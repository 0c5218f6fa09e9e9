"""The capacity ladder: lanes that overflow a small band capacity retry
on the 2x tier; lanes that overflow every tier fall back to the host
oracle — and every path returns the same alignments."""

import pytest

from graphaligner_tpu.core.batch_align import (
    BandedBatchAligner,
    align_reads_seeded_batch,
)
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.io import load_fastq, vg
from graphaligner_tpu.runtime.aligner import load_seed_hits

from pathlib import Path

SIM = Path(__file__).parent / "fixtures" / "sim"


def _golden(graph, reads, seeds):
    ref = BandedBatchAligner(graph, 35, 0)
    return align_reads_seeded_batch(graph, ref, reads, seeds)


def _check(results, golden, reads):
    for r in reads:
        a, b = results[r.seq_id], golden[r.seq_id]
        assert a.alignment_failed == b.alignment_failed, r.seq_id
        if a.alignment_failed:
            continue
        assert (
            vg.Alignment.decode(a.alignment.encode())
            == vg.Alignment.decode(b.alignment.encode())
        ), r.seq_id


def test_overflow_retries_on_bigger_tier():
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:6]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    golden = _golden(graph, reads, seeds)
    # deliberately undersized first tier: bands at b=35 need far more
    # than 4 slots / 24 cells, so every lane overflows and retries
    tiny = BandedBatchAligner(graph, 35, 0, Nm=4, Cm=24)
    assert tiny._next_tier() is not None
    results = align_reads_seeded_batch(graph, tiny, reads, seeds)
    _check(results, golden, reads)


def test_overflow_exhausts_tiers_to_oracle():
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:3]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    golden = _golden(graph, reads, seeds)
    tiny = BandedBatchAligner(graph, 35, 0, Nm=4, Cm=24)
    tiny._bigger = BandedBatchAligner(
        graph, 35, 0, Nm=4, Cm=24, _tables=tiny.tables, _rev_pos=tiny.rev_pos
    )
    tiny._bigger._bigger = False  # sentinel: block further tiers
    tiny._bigger._next_tier = lambda: None
    results = align_reads_seeded_batch(graph, tiny, reads, seeds)
    _check(results, golden, reads)


def _ceiling_aligner(graph, Nm=4, Cm=24):
    """A one-tier ladder that every sim band overflows."""
    tiny = BandedBatchAligner(graph, 35, 0, Nm=Nm, Cm=Cm)
    tiny._next_tier = lambda: None
    return tiny


_CAPACITY = ("band_slots", "band_cells", "fixpoint")


def test_ceiling_fallbacks_are_counted_as_capacity():
    import graphaligner_tpu.core.batch_align as ba

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:2]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    golden = _golden(graph, reads, seeds)
    before = ba.fallback_counts()
    results = align_reads_seeded_batch(
        graph, _ceiling_aligner(graph), reads, seeds
    )
    _check(results, golden, reads)
    after = ba.fallback_counts()
    grown = sum(after[c] - before[c] for c in _CAPACITY)
    assert grown >= len(reads)
    assert after["other"] == before["other"]
    assert after["dropped_round"] == before["dropped_round"]


def test_no_fallback_mode_refuses_capacity_fallbacks(monkeypatch):
    monkeypatch.setenv("GA_NO_FALLBACK", "1")
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:1]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    with pytest.raises(RuntimeError, match=r"\((band_slots|band_cells)\)"):
        align_reads_seeded_batch(graph, _ceiling_aligner(graph), reads, seeds)


@pytest.mark.parametrize(
    "Nm,Cm,cause", [(4, 4096, "band_slots"), (32, 24, "band_cells")]
)
def test_overflow_cause_names_the_capacity(Nm, Cm, cause):
    """The engine's overflow bits say which capacity a band outgrew, and
    the host fallback is counted under that cause alone."""
    import graphaligner_tpu.core.batch_align as ba

    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:2]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    before = ba.fallback_counts()
    results = align_reads_seeded_batch(
        graph, _ceiling_aligner(graph, Nm, Cm), reads, seeds
    )
    _check(results, _golden(graph, reads, seeds), reads)
    grown = {c: ba.fallback_counts()[c] - before[c] for c in before}
    assert grown[cause] >= len(reads)
    assert sum(grown.values()) == grown[cause]


@pytest.mark.parametrize(
    "bits,cause",
    [(1, "band_slots"), (3, "band_slots"), (2, "band_cells"), (6, "band_cells"),
     (4, "fixpoint")],
)
def test_overflow_bits_to_cause(bits, cause):
    from graphaligner_tpu.core.batch_align import _overflow_cause

    assert _overflow_cause(bits) == cause


def test_ladder_widens_slots_then_cells_to_the_top_tier():
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    tier = BandedBatchAligner(graph, 35, 0)
    shapes = [(tier.Nm, tier.Cm)]
    while (tier := tier._next_tier()) is not None:
        shapes.append((tier.Nm, tier.Cm))
    assert shapes == [(32, 288), (64, 576), (64, 1152), (64, 2304)]
