"""Memory-bounded long-read mode: chained scan windows with dropped
columns + the windowed recompute walk must produce byte-identical
results to the single-window path. The CPU tests force a tiny window so
every piece (chaining, boundary stash, the state-continued walk kernel
and cell kernel in explicit interpreter mode, stream concat decode)
runs in CI, against the single-window XLA path."""

import os

import numpy as np
import pytest

from graphaligner_tpu.core.batch_align import (
    BandedBatchAligner,
    align_reads_seeded_batch,
)
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.runtime.aligner import load_seed_hits

from pathlib import Path

LS = str(Path(__file__).parent / "fixtures" / "longsim")


def test_windowed_long_mode_matches_normal_cpu():
    graph = load_alignment_graph(f"{LS}/graph.vg")
    reads = load_fastq(f"{LS}/reads.fastq")[:6]
    seeds = load_seed_hits(f"{LS}/seeds.gam", [r.seq_id for r in reads])

    normal = BandedBatchAligner(graph, 35, 0)
    res_n = align_reads_seeded_batch(graph, normal, reads, seeds)

    long_al = BandedBatchAligner(graph, 35, 0, interpret=True)
    long_al.LONG_WINDOW = 48  # force windowing on these ~157-slice reads
    res_l = align_reads_seeded_batch(graph, long_al, reads, seeds)

    for r in reads:
        a, b = res_n[r.seq_id], res_l[r.seq_id]
        assert a.alignment_failed == b.alignment_failed, r.seq_id
        if a.alignment_failed:
            continue
        assert a.alignment.encode() == b.alignment.encode(), r.seq_id


def test_long_mode_ramping_rewinds_match_normal():
    """Bandwidth-ramp rewinds + HMM cuts MID-WINDOW (error bursts, b=5
    B=20): the control replay cuts window chains at the last accepted
    step, so the boundary stash must serve the ACCEPTED cut (not the
    last computed step) or fail only that lane — either way the final
    bytes must equal the unwindowed run (ADVICE r2 high-1 regression)."""
    import graphaligner_tpu.core.batch_align as _ba

    rng = np.random.default_rng(41)
    graph = load_alignment_graph(f"{LS}/graph.vg")
    base = load_fastq(f"{LS}/reads.fastq")[:5]
    seeds = load_seed_hits(f"{LS}/seeds.gam", [r.seq_id for r in base])
    reads = []
    for r in base:
        sub = list(r.sequence)
        # two 300bp bursts at 25% extra error, past the first window
        for b0 in (3400, 6200):
            for p in rng.integers(b0, b0 + 300, 75):
                sub[p] = "ACGT"[rng.integers(4)]
        r2 = r.__class__(**{**r.__dict__, "sequence": "".join(sub)})
        reads.append(r2)

    normal = BandedBatchAligner(graph, 5, 20)
    res_n = align_reads_seeded_batch(graph, normal, reads, seeds)

    rw0 = _ba.rewind_count()
    long_al = BandedBatchAligner(graph, 5, 20, interpret=True)
    long_al.LONG_WINDOW = 48
    res_l = align_reads_seeded_batch(graph, long_al, reads, seeds)
    assert _ba.rewind_count() > rw0  # the scenario actually fired

    for r in reads:
        a, b = res_n[r.seq_id], res_l[r.seq_id]
        assert a.alignment_failed == b.alignment_failed, r.seq_id
        if a.alignment_failed:
            continue
        assert a.alignment.encode() == b.alignment.encode(), r.seq_id


@pytest.mark.gpu
@pytest.mark.parametrize("bandwidth,ramp,golden", [
    (35, 0, "golden_b35.gam"),
    (5, 20, "golden_b5B20.gam"),
])
def test_1mbp_reads_match_reference(bandwidth, ramp, golden):
    """1Mbp reads — 10x the 100kb tier — through windowed long mode on
    a 4.8Mbp synthetic variation graph (tests/make_fixture_1m.py;
    VERDICT r3 item 7). The b5/B20 case runs the SAME 5%-error reads at
    minimal bandwidth, so ramping rewinds and HMM cuts fire mid
    window-chain (the boundary-stash regime ADVICE r2 found a crash in
    at 100kb depth). Byte-compared against the reference binary's
    alignments; reference long-read mechanism GraphAligner.h:2571-2856."""
    import graphaligner_tpu.core.batch_align as _ba
    from graphaligner_tpu.io import stream, vg

    M = f"{LS}/mega"
    if not os.path.exists(f"{M}/graph.vg"):
        pytest.skip("mega fixture not generated (tests/make_fixture_1m.py)")
    graph = load_alignment_graph(f"{M}/graph.vg")
    reads = load_fastq(f"{M}/reads.fastq")
    seeds = load_seed_hits(f"{M}/seeds.gam", [r.seq_id for r in reads])
    gold = {
        a.name: a for a in stream.read_messages(f"{M}/{golden}", vg.Alignment)
    }
    rw0 = _ba.rewind_count()
    aligner = BandedBatchAligner(graph, bandwidth, ramp)
    res = align_reads_seeded_batch(graph, aligner, reads, seeds)
    if ramp:
        assert _ba.rewind_count() > rw0  # the rewind scenario actually fired
    for r in reads:
        a = res[r.seq_id]
        if a.alignment_failed or a.alignment.score == 2**31 - 1:
            assert r.seq_id not in gold, f"{r.seq_id}: golden expected a hit"
            continue
        mine = vg.Alignment.decode(a.alignment.encode())
        for m in mine.path.mapping:
            m.position.node_id //= 2
        assert r.seq_id in gold, f"{r.seq_id}: extra alignment"
        assert mine == gold[r.seq_id], f"{r.seq_id}: differs from reference"


@pytest.mark.gpu
def test_100kb_reads_match_reference(tmp_path):
    """100kb reads (1560+ slices, windowed long mode on by default) vs
    the reference binary's alignments on a 480kb synthetic variation
    graph (tests/make_fixture_100k.py)."""
    from graphaligner_tpu.core.params import AlignerParams
    from graphaligner_tpu.io import stream, vg
    from graphaligner_tpu.runtime.aligner import align_reads

    H = f"{LS}/huge"
    params = AlignerParams(
        graph_file=f"{H}/graph.vg",
        fastq_file=f"{H}/reads.fastq",
        alignment_file=str(tmp_path / "out.gam"),
        seed_file=f"{H}/seeds.gam",
        initial_bandwidth=35,
    )
    align_reads(params, log=lambda m: None, output_dir=str(tmp_path), backend="jax")
    golden = stream.read_messages(f"{H}/golden.gam", vg.Alignment)
    mine = stream.read_messages(str(tmp_path / "out.gam"), vg.Alignment)
    assert [repr(a) for a in golden] == [repr(b) for b in mine]
