"""Chunk-width invariance: GA_CHUNK (the scan chunk-width knob used for
A/B sweeps) must never change results — tiny chunks force many
chunk boundaries through the two-deep pipeline, covering the
cross-chunk walk/finalize paths the default width only hits at scale."""

from pathlib import Path

from graphaligner_tpu.core.batch_align import (
    BandedBatchAligner,
    align_reads_seeded_batch,
)
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.runtime.aligner import load_seed_hits

SIM = Path(__file__).parent / "fixtures" / "sim"


def _run(graph, reads, seeds):
    aligner = BandedBatchAligner(graph, 35, 0)
    res = align_reads_seeded_batch(graph, aligner, reads, seeds)
    out = {}
    for rid, r in res.items():
        if r.alignment_failed:
            out[rid] = None
        else:
            out[rid] = (
                r.alignment.encode(),
                [(t.type, t.readpos, t.graph_char, t.read_char) for t in r.trace],
            )
    return out


def test_chunk_width_invariance(monkeypatch):
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:10]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])

    base = _run(graph, reads, seeds)
    assert sum(1 for v in base.values() if v is not None) >= 8

    # 2-lane chunks: every pair of reads crosses a chunk boundary
    monkeypatch.setenv("GA_CHUNK", "2")
    tiny = _run(graph, reads, seeds)
    assert tiny == base
