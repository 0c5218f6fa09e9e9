"""Regression: the walk kernel's boundary diagonal into a predecessor
that fell OUT of the current band (round-5 ONT find).

At a slice boundary (row 0) the reference's pickBacktracePredecessor
reads the previous slice via getValueOrMax regardless of current-band
membership (GraphAligner.h:493-591); the move-walk kernel originally
gated that diagonal on pred_tab's current-band valid bit and broke a
co-optimal tie toward V instead of D — same score, different path, not
bit-identical. tests/fixtures/ont read_590646759 at b5/B20 is the
minimal reproducer (node 2805 leaves the band exactly at slice 140's
boundary). This runs the move-walk kernel (and the cell kernel) through
the Pallas interpreter on CPU, asked for with interpret=True, and
byte-compares against the reference golden; tests/test_ont.py and
chip_smoke.py prove the compiled kernels on the GPU.
"""

import pathlib

import pytest

ONT = pathlib.Path(__file__).parent / "fixtures" / "ont"
LS = pathlib.Path(__file__).parent / "fixtures" / "longsim"

RID = "read_590646759"


@pytest.mark.slow
def test_boundary_diagonal_prev_only_pred():
    from graphaligner_tpu.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq, stream, vg
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(LS / "graph.vg"))
    reads = [r for r in load_fastq(str(ONT / "reads.fastq")) if r.seq_id == RID]
    assert reads, "reproducer read missing from the ONT fixture"
    seeds = load_seed_hits(str(ONT / "seeds.gam"), [RID])
    gold = {
        a.name: a
        for a in stream.read_messages(str(ONT / "golden_b5B20.gam"), vg.Alignment)
    }
    ba = BandedBatchAligner(graph, 5, 20, interpret=True)
    res = align_reads_seeded_batch(graph, ba, reads, seeds)[RID]
    assert not res.alignment_failed
    mine = vg.Alignment.decode(res.alignment.encode())
    for m in mine.path.mapping:
        m.position.node_id //= 2
    assert mine == gold[RID], "boundary-diagonal tie broke differently"
