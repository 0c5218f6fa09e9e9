"""ONT-error tier (~18% total error, VERDICT r4 item 7): the error
regime the correctness-estimation HMM's constants assume
(AlignmentCorrectnessEstimation.cpp:6-8). At -b 5 -B 20 the estimator
flags slices wrong constantly, so bandwidth ramping rewinds fire
throughout — the ramping-heavy path no other fixture stresses at
scale. Byte-identical to the reference binary at both configs.

GPU-gated (10kb reads are minutes-slow per read on the CPU backend);
chip_smoke.py runs the b5/B20 config as part of its golden phase.
Fixture: tests/make_fixture_ont.py.
"""

import pathlib

import pytest

ONT = pathlib.Path(__file__).parent / "fixtures" / "ont"
LS = pathlib.Path(__file__).parent / "fixtures" / "longsim"


@pytest.mark.gpu
@pytest.mark.parametrize("bandwidth,ramp,golden", [
    (35, 0, "golden_b35.gam"),
    (5, 20, "golden_b5B20.gam"),
])
def test_ont_reads_match_reference(bandwidth, ramp, golden):
    import graphaligner_tpu.core.batch_align as _ba
    from graphaligner_tpu.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq, stream, vg
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    graph = load_alignment_graph(str(LS / "graph.vg"))
    reads = load_fastq(str(ONT / "reads.fastq"))
    seeds = load_seed_hits(str(ONT / "seeds.gam"), [r.seq_id for r in reads])
    gold = {
        a.name: a
        for a in stream.read_messages(str(ONT / golden), vg.Alignment)
    }
    rw0 = _ba.rewind_count()
    aligner = BandedBatchAligner(graph, bandwidth, ramp)
    res = align_reads_seeded_batch(graph, aligner, reads, seeds)
    if ramp:
        # the point of this tier: ramping must actually fire
        assert _ba.rewind_count() > rw0
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
