"""Regression tests over the reference repo's historical crash graph.

`tests/fixtures/gwws_fail_ex1.vg` is carried by the reference
(/root/reference/test/gwws_fail_ex1.vg, SURVEY §4.4) precisely because
it broke a past engine: a ~296bp chain of 1bp SNP bubbles around long
anchor nodes. Fixtures (tests/make_fixtures.py): 12 simulated ~250bp
reads at 5% sub/ins/del with reference-binary goldens at both bandwidth
configs. Every alignment must be bit-identical after id÷2, through BOTH
the host spec path (align_one_way_seeded) and the batched device
pipeline (align_reads_seeded_batch, the XLA path on CPU here;
chip_smoke.py re-runs the goldens on the GPU).
"""

import pathlib

import pytest

from graphaligner_tpu.core.align import align_one_way_seeded
from graphaligner_tpu.core.batch_align import (
    BandedBatchAligner,
    align_reads_seeded_batch,
)
from graphaligner_tpu.core.result import INT32_MAX
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.io import load_fastq, stream, vg

GWWS = pathlib.Path(__file__).parent / "fixtures" / "gwws"
GRAPH = pathlib.Path(__file__).parent / "fixtures" / "gwws_fail_ex1.vg"

CONFIGS = {"golden_b35": (35, 0), "golden_b5_B20": (5, 20)}


@pytest.fixture(scope="module")
def gwws_graph():
    return load_alignment_graph(str(GRAPH))


@pytest.fixture(scope="module")
def gwws_reads():
    return load_fastq(str(GWWS / "sim.fastq"))


@pytest.fixture(scope="module")
def gwws_seeds():
    seeds = {}
    for a in stream.read_messages(str(GWWS / "seeds.gam"), vg.Alignment):
        seeds.setdefault(a.name, []).append(
            (
                a.path.mapping[0].position.node_id,
                a.query_position,
                a.path.mapping[0].position.is_reverse,
            )
        )
    return seeds


def _norm(res):
    mine = vg.Alignment.decode(res.alignment.encode())
    for m in mine.path.mapping:
        m.position.node_id //= 2
    return mine


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_host_path_bit_identical(config, gwws_graph, gwws_reads, gwws_seeds):
    bandwidth, ramp = CONFIGS[config]
    golden = {
        a.name: a
        for a in stream.read_messages(str(GWWS / config / "out.gam"), vg.Alignment)
    }
    for read in gwws_reads:
        res = align_one_way_seeded(
            gwws_graph, read.seq_id, read.sequence, bandwidth, ramp,
            gwws_seeds[read.seq_id],
        )
        if res.alignment_failed or res.alignment.score == INT32_MAX:
            assert read.seq_id not in golden, (
                f"{read.seq_id}: reference aligned, we failed"
            )
            continue
        assert read.seq_id in golden, (
            f"{read.seq_id}: we aligned, reference failed"
        )
        assert _norm(res) == golden[read.seq_id], (
            f"{read.seq_id}: alignment differs"
        )


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_batched_pipeline_bit_identical(
    config, gwws_graph, gwws_reads, gwws_seeds
):
    bandwidth, ramp = CONFIGS[config]
    golden = {
        a.name: a
        for a in stream.read_messages(str(GWWS / config / "out.gam"), vg.Alignment)
    }
    ba = BandedBatchAligner(gwws_graph, bandwidth, ramp)
    results = align_reads_seeded_batch(
        gwws_graph, ba, gwws_reads,
        {r.seq_id: gwws_seeds[r.seq_id] for r in gwws_reads},
    )
    for read in gwws_reads:
        res = results[read.seq_id]
        if res.alignment_failed or res.alignment.score == INT32_MAX:
            assert read.seq_id not in golden
            continue
        assert _norm(res) == golden[read.seq_id], (
            f"{read.seq_id}: batched alignment differs"
        )


def test_traces_identical_to_reference(gwws_graph, gwws_reads, gwws_seeds):
    """Per-step trace files must match the reference byte-for-byte."""
    checked = 0
    for read in gwws_reads:
        golden_path = GWWS / "golden_b35" / f"trace_0_{read.seq_id}.trace"
        if not golden_path.exists():
            continue
        res = align_one_way_seeded(
            gwws_graph, read.seq_id, read.sequence, 35, 0,
            gwws_seeds[read.seq_id],
        )
        mine = [
            f"{t.node_id} {t.offset} {1 if t.reverse else 0} {t.readpos} "
            f"{int(t.type)} {t.graph_char} {t.read_char}"
            for t in res.trace
        ]
        golden = [l for l in golden_path.read_text().split("\n") if l]
        assert mine == golden, f"{read.seq_id}: trace differs"
        checked += 1
    assert checked == 2
