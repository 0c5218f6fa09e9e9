"""Device engine tests (run on the CPU backend in CI).

The v1 engine computes exhaustive-mode (unbounded bandwidth) alignments;
it must agree exactly with the oracle pipeline run at a huge bandwidth,
and therefore transitively with the brute-force property tests.
"""

import numpy as np
import pytest

from graphaligner_tpu.core.align import align_one_way_full_band
from graphaligner_tpu.core.engine import (
    BatchAligner,
    align_batch_full_band,
    build_schedule,
)
from graphaligner_tpu.graph import load_alignment_graph, graph_from_gfa_file
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.ops.packing import pack_deltas, unpack_deltas_np

SIM = "tests/fixtures/sim"


def test_pack_unpack_roundtrip():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    sbs = rng.integers(0, 100, size=(5,)).astype(np.int32)
    deltas = rng.integers(-1, 2, size=(5, 64))
    scores = sbs[:, None] + np.cumsum(deltas, axis=1)
    packed = pack_deltas(jnp.asarray(scores.astype(np.int32)), jnp.asarray(sbs))
    back = unpack_deltas_np(*[np.asarray(p) for p in packed], sbs)
    assert (back == scores).all()


@pytest.fixture(scope="module")
def sim_graph():
    return load_alignment_graph(f"{SIM}/bubbles.vg")


@pytest.fixture(scope="module")
def sim_reads():
    return load_fastq(f"{SIM}/sim.fastq")


def test_engine_matches_oracle_exhaustive(sim_graph, sim_reads):
    reads = sim_reads[:6]
    results = align_batch_full_band(sim_graph, reads)
    for read, res in zip(reads, results):
        oracle = align_one_way_full_band(
            sim_graph, read.seq_id, read.sequence, 10**6, 0
        )
        assert res.alignment.score == oracle.alignment.score, read.seq_id
        assert res.alignment == oracle.alignment, read.seq_id


def test_engine_mixed_lengths(sim_graph, sim_reads):
    # different-length reads in one batch must each behave as if aligned
    # alone (N-padding prefix property)
    reads = [sim_reads[0], sim_reads[1]]
    short = type(reads[0])(seq_id="short", sequence=reads[0].sequence[:100], quality="!" * 100)
    batch = [short, reads[1]]
    results = align_batch_full_band(sim_graph, batch)
    solo = align_batch_full_band(sim_graph, [short])
    assert results[0].alignment == solo[0].alignment


def test_engine_cyclic_matches_oracle():
    """Full-band (-i) on a CYCLIC graph through the device fixpoint
    backend (reference full-band mode segfaults on every input — see
    test_tools.py::test_reference_full_band_crashes — so the oracle
    pipeline at unbounded bandwidth defines the semantics)."""
    import random

    g = graph_from_gfa_file(f"{SIM}/cyclic.gfa")
    sched = build_schedule(g)
    assert sched.cyclic
    seqs = {}
    for line in open(f"{SIM}/cyclic.gfa"):
        if line.startswith("S\t"):
            _, nid, seq = line.split()
            seqs[int(nid)] = seq
    rng = random.Random(11)
    path = [6, 7, 8, 9, 10, 11, 12, 8, 9, 10, 11, 12, 13, 14]
    truth = "".join(seqs[n] for n in path)
    bases = "ACGT"
    reads = []
    from graphaligner_tpu.io.fastq import FastQ

    for i in range(3):
        mut = "".join(
            rng.choice(bases) if rng.random() < 0.05 else c for c in truth
        )
        reads.append(FastQ(seq_id=f"cyc{i}", sequence=mut, quality="!" * len(mut)))
    results = align_batch_full_band(g, reads)
    for read, res in zip(reads, results):
        oracle = align_one_way_full_band(g, read.seq_id, read.sequence, 10**6, 0)
        assert res.alignment.score == oracle.alignment.score, read.seq_id
        assert res.alignment == oracle.alignment, read.seq_id


@pytest.mark.skipif(
    not __import__("os").path.exists("/tmp/refbuild/bin/Aligner"),
    reason="reference binary not built",
)
def test_reference_full_band_crashes():
    """Recorded reproduction of the reference full-band (-i) crash
    (PARITY.md §2.1): the reference binary dies with SIGSEGV on the
    FIRST read of any corpus when run with -i (initial minScore bug in
    getBacktraceFullStart, GraphAligner.h:3100-3133). This documents
    the divergence: our -i mode is the fixed/optimal semantics."""
    import os
    import subprocess

    fixtures = os.path.join(os.path.dirname(__file__), "fixtures")
    out = subprocess.run(
        [
            "/tmp/refbuild/bin/Aligner",
            "-g", os.path.join(fixtures, "longsim/graph.vg"),
            "-f", os.path.join(fixtures, "sim/sim.fastq"),
            "-a", "/tmp/ref_i_crash.gam",
            "-t", "1", "-b", "35", "-i",
        ],
        capture_output=True, text=True, timeout=300, cwd="/tmp",
    )
    assert "Signal 11" in out.stdout + out.stderr, (
        "reference -i no longer crashes — re-evaluate the -i parity "
        "claim in PARITY.md"
    )


def test_wavefront_backend_matches_column_backend(sim_graph, sim_reads):
    """The wavefront-scheduled engine must produce bit-identical packed
    slices to the column-scan engine."""
    import jax.numpy as jnp
    from graphaligner_tpu.core.engine import (
        _MATCH_TABLE,
        _align_batch_device,
        build_eq_vectors,
        encode_read,
        _READ_CODE,
    )
    from graphaligner_tpu.core.engine_wave import (
        _align_batch_wavefront,
        build_skewed_schedule,
        deskew,
    )

    ba = BatchAligner(sim_graph)
    B, S = 4, 3  # small: 192 rows cover the read prefixes
    seqs = [r.sequence[: S * 64 - 10] for r in sim_reads[:B]]
    codes = np.full((B, S * 64), _READ_CODE["N"], dtype=np.uint8)
    for i, s in enumerate(seqs):
        codes[i, : len(s)] = encode_read(s)
    P = len(ba.sched.cell_pos)
    sk = build_skewed_schedule(ba.sched, S)
    eq = build_eq_vectors(codes, _MATCH_TABLE, S)
    wave = deskew(
        [
            np.asarray(x)
            for x in _align_batch_wavefront(
                jnp.asarray(eq),
                *[jnp.asarray(x) for x in sk[:5]],
                num_slices=S,
                num_nodes=ba.sched.num_nodes,
                P=P,
            )
        ],
        P,
        S,
    )
    ref = [
        np.asarray(x)
        for x in _align_batch_device(
            jnp.asarray(codes),
            jnp.asarray(ba.sched.code),
            jnp.asarray(ba.sched.is_start),
            jnp.asarray(ba.sched.is_source_start),
            jnp.asarray(ba.sched.pred_nodes),
            jnp.asarray(ba.sched.node_slot),
            num_slices=S,
            num_nodes=ba.sched.num_nodes,
        )
    ]
    for name, a, b in zip(["vp_lo", "vp_hi", "vn_lo", "vn_hi", "sbs", "send"], wave, ref):
        assert (a == b).all(), name
