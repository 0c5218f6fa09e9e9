"""CPU coverage of the GPU kernels and of the choice between them.

The banded cell kernel and the move-walk kernel (Pallas, Triton route)
compile only for the GPU; here they run through the Pallas interpreter,
asked for explicitly (`interpret=True`), and are pinned against the
plain XLA paths: any layout or kernel edit that breaks bit-identity
fails here first. tests marked `gpu` prove the compiled kernels on the
card against the reference goldens.
"""

from pathlib import Path

import numpy as np
import pytest

from graphaligner_tpu.core.batch_align import (
    BandedBatchAligner,
    align_reads_seeded_batch,
)
from graphaligner_tpu.graph import load_alignment_graph
from graphaligner_tpu.io import load_fastq
from graphaligner_tpu.ops.kernels import Kernels, select_kernels
from graphaligner_tpu.runtime.aligner import load_seed_hits

SIM = Path(__file__).parent / "fixtures" / "sim"


def _sim(n):
    graph = load_alignment_graph(str(SIM / "bubbles.vg"))
    reads = load_fastq(str(SIM / "sim.fastq"))[:n]
    seeds = load_seed_hits(str(SIM / "seeds.gam"), [r.seq_id for r in reads])
    return graph, reads, seeds


def _run(graph, reads, seeds, **kw):
    aligner = BandedBatchAligner(graph, 35, 0, **kw)
    res = align_reads_seeded_batch(graph, aligner, reads, seeds)
    out = {}
    for rid, r in res.items():
        if r.alignment_failed:
            out[rid] = None
        else:
            out[rid] = r.alignment.encode()
    return out


def test_pallas_kernel_matches_xla_path():
    """The Triton cell kernel (interpreted) against the XLA cell pass,
    walks held on the XLA path."""
    graph, reads, seeds = _sim(4)
    base = _run(graph, reads, seeds)
    assert sum(1 for v in base.values() if v is not None) >= 3
    cell_only = Kernels(cell="triton", walk="xla", long_walk="xla",
                        interpret=True)
    assert _run(graph, reads, seeds, kernels=cell_only) == base


def test_pallas_kernel_under_shard_map():
    """The cell kernel inside the dp shard_map, on the 8-device CPU
    mesh, against the single-device XLA run."""
    from graphaligner_tpu.parallel import make_mesh

    graph, reads, seeds = _sim(8)
    base = _run(graph, reads, seeds)
    assert sum(1 for v in base.values() if v is not None) >= 6
    sharded = _run(graph, reads, seeds, mesh=make_mesh(), interpret=True)
    assert sharded == base


def test_full_production_path_on_cpu():
    """Cell kernel + move-walk kernel + native decode — the GPU
    pipeline — through the interpreter, against the XLA/CPU path."""
    graph, reads, seeds = _sim(4)
    base = _run(graph, reads, seeds)
    aligner = BandedBatchAligner(graph, 35, 0, interpret=True)
    assert aligner.kernels == Kernels("triton", "triton", "triton", True)
    assert _run(graph, reads, seeds, interpret=True) == base


def test_wide_slot_tier_matches_xla_path():
    """The 64-node-slot top tier (6-bit slot fields in the predecessor
    words) through both kernels and the windowed walk, interpreted,
    against the default XLA run."""
    graph, reads, seeds = _sim(3)
    base = _run(graph, reads, seeds)
    assert _run(graph, reads, seeds, Nm=64, interpret=True) == base
    wide = BandedBatchAligner(graph, 35, 0, Nm=64, interpret=True)
    wide.LONG_WINDOW = 4  # ~10-slice reads: force windowing
    res = align_reads_seeded_batch(graph, wide, reads, seeds)
    assert {rid: r.alignment.encode() for rid, r in res.items()} == base


def test_giant_tier_walks_on_device():
    """A Cm >= 1792 capacity tier (the ONT b5/B20 ladder reaches 2304)
    is scanned and walked by the kernels — the single-window walk and
    the windowed long-mode walk — with no lane failed to the host."""
    graph, reads, seeds = _sim(2)
    base = _run(graph, reads, seeds)
    giant = BandedBatchAligner(graph, 35, 0, Cm=1792, interpret=True)
    res = align_reads_seeded_batch(graph, giant, reads, seeds)
    got = {rid: r.alignment.encode() for rid, r in res.items()}
    assert got == base
    long_giant = BandedBatchAligner(graph, 35, 0, Cm=1792, interpret=True)
    long_giant.LONG_WINDOW = 4  # ~10-slice reads: force windowing
    res = align_reads_seeded_batch(graph, long_giant, reads, seeds)
    assert {rid: r.alignment.encode() for rid, r in res.items()} == base


@pytest.fixture(scope="module")
def walk_call():
    """Arguments of the first move-walk call of an interpreted run."""
    import graphaligner_tpu.ops.pallas.walk_moves as wm

    calls = []
    orig = wm.walk_moves

    def capture(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    wm.walk_moves = capture
    try:
        graph, reads, seeds = _sim(3)
        aligner = BandedBatchAligner(graph, 35, 0, interpret=True)
        align_reads_seeded_batch(graph, aligner, reads, seeds)
    finally:
        wm.walk_moves = orig
    assert calls
    return calls[0], aligner.tables.k_in


@pytest.mark.parametrize("lanes", [128, 100, 5])
def test_walk_kernel_matches_plain_walk(walk_call, lanes):
    """The walk kernel (interpreted, lanes padded to its block) against
    the same walk under a plain lax.while_loop, output for output."""
    from graphaligner_tpu.ops.pallas.walk_moves import walk_moves

    args, k_in = walk_call
    args = tuple(np.asarray(a)[..., :lanes] if np.ndim(a) > 1 else a
                 for a in args)
    ref = walk_moves(*args, K_in=k_in, impl="xla")
    got = walk_moves(*args, K_in=k_in, impl="triton", interpret=True)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    assert np.asarray(ref[3]).max() > 0  # the lanes really walked


@pytest.mark.parametrize("B,Nm", [(3, 32), (20, 32), (20, 64)])
def test_cell_kernel_pads_lanes(B, Nm):
    """banded_scan with the cell kernel at batch widths that are not a
    multiple of its lane block equals the XLA cell pass, field for
    field (Nm = 64: the wider predecessor slot fields)."""
    from graphaligner_tpu.core.align import _pad_to_word
    from graphaligner_tpu.core.engine import _READ_CODE, encode_read
    from graphaligner_tpu.core.engine_banded import (
        banded_scan,
        build_graph_tables,
        make_seed_carry,
    )

    graph, reads, seeds = _sim(B)
    tables = build_graph_tables(graph)
    Cm = 384
    problems = []
    for r in reads:
        node_id, pos, reverse = seeds[r.seq_id][0]
        fw = graph.node_lookup[node_id * 2 + (1 if reverse else 0)]
        problems.append((_pad_to_word(r.sequence[pos:]), fw))
    S = 4
    codes = np.full((B, S * 64), _READ_CODE["N"], dtype=np.uint8)
    for i, (seq, _) in enumerate(problems):
        c = encode_read(seq)[: S * 64]
        codes[i, : len(c)] = c
    steps = np.full(B, S, np.int32)
    carry = make_seed_carry(tables, [p[1] for p in problems], Nm, Cm)
    args = (*tables.device_args(), codes, np.full(B, S * 64, np.int32),
            steps, np.zeros(B, np.int32), np.full((S, B), 35, np.int32),
            *carry)
    ref = banded_scan(*args, S_max=S, Nm=Nm, Cm=Cm, cell="xla")
    got = banded_scan(*args, S_max=S, Nm=Nm, Cm=Cm, cell="triton",
                      interpret=True)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))


@pytest.mark.parametrize(
    "platform,k_in,Nm,want",
    [
        ("gpu", 3, 32, Kernels("triton", "triton", "triton")),
        ("gpu", 5, 32, Kernels("triton", "xla", None)),
        ("gpu", 6, 32, Kernels("xla", "xla", None)),
        ("gpu", 3, 64, Kernels("triton", "triton", "triton")),
        ("gpu", 4, 64, Kernels("triton", "triton", "triton")),
        ("gpu", 5, 64, Kernels("xla", "xla", None)),
        ("gpu", 3, 128, Kernels("triton", "triton", "triton")),
        ("gpu", 4, 128, Kernels("xla", "xla", None)),
        ("gpu", 2, 512, Kernels("xla", "triton", "triton")),
        ("cpu", 3, 32, Kernels("xla", "xla", "xla")),
        ("cpu", 5, 32, Kernels("xla", "xla", None)),
    ],
)
def test_select_kernels(platform, k_in, Nm, want):
    assert select_kernels(platform, k_in=k_in, Nm=Nm) == want


def test_select_kernels_interpret_and_unknown_platform():
    assert select_kernels("cpu", k_in=3, Nm=32, interpret=True) == Kernels(
        "triton", "triton", "triton", True
    )
    with pytest.raises(ValueError):
        select_kernels("metal", k_in=3, Nm=32)


@pytest.mark.parametrize("env", [None, "/some/cache/dir"])
def test_compile_cache_dir(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX (the code sets
    no other directory); unset, the cache sits at one fixed, gitignored
    path in the checkout."""
    import jax

    import graphaligner_tpu as ga

    saved = jax.config.jax_compilation_cache_dir
    repo = Path(ga.__file__).resolve().parent.parent
    assert Path(ga.DEFAULT_COMPILE_CACHE) == repo / ".jax_cache"
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()
    try:
        jax.config.update("jax_compilation_cache_dir", "/before")
        if env is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            ga._enable_persistent_compile_cache()
            assert jax.config.jax_compilation_cache_dir == ga.DEFAULT_COMPILE_CACHE
        else:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
            ga._enable_persistent_compile_cache()
            assert jax.config.jax_compilation_cache_dir == "/before"
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
