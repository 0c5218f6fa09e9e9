"""GPU smoke of the seeded banded aligner: the quickest proof that the
system starts on the card and is still byte-identical there.

    python chip_smoke.py            # one GPU: every phase below
    python chip_smoke.py --four     # four GPUs: the dp mesh path only

Phases (one process, one card, GA_NO_FALLBACK=1 throughout):
1. device line: platform, device kind, count, CPU cores, nvidia-smi;
2. kernels at real widths: the banded scan with the Triton cell kernel
   against the same scan with the XLA cell pass, and the Triton move
   walk against the same walk under plain XLA, both on a captured
   longsim chunk and compared exactly; each kernel's compiled memory;
3. the main path through the CLI (`--backend jax`), GAM bytes against
   the reference goldens on every checked-in tier, then longsim tiled
   to 1000 reads, timed once;
4. a chromosome-class graph (~2.6M digraph nodes) with 100 x 10 kb
   seeded reads; a few reads against the host spec path;
5. full-band `-i` on the sim corpus against the host oracle.

Every tier prints one line (reads, wall s, compile s, peak device
memory, host-fallback entries by cause, bit_identical). Windowed long
mode drops old rounds' columns by design; lanes that need them again
fall back to the host and are counted as `dropped_round`, the one
fallback GA_NO_FALLBACK=1 lets through, and only in the windowed tiers.
No other lane may fall back anywhere.
The last line of a passing run is one JSON object with "ok": true; any
failure exits non-zero without it.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "tests", "fixtures")
OUT = os.path.join(HERE, "chiprun_out", "smoke")
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))
os.environ["GA_NO_FALLBACK"] = "1"

_COMPILE_S = [0.0]


def _on_duration(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def nvidia_smi_line() -> str:
    """Card name and power limit, from a child that does not import
    JAX (so it never opens the card)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().replace("\n", " | ") or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _peak_gb(dev=None):
    import jax

    devs = [dev] if dev is not None else jax.local_devices()
    peaks = []
    for d in devs:
        st = d.memory_stats() or {}
        peaks.append(st.get("peak_bytes_in_use", 0) / 2**30)
    return peaks


class Tier:
    """Times one tier and prints its line."""

    def __init__(self, name, reads, windowed=False):
        from graphaligner_tpu.core import batch_align

        self.name = name
        self.reads = reads
        self.windowed = windowed
        self._fb0 = batch_align.fallback_counts()

    def __enter__(self):
        self.t0 = time.time()
        self.c0 = _COMPILE_S[0]
        return self

    def __exit__(self, exc_type, exc, tb):
        from graphaligner_tpu.core import batch_align

        if exc_type is not None:
            print(f"[tier] {self.name}: FAILED ({exc_type.__name__}: {exc})",
                  flush=True)
            return False
        fb1 = batch_align.fallback_counts()
        self.fallback = {k: fb1[k] - self._fb0[k] for k in fb1}
        wall = time.time() - self.t0
        line = {
            "tier": self.name,
            "reads": self.reads,
            "wall_s": round(wall, 3),
            "compile_s": round(_COMPILE_S[0] - self.c0, 3),
            "peak_mem_gib": [round(p, 3) for p in _peak_gb()],
            "fallback_lanes": self.fallback,
            "bit_identical": getattr(self, "identical", None),
        }
        line.update(getattr(self, "extra", {}))
        print("[tier] " + json.dumps(line), flush=True)
        allowed = ("dropped_round",) if self.windowed else ()
        bad = {k: n for k, n in self.fallback.items() if n and k not in allowed}
        assert not bad, f"{self.name}: host fallback {bad}"
        assert line["bit_identical"] is not False, f"{self.name}: differs"
        return False


# ------------------------------------------------------------- GAM checks
def _gam_by_name(path):
    from graphaligner_tpu.io import stream, vg

    out = {}
    for a in stream.read_messages(path, vg.Alignment):
        out.setdefault(a.name, []).append(a.encode())
    return out


def same_gam(mine_path, golden_path, names=None):
    """Per-read alignment bytes equal the golden's (order-free: the
    reference writes reads in thread completion order)."""
    mine = _gam_by_name(mine_path)
    gold = _gam_by_name(golden_path)
    if names is not None:
        gold = {k: v for k, v in gold.items() if k in names}
    if mine != gold:
        bad = sorted(set(mine) ^ set(gold)) or sorted(
            k for k in gold if mine.get(k) != gold[k]
        )
        print(f"  differing reads: {bad[:5]} (of {len(bad)})", flush=True)
        return False
    return True


def run_cli(tier_dir, argv):
    """The CLI in this process, cwd = the tier's directory (the
    reference writes per-read files next to the run)."""
    from graphaligner_tpu.runtime import cli

    os.makedirs(tier_dir, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(tier_dir)
    try:
        rc = cli.main(argv + ["--backend", "jax"])
    finally:
        os.chdir(cwd)
    assert rc == 0, f"cli exit {rc}"


def _count_reads(fastq):
    from graphaligner_tpu.io import load_fastq

    return len(load_fastq(fastq))


def golden_tier(name, graph, reads, seeds, golden, b, B=0, env=None,
                names=None, windowed=False):
    """One golden tier through the CLI."""
    env = dict(env or {})
    tier_dir = os.path.join(OUT, name.replace(" ", "_").replace("/", "_"))
    out_gam = os.path.join(tier_dir, "out.gam")
    argv = ["-g", graph, "-f", reads, "-s", seeds, "-a", out_gam,
            "-b", str(b)]
    if B:
        argv += ["-B", str(B)]
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with Tier(name, _count_reads(reads), windowed) as t:
            run_cli(tier_dir, argv)
            t.identical = same_gam(out_gam, golden, names)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ----------------------------------------------------------------- phases
def phase_device():
    import jax

    d = jax.devices()[0]
    print(json.dumps({
        "phase": "device", "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()), "cpu_count": os.cpu_count(),
        "nvidia_smi": nvidia_smi_line(),
        "compile_cache": jax.config.jax_compilation_cache_dir,
    }), flush=True)


def _mem(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {
        "args_b": m.argument_size_in_bytes,
        "out_b": m.output_size_in_bytes,
        "temp_b": m.temp_size_in_bytes,
    }


def phase_kernels():
    """Capture one longsim chunk's scan round and walk call, then run
    each Triton kernel and its XLA counterpart on it, compared exactly."""
    import jax
    import numpy as np

    from graphaligner_tpu.core import batch_align, engine_banded
    from graphaligner_tpu.ops.pallas import walk_moves as wm
    from graphaligner_tpu.ops.pallas.banded_cell import banded_cell_kernel
    from bench import load_corpus

    graph, reads, seeds = load_corpus("longsim")
    aligner = batch_align.BandedBatchAligner(graph, 35, 0)
    assert aligner.kernels.cell == "triton", aligner.kernels
    assert aligner.kernels.walk == "triton", aligner.kernels
    scans, walks = [], []
    orig_scan, orig_walk = batch_align.banded_scan, wm.walk_moves

    def cap_scan(*a, **kw):
        if not scans:
            scans.append((a, kw))
        return orig_scan(*a, **kw)

    def cap_walk(*a, **kw):
        if not walks:
            walks.append((a, kw))
        return orig_walk(*a, **kw)

    batch_align.banded_scan, wm.walk_moves = cap_scan, cap_walk
    try:
        with Tier("longsim b35 (capture)", len(reads)):
            batch_align.align_reads_seeded_batch(graph, aligner, reads, seeds)
    finally:
        batch_align.banded_scan, wm.walk_moves = orig_scan, orig_walk

    a, kw = scans[0]
    B = a[6].shape[0]
    res = {}
    for cell in ("triton", "xla"):
        kw2 = dict(kw, cell=cell)
        jax.block_until_ready(engine_banded.banded_scan(*a, **kw2))
        t0 = time.time()
        out = engine_banded.banded_scan(*a, **kw2)
        jax.block_until_ready(out)
        res[cell] = (time.time() - t0, {k: np.asarray(v) for k, v in out.items()})
    same = all(
        np.array_equal(res["triton"][1][k], res["xla"][1][k])
        for k in res["xla"][1]
    )
    i32 = jax.numpy.int32
    sd = jax.ShapeDtypeStruct
    Cm, Nm = kw["Cm"], kw["Nm"]
    k_in = aligner.tables.k_in
    cell_c = jax.jit(lambda *x: banded_cell_kernel(*x, K_in=k_in)).lower(
        *[sd((Cm, B), i32)] * 4, *[sd((5, B), i32)] * 2, sd((1, B), i32),
        sd((7, Nm, B), i32),
    ).compile()
    print("[kernel] " + json.dumps({
        "kernel": "banded_cell", "S": kw["S_max"], "B": B, "Cm": Cm,
        "Nm": Nm, "k_in": k_in,
        "scan_round_s": {c: round(res[c][0], 4) for c in res},
        "exact": same, "memory": _mem(cell_c),
    }), flush=True)
    assert same, "cell kernel differs from the XLA cell pass"

    a, kw = walks[0]
    outs = {}
    for impl in ("triton", "xla"):
        kw2 = dict(kw, impl=impl)
        jax.block_until_ready(wm.walk_moves(*a, **kw2))
        t0 = time.time()
        o = wm.walk_moves(*a, **kw2)
        jax.block_until_ready(o)
        outs[impl] = (time.time() - t0, [np.asarray(x) for x in o])
    same = all(
        np.array_equal(x, y) for x, y in zip(outs["triton"][1], outs["xla"][1])
    )
    walk_c = jax.jit(
        lambda *x: wm._walk_moves(*x, K_in=kw["K_in"], impl="triton",
                                  interpret=False)
    ).lower(*a).compile()
    print("[kernel] " + json.dumps({
        "kernel": "walk_moves", "K": a[0].shape[0] - 1, "B": a[0].shape[3],
        "Cm": a[0].shape[2], "walk_s": {i: round(outs[i][0], 4) for i in outs},
        "exact": same, "moves_used_max": int(outs["xla"][1][3].max()),
        "memory": _mem(walk_c),
    }), flush=True)
    assert same, "walk kernel differs from the XLA walk"


def phase_goldens():
    L = f"{FIX}/longsim"
    S = f"{FIX}/sim"
    golden_tier("longsim b35", f"{L}/graph.vg", f"{L}/reads.fastq",
                f"{L}/seeds.gam", f"{L}/golden_b35.gam", 35)
    golden_tier("sim b35", f"{S}/bubbles.vg", f"{S}/sim.fastq",
                f"{S}/seeds.gam", f"{S}/golden_b35/out.gam", 35)
    golden_tier("sim b5 B20", f"{S}/bubbles.vg", f"{S}/sim.fastq",
                f"{S}/seeds.gam", f"{S}/golden_b5_B20/out.gam", 5, 20)
    # the projection asked for by name (it is also the default)
    golden_tier("longsim b35 GA_PROJ=reach", f"{L}/graph.vg",
                f"{L}/reads.fastq", f"{L}/seeds.gam",
                f"{L}/golden_b35.gam", 35, env={"GA_PROJ": "reach"})
    golden_tier("sim b35 GA_PROJ=reach", f"{S}/bubbles.vg", f"{S}/sim.fastq",
                f"{S}/seeds.gam", f"{S}/golden_b35/out.gam", 35,
                env={"GA_PROJ": "reach"})
    golden_tier("gwws b35", f"{FIX}/gwws_fail_ex1.vg",
                f"{FIX}/gwws/sim.fastq", f"{FIX}/gwws/seeds.gam",
                f"{FIX}/gwws/golden_b35/out.gam", 35)
    giantband()
    golden_tier("ont b5 B20", f"{L}/graph.vg", f"{FIX}/ont/reads.fastq",
                f"{FIX}/ont/seeds.gam", f"{FIX}/ont/golden_b5B20.gam", 5, 20)
    golden_tier("giant 30kb b35", f"{L}/graph.vg",
                f"{L}/giant/giant_reads.fastq", f"{L}/giant/giant_seeds.gam",
                f"{L}/giant/giant_out.gam", 35)
    golden_tier("huge 100kb b35 (windowed)", f"{L}/huge/graph.vg",
                f"{L}/huge/reads.fastq", f"{L}/huge/seeds.gam",
                f"{L}/huge/golden.gam", 35, windowed=True)
    mega_read1 = _first_read_fastq(f"{L}/mega/reads.fastq")
    name = mega_read1[1]
    golden_tier("mega 1Mbp b35 read 1 (windowed)", f"{L}/mega/graph.vg",
                mega_read1[0], f"{L}/mega/seeds.gam",
                f"{L}/mega/golden_b35.gam", 35, names={name}, windowed=True)
    golden_tier("mega 1Mbp b5 B20 read 1 (windowed)", f"{L}/mega/graph.vg",
                mega_read1[0], f"{L}/mega/seeds.gam",
                f"{L}/mega/golden_b5B20.gam", 5, 20, names={name},
                windowed=True)
    timed_longsim()


def _first_read_fastq(path):
    from graphaligner_tpu.io import load_fastq

    r = load_fastq(path)[0]
    os.makedirs(OUT, exist_ok=True)
    out = os.path.join(OUT, "mega_read1.fastq")
    with open(out, "w") as f:
        f.write(f"@{r.seq_id}\n{r.sequence}\n+\n{'I' * len(r.sequence)}\n")
    return out, r.seq_id


def giantband():
    """230 kbp-band fixture through the native giant-band slice engine
    (the host path; part of the gate so that engine is proven here too)."""
    from graphaligner_tpu.core.align import align_one_way_seeded
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq, stream, vg

    graph = load_alignment_graph(f"{FIX}/giantband/graph.vg")
    read = load_fastq(f"{FIX}/giantband/read.fastq")[0]
    golden = list(
        stream.read_messages(f"{FIX}/giantband/golden.gam", vg.Alignment)
    )[0]
    with Tier("giantband (host native slices)", 1) as t:
        res = align_one_way_seeded(
            graph, read.seq_id, read.sequence, 35, 0, [(1, 0, False)]
        )
        mine = vg.Alignment.decode(res.alignment.encode())
        for m in mine.path.mapping:
            m.position.node_id //= 2
        t.identical = (not res.alignment_failed) and mine == golden


def timed_longsim():
    """longsim tiled to 1000 reads: one warm-up pass (its compiles land
    in compile_s), then one timed pass."""
    from bench import run_corpus

    with Tier("longsim x10 timed", 1000) as t:
        r = run_corpus("longsim", tile=10)
        t.identical = None
        t.extra = {k: r[k] for k in ("reads_per_s", "mbp_per_s")}
    print(f"longsim x10: {r['reads_per_s']} reads/s {r['mbp_per_s']} Mbp/s "
          f"on {nvidia_smi_line()}", flush=True)


def phase_biggraph():
    """Chromosome-class graph: make_big_graph at bench size, 100 x 10 kb
    seeded reads through align_reads_seeded_batch; the first reads
    against the host spec path."""
    from biggraph_util import make_big_graph, make_reads

    from graphaligner_tpu.core.align import align_one_way_seeded
    from graphaligner_tpu.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu.core.engine_banded import build_graph_tables
    from graphaligner_tpu.io.fastq import FastQ

    t0 = time.time()
    graph, backbone, seq = make_big_graph(1_050_000)
    t_gen = time.time() - t0
    t0 = time.time()
    tables = build_graph_tables(graph)
    t_tables = time.time() - t0
    reads = make_reads(seq, 100, 10_048, graph, backbone)
    fastqs = [FastQ(seq_id=n, sequence=s) for n, s, _ in reads]
    seed_map = {n: [(node, 0, False)] for n, _, node in reads}
    t0 = time.time()
    aligner = BandedBatchAligner(graph, 35, 0, _tables=tables)
    t_reach = time.time() - t0
    with Tier("chr20-class 2.6M nodes", len(reads)) as t:
        res = align_reads_seeded_batch(graph, aligner, fastqs, seed_map)
        failed = [n for n, r in res.items() if r.alignment_failed]
        assert not failed, f"{len(failed)} reads failed"
        n_host = 4
        same = 0
        for name, s, node in reads[:n_host]:
            host = align_one_way_seeded(graph, name, s, 35, 0,
                                        [(node, 0, False)])
            same += host.alignment.encode() == res[name].alignment.encode()
        t.identical = same == n_host
        t.extra = {
            "digraph_nodes": graph.node_count, "gen_s": round(t_gen, 3),
            "tables_s": round(t_tables, 3), "reach_s": round(t_reach, 3),
            "host_checked": n_host, "host_identical": same,
        }


def phase_full_band():
    """Full-band -i through the CLI (the batched exhaustive engine)
    against the host oracle's align_one_way_full_band."""
    from graphaligner_tpu.core.align import align_one_way_full_band
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq, stream, vg

    S = f"{FIX}/sim"
    reads = load_fastq(f"{S}/sim.fastq")
    n = len(reads)
    tier_dir = os.path.join(OUT, "full_band")
    os.makedirs(tier_dir, exist_ok=True)
    fq = os.path.join(tier_dir, "reads.fastq")
    with open(fq, "w") as f:
        for r in reads:
            f.write(f"@{r.seq_id}\n{r.sequence}\n+\n{'I' * len(r.sequence)}\n")
    out_gam = os.path.join(tier_dir, "out.gam")
    graph = load_alignment_graph(f"{S}/bubbles.vg")
    with Tier("sim full-band -i b35", n) as t:
        run_cli(tier_dir, ["-g", f"{S}/bubbles.vg", "-f", fq, "-a", out_gam,
                           "-b", "35", "-i"])
        mine = {a.name: a for a in stream.read_messages(out_gam, vg.Alignment)}
        ok = len(mine) == n
        for r in reads:
            ref = align_one_way_full_band(graph, r.seq_id, r.sequence, 35, 0)
            want = vg.Alignment.decode(ref.alignment.encode())
            for m in want.path.mapping:
                m.position.node_id //= 2
            ok = ok and mine.get(r.seq_id) == want
        t.identical = ok


def phase_four():
    """--mesh dp over four cards, one process: longsim through the CLI,
    bytes against the golden and against a one-card run; per-card peak
    memory shows the batch spread past card 0."""
    import jax

    devs = jax.devices()
    assert len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}"
    L = f"{FIX}/longsim"
    argv = ["-g", f"{L}/graph.vg", "-f", f"{L}/reads.fastq",
            "-s", f"{L}/seeds.gam", "-b", "35"]
    mesh_dir = os.path.join(OUT, "four_mesh")
    one_dir = os.path.join(OUT, "four_single")
    with Tier("longsim b35 --mesh dp x4", 100) as t:
        run_cli(mesh_dir, argv + ["-a", os.path.join(mesh_dir, "out.gam"),
                                  "--mesh", "dp"])
        t.identical = same_gam(os.path.join(mesh_dir, "out.gam"),
                               f"{L}/golden_b35.gam")
        t.extra = {"per_card_peak_gib": [round(p, 3) for p in _peak_gb()]}
    with Tier("longsim b35 one card", 100) as t:
        run_cli(one_dir, argv + ["-a", os.path.join(one_dir, "out.gam")])
        t.identical = same_gam(os.path.join(one_dir, "out.gam"),
                               os.path.join(mesh_dir, "out.gam"))
    per_card = _peak_gb()
    print("[four] per-card peak GiB: " + json.dumps(
        [round(p, 3) for p in per_card]), flush=True)
    assert all(p > 0 for p in per_card[1:]), "cards 1-3 were never used"


PHASES = {
    "kernels": phase_kernels,
    "goldens": phase_goldens,
    "biggraph": phase_biggraph,
    "full_band": phase_full_band,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card dp mesh path and nothing else")
    args = ap.parse_args(argv)

    import jax

    import graphaligner_tpu  # noqa: F401  (fails outside the repo)
    from graphaligner_tpu.io import native

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU visible (default device: {devs[0].platform})",
              file=sys.stderr)
        return 2
    if native.get_lib() is None:
        print("native library (native/ga_native.cpp) failed to build",
              file=sys.stderr)
        return 3
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT, exist_ok=True)
    t_all = time.time()
    phase_device()
    if args.four:
        phase_four()
    else:
        for name, phase in PHASES.items():
            t0 = time.time()
            phase()
            print(f"[phase] {name} {time.time() - t0:.3f} s", flush=True)
    print(f"[total] {time.time() - t_all:.3f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
