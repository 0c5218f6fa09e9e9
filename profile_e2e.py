"""End-to-end stage breakdown of the batched pipeline on the GPU.

Wraps the phase methods of BandedBatchAligner with cumulative wall-time
counters and runs the bench.py longsim workload (warm, then timed).
Because device work is asynchronous, time blocks wherever the host first
waits — so the numbers attribute WALL time at each blocking point, which
is exactly what end-to-end throughput is made of.

Usage: python profile_e2e.py [longsim|sim] [tile]
"""

import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault("GA_NO_FALLBACK", "1")

CUM = defaultdict(float)
CNT = defaultdict(int)


def _wrap(cls_or_mod, name, key=None):
    key = key or name
    orig = getattr(cls_or_mod, name)

    def timed(*a, **kw):
        t0 = time.time()
        try:
            return orig(*a, **kw)
        finally:
            CUM[key] += time.time() - t0
            CNT[key] += 1

    setattr(cls_or_mod, name, timed)


def main():
    corpus = sys.argv[1] if len(sys.argv) > 1 else "longsim"
    tile = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    from dataclasses import replace

    from graphaligner_tpu.core import batch_align as ba
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    FIX = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "tests/fixtures", corpus
    )
    names = {
        "longsim": ("graph.vg", "reads.fastq", "seeds.gam"),
        "sim": ("bubbles.vg", "sim.fastq", "seeds.gam"),
    }[corpus]
    if corpus == "sim":
        tile *= 25
    graph = load_alignment_graph(os.path.join(FIX, names[0]))
    reads0 = load_fastq(os.path.join(FIX, names[1]))
    seeds0 = load_seed_hits(os.path.join(FIX, names[2]), [r.seq_id for r in reads0])
    reads, seeds = [], {}
    for t in range(tile):
        for r in reads0:
            rid = f"{r.seq_id}_t{t}"
            reads.append(replace(r, seq_id=rid))
            seeds[rid] = seeds0[r.seq_id]

    B = ba.BandedBatchAligner
    for name in (
        "_dispatch_round",     # build inputs + async device dispatch
        "_finish_round",       # BLOCKS on the packed control fetch
        "_replay_bulk",        # vectorized host control replay
        "_replay",             # per-lane replay (rewinds)
        "_gather_walk_inputs", # walk-start summary gather + [B,10] fetch
        "_fetch_walk_rows",    # row-subset fetch for multi-node tie lanes
        "_walk_starts",        # start decision + tie resolution
        "_band_orders",        # the tie band-order replay inside ^
        "_consolidate",        # device gather of walk tables
        "_walk_moves_dispatch",# walk kernel dispatch
        "_walk_moves_collect", # BLOCKS on moves + native decode
        "_walk_xla",           # XLA fallback walk (should be ~0)
        "_stash_round_boundary",
        "_start_run",          # FFD packing + codes layout + dispatch
        "_build_table",        # host oracle-table fallback (should be ~0)
    ):
        _wrap(B, name)
    # module-qualified calls (batch_align calls trace_ops.trace_to_runs /
    # merge_runs through the module object, so rebinding works)
    from graphaligner_tpu.core import trace_ops as _to

    _wrap(_to, "trace_to_runs")
    _wrap(_to, "merge_runs")

    aligner = B(graph, 35, 0)
    ba.align_reads_seeded_batch(graph, aligner, reads, seeds)  # warm
    CUM.clear()
    CNT.clear()
    t0 = time.time()
    res = ba.align_reads_seeded_batch(graph, aligner, reads, seeds)
    dt = time.time() - t0
    ok = sum(1 for r in res.values() if not r.alignment_failed)
    print(f"\n{corpus} x{tile}: {len(reads)} reads ({ok} ok) in {dt:.2f}s "
          f"= {len(reads)/dt:.1f} reads/s")
    acc = 0.0
    for k in sorted(CUM, key=lambda k: -CUM[k]):
        print(f"  {k:22s} {CUM[k]*1000:9.1f} ms  x{CNT[k]}")
        acc += CUM[k]
    # _band_orders is nested inside _walk_starts; don't double count
    acc -= CUM.get("_band_orders", 0.0)
    print(f"  {'(unattributed)':22s} {(dt-acc)*1000:9.1f} ms")


if __name__ == "__main__":
    main()
