"""End-to-end throughput of the seeded banded pipeline, and the A/B of
each hand-written GPU kernel against its plain XLA counterpart.

    python bench.py [--corpus longsim,sim] [--tile N] [--repeat N]
                    [--kernels triton/triton,xla/xla,...]

Each configuration is cell/walk: "triton" = the Pallas kernel, "xla" =
the plain path (ops.kernels). In one process, each configuration gets
its aligner and one warm-up pass (its compiles), then --repeat rounds
of timed passes run the configurations in the order given and reversed
in turn. Every pass prints one JSON line: reads/s and Mbp/s from reads
to wire-ready GAM payloads, wall and compile seconds, the device and the
card's name and power limit. A run that falls back to the host oracle
fails (GA_NO_FALLBACK=1); a run that finds no GPU fails.

Corpora (tests/fixtures): longsim = 100 simulated 10 kb reads at ~5%
error on an 8.4k-node variation graph, -b 35; sim = 20 600 bp reads on a
bubble graph, -b 35. --tile repeats the corpus (longsim x10 = 1000
reads, sim x25 = 500 reads by default).
"""

import argparse
import json
import os
import sys
import time
from dataclasses import replace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
os.environ["GA_NO_FALLBACK"] = "1"

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests/fixtures")
DEFAULT_TILE = {"longsim": 10, "sim": 25}
_COMPILE_S = [0.0]


def load_corpus(corpus):
    """(graph, reads, seed map) of a checked-in corpus."""
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    names = {
        "longsim": ("graph.vg", "reads.fastq", "seeds.gam"),
        "sim": ("bubbles.vg", "sim.fastq", "seeds.gam"),
    }[corpus]
    d = os.path.join(FIX, corpus)
    graph = load_alignment_graph(os.path.join(d, names[0]))
    reads = load_fastq(os.path.join(d, names[1]))
    seeds = load_seed_hits(os.path.join(d, names[2]), [r.seq_id for r in reads])
    return graph, reads, seeds


def tile_reads(reads, seeds, times):
    out, smap = [], {}
    for t in range(times):
        for r in reads:
            rid = f"{r.seq_id}_t{t}"
            out.append(replace(r, seq_id=rid))
            smap[rid] = seeds[r.seq_id]
    return out, smap


def make_run(corpus, tile=None, kernels=None):
    """A timed end-to-end pass over a tiled corpus, as a function of no
    arguments returning the result dict; the aligner (and its compiled
    programs) lives as long as the function."""
    import jax

    from graphaligner_tpu.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )
    from graphaligner_tpu.io import native

    tile = DEFAULT_TILE[corpus] if tile is None else tile
    graph, reads, seeds = load_corpus(corpus)
    reads, seeds = tile_reads(reads, seeds, tile)
    aligner = BandedBatchAligner(graph, 35, 0, kernels=kernels)
    bp = sum(len(r.sequence) for r in reads)

    def run():
        c0 = _COMPILE_S[0]
        t0 = time.time()
        res = align_reads_seeded_batch(graph, aligner, reads, seeds)
        # wire-ready GAM payloads are part of the timed work
        enc = [
            (r, res[r.seq_id].alignment) for r in reads
            if getattr(res[r.seq_id].alignment, "_runs", None) is not None
        ]
        payloads = native.encode_alignments(
            [r.seq_id for r, _ in enc], [r.sequence for r, _ in enc],
            [a.score for _, a in enc], [a.query_position for _, a in enc],
            [a._runs for _, a in enc], div2=True,
        )
        dt = time.time() - t0
        assert payloads is not None and all(len(p) > 0 for p in payloads)
        d = jax.devices()[0]
        return {
            "corpus": f"{corpus} x{tile}",
            "cell": aligner.kernels.cell,
            "walk": aligner.kernels.walk,
            "reads": len(reads),
            "wall_s": dt,
            "compile_s": _COMPILE_S[0] - c0,
            "reads_per_s": len(reads) / dt,
            "mbp_per_s": bp / dt / 1e6,
            "device": {"platform": d.platform, "kind": d.device_kind,
                       "count": len(jax.devices())},
        }

    return run


def run_corpus(corpus, tile=None, kernels=None):
    """One warm-up pass that compiles every signature, then one timed
    pass. Returns the timed pass's result dict."""
    run = make_run(corpus, tile, kernels)
    run()
    return run()


def _on_duration(event, duration, **_):
    if event.startswith("/jax/core/compile/"):
        _COMPILE_S[0] += duration


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", default="longsim,sim")
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--kernels", default="triton/triton",
                    help="comma-separated cell/walk configurations")
    ap.add_argument("--repeat", type=int, default=1,
                    help="timed passes per configuration")
    args = ap.parse_args(argv)

    import jax

    from chip_smoke import nvidia_smi_line
    from graphaligner_tpu.core.engine_banded import build_graph_tables
    from graphaligner_tpu.ops.kernels import Kernels, select_kernels

    if jax.devices()[0].platform != "gpu":
        print("bench.py measures the GPU; none is visible", file=sys.stderr)
        return 2
    jax.monitoring.register_event_duration_secs_listener(_on_duration)
    card = nvidia_smi_line()
    cfgs = args.kernels.split(",")
    for corpus in args.corpus.split(","):
        k_in = build_graph_tables(load_corpus(corpus)[0]).k_in
        auto = select_kernels("gpu", k_in=k_in, Nm=32)
        runs = {}
        for cfg in cfgs:
            cell, walk = cfg.split("/")
            kernels = Kernels(
                cell=cell, walk=walk,
                long_walk=auto.long_walk and ("triton" if walk == "triton"
                                              else "xla"),
            )
            runs[cfg] = make_run(corpus, args.tile, kernels=kernels)
            r = runs[cfg]()  # warm-up: compiles every signature
            print(json.dumps(dict(r, rep="warm-up", card=card)), flush=True)
        # timed passes, the order reversed on every other repetition so
        # that drift falls on every configuration alike
        for rep in range(args.repeat):
            for cfg in cfgs if rep % 2 == 0 else cfgs[::-1]:
                r = runs[cfg]()
                print(json.dumps(dict(r, rep=rep, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
