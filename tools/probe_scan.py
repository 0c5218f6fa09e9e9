"""Scan-phase cost decomposition on the GPU: times ONE banded
scan round (dispatch -> control ready) under the GA_ABLATE switches,
back-to-back in one process, so the slice step's fixed costs can be
attributed (projection / fixpoint / cell kernel / the rest).

ABLATED SCANS PRODUCE WRONG ALIGNMENTS — this probe never runs the
replay or the walk, only the raw scan.

Usage: python -m tools.probe_scan [corpus] [n_reads] [reps]
       (default longsim 200 3)
Prints one JSON line per configuration.
"""

import json
import os
import sys
import time


def build_problems(graph, reads, seed_map):
    """First-wave extension problems, via the SAME helper
    align_reads_seeded_batch uses (seed_extension_problems), so the
    probe always measures the production workload."""
    from graphaligner_tpu.core.batch_align import seed_extension_problems

    problems = []
    for r in reads:
        seeds = seed_map.get(r.seq_id, [])
        if not seeds:
            continue
        bw, fw = seed_extension_problems(graph, r.sequence, seeds[0])
        if bw is not None:
            problems.append(bw)
        if fw is not None:
            problems.append(fw)
    return problems


CONFIGS = [
    ("full", None),
    ("noproj (band projection ablated)", "noproj"),
    ("nofix (cyclic fixpoint ablated)", "nofix"),
    ("nocells (cell kernel + fixpoint ablated)", "nocells"),
    ("full rerun", None),
]


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    from bench import load_corpus, tile_reads
    from graphaligner_tpu.core.batch_align import BandedBatchAligner

    corpus = argv[0] if argv else "longsim"
    n_reads = int(argv[1]) if len(argv) > 1 else 200
    reps = int(argv[2]) if len(argv) > 2 else 3

    graph, reads, seeds = load_corpus(corpus)
    tile = max(1, -(-n_reads // len(reads)))
    reads, seeds = tile_reads(reads, seeds, tile)
    reads = reads[:n_reads]
    problems = build_problems(graph, reads, seeds)
    print(json.dumps({"corpus": corpus, "reads": len(reads),
                      "problems": len(problems)}), flush=True)

    ba = BandedBatchAligner(graph, 35, 0)
    for label, ablate in CONFIGS:
        if ablate:
            os.environ["GA_ABLATE"] = ablate
        else:
            os.environ.pop("GA_ABLATE", None)
        # warm (compile)
        tok = ba._start_run(problems)
        jax.block_until_ready(tok[6][0]["control"])
        times = []
        for _ in range(reps):
            t0 = time.time()
            tok = ba._start_run(problems)
            jax.block_until_ready(tok[6][0]["control"])
            times.append(time.time() - t0)
        print(json.dumps({
            "config": label,
            "scan_s": round(min(times), 3),
            "all": [round(t, 3) for t in times],
        }), flush=True)


if __name__ == "__main__":
    main()
