"""Profile banded_scan per-step cost vs batch width on the GPU.

Usage: python profile_scan.py [B ...]   (default: 256 512 1024)

Times one full banded_scan round (dispatch + block on every output) on
real longsim forward-extension problems at S_max=160, reporting
ms/step and ms/step/lane so the B-scaling of the per-step fixed cost is
visible. All timings back-to-back in one process.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def main():
    import jax

    from graphaligner_tpu.core.batch_align import BandedBatchAligner
    from graphaligner_tpu.core.align import _pad_to_word
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    LS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests/fixtures/longsim")
    graph = load_alignment_graph(f"{LS}/graph.vg")
    reads = load_fastq(f"{LS}/reads.fastq")
    seeds = load_seed_hits(f"{LS}/seeds.gam", [r.seq_id for r in reads])

    aligner = BandedBatchAligner(graph, 35, 0)
    print(f"Nm={aligner.Nm} Cm={aligner.Cm} k_in={aligner.tables.k_in} "
          f"k_out={aligner.tables.k_out}", flush=True)

    # forward problems (seed -> read end), the dominant workload
    base_problems = []
    for r in reads:
        node_id, pos, reverse = seeds[r.seq_id][0]
        fw_node = graph.node_lookup[node_id * 2 + (1 if reverse else 0)]
        if pos < len(r.sequence) - 1:
            base_problems.append((_pad_to_word(r.sequence[pos:]), fw_node))
    print(f"{len(base_problems)} forward problems, "
          f"max slices={max(len(s)//64 for s,_ in base_problems)}", flush=True)

    import graphaligner_tpu.core.engine_banded as eb

    mode = sys.argv[1] if len(sys.argv) > 1 else "bscale"
    if mode == "bscale":
        configs = [(256, None), (512, None), (1024, None)]
    else:  # ablate
        configs = [(256, None), (256, "noproj"), (256, "nofix"),
                   (256, "nocells")]

    orig = eb.banded_scan
    results = {}
    for B, ablate in configs:
        def patched(*a, **kw):
            kw["_ablate"] = ablate
            return orig(*a, **kw)
        eb.banded_scan = patched
        import graphaligner_tpu.core.batch_align as ba
        ba.banded_scan = patched

        problems = (base_problems * ((B // len(base_problems)) + 1))[:B]
        tok = aligner._start_run(problems)
        out = tok[6][0]
        for k, v in out.items():
            if hasattr(v, "block_until_ready"):
                v.block_until_ready()
        S_max = tok[4]
        times = []
        for rep in range(3):
            t0 = time.time()
            tok = aligner._start_run(problems)
            out = tok[6][0]
            for k, v in out.items():
                if hasattr(v, "block_until_ready"):
                    v.block_until_ready()
            times.append(time.time() - t0)
        best = min(times)
        results[(B, ablate)] = (best, S_max)
        print(f"B={B:5d} S={S_max} ablate={ablate}: {best*1000:8.1f} ms, "
              f"{best*1000/S_max:7.3f} ms/step, "
              f"{best*1e6/S_max/B:7.2f} us/step/lane  (all: {[round(t,3) for t in times]})",
              flush=True)
    eb.banded_scan = orig


if __name__ == "__main__":
    main()
