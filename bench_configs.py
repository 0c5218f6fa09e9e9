"""Secondary benches for the BASELINE.json config list (configs 2 + 3;
config 1 = the golden suite, config 4 = bench_biggraph.py, config 5 =
tests/test_multihost.py + parallel/):

2. Linear-chain graph (single contig) with 10kb simulated reads at
   PacBio-class error — the degenerate DP path (band slides along one
   chain; projection/band logic at its cheapest).
3. Bluntified assembly graph (tools/bluntify output, the GfaGraph +
   Bluntify path) with ONT-class reads — exercises overlap trimming and
   denser adjacency.

Prints one JSON line per config. Synthetic inputs (no checked-in
fixtures): generation is seeded and deterministic.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
)

import numpy as np

BASES = np.array(list("ACGT"))


def _align(graph, reads, seed_map, label, extra, bandwidth=35, ramp=0):
    import graphaligner_tpu.core.batch_align as _ba
    from graphaligner_tpu.core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
    )

    aligner = BandedBatchAligner(graph, bandwidth, ramp)
    align_reads_seeded_batch(graph, aligner, reads, seed_map)  # warm
    rw0 = _ba.rewind_count()
    t0 = time.time()
    results = align_reads_seeded_batch(graph, aligner, reads, seed_map)
    dt = time.time() - t0
    if ramp > bandwidth:
        extra = {**extra, "ramp_rewinds": _ba.rewind_count() - rw0}
    bp = sum(len(r.sequence) for r in reads)
    ok = sum(1 for r in results.values() if not r.alignment_failed)
    print(
        json.dumps(
            {
                "config": label,
                "reads": len(reads),
                "aligned": ok,
                "wall_s": round(dt, 2),
                "reads_per_s": round(len(reads) / dt, 1),
                "mbp_per_s": round(bp / dt / 1e6, 2),
                **extra,
            }
        ),
        flush=True,
    )


def bench_linear_chain():
    """Config 2: one linear contig, 10kb reads, ~1% error (PacBio HiFi
    class)."""
    from biggraph_util import make_big_graph, make_reads
    from graphaligner_tpu.io.fastq import FastQ

    # bubble_every > n_segments => pure chain
    graph, backbone, seq = make_big_graph(
        40_000, bubble_every=10**9, seed=3
    )
    reads = make_reads(seq, 200, 10_048, graph, backbone, err=0.01, seed=4)
    fastqs = [FastQ(seq_id=n, sequence=s) for n, s, _ in reads]
    seed_map = {n: [(node, 0, False)] for n, _, node in reads}
    _align(
        graph,
        fastqs,
        seed_map,
        "linear-chain 10kb (BASELINE config 2)",
        {"graph_nodes": graph.node_count},
    )


def bench_bluntified_ont():
    """Config 3: overlap-GFA assembly graph through tools/bluntify, then
    ONT-class (5% error) reads along a traversal."""
    import subprocess
    import tempfile

    from graphaligner_tpu.graph.bigraph import graph_from_gfa_file
    from graphaligner_tpu.io.fastq import FastQ

    rng = np.random.default_rng(17)
    # assembly-overlap chain: unitigs of 600bp overlapping 63bp (dbg
    # k=64); ids 0-based contiguous (both the reference Bluntify and
    # this tool index nodes by raw id — verified byte-identical on this
    # input shape against /tmp/refbuild/bin/Bluntify)
    n_unitigs, ulen, ov = 600, 600, 63
    total = "".join(rng.choice(BASES, n_unitigs * (ulen - ov) + ov))
    lines = []
    step = ulen - ov
    for i in range(n_unitigs):
        lines.append(f"S\t{i}\t{total[i * step:i * step + ulen]}")
        if i:
            lines.append(f"L\t{i - 1}\t+\t{i}\t+\t{ov}M")
    with tempfile.TemporaryDirectory() as td:
        src = os.path.join(td, "overlap.gfa")
        dst = os.path.join(td, "blunt.gfa")
        with open(src, "w") as f:
            f.write("\n".join(lines) + "\n")
        subprocess.run(
            [
                sys.executable,
                "-m",
                "graphaligner_tpu.tools.bluntify",
                str(ov + 1),  # DBG k (uniform k-1 overlaps)
                src,
                dst,
            ],
            check=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
            stderr=subprocess.DEVNULL,
        )
        graph = graph_from_gfa_file(dst)
        # unitig -> blunt middle-node id, recovered by (unique random)
        # sequence: unitig j's overlap-trimmed middle chunk survives
        # bluntification verbatim as one output node
        mid_of = {}
        for line in open(dst):
            if line.startswith("S"):
                _, nid, seq = line.split("\t")
                mid_of[seq.strip()] = int(nid)
    # ONT reads along the blunt backbone
    n_reads, rlen = 200, 10_048
    reads, seed_map = [], {}
    for i in range(n_reads):
        # start past unitig 0 (its blunt node keeps the left overlap, so
        # the middle-chunk lookup below wouldn't match it)
        start = int(rng.integers(step, len(total) - rlen - 1))
        start -= start % step  # snap to a unitig boundary
        j = start // step
        sub = list(total[start : start + rlen])
        err_pos = rng.integers(ov + step, rlen, int(0.05 * rlen))
        for p in err_pos:  # keep the seed chunk exact
            sub[p] = str(rng.choice(BASES))
        name = f"ont{i}"
        reads.append(FastQ(seq_id=name, sequence="".join(sub)))
        # seed: read offset ov sits at unitig j's blunt middle node
        mid = mid_of[total[j * step + ov : (j + 1) * step]]
        seed_map[name] = [(mid, ov, False)]
    _align(
        graph,
        reads,
        seed_map,
        "bluntified assembly + ONT 10kb (BASELINE config 3)",
        {"graph_nodes": graph.node_count},
    )


def bench_variation_ramping():
    """Config 4: chr20-class variation graph (backbone + SNP bubbles)
    with ONT reads carrying 25%-error BURSTS — each burst drives the
    correctness HMM false, firing the bandwidth-ramp rewind path
    (reference GraphAligner.h:2648-2719: rewind to the last confidently-
    correct slice and recompute at the ramp bandwidth). b=5 B=20, the
    golden-verified ramping config."""
    from biggraph_util import make_big_graph, make_reads
    from graphaligner_tpu.io.fastq import FastQ

    rng = np.random.default_rng(29)
    graph, backbone, seq = make_big_graph(150_000, seed=11)
    base_reads = make_reads(seq, 100, 10_048, graph, backbone, err=0.03,
                            seed=12)
    reads, seed_map = [], {}
    for name, s, node in base_reads:
        sub = list(s)
        # three 500bp bursts at 25% extra error, clear of the seed chunk
        for _ in range(3):
            b0 = int(rng.integers(1024, len(sub) - 512))
            for p in rng.integers(b0, b0 + 512, 128):
                sub[p] = str(rng.choice(BASES))
        reads.append(FastQ(seq_id=name, sequence="".join(sub)))
        seed_map[name] = [(node, 0, False)]
    _align(
        graph,
        reads,
        seed_map,
        "variation graph + ONT bursts, ramping b=5 B=20 (BASELINE config 4)",
        {"graph_nodes": graph.node_count},
        bandwidth=5,
        ramp=20,
    )


def bench_ont_tier():
    """ONT-error tier (VERDICT r4 item 7): the CHECKED-IN ~18%-total-
    error fixture (tests/make_fixture_ont.py, reference-binary goldens
    in tests/fixtures/ont, verified on the GPU by tests/test_ont.py /
    chip_smoke.py) at the ramping config — uniform ONT-class error is
    the regime the HMM constants assume
    (AlignmentCorrectnessEstimation.cpp:6-8), so this measures
    ramping-heavy steady-state throughput, not burst recovery."""
    from graphaligner_tpu.graph import load_alignment_graph
    from graphaligner_tpu.io import load_fastq
    from graphaligner_tpu.runtime.aligner import load_seed_hits

    here = os.path.dirname(os.path.abspath(__file__))
    ont = os.path.join(here, "tests", "fixtures", "ont")
    ls = os.path.join(here, "tests", "fixtures", "longsim")
    graph = load_alignment_graph(os.path.join(ls, "graph.vg"))
    reads = load_fastq(os.path.join(ont, "reads.fastq")) * 8  # 200 reads
    seen: dict = {}
    uniq = []
    for r in reads:
        k = seen.get(r.seq_id, 0)
        seen[r.seq_id] = k + 1
        from dataclasses import replace

        uniq.append(replace(r, seq_id=f"{r.seq_id}_t{k}"))
    seeds0 = load_seed_hits(
        os.path.join(ont, "seeds.gam"), [r.seq_id for r in load_fastq(os.path.join(ont, "reads.fastq"))]
    )
    seed_map = {
        r.seq_id: seeds0[r.seq_id.rsplit("_t", 1)[0]] for r in uniq
    }
    _align(
        graph,
        uniq,
        seed_map,
        "ONT ~18% error 10kb, ramping b=5 B=20 (HMM regime)",
        {},
        bandwidth=5,
        ramp=20,
    )


def main():
    bench_linear_chain()
    bench_bluntified_ont()
    bench_variation_ramping()
    bench_ont_tier()


if __name__ == "__main__":
    main()
