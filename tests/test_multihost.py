"""Multi-host end-to-end: two local processes via jax.distributed, a
strided read shard each, per-host GAM shards, barrier, and a host-0
STREAMING merge whose bytes equal a single-process run (reference analog:
per-thread results + concat, Aligner.cpp:276-314)."""

import os
import pathlib
import socket
import subprocess
import sys

FIX = pathlib.Path(__file__).parent / "fixtures"
REPO = pathlib.Path(__file__).parent.parent

WORKER = r"""
import sys
sys.path.insert(0, sys.argv[5])

coordinator, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
fixtures = sys.argv[4]
fastq = sys.argv[6]
# distributed bring-up MUST precede anything that initializes jax
# backends (importing the package is fine; calling jax.devices() is not)
from graphaligner_tpu.parallel import distributed

pidx, pcount = distributed.initialize(coordinator, 2, pid)
assert pcount == 2, pcount
from graphaligner_tpu.core.params import AlignerParams
from graphaligner_tpu.runtime.aligner import align_reads
params = AlignerParams(
    graph_file=f"{fixtures}/sim/bubbles.vg",
    fastq_file=fastq,
    alignment_file=out,
    seed_file=f"{fixtures}/sim/seeds.gam",
    initial_bandwidth=35,
)
align_reads(params, log=lambda *a: None, output_dir="/tmp/ga_dist",
            backend="jax", process_index=pidx, process_count=pcount)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_shard_align_merge(tmp_path):
    out = str(tmp_path / "merged.gam")
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    # insert reads with NO seed hits mid-corpus: they emit no GAM message,
    # so the merge must order by global read ordinal (a positional
    # round-robin interleave would shift every later read)
    lines = (FIX / "sim" / "sim.fastq").read_text().splitlines()
    recs = [lines[i : i + 4] for i in range(0, len(lines), 4)]
    noseed = ["@no_seed_read", "ACGT" * 40, "+", "!" * 160]
    recs = recs[:3] + [noseed] + recs[3:7] + [
        ["@no_seed_read2", "TTGCA" * 30, "+", "!" * 150]
    ] + recs[7:]
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("\n".join("\n".join(r) for r in recs) + "\n")
    os.makedirs("/tmp/ga_dist", exist_ok=True)
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # workers use plain single-device CPU
    env["PYTHONPATH"] = str(REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), out, str(FIX),
             str(REPO), str(fastq)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for pid in range(2)
    ]
    for p in procs:
        try:
            outb, errb = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            raise
        assert p.returncode == 0, errb.decode()[-3000:]

    # single-process reference run in-process
    os.makedirs("/tmp/ga_dist", exist_ok=True)
    from graphaligner_tpu.core.params import AlignerParams
    from graphaligner_tpu.runtime.aligner import align_reads

    solo = str(tmp_path / "solo.gam")
    params = AlignerParams(
        graph_file=str(FIX / "sim" / "bubbles.vg"),
        fastq_file=str(fastq),
        alignment_file=solo,
        seed_file=str(FIX / "sim" / "seeds.gam"),
        initial_bandwidth=35,
    )
    align_reads(params, log=lambda *a: None, output_dir="/tmp/ga_dist",
                backend="jax")
    with open(out, "rb") as f:
        merged = f.read()
    with open(solo, "rb") as f:
        single = f.read()
    assert merged == single, "merged multi-host GAM differs from single-process bytes"


def test_gpu_process_opens_one_card_from_the_launcher():
    import pytest

    from graphaligner_tpu.parallel.distributed import gpu_local_device

    assert gpu_local_device(5, {"CUDA_VISIBLE_DEVICES": "3"}) == 0
    assert gpu_local_device(5, {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}) == 1
    assert gpu_local_device(2, {"CUDA_VISIBLE_DEVICES": "0, 1"}) == 0
    with pytest.raises(ValueError, match="CUDA_VISIBLE_DEVICES"):
        gpu_local_device(0, {})
