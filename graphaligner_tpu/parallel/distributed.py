"""Multi-host orchestration: jax.distributed bring-up, per-host read
sharding, and GAM shard merging.

Mirrors the reference's single-machine structure at pod scale: the graph
index is replicated per host (component sharding is the pangenome-scale
follow-up), the read set is split across hosts (DCN) and across each
host's devices (ICI, parallel.mesh), each read's alignment stays on one
chip, and results are written as per-host GAM shards then concatenated —
the pod-scale analogue of the reference's per-thread result vectors +
final concat (Aligner.cpp:276-314).
"""

from __future__ import annotations

import os

from ..io import stream, vg


def gpu_local_device(process_id: int, environ=os.environ) -> int:
    """The one card a GPU process opens, from the launcher's
    CUDA_VISIBLE_DEVICES: its only entry, or with n entries the process
    id modulo n (processes numbered host-major, n per host)."""
    visible = [v for v in environ.get("CUDA_VISIBLE_DEVICES", "").split(",")
               if v.strip()]
    if not visible:
        raise ValueError(
            "multi-process on GPUs: set CUDA_VISIBLE_DEVICES for each "
            "process (its card, or the host's cards)"
        )
    return process_id % len(visible)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> tuple:
    """Bring up jax.distributed (no-op for single-process runs). On a GPU
    every process opens exactly one card (gpu_local_device).

    Returns (process_index, process_count)."""
    import jax

    if coordinator_address is not None:
        kw = {}
        if "cpu" in os.environ.get("JAX_PLATFORMS", ""):
            # CPU multi-process needs the gloo collectives client or the
            # backend stays single-process (process_count() == 1)
            try:
                jax.config.update(
                    "jax_cpu_collectives_implementation", "gloo"
                )
            except Exception:
                pass
        else:
            kw["local_device_ids"] = [gpu_local_device(process_id)]
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            **kw,
        )
    return jax.process_index(), jax.process_count()


def shard_reads_for_host(reads: list, process_index: int, process_count: int) -> list:
    """Strided split of the read set across hosts — deterministic, no
    coordination needed (every host computes its own shard)."""
    return reads[process_index::process_count]


def shard_path(alignment_file: str, process_index: int) -> str:
    root, ext = os.path.splitext(alignment_file)
    return f"{root}.shard{process_index}{ext}"


def write_host_shard(alignment_file: str, alignments: list, process_index: int) -> str:
    path = shard_path(alignment_file, process_index)
    stream.write_messages(path, alignments)
    return path


def barrier(name: str = "ga-shards") -> None:
    """Block until every process reaches this point (host 0 must not
    merge before the other hosts finish writing their shards). No-op for
    single-process runs."""
    import jax

    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


def ordinal_path(alignment_file: str, process_index: int) -> str:
    return shard_path(alignment_file, process_index) + ".ord"


def write_shard_ordinals(
    alignment_file: str,
    process_index: int,
    process_count: int,
    shard_read_ids: list,
    alignments: list,
    ordinals: list | None = None,
) -> str:
    """Sidecar of GLOBAL traversal ordinals, one per shard message.

    Reads with no seed hits or a failed alignment emit NO message
    (Aligner.cpp:124-148 analog), so a positional round-robin interleave
    cannot reconstruct the single-process output order — the merge
    k-way-merges payloads by these ordinals instead. Alignments are
    produced in shard traversal order, so matching names in order
    recovers each message's shard position j; the global ordinal is
    ordinals[j] when the caller routed reads explicitly (component
    sharding), else process_index + j * process_count (strided split)."""
    path = ordinal_path(alignment_file, process_index)
    j = 0
    lines = []
    for a in alignments:
        name = a.name
        while j < len(shard_read_ids) and shard_read_ids[j] != name:
            j += 1
        if j >= len(shard_read_ids):
            raise RuntimeError(
                f"alignment {name!r} not found in shard read order"
            )
        lines.append(
            str(
                ordinals[j]
                if ordinals is not None
                else process_index + j * process_count
            )
        )
        j += 1
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return path


def merge_shards(alignment_file: str, process_count: int) -> int:
    """Merge per-host GAM shards into the final file (host 0, after
    barrier()) as a STREAM: raw message payloads are k-way merged by
    global read ordinal (see write_shard_ordinals) without protobuf
    decode/encode, reading each shard incrementally and compressing the
    output incrementally — peak memory is O(process_count), not corpus
    size, and the merged bytes equal a single-process run's output
    exactly. Returns the alignment count.

    Shards written without ordinal sidecars (direct write_host_shard
    users) fall back to a round-robin interleave, which is only correct
    when every read emitted exactly one message."""
    import heapq

    have_ord = all(
        os.path.exists(ordinal_path(alignment_file, i))
        for i in range(process_count)
    )
    if not have_ord:
        per_shard = []
        for i in range(process_count):
            with open(shard_path(alignment_file, i), "rb") as f:
                per_shard.append(list(stream.iter_messages(f.read())))
        merged = []
        for j in range(max(len(s) for s in per_shard) if per_shard else 0):
            for s in per_shard:
                if j < len(s):
                    merged.append(s[j])
        stream.write_payloads(alignment_file, merged)
        return len(merged)

    def shard_stream(i):
        with open(ordinal_path(alignment_file, i)) as of:
            for line, payload in zip(
                of, stream.iter_payloads_file(shard_path(alignment_file, i))
            ):
                yield int(line), payload

    n = 0
    with stream.PayloadStreamWriter(alignment_file) as w:
        for _, payload in heapq.merge(
            *[shard_stream(i) for i in range(process_count)]
        ):
            w.write(payload)
            n += 1
    return n
