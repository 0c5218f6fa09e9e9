"""Data-parallel read sharding over a device mesh.

The unit of parallelism is a read (as in the reference's thread pool,
Aligner.cpp:290); here a batch of reads is sharded across the 'dp' mesh
axis. The graph index and column schedule are replicated per device
(sharding by connected component is the pangenome-scale follow-up), so
the alignment of one read never crosses a chip and the computation needs
zero collectives — results are gathered host-side exactly like the
reference's per-thread result vectors (Aligner.cpp:301-306).
"""

from __future__ import annotations

import numpy as np


def make_mesh(n_devices: int | None = None, axis: str = "dp"):
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def shard_reads_aligner(graph, mesh, axis: str = "dp"):
    """Returns a function aligning a batch of encoded reads with the batch
    dimension sharded over the mesh and the graph replicated."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..core.engine import BatchAligner, _align_batch_device

    ba = BatchAligner(graph)
    batch_sharding = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())

    sched_args = tuple(
        jax.device_put(jnp.asarray(x), replicated)
        for x in (
            ba.sched.code,
            ba.sched.is_start,
            ba.sched.is_source_start,
            ba.sched.pred_nodes,
            ba.sched.node_slot,
        )
    )

    def run(read_codes: np.ndarray, num_slices: int):
        codes = jax.device_put(jnp.asarray(read_codes), batch_sharding)
        return _align_batch_device(
            codes,
            *sched_args,
            num_slices=num_slices,
            num_nodes=ba.sched.num_nodes,
        )

    return ba, run


def shard_banded_scan(graph, mesh, Nm: int = 8, Cm: int = 64, axis: str = "dp"):
    """One banded DP round (core.engine_banded.banded_scan) sharded over
    the mesh: the problem batch is split along `axis` via shard_map, the
    graph tables are replicated, and every lane's band scan runs entirely
    on its device (zero collectives — the multi-chip layout mirrors the
    reference's independent per-thread reads, Aligner.cpp:290).

    Returns (tables, run) where run(codes, seq_lens, steps, start, bw,
    *seed_carry, S_max=...) -> the banded_scan output dict with the batch
    axis sharded."""
    from ..core.engine_banded import banded_scan, build_graph_tables
    from ..ops.kernels import select_kernels

    tables = build_graph_tables(graph)
    kernels = select_kernels(
        mesh.devices.flat[0].platform, k_in=tables.k_in, Nm=Nm
    )

    def run(codes, seq_lens, steps, start, bw, init_ids, init_send,
            init_nmin, init_nend, init_min, *, S_max: int):
        return banded_scan(
            *tables.device_args(), codes, seq_lens, steps, start, bw,
            init_ids, init_send, init_nmin, init_nend, init_min,
            S_max=S_max, Nm=Nm, Cm=Cm, cell=kernels.cell, mesh=mesh,
            mesh_axis=axis,
        )

    return tables, run
