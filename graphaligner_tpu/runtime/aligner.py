"""The alignment driver (reference Aligner.cpp).

Loads the graph / reads / seeds, aligns every read, writes per-read GAM
and trace files incrementally (so a crashed run's completed reads
survive, Aligner.cpp:177-201), converts digraph ids back to bigraph ids
(÷2, Aligner.cpp:83-91), and concatenates results into the output GAM.

Read scheduling matches the reference: reads are popped from the back of
the queue (Aligner.cpp:113-115), so single-worker output order equals
the reference's single-thread order. Failures are isolated per read
(the reference catches AssertionFailure; here any exception is caught
and the read skipped, Aligner.cpp:124-148).
"""

from __future__ import annotations

import os
import sys
import traceback

from ..core.align import align_one_way_full_band, align_one_way_seeded
from ..core.params import AlignerParams
from ..core.result import INT32_MAX, AlignmentResult
from ..graph.bigraph import load_alignment_graph
from ..io import load_fastq, stream, vg


def replace_digraph_node_ids(alignment: vg.Alignment) -> None:
    for m in alignment.path.mapping:
        m.position.node_id //= 2


def write_trace(trace, path: str) -> None:
    """Trace file format of the reference's writeTrace (Aligner.cpp:93-100):
    nodeID offset reverse readpos type graphChar readChar."""
    with open(path, "w") as f:
        for t in trace:
            f.write(
                f"{t.node_id} {t.offset} {1 if t.reverse else 0} {t.readpos} "
                f"{int(t.type)} {t.graph_char} {t.read_char}\n"
            )


def _finalize_output_alignment(alignment):
    """Digraph->bigraph id mapping + wire encoding of one result.

    LazyAlignment results (the batched pipeline) encode through the
    native C++ serializer with the id division fused (~100x the Python
    object+encode path); everything else takes the object path
    (replace ids in place, byte-identical either way)."""
    from ..core.result import LazyAlignment, PayloadAlignment
    from ..io import native

    if isinstance(alignment, LazyAlignment) and alignment._obj is None:
        payloads = native.encode_alignments(
            [alignment.name],
            [alignment.sequence],
            [alignment.score],
            [alignment.query_position],
            [alignment._runs],
            div2=True,
        )
        if payloads is not None:
            return PayloadAlignment(payloads[0], name=alignment.name)
    replace_digraph_node_ids(alignment)
    return alignment


def _safe_filename(name: str) -> str:
    return name.replace("/", "_").replace(":", "_")


def load_seed_hits(seed_file: str, read_names) -> dict:
    """read name → [(node id, query position, is_reverse)]
    (reference Aligner.cpp:245-273)."""
    seeds: dict = {}
    for a in stream.read_messages(seed_file, vg.Alignment):
        seeds.setdefault(a.name, []).append(
            (
                a.path.mapping[0].position.node_id,
                a.query_position,
                a.path.mapping[0].position.is_reverse,
            )
        )
    return {name: seeds.get(name, []) for name in read_names}


def align_reads(params: AlignerParams, *args, **kwargs) -> list:
    """Public driver entry; handles the multi-host merge tail around
    _align_reads_impl (see its docstring)."""
    process_index = kwargs.get("process_index")
    process_count = kwargs.get("process_count")
    shard_info: dict = {}
    out = _align_reads_impl(params, *args, _shard_info=shard_info, **kwargs)
    if process_count is not None and process_count > 1:
        from ..parallel import distributed as _dist

        if params.alignment_file:
            # ordinal sidecar: reads with no seeds / failed alignments
            # emit no message, so the merge must order by global read
            # ordinal, not by shard position
            _dist.write_shard_ordinals(
                params.alignment_file,
                process_index,
                process_count,
                shard_info.get("ids", []),
                out,
                ordinals=shard_info.get("ordinals"),
            )
        _dist.barrier()
        if process_index == 0 and params.alignment_file:
            n = _dist.merge_shards(params.alignment_file, process_count)
            print(f"merged {n} alignments from {process_count} host shards")
    return out


def _align_reads_impl(
    params: AlignerParams,
    log=print,
    output_dir: str = ".",
    slice_backend=None,
    backend: str = "oracle",
    device_batch: int = 256,
    mesh_axis: str = "none",
    process_index: int | None = None,
    process_count: int | None = None,
    shard_mode: str = "reads",
    _shard_info: dict | None = None,
) -> list:
    """Align all reads; returns the list of output vg Alignments.

    backend='jax' runs seeded mode through the batched banded device
    engine (per-lane fallbacks: bigger capacity tier, then host oracle)
    and full-band (-i) through the batched exhaustive engine;
    backend='oracle' runs everything on the scalar host pipeline.
    backend='auto' (the CLI default) resolves to 'jax' whenever a jax
    backend initializes — the device engine is the product path
    (reference analog: AlignerMain.cpp has no slow-path flag at all) —
    and falls back to 'oracle' with a loud log otherwise.
    """
    if backend == "auto":
        try:
            import jax

            dev = jax.devices()[0]
            backend = "jax"
            log(f"backend auto: device engine on {dev.platform}")
        except Exception as e:
            backend = "oracle"
            log(
                "backend auto: no usable jax backend "
                f"({type(e).__name__}: {e}); FALLING BACK to the scalar "
                "host oracle — expect reference-CPU speeds"
            )
    os.makedirs(output_dir, exist_ok=True)
    dist = process_count is not None and process_count > 1
    final_alignment_file = params.alignment_file
    if dist:
        # multi-host: each process aligns its strided read shard into a
        # per-host GAM shard; host 0 stream-merges after the barrier
        # (the pod-scale analog of Aligner.cpp:276-314)
        from dataclasses import replace as _dc_replace

        from ..parallel import distributed as _dist

        params = _dc_replace(
            params,
            alignment_file=_dist.shard_path(
                final_alignment_file, process_index
            )
            if final_alignment_file
            else "",
        )
    fastqs = load_fastq(params.fastq_file)
    graph = None
    if dist:
        from ..parallel import distributed as _dist

        # stride over the driver's TRAVERSAL order (back-to-front, the
        # reference's shared stack) so the ordinal shard merge
        # reconstructs the single-process output order byte for byte
        traversal = list(reversed(fastqs))
        if shard_mode == "components":
            # pangenome-scale: each host loads only ITS connected
            # components and aligns the reads whose seeds live there
            # (parallel.components; SURVEY §5 distributed bullet)
            if not params.seed_file:
                raise ValueError(
                    "--shard components requires a seed file (-s)"
                )
            from ..parallel import components as _comp

            all_seeds = load_seed_hits(
                params.seed_file, [f.seq_id for f in traversal]
            )
            graph, read_host = _comp.load_component_shard(
                params.graph_file, all_seeds, process_index, process_count
            )
            pairs = [
                (j, f)
                for j, f in enumerate(traversal)
                if read_host(f.seq_id) == process_index
            ]
            shard = [f for _, f in pairs]
            ordinals = [j for j, _ in pairs]
        else:
            shard = _dist.shard_reads_for_host(
                traversal, process_index, process_count
            )
            ordinals = list(
                range(process_index, len(traversal), process_count)
            )
        if _shard_info is not None:
            # shard read ids in TRAVERSAL order + their global traversal
            # ordinals, for the ordinal sidecar
            _shard_info["ids"] = [f.seq_id for f in shard]
            _shard_info["ordinals"] = ordinals
        fastqs = list(reversed(shard))
        log(f"process {process_index}/{process_count}: {len(fastqs)} reads")
    log(f"{len(fastqs)} reads")
    seed_hits = None
    if params.seed_file:
        seed_hits = load_seed_hits(params.seed_file, [f.seq_id for f in fastqs])
    if graph is None:
        log(f"load graph from {params.graph_file}")
        graph = load_alignment_graph(params.graph_file)
    s = graph.stats
    log(f"{s.nodes} nodes\n{s.bp}bp\n{s.edges} edges\n{s.high_in_degree_nodes} nodes with in-degree >= 2")

    if backend == "jax" and seed_hits is None:
        try:
            return _align_reads_batched(
                params, graph, fastqs, log, output_dir, device_batch
            )
        except ValueError as e:
            if os.environ.get("GA_NO_FALLBACK") == "1":
                raise
            log(f"device engine unavailable ({e}); falling back to oracle")
    elif backend == "jax":
        # seeded mode pipelines device chunks inside get_traces; feed it
        # large waves so chunk k+1's scan overlaps chunk k's host work
        try:
            return _align_reads_seeded_batched(
                params, graph, fastqs, seed_hits, log, output_dir,
                max(device_batch, 4096), mesh_axis=mesh_axis,
            )
        except Exception:
            # the reference isolates failures per read (Aligner.cpp:124-148);
            # if the batched pipeline dies wholesale, recover through the
            # per-read host path instead of losing the run —
            # UNLESS GA_NO_FALLBACK=1 (bench/CI fail-loud mode): a run
            # that silently completes 100x slower must not look green
            if os.environ.get("GA_NO_FALLBACK") == "1":
                raise
            from ..core import batch_align

            batch_align._FALLBACKS["other"] += 1
            log("batched device pipeline failed (exception!); "
                "falling back to the per-read host path")
            traceback.print_exc(file=sys.stderr)

    backend_kwargs = {}
    if slice_backend is not None:
        backend_kwargs["slice_backend"] = slice_backend

    alignments: list = []
    queue = list(fastqs)
    while queue:
        fastq = queue.pop()  # back-first, like the reference's shared stack
        log(f"thread 0 {len(queue)} left")
        log(f"read {fastq.seq_id} size {len(fastq.sequence)}bp")
        # native crash attribution (reference assertSetRead,
        # Aligner.cpp:121): a SIGSEGV inside a native call now names
        # this read and fails only it
        from ..io import native as _native

        _native.set_read(fastq.seq_id)
        try:
            if seed_hits is None:
                result = align_one_way_full_band(
                    graph,
                    fastq.seq_id,
                    fastq.sequence,
                    params.initial_bandwidth,
                    params.ramp_bandwidth,
                    **backend_kwargs,
                )
            else:
                if not seed_hits.get(fastq.seq_id):
                    log(f"read {fastq.seq_id} has no seed hits")
                    log(f"read {fastq.seq_id} alignment failed")
                    continue
                result = align_one_way_seeded(
                    graph,
                    fastq.seq_id,
                    fastq.sequence,
                    params.initial_bandwidth,
                    params.ramp_bandwidth,
                    seed_hits[fastq.seq_id],
                    logger=log,
                    **backend_kwargs,
                )
        except Exception:
            log(f"read {fastq.seq_id} alignment failed (exception!)")
            traceback.print_exc(file=sys.stderr)
            continue
        log(f"read {fastq.seq_id} took {result.elapsed_milliseconds}ms")
        if result.alignment_failed or result.alignment.score == INT32_MAX:
            log(f"read {fastq.seq_id} alignment failed")
            continue
        log(f"read {fastq.seq_id} score {result.alignment.score}")
        if result.alignment.score > len(fastq.sequence) * 0.25:
            log(f"read {fastq.seq_id} score is poor: {result.alignment.score}")
        log(
            f"read {fastq.seq_id} alignment positions: "
            f"{result.alignment_start}-{result.alignment_end} "
            f"(read {len(fastq.sequence)}bp)"
        )
        replace_digraph_node_ids(result.alignment)
        alignments.append(result.alignment)
        name = _safe_filename(fastq.seq_id)
        gam_path = os.path.join(output_dir, f"alignment_0_{name}.gam")
        stream.write_messages(gam_path, [result.alignment])
        write_trace(result.trace, os.path.join(output_dir, f"trace_0_{name}.trace"))

    log(f"final result has {len(alignments)} alignments")
    if params.alignment_file:
        stream.write_messages(params.alignment_file, alignments)
    if params.auggraph_file:
        graphs = stream.read_messages(params.graph_file, vg.Graph)
        # reference quirk: stream::write_buffered CLEARS the alignment
        # vector (stream.hpp:54-63), so when -a was also given the
        # augmented graph is built from an EMPTY list (Aligner.cpp:310-321)
        aug_input = [] if params.alignment_file else alignments
        aug = augment_graph_with_alignments(graphs, aug_input)
        stream.write_messages(params.auggraph_file, [aug])
    return alignments


def _align_reads_seeded_batched(
    params, graph, fastqs, seed_hits, log, output_dir: str,
    device_batch: int, mesh_axis: str = "none",
) -> list:
    """Seeded banded alignment through the batched device engine
    (core.batch_align): reads are aligned in device-sized chunks; per-read
    GAM/trace outputs and the final concatenated GAM mirror the per-read
    path byte for byte. mesh_axis='dp' shards every device batch
    data-parallel over all local devices via shard_map (the multi-chip
    analog of the reference's thread pool, Aligner.cpp:275-314)."""
    from ..core.batch_align import (
        BandedBatchAligner,
        align_reads_seeded_batch,
        set_host_threads,
    )

    if params.num_threads and params.num_threads > 1:
        set_host_threads(params.num_threads)
    mesh = None
    if mesh_axis and mesh_axis != "none":
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(axis=mesh_axis)
        log(f"device mesh: {mesh.devices.size} devices along '{mesh_axis}'")
    aligner = BandedBatchAligner(
        graph, params.initial_bandwidth, params.ramp_bandwidth,
        mesh=mesh, mesh_axis=mesh_axis if mesh is not None else "dp",
    )
    alignments: list = []
    order = list(reversed(fastqs))  # match the per-read path's order
    for start in range(0, len(order), device_batch):
        chunk = [r for r in order[start : start + device_batch]]
        with_seeds = [r for r in chunk if seed_hits.get(r.seq_id)]
        for r in chunk:
            if not seed_hits.get(r.seq_id):
                log(f"read {r.seq_id} has no seed hits")
                log(f"read {r.seq_id} alignment failed")
        results = align_reads_seeded_batch(graph, aligner, with_seeds, seed_hits)
        for fastq in with_seeds:
            result = results[fastq.seq_id]
            log(f"read {fastq.seq_id} size {len(fastq.sequence)}bp")
            if result.alignment_failed or result.alignment.score == INT32_MAX:
                log(f"read {fastq.seq_id} alignment failed")
                continue
            log(f"read {fastq.seq_id} score {result.alignment.score}")
            if result.alignment.score > len(fastq.sequence) * 0.25:
                log(f"read {fastq.seq_id} score is poor: {result.alignment.score}")
            log(
                f"successfully aligned read {fastq.seq_id} with "
                f"{result.cells_processed} cells"
            )
            aln = _finalize_output_alignment(result.alignment)
            alignments.append(aln)
            name = _safe_filename(fastq.seq_id)
            stream.write_messages(
                os.path.join(output_dir, f"alignment_0_{name}.gam"),
                [aln],
            )
            write_trace(
                result.trace, os.path.join(output_dir, f"trace_0_{name}.trace")
            )
    log(f"final result has {len(alignments)} alignments")
    if params.alignment_file:
        stream.write_messages(params.alignment_file, alignments)
    if params.auggraph_file:
        graphs = stream.read_messages(params.graph_file, vg.Graph)
        # reference quirk: stream::write_buffered CLEARS the alignment
        # vector (stream.hpp:54-63), so when -a was also given the
        # augmented graph is built from an EMPTY list (Aligner.cpp:310-321)
        aug_input = [] if params.alignment_file else alignments
        aug = augment_graph_with_alignments(graphs, aug_input)
        stream.write_messages(params.auggraph_file, [aug])
    return alignments


def _align_reads_batched(
    params, graph, fastqs, log, output_dir: str, device_batch: int
) -> list:
    """Full-band alignment through the batched device engine, processed
    in device-sized chunks; per-read outputs mirror the per-read path."""
    from ..core.engine import BatchAligner, align_batch_full_band

    ba = BatchAligner(graph)  # raises ValueError for cyclic graphs
    alignments: list = []
    order = list(reversed(fastqs))  # match the per-read path's order
    for start in range(0, len(order), device_batch):
        chunk = order[start : start + device_batch]
        results = align_batch_full_band(graph, chunk, batch_aligner=ba)
        for fastq, result in zip(chunk, results):
            log(f"read {fastq.seq_id} size {len(fastq.sequence)}bp")
            if result.alignment_failed or result.alignment.score == INT32_MAX:
                log(f"read {fastq.seq_id} alignment failed")
                continue
            log(f"read {fastq.seq_id} score {result.alignment.score}")
            replace_digraph_node_ids(result.alignment)
            alignments.append(result.alignment)
            name = _safe_filename(fastq.seq_id)
            stream.write_messages(
                os.path.join(output_dir, f"alignment_0_{name}.gam"),
                [result.alignment],
            )
            write_trace(
                result.trace, os.path.join(output_dir, f"trace_0_{name}.trace")
            )
    log(f"final result has {len(alignments)} alignments")
    if params.alignment_file:
        stream.write_messages(params.alignment_file, alignments)
    if params.auggraph_file:
        graphs = stream.read_messages(params.graph_file, vg.Graph)
        aug_input = [] if params.alignment_file else alignments
        aug = augment_graph_with_alignments(graphs, aug_input)
        stream.write_messages(params.auggraph_file, [aug])
    return alignments


def augment_graph_with_alignments(graphs: list, alignments: list) -> vg.Graph:
    """Embed alignment-path edges into the graph
    (reference augmentGraphwithAlignment, Aligner.cpp:24-74)."""
    aug = vg.Graph()
    for g in graphs:
        for node in g.node:
            aug.node.append(
                vg.Node(id=node.id, sequence=node.sequence, name=node.name)
            )
    for aln in alignments:
        maps = aln.path.mapping
        for i in range(len(maps) - 1):
            aug.edge.append(
                vg.Edge(
                    from_=maps[i].position.node_id,
                    to=maps[i + 1].position.node_id,
                    from_start=maps[i].position.is_reverse,
                    to_end=maps[i + 1].position.is_reverse,
                    overlap=0,
                )
            )
    return aug
