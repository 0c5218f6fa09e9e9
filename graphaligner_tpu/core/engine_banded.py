"""Banded seeded alignment engine on device (the reference's primary path).

Batched redesign of the reference's seed-and-extend banded DP
(GraphAligner.h getSqrtSlices/pickMethodAndExtendFill/calculateSlice,
2571-2856, 2331-2451). Where the reference processes one read per thread
with a dynamic per-slice node set, this engine runs a *batch* of
(read, seed) extension problems per device with fully static shapes:

- The band is a fixed-capacity node-slot list ([Nm] slots, topo-rank
  sorted) + a fixed-capacity cell array ([Cm] cells, node-major), with
  per-lane overflow flags routing oversized problems to bigger compiled
  buckets or the host oracle — the batched analog of the reference's
  bitvector/alternate method switch (GraphAligner.h:2483).
- Band projection (reference projectForwardFromMinScore,
  GraphAligner.h:1110-1159) becomes a sort-based Bellman-Ford over the
  slot list: candidate generation via out-edge gathers, dedup-by-min via
  one `lax.sort` per relaxation round, iterated to fixpoint in a bounded
  `while_loop`.
- The slice DP is the bit-parallel Myers block advance on uint32 pairs
  (ops.wordops, reference getNextSlice GraphAligner.h:1349-1427) over a
  `lax.scan` of band cells; node joins merge via the differenceMasks bit
  algebra (WordSlice.h:361-421). Cells are processed in whole-graph SCC
  condensation topo-rank order (precomputed at graph load — replacing
  the reference's per-slice Tarjan, GraphAligner.h:2352), so acyclic
  bands converge in ONE pass; cyclic bands re-run the pass to a bounded
  fixpoint (the reference's UniqueQueue/confirmedRows loop,
  GraphAligner.h:2360-2427).
- All data-dependent control flow (per-lane slice counts, band sizes,
  cyclicity) is masks, not branches; the HMM/bandwidth-ramping control
  loop of getSqrtSlices runs host-side in float64 between batched rounds
  (see core.batch_align), consuming only the tiny per-slice
  (min_score, num_cells) records.

Scores use INF = 2^20 as "outside the band"; all word columns stay valid
(|row delta| <= 1) so the merge/advance bit algebra is exact throughout.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..graph.alignment_graph import AlignmentGraph
from ..graph.scc import condensation
from .engine import _MATCH_TABLE
from .params import WORD_SIZE

INF = np.int32(1 << 20)  # band-absent score (real scores < 2^18)
EMPTY = np.int32(2**31 - 1)  # empty node slot sentinel
PRI_RANGE = 1024  # projection priority range; requires bandwidth+64 < 1023
INF_PRI = np.int32(PRI_RANGE - 1)
I32MAX = np.int32(2**31 - 1)


@dataclass
class BandedGraphTables:
    """Host copies of the device-resident graph arrays for the banded
    engine (uploaded once per graph)."""

    node_len: np.ndarray  # [N] int32
    node_start: np.ndarray  # [N] int32
    seq_codes: np.ndarray  # [BP] int32 (0-3 bases, 4 dummy)
    in_nbrs: np.ndarray  # [N, K_in] int32, -1 pad
    out_nbrs: np.ndarray  # [N, K_out] int32, -1 pad
    topo_rank: np.ndarray  # [N] int32, unique, ascending ~ topo order
    pos_to_node: np.ndarray  # [BP] int32 (backtrace walk)
    node_end: np.ndarray  # [N] int32 (= node_start + node_len)
    k_in: int
    k_out: int
    num_nodes: int
    # lazily built by core.reach.ensure_reach (GA_PROJ=reach): [2, N, K]
    # packed reach sets, the d_max they cover, or -2 when the graph is
    # unfit for the precomputed-projection mode
    reach_tbl: np.ndarray | None = None
    reach_dmax: int = -1

    def device_args(self):
        return (
            self.node_len,
            self.node_start,
            self.seq_codes,
            self.in_nbrs,
            self.out_nbrs,
            self.topo_rank,
        )


def build_graph_tables(graph: AlignmentGraph) -> BandedGraphTables:
    n = graph.node_count

    def pad_adj(ptr, idx):
        deg = np.diff(ptr)
        k = max(1, int(deg.max()))
        out = np.full((n, k), -1, dtype=np.int32)
        rows = np.repeat(np.arange(n, dtype=np.int64), deg)
        cols = np.arange(len(idx), dtype=np.int64) - np.repeat(ptr[:-1], deg)
        out[rows, cols] = idx
        return out, k

    in_nbrs, k_in = pad_adj(graph.in_ptr, graph.in_idx)
    out_nbrs, k_out = pad_adj(graph.out_ptr, graph.out_idx)
    _, _, _, topo_order = condensation(graph.out_ptr, graph.out_idx)
    topo_rank = np.empty(n, dtype=np.int32)
    topo_rank[np.asarray(topo_order)] = np.arange(n, dtype=np.int32)
    return BandedGraphTables(
        node_len=graph.node_len.astype(np.int32),
        node_start=graph.node_start.astype(np.int32),
        seq_codes=graph.seq_codes.astype(np.int32),
        in_nbrs=in_nbrs,
        out_nbrs=out_nbrs,
        topo_rank=topo_rank,
        pos_to_node=graph.pos_to_node.astype(np.int32),
        node_end=(graph.node_start + graph.node_len).astype(np.int32),
        k_in=k_in,
        k_out=k_out,
        num_nodes=n,
    )


# One jit instance per full signature (statics + batch size). Working
# around a jax 0.9.0 bug: with multiple compiled entries in one jit's
# cache, cache-hit executions of any entry compiled after the first fail
# with "Execution supplied N buffers but compiled program expected M"
# (triggered by this function's nested scan/while_loop structure).
_JIT_CACHE: dict = {}


def banded_scan(
    *args, S_max, Nm, Cm, I_proj=32, P_fix=16, unroll=1, cell="xla",
    interpret=False, _ablate=None, _proj="sort2", seg=None, mesh=None,
    mesh_axis="dp", reach=None, tie8=False,
):
    """cell: the cell-pass implementation ("triton" = the Pallas kernel
    ops.pallas.banded_cell, "xla" = the lax.scan pass; see
    ops.kernels.select_kernels). interpret runs the Triton kernel
    through the Pallas interpreter (CPU tests only).

    seg: optional segmented-lane tables (active, first_slice,
    seq_len, reset_node, reset_len), each [S_max, B] int32 — when given,
    a lane holds multiple problems back to back: a step with
    reset_node >= 0 restarts the carry from that seed node in-scan, and
    the per-lane scalars (num_steps / start_slice / seq_len) are ignored
    in favor of the tables. Read codes must then be pre-shifted so step
    t's 64 rows sit at read_codes[:, t*64:(t+1)*64]."""
    import jax

    B = args[6].shape[0]
    assert cell in ("triton", "xla"), cell
    assert Cm < 1 << 21, Cm  # the control word's cell-count field
    segmented = seg is not None
    # GA_UNROLL overrides the scan unroll factor; resolved HERE so it is
    # part of the jit-cache key (an in-scan env read would be baked into
    # whichever trace compiled first and silently ignored afterwards)
    import os as _os_u

    unroll = int(_os_u.environ.get("GA_UNROLL", unroll))
    # GA_ABLATE: scan-phase cost decomposition for on-chip probes
    # (noproj / nofix / nocells). OUTPUTS ARE WRONG under ablation —
    # probe tools only; part of the jit key like unroll. A leaked env
    # var must not masquerade as a valid run (the repo's core invariant
    # is bit-identical output), so every ablated scan shouts on stderr.
    _ablate = _ablate or _os_u.environ.get("GA_ABLATE") or None
    if _ablate:
        import sys as _sys

        print(
            f"*** GA_ABLATE={_ablate}: ABLATED SCAN — OUTPUTS ARE WRONG "
            "(probe mode; unset GA_ABLATE for real runs) ***",
            file=_sys.stderr,
            flush=True,
        )
    # the pairwise dedup compares (rank, pri) as two int32 fields (same
    # node => same rank), so there is NO graph-size ceiling; the optional
    # sort-based dedup packs rank*1024+pri into one int32 key and only
    # works below ~2M digraph nodes
    if args[5].shape[0] >= (int(I32MAX) // PRI_RANGE) - 1:
        _proj = "pairwise"
    # reach mode needs the precomputed table (core.reach.ensure_reach);
    # without one (unfit graph, caller didn't build it) fall back to the
    # iterative relaxation
    if _proj == "reach" and reach is None:
        _proj = "pairwise"
    if _proj != "reach":
        reach = None
    mesh_key = (
        (tuple(d.id for d in mesh.devices.flat), mesh_axis)
        if mesh is not None
        else None
    )
    key = (S_max, Nm, Cm, I_proj, P_fix, B, unroll, cell, interpret,
           _ablate, _proj, segmented, mesh_key, tie8)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        inner = functools.partial(
            _banded_scan,
            S_max=S_max,
            Nm=Nm,
            Cm=Cm,
            I_proj=I_proj,
            P_fix=P_fix,
            unroll=unroll,
            cell=cell,
            interpret=interpret,
            _ablate=_ablate,
            _proj=_proj,
            segmented=segmented,
            tie8=tie8,
        )
        if mesh is not None:
            # data-parallel multi-device: the problem batch splits along
            # the mesh axis via shard_map, graph tables replicate, and
            # every lane's band scan (the cell kernel included) runs
            # entirely on its device — zero collectives, mirroring the
            # reference's independent per-thread reads (Aligner.cpp:290)
            inner = _shard_banded(
                inner, mesh, mesh_axis, segmented, reach is not None
            )
        fn = jax.jit(inner)
        _JIT_CACHE[key] = fn
    # match table passed as an argument, not closed over (see note below)
    extra = (reach,) if reach is not None else ()
    if segmented:
        return fn(*args, _MATCH_TABLE, *extra, *seg)
    return fn(*args, _MATCH_TABLE, *extra)


def _shard_banded(fn, mesh, axis, segmented, has_reach=False):
    '''Wrap a configured _banded_scan in shard_map over `mesh`: batch
    (last) axis sharded, graph tables + match table replicated.'''
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rep = P()
    in_specs = (
        (rep,) * 6  # graph tables, replicated
        + (P(axis), P(axis), P(axis), P(axis), P(None, axis))  # per-problem
        + (P(axis),) * 5  # init carry
        + (rep,)  # match table
    )
    if has_reach:
        in_specs = in_specs + (rep,)  # reach table, replicated
    if segmented:
        in_specs = in_specs + (P(None, axis),) * 5
    out_specs = {
        "tie16": P(None, None, axis),
        "ids_sub": P(None, axis),
        "band_ids": P(None, None, axis),
        "node_min": P(None, None, axis),
        "node_end": P(None, None, axis),
        "min_score": P(None, axis),
        "num_cells": P(None, axis),
        "overflow": P(None, axis),
        "control": P(None, axis),
        "cols": P(None, None, None, axis),
        "sends": P(None, None, axis),
        "lens_tab": P(None, None, axis),
        "pred_tab": P(None, None, axis),
        "pred_prev": P(None, None, axis),
        "codes": P(None, None, axis),
    }
    return shard_map(
        fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
        check_vma=False,
    )


def _banded_scan(
    # graph tables
    node_len,
    node_start,
    seq_codes,
    in_nbrs,
    out_nbrs,
    topo_rank,
    # per-problem inputs
    read_codes,  # [B, S_max*64] uint8 (N-padded)
    seq_len,  # [B] int32: padded sequence length (num_slices*64)
    num_steps,  # [B] int32: slices to compute this round
    start_slice,  # [B] int32: global index of this round's first slice
    bandwidth,  # [S_max, B] int32
    # initial carry (previous-slice state)
    init_ids,  # [B, Nm] int32 (topo-rank sorted, EMPTY pad)
    init_cell_send,  # [B, Cm] int32 last-row scores of prev slice cells
    init_node_min,  # [B, Nm] int32
    init_node_end,  # [B, Nm] int32 (last cell last-row score)
    init_min,  # [B] int32
    match_table,  # [R, 5] bool read-code x graph-code match table
    # segmented-mode tables ([S_max, B] int32 each; see banded_scan.seg)
    *seg_tables,
    S_max: int,
    Nm: int,
    Cm: int,
    I_proj: int = 32,
    P_fix: int = 16,
    unroll: int = 1,
    cell: str = "xla",
    interpret: bool = False,
    _ablate=None,
    _proj="sort2",
    segmented: bool = False,
    tie8: bool = False,
):
    """All internal arrays are laid out with the batch as the LAST axis
    ([Nm, B], [Cm, B], [K, Cm, B]) and per-field (never a trailing
    size-7 struct axis), so per-lane vectors are contiguous along the
    batch and the cell kernel's loads coalesce across lanes.
    Outputs follow the same convention (cols [S, 7, Cm, B])."""
    import jax
    import jax.numpy as jnp

    from ..ops import wordops
    from ..ops.kernels import pred_slot_bits

    if _proj == "reach":
        # packed [2, N, K] reach table rides as the first extra arg
        # (see banded_scan); K=0 never happens (self entry always there)
        reach_tbl, seg_tables = seg_tables[0], seg_tables[1:]

    B = read_codes.shape[0]
    K_in = in_nbrs.shape[1]
    K_out = out_nbrs.shape[1]
    # packed predecessor words: (slot | valid<<SB) << FW*k per pred k
    SB = pred_slot_bits(Nm)
    FW = SB + 1
    # NOTE: all index vectors use lax.iota (traced ops), never captured
    # numpy constants — non-scalar jaxpr constants become hidden executable
    # parameters that the jax 0.9.0 dispatch fastpath miscounts on repeat
    # executions ("supplied N buffers but compiled program expected M").
    iota_nm = jax.lax.iota(jnp.int32, Nm)
    iota_cm = jax.lax.iota(jnp.int32, Cm)
    ONES = jnp.uint32(0xFFFFFFFF)

    def gather_node(table, ids, fill):
        """table[ids] with EMPTY slots mapped to `fill` (1-D table)."""
        safe = jnp.clip(ids, 0, table.shape[0] - 1)
        out = table[safe]
        mask = (ids < EMPTY).reshape(ids.shape + (1,) * (out.ndim - ids.ndim))
        return jnp.where(mask, out, fill)

    # Packed per-node tables: every same-index-set gather is folded into
    # one multi-row table read (leading small axis; the batch stays last
    # per the layout note above), one gather op instead of several.
    N_nodes = node_len.shape[0]
    node_tbl = jnp.stack(
        [node_len, node_start] + [in_nbrs[:, k] for k in range(K_in)], axis=0
    )  # [2+K_in, N]
    exp_tbl = jnp.stack([node_len, topo_rank], axis=0)  # [2, N]
    # read-code -> 5-bit match mask LUT (one take instead of five)
    bits_lut = jnp.zeros(match_table.shape[0], jnp.int32)
    for _g in range(5):
        bits_lut = bits_lut | (match_table[:, _g].astype(jnp.int32) << _g)

    # ------------------------------------------------------ band projection
    def project_band_reach(p_ids_bn, p_node_min_bn, p_node_end_bn, p_min, bw, act):
        """Precomputed-reach projection (core/reach.py): band membership
        is m s.t. some qualified seed s has outp0(s) + d*(s,m) <= ew,
        and d* is in the table — so the whole relaxation collapses to
        one gather + one dedup sort. Exactly equivalent to the iterative
        fixpoint below (the per-hop outp <= ew constraint is monotone
        along a path, so only the final inequality binds; see
        core/reach.py). The overflow flag is the exact band-size test —
        the iterative path can additionally overflow at its trip cap,
        which only changes WHICH capacity tier computes the identical
        values."""
        ew = bw + WORD_SIZE  # [B]
        valid_slot = p_ids_bn < EMPTY
        qualified = valid_slot & (p_node_min_bn <= (p_min + bw)[:, None])
        outp0 = jnp.where(
            qualified & (p_node_end_bn <= (p_min + ew)[:, None]),
            p_node_end_bn - p_min[:, None] + 1,
            jnp.int32(INF_PRI),
        )  # [B, Nm]
        safe_ids = jnp.clip(p_ids_bn, 0, N_nodes - 1)
        g = reach_tbl[:, safe_ids]  # [2, B, Nm, K]
        rid, w1 = g[0], g[1]
        rd = jnp.bitwise_and(w1, 1023)
        is_self = rd == 1023  # d=1023 is the self marker (d_max <= 1022)
        valid = (
            qualified[:, :, None]
            & (rid >= 0)
            & (is_self | ((outp0[:, :, None] + rd) <= ew[:, None, None]))
        )  # [B, Nm, K]
        E = Nm * reach_tbl.shape[2]
        # w1 = rank*1024 + d - 2^31 is already the sort key: the bias
        # makes int32 order equal unsigned order of the packing, ranks
        # are unique per node, so same-node entries land adjacent and
        # cross-node order is topo order (the band slot order); I32MAX
        # stays the strict maximum (reach.py caps N at 2^22-1)
        key = jnp.where(valid, w1, I32MAX).reshape(B, E)
        ids_f = jnp.where(valid, rid, EMPTY).reshape(B, E)
        key_s, id_s = jax.lax.sort(
            (key, ids_f), dimension=1, num_keys=1, is_stable=True
        )
        valid_s = key_s < I32MAX
        first = (
            jnp.concatenate(
                [jnp.ones((B, 1), bool), id_s[:, 1:] != id_s[:, :-1]], axis=1
            )
            & valid_s
        )
        cnt = jnp.cumsum(first.astype(jnp.int32), axis=1)  # [B, E]
        over = cnt[:, -1] > Nm
        pos = jnp.where(first, cnt - 1, Nm)
        oh = pos[:, :, None] == iota_nm[None, None, :]  # [B, E, Nm]
        got = jnp.any(oh, axis=1)
        n_ids = jnp.where(
            got, jnp.sum(jnp.where(oh, id_s[:, :, None], 0), axis=1), EMPTY
        )
        return n_ids, over

    def project_band(p_ids_bn, p_node_min_bn, p_node_end_bn, p_min, bw, act):
        """projectForwardFromMinScore (GraphAligner.h:1110-1159) as a
        sort-deduped Bellman-Ford over node slots ([B, Nm] layout — the
        sorts run along the last axis). Universe entries are
        (id, pri, outp): pri = the Dijkstra priority (0 for qualifying
        previous-band seeds), outp = the priority this entry's expansion
        assigns to out-neighbors (seed: end_score-min+1; expanded:
        pri+len)."""
        ew = bw + WORD_SIZE  # [B]
        valid_slot = p_ids_bn < EMPTY
        qualified = valid_slot & (p_node_min_bn <= (p_min + bw)[:, None])
        ids0 = jnp.where(qualified, p_ids_bn, EMPTY)
        pri0 = jnp.where(qualified, 0, INF_PRI).astype(jnp.int32)
        seed_exp = qualified & (p_node_end_bn <= (p_min + ew)[:, None])
        outp0 = jnp.where(
            seed_exp, p_node_end_bn - p_min[:, None] + 1, jnp.int32(INF_PRI)
        ).astype(jnp.int32)

        # 2-hop candidate generation when the fan-out is small: the
        # relaxation discovers band nodes two hops per iteration instead
        # of one, ~halving the while_loop trip count. Extra edges with
        # correct distances never change the Bellman-Ford fixpoint (the
        # 1-hop edges alone already determine it), so the band SET — the
        # only thing bit-identity depends on — is unchanged.
        two_hop = K_out <= 2 and _proj in ("sort2", "pairwise2")
        E = Nm + Nm * K_out + (Nm * K_out * K_out if two_hop else 0)

        def body(state):
            ids, pri, outp, over, it, _ = state
            cand_id = gather_node(out_nbrs, ids, -1)  # [B, Nm, K_out]
            cand_valid = (
                (ids < EMPTY)[:, :, None]
                & (cand_id >= 0)
                & (outp[:, :, None] <= ew[:, None, None])
            )
            cand_id = jnp.where(cand_valid, cand_id, EMPTY)
            cand_pri = jnp.where(cand_valid, outp[:, :, None], INF_PRI)
            parts_id = [ids, cand_id.reshape(B, -1)]
            parts_pri = [pri, cand_pri.reshape(B, -1)]
            if two_hop:
                cand_len = gather_node(node_len, cand_id, 0)
                cand_outp = jnp.minimum(cand_pri + cand_len, INF_PRI)
                c2_id = gather_node(out_nbrs, cand_id, -1)  # [B, Nm, K, K]
                c2_valid = (
                    cand_valid[..., None]
                    & (c2_id >= 0)
                    & (cand_outp[..., None] <= ew[:, None, None, None])
                )
                c2_id = jnp.where(c2_valid, c2_id, EMPTY)
                c2_pri = jnp.where(c2_valid, cand_outp[..., None], INF_PRI)
                parts_id.append(c2_id.reshape(B, -1))
                parts_pri.append(c2_pri.reshape(B, -1))
            all_id = jnp.concatenate(parts_id, axis=1)
            all_pri = jnp.concatenate(parts_pri, axis=1)
            # one packed [2, B, E] gather supplies expansion lengths AND
            # topo ranks (one gather op per iteration instead of 2-3)
            g2 = exp_tbl[:, jnp.clip(all_id, 0, N_nodes - 1)]
            seg_valid = all_id < EMPTY
            all_len = jnp.where(seg_valid, g2[0], 0)
            nc = Nm * K_out
            if two_hop:
                c2_len = all_len[:, Nm + nc :]
                c2_outp = jnp.minimum(all_pri[:, Nm + nc :] + c2_len, INF_PRI)
                all_outp = jnp.concatenate(
                    [outp, cand_outp.reshape(B, -1), c2_outp], axis=1
                )
            else:
                cand_outp = jnp.minimum(
                    all_pri[:, Nm:] + all_len[:, Nm:], INF_PRI
                )
                all_outp = jnp.concatenate([outp, cand_outp], axis=1)
            valid_e = seg_valid & (all_pri < INF_PRI)
            rank = jnp.where(valid_e, g2[1], I32MAX)
            if _proj.startswith("sort"):
                # dedup-by-min via ONE stable sort on the packed
                # (rank, pri) key: same node => same rank => adjacent
                # after sorting, so the per-node minimum is the first
                # entry of each id run and the output slot is a prefix
                # count — O(E log^2 E) total
                key = jnp.where(
                    valid_e, rank * PRI_RANGE + all_pri, I32MAX
                )
                key_s, id_s, pri_s, outp_s = jax.lax.sort(
                    (key, all_id, all_pri, all_outp), dimension=1,
                    num_keys=1, is_stable=True,
                )
                valid_s = key_s < I32MAX
                first = (
                    jnp.concatenate(
                        [
                            jnp.ones((B, 1), bool),
                            id_s[:, 1:] != id_s[:, :-1],
                        ],
                        axis=1,
                    )
                    & valid_s
                )
                cnt = jnp.cumsum(first.astype(jnp.int32), axis=1)  # [B, E]
                over = over | (cnt[:, -1] > Nm)
                pos = jnp.where(first, cnt - 1, Nm)
                oh = pos[:, :, None] == iota_nm[None, None, :]  # [B, E, Nm]
                got = jnp.any(oh, axis=1)
                n_ids = jnp.where(got, jnp.sum(jnp.where(oh, id_s[:, :, None], 0), axis=1), EMPTY)
                n_pri = jnp.where(got, jnp.sum(jnp.where(oh, pri_s[:, :, None], 0), axis=1), INF_PRI)
                n_outp = jnp.where(got, jnp.sum(jnp.where(oh, outp_s[:, :, None], 0), axis=1), INF_PRI)
            else:
                # O(E^2) pairwise rank-select dedup on the (rank, pri)
                # field pair: entries of the SAME node share a rank, so
                # the per-node minimum needs only pri comparisons, and
                # ordering across distinct kept nodes needs only rank
                # comparisons — no packed key, no graph-size ceiling
                iota_e = jax.lax.iota(jnp.int32, E)
                samemat = all_id[:, :, None] == all_id[:, None, :]
                primat = jnp.where(
                    samemat & valid_e[:, None, :],
                    all_pri[:, None, :],
                    INF_PRI,
                )
                minpri = jnp.min(primat, axis=2)
                first_j = jnp.argmax(primat == minpri[:, :, None], axis=2)
                keep = valid_e & (first_j == iota_e[None, :])
                over = over | (jnp.sum(keep, axis=1) > Nm)
                pos = jnp.sum(
                    (rank[:, None, :] < rank[:, :, None]) & keep[:, None, :],
                    axis=2,
                )
                oh = (pos[:, :, None] == iota_nm[None, None, :]) & keep[
                    :, :, None
                ]
                got = jnp.any(oh, axis=1)
                n_ids = jnp.where(got, jnp.sum(jnp.where(oh, all_id[:, :, None], 0), axis=1), EMPTY)
                n_pri = jnp.where(got, jnp.sum(jnp.where(oh, all_pri[:, :, None], 0), axis=1), INF_PRI)
                n_outp = jnp.where(got, jnp.sum(jnp.where(oh, all_outp[:, :, None], 0), axis=1), INF_PRI)
            # per-lane convergence: inactive lanes (past num_steps) and
            # lanes whose band already overflowed Nm keep churning forever
            # and previously held the WHOLE batch at the iteration cap —
            # they are excluded here (their slice result is dead either
            # way), so the loop runs only as long as a live lane improves
            changed_l = (
                jnp.any((n_ids != ids) | (n_pri != pri), axis=1) & act & ~over
            )
            return (n_ids, n_pri, n_outp, over, it + 1, changed_l)

        state = (
            ids0,
            pri0,
            outp0,
            jnp.zeros(B, bool),
            jnp.int32(0),
            jnp.ones(B, bool),
        )
        if _proj.startswith("unroll"):
            # fixed-trip straight-line relaxation: nearly every live step
            # needs ~9-12 hops on this workload, so the while_loop's early
            # exit saved nothing while its per-iteration carry/cond cost
            # ~1.3ms/step; unrolled, XLA fuses across iterations. The cap
            # semantics are unchanged: a lane still improving on the last
            # iteration is flagged overflow.
            for _ in range(I_proj):
                state = body(state)
            ids, pri, outp, over, it, changed_l = state
        else:
            def cond(state):
                return jnp.any(state[5]) & (state[4] < I_proj)

            ids, pri, outp, over, it, changed_l = jax.lax.while_loop(
                cond, body, state
            )
        over = over | changed_l  # this lane hit the cap while improving
        return ids, over

    # -------------------------------------------------------------- slice step
    def slice_step(carry, xs):
        p_ids, p_cell_send, p_node_min, p_node_end, p_min = carry  # [Nm|Cm, B]
        if segmented:
            bw, t, seg_active, seg_first, seg_slen, seg_rnode, seg_rlen = xs
            active = seg_active == 1
            first_slice = seg_first == 1
            seq_len_v = seg_slen
            # segment start: restart the carry from the seed node
            # in-scan (== make_seed_carry) so many problems share a lane
            resetting = seg_rnode >= 0  # [B]
            rnode = jnp.where(resetting, seg_rnode, 0)
            slot0 = (iota_nm == 0)[:, None]  # [Nm, 1]
            rm = resetting[None, :]
            p_ids = jnp.where(rm, jnp.where(slot0, rnode[None, :], EMPTY), p_ids)
            p_cell_send = jnp.where(
                rm,
                jnp.where(iota_cm[:, None] < seg_rlen[None, :], 0, INF),
                p_cell_send,
            )
            p_node_min = jnp.where(rm, jnp.where(slot0, 0, INF), p_node_min)
            p_node_end = jnp.where(rm, jnp.where(slot0, 0, INF), p_node_end)
            p_min = jnp.where(resetting, 0, p_min)
        else:
            bw, t = xs  # [B], scalar
            active = t < num_steps  # [B]
            g_slice = start_slice + t  # [B] global slice index
            first_slice = g_slice == 0
            seq_len_v = seq_len

        if _ablate == "noproj":
            ids_bn, proj_over = p_ids.T, jnp.zeros(B, bool)
        else:
            proj_fn = project_band_reach if _proj == "reach" else project_band
            ids_bn, proj_over = proj_fn(
                p_ids.T, p_node_min.T, p_node_end.T, p_min, bw, active
            )
        ids = ids_bn.T  # [Nm, B]
        valid_slot = ids < EMPTY

        # ---- per-slot tables ([Nm, B]). node_tbl packs len/start/in-nbrs
        # into ONE gather over the band ids. ---------------------------------
        g_tbl = node_tbl[:, jnp.clip(ids, 0, N_nodes - 1)]  # [2+K_in, Nm, B]
        lens = jnp.where(valid_slot, g_tbl[0], 0)  # [Nm, B]
        starts_tab = jnp.where(valid_slot, g_tbl[1], 0)  # [Nm, B]
        c_used = jnp.sum(lens, axis=0)  # [B]
        cell_over = c_used > Cm

        # ---- previous-band matching ([Nm, B]) ------------------------------
        same = (
            (ids[:, None, :] == p_ids[None, :, :])
            & valid_slot[:, None, :]
            & (p_ids < EMPTY)[None, :, :]
        )  # [Nm, Nm_prev, B]
        node_in_prev = jnp.any(same, axis=1)  # [Nm, B]
        prev_slot = jnp.argmax(same, axis=1)  # [Nm, B]
        p_lens = gather_node(node_len, p_ids, 0)
        p_offsets = jnp.cumsum(p_lens, axis=0) - p_lens
        prev_base = jnp.take_along_axis(p_offsets, prev_slot, axis=0)  # [Nm, B]

        # ---- in-neighbor classification per slot ---------------------------
        nb_in_cur = []
        nb_cur_slot = []
        nb_in_prev = []
        nb_prev_slot = []
        any_banded = jnp.zeros((Nm, B), bool)
        slot_pseudo = jnp.full((Nm, B), INF, jnp.int32)
        for k in range(K_in):
            nb_k = jnp.where(valid_slot, g_tbl[2 + k], -1)  # [Nm, B]
            nbv = (nb_k >= 0) & valid_slot
            eq_cur = (nb_k[:, None, :] == ids[None, :, :]) & nbv[:, None, :]
            in_cur_k = jnp.any(eq_cur, axis=1)
            cur_slot_k = jnp.argmax(eq_cur, axis=1)
            eq_prev = (
                (nb_k[:, None, :] == p_ids[None, :, :])
                & nbv[:, None, :]
                & (p_ids < EMPTY)[None, :, :]
            )
            in_prev_k = jnp.any(eq_prev, axis=1)
            prev_slot_k = jnp.argmax(eq_prev, axis=1)
            pe_k = jnp.where(
                in_prev_k,
                jnp.take_along_axis(p_node_end, prev_slot_k, axis=0),
                INF,
            )
            slot_pseudo = jnp.minimum(
                slot_pseudo, jnp.where(in_prev_k & ~in_cur_k, pe_k, INF)
            )
            any_banded = any_banded | in_cur_k | in_prev_k
            nb_in_cur.append(in_cur_k)
            nb_cur_slot.append(cur_slot_k)
            nb_in_prev.append(in_prev_k)
            nb_prev_slot.append(prev_slot_k)
        band_source = ~any_banded & valid_slot
        src_noprev_slot = band_source & ~node_in_prev
        src_sm_slot = band_source & node_in_prev & first_slice[None, :]
        pred_tab = jnp.zeros((Nm, B), jnp.int32)
        pred_prev = jnp.zeros((Nm, B), jnp.int32)
        for k in range(K_in):
            pred_tab = pred_tab | (
                (nb_cur_slot[k] | (nb_in_cur[k].astype(jnp.int32) << SB))
                << (FW * k)
            )
            # PREVIOUS-band slot per pred: the walk kernel's boundary
            # diagonal (row 0) reads the pred's row-63 value from the
            # previous slice, which the reference allows even when the
            # pred fell OUT of the current band — pred_tab alone can't
            # name such preds (its slot bits are current-band refs)
            pred_prev = pred_prev | (
                (nb_prev_slot[k] | (nb_in_prev[k].astype(jnp.int32) << SB))
                << (FW * k)
            )

        # ---- per-slice Eq words for the 5 graph codes ([5, B]) -------------
        if segmented:
            # pre-shifted codes: one uniform dynamic_slice, no gather
            rc = jax.lax.dynamic_slice(
                read_codes.astype(jnp.int32),
                (0, t * WORD_SIZE),
                (B, WORD_SIZE),
            )  # [B, 64]
        else:
            rc_base = jnp.clip(
                g_slice * WORD_SIZE, 0, read_codes.shape[1] - WORD_SIZE
            )
            rc = jnp.take_along_axis(
                read_codes.astype(jnp.int32),
                rc_base[:, None] + jax.lax.iota(jnp.int32, WORD_SIZE)[None, :],
                axis=1,
            )  # [B, 64]
        w32 = jnp.uint32(1) << jax.lax.broadcasted_iota(jnp.uint32, (1, 32), 1)
        bits32 = jnp.take(bits_lut, rc)  # [B, 64] — 1 gather, not 5
        eq_lo_codes = []
        eq_hi_codes = []
        for g in range(5):
            bits = ((bits32 >> g) & 1) == 1  # [B, 64]
            eq_lo_codes.append(
                jnp.sum(jnp.where(bits[:, :32], w32, 0), axis=1, dtype=jnp.uint32)
            )
            eq_hi_codes.append(
                jnp.sum(jnp.where(bits[:, 32:], w32, 0), axis=1, dtype=jnp.uint32)
            )

        # ---- inner scan over cells (bit-parallel DP + layout walk) ----------
        def inf_col():
            z = jnp.zeros(B, jnp.uint32)
            return (
                jnp.full(B, ONES, jnp.uint32),
                jnp.full(B, ONES, jnp.uint32),
                z,
                z,
                jnp.full(B, INF, jnp.int32),
                jnp.full(B, INF + WORD_SIZE, jnp.int32),
                jnp.zeros(B, jnp.int32),
            )

        def layout_parallel():
            """Per-cell metadata for the cell kernel, computed with NO
            sequential dependency: the cell->slot map is a rank query
            against the cumulative node lengths, and every per-slot table
            read is a one-hot masked sum over the Nm slots, plus the two
            data gathers for sequence codes and previous-slice sends.
            Produces the meta words the XLA cell pass derives cell by
            cell, including for invalid trailing cells."""
            cum_end = jnp.cumsum(lens, axis=0)  # [Nm, B]
            # slot per cell = #{positive-length slots fully before c};
            # sticks at the first empty slot past the band (as the serial
            # walk does, since a zero-length slot never triggers `en`)
            slot = jnp.sum(
                (
                    (iota_cm[:, None, None] >= cum_end[None, :, :])
                    & (lens > 0)[None, :, :]
                ).astype(jnp.int32),
                axis=1,
            )
            slot = jnp.minimum(slot, Nm - 1)  # [Cm, B]
            oh = slot[:, None, :] == iota_nm[None, :, None]  # [Cm, Nm, B]

            def rd(tab):
                return jnp.sum(jnp.where(oh, tab[None, :, :], 0), axis=1)

            base = rd(cum_end - lens)  # [Cm, B] first cell of the slot
            off = iota_cm[:, None] - base
            len_s = rd(lens)
            vc = (iota_cm[:, None] < c_used[None, :]) & (len_s > 0)
            st = (off == 0) & vc
            en = (off == len_s - 1) & vc
            inprev = rd(node_in_prev.astype(jnp.int32)) == 1
            pos = jnp.clip(rd(starts_tab) + off, 0, seq_codes.shape[0] - 1)
            code = jnp.where(vc, seq_codes[pos], 4)
            old_idx = jnp.clip(rd(prev_base) + off, 0, Cm - 1)
            oe = jnp.where(
                inprev & vc,
                jnp.take_along_axis(p_cell_send, old_idx, axis=0),
                INF,
            )
            ps = jnp.where(st, rd(slot_pseudo), INF)
            srcnp = st & (rd(src_noprev_slot.astype(jnp.int32)) == 1)
            srcsm = st & (rd(src_sm_slot.astype(jnp.int32)) == 1)
            m1 = (
                slot
                | (st.astype(jnp.int32) << 8)
                | (en.astype(jnp.int32) << 9)
                | (vc.astype(jnp.int32) << 10)
                | (inprev.astype(jnp.int32) << 11)
                | (code << 12)
                | (srcnp.astype(jnp.int32) << 15)
                | (srcsm.astype(jnp.int32) << 16)
            )
            # pred_tab already packs every (slot | valid<<SB) << FW*k
            # word: ONE one-hot read replaces 2*K_in of them; valid bits
            # are st-gated after the fact, slot bits intentionally are
            # not (matching the per-k construction above)
            rp = rd(pred_tab)
            vb = 0
            for k in range(K_in):
                vb |= 1 << (SB + FW * k)
            m2 = jnp.where(st, rp, rp & ~jnp.int32(vb))
            be = jnp.zeros(B, bool)
            for k in range(K_in):
                pslot_k = (rp >> (FW * k)) & ((1 << SB) - 1)
                pvalid_k = st & (((rp >> (SB + FW * k)) & 1) == 1)
                be = be | jnp.any(pvalid_k & (pslot_k >= slot), axis=0)
            return m1, m2, oe, ps, be

        if cell == "triton":
            from ..ops.pallas.banded_cell import banded_cell_kernel

            m1, m2, oe_arr, ps_arr, pre_back_edge = layout_parallel()
            eq_lo_tab = jax.lax.bitcast_convert_type(
                jnp.stack(eq_lo_codes, axis=0), jnp.int32
            )
            eq_hi_tab = jax.lax.bitcast_convert_type(
                jnp.stack(eq_hi_codes, axis=0), jnp.int32
            )

            def cell_pass(buf_init):
                # buf_init/buf/cols stay STACKED [7, Nm|Cm, B] end to end
                cols, buf, nmin = banded_cell_kernel(
                    m1, m2, oe_arr, ps_arr, eq_lo_tab, eq_hi_tab,
                    seq_len_v[None, :], buf_init,
                    K_in=K_in, interpret=interpret,
                )
                return cols, buf, nmin, pre_back_edge

        def cell_pass_xla(buf_init_stacked):
            buf_init = tuple(buf_init_stacked[f] for f in range(7))

            # buf: tuple of 7 [Nm, B] arrays (int32-encoded fields)
            def cell_step(ccarry, c):
                col, buf, nmin, slot, off, be_acc = ccarry
                vp_lo, vp_hi, vn_lo, vn_hi, sbs, send, e_prev = col

                # ---- per-cell metadata from slot tables (shared one-hot)
                oh = iota_nm[:, None] == slot[None, :]  # [Nm, B]

                def rd(tab, fill=0):
                    return jnp.sum(
                        jnp.where(oh, tab, 0), axis=0
                    ) + jnp.where(jnp.any(oh, axis=0), 0, fill)

                len_s = rd(lens)
                vc = (c < c_used) & (len_s > 0)
                st = (off == 0) & vc
                en = (off == len_s - 1) & vc
                inprev = rd(node_in_prev.astype(jnp.int32)) == 1
                pos = jnp.clip(
                    rd(starts_tab) + off, 0, seq_codes.shape[0] - 1
                )
                code = jnp.where(vc, seq_codes[pos], 4)
                eq_lo = jnp.zeros(B, jnp.uint32)
                eq_hi = jnp.zeros(B, jnp.uint32)
                for g in range(5):
                    sel = code == g
                    eq_lo = jnp.where(sel, eq_lo_codes[g], eq_lo)
                    eq_hi = jnp.where(sel, eq_hi_codes[g], eq_hi)
                old_idx = jnp.clip(rd(prev_base) + off, 0, Cm - 1)
                oe = jnp.where(
                    inprev & vc,
                    jnp.take_along_axis(p_cell_send, old_idx[None, :], axis=0)[0],
                    INF,
                )
                pseudo_o = jnp.where(st, rd(slot_pseudo, INF), INF)
                srcnp = st & (rd(src_noprev_slot.astype(jnp.int32)) == 1)
                srcsm = st & (rd(src_sm_slot.astype(jnp.int32)) == 1)

                # within-node chain advance
                r_chain = jnp.minimum(oe, sbs + 1)
                hin = r_chain - sbs
                eq_lo_c = jnp.where(
                    (e_prev & 1) == 1, eq_lo, eq_lo & ~jnp.uint32(1)
                )
                c_vp_lo, c_vp_hi, c_vn_lo, c_vn_hi, c_send = wordops.myers_advance(
                    eq_lo_c, eq_hi, vp_lo, vp_hi, vn_lo, vn_hi, send, hin
                )

                # node-start path. The three "uniform" candidate columns of
                # the reference — vertical continuation of the previous
                # slice (getSourceSliceFromScore/StartMatch), the pseudo
                # column from previous-band-only in-neighbors, and the
                # unseen-band-source len+1 column — all have rows
                # A + r with per-column A and sbs, so their elementwise min
                # is one directly-constructed column (saves two
                # mergeTwoSlices evaluations per cell).
                match0 = (eq_lo & 1).astype(jnp.int32)
                sm0 = jnp.where(srcsm, 1 - match0, 1)
                sbs_b = jnp.where(inprev, oe, INF)
                a_b = jnp.where(inprev, oe + sm0, INF + 1)
                has_ps = pseudo_o < INF
                sbs_p = jnp.where(has_ps, pseudo_o + 1, INF)
                a_p = jnp.where(has_ps, pseudo_o + 1 - match0, INF + 1)
                sbs_s = jnp.where(srcnp, seq_len_v + 1, INF)
                a_s = jnp.where(srcnp, seq_len_v + 2, INF + 1)
                sbs_f = jnp.minimum(jnp.minimum(sbs_b, sbs_p), sbs_s)
                a_f = jnp.minimum(jnp.minimum(a_b, a_p), a_s)
                delta = a_f - sbs_f  # in [-1, 1]
                merged = (
                    (ONES & ~jnp.uint32(1)) | (delta == 1).astype(jnp.uint32),
                    jnp.full(B, ONES, jnp.uint32),
                    (delta == -1).astype(jnp.uint32),
                    jnp.zeros(B, jnp.uint32),
                    sbs_f,
                    a_f + 63,
                    jnp.zeros(B, jnp.int32),
                )
                # in-band predecessor columns (getNodeStartSlice)
                for k in range(K_in):
                    pslot_k = rd(nb_cur_slot[k])
                    pvalid_k = st & (rd(nb_in_cur[k].astype(jnp.int32)) == 1)
                    be_acc = be_acc | (pvalid_k & (pslot_k >= slot))
                    oh_p = iota_nm[:, None] == jnp.where(pvalid_k, pslot_k, -1)[
                        None, :
                    ]
                    g = [jnp.sum(jnp.where(oh_p, f, 0), axis=0) for f in buf]
                    g_vp_lo = jax.lax.bitcast_convert_type(g[0], jnp.uint32)
                    g_vp_hi = jax.lax.bitcast_convert_type(g[1], jnp.uint32)
                    g_vn_lo = jax.lax.bitcast_convert_type(g[2], jnp.uint32)
                    g_vn_hi = jax.lax.bitcast_convert_type(g[3], jnp.uint32)
                    eq_lo_k = jnp.where(
                        (g[6] & 1) == 1, eq_lo, eq_lo & ~jnp.uint32(1)
                    )
                    a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, a_send = (
                        wordops.myers_advance(
                            eq_lo_k,
                            eq_hi,
                            g_vp_lo,
                            g_vp_hi,
                            g_vn_lo,
                            g_vn_hi,
                            g[5],
                            jnp.ones(B, jnp.int32),
                        )
                    )
                    adv = (
                        a_vp_lo,
                        a_vp_hi,
                        a_vn_lo,
                        a_vn_hi,
                        g[4] + 1,
                        a_send,
                        g[6],
                    )
                    cand = wordops.merge_slices(merged, adv)
                    merged = tuple(
                        jnp.where(pvalid_k, cc, m) for cc, m in zip(cand, merged)
                    )
                s_vp_lo, s_vp_hi, s_vn_lo, s_vn_hi, s_sbs, s_send, _ = merged

                ic = inf_col()
                n_vp_lo = jnp.where(vc, jnp.where(st, s_vp_lo, c_vp_lo), ic[0])
                n_vp_hi = jnp.where(vc, jnp.where(st, s_vp_hi, c_vp_hi), ic[1])
                n_vn_lo = jnp.where(vc, jnp.where(st, s_vn_lo, c_vn_lo), ic[2])
                n_vn_hi = jnp.where(vc, jnp.where(st, s_vn_hi, c_vn_hi), ic[3])
                n_sbs = jnp.where(vc, jnp.where(st, s_sbs, r_chain), INF)
                n_send = jnp.where(
                    vc, jnp.where(st, s_send, c_send), INF + WORD_SIZE
                )
                # field 6: bit0 = scoreBeforeExists, bits 1-3 = cell's
                # graph code (consumed by the backtrace walk kernel)
                n_e = (inprev & (n_sbs == oe) & vc).astype(jnp.int32) | (
                    code << 1
                )

                fields = (
                    jax.lax.bitcast_convert_type(n_vp_lo, jnp.int32),
                    jax.lax.bitcast_convert_type(n_vp_hi, jnp.int32),
                    jax.lax.bitcast_convert_type(n_vn_lo, jnp.int32),
                    jax.lax.bitcast_convert_type(n_vn_hi, jnp.int32),
                    n_sbs,
                    n_send,
                    n_e,
                )
                end_oh = oh & (en & vc)[None, :]
                buf = tuple(
                    jnp.where(end_oh, f[None, :], bf)
                    for f, bf in zip(fields, buf)
                )
                min_oh = oh & vc[None, :]
                nmin = jnp.where(
                    min_oh, jnp.minimum(nmin, n_send[None, :]), nmin
                )
                n_slot = jnp.minimum(jnp.where(en, slot + 1, slot), Nm - 1)
                n_off = jnp.where(en, 0, off + 1)
                return (
                    (
                        (n_vp_lo, n_vp_hi, n_vn_lo, n_vn_hi, n_sbs, n_send, n_e),
                        buf,
                        nmin,
                        n_slot,
                        n_off,
                        be_acc,
                    ),
                    fields,
                )

            init = (
                inf_col(),
                buf_init,
                jnp.full((Nm, B), INF, jnp.int32),
                jnp.zeros(B, jnp.int32),
                jnp.zeros(B, jnp.int32),
                jnp.zeros(B, bool),
            )
            (_, buf, nmin, _, _, be_acc), cols = jax.lax.scan(
                cell_step, init, jax.lax.iota(jnp.int32, Cm), unroll=unroll
            )
            # cols from scan: tuple of 7 [Cm, B] -> stacked [7, Cm, B]
            return jnp.stack(cols, axis=0), jnp.stack(buf, axis=0), nmin, be_acc

        if cell == "xla":
            cell_pass = cell_pass_xla

        minus1 = jax.lax.bitcast_convert_type(ONES, jnp.int32)
        inf_buf = jnp.stack(
            (
                jnp.full((Nm, B), minus1, jnp.int32),
                jnp.full((Nm, B), minus1, jnp.int32),
                jnp.zeros((Nm, B), jnp.int32),
                jnp.zeros((Nm, B), jnp.int32),
                jnp.full((Nm, B), INF, jnp.int32),
                jnp.full((Nm, B), INF + WORD_SIZE, jnp.int32),
                jnp.zeros((Nm, B), jnp.int32),
            ),
            axis=0,
        )
        if _ablate == "nocells":
            cols = jnp.zeros((7, Cm, B), jnp.int32)
            buf = inf_buf
            nmin = jnp.full((Nm, B), INF, jnp.int32) - (p_min[None, :] % 2)
            back_edge = jnp.zeros(B, bool)
        else:
            cols, buf, nmin, back_edge = cell_pass(inf_buf)

        # bounded fixpoint for cyclic bands (back edge = an in-band
        # predecessor at a topo slot >= the node's own, accumulated by
        # cell_pass)
        def fix_cond(st):
            return st[3] & (st[5] < P_fix)

        def fix_body(st):
            cols0, buf0, nmin0, _, lane_ch, it = st
            cols1, buf1, nmin1, _ = cell_pass(buf0)
            diff = jnp.any(cols1 != cols0, axis=(0, 1))
            lane_changed = diff & back_edge
            return (cols1, buf1, nmin1, jnp.any(lane_changed), lane_changed, it + 1)

        if _ablate in ("nofix", "nocells"):
            fix_fail = jnp.zeros(B, bool)
        else:
            cols, buf, nmin, still, lane_ch, fx = jax.lax.while_loop(
                fix_cond,
                fix_body,
                (cols, buf, nmin, jnp.any(back_edge), back_edge, jnp.int32(0)),
            )
            fix_fail = lane_ch & still  # per-lane: hit the cap while changing

        sends = cols[5]  # [Cm, B]
        node_end = buf[5]  # [Nm, B]
        min_score = jnp.min(jnp.where(valid_slot, nmin, INF), axis=0)  # [B]
        # which capacity failed, one bit each (the host names a lane's
        # fallback by them): 1 = band past Nm node slots, 2 = past Cm
        # cells, 4 = the cyclic-band fixpoint hit its P_fix cap
        ovf_bits = (
            proj_over.astype(jnp.int32)
            | (cell_over.astype(jnp.int32) << 1)
            | (fix_fail.astype(jnp.int32) << 2)
        )

        def upd(new, old):
            return jnp.where(active[None, :] if new.ndim == 2 else active, new, old)

        n_carry = (
            upd(ids, p_ids),
            upd(sends, p_cell_send),
            upd(nmin, p_node_min),
            upd(node_end, p_node_end),
            upd(min_score, p_min),
        )
        am2 = active[None, :]
        # cols/sends are NOT masked for inactive lanes: every consumer
        # (walk consolidation, rewind carries) reads only accepted
        # (active) steps, and the where() pair on the multi-MB cols
        # array cost ~2x its own write bandwidth per step
        # per-step outputs packed: one [5, Nm, B] write + one [3, B]
        # write per step instead of eight separate scan-output updates
        # (the [3, B] stack IS the host control triple, saving its
        # post-scan restack too)
        ys = (
            jnp.stack(
                [
                    jnp.where(am2, ids, EMPTY),
                    jnp.where(am2, nmin, INF),
                    jnp.where(am2, node_end, INF),
                    jnp.where(am2, lens, 0),
                    jnp.where(am2, pred_tab, 0),
                    jnp.where(am2, pred_prev, 0),
                ],
                axis=0,
            ),
            # ONE packed control word per (step, lane) — third of the
            # eager host fetch bytes of the old [3, B] stack: min-score
            # DELTA vs the (post-reset) previous slice in bits 0-6 (DP
            # invariant: a slice's min moves <= 64; the replay asserts
            # it), band cell count in bits 7-27 (Cm < 2^21), overflow
            # cause bits in bits 28-30. Absolute minima are reconstructed
            # from the delta stream post-scan (device) and in the host
            # control replay.
            jnp.where(active, jnp.clip(min_score - p_min, 0, 127), 0)
            | (jnp.where(active, jnp.minimum(c_used, Cm), 0) << 7)
            | (jnp.where(active, ovf_bits, 0) << 28),
            # sends is cols field 5 — sliced out after the scan rather
            # than written twice per step
            cols,
        )
        return n_carry, ys

    carry0 = (
        init_ids.T,
        init_cell_send.T,
        init_node_min.T,
        init_node_end.T,
        init_min,
    )
    # NOTE on shape strategy: S_max here is a compiled capacity; the
    # scan runs all S_max steps (inactive lanes/slices are masked). A
    # while_loop writing output buffers from its carry would copy the
    # multi-hundred-MB cols buffer every step. Instead the caller
    # quantizes S_max to a small bucket ladder and sorts problems by
    # length so each chunk's true length sits near its bucket.
    if segmented:
        seg_active_t, seg_first_t, seg_slen_t, seg_rnode_t, seg_rlen_t = (
            seg_tables
        )
        xs = (
            bandwidth,
            jax.lax.iota(jnp.int32, S_max),
            seg_active_t,
            seg_first_t,
            seg_slen_t,
            seg_rnode_t,
            seg_rlen_t,
        )
    else:
        xs = (bandwidth, jax.lax.iota(jnp.int32, S_max))
    # unroll: slice-scan unroll factor (GA_UNROLL, resolved in the
    # banded_scan wrapper so it participates in the jit-cache key).
    # Unrolling amortizes per-iteration loop mechanics (condition sync,
    # buffer bookkeeping) across k slices at compile-time cost.
    _, ys = jax.lax.scan(slice_step, carry0, xs, unroll=max(1, unroll))
    nm_pack, ctrl_pack, cols = ys  # [S,6,Nm,B], [S,B] packed, [S,7,Cm,B]
    sends = cols[:, 5]
    band_ids = nm_pack[:, 0]
    node_min = nm_pack[:, 1]
    node_end = nm_pack[:, 2]
    lens_tab = nm_pack[:, 3]
    pred_tab = nm_pack[:, 4]
    pred_prev = nm_pack[:, 5]
    # unpack the control word and reconstruct absolute per-slice minima
    # from the delta stream: cumulative sum with resets at segment
    # starts (fresh problems restart from 0) and the dispatch carry
    # (init_min) as each lane's base. Mirrored on the host in
    # batch_align._unpack_control — keep the two in sync.
    delta = ctrl_pack & 127
    num_cells = (ctrl_pack >> 7) & 0x1FFFFF
    overflow = ((ctrl_pack >> 28) & 7) != 0
    cs = jnp.cumsum(delta, axis=0)
    iota_sb = jax.lax.broadcasted_iota(jnp.int32, (S_max, B), 0)
    if segmented:
        reset = seg_rnode_t >= 0  # [S, B] fresh-problem starts
        last_reset = jax.lax.cummax(
            jnp.where(reset, iota_sb, -1), axis=0
        )
        prev_cs = jnp.concatenate(
            [jnp.zeros((1, B), cs.dtype), cs[:-1]], axis=0
        )
        base = jnp.where(
            last_reset >= 0,
            -jnp.take_along_axis(
                prev_cs, jnp.maximum(last_reset, 0), axis=0
            ),
            init_min[None, :],
        )
        active_m = seg_active_t == 1
    else:
        base = init_min[None, :]
        active_m = iota_sb < num_steps[None, :]
    min_score = jnp.where(active_m, cs + base, INF)
    import jax.numpy as _jnp

    # packed per-slot score deltas for the host band-order replay: the
    # qualification/expansion thresholds live within ~bw+128 of the slice
    # minimum, so 16 bits per score (clamped) quarters the tie-break
    # transfer vs full int32 node_min+node_end+ids — and when the
    # engine's max expansion width fits (ew <= 254, i.e. any default
    # bandwidth), 8 bits each halve it again: values at/above the clamp
    # only ever feed >=-threshold comparisons, never exact arithmetic
    # (same argument as the 16-bit clamp)
    nmin_d = _jnp.clip(node_min - min_score[:, None, :], 0, 32767)
    nend_d = _jnp.clip(node_end - min_score[:, None, :], 0, 32767)
    if tie8:
        tie_pack = (
            _jnp.minimum(nmin_d, 255) | (_jnp.minimum(nend_d, 255) << 8)
        ).astype(_jnp.int16)
    else:
        tie_pack = nmin_d | (nend_d << 16)

    # subsampled band-id HASH for the host/device differential check:
    # one slot-weighted uint32 mix per (slice, lane) — 32x fewer eager
    # bytes than shipping the Nm id rows, same divergence detection
    # (2^-32 per-slice false-negative only matters when a real bug
    # already exists). Definition shared with band_hash_np and the
    # native checker (ga_native.cpp ga_band_orders) — keep all three
    # in sync.
    w_hash = ((jax.lax.iota(jnp.int32, Nm) + 1).astype(jnp.uint32)
              * jnp.uint32(2654435761))
    ids_hash = jax.lax.bitcast_convert_type(
        _jnp.sum(
            band_ids[::8].astype(jnp.uint32) * w_hash[None, :, None],
            axis=1,
            dtype=jnp.uint32,
        ),
        jnp.int32,
    )

    return {
        "tie16": tie_pack,  # [S, Nm, B] int16 (8/8) or int32 (16/16)
        "ids_sub": ids_hash,  # [ceil(S/8), B] band-row hash (host check)
        "band_ids": band_ids,  # [S, Nm, B]
        "node_min": node_min,  # [S, Nm, B]
        "node_end": node_end,  # [S, Nm, B] last cell's last-row score
        "min_score": min_score,  # [S, B]
        "num_cells": num_cells,  # [S, B]
        "overflow": overflow,  # [S, B]
        # packed control fetch: the ONLY array the host control replay
        # needs eagerly; one small transfer instead of five multi-MB ones
        "control": ctrl_pack,  # [S, B] (min_delta | cells<<7 | ovf_bits<<28)
        # [S, 7, Cm, B]: vp_lo vp_hi vn_lo vn_hi sbs send e
        "cols": cols,
        "sends": sends,  # [S, Cm, B] per-cell last-row scores
        "lens_tab": lens_tab,  # [S, Nm, B] per-slot node lengths
        "pred_tab": pred_tab,  # [S, Nm, B] packed pred (slot|valid<<SB)<<FW*k
        # PREVIOUS-band pred slots, same packing: the walk kernel's
        # boundary diagonal reads preds out of the previous slice even
        # when they fell out of the current band (pickBacktracePredecessor
        # via getValueOrMax on the previous slice, GraphAligner.h:493-591)
        "pred_prev": pred_prev,  # [S, Nm, B] packed (prev_slot|in_prev<<SB)<<FW*k
        # read codes passed through to a DEVICE-RESIDENT buffer in the
        # walk kernel's [S, 64, B] layout: the backtrace walk gathers
        # its per-slice codes from here (batch_align._consolidate)
        # instead of re-uploading host-relaid codes per chunk
        "codes": jnp.transpose(
            read_codes.reshape(B, -1, WORD_SIZE), (1, 2, 0)
        ),  # [S, 64, B] uint8
    }


def band_hash_np(ids_rows: np.ndarray) -> np.ndarray:
    """Host mirror of the engine's band-row hash (see the ids_sub
    construction above and ga_native.cpp's checker — keep in sync):
    slot-weighted uint32 mix over the last axis ([..., Nm] topo-sorted,
    EMPTY-padded band ids) -> int32 hashes."""
    nm = ids_rows.shape[-1]
    w = ((np.arange(nm, dtype=np.uint64) + 1) * np.uint64(2654435761)).astype(
        np.uint32
    )
    h = np.asarray(
        np.sum(ids_rows.astype(np.uint32) * w, axis=-1, dtype=np.uint32)
    )
    return h.view(np.int32)


def make_seed_carry(tables: BandedGraphTables, start_nodes, Nm: int, Cm: int):
    """Initial carry for seeded problems: band = the seed node at score 0
    (reference getInitialSliceOnlyOneNode, GraphAligner.h:2945-2960)."""
    start_nodes = np.asarray(start_nodes, dtype=np.int32)
    B = len(start_nodes)
    ids = np.full((B, Nm), EMPTY, dtype=np.int32)
    ids[:, 0] = start_nodes
    lens = tables.node_len[start_nodes]
    cell_send = np.full((B, Cm), INF, dtype=np.int32)
    cell_send[np.arange(Cm)[None, :] < lens[:, None]] = 0
    node_min = np.full((B, Nm), INF, dtype=np.int32)
    node_min[:, 0] = 0
    node_end = np.full((B, Nm), INF, dtype=np.int32)
    node_end[:, 0] = 0
    mins = np.zeros(B, dtype=np.int32)
    return ids, cell_send, node_min, node_end, mins
