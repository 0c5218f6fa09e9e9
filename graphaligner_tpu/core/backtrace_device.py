"""Batched device-side backtrace walk.

The reference walks the DP table cell-by-cell on the CPU
(pickBacktracePredecessor / getTraceFromTable, GraphAligner.h:493-591,
894-1021). Here the packed DP columns live in device memory, and
shipping them to the host (~130 KB/read) would cost more than the walk
itself — so the walk runs on device, one loop step per trace position
with every lane advancing in lockstep, and only the final (graph
position, read row) trace pairs (~5 KB/read) cross to the host. It is
the plain-XLA alternative to the move-walk kernel
(ops.pallas.walk_moves) for single-window walks.

The predecessor priority order is the reference's, replicated as masked
selects: the row-0 free-start stop, then per in-neighbor (adjacency
order) horizontal-then-diagonal, then vertical — this order defines
tie-breaking and therefore byte-identical GAM output. Score lookups
expand packed columns with masked popcounts (WordSlice::getValue,
WordSlice.h:223-229). Slice 0 (the seed initial slice,
getInitialSliceOnlyOneNode) is synthesized arithmetically: score 0 on
the seed node, absent elsewhere.

Array layouts keep the batch as the last axis ([K, Nm, B] bands,
[7, B, K*Cm] columns); see engine_banded's layout note.

Like the host backtrace, a lane that takes no legal predecessor (or
exceeds the step budget) raises a per-lane fail flag and falls back to
the host path, mirroring the reference's per-read AssertionFailure
isolation (Aligner.cpp:124-148).
"""

from __future__ import annotations

import functools

import numpy as np

from .engine import _MATCH_TABLE, _READ_CODE
from .engine_banded import EMPTY, INF
from .params import WORD_SIZE

# backtrace-time character match (reference characterMatch in NDEBUG as the
# backtrace consumes it, GraphAligner.h:2039-2110): like the DP Eq table but
# read-side 'N' matches everything INCLUDING dummy '-' cells.
_BT_MATCH = _MATCH_TABLE.copy()
_BT_MATCH[_READ_CODE["N"], :] = True

_JIT_CACHE: dict = {}


def walk_batch(
    tables,
    cols_tab,  # [7, B, K_max*Cm] int32 (field-major packed columns)
    band_tab,  # [K_max, Nm, B] int32
    read_codes,  # [B, L] uint8
    seq_len,  # [B] int32 (padded length)
    seed_node,  # [B] int32 (initial slice's single band node)
    start_w,  # [B] int32 graph position of the backtrace start
    num_slices,  # [B] int32 K: table slice count (>=1)
    T_max: int,
):
    """Returns (trace [T_max+1, 2, B] int32, fail [B] bool).
    trace[0] is the start position; entries after the walk finishes hold
    the (-1, -2) pad."""
    K_max, Nm, B = band_tab.shape
    Cm = cols_tab.shape[2] // K_max
    key = (K_max, B, Cm, Nm, T_max, tables.k_in)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        import jax

        fn = jax.jit(functools.partial(_walk, T_max=T_max, Cm=Cm))
        _JIT_CACHE[key] = fn
    return fn(
        tables.node_start,
        tables.node_end,
        tables.seq_codes,
        tables.in_nbrs,
        tables.pos_to_node,
        tables.node_len,
        cols_tab,
        band_tab,
        read_codes,
        seq_len,
        seed_node,
        start_w,
        num_slices,
        _BT_MATCH,
    )


def _walk(
    node_start,
    node_end,
    seq_codes,
    in_nbrs,
    pos_to_node,
    node_len,
    cols_tab,
    band_tab,
    read_codes,
    seq_len,
    seed_node,
    start_w,
    num_slices,
    bt_match,
    *,
    T_max: int,
    Cm: int,
):
    import jax
    import jax.numpy as jnp

    K_max, Nm, B = band_tab.shape
    K_in = in_nbrs.shape[1]
    iota_nm = jax.lax.broadcasted_iota(jnp.int32, (Nm, 1), 0)

    # per-slice exclusive cell offsets from band ids
    lens_tab = jnp.where(
        band_tab < EMPTY, node_len[jnp.clip(band_tab, 0, node_len.shape[0] - 1)], 0
    )
    offs_tab = jnp.cumsum(lens_tab, axis=1) - lens_tab  # [K_max, Nm, B]

    def locate(sk, node):
        """(found, first cell index) of `node`'s cells in table slice sk
        (sk >= 1; row sk-1 of the tabs). [B] in, [B] out."""
        k = jnp.clip(sk - 1, 0, K_max - 1)
        ids = jnp.take_along_axis(band_tab, k[None, None, :], axis=0)[0]  # [Nm, B]
        offs = jnp.take_along_axis(offs_tab, k[None, None, :], axis=0)[0]
        eq = ids == node[None, :]
        found = jnp.any(eq, axis=0)
        slot = jnp.argmax(eq, axis=0)
        return found, jnp.take_along_axis(offs, slot[None, :], axis=0)[0]

    def value(sk, w, r, default):
        """Score at (table slice sk, graph position w, slice row r);
        `default` where the position's node is outside the band
        (reference getValueOrMax)."""
        w = jnp.clip(w, 0, pos_to_node.shape[0] - 1)
        node = pos_to_node[w]
        found, first = locate(sk, node)
        cell = first + (w - node_start[node])
        flat = jnp.clip(sk - 1, 0, K_max - 1) * Cm + jnp.clip(cell, 0, Cm - 1)
        col = jnp.take_along_axis(cols_tab, flat[None, :, None], axis=2)[
            :, :, 0
        ]  # [7, B]
        r = jnp.clip(r, 0, WORD_SIZE - 1)
        # masked popcount expansion (WordSlice::getValue)
        n_lo = jnp.minimum(r + 1, 32)
        n_hi = jnp.clip(r + 1 - 32, 0, 32)
        m_lo = jnp.where(
            n_lo >= 32,
            jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << n_lo.astype(jnp.uint32)) - 1,
        )
        m_hi = jnp.where(
            n_hi >= 32,
            jnp.uint32(0xFFFFFFFF),
            (jnp.uint32(1) << n_hi.astype(jnp.uint32)) - 1,
        )
        u = lambda i: jax.lax.bitcast_convert_type(col[i], jnp.uint32)
        v = (
            col[4]
            + jax.lax.population_count(u(0) & m_lo).astype(jnp.int32)
            + jax.lax.population_count(u(1) & m_hi).astype(jnp.int32)
            - jax.lax.population_count(u(2) & m_lo).astype(jnp.int32)
            - jax.lax.population_count(u(3) & m_hi).astype(jnp.int32)
        )
        # slice 0 = synthetic initial slice: 0 on the seed node, absent else
        v = jnp.where(sk == 0, jnp.int32(0), v)
        found = jnp.where(sk == 0, node == seed_node, found)
        return jnp.where(found, v, default)

    def has_node(sk, node):
        found, _ = locate(sk, node)
        return jnp.where(sk == 0, node == seed_node, found)

    def step(carry, _):
        sk, w, row, done, fail = carry
        row_in = row - (sk - 1) * WORD_SIZE
        wn = jnp.clip(w, 0, pos_to_node.shape[0] - 1)
        node = pos_to_node[wn]
        default = seq_len
        here = value(sk, w, row_in, default)
        prev_k = jnp.where(row_in > 0, sk, sk - 1)

        # row-0 free-start stop (GraphAligner.h:505-513)
        spec = (row == 0) & has_node(prev_k, node) & ((here == 0) | (here == 1))

        # predecessors in adjacency order
        is_start = w == node_start[node]
        rc = jnp.take_along_axis(
            read_codes.astype(jnp.int32),
            jnp.clip(row, 0, read_codes.shape[1] - 1)[:, None],
            axis=1,
        )[:, 0]
        gcode = seq_codes[wn]
        matched = bt_match[rc, gcode]

        decided = spec | done
        n_w = jnp.where(spec, w, 0)
        n_row = jnp.where(spec, row - 1, 0)
        for k in range(K_in):
            nb = in_nbrs[node, k]
            u_start = jnp.where(
                nb >= 0, node_end[jnp.clip(nb, 0, node_end.shape[0] - 1)] - 1, -1
            )
            u = jnp.where(is_start, u_start, w - 1)
            uv = jnp.where(is_start, nb >= 0, k == 0)
            horizontal = value(sk, u, row_in, default)
            take_h = uv & (horizontal == here - 1) & ~decided
            n_w = jnp.where(take_h, u, n_w)
            n_row = jnp.where(take_h, row, n_row)
            decided = decided | take_h
            diag = jnp.where(
                row_in == 0,
                value(sk - 1, u, jnp.full(B, WORD_SIZE - 1), default),
                value(sk, u, row_in - 1, default),
            )
            take_d = (
                uv & jnp.where(matched, diag == here, diag == here - 1) & ~decided
            )
            n_w = jnp.where(take_d, u, n_w)
            n_row = jnp.where(take_d, row - 1, n_row)
            decided = decided | take_d
        vert = jnp.where(
            row_in == 0,
            value(sk - 1, w, jnp.full(B, WORD_SIZE - 1), default),
            value(sk, w, row_in - 1, default),
        )
        take_v = (vert == here - 1) & ~decided
        n_w = jnp.where(take_v, w, n_w)
        n_row = jnp.where(take_v, row - 1, n_row)
        decided = decided | take_v

        fail = fail | (~decided & ~done)
        n_w = jnp.where(done | fail, w, n_w)
        n_row = jnp.where(done | fail, row, n_row)
        n_sk = jnp.where(n_row < (sk - 1) * WORD_SIZE, sk - 1, sk)
        n_done = done | (n_row == -1)
        out = (
            jnp.where(done | fail, -1, n_w),
            jnp.where(done | fail, -2, n_row),
        )
        return (n_sk, n_w, n_row, n_done, fail), out

    row0 = num_slices * WORD_SIZE - 1
    init = (
        num_slices,
        start_w,
        row0,
        num_slices < 1,
        jnp.zeros(B, bool),
    )
    (sk, w, row, done, fail), (out_w, out_r) = jax.lax.scan(
        step, init, None, length=T_max
    )
    fail = fail | ~done  # ran out of steps
    trace_w = jnp.concatenate([start_w[None], out_w], axis=0)  # [T_max+1, B]
    trace_r = jnp.concatenate([row0[None], out_r], axis=0)
    return jnp.stack([trace_w, trace_r], axis=1), fail  # [T_max+1, 2, B]
