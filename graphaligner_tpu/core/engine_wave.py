"""Wavefront-scheduled batched alignment engine.

The column-scan engine (core.engine) runs slices sequentially: its
sequential depth is num_slices × num_positions. This engine skews the
computation: at wave τ, slice s processes graph column τ-s, so all
slices advance simultaneously and the depth drops to
num_positions + num_slices — an S-fold cut in sequential steps, which is
what bounds throughput when per-step loop overhead dominates the tiny
per-column vector work.

The wavefront is legal because slice s's column t needs only
(s, t-1) — same wave, previous step — and (s-1, t) — the previous wave's
result in the neighboring lane, passed lane-to-lane with a shift (the
previous slice's last-row score, "old_end"). No [P]-sized slice boundary
buffer exists at all.

Within-node columns advance bit-parallel (ops.wordops.myers_advance, the
Myers block step on uint32 pairs: reference GraphAligner.h:1349-1427).
Node-start columns expand their in-neighbor columns to score space,
advance, min-fold with the boundary column, re-close vertically with a
prefix-min, and re-pack — the reference's getNodeStartSlice +
mergeTwoSlices (GraphAligner.h:1270-1315, WordSlice.h:361-421) in a
vector-friendly form.

Outputs are identical to core.engine._align_batch_device.
"""

from __future__ import annotations

import functools

import numpy as np

from .params import WORD_SIZE

INF = np.int32(1 << 30)


def build_skewed_schedule(sched, num_slices: int):
    """Skew the column schedule: skewed[τ, s] = schedule[τ-s] (padded)."""
    P = len(sched.cell_pos)
    S = num_slices
    T = P + S - 1
    K = sched.pred_nodes.shape[1]
    code = np.full((T, S), 4, dtype=np.int32)
    start = np.zeros((T, S), dtype=bool)
    source = np.zeros((T, S), dtype=bool)
    slot = np.zeros((T, S), dtype=np.int32)
    preds = np.full((T, S, K), -1, dtype=np.int32)
    for s in range(S):
        sl = slice(s, s + P)
        code[sl, s] = sched.code
        start[sl, s] = sched.is_start
        source[sl, s] = sched.is_source_start
        slot[sl, s] = sched.node_slot
        preds[sl, s] = sched.pred_nodes
    return code, start, source, slot, preds, T


@functools.partial(
    __import__("jax").jit, static_argnames=("num_slices", "num_nodes", "P")
)
def _align_batch_wavefront(
    eq_by_slice,  # [S, 5, 2, B] uint32 Eq vectors per slice per graph code
    sk_code,  # [T, S]
    sk_start,  # [T, S] bool
    sk_source,  # [T, S] bool
    sk_slot,  # [T, S]
    sk_preds,  # [T, S, K]
    num_slices: int,
    num_nodes: int,
    P: int,
):
    import jax
    import jax.numpy as jnp

    from ..ops import wordops

    S = num_slices
    B = eq_by_slice.shape[-1]
    K = sk_preds.shape[-1]
    ar_s = jnp.arange(S)
    iota64 = jax.lax.broadcasted_iota(jnp.int32, (WORD_SIZE, S, B), 0)

    def expand(vp_lo, vp_hi, vn_lo, vn_hi, sbs):
        """packed [.., B] → scores [64, .., B] via bit extraction + log
        cumsum."""
        sh_lo = jnp.minimum(iota64, 31).astype(jnp.uint32)
        sh_hi = jnp.minimum(jnp.maximum(iota64 - 32, 0), 31).astype(jnp.uint32)
        lo = ((vp_lo[None] >> sh_lo) & 1).astype(jnp.int32)
        hi = ((vp_hi[None] >> sh_hi) & 1).astype(jnp.int32)
        vp = jnp.where(iota64 < 32, lo, hi)
        lo = ((vn_lo[None] >> sh_lo) & 1).astype(jnp.int32)
        hi = ((vn_hi[None] >> sh_hi) & 1).astype(jnp.int32)
        vn = jnp.where(iota64 < 32, lo, hi)
        d = vp - vn
        k = 1
        while k < WORD_SIZE:
            d = d + jnp.where(iota64 >= k, jnp.roll(d, k, axis=0), 0)
            k *= 2
        return sbs[None] + d

    def pack(scores, sbs):
        prev = jnp.where(
            iota64 == 0, sbs[None], jnp.roll(scores, 1, axis=0)
        )
        d = scores - prev
        shift = (iota64 % 32).astype(jnp.uint32)
        vp = jnp.where(d > 0, jnp.int32(1), jnp.int32(0)) << shift
        vn = jnp.where(d < 0, jnp.int32(1), jnp.int32(0)) << shift
        vp_lo = jnp.sum(jnp.where(iota64 < 32, vp, 0), axis=0)
        vp_hi = jnp.sum(jnp.where(iota64 >= 32, vp, 0), axis=0)
        vn_lo = jnp.sum(jnp.where(iota64 < 32, vn, 0), axis=0)
        vn_hi = jnp.sum(jnp.where(iota64 >= 32, vn, 0), axis=0)
        cast = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
        return cast(vp_lo), cast(vp_hi), cast(vn_lo), cast(vn_hi)

    def wave_step(carry, xs):
        vp_lo, vp_hi, vn_lo, vn_hi, sbs, send, e_prev, store = carry
        code_v, start_v, source_v, slot_v, preds_v = xs
        # previous slice's score at this column, passed lane-to-lane
        old_end = jnp.concatenate(
            [jnp.zeros((1, B), jnp.int32), send[:-1]], axis=0
        )
        # Eq words for each lane's column base code
        eq = jnp.take_along_axis(
            eq_by_slice, code_v[:, None, None, None], axis=1
        )[:, 0]  # [S, 2, B]
        eq_lo0, eq_hi = eq[:, 0], eq[:, 1]

        # ---- within-node chain path (bit domain) ------------------------
        r_chain = jnp.minimum(old_end, sbs + 1)
        hin = r_chain - sbs
        eq_lo_c = jnp.where(e_prev == 1, eq_lo0, eq_lo0 & ~jnp.uint32(1))
        c_vp_lo, c_vp_hi, c_vn_lo, c_vn_hi, c_send = wordops.myers_advance(
            eq_lo_c, eq_hi, vp_lo, vp_hi, vn_lo, vn_hi, send, hin
        )

        # ---- node-start path (bit domain) --------------------------------
        # boundary column: vertical continuation of the previous slice's
        # value (the mergable clamp / FromBefore, GraphAligner.h:1504-1509,
        # 1333-1337); for band sources at slice 0 (lane 0), the free-start
        # match (StartMatch) makes row 0 cost the match cost instead of 1.
        is_slice0 = (ar_s == 0)[:, None]
        sm0 = jnp.where(
            source_v[:, None] & is_slice0, 1 - (eq_lo0 & 1).astype(jnp.int32), 1
        )
        # VP = AllOnes & ~1 | firstVP where firstVP = match ? 0 : 1 = sm0
        u_vp_lo, u_vp_hi, u_vn_lo, u_vn_hi = (
            (jnp.full((S, B), 0xFFFFFFFF, jnp.uint32) & ~jnp.uint32(1))
            | sm0.astype(jnp.uint32),
            jnp.full((S, B), 0xFFFFFFFF, jnp.uint32),
            jnp.zeros((S, B), jnp.uint32),
            jnp.zeros((S, B), jnp.uint32),
        )
        merged = (
            u_vp_lo, u_vp_hi, u_vn_lo, u_vn_hi,
            old_end, old_end + 63 + sm0, jnp.ones((S, B), jnp.int32),
        )
        for k in range(K):
            pred = preds_v[:, k]  # [S]
            valid = (pred >= 0)[:, None]  # [S,1]
            safe = jnp.maximum(pred, 0)
            g = store[safe, :, ar_s]  # [S, 7, B] int32
            g_vp_lo = jax.lax.bitcast_convert_type(g[:, 0], jnp.uint32)
            g_vp_hi = jax.lax.bitcast_convert_type(g[:, 1], jnp.uint32)
            g_vn_lo = jax.lax.bitcast_convert_type(g[:, 2], jnp.uint32)
            g_vn_hi = jax.lax.bitcast_convert_type(g[:, 3], jnp.uint32)
            g_sbs, g_e = g[:, 4], g[:, 6]
            eq_lo_k = jnp.where(g_e == 1, eq_lo0, eq_lo0 & ~jnp.uint32(1))
            a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, a_send = wordops.myers_advance(
                eq_lo_k, eq_hi, g_vp_lo, g_vp_hi, g_vn_lo, g_vn_hi,
                g[:, 5], jnp.ones((S, B), jnp.int32),
            )
            adv = (
                a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi,
                g_sbs + 1, a_send, g_e,
            )
            candidate = wordops.merge_slices(merged, adv)
            merged = tuple(
                jnp.where(valid, c, m) for c, m in zip(candidate, merged)
            )
        s_vp_lo, s_vp_hi, s_vn_lo, s_vn_hi, r_st, s_send, _ = merged

        # ---- select per lane ---------------------------------------------
        st = start_v[:, None]
        n_vp_lo = jnp.where(st, s_vp_lo, c_vp_lo)
        n_vp_hi = jnp.where(st, s_vp_hi, c_vp_hi)
        n_vn_lo = jnp.where(st, s_vn_lo, c_vn_lo)
        n_vn_hi = jnp.where(st, s_vn_hi, c_vn_hi)
        n_sbs = jnp.where(st, r_st, r_chain)
        n_send = jnp.where(st, s_send, c_send)
        n_e = (n_sbs == old_end).astype(jnp.int32)

        # store writeback (per-lane node slot)
        vals = jnp.stack(
            [
                jax.lax.bitcast_convert_type(n_vp_lo, jnp.int32),
                jax.lax.bitcast_convert_type(n_vp_hi, jnp.int32),
                jax.lax.bitcast_convert_type(n_vn_lo, jnp.int32),
                jax.lax.bitcast_convert_type(n_vn_hi, jnp.int32),
                n_sbs,
                n_send,
                n_e,
            ],
            axis=1,
        )  # [S, 7, B]
        store = store.at[slot_v, :, ar_s].set(vals)

        out = (n_vp_lo, n_vp_hi, n_vn_lo, n_vn_hi, n_sbs, n_send)
        return (
            (n_vp_lo, n_vp_hi, n_vn_lo, n_vn_hi, n_sbs, n_send, n_e, store),
            out,
        )

    init = (
        jnp.zeros((S, B), jnp.uint32),
        jnp.zeros((S, B), jnp.uint32),
        jnp.zeros((S, B), jnp.uint32),
        jnp.zeros((S, B), jnp.uint32),
        jnp.full((S, B), INF, jnp.int32),
        jnp.full((S, B), INF, jnp.int32),
        jnp.zeros((S, B), jnp.int32),
        jnp.zeros((num_nodes, 7, S, B), jnp.int32),
    )
    xs = (sk_code, sk_start, sk_source, sk_slot, sk_preds)
    _, outs = jax.lax.scan(wave_step, init, xs)
    # outs: each [T, S, B]
    return outs


def deskew(outs, P: int, num_slices: int):
    """[T, S, B] wave outputs → [S, P, B] per-slice column outputs."""
    S = num_slices
    result = []
    for arr in outs:
        arr = np.asarray(arr)
        out = np.empty((S, P) + arr.shape[2:], dtype=arr.dtype)
        for s in range(S):
            out[s] = arr[s : s + P, s]
        result.append(out)
    return result
