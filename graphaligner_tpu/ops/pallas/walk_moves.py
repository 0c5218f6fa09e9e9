"""Backtrace walk emitting 4-bit move codes: a GPU kernel (Pallas,
Triton route) and the same walk as plain JAX.

The reference backtrace (pickBacktracePredecessor/getTraceFromTable,
GraphAligner.h:493-591, 894-1021) is a per-read sequential walk with
random access into the DP table. Here every lane walks on its own: one
lane per thread, its state in registers, every table access an indexed
load from the window's tables in device memory. Lanes share nothing, so
a block of lanes runs until its slowest lane stops.

Instead of (position, row) pairs, each step emits a 4-bit move code,
packed 8 per int32 word per lane. The host decodes moves back into the
exact trace with the native C++ decoder (native/ga_native.cpp), which
replays the same predecessor rules over the host graph and skips PAD
codes wherever they sit in a lane's stream.

The walk never touches graph positions on device: state is (slice,
band slot, in-node offset), with node identity resolved through the
per-slice band tables the engine already records.

Move codes (K_in <= 4):
  0       PAD   (nothing: unused tail of a lane's stream)
  1       STOP  (row-0 free start, GraphAligner.h:505-513; appends
                 (w, row-1) and terminates)
  2       V     vertical (w, row-1)
  3       H0    horizontal within node (w-1, row)
  4       D0    diagonal within node (w-1, row-1)
  8+k     Hk    horizontal via in-neighbor k (pred node end, row)
  12+k    Dk    diagonal via in-neighbor k (pred node end, row-1)

Lane state rows ([16, B] int32, carried from window to window):
0 sk (global table slice the lane is in), 1 row, 2 slot, 3 off, 4 here
(score at the current cell), 5 done, 6 fail, 7 needs_col, 8-12 the
current column packed 5 words, 13-15 unused.
"""

from __future__ import annotations

import functools

import numpy as np

INF = np.int32(1 << 20)
EMPTY = np.int32(2**31 - 1)
# steps a lane may take inside one slice before it is failed: a slice has
# 64 rows, and horizontal moves only lower the score, so a walk that
# needs more is stuck
W_CAP = 448

_JIT_CACHE: dict = {}


def moves_rows(K: int) -> int:
    """Rows of the [T_w, B] moves array for a K-slice window: a budget
    of 112 moves per slice plus 512, 8 moves per row."""
    return (K * 112 + 512 + 7) // 8


def walk_moves(*args, K_in, impl="triton", interpret=False):
    """jit-cached entry (one jit instance per shape signature — see the
    dispatch-fastpath note in core.engine_banded).

    args: cols_tab [K+1, 7, Cm, B] packed columns, entry 0 = the slice
    BELOW the window (zero pad when the window starts at the table
    bottom); band_tab / lens_tab / pred_tab / pred_prev_tab [K+1, Nm, B]
    band node ids, node lengths, packed current-band pred slots
    (slot|valid<<SB)<<FW*k (ops.kernels) and packed previous-band pred
    slots; codes8 [K+1, 64, B] uint8 read codes; bits_lut [R] read-code
    -> 5-bit match mask; seq_len, seed_node, win_base [1, B] (this call walks GLOBAL
    table slices (base, base+K]); init_state [16, B].

    Returns (moves [T_w, B], fail [1, B], state_out [16, B], used
    [1, B] = each lane's move count, so the host fetches only the
    written prefix). Long reads walk window by window (state_out of
    window w feeds init_state of window w-1); one window with base 0 is
    the whole-table walk. impl "triton" runs the Pallas kernel, "xla"
    the same step function under a plain lax.while_loop."""
    import jax

    shapes = tuple(a.shape for a in args)
    key = (shapes, K_in, impl, interpret)
    fn = _JIT_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            functools.partial(
                _walk_moves, K_in=K_in, impl=impl, interpret=interpret
            )
        )
        _JIT_CACHE[key] = fn
    return fn(*args)


def _walk_moves(cols_tab, band_tab, lens_tab, pred_tab, pred_prev_tab,
                codes8, bits_lut, seq_len, seed_node, win_base, init_state,
                *, K_in, impl, interpret):
    import jax.numpy as jnp

    K1, _, Cm, B = cols_tab.shape
    K = K1 - 1
    Nm = band_tab.shape[1]
    assert K_in <= 4, K_in
    T_w = moves_rows(K)
    # walk column layout: fields 0-3 the vp/vn words, field 4 =
    # sbs | e<<24, field 5 = send (read only from the previous slice)
    cols6 = jnp.concatenate(
        [
            cols_tab[:, :4],
            (cols_tab[:, 4:5] & 0xFFFFFF) | (cols_tab[:, 6:7] << 24),
            cols_tab[:, 5:6],
        ],
        axis=1,
    )
    # per-slice derived tables: first cell of each slot, and each slot's
    # slot in the slice below (-1: node not in that band)
    offs = jnp.cumsum(lens_tab, axis=1) - lens_tab
    valid = band_tab != EMPTY
    same = (
        (band_tab[1:, :, None, :] == band_tab[:-1, None, :, :])
        & valid[1:, :, None, :]
        & valid[:-1, None, :, :]
    )  # [K, Nm, Nm_prev, B]
    prevslot = jnp.where(
        jnp.any(same, axis=2), jnp.argmax(same, axis=2), -1
    ).astype(jnp.int32)
    prevslot = jnp.concatenate(
        [jnp.full((1, Nm, B), -1, jnp.int32), prevslot], axis=0
    )
    mtab = bits_lut[codes8.astype(jnp.int32)]  # [K1, 64, B] match masks
    tabs = (cols6, band_tab, offs, lens_tab, pred_tab, pred_prev_tab,
            prevslot, mtab, seq_len, seed_node, win_base, init_state)
    if impl == "xla":
        return _walk_xla(tabs, K=K, K_in=K_in, T_w=T_w)
    from ..kernels import LANE_BLOCK as Bb

    Bp = -(-B // Bb) * Bb
    if Bp != B:
        # pad lanes start done (state row 5) and emit nothing
        tabs = tuple(
            jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Bp - B)]) for a in tabs
        )
        tabs = tabs[:-1] + (tabs[-1].at[5, B:].set(1),)
    outs = _walk_call(K, Cm, Nm, Bp, Bb, K_in, T_w, interpret)(*tabs)
    return tuple(o[:, :B] for o in outs)


def _any(x):
    import jax.numpy as jnp

    # (Triton lowers max, not the boolean any-reduction)
    return jnp.max(x.astype(jnp.int32)) > 0


def _walk_step(T, lanes, seq_len_v, seed_v, base_v, S, *, K, K_in, T_w):
    """One move of every running lane. T: the tables, indexable as
    T[i][slice, ..., lanes] (Pallas refs in the kernel, arrays under
    XLA). S: lane state (sk, row, slot, off, here, done, fail, needs,
    c0..c4, t, ns, word). Returns (S', moves row, moves word)."""
    import jax
    import jax.numpy as jnp

    from .. import wordops
    from ..kernels import pred_slot_bits

    cols, band, offs, lens, pred, pprev, prevslot, mtab = T[:8]
    Cm = cols.shape[2]
    Nm = band.shape[1]
    (sk, row_in, slot, off, here, done, fail, needs,
     c0, c1, c2, c3, c4, t, ns, word) = S
    shape = sk.shape
    zero = jnp.zeros(shape, jnp.int32)
    u32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)

    active = _running(S, base_v, K)
    e = jnp.clip(sk - base_v, 1, K)  # this slice's window entry
    ep = e - 1  # the slice below
    q = sk
    slot_c = jnp.clip(slot, 0, Nm - 1)

    def nm(tab, ent, s):
        return tab[ent, jnp.clip(s, 0, Nm - 1), lanes]

    def read5(ent, cell):
        cell = jnp.clip(cell, 0, Cm - 1)
        return tuple(cols[ent, f, cell, lanes] for f in range(5))

    def unpack7(p5):
        return (
            p5[0], p5[1], p5[2], p5[3], p5[4] & 0xFFFFFF, zero,
            jax.lax.shift_right_logical(p5[4], 24),
        )

    def pack5(col7):
        return (
            col7[0], col7[1], col7[2], col7[3],
            (col7[4] & 0xFFFFFF) | (col7[6] << 24),
        )

    def col_value(col, r):
        """Score at row r (masked popcount, WordSlice::getValue)."""
        r = jnp.clip(r, 0, 63)
        n_lo = jnp.minimum(r + 1, 32).astype(jnp.uint32)
        n_hi = jnp.clip(r + 1 - 32, 0, 32).astype(jnp.uint32)
        m_lo = jnp.where(
            n_lo >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << n_lo) - 1
        )
        m_hi = jnp.where(
            n_hi >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << n_hi) - 1
        )
        pc = lambda x: wordops.popcount32(x).astype(jnp.int32)
        return (
            col[4]
            + pc(u32(col[0]) & m_lo)
            + pc(u32(col[1]) & m_hi)
            - pc(u32(col[2]) & m_lo)
            - pc(u32(col[3]) & m_hi)
        )

    zeros5 = (zero,) * 5
    cell = nm(offs, e, slot_c) + off
    needs_fresh = active & (needs == 1)
    # a fresh column read is only needed on slice-entry steps
    fresh = jax.lax.cond(
        _any(needs_fresh), lambda: read5(e, cell), lambda: zeros5
    )
    cache = (c0, c1, c2, c3, c4)
    col5 = tuple(jnp.where(needs_fresh, a, b) for a, b in zip(fresh, cache))
    col = unpack7(col5)

    node_id = nm(band, e, slot_c)
    is_start = off == 0
    grow = (q - 1) * 64 + row_in  # global row
    code = (col[6] >> 1) & 7
    mt = mtab[e, jnp.clip(row_in, 0, 63), lanes]
    matched = ((mt >> code) & 1) == 1
    default = seq_len_v

    # row-0 free-start stop
    spec = (
        active & (grow == 0) & (node_id == seed_v) & (here >= 0)
        & (here <= 1)
    )
    decided = spec | ~active
    move = jnp.where(spec, 1, 0)
    n_slot = slot
    n_off = off
    n_row = jnp.where(spec, row_in - 1, row_in)
    n_here = here
    n_col = col
    predw = nm(pred, e, slot_c)
    predprevw = nm(pprev, e, slot_c)
    SB = pred_slot_bits(Nm)
    FW, SMASK = SB + 1, (1 << SB) - 1
    pslots = [(predw >> (FW * k)) & SMASK for k in range(K_in)]
    pslots_prev = [(predprevw >> (FW * k)) & SMASK for k in range(K_in)]
    pprev_valids = [
        ((predprevw >> (FW * k + SB)) & 1) == 1 for k in range(K_in)
    ]
    u_offs = [
        jnp.where(is_start, nm(lens, e, pslots[k]) - 1, off - 1)
        for k in range(K_in)
    ]

    # boundary (row 0) values from the slice below, needed only when some
    # lane sits at row 0. Preds are read by PREVIOUS-band slot
    # (pslots_prev), so the boundary diagonal sees preds that fell out
    # of the current band (pickBacktracePredecessor reads the previous
    # slice via getValueOrMax regardless of current-band membership);
    # the same node's own value resolves through prevslot.
    def bd_read():
        pslot_here = nm(prevslot, e, slot_c)

        def prev_value(off_):
            cellp = nm(offs, ep, pslot_here) + off_
            send5 = cols[ep, 5, jnp.clip(cellp, 0, Cm - 1), lanes]
            v = jnp.where(pslot_here >= 0, send5, default)
            init_v = jnp.where(node_id == seed_v, 0, default)
            return jnp.where(q == 1, init_v, v)

        # within-node diagonal value (same node, off-1) for ~is_start
        # lanes — k==0's only D candidate there
        wn_d = prev_value(off - 1)
        vals = []
        offs_po = []
        for k in range(K_in):
            off_pk = nm(lens, ep, pslots_prev[k]) - 1
            cellk = nm(offs, ep, pslots_prev[k]) + off_pk
            send5 = cols[ep, 5, jnp.clip(cellk, 0, Cm - 1), lanes]
            # q==1: the synthetic initial band holds only the seed node
            # at score 0, so membership implies value 0
            v = jnp.where(q == 1, 0, send5)
            sv = jnp.where(pprev_valids[k], v, default)
            vals.append(jnp.where(is_start, sv, wn_d))
            offs_po.append(off_pk)
        vals.append(prev_value(off))
        return tuple(vals + offs_po)

    bd_st = jax.lax.cond(
        _any(active & (row_in == 0)),
        bd_read,
        lambda: (default,) * (2 * K_in + 1),
    )
    bd = bd_st[: K_in + 1]
    po_offs = bd_st[K_in + 1 :]
    # k>=1 predecessor columns only exist at node-start cells
    any_start = _any(active & is_start)
    po_any = jnp.zeros(shape, bool)
    po_slot = zero
    po_off = zero
    for k in range(K_in):
        pslot_k = pslots[k]
        pvalid_k = ((predw >> (FW * k + SB)) & 1) == 1
        u_slot = jnp.where(is_start, pslot_k, slot)
        u_off = u_offs[k]
        if k == 0:
            uv = active & (pvalid_k | ~is_start)
        else:
            uv = active & is_start & pvalid_k
        u_cell = nm(offs, e, u_slot) + u_off
        if k == 0:
            u_col = unpack7(read5(e, u_cell))
        else:
            u_col = unpack7(
                jax.lax.cond(
                    any_start,
                    functools.partial(read5, e, u_cell),
                    lambda: zeros5,
                )
            )
        horizontal = jnp.where(uv, col_value(u_col, row_in), INF)
        take_h = uv & (horizontal == here - 1) & ~decided
        diag_in = col_value(u_col, row_in - 1)
        diag = jnp.where(row_in == 0, bd[k], diag_in)
        d_ok = (matched & (diag == here)) | (~matched & (diag == here - 1))
        # the boundary diagonal (row 0) additionally admits preds present
        # only in the PREVIOUS band; bd[k] already carries their values
        prev_only_k = (
            active & is_start & (row_in == 0) & ~pvalid_k & pprev_valids[k]
        )
        take_d = (uv | prev_only_k) & d_ok & ~decided & ~take_h
        take = take_h | take_d
        move = jnp.where(take_h, jnp.where(is_start, 8 + k, 3), move)
        move = jnp.where(take_d, jnp.where(is_start, 12 + k, 4), move)
        n_slot = jnp.where(take, u_slot, n_slot)
        n_off = jnp.where(take, u_off, n_off)
        n_row = jnp.where(take_d, row_in - 1, n_row)
        n_here = jnp.where(take_h | (take_d & ~matched), here - 1, n_here)
        n_col = tuple(jnp.where(take, u, c) for u, c in zip(u_col, n_col))
        # a prev-only D lands directly in the slice below at the pred's
        # end cell: keep its PREV-band slot/off — the generic transition
        # below re-expresses via the current band and would resolve a
        # junk slot for these lanes
        po_fire = take_d & prev_only_k
        po_any = po_any | po_fire
        po_slot = jnp.where(po_fire, pslots_prev[k], po_slot)
        po_off = jnp.where(po_fire, po_offs[k], po_off)
        decided = decided | take
    vert_in = col_value(col, row_in - 1)
    vert = jnp.where(row_in == 0, bd[K_in], vert_in)
    take_v = active & (vert == here - 1) & ~decided
    move = jnp.where(take_v, 2, move)
    n_row = jnp.where(take_v, row_in - 1, n_row)
    n_here = jnp.where(take_v, here - 1, n_here)
    decided = decided | take_v

    new_fail = active & ~decided
    moved_down = decided & ~spec & (n_row < row_in) & (row_in == 0)
    # slice transition: re-express (slot, off) in the lower slice's band
    t_slot = jnp.maximum(nm(prevslot, e, n_slot), 0)
    # prev-only D destinations already carry their PREV-band slot
    t_slot = jnp.where(po_any, po_slot, t_slot)
    n_off = jnp.where(po_any, po_off, n_off)
    n_sk = jnp.where(moved_down, sk - 1, sk)
    n_slot = jnp.where(moved_down, t_slot, n_slot)
    n_row2 = jnp.where(moved_down, 63, n_row)
    needs2 = (active & moved_down) | (~active & (needs == 1))
    # a downward move out of slice 1 means row -1: done (the -1 row
    # entry is implicit; the decoder appends and pops it like the host)
    new_done = spec | (done == 1) | ((q == 1) & moved_down)
    ncp = pack5(n_col)
    cache2 = tuple(jnp.where(active, a, b) for a, b in zip(ncp, col5))

    move = jnp.where(active, move, 0)
    w = word | (move << (4 * (t % 8)))
    mrow = jnp.minimum(t // 8, T_w - 1)
    act_i = active.astype(jnp.int32)
    n_word = jnp.where(active & (t % 8 == 7), 0, w)
    n_ns = jnp.where(moved_down, 0, ns + act_i)
    S2 = (
        n_sk, n_row2, n_slot, n_off, n_here, new_done.astype(jnp.int32),
        ((fail == 1) | new_fail).astype(jnp.int32),
        needs2.astype(jnp.int32), *cache2, t + act_i, n_ns, n_word,
    )
    return S2, mrow, w


def _running(S, base_v, K):
    sk, done, fail, t, ns = S[0], S[5], S[6], S[13], S[14]
    return (
        (sk > base_v) & (done == 0) & (fail == 0) & (ns < W_CAP)
        & (t < K * 112 + 512 - 1)
    )


def _finish(S, base_v):
    """(fail, the 16 state_out rows, used) of a finished window. A lane
    still INSIDE the window (sk > base) that is not done got stuck ->
    fail; lanes with sk <= base continue in the next (lower) window via
    state_out."""
    import jax.numpy as jnp

    sk, done, fail, t = S[0], S[5], S[6], S[13]
    fail_out = ((fail == 1) | ((done == 0) & (sk > base_v))).astype(
        jnp.int32
    )
    zero = jnp.zeros_like(sk)
    return fail_out, list(S[:13]) + [zero, zero, zero], t


def _walk_xla(tabs, *, K, K_in, T_w):
    import jax
    import jax.numpy as jnp

    T = tabs[:8]
    seq_len, seed, base, init = tabs[8:]
    B = init.shape[1]
    lanes = jnp.arange(B, dtype=jnp.int32)
    zero = jnp.zeros(B, jnp.int32)
    S0 = tuple(init[r] for r in range(13)) + (zero, zero, zero)

    def cond(c):
        return jnp.any(_running(c[0], base[0], K))

    def body(c):
        S, moves = c
        S2, mrow, w = _walk_step(
            T, lanes, seq_len[0], seed[0], base[0], S, K=K, K_in=K_in,
            T_w=T_w,
        )
        return S2, moves.at[mrow, lanes].set(w)

    S, moves = jax.lax.while_loop(
        cond, body, (S0, jnp.zeros((T_w, B), jnp.int32))
    )
    fail, rows, used = _finish(S, base[0])
    return moves, fail[None], jnp.stack(rows, axis=0), used[None]


@functools.lru_cache(maxsize=None)
def _walk_call(K, Cm, Nm, B, Bb, K_in, T_w, interpret):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    def kernel(cols_ref, band_ref, offs_ref, lens_ref, pred_ref, pprev_ref,
               prevslot_ref, mtab_ref, sl_ref, seed_ref, base_ref, init_ref,
               moves_ref, fail_ref, stout_ref, used_ref):
        lanes = pl.program_id(0) * Bb + jax.lax.iota(jnp.int32, Bb)
        zero = jnp.zeros((Bb,), jnp.int32)

        def clear(r, carry):
            moves_ref[r, lanes] = zero
            return carry

        jax.lax.fori_loop(0, T_w, clear, jnp.int32(0))
        T = (cols_ref, band_ref, offs_ref, lens_ref, pred_ref, pprev_ref,
             prevslot_ref, mtab_ref)
        seq_len_v = sl_ref[0, lanes]
        seed_v = seed_ref[0, lanes]
        base_v = base_ref[0, lanes]
        S0 = tuple(init_ref[r, lanes] for r in range(13)) + (zero,) * 3

        def cond(S):
            return _any(_running(S, base_v, K))

        def body(S):
            S2, mrow, w = _walk_step(
                T, lanes, seq_len_v, seed_v, base_v, S, K=K, K_in=K_in,
                T_w=T_w,
            )
            moves_ref[mrow, lanes] = w
            return S2

        S = jax.lax.while_loop(cond, body, S0)
        fail, rows, used = _finish(S, base_v)
        fail_ref[0, lanes] = fail
        for r, row in enumerate(rows):
            stout_ref[r, lanes] = row
        used_ref[0, lanes] = used

    return pl.pallas_call(
        kernel,
        grid=(B // Bb,),
        out_shape=[
            jax.ShapeDtypeStruct((T_w, B), jnp.int32),
            jax.ShapeDtypeStruct((1, B), jnp.int32),
            jax.ShapeDtypeStruct((16, B), jnp.int32),
            jax.ShapeDtypeStruct((1, B), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="walk_moves",
    )
