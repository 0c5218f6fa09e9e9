"""Banded slice cell pass as one GPU kernel (Pallas, Triton route).

One call advances every band cell of one 64-row DP slice for every
batch lane: the Myers block advance along node chains (reference
getNextSlice, GraphAligner.h:1349-1427), the fused uniform
boundary/pseudo/source column, and the differenceMasks merges at node
joins (WordSlice.h:361-421). It is the same bit algebra as the XLA path
in core.engine_banded (cell_pass_xla), which is its reference.

Layout: one grid program per block of `Bb` lanes, programs independent.
Each lane is one element of a [Bb] vector, so one thread carries one
lane's running column in registers through a `fori_loop` over the Cm
cells. The per-slot node-end state (`buf`, 7 fields) and the per-slot
minima live in the kernel's outputs in device memory; a node start
reads its predecessors' end columns with indexed loads at their slots,
and a node end writes its own slot. Every lane touches only its own
column of those arrays, so no two threads share an address. Both arrays
carry one extra dummy slot row (index Nm) that receives the writes of
cells that must not update a slot, so no store needs a mask.
"""

from __future__ import annotations

import functools

import numpy as np

INF = np.int32(1 << 20)


def banded_cell_kernel(
    meta1,  # [Cm, B] int32: slot|st<<8|en<<9|vc<<10|inprev<<11|code<<12|srcnp<<15|srcsm<<16
    meta2,  # [Cm, B] int32: per-pred (slot | valid<<SB) << FW*k (ops.kernels)
    old_end,  # [Cm, B] int32
    pseudo,  # [Cm, B] int32
    eq_lo,  # [5, B] int32 (bitcast uint32)
    eq_hi,  # [5, B] int32
    seq_len,  # [1, B] int32
    buf_init,  # [7, Nm, B] int32
    *,
    K_in: int,
    interpret: bool = False,
):
    """Returns (cols [7, Cm, B], buf [7, Nm, B], nmin [Nm, B])."""
    import jax.numpy as jnp

    Cm, B = meta1.shape
    Nm = buf_init.shape[1]
    from ..kernels import LANE_BLOCK as Bb

    Bp = -(-B // Bb) * Bb
    ins = [meta1, meta2, old_end, pseudo, eq_lo, eq_hi, seq_len, buf_init]
    if Bp != B:
        # pad lanes carry meta 0 (no valid cell) and are sliced off
        ins = [
            jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Bp - B)]) for a in ins
        ]
    cols, buf, nmin = _cell_call(
        Cm, Nm, Bp, Bb, K_in, interpret
    )(*ins)
    return cols[..., :B], buf[:, :Nm, :B], nmin[:Nm, :B]


@functools.lru_cache(maxsize=None)
def _cell_call(Cm, Nm, B, Bb, K_in, interpret):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    from .. import wordops
    from ..kernels import pred_slot_bits

    SB = pred_slot_bits(Nm)
    FW, SMASK = SB + 1, (1 << SB) - 1

    def kernel(m1_ref, m2_ref, oe_ref, ps_ref, eqlo_ref, eqhi_ref, sl_ref,
               binit_ref, cols_ref, buf_ref, nmin_ref):
        ONES = jnp.uint32(0xFFFFFFFF)
        NOT1 = jnp.uint32(0xFFFFFFFE)
        u32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
        i32 = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
        lanes = pl.program_id(0) * Bb + jax.lax.iota(jnp.int32, Bb)
        inf_v = jnp.full((Bb,), INF, jnp.int32)

        def init_slot(j, carry):
            for f in range(7):
                buf_ref[f, j, lanes] = binit_ref[f, j, lanes]
            nmin_ref[j, lanes] = inf_v
            return carry

        jax.lax.fori_loop(0, Nm, init_slot, jnp.int32(0))
        seq_len_v = sl_ref[0, lanes]
        eqlo_all = [eqlo_ref[g, lanes] for g in range(5)]
        eqhi_all = [eqhi_ref[g, lanes] for g in range(5)]
        zero_u = jnp.zeros((Bb,), jnp.uint32)
        ones_u = jnp.full((Bb,), ONES, jnp.uint32)
        zero_i = jnp.zeros((Bb,), jnp.int32)

        def body(c, col):
            vp_lo, vp_hi, vn_lo, vn_hi, sbs, send, e_prev = col
            meta = m1_ref[c, lanes]
            slot = meta & 0xFF
            st = ((meta >> 8) & 1) == 1
            en = ((meta >> 9) & 1) == 1
            vc = ((meta >> 10) & 1) == 1
            inprev = ((meta >> 11) & 1) == 1
            code = (meta >> 12) & 7
            srcnp = ((meta >> 15) & 1) == 1
            srcsm = ((meta >> 16) & 1) == 1
            oe = oe_ref[c, lanes]
            pseudo_o = ps_ref[c, lanes]
            eq_lo_c32 = zero_i
            eq_hi_c32 = zero_i
            for g in range(5):
                sel = code == g
                eq_lo_c32 = jnp.where(sel, eqlo_all[g], eq_lo_c32)
                eq_hi_c32 = jnp.where(sel, eqhi_all[g], eq_hi_c32)
            eq_lo_v = u32(eq_lo_c32)
            eq_hi_v = u32(eq_hi_c32)

            # within-node chain advance
            r_chain = jnp.minimum(oe, sbs + 1)
            hin = r_chain - sbs
            eq_lo_g = jnp.where(
                (e_prev & 1) == 1, eq_lo_v, eq_lo_v & NOT1
            )
            c_vp_lo, c_vp_hi, c_vn_lo, c_vn_hi, c_send = wordops.myers_advance(
                eq_lo_g, eq_hi_v, vp_lo, vp_hi, vn_lo, vn_hi, send, hin
            )

            # fused uniform column (boundary / pseudo / band-source)
            match0 = (eq_lo_v & 1).astype(jnp.int32)
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
            delta = a_f - sbs_f
            merged = (
                NOT1 | (delta == 1).astype(jnp.uint32),
                ones_u,
                (delta == -1).astype(jnp.uint32),
                zero_u,
                sbs_f,
                a_f + 63,
                zero_i,
            )

            meta2v = m2_ref[c, lanes]
            for k in range(K_in):
                # invalid preds may name any SB-bit slot: clamp into the
                # array (their value is discarded)
                pslot_k = jnp.minimum((meta2v >> (FW * k)) & SMASK, Nm)
                pvalid_k = (((meta2v >> (FW * k + SB)) & 1) == 1) & st
                # predecessor k's node-end column, read at its slot
                g = [buf_ref[f, pslot_k, lanes] for f in range(7)]
                eq_lo_k = jnp.where(
                    (g[6] & 1) == 1, eq_lo_v, eq_lo_v & NOT1
                )
                a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, a_send = (
                    wordops.myers_advance(
                        eq_lo_k, eq_hi_v, u32(g[0]), u32(g[1]), u32(g[2]),
                        u32(g[3]), g[5], jnp.ones((Bb,), jnp.int32),
                    )
                )
                adv = (a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, g[4] + 1, a_send, g[6])
                cand = wordops.merge_slices(merged, adv)
                merged = tuple(
                    jnp.where(pvalid_k, cc, mm) for cc, mm in zip(cand, merged)
                )
            s_vp_lo, s_vp_hi, s_vn_lo, s_vn_hi, s_sbs, s_send, _ = merged

            n_vp_lo = jnp.where(vc, jnp.where(st, s_vp_lo, c_vp_lo), ones_u)
            n_vp_hi = jnp.where(vc, jnp.where(st, s_vp_hi, c_vp_hi), ones_u)
            n_vn_lo = jnp.where(vc, jnp.where(st, s_vn_lo, c_vn_lo), zero_u)
            n_vn_hi = jnp.where(vc, jnp.where(st, s_vn_hi, c_vn_hi), zero_u)
            n_sbs = jnp.where(vc, jnp.where(st, s_sbs, r_chain), INF)
            n_send = jnp.where(vc, jnp.where(st, s_send, c_send), INF + 64)
            n_e = (inprev & (n_sbs == oe) & vc).astype(jnp.int32) | (code << 1)

            fields = (
                i32(n_vp_lo), i32(n_vp_hi), i32(n_vn_lo), i32(n_vn_hi),
                n_sbs, n_send, n_e,
            )
            # node end: publish the column at the slot (others hit the
            # dummy row Nm)
            end_slot = jnp.where(en & vc, slot, Nm)
            for f in range(7):
                cols_ref[f, c, lanes] = fields[f]
                buf_ref[f, end_slot, lanes] = fields[f]
            min_slot = jnp.where(vc, slot, Nm)
            old_min = nmin_ref[min_slot, lanes]
            nmin_ref[min_slot, lanes] = jnp.minimum(old_min, n_send)
            return (n_vp_lo, n_vp_hi, n_vn_lo, n_vn_hi, n_sbs, n_send, n_e)

        inf_col = (
            ones_u, ones_u, zero_u, zero_u, inf_v,
            jnp.full((Bb,), INF + 64, jnp.int32), zero_i,
        )
        jax.lax.fori_loop(0, Cm, body, inf_col)

    call = pl.pallas_call(
        kernel,
        grid=(B // Bb,),
        out_shape=[
            jax.ShapeDtypeStruct((7, Cm, B), jnp.int32),
            jax.ShapeDtypeStruct((7, Nm + 1, B), jnp.int32),
            jax.ShapeDtypeStruct((Nm + 1, B), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="banded_cell",
    )
    return call
