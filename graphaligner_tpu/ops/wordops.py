"""Bit-parallel word operations on uint32 pairs (64-bit words as pairs).

The device program runs without 64-bit types (no x64), so the
reference's 64-bit DP words
(WordSlice.h) become (lo, hi) uint32 pairs; every op here is elementwise
over arbitrary batch shapes and works identically under XLA and inside
Pallas kernels.

Implements:
  myers_advance     — the Myers block advance with horizontal input
                      (reference getNextSlice, GraphAligner.h:1349-1427,
                      minus the confirmedRows machinery, which exists to
                      drive the CPU worklist's early exit)
  merge_slices      — elementwise min of two 64-row score columns in bit
                      space (reference mergeTwoSlices + differenceMasks,
                      WordSlice.h:361-421, 512-615)
  uniform_column    — the "source slice" column: scores increase by one
                      per row from a boundary score (reference
                      getSourceSliceFromScore / FromStartMatch,
                      WordSlice.h / GraphAligner.h:1317-1337)

A word column is the tuple (vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end)
where sbs is the row -1 score ("scoreBeforeStart") and score_end the row
63 score; scores[r] = sbs + popcount(VP & mask_r) - popcount(VN & mask_r).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

U32 = jnp.uint32
# numpy scalars, NOT jnp: jnp scalars are device arrays, and closing over
# device arrays turns them into hidden executable parameters that the
# jax 0.9.0 dispatch fastpath miscounts on repeat executions.
_SIGN = np.uint32(0x80808080)
_LSB = np.uint32(0x01010101)
_MULT = np.uint32(0x01010101)
_ONES = np.uint32(0xFFFFFFFF)


def popcount32(x):
    """uint32 popcount, taken on the int32 bit pattern: Triton lowers the
    int32 form to the CUDA popc instruction and has no rule for uint32."""
    pc = jax.lax.population_count(jax.lax.bitcast_convert_type(x, jnp.int32))
    return pc.astype(jnp.uint32)


def popcount64(lo, hi):
    return popcount32(lo) + popcount32(hi)


def chunk_popcounts(x):
    """Per-byte popcounts of a uint32 (reference ChunkPopcounts,
    WordSlice.h:36-43)."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return x


def add64(a_lo, a_hi, b_lo, b_hi):
    s_lo = a_lo + b_lo
    carry = (s_lo < a_lo).astype(U32)
    return s_lo, a_hi + b_hi + carry


def sub64(a_lo, a_hi, b_lo, b_hi):
    d_lo = a_lo - b_lo
    borrow = (a_lo < b_lo).astype(U32)
    return d_lo, a_hi - b_hi - borrow


def shl1_64(lo, hi):
    return lo << 1, (hi << 1) | (lo >> 31)


def myers_advance(eq_lo, eq_hi, vp_lo, vp_hi, vn_lo, vn_hi, score_end, hin):
    """One column advance (reference getNextSlice score semantics).

    Args: predecessor column word (vp/vn), its last-row score, the Eq
    match word for the new column (row-0 bit already gated by the
    caller's existence rules), and hin = new sbs - pred sbs ∈ {-1,0,+1}.
    Returns (vp_lo, vp_hi, vn_lo, vn_hi, score_end) of the new column.
    """
    eq_lo = jnp.where(hin < 0, eq_lo | 1, eq_lo)
    xv_lo = eq_lo | vn_lo
    xv_hi = eq_hi | vn_hi
    t_lo = eq_lo & vp_lo
    t_hi = eq_hi & vp_hi
    s_lo, s_hi = add64(t_lo, t_hi, vp_lo, vp_hi)
    xh_lo = (s_lo ^ vp_lo) | eq_lo
    xh_hi = (s_hi ^ vp_hi) | eq_hi
    ph_lo = vn_lo | ~(xh_lo | vp_lo)
    ph_hi = vn_hi | ~(xh_hi | vp_hi)
    mh_lo = vp_lo & xh_lo
    mh_hi = vp_hi & xh_hi
    score_end = (
        score_end
        + ((ph_hi >> 31) & 1).astype(jnp.int32)
        - ((mh_hi >> 31) & 1).astype(jnp.int32)
    )
    ph_lo, ph_hi = shl1_64(ph_lo, ph_hi)
    mh_lo, mh_hi = shl1_64(mh_lo, mh_hi)
    ph_lo = jnp.where(hin > 0, ph_lo | 1, ph_lo)
    mh_lo = jnp.where(hin < 0, mh_lo | 1, mh_lo)
    nvp_lo = mh_lo | ~(xv_lo | ph_lo)
    nvp_hi = mh_hi | ~(xv_hi | ph_hi)
    nvn_lo = ph_lo & xv_lo
    nvn_hi = ph_hi & xv_hi
    return nvp_lo, nvp_hi, nvn_lo, nvn_hi, score_end


def _byte_prefix_sums(value, addition):
    """Byte-exclusive prefix sums within a uint32 (reference
    bytePrefixSums, WordSlice.h:342-348): result byte k = addition +
    sum of bytes < k of value."""
    value = value << 8
    value = value + addition.astype(U32)
    return value * _MULT


def _byte_vpvn_sum(p_vp, p_vn):
    """One's-complement-ish per-byte difference with sign bits
    (reference byteVPVNSum, WordSlice.h:350-359)."""
    result = _SIGN + p_vp - p_vn
    return result ^ _SIGN


def _difference_masks_half(d, l_vp, l_vn, r_vp, r_vn):
    """The 8-bit refinement loop of differenceMasks
    (WordSlice.h:577-609) for one uint32 half; d holds per-byte prefix
    sum differences (left - right) in offset-binary (sign bit = negative).
    Returns (d_out, left_smaller, right_smaller)."""
    left_smaller = jnp.zeros_like(d)
    right_smaller = jnp.zeros_like(d)
    for bit in range(8):
        signs = d & _SIGN
        d = d & ~_SIGN
        d = d + (l_vp & _LSB) + (r_vn & _LSB)
        d = d ^ signs
        signs = d & _SIGN
        d = d | _SIGN
        d = d - (l_vn & _LSB) - (r_vp & _LSB)
        signs = signs ^ (_SIGN & ~d)
        d = d & ~_SIGN
        d = d | signs
        l_vp = l_vp >> 1
        l_vn = l_vn >> 1
        r_vp = r_vp >> 1
        r_vn = r_vn >> 1
        negative = d & _SIGN
        left_smaller = left_smaller | (negative >> (7 - bit))
        not_zero = ((d | _SIGN) - _LSB) & _SIGN
        right_smaller = right_smaller | ((not_zero & ~negative) >> (7 - bit))
    return left_smaller, right_smaller


def difference_masks(l_vp, l_vn, r_vp, r_vn, score_diff):
    """Per-row comparison masks of two columns with
    right.sbs - left.sbs = score_diff >= 0 (reference differenceMasks,
    WordSlice.h:512-615). Columns as ((lo,hi) VP, (lo,hi) VN).

    Returns (left_smaller, right_smaller) as (lo, hi) pairs."""
    (lvp_lo, lvp_hi), (lvn_lo, lvn_hi) = l_vp, l_vn
    (rvp_lo, rvp_hi), (rvn_lo, rvn_hi) = r_vp, r_vn
    vp_common_lo = ~(lvp_lo & rvp_lo)
    vp_common_hi = ~(lvp_hi & rvp_hi)
    vn_common_lo = ~(lvn_lo & rvn_lo)
    vn_common_hi = ~(lvn_hi & rvn_hi)
    lvp_lo, lvp_hi = lvp_lo & vp_common_lo, lvp_hi & vp_common_hi
    lvn_lo, lvn_hi = lvn_lo & vn_common_lo, lvn_hi & vn_common_hi
    rvp_lo, rvp_hi = rvp_lo & vp_common_lo, rvp_hi & vp_common_hi
    rvn_lo, rvn_hi = rvn_lo & vn_common_lo, rvn_hi & vn_common_hi

    # "left is lower everywhere" early-out, as a mask (vectorized)
    all_left = score_diff > (
        popcount64(rvn_lo, rvn_hi) + popcount64(lvp_lo, lvp_hi)
    )

    # byte prefix sums; the hi half continues from the lo half's totals
    sd = score_diff.astype(jnp.int32)
    lvp_pc = chunk_popcounts(lvp_lo)
    lvn_pc = chunk_popcounts(lvn_lo)
    rvp_pc = chunk_popcounts(rvp_lo)
    rvn_pc = chunk_popcounts(rvn_lo)
    zeros = jnp.zeros_like(sd)
    sum_left_lo = _byte_vpvn_sum(
        _byte_prefix_sums(lvp_pc, zeros), _byte_prefix_sums(lvn_pc, zeros)
    )
    sum_right_lo = _byte_vpvn_sum(
        _byte_prefix_sums(rvp_pc, sd), _byte_prefix_sums(rvn_pc, zeros)
    )
    lvp_tot = popcount32(lvp_lo)
    lvn_tot = popcount32(lvn_lo)
    rvp_tot = popcount32(rvp_lo)
    rvn_tot = popcount32(rvn_lo)
    sum_left_hi = _byte_vpvn_sum(
        _byte_prefix_sums(chunk_popcounts(lvp_hi), lvp_tot),
        _byte_prefix_sums(chunk_popcounts(lvn_hi), lvn_tot),
    )
    sum_right_hi = _byte_vpvn_sum(
        _byte_prefix_sums(chunk_popcounts(rvp_hi), sd + rvp_tot),
        _byte_prefix_sums(chunk_popcounts(rvn_hi), rvn_tot),
    )

    def diff_combine(sum_left, sum_right):
        # difference = sum_left - sum_right in offset-binary per byte
        # (reference WordSlice.h:546-573)
        smear = ((sum_right & _SIGN) >> 7) * jnp.uint32(0x7F)
        deductions = ~smear & sum_right & ~_SIGN
        additions = (smear & ~sum_right) + (smear & _LSB)
        d = sum_left
        signs = d & _SIGN
        d = d & ~_SIGN
        d = d + additions
        d = d ^ signs
        signs = d & _SIGN
        d = d | _SIGN
        d = d - deductions
        signs = signs ^ (_SIGN & ~d)
        d = d & ~_SIGN
        d = d | signs
        return d

    d_lo = diff_combine(sum_left_lo, sum_right_lo)
    d_hi = diff_combine(sum_left_hi, sum_right_hi)
    ls_lo, rs_lo = _difference_masks_half(d_lo, lvp_lo, lvn_lo, rvp_lo, rvn_lo)
    ls_hi, rs_hi = _difference_masks_half(d_hi, lvp_hi, lvn_hi, rvp_hi, rvn_hi)

    # special cases (WordSlice.h:534-541): with rightVN and leftVP all
    # ones the byte-offset arithmetic would overflow its 7-bit range
    extreme = (
        (rvn_lo == _ONES) & (rvn_hi == _ONES)
        & (lvp_lo == _ONES) & (lvp_hi == _ONES)
    )
    case128 = extreme & (score_diff == 128)
    case0 = extreme & (score_diff == 0)
    ls_lo = jnp.where(case128, _ONES, jnp.where(case0, 0, ls_lo))
    ls_hi = jnp.where(
        case128, _ONES ^ jnp.uint32(0x80000000), jnp.where(case0, 0, ls_hi)
    )
    rs_lo = jnp.where(case128, 0, jnp.where(case0, _ONES, rs_lo))
    rs_hi = jnp.where(case128, 0, jnp.where(case0, _ONES, rs_hi))

    ls_lo = jnp.where(all_left, _ONES, ls_lo)
    ls_hi = jnp.where(all_left, _ONES, ls_hi)
    rs_lo = jnp.where(all_left, jnp.uint32(0), rs_lo)
    rs_hi = jnp.where(all_left, jnp.uint32(0), rs_hi)
    return (ls_lo, ls_hi), (rs_lo, rs_hi)


def merge_slices(a, b):
    """Elementwise min of two word columns (reference mergeTwoSlices,
    WordSlice.h:361-421). Columns are tuples
    (vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end, exists)."""
    a_vp_lo, a_vp_hi, a_vn_lo, a_vn_hi, a_sbs, a_send, a_e = a
    b_vp_lo, b_vp_hi, b_vn_lo, b_vn_hi, b_sbs, b_send, b_e = b
    # ensure left.sbs <= right.sbs lane-wise
    swap = a_sbs > b_sbs

    def sel(x, y):
        return jnp.where(swap, y, x), jnp.where(swap, x, y)

    l_vp_lo, r_vp_lo = sel(a_vp_lo, b_vp_lo)
    l_vp_hi, r_vp_hi = sel(a_vp_hi, b_vp_hi)
    l_vn_lo, r_vn_lo = sel(a_vn_lo, b_vn_lo)
    l_vn_hi, r_vn_hi = sel(a_vn_hi, b_vn_hi)
    l_sbs, r_sbs = sel(a_sbs, b_sbs)
    l_send, r_send = sel(a_send, b_send)
    l_e, r_e = sel(a_e, b_e)

    score_diff = (r_sbs - l_sbs).astype(U32)
    (ls_lo, ls_hi), (rs_lo, rs_hi) = difference_masks(
        (l_vp_lo, l_vp_hi), (l_vn_lo, l_vn_hi),
        (r_vp_lo, r_vp_hi), (r_vn_lo, r_vn_hi),
        score_diff,
    )
    # mask = rightSmaller | ((leftSmaller|rightSmaller) - (rightSmaller<<1))
    #        & ~leftSmaller                      (WordSlice.h:380)
    or_lo, or_hi = ls_lo | rs_lo, ls_hi | rs_hi
    sh_lo, sh_hi = shl1_64(rs_lo, rs_hi)
    sub_lo, sub_hi = sub64(or_lo, or_hi, sh_lo, sh_hi)
    mask_lo = (rs_lo | sub_lo) & ~ls_lo
    mask_hi = (rs_hi | sub_hi) & ~ls_hi
    lr_lo, lr_hi = shl1_64(rs_lo, rs_hi)
    left_red_lo = ls_lo & lr_lo
    left_red_hi = ls_hi & lr_hi
    rr_lo, rr_hi = shl1_64(ls_lo, ls_hi)
    right_red_lo = rs_lo & rr_lo
    right_red_hi = rs_hi & rr_hi
    # boundary: right's row 0 smaller while left's sbs smaller
    right_red_lo = jnp.where(
        ((rs_lo & 1) == 1) & (l_sbs < r_sbs), right_red_lo | 1, right_red_lo
    )
    l_vn_lo = l_vn_lo & ~left_red_lo
    l_vn_hi = l_vn_hi & ~left_red_hi
    r_vn_lo = r_vn_lo & ~right_red_lo
    r_vn_hi = r_vn_hi & ~right_red_hi
    vn_lo = (l_vn_lo & ~mask_lo) | (r_vn_lo & mask_lo)
    vn_hi = (l_vn_hi & ~mask_hi) | (r_vn_hi & mask_hi)
    vp_lo = (l_vp_lo & ~mask_lo) | (r_vp_lo & mask_lo)
    vp_hi = (l_vp_hi & ~mask_hi) | (r_vp_hi & mask_hi)
    sbs = jnp.minimum(l_sbs, r_sbs)
    send = jnp.minimum(l_send, r_send)
    exists = jnp.where(
        l_sbs < r_sbs, l_e, jnp.where(r_sbs < l_sbs, r_e, l_e | r_e)
    )
    return vp_lo, vp_hi, vn_lo, vn_hi, sbs, send, exists


def uniform_column(score, first_vp=None):
    """All-VP column from a boundary score: scores[r] = score + 1 + r
    (reference getSourceSliceFromScore). With first_vp (0/1), row 0 costs
    first_vp instead of 1 (getSourceSliceFromStartMatch)."""
    ones = jnp.full_like(score, 0xFFFFFFFF, dtype=U32)
    vp_lo = ones
    if first_vp is not None:
        vp_lo = (ones & ~jnp.uint32(1)) | first_vp.astype(U32)
        send = score + 63 + first_vp.astype(jnp.int32)
    else:
        send = score + 64
    zero = jnp.zeros_like(score, dtype=U32)
    return vp_lo, ones, zero, zero, score, send


def column_scores_np(vp_lo, vp_hi, vn_lo, vn_hi, sbs):
    """Debug/host helper: expand a packed column to its 64 scores."""
    import numpy as np

    from .packing import unpack_deltas_np

    return unpack_deltas_np(vp_lo, vp_hi, vn_lo, vn_hi, sbs)
