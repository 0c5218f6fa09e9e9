"""Bit-packing between score columns and VP/VN delta bitvectors.

The reference's WordSlice stores a 64-row score column as two 64-bit
delta bitvectors plus boundary scores (WordSlice.h:172-200). The device
program runs without 64-bit types (no x64), so a word is a pair of
uint32 lanes. These
helpers convert between explicit score columns (how the v1 engine
computes) and the packed form (how slices are stored in HBM and handed
to the host backtrace).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_POW2_32 = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)


def pack_deltas(scores: jnp.ndarray, sbs: jnp.ndarray):
    """scores [..., 64] int32, sbs [...] int32 →
    (vp_lo, vp_hi, vn_lo, vn_hi) uint32[...].

    Bit r of VP/VN encodes scores[r] - scores[r-1] (scores[-1] = sbs):
    +1 → VP, -1 → VN, 0 → neither (WordSlice getValue semantics,
    WordSlice.h:223-229)."""
    prev = jnp.concatenate([sbs[..., None], scores[..., :-1]], axis=-1)
    delta = scores - prev
    vp = (delta > 0).astype(jnp.uint32)
    vn = (delta < 0).astype(jnp.uint32)
    pow2 = jnp.asarray(_POW2_32)
    vp_lo = jnp.sum(vp[..., :32] * pow2, axis=-1, dtype=jnp.uint32)
    vp_hi = jnp.sum(vp[..., 32:] * pow2, axis=-1, dtype=jnp.uint32)
    vn_lo = jnp.sum(vn[..., :32] * pow2, axis=-1, dtype=jnp.uint32)
    vn_hi = jnp.sum(vn[..., 32:] * pow2, axis=-1, dtype=jnp.uint32)
    return vp_lo, vp_hi, vn_lo, vn_hi


def unpack_deltas_np(vp_lo, vp_hi, vn_lo, vn_hi, sbs):
    """numpy inverse of pack_deltas: → scores [..., 64] int64."""
    vp_lo = np.asarray(vp_lo, dtype=np.uint32)
    shape = vp_lo.shape
    bits = np.arange(32, dtype=np.uint32)
    vp = np.concatenate(
        [
            (vp_lo[..., None] >> bits) & 1,
            (np.asarray(vp_hi, dtype=np.uint32)[..., None] >> bits) & 1,
        ],
        axis=-1,
    ).astype(np.int64)
    vn = np.concatenate(
        [
            (np.asarray(vn_lo, dtype=np.uint32)[..., None] >> bits) & 1,
            (np.asarray(vn_hi, dtype=np.uint32)[..., None] >> bits) & 1,
        ],
        axis=-1,
    ).astype(np.int64)
    deltas = vp - vn
    return np.asarray(sbs, dtype=np.int64)[..., None] + np.cumsum(deltas, axis=-1)
