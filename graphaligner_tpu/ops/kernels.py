"""The one place that decides which implementation of each hot kernel a
device path runs.

The banded engine has two hand-written GPU kernels (Pallas lowered
through Triton, `ops/pallas/`) and a plain JAX path for each:

- the banded cell pass: `triton` = ops.pallas.banded_cell, `xla` =
  core.engine_banded's `lax.scan` over the band cells;
- the single-window backtrace walk: `triton` = the move walk
  (ops.pallas.walk_moves), `xla` = core.backtrace_device.walk_batch;
- the windowed long-read walk, which needs the move walk's lane-state
  continuation: `triton` = the move walk kernel, `xla` = the same walk
  step under a plain `lax.while_loop` (`walk_moves(..., impl="xla")`), or
  None when the graph is outside the move encoding.

Limits come from the packed metadata the engine records, not from the
kernels: each predecessor k of a band slot is packed as (slot | valid <<
b) << k * (b + 1) in one int32 word, with b = pred_slot_bits(Nm) (5 bits
up to 32 node slots, 6 up to 64), so k_in * (b + 1) <= 31; the cell
kernel's per-cell word holds the slot in 8 bits (Nm <= 256); the move
codes name at most four predecessors (k_in <= 4). Band cell capacity
(Cm) bounds nothing: neither kernel keeps a Cm-sized block on chip.
"""

from __future__ import annotations

from dataclasses import dataclass

PLATFORMS = ("gpu", "cpu")


@dataclass(frozen=True)
class Kernels:
    cell: str  # "triton" | "xla"
    walk: str  # "triton" | "xla"
    long_walk: str | None  # "triton" | "xla" | None (no windowed walk)
    # run the Triton kernels through the Pallas interpreter (CPU tests)
    interpret: bool = False


def pred_slot_bits(Nm: int) -> int:
    """Bits of one band-slot index in the packed predecessor words."""
    return max(5, (Nm - 1).bit_length())


def select_kernels(
    platform: str, *, k_in: int, Nm: int, interpret: bool = False
) -> Kernels:
    """Kernel choice for a platform ("gpu" or "cpu", as
    `jax.devices()[0].platform` names it) and a graph/band shape.
    interpret=True gives the GPU choice with every Triton kernel run by
    the Pallas interpreter: how the CPU tests reach the kernels' code."""
    if platform not in PLATFORMS:
        raise ValueError(
            f"no kernel set for platform {platform!r} (known: {PLATFORMS})"
        )
    preds_ok = k_in * (pred_slot_bits(Nm) + 1) <= 31
    cell_ok = preds_ok and Nm <= 256
    moves_ok = preds_ok and k_in <= 4
    if platform == "gpu" or interpret:
        return Kernels(
            cell="triton" if cell_ok else "xla",
            walk="triton" if moves_ok else "xla",
            long_walk="triton" if moves_ok else None,
            interpret=interpret,
        )
    return Kernels(
        cell="xla", walk="xla", long_walk="xla" if moves_ok else None
    )


# Lanes per grid program of both Triton kernels, in interpret mode too
# (the tests then run the card's block geometry and padding). Each lane
# is one dependent chain, so narrow blocks spread a chunk over more SMs
# (an H100 has 132).
LANE_BLOCK = 32
