"""Batched seeded alignment: device DP rounds + exact host control replay.

The reference's getSqrtSlices control loop (GraphAligner.h:2571-2856)
interleaves per-slice DP with data-dependent decisions: the correctness
HMM (double-precision), bandwidth ramping rewinds, and early stopping.
On a device those per-read branches would serialize the batch, so this module
splits the loop:

  device: compute slices for ALL lanes straight through (engine_banded),
          no branches — each round is one `banded_scan` call that records
          per-slice (min_score, num_cells, band, packed columns).
  host:   replay getSqrtSlices' control flow *exactly* (float64 HMM,
          literal rewind/swap quirks) against the recorded minima. When
          the replay takes a rewind, the affected lanes are gathered
          into the next device round, restarted from the recorded
          pre-ramp slice state with the ramped bandwidth schedule.

Rounds repeat until every lane finishes (typically 1-2; each round only
re-runs lanes that actually rewound — the batched analog of the
reference's rampSlice redo, GraphAligner.h:2648-2719). Lanes whose band
overflows the engine's static capacities (or that keep rewinding) fall
back to the host oracle path — the analog of the reference's
alternate-method switch for giant bands (GraphAligner.h:2483).

The replay consumes only tiny per-slice scalars; the packed DP columns
stay in per-round arrays and are expanded to SliceScores lazily, only
for slices the surviving table actually needs. Band node *order* (which
the reference's per-slice Tarjan tie-breaking inherits from the
projection insertion order, GraphAligner.h:2359-2366) is reproduced on
the host by re-walking projectForwardFromMinScore over the recorded
per-node minima — and doubles as a device/host differential check.
"""

from __future__ import annotations

import os as _os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from ..graph.alignment_graph import AlignmentGraph
from .align import DPTable, _pad_to_word
from .band import project_forward_from_arrays
from .engine import _READ_CODE, encode_read
from .engine_banded import (
    EMPTY,
    INF,
    BandedGraphTables,
    banded_scan,
    build_graph_tables,
    make_seed_carry,
)
from . import hmm as _hmm
from .hmm import CorrectnessState
from .oracle import SliceScores, _banded_tarjan, make_initial_slice_one_node
from .params import BACKTRACE_OVERRIDE_CUTOFF, WORD_SIZE
from ..ops.packing import unpack_deltas_np


# bandwidth-ramp rewind counter (bench telemetry: BASELINE config 4
# exercises band-widening restarts; read via rewind_count())
_REWIND_COUNT = 0


def rewind_count() -> int:
    return _REWIND_COUNT


# Why a device lane fell back to the host oracle (a lane's cause is set
# where it fails and travels with its result as a HostFallback):
# - "band_slots" / "band_cells" / "fixpoint": on the top capacity tier
#   the band still held more than Nm nodes or Cm cells, or a cyclic
#   band's fixpoint hit its iteration cap (the engine's overflow bits);
# - "dropped_round": windowed long mode drops old rounds' columns by
#   design, so a lane whose chain needs them again (a rewind or an HMM
#   cut into a dropped round, a boundary stash miss) fails to the host;
# - "other": no known cause.
# Listed most alarming first: an entry with two failed pieces counts
# under the earlier cause. GA_NO_FALLBACK=1 lets only "dropped_round"
# fall back; fallback_counts() reports host-fallback entries per cause.
FALLBACK_CAUSES = (
    "other", "band_slots", "band_cells", "fixpoint", "dropped_round"
)
_FALLBACKS = dict.fromkeys(FALLBACK_CAUSES, 0)


class HostFallback(NamedTuple):
    """A device result that did not come: the lane goes to the host."""

    cause: str


def _overflow_cause(bits: int) -> str:
    if bits & 1:
        return "band_slots"
    return "band_cells" if bits & 2 else "fixpoint"


def fallback_counts() -> dict:
    return dict(_FALLBACKS)


class _CorrFlags:
    """Interned (correct_from_correct, false_from_correct,
    currently_correct) triple: the only facts consumers of a FINISHED
    lane's correctness chain ever read. Full CorrectnessState objects
    (with log odds) are needed only while a chain can still be rewound,
    so the vectorized replay stores these flyweights instead of 150+
    dataclass instances per lane."""

    __slots__ = ("cc", "ffc", "cur")

    def currently_correct(self):
        return self.cur

    def correct_from_correct(self):
        return self.cc

    def false_from_correct(self):
        return self.ffc


_FLAGS_POOL: dict = {}

_DECODE_POOL = None


def set_host_threads(n: int) -> None:
    """Size the host-side native worker pool (the CLI -t flag;
    reference Aligner.cpp:275-298 thread count)."""
    global _DECODE_POOL
    from concurrent.futures import ThreadPoolExecutor

    old = _DECODE_POOL
    _DECODE_POOL = ThreadPoolExecutor(max_workers=max(1, int(n)))
    if old is not None:
        old.shutdown(wait=False)


# one jitted dynamic-slice for per-lane tie16 fetches (see
# _Round.fetch_tie16_lanes); module-level so every round shares the
# single compiled signature
_TIE16_SLICE = None


def _decode_pool():
    """Shared worker pool for host-side native decode/encode (the ctypes
    calls release the GIL). Size follows GA_THREADS or the CLI -t flag
    (runtime.aligner sets it), defaulting to the core count capped at 8."""
    global _DECODE_POOL
    if _DECODE_POOL is None:
        import os
        from concurrent.futures import ThreadPoolExecutor

        n = int(os.environ.get("GA_THREADS", 0)) or min(8, os.cpu_count() or 1)
        _DECODE_POOL = ThreadPoolExecutor(max_workers=max(1, n))
    return _DECODE_POOL


def _decode_tie(traw, ms):
    """Unpack device tie deltas (int16 = 8/8 packing, int32 = 16/16)
    back to absolute (node_min, node_end) via the slice min."""
    if traw.dtype == np.int16:
        t16 = traw.astype(np.int64) & 0xFFFF
        return (t16 & 0xFF) + ms, ((t16 >> 8) & 0xFF) + ms
    t16 = traw.astype(np.int64)
    return (t16 & 0xFFFF) + ms, ((t16 >> 16) & 0xFFFF) + ms


def _corr_flags(cc, ffc, cur):
    obj = _FLAGS_POOL.get((cc, ffc, cur))
    if obj is None:
        obj = _CorrFlags()
        obj.cc, obj.ffc, obj.cur = cc, ffc, cur
        _FLAGS_POOL[(cc, ffc, cur)] = obj
    return obj



_WALK_INPUTS_STEP = None
_WALK_ROW_SLICE = None
_WALK_ROW_GATHER = None


def _walk_inputs_step_fn():
    """Jitted per-round gather of every walk lane's final-slice data PLUS
    the device-side min_score_index.back() decision. Returns TWO arrays:
    a [B, Cm+Nm] payload (per-cell last-row scores + band node ids) that
    STAYS DEVICE-RESIDENT — only multi-node tie lanes ever fetch their
    row — and a tiny [B, 10] start summary (best, nmins, pos, slot, off,
    node, pos_l, slot_l, off_l, node_l) that resolves both unique minima
    AND same-node ties on device: slot spans are contiguous cell ranges,
    so first-min and last-min in the same slot means every tied minimum
    is inside one node, and the reference winner is that node's LAST
    tied offset regardless of banded-Tarjan collection order (reference:
    min_score_index.back(), GraphAligner.h:2359-2366). Only multi-node
    ties still need the host band-order replay."""
    global _WALK_INPUTS_STEP
    if _WALK_INPUTS_STEP is None:
        import jax
        import jax.numpy as jnp

        def step(sends_dev, band_dev, lens_dev, node_start, packed,
                 acc_big, acc_st):
            steps = packed[0]
            lane = packed[1]
            mask = packed[2] != 0
            sends = sends_dev[steps, :, lane]  # [B, Cm]
            band = band_dev[steps, :, lane]  # [B, Nm]
            lens = lens_dev[steps, :, lane]  # [B, Nm]
            valid = band != EMPTY
            lens = jnp.where(valid, lens, 0)
            offs = jnp.cumsum(lens, axis=1) - lens
            c_used = lens.sum(axis=1)
            big = jnp.int32(2**31 - 1)
            Cm = sends.shape[1]
            cm_idx = jnp.arange(Cm, dtype=jnp.int32)[None, :]
            masked = jnp.where(cm_idx < c_used[:, None], sends, big)
            best = masked.min(axis=1)
            is_min = masked == best[:, None]
            nmins = is_min.sum(axis=1).astype(jnp.int32)

            def locate(cell):
                slot = ((offs <= cell[:, None]) & valid).sum(axis=1).astype(
                    jnp.int32
                ) - 1
                slot_c = jnp.clip(slot, 0, offs.shape[1] - 1)[:, None]
                off = cell - jnp.take_along_axis(offs, slot_c, axis=1)[:, 0]
                node = jnp.take_along_axis(band, slot_c, axis=1)[:, 0]
                pos = (
                    node_start[jnp.clip(node, 0, node_start.shape[0] - 1)]
                    + off
                )
                return pos, slot, off, node

            first = jnp.argmax(is_min, axis=1).astype(jnp.int32)
            last = (Cm - 1) - jnp.argmax(is_min[:, ::-1], axis=1).astype(
                jnp.int32
            )
            pos, slot, off, node = locate(first)
            pos_l, slot_l, off_l, node_l = locate(last)
            st = jnp.stack(
                [best, nmins, pos, slot, off, node,
                 pos_l, slot_l, off_l, node_l],
                axis=1,
            ).astype(jnp.int32)
            src = jnp.concatenate([sends, band], axis=1)
            return (
                jnp.where(mask[:, None], src, acc_big),
                jnp.where(mask[:, None], st, acc_st),
            )

        _WALK_INPUTS_STEP = jax.jit(step)
    return _WALK_INPUTS_STEP


_CONSOL_JIT: dict = {}


def _consol_fn(with_codes: bool, first: bool):
    """One jit-compiled program per walk-block consolidation round: the
    band/lens/pred/cols (and optionally codes) gathers, the lane-pad to
    a 128-multiple lane bucket, and the walk kernel's leading
    below-window pad slice all happen in ONE device program instead of
    ~10 eager dispatches per round per block."""
    key = (with_codes, first)
    fn = _CONSOL_JIT.get(key)
    if fn is not None:
        return fn
    import jax
    import jax.numpy as jnp

    EMPTYi = int(EMPTY)

    def build(band_dev, lens_dev, pred_dev, pprev_dev, cols_dev, codes_dev,
              lane_pos, steps, mask, *accs):
        # steps/mask: [K_max+1, Bp] with row 0 (the lead pad slice) all
        # False — gathers then emit the pad fill there automatically
        steps3 = steps[:, None, :]
        mask3 = mask[:, None, :]
        mask4 = mask[:, None, None, :]

        def g3(dev):
            return jnp.take_along_axis(dev[:, :, lane_pos], steps3, axis=0)

        band_g = g3(band_dev)
        lens_g = g3(lens_dev)
        pred_g = g3(pred_dev)
        pprev_g = g3(pprev_dev)
        cols_g = jnp.take_along_axis(
            cols_dev[:, :, :, lane_pos], steps[:, None, None, :], axis=0
        )
        if first:
            band_t = jnp.where(mask3, band_g, EMPTYi)
            lens_t = jnp.where(mask3, lens_g, 0)
            pred_t = jnp.where(mask3, pred_g, 0)
            pprev_t = jnp.where(mask3, pprev_g, 0)
            cols_t = jnp.where(mask4, cols_g, 0)
        else:
            band_t = jnp.where(mask3, band_g, accs[0])
            lens_t = jnp.where(mask3, lens_g, accs[1])
            pred_t = jnp.where(mask3, pred_g, accs[2])
            pprev_t = jnp.where(mask3, pprev_g, accs[3])
            cols_t = jnp.where(mask4, cols_g, accs[4])
        out = [band_t, lens_t, pred_t, pprev_t, cols_t]
        if with_codes:
            cg = jnp.take_along_axis(
                codes_dev[:, :, lane_pos], steps3, axis=0
            )
            zero8 = jnp.zeros((), dtype=cg.dtype)
            out.append(
                jnp.where(mask3, cg, zero8)
                if first
                else jnp.where(mask3, cg, accs[5])
            )
        return tuple(out)

    if first:
        fn = jax.jit(build)
    else:
        # merge rounds reuse the donated accumulator buffers in place
        n_acc = 6 if with_codes else 5
        fn = jax.jit(
            build, donate_argnums=tuple(range(9, 9 + n_acc))
        )
    _CONSOL_JIT[key] = fn
    return fn


def _pad_lead(arr, fill):
    """Prepend one zero/fill slice along axis 0 (the walk kernel's
    below-window neighbor entry)."""
    import jax.numpy as jnp
    import numpy as np

    if isinstance(arr, np.ndarray):
        pad = np.full((1,) + arr.shape[1:], fill, dtype=arr.dtype)
        return np.concatenate([pad, arr], axis=0)
    pad = jnp.full((1,) + arr.shape[1:], fill, dtype=arr.dtype)
    return jnp.concatenate([pad, arr], axis=0)


def _quantize_k(k: int) -> int:
    """Walk-kernel slice-grid ladder: {32, 160, 320, ...} — the same
    tiny signature ladder as the scan (leading pad slices have no
    active lane, so their grid steps skip the lockstep loop)."""
    if k <= 32:
        return 32
    cap = 160
    while cap < k:
        cap *= 2
    return cap


def _walk_init_state(Bp, keeps, sslot, soff, sscore):
    """Fresh walk lane state [16, Bp] (kernel row layout: sk, row_in,
    slot, off, here, done, fail, needs_col, 5 cache words, spares)."""
    st = np.zeros((16, Bp), np.int32)
    st[0] = keeps
    st[1] = 63
    st[2] = sslot
    st[3] = soff
    st[4] = sscore
    st[5] = (keeps < 1).astype(np.int32)
    st[7] = 1
    return st


class _Round:
    """One banded_scan invocation's host-side record.

    Only the packed per-slice control triple (min_score, num_cells,
    overflow — what the getSqrtSlices replay consumes) is fetched from
    the device eagerly; the multi-MB per-slice tables stay in device HBM
    and materialize host-side lazily, each at most once."""

    def __init__(
        self,
        lanes,  # problem index per batch lane
        start_slice,  # [B] np
        num_steps,  # [B] np
        control,  # [S, 3, B] np (min_score, num_cells, overflow bits)
        band_ids_dev,  # [S, Nm, B] device
        node_min_dev,  # [S, Nm, B] device
        node_end_dev,  # [S, Nm, B] device
        lens_tab_dev,  # [S, Nm, B] device
        pred_tab_dev,  # [S, Nm, B] device packed (slot|valid<<SB)<<FW*k
        cols_dev,  # [S, 7, Cm, B] device
        sends_dev,  # [S, Cm, B] device
        tie16_dev=None,  # [S, Nm, B] device packed score deltas
        ids_sub_dev=None,  # [ceil(S/8), Nm, B] device
        codes_dev=None,  # [S, 64, B] device uint8 (walk-layout read codes)
        pred_prev_dev=None,  # [S, Nm, B] packed (prev_slot|in_prev<<SB)<<FW*k
    ):
        self.tie16_dev = tie16_dev
        self.ids_sub_dev = ids_sub_dev
        self.codes_dev = codes_dev
        self.pred_prev_dev = pred_prev_dev
        self._tie16_cols: dict = {}
        self.lanes = lanes
        self.start_slice = start_slice
        self.num_steps = num_steps
        self.min_score = control[:, 0]
        self.num_cells = control[:, 1]
        self.overflow = control[:, 2]  # cause bits, 0 = none
        self.band_ids_dev = band_ids_dev
        self.node_min_dev = node_min_dev
        self.node_end_dev = node_end_dev
        self.lens_tab_dev = lens_tab_dev
        self.pred_tab_dev = pred_tab_dev
        self.cols_dev = cols_dev
        self.sends_dev = sends_dev
        self.dropped = False  # long mode dropped the rewind-carry fields
        self._host: dict = {}

    def _lazy(self, name):
        arr = self._host.get(name)
        if arr is None:
            arr = np.asarray(getattr(self, name + "_dev"))
            self._host[name] = arr
        return arr

    @property
    def tie_data(self) -> np.ndarray:
        """[S, 3, Nm, B] (band_ids, node_min, node_end) — the band replay
        inputs, materialized host-side in a single packed transfer."""
        arr = self._host.get("tie")
        if arr is None:
            import jax.numpy as jnp

            arr = np.asarray(
                jnp.stack(
                    [self.band_ids_dev, self.node_min_dev, self.node_end_dev],
                    axis=1,
                )
            )
            self._host["tie"] = arr
        return arr

    @property
    def band_ids(self) -> np.ndarray:
        return self.tie_data[:, 0]

    @property
    def node_min(self) -> np.ndarray:
        return self.tie_data[:, 1]

    @property
    def node_end(self) -> np.ndarray:
        return self.tie_data[:, 2]

    @property
    def tie16(self) -> np.ndarray:
        """[S, Nm, B] packed (node_min_delta | node_end_delta<<16) —
        the compressed band-replay scores (one quarter of tie_data)."""
        return self._lazy("tie16")

    def tie16_lane(self, lane: int) -> np.ndarray:
        """[S, Nm] tie deltas for ONE batch lane, served from the full
        fetch when present, else from the subset cache (fetch_tie16_lanes),
        else fetched on demand (long-mode stragglers)."""
        full = self._host.get("tie16")
        if full is not None:
            return full[:, :, lane]
        col = self._tie16_cols.get(lane)
        if col is None:
            self.fetch_tie16_lanes([lane])
            col = self._tie16_cols[lane]
        return col

    def fetch_tie16_lanes(self, lanes) -> None:
        """Materialize tie16 for a SUBSET of batch lanes. Band-order
        replays are needed only for multi-node score ties (~35% of walk
        lanes on longsim), so fetching per-lane columns instead of the
        whole [S, Nm, B] round cuts the largest device-to-host transfer.
        Per-lane dynamic slices keep ONE jit signature (a padded gather
        would compile once per subset-size bucket); the copies pipeline
        via copy_to_host_async. Above
        ~30% of the round the full fetch is cheaper (fewer dispatches,
        one transfer)."""
        need = [l for l in lanes if l not in self._tie16_cols]
        if not need or "tie16" in self._host or self.tie16_dev is None:
            return
        B = self.tie16_dev.shape[2]
        if len(need) > 0.3 * B:
            self._lazy("tie16")
            return
        import jax

        global _TIE16_SLICE
        if _TIE16_SLICE is None:
            import jax.numpy as jnp

            def _slice1(dev, i):
                return jax.lax.dynamic_slice_in_dim(dev, i, 1, axis=2)

            _TIE16_SLICE = jax.jit(_slice1)
        devs = []
        for l in need:
            d = _TIE16_SLICE(self.tie16_dev, np.int32(l))
            try:
                d.copy_to_host_async()
            except Exception:
                pass
            devs.append(d)
        for l, d in zip(need, devs):
            self._tie16_cols[l] = np.asarray(d)[:, :, 0]

    @property
    def tie_ids_sub(self) -> np.ndarray:
        """[ceil(S/8), B] band-row HASHES of every 8th slice (see
        engine_banded band_hash_np), for the subsampled host/device
        band differential check."""
        arr = self._host.get("ids_sub")
        if arr is None:
            if self.ids_sub_dev is not None:
                arr = np.asarray(self.ids_sub_dev)
            else:
                from .engine_banded import band_hash_np

                ids = np.asarray(self.band_ids_dev[::8])  # [S/8, Nm, B]
                arr = band_hash_np(np.moveaxis(ids, 1, -1))
            self._host["ids_sub"] = arr
        return arr

    @property
    def lens_tab(self) -> np.ndarray:
        return self._lazy("lens_tab")

    @property
    def pred_tab(self) -> np.ndarray:
        return self._lazy("pred_tab")


@dataclass
class _Rec:
    """Reference to one computed slice of one lane."""

    rnd: _Round
    step: int
    lane_in_round: int
    slice_i: int
    bandwidth: int
    req_i: int = -1  # index into the round's request list

    @property
    def min_score(self) -> int:
        return int(self.rnd.min_score[self.step, self.lane_in_round])

    @property
    def num_cells(self) -> int:
        return int(self.rnd.num_cells[self.step, self.lane_in_round])

    @property
    def overflow(self) -> int:
        """The engine's overflow cause bits for this slice (0 = none)."""
        return int(self.rnd.overflow[self.step, self.lane_in_round])

    def band_ids(self) -> np.ndarray:
        ids = self.rnd.band_ids[self.step, :, self.lane_in_round]
        return ids[ids != EMPTY]

    def node_min_map(self, tables) -> dict:
        ids = self.rnd.band_ids[self.step, :, self.lane_in_round]
        nm = self.rnd.node_min[self.step, :, self.lane_in_round]
        return {int(i): int(m) for i, m in zip(ids, nm) if i != EMPTY}

    def node_end_map(self) -> dict:
        ids = self.rnd.band_ids[self.step, :, self.lane_in_round]
        ne = self.rnd.node_end[self.step, :, self.lane_in_round]
        return {int(i): int(e) for i, e in zip(ids, ne) if i != EMPTY}

    def cols(self) -> np.ndarray:
        """Fetch this lane's packed slice columns from device [Cm, 7]
        (fallback/reconstruction path only)."""
        return np.asarray(
            self.rnd.cols_dev[self.step, :, :, self.lane_in_round]
        ).T

    def sends(self) -> np.ndarray:
        """Fetch this lane's per-cell last-row scores from device [Cm]."""
        return np.asarray(self.rnd.sends_dev[self.step, :, self.lane_in_round])


def _cell_layout(tables: BandedGraphTables, ids: np.ndarray):
    """Topo-order node list + exclusive cell offsets for a band."""
    order = ids[np.argsort(tables.topo_rank[ids])]
    lens = tables.node_len[order]
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return order, lens, offs


@dataclass
class _LaneState:
    """Literal replay of getSqrtSlices' control variables for one lane
    (GraphAligner.h:2571-2856)."""

    num_slices: int
    slice_i: int = 0
    ramp_until: int = 0
    ramp_redo_index: int = -1
    last: object = "init"  # "init" | _Rec
    ramp: object = "init"
    correctness: CorrectnessState = field(default_factory=CorrectnessState)
    accepted: list = field(default_factory=list)  # _Rec per table slice
    bandwidths: list = field(default_factory=list)
    corr_list: list = field(default_factory=list)
    done: bool = False
    failed: bool = False  # overflow/fallback
    cause: str = "other"  # why it failed (a HostFallback cause)

    # chain cursor into the current round
    chain: list = field(default_factory=list)  # [_Rec] sequential records
    cursor: int = 0


class BandedBatchAligner:
    """Batched seeded/banded alignment over the device engine."""

    # reads past this many slices run the memory-bounded long-read mode:
    # chained LONG_WINDOW-slice scan rounds whose packed columns are
    # dropped after the control replay, with the backtrace recomputing
    # one window at a time (the reference's sqrt-slice sampling +
    # getSlicesFromTable recompute analog, GraphAligner.h:2858-2943)
    LONG_WINDOW = 320
    # top capacity tier of the retry ladder: bands of windowed 100 kb
    # reads on short-node graphs reach 35 nodes (the host spec path's
    # bands), past 32 slots; cells go to 2304 (ONT b5/B20 reaches it)
    NM_MAX = 64
    CM_MAX = 2304

    def __init__(
        self,
        graph: AlignmentGraph,
        initial_bandwidth: int,
        ramp_bandwidth: int,
        Nm: int | None = None,
        Cm: int | None = None,
        max_rounds: int = 6,
        mesh=None,
        mesh_axis: str = "dp",
        kernels=None,
        interpret: bool = False,
        _tables=None,
        _rev_pos=None,
        _tier: int = 0,
    ):
        """kernels: an explicit ops.kernels.Kernels choice (A/B runs);
        by default select_kernels picks it from the platform and the
        graph. interpret: run the Triton kernels through the Pallas
        interpreter (CPU tests)."""
        self.graph = graph
        self.tables = _tables if _tables is not None else build_graph_tables(graph)
        self.initial_bandwidth = int(initial_bandwidth)
        self.ramp_bandwidth = int(ramp_bandwidth)
        ew = max(self.initial_bandwidth, self.ramp_bandwidth) + WORD_SIZE
        assert ew < 1023
        if Nm is None:
            # measured on longsim accepted slices: bands reach 26 nodes
            # (p99 21), so 16 node slots overflow on 85% of lanes — the
            # first tier keeps 32 (the retry ladder widens to 64)
            Nm = 32
        if Cm is None:
            # cell capacity auto-scaled to the bandwidth AND the graph's
            # node-length profile: on short-node graphs accepted bands
            # stay under ~2.6x the expansion width in bp (longsim b=35:
            # p99 217, max 255 cells at ew=99), but a band always holds
            # WHOLE nodes, so long-node graphs (bluntified assemblies:
            # p99 474bp) need ~ew + 2*p99 cells — starting below that
            # makes every chunk burn capacity-retry scans (measured 2x
            # end-to-end on the bluntified bench). The cell kernel walks
            # all Cm cells sequentially, so the first tier stays as
            # tight as the profile allows; p99 (not max) keeps one giant
            # hub node from inflating it (the >=200k native slice path
            # handles those), and CM_MAX is the ladder ceiling.
            p99_len = float(np.percentile(np.asarray(graph.node_len), 99))
            # start tier capped at 1152 (the largest 288-doubling value
            # below the ladder ceiling — a higher cap would make the
            # loop land on 2304): wider bands go through the retry
            # ladder / native giant-band path instead of slowing every
            # slice of every read
            need = min(1152.0, max(2.6 * ew, ew + 2.0 * p99_len))
            Cm = 288
            while Cm < need:
                Cm *= 2
        self.Nm = Nm
        self.Cm = Cm
        if kernels is None:
            import jax

            from ..ops.kernels import select_kernels

            kernels = select_kernels(
                jax.default_backend(), k_in=self.tables.k_in, Nm=Nm,
                interpret=interpret,
            )
        self.kernels = kernels
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.tier = _tier
        self._long_mode = False
        self._chunk_rounds = []
        self.max_rounds = max_rounds
        if _rev_pos is not None:
            self.rev_pos = _rev_pos
        else:
            from .trace_ops import build_reverse_pos

            self.rev_pos = build_reverse_pos(graph)
        self._dev_args = None
        self._bigger = None
        # projection mode: reach (the DEFAULT — measured faster on every
        # corpus, 2x on longsim CPU) builds once per graph (cached on
        # the shared tables) the precomputed reach sets that collapse
        # the per-slice relaxation loop to one gather + one sort; unfit
        # graphs (reach set > 63, > 2^22-1 nodes) fall back to the
        # iterative mode inside banded_scan. GA_PROJ=pairwise/sort2
        # reverts to the iterative projection.
        self._proj = _os.environ.get("GA_PROJ", "reach")
        # 8-bit tie-break deltas whenever every replay threshold fits
        # (ew <= 254 covers all default bandwidths); halves the largest
        # eager device->host transfer
        self._tie8 = ew <= 254 and not _os.environ.get("GA_NO_TIE8")
        self._reach = None
        if self._proj == "reach":
            from .reach import ensure_reach

            self._reach = ensure_reach(self.tables, ew - 1)
        # observed multi-node tie rate (EMA over walk batches): gates the
        # eager full-round tie16 prefetch vs per-lane subset fetches
        # (see _dispatch_round / fetch_tie16_lanes). Starts eager.
        self._mn_tie_rate = 1.0

    def _next_tier(self):
        """The 2x-capacity retry aligner (sharing graph tables), or None
        on the top tier: NM_MAX node slots (32 where the graph's in-degree
        leaves the packed predecessor words no room for wider slot
        fields, see ops.kernels) and CM_MAX cells."""
        nm_max = self.NM_MAX if self.tables.k_in <= 4 else 32
        if self.Nm >= nm_max and self.Cm >= self.CM_MAX:
            return None
        if self._bigger is None:
            self._bigger = BandedBatchAligner(
                self.graph,
                self.initial_bandwidth,
                self.ramp_bandwidth,
                Nm=min(self.Nm * 2, nm_max),
                Cm=min(max(self.Cm * 2, 448), self.CM_MAX),
                max_rounds=self.max_rounds,
                mesh=self.mesh,
                mesh_axis=self.mesh_axis,
                interpret=self.kernels.interpret,
                _tables=self.tables,
                _rev_pos=self.rev_pos,
                _tier=self.tier + 1,
            )
        return self._bigger

    def _device_args(self):
        # NOTE: plain numpy, not jax.device_put — mixing committed device
        # arrays and host arrays for the same jit signature once tripped
        # an XLA executable/buffer-count mismatch. XLA caches the
        # host->device transfer of these static tables.
        if self._dev_args is None:
            self._dev_args = self.tables.device_args()
        return self._dev_args

    # ------------------------------------------------------------ main entry
    def _start_run(self, problems):
        """Dispatch round 1 for a problem chunk WITHOUT blocking on the
        result: returns an opaque token for _finish_run. Lets the caller
        overlap another chunk's host-side walk/trace work with this
        chunk's device scan (JAX dispatch is async; only the control
        fetch in _finish_run blocks)."""
        n = len(problems)
        S_max = max(1, max(len(seq) // WORD_SIZE for seq, _ in problems))
        # quantize the compiled scan length to a small bucket ladder (each
        # signature is a separate compile; runtime is proportional to the
        # bucket, and sorted chunks keep the true length near it): {32},
        # multiples of 32 to 160, then x2.
        if S_max <= 32:
            S_max = 32
        elif S_max <= 96:
            S_max = 96
        elif S_max <= 160:
            S_max = 160
        else:
            cap = 160
            while cap < S_max:
                cap *= 2
            S_max = cap
        # memory-bounded long-read mode (the reference's sqrt-slice
        # sampling analog, GraphAligner.h:2571-2856, 2962-2967): reads
        # past LONG_WINDOW slices run as CHAINED rounds of LONG_WINDOW
        # slices; each round's multi-MB packed columns are dropped after
        # its control replay (only the boundary carry + last-slice
        # columns + the small per-slice tables survive), and the
        # backtrace recomputes one window at a time (_walk_long)
        true_S = max(1, max(len(seq) // WORD_SIZE for seq, _ in problems))
        window = self.LONG_WINDOW
        long_mode = S_max > window
        rounds_cap = self.max_rounds
        if long_mode:
            S_max = window
            rounds_cap = max(
                self.max_rounds, -(-true_S // S_max) + 4
            )
        self._long_mode = long_mode
        self._chunk_rounds = []
        lanes = [
            _LaneState(num_slices=len(seq) // WORD_SIZE) for seq, _ in problems
        ]
        cw = max(S_max, true_S)
        codes = np.full((n, cw * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8)
        # ONE LUT pass + per-problem CONTIGUOUS row copies: per-problem
        # encode_read calls (encode + LUT + a full validity pass each)
        # cost ~40us/problem of the short-read host wall. (A fancy-index
        # scatter variant was tried and LOST 4.5x — np.repeat traffic.)
        from .engine import _ENCODE_LUT

        seq_lens = np.fromiter(
            (len(seq) for seq, _ in problems), np.int64, n
        )
        joined = "".join(seq for seq, _ in problems).encode("latin-1")
        enc = _ENCODE_LUT[np.frombuffer(joined, np.uint8)]
        if len(enc) and enc.max(initial=0) == 255:
            bad = joined[int(np.argmax(enc == 255))]
            raise ValueError(f"unsupported read character {chr(bad)!r}")
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(seq_lens, out=offs[1:])
        for i in range(n):
            codes[i, : seq_lens[i]] = enc[offs[i] : offs[i + 1]]
        seq_lens = seq_lens.astype(np.int32)
        requests = [
            (i, 0, "init", 0) for i in range(n)
        ]  # (problem, start_slice, carry_ref, ramp_until)
        pend = self._dispatch_round(problems, codes, seq_lens, requests, S_max)
        return (problems, codes, seq_lens, lanes, S_max, requests, pend,
                rounds_cap)

    def _finish_run(self, token):
        """Complete all device rounds + control replay for a chunk started
        by _start_run; returns the final per-problem _LaneState list."""
        (problems, codes, seq_lens, lanes, S_max, requests, pend,
         rounds_cap) = token
        self._codes = codes
        self._seq_lens = seq_lens
        for round_no in range(rounds_cap):
            if not requests:
                break
            if pend is None:
                pend = self._dispatch_round(
                    problems, codes, seq_lens, requests, S_max
                )
                if self._long_mode and len(self._chunk_rounds) >= 1:
                    # the dispatch above consumed any carries from the
                    # previous round; its packed columns can go now, and
                    # the round before THAT no longer feeds rewinds
                    self._chunk_rounds[-1].cols_dev = None
                    self._chunk_rounds[-1].codes_dev = None
                    if len(self._chunk_rounds) >= 2:
                        # these four fields are dropped TOGETHER: rewind
                        # carries into this round are no longer serviceable
                        # (see rnd.dropped check below)
                        self._chunk_rounds[-2].sends_dev = None
                        self._chunk_rounds[-2].node_min_dev = None
                        self._chunk_rounds[-2].node_end_dev = None
                        self._chunk_rounds[-2].dropped = True
            rnd = self._finish_round(pend)
            pend = None
            if self._long_mode:
                self._chunk_rounds.append(rnd)
            for pos, (i, start, _, _) in enumerate(requests):
                lane = lanes[i]
                l, s0, n = rnd.req_meta[pos]
                lane.chain = [
                    _Rec(rnd, s0 + t, l, start + t, int(rnd._bw[s0 + t, l]), pos)
                    for t in range(n)
                ]
                lane.cursor = 0
            if round_no == 0:
                self._replay_bulk(lanes, requests, rnd)
            requests = []
            for i, lane in enumerate(lanes):
                if lane.done or lane.failed:
                    continue
                req = self._replay(lane)
                if req is not None:
                    if (
                        self._long_mode
                        and req[1] != "init"
                        and getattr(req[1].rnd, "dropped", False)
                    ):
                        # rewind carry into a round whose seeds were
                        # dropped (long mode keeps only the last round's)
                        lane.failed = True
                        lane.cause = "dropped_round"
                        continue
                    requests.append((i, req[0], req[1], req[2]))
            if self._long_mode:
                # stash each request's boundary columns AFTER the replay:
                # when the HMM/ramp control cut a window mid-chain, the
                # boundary the next window's walk needs is the last
                # ACCEPTED step (= the carry record), not the last
                # computed one.
                overrides = {}
                for (_, _, carry, _) in requests:
                    if carry != "init" and carry.rnd is rnd:
                        overrides[carry.lane_in_round] = carry.step
                self._stash_round_boundary(rnd, overrides)
        for i, lane in enumerate(lanes):
            if not lane.done:
                lane.failed = True
        return lanes

    def _run(self, problems):
        """Run all device rounds + control replay for
        problems = [(padded_sequence, start_node_index)]; returns the
        final per-problem _LaneState list."""
        return self._finish_run(self._start_run(problems))

    def get_tables(self, problems):
        """problems: [(padded_sequence, start_node_index)] →
        list of DPTable (reference getSqrtSlices result) or None where the
        lane needs the host fallback path."""
        if not problems:
            return []
        lanes = self._run(problems)
        out = []
        for i, lane in enumerate(lanes):
            if lane.failed:
                out.append(None)
                continue
            try:
                out.append(self._build_table(problems[i], lane))
            except AssertionError:
                out.append(None)  # host/device divergence → oracle fallback
        return out

    def get_traces(self, problems, chunk_size: int = 512):
        """problems → [(score, trace, table_slices, cells) | HostFallback]:
        the (min score, forward-order trace, surviving slice count)
        triple of getTraceFromTable via the batched device walk, or a
        HostFallback (with its cause) for lanes the host must align.

        Large problem lists run as a two-deep pipeline of chunks: the
        next chunk's slice scan is dispatched (async) before the current
        chunk's control fetch, so the device computes chunk k+1 while the
        host replays/walks chunk k. Only two chunks' DP columns are live
        in HBM at a time."""
        if not problems:
            return []
        results: list = [None] * len(problems)
        for batch in self.get_traces_stream(problems, chunk_size):
            for i, r in batch.items():
                results[i] = r
        return results

    def get_traces_stream(self, problems, chunk_size: int = 512):
        """Generator form of get_traces: yields {problem_index: result}
        batches as chunks complete (shortest chunks first, so a read's
        backward piece is usually ready when its forward chunk lands and
        the caller can finalize it while later chunks still compute).
        Failed lanes are withheld until the capacity-retry tier resolves
        them; the last yielded batch maps the remainder (a HostFallback
        where the host must align the lane)."""

        chunk_size = int(_os.environ.get("GA_CHUNK", chunk_size))
        # segment-packed chunks: problems are packed back to back into
        # scan lanes (FFD, the same packing _dispatch_round computes), so
        # a chunk mixes 160-slice forward extensions with 2-slice
        # backward ones at no step waste — chunk boundaries fall where
        # the LANE count reaches the batch target or the HBM cap
        order = sorted(
            range(len(problems)),
            key=lambda i: len(problems[i][0]),
            reverse=True,
        )
        chunks = []
        i = 0
        while i < len(order):
            S0 = max(1, len(problems[order[i]][0]) // WORD_SIZE)
            S_bucket = 32
            while S_bucket < S0:
                S_bucket = (
                    S_bucket + 64 if S_bucket < 160 else S_bucket * 2
                )
            # cap each chunk so one round's packed columns stay under
            # ~1.5GB of HBM (two chunks are in flight); megabase-scale
            # reads therefore run at a smaller batch instead of OOMing
            lane_target = min(
                chunk_size, max(8, int(1.5e9 // (S_bucket * 7 * self.Cm * 4)))
            )
            group = []
            fill: list = []
            while i < len(order):
                n = max(1, len(problems[order[i]][0]) // WORD_SIZE)
                placed = False
                for l in range(len(fill)):
                    if fill[l] + n <= S_bucket:
                        fill[l] += n
                        placed = True
                        break
                if not placed:
                    if len(fill) >= lane_target:
                        break
                    fill.append(n)
                group.append(order[i])
                i += 1
            chunks.append((group, [problems[j] for j in group]))
        chunks.reverse()  # smallest first
        unresolved: list = []
        causes: dict = {}
        pend = self._start_run(chunks[0][1])
        for ci, (idxs, ch) in enumerate(chunks):
            lanes = self._finish_run(pend)
            # dispatch this chunk's walk BEFORE the next chunk's scan so
            # the walk kernel + its fetches don't queue behind the scan;
            # the moves fetch and native decode then overlap that scan
            token = self._walk_dispatch(ch, lanes)
            pend = (
                self._start_run(chunks[ci + 1][1])
                if ci + 1 < len(chunks)
                else None
            )
            batch = {}
            for j, r, lane in zip(idxs, self._walk_collect(token), lanes):
                if r is None:
                    unresolved.append(j)
                    causes[j] = lane.cause
                else:
                    batch[j] = r
            yield batch
        # lanes that failed at this capacity (band overflow, usually)
        # retry on the 2x tier before anything falls to the host oracle
        final: dict = {}
        if unresolved:
            bigger = self._next_tier()
            if bigger is not None:
                redo = bigger.get_traces(
                    [problems[j] for j in unresolved], chunk_size
                )
            else:
                redo = [HostFallback(causes[j]) for j in unresolved]
            for j, r in zip(unresolved, redo):
                final[j] = r
        yield final

    def _walk_lanes(self, problems, lanes):
        return self._walk_collect(self._walk_dispatch(problems, lanes))

    def _walk_collect(self, token):
        """Fetch + decode a dispatched walk (see _walk_dispatch)."""
        kind = token[0]
        if kind == "done":
            return token[1]
        if kind == "moves":
            _, results, mv = token
            self._walk_moves_collect(mv, results)
            return results
        _, results, args = token
        self._walk_xla(*args, results)
        return results

    def _walk_dispatch(self, problems, lanes):
        """Host control tail + DEVICE dispatch of the backtrace walk,
        WITHOUT blocking on its results: get_traces dispatches the next
        chunk's scan between this and _walk_collect, so the moves fetch
        and native decode overlap that scan instead of queueing every
        walk-side device op behind it."""
        INT_MAX = 2**62
        B = len(lanes)
        results: list = [None] * B
        # apply removeWronglyAlignedEnd + compute per-lane table length
        keeps = np.zeros(B, dtype=np.int32)
        starts_w = np.zeros(B, dtype=np.int32)
        removed = []
        for i, lane in enumerate(lanes):
            if lane.failed:
                removed.append(None)
                continue
            corr = list(lane.corr_list)
            ok = corr[-1].currently_correct() if corr else False
            while not ok:
                if not corr:
                    break
                corr.pop()
                if not corr:
                    break
                ok = corr[-1].false_from_correct()
            removed.append(len(corr))
            keeps[i] = len(corr)
            if len(corr) == 0:
                results[i] = (INT_MAX, [], 0, 0)
        walk_idx = [
            i
            for i, lane in enumerate(lanes)
            if not lane.failed and keeps[i] > 0
        ]
        if not walk_idx:
            return ("done", results)
        if self._long_mode:
            from ..io import native

            if self.kernels.long_walk is None or native.get_lib() is None:
                # the windowed walk needs the move encoding (k_in <= 4)
                # and the native decoder: without either these lanes go
                # to the host fallback (or fail loudly under
                # GA_NO_FALLBACK)
                for i in walk_idx:
                    lanes[i].failed = True
                return ("done", results)
            # memory-bounded long-read walk: recompute + walk one window
            # (round) at a time, newest first, carrying lane state across
            # windows (runs synchronously at dispatch)
            self._walk_long(
                problems, lanes, keeps, walk_idx, list(self._chunk_rounds),
                results,
            )
            return ("done", results)
        big_dev, st = self._gather_walk_inputs(lanes, keeps)
        starts_map: dict = {}
        slow_idx = []
        for i in walk_idx:
            rec_best = lanes[i].accepted[int(keeps[i]) - 1].min_score
            if int(st[i, 0]) != rec_best:
                slow_idx.append(i)  # host/device min divergence
            elif int(st[i, 1]) == 1:
                # unique minimum: collection order is tie-breaking only,
                # the device decision is exact
                starts_map[i] = (int(st[i, 2]), int(st[i, 3]), int(st[i, 4]))
            elif int(st[i, 3]) == int(st[i, 7]):
                # same-node tie, decided on device: all tied minima in
                # one node -> winner is the node's last tied offset
                starts_map[i] = (int(st[i, 6]), int(st[i, 7]), int(st[i, 8]))
            else:
                slow_idx.append(i)
        # EMA of the multi-node tie rate steers the eager-vs-subset tie16
        # prefetch of FUTURE rounds (see _dispatch_round)
        if walk_idx:
            rate = len(slow_idx) / len(walk_idx)
            self._mn_tie_rate = 0.5 * self._mn_tie_rate + 0.5 * rate
        if slow_idx:
            # multi-node score ties (or a host/device min divergence):
            # the reference picks the LAST minimum in banded-Tarjan
            # collection order, which needs the host band-order replay
            # over the affected lanes' final slices (fetched row-wise)
            final_sends, final_band = self._fetch_walk_rows(
                big_dev, slow_idx, B
            )
            try:
                slow = self._walk_starts(
                    problems, lanes, keeps, slow_idx, final_sends, final_band
                )
            except AssertionError:
                # host/device band divergence: fall back lane-by-lane
                # (only the affected lanes; unique-minimum lanes keep
                # their device-decided starts)
                for i in slow_idx:
                    lanes[i].failed = True
            else:
                for i, s in zip(slow_idx, slow):
                    if s is None:
                        lanes[i].failed = True
                    else:
                        starts_map[i] = s
            walk_idx = [i for i in walk_idx if i in starts_map]
            if not walk_idx:
                return ("done", results)
        starts = [starts_map[i] for i in walk_idx]
        from ..io import native

        K_max = _quantize_k(int(max(keeps[i] for i in walk_idx)))

        if self.kernels.walk == "triton" and native.get_lib() is not None:
            mv = self._walk_moves_dispatch(
                problems, lanes, keeps, walk_idx, starts
            )
            return ("moves", results, mv)
        return ("xla", results, (problems, lanes, keeps, walk_idx, starts, K_max))

    def _walk_xla(self, problems, lanes, keeps, walk_idx, starts, K_max, results):
        from .backtrace_device import walk_batch

        B = len(lanes)
        starts_w = np.zeros(B, dtype=np.int32)
        for i, (w0, _, _) in zip(walk_idx, starts):
            starts_w[i] = w0
        cols_tab, band_tab = self._consolidate(lanes, keeps, K_max, "flat")
        assert cols_tab is not None
        T_max = K_max * 80 + WORD_SIZE
        seed_nodes = np.array([p[1] for p in problems], dtype=np.int32)
        trace_dev, fail_dev = walk_batch(
            self.tables,
            cols_tab,
            band_tab,
            self._codes,
            self._seq_lens,
            seed_nodes,
            starts_w,
            keeps,
            T_max=T_max,
        )
        trace = np.asarray(trace_dev)  # [T_max+1, 2, B]
        fail = np.asarray(fail_dev)
        for i in walk_idx:
            lane = lanes[i]
            if fail[i]:
                lane.failed = True
                continue
            rows = trace[:, 1, i]
            n = int(np.argmax(rows == -2)) if (rows == -2).any() else len(rows)
            arr = np.stack([trace[:n, 0, i], rows[:n]], axis=1).astype(np.int64)
            if len(arr) < 2 or arr[-1, 1] != -1 or arr[-2, 1] != 0:
                lane.failed = True
                continue
            arr = arr[-2::-1]  # drop the row -1 terminator, forward order
            score = lane.accepted[int(keeps[i]) - 1].min_score
            cells = sum(
                r.num_cells for r in lane.accepted[: int(keeps[i])]
            ) * WORD_SIZE
            results[i] = (score, arr, int(keeps[i]), cells)

    def _walk_moves_dispatch(self, problems, lanes, keeps, walk_idx, starts):
        """Move-encoded walk-kernel dispatch (collect fetches + decodes):
        ~6KB of 4-bit move codes per 10kb read cross to the host instead
        of ~100KB of (position, row) pairs.

        Lanes are GROUPED by quantized table length and split into
        <=GA_WALK_DISP_B-lane blocks, each dispatched as its own kernel
        call: short (backward-extension) lanes stop paying the long
        lanes' padded moves buffer (+ its fetch bytes), and block k+1's
        kernel overlaps block k's moves fetch + native decode — the
        walk pipeline the single-chunk short-read regime otherwise
        lacks. Pure scheduling: per-lane results are unchanged."""
        starts_map = dict(zip(walk_idx, starts))
        disp_b = int(_os.environ.get("GA_WALK_DISP_B", 256))
        groups: dict = {}
        for i in walk_idx:
            groups.setdefault(_quantize_k(int(keeps[i])), []).append(i)
        # sparse rungs ride the next-larger rung: every (K rung, lane
        # bucket) pair is a fresh jit signature and blocks pad to >=128
        # lanes anyway, so a <32-lane rung costs more in compile +
        # padding than its shorter moves buffer saves. Padded slices
        # are inert (no active lane).
        for kq in sorted(groups):
            bigger = [q for q in groups if q > kq]
            if len(groups[kq]) < 32 and bigger:
                groups[min(bigger)].extend(groups.pop(kq))
        mv_blocks = []
        for kq in sorted(groups, reverse=True):
            g = groups[kq]
            if disp_b <= 0:
                blocks = [g]
            else:
                blocks = [g[j : j + disp_b] for j in range(0, len(g), disp_b)]
            for blk in blocks:
                mv_blocks.append(
                    self._walk_moves_dispatch_block(
                        problems, lanes, keeps, blk, starts_map, kq
                    )
                )
        return mv_blocks

    def _walk_moves_dispatch_block(
        self, problems, lanes, keeps, blk, starts_map, K_max
    ):
        """One walk-kernel dispatch over lane subset `blk` (table length
        quantized to K_max slices). Returns the collect token; nothing
        here blocks on device results."""
        import jax.numpy as jnp

        from ..ops.pallas import walk_moves as wm

        n = len(blk)
        # lane-pad to a 128-multiple; the jitted consolidation emits the
        # tabs already padded AND carrying the leading below-window slice
        Bp = max(128, -(-n // 128) * 128)
        cols_tab, band_tab, lens_tab, pred_tab, pprev_tab, codes_tab = (
            self._consolidate_walk(lanes, keeps, K_max, blk, Bp)
        )
        from .backtrace_device import _BT_MATCH

        bits_lut = np.zeros(_BT_MATCH.shape[0], dtype=np.int32)
        for g in range(5):
            bits_lut |= _BT_MATCH[:, g].astype(np.int32) << g
        if codes_tab is None or _os.environ.get("GA_HOST_WALK_CODES"):
            # host fallback (and the GA_HOST_WALK_CODES A/B switch):
            # relayout + re-upload the uint8 codes; device-side match
            # mask expansion either way (the mask table is 4x the bytes)
            L = K_max * WORD_SIZE
            codes = self._codes[blk, :L]
            if codes.shape[1] < L:
                codes = np.pad(codes, ((0, 0), (0, L - codes.shape[1])))
            codes8 = np.ascontiguousarray(
                codes.reshape(n, K_max, WORD_SIZE).transpose(1, 2, 0)
            )
            if Bp != n:
                codes8 = np.pad(codes8, ((0, 0), (0, 0), (0, Bp - n)))
            codes8 = _pad_lead(codes8, 0)  # device tabs carry theirs
        else:
            # device-resident: gathered by _consolidate_walk from the
            # scan's codes passthrough (lead slice included) — nothing
            # multi-MB is re-uploaded
            codes8 = codes_tab

        def row1(a):
            a = np.ascontiguousarray(a, dtype=np.int32)
            if Bp != len(a):
                a = np.pad(a, (0, Bp - len(a)))
            return a[None, :]

        keeps_b = np.zeros(n, np.int32)
        sslot = np.zeros(n, np.int32)
        soff = np.zeros(n, np.int32)
        sscore = np.zeros(n, np.int32)
        sw = np.zeros(n, np.int64)
        for bi, i in enumerate(blk):
            w0, slot0, off0 = starts_map[i]
            keeps_b[bi] = keeps[i]
            sslot[bi] = slot0
            soff[bi] = off0
            sw[bi] = w0
            sscore[bi] = lanes[i].accepted[int(keeps[i]) - 1].min_score
        seed_nodes = np.array([problems[i][1] for i in blk], dtype=np.int32)
        init_state = _walk_init_state(
            Bp, row1(keeps_b)[0], row1(sslot)[0], row1(soff)[0],
            row1(sscore)[0],
        )
        # whole-table walk = one window with base 0; the consolidation
        # already grew the leading pad slice (the below-window neighbor,
        # unread at q==1)
        moves_dev, fail_dev, _state, used_dev = wm.walk_moves(
            cols_tab,
            band_tab,
            lens_tab,
            pred_tab,
            pprev_tab,
            codes8,
            bits_lut,
            row1(self._seq_lens[blk]),
            row1(seed_nodes),
            np.zeros((1, Bp), np.int32),
            init_state,
            K_in=self.tables.k_in,
            interpret=self.kernels.interpret,
        )
        # the moves budget (112/slice) is the worst case; real paths use
        # ~60-75% of it, so prefetch only the expected-use prefix —
        # collect falls back to the full buffer on the rare over-run
        # (the kernel reports each lane's used count)

        T_w = moves_dev.shape[0]
        t_lo = int(_os.environ.get("GA_WALK_TLO", 88))
        T_lo = min(T_w, (K_max * t_lo + 512 + 7) // 8)
        lo_dev = moves_dev[:T_lo] if T_lo < T_w else moves_dev
        for arr in (lo_dev, fail_dev, used_dev):
            if hasattr(arr, "copy_to_host_async"):
                try:
                    arr.copy_to_host_async()
                except Exception:
                    pass
        return (
            lo_dev, moves_dev, T_lo, used_dev, fail_dev, lanes, keeps,
            blk, sw, K_max,
        )

    def _walk_moves_collect(self, mv_blocks, results):
        from ..io import native

        t = self.tables
        node_start64 = np.ascontiguousarray(self.graph.node_start, dtype=np.int64)
        node_end64 = np.ascontiguousarray(self.graph.node_end, dtype=np.int64)
        pos2node = np.ascontiguousarray(t.pos_to_node)
        in_nbrs = np.ascontiguousarray(t.in_nbrs)

        # ONE batched native call per block decodes every live lane with
        # an internal C++ thread pool (ga_decode_batch) — the per-lane
        # pool of ctypes calls paid a GIL round trip + a strided numpy
        # column copy per lane. Block k's native
        # decode overlaps block k+1's kernel + async moves fetch on the
        # device timeline.
        trace_t = _os.environ.get("GA_WALK_TIMES") == "1"
        import time as _t

        nthreads = int(_os.environ.get("GA_THREADS", 0)) or min(
            8, _os.cpu_count() or 1
        )
        for mv in mv_blocks:
            (lo_dev, moves_dev, T_lo, used_dev, fail_dev, lanes, keeps,
             blk, sw, K_max) = mv
            t0 = _t.time() if trace_t else 0
            rows = int(np.asarray(used_dev).max()) // 8 + 1
            t1 = _t.time() if trace_t else 0
            if rows <= T_lo:
                src = lo_dev
            else:
                # over-run: fetch the FULL buffer (already materialized on
                # device — a tail slice would compile a fresh signature)
                src = moves_dev
            moves = np.ascontiguousarray(np.asarray(src)).view(np.uint32)
            t2 = _t.time() if trace_t else 0
            fail = np.asarray(fail_dev)[0]
            cap = K_max * WORD_SIZE * 3 + 64
            live = [(col, i) for col, i in enumerate(blk) if not fail[col]]
            for col, i in enumerate(blk):
                if fail[col]:
                    lanes[i].failed = True
            if live:
                cols_a = np.array([c for c, _ in live], dtype=np.int32)
                sw_a = np.array([sw[c] for c, _ in live], dtype=np.int64)
                sr_a = np.array(
                    [int(keeps[i]) * WORD_SIZE - 1 for _, i in live],
                    dtype=np.int64,
                )
                tn = _t.time() if trace_t else 0
                out_w, out_r, n_out = native.decode_moves_batch(
                    moves, cols_a, sw_a, sr_a, node_start64, node_end64,
                    pos2node, in_nbrs, cap, nthreads,
                )
                tn2 = _t.time() if trace_t else 0
                if trace_t:
                    import sys as _sys

                    print(
                        f"[walk_times]   native={1e3*(tn2-tn):.1f}ms "
                        f"W={len(live)} cap={cap}",
                        file=_sys.stderr, flush=True,
                    )
                for j, (_, i) in enumerate(live):
                    n = int(n_out[j])
                    lane = lanes[i]
                    if n < 1 or out_r[j, 0] != 0:
                        lane.failed = True
                        continue
                    arr = np.stack(
                        [out_w[j, :n], out_r[j, :n]], axis=1
                    )
                    score = lane.accepted[int(keeps[i]) - 1].min_score
                    cells = sum(
                        r.num_cells for r in lane.accepted[: int(keeps[i])]
                    ) * WORD_SIZE
                    results[i] = (score, arr, int(keeps[i]), cells)
            if trace_t:
                import sys as _sys

                print(
                    f"[walk_times] block lanes={len(blk)} K={K_max} "
                    f"Tw={src.shape[0]} kernel_wait={1e3*(t1-t0):.1f}ms "
                    f"moves_fetch={1e3*(t2-t1):.1f}ms "
                    f"({moves.nbytes/1e6:.2f}MB) "
                    f"decode={1e3*(_t.time()-t2):.1f}ms",
                    file=_sys.stderr, flush=True,
                )

    def _gather_walk_inputs(self, lanes, keeps):
        """Batched device gather of every walk lane's final slice. Only
        the [B, 10] start summary is fetched (unique minima AND
        same-node ties resolve from it directly); the multi-MB
        [B, Cm+Nm] sends+band payload stays DEVICE-RESIDENT — multi-node
        tie lanes fetch their rows via _fetch_walk_rows."""
        import jax.numpy as jnp

        B = len(lanes)
        acc_big = jnp.zeros((B, self.Cm + self.Nm), jnp.int32)
        acc_st = jnp.zeros((B, 10), jnp.int32)
        rounds = []
        for i, lane in enumerate(lanes):
            if not lane.failed and keeps[i] > 0:
                rec = lane.accepted[int(keeps[i]) - 1]
                if rec.rnd not in rounds:
                    rounds.append(rec.rnd)
        step_fn = _walk_inputs_step_fn()
        for rnd in rounds:
            steps = np.zeros(B, dtype=np.int32)
            lane_pos = np.zeros(B, dtype=np.int32)
            mask = np.zeros(B, dtype=np.int32)
            for i, lane in enumerate(lanes):
                if lane.failed or keeps[i] == 0:
                    continue
                rec = lane.accepted[int(keeps[i]) - 1]
                if rec.rnd is rnd:
                    steps[i] = rec.step
                    lane_pos[i] = rec.lane_in_round
                    mask[i] = 1
            packed = np.stack([steps, lane_pos, mask])
            acc_big, acc_st = step_fn(
                rnd.sends_dev,
                rnd.band_ids_dev,
                rnd.lens_tab_dev,
                self.tables.node_start,
                packed,
                acc_big,
                acc_st,
            )
        acc_st_h = np.asarray(acc_st)
        if self._mn_tie_rate > 0.4 and hasattr(acc_big, "copy_to_host_async"):
            # tie-heavy corpora will take _fetch_walk_rows' full-fetch
            # branch: start the [B, Cm+Nm] payload's transfer now
            # (AFTER the small summary fetch, so it doesn't queue ahead
            # of it) — _walk_starts' host work overlaps the transfer
            try:
                acc_big.copy_to_host_async()
            except Exception:
                pass
        return acc_big, acc_st_h  # device [B, Cm+Nm], host [B, 10]

    def _fetch_walk_rows(self, big_dev, idxs, B):
        """Fetch the final-slice (sends, band) rows for a SUBSET of walk
        lanes from the device-resident payload; returns dense
        (final_sends [B, Cm], final_band [B, Nm]) host arrays with only
        those rows filled. Per-lane dynamic slices keep ONE jit
        signature; above ~30% of the batch the full fetch is cheaper."""
        final_sends = np.zeros((B, self.Cm), np.int32)
        final_band = np.full((B, self.Nm), int(EMPTY), np.int32)
        if not idxs:
            return final_sends, final_band
        if len(idxs) > 0.5 * B:
            out = np.asarray(big_dev)
            final_sends[:] = out[:, : self.Cm]
            final_band[:] = out[:, self.Cm :]
            return final_sends, final_band
        import jax

        if len(idxs) > 48:
            # mid-size subset: ONE device gather with the index count
            # padded to a power-of-two bucket (per-lane slices would be
            # hundreds of dispatches; an unbucketed gather would compile
            # a fresh signature per subset size)
            bucket = 64
            while bucket < len(idxs):
                bucket *= 2
            bucket = min(bucket, B)
            pad = np.zeros(bucket, np.int32)
            pad[: len(idxs)] = idxs
            global _WALK_ROW_GATHER
            if _WALK_ROW_GATHER is None:
                _WALK_ROW_GATHER = jax.jit(lambda d, i: d[i])
            out = np.asarray(_WALK_ROW_GATHER(big_dev, pad))
            for j, i in enumerate(idxs):
                final_sends[i] = out[j, : self.Cm]
                final_band[i] = out[j, self.Cm :]
            return final_sends, final_band

        global _WALK_ROW_SLICE
        if _WALK_ROW_SLICE is None:

            def _row1(dev, i):
                return jax.lax.dynamic_slice_in_dim(dev, i, 1, axis=0)

            _WALK_ROW_SLICE = jax.jit(_row1)
        devs = []
        for i in idxs:
            d = _WALK_ROW_SLICE(big_dev, np.int32(i))
            try:
                d.copy_to_host_async()
            except Exception:
                pass
            devs.append(d)
        for i, d in zip(idxs, devs):
            row = np.asarray(d)[0]
            final_sends[i] = row[: self.Cm]
            final_band[i] = row[self.Cm :]
        return final_sends, final_band

    def _walk_starts(self, problems, lanes, keeps, walk_idx, final_sends, final_band):
        """Backtrace start position per lane: min_score_index.back() of the
        final surviving slice, with the reference's banded-Tarjan
        collection order (GraphAligner.h:2359-2366).

        The unique-minimum decision runs VECTORIZED across all lanes
        (batched node-length/offset layout + min counting); only lanes
        whose final slice has score ties take the per-lane order replay."""
        g = self.graph
        t = self.tables
        widx = np.asarray(walk_idx)
        fb = final_band[widx]  # [W, Nm]
        valid = fb != EMPTY
        lens_w = np.where(valid, t.node_len[np.clip(fb, 0, t.num_nodes - 1)], 0)
        offs_w = np.cumsum(lens_w, axis=1) - lens_w  # [W, Nm]
        c_used_w = lens_w.sum(axis=1)
        best_w = np.array(
            [lanes[i].accepted[int(keeps[i]) - 1].min_score for i in walk_idx]
        )
        sends_w = final_sends[widx]  # [W, Cm]
        cells_idx = np.arange(sends_w.shape[1])[None, :]
        is_min = (sends_w == best_w[:, None]) & (cells_idx < c_used_w[:, None])
        nmins = is_min.sum(axis=1)
        first_cell = np.argmax(is_min, axis=1)
        # slot of the min cell: #offsets <= cell, minus one
        slot_w = (
            (offs_w <= first_cell[:, None]) & valid
        ).sum(axis=1) - 1
        off_w = first_cell - offs_w[np.arange(len(widx)), slot_w]
        node_w = fb[np.arange(len(widx)), slot_w]
        pos_w = np.asarray(g.node_start)[node_w] + off_w
        # same-node ties, VECTORIZED: slot spans are contiguous cell
        # ranges, so first and last min in the same slot means ALL tied
        # minima are inside one node — the reference winner is then the
        # node's last tied offset regardless of collection order (the
        # resolve_tie fast path, lifted out of the per-lane pool)
        last_cell = sends_w.shape[1] - 1 - np.argmax(is_min[:, ::-1], axis=1)
        slot_l = ((offs_w <= last_cell[:, None]) & valid).sum(axis=1) - 1
        off_l = last_cell - offs_w[np.arange(len(widx)), slot_l]
        node_l = fb[np.arange(len(widx)), slot_l]
        pos_l = np.asarray(g.node_start)[node_l] + off_l
        same_node = slot_w == slot_l
        def resolve_tie(i):
            """Reference min_score_index.back(): the LAST minimum cell in
            banded-Tarjan collection order, which needs the band-order
            replay chain (GraphAligner.h:2359-2366)."""
            lane = lanes[i]
            keep = int(keeps[i])
            accepted = lane.accepted[:keep]
            rec = accepted[-1]
            sends = final_sends[i]
            ids = final_band[i]
            ids = ids[ids != EMPTY]
            order2, lens2, offs2 = _cell_layout(self.tables, ids)
            c_used = int(lens2.sum())
            best = rec.min_score
            hits = np.nonzero(sends[:c_used] == best)[0]
            if len(hits) == 1:
                # unique minimum: the Tarjan collection order
                # (GraphAligner.h:2359-2366) is tie-breaking only
                cell = int(hits[0])
                slot = int(np.searchsorted(offs2, cell, side="right")) - 1
                off = cell - int(offs2[slot])
                return (int(g.node_start[order2[slot]]) + off, slot, off)
            hit_slots = np.searchsorted(offs2, hits, side="right") - 1
            if (hit_slots == hit_slots[0]).all():
                # all tied minima inside ONE node: whatever position the
                # node takes in the collection order, the reference's
                # winner is the node's last tied offset — no band-order
                # replay needed (the common case on chain-like graphs)
                cell = int(hits[-1])
                slot = int(hit_slots[0])
                off = cell - int(offs2[slot])
                return (int(g.node_start[order2[slot]]) + off, slot, off)
            orders = self._band_orders(problems[i][1], accepted, lane.bandwidths[:keep])
            order = orders[-1]
            from ..io import native as _nat

            if _nat.get_lib() is not None:
                # native banded-Tarjan + last-min scan (bit-exact twin of
                # the Python block below; the per-lane Python Tarjan was
                # the tie path's host bottleneck on short-read corpora)
                last = _nat.tie_start(
                    order, sends[:c_used], best, g, self.tables.topo_rank
                )
                assert last is not None and last >= 0
            else:
                cell_of = {
                    int(n): (int(f), int(L))
                    for n, f, L in zip(order2, offs2, lens2)
                }
                last = None
                comps = _banded_tarjan(g, list(order), {n: True for n in order})
                for comp in reversed(comps):
                    for n in reversed(comp):
                        f, L = cell_of[n]
                        seg = sends[f : f + L]
                        if seg.min() == best:
                            startp = int(g.node_start[n])
                            for k in range(L):
                                if seg[k] == best:
                                    last = startp + k
                assert last is not None
            node = int(g.pos_to_node[last])
            slot = int(np.nonzero(order2 == node)[0][0])
            return (last, slot, last - int(g.node_start[node]))

        starts: list = [None] * len(walk_idx)
        tie_idx = []
        n_mn = 0
        # bulk .tolist() once — per-element numpy scalar reads in the
        # loop below cost microseconds each
        nmins_l = nmins.tolist()
        same_node_l = same_node.tolist()
        pw, sw_, ow = pos_w.tolist(), slot_w.tolist(), off_w.tolist()
        pl, sl_, ol = pos_l.tolist(), slot_l.tolist(), off_l.tolist()
        for w, i in enumerate(walk_idx):
            if nmins_l[w] == 0:
                # host/device min divergence: no cell holds the accepted
                # min — fail the lane (starts[w] stays None)
                continue
            if nmins_l[w] == 1:
                starts[w] = (pw[w], sw_[w], ow[w])
            elif same_node_l[w]:
                starts[w] = (pl[w], sl_[w], ol[w])
            else:
                tie_idx.append((w, i))
                n_mn += 1
        if tie_idx:
            # materialize the replay inputs once, single-threaded (cached
            # on the _Round; tie16 columns fetched only for THESE lanes
            # unless the eager full round already landed), then resolve
            # the tie lanes on the host pool: the native band-order
            # replay releases the GIL (reference analog: per-thread
            # backtraces, Aligner.cpp:275-298)
            from ..io import native as _native

            have_native = _native.get_lib() is not None
            live_ties = []
            by_round: dict = {}
            for w, i in tie_idx:
                ok = True
                for rec in lanes[i].accepted[: int(keeps[i])]:
                    if have_native:
                        ent = by_round.setdefault(id(rec.rnd), (rec.rnd, set()))
                        ent[1].add(int(rec.lane_in_round))
                        rec.rnd.tie_ids_sub
                    elif (
                        rec.rnd.node_min_dev is None
                        and "tie" not in rec.rnd._host
                    ):
                        # long mode dropped this round's replay inputs and
                        # there is no native tie16 path: the tie cannot be
                        # resolved — fail just this lane (starts[w]=None)
                        ok = False
                        break
                    else:
                        rec.rnd.tie_data
                if ok:
                    live_ties.append((w, i))
                else:
                    lanes[i].failed = True
            for rnd, lset in by_round.values():
                rnd.fetch_tie16_lanes(sorted(lset))
            if (
                have_native
                and live_ties
                and not _os.environ.get("GA_NO_TIEBATCH")
            ):
                # ONE native call resolves every tie lane: the chain
                # replay + last-min scan run on a C++ thread pool
                # (ga_tie_batch); the per-lane Python dispatch overhead
                # (numpy prep + 2 ctypes calls per lane under the GIL)
                # dominated this phase on short-read corpora
                from .params import ALTERNATE_METHOD_CUTOFF

                W = len(live_ties)
                Kmax = max(int(keeps[i]) for _, i in live_ties)
                Nm = self.Nm
                tie_b = np.zeros((W, Kmax, 3, Nm), np.int32)
                chk_b = np.zeros((W, Kmax), np.uint8)
                ms_b = np.zeros((W, Kmax), np.int32)
                bw_b = np.zeros((W, Kmax), np.int32)
                Ks = np.zeros(W, np.int32)
                sn_b = np.zeros(W, np.int32)
                bests_b = np.zeros(W, np.int32)
                for t, (w, i) in enumerate(live_ties):
                    keep = int(keeps[i])
                    tie, check, ms = self._tie_chain_inputs(
                        lanes[i].accepted[:keep]
                    )
                    tie_b[t, :keep] = tie
                    chk_b[t, :keep] = check
                    ms_b[t, :keep] = ms
                    bw_b[t, :keep] = lanes[i].bandwidths[:keep]
                    Ks[t] = keep
                    sn_b[t] = problems[i][1]
                    bests_b[t] = ms[keep - 1]
                sends_b = final_sends[[i for _, i in live_ties]]
                pos_b, rc_b = _native.tie_batch(
                    tie_b, ms_b, bw_b, Ks, sn_b, chk_b, sends_b, bests_b,
                    g, self.tables.topo_rank, ALTERNATE_METHOD_CUTOFF,
                    int(EMPTY), _decode_pool()._max_workers,
                )
                p2n = self.tables.pos_to_node
                node_start = np.asarray(g.node_start)
                for t, (w, i) in enumerate(live_ties):
                    if rc_b[t] != 0 or pos_b[t] < 0:
                        # host/device band divergence (or no tied min):
                        # fail only this lane — it re-runs on the retry
                        # ladder (capacity tier → oracle)
                        lanes[i].failed = True
                        continue
                    pos = int(pos_b[t])
                    node = int(p2n[pos])
                    hit = np.nonzero(fb[w] == node)[0]
                    if len(hit) == 0:
                        lanes[i].failed = True
                        continue
                    starts[w] = (
                        pos, int(hit[0]), pos - int(node_start[node])
                    )
                return starts
            resolved = list(
                _decode_pool().map(resolve_tie, [i for _, i in live_ties])
            )
            for (w, _), s in zip(live_ties, resolved):
                starts[w] = s
        return starts

    def _consolidate_walk(self, lanes, keeps, K_max, blk, Bp):
        """Jitted walk-table consolidation for one dispatch block:
        returns (cols, band, lens, pred, pred_prev, codes) device tabs, already
        lane-padded to Bp and carrying the walk kernel's leading
        below-window pad slice (shape [K_max+1, ..., Bp]). codes is
        None when any source round lacks the device codes passthrough
        (host fallback / GA_HOST_WALK_CODES A/B). One compiled program
        per (round shapes, K_max, Bp) replaces ~10 eager dispatches per
        round (see _consol_fn)."""
        idx_list = list(blk)
        rounds = []
        for li in idx_list:
            for rec in lanes[li].accepted:
                if rec.rnd not in rounds:
                    rounds.append(rec.rnd)
        want_codes = all(
            r.codes_dev is not None for r in rounds
        ) and not _os.environ.get("GA_HOST_WALK_CODES")
        K1 = K_max + 1
        accs: tuple = ()
        dummy_codes = np.zeros((1, 1, 1), np.uint8)
        for ri, rnd in enumerate(rounds):
            steps = np.zeros((K1, Bp), np.int32)
            mask = np.zeros((K1, Bp), bool)
            lane_pos = np.zeros(Bp, np.int32)
            for bi, li in enumerate(idx_list):
                lane = lanes[li]
                if lane.failed:
                    continue
                for k, rec in enumerate(lane.accepted[: int(keeps[li])]):
                    if rec.rnd is rnd:
                        steps[k + 1, bi] = rec.step
                        mask[k + 1, bi] = True
            for bi, li in enumerate(idx_list):
                for rec in lanes[li].accepted:
                    if rec.rnd is rnd:
                        lane_pos[bi] = rec.lane_in_round
                        break
            fn = _consol_fn(want_codes, ri == 0)
            accs = fn(
                rnd.band_ids_dev,
                rnd.lens_tab_dev,
                rnd.pred_tab_dev,
                rnd.pred_prev_dev,
                rnd.cols_dev,
                rnd.codes_dev if want_codes else dummy_codes,
                lane_pos,
                steps,
                mask,
                *accs,
            )
        band_t, lens_t, pred_t, pprev_t, cols_t = accs[:5]
        codes_t = accs[5] if want_codes else None
        return cols_t, band_t, lens_t, pred_t, pprev_t, codes_t

    def _consolidate(self, lanes, keeps, K_max, layout, *, subset=None):
        """Gather per-lane table slices from each round's device-resident
        outputs. layout 'flat' -> (cols [7, B, K*Cm], band [K, Nm, B]) for
        the XLA walk; 'perslice' -> (cols [K, 7, Cm, B], band, lens, pred
        tabs [K, Nm, B]) for the Pallas move-walk kernel. subset = a list
        of lane indices to gather (table column b = lane subset[b]); the
        walk dispatch groups lanes by table length so short (backward)
        lanes stop paying the long lanes' padded slices."""
        import jax.numpy as jnp

        idx_list = list(range(len(lanes))) if subset is None else list(subset)
        B = len(idx_list)
        rounds = []
        for li in idx_list:
            for rec in lanes[li].accepted:
                if rec.rnd not in rounds:
                    rounds.append(rec.rnd)
        # all tables are gathered on DEVICE (band/lens/pred feed the walk
        # kernel directly; nothing multi-MB crosses to the host)
        band_tab = jnp.full((K_max, self.Nm, B), int(EMPTY), dtype=jnp.int32)
        lens_tab = jnp.zeros((K_max, self.Nm, B), dtype=jnp.int32)
        pred_tab = jnp.zeros((K_max, self.Nm, B), dtype=jnp.int32)
        cols_tab = None
        codes_tab = None
        want_codes = layout == "perslice" and all(
            r.codes_dev is not None for r in rounds
        )
        for rnd in rounds:
            steps = np.zeros((K_max, B), dtype=np.int32)
            mask = np.zeros((K_max, B), dtype=bool)
            for bi, li in enumerate(idx_list):
                lane = lanes[li]
                if lane.failed:
                    continue
                for k, rec in enumerate(lane.accepted[: int(keeps[li])]):
                    if rec.rnd is rnd:
                        steps[k, bi] = rec.step
                        mask[k, bi] = True
            # map batch lanes: lane i occupies rec.lane_in_round in rnd
            lane_pos = np.zeros(B, dtype=np.int32)
            for bi, li in enumerate(idx_list):
                for rec in lanes[li].accepted:
                    if rec.rnd is rnd:
                        lane_pos[bi] = rec.lane_in_round
                        break
            steps_d = jnp.asarray(steps)[:, None, :]  # [K_max, 1, B]
            mask_d = jnp.asarray(mask)[:, None, :]
            for tab, dev, fill in (
                ("band", rnd.band_ids_dev, None),
                ("lens", rnd.lens_tab_dev, None),
                ("pred", rnd.pred_tab_dev, None),
            ):
                g = jnp.take_along_axis(dev[:, :, lane_pos], steps_d, axis=0)
                if tab == "band":
                    band_tab = jnp.where(mask_d, g, band_tab)
                elif tab == "lens":
                    lens_tab = jnp.where(mask_d, g, lens_tab)
                else:
                    pred_tab = jnp.where(mask_d, g, pred_tab)
            src = rnd.cols_dev[:, :, :, lane_pos]  # [S, 7, Cm, B]
            if layout == "perslice":
                g = jnp.take_along_axis(
                    src, jnp.asarray(steps)[:, None, None, :], axis=0
                )  # [K_max, 7, Cm, B]
                m = jnp.asarray(mask)[:, None, None, :]
            else:
                src = jnp.transpose(src, (0, 1, 3, 2))  # [S, 7, B, Cm]
                g = jnp.take_along_axis(
                    src, jnp.asarray(steps)[:, None, :, None], axis=0
                )  # [K_max, 7, B, Cm]
                m = jnp.asarray(mask)[:, None, :, None]
            cols_tab = (
                jnp.where(m, g, 0) if cols_tab is None else jnp.where(m, g, cols_tab)
            )
            if want_codes:
                # walk-layout read codes, gathered from the SCAN's
                # device-resident passthrough (engine_banded "codes"):
                # saves the ~5MB/chunk host relayout + re-upload the
                # walk dispatch used to pay
                csrc = rnd.codes_dev[:, :, lane_pos]  # [S, 64, B]
                cg = jnp.take_along_axis(
                    csrc, jnp.asarray(steps)[:, None, :], axis=0
                )  # [K_max, 64, B]
                cm = jnp.asarray(mask)[:, None, :]
                zero8 = jnp.zeros((), dtype=cg.dtype)
                codes_tab = (
                    jnp.where(cm, cg, zero8)
                    if codes_tab is None
                    else jnp.where(cm, cg, codes_tab)
                )
        if layout == "perslice":
            return cols_tab, band_tab, lens_tab, pred_tab, codes_tab
        cols_tab = jnp.transpose(cols_tab, (1, 2, 0, 3)).reshape(
            7, B, K_max * cols_tab.shape[3]
        )
        return cols_tab, band_tab


    # ------------------------------------------------------- long-read walk
    def _walk_long(self, problems, lanes, keeps, walk_idx, chunk_rounds,
                   results):
        """Windowed backtrace for long-mode chunks: for each scan round
        (newest to oldest) the dropped columns are recomputed
        (_redispatch_round), lanes whose table ends in that window are
        started there, and the move-walk kernel runs with lane-state
        continuation across windows. The concatenated move streams decode
        exactly like the single-window walk."""
        import jax.numpy as jnp

        from ..io import native
        from ..ops.pallas import walk_moves as wm
        from .backtrace_device import _BT_MATCH

        B = len(lanes)
        Bp = max(128, -(-B // 128) * 128)
        INT_MAX = 2**62

        # per-lane straight segment chains [rnd, step0, n, g0, lane_in_round]
        lane_segs: dict = {}
        for i in list(walk_idx):
            recs = lanes[i].accepted[: int(keeps[i])]
            segs: list = []
            ok = True
            for rec in recs:
                if (
                    segs
                    and segs[-1][0] is rec.rnd
                    and rec.step == segs[-1][1] + segs[-1][2]
                    and rec.slice_i == segs[-1][3] + segs[-1][2]
                ):
                    segs[-1][2] += 1
                elif not segs or segs[-1][0] is not rec.rnd:
                    segs.append(
                        [rec.rnd, rec.step, 1, rec.slice_i, rec.lane_in_round]
                    )
                else:
                    ok = False
                    break
            if ok:
                g = 0
                for s_ in segs:
                    if s_[3] != g:
                        ok = False
                        break
                    g += s_[2]
            if not ok or not segs:
                # rewound chains (rare) lose their dropped columns; the
                # capacity-retry tier / host oracle picks the lane up
                lanes[i].failed = True
                lanes[i].cause = "dropped_round"
                continue
            lane_segs[i] = segs
        live = [i for i in walk_idx if i in lane_segs]
        if not live:
            return
        rounds = [
            r
            for r in chunk_rounds
            if any(any(s_[0] is r for s_ in lane_segs[i]) for i in live)
        ]

        bits_lut = np.zeros(_BT_MATCH.shape[0], dtype=np.int32)
        for g in range(5):
            bits_lut |= _BT_MATCH[:, g].astype(np.int32) << g
        seq_row = np.zeros((1, Bp), np.int32)
        seq_row[0, :B] = self._seq_lens
        seed_row = np.zeros((1, Bp), np.int32)
        seed_row[0, :B] = np.array([p[1] for p in problems], np.int32)
        state = np.zeros((16, Bp), np.int32)
        state[5] = 1  # idle until the lane's final window initializes it
        sw = np.zeros(B, dtype=np.int64)
        move_parts: list = []
        S_g = self._codes.shape[1] // WORD_SIZE
        codes_all = self._codes.reshape(B, S_g, WORD_SIZE)

        for rnd in reversed(rounds):
            segs_here = {
                i: s_
                for i in live
                for s_ in lane_segs[i]
                if s_[0] is rnd and not lanes[i].failed
            }
            if not segs_here:
                continue
            out = self._redispatch_round(rnd)
            K_w = max(s_[2] for s_ in segs_here.values())
            steps_map = np.zeros((K_w, B), np.int32)
            valid_map = np.zeros((K_w, B), bool)
            base = np.full(B, -(10**6), np.int32)
            lr = np.zeros(B, np.int32)
            for i, s_ in segs_here.items():
                _, step0, n, g0, lane_r = s_
                base[i] = g0
                lr[i] = lane_r
                steps_map[:n, i] = step0 + np.arange(n, dtype=np.int32)
                valid_map[:n, i] = True
            lr_d = jnp.asarray(lr)
            steps_d = jnp.asarray(steps_map)
            vm2 = jnp.asarray(valid_map)[:, None, :]

            def g3(dev, fill):
                src = dev[:, :, lr_d]  # [S, Nm, B]
                g = jnp.take_along_axis(src, steps_d[:, None, :], axis=0)
                return jnp.where(vm2, g, fill)

            band_w = g3(rnd.band_ids_dev, int(EMPTY))
            lens_w = g3(rnd.lens_tab_dev, 0)
            pred_w = g3(rnd.pred_tab_dev, 0)
            pprev_w = g3(rnd.pred_prev_dev, 0)
            cols_src = out["cols"][:, :, :, lr_d]  # [S, 7, Cm, B]
            cols_w = jnp.take_along_axis(
                cols_src, steps_d[:, None, None, :], axis=0
            )
            cols_w = jnp.where(jnp.asarray(valid_map)[:, None, None, :], cols_w, 0)

            # entry 0 (below-window neighbor): the previous segment's last
            # slice, from that round's stashed boundary columns
            prev0_cols = jnp.zeros((cols_w.shape[1], cols_w.shape[2], B), cols_w.dtype)
            prev0_band = jnp.full((band_w.shape[1], B), int(EMPTY), band_w.dtype)
            prev0_lens = jnp.zeros((band_w.shape[1], B), band_w.dtype)
            prev0_pred = jnp.zeros((band_w.shape[1], B), band_w.dtype)
            prev0_pprev = jnp.zeros((band_w.shape[1], B), band_w.dtype)
            by_prev: dict = {}
            for i, s_ in segs_here.items():
                segs = lane_segs[i]
                k = segs.index(s_)
                if k > 0:
                    p_ = segs[k - 1]
                    by_prev.setdefault(id(p_[0]), (p_[0], []))[1].append((i, p_))
            for prnd, pairs in by_prev.values():
                # boundary cols: locate each lane's segment end in the stash.
                # A miss (e.g. a rewind retroactively moved an older round's
                # segment end after its stash was taken) fails the lane to
                # the retry ladder instead of crashing the whole chunk.
                good_pairs = []
                reqpos = []
                for i, p_ in pairs:
                    hits = np.nonzero(
                        (prnd.last_lanes == p_[4])
                        & (prnd.last_steps == p_[1] + p_[2] - 1)
                    )[0]
                    if len(hits) == 0:
                        lanes[i].failed = True
                        lanes[i].cause = "dropped_round"
                        continue
                    good_pairs.append((i, p_))
                    reqpos.append(int(hits[0]))
                if not good_pairs:
                    continue
                pairs = good_pairs
                idxs = np.array([i for i, _ in pairs], np.int32)
                plast = np.array(
                    [p_[1] + p_[2] - 1 for _, p_ in pairs], np.int32
                )
                plane = np.array([p_[4] for _, p_ in pairs], np.int32)
                reqpos = np.array(reqpos, np.int32)
                pc = prnd.cols_last_dev[jnp.asarray(reqpos)]  # [n, 7, Cm]
                prev0_cols = prev0_cols.at[:, :, jnp.asarray(idxs)].set(
                    jnp.transpose(pc, (1, 2, 0))
                )
                pl_d = jnp.asarray(plast)
                pn_d = jnp.asarray(plane)
                prev0_band = prev0_band.at[:, jnp.asarray(idxs)].set(
                    jnp.transpose(prnd.band_ids_dev[pl_d, :, pn_d], (1, 0))
                )
                prev0_lens = prev0_lens.at[:, jnp.asarray(idxs)].set(
                    jnp.transpose(prnd.lens_tab_dev[pl_d, :, pn_d], (1, 0))
                )
                prev0_pred = prev0_pred.at[:, jnp.asarray(idxs)].set(
                    jnp.transpose(prnd.pred_tab_dev[pl_d, :, pn_d], (1, 0))
                )
                prev0_pprev = prev0_pprev.at[:, jnp.asarray(idxs)].set(
                    jnp.transpose(prnd.pred_prev_dev[pl_d, :, pn_d], (1, 0))
                )
            cols_w = jnp.concatenate([prev0_cols[None], cols_w], axis=0)
            band_w = jnp.concatenate([prev0_band[None], band_w], axis=0)
            lens_w = jnp.concatenate([prev0_lens[None], lens_w], axis=0)
            pred_w = jnp.concatenate([prev0_pred[None], pred_w], axis=0)
            pprev_w = jnp.concatenate([prev0_pprev[None], pprev_w], axis=0)

            # lanes whose table ENDS in this window start walking here
            starters = [
                i
                for i, s_ in segs_here.items()
                if s_[3] + s_[2] == int(keeps[i]) and not lanes[i].failed
            ]
            if starters:
                fin_step = np.array(
                    [segs_here[i][1] + segs_here[i][2] - 1 for i in starters],
                    np.int32,
                )
                fin_lane = np.array([segs_here[i][4] for i in starters], np.int32)
                fs = np.asarray(
                    out["sends"][jnp.asarray(fin_step), :, jnp.asarray(fin_lane)]
                )
                fb = np.asarray(
                    rnd.band_ids_dev[jnp.asarray(fin_step), :, jnp.asarray(fin_lane)]
                )
                final_sends = np.zeros((B, self.Cm), np.int32)
                final_band = np.full((B, self.Nm), int(EMPTY), np.int32)
                final_sends[starters] = fs
                final_band[starters] = fb
                try:
                    starts = self._walk_starts(
                        problems, lanes, keeps, starters, final_sends,
                        final_band,
                    )
                except AssertionError:
                    for i in starters:
                        lanes[i].failed = True
                    starts = []
                    starters = []
                for i, s0_ in zip(starters, starts):
                    if s0_ is None:
                        lanes[i].failed = True
                        continue
                    w0, slot0, off0 = s0_
                    sw[i] = w0
                    state[0, i] = int(keeps[i])
                    state[1, i] = 63
                    state[2, i] = slot0
                    state[3, i] = off0
                    state[4, i] = lanes[i].accepted[int(keeps[i]) - 1].min_score
                    state[5, i] = 0
                    state[6, i] = 0
                    state[7, i] = 1
                    state[8:16, i] = 0

            # pad lanes to Bp and run the window
            def padB(a, fill):
                if a.shape[-1] == Bp:
                    return a
                pw = [(0, 0)] * (a.ndim - 1) + [(0, Bp - a.shape[-1])]
                return jnp.pad(a, pw, constant_values=fill)

            base_row = np.full((1, Bp), -(10**6), np.int32)
            base_row[0, :B] = base
            codes_rows = np.clip(
                base[:, None] + np.arange(K_w + 1, dtype=np.int32)[None, :] - 1,
                0,
                S_g - 1,
            )
            codes8_w = np.ascontiguousarray(
                codes_all[np.arange(B)[:, None], codes_rows].transpose(1, 2, 0)
            )
            if Bp != B:
                codes8_w = np.pad(codes8_w, ((0, 0), (0, 0), (0, Bp - B)))
            moves_dev, fail_dev, state_dev, _used_dev = wm.walk_moves(
                padB(cols_w, 0),
                padB(band_w, int(EMPTY)),
                padB(lens_w, 0),
                padB(pred_w, 0),
                padB(pprev_w, 0),
                codes8_w,
                bits_lut,
                seq_row,
                seed_row,
                base_row,
                state,
                K_in=self.tables.k_in,
                impl=self.kernels.long_walk,
                interpret=self.kernels.interpret,
            )
            state = np.asarray(state_dev).copy()
            fail = np.asarray(fail_dev)[0]
            for i in list(segs_here):
                if fail[i]:
                    lanes[i].failed = True
                    state[5, i] = 1
            move_parts.append(
                np.ascontiguousarray(np.asarray(moves_dev)).view(np.uint32)
            )

        moves = np.concatenate(move_parts, axis=0)
        t = self.tables
        node_start64 = np.ascontiguousarray(self.graph.node_start, dtype=np.int64)
        node_end64 = np.ascontiguousarray(self.graph.node_end, dtype=np.int64)
        pos2node = np.ascontiguousarray(t.pos_to_node)
        in_nbrs = np.ascontiguousarray(t.in_nbrs)
        final_live = [
            i for i in live if not lanes[i].failed and state[5, i] == 1
        ]
        for i in live:
            if not lanes[i].failed and state[5, i] != 1:
                lanes[i].failed = True  # never finished across all windows

        def decode_one(i):
            try:
                return native.decode_moves(
                    np.ascontiguousarray(moves[:, i]),
                    int(sw[i]),
                    int(keeps[i]) * WORD_SIZE - 1,
                    node_start64,
                    node_end64,
                    pos2node,
                    in_nbrs,
                    int(keeps[i]) * WORD_SIZE * 3 + 64,
                )
            except ValueError:
                return False

        decoded = list(_decode_pool().map(decode_one, final_live))
        for i, arr in zip(final_live, decoded):
            lane = lanes[i]
            if arr is False or arr is None or len(arr) < 1 or arr[0, 1] != 0:
                lane.failed = True
                continue
            score = lane.accepted[int(keeps[i]) - 1].min_score
            cells = sum(
                r.num_cells for r in lane.accepted[: int(keeps[i])]
            ) * WORD_SIZE
            results[i] = (score, arr, int(keeps[i]), cells)

    # ------------------------------------------------------------- device round
    @staticmethod
    def _ffd_pack(sizes, cap, opens):
        """First-fit-decreasing packing of request slice-counts into
        lanes of `cap` steps. opens[r] forces request r to open a fresh
        lane at step 0 (carried rewinds consume the init_* carry slot).
        Returns (lane_of, step0_of, n_lanes); deterministic."""
        order = sorted(range(len(sizes)), key=lambda r: (-sizes[r], r))
        fill = []  # per lane: used steps
        lane_of = [0] * len(sizes)
        step0_of = [0] * len(sizes)
        for r in order:
            n = max(1, sizes[r])
            if opens[r]:
                lane_of[r] = len(fill)
                step0_of[r] = 0
                fill.append(n)
                continue
            placed = False
            for l in range(len(fill)):
                if fill[l] + n <= cap:
                    lane_of[r] = l
                    step0_of[r] = fill[l]
                    fill[l] += n
                    placed = True
                    break
            if not placed:
                lane_of[r] = len(fill)
                step0_of[r] = 0
                fill.append(n)
        return lane_of, step0_of, max(1, len(fill))

    def _dispatch_round(self, problems, codes, seq_lens, requests, S_max):
        """Pack the requests' slice ranges into scan lanes (many problems
        per lane, back to back — segment starts reset the carry in-scan)
        and dispatch one banded_scan round."""
        nreq = len(requests)
        # long mode: a request covers at most one window of slices; the
        # replay walks off the chain's end and re-requests the remainder
        # with a carry (the same mechanism rewinds use)
        sizes = [
            min(S_max, max(0, (len(problems[i][0]) // WORD_SIZE) - st))
            for (i, st, _, _) in requests
        ]
        opens = [carry != "init" for (_, _, carry, _) in requests]
        lane_of, step0_of, n_lanes = self._ffd_pack(sizes, S_max, opens)
        # few batch buckets only (compile cost, see _start_run)
        if n_lanes <= 32:
            B = 32
        elif n_lanes <= 256:
            B = 256
        else:
            B = 512
            while B < n_lanes:
                B *= 2
        if self.mesh is not None:
            nd = self.mesh.devices.size
            B = -(-B // nd) * nd  # shard_map needs the batch axis divisible
        bw = np.full((S_max, B), self.initial_bandwidth, dtype=np.int32)
        codes_lane = np.full(
            (B, S_max * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8
        )
        seg_active = np.zeros((S_max, B), dtype=np.int32)
        seg_first = np.zeros((S_max, B), dtype=np.int32)
        seg_slen = np.zeros((S_max, B), dtype=np.int32)
        seg_rnode = np.full((S_max, B), -1, dtype=np.int32)
        seg_rlen = np.zeros((S_max, B), dtype=np.int32)
        seg_start_mask = np.zeros((S_max, B), dtype=bool)
        init_ids = np.full((B, self.Nm), EMPTY, dtype=np.int32)
        init_send = np.full((B, self.Cm), INF, dtype=np.int32)
        init_nmin = np.full((B, self.Nm), INF, dtype=np.int32)
        init_nend = np.full((B, self.Nm), INF, dtype=np.int32)
        init_min = np.zeros(B, dtype=np.int32)

        carry_groups: dict = {}  # id(rnd) -> (rnd, [(lane, rec)])
        req_meta = []
        for pos, (i, st, carry, ramp_until) in enumerate(requests):
            l, s0, n = lane_of[pos], step0_of[pos], sizes[pos]
            req_meta.append((l, s0, n))
            codes_lane[l, s0 * WORD_SIZE : (s0 + n) * WORD_SIZE] = codes[
                i, st * WORD_SIZE : (st + n) * WORD_SIZE
            ]
            seg_active[s0 : s0 + n, l] = 1
            seg_slen[s0 : s0 + n, l] = seq_lens[i]
            seg_start_mask[s0, l] = True
            if st == 0:
                seg_first[s0, l] = 1
            hi = min(n, ramp_until - st + 1)
            if hi > 0:
                bw[s0 : s0 + hi, l] = self.ramp_bandwidth
            if carry == "init":
                node = problems[i][1]
                seg_rnode[s0, l] = node
                seg_rlen[s0, l] = int(self.tables.node_len[node])
            else:
                rec: _Rec = carry
                carry_groups.setdefault(id(rec.rnd), (rec.rnd, []))[1].append(
                    (l, rec)
                )
                init_min[l] = rec.min_score
        # rewind carries: one batched device gather + fetch per source
        # round (instead of one fetch per lane)
        import jax.numpy as jnp

        for rnd_src, recs in carry_groups.values():
            steps_a = jnp.asarray(np.array([r.step for _, r in recs]))
            lanes_a = jnp.asarray(
                np.array([r.lane_in_round for _, r in recs])
            )
            packed = np.asarray(
                jnp.concatenate(
                    [
                        rnd_src.band_ids_dev[steps_a, :, lanes_a],
                        rnd_src.node_min_dev[steps_a, :, lanes_a],
                        rnd_src.node_end_dev[steps_a, :, lanes_a],
                        rnd_src.sends_dev[steps_a, :, lanes_a],
                    ],
                    axis=1,
                )
            )  # [n, 3*Nm + Cm]
            Nm = self.Nm
            for j, (l, _) in enumerate(recs):
                init_ids[l] = packed[j, :Nm]
                init_nmin[l] = packed[j, Nm : 2 * Nm]
                init_nend[l] = packed[j, 2 * Nm : 3 * Nm]
                init_send[l] = packed[j, 3 * Nm :]

        zeros_b = np.zeros(B, dtype=np.int32)
        out = banded_scan(
            *self._device_args(),
            codes_lane,
            zeros_b,  # seq_len (per-lane scalar; unused in segmented mode)
            zeros_b,  # num_steps (unused)
            zeros_b,  # start_slice (unused)
            bw,
            init_ids,
            init_send,
            init_nmin,
            init_nend,
            init_min,
            S_max=S_max,
            Nm=self.Nm,
            Cm=self.Cm,
            # pairwise rank-select dedup measured fastest (sort-based
            # equal; 2-hop was slower BEFORE the packed exp_tbl gather —
            # GA_PROJ=pairwise2 re-tests it; GA_PROJ=reach replaces the
            # loop with a precomputed-table lookup); the while_loop exits
            # at the ~9-12 hops this workload needs
            _proj=self._proj,
            reach=self._reach,
            tie8=self._tie8,
            seg=(seg_active, seg_first, seg_slen, seg_rnode, seg_rlen),
            mesh=self.mesh,
            mesh_axis=self.mesh_axis,
            cell=self.kernels.cell,
            interpret=self.kernels.interpret,
        )
        # enqueue host copies now: they run right after the scan on the
        # device timeline and overlap whatever is dispatched next, so the
        # later np.asarray calls return without paying transfer latency.
        # tie16 is ADAPTIVE: the full [S, Nm, B] round is ~5MB of
        # transfer but only multi-node score ties consume it (~35% of walk
        # lanes on longsim, ~75% on sim) — when the observed multi-node
        # tie rate is low, skip the eager full fetch and let _walk_starts
        # pull per-lane columns instead (fetch_tie16_lanes).
        eager = ("control", "tie16", "ids_sub")
        if self._mn_tie_rate <= 0.4:
            eager = ("control", "ids_sub")
        for key in eager:
            arr = out.get(key)
            if arr is not None and hasattr(arr, "copy_to_host_async"):
                try:
                    arr.copy_to_host_async()
                except Exception:
                    pass
        scan_inputs = (
            codes_lane, bw, init_ids, init_send, init_nmin, init_nend,
            init_min, (seg_active, seg_first, seg_slen, seg_rnode, seg_rlen),
            S_max,
        )
        return (out, requests, req_meta, seg_start_mask, bw, scan_inputs)

    @staticmethod
    def _unpack_control(ctrl, init_min, seg_active, seg_rnode):
        """Host mirror of the engine's packed-control reconstruction
        (engine_banded: delta|cells<<7|ovf_bits<<28 per (step, lane); keep
        in sync): absolute minima = delta cumsum with resets at fresh-
        problem segment starts and init_min as each lane's carry base.
        Returns the [S, 3, B] (min_score, num_cells, overflow bits)
        triple."""
        delta = (ctrl & 127).astype(np.int32)
        cells = ((ctrl >> 7) & 0x1FFFFF).astype(np.int32)
        ovf = ((ctrl >> 28) & 7).astype(np.int32)
        S, B = ctrl.shape
        cs = np.cumsum(delta, axis=0, dtype=np.int32)
        reset = seg_rnode >= 0
        idx = np.where(reset, np.arange(S, dtype=np.int32)[:, None], -1)
        last_reset = np.maximum.accumulate(idx, axis=0)
        prev_cs = np.concatenate(
            [np.zeros((1, B), np.int32), cs[:-1]], axis=0
        )
        base = np.where(
            last_reset >= 0,
            -np.take_along_axis(prev_cs, np.maximum(last_reset, 0), axis=0),
            init_min[None, :].astype(np.int32),
        )
        ms = np.where(seg_active == 1, cs + base, np.int32(INF))
        return np.stack([ms, cells, ovf], axis=1)

    def _finish_round(self, pend) -> _Round:
        """Block on a dispatched round's control triple and wrap it."""
        out, requests, req_meta, seg_start_mask, bw, scan_inputs = pend
        init_min_h = scan_inputs[6]
        seg_active_h, _, _, seg_rnode_h, _ = scan_inputs[7]
        rnd = _Round(
            lanes=[r[0] for r in requests],
            start_slice=np.array([r[1] for r in requests], dtype=np.int32),
            num_steps=np.array([m[2] for m in req_meta], dtype=np.int32),
            control=self._unpack_control(
                np.asarray(out["control"]), init_min_h, seg_active_h,
                seg_rnode_h,
            ),
            band_ids_dev=out["band_ids"],
            node_min_dev=out["node_min"],
            node_end_dev=out["node_end"],
            lens_tab_dev=out["lens_tab"],
            pred_tab_dev=out["pred_tab"],
            cols_dev=out["cols"],
            sends_dev=out["sends"],
            tie16_dev=out["tie16"],
            ids_sub_dev=out.get("ids_sub"),
            codes_dev=out.get("codes"),
            pred_prev_dev=out.get("pred_prev"),
        )
        rnd._bw = bw
        rnd._carry_from = [r[2] for r in requests]
        rnd.req_meta = req_meta
        rnd.req_start = rnd.start_slice
        rnd._seg_start = seg_start_mask
        rnd._scan_inputs = scan_inputs if self._long_mode else None
        return rnd

    def _redispatch_round(self, rnd):
        """Re-run a long-mode round from its stashed inputs: banded_scan
        is deterministic, so the recomputed columns equal the dropped
        ones bit for bit (the reference's getSlicesFromTable recompute,
        GraphAligner.h:2858-2943)."""
        (codes_lane, bw, init_ids, init_send, init_nmin, init_nend,
         init_min, seg, S_max) = rnd._scan_inputs
        zeros_b = np.zeros(codes_lane.shape[0], dtype=np.int32)
        return banded_scan(
            *self._device_args(),
            codes_lane,
            zeros_b,
            zeros_b,
            zeros_b,
            bw,
            init_ids,
            init_send,
            init_nmin,
            init_nend,
            init_min,
            S_max=S_max,
            Nm=self.Nm,
            Cm=self.Cm,
            _proj=self._proj,
            reach=self._reach,
            tie8=self._tie8,
            seg=seg,
            mesh=self.mesh,
            mesh_axis=self.mesh_axis,
            cell=self.kernels.cell,
            interpret=self.kernels.interpret,
        )

    def _stash_round_boundary(self, rnd, overrides=None):
        """Before a long-mode round's columns are dropped: keep each
        request's LAST ACCEPTED slice columns (the below-window neighbor
        the next window's walk needs) as a small [nreq, 7, Cm] gather.
        `overrides` maps lane_in_round -> accepted cut step for requests
        the control replay cut mid-window (HMM break / ramp rewind)."""
        import jax.numpy as jnp

        overrides = overrides or {}
        steps = np.array(
            [overrides.get(l, s0 + n - 1) for (l, s0, n) in rnd.req_meta],
            dtype=np.int32,
        )
        lanes_ = np.array([l for (l, _, _) in rnd.req_meta], dtype=np.int32)
        rnd.cols_last_dev = rnd.cols_dev[
            jnp.asarray(steps), :, :, jnp.asarray(lanes_)
        ]
        rnd.last_steps = steps
        rnd.last_lanes = lanes_

    def _replay_bulk(self, lanes, requests, rnd):
        """Vectorized fast path of the getSqrtSlices replay for round-1
        'init' lanes: the HMM chain is a per-lane float64 recurrence
        (bit-identical op order to hmm.CorrectnessState.next_state), so
        all lanes advance in one numpy sweep. Lanes whose chain hits an
        overflow, a possible ramping rewind, or any irregularity are
        left untouched for the literal scalar replay below."""
        import math

        S, B = rnd.min_score.shape
        ms = rnd.min_score.astype(np.float64)
        seg0 = rnd._seg_start  # [S, B] bool: a fresh problem starts here
        prev = np.concatenate([np.zeros((1, B)), ms[:-1]], axis=0)
        prev = np.where(seg0, 0.0, prev)  # each segment's chain starts at 0
        delta = np.clip((ms - prev).astype(np.int64), 0, WORD_SIZE)
        lut = np.asarray(_hmm._LOG_FACTORIALS)
        log_choose = lut[WORD_SIZE] - lut[delta] - lut[WORD_SIZE - delta]
        c = np.full(B, math.log(0.8))
        f = np.full(B, math.log(0.2))
        CFC = np.zeros((S, B), bool)
        FFC = np.zeros((S, B), bool)
        CUR = np.zeros((S, B), bool)
        lp8, lp2 = math.log(0.8), math.log(0.2)
        for k in range(S):
            # segment boundary: the HMM restarts from its priors (each
            # packed problem is an independent getSqrtSlices chain)
            if seg0[k].any():
                c = np.where(seg0[k], lp8, c)
                f = np.where(seg0[k], lp2, f)
            CFC[k] = c + _hmm._CORRECT_TO_CORRECT >= f + _hmm._FALSE_TO_CORRECT
            FFC[k] = c + _hmm._CORRECT_TO_FALSE >= f + _hmm._FALSE_TO_FALSE
            nc = np.maximum(
                c + _hmm._CORRECT_TO_CORRECT, f + _hmm._FALSE_TO_CORRECT
            )
            nf = np.maximum(
                c + _hmm._CORRECT_TO_FALSE, f + _hmm._FALSE_TO_FALSE
            )
            d = delta[k]
            nc = nc + log_choose[k] + d * _hmm._CORRECT_MISMATCH + (
                WORD_SIZE - d
            ) * _hmm._CORRECT_MATCH
            nf = nf + log_choose[k] + d * _hmm._FALSE_MISMATCH + (
                WORD_SIZE - d
            ) * _hmm._FALSE_MATCH
            c, f = nc, nf
            CUR[k] = c > f
        ramping = self.ramp_bandwidth > self.initial_bandwidth
        for pos, (i, st, carry, ramp_until) in enumerate(requests):
            lane = lanes[i]
            if carry != "init" or st != 0 or ramp_until != 0:
                continue
            l, s0, n = rnd.req_meta[pos]
            if n == 0 or n < lane.num_slices:
                continue
            if rnd.overflow[s0 : s0 + n, l].any():
                continue  # the scalar replay reports the failure
            notcfc = ~CFC[s0 : s0 + n, l]
            stop = int(np.argmax(notcfc)) if notcfc.any() else n
            if ramping and (~CUR[s0 : s0 + min(stop + 1, n), l]).any():
                continue  # a rewind may fire; take the literal path
            recs = lane.chain[:stop]
            lane.accepted = recs
            lane.bandwidths = [r.bandwidth for r in recs]
            lane.corr_list = [
                _corr_flags(
                    bool(CFC[s0 + k, l]),
                    bool(FFC[s0 + k, l]),
                    bool(CUR[s0 + k, l]),
                )
                for k in range(stop)
            ]
            lane.cursor = stop
            lane.slice_i = stop
            lane.done = True

    # ---------------------------------------------------------------- replay
    def _replay(self, lane: _LaneState):
        """Advance the literal getSqrtSlices control flow against the
        lane's recorded chain. Returns None when the lane finished, or a
        (start_slice, carry_ref, ramp_until) request for the next round."""
        while lane.slice_i < lane.num_slices:
            bandwidth = (
                self.ramp_bandwidth
                if lane.ramp_until >= lane.slice_i
                else self.initial_bandwidth
            )
            # find the next chain record matching (slice_i, bandwidth)
            rec = lane.chain[lane.cursor] if lane.cursor < len(lane.chain) else None
            pred_ok = rec is not None and (
                (lane.cursor > 0 and lane.chain[lane.cursor - 1] is lane.last)
                or (lane.cursor == 0 and self._carry_matches(rec, lane.last))
            )
            if (
                rec is None
                or rec.slice_i != lane.slice_i
                or rec.bandwidth != bandwidth
                or not pred_ok
            ):
                return (lane.slice_i, lane.last, lane.ramp_until)
            if rec.overflow:
                lane.failed = True
                lane.cause = _overflow_cause(rec.overflow)
                return None
            lane.cursor += 1

            last_min = 0 if lane.last == "init" else lane.last.min_score
            delta = rec.min_score - last_min
            assert 0 <= delta <= WORD_SIZE, (delta, rec.slice_i)
            correctness = lane.correctness.next_state(delta, WORD_SIZE)
            rec_corr = correctness

            last_cells = 0 if lane.last == "init" else lane.last.num_cells
            if (
                lane.ramp_until == lane.slice_i
                and rec.num_cells >= BACKTRACE_OVERRIDE_CUTOFF
            ):
                lane.ramp_until += 1
            if (
                lane.ramp_until == lane.slice_i - 1
                or (
                    lane.ramp_until < lane.slice_i
                    and correctness.currently_correct()
                    and correctness.false_from_correct()
                )
            ) and last_cells < BACKTRACE_OVERRIDE_CUTOFF:
                lane.ramp = lane.last
                lane.ramp_redo_index = lane.slice_i - 1

            if not correctness.correct_from_correct():
                lane.correctness = correctness
                break
            if (
                not correctness.currently_correct()
                and lane.ramp_until < lane.slice_i
                and self.ramp_bandwidth > self.initial_bandwidth
            ):
                # rewind (literal swap quirk, GraphAligner.h:2664-2666)
                global _REWIND_COUNT
                _REWIND_COUNT += 1
                lane.ramp_until = lane.slice_i
                lane.slice_i, lane.ramp_redo_index = (
                    lane.ramp_redo_index,
                    lane.slice_i,
                )
                lane.last, lane.ramp = lane.ramp, lane.last
                del lane.bandwidths[lane.slice_i + 1 :]
                del lane.corr_list[lane.slice_i + 1 :]
                while (
                    len(lane.accepted) > 0
                    and lane.accepted[-1].slice_i > lane.slice_i
                ):
                    lane.accepted.pop()
                # correctness must continue from the rewound-to slice
                lane.correctness = (
                    lane.corr_list[lane.slice_i]
                    if 0 <= lane.slice_i < len(lane.corr_list)
                    else CorrectnessState()
                )
                lane.slice_i += 1
                continue

            assert len(lane.bandwidths) == lane.slice_i
            lane.bandwidths.append(bandwidth)
            lane.corr_list.append(rec_corr)
            lane.accepted.append(rec)
            lane.correctness = correctness
            lane.last = rec
            lane.slice_i += 1
        lane.done = True
        return None

    @staticmethod
    def _carry_matches(rec: _Rec, last) -> bool:
        """Is the request that produced `rec` seeded from `last`?"""
        r = rec.req_i
        if int(rec.rnd.req_start[r]) != rec.slice_i:
            return False
        if last == "init":
            return rec.slice_i == 0 and rec.rnd._carry_from[r] == "init"
        return rec.rnd._carry_from[r] is last

    # ---------------------------------------------------------- reconstruction
    def _build_table(self, problem, lane: _LaneState) -> DPTable:
        seq, start_node = problem
        table = DPTable(slices=[make_initial_slice_one_node(self.graph, start_node)])
        table.bandwidth_per_slice = list(lane.bandwidths)
        table.correctness = list(lane.corr_list)

        # remove_wrongly_aligned_end replay (GraphAligner.h:2554-2569)
        currently_correct = (
            table.correctness[-1].currently_correct() if table.correctness else False
        )
        while not currently_correct:
            if not table.correctness:
                break
            table.correctness.pop()
            table.bandwidth_per_slice.pop()
            if not table.correctness:
                break
            currently_correct = table.correctness[-1].false_from_correct()
        keep = len(table.correctness)
        if keep == 0:
            table.slices = []
            return table
        accepted = lane.accepted[:keep]

        # reproduce the reference band-insertion order chain for tie-breaking
        orders = self._band_orders(start_node, accepted, lane.bandwidths[:keep])
        for idx, rec in enumerate(accepted):
            final = idx == len(accepted) - 1
            table.slices.append(
                self._reconstruct(rec, orders[idx], with_min_index=final)
            )
        return table

    def _tie_chain_inputs(self, accepted):
        """Device tie rows for one lane's accepted chain, as the native
        chain replay consumes them: tie [K, 3, Nm] int32 (plane 0 =
        subsampled band-row hash in slot 0, planes 1/2 = decoded
        node_min/node_end), check [K] uint8, min_scores [K] int32."""
        K = len(accepted)
        Nm = self.Nm
        tie = np.zeros((K, 3, Nm), np.int32)
        check = np.zeros(K, np.uint8)
        r0 = accepted[0]
        straight = all(
            rec.rnd is r0.rnd
            and rec.lane_in_round == r0.lane_in_round
            and rec.step == r0.step + k
            for k, rec in enumerate(accepted)
        )
        if straight:
            # the common no-rewind chain: one contiguous slab view
            # (steps s0..s0+K of the packed lane)
            lr = r0.lane_in_round
            s0 = r0.step
            traw = r0.rnd.tie16_lane(lr)[s0 : s0 + K]
            ms = r0.rnd.min_score[s0 : s0 + K, lr].astype(np.int64)
            tie[:, 1], tie[:, 2] = _decode_tie(traw, ms[:, None])
            # subsampled band-HASH checks exist at absolute steps = 0 mod 8
            k0 = (-s0) % 8
            sub = r0.rnd.tie_ids_sub[
                (s0 + k0) // 8 : (s0 + K + 7) // 8, lr
            ]
            tie[k0 : k0 + sub.shape[0] * 8 : 8, 0, 0] = sub
            check[k0::8] = 1
            ms = ms.astype(np.int32)
        else:
            ms = np.zeros(K, np.int32)
            for k, rec in enumerate(accepted):
                traw = rec.rnd.tie16_lane(rec.lane_in_round)[rec.step]
                tie[k, 1], tie[k, 2] = _decode_tie(traw, rec.min_score)
                ms[k] = rec.min_score
                if rec.step % 8 == 0:
                    tie[k, 0, 0] = rec.rnd.tie_ids_sub[
                        rec.step // 8, rec.lane_in_round
                    ]
                    check[k] = 1
        return tie, check, ms

    def _band_orders(self, start_node, accepted, bandwidths):
        """Replay the reference's band-insertion-order chain (needed for
        min_score_index tie-breaking): each slice's projection consumes
        the previous slice's insertion ORDER plus the device-computed
        scores, mapped from topo-sorted slot order by an argsort."""
        g = self.graph
        topo = self.tables.topo_rank
        from ..io import native
        from .params import ALTERNATE_METHOD_CUTOFF

        if native.get_lib() is not None and accepted:
            tie, check, ms = self._tie_chain_inputs(accepted)
            orders = native.band_orders(
                tie,
                ms,
                list(bandwidths),
                start_node,
                g,
                topo,
                ALTERNATE_METHOD_CUTOFF,
                int(EMPTY),
                check,
            )
            if orders is not None:
                return [list(o) for o in orders]
        nodes = [start_node]
        nmin = np.zeros(1, dtype=np.int64)
        nend = np.zeros(1, dtype=np.int64)
        mins = 0
        orders = []
        for rec, bwv in zip(accepted, bandwidths):
            order = project_forward_from_arrays(g, nodes, nmin, nend, mins, bwv)
            orders.append(order)
            tie = rec.rnd.tie_data[rec.step, :, :, rec.lane_in_round]
            order_arr = np.asarray(order, dtype=np.int64)
            k = len(order_arr)
            perm = np.argsort(topo[order_arr], kind="stable")
            assert np.array_equal(order_arr[perm], tie[0, :k]), (
                f"host/device band mismatch at slice {rec.slice_i}"
            )
            inv = np.empty(k, dtype=np.int64)
            inv[perm] = np.arange(k)
            nodes = order_arr
            nmin = tie[1, :k][inv]
            nend = tie[2, :k][inv]
            mins = rec.min_score
        return orders

    def _reconstruct(
        self, rec: _Rec, band_order, with_min_index: bool
    ) -> SliceScores:
        g = self.graph
        ids = rec.band_ids()
        order, lens, offs = _cell_layout(self.tables, ids)
        cols = rec.cols()
        sbs_d, sbs_e, rows_d, ee, node_min = {}, {}, {}, {}, {}
        for n, L, off in zip(order, lens, offs):
            seg = cols[off : off + L]
            rows = unpack_deltas_np(
                seg[:, 0].astype(np.uint32),
                seg[:, 1].astype(np.uint32),
                seg[:, 2].astype(np.uint32),
                seg[:, 3].astype(np.uint32),
                seg[:, 4],
            ).T  # [64, L]
            n = int(n)
            rows_d[n] = rows
            sbs_d[n] = seg[:, 4].astype(np.int64)
            sbs_e[n] = (seg[:, 6] & 1).astype(bool)
            ee[n] = np.ones(L, dtype=bool)
            node_min[n] = int(rows[WORD_SIZE - 1].min())
        min_index = []
        if with_min_index:
            comps = _banded_tarjan(g, list(band_order), {n: True for n in band_order})
            best = rec.min_score
            for comp in reversed(comps):
                for n in reversed(comp):
                    if node_min[n] == best:
                        startp = int(g.node_start[n])
                        for k in range(int(g.node_len[n])):
                            if rows_d[n][WORD_SIZE - 1, k] == best:
                                min_index.append(startp + k)
        s = SliceScores(
            j=rec.slice_i * WORD_SIZE,
            nodes=list(band_order),
            sbs=sbs_d,
            sbs_exists=sbs_e,
            rows=rows_d,
            end_exists=ee,
            min_score=rec.min_score,
            min_score_index=min_index,
            node_min=node_min,
            bandwidth=rec.bandwidth,
            num_cells=rec.num_cells,
            cells_processed=rec.num_cells * WORD_SIZE,
        )
        return s


# =========================================================================
# Batched seed-and-extend orchestration (reference AlignOneWay seeded,
# GraphAligner.h:408-491): one seed per read per wave, so the sequential
# "skip seeds inside already-aligned regions" rule (420-429) is preserved
# exactly while all reads' DP extensions run batched on device.
# =========================================================================


def seed_extension_problems(graph: AlignmentGraph, sequence: str, seed):
    """The two extension problems one seed spawns (reference
    getSplitAlignment, GraphAligner.h:2969-3024): the RC'd backward
    prefix (seeded at the opposite-orientation node, extended by
    dbg_overlap) and the forward suffix. Returns (bw, fw), each a
    (padded_sequence, start_node_index) pair or None when that side is
    empty. Shared by align_reads_seeded_batch and tools/probe_scan so
    the probe always measures the production workload."""
    from ..io.sequences import reverse_complement

    node_id, pos, reverse = seed
    if reverse:
        fw_node = graph.node_lookup[node_id * 2 + 1]
        bw_node = graph.node_lookup[node_id * 2]
    else:
        fw_node = graph.node_lookup[node_id * 2]
        bw_node = graph.node_lookup[node_id * 2 + 1]
    bw = fw = None
    if pos > 0:
        bw = (
            _pad_to_word(
                reverse_complement(sequence[: pos + graph.dbg_overlap])
            ),
            bw_node,
        )
    if pos < len(sequence) - 1:
        fw = (_pad_to_word(sequence[pos:]), fw_node)
    return bw, fw


def align_reads_seeded_batch(
    graph: AlignmentGraph,
    aligner: BandedBatchAligner,
    reads,
    seed_map: dict,
    logger=None,
):
    """reads: [FastQ]; seed_map: seq_id -> [(node_id, pos, reverse)].
    Returns {seq_id: AlignmentResult} identical to align_one_way_seeded.

    Chunk results are consumed as they STREAM off the device: each wave
    entry is assembled the moment both of its extension pieces have
    walked, and a read with no seeds left is finalized immediately — so
    the trace/merge/alignment host work overlaps later chunks' scans."""
    import time as _time

    from . import trace_ops
    from .align import (
        get_piecewise_traces_from_split,
        get_split_alignment,
        get_trace_info,
    )
    from .result import AlignmentResult, LazyAlignment, LazyTrace, empty_alignment

    def as_arr(t):
        return np.asarray(t, dtype=np.int64).reshape(-1, 2)

    INT_MAX = 2**62

    # native per-piece trace finalize context (ga_trace_piece): the
    # contiguous graph tables are hoisted out of the per-read loop
    from ..io import native as _nat

    _tp_lib = _nat.get_lib() is not None
    _p2n = np.ascontiguousarray(graph.pos_to_node)
    _nstart = np.ascontiguousarray(graph.node_start, dtype=np.int64)
    _nids = np.ascontiguousarray(graph.node_ids, dtype=np.int64)
    _revf = np.ascontiguousarray(graph.reverse.astype(np.uint8))
    _rev_pos_c = np.ascontiguousarray(aligner.rev_pos, dtype=np.int64)

    _tp_ctx = (
        _nat.TracePieceCtx(
            _rev_pos_c, _p2n, _nstart, _nids, _revf,
            graph.dummy_node_start, graph.dummy_node_end,
        )
        if _tp_lib
        else None
    )

    def tp_native(trace, trim, rev, end_row, shift):
        """(final_trace, runs|None, tried triples) for one piece —
        native when available, else the trace_ops chain (identical
        semantics; the native path is a C port of these calls)."""
        if _tp_lib:
            return _tp_ctx.piece(trace, trim, rev, end_row, shift)
        t = trace_ops.trim_trace(as_arr(trace), trim)
        if rev:
            t = trace_ops.reverse_trace(aligner.rev_pos, t, end_row)
        elif shift:
            t = t.copy()
            t[:, 1] += shift
        runs = trace_ops.trace_to_runs(graph, t)
        tried: list = []
        if len(t):
            starts, nodes = trace_ops.trace_node_runs(graph, t)
            ends = np.concatenate([starts[1:], [len(t)]]) - 1
            tried = list(
                zip(
                    t[starts, 1].tolist(),
                    t[ends, 1].tolist(),
                    nodes.tolist(),
                )
            )
        return t, runs, tried

    t0 = _time.time()
    state = {}
    results: dict = {}
    for r in reads:
        seeds = seed_map.get(r.seq_id, [])
        state[r.seq_id] = {
            "read": r,
            "seeds": seeds,
            "cursor": 0,
            "tried": [],
            "best": None,  # (estimated, trace, seed)
        }

    def process_entry(s, seed, fw_i, bw_i, walked):
        """Assemble one wave entry (reference getPiecewiseTracesFromSplit,
        GraphAligner.h:3040-3098) and fold it into the read's best."""
        from ..io import native as _native

        _native.set_read(s["read"].seq_id)
        node_id, pos, reverse = seed
        sequence = s["read"].sequence
        cells = 0
        causes = {
            walked[x].cause
            for x in (fw_i, bw_i)
            if x is not None and isinstance(walked[x], HostFallback)
        }
        fb_needed = bool(causes)
        if fb_needed:
            cause = next(c for c in FALLBACK_CAUSES if c in causes)
            _FALLBACKS[cause] += 1
            if cause != "dropped_round" and (
                _os.environ.get("GA_NO_FALLBACK") == "1"
            ):
                # fail-loud mode: a host-oracle fallback silently masking
                # a device regression as a slowdown
                raise RuntimeError(
                    f"GA_NO_FALLBACK: read {s['read'].seq_id!r} seed "
                    f"{seed} fell back to the host oracle ({cause})"
                )
        if fb_needed:
            split = get_split_alignment(
                graph,
                sequence,
                node_id,
                reverse,
                pos,
                aligner.initial_bandwidth,
                aligner.ramp_bandwidth,
            )
            (f_sc, f_tr), (b_sc, b_tr) = get_piecewise_traces_from_split(
                graph, split, sequence
            )
            trace = ((f_sc, as_arr(f_tr)), (b_sc, as_arr(b_tr)))
            est = split.estimated_correctly_aligned()
            runs_pair = None  # finalize derives runs via trace_to_runs
            s["cells"] = s.get("cells", 0) + cells
            trace_ops.add_alignment_nodes(graph, s["tried"], trace)
        else:
            # native per-piece finalize (ga_trace_piece): trim +
            # reverse/shift + both run tables in one C call per piece
            # instead of the ~60-numpy-op Python chain. Bit-identical
            # port of trace_ops semantics.
            fw = (0, np.zeros((0, 2), np.int64))
            bw = (0, np.zeros((0, 2), np.int64))
            fw_runs = bw_runs = None
            keep_fw = keep_bw = 0
            bw_tried: list = []
            fw_tried: list = []
            if bw_i is not None:
                b_score, b_trace, keep_bw, b_cells = walked[bw_i]
                cells += b_cells
                if keep_bw > 0:
                    b_final, bw_runs, bw_tried = tp_native(
                        b_trace, pos, True, pos - 1, 0
                    )
                    bw = (b_score, b_final)
            if fw_i is not None:
                f_score, f_trace, keep_fw, f_cells = walked[fw_i]
                cells += f_cells
                if keep_fw > 0:
                    backtraceable = len(sequence) - pos - graph.dbg_overlap
                    f_final, fw_runs, fw_tried = tp_native(
                        f_trace, backtraceable, False, 0,
                        pos if keep_bw > 0 else 0,
                    )
                    fw = (f_score, f_final)
            trace = (fw, bw)
            est = (keep_fw + keep_bw) * WORD_SIZE
            runs_pair = (fw_runs, bw_runs)
            s["cells"] = s.get("cells", 0) + cells
            s["tried"].extend(fw_tried)
            s["tried"].extend(bw_tried)
        if s["best"] is None or est > s["best"][0]:
            s["best"] = (est, trace, seed, runs_pair)

    def finalize_read(seq_id, s):
        """The tail of align_one_way_seeded for one read."""
        elapsed = int((_time.time() - t0) * 1000)
        if s["best"] is None:
            return empty_alignment(elapsed, 0)
        est, trace, best_seed, runs_pair = s["best"]
        sequence = s["read"].sequence
        (fw_score, fw_trace), (bw_score, bw_trace) = trace
        if fw_score >= INT_MAX and bw_score >= INT_MAX:
            return empty_alignment(elapsed, 0)
        trace_vector = LazyTrace(
            lambda g=graph, sq=sequence, b=bw_trace, f=fw_trace: get_trace_info(
                g, sq, [tuple(x) for x in b], [tuple(x) for x in f]
            )
        )
        if runs_pair is not None:
            fw_runs, bw_runs = runs_pair  # native finalize (process_entry)
        else:
            fw_runs = trace_ops.trace_to_runs(graph, fw_trace)
            bw_runs = trace_ops.trace_to_runs(graph, bw_trace)
        if fw_runs is None and bw_runs is None:
            return empty_alignment(elapsed, 0)
        score = (bw_score if bw_runs is not None else 0) + (
            fw_score if fw_runs is not None else 0
        )
        runs = trace_ops.merge_runs(graph, bw_runs, fw_runs)
        last_aligned = int(bw_trace[0][1]) if len(bw_trace) else best_seed[1]
        result = AlignmentResult(
            alignment=LazyAlignment(
                graph, seq_id, sequence, score, last_aligned, runs
            ),
            alignment_failed=False,
            cells_processed=s.get("cells", 0),
            elapsed_milliseconds=elapsed,
        )
        result.trace = trace_vector
        result.alignment_start = last_aligned
        result.alignment_end = result.alignment_start + est
        return result

    active = [s for s in state.values() if s["seeds"]]
    while active:
        wave = []  # (state, seed, fw_problem_idx|None, bw_problem_idx|None)
        problems = []
        for s in active:
            seed = None
            while s["cursor"] < len(s["seeds"]):
                node_id, pos, reverse = s["seeds"][s["cursor"]]
                s["cursor"] += 1
                node_index = graph.node_lookup[node_id * 2]
                if any(
                    lo <= pos <= hi and n == node_index
                    for (lo, hi, n) in s["tried"]
                ):
                    if logger:
                        logger(f"seed {s['cursor'] - 1} already aligned")
                    continue
                seed = (node_id, pos, reverse)
                break
            if seed is None:
                continue
            bw, fw = seed_extension_problems(graph, s["read"].sequence, seed)
            fw_i = bw_i = None
            if bw is not None:
                bw_i = len(problems)
                problems.append(bw)
            if fw is not None:
                fw_i = len(problems)
                problems.append(fw)
            wave.append((s, seed, fw_i, bw_i))

        if not wave:
            break
        walked: dict = {}
        done_entries = [False] * len(wave)
        for batch in aligner.get_traces_stream(problems):
            walked.update(batch)
            for wi, (s, seed, fw_i, bw_i) in enumerate(wave):
                if done_entries[wi]:
                    continue
                need = [x for x in (fw_i, bw_i) if x is not None]
                if not all(x in walked for x in need):
                    continue
                done_entries[wi] = True
                process_entry(s, seed, fw_i, bw_i, walked)
                if s["cursor"] >= len(s["seeds"]):
                    sid = s["read"].seq_id
                    results[sid] = finalize_read(sid, s)
        assert all(done_entries)
        active = [s for s in active if s["cursor"] < len(s["seeds"])]

    for seq_id, s in state.items():
        if seq_id not in results:
            results[seq_id] = finalize_read(seq_id, s)
    return results
