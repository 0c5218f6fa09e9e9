"""Batched device alignment engine (v1: exhaustive mode).

Batched redesign of the reference's alignment core. Where the
reference packs 64 DP cells into one CPU word and processes one read per
thread (WordSlice.h, Aligner.cpp:290), this engine processes a *batch*
of reads at once: each graph-position step advances a [batch, 64] score
column with a handful of vector ops, so one vector op covers
batch × 64 cells. The 64-row column advance uses a prefix-min identity
instead of Myers' carry tricks:

    cur[r] = min_{k<=r}(base[k] + r - k)  =  cummin(base[k] - k)[r] + r

which runs all 64 rows of the vertical closure in parallel — the
batched equivalent of the reference's bit-parallel `getNextSlice`
(GraphAligner.h:1349-1427).

v1 computes in "exhaustive mode": every graph position is active in
every slice, i.e. banded semantics with unbounded bandwidth. This yields
guaranteed-optimal semiglobal alignments (equal to the oracle/brute
force with a huge bandwidth) with fully static shapes. The banded device
engine reuses this machinery with a fixed-capacity band (future work).

Graph positions are processed in topological order of the SCC
condensation via `lax.scan`; cyclic graphs converge through the
in-scan Bellman-Ford fixpoint over whole-slice passes (fix_cond /
fix_body below; non-convergence within the pass cap raises — there is
no silent host fallback). Slice results are stored
bit-packed (VP/VN uint32 pairs + boundary scores — the WordSlice storage
layout, NodeSlice.h:15-31) and handed to the unchanged host backtrace.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..graph.alignment_graph import AlignmentGraph
from ..io.sequences import IUPAC_MATCHES
from .hmm import CorrectnessState
from .oracle import SliceScores, _banded_tarjan
from .params import WORD_SIZE

INF = np.int32(1 << 30)

# read-character alphabet for device match tables
_READ_ALPHABET = "ACGTRYSWKMBDHVN"
_READ_CODE = {c: i for i, c in enumerate(_READ_ALPHABET)}
# match table [read code, graph code(5)] — graph code 4 = dummy, never matches
_MATCH_TABLE = np.zeros((len(_READ_ALPHABET), 5), dtype=bool)
for _c, _i in _READ_CODE.items():
    for _g, _base in enumerate("ATCG"):
        _MATCH_TABLE[_i, _g] = _base in IUPAC_MATCHES[_c]


_ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
for _c, _i in _READ_CODE.items():
    _ENCODE_LUT[ord(_c)] = _i
    _ENCODE_LUT[ord(_c.lower())] = _i


def build_eq_vectors(read_codes: np.ndarray, match_table: np.ndarray, num_slices: int):
    """Per-slice per-graph-code Eq bitvectors (reference BA/BT/BC/BG,
    GraphAligner.h:2337-2351), host-side, for the wavefront engine.

    read_codes [B, S*64] uint8 → eq [S, 5, 2, B] uint32 (lo, hi)."""
    B = read_codes.shape[0]
    eq = np.zeros((num_slices, 5, 2, B), dtype=np.uint32)
    match_rows = match_table[read_codes]  # [B, S*64, 5]
    bits_lo = (1 << np.arange(32, dtype=np.uint64)).astype(np.uint32)
    for s in range(num_slices):
        rows = match_rows[:, s * WORD_SIZE : (s + 1) * WORD_SIZE, :]  # [B,64,5]
        for c in range(5):
            eq[s, c, 0] = (rows[:, :32, c] * bits_lo).sum(axis=1, dtype=np.uint32)
            eq[s, c, 1] = (rows[:, 32:, c] * bits_lo).sum(axis=1, dtype=np.uint32)
    return eq


def encode_read(sequence: str) -> np.ndarray:
    codes = _ENCODE_LUT[np.frombuffer(sequence.encode("latin-1"), np.uint8)]
    if codes.max(initial=0) == 255:
        bad = sequence[int(np.argmax(codes == 255))]
        raise ValueError(f"unsupported read character {bad!r}")
    return codes


@dataclass
class DeviceSchedule:
    """Topologically-ordered column schedule + device graph arrays."""

    graph: AlignmentGraph
    cell_pos: np.ndarray  # [P] graph position per step
    code: np.ndarray  # [P] uint8 base code
    is_start: np.ndarray  # [P] bool
    is_source_start: np.ndarray  # [P] bool (node start with no in-edges)
    pred_nodes: np.ndarray  # [P, max_indeg] node slot of in-neighbors (-1 pad)
    node_slot: np.ndarray  # [P] node index
    pos_to_step: np.ndarray  # [graph bp] inverse of cell_pos
    num_nodes: int
    cyclic: bool = False


def build_schedule(graph: AlignmentGraph) -> DeviceSchedule:
    """Column schedule in SCC-condensation topological order. For
    cyclic graphs the order within a cyclic component is arbitrary;
    `_align_batch_device` then iterates whole-slice passes to the
    Bellman-Ford fixpoint (the reference's UniqueQueue recalculation
    loop for cyclic components, GraphAligner.h calculateSlice)."""
    order = [int(n) for n in graph.topo_node_order]
    cell_pos = []
    code = []
    is_start = []
    is_source_start = []
    pred_nodes = []
    node_slot = []
    max_indeg = max(1, int(np.diff(graph.in_ptr).max()))
    for n in order:
        start, end = int(graph.node_start[n]), int(graph.node_end[n])
        preds = [int(x) for x in graph.in_neighbors(n)]
        for w in range(start, end):
            cell_pos.append(w)
            code.append(int(graph.seq_codes[w]))
            first = w == start
            is_start.append(first)
            is_source_start.append(first and not preds)
            row = preds + [-1] * (max_indeg - len(preds)) if first else [-1] * max_indeg
            pred_nodes.append(row)
            node_slot.append(n)
    cell_pos = np.array(cell_pos, dtype=np.int32)
    pos_to_step = np.empty(graph.size_in_bp, dtype=np.int32)
    pos_to_step[cell_pos] = np.arange(len(cell_pos), dtype=np.int32)
    return DeviceSchedule(
        graph=graph,
        cell_pos=cell_pos,
        code=np.array(code, dtype=np.int32),
        is_start=np.array(is_start, dtype=bool),
        is_source_start=np.array(is_source_start, dtype=bool),
        pred_nodes=np.array(pred_nodes, dtype=np.int32),
        node_slot=np.array(node_slot, dtype=np.int32),
        pos_to_step=pos_to_step,
        num_nodes=graph.node_count,
        cyclic=bool(graph.comp_cyclic.any()),
    )


def _cummin_rows(x, ar_like):
    """Prefix-min along axis 0 (the 64-row axis) via log-shifts; rows are
    the major axis so every shift moves whole rows."""
    import jax.numpy as jnp

    k = 1
    n = x.shape[0]
    while k < n:
        shifted = jnp.concatenate(
            [jnp.full((k,) + x.shape[1:], INF, x.dtype), x[:-k]], axis=0
        )
        x = jnp.minimum(x, shifted)
        k *= 2
    return x


@functools.partial(
    __import__("jax").jit,
    static_argnames=("num_slices", "num_nodes", "cyclic", "max_passes"),
)
def _align_batch_device(
    read_codes,  # [B, num_slices*64] uint8
    sched_code,  # [P]
    sched_is_start,  # [P]
    sched_is_source_start,  # [P]
    sched_pred_nodes,  # [P, max_indeg]
    sched_node_slot,  # [P]
    num_slices: int,
    num_nodes: int,
    cyclic: bool = False,
    max_passes: int = 128,
):
    """Layout note: score columns are [64 rows, batch] so the batch is
    the contiguous minor axis."""
    import jax
    import jax.numpy as jnp

    from ..ops.packing import pack_deltas

    B = read_codes.shape[0]
    P = sched_code.shape[0]
    max_indeg = sched_pred_nodes.shape[1]
    ar64 = jnp.arange(WORD_SIZE, dtype=jnp.int32)[:, None]  # [64,1]
    match_table = jnp.asarray(_MATCH_TABLE)

    def slice_step_inner(old_end, nc, s):
        # old_end: [P, B] previous slice last-row scores (schedule order)
        rows_codes = jax.lax.dynamic_slice(
            read_codes, (0, s * WORD_SIZE), (B, WORD_SIZE)
        )
        # match_by_code [5, 64, B]
        match_by_code = jnp.transpose(match_table[rows_codes], (2, 1, 0))

        def column_step(carry, xs):
            prev_scores, prev_sbs, prev_e, store_scores, store_sbs, store_e = carry
            # prev_scores [64,B]; store_scores [N,64,B]; store_sbs/e [N,B]
            code_t, start_t, source_start_t, preds_t, slot_t, old_end_t = xs
            m = match_by_code[code_t]  # [64, B]

            def advance(p_scores, p_sbs, p_e):
                # base[r] = min(horizontal p[r]+1, diagonal p[r-1]+cost)
                diag_prev = jnp.concatenate(
                    [p_sbs[None], p_scores[:-1]], axis=0
                )
                cost = jnp.where(m, 0, 1).astype(jnp.int32)
                # row 0 match requires the predecessor's sbs to exist
                row0 = jnp.where(m[0] & p_e, 0, 1).astype(jnp.int32)
                cost = jnp.concatenate([row0[None], cost[1:]], axis=0)
                return jnp.minimum(p_scores + 1, diag_prev + cost)

            # within-node path
            base = advance(prev_scores, prev_sbs, prev_e)
            r_t = prev_sbs + 1
            # node-start path: fold min over advanced in-neighbor columns
            if max_indeg:
                base_start = jnp.full_like(base, INF)
                r_start = jnp.full_like(prev_sbs, INF)
                for k in range(max_indeg):
                    pred = preds_t[k]
                    valid = pred >= 0
                    safe = jnp.maximum(pred, 0)
                    adv = advance(
                        store_scores[safe], store_sbs[safe], store_e[safe]
                    )
                    base_start = jnp.minimum(
                        base_start, jnp.where(valid, adv, INF)
                    )
                    r_start = jnp.minimum(
                        r_start, jnp.where(valid, store_sbs[safe] + 1, INF)
                    )
                base = jnp.where(start_t, base_start, base)
                r_t = jnp.where(start_t, r_start, r_t)
            r_t = jnp.minimum(old_end_t, r_t)
            e_t = r_t == old_end_t

            # vertical from own sbs; free-start diagonal for source nodes
            # at slice 0
            sm_cost = jnp.where(m[0], 0, 1).astype(jnp.int32)
            row0 = jnp.minimum(base[0], r_t + 1)
            row0 = jnp.minimum(
                row0, jnp.where(source_start_t & (s == 0), r_t + sm_cost, INF)
            )
            base = jnp.concatenate([row0[None], base[1:]], axis=0)
            # 64-row vertical closure via prefix-min
            cur = _cummin_rows(base - ar64, ar64) + ar64

            store_scores = store_scores.at[slot_t].set(cur)
            store_sbs = store_sbs.at[slot_t].set(r_t)
            store_e = store_e.at[slot_t].set(e_t)
            vp_lo, vp_hi, vn_lo, vn_hi = pack_deltas(cur.T, r_t)
            out = (vp_lo, vp_hi, vn_lo, vn_hi, r_t, cur[WORD_SIZE - 1])
            return (
                (cur, r_t, e_t, store_scores, store_sbs, store_e),
                out,
            )

        xs = (
            sched_code,
            sched_is_start,
            sched_is_source_start,
            sched_pred_nodes,
            sched_node_slot,
            old_end,  # [P, B]
        )

        def run_pass(stores):
            init = (
                jnp.full((WORD_SIZE, B), INF, dtype=jnp.int32),
                jnp.full((B,), INF, dtype=jnp.int32),
                jnp.zeros((B,), dtype=bool),
            ) + stores
            final, outs = jax.lax.scan(column_step, init, xs, unroll=8)
            return final[3:], outs

        stores0 = (
            jnp.full((num_nodes, WORD_SIZE, B), INF, dtype=jnp.int32),
            jnp.full((num_nodes, B), INF, dtype=jnp.int32),
            jnp.zeros((num_nodes, B), dtype=bool),
        )
        stores, outs = run_pass(stores0)
        nonconv = jnp.bool_(False)
        if cyclic:
            # Bellman-Ford fixpoint over whole-slice passes: back-edge
            # predecessors read the PREVIOUS pass's stored columns (INF
            # on pass 1), and passes repeat until nothing changes — the
            # reference's cyclic-component recalculation loop
            # (GraphAligner.h calculateSlice / UniqueQueue). advance()
            # is monotone in its inputs, so scores only decrease and the
            # limit is the unique least fixpoint regardless of order.
            def fix_cond(st):
                return st[2] & (st[3] < max_passes)

            def fix_body(st):
                stores_i, outs_i, _, it = st
                stores_n, outs_n = run_pass(stores_i)
                changed = jnp.any(
                    jnp.stack(
                        [jnp.any(a != b) for a, b in zip(outs_n, outs_i)]
                    )
                )
                return (stores_n, outs_n, changed, it + 1)

            stores, outs, still_changing, _ = jax.lax.while_loop(
                fix_cond, fix_body, (stores, outs, jnp.bool_(True), jnp.int32(1))
            )
            nonconv = still_changing  # hit the pass cap while improving

        vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end = outs  # each [P, B]
        return (score_end, nc | nonconv), (
            vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end,
        )

    def slice_wrap(carry, s):
        old_end, nc = carry
        return slice_step_inner(old_end, nc, s)

    init_old_end = jnp.zeros((P, B), dtype=jnp.int32)
    (_, nonconv), per_slice = jax.lax.scan(
        slice_wrap,
        (init_old_end, jnp.bool_(False)),
        jnp.arange(num_slices, dtype=jnp.int32),
    )
    # per_slice leaves: [S, P, B]
    return per_slice + (nonconv,)


class DeviceSliceView:
    """SliceScores-compatible view over device-computed packed arrays for
    one read and one slice; reconstructs score columns lazily for the
    host backtrace."""

    def __init__(self, sched: DeviceSchedule, j, vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end):
        self._sched = sched
        self.j = j
        self._packed = (vp_lo, vp_hi, vn_lo, vn_hi)  # each [P]
        self._sbs = sbs  # [P]
        self._score_end = score_end  # [P]
        self._cache: dict = {}
        self.nodes = [int(n) for n in sched.graph.topo_node_order]
        self.correctness = CorrectnessState()
        self.min_score = 0
        self.min_score_index: list = []
        self.node_min: dict = {}
        self.num_cells = len(sbs)
        g = sched.graph
        ends = self._score_end
        self.node_min = {}
        for n in self.nodes:
            steps = sched.pos_to_step[
                int(g.node_start[n]) : int(g.node_end[n])
            ]
            self.node_min[n] = int(ends[steps].min())

    def _rows(self, node: int) -> np.ndarray:
        cached = self._cache.get(node)
        if cached is not None:
            return cached
        from ..ops.packing import unpack_deltas_np

        g = self._sched.graph
        steps = self._sched.pos_to_step[int(g.node_start[node]) : int(g.node_end[node])]
        vp_lo, vp_hi, vn_lo, vn_hi = (p[steps] for p in self._packed)
        scores = unpack_deltas_np(vp_lo, vp_hi, vn_lo, vn_hi, self._sbs[steps])
        rows = scores.T  # [64, L]
        self._cache[node] = rows
        return rows

    # SliceScores protocol used by the backtrace/band/pipeline code
    def has_node(self, node: int) -> bool:
        return True

    def get_value(self, graph, row: int, pos: int) -> int:
        node = graph.index_to_node(pos)
        return int(self._rows(node)[row, pos - graph.node_start[node]])

    def get_value_or_max(self, graph, row: int, pos: int, default):
        return self.get_value(graph, row, pos)

    def node_end_score(self, node: int) -> int:
        return int(self._rows(node)[WORD_SIZE - 1, -1])

    @property
    def rows(self):  # for SliceScores duck-typing in min-index collection
        raise AttributeError("use _rows(node)")


class BatchAligner:
    """Aligns batches of reads in exhaustive mode on the device and
    produces host-side DPTables compatible with the existing backtrace
    and GAM conversion."""

    def __init__(self, graph: AlignmentGraph):
        self.graph = graph
        self.sched = build_schedule(graph)

    def compute_tables(
        self, sequences: list, num_slices: int | None = None, backend: str = "wavefront"
    ):
        """Returns per-read lists of DeviceSliceView (slice 0..S_b-1) plus
        the per-read initial slice, and per-slice min scores."""
        import jax.numpy as jnp

        B = len(sequences)
        slices_per_read = [
            (len(s) + WORD_SIZE - 1) // WORD_SIZE for s in sequences
        ]
        S = num_slices or max(slices_per_read)
        codes = np.full((B, S * WORD_SIZE), _READ_CODE["N"], dtype=np.uint8)
        for i, s in enumerate(sequences):
            codes[i, : len(s)] = encode_read(s)
        if self.sched.cyclic:
            # cyclic SCCs need the fixpoint column backend (the skewed
            # wavefront schedule assumes forward-only dependencies)
            backend = "column"
        if backend == "wavefront":
            from .engine_wave import (
                _align_batch_wavefront,
                build_skewed_schedule,
                deskew,
            )

            P = len(self.sched.cell_pos)
            sk = build_skewed_schedule(self.sched, S)
            eq = build_eq_vectors(codes, _MATCH_TABLE, S)
            out = _align_batch_wavefront(
                jnp.asarray(eq),
                *[jnp.asarray(x) for x in sk[:5]],
                num_slices=S,
                num_nodes=self.sched.num_nodes,
                P=P,
            )
            host = deskew([np.asarray(x) for x in out], P, S)
        else:
            out = _align_batch_device(
                jnp.asarray(codes),
                jnp.asarray(self.sched.code),
                jnp.asarray(self.sched.is_start),
                jnp.asarray(self.sched.is_source_start),
                jnp.asarray(self.sched.pred_nodes),
                jnp.asarray(self.sched.node_slot),
                num_slices=S,
                num_nodes=self.sched.num_nodes,
                cyclic=self.sched.cyclic,
            )
            *slabs, nonconv = out
            if bool(np.asarray(nonconv)):
                raise ValueError(
                    "cyclic fixpoint did not converge within the pass "
                    "cap; use the oracle backend"
                )
            host = [np.asarray(x) for x in slabs]  # each [S, P, B]
        vp_lo, vp_hi, vn_lo, vn_hi, sbs, score_end = host
        tables = []
        for b in range(B):
            views = []
            for s in range(slices_per_read[b]):
                views.append(
                    DeviceSliceView(
                        self.sched,
                        s * WORD_SIZE,
                        vp_lo[s, :, b],
                        vp_hi[s, :, b],
                        vn_lo[s, :, b],
                        vn_hi[s, :, b],
                        sbs[s, :, b].astype(np.int64),
                        score_end[s, :, b].astype(np.int64),
                    )
                )
            tables.append(views)
        return tables

    def cells_per_batch(self, sequences: list) -> int:
        total_slices = sum((len(s) + WORD_SIZE - 1) // WORD_SIZE for s in sequences)
        return total_slices * WORD_SIZE * len(self.sched.cell_pos)


def _finalize_table(graph: AlignmentGraph, views: list):
    """Attach reference-order min scores/indices and HMM states, build a
    DPTable through the existing pipeline types."""
    from .align import DPTable
    from .oracle import make_initial_slice_full_band

    band_order = [int(n) for n in graph.topo_node_order]
    components = _banded_tarjan(graph, band_order, {n: True for n in band_order})
    table = DPTable(slices=[make_initial_slice_full_band(graph)])
    correctness = CorrectnessState()
    prev_min = 0
    for view in views:
        min_score = None
        min_index = []
        for comp in reversed(components):
            for n in reversed(comp):
                nm = view.node_min[n]
                if min_score is None or nm < min_score:
                    min_score = nm
                    min_index = []
                if nm == min_score:
                    rows = view._rows(n)[WORD_SIZE - 1]
                    start = int(graph.node_start[n])
                    for k in np.nonzero(rows == nm)[0]:
                        min_index.append(start + int(k))
        view.min_score = int(min_score)
        view.min_score_index = min_index
        delta = min(WORD_SIZE, view.min_score - prev_min)
        correctness = correctness.next_state(delta, WORD_SIZE)
        view.correctness = correctness
        prev_min = view.min_score
        table.slices.append(view)
        table.bandwidth_per_slice.append(0)
        table.correctness.append(correctness)
    return table


def align_batch_full_band(graph: AlignmentGraph, reads: list, batch_aligner=None):
    """Exhaustive-mode batched alignment: returns per-read AlignmentResult.

    Pipeline parity notes: band projection is bypassed (all positions
    active — optimal alignments); the HMM still trims wrongly-aligned
    tails as in the reference."""
    from .align import remove_wrongly_aligned_end, trace_to_alignment, _pad_to_word
    from .backtrace import get_trace_from_table
    from .result import empty_alignment

    ba = batch_aligner or BatchAligner(graph)
    sequences = [r.sequence for r in reads]
    tables_views = ba.compute_tables(sequences)
    results = []
    for read, views in zip(reads, tables_views):
        table = _finalize_table(graph, views)
        remove_wrongly_aligned_end(table)
        padded = _pad_to_word(read.sequence)
        padding = len(padded) - len(read.sequence)
        score, trace = get_trace_from_table(graph, padded, table)
        if score >= INF or not trace:
            results.append(empty_alignment(0, 0))
            continue
        while trace and trace[-1][1] >= len(padded) - padding:
            trace.pop()
        result = trace_to_alignment(graph, read.seq_id, read.sequence, score, trace, 0)
        result.alignment_start = trace[0][1]
        result.alignment_end = trace[-1][1]
        results.append(result)
    return results

