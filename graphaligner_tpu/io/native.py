"""ctypes bindings to the native I/O fast paths (native/ga_native.cpp).

Auto-builds the shared library on first use (g++ is part of the
deployment image); every entry point has a pure-Python fallback in
stream.py / fastq.py / bigraph.py, so the library is an accelerator,
never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libga_native.so")
_lib = None
_tried = False


def get_lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    src = os.path.join(_NATIVE_DIR, "ga_native.cpp")
    stale = not os.path.exists(_LIB_PATH) or (
        os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    )
    if stale:
        try:
            subprocess.run(
                ["make", "-s", "-B", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            if not os.path.exists(_LIB_PATH):
                return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        _register(lib)
    except (OSError, AttributeError):
        # missing symbol = a stale library from an older source tree
        return None
    if not os.environ.get("GA_NO_CRASH_GUARD"):
        # SIGSEGV/SIGBUS -> read attribution + per-call recovery inside
        # the native entry points (reference ThreadReadAssertion.cpp:8-14,
        # installed at AlignerMain.cpp:12-16). Faults outside a guarded
        # native call re-raise with the default handler.
        lib.ga_install_crash_guard()
    _lib = lib
    return _lib


def set_read(name) -> None:
    """Record the read/context being processed on THIS thread for native
    crash attribution (reference assertSetRead)."""
    lib = get_lib()
    if lib is not None:
        lib.ga_set_read(str(name).encode()[:255])


def _register(lib):
    lib.ga_gunzip.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ga_gunzip.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
    ]
    lib.ga_gzip.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.ga_gzip.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.ga_free.argtypes = [ctypes.c_void_p]
    lib.ga_count_messages.restype = ctypes.c_int64
    lib.ga_count_messages.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.ga_frame_messages.restype = ctypes.c_int64
    lib.ga_frame_messages.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64), np.ctypeslib.ndpointer(np.int64),
        ctypes.c_int64,
    ]
    lib.ga_parse_reads.restype = ctypes.c_void_p
    lib.ga_parse_reads.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
    for name in ("ga_reads_names", "ga_reads_seqs", "ga_reads_quals"):
        getattr(lib, name).restype = ctypes.c_void_p
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("ga_reads_name_off", "ga_reads_seq_off", "ga_reads_qual_off"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int64)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ga_reads_count.restype = ctypes.c_int64
    lib.ga_reads_count.argtypes = [ctypes.c_void_p]
    lib.ga_reads_destroy.argtypes = [ctypes.c_void_p]
    lib.ga_parse_gfa.restype = ctypes.c_void_p
    lib.ga_parse_gfa.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    for name in ("ga_gfa_num_s", "ga_gfa_num_l"):
        getattr(lib, name).restype = ctypes.c_int64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in (
        "ga_gfa_s_ids", "ga_gfa_l_from", "ga_gfa_l_to", "ga_gfa_l_overlap",
        "ga_gfa_s_off",
    ):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int64)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ga_gfa_s_seqs.restype = ctypes.c_void_p
    lib.ga_gfa_s_seqs.argtypes = [ctypes.c_void_p]
    for name in ("ga_gfa_l_from_minus", "ga_gfa_l_to_minus"):
        getattr(lib, name).restype = ctypes.POINTER(ctypes.c_uint8)
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.ga_gfa_destroy.argtypes = [ctypes.c_void_p]
    lib.ga_compute_slice.restype = ctypes.c_int64
    lib.ga_compute_slice.argtypes = [
        ctypes.c_int64,                    # C
        ctypes.POINTER(ctypes.c_uint8),    # chain
        ctypes.POINTER(ctypes.c_int64),    # edge_ptr
        ctypes.POINTER(ctypes.c_int32),    # edge_to
        ctypes.c_int64,                    # n_sp
        ctypes.POINTER(ctypes.c_int32),    # sp_cell
        ctypes.POINTER(ctypes.c_int32),    # sp_pred
        ctypes.c_int64,                    # n_ps
        ctypes.POINTER(ctypes.c_int32),    # ps_cell
        ctypes.POINTER(ctypes.c_int64),    # ps_old
        ctypes.c_int64,                    # n_fs
        ctypes.POINTER(ctypes.c_int32),    # fs_cell
        ctypes.POINTER(ctypes.c_uint8),    # match [64*C]
        ctypes.POINTER(ctypes.c_int64),    # seed_sbs
        ctypes.POINTER(ctypes.c_int64),    # old_end
        ctypes.POINTER(ctypes.c_uint8),    # old_flags
        ctypes.c_int64,                    # slice_index
        ctypes.POINTER(ctypes.c_int64),    # out sbs
        ctypes.POINTER(ctypes.c_uint8),    # out sbs_exists
        ctypes.POINTER(ctypes.c_int64),    # out rows
    ]
    lib.ga_decode_moves.restype = ctypes.c_int64
    lib.ga_decode_moves.argtypes = [
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int32,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
    ]
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.ga_band_orders.restype = ctypes.c_int
    lib.ga_band_orders.argtypes = [
        i32p, i32p, i32p, i32p, i32p,  # band/min/end/min_scores/bandwidths
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # K, Nm, start_node
        i64p, i32p, i64p, i32p,  # out_ptr, out_idx, node_len, topo_rank
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # N, cutoff, EMPTY
        ctypes.POINTER(ctypes.c_uint8),  # check_mask
        i32p, i32p,  # orders_out, counts_out
    ]
    lib.ga_tie_start.restype = ctypes.c_int64
    lib.ga_tie_start.argtypes = [
        i32p, ctypes.c_int64,  # order, n
        i64p, i32p,  # out_ptr, out_idx
        i64p, i64p,  # node_len, node_start
        i32p, i32p,  # topo_rank, sends
        ctypes.c_int64, ctypes.c_int32,  # n_sends, best
    ]
    lib.ga_set_read.restype = None
    lib.ga_set_read.argtypes = [ctypes.c_char_p]
    lib.ga_install_crash_guard.restype = None
    lib.ga_install_crash_guard.argtypes = []
    lib.ga_decode_batch.restype = ctypes.c_int
    lib.ga_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, ctypes.c_int64,
        i32p,  # cols [W]
        i64p, i64p,  # start_w, start_row [W]
        i64p, i64p,  # node_start, node_end
        i32p, i32p, ctypes.c_int32,  # pos_to_node, in_nbrs, k_in
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # W, cap, nthreads
        i64p, i64p, i64p,  # out_w, out_r [W*cap], n_out [W]
    ]
    lib.ga_tie_batch.restype = ctypes.c_int
    lib.ga_tie_batch.argtypes = [
        i32p, i32p, i32p,  # band_ids, node_min, node_end [W*Kmax*Nm]
        i32p, i32p,  # min_scores, bandwidths [W*Kmax]
        i32p, i32p,  # Ks, start_nodes [W]
        ctypes.POINTER(ctypes.c_uint8),  # check_mask [W*Kmax]
        i32p, i32p,  # sends [W*Cm], bests [W]
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # W, Kmax, Nm, Cm
        i64p, i32p, i64p, i64p,  # out_ptr, out_idx, node_len, node_start
        i32p, ctypes.c_int64,  # topo_rank, num_nodes
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,  # cutoff, EMPTY, nthreads
        i64p, i32p,  # pos_out, rc_out
    ]


def gunzip(data: bytes) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out_len = ctypes.c_int64()
    ptr = lib.ga_gunzip(data, len(data), ctypes.byref(out_len))
    if not ptr:
        raise ValueError("truncated gzip stream")
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.ga_free(ptr)


def gzip_bytes(data: bytes, level: int = 6) -> bytes | None:
    lib = get_lib()
    if lib is None:
        return None
    out_len = ctypes.c_int64()
    ptr = lib.ga_gzip(data, len(data), level, ctypes.byref(out_len))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.ga_free(ptr)


def frame_offsets(raw: bytes):
    """(offsets, lengths) int64 arrays of message payloads in framed data,
    or None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = lib.ga_count_messages(raw, len(raw))
    if n < 0:
        raise ValueError("malformed vg stream framing")
    offsets = np.empty(n, dtype=np.int64)
    lengths = np.empty(n, dtype=np.int64)
    got = lib.ga_frame_messages(raw, len(raw), offsets, lengths, n)
    if got != n:
        raise ValueError("malformed vg stream framing")
    return offsets, lengths


def parse_reads(data: bytes, is_fasta: bool):
    """[(name, seq, qual)] parsed natively, or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.ga_parse_reads(data, len(data), 1 if is_fasta else 0)
    try:
        n = lib.ga_reads_count(h)
        name_off = np.ctypeslib.as_array(lib.ga_reads_name_off(h), shape=(n + 1,))
        seq_off = np.ctypeslib.as_array(lib.ga_reads_seq_off(h), shape=(n + 1,))
        qual_off = np.ctypeslib.as_array(lib.ga_reads_qual_off(h), shape=(n + 1,))
        names = ctypes.string_at(lib.ga_reads_names(h), int(name_off[-1]))
        seqs = ctypes.string_at(lib.ga_reads_seqs(h), int(seq_off[-1]))
        quals = ctypes.string_at(lib.ga_reads_quals(h), int(qual_off[-1]))
        out = []
        for i in range(n):
            out.append(
                (
                    names[name_off[i] : name_off[i + 1]].decode(),
                    seqs[seq_off[i] : seq_off[i + 1]].decode(),
                    quals[qual_off[i] : qual_off[i + 1]].decode(),
                )
            )
        return out
    finally:
        lib.ga_reads_destroy(h)


def parse_gfa(data: bytes):
    """(s_records, l_records) parsed natively, or None.
    s_records: [(id, seq)]; l_records: [(from, from_minus, to, to_minus, overlap)]."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.ga_parse_gfa(data, len(data))
    try:
        ns = lib.ga_gfa_num_s(h)
        nl = lib.ga_gfa_num_l(h)
        s_ids = np.ctypeslib.as_array(lib.ga_gfa_s_ids(h), shape=(ns,)).copy() if ns else np.zeros(0, np.int64)
        s_off = np.ctypeslib.as_array(lib.ga_gfa_s_off(h), shape=(ns + 1,))
        seqs = ctypes.string_at(lib.ga_gfa_s_seqs(h), int(s_off[-1])) if ns else b""
        s_records = [
            (int(s_ids[i]), seqs[s_off[i] : s_off[i + 1]].decode()) for i in range(ns)
        ]
        if nl:
            l_from = np.ctypeslib.as_array(lib.ga_gfa_l_from(h), shape=(nl,))
            l_to = np.ctypeslib.as_array(lib.ga_gfa_l_to(h), shape=(nl,))
            l_ov = np.ctypeslib.as_array(lib.ga_gfa_l_overlap(h), shape=(nl,))
            l_fm = np.ctypeslib.as_array(lib.ga_gfa_l_from_minus(h), shape=(nl,))
            l_tm = np.ctypeslib.as_array(lib.ga_gfa_l_to_minus(h), shape=(nl,))
            l_records = [
                (int(l_from[i]), bool(l_fm[i]), int(l_to[i]), bool(l_tm[i]), int(l_ov[i]))
                for i in range(nl)
            ]
        else:
            l_records = []
        return s_records, l_records
    finally:
        lib.ga_gfa_destroy(h)


def decode_moves(moves, start_w, start_row, node_start, node_end, pos_to_node,
                 in_nbrs, cap):
    """Decode a packed 4-bit move stream (the move-walk kernel) into a forward
    [n, 2] (graph position, read row) trace; None if the native library is
    unavailable; raises ValueError on a malformed stream."""
    lib = get_lib()
    if lib is None:
        return None
    moves = np.ascontiguousarray(moves, dtype=np.uint32)
    out_w = np.empty(cap, dtype=np.int64)
    out_r = np.empty(cap, dtype=np.int64)
    n = lib.ga_decode_moves(
        moves.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(moves),
        int(start_w),
        int(start_row),
        node_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        node_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pos_to_node.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        in_nbrs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        in_nbrs.shape[1],
        cap,
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        raise ValueError("malformed move stream")
    return np.stack([out_w[:n], out_r[:n]], axis=1)


def _trace_piece_sig(lib):
    if getattr(lib, "_tp_ready", False):
        return
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ga_trace_piece.restype = ctypes.c_int
    lib.ga_trace_piece.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # trace, n, trim, rev
        i64p, ctypes.c_int64, ctypes.c_int64,  # rev_pos, end_row, shift
        i32p, i64p, i64p, u8p,  # pos_to_node, node_start, node_ids, rev_flags
        ctypes.c_int32, ctypes.c_int32,  # dummy_start, dummy_end
        i64p,  # out_trace
        i32p, i64p, i64p,  # fr_node, fr_rfirst, fr_rlast
        i32p, i64p, u8p, i64p, i64p, i64p, i64p,  # window arrays
        i64p,  # meta
    ]
    lib._tp_ready = True


def trace_piece(trace, trim_limit, do_reverse, rev_pos, end_row, shift,
                pos_to_node, node_start, node_ids, rev_flags,
                dummy_start, dummy_end):
    """One-call trace finalize (see ga_trace_piece): returns
    (final_trace [m, 2] int64, runs_dict | None, tried list of
    (rfirst, rlast, node) triples). None if the library is unavailable.
    The graph table arrays must be C-contiguous with dtypes
    int32/int64/int64/uint8."""
    lib = get_lib()
    if lib is None:
        return None
    _trace_piece_sig(lib)
    trace = np.ascontiguousarray(trace, dtype=np.int64)
    n = len(trace)
    out_trace = np.empty((n, 2), np.int64)
    fr_node = np.empty(n + 1, np.int32)
    fr_rfirst = np.empty(n + 1, np.int64)
    fr_rlast = np.empty(n + 1, np.int64)
    w_node_idx = np.empty(n + 1, np.int32)
    w_node_id = np.empty(n + 1, np.int64)
    w_rev = np.empty(n + 1, np.uint8)
    w_offsets = np.empty(n + 1, np.int64)
    w_from_len = np.empty(n + 1, np.int64)
    w_to_len = np.empty(n + 1, np.int64)
    w_rstart = np.empty(n + 1, np.int64)
    meta = np.zeros(3, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.ga_trace_piece(
        trace.ctypes.data_as(i64p),
        n,
        int(trim_limit),
        1 if do_reverse else 0,
        rev_pos.ctypes.data_as(i64p),
        int(end_row),
        int(shift),
        pos_to_node.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        node_start.ctypes.data_as(i64p),
        node_ids.ctypes.data_as(i64p),
        rev_flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(dummy_start),
        int(dummy_end),
        out_trace.ctypes.data_as(i64p),
        fr_node.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        fr_rfirst.ctypes.data_as(i64p),
        fr_rlast.ctypes.data_as(i64p),
        w_node_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        w_node_id.ctypes.data_as(i64p),
        w_rev.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w_offsets.ctypes.data_as(i64p),
        w_from_len.ctypes.data_as(i64p),
        w_to_len.ctypes.data_as(i64p),
        w_rstart.ctypes.data_as(i64p),
        meta.ctypes.data_as(i64p),
    )
    if rc != 0:
        raise ValueError("native crash in trace finalize")
    m, nr, nw = int(meta[0]), int(meta[1]), int(meta[2])
    final = out_trace[:m]
    tried = list(
        zip(fr_rfirst[:nr].tolist(), fr_rlast[:nr].tolist(),
            fr_node[:nr].tolist())
    )
    if nw == 0:
        return final, None, tried
    runs = {
        "node_idx": w_node_idx[:nw],
        "node_id": w_node_id[:nw],
        "rev": w_rev[:nw].view(bool),
        "offsets": w_offsets[:nw],
        "ranks": np.arange(nw, dtype=np.int64),
        "from_len": w_from_len[:nw],
        "to_len": w_to_len[:nw],
        "rstart": w_rstart[:nw],
    }
    return final, runs, tried


class TracePieceCtx:
    """Cached-pointer fast path of the per-piece trace finalize
    (ga_trace_piece2): the 24-argument per-call ctypes marshalling of
    trace_piece cost ~80us/call — the top host cost of the short-read
    pipeline. Graph-table addresses resolve ONCE here; per call only
    the trace and two output buffers are marshalled, and every output
    lands in one [11, n+1] int64 slab. Returns match trace_piece."""

    def __init__(self, rev_pos, pos_to_node, node_start, node_ids,
                 rev_flags, dummy_start, dummy_end):
        lib = get_lib()
        self.lib = lib
        if lib is None:
            return
        if not getattr(lib, "_tp2_ready", False):
            vp = ctypes.c_void_p
            i64 = ctypes.c_int64
            i32 = ctypes.c_int32
            lib.ga_trace_piece2.restype = ctypes.c_int
            lib.ga_trace_piece2.argtypes = [
                vp, i64, i64, i32,  # trace, n, trim_limit, do_reverse
                vp, i64, i64,  # rev_pos, end_row, shift
                vp, vp, vp, vp,  # pos_to_node, node_start, node_ids, rev
                i32, i32,  # dummy_start, dummy_end
                vp, vp,  # out_trace, slab
            ]
            lib._tp2_ready = True
        # keep the table arrays alive for the cached raw addresses
        self._keep = (rev_pos, pos_to_node, node_start, node_ids, rev_flags)
        self.p_rev = rev_pos.ctypes.data
        self.p_p2n = pos_to_node.ctypes.data
        self.p_nstart = node_start.ctypes.data
        self.p_nids = node_ids.ctypes.data
        self.p_revf = rev_flags.ctypes.data
        self.ds = int(dummy_start)
        self.de = int(dummy_end)

    def piece(self, trace, trim_limit, do_reverse, end_row, shift):
        trace = np.ascontiguousarray(trace, dtype=np.int64)
        n = len(trace)
        R = n + 1
        slab = np.empty((11, R), np.int64)
        out_trace = np.empty((n, 2), np.int64)
        rc = self.lib.ga_trace_piece2(
            trace.ctypes.data, n, int(trim_limit),
            1 if do_reverse else 0, self.p_rev, int(end_row), int(shift),
            self.p_p2n, self.p_nstart, self.p_nids, self.p_revf,
            self.ds, self.de, out_trace.ctypes.data, slab.ctypes.data,
        )
        if rc != 0:
            raise ValueError("native crash in trace finalize")
        meta = slab[10]
        m, nr, nw = int(meta[0]), int(meta[1]), int(meta[2])
        final = out_trace[:m]
        tried = list(
            zip(slab[1, :nr].tolist(), slab[2, :nr].tolist(),
                slab[0, :nr].tolist())
        )
        if nw == 0:
            return final, None, tried
        # small-row COPIES (a view would pin the whole per-read slab)
        runs = {
            "node_idx": slab[3, :nw].astype(np.int32),
            "node_id": slab[4, :nw].copy(),
            "rev": slab[5, :nw].astype(bool),
            "offsets": slab[6, :nw].copy(),
            "ranks": np.arange(nw, dtype=np.int64),
            "from_len": slab[7, :nw].copy(),
            "to_len": slab[8, :nw].copy(),
            "rstart": slab[9, :nw].copy(),
        }
        return final, runs, tried


def decode_moves_batch(moves2d, cols, start_ws, start_rows, node_start,
                       node_end, pos_to_node, in_nbrs, cap, nthreads):
    """Decode every lane of one walk block in ONE native call (internal
    thread pool; see ga_decode_batch). moves2d: the [n_words, B] uint32
    fetch layout; cols[i] = lane i's column. Returns (out_w, out_r,
    n_out) slabs — lane i's forward trace is
    (out_w[i, :n], out_r[i, :n]) for n = n_out[i]; n < 0 flags a
    malformed stream (-1) or a caught native crash (-2).
    None if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    moves2d = np.ascontiguousarray(moves2d, dtype=np.uint32)
    W = len(cols)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    start_ws = np.ascontiguousarray(start_ws, dtype=np.int64)
    start_rows = np.ascontiguousarray(start_rows, dtype=np.int64)
    out_w = np.empty((W, cap), dtype=np.int64)
    out_r = np.empty((W, cap), dtype=np.int64)
    n_out = np.empty(W, dtype=np.int64)
    lib.ga_decode_batch(
        moves2d.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        moves2d.shape[0],
        moves2d.shape[1],
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        start_ws.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        start_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        node_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        node_end.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pos_to_node.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        in_nbrs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        in_nbrs.shape[1],
        W,
        cap,
        nthreads,
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_r.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n_out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out_w, out_r, n_out


def tie_start(order, sends, best, graph, topo_rank):
    """Resolve a multi-node final-slice score tie natively: banded
    Tarjan over the insertion order + the reversed-components last-min
    scan (the Python resolve_tie hot path). Returns the winning graph
    position, -1 on host/device divergence, or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    order = np.ascontiguousarray(order, dtype=np.int32)
    sends = np.ascontiguousarray(sends, dtype=np.int32)
    out_ptr = np.ascontiguousarray(graph.out_ptr, dtype=np.int64)
    out_idx = np.ascontiguousarray(graph.out_idx, dtype=np.int32)
    node_len = np.ascontiguousarray(graph.node_len, dtype=np.int64)
    node_start = np.ascontiguousarray(graph.node_start, dtype=np.int64)
    topo_rank = np.ascontiguousarray(topo_rank, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    return int(
        lib.ga_tie_start(
            order.ctypes.data_as(i32p), len(order),
            out_ptr.ctypes.data_as(i64p), out_idx.ctypes.data_as(i32p),
            node_len.ctypes.data_as(i64p), node_start.ctypes.data_as(i64p),
            topo_rank.ctypes.data_as(i32p), sends.ctypes.data_as(i32p),
            len(sends), int(best),
        )
    )


def tie_batch(tie, min_scores, bandwidths, Ks, start_nodes, check_mask,
              sends, bests, graph, topo_rank, cutoff, empty, nthreads):
    """Batched multi-node tie resolution: chain replay + last-min scan
    for W lanes in ONE native call (internal C++ thread pool).

    tie: [W, Kmax, 3, Nm] int32 (hash-plane, node_min, node_end);
    min_scores/bandwidths/check_mask: [W, Kmax]; Ks/start_nodes/bests:
    [W]; sends: [W, Cm] final-slice cell scores. Returns (pos [W] int64,
    rc [W] int32) — pos=-1 where unresolved, rc 1=band mismatch,
    2=capacity overflow — or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    tie = np.asarray(tie, dtype=np.int32)
    W, Kmax, _, Nm = tie.shape
    band = np.ascontiguousarray(tie[:, :, 0])
    nmin = np.ascontiguousarray(tie[:, :, 1])
    nend = np.ascontiguousarray(tie[:, :, 2])
    min_scores = np.ascontiguousarray(min_scores, dtype=np.int32)
    bandwidths = np.ascontiguousarray(bandwidths, dtype=np.int32)
    Ks = np.ascontiguousarray(Ks, dtype=np.int32)
    start_nodes = np.ascontiguousarray(start_nodes, dtype=np.int32)
    check_mask = np.ascontiguousarray(check_mask, dtype=np.uint8)
    sends = np.ascontiguousarray(sends, dtype=np.int32)
    bests = np.ascontiguousarray(bests, dtype=np.int32)
    Cm = sends.shape[1]
    out_ptr = np.ascontiguousarray(graph.out_ptr, dtype=np.int64)
    out_idx = np.ascontiguousarray(graph.out_idx, dtype=np.int32)
    node_len = np.ascontiguousarray(graph.node_len, dtype=np.int64)
    node_start = np.ascontiguousarray(graph.node_start, dtype=np.int64)
    topo_rank = np.ascontiguousarray(topo_rank, dtype=np.int32)
    pos = np.empty(W, dtype=np.int64)
    rc = np.empty(W, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.ga_tie_batch(
        band.ctypes.data_as(i32p), nmin.ctypes.data_as(i32p),
        nend.ctypes.data_as(i32p), min_scores.ctypes.data_as(i32p),
        bandwidths.ctypes.data_as(i32p), Ks.ctypes.data_as(i32p),
        start_nodes.ctypes.data_as(i32p), check_mask.ctypes.data_as(u8p),
        sends.ctypes.data_as(i32p), bests.ctypes.data_as(i32p),
        W, Kmax, Nm, Cm,
        out_ptr.ctypes.data_as(i64p), out_idx.ctypes.data_as(i32p),
        node_len.ctypes.data_as(i64p), node_start.ctypes.data_as(i64p),
        topo_rank.ctypes.data_as(i32p), graph.node_count,
        int(cutoff), int(empty), int(nthreads),
        pos.ctypes.data_as(i64p), rc.ctypes.data_as(i32p),
    )
    return pos, rc


def band_orders(tie, min_scores, bandwidths, start_node, graph, topo_rank,
                cutoff, empty, check_mask=None):
    """Replay the band-insertion-order chain natively.

    tie: [K, 3, Nm] int32 (band_ids, node_min, node_end) device rows.
    Returns list of K per-slice insertion orders (int32 arrays), or None
    when the library is unavailable. Raises AssertionError on a
    device/host band mismatch (same contract as the Python replay)."""
    lib = get_lib()
    if lib is None:
        return None
    tie = np.asarray(tie, dtype=np.int32)
    K, _, Nm = tie.shape
    # each plane must be CONTIGUOUS before handing its pointer to C
    band = np.ascontiguousarray(tie[:, 0])
    nmin = np.ascontiguousarray(tie[:, 1])
    nend = np.ascontiguousarray(tie[:, 2])
    min_scores = np.ascontiguousarray(min_scores, dtype=np.int32)
    bandwidths = np.ascontiguousarray(bandwidths, dtype=np.int32)
    out_ptr = np.ascontiguousarray(graph.out_ptr, dtype=np.int64)
    out_idx = np.ascontiguousarray(graph.out_idx, dtype=np.int32)
    node_len = np.ascontiguousarray(graph.node_len, dtype=np.int64)
    topo_rank = np.ascontiguousarray(topo_rank, dtype=np.int32)
    orders = np.empty((K, Nm), dtype=np.int32)
    counts = np.empty(K, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.ga_band_orders(
        band.ctypes.data_as(i32p),
        nmin.ctypes.data_as(i32p),
        nend.ctypes.data_as(i32p),
        min_scores.ctypes.data_as(i32p),
        bandwidths.ctypes.data_as(i32p),
        K, Nm, int(start_node),
        out_ptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_idx.ctypes.data_as(i32p),
        node_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        topo_rank.ctypes.data_as(i32p),
        graph.node_count, int(cutoff), int(empty),
        (np.ascontiguousarray(check_mask, dtype=np.uint8).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8))
         if check_mask is not None else None),
        orders.ctypes.data_as(i32p),
        counts.ctypes.data_as(i32p),
    )
    assert rc != 1, "host/device band mismatch"
    if rc != 0:
        return None  # capacity overflow -> let the caller fall back
    return [orders[k, : counts[k]] for k in range(K)]


def encode_alignments(names, seqs, scores, qposs, runs_list, div2=False):
    """Serialize vg.Alignment payloads natively from per-lane run arrays.

    runs_list: [dict from core.trace_ops.trace_to_runs | None]; a None
    entry yields an empty-path alignment payload. Returns [bytes] or
    None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if not hasattr(lib, "_enc_ready"):
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.ga_encode_alignments.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ga_encode_alignments.argtypes = [
            ctypes.c_char_p, i64p, ctypes.c_char_p, i64p,
            i64p, i64p, ctypes.c_int64,
            i64p, i64p, ctypes.POINTER(ctypes.c_uint8), i64p, i64p, i64p,
            i64p, i64p, ctypes.c_int, i64p,
        ]
        lib._enc_ready = True
    n = len(runs_list)
    name_blob = "".join(names).encode()
    name_off = np.zeros(n + 1, np.int64)
    name_off[1:] = np.cumsum([len(x.encode()) for x in names])
    seq_blob = "".join(seqs).encode()
    seq_off = np.zeros(n + 1, np.int64)
    seq_off[1:] = np.cumsum([len(x) for x in seqs])
    score_a = np.asarray(scores, np.int64)
    qpos_a = np.asarray(qposs, np.int64)
    map_off = np.zeros(n + 1, np.int64)
    for i, r in enumerate(runs_list):
        map_off[i + 1] = map_off[i] + (0 if r is None else len(r["node_id"]))
    M = int(map_off[-1])

    def cat(key, dtype):
        out = np.empty(M, dtype)
        for i, r in enumerate(runs_list):
            if r is not None:
                out[map_off[i] : map_off[i + 1]] = r[key]
        return out

    node_id = cat("node_id", np.int64)
    offset = cat("offsets", np.int64)
    rev = cat("rev", np.uint8)
    rank = cat("ranks", np.int64)
    from_len = cat("from_len", np.int64)
    to_len = cat("to_len", np.int64)
    rstart = cat("rstart", np.int64)
    out_off = np.zeros(n + 1, np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ptr = lib.ga_encode_alignments(
        name_blob, name_off.ctypes.data_as(i64p),
        seq_blob, seq_off.ctypes.data_as(i64p),
        score_a.ctypes.data_as(i64p), qpos_a.ctypes.data_as(i64p), n,
        node_id.ctypes.data_as(i64p), offset.ctypes.data_as(i64p),
        rev.ctypes.data_as(u8p), rank.ctypes.data_as(i64p),
        from_len.ctypes.data_as(i64p), to_len.ctypes.data_as(i64p),
        rstart.ctypes.data_as(i64p), map_off.ctypes.data_as(i64p),
        1 if div2 else 0, out_off.ctypes.data_as(i64p),
    )
    if not ptr:
        return None
    try:
        blob = ctypes.string_at(ptr, int(out_off[-1]))
    finally:
        lib.ga_free(ptr)
    return [blob[out_off[i] : out_off[i + 1]] for i in range(n)]


def compute_slice_rows(chain, edge_ptr, edge_to, sp_cell, sp_pred, ps_cell,
                       ps_old, fs_cell, match, seed_sbs, old_end, old_flags,
                       slice_index):
    """Native banded slice DP (the giant-band host path — the analog of
    the reference's calculateSliceAlternate sparse method). Returns
    (sbs, sbs_exists, rows[64, C]) or None when the library is absent."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    C = len(seed_sbs)
    chain = np.ascontiguousarray(chain, dtype=np.uint8)
    edge_ptr = np.ascontiguousarray(edge_ptr, dtype=np.int64)
    edge_to = np.ascontiguousarray(edge_to, dtype=np.int32)
    sp_cell = np.ascontiguousarray(sp_cell, dtype=np.int32)
    sp_pred = np.ascontiguousarray(sp_pred, dtype=np.int32)
    ps_cell = np.ascontiguousarray(ps_cell, dtype=np.int32)
    ps_old = np.ascontiguousarray(ps_old, dtype=np.int64)
    fs_cell = np.ascontiguousarray(fs_cell, dtype=np.int32)
    match = np.ascontiguousarray(match, dtype=np.uint8)
    seed_sbs = np.ascontiguousarray(seed_sbs, dtype=np.int64)
    old_end = np.ascontiguousarray(old_end, dtype=np.int64)
    old_flags = np.ascontiguousarray(old_flags, dtype=np.uint8)
    sbs = np.empty(C, dtype=np.int64)
    sbs_exists = np.empty(C, dtype=np.uint8)
    rows = np.empty((64, C), dtype=np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    ok = lib.ga_compute_slice(
        C, p(chain, ctypes.c_uint8), p(edge_ptr, ctypes.c_int64),
        p(edge_to, ctypes.c_int32), len(sp_cell), p(sp_cell, ctypes.c_int32),
        p(sp_pred, ctypes.c_int32), len(ps_cell), p(ps_cell, ctypes.c_int32),
        p(ps_old, ctypes.c_int64), len(fs_cell), p(fs_cell, ctypes.c_int32),
        p(match, ctypes.c_uint8), p(seed_sbs, ctypes.c_int64),
        p(old_end, ctypes.c_int64), p(old_flags, ctypes.c_uint8),
        int(slice_index), p(sbs, ctypes.c_int64),
        p(sbs_exists, ctypes.c_uint8), p(rows, ctypes.c_int64),
    )
    if not ok:
        return None
    return sbs, sbs_exists.astype(bool), rows
