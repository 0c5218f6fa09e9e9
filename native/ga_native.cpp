// Native I/O fast paths for graphaligner_tpu.
//
// The reference's I/O layer is compiled C++ (stream.hpp's gzip+varint
// codec over protobuf, fastqloader.cpp, GfaGraph.cpp); at pangenome
// scale a Python loader would become the bottleneck, so the hot paths
// live here: gzip (de)compression, vg-stream varint framing, FASTQ
// parsing, and GFA tokenization. Python binds via ctypes
// (graphaligner_tpu/io/native.py) and falls back to the pure-Python
// implementations when this library is unavailable.
//
// Build: make -C native (g++ -O3 -shared -fPIC, links zlib).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <queue>
#include <string>
#include <thread>
#include <tuple>
#include <vector>
#include <zlib.h>

#include <csetjmp>
#include <csignal>

// ---------------------------------------------------------------------------
// Crash guard: SIGSEGV/SIGBUS -> read attribution + per-call recovery.
//
// The reference maps SIGSEGV to the read being processed
// (ThreadReadAssertion.cpp:8-14, installed AlignerMain.cpp:12-16) so a
// native crash names the read instead of killing the run silently.
// Here every crash-prone entry point arms a thread-local sigjmp buffer:
// a fault inside the guarded region prints the thread's current read
// context and long-jumps back, and the entry returns its error value —
// the caller's per-lane/per-read isolation then fails just that lane
// (better than the reference, which still dies after printing). Faults
// OUTSIDE a guarded region re-raise with the default handler so
// unrelated crashes keep their normal behavior.
// ---------------------------------------------------------------------------
static thread_local sigjmp_buf ga_crash_jmp;
static thread_local volatile int ga_crash_armed = 0;
static thread_local char ga_read_ctx[256] = "unknown";

static void ga_crash_handler(int sig) {
  if (ga_crash_armed) {
    ga_crash_armed = 0;
    siglongjmp(ga_crash_jmp, sig);
  }
  signal(sig, SIG_DFL);
  raise(sig);
}

// Arm/report helpers; GA_GUARD evaluates to nonzero when recovering
// from a fault inside the guarded region.
#define GA_GUARD() \
  (sigsetjmp(ga_crash_jmp, 1) \
       ? (fprintf(stderr, \
                  "Signal %d in native path. Read: %s\n", 11, ga_read_ctx), \
          fflush(stderr), 1) \
       : (ga_crash_armed = 1, 0))
#define GA_UNGUARD() (ga_crash_armed = 0)

extern "C" {

void ga_free(void* p) { free(p); }

// Thread-local read context for crash attribution (reference
// assertSetRead, ThreadReadAssertion.cpp:19-25).
void ga_set_read(const char* name) {
  snprintf(ga_read_ctx, sizeof(ga_read_ctx), "%s",
           name ? name : "unknown");
}

// Install the SIGSEGV/SIGBUS handler (reference AlignerMain.cpp:12-16).
void ga_install_crash_guard() {
  struct sigaction sa;
  memset(&sa, 0, sizeof(sa));
  sa.sa_handler = ga_crash_handler;
  sigemptyset(&sa.sa_mask);
  sa.sa_flags = SA_NODEFER;
  sigaction(SIGSEGV, &sa, nullptr);
  sigaction(SIGBUS, &sa, nullptr);
}

// ---------------------------------------------------------------------------
// gzip
// ---------------------------------------------------------------------------

// Decompress possibly-concatenated gzip members. Returns malloc'd buffer,
// sets *out_len; returns nullptr on error (including truncated streams).
uint8_t* ga_gunzip(const uint8_t* data, int64_t len, int64_t* out_len) {
  size_t cap = (size_t)len * 4 + 4096;
  uint8_t* out = (uint8_t*)malloc(cap);
  if (!out) return nullptr;
  size_t total = 0;

  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 15 + 32) != Z_OK) {  // gzip or zlib
    free(out);
    return nullptr;
  }
  zs.next_in = const_cast<Bytef*>(data);
  zs.avail_in = (uInt)len;
  for (;;) {
    if (total + 65536 > cap) {
      cap = cap * 2;
      uint8_t* n = (uint8_t*)realloc(out, cap);
      if (!n) { free(out); inflateEnd(&zs); return nullptr; }
      out = n;
    }
    zs.next_out = out + total;
    zs.avail_out = (uInt)(cap - total);
    uInt room = zs.avail_out;
    int rc = inflate(&zs, Z_NO_FLUSH);
    // accumulate bytes produced by THIS call: zs.total_out resets on
    // inflateReset2, so it cannot be used across concatenated members
    total += room - zs.avail_out;
    if (rc == Z_STREAM_END) {
      if (zs.avail_in == 0) break;
      // concatenated member: restart
      if (inflateReset2(&zs, 15 + 32) != Z_OK) { free(out); inflateEnd(&zs); return nullptr; }
      continue;
    }
    if (rc == Z_OK || rc == Z_BUF_ERROR) {
      if (zs.avail_in == 0 && rc != Z_STREAM_END) {
        // truncated stream
        free(out);
        inflateEnd(&zs);
        return nullptr;
      }
      continue;
    }
    free(out);
    inflateEnd(&zs);
    return nullptr;
  }
  inflateEnd(&zs);
  *out_len = (int64_t)total;
  return out;
}

// Compress with a deterministic gzip header (mtime=0). Returns malloc'd
// buffer, sets *out_len.
uint8_t* ga_gzip(const uint8_t* data, int64_t len, int level, int64_t* out_len) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, 15 + 16, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return nullptr;
  gz_header head;
  memset(&head, 0, sizeof(head));
  head.os = 3;  // Unix, what the reference's zlib writes (stream.hpp golden)
  deflateSetHeader(&zs, &head);
  size_t cap = deflateBound(&zs, (uLong)len) + 32;
  uint8_t* out = (uint8_t*)malloc(cap);
  if (!out) { deflateEnd(&zs); return nullptr; }
  zs.next_in = const_cast<Bytef*>(data);
  zs.avail_in = (uInt)len;
  zs.next_out = out;
  zs.avail_out = (uInt)cap;
  int rc = deflate(&zs, Z_FINISH);
  if (rc != Z_STREAM_END) { free(out); deflateEnd(&zs); return nullptr; }
  *out_len = (int64_t)zs.total_out;
  deflateEnd(&zs);
  return out;
}

// ---------------------------------------------------------------------------
// vg stream framing: [varint64 count, count x (varint32 size, bytes)]*
// ---------------------------------------------------------------------------

static inline bool read_varint(const uint8_t* d, int64_t len, int64_t* pos,
                               uint64_t* value) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len) {
    uint8_t b = d[*pos];
    (*pos)++;
    result |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *value = result;
      return true;
    }
    shift += 7;
    if (shift >= 70) return false;
  }
  return false;
}

// Pass 1: count messages in framed (uncompressed) data. Returns -1 on error.
int64_t ga_count_messages(const uint8_t* raw, int64_t len) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos < len) {
    uint64_t count;
    if (!read_varint(raw, len, &pos, &count)) return -1;
    for (uint64_t i = 0; i < count; i++) {
      uint64_t size;
      if (!read_varint(raw, len, &pos, &size)) return -1;
      pos += (int64_t)size;
      if (pos > len) return -1;
      n++;
    }
  }
  return n;
}

// Pass 2: fill message offsets/lengths. Returns count or -1.
int64_t ga_frame_messages(const uint8_t* raw, int64_t len, int64_t* offsets,
                          int64_t* lengths, int64_t max_msgs) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos < len) {
    uint64_t count;
    if (!read_varint(raw, len, &pos, &count)) return -1;
    for (uint64_t i = 0; i < count; i++) {
      uint64_t size;
      if (!read_varint(raw, len, &pos, &size)) return -1;
      if (n >= max_msgs) return -1;
      offsets[n] = pos;
      lengths[n] = (int64_t)size;
      pos += (int64_t)size;
      if (pos > len) return -1;
      n++;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// FASTQ/FASTA parsing → (names blob, name offsets, seq blob, seq offsets,
// qual blob) with lengths; the Python side slices strings out.
// ---------------------------------------------------------------------------

struct GaReads {
  std::string names;
  std::string seqs;
  std::string quals;
  std::vector<int64_t> name_off;  // n+1 offsets
  std::vector<int64_t> seq_off;
  std::vector<int64_t> qual_off;
};

static void rstrip_cr(const char** e, const char* b) {
  while (*e > b && ((*e)[-1] == '\r')) (*e)--;
}

// Parse FASTQ (is_fasta=0) or FASTA (is_fasta=1); returns opaque handle.
void* ga_parse_reads(const uint8_t* data, int64_t len, int is_fasta) {
  GaReads* r = new GaReads();
  r->name_off.push_back(0);
  r->seq_off.push_back(0);
  r->qual_off.push_back(0);
  const char* p = (const char*)data;
  const char* end = p + len;
  auto next_line = [&](const char** b, const char** e) {
    if (p >= end) return false;
    *b = p;
    const char* nl = (const char*)memchr(p, '\n', end - p);
    if (!nl) { *e = end; p = end; } else { *e = nl; p = nl + 1; }
    rstrip_cr(e, *b);
    return true;
  };
  const char *b, *e;
  if (!is_fasta) {
    while (next_line(&b, &e)) {
      if (b == e || *b != '@') continue;
      r->names.append(b + 1, e);
      r->name_off.push_back((int64_t)r->names.size());
      if (!next_line(&b, &e)) { b = e = end; }
      r->seqs.append(b, e);
      r->seq_off.push_back((int64_t)r->seqs.size());
      next_line(&b, &e);  // '+'
      if (!next_line(&b, &e)) { b = e = end; }
      r->quals.append(b, e);
      r->qual_off.push_back((int64_t)r->quals.size());
    }
  } else {
    bool have = false;
    while (next_line(&b, &e)) {
      if (b < e && *b == '>') {
        if (have) {
          r->seq_off.push_back((int64_t)r->seqs.size());
          int64_t n = r->seq_off.back() - r->seq_off[r->seq_off.size() - 2];
          r->quals.append((size_t)n, '!');
          r->qual_off.push_back((int64_t)r->quals.size());
        }
        r->names.append(b + 1, e);
        r->name_off.push_back((int64_t)r->names.size());
        have = true;
      } else if (have) {
        r->seqs.append(b, e);
      }
    }
    if (have) {
      r->seq_off.push_back((int64_t)r->seqs.size());
      int64_t n = r->seq_off.back() - r->seq_off[r->seq_off.size() - 2];
      r->quals.append((size_t)n, '!');
      r->qual_off.push_back((int64_t)r->quals.size());
    }
  }
  return r;
}

int64_t ga_reads_count(void* h) { return (int64_t)((GaReads*)h)->name_off.size() - 1; }
const char* ga_reads_names(void* h) { return ((GaReads*)h)->names.data(); }
const char* ga_reads_seqs(void* h) { return ((GaReads*)h)->seqs.data(); }
const char* ga_reads_quals(void* h) { return ((GaReads*)h)->quals.data(); }
const int64_t* ga_reads_name_off(void* h) { return ((GaReads*)h)->name_off.data(); }
const int64_t* ga_reads_seq_off(void* h) { return ((GaReads*)h)->seq_off.data(); }
const int64_t* ga_reads_qual_off(void* h) { return ((GaReads*)h)->qual_off.data(); }
void ga_reads_destroy(void* h) { delete (GaReads*)h; }

// ---------------------------------------------------------------------------
// GFA tokenization → S records (ids + concatenated seqs) and L records
// (from, from_dir, to, to_dir, overlap).
// ---------------------------------------------------------------------------

struct GaGfa {
  std::vector<int64_t> s_ids;
  std::string s_seqs;
  std::vector<int64_t> s_off;  // n+1
  std::vector<int64_t> l_from, l_to, l_overlap;
  std::vector<uint8_t> l_from_minus, l_to_minus;
};

void* ga_parse_gfa(const uint8_t* data, int64_t len) {
  GaGfa* g = new GaGfa();
  g->s_off.push_back(0);
  const char* p = (const char*)data;
  const char* end = p + len;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* le = nl ? nl : end;
    const char* lb = p;
    p = nl ? nl + 1 : end;
    rstrip_cr(&le, lb);
    if (lb >= le) continue;
    if (*lb == 'S') {
      // S\tid\tseq
      const char* t1 = (const char*)memchr(lb, '\t', le - lb);
      if (!t1) continue;
      const char* t2 = (const char*)memchr(t1 + 1, '\t', le - t1 - 1);
      if (!t2) continue;
      const char* t3 = (const char*)memchr(t2 + 1, '\t', le - t2 - 1);
      const char* seq_end = t3 ? t3 : le;
      g->s_ids.push_back(strtoll(t1 + 1, nullptr, 10));
      g->s_seqs.append(t2 + 1, seq_end);
      g->s_off.push_back((int64_t)g->s_seqs.size());
    } else if (*lb == 'L') {
      // L\tfrom\tdir\tto\tdir\toverlapM
      const char* f[6];
      int nf = 0;
      const char* q = lb;
      while (nf < 6 && q < le) {
        const char* t = (const char*)memchr(q, '\t', le - q);
        if (!t) break;
        f[nf++] = t + 1;
        q = t + 1;
      }
      if (nf < 5) continue;
      g->l_from.push_back(strtoll(f[0], nullptr, 10));
      g->l_from_minus.push_back(f[1][0] == '-');
      g->l_to.push_back(strtoll(f[2], nullptr, 10));
      g->l_to_minus.push_back(f[3][0] == '-');
      g->l_overlap.push_back(nf >= 5 ? strtoll(f[4], nullptr, 10) : 0);
    }
  }
  return g;
}

int64_t ga_gfa_num_s(void* h) { return (int64_t)((GaGfa*)h)->s_ids.size(); }
int64_t ga_gfa_num_l(void* h) { return (int64_t)((GaGfa*)h)->l_from.size(); }
const int64_t* ga_gfa_s_ids(void* h) { return ((GaGfa*)h)->s_ids.data(); }
const char* ga_gfa_s_seqs(void* h) { return ((GaGfa*)h)->s_seqs.data(); }
const int64_t* ga_gfa_s_off(void* h) { return ((GaGfa*)h)->s_off.data(); }
const int64_t* ga_gfa_l_from(void* h) { return ((GaGfa*)h)->l_from.data(); }
const int64_t* ga_gfa_l_to(void* h) { return ((GaGfa*)h)->l_to.data(); }
const int64_t* ga_gfa_l_overlap(void* h) { return ((GaGfa*)h)->l_overlap.data(); }
const uint8_t* ga_gfa_l_from_minus(void* h) { return ((GaGfa*)h)->l_from_minus.data(); }
const uint8_t* ga_gfa_l_to_minus(void* h) { return ((GaGfa*)h)->l_to_minus.data(); }
void ga_gfa_destroy(void* h) { delete (GaGfa*)h; }


// ---------------------------------------------------------------------------
// Backtrace move decoder (counterpart of ops/pallas/walk_moves.py).
//
// The walk kernel emits one 4-bit move code per step of a lane; this
// replays them over the host graph to reconstruct the exact
// (graph position, read row) trace of the reference backtrace
// (pickBacktracePredecessor, GraphAligner.h:493-591). Emits FORWARD
// order; the implicit row -1 terminator is dropped (getTraceFromTable,
// GraphAligner.h:894-1021). Returns the number of steps, or -1 on a
// malformed stream / capacity overflow.
//   moves:   packed words, nibble t = the lane's step t (0 = PAD)
//   in_nbrs: [num_nodes * k_in], -1 padded, adjacency order
// ---------------------------------------------------------------------------
static int64_t ga_decode_moves_impl(
    const uint32_t* moves, int64_t n_words, int64_t start_w,
    int64_t start_row, const int64_t* node_start, const int64_t* node_end,
    const int32_t* pos_to_node, const int32_t* in_nbrs, int32_t k_in,
    int64_t cap, int64_t* out_w, int64_t* out_r) {
  int64_t w = start_w, row = start_row, n = 0;
  if (n < cap) { out_w[n] = w; out_r[n] = row; n++; } else return -1;
  for (int64_t t = 0; t < n_words * 8; t++) {
    uint32_t code = (moves[t >> 3] >> (4 * (t & 7))) & 0xF;
    if (code == 0) continue;  // PAD
    int64_t node = pos_to_node[w];
    if (code == 1) {           // STOP: (w, row-1), then terminate
      row -= 1;
    } else if (code == 2) {    // V
      row -= 1;
    } else if (code == 3) {    // H within node
      w -= 1;
    } else if (code == 4) {    // D within node
      w -= 1; row -= 1;
    } else if (code >= 8 && code < 16) {
      int k = (code & 3);
      int32_t nb = in_nbrs[node * k_in + k];
      if (nb < 0) return -1;
      w = node_end[nb] - 1;
      if (code >= 12) row -= 1;  // Dk else Hk
    } else {
      return -1;
    }
    if (row < 0) break;        // the -1-row entry is dropped
    if (n >= cap) return -1;
    out_w[n] = w; out_r[n] = row; n++;
  }
  // reverse to forward order
  for (int64_t i = 0, j = n - 1; i < j; i++, j--) {
    int64_t tw = out_w[i]; out_w[i] = out_w[j]; out_w[j] = tw;
    int64_t tr = out_r[i]; out_r[i] = out_r[j]; out_r[j] = tr;
  }
  return n;
}

int64_t ga_decode_moves(const uint32_t* moves, int64_t n_words,
                        int64_t start_w, int64_t start_row,
                        const int64_t* node_start, const int64_t* node_end,
                        const int32_t* pos_to_node,
                        const int32_t* in_nbrs, int32_t k_in,
                        int64_t cap, int64_t* out_w, int64_t* out_r) {
  if (GA_GUARD()) return -2;  // crash -> caller fails just this lane
  int64_t n = ga_decode_moves_impl(moves, n_words, start_w, start_row,
                                   node_start, node_end, pos_to_node,
                                   in_nbrs, k_in, cap, out_w, out_r);
  GA_UNGUARD();
  return n;
}

// ---------------------------------------------------------------------------
// Per-piece trace finalize: trim + reverse/shift + node runs in one call.
//
// Replaces the per-read Python chain trim_trace -> reverse_trace /
// row-shift -> trace_node_runs (addAlignmentNodes) -> trace_to_runs
// (core/trace_ops.py) whose ~60 numpy-call overheads per read dominate
// the short-read host wall on this 1-core machine. Semantics are an
// exact port of trace_ops.py (reference counterparts: reverseTrace
// GraphAligner.h:3026-3038, addAlignmentNodes 593-633, traceToAlignment
// 782-847).
//   trace:      [n, 2] interleaved (graph position, read row), forward
//               order, rows non-decreasing
//   trim_limit: keep rows < trim_limit (pass < 0 for no trim)
//   do_reverse: map positions through rev_pos, rows to end_row - row,
//               reverse order (backward piece); else rows += shift
//   meta out:   [0]=m final trace length, [1]=nr_full full-run count,
//               [2]=nr_window trace_to_runs run count (0 = None)
// ---------------------------------------------------------------------------
int ga_trace_piece(
    const int64_t* trace, int64_t n, int64_t trim_limit, int32_t do_reverse,
    const int64_t* rev_pos, int64_t end_row, int64_t shift,
    const int32_t* pos_to_node, const int64_t* node_start,
    const int64_t* node_ids, const uint8_t* rev_flags, int32_t dummy_start,
    int32_t dummy_end, int64_t* out_trace, int32_t* fr_node,
    int64_t* fr_rfirst, int64_t* fr_rlast, int32_t* w_node_idx,
    int64_t* w_node_id, uint8_t* w_rev, int64_t* w_offsets,
    int64_t* w_from_len, int64_t* w_to_len, int64_t* w_rstart,
    int64_t* meta) {
  if (GA_GUARD()) return -2;
  // 1. trim: first index with row >= trim_limit (rows non-decreasing)
  int64_t m = n;
  if (trim_limit >= 0) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (trace[2 * mid + 1] < trim_limit) lo = mid + 1; else hi = mid;
    }
    m = lo;
  }
  // 2. transform into out_trace
  if (do_reverse) {
    for (int64_t i = 0; i < m; i++) {
      int64_t src = m - 1 - i;
      out_trace[2 * i] = rev_pos[trace[2 * src]];
      out_trace[2 * i + 1] = end_row - trace[2 * src + 1];
    }
  } else {
    for (int64_t i = 0; i < m; i++) {
      out_trace[2 * i] = trace[2 * i];
      out_trace[2 * i + 1] = trace[2 * i + 1] + shift;
    }
  }
  // 3. full node runs over the final trace (trace_node_runs)
  std::vector<int64_t> run_s;
  run_s.reserve(64);
  int64_t nr = 0;
  int32_t prev_node = -2;
  for (int64_t i = 0; i < m; i++) {
    int32_t node = pos_to_node[out_trace[2 * i]];
    if (node != prev_node) {
      fr_node[nr] = node;
      fr_rfirst[nr] = out_trace[2 * i + 1];
      run_s.push_back(i);
      nr++;
      prev_node = node;
    }
    fr_rlast[nr - 1] = out_trace[2 * i + 1];
  }
  meta[0] = m;
  meta[1] = nr;
  meta[2] = 0;
  // 4. window (trace_to_runs): skip leading dummy-start runs, stop at
  // the dummy end node
  int64_t k = 0;
  while (k < nr && fr_node[k] == dummy_start) k++;
  if (k == nr || fr_node[k] == dummy_end) {
    GA_UNGUARD();
    return 0;  // nr_window = 0 -> trace_to_runs None
  }
  int64_t stop = nr;
  for (int64_t j = k; j < nr; j++) {
    if (fr_node[j] == dummy_end) { stop = j; break; }
  }
  int64_t nw = stop - k;
  for (int64_t j = k; j < stop; j++) {
    int64_t o = j - k;
    int32_t node = fr_node[j];
    int64_t s_idx = run_s[(size_t)j];
    int64_t e_idx = (j + 1 < nr ? run_s[(size_t)(j + 1)] : m) - 1;
    int64_t w_start = out_trace[2 * s_idx];
    int64_t w_end = out_trace[2 * e_idx];
    int64_t r_end = out_trace[2 * e_idx + 1];
    w_node_idx[o] = node;
    w_node_id[o] = node_ids[node];
    w_rev[o] = rev_flags[node];
    w_offsets[o] = (o == 0) ? w_start - node_start[node] : 0;
    w_from_len[o] = w_end - w_start + 1;
    w_rstart[o] = out_trace[2 * s_idx + 1];
    if (o == 0) {
      w_to_len[o] = r_end - out_trace[2 * s_idx + 1];
    } else {
      int64_t pe_idx = run_s[(size_t)j] - 1;  // previous run's last index
      w_to_len[o] = r_end - out_trace[2 * pe_idx + 1];
    }
  }
  w_from_len[nw - 1] -= 1;
  meta[2] = nw;
  GA_UNGUARD();
  return 0;
}

// ---------------------------------------------------------------------------
// Slab variant of ga_trace_piece: all outputs int64 rows of ONE
// caller-provided [11, n+1] slab (rows: 0 fr_node, 1 fr_rfirst,
// 2 fr_rlast, 3 w_node_idx, 4 w_node_id, 5 w_rev, 6 w_offsets,
// 7 w_from_len, 8 w_to_len, 9 w_rstart; row 10 carries meta[0..2]).
// Exists because the 24-pointer ctypes marshalling of ga_trace_piece
// cost ~80us per call — the top host cost of the short-read pipeline
// (BENCH.md round 5). Logic identical to ga_trace_piece.
// ---------------------------------------------------------------------------
int ga_trace_piece2(
    const int64_t* trace, int64_t n, int64_t trim_limit, int32_t do_reverse,
    const int64_t* rev_pos, int64_t end_row, int64_t shift,
    const int32_t* pos_to_node, const int64_t* node_start,
    const int64_t* node_ids, const uint8_t* rev_flags, int32_t dummy_start,
    int32_t dummy_end, int64_t* out_trace, int64_t* slab) {
  if (GA_GUARD()) return -2;
  const int64_t R = n + 1;  // slab row stride
  int64_t* fr_node = slab + 0 * R;
  int64_t* fr_rfirst = slab + 1 * R;
  int64_t* fr_rlast = slab + 2 * R;
  int64_t* w_node_idx = slab + 3 * R;
  int64_t* w_node_id = slab + 4 * R;
  int64_t* w_rev = slab + 5 * R;
  int64_t* w_offsets = slab + 6 * R;
  int64_t* w_from_len = slab + 7 * R;
  int64_t* w_to_len = slab + 8 * R;
  int64_t* w_rstart = slab + 9 * R;
  int64_t* meta = slab + 10 * R;
  // 1. trim
  int64_t m = n;
  if (trim_limit >= 0) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (trace[2 * mid + 1] < trim_limit) lo = mid + 1; else hi = mid;
    }
    m = lo;
  }
  // 2. transform
  if (do_reverse) {
    for (int64_t i = 0; i < m; i++) {
      int64_t src = m - 1 - i;
      out_trace[2 * i] = rev_pos[trace[2 * src]];
      out_trace[2 * i + 1] = end_row - trace[2 * src + 1];
    }
  } else {
    for (int64_t i = 0; i < m; i++) {
      out_trace[2 * i] = trace[2 * i];
      out_trace[2 * i + 1] = trace[2 * i + 1] + shift;
    }
  }
  // 3. full node runs
  std::vector<int64_t> run_s;
  run_s.reserve(64);
  int64_t nr = 0;
  int32_t prev_node = -2;
  for (int64_t i = 0; i < m; i++) {
    int32_t node = pos_to_node[out_trace[2 * i]];
    if (node != prev_node) {
      fr_node[nr] = node;
      fr_rfirst[nr] = out_trace[2 * i + 1];
      run_s.push_back(i);
      nr++;
      prev_node = node;
    }
    fr_rlast[nr - 1] = out_trace[2 * i + 1];
  }
  meta[0] = m;
  meta[1] = nr;
  meta[2] = 0;
  // 4. trace_to_runs window
  int64_t k = 0;
  while (k < nr && fr_node[k] == dummy_start) k++;
  if (k == nr || fr_node[k] == dummy_end) {
    GA_UNGUARD();
    return 0;
  }
  int64_t stop = nr;
  for (int64_t j = k; j < nr; j++) {
    if (fr_node[j] == dummy_end) { stop = j; break; }
  }
  int64_t nw = stop - k;
  for (int64_t j = k; j < stop; j++) {
    int64_t o = j - k;
    int32_t node = (int32_t)fr_node[j];
    int64_t s_idx = run_s[(size_t)j];
    int64_t e_idx = (j + 1 < nr ? run_s[(size_t)(j + 1)] : m) - 1;
    int64_t w_start = out_trace[2 * s_idx];
    int64_t w_end = out_trace[2 * e_idx];
    int64_t r_end = out_trace[2 * e_idx + 1];
    w_node_idx[o] = node;
    w_node_id[o] = node_ids[node];
    w_rev[o] = rev_flags[node];
    w_offsets[o] = (o == 0) ? w_start - node_start[node] : 0;
    w_from_len[o] = w_end - w_start + 1;
    w_rstart[o] = out_trace[2 * s_idx + 1];
    if (o == 0) {
      w_to_len[o] = r_end - out_trace[2 * s_idx + 1];
    } else {
      int64_t pe_idx = run_s[(size_t)j] - 1;
      w_to_len[o] = r_end - out_trace[2 * pe_idx + 1];
    }
  }
  w_from_len[nw - 1] -= 1;
  meta[2] = nw;
  GA_UNGUARD();
  return 0;
}

// ---------------------------------------------------------------------------
// Batched move decode: all lanes of one walk block in ONE call.
//
// The per-lane Python path (thread pool of ctypes ga_decode_moves calls)
// pays a GIL round trip + a strided numpy column copy per lane — ~0.3ms
// each, the dominant cost of _walk_moves_collect on short-read corpora.
// This decodes every lane with an internal std::thread pool (same
// work-stealing pattern as ga_tie_batch), reading each lane's word
// column straight out of the [n_words, B] device-fetch layout.
//   moves:   [n_words * B] row-major, nibble stream of lane i is
//            moves[t*B + cols[i]] over t
//   n_out:   [W] decoded step counts; -1 malformed stream, -2 crash
//   out_w/out_r: [W * cap] per-lane slabs (lane i at offset i*cap)
// ---------------------------------------------------------------------------
int ga_decode_batch(const uint32_t* moves, int64_t n_words, int64_t B,
                    const int32_t* cols, const int64_t* start_w,
                    const int64_t* start_row, const int64_t* node_start,
                    const int64_t* node_end, const int32_t* pos_to_node,
                    const int32_t* in_nbrs, int32_t k_in, int64_t W,
                    int64_t cap, int32_t nthreads, int64_t* out_w,
                    int64_t* out_r, int64_t* n_out) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<uint32_t> lane_words((size_t)n_words);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= W) break;
      snprintf(ga_read_ctx, sizeof(ga_read_ctx), "walk decode lane %lld",
               (long long)i);
      if (GA_GUARD()) {  // crash in this lane only: mark and move on
        n_out[i] = -2;
        continue;
      }
      const int64_t c = cols[i];
      for (int64_t t = 0; t < n_words; t++)
        lane_words[(size_t)t] = moves[t * B + c];
      n_out[i] = ga_decode_moves_impl(
          lane_words.data(), n_words, start_w[i], start_row[i], node_start,
          node_end, pos_to_node, in_nbrs, k_in, cap, out_w + i * cap,
          out_r + i * cap);
      GA_UNGUARD();
    }
  };
  int64_t T = nthreads;
  if (T < 1) T = 1;
  if (T > W) T = W;
  if (T <= 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    ths.reserve((size_t)T);
    for (int64_t t = 0; t < T; t++) ths.emplace_back(worker);
    for (auto& th : ths) th.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Band-insertion-order chain replay (counterpart of
// core/batch_align.py::_band_orders / core/band.py).
//
// Replays projectForwardFromMinScore (reference GraphAligner.h:1110-1159)
// slice by slice, consuming the device-recorded per-node (min, end)
// scores. The insertion ORDER determines the reference's Tarjan
// tie-breaking for min_score_index, so seeding order and heap push
// counters are replicated exactly. Also differentially checks the host
// band set against the device band (topo-sorted slot rows).
//
// Inputs (one lane):
//   band_ids/node_min/node_end: [K * Nm] device tie rows, slice-major.
//     band_ids[k*Nm] holds the device band-row HASH for checked slices
//     (engine_banded band_hash_np), not raw ids.
//   min_scores:                 [K] per-slice minimum
//   bandwidths:                 [K]
//   out_ptr[N+1] int64, out_idx[E] int32, node_len[N] int64,
//   topo_rank[N] int32
// Outputs:
//   orders_out: [K * Nm] node indices, slice-major; counts_out: [K]
// Returns 0 ok; 1 device/host band mismatch; 2 capacity overflow.
// ---------------------------------------------------------------------------
// Reusable scratch for the chain replay: epoch-stamped distance map
// over graph nodes (sized num_nodes, reused across slices AND lanes so
// threaded batch callers pay the allocation once per thread).
struct GaBandScratch {
  std::vector<int32_t> dist, stamp;
  int32_t epoch;
  explicit GaBandScratch(int64_t num_nodes)
      : dist((size_t)num_nodes, 0), stamp((size_t)num_nodes, -1), epoch(0) {}
};

static int ga_band_orders_core(
    const int32_t* band_ids, const int32_t* node_min, const int32_t* node_end,
    const int32_t* min_scores, const int32_t* bandwidths, int64_t K,
    int64_t Nm, int64_t start_node, const int64_t* out_ptr,
    const int32_t* out_idx, const int64_t* node_len, const int32_t* topo_rank,
    int64_t cutoff, int32_t empty_sentinel, const uint8_t* check_mask,
    int32_t* orders_out, int32_t* counts_out, GaBandScratch& scr) {
  const int WORD = 64;
  std::vector<int32_t> nodes(1, (int32_t)start_node);
  std::vector<int32_t> nmin(1, 0), nend(1, 0);
  int32_t mins = 0;
  std::vector<int32_t>& dist = scr.dist;
  std::vector<int32_t>& stamp = scr.stamp;
  // min-heap of (priority, counter, node)
  typedef std::tuple<int32_t, int32_t, int32_t> Entry;
  std::priority_queue<Entry, std::vector<Entry>, std::greater<Entry> > heap;
  std::vector<int32_t> order;
  std::vector<int32_t> perm;
  for (int64_t k = 0; k < K; k++) {
    int32_t ep = ++scr.epoch;
    int32_t bw = bandwidths[k];
    int32_t expand = bw + WORD;
    order.clear();
    while (!heap.empty()) heap.pop();
    int32_t counter = 0;
    int64_t width = 0;
    bool truncated = false;
    for (size_t j = 0; j < nodes.size() && !truncated; j++) {
      if (nmin[j] > mins + bw) continue;
      int32_t node = nodes[j];
      stamp[node] = ep;
      dist[node] = 0;
      order.push_back(node);
      width += node_len[node];
      if (width >= cutoff) { truncated = true; break; }
      if (nend[j] > mins + expand) continue;
      int32_t pri = nend[j] - mins + 1;
      for (int64_t e = out_ptr[node]; e < out_ptr[node + 1]; e++) {
        heap.push(Entry(pri, ++counter, out_idx[e]));
      }
    }
    if (order.empty()) return 1;  // assert distances (band.py)
    while (!heap.empty() && !truncated) {
      Entry top = heap.top();
      heap.pop();
      int32_t pri = std::get<0>(top);
      int32_t node = std::get<2>(top);
      if (pri > expand) break;
      if (stamp[node] == ep && dist[node] <= pri) continue;
      stamp[node] = ep;
      dist[node] = pri;
      order.push_back(node);
      width += node_len[node];
      if (width >= cutoff) { truncated = true; break; }
      int32_t size = (int32_t)node_len[node];
      for (int64_t e = out_ptr[node]; e < out_ptr[node + 1]; e++) {
        heap.push(Entry(pri + size, ++counter, out_idx[e]));
      }
    }
    int64_t n = (int64_t)order.size();
    if (n > Nm) return 2;
    // check against the device band (slot rows are topo-rank sorted)
    perm.resize(n);
    for (int64_t j = 0; j < n; j++) perm[j] = (int32_t)j;
    const int32_t* tr = topo_rank;
    const std::vector<int32_t>& ord = order;
    std::sort(perm.begin(), perm.end(),
              [tr, &ord](int32_t a, int32_t b) {
                return tr[ord[a]] < tr[ord[b]];
              });
    if (check_mask == nullptr || check_mask[k]) {
      // device band-row HASH check (engine_banded ids_sub /
      // band_hash_np — keep the mix in sync): slot-weighted uint32
      // sum over the topo-sorted, EMPTY-padded band row
      const int32_t* brow = band_ids + k * Nm;
      uint32_t h = 0;
      for (int64_t j = 0; j < Nm; j++) {
        uint32_t v = (j < n) ? (uint32_t)order[perm[j]]
                             : (uint32_t)empty_sentinel;
        h += v * (uint32_t)(2654435761u * (uint32_t)(j + 1));
      }
      if (h != (uint32_t)brow[0]) return 1;
    }
    // record + advance: scores of order[perm[j]] live in slot j
    for (int64_t j = 0; j < n; j++) orders_out[k * Nm + j] = order[j];
    counts_out[k] = (int32_t)n;
    nodes = order;
    nmin.resize(n);
    nend.resize(n);
    const int32_t* mrow = node_min + k * Nm;
    const int32_t* erow = node_end + k * Nm;
    for (int64_t j = 0; j < n; j++) {
      nmin[perm[j]] = mrow[j];
      nend[perm[j]] = erow[j];
    }
    mins = min_scores[k];
  }
  return 0;
}

int ga_band_orders(const int32_t* band_ids, const int32_t* node_min,
                   const int32_t* node_end, const int32_t* min_scores,
                   const int32_t* bandwidths, int64_t K, int64_t Nm,
                   int64_t start_node, const int64_t* out_ptr,
                   const int32_t* out_idx, const int64_t* node_len,
                   const int32_t* topo_rank, int64_t num_nodes,
                   int64_t cutoff, int32_t empty_sentinel,
                   const uint8_t* check_mask,
                   int32_t* orders_out, int32_t* counts_out) {
  if (GA_GUARD()) return 3;  // crash -> caller falls back / fails the lane
  GaBandScratch scr(num_nodes);
  int rc = ga_band_orders_core(band_ids, node_min, node_end, min_scores,
                               bandwidths, K, Nm, start_node, out_ptr,
                               out_idx, node_len, topo_rank, cutoff,
                               empty_sentinel, check_mask, orders_out,
                               counts_out, scr);
  GA_UNGUARD();
  return rc;
}

// ---------------------------------------------------------------------------
// vg.Alignment wire encoder (counterpart of io/vg.py Message.encode for
// the alignment path of core/trace_ops.py trace_to_runs/merge_runs).
//
// Builds serialized vg.Alignment protobuf payloads directly from the
// batched pipeline's per-mapping run arrays — the Python object layer
// costs ~1-3ms per long read, this runs in ~10us. Field numbers/order
// match io/vg.py (Alignment: sequence=1, path=2, name=3, score=6,
// query_position=7; Path: mapping=2; Mapping: position=1, edit=2,
// rank=5; Position: node_id=1, offset=2, is_reverse=4; Edit:
// from_length=1, to_length=2, sequence=3), proto3 defaults skipped.
// ---------------------------------------------------------------------------

static inline int vlen(uint64_t v) {
  int n = 1;
  while (v >= 0x80) { v >>= 7; n++; }
  return n;
}

static inline void put_varint(std::string& out, uint64_t v) {
  while (v >= 0x80) { out.push_back((char)(0x80 | (v & 0x7F))); v >>= 7; }
  out.push_back((char)v);
}

static inline void put_tag(std::string& out, int field, int wt) {
  put_varint(out, (uint64_t)((field << 3) | wt));
}

// One alignment's encoded size pieces -------------------------------------
struct MapSizes {
  int64_t pos_len;   // Position payload bytes
  int64_t edit_len;  // Edit payload bytes
  int64_t map_len;   // Mapping payload bytes
};

// Encode alignments from run arrays. All mapping arrays are the
// concatenation over lanes; map_off[n+1] delimits each lane's runs.
// rstart indexes into the lane's sequence. div2 halves node ids
// (digraph -> bigraph, Aligner.cpp:83-91). Returns a malloc'd buffer
// (caller frees with ga_free) and fills out_off[n+1] payload offsets.
static uint8_t* ga_encode_alignments_impl(
    const char* names, const int64_t* name_off,
    const char* seqs, const int64_t* seq_off,
    const int64_t* score, const int64_t* qpos, int64_t n,
    const int64_t* node_id, const int64_t* offset, const uint8_t* rev,
    const int64_t* rank, const int64_t* from_len, const int64_t* to_len,
    const int64_t* rstart, const int64_t* map_off,
    int div2, int64_t* out_off) {
  std::string out;
  out.reserve((size_t)(seq_off[n] + map_off[n] * 16 + 64 * n));
  std::vector<MapSizes> ms;
  out_off[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t m0 = map_off[i], m1 = map_off[i + 1];
    ms.resize(m1 - m0);
    int64_t path_len = 0;
    for (int64_t m = m0; m < m1; m++) {
      int64_t nid = div2 ? node_id[m] / 2 : node_id[m];
      int64_t pos_len = 0;
      if (nid) pos_len += 1 + vlen((uint64_t)nid);
      if (offset[m]) pos_len += 1 + vlen((uint64_t)offset[m]);
      if (rev[m]) pos_len += 2;
      int64_t edit_len = 0;
      if (from_len[m]) edit_len += 1 + vlen((uint64_t)from_len[m]);
      if (to_len[m]) edit_len += 1 + vlen((uint64_t)to_len[m]) +
                                 1 + vlen((uint64_t)to_len[m]) + to_len[m];
      // Edit.sequence written iff to_length > 0 (the slice is that long)
      int64_t map_len = 1 + vlen((uint64_t)pos_len) + pos_len +
                        1 + vlen((uint64_t)edit_len) + edit_len;
      if (rank[m]) map_len += 1 + vlen((uint64_t)rank[m]);
      ms[m - m0] = {pos_len, edit_len, map_len};
      path_len += 1 + vlen((uint64_t)map_len) + map_len;
    }
    int64_t nm_len = name_off[i + 1] - name_off[i];
    int64_t sq_len = seq_off[i + 1] - seq_off[i];
    // Alignment fields in number order
    if (sq_len) {
      put_tag(out, 1, 2);
      put_varint(out, (uint64_t)sq_len);
      out.append(seqs + seq_off[i], (size_t)sq_len);
    }
    put_tag(out, 2, 2);
    put_varint(out, (uint64_t)path_len);
    const char* seq = seqs + seq_off[i];
    for (int64_t m = m0; m < m1; m++) {
      const MapSizes& z = ms[m - m0];
      put_tag(out, 2, 2);  // Path.mapping
      put_varint(out, (uint64_t)z.map_len);
      put_tag(out, 1, 2);  // Mapping.position
      put_varint(out, (uint64_t)z.pos_len);
      int64_t nid = div2 ? node_id[m] / 2 : node_id[m];
      if (nid) { put_tag(out, 1, 0); put_varint(out, (uint64_t)nid); }
      if (offset[m]) { put_tag(out, 2, 0); put_varint(out, (uint64_t)offset[m]); }
      if (rev[m]) { put_tag(out, 4, 0); put_varint(out, 1); }
      put_tag(out, 2, 2);  // Mapping.edit
      put_varint(out, (uint64_t)z.edit_len);
      if (from_len[m]) { put_tag(out, 1, 0); put_varint(out, (uint64_t)from_len[m]); }
      if (to_len[m]) {
        put_tag(out, 2, 0); put_varint(out, (uint64_t)to_len[m]);
        put_tag(out, 3, 2); put_varint(out, (uint64_t)to_len[m]);
        out.append(seq + rstart[m], (size_t)to_len[m]);
      }
      if (rank[m]) { put_tag(out, 5, 0); put_varint(out, (uint64_t)rank[m]); }
    }
    if (nm_len) {
      put_tag(out, 3, 2);
      put_varint(out, (uint64_t)nm_len);
      out.append(names + name_off[i], (size_t)nm_len);
    }
    if (score[i]) { put_tag(out, 6, 0); put_varint(out, (uint64_t)score[i]); }
    if (qpos[i]) { put_tag(out, 7, 0); put_varint(out, (uint64_t)qpos[i]); }
    out_off[i + 1] = (int64_t)out.size();
  }
  uint8_t* buf = (uint8_t*)malloc(out.size() ? out.size() : 1);
  if (!buf) return nullptr;
  memcpy(buf, out.data(), out.size());
  return buf;
}

uint8_t* ga_encode_alignments(
    const char* names, const int64_t* name_off,
    const char* seqs, const int64_t* seq_off,
    const int64_t* score, const int64_t* qpos, int64_t n,
    const int64_t* node_id, const int64_t* offset, const uint8_t* rev,
    const int64_t* rank, const int64_t* from_len, const int64_t* to_len,
    const int64_t* rstart, const int64_t* map_off,
    int div2, int64_t* out_off) {
  if (GA_GUARD()) return nullptr;  // crash -> Python encode fallback
  uint8_t* buf = ga_encode_alignments_impl(
      names, name_off, seqs, seq_off, score, qpos, n, node_id, offset, rev,
      rank, from_len, to_len, rstart, map_off, div2, out_off);
  GA_UNGUARD();
  return buf;
}


// ---------------------------------------------------------------------------
// Banded slice DP (the giant-band host path).
//
// Scalar specification of one 64-row banded slice exactly as
// core/oracle.py::compute_slice defines it (itself the distilled
// semantics of the reference's calculateSlice/getNextSlice,
// GraphAligner.h:2331-2451, 1349-1427): row j-1 min-closure, then 64
// rows of vertical/diagonal seeding + horizontal min-closure over the
// band. The closures use a Dial bucket queue (unit edge weights), so a
// 200k-cell slice costs O(64 * C) instead of the Python oracle's
// heap-based minutes — the performance replacement for the reference's
// calculateSliceAlternate sparse method (GraphAligner.h:2148-2329,
// switch at 2483): identical values, sparse bucket propagation,
// native speed.
// ---------------------------------------------------------------------------

static const int64_t GA_BIG = ((int64_t)1) << 40;

struct SliceClosure {
  int C;
  const uint8_t* chain;      // [C] 1 if cell c-1 -> c is a within-node edge
  const int64_t* edge_ptr;   // [C+1] CSR: cross-edges out of cell c
  const int32_t* edge_to;    // [edge_ptr[C]]
  std::vector<std::vector<int32_t>> buckets;
  int64_t sweeps = 0;        // GA_SLICE_STATS telemetry
  int64_t dial_calls = 0;
  int64_t heap_calls = 0;

  int n_edges_total = 0;
  const int32_t* edge_from_flat = nullptr;  // parallel to edge_to (flat)

  void run(int64_t* d) {
    // Fast path: forward chain sweeps + cross-edge relaxation to the
    // fixpoint. Band cross-edges (node-last -> successor-first) have
    // tiny depth (a handful of sweeps even on 200k-cell bands), and the
    // linear sweep is cache-friendly where the bucket queue thrashes.
    // Pathological cyclic bands fall back to the Dial queue.
    for (int iter = 0; iter < 80; iter++) {
      sweeps++;
      for (int c = 1; c < C; c++)
        if (chain[c] && d[c - 1] + 1 < d[c]) d[c] = d[c - 1] + 1;
      bool changed = false;
      for (int c = 0; c < C; c++) {
        for (int64_t e = edge_ptr[c]; e < edge_ptr[c + 1]; e++) {
          int t = edge_to[e];
          if (d[c] + 1 < d[t]) {
            d[t] = d[c] + 1;
            changed = true;
          }
        }
      }
      if (!changed) return;
    }
    run_dial(d);
  }

  // Heap Dijkstra fallback for pathological value spreads: identical
  // result to run_dial, no bucket-range assumption at all.
  void run_heap(int64_t* d) {
    heap_calls++;
    typedef std::pair<int64_t, int32_t> Ent;
    std::priority_queue<Ent, std::vector<Ent>, std::greater<Ent>> pq;
    for (int c = 0; c < C; c++)
      if (d[c] < GA_BIG) pq.push(Ent(d[c], c));
    while (!pq.empty()) {
      Ent top = pq.top();
      pq.pop();
      int c = top.second;
      if (top.first != d[c]) continue;  // stale entry
      int64_t nd = d[c] + 1;
      if (c + 1 < C && chain[c + 1] && nd < d[c + 1]) {
        d[c + 1] = nd;
        pq.push(Ent(nd, c + 1));
      }
      for (int64_t e = edge_ptr[c]; e < edge_ptr[c + 1]; e++) {
        int t = edge_to[e];
        if (nd < d[t]) {
          d[t] = nd;
          pq.push(Ent(nd, t));
        }
      }
    }
  }

  void run_dial(int64_t* d) {
    dial_calls++;
    int64_t dmin = GA_BIG, dmax = -GA_BIG;
    for (int c = 0; c < C; c++) {
      if (d[c] >= GA_BIG) continue;
      if (d[c] < dmin) dmin = d[c];
      if (d[c] > dmax) dmax = d[c];
    }
    if (dmin >= GA_BIG) return;
    // The bucket range must cover the full FINITE input spread (DP
    // scores routinely span more than C+1: band-source seeds at
    // seq_len+1 vs small old_end scores) PLUS the closure's growth
    // headroom: relaxation chains add +1 per step, so a cell reachable
    // only through a k-step chain from the nearest seed ends at
    // seed+k — up to dmax + C in the worst case. A bucket index beyond
    // the range would mean a relaxed cell never re-queues and its
    // successors silently keep stale values (caught by
    // test_native_slice_dial_and_heap_fallbacks's reversed-band
    // ladder). Absurd spreads take the heap.
    int64_t spread = dmax - dmin + 2 + (int64_t)C;
    if (spread > (int64_t)(1 << 22)) {
      run_heap(d);
      return;
    }
    int range = (int)spread;
    if ((int)buckets.size() < range) buckets.resize(range);
    for (int c = 0; c < C; c++) {
      int64_t off = d[c] - dmin;
      if (off < range) buckets[off].push_back(c);
    }
    for (int b = 0; b < range; b++) {
      auto& bk = buckets[b];
      for (size_t i = 0; i < bk.size(); i++) {
        int c = bk[i];
        if (d[c] != dmin + b) continue;  // stale entry
        int64_t nd = d[c] + 1;
        int64_t noff = nd - dmin;
        if (c + 1 < C && chain[c + 1] && nd < d[c + 1]) {
          d[c + 1] = nd;
          if (noff < range) buckets[noff].push_back(c + 1);
        }
        for (int64_t e = edge_ptr[c]; e < edge_ptr[c + 1]; e++) {
          int t = edge_to[e];
          if (nd < d[t]) {
            d[t] = nd;
            if (noff < range) buckets[noff].push_back(t);
          }
        }
      }
      bk.clear();
    }
  }
};

static int64_t ga_compute_slice_impl(
    int64_t C,
    const uint8_t* chain,        // [C]
    const int64_t* edge_ptr,     // [C+1]
    const int32_t* edge_to,      // cross-edges (node-last -> succ-first)
    int64_t n_sp,
    const int32_t* sp_cell,      // start-pred pairs
    const int32_t* sp_pred,
    int64_t n_ps,
    const int32_t* ps_cell,      // pseudo pairs
    const int64_t* ps_old,
    int64_t n_fs,
    const int32_t* fs_cell,      // free-start cells (slice 0 only)
    const uint8_t* match,        // [64 * C] row-major
    const int64_t* seed_sbs,     // [C] initial row j-1 values (GA_BIG absent)
    const int64_t* old_end,      // [C] previous slice last-row scores
    const uint8_t* old_flags,    // [C] bit0 = old_end_exists, bit1 = in_prev
    int64_t slice_index,
    int64_t* sbs,                // out [C] (closed row j-1)
    uint8_t* sbs_exists,         // out [C]
    int64_t* rows                // out [64 * C]
) {
  if (C <= 0) return 0;
  SliceClosure cl;
  cl.C = (int)C;
  cl.chain = chain;
  cl.edge_ptr = edge_ptr;
  cl.edge_to = edge_to;

  // row j-1 closure, then the existence stamping
  // (oracle.py: in_prev & (old_end == sbs) & old_end_exists)
  for (int64_t c = 0; c < C; c++) sbs[c] = seed_sbs[c];
  cl.run(sbs);
  for (int64_t c = 0; c < C; c++)
    sbs_exists[c] =
        ((old_flags[c] & 2) && sbs[c] == old_end[c] && (old_flags[c] & 1))
            ? 1
            : 0;

  const int64_t* prev = nullptr;
  for (int r = 0; r < 64; r++) {
    // compute directly into the output row (one less 1.6MB copy per
    // row on 200k-cell bands)
    int64_t* cur = rows + (size_t)r * C;
    const uint8_t* mrow = match + (size_t)r * C;
    const int64_t* diag = (r == 0) ? sbs : prev;
    // vertical
    for (int64_t c = 0; c < C; c++) {
      int64_t v = diag[c] + 1;
      // within-node diagonal
      if (chain[c]) {
        int64_t cost =
            (mrow[c] && (r > 0 || sbs_exists[c - 1])) ? 0 : 1;
        int64_t cand = diag[c - 1] + cost;
        if (cand < v) v = cand;
      }
      cur[c] = v;
    }
    // node-start diagonals from banded in-neighbors
    for (int64_t i = 0; i < n_sp; i++) {
      int32_t cell = sp_cell[i], p = sp_pred[i];
      int64_t cost = (mrow[cell] && (r > 0 || sbs_exists[p])) ? 0 : 1;
      int64_t cand = diag[p] + cost;
      if (cand < cur[cell]) cur[cell] = cand;
    }
    // pseudo columns from previous-band-only in-neighbors
    for (int64_t i = 0; i < n_ps; i++) {
      int32_t cell = ps_cell[i];
      int64_t cand = (r == 0) ? ps_old[i] + (mrow[cell] ? 0 : 1)
                              : ps_old[i] + r + 1;
      if (cand < cur[cell]) cur[cell] = cand;
    }
    // free-start diagonal at the very first slice
    if (r == 0 && slice_index == 0) {
      for (int64_t i = 0; i < n_fs; i++) {
        int32_t f = fs_cell[i];
        int64_t cand = sbs[f] + (mrow[f] ? 0 : 1);
        if (cand < cur[f]) cur[f] = cand;
      }
    }
    cl.run(cur);
    prev = cur;
  }
  if (getenv("GA_SLICE_STATS")) {
    fprintf(stderr,
            "ga_compute_slice C=%lld sweeps=%lld dial=%lld heap=%lld\n",
            (long long)C, (long long)cl.sweeps, (long long)cl.dial_calls,
            (long long)cl.heap_calls);
  }
  return 1;
}

int64_t ga_compute_slice(
    int64_t C, const uint8_t* chain, const int64_t* edge_ptr,
    const int32_t* edge_to, int64_t n_sp, const int32_t* sp_cell,
    const int32_t* sp_pred, int64_t n_ps, const int32_t* ps_cell,
    const int64_t* ps_old, int64_t n_fs, const int32_t* fs_cell,
    const uint8_t* match, const int64_t* seed_sbs, const int64_t* old_end,
    const uint8_t* old_flags, int64_t slice_index, int64_t* sbs,
    uint8_t* sbs_exists, int64_t* rows) {
  if (GA_GUARD()) return 0;  // crash -> caller falls back to the oracle
  int64_t ok = ga_compute_slice_impl(
      C, chain, edge_ptr, edge_to, n_sp, sp_cell, sp_pred, n_ps, ps_cell,
      ps_old, n_fs, fs_cell, match, seed_sbs, old_end, old_flags,
      slice_index, sbs, sbs_exists, rows);
  GA_UNGUARD();
  return ok;
}

// ---------------------------------------------------------------------------
// Multi-node tie resolution (counterpart of the banded-Tarjan scan in
// core/batch_align.py::resolve_tie / oracle.py::_banded_tarjan,
// reference min_score_index.back(), GraphAligner.h:1751-1901 +
// 2359-2366): given the final slice's band INSERTION order and its
// per-cell last-row scores, emit the winning backtrace start position.
//
// Replicates the Python exactly: Tarjan roots in band order,
// out-neighbors in CSR adjacency order, components sinks-first; the
// winner is whatever `last` holds after scanning reversed(components)
// x reversed(component) and overwriting with each node's last tied
// offset. Cell offsets follow the topo-rank-sorted (device slot)
// layout, not insertion order.
//
// Returns the winning graph position, or -1 when no cell holds `best`
// (host/device divergence; the caller fails the lane).
// ---------------------------------------------------------------------------
static int64_t ga_tie_start_impl(const int32_t* order, int64_t n,
                                 const int64_t* out_ptr,
                                 const int32_t* out_idx,
                                 const int64_t* node_len,
                                 const int64_t* node_start,
                                 const int32_t* topo_rank,
                                 const int32_t* sends, int64_t n_sends,
                                 int32_t best) {
  if (n <= 0) return -1;
  // layout: stable sort of the band by topo rank = the device slot
  // order the sends cells follow
  std::vector<int32_t> perm((size_t)n);
  for (int64_t j = 0; j < n; j++) perm[(size_t)j] = (int32_t)j;
  std::stable_sort(perm.begin(), perm.end(),
                   [order, topo_rank](int32_t a, int32_t b) {
                     return topo_rank[order[a]] < topo_rank[order[b]];
                   });
  // per-node (cell offset, length); n <= 32 so linear lookup is fine
  std::vector<int32_t> lnode((size_t)n);
  std::vector<int64_t> loff((size_t)n);
  int64_t off = 0;
  for (int64_t j = 0; j < n; j++) {
    int32_t nd = order[perm[(size_t)j]];
    lnode[(size_t)j] = nd;
    loff[(size_t)j] = off;
    off += node_len[nd];
  }
  if (off > n_sends) return -1;  // layout/sends length mismatch
  // iterative banded Tarjan (oracle.py::_banded_tarjan)
  std::vector<int32_t> idx((size_t)n, -1), low((size_t)n, 0);
  std::vector<uint8_t> onstk((size_t)n, 0);
  std::vector<int32_t> stk;
  std::vector<std::pair<int32_t, int64_t> > work;  // (band slot, cursor)
  std::vector<std::vector<int32_t> > comps;  // band-slot components
  auto slot_of = [&](int32_t nd) -> int32_t {
    for (int64_t j = 0; j < n; j++)
      if (order[j] == nd) return (int32_t)j;
    return -1;
  };
  int32_t counter = 0;
  for (int64_t r = 0; r < n; r++) {
    if (idx[(size_t)r] >= 0) continue;
    idx[(size_t)r] = low[(size_t)r] = counter++;
    stk.push_back((int32_t)r);
    onstk[(size_t)r] = 1;
    work.clear();
    work.push_back(std::make_pair((int32_t)r, out_ptr[order[r]]));
    while (!work.empty()) {
      int32_t v = work.back().first;
      int64_t cur = work.back().second;
      int64_t end = out_ptr[order[v] + 1];
      bool advanced = false;
      while (cur < end) {
        int32_t w = slot_of(out_idx[cur]);
        cur++;
        if (w < 0) continue;  // not in band
        if (idx[(size_t)w] < 0) {
          work.back().second = cur;
          idx[(size_t)w] = low[(size_t)w] = counter++;
          stk.push_back(w);
          onstk[(size_t)w] = 1;
          work.push_back(std::make_pair(w, out_ptr[order[w]]));
          advanced = true;
          break;
        } else if (onstk[(size_t)w]) {
          if (idx[(size_t)w] < low[(size_t)v]) low[(size_t)v] = idx[(size_t)w];
        }
      }
      if (advanced) continue;
      work.pop_back();
      if (!work.empty()) {
        int32_t parent = work.back().first;
        if (low[(size_t)v] < low[(size_t)parent])
          low[(size_t)parent] = low[(size_t)v];
      }
      if (low[(size_t)v] == idx[(size_t)v]) {
        comps.push_back(std::vector<int32_t>());
        while (true) {
          int32_t w = stk.back();
          stk.pop_back();
          onstk[(size_t)w] = 0;
          comps.back().push_back(w);
          if (w == v) break;
        }
      }
    }
  }
  // reversed(comps) x reversed(comp), overwriting `last` with each tied
  // node's last minimum offset (exact Python scan order)
  int64_t last = -1;
  for (size_t c = comps.size(); c-- > 0;) {
    const std::vector<int32_t>& comp = comps[c];
    for (size_t t = comp.size(); t-- > 0;) {
      int32_t nd = order[comp[t]];
      // locate the node's cell span in the slot layout
      int64_t f = -1, L = node_len[nd];
      for (int64_t j = 0; j < n; j++)
        if (lnode[(size_t)j] == nd) { f = loff[(size_t)j]; break; }
      if (f < 0) continue;
      int32_t mn = sends[f];
      for (int64_t k2 = 1; k2 < L; k2++)
        if (sends[f + k2] < mn) mn = sends[f + k2];
      if (mn != best) continue;
      for (int64_t k2 = 0; k2 < L; k2++)
        if (sends[f + k2] == best) last = node_start[nd] + k2;
    }
  }
  return last;
}

int64_t ga_tie_start(const int32_t* order, int64_t n,
                     const int64_t* out_ptr, const int32_t* out_idx,
                     const int64_t* node_len, const int64_t* node_start,
                     const int32_t* topo_rank, const int32_t* sends,
                     int64_t n_sends, int32_t best) {
  if (GA_GUARD()) return -1;  // crash -> caller fails just this lane
  int64_t pos = ga_tie_start_impl(order, n, out_ptr, out_idx, node_len,
                                  node_start, topo_rank, sends, n_sends,
                                  best);
  GA_UNGUARD();
  return pos;
}

// ---------------------------------------------------------------------------
// Batched multi-node tie resolution: chain replay (ga_band_orders_core)
// + final-slice last-min scan (ga_tie_start) for W lanes in one call,
// striped over an internal thread pool. The per-lane Python dispatch
// overhead (numpy prep + two ctypes calls per lane, GIL-held) was the
// walk-starts phase's host bottleneck on short-read corpora (~375
// replays per sim600 chunk); here the host makes ONE call and the
// lanes run on C++ threads.
//
// Inputs are lane-major: band_ids/node_min/node_end [W*Kmax*Nm],
// min_scores/bandwidths [W*Kmax], check_mask [W*Kmax], sends [W*Cm]
// (final-slice per-cell last-row scores), Ks/start_nodes/bests [W].
// Outputs: pos_out [W] winning positions (-1 = no tie winner /
// divergence), rc_out [W] per-lane chain-replay rc (0 ok, 1 device/
// host band mismatch, 2 capacity overflow).
// ---------------------------------------------------------------------------
int ga_tie_batch(const int32_t* band_ids, const int32_t* node_min,
                 const int32_t* node_end, const int32_t* min_scores,
                 const int32_t* bandwidths, const int32_t* Ks,
                 const int32_t* start_nodes, const uint8_t* check_mask,
                 const int32_t* sends, const int32_t* bests, int64_t W,
                 int64_t Kmax, int64_t Nm, int64_t Cm, const int64_t* out_ptr,
                 const int32_t* out_idx, const int64_t* node_len,
                 const int64_t* node_start, const int32_t* topo_rank,
                 int64_t num_nodes, int64_t cutoff, int32_t empty_sentinel,
                 int32_t nthreads, int64_t* pos_out, int32_t* rc_out) {
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    GaBandScratch scr(num_nodes);
    std::vector<int32_t> orders((size_t)(Kmax * Nm));
    std::vector<int32_t> counts((size_t)Kmax);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= W) break;
      int64_t K = Ks[i];
      if (K <= 0) { rc_out[i] = 1; pos_out[i] = -1; continue; }
      snprintf(ga_read_ctx, sizeof(ga_read_ctx), "tie lane %lld",
               (long long)i);
      if (GA_GUARD()) {  // crash in this lane only: mark and move on
        rc_out[i] = 3;
        pos_out[i] = -1;
        continue;
      }
      int rc = ga_band_orders_core(
          band_ids + i * Kmax * Nm, node_min + i * Kmax * Nm,
          node_end + i * Kmax * Nm, min_scores + i * Kmax,
          bandwidths + i * Kmax, K, Nm, start_nodes[i], out_ptr, out_idx,
          node_len, topo_rank, cutoff, empty_sentinel,
          check_mask + i * Kmax, orders.data(), counts.data(), scr);
      rc_out[i] = rc;
      if (rc != 0) {
        pos_out[i] = -1;
      } else {
        int64_t n = counts[(size_t)(K - 1)];
        pos_out[i] = ga_tie_start_impl(orders.data() + (K - 1) * Nm, n,
                                       out_ptr, out_idx, node_len,
                                       node_start, topo_rank,
                                       sends + i * Cm, Cm, bests[i]);
      }
      GA_UNGUARD();
    }
  };
  int64_t T = nthreads;
  if (T < 1) T = 1;
  if (T > W) T = W;
  if (T <= 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    ths.reserve((size_t)T);
    for (int64_t t = 0; t < T; t++) ths.emplace_back(worker);
    for (auto& th : ths) th.join();
  }
  return 0;
}

}  // extern "C"
