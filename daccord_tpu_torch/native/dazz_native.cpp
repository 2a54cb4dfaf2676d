// The port's host library: the feeder half and the window-consensus engine
// of the JAX package's C++ host library, copied into the port so that the
// port builds and loads its own.
//
// - las_scan / las_load: the columnar LAS loader (two passes: totals, then
//   caller-allocated columns; 1- or 2-byte trace points by tspace).
// - process_pile: one pile -> window tensors. Every overlap's trace tiles are
//   realigned to a base-accurate prefix map (align_path), windows are cut
//   along the A read, and the spanning B segments are written into
//   [nwin, D, L] rows.
// - suffix_prefix: the stitch splice (best suffix(a) x prefix(b)).
// - decode_reads: 2-bit .bps batch decode.
// - edit_distance_sum, align_map, infix_distance: exact unit-cost distances.
// - solve_windows: the tier ladder over a batch of windows on the host, the
//   engine of --backend native and the supervisor's native failover.
// - hp_rescue_windows: the homopolymer rescue over a batch's results
//   (oracle/hp.py semantics, byte-equal to its python loop).
// - las_sort / las_merge: the bounded-memory external LAS sort and the k-way
//   merge of sorted LAS files (formats/extsort.py's python path is their
//   plain version, byte-equal for the same mem_records).
// - take_rows / take_pages: the shadow audit's row take of a dispatched
//   batch (audit/worker.py take_rows; its numpy body is the plain version),
//   called with the interpreter lock held, so the take never waits to get
//   it back from the feeder threads.
//
// A plain C ABI for ctypes, built with g++ by daccord_tpu_torch/native. The
// realignment replicates the numpy align_path of daccord_tpu_torch/oracle/
// align.py exactly (unit-cost DP, backtrack preferring diagonal, then
// deletion, then insertion, a2b[0] = 0), so the native and numpy feeders
// write byte-identical windows.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <queue>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int8_t PAD = 4;

constexpr int32_t DP_INF = 1 << 28;

// One banded DP fill (Ukkonen): only cells with lo_d <= j - i <= hi_d are
// computed; cells one past each band edge hold DP_INF sentinels so both the
// next row's reads and the backtrack see +inf outside the band. Returns the
// banded distance (>= the true distance; equal when the band held).
static int32_t fill_banded(const int8_t* a, int n, const int8_t* b, int m,
                           int32_t* D, int W, int lo_d, int hi_d) {
  static thread_local std::vector<int32_t> cbuf_v;
  cbuf_v.resize(W + 1);
  int32_t* cbuf = cbuf_v.data();
  {
    const int jhi = std::min(m, hi_d);
    for (int j = 0; j <= jhi; ++j) D[j] = j;
    if (jhi < m) D[jhi + 1] = DP_INF;
  }
  for (int i = 1; i <= n; ++i) {
    int32_t* row = D + (size_t)i * W;
    const int32_t* prev = row - W;
    const int jlo = std::max(0, i + lo_d);
    const int jhi = std::min(m, i + hi_d);
    if (jlo > jhi) return DP_INF;
    if (jlo > 0) row[jlo - 1] = DP_INF;
    if (jhi < m) row[jhi + 1] = DP_INF;
    const int8_t ai = a[i - 1];
    int j = jlo;
    if (j == 0) { row[0] = i; ++j; }
    // pass 1 (no loop-carried dependency -> SIMD): substitution/deletion
    // candidates from the previous row
    for (int j2 = j; j2 <= jhi; ++j2) {
      const int32_t sub = prev[j2 - 1] + (b[j2 - 1] != ai);
      const int32_t del = prev[j2] + 1;
      cbuf[j2] = del < sub ? del : sub;
    }
    // pass 2 (serial but 2 ops/cell): fold in the insertion chain
    int32_t run = row[j - 1];
    for (int j2 = j; j2 <= jhi; ++j2) {
      ++run;
      if (cbuf[j2] < run) run = cbuf[j2];
      row[j2] = run;
    }
  }
  return D[(size_t)n * W + m];
}

// full unit-cost edit DP with backtrack -> prefix map a2b (len n+1).
// Banded with verify-retry: when the returned distance d satisfies d < band
// slack B, every cell of every optimal path is interior to the band, those
// cells' banded values are exact, and the backtrack equalities decide
// identically to the full matrix — so the result is bit-identical to the
// full DP (the numpy align_path) by construction, at ~half the
// cells for typical ~15%-error trace tiles. d >= B doubles the band.
// verify-retry loop: fill with a band of slack B, accept when d < B (every
// optimal path provably interior -> exact), else double. Leaves D filled for
// backtrack. The ONE copy of the exactness rule (align_path AND
// edit_distance_sum call it).
static int32_t fill_exact(const int8_t* a, int n, const int8_t* b, int m,
                          int32_t* D, int W, int32_t band_hint) {
  const int diff_lo = std::min(0, m - n), diff_hi = std::max(0, m - n);
  for (int32_t B = std::max(4, band_hint);; B *= 2) {
    if (diff_hi - diff_lo + 2 * B >= m)   // band no narrower than full width
      return fill_banded(a, n, b, m, D, W, -n, m);
    const int32_t d = fill_banded(a, n, b, m, D, W, diff_lo - B, diff_hi + B);
    if (d < B) return d;
  }
}

// ---------------------------------------------------------------------------
// Hyyro/Myers bit-parallel exact DP
// ---------------------------------------------------------------------------
// Unbanded and EXACT by construction (no verify-retry needed): the b side
// packs into K = ceil(m/64) words and each a row costs ~17 ops/word instead
// of 2-3 ops/cell. Per-row VP/VN (the deltas D[i][j]-D[i][j-1] along b) are
// stored — 16 bytes/row/word vs the int32 matrix's 4 bytes/cell — and the
// backtrack recovers the EXACT SAME decisions as the matrix walk from delta
// bits: with V = D[i][j]-D[i-1][j] (the step's HP/HN, recomputed per visited
// row from the stored previous-row VP/VN) and Hp = D[i-1][j]-D[i-1][j-1]
// (stored), the matrix conditions rewrite as
//     diagonal:  D[i][j] == D[i-1][j-1] + c   <=>  V + Hp == c
//     deletion:  D[i][j] == D[i-1][j] + 1     <=>  V == +1
// evaluated in the identical diagonal > deletion > insertion order, so a2b
// is bit-identical to the int32 backtrack (sealed by parity tests).
constexpr int MYERS_MAX_M = 256;   // 4 words; wider falls back to the matrix

struct MyersScratch {
  std::vector<uint64_t> peq;   // [5][K] match masks (incl. PAD=4: the
  //                              backtrack compares a!=b directly, so the
  //                              fill must also treat PAD==PAD as a match)
  std::vector<uint64_t> vp, vn;  // per-row stored deltas, (n+1)*K
  std::vector<uint64_t> hp, hn;  // K words, scratch for one step
  std::vector<uint64_t> t0, t1;  // discarded VP/VN outputs (backtrack
  //                                recompute wants HP/HN only; outputs must
  //                                NOT alias hp/hn — the step interleaves
  //                                HP/VP writes per word)
};

// one Myers step: from row i-1's VP/VN produce row i's, plus the step's
// HP/HN (= vertical deltas V(i, :) in matrix terms). Multi-word with carry.
static inline void myers_step(const uint64_t* peq_t, const uint64_t* VPp,
                              const uint64_t* VNp, uint64_t* HP, uint64_t* HN,
                              uint64_t* VP, uint64_t* VN, int K) {
  uint64_t carry = 0, hp_in = 1, hn_in = 0;   // hp_in=1: column 0 walks down
  for (int w = 0; w < K; ++w) {
    const uint64_t X = peq_t[w] | VNp[w];
    const uint64_t av = X & VPp[w];
    const uint64_t t = av + VPp[w];
    const uint64_t sum = t + carry;
    carry = (uint64_t)(t < av) | (uint64_t)(sum < t);
    const uint64_t D0 = (sum ^ VPp[w]) | X;
    const uint64_t hp = VNp[w] | ~(VPp[w] | D0);
    const uint64_t hn = VPp[w] & D0;
    HP[w] = hp; HN[w] = hn;
    const uint64_t hpw = (hp << 1) | hp_in; hp_in = hp >> 63;
    const uint64_t hnw = (hn << 1) | hn_in; hn_in = hn >> 63;
    VN[w] = hpw & D0;
    VP[w] = hnw | ~(hpw | D0);
  }
}

static inline void myers_build_peq(const int8_t* b, int m, int K,
                                   MyersScratch& S) {
  S.peq.assign((size_t)5 * K, 0);
  for (int j = 0; j < m; ++j) {
    const int8_t c = b[j];
    if (c >= 0 && c < 5)
      S.peq[(size_t)c * K + (j >> 6)] |= (uint64_t)1 << (j & 63);
  }
}

// distance-only variant (edit_distance_sum's path): no row storage.
static int32_t myers_dist(const int8_t* a, int n, const int8_t* b, int m,
                          MyersScratch& S) {
  const int K = (m + 63) >> 6;
  myers_build_peq(b, m, K, S);
  S.vp.assign(2 * K, ~(uint64_t)0);
  S.vn.assign(2 * K, 0);
  S.hp.resize(K); S.hn.resize(K);
  uint64_t* vp0 = S.vp.data(); uint64_t* vp1 = vp0 + K;
  uint64_t* vn0 = S.vn.data(); uint64_t* vn1 = vn0 + K;
  int32_t score = m;
  const int mw = (m - 1) >> 6;
  const uint64_t mb = (uint64_t)1 << ((m - 1) & 63);
  for (int i = 1; i <= n; ++i) {
    const int8_t c = a[i - 1];
    myers_step(S.peq.data() + (size_t)(c < 0 || c > 4 ? 4 : c) * K,
               vp0, vn0, S.hp.data(), S.hn.data(), vp1, vn1, K);
    score += (S.hp[mw] & mb) ? 1 : ((S.hn[mw] & mb) ? -1 : 0);
    std::swap(vp0, vp1); std::swap(vn0, vn1);
  }
  return score;
}

// full path variant: stores every row's VP/VN, walks the backtrack from
// delta bits. Returns the exact distance; writes the a2b prefix map.
static int32_t myers_path(const int8_t* a, int n, const int8_t* b, int m,
                          int64_t* a2b, MyersScratch& S) {
  const int K = (m + 63) >> 6;
  myers_build_peq(b, m, K, S);
  S.vp.resize((size_t)(n + 1) * K);
  S.vn.resize((size_t)(n + 1) * K);
  S.hp.resize(K); S.hn.resize(K);
  for (int w = 0; w < K; ++w) { S.vp[w] = ~(uint64_t)0; S.vn[w] = 0; }
  int32_t score = m;
  const int mw = (m - 1) >> 6;
  const uint64_t mb = (uint64_t)1 << ((m - 1) & 63);
  for (int i = 1; i <= n; ++i) {
    const int8_t c = a[i - 1];
    myers_step(S.peq.data() + (size_t)(c < 0 || c > 4 ? 4 : c) * K,
               S.vp.data() + (size_t)(i - 1) * K,
               S.vn.data() + (size_t)(i - 1) * K,
               S.hp.data(), S.hn.data(),
               S.vp.data() + (size_t)i * K, S.vn.data() + (size_t)i * K, K);
    score += (S.hp[mw] & mb) ? 1 : ((S.hn[mw] & mb) ? -1 : 0);
  }
  int i = n, j = m;
  a2b[n] = m;
  int hrow = -1;   // row whose HP/HN currently sit in S.hp/S.hn
  while (i > 0) {
    if (j == 0) {             // first column: deletion is the only move
      --i; a2b[i] = 0;
      continue;
    }
    if (hrow != i) {
      const int8_t c = a[i - 1];
      S.t0.resize(K); S.t1.resize(K);
      myers_step(S.peq.data() + (size_t)(c < 0 || c > 4 ? 4 : c) * K,
                 S.vp.data() + (size_t)(i - 1) * K,
                 S.vn.data() + (size_t)(i - 1) * K,
                 S.hp.data(), S.hn.data(), S.t0.data(), S.t1.data(), K);
      hrow = i;
    }
    const int w = (j - 1) >> 6;
    const uint64_t bit = (uint64_t)1 << ((j - 1) & 63);
    const int V = (S.hp[w] & bit) ? 1 : ((S.hn[w] & bit) ? -1 : 0);
    const uint64_t* VPp = S.vp.data() + (size_t)(i - 1) * K;
    const uint64_t* VNp = S.vn.data() + (size_t)(i - 1) * K;
    const int Hp = (VPp[w] & bit) ? 1 : ((VNp[w] & bit) ? -1 : 0);
    const int c = (a[i - 1] != b[j - 1]) ? 1 : 0;
    if (V + Hp == c) {
      --i; --j; a2b[i] = j;
    } else if (V == 1) {
      --i; a2b[i] = j;
    } else {
      --j;
    }
  }
  a2b[0] = 0;
  return score;
}

int32_t align_path(const int8_t* a, int n, const int8_t* b, int m,
                   std::vector<int32_t>& Dbuf, int64_t* a2b,
                   int32_t band_hint = 24) {
  if (m > 0 && m <= MYERS_MAX_M && n > 0) {
    static thread_local MyersScratch S;
    return myers_path(a, n, b, m, a2b, S);
  }
  const int W = m + 1;
  Dbuf.resize((size_t)(n + 1) * W);
  int32_t* D = Dbuf.data();
  const int32_t dist = fill_exact(a, n, b, m, D, W, band_hint);
  // backtrack (diagonal > deletion > insertion), matching oracle/align.py
  int i = n, j = m;
  a2b[n] = m;
  while (i > 0) {
    const int32_t* row = D + (size_t)i * W;
    const int32_t* prev = row - W;
    if (j > 0 && row[j] == prev[j - 1] + (a[i - 1] != b[j - 1])) {
      --i; --j;
      a2b[i] = j;
    } else if (row[j] == prev[j] + 1) {
      --i;
      a2b[i] = j;
    } else {
      --j;
    }
  }
  a2b[0] = 0;
  return dist;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// LAS columnar loader
// ---------------------------------------------------------------------------
// pass 1: header + totals so the caller can allocate numpy arrays.
// byte_start/byte_end restrict to an aread-aligned shard range (0,0 = whole
// file). The port always loads the whole file.
int las_scan(const char* path, int64_t byte_start, int64_t byte_end,
             int64_t* novl, int32_t* tspace, int64_t* trace_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  struct { int64_t novl; int32_t tspace; int32_t pad; } hdr;
  if (fread(&hdr, 16, 1, f) != 1) { fclose(f); return -2; }
  *tspace = hdr.tspace;
  const int tsize = hdr.tspace <= 125 ? 1 : 2;
  if (byte_start > 16 && fseek(f, (long)byte_start, SEEK_SET) != 0) { fclose(f); return -3; }
  int64_t total = 0, count = 0;
  struct Rec { int32_t tlen, diffs, abpos, bbpos, aepos, bepos; uint32_t flags; int32_t aread, bread, pad; } rec;
  static_assert(sizeof(Rec) == 40, "record layout");
  while ((byte_end <= 0 || ftell(f) < byte_end) && fread(&rec, sizeof(Rec), 1, f) == 1) {
    total += rec.tlen;
    ++count;
    if (fseek(f, (long)rec.tlen * tsize, SEEK_CUR) != 0) { fclose(f); return -3; }
  }
  *novl = count;
  *trace_elems = total;
  fclose(f);
  return 0;
}

// pass 2: fill caller-allocated columnar arrays
int las_load(const char* path, int64_t byte_start, int64_t byte_end, int64_t novl_expect,
             int32_t* aread, int32_t* bread,
             int32_t* abpos, int32_t* aepos,
             int32_t* bbpos, int32_t* bepos,
             uint8_t* comp, int32_t* diffs,
             int64_t* trace_off,          // [novl+1]
             int32_t* trace_flat) {       // [trace_elems] (d,b) interleaved
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  struct { int64_t novl; int32_t tspace; int32_t pad; } hdr;
  if (fread(&hdr, 16, 1, f) != 1) { fclose(f); return -2; }
  const int tsize = hdr.tspace <= 125 ? 1 : 2;
  if (byte_start > 16 && fseek(f, (long)byte_start, SEEK_SET) != 0) { fclose(f); return -3; }
  struct Rec { int32_t tlen, diffs, abpos, bbpos, aepos, bepos; uint32_t flags; int32_t aread, bread, pad; } rec;
  int64_t k = 0, off = 0;
  std::vector<uint8_t> tbuf;
  while ((byte_end <= 0 || ftell(f) < byte_end) && k < novl_expect
         && fread(&rec, sizeof(Rec), 1, f) == 1) {
    aread[k] = rec.aread; bread[k] = rec.bread;
    abpos[k] = rec.abpos; aepos[k] = rec.aepos;
    bbpos[k] = rec.bbpos; bepos[k] = rec.bepos;
    comp[k] = (uint8_t)(rec.flags & 1u);
    diffs[k] = rec.diffs;
    trace_off[k] = off;
    tbuf.resize((size_t)rec.tlen * tsize);
    if (rec.tlen && fread(tbuf.data(), tsize, rec.tlen, f) != (size_t)rec.tlen) { fclose(f); return -3; }
    if (tsize == 1) {
      for (int t = 0; t < rec.tlen; ++t) trace_flat[off + t] = tbuf[t];
    } else {
      const uint16_t* p = (const uint16_t*)tbuf.data();
      for (int t = 0; t < rec.tlen; ++t) trace_flat[off + t] = p[t];
    }
    off += rec.tlen;
    ++k;
  }
  trace_off[k] = off;
  fclose(f);
  return (int)(k == novl_expect ? 0 : -4);
}

// ---------------------------------------------------------------------------
// pile -> window tensors
// ---------------------------------------------------------------------------
// b_concat holds each overlap's B read bases in STORED orientation at
// b_off[i]..b_off[i]+b_len[i]; complementing happens here.
// out_seqs must be pre-filled with PAD by the caller ([nwin, D, L] int8);
// out_lens/out_nsegs are zero-filled by the caller.
int process_pile(const int8_t* a, int32_t alen,
                 int32_t novl,
                 const int32_t* abpos, const int32_t* aepos,
                 const int32_t* bbpos, const int32_t* bepos,
                 const uint8_t* comp,
                 const int8_t* b_concat, const int64_t* b_off, const int32_t* b_len,
                 const int32_t* trace_flat, const int64_t* trace_off,
                 int32_t tspace, int32_t w, int32_t adv,
                 int32_t D, int32_t L, int32_t include_a,
                 int8_t* out_seqs, int32_t* out_lens, int32_t* out_nsegs,
                 int32_t nwin) {
  // refine every overlap to a base-accurate prefix map. The scratch buffers
  // are thread_local flat arenas (the feeder pool calls this concurrently):
  // reusing their capacity across piles removes the per-pile allocation
  // churn of per-overlap vectors.
  static thread_local std::vector<int64_t> a2b_flat;
  static thread_local std::vector<int8_t> orient_flat;
  static thread_local std::vector<size_t> a2b_at, orient_at;
  static thread_local std::vector<int32_t> Dbuf;
  a2b_at.resize(novl);
  orient_at.resize(novl);
  {
    size_t at = 0, ot = 0;
    for (int i = 0; i < novl; ++i) {
      a2b_at[i] = at; orient_at[i] = ot;
      at += (size_t)(aepos[i] - abpos[i]) + 1;
      ot += (size_t)b_len[i];
    }
    a2b_flat.resize(at);
    orient_flat.resize(ot);
  }
  for (int i = 0; i < novl; ++i) {
    const int32_t ab = abpos[i], ae = aepos[i];
    const int32_t blen = b_len[i];
    const int8_t* bsrc = b_concat + b_off[i];
    int8_t* bo = orient_flat.data() + orient_at[i];
    if (comp[i]) {
      for (int32_t j = 0; j < blen; ++j) bo[j] = (int8_t)(3 - bsrc[blen - 1 - j]);
    } else {
      std::memcpy(bo, bsrc, blen);
    }
    int64_t* a2b = a2b_flat.data() + a2b_at[i];
    // tile bounds: [ab, next multiple of tspace, ..., ae]
    int64_t bpos = bbpos[i];
    const int32_t* tr = trace_flat + trace_off[i];
    int32_t t = 0;
    int32_t a0 = ab;
    while (a0 < ae) {
      int32_t a1 = std::min(((a0 / tspace) + 1) * tspace, ae);
      if (a1 <= a0) a1 = ae;
      const int32_t tb = tr[2 * t + 1];  // b bases in tile
      // the trace records the aligner's per-tile diff count; the optimal
      // distance is <= it, so diffs+2 is a valid exact band (the verify-
      // retry in align_path still protects against a lying trace)
      align_path(a + a0, a1 - a0, bo + bpos, tb, Dbuf, a2b + (a0 - ab),
                 tr[2 * t] + 2);
      // align_path wrote offsets relative to the tile; rebase to absolute
      for (int32_t x = a0 - ab; x <= a1 - ab; ++x) a2b[x] += bpos;
      bpos += tb;
      a0 = a1;
      ++t;
    }
    a2b[ae - ab] = bpos;
  }

  // cut windows
  const int32_t n_expected = alen < w ? 0 : (alen - w) / adv + 1;
  if (n_expected != nwin) return -5;
  for (int32_t j = 0; j < nwin; ++j) {
    const int32_t ws = j * adv, we = ws + w;
    int32_t d = 0;
    int8_t* wrow = out_seqs + (size_t)j * D * L;
    if (include_a && d < D) {
      const int32_t n = std::min(w, L);
      std::memcpy(wrow, a + ws, n);
      out_lens[(size_t)j * D] = n;
      ++d;
    }
    for (int i = 0; i < novl && d < D; ++i) {
      if (abpos[i] <= ws && aepos[i] >= we) {
        const int64_t* a2b = a2b_flat.data() + a2b_at[i];
        const int64_t b0 = a2b[ws - abpos[i]];
        const int64_t b1 = a2b[we - abpos[i]];
        if (b1 > b0) {
          const int32_t n = (int32_t)std::min<int64_t>(b1 - b0, L);
          std::memcpy(wrow + (size_t)d * L, orient_flat.data() + orient_at[i] + b0, n);
          out_lens[(size_t)j * D + d] = n;
          ++d;
        }
      }
    }
    out_nsegs[j] = d;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// stitch splice: best suffix(a) x prefix(b) semi-global alignment
// ---------------------------------------------------------------------------
// Exact copy of the numpy overlap_suffix_prefix (free start in a, free end
// in b, end chosen minimizing cost - len/2, ties to the lower index;
// backtrack tie order substitution > deletion > insertion).
int suffix_prefix(const int8_t* a, int32_t n, const int8_t* b, int32_t m,
                  int32_t* out_cost, int32_t* out_a_start, int32_t* out_b_end) {
  std::vector<int32_t> Dbuf((size_t)(n + 1) * (m + 1));
  int32_t* D = Dbuf.data();
  const int W = m + 1;
  for (int j = 0; j <= m; ++j) D[j] = j;
  for (int i = 1; i <= n; ++i) {
    int32_t* row = D + (size_t)i * W;
    const int32_t* prev = row - W;
    row[0] = 0;
    const int8_t ai = a[i - 1];
    for (int j = 1; j <= m; ++j) {
      int32_t best = prev[j - 1] + (b[j - 1] != ai);
      int32_t del = prev[j] + 1;
      if (del < best) best = del;
      int32_t ins = row[j - 1] + 1;
      if (ins < best) best = ins;
      row[j] = best;
    }
  }
  const int32_t* last = D + (size_t)n * W;
  int b_end = 0;
  int64_t bestc = 2LL * last[0];
  for (int j = 1; j <= m; ++j) {
    int64_t c = 2LL * last[j] - j;
    if (c < bestc) { bestc = c; b_end = j; }
  }
  int i = n, j = b_end;
  while (j > 0) {
    const int32_t* row = D + (size_t)i * W;
    const int32_t* prev = row - W;
    if (i > 0 && row[j] == prev[j - 1] + (b[j - 1] != a[i - 1])) {
      --i; --j;
    } else if (i > 0 && row[j] == prev[j] + 1) {
      --i;
    } else {
      --j;
    }
  }
  *out_cost = last[b_end];
  *out_a_start = i;
  *out_b_end = b_end;
  return 0;
}

// 2-bit .bps batch decode straight into host buffers. n reads decoded from the packed base store
// into one contiguous int8 buffer; layout per formats/dazzdb.py (4 bases per
// byte, first base in the two top bits — Dazzler order).
int decode_reads(const uint8_t* bps, const int64_t* boff, const int32_t* rlen,
                 int32_t n, int8_t* out, const int64_t* out_off) {
  for (int32_t i = 0; i < n; ++i) {
    const uint8_t* src = bps + boff[i];
    int8_t* dst = out + out_off[i];
    const int32_t len = rlen[i];
    const int32_t full = len / 4;
    for (int32_t j = 0; j < full; ++j) {
      const uint8_t b = src[j];
      dst[4 * j] = (b >> 6) & 3;
      dst[4 * j + 1] = (b >> 4) & 3;
      dst[4 * j + 2] = (b >> 2) & 3;
      dst[4 * j + 3] = b & 3;
    }
    for (int32_t k = 4 * full; k < len; ++k)
      dst[k] = (src[k / 4] >> (6 - 2 * (k % 4))) & 3;
  }
  return 0;
}

// exact unit-cost edit distance (verify-retry banded: a returned d < band
// slack proves every optimal path stayed interior, so the value equals the
// full DP's) of one candidate vs each of nsegs segments, summed, in one
// ctypes call (oracle/align.py edit_distance_sum).
int64_t edit_distance_sum(const int8_t* cand, int32_t n, const int8_t* segs,
                          const int64_t* offs, const int32_t* lens,
                          int32_t nsegs) {
  static thread_local std::vector<int32_t> Dbuf;
  static thread_local MyersScratch S;
  int64_t tot = 0;
  for (int32_t s = 0; s < nsegs; ++s) {
    const int8_t* b = segs + offs[s];
    const int m = lens[s];
    if (n == 0) { tot += m; continue; }
    if (m == 0) { tot += n; continue; }
    // distance-only Myers has no row storage, so the gate is far wider
    // than the path variant's: n*K word-steps beat the banded fill well
    // past window widths (e.g. whole-read 4k x 4k rescores)
    if (m <= 8192) {
      tot += myers_dist(cand, n, b, m, S);
      continue;
    }
    const int W = m + 1;
    Dbuf.resize((size_t)(n + 1) * W);
    tot += fill_exact(cand, n, b, m, Dbuf.data(), W, 16);
  }
  return tot;
}

// exact a2b prefix map (oracle/align.py align_path semantics, bit-identical
// backtrack tie order).
// Returns the exact edit distance (Myers score or the verify-retried
// banded fill's D[n][m]).
int64_t align_map(const int8_t* a, int32_t n, const int8_t* b, int32_t m,
                  int64_t* a2b) {
  static thread_local std::vector<int32_t> Dbuf;
  return align_path(a, n, b, m, Dbuf, a2b);
}

// best edit distance of needle a against ANY infix of haystack b
// (oracle/align.py infix_distance semantics: free start/end gaps in the
// haystack). Myers' original approximate-search formulation: bits run along
// the NEEDLE (multi-word), text consumed with a free-start boundary (no
// carry-in on the HP shift), score tracked at the needle's last bit and
// minimized over text positions. Exact.
int64_t infix_distance(const int8_t* a, int32_t n, const int8_t* b,
                       int32_t m) {
  if (n == 0) return 0;
  if (m == 0) return n;
  const int K = (n + 63) >> 6;
  static thread_local std::vector<uint64_t> peq_v, vp_v, vn_v;
  peq_v.assign((size_t)5 * K, 0);
  for (int j = 0; j < n; ++j) {
    const int8_t c = a[j];
    if (c >= 0 && c < 5)
      peq_v[(size_t)c * K + (j >> 6)] |= (uint64_t)1 << (j & 63);
  }
  vp_v.assign(K, ~(uint64_t)0);
  vn_v.assign(K, 0);
  uint64_t* VP = vp_v.data();
  uint64_t* VN = vn_v.data();
  const int nw = (n - 1) >> 6;
  const uint64_t nb = (uint64_t)1 << ((n - 1) & 63);
  int64_t score = n, best = n;
  for (int i = 0; i < m; ++i) {
    const int8_t c = b[i];
    const uint64_t* peq = peq_v.data() + (size_t)(c < 0 || c > 4 ? 4 : c) * K;
    uint64_t carry = 0, hp_in = 0, hn_in = 0;  // free text start: boundary
    //                                            delta 0, no carry-in
    for (int w = 0; w < K; ++w) {
      const uint64_t X = peq[w] | VN[w];
      const uint64_t av = X & VP[w];
      const uint64_t t = av + VP[w];
      const uint64_t sum = t + carry;
      carry = (uint64_t)(t < av) | (uint64_t)(sum < t);
      const uint64_t D0 = (sum ^ VP[w]) | X;
      const uint64_t hp = VN[w] | ~(VP[w] | D0);
      const uint64_t hn = VP[w] & D0;
      if (w == nw) score += (hp & nb) ? 1 : ((hn & nb) ? -1 : 0);
      const uint64_t hpw = (hp << 1) | hp_in; hp_in = hp >> 63;
      const uint64_t hnw = (hn << 1) | hn_in; hn_in = hn >> 63;
      VN[w] = hpw & D0;
      VP[w] = hnw | ~(hpw | D0);
    }
    if (score < best) best = score;
  }
  return best;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native window-consensus engine: C++ replica of the oracle spec
// (oracle/dbg.py window_consensus + oracle/consensus.py solve_window tier
// ladder — the reference's handleWindow/DebruijnGraph<k> per SURVEY.md §3.3;
// reference file:line pending backfill, mount empty). Full-graph semantics
// (no top-M cap), same thresholds, same tie-breaks (candidate order = score
// desc then flat index asc, matching the oracle's stable argsort; DP argmax
// keeps the lowest u). Float accumulation is sequential f32, which can
// differ from numpy's blocked BLAS reductions in the last ulp — parity is
// asserted at the consensus-sequence level (tests/test_native.py).
//
// Consumes the pipeline's WindowBatch tensor layout directly:
// seqs [B, D, L] int8 (PAD-filled), lens [B, D] i32, nsegs [B] i32.

namespace dbgc {

constexpr float NEGF = -1e30f;

static int band_for(int n, int m) {  // the one band formula (spec + fast)
  int band = std::abs(n - m) + std::max(16, std::max(n, m) >> 2);
  return std::max(band, std::abs(n - m) + 1);
}

// oracle.align.edit_distance replica: banded unit-cost DP, int32, band
// derived exactly as the spec does (NOT verify-retried — the banded value IS
// the spec the kernel parity tests are calibrated against).
static int32_t edit_distance_spec(const int8_t* a, int n, const int8_t* b,
                                  int m) {
  if (n == 0) return m;
  if (m == 0) return n;
  const int band = band_for(n, m);
  static thread_local std::vector<int32_t> pv, cv;
  pv.resize(m + 1);
  cv.resize(m + 1);
  int32_t* prev = pv.data();
  int32_t* cur = cv.data();
  const int32_t BIG = 1 << 30;
  for (int j = 0; j <= m; ++j) prev[j] = j;
  for (int i = 1; i <= n; ++i) {
    const int lo = std::max(1, i - band);
    const int hi = std::min(m, i + band);
    cur[lo - 1] = (lo == 1) ? i : BIG;
    int32_t run = cur[lo - 1];
    const int8_t ai = a[i - 1];
    for (int j = lo; j <= hi; ++j) {
      const int32_t sub = prev[j - 1] + (b[j - 1] != ai);
      const int32_t del = prev[j] + 1;
      int32_t best = sub < del ? sub : del;
      ++run;
      if (best < run) run = best;
      cur[j] = run;
    }
    if (hi < m) cur[hi + 1] = BIG;  // next row reads prev[hi+1]
    std::swap(prev, cur);
  }
  return prev[m];
}

// Myers/Hyyrö bit-parallel exact edit distance for candidate rescoring,
// n <= 64 (cand_len <= wlen + len_slack = 48): one uint64 word of VP/VN,
// ~15 bitwise ops per segment char. Formulation mirrors the device kernel's
// _edit_distance_myers (window_kernel.py), which is bit-parity-tested
// against the exact anti-diagonal DP. The SPEC the oracle defines is the
// BANDED distance (edit_distance_spec above), which equals the exact
// distance whenever exact <= band — always true for real candidate/segment
// pairs at these lengths; rare junk pairs (and any out-of-alphabet bytes)
// fall back to the banded replica so native == oracle stays bit-exact.

struct MyersCand {   // per-candidate precompute, reused across all segments
  uint64_t peq[5];
  uint64_t vp_init, hb;
  int n;
  bool ok;
};

static void myers_prep(const int8_t* a, int n, MyersCand& mc) {
  mc.n = n;
  mc.ok = n > 0 && n <= 64;
  if (!mc.ok) return;
  for (int c = 0; c < 5; ++c) mc.peq[c] = 0;
  for (int i = 0; i < n; ++i) {
    const uint8_t c = (uint8_t)a[i];
    if (c > 4) { mc.ok = false; return; }   // out-of-alphabet: spec path
    mc.peq[c] |= 1ull << i;
  }
  mc.vp_init = (n == 64) ? ~0ull : ((1ull << n) - 1);
  mc.hb = 1ull << (n - 1);
}

static int32_t edit_distance_fast(const MyersCand& mc, const int8_t* a,
                                  const int8_t* b, int m, bool b_checked) {
  const int n = mc.n;
  if (!mc.ok || m == 0) return edit_distance_spec(a, n, b, m);
  if (!b_checked)   // callers that pre-validate their segments skip the scan
    for (int j = 0; j < m; ++j)
      if ((uint8_t)b[j] > 4) return edit_distance_spec(a, n, b, m);
  uint64_t vp = mc.vp_init;
  uint64_t vn = 0;
  int32_t score = n;
  const uint64_t hb = mc.hb;
  for (int j = 0; j < m; ++j) {
    const uint64_t eq = mc.peq[(uint8_t)b[j]];
    const uint64_t x = eq | vn;
    const uint64_t ad = x & vp;
    const uint64_t s = vp + ad;
    const uint64_t d0 = (s ^ vp) | x;
    const uint64_t hn = vp & d0;
    const uint64_t hp = vn | ~(vp | d0);
    score += (hp & hb) ? 1 : ((hn & hb) ? -1 : 0);
    const uint64_t x2 = (hp << 1) | 1ull;   // D[0,j] = j carry-in
    const uint64_t h2 = hn << 1;
    vn = x2 & d0;
    vp = h2 | ~(x2 | d0);
  }
  if (score <= band_for(n, m)) return score;  // banded spec == exact here
  return edit_distance_spec(a, n, b, m);
}

struct TierSpec {
  int32_t k, min_count, edge_min_count, P, O;
  int32_t max_kmers;   // 0 = unbounded (full graph); > 0 mirrors the device
                       // ladder's top-M compaction (count desc, smaller code
                       // wins ties — lax.top_k semantics), measured a
                       // beneficial noise filter (BASELINE.md r3 top-M table)
  const float* table;  // [P][O]
};

struct Scratch {
  std::vector<int64_t> codes, codes1, kept;
  std::vector<int32_t> offs, order;       // per-occurrence offset; sort order
  std::vector<uint8_t> flags;             // per-occurrence start/end bits
  std::vector<int32_t> kid_off, kid_cnt;  // per-kept-id slice into occ_*
  std::vector<int32_t> occ_o;             // dedup'd offsets, o-ascending
  std::vector<float> occ_c;               // counts at those offsets
  std::vector<uint8_t> src_ok, snk_ok;
  std::vector<int32_t> in_off, in_u;      // CSR incoming-edge lists
  std::vector<std::pair<int32_t, int32_t>> edges;
  std::vector<float> W, score;
  std::vector<int32_t> ptr;
  std::vector<std::pair<float, int32_t>> ends;
  std::vector<int32_t> path;
  std::vector<int8_t> cand, best;
  std::vector<int32_t> seen;
  // top-M compaction temporaries (swap targets; kept here so ALL per-thread
  // scratch lives in one audited struct)
  std::vector<int32_t> sel, off2, cnt2, occ_o2;
  std::vector<int64_t> kept2;
  std::vector<float> occ_c2;
  std::vector<uint8_t> src2, snk2;
  std::vector<int32_t> radix_i;    // LSD radix alternate buffers
  std::vector<int64_t> radix_v;
};

// LSD radix sort core, 8-bit digits over the low ``bits`` key bits.
// Grouping order is key-ascending and the sort is stable — the only
// properties the callers need (within-run order is irrelevant downstream:
// offsets re-sort per run, anchor flags OR). ~4x std::sort on the 16-bit
// k=8 codes that dominate (ARCHITECTURE.md "Native engine cost anatomy").
// One templated core; KeyFn maps an element to its int64 key.
template <class T, class KeyFn>
static void radix_sort_core(std::vector<T>& v, int bits, std::vector<T>& alt,
                            KeyFn key) {
  const int n = (int)v.size();
  alt.resize(n);
  T* src = v.data();
  T* dst = alt.data();
  const int passes = (bits + 7) / 8;
  for (int p = 0; p < passes; ++p) {
    int32_t hist[257] = {0};
    const int shift = 8 * p;
    for (int i = 0; i < n; ++i)
      ++hist[((key(src[i]) >> shift) & 0xFF) + 1];
    for (int b = 0; b < 256; ++b) hist[b + 1] += hist[b];
    for (int i = 0; i < n; ++i)
      dst[hist[(key(src[i]) >> shift) & 0xFF]++] = src[i];
    std::swap(src, dst);
  }
  if (src != v.data())
    std::memcpy(v.data(), src, (size_t)n * sizeof(T));
}

static void radix_sort_idx(std::vector<int32_t>& order,
                           const std::vector<int64_t>& keys, int bits,
                           std::vector<int32_t>& alt) {
  radix_sort_core(order, bits, alt,
                  [&keys](int32_t i) { return keys[i]; });
}

static void radix_sort_vals(std::vector<int64_t>& v, int bits,
                            std::vector<int64_t>& alt) {
  radix_sort_core(v, bits, alt, [](int64_t x) { return x; });
}

// one window, one tier. Returns 0 solved (cons/err written), else -1.
// *movf is set when the top-M cap truncated the surviving k-mer set.
static int try_tier(const int8_t* seqs, const int32_t* lens, int nseg, int L,
                    const TierSpec& ts, int wlen, int anchor_slack,
                    int end_slack, int len_slack, int n_candidates,
                    float max_err, float count_frac, Scratch& S,
                    int8_t* cons_out, int32_t* cons_len, float* err_out,
                    uint8_t* movf) {
  const int k = ts.k;
  const int O = ts.O;
  // ---- 1. per-occurrence k-mers/(k+1)-mers with offsets + anchor flags ----
  S.codes.clear();
  S.codes1.clear();
  S.offs.clear();
  S.flags.clear();
  int64_t seg_total = 0;
  for (int j = 0; j < nseg; ++j) {
    const int len = lens[j];
    seg_total += len;
    const int8_t* seg = seqs + (size_t)j * L;
    const int nk = len - k + 1;
    if (nk <= 0) continue;  // oracle: segments shorter than k skip entirely
    int64_t code = 0;
    for (int p = 0; p < k - 1; ++p) code = code * 4 + seg[p];
    const int64_t mask = ((int64_t)1 << (2 * k)) - 1;
    for (int o = 0; o < nk; ++o) {
      code = ((code << 2) | seg[o + k - 1]) & mask;
      S.codes.push_back(code);
      S.offs.push_back(o);
      S.flags.push_back((o <= anchor_slack ? 1 : 0) |
                        (o >= nk - 1 - end_slack ? 2 : 0));
    }
    const int nk1 = len - k;
    if (nk1 > 0) {
      const int64_t mask1 = ((int64_t)1 << (2 * (k + 1))) - 1;
      int64_t c1 = 0;
      for (int p = 0; p < k; ++p) c1 = c1 * 4 + seg[p];
      for (int o = 0; o < nk1; ++o) {
        c1 = ((c1 << 2) | seg[o + k]) & mask1;
        S.codes1.push_back(c1);
      }
    }
  }
  if (S.codes.empty()) return -1;  // "empty"

  // ---- 2. frequency filter -> kept ids (ascending code order) ------------
  const int novl_occ = (int)S.codes.size();
  S.order.resize(novl_occ);
  for (int i = 0; i < novl_occ; ++i) S.order[i] = i;
  radix_sort_idx(S.order, S.codes, 2 * k, S.radix_i);
  const int thresh =
      std::max(ts.min_count, (int)std::ceil(count_frac * nseg));
  S.kept.clear();
  S.kid_off.clear();
  S.kid_cnt.clear();
  S.occ_o.clear();
  S.occ_c.clear();
  S.src_ok.clear();
  S.snk_ok.clear();
  for (int i = 0; i < novl_occ;) {
    int e = i + 1;
    while (e < novl_occ && S.codes[S.order[e]] == S.codes[S.order[i]]) ++e;
    if (e - i >= thresh) {
      S.kept.push_back(S.codes[S.order[i]]);
      S.kid_off.push_back((int)S.occ_o.size());
      uint8_t s_ok = 0, e_ok = 0;
      // dedup occurrence offsets ascending (order within a code run is
      // occurrence order; offsets repeat across segments) — counts merge
      static thread_local std::vector<int32_t> tmp;
      tmp.clear();
      for (int q = i; q < e; ++q) {
        const int occ_idx = S.order[q];
        int o = S.offs[occ_idx];
        if (o < 0) o = 0;
        if (o > O - 1) o = O - 1;
        tmp.push_back(o);
        s_ok |= (S.flags[occ_idx] & 1);
        e_ok |= (S.flags[occ_idx] & 2) ? 1 : 0;
      }
      std::sort(tmp.begin(), tmp.end());
      for (size_t q = 0; q < tmp.size();) {
        size_t r = q + 1;
        while (r < tmp.size() && tmp[r] == tmp[q]) ++r;
        S.occ_o.push_back(tmp[q]);
        S.occ_c.push_back((float)(r - q));
        q = r;
      }
      S.src_ok.push_back(s_ok);
      S.snk_ok.push_back(e_ok);
      S.kid_cnt.push_back(e - i);
    }
    i = e;
  }
  if (S.kept.empty()) return -1;  // "allfiltered"
  S.kid_off.push_back((int)S.occ_o.size());

  // ---- 2a. top-M compaction (device-ladder semantics) --------------------
  if (ts.max_kmers > 0 && (int)S.kept.size() > ts.max_kmers) {
    const int nk0 = (int)S.kept.size();
    S.sel.resize(nk0);
    for (int i = 0; i < nk0; ++i) S.sel[i] = i;
    std::partial_sort(S.sel.begin(), S.sel.begin() + ts.max_kmers,
                      S.sel.end(),
                      [&](int a, int b) {
                        if (S.kid_cnt[a] != S.kid_cnt[b])
                          return S.kid_cnt[a] > S.kid_cnt[b];
                        return a < b;   // lax.top_k: lower index wins ties
                      });
    S.sel.resize(ts.max_kmers);
    std::sort(S.sel.begin(), S.sel.end());  // kept must stay code-ascending
    S.kept2.clear(); S.off2.clear(); S.cnt2.clear();
    S.occ_o2.clear(); S.occ_c2.clear(); S.src2.clear(); S.snk2.clear();
    for (int id : S.sel) {
      S.kept2.push_back(S.kept[id]);
      S.off2.push_back((int)S.occ_o2.size());
      for (int q = S.kid_off[id]; q < S.kid_off[id + 1]; ++q) {
        S.occ_o2.push_back(S.occ_o[q]);
        S.occ_c2.push_back(S.occ_c[q]);
      }
      S.cnt2.push_back(S.kid_cnt[id]);
      S.src2.push_back(S.src_ok[id]);
      S.snk2.push_back(S.snk_ok[id]);
    }
    S.off2.push_back((int)S.occ_o2.size());
    S.kept.swap(S.kept2); S.kid_off.swap(S.off2); S.kid_cnt.swap(S.cnt2);
    S.occ_o.swap(S.occ_o2); S.occ_c.swap(S.occ_c2);
    S.src_ok.swap(S.src2); S.snk_ok.swap(S.snk2);
    *movf = 1;
  }
  const int nk = (int)S.kept.size();

  // ---- 2b. edges from (k+1)-mer support ----------------------------------
  radix_sort_vals(S.codes1, 2 * (k + 1), S.radix_v);
  S.edges.clear();
  const int64_t mask_k = ((int64_t)1 << (2 * k)) - 1;
  const size_t n1 = S.codes1.size();
  for (size_t i = 0; i < n1;) {
    size_t e = i + 1;
    while (e < n1 && S.codes1[e] == S.codes1[i]) ++e;
    if ((int)(e - i) >= ts.edge_min_count) {
      const int64_t c1 = S.codes1[i];
      const int64_t pref = c1 >> 2;
      const int64_t suff = c1 & mask_k;
      auto pi = std::lower_bound(S.kept.begin(), S.kept.end(), pref);
      auto si = std::lower_bound(S.kept.begin(), S.kept.end(), suff);
      if (pi != S.kept.end() && *pi == pref && si != S.kept.end() &&
          *si == suff)
        S.edges.emplace_back((int32_t)(si - S.kept.begin()),
                             (int32_t)(pi - S.kept.begin()));  // (v, u)
    }
    i = e;
  }
  if (S.edges.empty()) return -1;  // "noedges"
  // CSR incoming lists, u ascending per v (argmax-first tie-break), dedup'd
  std::sort(S.edges.begin(), S.edges.end());
  S.edges.erase(std::unique(S.edges.begin(), S.edges.end()), S.edges.end());
  S.in_off.assign(nk + 1, 0);
  for (auto& vu : S.edges) S.in_off[vu.first + 1]++;
  for (int v = 0; v < nk; ++v) S.in_off[v + 1] += S.in_off[v];
  S.in_u.resize(S.edges.size());
  {
    static thread_local std::vector<int32_t> cursor;
    cursor.assign(nk, 0);
    for (auto& vu : S.edges)
      S.in_u[S.in_off[vu.first] + cursor[vu.first]++] = vu.second;
  }

  // ---- 3. position weights W[nk][P] (sparse occ x table) -----------------
  const int P = std::min(ts.P, wlen - k + 1 + len_slack);
  if (P <= 0) return -1;
  S.W.assign((size_t)nk * P, 0.0f);
  for (int id = 0; id < nk; ++id) {
    float* wrow = S.W.data() + (size_t)id * P;
    for (int p = 0; p < P; ++p) {
      const float* trow = ts.table + (size_t)p * O;
      float acc = 0.0f;
      for (int q = S.kid_off[id]; q < S.kid_off[id + 1]; ++q)
        acc += S.occ_c[q] * trow[S.occ_o[q]];
      wrow[p] = acc;
    }
  }

  // ---- 4. heaviest path DP ----------------------------------------------
  S.score.assign((size_t)P * nk, NEGF);
  S.ptr.assign((size_t)P * nk, -1);
  for (int v = 0; v < nk; ++v)
    if (S.src_ok[v]) S.score[v] = S.W[(size_t)v * P + 0];
  for (int t = 1; t < P; ++t) {
    const float* sp = S.score.data() + (size_t)(t - 1) * nk;
    float* st = S.score.data() + (size_t)t * nk;
    int32_t* pt = S.ptr.data() + (size_t)t * nk;
    for (int v = 0; v < nk; ++v) {
      float best = NEGF;
      int32_t bu = -1;
      for (int q = S.in_off[v]; q < S.in_off[v + 1]; ++q) {
        const int u = S.in_u[q];
        if (sp[u] > best) {
          best = sp[u];
          bu = u;
        }
      }
      if (best > NEGF / 2) {
        st[v] = best + S.W[(size_t)v * P + t];
        pt[v] = bu;
      }
    }
  }

  // ---- 5. candidates: sort (score desc, flat idx asc), rescore -----------
  bool segs_ok = true;   // alphabet check hoisted out of the rescore loop
  for (int j = 0; j < nseg && segs_ok; ++j) {
    const int8_t* sb = seqs + (size_t)j * L;
    for (int q = 0; q < lens[j]; ++q)
      if ((uint8_t)sb[q] > 4) { segs_ok = false; break; }
  }
  const int t_lo = std::max(0, wlen - k - len_slack);
  const int t_hi = std::min(P - 1, wlen - k + len_slack);
  if (t_hi < t_lo) return -1;
  S.ends.clear();
  for (int t = t_lo; t <= t_hi; ++t)
    for (int v = 0; v < nk; ++v) {
      const float s = S.snk_ok[v] ? S.score[(size_t)t * nk + v] : NEGF;
      S.ends.emplace_back(s, (t - t_lo) * nk + v);
    }
  const size_t topn = std::min(S.ends.size(), (size_t)(4 * n_candidates));
  std::partial_sort(S.ends.begin(), S.ends.begin() + topn, S.ends.end(),
                    [](const std::pair<float, int32_t>& a,
                       const std::pair<float, int32_t>& b) {
                      if (a.first != b.first) return a.first > b.first;
                      return a.second < b.second;
                    });
  double best_err = 1e300;
  int best_len = -1;
  S.seen.clear();
  int n_cand = 0;
  for (size_t ei = 0; ei < topn; ++ei) {
    const float s = S.ends[ei].first;
    if (s <= NEGF / 2 || n_cand >= n_candidates) break;
    const int t = t_lo + S.ends[ei].second / nk;
    const int v = S.ends[ei].second % nk;
    if (std::find(S.seen.begin(), S.seen.end(), v) != S.seen.end()) continue;
    S.seen.push_back(v);
    S.path.resize(t + 1);
    int cur = v;
    for (int tt = t; tt >= 0; --tt) {
      S.path[tt] = cur;
      if (tt > 0) cur = S.ptr[(size_t)tt * nk + cur];
    }
    S.cand.resize(k + t);
    const int64_t first = S.kept[S.path[0]];
    for (int j = 0; j < k; ++j)
      S.cand[j] = (int8_t)((first >> (2 * (k - 1 - j))) & 3);
    for (int tt = 1; tt <= t; ++tt)
      S.cand[k + tt - 1] = (int8_t)(S.kept[S.path[tt]] & 3);
    ++n_cand;
    MyersCand mc;
    myers_prep(S.cand.data(), (int)S.cand.size(), mc);
    int64_t tot = 0;
    for (int j = 0; j < nseg; ++j)
      tot += edit_distance_fast(mc, S.cand.data(),
                                seqs + (size_t)j * L, lens[j], segs_ok);
    const double err = (double)tot / (double)std::max<int64_t>(seg_total, 1);
    if (err < best_err) {
      best_err = err;
      best_len = (int)S.cand.size();
      S.best = S.cand;
    }
  }
  if (best_len < 0) return -1;           // "nopath"
  if (best_err > max_err) return -1;     // "badscore"
  // winner only, written once: cons_out keeps its PAD fill past best_len
  // even when an earlier tier or a longer losing candidate was evaluated
  std::memcpy(cons_out, S.best.data(), best_len);
  *cons_len = best_len;
  *err_out = (float)best_err;
  return 0;
}

}  // namespace dbgc

extern "C" {

// Batched tier-ladder consensus over the WindowBatch tensor layout.
// cons [B, CL] (CL = wlen + len_slack, PAD-filled), cons_lens/errs/tiers [B];
// tier = -1 unsolved (err left at +inf); movf_out [B] = 1 when any attempted
// tier's top-M cap truncated the k-mer set (tier_M[i] = 0 disables the cap
// for that tier -> full-graph oracle semantics). n_threads > 1 splits windows
// across std::threads (engine is stateless per window; scratch thread_local).
int solve_windows(const int8_t* seqs, const int32_t* lens,
                  const int32_t* nsegs, int32_t B, int32_t D, int32_t L,
                  const float* tables, const int64_t* table_off,
                  const int32_t* tier_k, const int32_t* tier_minc,
                  const int32_t* tier_eminc, const int32_t* tier_P,
                  const int32_t* tier_O, const int32_t* tier_M,
                  int32_t n_tiers, int32_t wlen,
                  int32_t anchor_slack, int32_t end_slack, int32_t len_slack,
                  int32_t n_candidates, int32_t min_depth, float max_err,
                  float count_frac, int32_t n_threads, int8_t* cons,
                  int32_t* cons_lens, float* errs, int32_t* tiers_out,
                  uint8_t* movf_out) {
  const int CL = wlen + len_slack;
  std::vector<dbgc::TierSpec> ts(n_tiers);
  for (int i = 0; i < n_tiers; ++i)
    ts[i] = {tier_k[i], tier_minc[i], tier_eminc[i], tier_P[i], tier_O[i],
             tier_M[i], tables + table_off[i]};
  std::atomic<int32_t> next(0);
  auto worker = [&]() {
    dbgc::Scratch S;
    for (;;) {
      const int b = next.fetch_add(1);
      if (b >= B) return;
      int8_t* c = cons + (size_t)b * CL;
      std::memset(c, PAD, CL);
      cons_lens[b] = 0;
      errs[b] = std::numeric_limits<float>::infinity();
      tiers_out[b] = -1;
      movf_out[b] = 0;
      if (nsegs[b] < min_depth) continue;  // oracle: "depth" for every tier
      for (int ti = 0; ti < n_tiers; ++ti) {
        if (dbgc::try_tier(seqs + (size_t)b * D * L, lens + (size_t)b * D,
                           nsegs[b], L, ts[ti], wlen, anchor_slack, end_slack,
                           len_slack, n_candidates, max_err, count_frac, S, c,
                           &cons_lens[b], &errs[b], &movf_out[b]) == 0) {
          tiers_out[b] = ti;
          break;
        }
      }
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return 0;
}

// Homopolymer rescue post-pass over a solve_windows result (oracle/hp.py
// semantics, bit-identical by construction — see tests). Routing per window:
// failed or err > hp_err, with a run >= hp_min_run present (in the direct
// consensus if solved, else in any segment). Solve: run-length-compress the
// segments, run the FULL-GRAPH tier-0 DBG (M=0: the python path calls the
// oracle window_consensus) at wlen_c = int(median(compressed lens)), then
// re-expand each position's run length by the aligned MEDIAN vote
// (round-half-even, numpy/python parity) or — when post_tabs is non-NULL —
// the CALIBRATED POSTERIOR vote (oracle/hp.py vote_runs_posterior
// parity; tables built python-side). Accept only when the expanded
// candidate's exact rescored error beats the direct result (hp_margin) or
// clears max_err where the direct solve failed. Rescued rows write their
// (possibly longer-than-CL) sequence into hp_cons[CLH] and update
// cons_lens/errs in place with tiers_io = 29 (HP_TIER). Returns count
// rescued.
namespace {
// log-likelihood of the compressed segments under one candidate sequence
// (oracle/hp.py hp_loglik parity): run-length-compress the candidate, then
// per segment add -lambda_c per compressed edit plus the posterior walk's
// per-position log P(o | L_i); float64, python's accumulation order.
double hp_loglik_c(const int8_t* cand, int cand_len, const int8_t* cseqs,
                   const int32_t* cruns_all, const int32_t* clens, int nseg,
                   int L_stride, const double* tab, int Lmax, int Omax,
                   double lam_c, std::vector<int8_t>& cc_buf,
                   std::vector<int32_t>& cr_buf, std::vector<int64_t>& a2b,
                   std::vector<int32_t>& Dbuf_v) {
  cc_buf.clear();
  cr_buf.clear();
  for (int i = 0; i < cand_len; ++i) {
    if (!cc_buf.empty() && cand[i] == cc_buf.back()) {
      ++cr_buf.back();
    } else {
      cc_buf.push_back(cand[i]);
      cr_buf.push_back(1);
    }
  }
  const int n = (int)cc_buf.size();
  if (n == 0) return -std::numeric_limits<double>::infinity();
  const int TO = Omax + 1;
  double J = 0.0;
  a2b.resize(n + 1);
  for (int j = 0; j < nseg; ++j) {
    const int m = clens[j];
    if (m == 0) continue;
    const int8_t* cs = cseqs + (size_t)j * L_stride;
    const int32_t* cr = cruns_all + (size_t)j * L_stride;
    const int32_t d_c =
        align_path(cc_buf.data(), n, cs, m, Dbuf_v, a2b.data());
    J -= lam_c * (double)d_c;
    int claimed[4] = {0, 0, 0, 0};
    for (int i = 0; i < n; ++i) {
      const int c = cc_buf[i];
      if (c < 0 || c > 3) continue;
      int lo = (int)a2b[i];
      if (claimed[c] > lo) lo = claimed[c];
      int hi = (int)a2b[i + 1];
      if (hi < lo) hi = lo;
      if (hi < m && cs[hi] == c) ++hi;
      if (lo > claimed[c] && cs[lo - 1] == c) --lo;
      if (hi <= lo) continue;
      claimed[c] = hi;
      int64_t o = 0;
      for (int q = lo; q < hi; ++q)
        if (cs[q] == c) o += cr[q];
      int Li = cr_buf[i];
      if (Li < 1) Li = 1;
      if (Li > Lmax) Li = Lmax;
      const double v = tab[(size_t)Li * TO + (o > Omax ? Omax : (int)o)];
      if (std::isfinite(v)) {
        J += v;
      } else {
        J -= 60.0;   // impossible-under-model observation: crushing but
        //              finite, one outlier cannot veto via -inf
      }
    }
  }
  return J;
}
}  // namespace

int64_t hp_rescue_windows(
    const int8_t* seqs, const int32_t* lens, const int32_t* nsegs,
    int32_t B, int32_t D, int32_t L,
    const float* table0, int32_t P0, int32_t O0,
    int32_t k0, int32_t minc0, int32_t eminc0,
    int32_t wlen, int32_t anchor_slack, int32_t end_slack, int32_t len_slack,
    int32_t n_candidates, int32_t min_depth, double max_err,
    float count_frac,
    double hp_err, int32_t hp_min_run, double hp_margin, int32_t n_threads,
    const int8_t* cons_in, int32_t CL,
    int8_t* hp_cons, int32_t CLH,
    int32_t* cons_lens, float* errs, int32_t* tiers_io,
    // calibrated posterior vote (oracle/hp.py vote_runs_posterior):
    // post_tabs = [n_mult, Lmax+1, Omax+1] float64 log P(o|L) tables built
    // by the PYTHON hp_length_tables (bit-exact likelihoods; C++ only
    // mirrors the vote walk and same-order float64 accumulation), one per
    // quantized heat multiplier 1.0,1.25,..; NULL = median vote.
    const double* post_tabs, int32_t n_mult, int32_t Lmax, int32_t Omax,
    double p_err_prof, double mult_lo, double mult_step,
    // likelihood-ratio acceptance (oracle/hp.py hp_loglik): 1 = accept
    // the candidate that better explains the segments under the model
    // (only meaningful with post_tabs; solved windows only), 0 = raw
    // rescore bar. lambda_c = compressed-space edit penalty (log units).
    int32_t accept_likelihood, double lambda_c) {
  const dbgc::TierSpec ts_hp = {k0, minc0, eminc0, P0, O0, 0, table0};
  std::atomic<int32_t> next(0);
  std::atomic<int64_t> rescued(0);
  auto max_run_of = [](const int8_t* s, int n) {
    int best = 0, run = 0;
    for (int i = 0; i < n; ++i) {
      run = (i > 0 && s[i] == s[i - 1]) ? run + 1 : 1;
      if (run > best) best = run;
    }
    return best;
  };
  auto worker = [&]() {
    dbgc::Scratch S;
    std::vector<int8_t> cseqs((size_t)D * L);
    std::vector<int32_t> clens(D), cruns((size_t)D * L), med_buf;
    std::vector<int32_t> runs_out;
    std::vector<int8_t> hcons, expanded;
    std::vector<int64_t> a2b;
    std::vector<int32_t> Dbuf_v;   // align_path / rescore DP matrix
    std::vector<std::vector<int32_t>> pos_votes;
    std::vector<double> ll_buf;    // posterior log-likelihood accumulator
    std::vector<int32_t> nv_buf;
    std::vector<int8_t> cc_buf;    // hp_loglik_c candidate compression
    std::vector<int32_t> cr_buf;
    for (;;) {
      const int b = next.fetch_add(1);
      if (b >= B) return;
      const int nseg = nsegs[b];
      if (nseg < min_depth) continue;
      const bool solved = tiers_io[b] >= 0;
      // thresholds stay double end to end: the python host pass compares
      // float64 config values, and a float32-narrowed 0.12 differs from
      // float64 0.12 by enough to flip borderline routing decisions
      const double derr = solved ? (double)errs[b]
                                 : std::numeric_limits<double>::infinity();
      if (solved && derr <= hp_err) continue;
      const int8_t* wseqs = seqs + (size_t)b * D * L;
      const int32_t* wlens = lens + (size_t)b * D;
      // routing probe: a long run must exist for a vote to fix anything
      int mrun = 0;
      if (solved) {
        mrun = max_run_of(cons_in + (size_t)b * CL, cons_lens[b]);
      } else {
        for (int j = 0; j < nseg && mrun < hp_min_run; ++j)
          mrun = std::max(mrun, max_run_of(wseqs + (size_t)j * L, wlens[j]));
      }
      if (mrun < hp_min_run) continue;
      // ---- run-length compress into the same [D, L] layout --------------
      int64_t seg_total = 0;
      for (int j = 0; j < nseg; ++j) {
        const int8_t* s = wseqs + (size_t)j * L;
        const int n = wlens[j];
        seg_total += n;
        int8_t* cs = cseqs.data() + (size_t)j * L;
        int32_t* cr = cruns.data() + (size_t)j * L;
        int m = 0;
        for (int i = 0; i < n; ++i) {
          if (m > 0 && s[i] == cs[m - 1]) {
            ++cr[m - 1];
          } else {
            cs[m] = s[i];
            cr[m] = 1;
            ++m;
          }
        }
        clens[j] = m;
      }
      // wlen_c = int(np.median(clens)): sorted middle, even -> mean then
      // int() truncation toward zero
      med_buf.assign(clens.begin(), clens.begin() + nseg);
      std::sort(med_buf.begin(), med_buf.end());
      const int mid = nseg / 2;
      const int wlen_c =
          (nseg & 1) ? med_buf[mid]
                     : (int)((med_buf[mid - 1] + med_buf[mid]) / 2.0);
      if (wlen_c < k0 + 4) continue;
      // ---- full-graph DBG on the compressed subproblem -------------------
      hcons.assign((size_t)wlen_c + len_slack, PAD);
      int32_t hlen = 0;
      float herr = 0.0f;
      uint8_t hm = 0;
      if (dbgc::try_tier(cseqs.data(), clens.data(), nseg, L, ts_hp, wlen_c,
                         anchor_slack, end_slack, len_slack, n_candidates,
                         (float)max_err, count_frac, S, hcons.data(), &hlen,
                         &herr, &hm) != 0)
        continue;
      // ---- aligned per-position run-length vote --------------------------
      a2b.resize(hlen + 1);
      runs_out.assign(hlen, 1);
      int64_t out_len = 0;
      const double* tab_sel = nullptr;   // heat-selected posterior table
      if (post_tabs != nullptr) {
        // calibrated posterior (vote_runs_posterior parity): per segment,
        // per-base claim cursors keep same-base counted spans disjoint;
        // the observation is the summed same-base run length over the
        // (one-position-extended) span; argmax_L of the summed log
        // likelihood, first-max tie-break like np.argmax.
        // heat grid comes from oracle/hp.py's shared constants (mult_lo,
        // mult_step, n_mult) — the ONE definition; hp_heat() parity:
        // round to the step grid (nearbyint = python round ties-even on
        // the same exact power-of-two arithmetic), then clip
        const int TL = Lmax + 1, TO = Omax + 1;
        const double mult_hi = mult_lo + mult_step * (n_mult - 1);
        const double m_raw = std::isfinite(derr)
            ? derr / std::max(p_err_prof, 1e-3) : 1.5;
        double mq = std::nearbyint(m_raw / mult_step) * mult_step;
        if (mq < mult_lo) mq = mult_lo;
        if (mq > mult_hi) mq = mult_hi;
        int mi = (int)std::nearbyint((mq - mult_lo) / mult_step);
        if (mi < 0) mi = 0;
        if (mi >= n_mult) mi = n_mult - 1;
        const double* tab = post_tabs + (size_t)mi * TL * TO;
        tab_sel = tab;
        ll_buf.assign((size_t)hlen * TL, 0.0);
        nv_buf.assign(hlen, 0);
        for (int j = 0; j < nseg; ++j) {
          const int m = clens[j];
          if (m == 0) continue;
          align_path(hcons.data(), hlen, cseqs.data() + (size_t)j * L, m,
                     Dbuf_v, a2b.data());
          const int32_t* cr = cruns.data() + (size_t)j * L;
          const int8_t* cs = cseqs.data() + (size_t)j * L;
          int claimed[4] = {0, 0, 0, 0};
          for (int i = 0; i < hlen; ++i) {
            const int c = hcons[i];
            if (c < 0 || c > 3) continue;
            int lo = (int)a2b[i];
            if (claimed[c] > lo) lo = claimed[c];
            int hi = (int)a2b[i + 1];
            if (hi < lo) hi = lo;
            if (hi < m && cs[hi] == c) ++hi;
            if (lo > claimed[c] && cs[lo - 1] == c) --lo;
            if (hi <= lo) continue;
            int64_t o = 0;
            for (int q = lo; q < hi; ++q)
              if (cs[q] == c) o += cr[q];
            const int oc = o > Omax ? Omax : (int)o;
            double* row = ll_buf.data() + (size_t)i * TL;
            for (int Lv = 0; Lv < TL; ++Lv)
              row[Lv] += tab[(size_t)Lv * TO + oc];
            nv_buf[i] += 1;
            claimed[c] = hi;
          }
        }
        for (int i = 0; i < hlen; ++i) {
          if (nv_buf[i]) {
            const double* row = ll_buf.data() + (size_t)i * TL;
            int bestL = 1;
            double bestv = row[1];
            for (int Lv = 2; Lv < TL; ++Lv)
              if (row[Lv] > bestv) { bestv = row[Lv]; bestL = Lv; }
            runs_out[i] = bestL;
          }
          out_len += runs_out[i];
        }
      } else {
      pos_votes.assign(hlen, {});
      for (int j = 0; j < nseg; ++j) {
        const int m = clens[j];
        if (m == 0) continue;
        align_path(hcons.data(), hlen, cseqs.data() + (size_t)j * L, m,
                   Dbuf_v, a2b.data());
        const int32_t* cr = cruns.data() + (size_t)j * L;
        const int8_t* cs = cseqs.data() + (size_t)j * L;
        for (int i = 0; i < hlen; ++i)
          for (int64_t q = a2b[i]; q < a2b[i + 1]; ++q)
            if (cs[q] == hcons[i]) pos_votes[i].push_back(cr[q]);
      }
      for (int i = 0; i < hlen; ++i) {
        auto& v = pos_votes[i];   // sort in place: no per-position copies
        if (!v.empty()) {
          std::sort(v.begin(), v.end());
          const int vm = (int)v.size() / 2;
          const double med = (v.size() & 1) ? (double)v[vm]
                                            : (v[vm - 1] + v[vm]) / 2.0;
          // int(round(med)): python round() is half-to-even; nearbyint
          // honors the default FE_TONEAREST (ties-to-even) mode
          runs_out[i] = std::max(1, (int)std::nearbyint(med));
        }
        out_len += runs_out[i];
      }
      }
      if (out_len < wlen / 2 || out_len > 2 * wlen || out_len > CLH)
        continue;
      expanded.resize(out_len);
      {
        int64_t w = 0;
        for (int i = 0; i < hlen; ++i)
          for (int r = 0; r < runs_out[i]; ++r) expanded[w++] = hcons[i];
      }
      // ---- exact rescore vs the ORIGINAL segments ------------------------
      int64_t tot = 0;
      for (int j = 0; j < nseg; ++j) {
        const int m = wlens[j];
        const int n = (int)out_len;
        if (n == 0) { tot += m; continue; }
        if (m == 0) { tot += n; continue; }
        Dbuf_v.resize((size_t)(n + 1) * (m + 1));
        tot += fill_exact(expanded.data(), n, wseqs + (size_t)j * L, m,
                          Dbuf_v.data(), m + 1, 16);
      }
      const double err_hp =
          (double)tot / (double)std::max<int64_t>(seg_total, 1);
      if (accept_likelihood && tab_sel != nullptr && solved) {
        // likelihood-ratio acceptance (hp_loglik parity): the expanded
        // candidate must EXPLAIN the segments better than the direct one,
        // with a loose raw-error sanity bound (oracle/hp.py hp_candidate)
        const double j_exp = hp_loglik_c(
            expanded.data(), (int)out_len, cseqs.data(), cruns.data(),
            clens.data(), nseg, L, tab_sel, Lmax, Omax, lambda_c,
            cc_buf, cr_buf, a2b, Dbuf_v);
        const double j_dir = hp_loglik_c(
            cons_in + (size_t)b * CL, cons_lens[b], cseqs.data(),
            cruns.data(), clens.data(), nseg, L, tab_sel, Lmax, Omax,
            lambda_c, cc_buf, cr_buf, a2b, Dbuf_v);
        if (!(j_exp > j_dir) || err_hp > derr + 0.10) continue;
      } else {
        const double bar = solved ? derr - hp_margin : max_err;
        if (err_hp >= bar) continue;
      }
      int8_t* out_row = hp_cons + (size_t)b * CLH;
      std::memset(out_row, PAD, CLH);
      std::memcpy(out_row, expanded.data(), out_len);
      cons_lens[b] = (int32_t)out_len;
      errs[b] = (float)err_hp;
      tiers_io[b] = 29;  // HP_TIER (oracle/hp.py)
      rescued.fetch_add(1);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int i = 0; i < n_threads; ++i) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return rescued.load();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// block-memory external)
// ---------------------------------------------------------------------------
// Key (aread, bread, abpos), stable on input order. The run partitioning
// (chunks of mem_records in input order), the stable chunk sort, the
// earliest-run-wins tie break and the fan-in-64 multi-level merge replicate
// formats/extsort.py's semantics exactly, so for a given mem_records the
// native and Python sorts emit byte-identical files.

namespace {

struct SortKey {
  int32_t aread, bread, abpos;
  bool operator<(const SortKey& o) const {
    if (aread != o.aread) return aread < o.aread;
    if (bread != o.bread) return bread < o.bread;
    return abpos < o.abpos;
  }
};

struct LasRec40 {
  int32_t tlen, diffs, abpos, bbpos, aepos, bepos;
  uint32_t flags;
  int32_t aread, bread, pad;
};
static_assert(sizeof(LasRec40) == 40, "record layout");

// buffered reader over a run file of raw (Rec40 + trace) records.
// corrupt != exhausted: a truncated record or garbage tlen sets `err`
// (silently dropping a foreign file's tail would hand downstream consensus
// an incomplete overlap set while reporting success)
struct RunReader {
  FILE* f = nullptr;
  int tsize = 1;
  std::vector<uint8_t> rec;   // current raw record bytes
  SortKey key{};
  bool ok = false;
  bool err = false;

  bool next() {
    LasRec40 h;
    size_t got = fread(&h, 1, sizeof(h), f);
    if (got != sizeof(h)) {
      ok = false;
      err = got != 0;          // partial header = corruption, 0 = clean EOF
      return false;
    }
    if (h.tlen < 0 || h.tlen > (1 << 28)) { ok = false; err = true; return false; }
    h.pad = 0;   // normalize struct tail padding like the Python writer
    rec.resize(sizeof(h) + (size_t)h.tlen * tsize);
    std::memcpy(rec.data(), &h, sizeof(h));
    if (h.tlen &&
        fread(rec.data() + sizeof(h), tsize, h.tlen, f) != (size_t)h.tlen) {
      ok = false;
      err = true;              // truncated trace
      return false;
    }
    key = SortKey{h.aread, h.bread, h.abpos};
    ok = true;
    return true;
  }
};

// merge `paths` (already individually sorted) into `out`; `hdr16` non-null
// writes the 16-byte LAS header (novl patched at the end) for the final
// file. `in_hdr_tspace >= 0` means each input starts with a 16-byte LAS
// header that must carry that tspace (the las_merge foreign-input mode);
// -1 means headerless run files. `count_out` (optional) receives novl.
static int merge_runs(const std::vector<std::string>& paths, int tsize,
                      const char* out, const uint8_t* hdr16,
                      int32_t in_hdr_tspace = -1,
                      int64_t* count_out = nullptr) {
  std::vector<RunReader> rs(paths.size());
  auto close_runs = [&]() {
    for (auto& r : rs)
      if (r.f) { fclose(r.f); r.f = nullptr; }
  };
  for (size_t i = 0; i < paths.size(); ++i) {
    rs[i].f = fopen(paths[i].c_str(), "rb");
    if (!rs[i].f) { close_runs(); return -1; }
    if (in_hdr_tspace >= 0) {
      struct { int64_t novl; int32_t tspace; int32_t pad; } h;
      if (fread(&h, 16, 1, rs[i].f) != 1 || h.tspace != in_hdr_tspace) {
        close_runs();
        return -6;
      }
    }
    rs[i].tsize = tsize;
    rs[i].next();
  }
  FILE* fo = fopen(out, "wb");
  if (!fo) { close_runs(); return -1; }
  int64_t novl = 0;
  if (hdr16 && fwrite(hdr16, 16, 1, fo) != 1) { fclose(fo); close_runs(); return -2; }
  using HeapItem = std::pair<SortKey, size_t>;   // (key, run ordinal)
  auto gt = [](const HeapItem& a, const HeapItem& b) {
    if (b.first < a.first) return true;
    if (a.first < b.first) return false;
    return a.second > b.second;   // earliest run wins ties (stability)
  };
  std::priority_queue<HeapItem, std::vector<HeapItem>, decltype(gt)> heap(gt);
  for (size_t i = 0; i < rs.size(); ++i)
    if (rs[i].ok) heap.push({rs[i].key, i});
  while (!heap.empty()) {
    size_t i = heap.top().second;
    heap.pop();
    if (fwrite(rs[i].rec.data(), 1, rs[i].rec.size(), fo) != rs[i].rec.size()) {
      fclose(fo);
      close_runs();
      return -2;
    }
    ++novl;
    if (rs[i].next()) heap.push({rs[i].key, i});
  }
  for (const auto& r : rs)
    if (r.err) { fclose(fo); close_runs(); return -7; }   // corrupt input
  if (hdr16) {
    struct { int64_t novl; int32_t tspace; int32_t pad; } hdr;
    std::memcpy(&hdr, hdr16, 16);
    hdr.novl = novl;
    fseek(fo, 0, SEEK_SET);
    if (fwrite(&hdr, 16, 1, fo) != 1) { fclose(fo); close_runs(); return -2; }
  }
  close_runs();
  if (count_out) *count_out = novl;
  // fclose flushes the tail of the stdio buffer: a full disk surfaces HERE,
  // not at the buffered fwrites — an unchecked close would report a
  // truncated file as success
  return fclose(fo) == 0 ? 0 : -2;
}

}  // namespace

extern "C" {

// k-way merge of ALREADY-SORTED headered LAS files (LAmerge role; DALIGNER
// emits one LAS per block pair). Same key and earliest-input-wins tie break
// as las_sort / the Python heapq.merge path. in_paths is a
// NUL-separated, double-NUL-terminated list. Returns the record count or a
// negative error; all inputs must share out-file tspace `tspace_expect`.
int64_t las_merge(const char* in_paths, const char* out_path,
                  int32_t tspace_expect) {
  std::vector<std::string> paths;
  for (const char* p = in_paths; *p;) {
    paths.emplace_back(p);
    p += paths.back().size() + 1;
  }
  if (paths.empty()) return -1;
  const int tsize = tspace_expect <= 125 ? 1 : 2;
  struct { int64_t novl; int32_t tspace; int32_t pad; } oh{0, tspace_expect, 0};
  uint8_t hdr16[16];
  std::memcpy(hdr16, &oh, 16);
  int64_t novl = 0;
  const int rc = merge_runs(paths, tsize, out_path, hdr16,
                            /*in_hdr_tspace=*/tspace_expect, &novl);
  return rc == 0 ? novl : rc;
}

// sorts in_path -> out_path by (aread, bread, abpos) holding at most
// mem_records records in memory; temp runs live in tmp_dir. Returns the
// record count, or a negative error.
int64_t las_sort(const char* in_path, const char* out_path,
                 const char* tmp_dir, int64_t mem_records) {
  FILE* f = fopen(in_path, "rb");
  if (!f) return -1;
  struct { int64_t novl; int32_t tspace; int32_t pad; } hdr;
  if (fread(&hdr, 16, 1, f) != 1) { fclose(f); return -2; }
  const int tsize = hdr.tspace <= 125 ? 1 : 2;
  hdr.pad = 0;   // normalize header padding like the Python writer
  uint8_t hdr16[16];
  std::memcpy(hdr16, &hdr, 16);

  std::vector<uint8_t> arena;        // raw record bytes of the current chunk
  struct Ent { SortKey key; int64_t off; int32_t size; };
  std::vector<Ent> ents;
  std::vector<std::string> runs;
  int gen = 0;

  auto run_path = [&](int g) {
    return std::string(tmp_dir) + "/nrun" + std::to_string(g) + ".bin";
  };
  auto flush = [&]() -> int {
    if (ents.empty()) return 0;
    std::stable_sort(ents.begin(), ents.end(),
                     [](const Ent& a, const Ent& b) { return a.key < b.key; });
    std::string rp = run_path(gen++);
    FILE* fo = fopen(rp.c_str(), "wb");
    if (!fo) return -1;
    for (const auto& e : ents)
      if (fwrite(arena.data() + e.off, 1, e.size, fo) != (size_t)e.size) {
        fclose(fo);
        return -2;
      }
    fclose(fo);
    runs.push_back(rp);
    ents.clear();
    arena.clear();
    return 0;
  };

  LasRec40 rec;
  int64_t total = 0;
  size_t got;
  while ((got = fread(&rec, 1, sizeof(rec), f)) == sizeof(rec)) {
    if (rec.tlen < 0 || rec.tlen > (1 << 28)) { fclose(f); return -3; }
    rec.pad = 0;   // normalize struct tail padding like the Python writer
    const size_t sz = sizeof(rec) + (size_t)rec.tlen * tsize;
    const int64_t off = (int64_t)arena.size();
    arena.resize(arena.size() + sz);
    std::memcpy(arena.data() + off, &rec, sizeof(rec));
    if (rec.tlen && fread(arena.data() + off + sizeof(rec), tsize, rec.tlen, f)
                        != (size_t)rec.tlen) {
      fclose(f);
      return -3;
    }
    ents.push_back({SortKey{rec.aread, rec.bread, rec.abpos}, off, (int32_t)sz});
    ++total;
    if ((int64_t)ents.size() >= mem_records)
      if (flush() != 0) { fclose(f); return -4; }
  }
  if (got != 0) { fclose(f); return -3; }   // partial record = truncated input
  fclose(f);

  if (runs.empty()) {
    // whole input fit one chunk: sort and write directly (same fast path as
    // the Python implementation)
    std::stable_sort(ents.begin(), ents.end(),
                     [](const Ent& a, const Ent& b) { return a.key < b.key; });
    FILE* fo = fopen(out_path, "wb");
    if (!fo) return -1;
    if (fwrite(hdr16, 16, 1, fo) != 1) { fclose(fo); return -2; }
    for (const auto& e : ents)
      if (fwrite(arena.data() + e.off, 1, e.size, fo) != (size_t)e.size) {
        fclose(fo);
        return -2;
      }
    struct { int64_t novl; int32_t tspace; int32_t pad; } oh;
    std::memcpy(&oh, hdr16, 16);
    oh.novl = total;
    fseek(fo, 0, SEEK_SET);
    if (fwrite(&oh, 16, 1, fo) != 1) { fclose(fo); return -2; }
    if (fclose(fo) != 0) return -2;   // flush failure = truncated output
    return total;
  }
  if (flush() != 0) return -4;

  // multi-level merge, fan-in 64 (same grouping as extsort.py)
  const size_t FANIN = 64;
  while (runs.size() > FANIN) {
    std::vector<std::string> merged;
    for (size_t g0 = 0; g0 < runs.size(); g0 += FANIN) {
      std::vector<std::string> group(
          runs.begin() + g0,
          runs.begin() + std::min(runs.size(), g0 + FANIN));
      std::string rp = run_path(gen++);
      if (merge_runs(group, tsize, rp.c_str(), nullptr) != 0) return -5;
      for (const auto& p : group) std::remove(p.c_str());
      merged.push_back(rp);
    }
    runs = std::move(merged);
  }
  if (merge_runs(runs, tsize, out_path, hdr16) != 0) return -5;
  for (const auto& p : runs) std::remove(p.c_str());
  return total;
}


// Rows idx[0..k) of a [*, row_bytes] array into out [k, row_bytes].
void take_rows(const uint8_t* src, int64_t row_bytes, const int64_t* idx,
               int64_t k, uint8_t* out) {
  for (int64_t i = 0; i < k; ++i)
    std::memcpy(out + i * row_bytes, src + idx[i] * row_bytes, row_bytes);
}

// Rows idx[0..k) of a page table [*, pages] as a sample of their own: the
// pool pages they name, page 0 (the PAD sentinel) first and the rest in
// ascending order, into out_pool [n, page_len], and the rows renumbered
// into them, into out_table [k, pages]. Returns n (at most k * pages + 1),
// or -1 if an entry names no page of the pool's n_pages. The numpy take
// (union1d, searchsorted) gives the same bytes; a packed batch's pages rise
// along its rows, so the sort is usually skipped.
int64_t take_pages(const int32_t* table, int64_t pages, const int64_t* idx,
                   int64_t k, const int8_t* pool, int64_t n_pages,
                   int64_t page_len, int32_t* out_table, int8_t* out_pool) {
  std::vector<int32_t> used;
  used.reserve(k * pages + 1);
  used.push_back(0);
  bool rising = true;
  for (int64_t i = 0; i < k; ++i) {
    const int32_t* r = table + idx[i] * pages;
    for (int64_t j = 0; j < pages; ++j) {
      if (r[j] < 0 || r[j] >= n_pages) return -1;
      if (r[j] != 0) {
        rising = rising && r[j] > used.back();
        used.push_back(r[j]);
      }
    }
  }
  if (rising) {
    int32_t rank = 0;
    for (int64_t i = 0; i < k; ++i) {
      const int32_t* r = table + idx[i] * pages;
      for (int64_t j = 0; j < pages; ++j)
        out_table[i * pages + j] = r[j] != 0 ? ++rank : 0;
    }
  } else {
    std::sort(used.begin(), used.end());
    used.erase(std::unique(used.begin(), used.end()), used.end());
    for (int64_t i = 0; i < k; ++i) {
      const int32_t* r = table + idx[i] * pages;
      for (int64_t j = 0; j < pages; ++j)
        out_table[i * pages + j] = int32_t(
            std::lower_bound(used.begin(), used.end(), r[j]) - used.begin());
    }
  }
  for (size_t u = 0; u < used.size(); ++u)
    std::memcpy(out_pool + u * page_len, pool + int64_t(used[u]) * page_len,
                page_len);
  return int64_t(used.size());
}

}  // extern "C"
