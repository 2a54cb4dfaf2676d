// The port's host library: the feeder half of the JAX package's C++ host
// library, copied into the port so that the port builds and loads its own.
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
//
// A plain C ABI for ctypes, built with g++ by daccord_tpu_torch/native. The
// realignment replicates the numpy align_path of daccord_tpu_torch/oracle/
// align.py exactly (unit-cost DP, backtrack preferring diagonal, then
// deletion, then insertion, a2b[0] = 0), so the native and numpy feeders
// write byte-identical windows.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
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
