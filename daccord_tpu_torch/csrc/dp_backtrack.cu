// Fused heaviest-path DP, end-state choice, backtrack and candidate assembly
// for a batch of consensus windows, hand-written for Hopper (sm_90a).
//
// Replaces daccord_tpu/kernels/pallas_window.py:dp_backtrack_batch (the
// Pallas TPU kernel, body _fused_kernel) and computes exactly what it
// computes, bit for bit:
//   - the max-plus DP over P steps on the [M, M] adjacency (0 or -1e30),
//     s_t[v] = max_u (s_{t-1}[u] + adjW[u, v]) + wt[t, v], taking the lowest
//     u on ties, and NEG where the best predecessor is itself NEG;
//   - C rounds of end-state choice: the argmax over the flat index t*M + v of
//     the scores at t in [t_lo, t_hi] on sink-admissible v whose final k-mer
//     was not chosen before, lowest flat index on ties (an all-masked round
//     gives idx 0 and ok 0);
//   - the backtrack through the pointer stack, and the candidate bases: the
//     k head bases of the first k-mer, then the last base of each later
//     k-mer, PAD (4) from t_best + k on.
// The adjacency bits and the DP step are csrc/dp_bits.cuh, shared with
// csrc/heaviest_path.cu.
//
// What bounds it on this card: the DP's (P-1) * M * M cells per window. A
// cell costs a bit test and a select, and every four cells three maxima and
// one compare-and-update: ~3.5 instructions, all on the SM's integer/logic
// pipe, which takes a warp instruction every other cycle; ~1.3 ms of that
// pipe at M=256 and B=2048 (PERF.md has the times). Its bytes bound is one
// read of the inputs (B * M * M * 4 for adjW), 0.19 ms there, since only
// the candidates leave the kernel. A simple kernel that re-read the f32
// adjacency from L2 or HBM at every step, and chose the end states in one
// thread, ran 37x above that bound at M=256.
//
// What the design does about it: the adjacency is read once, as 16-byte
// loads, into bits and from there into registers; the two possible terms of
// each predecessor are added once per step; a cell's compare-and-update is
// shared by a group of four (csrc/dp_bits.cuh); a column's predecessors are
// split over S=2 threads and K compare chains, so that the escalation
// tiers' ~128-window batches still fill the card; one window a block (two a
// block at M=64 measured no faster at B=2048 and slower at B=128). The
// score rows t_lo..t_hi, the uint16 pointer stack and the k-mer codes stay
// in shared memory. Each end state is a window-wide argmax (a strided scan
// per thread, warp shuffles, then one warp over the warps' results, the
// lowest flat index on ties); one thread walks the P-step backtrack, and
// the window's threads write the candidate bases.

#include <limits.h>

#include "dp_bits.cuh"

#define PAD_BASE 4

using namespace dpbits;

template <int S, int U, int K>
struct FusedConfig {
    static constexpr int MP = S * U;          // padded columns
    static constexpr int THREADS = S * MP;    // one window a block
    static constexpr int ZS = S * (U + 4);    // one term buffer
    static constexpr int WARPS = THREADS / 32;
    static constexpr bool OVERLAY = MP > 256; // the wide windows' layout
};

// Shared memory of one block, in bytes from its start: 4-byte arrays first,
// then the uint16 pointer stack, then bytes. With ``overlay`` (the wide
// windows, M > 256) the adjacency bits share their bytes with the score rows
// and the pointer stack: the bits are read only into registers before the
// DP, and at M=1024 the three together would not fit the SM (130 + 68 + 84
// KB of its 227 KB).
struct FusedLayout {
    int z, n, bits, esc, sel, kpath, rv, ri, tb, pst, snk, chosen, total;
};

__host__ __device__ inline FusedLayout fused_layout(int ZS, int M, int P, int T,
                                                    bool overlay = false)
{
    FusedLayout L;
    int o = 0;
    L.z = o;      o += 4 * 2 * ZS;                // [2][ZS] f32
    L.n = o;      o += 4 * 2 * ZS;                // [2][ZS] f32
    if (overlay) {
        const int bits = 4 * bits_words(M * M);
        const int rows = 4 * T * M + 2 * P * M;
        L.bits = o;
        L.esc = o;                                // [T][M] f32, rows t_lo..t_hi
        L.pst = o + 4 * T * M;                    // [P][M] u16
        o += ((bits > rows ? bits : rows) + 3) & ~3;
    } else {
        L.bits = o;   o += 4 * bits_words(M * M);
        L.esc = o;    o += 4 * T * M;             // [T][M] f32, rows t_lo..t_hi
    }
    L.sel = o;    o += 4 * M;                     // [M] i32
    L.kpath = o;  o += 4 * P;                     // [P] i32
    L.rv = o;     o += 4 * 32;                    // [32] f32, per-warp maxima
    L.ri = o;     o += 4 * 32;                    // [32] i32, their indices
    L.tb = o;     o += 4;                         // i32
    if (!overlay) {
        L.pst = o; o += 2 * P * M;                // [P][M] u16
    }
    L.snk = o;    o += M;                         // [M] u8
    L.chosen = o; o += M;                         // [M] u8
    L.total = o;
    return L;
}

// (value, flat index) argmax over the 32 lanes: the larger value, the lower
// index on equal values; every lane ends with the result
__device__ __forceinline__ void argmax_warp(float& bv, int& bi)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
        }
    }
}

template <int S, int U, int K>
__global__ void __launch_bounds__(FusedConfig<S, U, K>::THREADS,
                                  1024 / FusedConfig<S, U, K>::THREADS)
dp_backtrack_kernel(
    const float* __restrict__ adjW,     // [B, M, M]
    const float* __restrict__ wt,       // [B, P, M]
    const float* __restrict__ s0,       // [B, M]
    const uint8_t* __restrict__ snk,    // [B, M] bool
    const int32_t* __restrict__ sel,    // [B, M] k-mer codes
    int32_t* __restrict__ cand,         // [B, C, CL]
    int32_t* __restrict__ clen,         // [B, C]
    uint8_t* __restrict__ ok,           // [B, C] bool
    int M, int P, int C, int CL, int k, int t_lo, int t_hi)
{
    using F = FusedConfig<S, U, K>;
    extern __shared__ __align__(16) unsigned char smem[];
    const int T = t_hi - t_lo + 1;
    const FusedLayout L = fused_layout(F::ZS, M, P, T, F::OVERLAY);
    float* Z = reinterpret_cast<float*>(smem + L.z);
    float* N = reinterpret_cast<float*>(smem + L.n);
    unsigned* bits = reinterpret_cast<unsigned*>(smem + L.bits);
    float* esc = reinterpret_cast<float*>(smem + L.esc);
    int32_t* sel_s = reinterpret_cast<int32_t*>(smem + L.sel);
    int32_t* kpath = reinterpret_cast<int32_t*>(smem + L.kpath);
    float* rv = reinterpret_cast<float*>(smem + L.rv);
    int32_t* ri = reinterpret_cast<int32_t*>(smem + L.ri);
    int32_t* sh_tb = reinterpret_cast<int32_t*>(smem + L.tb);
    uint16_t* pst = reinterpret_cast<uint16_t*>(smem + L.pst);
    uint8_t* snk_s = smem + L.snk;
    uint8_t* chosen = smem + L.chosen;

    const int b = blockIdx.x;
    const int r = threadIdx.x;
    const int v = r / S;
    const int s = r % S;
    const int lane = r & 31;
    const int wid = r >> 5;
    const bool col = v < M;

    // ---- adjacency bits, the window's row inputs --------------------------
    load_bits(adjW + (size_t)b * M * M, M * M, bits);
    __syncthreads();
    unsigned cw[U / 32];
    column_bits<U>(bits, M, s * U, v, cw);
    if (F::OVERLAY) __syncthreads();          // the bits' bytes are reused below

    const float* w = wt + (size_t)b * P * M;
    const int zv = zpad<U>(v);
    const float start = col ? s0[(size_t)b * M + v] : 0.f;
    if (s == 0) {
        Z[zv] = col ? start + 0.0f : neg_inf();
        if (col) {
            if (t_lo == 0) esc[v] = start;
            sel_s[v] = sel[(size_t)b * M + v];
            snk_s[v] = snk[(size_t)b * M + v];
            chosen[v] = 0;
        }
    }
    if (s == S - 1) {
        N[zv] = col ? start + NEGF : neg_inf();
        if (col) pst[v] = 0;
    }
    __syncthreads();

    // ---- heaviest-path max-plus DP ---------------------------------------
    int cur = 0;
    for (int t = 1; t < P; ++t) {
        const float wv = col ? w[(size_t)t * M + v] : 0.f;
        float best;
        int bu;
        dp_step<S, U, K>(Z + cur * F::ZS, N + cur * F::ZS, cw, s, best, bu);
        const float sn = (best > NEGF * 0.5f) ? best + wv : NEGF;
        const int nx = cur ^ 1;
        if (s == 0) {
            Z[nx * F::ZS + zv] = col ? sn + 0.0f : neg_inf();
            if (col && t >= t_lo && t <= t_hi) esc[(t - t_lo) * M + v] = sn;
        }
        if (s == S - 1) {
            N[nx * F::ZS + zv] = col ? sn + NEGF : neg_inf();
            if (col) pst[t * M + v] = (uint16_t)bu;
        }
        __syncthreads();
        cur = nx;
    }

    // ---- C end states with distinct final k-mers, then backtrack ---------
    // rows outside [t_lo, t_hi] read as NEG, so of them only the lowest flat
    // index can win: 0 when t_lo > 0, else (t_hi + 1) * M
    const int out_idx = t_lo > 0 ? 0 : (t_hi < P - 1 ? (t_hi + 1) * M : -1);
    for (int c = 0; c < C; ++c) {
        // each thread scans its in-range entries in ascending flat index
        float bv = neg_inf();
        int bi = INT_MAX;
        for (int i = r; i < T * M; i += F::THREADS) {
            const int vv = i % M;
            const float x = (snk_s[vv] && !chosen[vv]) ? esc[i] : NEGF;
            if (x > bv) {
                bv = x;
                bi = t_lo * M + i;
            }
        }
        argmax_warp(bv, bi);
        if (lane == 0) {
            rv[wid] = bv;
            ri[wid] = bi;
        }
        __syncthreads();
        if (wid == 0) {
            bv = lane < F::WARPS ? rv[lane] : neg_inf();
            bi = lane < F::WARPS ? ri[lane] : INT_MAX;
            if (lane == 0 && out_idx >= 0
                    && (NEGF > bv || (NEGF == bv && out_idx < bi))) {
                bv = NEGF;
                bi = out_idx;
            }
            argmax_warp(bv, bi);
            if (lane == 0) {
                const int tb = bi / M;
                const int vb = bi % M;
                chosen[vb] = 1;
                int node = 0;
                for (int i = 0; i < P; ++i) {
                    const int t = P - 1 - i;
                    int forced = (t == tb) ? vb : node;
                    forced = forced < 0 ? 0 : (forced > M - 1 ? M - 1 : forced);
                    kpath[t] = sel_s[forced];
                    const int pv = pst[t * M + forced];
                    node = (t <= tb && t > 0) ? pv : forced;
                }
                sh_tb[0] = tb;
                clen[(size_t)b * C + c] = tb + k;
                ok[(size_t)b * C + c] = (bv > NEGF * 0.5f) ? 1 : 0;
            }
        }
        __syncthreads();
        // kpath and chosen are next written after the next round's first
        // barrier, which every thread reaches only after these reads
        const int tb = sh_tb[0];
        const unsigned first = (unsigned)kpath[0];
        for (int j = r; j < CL; j += F::THREADS) {
            int sh = 2 * (k - 1 - j);
            sh = sh < 0 ? 0 : (sh > 30 ? 30 : sh);
            const int head = (int)((first >> sh) & 3u);
            int tt = j - k + 1;
            tt = tt < 0 ? 0 : (tt > P - 1 ? P - 1 : tt);
            const int tail = kpath[tt] & 3;
            const int base = j < k ? head : tail;
            cand[((size_t)b * C + c) * CL + j] = (j < tb + k) ? base : PAD_BASE;
        }
    }
}

template <int S, int U, int K>
static int launch(const void* adjW, const void* wt, const void* s0, const void* snk,
                  const void* sel, void* cand, void* clen, void* ok, int B, int M,
                  int P, int C, int CL, int k, int t_lo, int t_hi,
                  cudaStream_t stream)
{
    using F = FusedConfig<S, U, K>;
    const size_t smem = fused_layout(F::ZS, M, P, t_hi - t_lo + 1, F::OVERLAY).total;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dp_backtrack_kernel<S, U, K>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dp_backtrack_kernel<S, U, K><<<B, F::THREADS, smem, stream>>>(
        (const float*)adjW, (const float*)wt, (const float*)s0,
        (const uint8_t*)snk, (const int32_t*)sel, (int32_t*)cand,
        (int32_t*)clen, (uint8_t*)ok, M, P, C, CL, k, t_lo, t_hi);
    return (int)cudaGetLastError();
}

extern "C" int dp_backtrack_launch(
    const void* adjW, const void* wt, const void* s0, const void* snk,
    const void* sel, void* cand, void* clen, void* ok,
    int B, int M, int P, int C, int CL, int k, int t_lo, int t_hi,
    void* stream)
{
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    // the split follows from M alone: two threads a column up to M=512, one
    // above (a block holds at most 1024 threads), one window a block
    if (M <= 64)
        return launch<2, 32, 2>(adjW, wt, s0, snk, sel, cand, clen, ok, B, M, P,
                                C, CL, k, t_lo, t_hi, st);
    if (M <= 256)
        return launch<2, 128, 4>(adjW, wt, s0, snk, sel, cand, clen, ok, B, M, P,
                                 C, CL, k, t_lo, t_hi, st);
    if (M <= 512)
        return launch<2, 256, 4>(adjW, wt, s0, snk, sel, cand, clen, ok, B, M, P,
                                 C, CL, k, t_lo, t_hi, st);
    if (M <= 1024)
        return launch<1, 1024, 4>(adjW, wt, s0, snk, sel, cand, clen, ok, B, M, P,
                                  C, CL, k, t_lo, t_hi, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* dp_backtrack_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
