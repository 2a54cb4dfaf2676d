// The rescore of a batch of consensus windows in one launch, hand-written
// for Hopper (sm_90a): every candidate's exact edit distance to every
// segment of its window, the per-candidate sums, the argmin and the accept
// test. It computes what kernels/rescore.py rescore_pick_plain computes, bit
// for bit:
//   - dist(c, d) = the unit-cost edit distance of cand[c, :clen[c]] and
//     seg[d, :lens[d]] (Myers/Hyyro bit-parallel, the DP column in NW 64-bit
//     words, the addition's carry and the left shifts crossing words;
//     PAD and any byte outside 0..3 match nothing); segments of length 0
//     count 0;
//   - err[c] = (float)(sum_d dist(c, d)) / (float)max(sum_d lens[d], 1), the
//     exact integer sum and one IEEE division, +inf where ok[c] is 0;
//   - ci = the lowest c reaching the minimum (0 when every err is inf); the
//     window is solved when some ok[c] is set, err[ci] <= max_err and
//     nsegs >= min_depth; cons is cand[ci] when solved, else PAD; cons_len is
//     clen[ci] when solved and ok[ci], else 0; err is err[ci] when some
//     ok[c] is set, else +inf.
//
// It replaces no Pallas kernel: the JAX package leaves the rescore to XLA.
// The plain torch version runs L steps of ~30 small ops each, ~1,900
// launches a tier, which made the ladder launch-bound on the card.
//
// What bounds it: it reads each window's [D, L] tile, its candidates and
// lengths once and writes a row; the work is ~17 64-bit logic/add ops a
// (candidate, segment base, word). Both are a few microseconds at B=2048.
//
// Design: one warp a window (RS_WARPS windows a block), lane l taking the
// window's segments l, l + 32, ...; each lane runs G candidates' Myers
// chains side by side over its segment (G = min(C, 4) at one 64-bit word,
// fewer at more words), so each base step issues G independent dependent
// chains. Candidates go in groups of G in ascending order, the last group
// padded with copies of the last candidate (their sums are not used).
// - The segment is read in 16-byte vector loads (bytes where the row is not
//   16-byte aligned), the next chunk loaded while the current one's 16
//   steps run, each base taken from a register: no shared-memory tile, so
//   no bank conflict on the step's read (the design before read
//   seg_s[d * L + i] from every lane, 16 lanes a bank at L = 64).
// - A group's match masks are built once per warp: each 64-bit word of a
//   base's mask is two __ballot_sync over 32 candidate bases, written to
//   the warp's table peq[G][5][NW] in shared memory (row 4 = 0 for PAD and
//   any byte outside 0..3), and each step looks its mask up there by base.
// - No per-step score: the distance is read off the final column, D[n][m]
//   = m + popcount(VP) - popcount(VN) over the candidate's n rows (the
//   first row is D[0][j] = j), which equals the plain version's running
//   score at step m and saves the last row's two tests a step.
// - Sums and the window's segment bases are warp shuffle reductions; lane
//   0 keeps the running argmin (strictly lower error wins, so the lowest
//   index among equal errors) and writes the row's scalars, and the lanes
//   copy the chosen candidate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PAD_BASE 4
#define RS_WARPS 4
#define FULL 0xffffffffu

__device__ __forceinline__ uint64_t low_ones(int k)
{
    return k <= 0 ? 0ull : (k >= 64 ? ~0ull : ((1ull << k) - 1ull));
}

__device__ __forceinline__ int warp_sum(int v)
{
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    return v;
}

// 16 segment bytes from i0 on: one vector load when the row is 16-byte
// aligned, else bytes up to the row's end L
__device__ __forceinline__ uint4 load16(const int8_t* sg, int i0, int L, bool vec)
{
    if (vec) return __ldg(reinterpret_cast<const uint4*>(sg + i0));
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 16; ++k)
        if (i0 + k < L) w[k >> 2] |= (uint32_t)(uint8_t)sg[i0 + k] << ((k & 3) * 8);
    return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int NW, int G>
__global__ void __launch_bounds__(RS_WARPS * 32) rescore_kernel(
    const int8_t* __restrict__ seqs,    // [B, D, L]
    const int32_t* __restrict__ lens,   // [B, D]
    const int32_t* __restrict__ nsegs,  // [B]
    const int8_t* __restrict__ cand,    // [B, C, CL]
    const int32_t* __restrict__ clen,   // [B, C]
    const uint8_t* __restrict__ ok,     // [B, C] bool
    int8_t* __restrict__ cons,          // [B, CL]
    int32_t* __restrict__ cons_len,     // [B]
    float* __restrict__ err,            // [B]
    uint8_t* __restrict__ solved,       // [B] bool
    int B, int D, int L, int C, int CL, int min_depth, float max_err, int vec)
{
    __shared__ uint64_t peq_s[RS_WARPS][G][5][NW];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int b = blockIdx.x * RS_WARPS + warp;
    if (b >= B) return;                 // the whole warp; no block barrier below
    uint64_t (*peq)[5][NW] = peq_s[warp];
    const int8_t* cb = cand + (size_t)b * C * CL;
    const int32_t* lb = lens + (size_t)b * D;

    int total = 0;
    for (int d = lane; d < D; d += 32) total += lb[d];
    total = warp_sum(total);
    const float denom = __int2float_rn(total < 1 ? 1 : total);

    float be = INFINITY;
    int ci = 0, any = 0;
    for (int c0 = 0; c0 < C; c0 += G) {
        int n[G];
        __syncwarp();                   // the previous group's table is read
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int c = min(c0 + g, C - 1);
            n[g] = clen[(size_t)b * C + c];
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                uint64_t m4[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = w * 64 + h * 32 + lane;
                    const int x = (i < n[g] && i < CL) ? cb[c * CL + i] : -1;
#pragma unroll
                    for (int v = 0; v < 4; ++v)
                        m4[v] |= (uint64_t)__ballot_sync(FULL, x == v) << (32 * h);
                }
                if (lane == 0) {
#pragma unroll
                    for (int v = 0; v < 4; ++v) peq[g][v][w] = m4[v];
                    peq[g][4][w] = 0ull;
                }
            }
        }
        __syncwarp();

        int sum[G];
#pragma unroll
        for (int g = 0; g < G; ++g) sum[g] = 0;
        for (int d = lane; d < D; d += 32) {
            const int m = lb[d];
            if (m <= 0) continue;
            const int8_t* sg = seqs + ((size_t)b * D + d) * L;
            uint64_t vp[G][NW], vn[G][NW];
#pragma unroll
            for (int g = 0; g < G; ++g) {
#pragma unroll
                for (int w = 0; w < NW; ++w) {
                    vp[g][w] = low_ones(n[g] - 64 * w);
                    vn[g][w] = 0ull;
                }
            }
            uint4 cur = load16(sg, 0, L, vec);
            for (int i0 = 0; i0 < m; i0 += 16) {
                const uint4 nxt = i0 + 16 < m ? load16(sg, i0 + 16, L, vec) : cur;
                const uint32_t wd[4] = {cur.x, cur.y, cur.z, cur.w};
                const int kmax = m - i0;
#pragma unroll
                for (int k = 0; k < 16; ++k) {
                    if (k < kmax) {
                        const uint32_t x = min((wd[k >> 2] >> ((k & 3) * 8)) & 0xffu, 4u);
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            uint64_t carry = 0ull, hp_in = 1ull, hn_in = 0ull;
#pragma unroll
                            for (int w = 0; w < NW; ++w) {
                                const uint64_t X = peq[g][x][w] | vn[g][w];
                                const uint64_t A = X & vp[g][w];
                                const uint64_t t1 = vp[g][w] + A;
                                const uint64_t s = t1 + carry;
                                carry = (uint64_t)((t1 < vp[g][w]) | (s < t1));
                                const uint64_t d0 = (s ^ vp[g][w]) | X;
                                const uint64_t hn = vp[g][w] & d0;
                                const uint64_t hp = vn[g][w] | ~(vp[g][w] | d0);
                                const uint64_t x2 = (hp << 1) | hp_in;
                                const uint64_t h2 = (hn << 1) | hn_in;
                                hp_in = hp >> 63;
                                hn_in = hn >> 63;
                                vn[g][w] = x2 & d0;
                                vp[g][w] = h2 | ~(x2 | d0);
                            }
                        }
                    }
                }
                cur = nxt;
            }
            // D[n][m] = D[0][m] + the column's vertical deltas = m + #vp - #vn
            // over the candidate's n rows (bits above n carry no meaning)
#pragma unroll
            for (int g = 0; g < G; ++g) {
                int dist = m;
#pragma unroll
                for (int w = 0; w < NW; ++w) {
                    const uint64_t rows = low_ones(n[g] - 64 * w);
                    dist += __popcll(vp[g][w] & rows) - __popcll(vn[g][w] & rows);
                }
                sum[g] += dist;
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int s = warp_sum(sum[g]);
            const int c = c0 + g;
            if (c < C) {
                const int okc = ok[(size_t)b * C + c] ? 1 : 0;
                const float e = okc ? __fdiv_rn(__int2float_rn(s), denom) : INFINITY;
                any |= okc;
                if (c == 0 || e < be) {
                    be = e;
                    ci = c;
                }
            }
        }
    }
    const int sv = any && be <= max_err && nsegs[b] >= min_depth;
    if (lane == 0) {
        const int bl = ok[(size_t)b * C + ci] ? clen[(size_t)b * C + ci] : 0;
        cons_len[b] = sv ? bl : 0;
        err[b] = any ? be : INFINITY;
        solved[b] = (uint8_t)sv;
    }
    for (int j = lane; j < CL; j += 32)
        cons[(size_t)b * CL + j] = sv ? cb[ci * CL + j] : (int8_t)PAD_BASE;
}

template <int NW, int G>
static int launch(const void* seqs, const void* lens, const void* nsegs, const void* cand,
                  const void* clen, const void* ok, void* cons, void* cons_len, void* err,
                  void* solved, int B, int D, int L, int C, int CL, int min_depth,
                  float max_err, int vec, cudaStream_t stream)
{
    rescore_kernel<NW, G><<<(B + RS_WARPS - 1) / RS_WARPS, RS_WARPS * 32, 0, stream>>>(
        (const int8_t*)seqs, (const int32_t*)lens, (const int32_t*)nsegs,
        (const int8_t*)cand, (const int32_t*)clen, (const uint8_t*)ok, (int8_t*)cons,
        (int32_t*)cons_len, (float*)err, (uint8_t*)solved, B, D, L, C, CL, min_depth,
        max_err, vec);
    return (int)cudaGetLastError();
}

extern "C" int rescore_launch(
    const void* seqs, const void* lens, const void* nsegs, const void* cand,
    const void* clen, const void* ok, void* cons, void* cons_len, void* err,
    void* solved, int B, int D, int L, int C, int CL, int min_depth, float max_err,
    void* stream)
{
    if (B == 0) return 0;
    if (C < 1 || CL < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    // 16-byte loads of each segment row: L a multiple of 16, the tile aligned
    const int vec = (L % 16 == 0) && ((uintptr_t)seqs % 16 == 0);
    const int nw = (CL + 63) / 64;
#define RS_ARGS seqs, lens, nsegs, cand, clen, ok, cons, cons_len, err, solved, B, D, L, C, \
                CL, min_depth, max_err, vec, st
    if (nw <= 1) {
        if (C == 1) return launch<1, 1>(RS_ARGS);
        if (C == 2) return launch<1, 2>(RS_ARGS);
        if (C == 3) return launch<1, 3>(RS_ARGS);
        return launch<1, 4>(RS_ARGS);
    }
    if (nw <= 2) {
        if (C == 1) return launch<2, 1>(RS_ARGS);
        return launch<2, 2>(RS_ARGS);
    }
    if (nw <= 4) return launch<4, 1>(RS_ARGS);
    if (nw <= 8) return launch<8, 1>(RS_ARGS);
#undef RS_ARGS
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* rescore_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
