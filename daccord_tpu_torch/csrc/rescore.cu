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
// Design: one block a window, min(C, RS_WARPS) warps, warp w taking
// candidates w, w + RS_WARPS, ..., the segments across the warp's lanes
// (lane l takes segments l, l + 32, ...). The window's tile, lengths and
// candidates are copied into shared memory once; each lane builds its
// candidate's four match masks in registers, runs its segments, and the warp
// sums its lanes' distances with shuffles. Thread 0 then takes the argmin and
// the accept test, and the block writes the row. The block is at most
// RS_WARPS * 32 threads (__launch_bounds__), so the eight-word form's
// registers (~160 a thread) fit the register file at any C.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define PAD_BASE 4
#define RS_WARPS 8

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__device__ __forceinline__ uint64_t low_ones(int k)
{
    return k <= 0 ? 0ull : (k >= 64 ? ~0ull : ((1ull << k) - 1ull));
}

template <int NW>
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
    int D, int L, int C, int CL, int min_depth, float max_err)
{
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* seg_s = reinterpret_cast<int8_t*>(smem);                      // [D * L]
    int8_t* cand_s = reinterpret_cast<int8_t*>(smem + align16(D * L));    // [C * CL]
    int32_t* len_s = reinterpret_cast<int32_t*>(
        smem + align16(D * L) + align16(C * CL));                         // [D]
    float* err_s = reinterpret_cast<float*>(len_s + D);                   // [C]
    int32_t* pick = reinterpret_cast<int32_t*>(err_s + C);                // [2]

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    for (int i = tid; i < D * L; i += blockDim.x) seg_s[i] = seqs[(size_t)b * D * L + i];
    for (int i = tid; i < C * CL; i += blockDim.x) cand_s[i] = cand[(size_t)b * C * CL + i];
    for (int i = tid; i < D; i += blockDim.x) len_s[i] = lens[(size_t)b * D + i];
    __syncthreads();

    const int lane = tid & 31;
    for (int c = tid >> 5; c < C; c += blockDim.x >> 5) {
        const int n = clen[(size_t)b * C + c];
        const int8_t* cc = cand_s + c * CL;

        // match masks of the candidate's first n bases, one per base value
        uint64_t pa[NW], pc[NW], pg[NW], pt[NW], vp0[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
            uint64_t a = 0, cm = 0, g = 0, t = 0;
            for (int j = 0; j < 64; ++j) {
                const int i = w * 64 + j;
                if (i < n && i < CL) {
                    const int x = cc[i];
                    const uint64_t bit = 1ull << j;
                    a |= x == 0 ? bit : 0ull;
                    cm |= x == 1 ? bit : 0ull;
                    g |= x == 2 ? bit : 0ull;
                    t |= x == 3 ? bit : 0ull;
                }
            }
            pa[w] = a;
            pc[w] = cm;
            pg[w] = g;
            pt[w] = t;
            vp0[w] = low_ones(n - 64 * w);
        }
        const int hw = (n - 1) >> 6;           // word and bit of the last row
        const int hbit = (n - 1) & 63;

        int sum = 0;
        for (int d = lane; d < D; d += 32) {
            const int m = len_s[d];
            if (m <= 0) continue;
            if (n == 0) {
                sum += m;
                continue;
            }
            const int8_t* sg = seg_s + d * L;
            uint64_t vp[NW], vn[NW];
#pragma unroll
            for (int w = 0; w < NW; ++w) {
                vp[w] = vp0[w];
                vn[w] = 0;
            }
            int score = n;
            for (int i = 0; i < m; ++i) {
                const int x = sg[i];
                uint64_t carry = 0, hp_in = 1ull, hn_in = 0;
                int up = 0, dn = 0;
#pragma unroll
                for (int w = 0; w < NW; ++w) {
                    const uint64_t e = x == 0 ? pa[w] : x == 1 ? pc[w] : x == 2 ? pg[w]
                                     : x == 3 ? pt[w] : 0ull;
                    const uint64_t X = e | vn[w];
                    const uint64_t A = X & vp[w];
                    const uint64_t t1 = vp[w] + A;
                    const uint64_t s = t1 + carry;
                    carry = (uint64_t)((t1 < vp[w]) | (s < t1));
                    const uint64_t d0 = (s ^ vp[w]) | X;
                    const uint64_t hn = vp[w] & d0;
                    const uint64_t hp = vn[w] | ~(vp[w] | d0);
                    if (w == hw) {
                        up = (int)((hp >> hbit) & 1ull);
                        dn = (int)((hn >> hbit) & 1ull);
                    }
                    const uint64_t x2 = (hp << 1) | hp_in;
                    const uint64_t h2 = (hn << 1) | hn_in;
                    hp_in = hp >> 63;
                    hn_in = hn >> 63;
                    vn[w] = x2 & d0;
                    vp[w] = h2 | ~(x2 | d0);
                }
                score += up - dn;
            }
            sum += score;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
            int total = 0;
            for (int d = 0; d < D; ++d) total += len_s[d];
            total = total < 1 ? 1 : total;
            err_s[c] = ok[(size_t)b * C + c]
                     ? __fdiv_rn(__int2float_rn(sum), __int2float_rn(total)) : INFINITY;
        }
    }
    __syncthreads();
    if (tid == 0) {
        int ci = 0;
        float be = err_s[0];
        int any = 0;
        for (int k = 0; k < C; ++k) {
            if (k > 0 && err_s[k] < be) {
                be = err_s[k];
                ci = k;
            }
            any |= ok[(size_t)b * C + k] ? 1 : 0;
        }
        const int sv = any && be <= max_err && nsegs[b] >= min_depth;
        const int bl = ok[(size_t)b * C + ci] ? clen[(size_t)b * C + ci] : 0;
        cons_len[b] = sv ? bl : 0;
        err[b] = any ? be : INFINITY;
        solved[b] = (uint8_t)sv;
        pick[0] = ci;
        pick[1] = sv;
    }
    __syncthreads();
    const int ci = pick[0];
    const int sv = pick[1];
    for (int j = tid; j < CL; j += blockDim.x)
        cons[(size_t)b * CL + j] = sv ? cand_s[ci * CL + j] : (int8_t)PAD_BASE;
}

template <int NW>
static int launch(const void* seqs, const void* lens, const void* nsegs, const void* cand,
                  const void* clen, const void* ok, void* cons, void* cons_len, void* err,
                  void* solved, int B, int D, int L, int C, int CL, int min_depth,
                  float max_err, cudaStream_t stream)
{
    const size_t smem = align16(D * L) + align16(C * CL) + 4 * (size_t)D + 4 * (size_t)C + 8;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            rescore_kernel<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    rescore_kernel<NW><<<B, 32 * (C < RS_WARPS ? C : RS_WARPS), smem, stream>>>(
        (const int8_t*)seqs, (const int32_t*)lens, (const int32_t*)nsegs,
        (const int8_t*)cand, (const int32_t*)clen, (const uint8_t*)ok, (int8_t*)cons,
        (int32_t*)cons_len, (float*)err, (uint8_t*)solved, D, L, C, CL, min_depth,
        max_err);
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
    const int nw = (CL + 63) / 64;
    if (nw <= 1)
        return launch<1>(seqs, lens, nsegs, cand, clen, ok, cons, cons_len, err, solved,
                         B, D, L, C, CL, min_depth, max_err, st);
    if (nw <= 2)
        return launch<2>(seqs, lens, nsegs, cand, clen, ok, cons, cons_len, err, solved,
                         B, D, L, C, CL, min_depth, max_err, st);
    if (nw <= 4)
        return launch<4>(seqs, lens, nsegs, cand, clen, ok, cons, cons_len, err, solved,
                         B, D, L, C, CL, min_depth, max_err, st);
    if (nw <= 8)
        return launch<8>(seqs, lens, nsegs, cand, clen, ok, cons, cons_len, err, solved,
                         B, D, L, C, CL, min_depth, max_err, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* rescore_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
