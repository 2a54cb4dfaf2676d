// The core shared by the two heaviest-path DP kernels, csrc/dp_backtrack.cu
// and csrc/heaviest_path.cu: the window's adjacency read once into bits, and
// one max-plus DP step over a thread's share of the predecessors.
//
// Layout. A block serves one window; its M columns are padded to MP = S * U
// columns and MP predecessors. Thread r serves column v = r / S and the
// predecessors u in [s * U, s * U + U), s = r % S, so the S threads of a
// column are neighbouring lanes of one warp. Padded predecessors
// (u >= M) score -inf in both term buffers and never win; padded columns
// (v >= M) compute and write nothing that leaves the kernel.
//
// The adjacency holds only +0.0f (edge) and -1e30f (no edge). Each block
// reads its window's adjW once, 16 bytes a thread where the alignment allows,
// turns it into one bit per (u, v) with warp shuffles or a ballot, and keeps
// the bits in shared memory; each thread then copies its column's U bits
// into registers. Any other value traps: the bits cannot represent it, and
// a wrong answer must never come out instead.
//
// The step computes what the dense formulation computes, bit for bit: the
// term of (u, v) is cur[u] + adjW[u, v], which is cur[u] + 0.0f on a set
// bit and cur[u] + -1e30f on a clear one. Those two sums are the same IEEE
// adds for every column, so each step stores them once per u in two buffers
// (Z and N) and each cell selects one by its bit. Every u is visited, and
// the result is what a scan in ascending u with a strict '>' gives: the
// maximum and the lowest u reaching it. A thread runs K chains over
// consecutive sub-ranges (independent compare chains, for latency), merged
// in u order (a later chain wins only on a strictly larger value); then the
// S threads of a column merge their (value, u) pairs by shuffles, the
// larger value or, on equal values, the lower u. No term is -0.0f (cur +
// 0.0f is +0 for either zero; cur + -1e30f is never 0), so equal values
// carry equal bits. tests/test_torch_dp_step.py transcribes these steps in
// torch and holds them to the plain DP and the Pallas kernel.
//
// What bounds the step: per cell a bit test, a select and the compare and
// update, all on the SM's integer/logic pipe, which takes a warp
// instruction every other cycle.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define NEGF (-1e30f)

namespace dpbits {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// bank padding of the bit words: one spare word every 64, so that the
// S threads of a column, which read rows U apart, hit different banks
__host__ __device__ __forceinline__ int bpad(int q) { return q + (q >> 6); }

__host__ __device__ __forceinline__ int bits_words(int n_el)
{
    const int nw = (n_el + 31) / 32;
    return bpad(nw > 0 ? nw - 1 : 0) + 1;
}

// index of predecessor u in a term buffer: part s of U terms starts at
// s * (U + 4) floats, which keeps each part 16-byte aligned and moves the S
// parts onto different banks
template <int U>
__device__ __forceinline__ int zpad(int u) { return u + (u / U) * 4; }

__device__ __forceinline__ unsigned edge_bit(float x)
{
    const unsigned w = __float_as_uint(x);
    if (w != 0u && w != __float_as_uint(NEGF)) __trap();
    return w == 0u ? 1u : 0u;
}

// The n_el adjacency values at A (the block's window) into
// bits[bpad(g / 32)] bit g % 32, g the flat element index u * M + v; every
// thread of the block calls it (blockDim.x a multiple of 32).
__device__ __forceinline__ void load_bits(const float* __restrict__ A, int n_el,
                                          unsigned* __restrict__ bits)
{
    const int lane = threadIdx.x & 31;
    const bool vec = (n_el & 3) == 0 && (reinterpret_cast<uintptr_t>(A) & 15) == 0;
    if (vec) {
        // lane l holds elements 4i..4i+3 (i % 32 == l): a nibble; the eight
        // nibbles of lanes 8q..8q+7 make word i / 8
        const int n4 = n_el >> 2;
        const int end = (n4 + 31) & ~31;
        const float4* A4 = reinterpret_cast<const float4*>(A);
#pragma unroll 4
        for (int i = threadIdx.x; i < end; i += blockDim.x) {
            unsigned nib = 0;
            if (i < n4) {
                const float4 x = __ldg(A4 + i);
                nib = edge_bit(x.x) | (edge_bit(x.y) << 1) | (edge_bit(x.z) << 2)
                    | (edge_bit(x.w) << 3);
            }
            unsigned w = nib << (4 * (lane & 7));
            w |= __shfl_xor_sync(FULL, w, 1);
            w |= __shfl_xor_sync(FULL, w, 2);
            w |= __shfl_xor_sync(FULL, w, 4);
            if ((lane & 7) == 0 && i < n4) bits[bpad(i >> 3)] = w;
        }
    } else {
        const int end = (n_el + 31) & ~31;
        for (int i = threadIdx.x; i < end; i += blockDim.x) {
            const unsigned bit = i < n_el ? edge_bit(A[i]) : 0u;
            const unsigned w = __ballot_sync(FULL, bit);
            if (lane == 0) bits[bpad(i >> 5)] = w;
        }
    }
}

// Column v's bits for predecessors u0 .. u0 + U - 1, bit j of col[j / 32]
// for u0 + j; 0 past M.
template <int U>
__device__ __forceinline__ void column_bits(const unsigned* __restrict__ bits,
                                            int M, int u0, int v,
                                            unsigned (&col)[U / 32])
{
#pragma unroll
    for (int j = 0; j < U / 32; ++j) col[j] = 0;
    if (v >= M) return;
#pragma unroll
    for (int j = 0; j < U; ++j) {
        const int u = u0 + j;
        if (u < M) {
            const int g = u * M + v;
            col[j >> 5] |= ((bits[bpad(g >> 5)] >> (g & 31)) & 1u) << (j & 31);
        }
    }
}

// One DP step of column v, over this thread's predecessors: the best term
// and its u, merged over the column's S threads (every one of them ends
// with the column's result). zc, nc: this step's Z and N buffers.
//
// Each chain walks its predecessors four at a time: the group's maximum
// (fmaxf, exact: no term is NaN or -0.0f) against the chain's best with a
// strict '>', so a chain keeps the first group that reaches its maximum.
// Only the thread's winning group is then walked term by term, for the
// first u in it whose term equals the maximum. That is the first u of the
// whole range reaching it, what a strict '>' over every u finds, for about
// two thirds of the compare-and-select work a cell.
template <int S, int U, int K>
__device__ __forceinline__ void dp_step(const float* __restrict__ zc,
                                        const float* __restrict__ nc,
                                        const unsigned (&col)[U / 32], int s,
                                        float& best, int& bu)
{
    constexpr int G = 4;                     // terms a group
    constexpr int L = U / K;                 // one chain's predecessors
    static_assert(L % G == 0 && G % 4 == 0, "groups are read 4 terms at a time");
    const float* zs = zc + s * (U + 4);
    const float* ns = nc + s * (U + 4);
    float bv[K];
    int bg[K];                               // first u of the chain's best group
#pragma unroll
    for (int i = 0; i < L; i += G) {
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
            float m;
#pragma unroll
            for (int q = 0; q < G; q += 4) {
                const int u = kk * L + i + q;
                const float4 z = *reinterpret_cast<const float4*>(zs + u);
                const float4 n = *reinterpret_cast<const float4*>(ns + u);
                const unsigned w = col[u >> 5] >> (u & 31);
                const float m4 = fmaxf(fmaxf((w & 1u) ? z.x : n.x, (w & 2u) ? z.y : n.y),
                                       fmaxf((w & 4u) ? z.z : n.z, (w & 8u) ? z.w : n.w));
                m = q == 0 ? m4 : fmaxf(m, m4);
            }
            if (i == 0) {
                bv[kk] = m;
                bg[kk] = kk * L;
            } else if (m > bv[kk]) {         // strict: the first group reaching the max
                bv[kk] = m;
                bg[kk] = kk * L + i;
            }
        }
    }
#pragma unroll
    for (int kk = 1; kk < K; ++kk) {
        if (bv[kk] > bv[0]) {
            bv[0] = bv[kk];
            bg[0] = bg[kk];
        }
    }
    // the first u of the winning group whose term is the maximum
    const int g = bg[0];
    best = bv[0];
    int bi = g + G - 1;
#pragma unroll
    for (int q = G - 4; q >= 0; q -= 4) {
        unsigned w = col[0];
#pragma unroll
        for (int j = 1; j < U / 32; ++j) w = ((g + q) >> 5) == j ? col[j] : w;
        w >>= (g + q) & 31;
        const float4 z = *reinterpret_cast<const float4*>(zs + g + q);
        const float4 n = *reinterpret_cast<const float4*>(ns + g + q);
        if (((w & 8u) ? z.w : n.w) == best) bi = g + q + 3;
        if (((w & 4u) ? z.z : n.z) == best) bi = g + q + 2;
        if (((w & 2u) ? z.y : n.y) == best) bi = g + q + 1;
        if (((w & 1u) ? z.x : n.x) == best) bi = g + q;
    }
    bu = s * U + bi;
#pragma unroll
    for (int off = 1; off < S; off <<= 1) {
        const float ob = __shfl_xor_sync(FULL, best, off);
        const int ou = __shfl_xor_sync(FULL, bu, off);
        if (ob > best || (ob == best && ou < bu)) {
            best = ob;
            bu = ou;
        }
    }
}

}  // namespace dpbits
