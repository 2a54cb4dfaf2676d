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
//
// What bounds it on this card: the DP is a serial chain of P-1 dependent
// steps per window, each M*M f32 add+compare pairs, and the adjacency row of
// every step comes from device memory (through L1/L2: the same M*M matrix is
// read P-1 times). Counted once, the inputs are ~B*M*M*4 bytes and the work
// B*(P-1)*M*M*2 f32 operations (chip_smoke.py computes the bound from them);
// the kernel is latency-bound well above that bound, on the serial DP chain
// and on the single-thread backtrack.
//
// What the design does about it: one block per window and one thread per
// DP column v, so the P-1 steps run M columns wide with only a block barrier
// between steps; the score vector, the pointer stack (uint16) and the
// admissible-row scores stay in shared memory and never touch device memory,
// so only the candidates leave the kernel. Reads of adjW[u, v] are coalesced
// across the threads of a block. Loading the adjacency as a bitmask and
// packing several windows per block are the known next steps.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEGF (-1e30f)
#define PAD_BASE 4

__global__ void dp_backtrack_kernel(
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
    extern __shared__ __align__(16) unsigned char smem[];
    const int T = t_hi - t_lo + 1;
    float* s_a = reinterpret_cast<float*>(smem);      // [M] scores, step t-1
    float* s_b = s_a + M;                              // [M] scores, step t
    float* end_sc = s_b + M;                           // [T, M] rows t_lo..t_hi
    float* red_val = end_sc + T * M;                   // [M]
    int32_t* red_idx = reinterpret_cast<int32_t*>(red_val + M);   // [M]
    int32_t* sel_s = red_idx + M;                      // [M]
    int32_t* kpath = sel_s + M;                        // [P]
    int32_t* sh_tb = kpath + P;                        // [1]
    uint16_t* ptrs = reinterpret_cast<uint16_t*>(sh_tb + 1);      // [P, M]
    uint8_t* chosen = reinterpret_cast<uint8_t*>(ptrs + P * M);   // [M]

    const int b = blockIdx.x;
    const int v = threadIdx.x;
    const float* A = adjW + (size_t)b * M * M;
    const float* w = wt + (size_t)b * P * M;

    // ---- heaviest-path max-plus DP ---------------------------------------
    const float start = s0[(size_t)b * M + v];
    s_a[v] = start;
    ptrs[v] = 0;
    if (t_lo == 0) end_sc[v] = start;
    sel_s[v] = sel[(size_t)b * M + v];
    chosen[v] = 0;
    const bool snk_v = snk[(size_t)b * M + v] != 0;
    __syncthreads();

    float* cur = s_a;
    float* nxt = s_b;
    for (int t = 1; t < P; ++t) {
        float best = cur[0] + A[v];
        int bu = 0;
        for (int u = 1; u < M; ++u) {
            const float c = cur[u] + A[(size_t)u * M + v];
            if (c > best) {          // strict: the first u reaching the max
                best = c;
                bu = u;
            }
        }
        const float sn = (best > NEGF * 0.5f) ? best + w[(size_t)t * M + v] : NEGF;
        nxt[v] = sn;
        ptrs[t * M + v] = (uint16_t)bu;
        if (t >= t_lo && t <= t_hi) end_sc[(t - t_lo) * M + v] = sn;
        __syncthreads();
        float* tmp = cur;
        cur = nxt;
        nxt = tmp;
    }

    // ---- C end states with distinct final k-mers, then backtrack ---------
    for (int c = 0; c < C; ++c) {
        // column scan in t order: the lowest flat index among this column's
        // maxima; rows outside [t_lo, t_hi] read as NEG
        const bool live = snk_v && !chosen[v];
        float bv = (live && t_lo == 0) ? end_sc[v] : NEGF;
        int bi = v;
        for (int t = 1; t < P; ++t) {
            const float val = (live && t >= t_lo && t <= t_hi)
                                  ? end_sc[(t - t_lo) * M + v] : NEGF;
            if (val > bv) {
                bv = val;
                bi = t * M + v;
            }
        }
        red_val[v] = bv;
        red_idx[v] = bi;
        __syncthreads();
        if (v == 0) {
            float mx = red_val[0];
            int idx = red_idx[0];
            for (int i = 1; i < M; ++i) {
                const float x = red_val[i];
                const int ix = red_idx[i];
                if (x > mx || (x == mx && ix < idx)) {
                    mx = x;
                    idx = ix;
                }
            }
            const int tb = idx / M;
            const int vb = idx % M;
            chosen[vb] = 1;
            int node = 0;
            for (int i = 0; i < P; ++i) {
                const int t = P - 1 - i;
                int forced = (t == tb) ? vb : node;
                forced = forced < 0 ? 0 : (forced > M - 1 ? M - 1 : forced);
                kpath[t] = sel_s[forced];
                const int pv = ptrs[t * M + forced];
                node = (t <= tb && t > 0) ? pv : forced;
            }
            sh_tb[0] = tb;
            clen[(size_t)b * C + c] = tb + k;
            ok[(size_t)b * C + c] = (mx > NEGF * 0.5f) ? 1 : 0;
        }
        __syncthreads();
        const int tb = sh_tb[0];
        const unsigned first = (unsigned)kpath[0];
        for (int j = v; j < CL; j += blockDim.x) {
            int sh = 2 * (k - 1 - j);
            sh = sh < 0 ? 0 : (sh > 30 ? 30 : sh);
            const int head = (int)((first >> sh) & 3u);
            int tt = j - k + 1;
            tt = tt < 0 ? 0 : (tt > P - 1 ? P - 1 : tt);
            const int tail = kpath[tt] & 3;
            const int base = j < k ? head : tail;
            cand[((size_t)b * C + c) * CL + j] = (j < tb + k) ? base : PAD_BASE;
        }
        __syncthreads();
    }
}

static size_t smem_bytes(int M, int P, int t_lo, int t_hi)
{
    const size_t T = (size_t)(t_hi - t_lo + 1);
    const size_t n4 = 5 * (size_t)M + T * M + P + 1;
    return 4 * n4 + 2 * (size_t)P * M + M;
}

extern "C" int dp_backtrack_launch(
    const void* adjW, const void* wt, const void* s0, const void* snk,
    const void* sel, void* cand, void* clen, void* ok,
    int B, int M, int P, int C, int CL, int k, int t_lo, int t_hi,
    void* stream)
{
    if (B == 0) return 0;
    const size_t smem = smem_bytes(M, P, t_lo, t_hi);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dp_backtrack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dp_backtrack_kernel<<<B, M, smem, (cudaStream_t)stream>>>(
        (const float*)adjW, (const float*)wt, (const float*)s0,
        (const uint8_t*)snk, (const int32_t*)sel, (int32_t*)cand,
        (int32_t*)clen, (uint8_t*)ok, M, P, C, CL, k, t_lo, t_hi);
    return (int)cudaGetLastError();
}

extern "C" const char* dp_backtrack_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
