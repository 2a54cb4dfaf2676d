// Paged-pool page gather, hand-written for Hopper (sm_90a).
//
// Replaces daccord_tpu/kernels/pallas_window.py:gather_pages (the Pallas TPU
// kernel: one HBM->VMEM row DMA per page-table slot) and computes exactly
// what it computes: out[b, p, :] = pool[table[b, p], :], pool [N, PL] int8,
// table [B, PPW] int32, out [B, PPW, PL] int8. The index math that turns
// the gathered pages into the dense [B, D, L] tile stays outside, in torch
// (kernels/paging.py gather_windows), as it stays in XLA in the JAX package.
//
// What bounds it on this card: bytes. It reads the table (4 B a slot) and
// one page a slot, and writes one page a slot; there is no arithmetic
// (chip_smoke.py computes the bound over the HBM rate).
//
// What the design does about it: one thread per (window, slot), so the
// table reads of neighbouring threads are coalesced and every page is one
// vector load and one vector store of ``width`` bytes at a time (16 at the
// default page of 16 bases when the pool and the output are 16-byte
// aligned; the wrapper picks the widest width that divides the page and
// both addresses). A page index outside [0, N) traps: the kernel never reads
// past the pool and never clamps. The wrapper's caller checks the table on
// the host before the upload, so the trap only fires on misuse.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename V>
__device__ __forceinline__ void copy_page(const int8_t* __restrict__ src,
                                          int8_t* __restrict__ dst, int PL)
{
    const V* s = reinterpret_cast<const V*>(src);
    V* d = reinterpret_cast<V*>(dst);
    const int n = PL / (int)sizeof(V);
    for (int j = 0; j < n; ++j) d[j] = s[j];
}

__global__ void gather_pages_kernel(
    const int8_t* __restrict__ pool,    // [N, PL]
    const int32_t* __restrict__ table,  // [B * PPW]
    int8_t* __restrict__ out,           // [B * PPW, PL]
    long long n_slots, int N, int PL, int width)
{
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_slots) return;
    const int page = table[i];
    if (page < 0 || page >= N) __trap();
    const int8_t* src = pool + (size_t)page * PL;
    int8_t* dst = out + (size_t)i * PL;
    switch (width) {
    case 16: copy_page<int4>(src, dst, PL); break;
    case 8: copy_page<int2>(src, dst, PL); break;
    case 4: copy_page<int32_t>(src, dst, PL); break;
    case 2: copy_page<int16_t>(src, dst, PL); break;
    default: copy_page<int8_t>(src, dst, PL); break;
    }
}

extern "C" int gather_pages_launch(
    const void* pool, const void* table, void* out,
    int B, int PPW, int N, int PL, int width, void* stream)
{
    const long long n_slots = (long long)B * PPW;
    if (n_slots == 0) return 0;
    const int threads = 256;
    const long long blocks = (n_slots + threads - 1) / threads;
    gather_pages_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)pool, (const int32_t*)table, (int8_t*)out, n_slots, N,
        PL, width);
    return (int)cudaGetLastError();
}

extern "C" const char* gather_pages_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
