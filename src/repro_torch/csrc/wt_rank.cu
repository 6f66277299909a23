// Batched rank1 over a bit-packed vector (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `wt_rank_pallas`
// (src/repro/kernels/wt_rank/kernel.py, body `_rank_kernel`): for each
// query position q, the number of ones in bits [0, q) of the u32 words,
// as the superblock prefix super_cum[q / 512] plus the popcounts of the
// 16 words of that superblock under a mask: all ones for the whole words
// before word q / 32, (1 << q % 32) - 1 at that word, 0 after it.
//
// What bounds it on an H100: each query reads one count and at most its
// superblock's 64 bytes and writes one int.  Over a random batch the reads
// scatter over the whole bitvector, so the cost is where those reads are
// served from, not arithmetic.  Two routes:
//
// * resident (the bitvector and a rank a 4-word chunk fit a block's
//   shared memory, <= ~227 KB: up to ~1.48 M bits; level 0 of a 1M-id
//   wavelet tree takes 153 KB), for batches of RESIDENT_MIN_QUERIES or
//   more: one block of 1024 threads an SM takes the bitvector by one bulk
//   copy (`cp.async.bulk`) and pads it with zeros to a whole superblock
//   past the end, then turns each superblock's count and popcounts into
//   the rank at the start of each of its four 4-word chunks, and walks the
//   queries grid-stride, 8 a thread at a time so the query loads overlap.
//   A rank is one 16-byte shared load, one shared count and 4 masked
//   `__popc`s, with no branch: a quarter of the shared-memory reads and
//   of the popcounts of the 64-byte superblock read;
// * global, for any size: one thread a query, 256 to a block; the
//   superblock comes as four unconditional 16-byte loads (two 32-byte
//   sectors) through the read-only cache, the same 16 masked popcounts.
//   Vector loads only where the whole superblock lies inside `words` and
//   `words` is 16-byte aligned; otherwise (an unpadded tail, a view at a
//   4-byte offset) each word the mask keeps is a scalar load, as in the
//   first kernel.
//
// `__popc` (one instruction) takes the place of the TPU's SWAR bit-slide,
// which the TPU needed because its vector unit has no popcount.  The
// launch picks the route by size (`wt_rank_route`).
//
// Words arrive as int32 bit patterns and are read as u32.  A query
// outside [0, 32 W], or whose superblock is past the end of super_cum,
// gives -1.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;          // global route
constexpr int RES_THREADS = 1024;     // resident route: one block an SM
constexpr int RES_UNROLL = 8;         // queries a thread in flight
constexpr int WPS = 16;               // words a superblock
constexpr int SMEM_LIMIT = 232448;    // a block's shared memory on sm_90
// below this batch the global route wins: loading the bitvector into
// every SM costs more than the queries' own reads.  Over 1,050,000 bits
// on an H100 80GB HBM3 at 700 W the routes tie at 2^19 queries (0.0105
// ms global, 0.0104 resident); global leads at 3 * 2^17, resident at
// 5 * 2^17 (tools/ab_kernels.py, which builds a copy of this file for
// each route by patching this constant)
constexpr int RESIDENT_MIN_QUERIES = 1 << 19;

enum Route { GLOBAL = 0, RESIDENT = 1 };

__device__ __forceinline__ bool in_range(int q, int n_words, int n_super) {
  return q >= 0 && (long long)q <= 32LL * n_words && (q >> 9) < n_super;
}

// the mask of word j for a rank at word wl: all ones before it, the
// partial mask (1 << b) - 1 at it, none after it
__device__ __forceinline__ uint32_t mask_of(int j, int wl, uint32_t partial) {
  return j < wl ? 0xffffffffu : (j == wl ? partial : 0u);
}

__device__ __forceinline__ int masked_popc(const uint4 (&v)[4], int q) {
  const int wl = (q >> 5) & (WPS - 1);
  const uint32_t partial = (1u << (q & 31)) - 1u;
  int acc = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    acc += __popc(v[k].x & mask_of(4 * k, wl, partial));
    acc += __popc(v[k].y & mask_of(4 * k + 1, wl, partial));
    acc += __popc(v[k].z & mask_of(4 * k + 2, wl, partial));
    acc += __popc(v[k].w & mask_of(4 * k + 3, wl, partial));
  }
  return acc;
}

__global__ void __launch_bounds__(THREADS)
wt_rank_global(const uint32_t* __restrict__ words,
               const int* __restrict__ super_cum,
               const int* __restrict__ queries, int* __restrict__ out, int nq,
               int n_words, int n_super, bool vec) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= nq) return;
  const int q = queries[i];
  if (!in_range(q, n_words, n_super)) {
    out[i] = -1;
    return;
  }
  const int sb = q >> 9;
  int acc = __ldg(super_cum + sb);
  if (vec && (sb + 1) * WPS <= n_words) {
    const uint4* p = reinterpret_cast<const uint4*>(words) + sb * 4;
    const uint4 v[4] = {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
    acc += masked_popc(v, q);
  } else {
    const int wl = (q >> 5) & (WPS - 1);
    const uint32_t partial = (1u << (q & 31)) - 1u;
    for (int j = 0; j <= wl; ++j) {
      const uint32_t m = mask_of(j, wl, partial);
      if (m) acc += __popc(__ldg(words + sb * WPS + j) & m);
    }
  }
  out[i] = acc;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(RES_THREADS, 1)
wt_rank_resident(const uint32_t* __restrict__ words,
                 const int* __restrict__ super_cum,
                 const int* __restrict__ queries, int* __restrict__ out,
                 int nq, int n_words, int n_super, int n_pad, int run) {
  extern __shared__ __align__(16) uint4 smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint4* sv = smem + 1;                                  // the bitvector
  uint32_t* sw = reinterpret_cast<uint32_t*>(sv);      // n_pad words
  int* chunk_rank = reinterpret_cast<int*>(sw + n_pad);  // n_pad / 4
  const int tid = threadIdx.x;

  // the words [0, run) (a 16-byte multiple from a 16-byte-aligned `words`)
  // by one bulk copy, while the threads load the rest and pad with zeros
  // to n_pad (a whole superblock past the last query's)
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(4 * run)
        : "memory");
    if (run)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(sw)),
          "l"(words), "r"(4 * run), "r"(smem_u32(bar))
          : "memory");
  }
  for (int k = run + tid; k < n_pad; k += RES_THREADS)
    sw[k] = k < n_words ? __ldg(words + k) : 0u;
  __syncthreads();  // the mbarrier's init and the plain stores
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar))
      : "memory");

  // the rank at the start of each 4-word chunk: its superblock's count
  // plus the ones of the superblock's chunks before it, so a query reads
  // one count and one 16-byte chunk
  for (int sb = tid; sb < n_pad / WPS; sb += RES_THREADS) {
    int acc = sb < n_super ? __ldg(super_cum + sb) : 0;
    int c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 v = sv[4 * sb + k];
      c[k] = acc;
      acc += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    reinterpret_cast<int4*>(chunk_rank)[sb] =
        make_int4(c[0], c[1], c[2], c[3]);
  }
  __syncthreads();

  const int stride = gridDim.x * RES_THREADS;
  for (int i0 = blockIdx.x * RES_THREADS + tid; i0 < nq;
       i0 += stride * RES_UNROLL) {
    int q[RES_UNROLL];
#pragma unroll
    for (int u = 0; u < RES_UNROLL; ++u)
      q[u] = i0 + u * stride < nq ? queries[i0 + u * stride] : 0;
#pragma unroll
    for (int u = 0; u < RES_UNROLL; ++u) {
      const bool ok = in_range(q[u], n_words, n_super);
      const int qq = ok ? q[u] : 0;
      const int wl = (qq >> 5) & 3;
      const uint32_t partial = (1u << (qq & 31)) - 1u;
      const uint4 v = sv[qq >> 7];
      const int acc = chunk_rank[qq >> 7] +
                      __popc(v.x & mask_of(0, wl, partial)) +
                      __popc(v.y & mask_of(1, wl, partial)) +
                      __popc(v.z & mask_of(2, wl, partial)) +
                      __popc(v.w & mask_of(3, wl, partial));
      if (i0 + u * stride < nq) out[i0 + u * stride] = ok ? acc : -1;
    }
  }
}

// shared memory of the resident route (the mbarrier, the padded words and
// a rank a 4-word chunk), or 0 where it does not fit
size_t resident_bytes(int n_words, int n_super) {
  if (n_words <= 0 || n_super <= 0) return 0;
  const size_t n_pad = ((size_t)n_words / WPS + 1) * WPS;
  const size_t bytes = 16 + 4 * n_pad + n_pad;
  return bytes <= SMEM_LIMIT ? bytes : 0;
}

int launch_resident(const void* words, const void* super_cum,
                    const void* queries, void* out, int nq, int n_words,
                    int n_super, cudaStream_t stream) {
  const size_t smem = resident_bytes(n_words, n_super);
  if (!smem) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wt_rank_resident,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the bulk copy's run: none from a view off a 16-byte boundary (its
  // words could not land 16-byte aligned in shared memory)
  const int run = ((uintptr_t)words & 15) ? 0 : n_words & ~3;
  const int n_pad = (int)((smem - 16) / 5);
  const int grid = std::min(sms, (nq + RES_THREADS - 1) / RES_THREADS);
  wt_rank_resident<<<grid, RES_THREADS, smem, stream>>>(
      (const uint32_t*)words, (const int*)super_cum, (const int*)queries,
      (int*)out, nq, n_words, n_super, n_pad, run);
  return (int)cudaGetLastError();
}

}  // namespace

// the route a launch takes: 1 resident (the bitvector fits a block's
// shared memory and the batch pays for loading it), else 0 global
extern "C" int wt_rank_route(int n_words, int n_super, int nq) {
  return resident_bytes(n_words, n_super) && nq >= RESIDENT_MIN_QUERIES
             ? RESIDENT
             : GLOBAL;
}

extern "C" int wt_rank_launch(const void* words, const void* super_cum,
                              const void* queries, void* out, int nq,
                              int n_words, int n_super, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nq <= 0) return (int)cudaSuccess;
  if (wt_rank_route(n_words, n_super, nq) == RESIDENT)
    return launch_resident(words, super_cum, queries, out, nq, n_words,
                           n_super, s);
  const bool vec = !((uintptr_t)words & 15);
  wt_rank_global<<<(nq + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      (const uint32_t*)words, (const int*)super_cum, (const int*)queries,
      (int*)out, nq, n_words, n_super, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
