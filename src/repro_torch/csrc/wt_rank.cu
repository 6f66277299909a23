// Batched rank1 over a bit-packed vector (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `wt_rank_pallas`
// (src/repro/kernels/wt_rank/kernel.py, body `_rank_kernel`): for each
// query position q, the number of ones in bits [0, q) of the u32 words,
// as the superblock prefix super_cum[q / 512] plus the popcounts of the
// whole words between that superblock's start and word q / 32, plus the
// masked popcount of the partial word.
//
// What bounds it on an H100: each query reads one superblock count and
// at most 16 words and writes one int; over a random batch the words are
// scattered, so it is bound by memory latency and the 32-byte sectors it
// touches rather than by arithmetic.  The design keeps that to the
// minimum the layout allows:
//
// * one thread per query, 256 to a block, so a batch of 2^20 queries
//   fills the card many times over and latency hides behind occupancy;
// * `__popc` (one instruction) in place of the TPU's SWAR bit-slide,
//   which the TPU needed because its vector unit has no popcount;
// * only the words the answer needs are loaded (at most 15 whole words
//   and the partial word, whose load is skipped when q is word-aligned),
//   through the read-only cache, where the TPU kernel gathered all 16
//   under a mask.
//
// Words arrive as int32 bit patterns and are read as u32.  A query
// outside [0, 32 W], or whose superblock is past the end of super_cum,
// gives -1 and reads nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
wt_rank_kernel(const uint32_t* __restrict__ words,
               const int* __restrict__ super_cum,
               const int* __restrict__ queries, int* __restrict__ out, int nq,
               int n_words, int n_super) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= nq) return;
  const int q = queries[i];
  if (q < 0 || (long long)q > 32LL * n_words || (q >> 9) >= n_super) {
    out[i] = -1;
    return;
  }
  const int w = q >> 5;
  const int b = q & 31;
  int acc = __ldg(super_cum + (q >> 9));
  for (int j = w & ~15; j < w; ++j) acc += __popc(__ldg(words + j));
  if (b) acc += __popc(__ldg(words + w) & ((1u << b) - 1u));
  out[i] = acc;
}

}  // namespace

extern "C" int wt_rank_launch(const void* words, const void* super_cum,
                              const void* queries, void* out, int nq,
                              int n_words, int n_super, void* stream) {
  const int grid = (nq + THREADS - 1) / THREADS;
  wt_rank_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (const int*)super_cum, (const int*)queries,
      (int*)out, nq, n_words, n_super);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
