// The SIMT f32 tile loop shared by l2_dist.cu and l2_top1.cu (sm_90a).
//
// A block of 256 threads owns BM = 64 rows of q and walks BN = 128-wide
// tiles of a second row set a (arena rows or centroids), staging the depth
// d through shared memory in BK = 32-deep chunks.  Each thread keeps an
// 8 x 4 register tile of dot products: rows ty * 8 + i (ty = warp) and
// columns tx + 32 * j (tx = lane), so shared reads and the callers' output
// stores are conflict-free and coalesced.  Ragged rows and depth are
// zero-filled in the loads, which preserves dot products and norms.
//
// Only fmaf: no TF32 and no tensor cores, because both callers are held
// to the scan's f32 contraction band (`rescore_eps`), which TF32 inputs
// alone exceed.  The callers differ only in their epilogues.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace l2tile {

constexpr int BM = 64;        // q rows per block
constexpr int BN = 128;       // a rows per tile
constexpr int BK = 32;        // depth staged per step
constexpr int TM = 8;         // q rows per thread
constexpr int TN = 4;         // a rows per thread, strided by 32
constexpr int THREADS = 256;  // (BM / TM) * 32

struct Stage {
  float qs[BK][BM + 1];
  float as[BK][BN + 1];
};

// squared norm of a d-vector by one warp (lane-strided, shuffle reduce)
__device__ __forceinline__ float warp_norm(const float* row, int d, int lane) {
  float s = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float v = row[c];
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// out[r] = ||x[row0 + r]||^2 for r < count, one warp per row; rows at or
// past n give 0.
__device__ __forceinline__ void row_norms(const float* __restrict__ x, int n,
                                          int d, int row0, int count,
                                          float* out) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < count; r += THREADS / 32) {
    const float s =
        row0 + r < n ? warp_norm(x + (size_t)(row0 + r) * d, d, lane) : 0.f;
    if (lane == 0) out[r] = s;
  }
}

// acc[i][j] = q[q0 + ty * TM + i] . a[n0 + tx + 32 * j] over all of d.
// Starts and ends with the block in step (a __syncthreads after the last
// chunk), so the caller may reuse shared memory right after.
__device__ __forceinline__ void tile_dots(const float* __restrict__ q,
                                          const float* __restrict__ a, int nq,
                                          int n, int d, int q0, int n0,
                                          Stage& st, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gi = q0 + r, gc = k0 + c;
      st.qs[c][r] = (gi < nq && gc < d) ? q[(size_t)gi * d + gc] : 0.f;
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gj = n0 + r, gc = k0 + c;
      st.as[c][r] = (gj < n && gc < d) ? a[(size_t)gj * d + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      float qv[TM], av[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) qv[i] = st.qs[c][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) av[j] = st.as[c][tx + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(qv[i], av[j], acc[i][j]);
    }
    __syncthreads();
  }
}

}  // namespace l2tile
