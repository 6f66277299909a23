// Squared-L2 distance block for the IVF arena scan (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `l2_dist_pallas`
// (src/repro/kernels/l2_topk/kernel.py, body `_l2_dist_kernel`): for a
// query block q (nq, d) and a candidate arena a (n, d), all f32 and
// row-major, write out (nq, n) with
//
//     out[i, j] = (||q_i||^2 - 2 q_i . a_j) + ||a_j||^2
//
// in that order, the reference's expanded form.
//
// What bounds it on an H100: at the main path's shape (64 queries against
// about 2^20 arena rows, d = 128) it moves about 0.8 GB (the arena read
// once, the block written once: 0.24 ms at 3.35 TB/s), while its dot
// products, as three TF32 tensor-core products (l2_mma.cuh: the split that
// keeps them inside `rescore_eps`), take 0.10 ms at 495 TFLOP/s.  So it is
// bound by bytes, and the design spends them once:
//
// * one block of one warpgroup owns a 64 x 128 output tile and streams its
//   arena rows once through the split-TF32 wgmma tile loop of l2_mma.cuh:
//   TMA copies of 8-deep chunks, 7 chunks (42 KB) in flight a block, two
//   blocks an SM (87 KB of shared memory each); the query tile is small
//   and stays in L2;
// * row norms come from the f32 rows as they pass through shared memory,
//   so there is one launch, no norm buffer and no second read;
// * the output tile (a third of the bytes) is staged through shared memory
//   (the raw stages, idle by then) and written as coalesced 16-byte
//   streaming stores, a warp per row.

#include "l2_mma.cuh"

namespace {

using namespace l2mma;
using T = Tile<1, 8>;

constexpr int OS = BN + 8;  // staged output row stride: conflict-free float2
static_assert(T::BM * OS <= T::NP * T::RAW,
              "the output tile fits in the raw stages");

template <bool VEC>
__global__ void __launch_bounds__(T::THREADS, 2)
l2_dist_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap a_map,
               const float* __restrict__ q, const float* __restrict__ a,
               float* __restrict__ out, int nq, int n, int d) {
  extern __shared__ char smem[];
  const int q0 = blockIdx.y * T::BM;
  const int n0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int quad = lane & 3;
  float* stage = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));

  run<T, VEC>(&q_map, &a_map, q, a, nq, n, d, q0, n0, min(n0 + BN, n), smem,
              [&](float (&acc)[64], int, const float* norms) {
    // every copy has landed and every MMA is complete: reuse the raw
    // stages (the norms live in a split stage past them)
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float qn = norms[r];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * quad;
        // (qn - 2 dot) + an, rounded step by step as the reference does
        float2 v;
        v.x = __fadd_rn(__fsub_rn(qn, 2.0f * acc[4 * j + 2 * h]),
                        norms[T::BM + col]);
        v.y = __fadd_rn(__fsub_rn(qn, 2.0f * acc[4 * j + 2 * h + 1]),
                        norms[T::BM + col + 1]);
        *reinterpret_cast<float2*>(stage + r * OS + col) = v;
      }
    }
    __syncthreads();
  });

  // write the staged tile: a warp per row, 16 bytes a lane where rows of
  // out are 16-byte aligned and the tile is whole, else 4 bytes a lane
  const bool vec_out = n % 4 == 0 && (uintptr_t)out % 16 == 0;
  const int warp = threadIdx.x >> 5;
  for (int r = warp; r < T::BM && q0 + r < nq; r += T::THREADS / 32) {
    float* dst = out + (size_t)(q0 + r) * n + n0;
    const float* src = stage + r * OS;
    if (vec_out && n0 + BN <= n) {
      __stcs(reinterpret_cast<float4*>(dst) + lane,
             *reinterpret_cast<const float4*>(src + 4 * lane));
    } else {
      for (int c = lane; c < BN && n0 + c < n; c += 32) __stcs(dst + c, src[c]);
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* q, const float* a, float* out, int nq, int n,
                   int d, cudaStream_t stream) {
  CUtensorMap q_map = {}, a_map = {};
  cudaError_t err = cudaSuccess;
  if (VEC) {
    err = bind_context();
    if (err == cudaSuccess) err = make_map(&q_map, q, nq, d, T::BM);
    if (err == cudaSuccess) err = make_map(&a_map, a, n, d, BN);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(l2_dist_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((n + BN - 1) / BN, (nq + T::BM - 1) / T::BM);
  l2_dist_kernel<VEC><<<grid, T::THREADS, T::SMEM, stream>>>(
      q_map, a_map, q, a, out, nq, n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int l2_dist_launch(const void* q, const void* a, void* out,
                              int nq, int n, int d, void* stream) {
  // TMA needs 16-byte aligned rows
  const bool vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)a) % 16 == 0;
  return (int)(vec ? launch<true> : launch<false>)(
      (const float*)q, (const float*)a, (float*)out, nq, n, d,
      (cudaStream_t)stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
