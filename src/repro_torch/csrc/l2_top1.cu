// Nearest centroid per row for k-means assignment (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `l2_top1_pallas`
// (src/repro/kernels/l2_topk/kernel.py, body `_l2_kernel`): for rows
// q (nq, d) and centroids c (k, d), all f32 and row-major, write
//
//     val[i] = min_j  (||q_i||^2 - 2 q_i . c_j) + ||c_j||^2
//     idx[i] = the lowest j reaching that minimum
//
// in the reference's expanded form and rounding order.  NaN orders before
// every number, as in torch's min/argmin.  The (rows, k) distance tile
// never reaches device memory.
//
// What bounds it on an H100: at the IVF build's shape (2^20 rows, k = 1024,
// d = 128) it does 2 * 2^20 * 1024 * 128 = 275 GFLOP of dot products and
// moves only about 0.5 GB (rows read once, two words written per row).  The
// dot products run as three TF32 tensor-core products (l2_mma.cuh: the
// split that keeps them inside `rescore_eps`), 825 GFLOP at the card's
// 495 TFLOP/s dense TF32 rate, ~1.7 ms: bound by operations.  The design:
//
// * a block of two warpgroups owns 128 rows (64 each) and walks every
//   centroid in 128-wide tiles through the split-TF32 wgmma tile loop of
//   l2_mma.cuh (TMA copies of 8-deep chunks, 3 raw and 3 split stages,
//   78 KB of shared memory, so two blocks share an SM and one block's
//   split and epilogue overlap the other's MMAs); the 512 KB of centroids
//   at k = 1024, d = 128 stay in L2, read once per 128 rows;
// * each centroid tile's norms come from its f32 rows as they pass through
//   shared memory, once per tile visit: no row is read twice for them;
// * the epilogue of a tile folds its 64 x 128 accumulators per warpgroup
//   into a running (min, argmin) per row in registers (each thread owns
//   2 rows and 32 columns of the wgmma fragment, visited in ascending
//   order, so a strict "better" keeps the lowest index on ties); at the
//   end the 4 lanes that share a row reduce with shuffles, ties to the
//   lower index; a warpgroup spans all 128 columns of a tile, so no
//   reduction across warps is needed;
// * ragged k and d are zero-filled by the copies (zeros in d preserve
//   distances; columns past k are never compared), so the wrapper pads
//   nothing.

#include "l2_mma.cuh"

namespace {

using namespace l2mma;
using T = Tile<2, 3>;

constexpr int NO_INDEX = 0x7fffffff;

// (v, j) comes before (bv, bj) in torch's min order: NaN first, then
// ascending value, ties to the lower index.
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  if (v != v) return bv == bv || j < bj;
  return v < bv || (v == bv && j < bj);
}

template <bool VEC>
__global__ void __launch_bounds__(T::THREADS, 2)
l2_top1_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap c_map,
               const float* __restrict__ q, const float* __restrict__ c,
               int* __restrict__ out_idx, float* __restrict__ out_val,
               int nq, int k, int d) {
  extern __shared__ char smem[];
  const int q0 = blockIdx.x * T::BM;
  const int lane = threadIdx.x & 31;
  // this thread's rows r0 + 8 h (h = 0, 1) and columns 8 j + 2 quad + e
  const int r0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int quad = lane & 3;

  float best_v[2];
  int best_j[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best_v[h] = __int_as_float(0x7f800000);  // +inf
    best_j[h] = NO_INDEX;
  }

  run<T, VEC>(&q_map, &c_map, q, c, nq, k, d, q0, 0, k, smem,
              [&](float (&acc)[64], int n0, const float* norms) {
    const int lim = k - n0;  // columns at or past lim lie beyond k
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float qn = norms[r0 + 8 * h];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * j + 2 * quad + e;
          if (col < lim) {
            // (qn - 2 dot) + cn, rounded step by step as the reference does
            const float v =
                __fadd_rn(__fsub_rn(qn, 2.0f * acc[4 * j + 2 * h + e]),
                          norms[T::BM + col]);
            if (better(v, n0 + col, best_v[h], best_j[h])) {
              best_v[h] = v;
              best_j[h] = n0 + col;
            }
          }
        }
    }
  });

  // the 4 lanes of a quad share rows r0 and r0 + 8: reduce (min, argmin)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = best_v[h];
    int j = best_j[h];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oj = __shfl_xor_sync(0xffffffffu, j, off);
      if (better(ov, oj, v, j)) {
        v = ov;
        j = oj;
      }
    }
    const int gi = q0 + r0 + 8 * h;
    if (quad == 0 && gi < nq) {
      out_idx[gi] = j;
      out_val[gi] = v;
    }
  }
}

template <bool VEC>
cudaError_t launch(const float* q, const float* c, int* idx, float* val,
                   int nq, int k, int d, cudaStream_t stream) {
  CUtensorMap q_map = {}, c_map = {};
  cudaError_t err = cudaSuccess;
  if (VEC) {
    err = bind_context();
    if (err == cudaSuccess) err = make_map(&q_map, q, nq, d, T::BM);
    if (err == cudaSuccess) err = make_map(&c_map, c, k, d, BN);
  }
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(l2_top1_kernel<VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)T::SMEM);
  if (err != cudaSuccess) return err;
  l2_top1_kernel<VEC><<<(nq + T::BM - 1) / T::BM, T::THREADS, T::SMEM,
                        stream>>>(q_map, c_map, q, c, idx, val, nq, k, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" int l2_top1_launch(const void* q, const void* c, void* out_idx,
                              void* out_val, int nq, int k, int d,
                              void* stream) {
  // TMA needs 16-byte aligned rows
  const bool vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)c) % 16 == 0;
  return (int)(vec ? launch<true> : launch<false>)(
      (const float*)q, (const float*)c, (int*)out_idx, (float*)out_val, nq,
      k, d, (cudaStream_t)stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
