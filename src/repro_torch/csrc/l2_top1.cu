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
// d = 128) it does 2 * 2^20 * 1024 * 128 = 275 GFLOP and moves only
// about 0.5 GB (rows read once, two words written per row), so it is
// bound by the card's 67 TFLOP/s non-tensor f32 rate (~4.1 ms).  The
// design spends its memory traffic on nothing but that arithmetic:
//
// * one block owns 64 rows and walks every centroid in 128-wide tiles,
//   staging d in 32-deep chunks through shared memory (k x d f32 is
//   512 KB at k = 1024, d = 128: it does not fit in shared memory, and
//   the centroids stay in L2 across blocks); each of the 256 threads
//   keeps an 8 x 4 register tile of dot products (fmaf; the tile loop of
//   l2_tile.cuh, shared with l2_dist.cu);
// * each thread also keeps a running (min, argmin) for its 8 rows over
//   the centroid columns it owns; columns are visited in ascending order,
//   so a strict "better" keeps the lowest index on ties;
// * at the end the 32 lanes that share a row reduce their (min, argmin)
//   pairs with shuffles, ties to the lower index;
// * row and centroid norms are prologues of the same kernel (one warp
//   per row, shuffle reduce), so there is one launch and no norm buffer;
// * ragged k and d are masked in the tile loads (zeros in d preserve
//   distances; columns past k are never compared), so the wrapper pads
//   nothing.
//
// No TF32 and no tensor cores: the assignment values are held to the
// scan's f32 contraction band (`rescore_eps`), which TF32 inputs alone
// exceed.

#include "l2_tile.cuh"

namespace {

using namespace l2tile;

constexpr int NO_INDEX = 0x7fffffff;

// (v, j) comes before (bv, bj) in torch's min order: NaN first, then
// ascending value, ties to the lower index.
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  if (v != v) return bv == bv || j < bj;
  return v < bv || (v == bv && j < bj);
}

__global__ void __launch_bounds__(THREADS)
l2_top1_kernel(const float* __restrict__ q, const float* __restrict__ c,
               int* __restrict__ out_idx, float* __restrict__ out_val,
               int nq, int k, int d) {
  __shared__ Stage st;
  __shared__ float qn_s[BM];
  __shared__ float cn_s[BN];

  const int tx = threadIdx.x & 31;   // centroid columns tx + 32 * j
  const int ty = threadIdx.x >> 5;   // rows ty * TM + i
  const int q0 = blockIdx.x * BM;

  row_norms(q, nq, d, q0, BM, qn_s);
  float best_v[TM];
  int best_j[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_v[i] = __int_as_float(0x7f800000);  // +inf
    best_j[i] = NO_INDEX;
  }

  for (int n0 = 0; n0 < k; n0 += BN) {
    __syncthreads();  // the previous tile's readers of cn_s are done
    row_norms(c, k, d, n0, BN, cn_s);
    __syncthreads();
    float acc[TM][TN];
    tile_dots(q, c, nq, k, d, q0, n0, st, acc);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = n0 + tx + 32 * j;
      if (gj >= k) continue;
      const float cn = cn_s[tx + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        // (qn - 2 dot) + cn, rounded step by step as the reference does
        const float v =
            __fadd_rn(__fsub_rn(qn_s[ty * TM + i], 2.0f * acc[i][j]), cn);
        if (better(v, gj, best_v[i], best_j[i])) {
          best_v[i] = v;
          best_j[i] = gj;
        }
      }
    }
  }

  // the warp's 32 lanes share rows ty * TM + i: reduce their (min, argmin)
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best_v[i];
    int j = best_j[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oj = __shfl_xor_sync(0xffffffffu, j, off);
      if (better(ov, oj, v, j)) {
        v = ov;
        j = oj;
      }
    }
    const int gi = q0 + ty * TM + i;
    if (tx == i && gi < nq) {
      out_idx[gi] = j;
      out_val[gi] = v;
    }
  }
}

}  // namespace

extern "C" int l2_top1_launch(const void* q, const void* c, void* out_idx,
                              void* out_val, int nq, int k, int d,
                              void* stream) {
  const int grid = (nq + BM - 1) / BM;
  l2_top1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)c, (int*)out_idx, (float*)out_val, nq,
      k, d);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
