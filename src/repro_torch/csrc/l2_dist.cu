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
// about 2^20 arena rows, d = 128) it does 2 * 64 * 2^20 * 128 = 17.2 GFLOP
// and moves about 0.8 GB (the arena read once, the block written once), so
// it sits near the ridge of the card's 67 TFLOP/s non-tensor f32 rate and
// its 3.35 TB/s memory rate.  The design keeps both costs to one pass:
//
// * one block owns a 64 x 128 output tile and reads its arena rows once,
//   staging d in 32-wide chunks through shared memory (the query tile is
//   tiny and stays in L2), with an 8 x 4 register micro-tile per thread
//   (l2_tile.cuh, shared with l2_top1.cu);
// * row norms are a prologue of the same kernel (one warp per row, shuffle
//   reduce), so there is one launch and no norm buffer.
//
// No TF32 and no tensor cores: the scan's exact re-score only tolerates
// the f32 contraction error band (`rescore_eps`, about 2.4e-4 relative at
// d = 128), and TF32 inputs alone carry about 5e-4.

#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS)
l2_dist_kernel(const float* __restrict__ q, const float* __restrict__ a,
               float* __restrict__ out, int nq, int n, int d) {
  __shared__ Stage st;
  __shared__ float qn_s[BM];
  __shared__ float an_s[BN];

  const int tx = threadIdx.x & 31;   // arena rows tx + 32 * j
  const int ty = threadIdx.x >> 5;   // query rows ty * TM + i
  const int q0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // prologue: squared norms of this tile's query and arena rows
  row_norms(q, nq, d, q0, BM, qn_s);
  row_norms(a, n, d, n0, BN, an_s);
  __syncthreads();

  float acc[TM][TN];
  tile_dots(q, a, nq, n, d, q0, n0, st, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = q0 + ty * TM + i;
    if (gi >= nq) continue;
    const float qn = qn_s[ty * TM + i];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gj = n0 + tx + 32 * j;
      if (gj < n) {
        // (qn - 2 dot) + an, rounded step by step as the reference does
        out[(size_t)gi * n + gj] =
            __fadd_rn(__fsub_rn(qn, 2.0f * acc[i][j]), an_s[tx + 32 * j]);
      }
    }
  }
}

}  // namespace

extern "C" int l2_dist_launch(const void* q, const void* a, void* out,
                              int nq, int n, int d, void* stream) {
  dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  l2_dist_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)a, (float*)out, nq, n, d);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
