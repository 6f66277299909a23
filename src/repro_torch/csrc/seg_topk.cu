// Segmented top-k select over padded distance rows (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `seg_topk_pallas`
// (src/repro/kernels/seg_topk/kernel.py, body `_seg_topk_kernel`): for
// dists (nq, n) f32 and lens (nq,) i32, return for each row the k smallest
// (value, column) pairs in lexicographic order, ascending.  Columns at or
// past min(lens[i], n) count as +inf; when k > n the row is widened with
// +inf columns n..k-1.  Ties, +inf included, go to the lower column.
//
// Each element becomes one unique 64-bit key
//
//     key = (order-preserving bits of the f32 value << 32) | column
//
// after -0.0 is made +0.0 (the reference compares them equal and ties them
// by column), so the lexicographic order is a plain integer order and
// selection is exact whatever the values.
//
// What bounds it on an H100: at the main path's shape (64 rows of 16384
// candidates, k = 16..64) it reads 4 MB, a few microseconds at 3.35 TB/s,
// but only 64 blocks run on 132 SMs and the k rounds are sequential, so it
// is latency-bound.  The design keeps each round short:
//
// * one block per row; thread t owns columns t, t + 256, ... and keeps the
//   smallest of its keys above the last key chosen;
// * a round is one block-wide min (warp shuffles, then one warp over the
//   per-warp minima); the owner of the winning key refreshes its local
//   minimum with its whole warp scanning its columns, so no thread ever
//   walks a long column list alone;
// * the value written back is the row's own value (so -0.0 stays -0.0).
//
// Worst case: the scan's retry path doubles k up to the padded row width,
// which makes the rounds, not the bytes, the cost (see PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned long long NONE = ~0ull;

__device__ __forceinline__ unsigned long long make_key(float v, int col) {
  unsigned int u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;                    // -0.0 -> +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned int)col;
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// smallest key above `last` (any key when !has_last) among columns
// first, first + step, ... < ncols
__device__ __forceinline__ unsigned long long scan_min(
    const float* __restrict__ row, int len, int ncols, int first, int step,
    unsigned long long last, bool has_last) {
  unsigned long long best = NONE;
  for (int c = first; c < ncols; c += step) {
    const unsigned long long key =
        make_key(c < len ? row[c] : __int_as_float(0x7f800000), c);
    if ((!has_last || key > last) && key < best) best = key;
  }
  return best;
}

__global__ void __launch_bounds__(THREADS)
seg_topk_kernel(const float* __restrict__ d, const int* __restrict__ lens,
                float* __restrict__ vals, int* __restrict__ idx, int n,
                int k) {
  __shared__ unsigned long long wmin[WARPS];
  __shared__ unsigned long long chosen;
  const int row_id = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* row = d + (size_t)row_id * n;
  const int len = max(0, min(lens[row_id], n));
  const int ncols = max(n, k);

  unsigned long long mine = scan_min(row, len, ncols, tid, THREADS, 0, false);
  for (int t = 0; t < k; ++t) {
    unsigned long long v = warp_min(mine);
    if (lane == 0) wmin[warp] = v;
    __syncthreads();
    if (warp == 0) {
      v = warp_min(lane < WARPS ? wmin[lane] : NONE);
      if (lane == 0) {
        chosen = v;
        const int col = (int)(v & 0xffffffffull);
        vals[(size_t)row_id * k + t] =
            col < len ? row[col] : __int_as_float(0x7f800000);
        idx[(size_t)row_id * k + t] = col;
      }
    }
    __syncthreads();
    const unsigned long long c = chosen;
    const unsigned int hit = __ballot_sync(0xffffffffu, mine == c);
    if (hit) {
      // keys are unique: exactly one thread of the block owned the winner;
      // its warp rescans the owner's columns above it together
      const int w = __ffs(hit) - 1;
      const int owner = (warp << 5) + w;
      const unsigned long long best = warp_min(
          scan_min(row, len, ncols, owner + lane * THREADS, 32 * THREADS, c,
                   true));
      if (lane == w) mine = best;
    }
  }
}

}  // namespace

extern "C" int seg_topk_launch(const void* d, const void* lens, void* vals,
                               void* idx, int nq, int n, int k,
                               void* stream) {
  seg_topk_kernel<<<nq, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const int*)lens, (float*)vals, (int*)idx, n, k);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
