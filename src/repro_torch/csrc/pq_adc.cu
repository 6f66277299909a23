// Batched PQ asymmetric-distance (ADC) scan (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `pq_adc_pallas`
// (src/repro/kernels/pq_adc/kernel.py, body `_adc_kernel`) together with
// the `vmap` over per-query tables around it (src/repro/ann/scan.py): for
// lookup tables luts (qb, m, 256) f32 and codes (n, m) u8 write
//
//     out[q, r] = sum_{j < m} luts[q, j, codes[r, j]]      (qb, n) f32
//
// The TPU kernel turns the lookup into a one-hot contraction for the
// matrix unit; on Hopper the lookup itself is cheap, so this kernel does
// the gather directly.
//
// What bounds it on an H100: the output.  At the main path's shape (64
// tables, m = 8, about 2^20 codes) it writes 268 MB and reads 8 MB of
// codes, which takes about 0.08 ms at 3.35 TB/s; the adds (0.5 G) are
// negligible.  The design:
//
// * each block loads QT queries' tables (QT * m KB) into shared memory
//   once and scores a 4096-row span of codes against all of them, so the
//   tables are read from L2 once per span and each code row is read once
//   per query group;
// * each thread reads one code row with 32-bit loads (m % 4 == 0) or
//   bytes, sums its m lookups in order j = 0..m-1, and writes one float
//   per query; neighbouring threads write neighbouring columns, so the
//   output stores are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = 4096;
constexpr int QT_MAX = 8;      // queries per block (the wrapper picks QT)
constexpr int KSUB = 256;

__global__ void __launch_bounds__(THREADS)
pq_adc_kernel(const float* __restrict__ luts,
              const uint8_t* __restrict__ codes, float* __restrict__ out,
              int qb, int n, int m, int qt) {
  extern __shared__ float lut_s[];   // (nqt, m, 256)
  const int g0 = blockIdx.y * qt;
  const int nqt = min(qt, qb - g0);
  const int tab = m * KSUB;
  const float* src = luts + (size_t)g0 * tab;
  for (int e = threadIdx.x; e < nqt * tab; e += THREADS) lut_s[e] = src[e];
  __syncthreads();

  const bool words = (m % 4 == 0) && ((uintptr_t)codes % 4 == 0);
  const int r0 = blockIdx.x * ROWS_PER_BLOCK;
  const int r1 = min(n, r0 + ROWS_PER_BLOCK);
  for (int r = r0 + threadIdx.x; r < r1; r += THREADS) {
    const uint8_t* c = codes + (size_t)r * m;
    float acc[QT_MAX];
#pragma unroll
    for (int t = 0; t < QT_MAX; ++t) acc[t] = 0.f;
    if (words) {
      const uint32_t* cw = (const uint32_t*)c;
      for (int w = 0; w < m / 4; ++w) {
        const uint32_t bits = cw[w];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float* l = lut_s + (4 * w + b) * KSUB + ((bits >> (8 * b)) & 0xffu);
#pragma unroll
          for (int t = 0; t < QT_MAX; ++t)
            if (t < nqt) acc[t] += l[t * tab];
        }
      }
    } else {
      for (int j = 0; j < m; ++j) {
        const float* l = lut_s + j * KSUB + c[j];
#pragma unroll
        for (int t = 0; t < QT_MAX; ++t)
          if (t < nqt) acc[t] += l[t * tab];
      }
    }
#pragma unroll
    for (int t = 0; t < QT_MAX; ++t)
      if (t < nqt) out[(size_t)(g0 + t) * n + r] = acc[t];
  }
}

}  // namespace

extern "C" int pq_adc_launch(const void* luts, const void* codes, void* out,
                             int qb, int n, int m, int qt, void* stream) {
  if (qt < 1 || qt > QT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)qt * m * KSUB * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, (qb + qt - 1) / qt);
  pq_adc_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)luts, (const uint8_t*)codes, (float*)out, qb, n, m, qt);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
