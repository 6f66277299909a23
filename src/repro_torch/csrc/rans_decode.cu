// Interleaved-lane 32/16 rANS decode with a static pmf (Hopper, sm_90a).
//
// Replaces the reference's Pallas TPU kernel `rans_decode_pallas`
// (src/repro/kernels/rans_decode/kernel.py, body `_decode_kernel`): L
// lanes decode one symbol each per step, in lockstep, for `rows` steps.
// Per step and lane, with u32 head h and cf = h mod 2^r:
//
//     sym = sym_t[cf];  h = freq_t[cf] * (h >> r) + cf - start_t[cf]
//     if h < 2^16: h = (h << 16) | words[ptr + k]
//
// where k is the lane's rank among the lanes that need a word this step
// (an exclusive prefix sum over the need mask: the encoder wrote each
// step's words contiguous and in lane order), and ptr advances by the
// step's total.
//
// What bounds it on an H100: nothing the card has a peak for.  The steps
// form one dependent chain (each step's word index needs the previous
// step's prefix sum), and a decode of rows x L symbols moves only
// ~(2 + 4) bytes per symbol, so the time is `rows` times the latency of
// one step.  The design keeps that step short:
//
// * one block of L threads (1 <= L <= 1024), one lane per thread, so the
//   head lives in a register for the whole decode;
// * the prefix sum is a warp ballot and `__popc(ballot & lanemask_lt)`
//   inside each warp, plus the warp totals through shared memory: one
//   `__syncthreads` per step, with the totals double-buffered by step
//   parity so no second barrier is needed;
// * the three tables go to shared memory when 3 * 2^r * 4 bytes fit
//   (r <= 14; r = 12 is 48 KB), else they are read through the read-only
//   cache (r = 16 is 768 KB);
// * a word index past the end of `words` reads 0 (the reference pads L
//   zero words instead), so the kernel never reads out of bounds.
//
// Heads arrive as int32 bit patterns and words as int32 16-bit values;
// both are read as u32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LANES = 1024;
constexpr int TOTALS = 2 * 32;   // warp totals, double-buffered by parity
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90

template <bool TABLES_IN_SMEM>
__global__ void __launch_bounds__(MAX_LANES)
rans_decode_kernel(const uint32_t* __restrict__ heads,
                   const uint32_t* __restrict__ words, int n_words,
                   const int* __restrict__ sym_t,
                   const int* __restrict__ freq_t,
                   const int* __restrict__ start_t, int* __restrict__ out,
                   int rows, int r) {
  extern __shared__ int smem[];
  int* totals = smem;
  const int L = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (L + 31) >> 5;
  const unsigned active = (warp == nwarps - 1 && (L & 31))
                              ? ((1u << (L & 31)) - 1u)
                              : 0xffffffffu;
  const unsigned lanemask_lt = (1u << lane) - 1u;

  const int* st = sym_t;
  const int* ft = freq_t;
  const int* ct = start_t;
  if (TABLES_IN_SMEM) {
    const int tsz = 1 << r;
    int* tab = smem + TOTALS;
    for (int i = tid; i < tsz; i += L) {
      tab[i] = sym_t[i];
      tab[tsz + i] = freq_t[i];
      tab[2 * tsz + i] = start_t[i];
    }
    st = tab;
    ft = tab + tsz;
    ct = tab + 2 * tsz;
    __syncthreads();
  }

  const uint32_t mask = (1u << r) - 1u;
  uint32_t h = heads[tid];
  int ptr = 0;  // words consumed so far; the same in every thread
  for (int t = 0; t < rows; ++t) {
    const uint32_t cf = h & mask;
    int sym;
    uint32_t f, c;
    if (TABLES_IN_SMEM) {
      sym = st[cf];
      f = (uint32_t)ft[cf];
      c = (uint32_t)ct[cf];
    } else {
      sym = __ldg(st + cf);
      f = (uint32_t)__ldg(ft + cf);
      c = (uint32_t)__ldg(ct + cf);
    }
    h = f * (h >> r) + cf - c;
    const bool need = h < (1u << 16);
    const unsigned ballot = __ballot_sync(active, need);
    int* tot = totals + (t & 1) * 32;
    if (lane == 0) tot[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nwarps; ++w) {
      const int v = tot[w];
      before += w < warp ? v : 0;
      total += v;
    }
    if (need) {
      const int idx = ptr + before + __popc(ballot & lanemask_lt);
      const uint32_t wv = idx < n_words ? __ldg(words + idx) : 0u;
      h = (h << 16) | wv;
    }
    ptr += total;
    out[(size_t)t * L + tid] = sym;
  }
}

}  // namespace

extern "C" int rans_decode_launch(const void* heads, const void* words,
                                  const void* sym_t, const void* freq_t,
                                  const void* start_t, void* out, int lanes,
                                  int n_words, int rows, int r,
                                  void* stream) {
  if (lanes < 1 || lanes > MAX_LANES || r < 1 || r > 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(TOTALS + 3 * (1 << r)) * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (smem <= SMEM_LIMIT) {
    err = cudaFuncSetAttribute(rans_decode_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rans_decode_kernel<true><<<1, lanes, smem, s>>>(
        (const uint32_t*)heads, (const uint32_t*)words, n_words,
        (const int*)sym_t, (const int*)freq_t, (const int*)start_t,
        (int*)out, rows, r);
  } else {
    rans_decode_kernel<false><<<1, lanes, TOTALS * sizeof(int), s>>>(
        (const uint32_t*)heads, (const uint32_t*)words, n_words,
        (const int*)sym_t, (const int*)freq_t, (const int*)start_t,
        (int*)out, rows, r);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
