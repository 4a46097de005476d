// Symmetric per-row int8 quantisation of a count-sketch table, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/csvec_quant.py::csvec_quant (its
// pallas_call). For a table t (r, c) f32 it writes, per row j,
//
//   scale[j] = amax_j / 127                       (amax_j = max_i |t[j, i]|)
//   q[j, i]  = clamp(rint(t[j, i] / safe_j), -127, 127)   (safe_j = scale[j],
//                                                          or 1 when it is 0)
//   dhat     = q * scale[j],   resid = t - dhat
//
// rint rounds half to even, like jnp.round and torch.round. The division
// is IEEE (__fdiv_rn), and the product and difference are __fmul_rn and
// __fsub_rn, so nothing is contracted into an FMA: q, scale and dhat equal
// the plain version's bit for bit, resid to one rounding. An all-zero row
// gets scale 0 and zeros.
//
// Bound on an H100 SXM (3.35 TB/s). The function reads the table once
// (4 r c bytes) and writes q (r c), dhat and resid (4 r c each) and the r
// scales. At the LM train step's geometry (r = 5, c = 2^23) that is
// 168 MB in and 42 + 168 + 168 MB out, 546 MB, 0.163 ms.
//
// Design. The TPU kernel holds the table in VMEM with grid (1,), which at
// 168 MB is not possible. Here two kernels run on one stream:
//   1. amax: blocks (x, j) reduce slices of row j (warp shuffles, then
//      shared memory) and fold them in with atomicMax on the bits of the
//      non-negative |t|, which order as unsigned integers (NaN above inf,
//      so a NaN row propagates as jnp.max's does); the wrapper's scratch
//      is zeroed first;
//   2. quant: blocks (x, j) read row j's amax, and each element is read
//      once and written three times.
// The table is read twice, 336 MB of reads in all: 0.21 ms at the memory
// rate, 1.3 times the bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float nanmax(float m, float a) {
  return a <= m ? m : a;  // a NaN replaces m
}

__global__ void __launch_bounds__(THREADS)
    amax_kernel(const float* __restrict__ t, unsigned* __restrict__ amax_bits,
                int cols) {
  const float* row = t + (size_t)blockIdx.y * cols;
  float m = 0.f;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < cols;
       i += gridDim.x * THREADS)
    m = nanmax(m, fabsf(row[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ float warp_max[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) b = nanmax(b, warp_max[w]);
    atomicMax(amax_bits + blockIdx.y, __float_as_uint(b));
  }
}

__global__ void __launch_bounds__(THREADS)
    quant_kernel(const float* __restrict__ t,
                 const unsigned* __restrict__ amax_bits,
                 int8_t* __restrict__ q, float* __restrict__ scale_out,
                 float* __restrict__ dhat, float* __restrict__ resid,
                 int cols) {
  const int j = blockIdx.y;
  const float scale = __fdiv_rn(__uint_as_float(amax_bits[j]), 127.f);
  const float safe = scale > 0.f ? scale : 1.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) scale_out[j] = scale;
  const size_t base = (size_t)j * cols;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < cols;
       i += gridDim.x * THREADS) {
    const float x = t[base + i];
    const float qf = fminf(fmaxf(rintf(__fdiv_rn(x, safe)), -127.f), 127.f);
    const int8_t qi = (int8_t)qf;
    // from the int8 code, as the plain version: a -0 rounding gives +0
    const float dh = __fmul_rn((float)qi, scale);
    q[base + i] = qi;
    dhat[base + i] = dh;
    resid[base + i] = __fsub_rn(x, dh);
  }
}

}  // namespace

extern "C" {

// Quantises `table` (rows, cols) on `stream` into q, scale (rows,), dhat and
// resid. `amax_scratch` holds `rows` unsigned ints. Returns
// cudaGetLastError() as an int (0 on success).
int csvec_quant_launch(const float* table, unsigned* amax_scratch, int8_t* q,
                       float* scale, float* dhat, float* resid, int rows,
                       int cols, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(amax_scratch, 0, rows * sizeof(unsigned), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(blocks, rows);
  amax_kernel<<<grid, THREADS, 0, s>>>(table, amax_scratch, cols);
  quant_kernel<<<grid, THREADS, 0, s>>>(table, amax_scratch, q, scale, dhat,
                                         resid, cols);
  return static_cast<int>(cudaGetLastError());
}

const char* csvec_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
