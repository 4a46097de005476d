// Fused EMA sketch-triple update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/sketch_update.py::sketch_update
// (its pallas_call). For an activation A (T, d), projections Upsilon, Omega,
// Phi (T, k), weights psi (k,) and sketches X, Y, Z (d, k) it computes
//
//   X' = beta X + (1-beta) A^T Upsilon
//   Y' = beta Y + (1-beta) A^T Omega
//   Z' = beta Z + (1-beta) (A^T Phi) * psi        (psi per column)
//
// reading A once for all three thin products. A is bf16 or f32 and is
// accumulated in f32; everything else is f32. k <= 64 (checked by the
// Python wrapper, src/repro_torch/kernels/sketch_update.py).
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores).
// The call moves T*d*|A| + 3*T*k*4 + 6*d*k*4 bytes and does 6*T*d*k
// flops. At the serving prefill shape (T=1024, d=2048, k=9, bf16 A) that
// is 4.75 MB (1.42 us) and 113 MFLOP, which the tensor cores do in 0.23 us
// even with each f32 projection split into bf16 high and low parts (as the
// 1e-4 tolerance needs): the bound is set by bytes, by a wide margin. At
// k=33 it is 6.22 MB (1.86 us). At decode (T=8) it is 0.48 MB (0.14 us),
// far under the launch latency, so at decode the launch is the cost. This
// kernel runs its products on the f32 FMA units (67 TFLOP/s, 1.7 us for
// the prefill products), which alone keeps it above that bound.
//
// Design. The TPU kernel pads k to 128 lanes and T, d to its block grid,
// and carries each (d_blk, k) output across the T axis because the TPU
// grid runs in order. Here blocks run in parallel, so:
//   * a block owns a 32-column d-tile (one column per lane, so a warp reads
//     32 neighbouring elements of a row of A) and a 16-wide chunk of k
//     (gridDim.z = ceil(k/16)); the ragged d and k edges are masked in the
//     kernel, nothing is padded in device memory;
//   * its 8 warps take interleaved rows of the block's T range, each lane
//     keeping 3 x 16 f32 sums in registers; projection rows are staged in
//     shared memory (zero past k), where all lanes of a warp read the same
//     word (a broadcast);
//   * d=2048 gives only 64 d-tiles for 132 SMs, so T is split across
//     gridDim.y blocks (the wrapper aims at two blocks per SM, with at least
//     64 rows each). One split writes the EMA epilogue directly; several
//     write partial sums to a workspace that a second small kernel reduces
//     in a fixed order (deterministic, no atomics) before the epilogue.
// Occupancy: 256 threads and 28 KB of static shared memory a block, so up
// to 8 blocks fit on an SM. Tensor cores (wgmma) and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE_D = 32;  // d columns per block, one per lane
constexpr int WARPS = 8;    // warp w takes rows w, w + 8, ... of a stage
constexpr int KC = 16;      // projection columns per block (gridDim.z chunks)
constexpr int ROWS = 64;    // projection rows staged in shared memory at once

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename TA>
__global__ void __launch_bounds__(TILE_D* WARPS)
    sketch_update_partial(const TA* __restrict__ a,
                          const float* __restrict__ ups,
                          const float* __restrict__ omg,
                          const float* __restrict__ phi,
                          const float* __restrict__ psi,
                          const float* __restrict__ x_in,
                          const float* __restrict__ y_in,
                          const float* __restrict__ z_in,
                          float* __restrict__ x_out,
                          float* __restrict__ y_out,
                          float* __restrict__ z_out,
                          float* __restrict__ ws, int T, int d, int k,
                          int rows_per_split, float beta) {
  __shared__ __align__(16) float proj[ROWS][3][KC];
  __shared__ float red[WARPS][KC][TILE_D];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * TILE_D + lane;
  const int col = blockIdx.x * TILE_D + lane;
  const int k0 = blockIdx.z * KC;
  const int kc = min(KC, k - k0);
  const int t_begin = blockIdx.y * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);

  float acc[3][KC];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[m][c] = 0.f;
  }

  for (int t0 = t_begin; t0 < t_end; t0 += ROWS) {
    const int nrows = min(ROWS, t_end - t0);
    for (int i = tid; i < ROWS * 3 * KC; i += TILE_D * WARPS) {
      const int r = i / (3 * KC);
      const int m = (i / KC) % 3;
      const int c = i % KC;
      const float* p = m == 0 ? ups : (m == 1 ? omg : phi);
      proj[r][m][c] = (r < nrows && c < kc)
                          ? p[(size_t)(t0 + r) * k + k0 + c]
                          : 0.f;
    }
    __syncthreads();
    if (col < d) {
#pragma unroll 4
      for (int r = warp; r < nrows; r += WARPS) {
        const float av = to_f32(a[(size_t)(t0 + r) * d + col]);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
#pragma unroll
          for (int c = 0; c < KC; c += 4) {
            const float4 pv =
                *reinterpret_cast<const float4*>(&proj[r][m][c]);
            acc[m][c + 0] = fmaf(av, pv.x, acc[m][c + 0]);
            acc[m][c + 1] = fmaf(av, pv.y, acc[m][c + 1]);
            acc[m][c + 2] = fmaf(av, pv.z, acc[m][c + 2]);
            acc[m][c + 3] = fmaf(av, pv.w, acc[m][c + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Sum the 8 warps' partial sums of each matrix, one matrix at a time.
  const float* in[3] = {x_in, y_in, z_in};
  float* out[3] = {x_out, y_out, z_out};
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int c = 0; c < KC; ++c) red[warp][c][lane] = acc[m][c];
    __syncthreads();
    for (int i = tid; i < KC * TILE_D; i += TILE_D * WARPS) {
      const int c = i / TILE_D;
      const int j = blockIdx.x * TILE_D + i % TILE_D;
      if (c < kc && j < d) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][c][i % TILE_D];
        const size_t o = (size_t)j * k + k0 + c;
        if (direct) {
          const float inc = m == 2 ? s * psi[k0 + c] : s;
          out[m][o] = beta * in[m][o] + (1.f - beta) * inc;
        } else {
          ws[((size_t)blockIdx.y * 3 + m) * d * k + o] = s;
        }
      }
    }
    __syncthreads();
  }
}

// Sums the T-splits' partials in split order and applies the epilogue.
__global__ void sketch_update_finalize(const float* __restrict__ ws,
                                       const float* __restrict__ psi,
                                       const float* __restrict__ x_in,
                                       const float* __restrict__ y_in,
                                       const float* __restrict__ z_in,
                                       float* __restrict__ x_out,
                                       float* __restrict__ y_out,
                                       float* __restrict__ z_out, int d,
                                       int k, int splits, float beta) {
  const size_t n = (size_t)d * k;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < 3 * n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int m = (int)(i / n);
    const size_t o = i % n;
    float s = 0.f;
    for (int sp = 0; sp < splits; ++sp) s += ws[((size_t)sp * 3 + m) * n + o];
    const float* in = m == 0 ? x_in : (m == 1 ? y_in : z_in);
    float* out = m == 0 ? x_out : (m == 1 ? y_out : z_out);
    const float inc = m == 2 ? s * psi[o % k] : s;
    out[o] = beta * in[o] + (1.f - beta) * inc;
  }
}

}  // namespace

extern "C" {

// Launches the update on `stream`; returns cudaGetLastError() as an int
// (0 on success). `ws` holds splits*3*d*k floats and is unused when
// splits == 1.
int sketch_update_launch(const void* a, int a_is_bf16, const float* ups,
                         const float* omg, const float* phi,
                         const float* psi, const float* x_in,
                         const float* y_in, const float* z_in, float* x_out,
                         float* y_out, float* z_out, float* ws, int T, int d,
                         int k, int splits, int rows_per_split, float beta,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(TILE_D, WARPS);
  const dim3 grid((d + TILE_D - 1) / TILE_D, splits, (k + KC - 1) / KC);
  if (a_is_bf16) {
    sketch_update_partial<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), ups, omg, phi, psi, x_in, y_in,
        z_in, x_out, y_out, z_out, ws, T, d, k, rows_per_split, beta);
  } else {
    sketch_update_partial<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), ups, omg, phi, psi, x_in, y_in, z_in,
        x_out, y_out, z_out, ws, T, d, k, rows_per_split, beta);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long n = 3LL * d * k;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 1024
                               ? (n + threads - 1) / threads
                               : 1024);
  sketch_update_finalize<<<blocks, threads, 0, s>>>(
      ws, psi, x_in, y_in, z_in, x_out, y_out, z_out, d, k, splits, beta);
  return static_cast<int>(cudaGetLastError());
}

const char* sketch_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
