// p-sparsified EMA sketch-triple update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/psparse_update.py::psparse_update
// (its pallas_call). Each of the three projections (T, k) is implicit: m
// support slots, slot u of matrix mat at row row_mat(u) holding
// alpha * sgn_mat(u, j) in column j, alpha = sqrt(T / m), from four uint32
// multiply-shift coefficients [a1, b1, a2, b2] per matrix:
//
//   row(u)    = (((a1 u + b1) >> 16) T) >> 16
//   sgn(u, j) = 1 - 2 ((a2 (u << 16 | j) + b2) >> 31)
//
// in uint32 arithmetic that wraps. For an activation A (T, d), weights psi
// (k,) (masked by the caller) and sketches X, Y, Z (d, k) it computes
//
//   X' = beta X + (1-beta) sum_u A[row_0(u), :]^T alpha sgn_0(u, :)
//   Y' = the same with matrix 1
//   Z' = the same with matrix 2, the sum times psi (per column)
//
// Duplicate support rows add, as in a CountSketch. A is bf16 or f32 and is
// summed in f32; everything else is f32. k <= 64 (checked by the Python
// wrapper, src/repro_torch/kernels/psparse_update.py).
//
// Bound on an H100 SXM (3.35 TB/s). The call must read the 3 m support rows
// of A (3 m d |A| bytes) and read and write the sketches (6 d k 4 bytes);
// the 6 m d k flops are negligible. At the trainer's shapes (T=128, m=33,
// d=512, k=33; T=128, m=17, d=1024, k=17; f32 A) that is 0.61 and 0.63 MB,
// 0.18 and 0.19 us; at the psparse serving prefill (T=1024, m=102, d=2048,
// k=9, bf16 A) 1.70 MB, 0.51 us. All are far under a launch's latency: the
// kernel is latency-bound, and a simple design is enough.
//
// Design. The TPU kernel reads all of A and multiplies it by one-hot
// (t_blk, m) tiles on the MXU. Here nothing but the support rows is read:
//   * a block owns a 32-column d-tile (one column per lane, so a warp reads
//     32 neighbouring elements of a support row) and a 16-wide chunk of k
//     (gridDim.z = ceil(k/16)); ragged d and k edges are masked here, and
//     nothing is padded in device memory;
//   * the block regenerates 64 support slots at a time from the 12
//     coefficients (kernel arguments, so no device read): their rows
//     (3 x 64 ints) and alpha * sign (64 x 3 x 16 floats, zero past k) go
//     to shared memory, where all lanes of a warp read the same word;
//   * its 8 warps take interleaved slots, each lane keeping 3 x 16 f32 sums
//     in registers; the warps' sums are added in shared memory in a fixed
//     order (deterministic, no atomics), and the EMA epilogue is written
//     once. m is at most a few hundred on the paths that call this, so T
//     is not split across blocks.
// Occupancy: 256 threads and about 28 KB of static shared memory a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TILE_D = 32;  // d columns per block, one per lane
constexpr int WARPS = 8;    // warp w takes slots w, w + 8, ... of a stage
constexpr int KC = 16;      // projection columns per block (gridDim.z chunks)
constexpr int SLOTS = 64;   // support slots regenerated per stage

struct Coeffs {
  uint32_t v[3][4];  // per matrix: a_row, b_row, a_sign, b_sign
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int support_row(const uint32_t* c, uint32_t u,
                                           uint32_t T) {
  const uint32_t h = c[0] * u + c[1];
  return static_cast<int>(((h >> 16) * T) >> 16);
}

__device__ __forceinline__ float support_sign(const uint32_t* c, uint32_t u,
                                              uint32_t j) {
  const uint32_t h = c[2] * ((u << 16) | j) + c[3];
  return (h >> 31) ? -1.f : 1.f;
}

template <typename TA>
__global__ void __launch_bounds__(TILE_D* WARPS)
    psparse_update_kernel(const TA* __restrict__ a,
                          const float* __restrict__ psi,
                          const float* __restrict__ x_in,
                          const float* __restrict__ y_in,
                          const float* __restrict__ z_in,
                          float* __restrict__ x_out,
                          float* __restrict__ y_out,
                          float* __restrict__ z_out, Coeffs coeffs, int T,
                          int d, int k, int m, float alpha, float beta) {
  __shared__ int rows[3][SLOTS];
  __shared__ __align__(16) float sgn[SLOTS][3][KC];
  __shared__ float red[WARPS][KC][TILE_D];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * TILE_D + lane;
  const int col = blockIdx.x * TILE_D + lane;
  const int k0 = blockIdx.z * KC;
  const int kc = min(KC, k - k0);

  float acc[3][KC];
#pragma unroll
  for (int mat = 0; mat < 3; ++mat) {
#pragma unroll
    for (int c = 0; c < KC; ++c) acc[mat][c] = 0.f;
  }

  for (int u0 = 0; u0 < m; u0 += SLOTS) {
    const int nu = min(SLOTS, m - u0);
    for (int i = tid; i < 3 * SLOTS; i += TILE_D * WARPS) {
      const int mat = i / SLOTS;
      const int r = i % SLOTS;
      rows[mat][r] = r < nu ? support_row(coeffs.v[mat], u0 + r, T) : 0;
    }
    for (int i = tid; i < SLOTS * 3 * KC; i += TILE_D * WARPS) {
      const int r = i / (3 * KC);
      const int mat = (i / KC) % 3;
      const int c = i % KC;
      sgn[r][mat][c] = (r < nu && c < kc)
                           ? alpha * support_sign(coeffs.v[mat], u0 + r,
                                                  k0 + c)
                           : 0.f;
    }
    __syncthreads();
    if (col < d) {
      for (int r = warp; r < nu; r += WARPS) {
#pragma unroll
        for (int mat = 0; mat < 3; ++mat) {
          const float av = to_f32(a[(size_t)rows[mat][r] * d + col]);
#pragma unroll
          for (int c = 0; c < KC; c += 4) {
            const float4 sv =
                *reinterpret_cast<const float4*>(&sgn[r][mat][c]);
            acc[mat][c + 0] = fmaf(av, sv.x, acc[mat][c + 0]);
            acc[mat][c + 1] = fmaf(av, sv.y, acc[mat][c + 1]);
            acc[mat][c + 2] = fmaf(av, sv.z, acc[mat][c + 2]);
            acc[mat][c + 3] = fmaf(av, sv.w, acc[mat][c + 3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // Sum the 8 warps' partial sums of each matrix and write the epilogue.
  const float* in[3] = {x_in, y_in, z_in};
  float* out[3] = {x_out, y_out, z_out};
#pragma unroll
  for (int mat = 0; mat < 3; ++mat) {
#pragma unroll
    for (int c = 0; c < KC; ++c) red[warp][c][lane] = acc[mat][c];
    __syncthreads();
    for (int i = tid; i < KC * TILE_D; i += TILE_D * WARPS) {
      const int c = i / TILE_D;
      const int j = blockIdx.x * TILE_D + i % TILE_D;
      if (c < kc && j < d) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) s += red[w][c][i % TILE_D];
        const size_t o = (size_t)j * k + k0 + c;
        const float inc = mat == 2 ? s * psi[k0 + c] : s;
        out[mat][o] = beta * in[mat][o] + (1.f - beta) * inc;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches the update on `stream`; returns cudaGetLastError() as an int
// (0 on success). c{mat}{0..3} are matrix mat's a_row, b_row, a_sign,
// b_sign.
int psparse_update_launch(const void* a, int a_is_bf16, const float* psi,
                          const float* x_in, const float* y_in,
                          const float* z_in, float* x_out, float* y_out,
                          float* z_out, uint32_t c00, uint32_t c01,
                          uint32_t c02, uint32_t c03, uint32_t c10,
                          uint32_t c11, uint32_t c12, uint32_t c13,
                          uint32_t c20, uint32_t c21, uint32_t c22,
                          uint32_t c23, int T, int d, int k, int m,
                          float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Coeffs coeffs = {{{c00, c01, c02, c03},
                          {c10, c11, c12, c13},
                          {c20, c21, c22, c23}}};
  const dim3 block(TILE_D, WARPS);
  const dim3 grid((d + TILE_D - 1) / TILE_D, 1, (k + KC - 1) / KC);
  if (a_is_bf16) {
    psparse_update_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), psi, x_in, y_in, z_in, x_out,
        y_out, z_out, coeffs, T, d, k, m, alpha, beta);
  } else {
    psparse_update_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(a), psi, x_in, y_in, z_in, x_out, y_out,
        z_out, coeffs, T, d, k, m, alpha, beta);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* psparse_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
