// Pieces shared by the two EMA sketch-update kernels (sketch_update.cu,
// psparse_update.cu): the epilogue, the ordered sum of T-split partials,
// the FMA kernel for f32 A (and bf16 A whose rows are not 16-byte
// multiples), and the tensor-core consumers' epilogue.
//
// Both kernels compute the (d, 3k) increment inc[j, n] = sum_r A[row(r), j]
// * P[r, n] over "rows" r: the T activation rows with P = [Upsilon | Omega
// | Phi] for sketch_update, the 3m support slots with P the implicit
// +-1 signs for psparse_update (slot s of matrix s / m; zero outside
// that matrix's k columns), times `scale` (1, or alpha = sqrt(T / m)).
// Output n = mat * k + c is column c of sketch mat, and the epilogue is
//
//   S'_mat[j, c] = beta S_mat[j, c] + (1 - beta) inc[j, n] (* psi[c] for Z)
//
// written once, in f32, into one (3, d, k) buffer. When the rows are
// split across blocks (gridDim.y > 1) each split writes its partial sums
// to a (splits, 3, d, k) workspace instead, and `finalize` sums them in
// split order: deterministic, no atomics.
//
// A stacked call updates E experts' triples in one launch, as the TPU
// kernel runs under the reference's vmap over the experts: gridDim.z is
// E, and block z reads expert z's A (E, rows, d), sketches (E, d, k) and
// psi (E, k) and writes its (E, 3, d, k) outputs and (E, splits, 3, d,
// k) partials, against projections all experts share (`expert_outs`).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ema {

struct Outs {
  const float* x;     // the sketches read, each (d, k)
  const float* y;
  const float* z;
  const float* psi;   // (k,)
  float* out;         // (3, d, k)
  float* ws;          // (splits, 3, d, k), or null with one split
  int d, k;
  float beta, scale;
};

// Expert e's part of a stacked call: its sketches, psi, outputs and
// partials (the split count given, as finalize's grid differs)
__device__ __forceinline__ Outs expert_outs(Outs o, int e, int splits) {
  const size_t dk = (size_t)o.d * o.k;
  o.x += e * dk;
  o.y += e * dk;
  o.z += e * dk;
  o.psi += (size_t)e * o.k;
  o.out += e * 3 * dk;
  if (o.ws != nullptr) o.ws += e * splits * 3 * dk;
  return o;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Where output n (= mat k + c) of a sketch row goes: `dst` is column c of
// the output (or of this split's partial) of matrix mat, `src` column c
// of its input sketch; an element of row j is at [j * k]. With one split
// the epilogue is dst = beta src + mul inc, else dst = mul inc.
struct Target {
  const float* src;
  float* dst;
  float mul;
  bool ok;
};

__device__ __forceinline__ Target target(const Outs& o, bool direct, int n) {
  const int mat = n / o.k, c = n - mat * o.k, dk = o.d * o.k;
  Target t;
  t.ok = n < 3 * o.k;
  t.src = (mat == 0 ? o.x : (mat == 1 ? o.y : o.z)) + c;
  t.dst = (direct ? o.out : o.ws + blockIdx.y * 3 * dk) + mat * dk + c;
  t.mul = direct ? (1.f - o.beta) * o.scale * (mat == 2 && t.ok ? o.psi[c]
                                                                 : 1.f)
                 : o.scale;
  return t;
}

// Sums the splits' partials in split order and applies the epilogue;
// blockIdx.y is the expert.
__global__ void finalize(Outs o, int splits) {
  o = expert_outs(o, blockIdx.y, splits);
  const int dk = o.d * o.k;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 3 * dk;
       i += gridDim.x * blockDim.x) {
    const int mat = i >= 2 * dk ? 2 : (i >= dk ? 1 : 0), at = i - mat * dk;
    const float* in = mat == 0 ? o.x : (mat == 1 ? o.y : o.z);
    const float keep = o.beta * in[at];
    const float mul = mat == 2 ? o.psi[at % o.k] : 1.f;
    // eight partials' reads in flight at once, summed in split order
    float s = 0.f;
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      float part[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        part[q] = sp0 + q < splits ? o.ws[(sp0 + q) * 3 * dk + i] : 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (sp0 + q < splits) s += part[q];
    }
    o.out[i] = keep + (1.f - o.beta) * mul * s;
  }
}

inline cudaError_t launch_finalize(const Outs& o, int splits, int experts,
                                   cudaStream_t stream) {
  const int n = 3 * o.d * o.k;
  const int blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  finalize<<<dim3(blocks, experts), 256, 0, stream>>>(o, splits);
  return cudaGetLastError();
}

// ---- the FMA kernel ----
//
// A block owns 32 columns of d (one a lane: a warp reads 32 neighbouring
// elements of a row) and all 3k outputs: warp w keeps outputs
// [w NW, w NW + NW) of the 3k padded to 8 NW, so A is read once for every
// k. A stage stages ROWS rows of A (as f32) and of P (zero past 3k and
// past the split's rows) in shared memory; each lane then runs NW FMAs a
// row, reading its A value and a warp-wide broadcast float4 of P.
constexpr int FMA_TILE_D = 32;
constexpr int FMA_WARPS = 8;
constexpr int FMA_ROWS = 32;

// Src: row(r), the row of A that row r reads, and val(r, n), P[r, n];
// an expert's A is a_stride elements after the last one's.
template <typename TA, int NW4, class Src>
__global__ void __launch_bounds__(FMA_TILE_D* FMA_WARPS)
    fma_kernel(const TA* __restrict__ a, size_t a_stride, Src src, Outs o,
               int rows_total, int rows_per_split) {
  constexpr int NW = 4 * NW4, NP = FMA_WARPS * NW;
  a += blockIdx.z * a_stride;
  o = expert_outs(o, blockIdx.z, gridDim.y);
  __shared__ float As[FMA_ROWS][FMA_TILE_D];
  __shared__ __align__(16) float Ps[FMA_ROWS][NP];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d0 = blockIdx.x * FMA_TILE_D;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows_total, r_begin + rows_per_split);
  const int np = 3 * o.k;
  float acc[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i] = 0.f;

  constexpr int THREADS = FMA_TILE_D * FMA_WARPS;
  constexpr int LA = FMA_ROWS * FMA_TILE_D / THREADS, LP = FMA_ROWS * NP /
                                                           THREADS;
  for (int r0 = r_begin; r0 < r_end; r0 += FMA_ROWS) {
    const int nr = min(FMA_ROWS, r_end - r0);
    // every read of the stage into registers first, then the shared
    // stores: a store between two reads would keep them apart (the
    // compiler cannot tell the generic pointers from shared memory)
    float va[LA], vp[LP];
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int i = tid + q * THREADS, r = i / FMA_TILE_D;
      const int j = d0 + i % FMA_TILE_D;
      va[q] = (r < nr && j < o.d)
                  ? to_f32(a[(size_t)src.row(r0 + r) * o.d + j])
                  : 0.f;
    }
#pragma unroll
    for (int q = 0; q < LP; ++q) {
      const int i = tid + q * THREADS, r = i / NP, n = i % NP;
      vp[q] = (r < nr && n < np) ? src.val(r0 + r, n) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < LA; ++q) {
      const int i = tid + q * THREADS;
      As[i / FMA_TILE_D][i % FMA_TILE_D] = va[q];
    }
#pragma unroll
    for (int q = 0; q < LP; ++q) {
      const int i = tid + q * THREADS;
      Ps[i / NP][i % NP] = vp[q];
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const float av = As[r][lane];
#pragma unroll
      for (int c = 0; c < NW4; ++c) {
        const float4 pv =
            *reinterpret_cast<const float4*>(&Ps[r][warp * NW + 4 * c]);
        acc[4 * c + 0] = fmaf(av, pv.x, acc[4 * c + 0]);
        acc[4 * c + 1] = fmaf(av, pv.y, acc[4 * c + 1]);
        acc[4 * c + 2] = fmaf(av, pv.z, acc[4 * c + 2]);
        acc[4 * c + 3] = fmaf(av, pv.w, acc[4 * c + 3]);
      }
    }
    __syncthreads();
  }
  // the epilogue: this lane's column, the warp's NW outputs in turn (mat
  // and c stepped, not divided); every read before any write
  const int col = d0 + lane;
  if (col >= o.d) return;
  const bool direct = gridDim.y == 1;
  Target t[NW];
  float keep[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    t[i] = target(o, direct, warp * NW + i);
    keep[i] = direct && t[i].ok ? o.beta * t[i].src[col * o.k] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i)
    if (t[i].ok) t[i].dst[col * o.k] = keep[i] + t[i].mul * acc[i];
}

// NW4 = ceil(3k / 32) in 1..6 (k <= 64): the float4 groups a warp keeps
template <typename TA, class Src>
cudaError_t launch_fma(const TA* a, size_t a_stride, const Src& src,
                       const Outs& o, int rows_total, int splits,
                       int rows_per_split, int experts, cudaStream_t stream) {
  const dim3 grid((o.d + FMA_TILE_D - 1) / FMA_TILE_D, splits, experts);
  const int threads = FMA_TILE_D * FMA_WARPS;
  switch ((3 * o.k + 31) / 32) {
#define EMA_FMA_CASE(N)                                                    \
  case N:                                                                  \
    fma_kernel<TA, N, Src><<<grid, threads, 0, stream>>>(                  \
        a, a_stride, src, o, rows_total, rows_per_split);                  \
    break;
    EMA_FMA_CASE(1)
    EMA_FMA_CASE(2)
    EMA_FMA_CASE(3)
    EMA_FMA_CASE(4)
    EMA_FMA_CASE(5)
    EMA_FMA_CASE(6)
#undef EMA_FMA_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- the tensor-core kernels' shared shape ----
//
// A block owns TC_TILE_D = 128 columns of d and all 3k outputs, one
// consumer warpgroup for each 64 outputs (MT = ceil(3k / 64) in 1..3).
// The product is computed transposed, inc^T (3k, 128) = P^T A_tile, on
// wgmma m64n128k16: P^T, 64 outputs by 16 rows, is the A operand in
// registers, built by each thread from P; the A tile, 16 rows by 128
// columns, is the B operand, MN-major in shared memory (its rows as they
// lie in device memory), 128-byte swizzled. A stage holds TC_ROWS rows.
constexpr int TC_TILE_D = 128;
constexpr int TC_ROWS = 64;
constexpr int TC_STAGE_BYTES = TC_ROWS * TC_TILE_D * 2;

// Consumer warpgroup c's (64, 128) accumulator, outputs [64 c, 64 c +
// 64), through the epilogue: a thread holds two output rows and 32
// columns of each; every read before any write.
__device__ __forceinline__ void tc_emit(const float (&acc)[64], int c,
                                        const Outs& o, int d0) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const bool direct = gridDim.y == 1;
  const Target row[2] = {target(o, direct, 64 * c + 16 * w + lane / 4),
                         target(o, direct, 64 * c + 16 * w + lane / 4 + 8)};
  const int col0 = d0 + 2 * (lane % 4);
  float keep[64];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Target& r = row[e >> 1];
      const int col = col0 + 8 * j + (e & 1);
      keep[4 * j + e] = direct && r.ok && col < o.d
                            ? o.beta * r.src[col * o.k] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Target& r = row[e >> 1];
      const int col = col0 + 8 * j + (e & 1);
      if (r.ok && col < o.d)
        r.dst[col * o.k] = keep[4 * j + e] + r.mul * acc[4 * j + e];
    }
}

}  // namespace ema
