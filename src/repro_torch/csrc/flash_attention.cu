// Flash attention for Hopper (sm_90a): causal GQA attention, optionally
// in a sliding window, forward and backward, with a plain C interface
// for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (forward only; the backward is the gradient of
// src/repro/kernels/ref.py::flash_attention_ref, for which the JAX
// package has no Pallas kernel). Layout as there: q (B, Hq, S, D), k and
// v (B, Hkv, S, D); query head h reads KV head h / G, G = Hq / Hkv. Any
// b/h/s strides, the D stride 1. o, dq, dk and dv are written in the
// input type, lse = m + log(max(l, 1e-30)) and delta = rowsum(do * o) in
// f32. Two paths, chosen by the input type alone:
//
// bf16 (namespace tc; head_dim 64, 128, 160 and 256): the tensor cores.
//   Every product is a wgmma (m64nNk16, f32 accumulators) on tiles that
//   TMA brings into shared memory, swizzled: 128-byte rows at D 64, 128
//   and 256, 64-byte rows at D 160 (a 320-byte row is no whole number of
//   128-byte atoms). q, k, v, do are read through 4-D tensor maps
//   (D, H, S, B) built per call from the strides, so the model's
//   (B, S, H, D) storage needs no copy; rows past S arrive as zeros and
//   the stores clip them. A block is one producer warpgroup (one thread,
//   one warp in the dk/dv pass, issues the loads; setmaxnreg gives its
//   registers to the consumers) and two consumer warpgroups of 64 rows;
//   streamed tiles go through a two-stage ring of full/empty mbarriers.
//   Only the diagonal tile and the window's edge tile apply the element
//   mask; tiles without a live pair for a warpgroup are skipped, and the
//   loops never reach tiles outside the causal frontier or the window.
//   P and dS are rounded to bf16 before their products, as the JAX
//   model's chunked scan rounds P.
//   forward    128 query rows a block; S = Q K^T (both operands in
//              shared memory), scaled by D^-1/2 in f32; the online
//              softmax on the accumulator's fragment (a row's four lanes
//              reduce with shuffles); P V with P as the register A
//              operand and V read transposed from shared memory.
//   backward   FlashAttention-2, deterministic, no atomics: a pre-pass
//              writes delta; the dq pass (128 query rows a block, K and
//              V streamed) computes dQ += dS K; the dk/dv pass (128 keys
//              a block, 64 a warpgroup, Q, dO, lse and delta streamed)
//              computes S^T = K Q^T and dP^T = V dO^T, so that P^T and
//              dS^T are the register A operands of dV += P^T dO and
//              dK += dS^T Q as they stand. Where a KV head's G query
//              heads are split over blocks (`splits`, for MQA's few KV
//              heads), f32 partials are summed in slice order by a
//              third kernel.
//   Tiles (rows x keys or keys x queries): forward 128 x 128 at D 64
//   and 128, 128 x 64 at D 160 and 256; the dq pass streams 128 keys at
//   D 64, 32 at D 256, 64 otherwise; the dk/dv pass streams 128 queries
//   at D 64, 64 at D 128, 32 at D 160: as wide as two f32 accumulators
//   of that width fit beside the (64, D) ones in 240 registers.
//   At D 256 (recurrentgemma's local layers) a (64, D) f32 accumulator
//   is 128 registers a thread: the forward's O and a 64-key S tile
//   (176) fit, and Q (64 KB) with two stages of 64-key K and V (128 KB)
//   fit shared memory; the dq pass takes 32-key K and V tiles so that
//   its resident Q and dO (128 KB) and two stages (64 KB) fit; the dk/dv
//   pass cannot hold dK and dV for one warpgroup's keys (256 registers),
//   so `flash_bwd_dkdv_split_kernel` gives a block 64 keys and splits
//   its two consumer warpgroups by output, one dV and one dK, P^T handed
//   from the first to the second through shared memory: each issues two
//   of a tile's four products and nothing is computed twice. (One
//   head_dim half of both a warpgroup would need S^T and dP^T swapped
//   both ways between them.) The grid's slowest
//   index is the tile, so the longest rows (forward, dq) and the
//   earliest keys (dk/dv) start first.
//   Bound on an H100 SXM: 4 D flops a live (q, k) pair forward, 10 D
//   backward, at 989 TFLOP/s (bf16 tensor cores); at the model's shapes
//   the operations bound it, not the bytes. This version serialises
//   each warpgroup's products and its softmax (no ping-pong between the
//   warpgroups, no overlap of a tile's softmax with the next tile's S)
//   and aims at a quarter of the forward's bound and a tenth of the
//   backward's; on an NVIDIA H100 80GB HBM3 at 700 W it reached 28-40%
//   and 12-20% of them at the models' S 2048 shapes (PERF.md).
//
// f32 (head_dim 16, 64, 128 and 160): the first version's kernels, on
// the f32 FMA units. The tensor cores take no f32 operand at f32
// precision (TF32 keeps 10 bits of mantissa), and only the reduced
// configs and the card-against-CPU checks, held at 1e-4, feed flash f32.
//   Forward: one block per (q-tile of 64 rows, query head, batch),
//   looping over the 64-key tiles of its live range, with the running
//   max, sum and (64, D) accumulator in registers. Backward: the dq pass
//   (which also writes delta) and the dk/dv pass, as above, one block
//   per 64-row tile. Threads of a tile: 8 across its 64 columns (column
//   tx + 8 j), the rest down its rows (RT consecutive rows each), so the
//   8 lanes that share a row are neighbours in one warp and reduce with
//   shuffles. Shared rows are padded to D + 1 and 65 floats to keep the
//   lanes on distinct banks. Bound: 67 TFLOP/s of f32 FMA.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>
#include <cstdio>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows of a tile
constexpr int BK = 64;            // key rows of a tile
constexpr int TX = 8;             // threads across a tile's 64 columns
constexpr int CW = BK / TX;       // columns a thread holds
constexpr int LDP = BK + 1;       // padded row of a (64, 64) score tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;              // in elements; the D stride is 1
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + ROWS) of one head into shared f32 [ROWS][D + 1],
// times mul; rows at or past S are zero
template <int D, int ROWS>
__device__ void load_tile(float* dst, const float* src, long long stride_s,
                          int row0, int S, float mul) {
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, c = i % D, row = row0 + r;
    dst[r * (D + 1) + c] =
        row < S ? src[(long long)row * stride_s + c] * mul : 0.f;
  }
}

// acc[i][j] = sum_d A[row i][d] * B[col j][d] over a tile's RT rows and
// CW columns of this thread (A, B: shared [64][D + 1])
template <int RT, int D>
__device__ __forceinline__ void dot_rows(float (&acc)[RT][CW],
                                         const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RT], b[CW];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = A[(ty * RT + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < CW; ++j) b[j] = B[(tx + TX * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][c] += sum_k P[row i][k] * M[k][col c] over the 64 k of a tile
// (P: shared [64][65]; M: shared [64][D + 1]; columns tx + 8 c)
template <int RT, int D>
__device__ __forceinline__ void acc_rows(float (&acc)[RT][D / TX],
                                         const float* P, const float* M,
                                         int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < BK; ++k) {
    float p[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) p[i] = P[(ty * RT + i) * LDP + k];
#pragma unroll
    for (int c = 0; c < D / TX; ++c) {
      const float m = M[k * (D + 1) + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][c] = fmaf(p[i], m, acc[i][c]);
    }
  }
}

// sum or max over the 8 lanes that share a row
__device__ __forceinline__ float row_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int window) {
  return qpos < S && kpos <= qpos && (window <= 0 || qpos - kpos < window);
}

// the key tiles [*t0, *t1) that hold a live key of queries [q0, q0 + BQ)
__device__ __forceinline__ void key_tiles(int q0, int S, int window,
                                          int* t0, int* t1) {
  const int k_end = min(S, q0 + BQ);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  *t0 = k_begin / BK;
  *t1 = (k_end + BK - 1) / BK;
}

template <int D>
__global__ void __launch_bounds__(BQ / 4 * TX)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, Strides sq, Strides sk,
                 Strides sv, Strides so, int H, int G, int S, int window,
                 float scale) {
  constexpr int RT = 4, DW = D / TX, LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;
  const int qt = gridDim.x - 1 - blockIdx.x;    // long rows start first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G, q0 = qt * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const float* kh = k + b * sk.b + hk * sk.h;
  const float* vh = v + b * sv.b + hk * sv.h;
  load_tile<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);

  float m[RT], l[RT], acc[RT][DW];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DW; ++c) acc[i][c] = 0.f;
  }
  int t0, t1;
  key_tiles(q0, S, window, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * BK;
    __syncthreads();            // the last tile's Ks, Vs, Ps are read
    load_tile<D, BK>(Ks, kh, sk.s, k0, S, 1.f);
    load_tile<D, BK>(Vs, vh, sv.s, k0, S, 1.f);
    __syncthreads();
    float s[RT][CW];
    dot_rows<RT, D>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty * RT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        if (!live(qpos, k0 + tx + TX * j, S, window))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float p = live(qpos, k0 + tx + TX * j, S, window)
                            ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RT + i) * LDP + tx + TX * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DW; ++c) acc[i][c] *= corr;
    }
    __syncthreads();
    acc_rows<RT, D>(acc, Ps, Vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty * RT + i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* orow = o + b * so.b + h * so.h + (long long)row * so.s;
#pragma unroll
    for (int c = 0; c < DW; ++c) store(orow + tx + TX * c, acc[i][c] / li);
    if (tx == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(li);
  }
}

template <int D>
__global__ void __launch_bounds__(BQ / 4 * TX)
flash_bwd_dq_kernel(const float* __restrict__ q,
                    const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ o,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, float* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides so,
                    Strides sdo, Strides sdq, int H, int G, int S,
                    int window, float scale) {
  constexpr int RT = 4, DW = D / TX, LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* Ks = dOs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* dSs = Vs + BK * LD;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G, q0 = qt * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const float* kh = k + b * sk.b + hk * sk.h;
  const float* vh = v + b * sv.b + hk * sv.h;
  const float* oh = o + b * so.b + h * so.h;
  const long long rows = ((long long)b * H + h) * S;
  load_tile<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
  load_tile<D, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                      1.f);
  __syncthreads();

  float lse_r[RT], del[RT], acc[RT][DW];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty * RT + i;
    float part = 0.f;
    if (row < S) {
#pragma unroll
      for (int c = 0; c < DW; ++c)
        part += dOs[(ty * RT + i) * LD + tx + TX * c] *
                oh[(long long)row * so.s + tx + TX * c];
    }
    del[i] = row_sum(part);
    lse_r[i] = row < S ? lse[rows + row] : 0.f;
    if (row < S && tx == 0) delta[rows + row] = del[i];
#pragma unroll
    for (int c = 0; c < DW; ++c) acc[i][c] = 0.f;
  }
  int t0, t1;
  key_tiles(q0, S, window, &t0, &t1);
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<D, BK>(Ks, kh, sk.s, k0, S, 1.f);
    load_tile<D, BK>(Vs, vh, sv.s, k0, S, 1.f);
    __syncthreads();
    float p[RT][CW], dp[RT][CW];
    dot_rows<RT, D>(p, Qs, Ks, ty, tx);
    dot_rows<RT, D>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int qpos = q0 + ty * RT + i;
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float pij = live(qpos, k0 + tx + TX * j, S, window)
                              ? expf(p[i][j] - lse_r[i]) : 0.f;
        dSs[(ty * RT + i) * LDP + tx + TX * j] = pij * (dp[i][j] - del[i]);
      }
    }
    __syncthreads();
    acc_rows<RT, D>(acc, dSs, Ks, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = q0 + ty * RT + i;
    if (row >= S) continue;
    float* drow = dq + b * sdq.b + h * sdq.h + (long long)row * sdq.s;
#pragma unroll
    for (int c = 0; c < DW; ++c) store(drow + tx + TX * c, acc[i][c] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(BK / 2 * TX)
flash_bwd_dkdv_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk,
                      float* __restrict__ dv, Strides sq, Strides sk,
                      Strides sv, Strides sdo, Strides sdk, Strides sdv,
                      int H, int G, int S, int window, float scale,
                      int splits, float* __restrict__ part) {
  constexpr int RT = 2, DW = D / TX, LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * LD;
  float* Qs = Vs + BK * LD;
  float* dOs = Qs + BQ * LD;
  float* Ps = dOs + BQ * LD;
  float* dSs = Ps + BK * LDP;
  float* lse_s = dSs + BK * LDP;
  float* del_s = lse_s + BQ;
  const int k0 = blockIdx.x * BK;               // early keys have most rows
  const int hk = blockIdx.y / splits, slice = blockIdx.y % splits;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  load_tile<D, BK>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S, 1.f);
  load_tile<D, BK>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S, 1.f);

  float dk_acc[RT][DW], dv_acc[RT][DW];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int c = 0; c < DW; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  // the q-tiles that hold a live query of keys [k0, k0 + BK)
  const int q_begin = k0;
  const int q_end = window > 0 ? min(S, k0 + BK - 1 + window) : S;
  const int t0 = q_begin / BQ, t1 = (q_end + BQ - 1) / BQ;
  for (int g = slice * G / splits; g < (slice + 1) * G / splits; ++g) {
    const int h = hk * G + g;
    const long long rows = ((long long)b * H + h) * S;
    for (int t = t0; t < t1; ++t) {
      const int q0 = t * BQ;
      __syncthreads();          // the last tile's Qs, dOs, Ps, dSs are read
      load_tile<D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
      load_tile<D, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
                          1.f);
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        const int row = q0 + i;
        lse_s[i] = row < S ? lse[rows + row] : 0.f;
        del_s[i] = row < S ? delta[rows + row] : 0.f;
      }
      __syncthreads();
      float p[RT][CW], dp[RT][CW];
      dot_rows<RT, D>(p, Ks, Qs, ty, tx);      // s^T: rows keys, cols queries
      dot_rows<RT, D>(dp, Vs, dOs, ty, tx);    // dP^T
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int kpos = k0 + ty * RT + i;
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const int col = tx + TX * j;
          const float pij = live(q0 + col, kpos, S, window)
                                ? expf(p[i][j] - lse_s[col]) : 0.f;
          Ps[(ty * RT + i) * LDP + col] = pij;
          dSs[(ty * RT + i) * LDP + col] = pij * (dp[i][j] - del_s[col]);
        }
      }
      __syncthreads();
      acc_rows<RT, D>(dv_acc, Ps, dOs, ty, tx);
      acc_rows<RT, D>(dk_acc, dSs, Qs, ty, tx);
    }
  }
  // one slice of the group: dk and dv out; several: f32 partials
  // part[2][splits][B][Hkv][S][D], summed in order by flash_bwd_sum_kernel
  const long long n = (long long)gridDim.z * (H / G) * S * D;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = k0 + ty * RT + i;
    if (row >= S) continue;
    if (part == nullptr) {
      float* krow = dk + b * sdk.b + hk * sdk.h + (long long)row * sdk.s;
      float* vrow = dv + b * sdv.b + hk * sdv.h + (long long)row * sdv.s;
#pragma unroll
      for (int c = 0; c < DW; ++c) {
        store(krow + tx + TX * c, dk_acc[i][c]);
        store(vrow + tx + TX * c, dv_acc[i][c]);
      }
    } else {
      float* krow = part + slice * n +
                    (((long long)b * (H / G) + hk) * S + row) * D;
      float* vrow = krow + splits * n;
#pragma unroll
      for (int c = 0; c < DW; ++c) {
        krow[tx + TX * c] = dk_acc[i][c];
        vrow[tx + TX * c] = dv_acc[i][c];
      }
    }
  }
}

// dk and dv = the sum of the dk/dv pass's `splits` partials (n elements
// each, (B, Hkv, S, D) contiguous), taken in slice order: deterministic
template <typename T>
__global__ void flash_bwd_sum_kernel(const float* __restrict__ part,
                                     T* __restrict__ dk, T* __restrict__ dv,
                                     Strides sdk, Strides sdv, int Hkv,
                                     int S, int D, int splits, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < 2 * n; i += (long long)gridDim.x * blockDim.x) {
    const bool is_v = i >= n;
    const long long e = is_v ? i - n : i;
    const float* src = part + (is_v ? splits * n : 0) + e;
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += src[s * n];
    const int c = (int)(e % D);
    const long long r = e / D;
    const int row = (int)(r % S), hk = (int)(r / S % Hkv);
    const long long b = r / S / Hkv;
    const Strides st = is_v ? sdv : sdk;
    store((is_v ? dv : dk) + b * st.b + hk * st.h + (long long)row * st.s + c,
          acc);
  }
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int S,
                       const long long* st, int window, float scale,
                       cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = (size_t)(BQ * LD + 2 * BK * LD + BQ * LDP) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, BQ / 4 * TX, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), Hq, Hq / Hkv, S, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int B,
                       int Hq, int Hkv, int S, const long long* st,
                       int window, float scale, int splits, float* part,
                       cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem_dq = (size_t)(2 * BQ * LD + 2 * BK * LD + BQ * LDP) * 4;
  const size_t smem_kv =
      (size_t)(2 * BK * LD + 2 * BQ * LD + 2 * BK * LDP + 2 * BQ) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  // strides: q, k, v, o, do, dq, dk, dv
  flash_bwd_dq_kernel<D><<<dim3((S + BQ - 1) / BQ, Hq, B), BQ / 4 * TX,
                           smem_dq, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, lse, delta, (float*)dq, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), strides_at(st, 5), Hq, G, S, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<D><<<dim3((S + BK - 1) / BK, Hkv * splits, B),
                             BK / 2 * TX, smem_kv, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, (float*)dk, (float*)dv, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 4), strides_at(st, 6),
      strides_at(st, 7), Hq, G, S, window, scale, splits,
      splits > 1 ? part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Hkv * S * D;
  long long blocks = (2 * n + 255) / 256;
  if (blocks > 4096) blocks = 4096;      // the kernel strides the rest
  flash_bwd_sum_kernel<float><<<(int)blocks, 256, 0, stream>>>(
      part, (float*)dk, (float*)dv, strides_at(st, 6), strides_at(st, 7),
      Hkv, S, D, splits, n);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The bf16 path: tensor cores (wgmma), TMA and mbarriers (sm_90a).
// ---------------------------------------------------------------------
namespace tc {

using namespace hopper;

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 384;       // a producer warpgroup, two consumers

// Shared tiles are TMA boxes of (rows, AW) bf16, one box a column block
// of AW elements of D, laid out [D / AW][rows][AW] and swizzled as the
// box's swizzle mode lays them (128 bytes, AW 64, where D is a multiple
// of 64; 64 bytes, AW 32, at D 160, whose 320-byte rows are not whole
// 128-byte atoms). The wgmma descriptors name the same swizzle.
template <int D>
struct Cfg {
  static constexpr int SW = D % 64 == 0 ? 128 : 64;   // swizzle bytes
  static constexpr int AW = SW / 2;                   // elements a row
  static constexpr int NB = D / AW;                   // column blocks
  static constexpr int FWD_BK = D <= 128 ? 128 : 64;  // forward key tile
  // dq pass key tile, dk/dv pass query tile: as large as two f32
  // accumulators of that width beside the (64, D) ones fit registers;
  // at D 256 the dq pass's as small as Q, dO and two stages of K and V
  // fit 227 KB of shared memory (128 + 2 x 32 KB), and the dk/dv pass
  // (`flash_bwd_dkdv_split_kernel`) holds one (64, D) accumulator a
  // warpgroup beside one f32 tile of 64 queries
  static constexpr int DQ_BK = D == 64 ? 128 : D == 256 ? 32 : 64;
  static constexpr int KV_BQ = D == 64 ? 128 : D == 160 ? 32 : 64;
  // keys a dk/dv block: two warpgroups of 64, or at D 256 one 64-key
  // tile shared by the dV and the dK warpgroup
  static constexpr int KV_BK = D == 256 ? 64 : 128;
};

// one (rows, AW) box at element coordinates (d0, h, s0, b) of a 4-D map
// (D, H, S, B) into shared memory; rows past S arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int d0, int h, int s0,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(h), "r"(s0), "r"(b) : "memory");
}

// a tile of `rows` rows: every column block, one box each
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int rows, int h,
                                         int s0, int b) {
  using C = Cfg<D>;
#pragma unroll
  for (int cb = 0; cb < C::NB; ++cb)
    tma_load(dst + cb * rows * C::SW, map, bar, cb * C::AW, h, s0, b);
}

// wgmma shared-memory descriptor: start address, leading and stride
// byte offsets, swizzle mode (1: 128 bytes, 2: 64 bytes)
template <int SW>
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 |
         (uint64_t)(SW == 128 ? 1 : 2) << 62;
}

// K-major operand: the 16 elements of D from k-step kk of a tile of
// `rows` rows, starting at row `row0` (a multiple of 8)
template <int D>
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int rows,
                                          int row0, int kk) {
  using C = Cfg<D>;
  const int cb = kk * 16 / C::AW, off = (kk * 16 % C::AW) * 2;
  return make_desc<C::SW>(tile + cb * rows * C::SW + row0 * C::SW + off, 16,
                          8 * C::SW);
}

// MN-major operand (the tile read transposed: N = D, K = its rows): rows
// [16 kk, 16 kk + 16) of a tile of `rows` rows
template <int D>
__device__ __forceinline__ uint64_t mndesc(const uint8_t* tile, int rows,
                                           int kk) {
  using C = Cfg<D>;
  return make_desc<C::SW>(tile + kk * 16 * C::SW, rows * C::SW, 8 * C::SW);
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// An m64nN f32 accumulator as a register A operand of the next product
// (K = N): k-step kk holds columns [16 kk, 16 kk + 16), rounded to bf16.
template <int N>
__device__ __forceinline__ void to_a(const float (&d)[N / 2],
                                     uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = pack_bf16(d[8 * kk + 2 * i], d[8 * kk + 2 * i + 1]);
}

// The accumulator's fragment: element e of n-block j (register 4 j + e)
// of lane l in warp w holds row 16 w + l / 4 + 8 (e / 2), column
// 8 j + 2 (l % 4) + e % 2. The four lanes of a row are neighbours.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// wgmma m64nNk16, f32 += bf16 x bf16 (the operand lists written out)
template <int N>
struct MMA;

template <> struct MMA<32> {
  // A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct MMA<64> {
  // A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // A in registers, B MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct MMA<128> {
  // A and B K-major in shared memory
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // A in registers, B MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct MMA<160> {
  // A in registers, B MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[80],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79"
        "}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct MMA<256> {
  // A in registers, B MN-major in shared memory (transposed)
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

constexpr int STAGES = 2;                 // the ring of streamed tiles

__device__ __forceinline__ void init_barriers(uint64_t* bars, int stages,
                                              uint32_t full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&bars[s], full_count);          // full: the producer's
      mbar_init(&bars[stages + s], 256);        // empty: every consumer
    }
    mbar_init(&bars[2 * stages], 1);            // the resident tiles
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// Forward: a block owns 128 query rows of one (batch, query head); two
// consumer warpgroups take 64 rows each, and one thread of the producer
// warpgroup streams the live K and V tiles of BK keys through the ring.
template <int D, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
           float* __restrict__ lse, Strides so, int H, int G, int S,
           int window, float scale) {
  constexpr int BQ = 128;
  constexpr uint32_t QB = BQ * D * 2, KB = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* Ks = Qs + QB;
  uint8_t* Vs = Ks + STAGES * KB;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * KB);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  // the grid's slowest index is the tile: long rows start first
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / G, q0 = qt * BQ;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_begin / BK, t1 = (min(S, q0 + BQ) + BK - 1) / BK;
  init_barriers(full, STAGES, 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(qbar, QB);
      tma_tile<D>(Qs, &mq, qbar, BQ, h, q0, b);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KB);
        tma_tile<D>(Ks + s * KB, &mk, &full[s], BK, hk, t * BK, b);
        tma_tile<D>(Vs + s * KB, &mv, &full[s], BK, hk, t * BK, b);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int c = wg - 1, warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 64 * c;                    // this warpgroup's rows
  const int ra = r0 + 16 * warp + lane / 4;      // this thread's: ra, ra + 8
  const float sl2 = scale * LOG2E;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(qbar, 0);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, s = i % STAGES, k0 = t * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    // no live pair for these 64 rows: past S, every key after the last
    // row, or every key behind the first row's window
    const bool dead = r0 >= S || k0 > r0 + 63 ||
                      (window > 0 && r0 - (k0 + BK - 1) >= window);
    if (!dead) {
      const uint8_t* Kt = Ks + s * KB;
      const uint8_t* Vt = Vs + s * KB;
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = 0.f;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MMA<BK>::ss(sc, kdesc<D>(Qs, BQ, 64 * c, kk), kdesc<D>(Kt, BK, 0, kk),
                    1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      // only the diagonal tile and the window's edge tile hold dead pairs
      const bool edge = k0 + BK - 1 > r0 ||
                        (window > 0 && r0 + 63 - k0 >= window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ra + 8 * (e >> 1);
            const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            if (col > row || (window > 0 && row - col >= window))
              sc[4 * j + e] = -INFINITY;
          }
      }
      float mx[2] = {m[0], m[1]}, msc[2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        msc[r] = mx[r] == -INFINITY ? 0.f : mx[r] * sl2;
        const float corr = exp2f(m[r] * sl2 - msc[r]);   // 0 from -inf
        m[r] = mx[r];
        l[r] *= corr;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j + 2 * r] *= corr;
          acc[4 * j + 2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        const int r = (j >> 1) & 1;
        sc[j] = exp2f(sc[j] * sl2 - msc[r]);
        l[r] += sc[j];
      }
      uint32_t pa[BK / 16][4];
      to_a<BK>(sc, pa);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        MMA<D>::rs(acc, pa[kk], mndesc<D>(Vt, BK, kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(pa);
    }
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    const float li = fmaxf(quad_sum(l[r]), 1e-30f), inv = 1.f / li;
    if (row >= S) continue;
    bf16* orow = o + b * so.b + h * so.h + (long long)row * so.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
    if (lane % 4 == 0)
      lse[((long long)b * H + h) * S + row] = m[r] * scale + logf(li);
  }
}

// delta = rowsum(do * o) in f32, one warp a row of (B, H, S)
template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o,
                             const bf16* __restrict__ dout,
                             float* __restrict__ delta, Strides so,
                             Strides sdo, int H, int S, long long rows) {
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32, s = (int)(r % S);
  const long long bh = r / S, b = bh / H;
  const int h = (int)(bh % H);
  const bf16* orow = o + b * so.b + h * so.h + (long long)s * so.s;
  const bf16* drow = dout + b * sdo.b + h * sdo.h + (long long)s * sdo.s;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(orow + c));
    const float2 d = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(drow + c));
    acc += a.x * d.x + a.y * d.y;
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[r] = acc;
}

// dq pass: a block owns 128 query rows of one (batch, query head), Q
// and dO resident, and streams K and V: S = Q K^T, dP = dO V^T, P from
// lse, dS = P (dP - delta), dQ += dS K.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mdo,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, Strides sdq, int H, int G, int S,
          int window, float scale) {
  constexpr int BQ = 128, BK = Cfg<D>::DQ_BK;
  constexpr uint32_t QB = BQ * D * 2, KB = BK * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align_1024(smem_raw);
  uint8_t* dOs = Qs + QB;
  uint8_t* Ks = dOs + QB;
  uint8_t* Vs = Ks + STAGES * KB;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + STAGES * KB);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / G, q0 = qt * BQ;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int t0 = k_begin / BK, t1 = (min(S, q0 + BQ) + BK - 1) / BK;
  init_barriers(full, STAGES, 1);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    reg_dealloc<24>();
    if (tid == 0) {
      mbar_expect_tx(qbar, 2 * QB);
      tma_tile<D>(Qs, &mq, qbar, BQ, h, q0, b);
      tma_tile<D>(dOs, &mdo, qbar, BQ, h, q0, b);
      for (int t = t0; t < t1; ++t) {
        const int i = t - t0, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * KB);
        tma_tile<D>(Ks + s * KB, &mk, &full[s], BK, hk, t * BK, b);
        tma_tile<D>(Vs + s * KB, &mv, &full[s], BK, hk, t * BK, b);
      }
    }
    return;
  }
  reg_alloc<240>();
  const int c = wg - 1, warp = tid / 32, lane = tid % 32;
  const int r0 = q0 + 64 * c;
  const int ra = r0 + 16 * warp + lane / 4;
  const float sl2 = scale * LOG2E;
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    const long long at = ((long long)b * H + h) * S + row;
    lse2[r] = row < S ? lse[at] * LOG2E : 0.f;
    del[r] = row < S ? delta[at] : 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(qbar, 0);
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, s = i % STAGES, k0 = t * BK;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const bool dead = r0 >= S || k0 > r0 + 63 ||
                      (window > 0 && r0 - (k0 + BK - 1) >= window);
    if (!dead) {
      const uint8_t* Kt = Ks + s * KB;
      const uint8_t* Vt = Vs + s * KB;
      float sc[BK / 2], dp[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) sc[j] = dp[j] = 0.f;
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MMA<BK>::ss(sc, kdesc<D>(Qs, BQ, 64 * c, kk), kdesc<D>(Kt, BK, 0, kk),
                    1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MMA<BK>::ss(dp, kdesc<D>(dOs, BQ, 64 * c, kk),
                    kdesc<D>(Vt, BK, 0, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);
      fence_regs(dp);
      const bool edge = k0 + BK - 1 > r0 ||
                        (window > 0 && r0 + 63 - k0 >= window);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, row = ra + 8 * r;
          const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const bool live = !edge || (col <= row &&
                                      (window <= 0 || row - col < window));
          const float p = live ? exp2f(sc[4 * j + e] * sl2 - lse2[r]) : 0.f;
          sc[4 * j + e] = p * (dp[4 * j + e] - del[r]);     // dS
        }
      uint32_t da[BK / 16][4];
      to_a<BK>(sc, da);
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        MMA<D>::rs(acc, da[kk], mndesc<D>(Kt, BK, kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(da);
    }
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = ra + 8 * r;
    if (row >= S) continue;
    bf16* drow = dq + b * sdq.b + h * sdq.h + (long long)row * sdq.s;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                acc[4 * j + 2 * r + 1] * scale);
  }
}

// dk/dv pass: a block owns 128 keys of one (batch, KV head) and a slice
// of its G query heads; each consumer warpgroup takes 64 keys, with K
// and V resident, and the producer warp streams Q, dO, lse and delta
// tiles of BQ queries: S^T = K Q^T, dP^T = V dO^T, P^T from lse,
// dS^T = P^T (dP^T - delta), dV += P^T dO, dK += dS^T Q (times the
// scale at the end). P^T and dS^T are the register A operands as they
// stand: no transposed staging. One slice writes dk and dv; several
// write f32 partials part[2][splits][B][Hkv][S][D].
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_tc_kernel(const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
            Strides sdv, int H, int G, int S, int window, float scale,
            int splits, float* __restrict__ part) {
  constexpr int BKV = 128, BQ = Cfg<D>::KV_BQ;
  constexpr uint32_t KVB = BKV * D * 2, QB = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + KVB;
  uint8_t* Qs = Vs + KVB;
  uint8_t* dOs = Qs + STAGES * QB;
  float* lse_s = reinterpret_cast<float*>(dOs + STAGES * QB);
  float* del_s = lse_s + STAGES * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(del_s + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  const int k0 = blockIdx.z * BKV;              // early keys have most rows
  const int hk = blockIdx.x / splits, slice = blockIdx.x % splits;
  const int b = blockIdx.y;
  // the query tiles that hold a live query of keys [k0, k0 + BKV), for
  // each query head of the slice
  const int q_end = window > 0 ? min(S, k0 + BKV - 1 + window) : S;
  const int t0 = k0 / BQ, nt = (q_end + BQ - 1) / BQ - t0;
  const int g0 = slice * G / splits, n = ((slice + 1) * G / splits - g0) * nt;
  init_barriers(full, STAGES, 32);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    reg_dealloc<24>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(kvbar, 2 * KVB);
        tma_tile<D>(Ks, &mk, kvbar, BKV, hk, k0, b);
        tma_tile<D>(Vs, &mv, kvbar, BKV, hk, k0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int h = hk * G + g0 + i / nt, q0 = (t0 + i % nt) * BQ;
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        const long long at = ((long long)b * H + h) * S;
        for (int j = tid; j < BQ; j += 32) {
          const int row = q0 + j;
          lse_s[s * BQ + j] = row < S ? lse[at + row] * LOG2E : 0.f;
          del_s[s * BQ + j] = row < S ? delta[at + row] : 0.f;
        }
        if (tid == 0) {
          mbar_expect_tx(&full[s], 2 * QB);
          tma_tile<D>(Qs + s * QB, &mq, &full[s], BQ, h, q0, b);
          tma_tile<D>(dOs + s * QB, &mdo, &full[s], BQ, h, q0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  reg_alloc<240>();
  const int c = wg - 1, warp = tid / 32, lane = tid % 32;
  const int kc = k0 + 64 * c;                    // this warpgroup's keys
  const int ka = kc + 16 * warp + lane / 4;      // this thread's: ka, ka + 8
  const float sl2 = scale * LOG2E;
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int q0 = (t0 + i % nt) * BQ, s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const bool dead = kc >= S || q0 + BQ - 1 < kc ||
                      (window > 0 && q0 - (kc + 63) >= window);
    if (!dead) {
      const uint8_t* Qt = Qs + s * QB;
      const uint8_t* dOt = dOs + s * QB;
      const float* ls = lse_s + s * BQ;
      const float* ds = del_s + s * BQ;
      float st[BQ / 2], dpt[BQ / 2];
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = dpt[j] = 0.f;
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MMA<BQ>::ss(st, kdesc<D>(Ks, BKV, 64 * c, kk),
                    kdesc<D>(Qt, BQ, 0, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MMA<BQ>::ss(dpt, kdesc<D>(Vs, BKV, 64 * c, kk),
                    kdesc<D>(dOt, BQ, 0, kk), 1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      fence_regs(dpt);
      const bool edge = kc + 63 > q0 || q0 + BQ > S ||
                        (window > 0 && q0 + BQ - 1 - kc >= window);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = ka + 8 * (e >> 1);
          const int col = 8 * j + 2 * (lane % 4) + (e & 1), qpos = q0 + col;
          const bool live = !edge || (qpos < S && key <= qpos &&
                                      (window <= 0 || qpos - key < window));
          const float p = live ? exp2f(st[4 * j + e] * sl2 - ls[col]) : 0.f;
          st[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - ds[col]);
        }
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
      to_a<BQ>(st, pa);
      to_a<BQ>(dpt, da);
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        MMA<D>::rs(dva, pa[kk], mndesc<D>(dOt, BQ, kk));
        MMA<D>::rs(dka, da[kk], mndesc<D>(Qt, BQ, kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(dva);
      fence_regs(dka);
      fence_regs(pa);
      fence_regs(da);
    }
    mbar_arrive(&empty[s]);
  }
  const long long nel = (long long)gridDim.y * (H / G) * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = ka + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float k_lo = dka[4 * j + 2 * r] * scale;
      const float k_hi = dka[4 * j + 2 * r + 1] * scale;
      const float v_lo = dva[4 * j + 2 * r], v_hi = dva[4 * j + 2 * r + 1];
      if (part == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(
            dk + b * sdk.b + hk * sdk.h + (long long)key * sdk.s + col) =
            __floats2bfloat162_rn(k_lo, k_hi);
        *reinterpret_cast<__nv_bfloat162*>(
            dv + b * sdv.b + hk * sdv.h + (long long)key * sdv.s + col) =
            __floats2bfloat162_rn(v_lo, v_hi);
      } else {
        float* krow = part + slice * nel +
                      (((long long)b * (H / G) + hk) * S + key) * D + col;
        *reinterpret_cast<float2*>(krow) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(krow + splits * nel) =
            make_float2(v_lo, v_hi);
      }
    }
  }
}

// named barrier `id` over `count` threads (a multiple of 32): arrive and
// go on, or arrive and wait for the rest
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// dk/dv pass at head_dim 256, where one warpgroup cannot hold both
// (64, D) f32 accumulators (2 x 128 registers a thread): a block owns 64
// keys of one (batch, KV head) and a slice of its G query heads, and its
// two consumer warpgroups split the work by output. The first ("V")
// computes S^T = K Q^T and P^T from lse, hands P^T to the second through
// shared memory (f32, in its accumulator fragment's order, so each
// thread reads back what the same thread of the other warpgroup wrote)
// and accumulates dV += P^T dO; the second ("K") computes dP^T = V dO^T,
// waits for P^T on a named barrier, forms dS^T = P^T (dP^T - delta) and
// accumulates dK += dS^T Q. Each issues two of a tile's four products.
// P^T has a buffer a ring stage: the producer refills stage s only after
// both warpgroups released it, so "V" never overwrites a P^T that "K"
// has not read. One slice writes dk and dv; several write f32 partials
// part[2][splits][B][Hkv][S][D].
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkdv_split_kernel(const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv,
            const __grid_constant__ CUtensorMap mq,
            const __grid_constant__ CUtensorMap mdo,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sdk,
            Strides sdv, int H, int G, int S, int window, float scale,
            int splits, float* __restrict__ part) {
  constexpr int BKV = Cfg<D>::KV_BK, BQ = Cfg<D>::KV_BQ;
  static_assert(BKV == 64, "one 64-row tile of keys a block");
  constexpr uint32_t KVB = BKV * D * 2, QB = BQ * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align_1024(smem_raw);
  uint8_t* Vs = Ks + KVB;
  uint8_t* Qs = Vs + KVB;
  uint8_t* dOs = Qs + STAGES * QB;
  float* Ps = reinterpret_cast<float*>(dOs + STAGES * QB);  // [STAGES][BQ / 2][128]
  float* lse_s = Ps + STAGES * BQ / 2 * 128;
  float* del_s = lse_s + STAGES * BQ;
  uint64_t* full = reinterpret_cast<uint64_t*>(del_s + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  const int k0 = blockIdx.z * BKV;              // early keys have most rows
  const int hk = blockIdx.x / splits, slice = blockIdx.x % splits;
  const int b = blockIdx.y;
  // the query tiles that hold a live query of keys [k0, k0 + 64)
  const int q_last = window > 0 ? min(S, k0 + BKV - 1 + window) : S;
  const int tq0 = k0 / BQ, ntq = (q_last + BQ - 1) / BQ - tq0;
  const int g0 = slice * G / splits, n = ((slice + 1) * G / splits - g0) * ntq;
  init_barriers(full, STAGES, 32);
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    reg_dealloc<24>();
    if (tid < 32) {
      if (tid == 0) {
        mbar_expect_tx(kvbar, 2 * KVB);
        tma_tile<D>(Ks, &mk, kvbar, BKV, hk, k0, b);
        tma_tile<D>(Vs, &mv, kvbar, BKV, hk, k0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int h = hk * G + g0 + i / ntq, q0 = (tq0 + i % ntq) * BQ;
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        const long long at = ((long long)b * H + h) * S;
        for (int j = tid; j < BQ; j += 32) {
          const int row = q0 + j;
          lse_s[s * BQ + j] = row < S ? lse[at + row] * LOG2E : 0.f;
          del_s[s * BQ + j] = row < S ? delta[at + row] : 0.f;
        }
        if (tid == 0) {
          mbar_expect_tx(&full[s], 2 * QB);
          tma_tile<D>(Qs + s * QB, &mq, &full[s], BQ, h, q0, b);
          tma_tile<D>(dOs + s * QB, &mdo, &full[s], BQ, h, q0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
    return;
  }
  reg_alloc<240>();
  const bool v_half = wg == 1;                   // else the dK warpgroup
  const int warp = tid / 32, lane = tid % 32;
  const int ka = k0 + 16 * warp + lane / 4;      // this thread's: ka, ka + 8
  const float sl2 = scale * LOG2E;
  float acc[D / 2];                              // dV or dK
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int q0 = (tq0 + i % ntq) * BQ, s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const bool no_pair = k0 >= S || q0 + BQ - 1 < k0 ||
                         (window > 0 && q0 - (k0 + 63) >= window);
    if (!no_pair) {
      const uint8_t* Qt = Qs + s * QB;
      const uint8_t* dOt = dOs + s * QB;
      const float* ls = lse_s + s * BQ;
      const float* ds = del_s + s * BQ;
      float* Pt = Ps + s * BQ / 2 * 128;
      float st[BQ / 2];                          // S^T, or dP^T
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) st[j] = 0.f;
      fence_regs(st);
      wgmma_fence();
      const uint8_t* lhs = v_half ? Ks : Vs;
      const uint8_t* rhs = v_half ? Qt : dOt;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        MMA<BQ>::ss(st, kdesc<D>(lhs, BKV, 0, kk), kdesc<D>(rhs, BQ, 0, kk),
                    1);
      wgmma_commit();
      wgmma_wait();
      fence_regs(st);
      if (v_half) {
        const bool edge = k0 + 63 > q0 || q0 + BQ > S ||
                          (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = ka + 8 * (e >> 1);
            const int col = 8 * j + 2 * (lane % 4) + (e & 1), qpos = q0 + col;
            const bool live = !edge || (qpos < S && key <= qpos &&
                                        (window <= 0 || qpos - key < window));
            const float p = live ? exp2f(st[4 * j + e] * sl2 - ls[col]) : 0.f;
            st[4 * j + e] = p;
            Pt[(4 * j + e) * 128 + tid] = p;
          }
        bar_arrive(1, 256);                      // P^T is in shared memory
      } else {
        bar_sync(1, 256);
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * j + 2 * (lane % 4) + (e & 1);
            st[4 * j + e] = Pt[(4 * j + e) * 128 + tid] *
                            (st[4 * j + e] - ds[col]);   // dS^T
          }
      }
      uint32_t pa[BQ / 16][4];
      to_a<BQ>(st, pa);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      const uint8_t* rows = v_half ? dOt : Qt;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        MMA<D>::rs(acc, pa[kk], mndesc<D>(rows, BQ, kk));
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(pa);
    }
    mbar_arrive(&empty[s]);
  }
  const long long nel = (long long)gridDim.y * (H / G) * S * D;
  const float mul = v_half ? 1.f : scale;
  bf16* out = v_half ? dv : dk;
  const Strides so = v_half ? sdv : sdk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = ka + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float lo = acc[4 * j + 2 * r] * mul;
      const float hi = acc[4 * j + 2 * r + 1] * mul;
      if (part == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + b * so.b + hk * so.h + (long long)key * so.s + col) =
            __floats2bfloat162_rn(lo, hi);
      } else {
        float* row = part + (v_half ? splits * nel : 0) + slice * nel +
                     (((long long)b * (H / G) + hk) * S + key) * D + col;
        *reinterpret_cast<float2*>(row) = make_float2(lo, hi);
      }
    }
  }
}

// ---- host side: tensor maps and launches ----

constexpr int ERR_ENCODE = 10000;   // + the CUresult of a refused map
constexpr int ERR_NO_ENCODE = 20000;

// the 4-D map (D, H, S, B) of a bf16 tensor with (b, h, s) element
// strides st, boxes of (AW, 1, rows, 1); 0 or an error code
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int B, int H, int S,
             const long long* st, int rows) {
  using C = Cfg<D>;
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return ERR_NO_ENCODE;
  // a dimension of size 1 is never stepped: any legal stride will do
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {
      H > 1 ? (cuuint64_t)st[1] * 2 : (cuuint64_t)D * 2,
      S > 1 ? (cuuint64_t)st[2] * 2 : (cuuint64_t)D * 2,
      B > 1 ? (cuuint64_t)st[0] * 2 : (cuuint64_t)D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::AW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

template <typename K>
cudaError_t set_smem(K* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr size_t BARRIER_BYTES = (2 * STAGES + 1) * 8;

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Hq, int Hkv, int S, const long long* st,
               int window, float scale, cudaStream_t stream) {
  constexpr int BK = Cfg<D>::FWD_BK;
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = make_map<D>(&mq, q, B, Hq, S, st, 128)) ||
      (e = make_map<D>(&mk, k, B, Hkv, S, st + 3, BK)) ||
      (e = make_map<D>(&mv, v, B, Hkv, S, st + 6, BK)))
    return e;
  const size_t smem = 1024 + (size_t)(128 + 2 * STAGES * BK) * D * 2 +
                      BARRIER_BYTES;
  cudaError_t err = set_smem(flash_fwd_tc_kernel<D, BK>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_tc_kernel<D, BK>
      <<<dim3(Hq, B, (S + 127) / 128), THREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)o, lse, strides_at(st, 3), Hq, Hq / Hkv, S, window,
      scale);
  return cudaGetLastError();
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int B, int Hq, int Hkv, int S,
               const long long* st, int window, float scale, int splits,
               float* part, cudaStream_t stream) {
  using C = Cfg<D>;
  // strides: q, k, v, o, do, dq, dk, dv. The dq pass takes Q and dO in
  // boxes of 128 rows and K and V in DQ_BK, the dk/dv pass K and V in
  // KV_BK and Q and dO in KV_BQ: where the two agree (at head_dim 64)
  // both passes take the same maps
  CUtensorMap mq, mdo, mk, mv, mk2, mv2, mq2, mdo2;
  int e;
  if ((e = make_map<D>(&mq, q, B, Hq, S, st, 128)) ||
      (e = make_map<D>(&mdo, dout, B, Hq, S, st + 12, 128)) ||
      (e = make_map<D>(&mk, k, B, Hkv, S, st + 3, C::DQ_BK)) ||
      (e = make_map<D>(&mv, v, B, Hkv, S, st + 6, C::DQ_BK)))
    return e;
  if constexpr (C::DQ_BK == C::KV_BK) {
    mk2 = mk;
    mv2 = mv;
  } else if ((e = make_map<D>(&mk2, k, B, Hkv, S, st + 3, C::KV_BK)) ||
             (e = make_map<D>(&mv2, v, B, Hkv, S, st + 6, C::KV_BK))) {
    return e;
  }
  if constexpr (C::KV_BQ == 128) {
    mq2 = mq;
    mdo2 = mdo;
  } else if ((e = make_map<D>(&mq2, q, B, Hq, S, st, C::KV_BQ)) ||
             (e = make_map<D>(&mdo2, dout, B, Hq, S, st + 12, C::KV_BQ))) {
    return e;
  }
  const size_t smem_dq = 1024 +
                         (size_t)(2 * 128 + 2 * STAGES * C::DQ_BK) * D * 2 +
                         BARRIER_BYTES;
  // the split kernel (D 256) adds a P^T buffer a stage, 64 x KV_BQ f32
  constexpr bool split = C::KV_BK == 64;
  const size_t smem_kv = 1024 +
                         (size_t)(2 * C::KV_BK + 2 * STAGES * C::KV_BQ) * D * 2 +
                         2 * STAGES * C::KV_BQ * 4 +
                         (split ? STAGES * 64 * C::KV_BQ * 4 : 0) +
                         BARRIER_BYTES;
  decltype(&flash_bwd_dkdv_tc_kernel<D>) dkdv_kernel;
  if constexpr (split)
    dkdv_kernel = flash_bwd_dkdv_split_kernel<D>;
  else
    dkdv_kernel = flash_bwd_dkdv_tc_kernel<D>;
  cudaError_t err = set_smem(flash_bwd_dq_tc_kernel<D>, smem_dq);
  if (err == cudaSuccess) err = set_smem(dkdv_kernel, smem_kv);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * Hq * S;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const bf16*)o, (const bf16*)dout, delta, strides_at(st, 3),
      strides_at(st, 4), Hq, S, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  flash_bwd_dq_tc_kernel<D>
      <<<dim3(Hq, B, (S + 127) / 128), THREADS, smem_dq, stream>>>(
      mq, mdo, mk, mv, lse, delta, (bf16*)dq, strides_at(st, 5), Hq, G, S,
      window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<dim3(Hkv * splits, B, (S + C::KV_BK - 1) / C::KV_BK), THREADS,
                smem_kv, stream>>>(
      mk2, mv2, mq2, mdo2, lse, delta, (bf16*)dk, (bf16*)dv, strides_at(st, 6),
      strides_at(st, 7), Hq, G, S, window, scale, splits,
      splits > 1 ? part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long nel = (long long)B * Hkv * S * D;
  long long blocks = (2 * nel + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  flash_bwd_sum_kernel<bf16><<<(int)blocks, 256, 0, stream>>>(
      part, (bf16*)dk, (bf16*)dv, strides_at(st, 6), strides_at(st, 7), Hkv,
      S, D, splits, nel);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// bf16 at head_dim 64, 128, 160 and 256 takes the tensor-core kernels;
// f32 at head_dim 16, 64, 128 and 160 the FMA kernels; anything else is
// refused (cudaErrorInvalidValue)
#define FA_DISPATCH(TC_CALL, F32_CALL)                                 \
  if (is_bf16) {                                                       \
    if (D == 64) return TC_CALL(64);                                   \
    if (D == 128) return TC_CALL(128);                                 \
    if (D == 160) return TC_CALL(160);                                 \
    if (D == 256) return TC_CALL(256);                                 \
  } else {                                                             \
    if (D == 16) return (int)F32_CALL(16);                             \
    if (D == 64) return (int)F32_CALL(64);                             \
    if (D == 128) return (int)F32_CALL(128);                           \
    if (D == 160) return (int)F32_CALL(160);                           \
  }                                                                    \
  return (int)cudaErrorInvalidValue;

// q/k/v/o with (b, h, s) element strides in st[0..11]; lse (B, Hq, S)
// contiguous f32. Returns cudaGetLastError() after the launch, or an
// error code of the tensor maps (flash_attention_error_string).
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int is_bf16, int B, int Hq, int Hkv, int S, int D, const long long* st,
    int window, float scale, void* stream) {
#define FA_TC(D_)                                                       \
  tc::launch_fwd<D_>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, \
                     (cudaStream_t)stream)
#define FA_F32(D_)                                                      \
  launch_fwd<D_>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale,    \
                 (cudaStream_t)stream)
  FA_DISPATCH(FA_TC, FA_F32)
#undef FA_TC
#undef FA_F32
}

// q, k, v, o, do, dq, dk, dv with (b, h, s) element strides in
// st[0..23]; lse and delta (B, Hq, S) contiguous f32 (delta is written
// first and read by the dk/dv pass). The dk/dv pass splits each group's
// G query heads into `splits` (1..G) slices, one block each; with more
// than one, `part` is f32 [2][splits][B][Hkv][S][D] scratch and a third
// kernel sums it. In order on the stream. Returns cudaGetLastError()
// after the launches, or an error code of the tensor maps.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int is_bf16, int B, int Hq, int Hkv, int S, int D,
    const long long* st, int window, float scale, int splits, float* part,
    void* stream) {
  if (splits < 1 || splits > Hq / Hkv || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
#define FA_TC(D_)                                                        \
  tc::launch_bwd<D_>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, \
                     S, st, window, scale, splits, part,                 \
                     (cudaStream_t)stream)
#define FA_F32(D_)                                                       \
  launch_bwd<D_>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv,  \
                 S, st, window, scale, splits, part, (cudaStream_t)stream)
  FA_DISPATCH(FA_TC, FA_F32)
#undef FA_TC
#undef FA_F32
}

// microseconds the host takes to encode one tensor map, over `reps`
// encodes of a bf16 (B, H, S, D) tensor with (b, h, s) strides st, as
// the forward's q map; negative if the CUDA driver refuses it
extern "C" double flash_attention_encode_us(const void* ptr, int B, int H,
                                            int S, int D,
                                            const long long* st, int reps) {
  CUtensorMap map;
  const auto start = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int e = D == 64    ? tc::make_map<64>(&map, ptr, B, H, S, st, 128)
                  : D == 128 ? tc::make_map<128>(&map, ptr, B, H, S, st, 128)
                  : D == 160 ? tc::make_map<160>(&map, ptr, B, H, S, st, 128)
                  : D == 256 ? tc::make_map<256>(&map, ptr, B, H, S, st, 128)
                             : -1;
    if (e) return -1.0;
  }
  const std::chrono::duration<double, std::micro> took =
      std::chrono::steady_clock::now() - start;
  return took.count() / reps;
}

extern "C" const char* flash_attention_error_string(int err) {
  static char msg[96];
  if (err == tc::ERR_NO_ENCODE)
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err >= tc::ERR_ENCODE) {
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled refused a map (CUresult %d)",
             err - tc::ERR_ENCODE);
    return msg;
  }
  return cudaGetErrorString((cudaError_t)err);
}
