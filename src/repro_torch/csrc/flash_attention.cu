// Flash attention for Hopper (sm_90a): causal GQA attention, optionally
// in a sliding window, forward and backward, with a plain C interface
// for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (forward only; the backward is the gradient of
// src/repro/kernels/ref.py::flash_attention_ref, for which the JAX
// package has no Pallas kernel). Layout as there: q (B, Hq, S, D), k and
// v (B, Hkv, S, D); query head h reads KV head h / G, G = Hq / Hkv. Any
// b/h/s strides, the D stride 1. Scores, softmax and every product run
// in f32 on the FMA units (inputs f32 or bf16, converted on their way
// into shared memory); o, dq, dk and dv are written in the input type,
// lse and delta in f32.
//
// Forward: one block per (q-tile of 64 rows, query head, batch). It
// loops over the 64-key tiles of its live range (the causal frontier
// and the window's oldest key bound the loop; tiles outside are never
// loaded), keeping the running max, sum and the (64, D) accumulator in
// registers. lse = m + log(max(l, 1e-30)) is kept for the backward.
//
// Backward (FlashAttention-2, deterministic, no atomics), P rebuilt from
// lse:
//   dq pass    one block per (q-tile, query head, batch): delta =
//              rowsum(do * o) for its rows (written out for the next
//              pass), then dq = scale * sum_j dS_ij k_j over its live
//              key tiles, dS = P * (dP - delta), dP = do v^T;
//   dk/dv pass one block per (kv-tile, KV head, batch) and slice of
//              the KV head's G query heads: loops over the heads of its
//              slice and their live q-tiles, dv = sum_i P_ij do_i,
//              dk = sum_i dS_ij (scale q_i). With one slice (the caller
//              picks enough slices to give the SMs two blocks each, as
//              MQA's few KV heads need) the block writes dk and dv; with
//              more, f32 partials that a third kernel sums in slice
//              order. No atomics: the sums are deterministic.
//
// Threads of a tile: 8 across its 64 columns (column tx + 8 j), the rest
// down its rows (RT consecutive rows each), so the 8 lanes that share a
// row are neighbours in one warp and reduce with shuffles. Shared rows
// are padded to D + 1 and 65 floats to keep the lanes on distinct banks.
//
// Bound on an H100 SXM: 4 D flops a live (q, k) pair forward, 10 D
// backward, against 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32);
// at the model's shapes the operations bound it, not the bytes. This
// first version runs on the f32 FMA units (67 TFLOP/s at best), reads
// its tiles without cp.async or TMA and keeps one to three blocks a SM,
// so it cannot come near the tensor-core bound: wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + ROWS) of one head into shared f32 [ROWS][D + 1],
// times mul; rows at or past S are zero
template <typename T, int D, int ROWS>
__device__ void load_tile(float* dst, const T* src, long long stride_s,
                          int row0, int S, float mul) {
  for (int i = threadIdx.x; i < ROWS * D; i += blockDim.x) {
    const int r = i / D, c = i % D, row = row0 + r;
    dst[r * (D + 1) + c] =
        row < S ? to_f32(src[(long long)row * stride_s + c]) * mul : 0.f;
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

template <typename T, int D>
__global__ void __launch_bounds__(BQ / 4 * TX)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  load_tile<T, D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);

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
    load_tile<T, D, BK>(Ks, kh, sk.s, k0, S, 1.f);
    load_tile<T, D, BK>(Vs, vh, sv.s, k0, S, 1.f);
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
    T* orow = o + b * so.b + h * so.h + (long long)row * so.s;
#pragma unroll
    for (int c = 0; c < DW; ++c) store(orow + tx + TX * c, acc[i][c] / li);
    if (tx == 0) lse[((long long)b * H + h) * S + row] = m[i] + logf(li);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ / 4 * TX)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    float* __restrict__ delta, T* __restrict__ dq,
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
  const T* kh = k + b * sk.b + hk * sk.h;
  const T* vh = v + b * sv.b + hk * sv.h;
  const T* oh = o + b * so.b + h * so.h;
  const long long rows = ((long long)b * H + h) * S;
  load_tile<T, D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
  load_tile<T, D, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
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
                to_f32(oh[(long long)row * so.s + tx + TX * c]);
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
    load_tile<T, D, BK>(Ks, kh, sk.s, k0, S, 1.f);
    load_tile<T, D, BK>(Vs, vh, sv.s, k0, S, 1.f);
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
    T* drow = dq + b * sdq.b + h * sdq.h + (long long)row * sdq.s;
#pragma unroll
    for (int c = 0; c < DW; ++c) store(drow + tx + TX * c, acc[i][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(BK / 2 * TX)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Strides sq, Strides sk,
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
  load_tile<T, D, BK>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S, 1.f);
  load_tile<T, D, BK>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S, 1.f);

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
      load_tile<T, D, BQ>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S, scale);
      load_tile<T, D, BQ>(dOs, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S,
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
      T* krow = dk + b * sdk.b + hk * sdk.h + (long long)row * sdk.s;
      T* vrow = dv + b * sdv.b + hk * sdv.h + (long long)row * sdv.s;
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

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int Hq, int Hkv, int S,
                       const long long* st, int window, float scale,
                       cudaStream_t stream) {
  constexpr int LD = D + 1;
  const size_t smem = (size_t)(BQ * LD + 2 * BK * LD + BQ * LDP) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, BQ / 4 * TX, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3), Hq,
      Hq / Hkv, S, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
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
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_kv);
  if (err != cudaSuccess) return err;
  const int G = Hq / Hkv;
  // strides: q, k, v, o, do, dq, dk, dv
  flash_bwd_dq_kernel<T, D><<<dim3((S + BQ - 1) / BQ, Hq, B), BQ / 4 * TX,
                              smem_dq, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      lse, delta, (T*)dq, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 3), strides_at(st, 4),
      strides_at(st, 5), Hq, G, S, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((S + BK - 1) / BK, Hkv * splits, B),
                                BK / 2 * TX, smem_kv, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
      (T*)dk, (T*)dv, strides_at(st, 0), strides_at(st, 1),
      strides_at(st, 2), strides_at(st, 4), strides_at(st, 6),
      strides_at(st, 7), Hq, G, S, window, scale, splits,
      splits > 1 ? part : nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = (long long)B * Hkv * S * D;
  long long blocks = (2 * n + 255) / 256;
  if (blocks > 4096) blocks = 4096;      // the kernel strides the rest
  flash_bwd_sum_kernel<T><<<(int)blocks, 256, 0, stream>>>(
      part, (T*)dk, (T*)dv, strides_at(st, 6), strides_at(st, 7), Hkv, S, D,
      splits, n);
  return cudaGetLastError();
}

}  // namespace

#define FA_DISPATCH(D_, CALL)                                          \
  if (D == D_) {                                                       \
    err = is_bf16 ? CALL(__nv_bfloat16, D_) : CALL(float, D_);         \
  }

// q/k/v/o with (b, h, s) element strides in st[0..11]; lse (B, Hq, S)
// contiguous f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int is_bf16, int B, int Hq, int Hkv, int S, int D, const long long* st,
    int window, float scale, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
#define FA_FWD(T, D_)                                                  \
  launch_fwd<T, D_>(q, k, v, o, lse, B, Hq, Hkv, S, st, window, scale, \
                    (cudaStream_t)stream)
  FA_DISPATCH(16, FA_FWD)
  FA_DISPATCH(64, FA_FWD)
  FA_DISPATCH(128, FA_FWD)
  FA_DISPATCH(160, FA_FWD)
#undef FA_FWD
  return (int)err;
}

// q, k, v, o, do, dq, dk, dv with (b, h, s) element strides in
// st[0..23]; lse and delta (B, Hq, S) contiguous f32 (delta is written
// by the dq pass and read by the dk/dv pass). The dk/dv pass splits
// each group's G query heads into `splits` (1..G) slices, one block
// each; with more than one, `part` is f32 [2][splits][B][Hkv][S][D]
// scratch and a third kernel sums it. In order on the stream. Returns
// cudaGetLastError() after the launches.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int is_bf16, int B, int Hq, int Hkv, int S, int D,
    const long long* st, int window, float scale, int splits, float* part,
    void* stream) {
  if (splits < 1 || splits > Hq / Hkv || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaErrorInvalidValue;
#define FA_BWD(T, D_)                                                   \
  launch_bwd<T, D_>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, \
                    S, st, window, scale, splits, part, (cudaStream_t)stream)
  FA_DISPATCH(16, FA_BWD)
  FA_DISPATCH(64, FA_BWD)
  FA_DISPATCH(128, FA_BWD)
  FA_DISPATCH(160, FA_BWD)
#undef FA_BWD
  return (int)err;
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
