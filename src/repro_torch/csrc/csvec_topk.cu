// Count-sketch heavy-hitter search for Hopper (sm_90a): the top-k
// coordinates of the sketched vector by |median-of-r estimate|.
//
// Replaces the TPU kernel src/repro/kernels/csvec_topk.py::csvec_topk (its
// pallas_call). For a table (r, c) f32, c a power of two, hash coefficients
// (a_b, b_b, a_s, b_s) per row and a dimension D, coordinate i < D has the
// estimate
//
//   est(i) = median_j  s_j(i) table[j, h_j(i)]
//
// with the multiply-shift hashes of csvec_insert.cu. The median is an
// odd-even transposition network; for even r it is the midpoint
// (lo + hi) * 0.5, as jnp.median takes it. The result is the k coordinates
// first in the order (|est| descending, index ascending), in that order,
// with their signed estimates: exactly the reference's lax.top_k, ties
// included.
//
// Bound on an H100 SXM. The function reads the table (4 r c bytes) and
// writes 12 k bytes: at the LM train step's geometry (r = 5, c = 2^23,
// D = 1,100,048,384, k = 256 or 512) 168 MB, 0.050 ms at 3.35 TB/s. Its
// f32 work is larger: per coordinate r sign products, r (r - 1) / 2
// compare-exchanges of the median network and an absolute value, 26
// operations at r = 5, 2.9e10 in all, 0.43 ms at 67 TFLOP/s, so the bound
// is set by operations (the integer hash arithmetic is not counted: the
// data sheet gives no integer rate). Both hide what the data needs: r D =
// 5.5e9 gathers at random buckets of a table three times the 50 MB L2,
// each a 32-byte sector when it misses, up to 176 GB and 52.5 ms.
//
// Design. The TPU kernel sweeps chunks in grid order, gathering through a
// one-hot (chunk, c) matmul and keeping a running top-k in its output
// block. Blocks here run in no order, so the search takes two passes:
//   1. each of up to 4 blocks an SM sweeps its own range of coordinates,
//      256 at a time, computing the estimates in registers. A coordinate
//      that beats the block's current kp-th best (kp = k rounded up to a
//      power of two) is appended to a candidate area of a shared-memory
//      buffer of nb entries; when the next tile might overflow it, a
//      bitonic sort of the whole buffer by (|est| desc, index asc) folds
//      the candidates into the best kp, and raises the threshold. Each
//      block writes its best kp to scratch;
//   2. one block streams the blocks' lists through the same buffer and
//      writes the first k.
// The global top k lies in the union of the blocks' best kp >= k, so the
// result is exact. Sentinels (-inf, INT_MAX) pad every buffer and never
// win. k <= 1024 (checked by the wrapper).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 8;

struct Hash {
  uint32_t ab[MAX_ROWS], bb[MAX_ROWS], as[MAX_ROWS], bs[MAX_ROWS];
};

__device__ __forceinline__ bool better(float m1, int i1, float m2, int i2) {
  return m1 > m2 || (m1 == m2 && i1 < i2);
}

// nb entries in shared memory: [0, kp) the best so far, sorted; from kp on,
// the candidates appended since the last fold, then sentinels.
struct Buf {
  float* mag;
  float* val;
  int* idx;
  int kp;
  int nb;
};

__device__ __forceinline__ void set_sentinel(Buf b, int t) {
  b.mag[t] = -INFINITY;
  b.val[t] = 0.f;
  b.idx[t] = INT_MAX;
}

__device__ void init_buf(Buf b, int* count, float* thr_mag, int* thr_idx) {
  for (int t = threadIdx.x; t < b.nb; t += THREADS) set_sentinel(b, t);
  if (threadIdx.x == 0) {
    *count = 0;
    *thr_mag = -INFINITY;
    *thr_idx = INT_MAX;
  }
  __syncthreads();
}

__device__ __forceinline__ void push(Buf b, int* count, float mag, int idx,
                                     float val) {
  const int slot = b.kp + atomicAdd(count, 1);
  b.mag[slot] = mag;
  b.val[slot] = val;
  b.idx[slot] = idx;
}

// Bitonic sort of all nb entries, best first. Every thread of the block.
__device__ void bitonic_sort_desc(Buf b) {
  for (int size = 2; size <= b.nb; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < b.nb / 2; t += THREADS) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const bool swap =
            desc ? better(b.mag[hi], b.idx[hi], b.mag[lo], b.idx[lo])
                 : better(b.mag[lo], b.idx[lo], b.mag[hi], b.idx[hi]);
        if (swap) {
          const float m = b.mag[lo], v = b.val[lo];
          const int i = b.idx[lo];
          b.mag[lo] = b.mag[hi];
          b.val[lo] = b.val[hi];
          b.idx[lo] = b.idx[hi];
          b.mag[hi] = m;
          b.val[hi] = v;
          b.idx[hi] = i;
        }
      }
      __syncthreads();
    }
  }
}

// Whether the next tile might overflow the candidate area. Every thread of
// the block; the second barrier keeps the next tile's pushes after every
// thread's read of the count.
__device__ __forceinline__ bool must_fold(Buf b, const int* count) {
  __syncthreads();
  const bool full = *count > b.nb - b.kp - THREADS;
  __syncthreads();
  return full;
}

// Folds the candidates into the best kp and raises the threshold to the
// kp-th best. Every thread of the block, after a __syncthreads.
__device__ void fold(Buf b, int* count, float* thr_mag, int* thr_idx) {
  bitonic_sort_desc(b);
  for (int t = b.kp + threadIdx.x; t < b.nb; t += THREADS) set_sentinel(b, t);
  if (threadIdx.x == 0) {
    *count = 0;
    *thr_mag = b.mag[b.kp - 1];
    *thr_idx = b.idx[b.kp - 1];
  }
  __syncthreads();
}

template <int R>
__device__ __forceinline__ float estimate(const float* __restrict__ table,
                                          int cols, int shift,
                                          const Hash& h, uint32_t u) {
  float e[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const uint32_t b = shift >= 32 ? 0u : (h.ab[j] * u + h.bb[j]) >> shift;
    const uint32_t s = (h.as[j] * u + h.bs[j]) >> 31;
    const float t = __ldg(table + (size_t)j * cols + b);
    e[j] = s ? -t : t;
  }
#pragma unroll
  for (int rnd = 0; rnd < R; ++rnd) {
#pragma unroll
    for (int j = rnd & 1; j < R - 1; j += 2) {
      const float a = e[j], c = e[j + 1];
      e[j] = fminf(a, c);
      e[j + 1] = fmaxf(a, c);
    }
  }
  if constexpr (R & 1) {
    return e[R / 2];
  } else {
    return __fmul_rn(__fadd_rn(e[R / 2 - 1], e[R / 2]), 0.5f);
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS)
    topk_pass1(const float* __restrict__ table, int cols, int shift, Hash h,
               long long dim, long long per_block, int kp, int nb,
               float* __restrict__ out_mag, float* __restrict__ out_val,
               int* __restrict__ out_idx) {
  extern __shared__ float smem[];
  const Buf b{smem, smem + nb, reinterpret_cast<int*>(smem + 2 * nb), kp, nb};
  __shared__ int count, thr_idx;
  __shared__ float thr_mag;
  init_buf(b, &count, &thr_mag, &thr_idx);
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = min(dim, start + per_block);
  for (long long base = start; base < end; base += THREADS) {
    const long long i = base + threadIdx.x;
    if (i < end) {
      const float est = estimate<R>(table, cols, shift, h, (uint32_t)i);
      const float mag = fabsf(est);
      if (better(mag, (int)i, thr_mag, thr_idx))
        push(b, &count, mag, (int)i, est);
    }
    if (must_fold(b, &count)) fold(b, &count, &thr_mag, &thr_idx);
  }
  if (count > 0) fold(b, &count, &thr_mag, &thr_idx);
  for (int t = threadIdx.x; t < kp; t += THREADS) {
    const size_t o = (size_t)blockIdx.x * kp + t;
    out_mag[o] = b.mag[t];
    out_val[o] = b.val[t];
    out_idx[o] = b.idx[t];
  }
}

__global__ void __launch_bounds__(THREADS)
    topk_pass2(const float* __restrict__ in_mag,
               const float* __restrict__ in_val,
               const int* __restrict__ in_idx, int n_in, int kp, int nb,
               int k, float* __restrict__ out_val,
               long long* __restrict__ out_idx) {
  extern __shared__ float smem[];
  const Buf b{smem, smem + nb, reinterpret_cast<int*>(smem + 2 * nb), kp, nb};
  __shared__ int count, thr_idx;
  __shared__ float thr_mag;
  init_buf(b, &count, &thr_mag, &thr_idx);
  for (int base = 0; base < n_in; base += THREADS) {
    const int t = base + threadIdx.x;
    if (t < n_in) {
      const float mag = in_mag[t];
      const int idx = in_idx[t];
      if (better(mag, idx, thr_mag, thr_idx))
        push(b, &count, mag, idx, in_val[t]);
    }
    if (must_fold(b, &count)) fold(b, &count, &thr_mag, &thr_idx);
  }
  if (count > 0) fold(b, &count, &thr_mag, &thr_idx);
  for (int t = threadIdx.x; t < k; t += THREADS) {
    out_val[t] = b.val[t];
    out_idx[t] = b.idx[t];
  }
}

template <int R>
void launch_pass1(const float* table, int cols, int shift, const Hash& h,
                  long long dim, long long per_block, int kp, int nb,
                  int blocks, size_t smem, cudaStream_t s, float* s_mag,
                  float* s_val, int* s_idx) {
  topk_pass1<R><<<blocks, THREADS, smem, s>>>(
      table, cols, shift, h, dim, per_block, kp, nb, s_mag, s_val, s_idx);
}

}  // namespace

extern "C" {

// Top-k of the sketched vector on `stream`. `coeffs` holds 4 * rows uint32
// (a_b row, b_b row, a_s row, b_s row); kp is a power of two >= k, nb a
// power of two >= kp + 2 * 256; the scratch holds blocks * kp entries.
// Returns cudaGetLastError() as an int (0 on success).
int csvec_topk_launch(const float* table, int rows, int cols, int shift,
                      const uint32_t* coeffs, long long dim, int k, int kp,
                      int nb, int blocks, long long per_block, float* s_mag,
                      float* s_val, int* s_idx, float* out_val,
                      long long* out_idx, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || kp < k || nb < kp + 2 * THREADS)
    return (int)cudaErrorInvalidValue;
  Hash h = {};
  for (int j = 0; j < rows; ++j) {
    h.ab[j] = coeffs[j];
    h.bb[j] = coeffs[rows + j];
    h.as[j] = coeffs[2 * rows + j];
    h.bs[j] = coeffs[3 * rows + j];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)nb * (2 * sizeof(float) + sizeof(int));
  switch (rows) {
#define PASS1(R)                                                         \
  case R:                                                                \
    launch_pass1<R>(table, cols, shift, h, dim, per_block, kp, nb,       \
                    blocks, smem, s, s_mag, s_val, s_idx);               \
    break;
    PASS1(1) PASS1(2) PASS1(3) PASS1(4) PASS1(5) PASS1(6) PASS1(7) PASS1(8)
#undef PASS1
  }
  topk_pass2<<<1, THREADS, smem, s>>>(s_mag, s_val, s_idx, blocks * kp, kp,
                                      nb, k, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}

const char* csvec_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
