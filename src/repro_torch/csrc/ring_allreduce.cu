// Quantisation-aware chain all-reduce of W workers' flat f32 buffers, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ring_allreduce.py::ring_allreduce
// (its pallas_call), a remote-DMA chain between W chips: chunk c of
// ceil(N / W) elements (rounded up to 128, zero past N) is folded in device
// order 0..W-1 along the chain, then broadcast back. Here the W workers of
// the data-parallel step live in one process on one card, so the W shard
// rows x[0..W-1] lie side by side in one memory. Nothing has to travel, and
// this kernel computes the chain's result, not its wire: the fold, per
// element and in device order. The transport across cards, whose hops go
// through peer memory, is a kernel of its own (ROADMAP A item 6).
//
// fp32 wire: y = x[0] + x[1] + ... + x[W-1], a left fold of IEEE adds
// (__fadd_rn), which is the chain's fold and the reference's psum order bit
// for bit. One launch: a thread loads 4 elements of every row (16 bytes a
// row where the rows are 16-byte aligned), folds them and writes y once, to
// row 0 or, with `replicas`, to every replica row.
//
// int8 wire: at fold point d the running sum s_d is requantised per chunk:
//   s_0 = x_0,  s_d = __fmaf_rn(q_{d-1}, sc_{d-1}, x_d)
//   sc_d = __fmul_rn(amax_chunk |s_d|, fl(1/127))
//   q_d  = clamp(rint(__fdiv_rn(s_d, safe)), -127, 127),  safe = sc_d or 1
//   res_d = __fmaf_rn(-q_d, sc_d, s_d),   y = __fmul_rn(q_{W-1}, sc_{W-1})
// the arithmetic of the reference's compiled oracle, every step an
// intrinsic so that nvcc cannot contract or reorder it. The chunks do not
// depend on one another, so every chunk's fold point d runs at once: W
// levels instead of the chain's 3W - 3 hops. A level needs each chunk's
// amax before it quantises, a reduction across blocks, so the amax of level
// d + 1 is taken by level d's launch: it computes s_{d+1} from the q_d and
// sc_d it has just made and folds max |s_{d+1}| in with atomicMax on the
// bits (|s| >= 0 orders as unsigned ints, a NaN above every number: exact
// and order-free). Between levels only the int8 codes (one byte an element,
// in place) and the W x W amax words are kept. Launches: a memset of the
// amax words, the amax of level 0, then one launch a level.
//
// NaN and inf follow the plain version bit for bit: every amax fold is a
// max over the bits of |s| (so a NaN in a chunk makes its amax and scale
// NaN, as torch's amax does), and the clamp keeps a NaN code NaN (as
// torch.clamp does) for y and the residual. A NaN code is kept as the int8
// code 0 between levels; its scale is then NaN or inf (a code is NaN only
// where s / safe is, so s is NaN or inf and so is the chunk's amax), and
// the next fold's 0 * sc is NaN as NaN * sc is.
//
// Bound on an H100 SXM (3.35 TB/s). The call reads the W shards once and
// writes y once (4 W N + 4 N bytes on the fp32 wire as the DP step calls
// it; 4 W N more for the W replica rows), and on the int8 wire also the W
// residual rows (8 W N + 4 N). At tinyllama-1.1b's fused dense wire (N =
// 1.109e9, W = 4) the fp32 call moves 22.2 GB, 6.62 ms. The fp32 kernel
// moves just that. The int8 kernel moves more: each level reads its row,
// the codes and the next row (for its amax) and writes the codes, 14 N
// bytes a level and 4 N for level 0's amax, about 14 W N in all.
//
// Offsets are 64-bit: the fused buffer holds W N = 4.4e9 elements.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

__device__ __forceinline__ bool aligned(long long n, long long idx) {
  return (n & 3) == 0 && idx + VEC <= n;
}

// row[idx .. idx + VEC), zero past n
__device__ __forceinline__ void load_row(const float* row, long long n,
                                         long long idx, float v[VEC]) {
  if (aligned(n, idx)) {
    const float4 q = *reinterpret_cast<const float4*>(row + idx);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = idx + k < n ? row[idx + k] : 0.f;
}

__device__ __forceinline__ void store_row(float* row, long long n,
                                          long long idx, const float v[VEC]) {
  if (aligned(n, idx)) {
    *reinterpret_cast<float4*>(row + idx) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    if (idx + k < n) row[idx + k] = v[k];
}

// y's row 0, or every replica row
__device__ __forceinline__ void store_y(float* y, long long n, int rows,
                                        long long idx, const float v[VEC]) {
  for (int d = 0; d < rows; ++d) store_row(y + (long long)d * n, n, idx, v);
}

__global__ void __launch_bounds__(THREADS)
    ring_fold_f32(const float* __restrict__ x, float* __restrict__ y,
                  long long n, int w, int rows) {
  const long long idx =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (idx >= n) return;
  float s[VEC];
  load_row(x, n, idx, s);
#pragma unroll 8
  for (int d = 1; d < w; ++d) {
    float v[VEC];
    load_row(x + (long long)d * n, n, idx, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) s[k] = __fadd_rn(s[k], v[k]);
  }
  store_y(y, n, rows, idx, s);
}

struct Int8Geo {
  const float* x;   // (W, N) shards
  float* y;         // (rows, N) replicas
  float* res;       // (W, N) residual rows
  int8_t* q;        // (W * S,) the running codes, in place
  unsigned* amax;   // (W, W) |s| bits, [level][chunk]
  long long n;
  int w, s, rows;
};

// |a| folded into m as unsigned bits: a NaN's bits lie above inf's, so a
// NaN stays wherever it is folded in
__device__ __forceinline__ unsigned fold_amax(unsigned m, float a) {
  return max(m, __float_as_uint(fabsf(a)));
}

// torch.clamp(v, -127, 127): a NaN stays NaN (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp_code(float v) {
  return v != v ? v : fminf(fmaxf(v, -127.f), 127.f);
}

__device__ __forceinline__ float scale_of(const Int8Geo& g, int d, int c) {
  return __fmul_rn(__uint_as_float(g.amax[d * g.w + c]), 1.0f / 127.0f);
}

// max over the block of each thread's m (|s| bits), folded into *dst
__device__ __forceinline__ void block_amax(unsigned m, unsigned* dst) {
  m = __reduce_max_sync(0xffffffffu, m);
  __shared__ unsigned warp_max[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned b = 0u;
    for (int k = 0; k < THREADS / 32; ++k) b = max(b, warp_max[k]);
    atomicMax(dst, b);
  }
}

// level 0's amax: max |x_0| over each chunk (grid: chunk elements, chunk)
__global__ void __launch_bounds__(THREADS) ring_amax0_int8(Int8Geo g) {
  const int c = blockIdx.y;
  const int i = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  unsigned m = 0u;
  if (i < g.s) {
    float s[VEC];
    load_row(g.x, g.n, (long long)c * g.s + i, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = fold_amax(m, s[k]);
  }
  block_amax(m, g.amax + c);
}

// fold point d of every chunk: s_d, q_d, res_d (and y at the last level),
// then the amax of s_{d+1}
__global__ void __launch_bounds__(THREADS) ring_level_int8(Int8Geo g, int d) {
  const int c = blockIdx.y;
  const int i = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  const bool last = d == g.w - 1;
  unsigned m = 0u;
  if (i < g.s) {
    const long long idx = (long long)c * g.s + i;
    float s[VEC];
    load_row(g.x + (long long)d * g.n, g.n, idx, s);
    if (d > 0) {
      const char4 p = *reinterpret_cast<const char4*>(g.q + idx);
      const float sp = scale_of(g, d - 1, c);
      s[0] = __fmaf_rn((float)p.x, sp, s[0]);
      s[1] = __fmaf_rn((float)p.y, sp, s[1]);
      s[2] = __fmaf_rn((float)p.z, sp, s[2]);
      s[3] = __fmaf_rn((float)p.w, sp, s[3]);
    }
    const float sc = scale_of(g, d, c);
    const float safe = sc > 0.f ? sc : 1.f;
    float q[VEC], rs[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      q[k] = clamp_code(rintf(__fdiv_rn(s[k], safe)));
      rs[k] = __fmaf_rn(-q[k], sc, s[k]);
    }
    store_row(g.res + (long long)d * g.n, g.n, idx, rs);
    if (last) {
      float v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(q[k], sc);
      store_y(g.y, g.n, g.rows, idx, v);
    } else {
      // a NaN code converts to 0 (cvt's rule)
      *reinterpret_cast<char4*>(g.q + idx) = make_char4(
          __float2int_rz(q[0]), __float2int_rz(q[1]), __float2int_rz(q[2]),
          __float2int_rz(q[3]));
      float x1[VEC];
      load_row(g.x + (long long)(d + 1) * g.n, g.n, idx, x1);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        m = fold_amax(m, __fmaf_rn(q[k], sc, x1[k]));
    }
  }
  if (!last) block_amax(m, g.amax + (d + 1) * g.w + c);  // uniform
}

}  // namespace

extern "C" {

// All-reduces the (workers, n) shards `x` on `stream`. Writes the merged
// vector into y's row 0, or into every one of its `workers` rows when
// `replicas`. On the int8 wire also writes the residual rows into res
// (workers, n), and uses `q` (workers * chunk int8) and `amax` (workers *
// workers unsigned ints) as scratch; on the fp32 wire res, q and amax are
// not read. Launches one kernel (fp32), or a memset and workers + 1
// kernels (int8). Returns the first cudaGetLastError() that is not
// cudaSuccess, as an int (0 on success).
int ring_allreduce_launch(const float* x, float* y, float* res, int8_t* q,
                          unsigned* amax, long long n, int workers, int chunk,
                          int int8, int replicas, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = replicas ? workers : 1;
  if (!int8) {
    const long long blocks = (n + (long long)THREADS * VEC - 1) /
                             ((long long)THREADS * VEC);
    ring_fold_f32<<<(unsigned)blocks, THREADS, 0, st>>>(x, y, n, workers, rows);
    return static_cast<int>(cudaGetLastError());
  }
  Int8Geo g{x, y, res, q, amax, n, workers, chunk, rows};
  const dim3 grid((chunk / VEC + THREADS - 1) / THREADS, workers);
  cudaError_t e = cudaMemsetAsync(
      amax, 0, (size_t)workers * workers * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  ring_amax0_int8<<<grid, THREADS, 0, st>>>(g);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int d = 0; d < workers; ++d) {
    ring_level_int8<<<grid, THREADS, 0, st>>>(g, d);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* ring_allreduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
