// Quantisation-aware chain all-reduce of W workers' flat f32 buffers, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ring_allreduce.py::ring_allreduce
// (its pallas_call), a remote-DMA ring between W chips. Here the W workers
// of the data-parallel step live in one process on one card, so the W
// "devices" of the ring are W regions of device memory. Device d owns its
// shard row x[d] (N f32, read in chunks of S, zero past N), two receive
// slots slot[d][0..1] (S f32, or S int8 plus scale[d][0..1]), its residual
// row res[d] and its output row y[d]. A hop is one launch (two on the int8
// wire), with the grid over (chunk elements, device): the launch boundary
// is the barrier between hops, so no block waits on another.
//
// Schedule, the reference's pipelined chain (not a rotated ring), 3W - 3
// hops t = 0..3W-4 with double-buffered slots p = t % 2:
//   stage   device 0 puts chunk t + 1 of its shard into device 1's slot
//           (t + 1) % 2 during hop t (hop -1 stages chunk 0);
//   reduce  device d >= 1 receives chunk c = t - (d - 1) in slot t % 2,
//           adds its own chunk c and writes the sum into device
//           (d + 1) % W's slot (t + 1) % 2; device W - 1 holds the final
//           chunk, keeps it in y and starts the broadcast to device 0;
//   bcast   device d < W - 1 receives final chunk c = t - (W - 1) - d,
//           keeps it in y and, for d <= W - 3, forwards it raw.
// So chunk c folds in device order 0..W-1: the fp32 wire is the left fold
// x[0] + x[1] + ... + x[W-1] of every element, bit for bit.
//
// int8 wire: device 0 quantises its chunk, each reduce step folds the
// received codes in and requantises, the broadcast forwards the raw (int8,
// scale) pairs. The arithmetic is that of the reference's compiled oracle,
// every step an intrinsic so that nvcc cannot contract or reorder it:
//   scale = __fmul_rn(amax, 1/127f)        amax = max |s| over the chunk
//   q     = clamp(rint(__fdiv_rn(s, safe)), -127, 127),  safe = scale or 1
//   s     = __fmaf_rn(q_in, scale_in, x)   (the fold; device 0: s = x)
//   res   = __fmaf_rn(-q, scale, s)        (the device's residual)
//   y     = __fmul_rn(q, scale)
// The chunk's amax is a reduction across blocks: a first launch of the hop
// computes s and folds max |s| in with atomicMax on its bits (|s| >= 0
// orders as unsigned ints, so this is exact and order-free), and the second
// launch computes s again instead of storing it.
//
// Bound on an H100 SXM (3.35 TB/s): the function reads the W shards once and
// writes the merged vector once per replica, 8 W N bytes (fp32), and the W
// residual rows as well on the int8 wire, 12 W N bytes. At tinyllama-1.1b's
// fused dense wire (N = 1.1e9, W = 4) that is 35 GB, 10.5 ms. The chain moves
// more: each chunk crosses 2W - 2 slots (written and read once each), as on
// the TPU. Loads and stores are 16 bytes a thread where aligned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;

struct Geo {
  const float* x;   // (W, N) shards
  float* y;         // (W or 1, N) replicas
  float* res;       // (W, N) residual rows (int8 wire)
  void* slot;       // (W, 2, S) receive slots
  float* scale;     // (W, 2) received scales (int8 wire)
  unsigned* amax;   // (W,) |s| bits of the hop's chunk (int8 wire)
  long long n;
  int w, s, t, replicas;
};

// The role of device d at hop t: 0 none, 1 stage (device 0), 2 reduce,
// 3 bcast; `c` the chunk it handles.
__device__ __forceinline__ int role(const Geo& g, int d, int* c) {
  const int W = g.w, t = g.t;
  if (d == 0 && t + 1 < W) { *c = t + 1; return 1; }
  if (t < 0) return 0;
  if (d >= 1) {
    const int cr = t - (d - 1);
    if (cr >= 0 && cr < W) { *c = cr; return 2; }
  }
  if (d < W - 1) {
    const int cb = t - (W - 1) - d;
    if (cb >= 0 && cb < W) { *c = cb; return 3; }
  }
  return 0;
}

__device__ __forceinline__ bool aligned(long long n, long long idx) {
  return (n & 3) == 0 && idx + VEC <= n;
}

// x[d][c*S + i .. + VEC), zero past N
__device__ __forceinline__ void load_x(const Geo& g, int d, long long idx,
                                       float v[VEC]) {
  const float* row = g.x + (long long)d * g.n;
  if (aligned(g.n, idx)) {
    const float4 q = *reinterpret_cast<const float4*>(row + idx);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) v[k] = idx + k < g.n ? row[idx + k] : 0.f;
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

// device d's output row, or nothing when only device 0's replica is kept
__device__ __forceinline__ void store_y(const Geo& g, int d, long long idx,
                                       const float v[VEC]) {
  if (g.replicas)
    store_row(g.y + (long long)d * g.n, g.n, idx, v);
  else if (d == 0)
    store_row(g.y, g.n, idx, v);
}

__global__ void __launch_bounds__(THREADS) hop_f32(Geo g) {
  const int d = blockIdx.y;
  const int i = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  int c = 0;
  const int r = role(g, d, &c);
  if (r == 0 || i >= g.s) return;
  const int W = g.w, last = g.t + 1 >= 3 * W - 3;
  float* slots = static_cast<float*>(g.slot);
  const int p = g.t & 1, p1 = (g.t + 1) & 1;
  const long long idx = (long long)c * g.s + i;
  float v[VEC];
  if (r == 1) {
    load_x(g, 0, idx, v);
  } else {
    const float4 m = *reinterpret_cast<const float4*>(
        slots + ((long long)d * 2 + p) * g.s + i);
    v[0] = m.x; v[1] = m.y; v[2] = m.z; v[3] = m.w;
    if (r == 2) {
      float xv[VEC];
      load_x(g, d, idx, xv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = __fadd_rn(v[k], xv[k]);
      if (d == W - 1) store_y(g, d, idx, v);
    } else {
      store_y(g, d, idx, v);
      if (d > W - 3) return;            // the chain ends at device W - 2
    }
  }
  if (last) return;
  const int dst = (d + 1) % W;
  *reinterpret_cast<float4*>(slots + ((long long)dst * 2 + p1) * g.s + i) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// s for a quantising role (stage or reduce) at element block i
__device__ __forceinline__ void fold_in(const Geo& g, int d, int r,
                                        long long idx, int i, float s[VEC]) {
  load_x(g, d, idx, s);
  if (r == 2) {
    const int p = g.t & 1;
    const char4 m = *reinterpret_cast<const char4*>(
        static_cast<const int8_t*>(g.slot) + ((long long)d * 2 + p) * g.s + i);
    const float sc = g.scale[d * 2 + p];
    s[0] = __fmaf_rn((float)m.x, sc, s[0]);
    s[1] = __fmaf_rn((float)m.y, sc, s[1]);
    s[2] = __fmaf_rn((float)m.z, sc, s[2]);
    s[3] = __fmaf_rn((float)m.w, sc, s[3]);
  }
}

__device__ __forceinline__ float nanmax(float m, float a) {
  return a <= m ? m : a;  // a NaN replaces m
}

__global__ void __launch_bounds__(THREADS) hop_int8_amax(Geo g) {
  const int d = blockIdx.y;
  const int i = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  int c = 0;
  const int r = role(g, d, &c);
  if (r != 1 && r != 2) return;         // uniform over the block
  float m = 0.f;
  if (i < g.s) {
    float s[VEC];
    fold_in(g, d, r, (long long)c * g.s + i, i, s);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = nanmax(m, fabsf(s[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nanmax(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ float warp_max[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
    for (int k = 0; k < THREADS / 32; ++k) b = nanmax(b, warp_max[k]);
    atomicMax(g.amax + d, __float_as_uint(b));
  }
}

__global__ void __launch_bounds__(THREADS) hop_int8(Geo g) {
  const int d = blockIdx.y;
  const int i = (blockIdx.x * THREADS + threadIdx.x) * VEC;
  int c = 0;
  const int r = role(g, d, &c);
  if (r == 0 || i >= g.s) return;
  const int W = g.w, last = g.t + 1 >= 3 * W - 3;
  const int p = g.t & 1, p1 = (g.t + 1) & 1;
  int8_t* slots = static_cast<int8_t*>(g.slot);
  const long long idx = (long long)c * g.s + i;
  char4 out;
  float sc;
  if (r == 3) {                         // forward the raw pair
    out = *reinterpret_cast<const char4*>(slots + ((long long)d * 2 + p) *
                                          g.s + i);
    sc = g.scale[d * 2 + p];
    const float v[VEC] = {__fmul_rn((float)out.x, sc),
                          __fmul_rn((float)out.y, sc),
                          __fmul_rn((float)out.z, sc),
                          __fmul_rn((float)out.w, sc)};
    store_y(g, d, idx, v);
    if (d > W - 3) return;
  } else {
    float s[VEC];
    fold_in(g, d, r, idx, i, s);
    sc = __fmul_rn(__uint_as_float(g.amax[d]), 1.0f / 127.0f);
    const float safe = sc > 0.f ? sc : 1.f;
    float q[VEC], rs[VEC], v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      q[k] = fminf(fmaxf(rintf(__fdiv_rn(s[k], safe)), -127.f), 127.f);
      rs[k] = __fmaf_rn(-q[k], sc, s[k]);
      v[k] = __fmul_rn(q[k], sc);
    }
    store_row(g.res + (long long)d * g.n, g.n, idx, rs);
    if (d == W - 1) store_y(g, d, idx, v);
    out = make_char4((int8_t)q[0], (int8_t)q[1], (int8_t)q[2], (int8_t)q[3]);
  }
  if (last) return;
  const int dst = (d + 1) % W;
  *reinterpret_cast<char4*>(slots + ((long long)dst * 2 + p1) * g.s + i) = out;
  if (blockIdx.x == 0 && threadIdx.x == 0) g.scale[dst * 2 + p1] = sc;
}

}  // namespace

extern "C" {

// All-reduces the (workers, n) shards `x` on `stream` through 3W - 2 hop
// launches (two kernels and a memset each on the int8 wire). Writes device
// 0's replica into y (n,), or every device's into y (workers, n) when
// `replicas`; on the int8 wire the residual rows into res (workers, n).
// `slot` holds (workers, 2, chunk) f32 or int8, `scale` (workers, 2) f32,
// `amax` (workers,) unsigned ints. Returns the first
// cudaGetLastError() that is not cudaSuccess, as an int (0 on success).
int ring_allreduce_launch(const float* x, float* y, float* res, void* slot,
                          float* scale, unsigned* amax, long long n,
                          int workers, int chunk, int int8, int replicas,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geo g{x, y, res, slot, scale, amax, n, workers, chunk, 0, replicas};
  const dim3 grid((chunk / VEC + THREADS - 1) / THREADS, workers);
  for (int t = -1; t < 3 * workers - 3; ++t) {
    g.t = t;
    if (int8) {
      cudaError_t e = cudaMemsetAsync(amax, 0, workers * sizeof(unsigned), st);
      if (e != cudaSuccess) return static_cast<int>(e);
      hop_int8_amax<<<grid, THREADS, 0, st>>>(g);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      hop_int8<<<grid, THREADS, 0, st>>>(g);
    } else {
      hop_f32<<<grid, THREADS, 0, st>>>(g);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* ring_allreduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
