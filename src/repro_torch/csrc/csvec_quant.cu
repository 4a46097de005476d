// Symmetric per-row int8 quantisation of a count-sketch table, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/csvec_quant.py::csvec_quant (its
// pallas_call). For a table t (r, c) f32 it writes, per row j,
//
//   scale[j] = amax_j / 127                       (amax_j = max_i |t[j, i]|)
//   q[j, i]  = clamp(rint(t[j, i] / safe_j), -127, 127)   (safe_j = scale[j]
//                                                          where > 0, else 1)
//   dhat     = q * scale[j],   resid = t - dhat
//
// as the plain version computes them. rint rounds half to even, like
// jnp.round and torch.round. The division is IEEE (__fdiv_rn), and the
// product and difference are __fmul_rn and __fsub_rn, so nothing is
// contracted into an FMA: q, scale and dhat equal the plain version's bit
// for bit, resid to one rounding. dhat is taken from the int8 code (a -0
// rounding gives +0). An all-zero row gets scale 0 and zeros.
//
// Non-finite entries follow the plain version too. The row's amax is a max
// over the bits of |t| as unsigned ints, where a NaN lies above inf, so a
// NaN anywhere in a row makes its amax, scale and dhat NaN, as torch's amax
// does. The clamp keeps a NaN code NaN, as torch.clamp does, and the code
// converts to int8 by cvt's rule (NaN to 0), as the plain version's
// .to(torch.int8) converts it. q and resid are optional: with null
// pointers only scale and dhat are written (the trainer keeps dhat alone).
//
// Bound on an H100 SXM (3.35 TB/s). The function reads the table once
// (4 r c bytes) and writes q (r c), dhat and resid (4 r c each) and the r
// scales: at the LM train step's geometry (r = 5, c = 2^23) 168 MB in and
// 42 + 168 + 168 MB out, 545.3 MB, 162.8 us; dhat and scale only, 8 r c =
// 335.5 MB, 100.2 us. A design that reads the table twice moves 17 r c
// (212.9 us) or 12 r c (150.2 us).
//
// Design: one launch, the table read once from device memory.
//   * A grid of blocks that co-reside (a cooperative launch where a row has
//     several blocks) takes the table row by row: `conc` rows at a time,
//     `bpr` blocks a row, each block a `part` of the row. At the train
//     geometry that is one row at a time over the 132 SMs, a block an SM.
//   * Pass 1 reads the block's part with 16-byte loads, four in flight a
//     thread, and folds |t| into the row's amax. The part stays on the
//     chip: its first tile (THREADS * 4 * 4 elements) in registers, the
//     next `smem` elements in shared memory (up to 224 KB a block), which
//     at the train geometry holds the whole row (63,552 elements a block,
//     of 73,728). Elements past that (rows longer than the card's register
//     files and shared memory hold) are read with an L2 evict-last policy,
//     so that pass 2 finds them in L2.
//   * The row handoff: each block folds its amax into the row's word with
//     atomicMax and adds one to the row's arrival counter; a block goes on
//     once every block of the row has arrived, and the last block to leave
//     sets the row's words back to zero for the next call on the stream
//     (the wrapper keeps them per stream), so no memset runs.
//   * Pass 2 quantises from registers and shared memory and writes with
//     streaming stores (st.global.cs): 16 bytes of dhat and of resid and
//     4 packed codes a store.
// A table of a few thousand counters a row runs with one block a row and
// the row in registers, in one launch and with no handoff.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;           // a block an SM
constexpr int UNROLL = 4;               // loads in flight a thread
constexpr int SMEM_ELEMS = 56 * 1024;   // floats of a part in shared memory
constexpr int MAX_ROWS = 8;
static_assert(THREADS == 32 * 32, "the block fold takes one warp of maxima");

// a launch's geometry (the wrapper's launch_plan)
struct Geo {
  const float* t;
  int8_t* q;            // null with resid: dhat and scale only
  float* scale;
  float* dhat;
  float* resid;
  unsigned* words;      // [amax bits | arrivals | departures] x MAX_ROWS
  int rows, cols;
  int conc, bpr;        // rows at a time, blocks a row
  int part;             // elements of a row a block takes (a multiple of V)
  int smem;             // elements of a part in shared memory
};

__device__ __forceinline__ uint64_t l2_policy_evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t l2_policy_evict_first() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

template <int V>
struct Access;

template <>
struct Access<4> {
  static __device__ __forceinline__ void load_policy(const float* p,
                                                     uint64_t pol,
                                                     float (&v)[4]) {
    asm volatile("ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "l"(p), "l"(pol));
  }
  static __device__ __forceinline__ void load_once(const float* p,
                                                   float (&v)[4]) {
    const float4 x = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void to_shared(float* s,
                                                   const float (&v)[4]) {
    *reinterpret_cast<float4*>(s) = make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ void from_shared(const float* s,
                                                     float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
  static __device__ __forceinline__ void store_codes(int8_t* p,
                                                     const int (&c)[4]) {
    const unsigned w = (unsigned)(c[0] & 0xff) | (unsigned)(c[1] & 0xff) << 8 |
                       (unsigned)(c[2] & 0xff) << 16 |
                       (unsigned)(c[3] & 0xff) << 24;
    __stcs(reinterpret_cast<unsigned*>(p), w);
  }
};

template <>
struct Access<1> {
  static __device__ __forceinline__ void load_policy(const float* p,
                                                     uint64_t pol,
                                                     float (&v)[1]) {
    asm volatile("ld.global.L2::cache_hint.f32 %0, [%1], %2;"
                 : "=f"(v[0])
                 : "l"(p), "l"(pol));
  }
  static __device__ __forceinline__ void load_once(const float* p,
                                                   float (&v)[1]) {
    v[0] = __ldcs(p);
  }
  static __device__ __forceinline__ void to_shared(float* s,
                                                   const float (&v)[1]) {
    *s = v[0];
  }
  static __device__ __forceinline__ void from_shared(const float* s,
                                                     float (&v)[1]) {
    v[0] = *s;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) {
    __stcs(p, v[0]);
  }
  static __device__ __forceinline__ void store_codes(int8_t* p,
                                                     const int (&c)[1]) {
    *p = (int8_t)c[0];
  }
};

// |x| folded into m as unsigned bits: |x| >= 0 orders as its bits, and a
// NaN's bits lie above inf's, so a NaN stays, as torch's amax keeps it
__device__ __forceinline__ unsigned fold_amax(unsigned m, float x) {
  return max(m, __float_as_uint(fabsf(x)));
}

// torch.clamp(v, -127, 127): a NaN stays NaN (fminf / fmaxf would drop it)
__device__ __forceinline__ float clamp_code(float v) {
  return v != v ? v : fminf(fmaxf(v, -127.f), 127.f);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Row j's amax bits: m folded over the block, then, where the row has
// several blocks, over the row's blocks through its words. Every thread of
// the block.
__device__ unsigned row_amax(unsigned m, const Geo& g, int j) {
  __shared__ unsigned warp_max[THREADS / 32];
  __shared__ unsigned row_max;
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = __reduce_max_sync(0xffffffffu, warp_max[threadIdx.x]);
    if (threadIdx.x == 0) {
      if (g.bpr == 1) {
        row_max = m;
      } else {
        unsigned* amax = g.words + j;
        unsigned* arrived = g.words + MAX_ROWS + j;
        unsigned* left = g.words + 2 * MAX_ROWS + j;
        atomicMax(amax, m);
        __threadfence();
        atomicAdd(arrived, 1u);
        while (ld_acquire(arrived) < (unsigned)g.bpr) __nanosleep(64);
        row_max = __ldcg(amax);
        if (atomicAdd(left, 1u) == (unsigned)g.bpr - 1u) {
          // the last block out: every block has read the amax
          *amax = 0u;
          *arrived = 0u;
          *left = 0u;
        }
      }
    }
  }
  __syncthreads();
  return row_max;
}

// q, dhat and (FULL) resid of V elements from element `at` of the table
template <int V, bool FULL>
__device__ __forceinline__ void emit(const Geo& g, size_t at,
                                     const float (&x)[V], float scale,
                                     float safe) {
  float dh[V], rs[V];
  int code[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float qf = clamp_code(rintf(__fdiv_rn(x[k], safe)));
    code[k] = __float2int_rz(qf);   // a NaN code converts to 0
    dh[k] = __fmul_rn((float)code[k], scale);
    rs[k] = __fsub_rn(x[k], dh[k]);
  }
  Access<V>::store(g.dhat + at, dh);
  if constexpr (FULL) {
    Access<V>::store_codes(g.q + at, code);
    Access<V>::store(g.resid + at, rs);
  }
}

template <int V, bool FULL>
__global__ void __launch_bounds__(THREADS, 1) csvec_quant_kernel(Geo g) {
  extern __shared__ float4 smem_v4[];
  float* smem = reinterpret_cast<float*>(smem_v4);
  constexpr int STEP = THREADS * V;      // elements of one load a thread
  constexpr int TILE = STEP * UNROLL;    // the first one stays in registers
  const int slot = blockIdx.x / g.bpr;
  const int lo = (blockIdx.x % g.bpr) * g.part;
  const int hi = min(g.cols, lo + g.part);
  const int mine = lo + threadIdx.x * V;
  const uint64_t keep = l2_policy_evict_last();
  const uint64_t done = l2_policy_evict_first();
  for (int j = slot; j < g.rows; j += g.conc) {
    const size_t row = (size_t)j * g.cols;
    const float* t = g.t + row;
    // pass 1: the amax, with the part kept on the chip
    float first[UNROLL][V];
    unsigned m = 0u;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (mine + u * STEP < hi) Access<V>::load_once(t + mine + u * STEP,
                                                     first[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (mine + u * STEP < hi)
#pragma unroll
        for (int k = 0; k < V; ++k) m = fold_amax(m, first[u][k]);
    for (int base = mine + TILE; base < hi; base += TILE) {
      float v[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * STEP;
        if (e >= hi) continue;
        if (e - lo - TILE < g.smem)
          Access<V>::load_once(t + e, v[u]);
        else
          Access<V>::load_policy(t + e, keep, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * STEP;
        if (e >= hi) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) m = fold_amax(m, v[u][k]);
        if (e - lo - TILE < g.smem)
          Access<V>::to_shared(smem + (e - lo - TILE), v[u]);
      }
    }
    const unsigned bits = row_amax(m, g, j);
    const float scale = __fdiv_rn(__uint_as_float(bits), 127.f);
    const float safe = scale > 0.f ? scale : 1.f;
    if (lo == 0 && threadIdx.x == 0) g.scale[j] = scale;
    // pass 2: each thread reads back what it kept (no barrier needed)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (mine + u * STEP < hi)
        emit<V, FULL>(g, row + mine + u * STEP, first[u], scale, safe);
    for (int base = mine + TILE; base < hi; base += TILE) {
      float v[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * STEP;
        if (e >= hi) continue;
        if (e - lo - TILE < g.smem)
          Access<V>::from_shared(smem + (e - lo - TILE), v[u]);
        else
          Access<V>::load_policy(t + e, done, v[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int e = base + u * STEP;
        if (e < hi) emit<V, FULL>(g, row + e, v[u], scale, safe);
      }
    }
  }
}

template <int V, bool FULL>
cudaError_t set_smem() {
  return cudaFuncSetAttribute(csvec_quant_kernel<V, FULL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_ELEMS * (int)sizeof(float));
}

template <int V, bool FULL>
int blocks_per_sm() {
  cudaError_t e = set_smem<V, FULL>();
  if (e != cudaSuccess) return -(int)e;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, csvec_quant_kernel<V, FULL>, THREADS,
      SMEM_ELEMS * sizeof(float));
  return e != cudaSuccess ? -(int)e : n;
}

template <int V, bool FULL>
cudaError_t launch(Geo g, cudaStream_t s) {
  const int grid = g.conc * g.bpr;
  const size_t smem = (size_t)g.smem * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = set_smem<V, FULL>();
    if (e != cudaSuccess) return e;
  }
  if (g.bpr == 1) {   // no handoff: blocks need not co-reside
    csvec_quant_kernel<V, FULL><<<grid, THREADS, smem, s>>>(g);
    return cudaGetLastError();
  }
  void* args[] = {&g};
  return cudaLaunchCooperativeKernel((const void*)csvec_quant_kernel<V, FULL>,
                                     grid, THREADS, args, smem, s);
}

}  // namespace

extern "C" {

// Blocks of the kernel (vec 4 or 1 elements a load; full: q and resid
// too) that co-reside on an SM with the most shared memory a launch takes;
// a negative cudaError_t on failure.
int csvec_quant_blocks_per_sm(int vec, int full) {
  if (vec == 4) return full ? blocks_per_sm<4, true>() : blocks_per_sm<4, false>();
  return full ? blocks_per_sm<1, true>() : blocks_per_sm<1, false>();
}

// Quantises `table` (rows, cols) on `stream` into scale (rows,), dhat and,
// unless q and resid are null, q and resid; `words` holds 3 * 8 unsigned
// ints, zero before the call and after it. The plan: vec elements a load
// (4 needs cols % 4 == 0 and 16-byte aligned rows), conc rows at a time,
// bpr blocks a row of part elements each (bpr * part >= cols), smem of
// them in shared memory; with bpr > 1 the conc * bpr blocks must
// co-reside. Returns cudaGetLastError() as an int (0 on success).
int csvec_quant_launch(const float* table, unsigned* words, int8_t* q,
                       float* scale, float* dhat, float* resid, int rows,
                       int cols, int vec, int conc, int bpr, int part,
                       int smem, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || cols < 1 || (vec != 1 && vec != 4) ||
      cols % vec != 0 || part % vec != 0 || smem % vec != 0 || conc < 1 ||
      conc > rows || bpr < 1 || part < 1 || (long long)bpr * part < cols ||
      (long long)(bpr - 1) * part >= cols || smem < 0 ||
      smem > SMEM_ELEMS || (q == nullptr) != (resid == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo g{table, q, scale, dhat, resid, words, rows, cols, conc, bpr,
              part, smem};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (vec == 4)
    e = q ? launch<4, true>(g, s) : launch<4, false>(g, s);
  else
    e = q ? launch<1, true>(g, s) : launch<1, false>(g, s);
  return static_cast<int>(e);
}

const char* csvec_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
