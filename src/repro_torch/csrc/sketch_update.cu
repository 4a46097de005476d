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
// reading A once for all three thin products and every column of k. A is
// bf16 or f32; everything else is f32; k <= 64 (checked by the Python
// wrapper, src/repro_torch/kernels/sketch_update.py, which also picks the
// kernel and the T split). A stacked call does this for E experts in one
// launch (gridDim.z = E): A (E, T, d), sketches (E, d, k) and psi (E, k)
// against the projections all experts share, as the TPU kernel runs
// under the reference's vmap over an (E, d, k) node stack.
//
// Bound on an H100 SXM (3.35 TB/s; 989 TFLOP/s bf16 on the tensor cores).
// The call moves T*d*|A| + 3*T*k*4 + 6*d*k*4 bytes and does 6*T*d*k
// flops. At the LM's FFN shapes (T 1024 or 8192, d 2048 or 5632, k 17,
// bf16 A) the bytes bound it by a wide margin even with each f32
// projection split into bf16 high and low parts (two products): 4.19 us
// at T 1024, d 5632; 28.7 us at T 8192. The f32 FMA units (67 TFLOP/s)
// could not keep up with the bytes there, hence the tensor cores.
//
// Two kernels (ema_update.cuh has the shared pieces), chosen by the
// wrapper from A's dtype and shape:
//   * bf16 A whose rows are whole 16-byte chunks (d % 8 == 0), T > 64:
//     the tensor-core kernel below. A block owns 128 columns of d and all
//     3k outputs, one consumer warpgroup for each 64 of them (k <= 21: one).
//     The products are computed transposed, inc^T = P^T A, on wgmma
//     m64n128k16 (A's tile, 64 rows by 128 columns as it lies in device
//     memory, is the MN-major B operand). A producer warp fills a ring of
//     STAGES slots under mbarriers: lane 0 streams the A tile by TMA
//     (128-byte swizzle; a 3-D map (d, T, E), so a tile never reads the
//     next expert's rows), and all 32 lanes copy the same rows of the three
//     projections (contiguous in device memory) with coalesced cp.async,
//     each lane's copies counted on the slot's full barrier. Each consumer
//     reads its P^T fragments from the slot, splits each value into
//     hi = bf16(P) and lo = bf16(P - hi), and runs hi and lo through wgmma
//     into one f32 accumulator: P = hi + lo to about 2^-17 of |P|, and a
//     bf16 product is exact in f32. A is read from device memory once;
//     there is no k-chunk grid dimension.
//   * f32 A, bf16 A with d % 8 != 0, or T <= 64: the FMA kernel
//     (ema_update.cuh), 32 columns a block, A read once for every k.
// Both split T across gridDim.y blocks where the d-tiles alone leave SMs
// idle (the wrapper's plan, whole stages a split); the splits' partials
// are then summed in a fixed order by a second small kernel
// (deterministic, no atomics). On an H100 a one-kernel variant, the
// splits as one thread-block cluster summed through distributed shared
// memory, measured slower (PERF.md).

#include <mutex>

#include "ema_update.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
using ema::Outs;

constexpr int STAGES = 3;   // the ring of A and projection tiles

// bytes of a stage's projection tile: rows [t0, t0 + 64) of the three
// (T, k) projections, each as it lies in device memory
__host__ __device__ constexpr int p_stage_bytes(int k) {
  return 3 * ema::TC_ROWS * k * 4;
}

// the dense projections: row r of A is row r; P[r, n] is column n % k of
// projection n / k
struct Dense {
  const float* p0;
  const float* p1;
  const float* p2;
  int k;
  __device__ __forceinline__ int row(int r) const { return r; }
  __device__ __forceinline__ float val(int r, int n) const {
    const int mat = n / k;
    return (mat == 0 ? p0 : (mat == 1 ? p1 : p2))[(size_t)r * k + n - mat * k];
  }
};

// hi = bf16(P), lo = bf16(P - hi) of this thread's A fragments for one
// stage, read from the stage's projection tile: register i of k-step kk
// holds output row n[i & 1] (at off[i & 1] in the tile, or none where
// off < 0) and rows 16 kk + 8 (i >> 1) + 2 tig and the next
// (hopper.cuh, mma_m64n128k16_rs); rows from `rows` on (past T) are zero
__device__ __forceinline__ void split_stage(const float* pt,
                                            const int (&off)[2], int k,
                                            int rows, int tig,
                                            uint32_t (&hi)[4][4],
                                            uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int o = off[i & 1], t = 16 * kk + 8 * (i >> 1) + 2 * tig;
      const float v0 = o >= 0 && t < rows ? pt[o + t * k] : 0.f;
      const float v1 = o >= 0 && t + 1 < rows ? pt[o + (t + 1) * k] : 0.f;
      const float h0 = __bfloat162float(__float2bfloat16_rn(v0));
      const float h1 = __bfloat162float(__float2bfloat16_rn(v1));
      hi[kk][i] = pack_bf16(h0, h1);
      lo[kk][i] = pack_bf16(v0 - h0, v1 - h1);
    }
}

// The producer warp: for each stage, once its slot is free, lane 0
// streams the A tile by TMA and the stage's rows of the three projections
// (each contiguous in device memory, 256 k bytes from the last stage's,
// from a base the wrapper checks is 16-byte aligned) by 1-D bulk copies of
// whole 16-byte chunks; lanes 1-3 copy the last floats of a ragged end
// with cp.async, and every lane's copies are counted on the full barrier.
__device__ __forceinline__ void produce(const CUtensorMap* ma,
                                        const Dense& src, uint8_t* tiles,
                                        float* ptiles, uint64_t* full,
                                        uint64_t* empty, int T, int d0,
                                        int t_begin, int nst, int e) {
  const int lane = threadIdx.x % 32, k = src.k, per = ema::TC_ROWS * k;
  for (int i = 0; i < nst; ++i) {
    const int s = i % STAGES, t0 = t_begin + i * ema::TC_ROWS;
    if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
    float* pt = ptiles + s * 3 * per;
    const int valid = min(ema::TC_ROWS, T - t0) * k, whole = valid & ~3;
    const float* g[3] = {src.p0 + (size_t)t0 * k, src.p1 + (size_t)t0 * k,
                         src.p2 + (size_t)t0 * k};
    if (lane == 0) {
      uint8_t* tile = tiles + s * ema::TC_STAGE_BYTES;
      mbar_expect_tx(&full[s], ema::TC_STAGE_BYTES + 3 * whole * 4);
      tma_load_3d(tile, ma, &full[s], d0, t0, e);
      tma_load_3d(tile + ema::TC_STAGE_BYTES / 2, ma, &full[s], d0 + 64, t0,
                  e);
      if (whole > 0)
#pragma unroll
        for (int mat = 0; mat < 3; ++mat)
          bulk_load(pt + mat * per, g[mat], whole * 4, &full[s]);
    } else if (whole + lane - 1 < valid) {
#pragma unroll
      for (int mat = 0; mat < 3; ++mat)
        cp_async4(pt + mat * per + whole + lane - 1, g[mat] + whole + lane - 1,
                  4);
    }
    cp_async_arrive(&full[s]);
  }
}

// A consumer warpgroup: the products over this block's rows into acc.
template <int MT>
__device__ __forceinline__ void consume(float (&acc)[64], const uint8_t* tiles,
                                        const float* ptiles, uint64_t* full,
                                        uint64_t* empty, int k, int T,
                                        int t_begin, int nst) {
  const int c = threadIdx.x / 128, w = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32, tig = lane % 4, per = ema::TC_ROWS * k;
  // where this thread's two output rows sit in a projection tile
  int off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = 64 * c + 16 * w + lane / 4 + 8 * h, mat = n / k;
    off[h] = n < 3 * k ? mat * per + n - mat * k : -1;
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nst; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    uint32_t hi[4][4], lo[4][4];
    split_stage(ptiles + s * 3 * per, off, k,
                T - t_begin - i * ema::TC_ROWS, tig, hi, lo);
    const uint8_t* tile = tiles + s * ema::TC_STAGE_BYTES;
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t b = mn_desc128(tile, ema::TC_ROWS, kk);
      mma_m64n128k16_rs(acc, hi[kk], b);
      mma_m64n128k16_rs(acc, lo[kk], b);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    mbar_arrive(&empty[s]);
  }
}

template <int MT>
__global__ void __launch_bounds__(128 * MT + 32)
    sketch_update_tc(const __grid_constant__ CUtensorMap ma, Dense src,
                     Outs o, int T, int rows_per_split) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* tiles = align_1024(smem_raw);
  float* ptiles = reinterpret_cast<float*>(tiles + STAGES *
                                           ema::TC_STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(ptiles) + STAGES * p_stage_bytes(src.k));
  uint64_t* empty = full + STAGES;
  const int d0 = blockIdx.x * ema::TC_TILE_D;
  const int t_begin = blockIdx.y * rows_per_split;
  const int t_end = min(T, t_begin + rows_per_split);
  const int nst = (t_end - t_begin + ema::TC_ROWS - 1) / ema::TC_ROWS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA's expect_tx, each lane's copies
      mbar_init(&empty[s], 128 * MT);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 128 * MT) {
    produce(&ma, src, tiles, ptiles, full, empty, T, d0, t_begin, nst,
            blockIdx.z);
    return;
  }
  float acc[64];
  consume<MT>(acc, tiles, ptiles, full, empty, src.k, T, t_begin, nst);
  ema::tc_emit(acc, threadIdx.x / 128, ema::expert_outs(o, blockIdx.z,
                                                        gridDim.y), d0);
}

// ---- host side ----

constexpr int ERR_ENCODE = 10000;   // + the CUresult of a refused map
constexpr int ERR_NO_ENCODE = 20000;

// A's 3-D map (d, T, E), boxes of (64 columns, 64 rows, one expert),
// 128-byte swizzle. A map depends only on (pointer, T, d, E), so the last
// few are kept: a caller that reuses its buffers encodes once.
struct MapEntry {
  const void* ptr;
  int T, d, E;
  CUtensorMap map;
};
constexpr int MAP_CACHE = 16;
MapEntry map_cache[MAP_CACHE];
int map_next = 0;
std::mutex map_mutex;

int a_map(CUtensorMap* map, const void* a, int T, int d, int E) {
  std::lock_guard<std::mutex> lock(map_mutex);
  for (const MapEntry& e : map_cache)
    if (e.ptr == a && e.T == T && e.d == d && e.E == E) {
      *map = e.map;
      return 0;
    }
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return ERR_NO_ENCODE;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)T, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)T * d * 2};
  const cuuint32_t box[3] = {64, ema::TC_ROWS, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(a), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return ERR_ENCODE + (int)r;
  map_cache[map_next] = MapEntry{a, T, d, E, *map};
  map_next = (map_next + 1) % MAP_CACHE;
  return 0;
}

template <int MT>
int launch_tc(const CUtensorMap& map, const Dense& src, const Outs& o, int T,
              int splits, int rows_per_split, int experts,
              cudaStream_t stream) {
  // the rings at this k; the attribute allows the largest k's
  const auto bytes = [](int k) {
    return 1024 + STAGES * (ema::TC_STAGE_BYTES + p_stage_bytes(k)) +
           2 * STAGES * (int)sizeof(uint64_t);
  };
  const size_t smem = bytes(src.k);
  static bool ready[64] = {};   // the attribute is set once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(sketch_update_tc<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes(64));
    if (err != cudaSuccess) return err;
    // all of the SM's 228 KB as shared memory, so that two blocks fit
    err = cudaFuncSetAttribute(sketch_update_tc<MT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid((o.d + ema::TC_TILE_D - 1) / ema::TC_TILE_D, splits,
                  experts);
  sketch_update_tc<MT><<<grid, 128 * MT + 32, smem, stream>>>(
      map, src, o, T, rows_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the update on `stream`; returns 0, a cudaError_t, or an
// ERR_* code of the tensor map. `out` is (experts, 3, d, k); `ws` holds
// experts*splits*3*d*k floats and is unused when splits == 1. A is
// (experts, T, d), the sketches (experts, d, k) and psi (experts, k); the
// projections (T, k) are shared. tensor_cores
// selects the tensor-core kernel (bf16 A, d % 8 == 0, A 16-byte aligned)
// and splits/rows_per_split its plan (rows a whole number of 64-row
// stages), else the FMA kernel (rows a whole number of 32).
int sketch_update_launch(const void* a, int a_is_bf16, const float* ups,
                         const float* omg, const float* phi,
                         const float* psi, const float* x_in,
                         const float* y_in, const float* z_in, float* out,
                         float* ws, int T, int d, int k, int experts,
                         int tensor_cores, int splits, int rows_per_split,
                         float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Outs o{x_in, y_in, z_in, psi, out, ws, d, k, beta, 1.f};
  const Dense src{ups, omg, phi, k};
  int err;
  if (tensor_cores) {
    if (!a_is_bf16 || d % 8 != 0) return cudaErrorInvalidValue;
    CUtensorMap map;
    if ((err = a_map(&map, a, T, d, experts))) return err;
    const int mt = (3 * k + 63) / 64;
    err = mt == 1 ? launch_tc<1>(map, src, o, T, splits, rows_per_split,
                                 experts, s)
          : mt == 2 ? launch_tc<2>(map, src, o, T, splits, rows_per_split,
                                   experts, s)
                    : launch_tc<3>(map, src, o, T, splits, rows_per_split,
                                   experts, s);
  } else if (a_is_bf16) {
    err = ema::launch_fma(static_cast<const bf16*>(a), (size_t)T * d, src, o,
                          T, splits, rows_per_split, experts, s);
  } else {
    err = ema::launch_fma(static_cast<const float*>(a), (size_t)T * d, src,
                          o, T, splits, rows_per_split, experts, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return ema::launch_finalize(o, splits, experts, s);
}

const char* sketch_update_error_string(int code) {
  if (code == ERR_NO_ENCODE)
    return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (code >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused A's map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
