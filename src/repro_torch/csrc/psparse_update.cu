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
//   X' = beta X + (1-beta) alpha sum_u A[row_0(u), :]^T sgn_0(u, :)
//   Y' = the same with matrix 1
//   Z' = the same with matrix 2, the sum times psi (per column)
//
// Duplicate support rows add, as in a CountSketch. A is bf16 or f32 and is
// summed in f32; everything else is f32. k <= 64 (checked by the Python
// wrapper, src/repro_torch/kernels/psparse_update.py, which also picks the
// kernel and the split of the slots). A stacked call does this for E
// experts in one launch (gridDim.z = E): A (E, rows, d), sketches (E, d,
// k) and psi (E, k) against the hashes all experts share, as the TPU
// kernel runs under the reference's vmap over an (E, d, k) node stack.
//
// Bound on an H100 SXM (3.35 TB/s). The call must read the distinct
// support rows of A (at most 3 m d |A| bytes) and read and write the
// sketches (6 d k 4 bytes); the 6 m d k flops are negligible. At the LM's
// FFN shapes (T 1024, m 102, k 17, bf16 A) that is 1.58 us at d 5632.
//
// The 3m support slots are the rows of one product (ema_update.cuh): slot
// s is slot s % m of matrix s / m, and its P row holds sgn in that
// matrix's k columns and zero elsewhere; alpha is applied in the
// epilogue. Two kernels:
//   * bf16 A whose rows are whole 16-byte chunks (d % 8 == 0), T > 64:
//     the tensor-core kernel below. A block owns 128 columns of d and all 3k
//     outputs, one warpgroup for each 64 of them. It gathers the support
//     rows of its d-tile into shared memory with cp.async, 16 bytes a
//     thread and a 64-slot stage's 1024 chunks in flight at once, in a
//     ring of STAGES stages (TMA has no row gather); each thread builds its
//     +-1 sign fragments from the coefficients (exact in bf16), and wgmma
//     m64n128k16 sums sgn^T A[rows] in f32 with no split at all.
//   * f32 A, bf16 A with d % 8 != 0, or T <= 64: the FMA kernel, A read
//     once for every k. An A of fewer rows than T (a carry's B rows
//     against the tree's token rows) takes it too, over only the slots
//     whose row A holds, which the wrapper lists.
// Both split the slots across gridDim.y blocks where the d-tiles alone
// leave SMs idle; the splits' partials are summed in a fixed order by a
// second small kernel (deterministic, no atomics).

#include <stdint.h>

#include "ema_update.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
using ema::Outs;

constexpr int STAGES = 3;   // the ring of gathered tiles

struct Coeffs {
  uint32_t v[3][4];  // per matrix: a_row, b_row, a_sign, b_sign
};

// the implicit projections: slot s of the 3m, matrix s / m
struct Hashed {
  Coeffs c;
  int T, m, k;
  __device__ __forceinline__ uint32_t coeff(int mat, int i) const {
    return mat == 0 ? c.v[0][i] : (mat == 1 ? c.v[1][i] : c.v[2][i]);
  }
  __device__ __forceinline__ int row(int s) const {
    const int mat = s / m;
    const uint32_t u = s - mat * m;
    const uint32_t h = coeff(mat, 0) * u + coeff(mat, 1);
    return static_cast<int>(((h >> 16) * static_cast<uint32_t>(T)) >> 16);
  }
  // sgn of slot u of matrix mat in column j, from the sign coefficients
  static __device__ __forceinline__ float sign(uint32_t a2, uint32_t b2,
                                               uint32_t u, uint32_t j) {
    return ((a2 * ((u << 16) | j) + b2) >> 31) ? -1.f : 1.f;
  }
  __device__ __forceinline__ float val(int s, int n) const {
    const int mat = s / m;
    if (n / k != mat) return 0.f;
    return sign(coeff(mat, 2), coeff(mat, 3), s - mat * m, n - mat * k);
  }
};

// a carry's update: A holds the binding's first rows (a carry's B
// against the tree's T token rows, the rest zero), so only the slots
// whose row falls among them add anything; the wrapper lists those
// slots, and row r of the product is slot slots[r]
struct Listed {
  Hashed h;
  const int* slots;
  __device__ __forceinline__ int row(int r) const {
    return h.row(slots[r]);
  }
  __device__ __forceinline__ float val(int r, int n) const {
    return h.val(slots[r], n);
  }
};

// gathers stage i's 64 slots of the d-tile at d0 into `tile`, 16 bytes a
// chunk; a slot past s_end, or a chunk past d, is zero-filled
__device__ __forceinline__ void gather(uint8_t* tile, const bf16* a,
                                       const Hashed& src, int d, int d0,
                                       int s0, int s_end, int threads) {
  for (int q = threadIdx.x; q < ema::TC_ROWS * 16; q += threads) {
    const int r = q >> 4, cb = (q >> 3) & 1, ch = q & 7;
    const int slot = s0 + r, col = d0 + 64 * cb + 8 * ch;
    const bool ok = slot < s_end && col < d;
    const bf16* p = ok ? a + (size_t)src.row(slot) * d + col : a;
    cp_async16(tile + sw128_offset(ema::TC_ROWS, r, cb, ch), p, ok ? 16 : 0);
  }
}

template <int MT>
__global__ void __launch_bounds__(128 * MT)
    psparse_update_tc(const bf16* __restrict__ a, size_t a_stride,
                      Hashed src, Outs o, int slots_per_split) {
  extern __shared__ uint8_t smem_raw[];
  a += blockIdx.z * a_stride;
  o = ema::expert_outs(o, blockIdx.z, gridDim.y);
  uint8_t* tiles = align_1024(smem_raw);
  const int d0 = blockIdx.x * ema::TC_TILE_D;
  const int s_begin = blockIdx.y * slots_per_split;
  const int s_end = min(3 * src.m, s_begin + slots_per_split);
  const int nst = (s_end - s_begin + ema::TC_ROWS - 1) / ema::TC_ROWS;
  const int d = o.d;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < nst)
      gather(tiles + i * ema::TC_STAGE_BYTES, a, src, d, d0,
             s_begin + i * ema::TC_ROWS, s_end, 128 * MT);
    cp_async_commit();
  }

  // this thread's two outputs (A-fragment rows) and their matrix's sign
  // coefficients
  const int c = threadIdx.x / 128, w = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32, tig = lane % 4;
  int mat_n[2], col_n[2];
  uint32_t a2[2], b2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = 64 * c + 16 * w + lane / 4 + 8 * h;
    mat_n[h] = n < 3 * src.k ? n / src.k : -1;
    col_n[h] = n - max(mat_n[h], 0) * src.k;
    a2[h] = src.coeff(max(mat_n[h], 0), 2);
    b2[h] = src.coeff(max(mat_n[h], 0), 3);
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int i = 0; i < nst; ++i) {
    const int s0 = s_begin + i * ema::TC_ROWS;
    // the sign fragments of this stage: register r of k-step kk holds
    // output row (r & 1) and slots 16 kk + 8 (r >> 1) + 2 tig, + 1
    uint32_t sg[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int slot = s0 + 16 * kk + 8 * (r >> 1) + 2 * tig + q;
          const int h = r & 1, mat = slot / src.m;
          v[q] = (slot < s_end && mat == mat_n[h])
                     ? Hashed::sign(a2[h], b2[h], slot - mat * src.m,
                                    col_n[h])
                     : 0.f;
        }
        sg[kk][r] = pack_bf16(v[0], v[1]);
      }
    cp_async_wait<STAGES - 2>();   // this thread's chunks of stage i
    fence_proxy_async();
    __syncthreads();               // everyone's, and stage i - 1 consumed
    if (i + STAGES - 1 < nst)
      gather(tiles + (i + STAGES - 1) % STAGES * ema::TC_STAGE_BYTES, a, src,
             d, d0, s0 + (STAGES - 1) * ema::TC_ROWS, s_end, 128 * MT);
    cp_async_commit();
    const uint8_t* tile = tiles + i % STAGES * ema::TC_STAGE_BYTES;
    fence_regs(acc);
    fence_regs(sg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_m64n128k16_rs(acc, sg[kk], mn_desc128(tile, ema::TC_ROWS, kk));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(sg);
  }
  ema::tc_emit(acc, c, o, d0);
}

template <int MT>
int launch_tc(const bf16* a, size_t a_stride, const Hashed& src,
              const Outs& o, int splits, int slots_per_split, int experts,
              cudaStream_t stream) {
  constexpr size_t smem = 1024 + STAGES * ema::TC_STAGE_BYTES;
  static bool ready[64] = {};   // the attribute is set once a device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(psparse_update_tc<MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(psparse_update_tc<MT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  const dim3 grid((o.d + ema::TC_TILE_D - 1) / ema::TC_TILE_D, splits,
                  experts);
  psparse_update_tc<MT><<<grid, 128 * MT, smem, stream>>>(
      a, a_stride, src, o, slots_per_split);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the update on `stream`; returns 0 or a cudaError_t. `out` is
// (experts, 3, d, k); `ws` holds experts*splits*3*d*k floats and is unused
// when splits == 1. A is (experts, a_rows, d), the sketches (experts, d,
// k) and psi (experts, k). c{mat}{0..3} are matrix mat's a_row, b_row,
// a_sign, b_sign. Rows hash into [0, T). n_slots < 0 sums every one of the 3m slots; else A
// holds fewer rows than T and only the n_slots slots listed in `slots`
// (device int32, slot numbers in [0, 3m)) are summed, on the FMA kernel.
// tensor_cores selects the tensor-core kernel (bf16 A, d % 8 == 0, A
// 16-byte aligned) and splits/slots_per_split its plan (a whole number of
// 64-slot stages a split), else the FMA kernel (a whole number of 32).
int psparse_update_launch(const void* a, int a_is_bf16, const float* psi,
                          const float* x_in, const float* y_in,
                          const float* z_in, float* out, float* ws,
                          uint32_t c00, uint32_t c01, uint32_t c02,
                          uint32_t c03, uint32_t c10, uint32_t c11,
                          uint32_t c12, uint32_t c13, uint32_t c20,
                          uint32_t c21, uint32_t c22, uint32_t c23, int T,
                          int d, int k, int m, int experts, int a_rows,
                          const int* slots, int n_slots,
                          int tensor_cores, int splits, int slots_per_split,
                          float alpha, float beta, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hashed src{{{{c00, c01, c02, c03},
                     {c10, c11, c12, c13},
                     {c20, c21, c22, c23}}},
                   T, m, k};
  const Outs o{x_in, y_in, z_in, psi, out, ws, d, k, beta, alpha};
  const size_t a_stride = (size_t)a_rows * d;
  int err;
  if (n_slots >= 0) {
    if (tensor_cores) return cudaErrorInvalidValue;
    const Listed listed{src, slots};
    err = a_is_bf16
              ? ema::launch_fma(static_cast<const bf16*>(a), a_stride,
                                listed, o, n_slots, splits, slots_per_split,
                                experts, s)
              : ema::launch_fma(static_cast<const float*>(a), a_stride,
                                listed, o, n_slots, splits, slots_per_split,
                                experts, s);
  } else if (tensor_cores) {
    if (!a_is_bf16 || d % 8 != 0) return cudaErrorInvalidValue;
    const bf16* ab = static_cast<const bf16*>(a);
    const int mt = (3 * k + 63) / 64;
    err = mt == 1 ? launch_tc<1>(ab, a_stride, src, o, splits,
                                 slots_per_split, experts, s)
          : mt == 2 ? launch_tc<2>(ab, a_stride, src, o, splits,
                                   slots_per_split, experts, s)
                    : launch_tc<3>(ab, a_stride, src, o, splits,
                                   slots_per_split, experts, s);
  } else if (a_is_bf16) {
    err = ema::launch_fma(static_cast<const bf16*>(a), a_stride, src, o,
                          3 * m, splits, slots_per_split, experts, s);
  } else {
    err = ema::launch_fma(static_cast<const float*>(a), a_stride, src, o,
                          3 * m, splits, slots_per_split, experts, s);
  }
  if (err != cudaSuccess || splits == 1) return err;
  return ema::launch_finalize(o, splits, experts, s);
}

const char* psparse_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
