// Count-sketch insert of a flat vector into all r hash rows, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/csvec_insert.py::csvec_insert
// (its pallas_call). For a table (r, c) f32, c a power of two, hash
// coefficients (a_b, b_b, a_s, b_s) per row and a vector v (n,) f32 it adds
//
//   table[j, (a_b[j] i + b_b[j]) >> (32 - log2 c)] += s_j(i) v[i],
//   s_j(i) = 1 - 2 ((a_s[j] i + b_s[j]) >> 31),
//
// for every i < n and row j, in uint32 arithmetic that wraps. The table is
// added onto, not overwritten, as the reference's kernel starts from its
// input table.
//
// Bound on an H100 SXM (3.35 TB/s). The call must read v (4 n bytes) and
// read and write the table (2 * 4 r c bytes). At the LM train step's
// geometry (n = 1,100,048,384, r = 5, c = 2^23) that is 4.40 GB + 0.34 GB,
// 1.41 ms. Its r n float adds are 5.5e9 operations, 0.08 ms at the f32 rate.
// What the bound hides: the adds land in random buckets, and a 168 MB table
// does not fit the 50 MB L2, so each add costs an atomic read-modify-write
// of a 32-byte sector in device memory if nothing is done about it.
//
// Design. The TPU kernel keeps the whole table in VMEM (tens of KB at its
// design size) and turns the scatter into a one-hot matmul on the MXU; at
// c = 2^23 the one-hot alone would be 2048 x 2^23 floats a block. Here the
// scatter is an atomicAdd per (element, row), and the hashes are computed
// in registers from the element's index:
//   * gridDim.y = r: block (x, j) adds only into row j. Blocks are issued in
//     order of x + j * gridDim.x, so the card works through row 0's blocks
//     before row 1's: while a row's blocks run, its 33.5 MB of counters can
//     stay in L2, at the price of reading v once per row (r * 4 n bytes);
//   * each block strides over v with 64-bit offsets; neighbouring threads
//     read neighbouring elements;
//   * the sums come out in atomic order, so they differ from the plain
//     version's in rounding (the buckets and signs are exact).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 8;

struct Hash {
  uint32_t ab[MAX_ROWS], bb[MAX_ROWS], as[MAX_ROWS], bs[MAX_ROWS];
};

__global__ void __launch_bounds__(THREADS)
    csvec_insert_kernel(float* __restrict__ table,
                        const float* __restrict__ vec, long long n, int cols,
                        int shift, Hash h) {
  const int j = blockIdx.y;
  const uint32_t ab = h.ab[j], bb = h.bb[j], as = h.as[j], bs = h.bs[j];
  float* row = table + (size_t)j * cols;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float v = vec[i];
    const uint32_t u = (uint32_t)i;
    const uint32_t b = shift >= 32 ? 0u : (ab * u + bb) >> shift;
    const uint32_t s = (as * u + bs) >> 31;
    atomicAdd(row + b, s ? -v : v);
  }
}

}  // namespace

extern "C" {

// Adds `vec` (n,) into `table` (rows, cols) on `stream`. `coeffs` holds
// 4 * rows uint32 (a_b row, b_b row, a_s row, b_s row). Returns
// cudaGetLastError() as an int (0 on success).
int csvec_insert_launch(float* table, const float* vec, long long n,
                        int rows, int cols, int shift, const uint32_t* coeffs,
                        int blocks, void* stream) {
  if (rows < 1 || rows > MAX_ROWS) return (int)cudaErrorInvalidValue;
  Hash h = {};
  for (int j = 0; j < rows; ++j) {
    h.ab[j] = coeffs[j];
    h.bb[j] = coeffs[rows + j];
    h.as[j] = coeffs[2 * rows + j];
    h.bs[j] = coeffs[3 * rows + j];
  }
  const dim3 grid(blocks, rows);
  csvec_insert_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, vec, n, cols, shift, h);
  return static_cast<int>(cudaGetLastError());
}

const char* csvec_insert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
