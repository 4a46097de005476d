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
// What the bound hides: the adds land in random buckets of a 168 MB table,
// three times the 50 MB L2. The TPU kernel keeps its table in VMEM (tens of
// KB at its design size) and scatters by a one-hot matmul; at c = 2^23 the
// one-hot alone would be 2048 x 2^23 floats a block.
//
// The first port added each (element, row) with an atomicAdd into device
// memory, the rows one after another so that a row's counters could stay
// in L2: 173 ms, about 32 G random L2 atomics a second, which is the floor
// of that design however it is tuned (index_add_ reaches about 46 G).
//
// Design: a partition by the bucket's high bits, so that every add lands
// in shared memory. A row's c counters are cut into bins of 2^bin_bits
// (2^15 at c = 2^23: 128 KB, 256 bins a row). v is taken in chunks that
// the scratch can hold, and each chunk runs two kernels:
//   csvec_insert_bin_records: a block holds a tile of TILE elements of v
//     in registers and, row by row, counts its elements per bin
//     (shared-memory atomics, whose return value ranks each element
//     within its bin), scans the counts, stages the tile's (bucket, signed
//     value) records sorted by bin in shared memory, and writes them out
//     whole: the tile's row of records is one contiguous 64 KB run of
//     8-byte stores, in tile-major order. The (start, count) of each bin's
//     run goes into a table laid out bin-major, [row][bin][tile], so that
//     a bin reads its runs' words as one contiguous row. Nothing is
//     reserved across blocks: the layout is fixed by the tile's index, so
//     no global atomic is taken;
//   csvec_insert_sum_bins: a block a (bin, row) walks the chunk's tiles in
//     order (their run words staged in shared memory, a warp a run, four
//     runs in flight a warp), adds its records into 2^15 counters in
//     shared memory (shared atomics), then adds the counters onto the
//     table's bin once, without atomics (no other block owns them). A bin
//     wider than 2^15 counters (c > 2^27, which keeps at most 4096 bins a
//     row) is summed in 2^15-counter slices, each reading the records
//     again; at c <= 2^15 a row is one bin.
// Every access of both kernels is a contiguous run: whole tiles on the way
// out, runs of about TILE / nbins records (32 at the train geometry) on
// the way back, walked page by page. An earlier layout, each bin's records
// in one region of the scratch with its runs reserved by a global
// atomicAdd, made every block store into 256 regions a row and was slower.
// Bytes: v once, r n records of 8 bytes written and read once (88 GB at
// the train geometry, 26 ms at the memory's rate), the runs' words (0.6
// byte an element and row), and the table read and written once a chunk
// (21 chunks in the 2 GiB of scratch the wrapper grants: 7 GB). Neither
// kernel reaches the memory's rate: sm_90a has no shared-memory float add,
// so atomicAdd (and red.shared.add.f32) on shared memory compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN), which csvec_insert_sum_bins
// waits on; it runs best at 1024 threads. tools/insert_variants.py times
// these choices.
//
// The sums come out in shared-atomic order, so they differ from the plain
// version's in rounding; the buckets and signs are exact.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_ROWS = 8;
constexpr int BIN_THREADS = 512;                  // the records kernel's block
constexpr int PER_THREAD = 16;                    // elements a thread holds
constexpr int TILE = BIN_THREADS * PER_THREAD;    // elements a block
constexpr int SUM_THREADS = 1024;                 // the summing kernel's block
constexpr int SUM_WARPS = SUM_THREADS / 32;
constexpr int IN_FLIGHT = 4;                      // runs a warp loads at once
constexpr int RUN_BATCH = 4096;                   // run words in shared memory
constexpr int SLICE_BITS = 15;                    // 128 KB of counters
static_assert(TILE < 1 << 16, "a run's start and count are 16 bits each");

struct Hash {
  uint32_t ab[MAX_ROWS], bb[MAX_ROWS], as[MAX_ROWS], bs[MAX_ROWS];
};

struct Geo {
  float* table;         // (rows, cols), added onto
  const float* vec;     // (n,)
  uint2* rec;           // (rows, tiles, TILE) records: bucket, value bits
  unsigned* runs;       // (rows, nbins, tiles) count << 16 | start
  long long n, begin;   // the chunk is [begin, min(begin + len, n))
  int len, tiles;       // tiles = the chunk's TILEs, the layout's stride
  int rows, cols, shift, bin_bits, nbins;
};

__device__ __forceinline__ uint32_t bucket(const Hash& h, int j, int shift,
                                           uint32_t u) {
  return shift >= 32 ? 0u : (h.ab[j] * u + h.bb[j]) >> shift;
}

__device__ __forceinline__ float signed_value(const Hash& h, int j,
                                              uint32_t u, float v) {
  return (h.as[j] * u + h.bs[j]) >> 31 ? -v : v;
}

// off[b] = cnt[0] + ... + cnt[b - 1] over nb <= 4096 bins
__device__ void exclusive_scan(const unsigned* cnt, unsigned* off, int nb) {
  __shared__ unsigned warp_sum[BIN_THREADS / 32];
  const int per = (nb + BIN_THREADS - 1) / BIN_THREADS;
  const int b0 = threadIdx.x * per;
  unsigned own = 0;
  for (int k = 0; k < per; ++k)
    if (b0 + k < nb) own += cnt[b0 + k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = lane < BIN_THREADS / 32 ? warp_sum[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < BIN_THREADS / 32) warp_sum[lane] = w;
  }
  __syncthreads();
  unsigned run = x - own + (warp ? warp_sum[warp - 1] : 0u);
  for (int k = 0; k < per; ++k)
    if (b0 + k < nb) {
      off[b0 + k] = run;
      run += cnt[b0 + k];
    }
  __syncthreads();
}

__global__ void __launch_bounds__(BIN_THREADS)
    csvec_insert_bin_records(Geo g, Hash h) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint2* stage = reinterpret_cast<uint2*>(smem);           // TILE records
  unsigned* cnt = reinterpret_cast<unsigned*>(stage + TILE);
  unsigned* off = cnt + g.nbins;
  // the coefficients in shared memory: indexed by the row, a kernel
  // parameter would be copied to the stack
  __shared__ Hash hs;
  const int tid = threadIdx.x, t = blockIdx.x;
  if (tid < 4 * MAX_ROWS)
    reinterpret_cast<uint32_t*>(&hs)[tid] =
        reinterpret_cast<const uint32_t*>(&h)[tid];
  const long long t0 = g.begin + (long long)t * TILE;
  const int valid = (int)min((long long)TILE, min(g.begin + g.len, g.n) - t0);
  float v[PER_THREAD];
  unsigned rank[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int e = k * BIN_THREADS + tid;
    v[k] = e < valid ? g.vec[t0 + e] : 0.f;
  }
  for (int j = 0; j < g.rows; ++j) {
    for (int b = tid; b < g.nbins; b += BIN_THREADS) cnt[b] = 0;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = k * BIN_THREADS + tid;
      if (e < valid) {
        const uint32_t bk = bucket(hs, j, g.shift, (uint32_t)(t0 + e));
        rank[k] = atomicAdd(cnt + (bk >> g.bin_bits), 1u);
      }
    }
    __syncthreads();
    exclusive_scan(cnt, off, g.nbins);
    unsigned* runs = g.runs + (size_t)j * g.nbins * g.tiles + t;
    for (int b = tid; b < g.nbins; b += BIN_THREADS)
      runs[(size_t)b * g.tiles] = cnt[b] << 16 | off[b];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      const int e = k * BIN_THREADS + tid;
      if (e < valid) {
        const uint32_t u = (uint32_t)(t0 + e);
        const uint32_t bk = bucket(hs, j, g.shift, u);
        stage[off[bk >> g.bin_bits] + rank[k]] =
            make_uint2(bk, __float_as_uint(signed_value(hs, j, u, v[k])));
      }
    }
    __syncthreads();
    uint2* out = g.rec + ((size_t)j * g.tiles + t) * TILE;
    for (int e = tid; e < valid; e += BIN_THREADS) out[e] = stage[e];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(SUM_THREADS) csvec_insert_sum_bins(Geo g) {
  extern __shared__ float acc[];        // a slice of counters, then words
  const int b = blockIdx.x, j = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = (int)((min((long long)g.len, g.n - g.begin) + TILE - 1) /
                       TILE);
  const unsigned* runs = g.runs + ((size_t)j * g.nbins + b) * g.tiles;
  const uint2* rec = g.rec + (size_t)j * g.tiles * TILE;
  const int slice_bits = min(g.bin_bits, SLICE_BITS);
  const unsigned slice = 1u << slice_bits;
  const unsigned local = (1u << g.bin_bits) - 1u;
  unsigned* words = reinterpret_cast<unsigned*>(acc + slice);
  float* row = g.table + (size_t)j * g.cols + ((size_t)b << g.bin_bits);
  for (int s = 0; s < 1 << (g.bin_bits - slice_bits); ++s) {
    for (unsigned k = threadIdx.x; k < slice; k += SUM_THREADS) acc[k] = 0.f;
    auto add = [&](uint2 x) {
      const unsigned at = x.x & local;
      if ((at >> slice_bits) == (unsigned)s)
        atomicAdd(acc + (at & (slice - 1u)), __uint_as_float(x.y));
    };
    for (int tb = 0; tb < nt; tb += RUN_BATCH) {
      const int nw = min(RUN_BATCH, nt - tb);
      for (int k = threadIdx.x; k < nw; k += SUM_THREADS) words[k] = runs[tb + k];
      __syncthreads();
      // a warp takes IN_FLIGHT runs at a time and loads the first 64
      // records of each before it adds any
      for (int i0 = warp; i0 < nw; i0 += IN_FLIGHT * SUM_WARPS) {
        unsigned count[IN_FLIGHT];
        const uint2* at[IN_FLIGHT];
        uint2 r[IN_FLIGHT][2];
#pragma unroll
        for (int q = 0; q < IN_FLIGHT; ++q) {
          const int i = i0 + q * SUM_WARPS;
          const unsigned w = i < nw ? words[i] : 0u;
          count[q] = w >> 16;
          at[q] = rec + (size_t)(tb + i) * TILE + (w & 0xffffu);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (lane + 32 * h < (int)count[q]) r[q][h] = at[q][lane + 32 * h];
        }
#pragma unroll
        for (int q = 0; q < IN_FLIGHT; ++q) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (lane + 32 * h < (int)count[q]) add(r[q][h]);
          for (int e = lane + 64; e < (int)count[q]; e += 32) add(at[q][e]);
        }
      }
      __syncthreads();
    }
    float* dst = row + (size_t)s * slice;
    for (unsigned k = threadIdx.x; k < slice; k += SUM_THREADS)
      dst[k] += acc[k];
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Adds `vec` (n,) into `table` (rows, cols) on `stream`. `coeffs` holds
// 4 * rows uint32 (a_b row, b_b row, a_s row, b_s row). The plan (the
// wrapper's insert_plan): bins of 2^bin_bits counters, chunks of `chunk`
// elements (a multiple of TILE); `rec` holds rows * chunk records of 8
// bytes and `runs` rows * (cols >> bin_bits) * (chunk / TILE) unsigned
// ints. Launches two kernels a chunk. Returns the first cudaGetLastError()
// that is not cudaSuccess, as an int (0 on success).
int csvec_insert_launch(float* table, const float* vec, long long n,
                        int rows, int cols, int shift, const uint32_t* coeffs,
                        void* rec, unsigned* runs, int bin_bits,
                        long long chunk, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || chunk <= 0 || chunk % TILE ||
      chunk > 0x7fffffffLL || bin_bits < 0 || (1LL << bin_bits) > cols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Hash h = {};
  for (int j = 0; j < rows; ++j) {
    h.ab[j] = coeffs[j];
    h.bb[j] = coeffs[rows + j];
    h.as[j] = coeffs[2 * rows + j];
    h.bs[j] = coeffs[3 * rows + j];
  }
  const int nbins = cols >> bin_bits;
  const int bin_smem = TILE * (int)sizeof(uint2) + 2 * nbins * 4;
  const int sum_smem =
      ((1 << (bin_bits < SLICE_BITS ? bin_bits : SLICE_BITS)) + RUN_BATCH) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      csvec_insert_bin_records, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bin_smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(csvec_insert_sum_bins,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sum_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Geo g{table, vec, static_cast<uint2*>(rec), runs, n, 0, (int)chunk,
        (int)(chunk / TILE), rows, cols, shift, bin_bits, nbins};
  for (long long begin = 0; begin < n; begin += chunk) {
    g.begin = begin;
    const long long len = n - begin < chunk ? n - begin : chunk;
    csvec_insert_bin_records<<<(unsigned)((len + TILE - 1) / TILE),
                               BIN_THREADS, bin_smem, st>>>(g, h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    csvec_insert_sum_bins<<<dim3(nbins, rows), SUM_THREADS, sum_smem,
                            st>>>(g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

const char* csvec_insert_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
