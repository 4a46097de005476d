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
// Non-finite tables give the plain version's result too. The network's
// compare-exchanges propagate a NaN (min.NaN / max.NaN, as torch.minimum
// and torch.maximum do; fminf and fmaxf would drop it), and the order puts
// a NaN estimate above every number, +inf included, ties to the smaller
// index, as a stable descending sort does (`better`).
//
// Bound on an H100 SXM. The function reads the table (4 r c bytes) and
// writes 12 k bytes: at the LM train step's geometry (r = 5, c = 2^23,
// D = 1,100,048,384, k = 256 or 512) 168 MB, 0.050 ms at 3.35 TB/s. Its
// f32 work is larger: per coordinate r sign products, r (r - 1) / 2
// compare-exchanges of the median network and an absolute value, 26
// operations at r = 5, 2.9e10 in all, 0.43 ms at 67 TFLOP/s, so the bound
// is set by operations (the integer hash arithmetic is not counted: the
// data sheet gives no integer rate). An estimate of every coordinate
// would need r D = 5.5e9 gathers at random buckets of a table three times
// the 50 MB L2, each a 32-byte sector when it misses, up to 176 GB and
// 52.5 ms: the pruned path below makes few of them.
//
// The search. Blocks run in no order, so it takes passes:
//   pass 1  each block sweeps its own range of coordinates, 256 at a
//           time, computing the estimates in registers. A coordinate that
//           beats the block's current kp-th best (kp = k rounded up to a
//           power of two) is appended to a candidate area of a
//           shared-memory buffer of nb entries; when the next tile might
//           overflow it, a bitonic sort of the whole buffer by (|est|
//           desc, index asc) folds the candidates into the best kp, and
//           raises the threshold. Each block writes its best kp to
//           scratch;
//   pass 2  one block streams the blocks' lists through the same buffer
//           and writes the first k.
// The global top k lies in the union of the blocks' best kp >= k, so the
// result is exact. Sentinels (-inf, INT_MAX) pad every buffer and never
// win. k <= 1024 (checked by the wrapper).
//
// The pruned path (odd r; the wrapper's prune plan) runs pass 1 only over
// coordinates that can reach the top k. For odd r the median is one of the
// r signed values, so |est(i)| >= tau needs at least (r + 1) / 2 rows with
// |table[j, h_j(i)]| >= tau; and any tau0 at or below the k-th best |est|
// drops no member of the top k. So:
//   seed    pass 1 and pass 2 over a strided sample of coordinates (i =
//           j stride, j < sample): tau0 = |the sample's k-th best|;
//   masks   one read of the table: a fine bitmap (a bit a bucket,
//           |table| >= tau; r c / 8 bytes, in L2) and a coarse one (a
//           bit per `group` buckets, their OR), small enough for shared
//           memory (160 KB at r 5, c 2^23: a bit per 32 buckets);
//   pruned  pass 1 over coordinates [0, n) with the coarse bitmap in
//           shared memory: first the rows' coarse bits in turn, stopping
//           once the rows left cannot reach (r + 1) / 2; then, where a
//           coarse bit stands for several buckets, the fine bits of the
//           rows whose coarse bit is set (random lookups in L2, the
//           sweep's costliest step), stopping once decided; only the
//           coordinates that pass gather the table and compete. It
//           counts them (`survivors`);
//   refine  where the plan has one: pruned and pass 2 over the first
//           `refine` coordinates (n = refine) with the masks of tau0, whose
//           k-th best is a second threshold tau1; the masks again at
//           tau = max(tau0, tau1), which each drop no member of the top k;
//   final   pruned (n = D) and pass 2.
// Where half the buckets or more hold |table| >= tau0 (the masks count
// them), most coordinates would pass and the row tests would only add
// to the unpruned cost: the refine then writes no candidate and the
// final sweep is the unpruned pass 1 (both are launched; each reads the
// count on the card and the one not wanted returns at once), so a flat
// table costs the unpruned search plus the seed and the masks.
// The same switch is taken where the table holds a NaN anywhere (the
// first masks count them) or tau0 or tau is not finite. A NaN estimate
// ranks first but its row test never passes (|NaN| >= tau is false), and
// a NaN or inf threshold says nothing of the coordinates below it. An inf
// in the table with finite thresholds keeps the pruned path, exactly:
// with no NaN every estimate is one of its r signed values (odd r), so
// |est| >= tau still needs (r + 1) / 2 rows with |table| >= tau, and inf
// is at or above every tau.
// A tie at tau0 passes (>=), as ties go to the smaller index. For even r
// the midpoint can round up to tau from two values below it, so even r
// takes the unpruned passes. A flat table passes every coordinate and
// costs the unpruned pass plus the seed and the masks.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int PRUNE_THREADS = 1024;   // threads of a pruned pass-1 block
constexpr int MAX_ROWS = 8;

struct Hash {
  uint32_t ab[MAX_ROWS], bb[MAX_ROWS], as[MAX_ROWS], bs[MAX_ROWS];
};

// (m1, i1) before (m2, i2) in select_topk's order of |estimate|: a NaN
// first, then by magnitude, ties to the smaller index. The sentinels'
// -inf lies below every entry, zero included.
__device__ __forceinline__ bool better(float m1, int i1, float m2, int i2) {
  const bool n1 = m1 != m1, n2 = m2 != m2;
  if (n1 || n2) return n1 && (!n2 || i1 < i2);
  return m1 > m2 || (m1 == m2 && i1 < i2);
}

// torch.minimum / torch.maximum: a NaN in either operand gives a NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
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
  for (int t = threadIdx.x; t < b.nb; t += blockDim.x) set_sentinel(b, t);
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
      for (int t = threadIdx.x; t < b.nb / 2; t += blockDim.x) {
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
  const bool full = *count > b.nb - b.kp - (int)blockDim.x;
  __syncthreads();
  return full;
}

// Folds the candidates into the best kp and raises the threshold to the
// kp-th best. Every thread of the block, after a __syncthreads.
__device__ void fold(Buf b, int* count, float* thr_mag, int* thr_idx) {
  bitonic_sort_desc(b);
  for (int t = b.kp + threadIdx.x; t < b.nb; t += blockDim.x)
    set_sentinel(b, t);
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
      e[j] = min_nan(a, c);
      e[j + 1] = max_nan(a, c);
    }
  }
  if constexpr (R & 1) {
    return e[R / 2];
  } else {
    return __fmul_rn(__fadd_rn(e[R / 2 - 1], e[R / 2]), 0.5f);
  }
}

// The pruned path's switch to the unpruned sweep, read on the card:
// where the first masks found the table dense (counters[2], the buckets at
// or above tau0, half of `buckets` or more) or a NaN in it (counters[4]),
// or tau0 (tau[k - 1]) or, after the refining sweep, tau1 (tau[2 k - 1])
// is not finite. `counters` null means no switch.
struct Gate {
  const unsigned long long* counters;
  const float* tau;
  long long buckets;
  int k;
  int after_refine;
  int* n_lists;                    // the lists pass 2 reads, set by the
  unsigned long long* survivors;   // sweep that runs; its count
  __device__ __forceinline__ bool unpruned() const {
    if (2 * counters[2] >= (unsigned long long)buckets || counters[4] != 0)
      return true;
    return !isfinite(tau[k - 1]) ||
           (after_refine && !isfinite(tau[2 * k - 1]));
  }
};

// the block's kp best as sentinels (a sweep that does not run)
__device__ void write_sentinels(int kp, float* out_mag, float* out_val,
                                int* out_idx) {
  for (int t = threadIdx.x; t < kp; t += blockDim.x) {
    const size_t o = (size_t)blockIdx.x * kp + t;
    out_mag[o] = -INFINITY;
    out_val[o] = 0.f;
    out_idx[o] = INT_MAX;
  }
}

// Block lists of the best kp among coordinates i = p stride, p < dim.
// With a gate (the pruned path's unpruned sweep) it runs only where the
// gate switches to it, and otherwise writes sentinel lists.
template <int R>
__global__ void __launch_bounds__(THREADS)
    topk_pass1(const float* __restrict__ table, int cols, int shift, Hash h,
               long long dim, long long stride, long long per_block, int kp,
               int nb, Gate gate, float* __restrict__ out_mag,
               float* __restrict__ out_val, int* __restrict__ out_idx) {
  if (gate.counters != nullptr) {
    if (!gate.unpruned()) {
      write_sentinels(kp, out_mag, out_val, out_idx);
      return;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *gate.n_lists = gridDim.x;
      *gate.survivors = (unsigned long long)dim;
    }
  }
  extern __shared__ float smem[];
  const Buf b{smem, smem + nb, reinterpret_cast<int*>(smem + 2 * nb), kp, nb};
  __shared__ int count, thr_idx;
  __shared__ float thr_mag;
  init_buf(b, &count, &thr_mag, &thr_idx);
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = min(dim, start + per_block);
  for (long long base = start; base < end; base += THREADS) {
    const long long i = (base + threadIdx.x) * stride;
    if (base + threadIdx.x < end) {
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

// The masks of the pruned path at tau = |tau_a[at]|, or max(|tau_a[at]|,
// |tau_b[at]|) where tau_b is not null. Fine bit b of row j (word
// j nfw + b / 32):
// |table[j, b]| >= tau. Coarse bit g (word j ncw + g / 32): the OR of
// fine bits [g group, (g + 1) group). One warp an item of 32 coarse bits
// (32 group buckets): per step, each lane reads one bucket, a ballot
// makes the fine word, and each lane ORs in the bits of its coarse
// group. Where `bits` is not null the set fine bits are added to it, and
// the table's NaN entries to `nans`.
__global__ void __launch_bounds__(THREADS)
    topk_masks(const float* __restrict__ table, int rows, int cols,
               int group, const float* __restrict__ tau_a,
               const float* __restrict__ tau_b, int at, int nfw, int ncw,
               uint32_t* __restrict__ fine, uint32_t* __restrict__ coarse,
               unsigned long long* __restrict__ bits,
               unsigned long long* __restrict__ nans) {
  // a NaN tau0 stays NaN (no bucket passes), as the plain emulation has it
  const float tau = tau_b == nullptr ? fabsf(tau_a[at])
                                     : fmaxf(fabsf(tau_a[at]),
                                             fabsf(tau_b[at]));
  const int lane = threadIdx.x & 31;
  const long long items = (long long)rows * ncw;
  const long long warps = (long long)gridDim.x * (blockDim.x / 32);
  unsigned long long set = 0, nan = 0;
  for (long long it = (long long)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
       it < items; it += warps) {
    const int j = (int)(it / ncw), w = (int)(it % ncw);
    const float* row = table + (size_t)j * cols;
    const long long b0 = (long long)w * 32 * group;  // the item's first
    bool any = false;
    for (int s = 0; s < group; ++s) {
      const long long b = b0 + 32LL * s + lane;
      if (b0 + 32LL * s >= cols) break;
      const bool hit = b < cols && fabsf(row[b]) >= tau;
      const uint32_t word = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) fine[(size_t)j * nfw + (b0 >> 5) + s] = word;
      set += __popc(word);
      nan += __popc(
          __ballot_sync(0xffffffffu, b < cols && row[b] != row[b]));
      // this lane's coarse bits [lane group, (lane + 1) group) of the
      // item against the word's [32 s, 32 s + 32)
      const int lo = max(lane * group, 32 * s);
      const int hi = min((lane + 1) * group, 32 * s + 32);
      if (lo < hi) {
        const int n = hi - lo;
        const uint32_t mask = n >= 32 ? 0xffffffffu : (1u << n) - 1u;
        any |= ((word >> (lo - 32 * s)) & mask) != 0u;
      }
    }
    const uint32_t cw = __ballot_sync(0xffffffffu, any);
    if (lane == 0) coarse[(size_t)j * ncw + w] = cw;
  }
  if (bits != nullptr && lane == 0 && set) atomicAdd(bits, set);
  if (nans != nullptr && lane == 0 && nan) atomicAdd(nans, nan);
}

// Pass 1 over coordinates [0, dim) that pass the row test: at least
// NEED of the r rows with |table| >= tau by the masks. The coarse bitmap
// lives in shared memory behind the buffer: each coordinate's coarse
// bits are tested first, row by row until the rows left cannot reach
// NEED; where a coarse bit stands for several buckets (gshift > 0) the
// rows whose coarse bit is set are then confirmed in the fine bitmap,
// row by row until decided. A thread tests PER coordinates of a tile
// together (their lookups in flight at once); a tile with no survivor
// costs one barrier.
// In a tile with survivors each thread gathers the estimates of its own
// at once, then pushes those that beat the threshold a coordinate at a
// time, each round that has a candidate behind two barriers (the second
// keeps every thread's read of the count before the round's pushes: a
// thread that read it after another's push could take the fold's
// barriers alone) and, where the buffer might overflow, a fold. One
// block an SM (its shared memory), so the launch bounds let a thread
// hold 64 registers. Where the gate switches to the
// unpruned sweep this one does not run: it writes sentinel lists if
// `sentinels_if_dense` (the refining sweep), else nothing (the final
// one, whose lists the gated pass 1 writes).
template <int R>
__global__ void __launch_bounds__(PRUNE_THREADS, 1)
    topk_pruned(const float* __restrict__ table, int cols, int shift, Hash h,
                long long dim, long long per_block, int kp, int nb,
                int gshift, int nfw, int ncw,
                const uint32_t* __restrict__ fine,
                const uint32_t* __restrict__ coarse,
                unsigned long long* __restrict__ survivors, Gate gate,
                int sentinels_if_dense, float* __restrict__ out_mag,
                float* __restrict__ out_val, int* __restrict__ out_idx) {
  constexpr int NEED = (R + 1) / 2;
  constexpr int PER = 4;
  if (gate.unpruned()) {
    if (sentinels_if_dense) write_sentinels(kp, out_mag, out_val, out_idx);
    return;
  }
  if (gate.n_lists != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    *gate.n_lists = gridDim.x;
  extern __shared__ float smem[];
  const Buf b{smem, smem + nb, reinterpret_cast<int*>(smem + 2 * nb), kp, nb};
  uint32_t* cm = reinterpret_cast<uint32_t*>(smem + 3 * nb);
  __shared__ int count, thr_idx;
  __shared__ float thr_mag;
  __shared__ unsigned int passed;
  for (int t = threadIdx.x; t < R * ncw; t += blockDim.x) cm[t] = coarse[t];
  if (threadIdx.x == 0) passed = 0u;
  init_buf(b, &count, &thr_mag, &thr_idx);
  unsigned int mine = 0u;
  const long long start = (long long)blockIdx.x * per_block;
  const long long end = min(dim, start + per_block);
  const long long tile = (long long)PER * blockDim.x;
  for (long long base = start; base < end; base += tile) {
    long long i[PER];
    int miss[PER], hits[PER];
    uint32_t set[PER];               // the rows whose coarse bit is set
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      i[u] = base + u * (long long)blockDim.x + threadIdx.x;
      miss[u] = i[u] < end ? 0 : R;  // past the range: never passes
      set[u] = 0u;
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        if (R - miss[u] < NEED) continue;
        const uint32_t bk =
            shift >= 32 ? 0u : (h.ab[j] * (uint32_t)i[u] + h.bb[j]) >> shift;
        const uint32_t g = bk >> gshift;
        if ((cm[j * ncw + (g >> 5)] >> (g & 31)) & 1u)
          set[u] |= 1u << j;
        else
          ++miss[u];
      }
#pragma unroll
    for (int u = 0; u < PER; ++u)
      hits[u] = R - miss[u] >= NEED ? (gshift > 0 ? 0 : __popc(set[u])) : 0;
    if (gshift > 0) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uint32_t bk[PER], word[PER];
        bool live[PER];
#pragma unroll
        for (int u = 0; u < PER; ++u) {
          live[u] = R - miss[u] >= NEED && ((set[u] >> j) & 1u) &&
                    hits[u] < NEED && hits[u] + __popc(set[u] >> j) >= NEED;
          bk[u] = shift >= 32 ? 0u
                              : (h.ab[j] * (uint32_t)i[u] + h.bb[j]) >> shift;
        }
#pragma unroll
        for (int u = 0; u < PER; ++u)
          word[u] = live[u] ? __ldg(fine + (size_t)j * nfw + (bk[u] >> 5))
                            : 0u;
#pragma unroll
        for (int u = 0; u < PER; ++u)
          hits[u] += live[u] && ((word[u] >> (bk[u] & 31)) & 1u);
      }
    }
    int pass = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u) pass |= (hits[u] >= NEED) << u;
    if (!__syncthreads_or(pass)) continue;
    float est[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u)
      est[u] = (pass >> u) & 1
                   ? estimate<R>(table, cols, shift, h, (uint32_t)i[u])
                   : 0.f;
    mine += __popc(pass);
    // candidates against the threshold as it stands (a fold below only
    // raises it: a candidate pushed after one is kept or sorted out)
    int cand = 0;
#pragma unroll
    for (int u = 0; u < PER; ++u)
      cand |= (((pass >> u) & 1) &&
               better(fabsf(est[u]), (int)i[u], thr_mag, thr_idx)) << u;
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      if (!__syncthreads_or((cand >> u) & 1)) continue;
      // every thread reads the count before any thread's push, so that
      // all take the fold (and its barriers) or none does
      const bool full = count > nb - kp - (int)blockDim.x;
      __syncthreads();
      if (full) fold(b, &count, &thr_mag, &thr_idx);
      if ((cand >> u) & 1) push(b, &count, fabsf(est[u]), (int)i[u], est[u]);
    }
  }
  __syncthreads();     // the last round's pushes
  if (count > 0) fold(b, &count, &thr_mag, &thr_idx);
  if (mine) atomicAdd(&passed, mine);
  for (int t = threadIdx.x; t < kp; t += blockDim.x) {
    const size_t o = (size_t)blockIdx.x * kp + t;
    out_mag[o] = b.mag[t];
    out_val[o] = b.val[t];
    out_idx[o] = b.idx[t];
  }
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(survivors, (unsigned long long)passed);
}

__global__ void __launch_bounds__(THREADS)
    topk_pass2(const float* __restrict__ in_mag,
               const float* __restrict__ in_val,
               const int* __restrict__ in_idx, int n_in,
               const int* __restrict__ n_lists, int kp, int nb, int k,
               float* __restrict__ out_val, long long* __restrict__ out_idx) {
  if (n_lists != nullptr) n_in = *n_lists * kp;
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
                  long long dim, long long stride, long long per_block,
                  int kp, int nb, int blocks, const Gate& gate, size_t smem,
                  cudaStream_t s, float* s_mag, float* s_val, int* s_idx) {
  topk_pass1<R><<<blocks, THREADS, smem, s>>>(table, cols, shift, h, dim,
                                               stride, per_block, kp, nb,
                                               gate, s_mag, s_val, s_idx);
}

template <int R>
cudaError_t launch_pruned(const float* table, int cols, int shift,
                          const Hash& h, long long dim, long long per_block,
                          int kp, int nb, int blocks, int gshift, int nfw,
                          int ncw, const uint32_t* fine,
                          const uint32_t* coarse,
                          unsigned long long* survivors, const Gate& gate,
                          int sentinels_if_dense, cudaStream_t s,
                          float* s_mag, float* s_val, int* s_idx) {
  const size_t smem = (size_t)nb * (2 * sizeof(float) + sizeof(int)) +
                      (size_t)R * ncw * sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      topk_pruned<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  topk_pruned<R><<<blocks, PRUNE_THREADS, smem, s>>>(
      table, cols, shift, h, dim, per_block, kp, nb, gshift, nfw, ncw, fine,
      coarse, survivors, gate, sentinels_if_dense, s_mag, s_val, s_idx);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Top-k of the sketched vector on `stream`. `coeffs` holds 4 * rows uint32
// (a_b row, b_b row, a_s row, b_s row); kp is a power of two >= k, nb a
// power of two >= kp + 2 * 256; the scratch holds blocks * kp entries.
// With sample > 0 (odd rows) the pruned path runs: pass 1 and 2 over the
// sample (coordinates p stride, p < sample; sample_blocks blocks of
// sample_per_block) into tau_val / tau_idx [0, k), the masks with a
// coarse bit per 2^gshift buckets into fine (rows * nfw words) and coarse
// (rows * ncw words); where refine > 0 the pruned pass over [0, refine)
// (refine_blocks blocks of refine_per_block) and pass 2 into tau_val /
// tau_idx [k, 2 k) and the masks again; then the gated unpruned pass 1
// (blocks of per_block), the pruned pass over [0, dim) (pruned_blocks
// blocks of pruned_per_block coordinates) and pass 2 over the lists of
// the one that ran. The pruned passes' buffers hold pruned_nb >= kp + 2 *
// 1024 entries. counters (5 int64, zeroed by the caller): the
// coordinates that pass the refining and the final row tests (dim where
// the unpruned sweep runs), the first masks' set bits, (the low word)
// the lists pass 2 reads, and the table's NaN entries. The scratch then
// holds max(sample_blocks, refine_blocks, blocks, pruned_blocks) * kp
// entries. Returns
// cudaGetLastError() as an int (0 on success).
int csvec_topk_launch(const float* table, int rows, int cols, int shift,
                      const uint32_t* coeffs, long long dim, int k, int kp,
                      int nb, int blocks, long long per_block, float* s_mag,
                      float* s_val, int* s_idx, float* out_val,
                      long long* out_idx, long long sample, long long stride,
                      int sample_blocks, long long sample_per_block,
                      long long refine, int refine_blocks,
                      long long refine_per_block, int gshift,
                      int pruned_blocks, long long pruned_per_block,
                      int pruned_nb, uint32_t* fine, uint32_t* coarse,
                      float* tau_val, long long* tau_idx,
                      unsigned long long* counters, void* stream) {
  if (rows < 1 || rows > MAX_ROWS || kp < k || nb < kp + 2 * THREADS)
    return (int)cudaErrorInvalidValue;
  if (sample > 0 && (rows % 2 == 0 || sample < k || stride < 1 ||
                     refine < 0 || refine > dim ||
                     pruned_nb < kp + 2 * PRUNE_THREADS || gshift < 0 ||
                     (1LL << gshift) > cols))
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
  const Gate none{nullptr, nullptr, 0, 0, 0, nullptr, nullptr};
  cudaError_t err;
  if (sample > 0) {
    int* n_lists = reinterpret_cast<int*>(counters + 3);
    const Gate refine_gate{counters, tau_val, (long long)rows * cols, k, 0,
                           nullptr, nullptr};
    const Gate final_gate{counters, tau_val, (long long)rows * cols, k,
                          refine > 0, n_lists, counters + 1};
    switch (rows) {
#define SEED(R)                                                           \
  case R:                                                                 \
    launch_pass1<R>(table, cols, shift, h, sample, stride,                \
                    sample_per_block, kp, nb, sample_blocks, none, smem,  \
                    s, s_mag, s_val, s_idx);                              \
    break;
      SEED(1) SEED(3) SEED(5) SEED(7)
#undef SEED
    }
    topk_pass2<<<1, THREADS, smem, s>>>(s_mag, s_val, s_idx,
                                        sample_blocks * kp, nullptr, kp, nb,
                                        k, tau_val, tau_idx);
    const int group = 1 << gshift;
    const int nfw = (cols + 31) / 32;
    const int ncw = (cols / group + 31) / 32;
    const int mask_blocks = (rows * ncw + 7) / 8;
    topk_masks<<<mask_blocks, THREADS, 0, s>>>(
        table, rows, cols, group, tau_val, nullptr, k - 1, nfw, ncw, fine,
        coarse, counters + 2, counters + 4);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    // the pruned pass over [0, n) into the scratch lists
    const auto pruned = [&](long long n, int nblk, long long per,
                            unsigned long long* count, const Gate& gate,
                            int sentinels_if_dense) -> cudaError_t {
      cudaError_t e = cudaSuccess;
      switch (rows) {
#define PRUNED(R)                                                          \
  case R:                                                                  \
    e = launch_pruned<R>(table, cols, shift, h, n, per, kp, pruned_nb,     \
                         nblk, gshift, nfw, ncw, fine, coarse, count,      \
                         gate, sentinels_if_dense, s, s_mag, s_val,        \
                         s_idx);                                           \
    break;
        PRUNED(1) PRUNED(3) PRUNED(5) PRUNED(7)
#undef PRUNED
      }
      return e;
    };
    if (refine > 0) {
      err = pruned(refine, refine_blocks, refine_per_block, counters,
                   refine_gate, 1);
      if (err != cudaSuccess) return (int)err;
      topk_pass2<<<1, THREADS, smem, s>>>(s_mag, s_val, s_idx,
                                          refine_blocks * kp, nullptr, kp,
                                          nb, k, tau_val + k, tau_idx + k);
      topk_masks<<<mask_blocks, THREADS, 0, s>>>(
          table, rows, cols, group, tau_val, tau_val + k, k - 1, nfw, ncw,
          fine, coarse, nullptr, nullptr);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    // the unpruned sweep where the table is dense (sentinels otherwise),
    // then the pruned one where it is not: pass 2 reads the lists of the
    // one that ran
    switch (rows) {
#define GATED(R)                                                          \
  case R:                                                                 \
    launch_pass1<R>(table, cols, shift, h, dim, 1, per_block, kp, nb,     \
                    blocks, final_gate, smem, s, s_mag, s_val, s_idx);    \
    break;
      GATED(1) GATED(3) GATED(5) GATED(7)
#undef GATED
    }
    err = pruned(dim, pruned_blocks, pruned_per_block, counters + 1,
                 final_gate, 0);
    if (err != cudaSuccess) return (int)err;
    topk_pass2<<<1, THREADS, smem, s>>>(s_mag, s_val, s_idx, 0, n_lists, kp,
                                        nb, k, out_val, out_idx);
    return static_cast<int>(cudaGetLastError());
  }
  switch (rows) {
#define PASS1(R)                                                         \
  case R:                                                                \
    launch_pass1<R>(table, cols, shift, h, dim, 1, per_block, kp, nb,    \
                    blocks, none, smem, s, s_mag, s_val, s_idx);         \
    break;
    PASS1(1) PASS1(2) PASS1(3) PASS1(4) PASS1(5) PASS1(6) PASS1(7) PASS1(8)
#undef PASS1
  }
  topk_pass2<<<1, THREADS, smem, s>>>(s_mag, s_val, s_idx, blocks * kp,
                                      nullptr, kp, nb, k, out_val, out_idx);
  return static_cast<int>(cudaGetLastError());
}

const char* csvec_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
