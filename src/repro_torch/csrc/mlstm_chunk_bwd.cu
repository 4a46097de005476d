// Gradient of the chunkwise stabilised mLSTM forward (csrc/mlstm_chunk.cu)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package trains the mLSTM through
// jax.grad of its scan, src/repro/models/ssm.py::_mlstm_chunk_scan, and
// has no Pallas backward. Inputs are the forward's: q, k (B, H, S, Dk),
// v (B, H, S, Dv) in f32 or bf16 with any b/h/s strides and unit stride
// along the last dimension; li, lf (B, H, S) f32; h and its gradient dh
// (B, H, S, Dv) f32, contiguous. Out: dq, dk, dv in the inputs' type and
// dli, dlf f32, all contiguous; C, n and m carry no gradient. Each
// output is rounded once.
//
// The stabilisers are constants (h is the unstabilised num over max(|den|,
// 1) whatever m is), so with the forward's F, D, S, e (inter-chunk
// weights), w (key weights), g (chunk decays), C_c and n_c (a chunk's
// starting state) and M_r = max(|den_r|, exp(-mj_r)):
//   dnum_r = dh_r / M_r,  dden_r = -[|den_r| >= exp(-mj_r)] sign(den_r)
//            (dh_r . h_r) / M_r
//   dS = dnum v^T + dden,  dP = dS * D,  dwlog = dS * S   (t <= r)
//   dq = scale (dP k + e (C_c dnum + dden n_c)),
//   dk = dP^T (scale q) + w (dC v + dn),  dv = S^T dnum + w (k dC)
//   dC_c = g dC + (e scale q)^T dnum,  dn_c = g dn + (e dden scale q)
// where dC and dn are the gradient of the chunk's end state, swept from
// the last chunk (zero) to the first. dF = rowsum(dwlog) - colsum(dwlog)
// + de e - dw w, plus dg g + sum_t dw_t w_t at the chunk's last row;
// dli = colsum(dwlog) + dw w; dlf is the reversed in-chunk sum of dF.
//
// Two paths. bf16 inputs at xlstm's widths take the tensor cores
// (namespace tc below: nine kernels, the products on wgmma). Every other
// input takes six FMA kernels, every product in f32, in order on the
// caller's stream, through one f32 scratch buffer that the wrapper
// allocates (mlstm_chunk_bwd_workspace floats):
//   gates    one block per (b, h): F, the chain of m, w, g, and each row's
//            mj and e, as the forward's gates and scores kernels take them.
//   states   one block per (b, h) and 32 value columns: C_c[:, cols] and
//            n_c for every chunk, recomputed (B H nc Dk Dv floats; no
//            state is saved by the forward).
//   scores   one block per 64 rows of a chunk: P = (scale q) k^T, S, den,
//            M, dden, then dnum v^T, dS, dP; writes S and dP (W x W a
//            chunk), M, dden, rowsum(dwlog) and its column sums.
//   sweep    one block per (b, h) and 32 value columns, holding dC[:, cols]
//            (and dn) in shared memory across the chunks in reverse: dv,
//            each chunk's dC and dn at its end, and <dC, C_c>.
//   dqdk     one block per 64 rows and 64 key columns of a chunk: dq, dk
//            and the rows' partial de and dw over those columns.
//   grads    one block per (b, h): dli and dlf.
// The FMA path's bound on an H100 SXM, per chunk of a (b, h): the causal
// products P, dnum v^T, S^T dnum, dP k and dP^T q (W (W + 1) (3 Dk + 2 Dv)
// operations) and
// the state products (C_c dnum, dC v, k dC, the dC update and the
// recomputed C update: 10 W Dk Dv) at 67 TFLOP/s: at B 4, H 4, S 512, Dk
// 512, Dv 1024, W 256 that is 50.5 GFLOP, 0.75 ms, against 0.04 ms of
// bytes (bf16 q, k, v and their gradients, f32 h, dh and the gates'
// rows: 134 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mlstm_tc.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT = 256;           // threads of every block but the gates'
constexpr int WMAX = 256;         // rows of a chunk at most
constexpr int DKMAX = 512;        // key width at most
constexpr int RB = 64;            // rows of a scores or dqdk block
constexpr int DVB = 32;           // value columns of a states or sweep block
constexpr int DKB = 64;           // key columns of a dqdk block
constexpr int TD = 32;            // depth of a product tile
constexpr int TU = 8;             // rows of a state-update tile
constexpr int LDW = WMAX + 4;     // padded (depth, key) tile row
constexpr int LDR = RB + 4;       // padded (depth, row) tile row
constexpr int LDB = DKB + 4;      // padded (depth, key column) tile row

struct Strides {
  long long b, h, s;              // in elements; the last stride is 1
};

struct Dims {
  int B, H, S, Dk, Dv, W, nc;
  int nrb, nds, ndv;              // 64-row blocks, 64-wide Dk and 32-wide Dv
};

// The scratch buffer's regions, all f32.
struct Work {
  float *F, *wkv, *mj, *inter, *Md, *dden, *rsum, *dww;  // (B H, S)
  float *dinter_p, *dwkv_p;       // (B H S, nds) partial de and dw
  float *mstart, *decay;          // (B H, nc)
  float *dg_p;                    // (B H, nc, ndv) partial <dC, C_c>
  float *csum_p;                  // (B H, nc, nrb, W) column sums of dwlog
  float *n0, *dn1;                // (B H, nc, Dk) n at a chunk's start, dn
                                  // at its end
  float *Sx, *dPx;                // (B H, nc, W, W)
  float *C0, *dC1;                // (B H, nc, Dk, Dv) C at a chunk's start,
                                  // dC at its end
};

// tc: the tensor-core path's partial sums (two 256-wide key tiles for
// de and dw; dg's terms: one a (64 value, 256 key) state tile, then one
// a 32 key columns of dn)
Dims make_dims(int B, int H, int S, int Dk, int Dv, int W, bool tc) {
  if (tc)
    return Dims{B, H, S, Dk, Dv, W, S / W, W / RB, Dk / 256,
                Dv / 64 * (Dk / 256) + Dk / 32};
  return Dims{B, H, S, Dk, Dv, W, S / W, (W + RB - 1) / RB,
              (Dk + DKB - 1) / DKB, (Dv + DVB - 1) / DVB};
}

// Carves the scratch buffer at `base` into `o` (with base null, only
// counts it): each region rounded up to 64 floats. Returns the floats
// the regions take.
long long carve(Work& o, float* base, const Dims& d) {
  long long at = 0;
  auto take = [&](float*& p, long long n) {
    p = base ? base + at : nullptr;
    at += (n + 63) / 64 * 64;
  };
  const long long bh = (long long)d.B * d.H, rows = bh * d.S;
  const long long chunks = bh * d.nc;
  float** row_regions[8] = {&o.F,  &o.wkv,  &o.mj,   &o.inter,
                            &o.Md, &o.dden, &o.rsum, &o.dww};
  for (int i = 0; i < 8; ++i) take(*row_regions[i], rows);
  take(o.dinter_p, rows * d.nds);
  take(o.dwkv_p, rows * d.nds);
  take(o.mstart, chunks);
  take(o.decay, chunks);
  take(o.dg_p, chunks * d.ndv);
  take(o.csum_p, chunks * d.nrb * d.W);
  take(o.n0, chunks * d.Dk);
  take(o.dn1, chunks * d.Dk);
  take(o.Sx, chunks * d.W * d.W);
  take(o.dPx, chunks * d.W * d.W);
  take(o.C0, chunks * d.Dk * d.Dv);
  take(o.dC1, chunks * d.Dk * d.Dv);
  return at;
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---- gates: F, m, w, g, mj, e (the forward's arithmetic) ----

__global__ void bwd_gates_kernel(const float* __restrict__ li,
                                 const float* __restrict__ lf, Work w,
                                 int S, int W, int nc) {
  __shared__ float m_end;
  const long long bh = blockIdx.x;
  const float* lib = li + bh * S;
  const float* lfb = lf + bh * S;
  float* Fb = w.F + bh * S;
  float* ms = w.mstart + bh * nc;
  float* dc = w.decay + bh * nc;
  // each thread a chunk: F in sequence, then max_t (Ftot - F_t) + li_t,
  // kept in decay[] until the chain below reads it
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t0 = c * W;
    float acc = 0.f;
    for (int t = 0; t < W; ++t) {
      acc += lfb[t0 + t];
      Fb[t0 + t] = acc;
    }
    float mkv = -INFINITY;
    for (int t = 0; t < W; ++t)
      mkv = fmaxf(mkv, (acc - Fb[t0 + t]) + lib[t0 + t]);
    dc[c] = mkv;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float ftot = Fb[c * W + W - 1];
      const float mn = fmaxf(ftot + m, dc[c]);
      ms[c] = m;
      dc[c] = expf((ftot + m) - mn);
      m = mn;
    }
    m_end = m;
  }
  // each chunk's F and li in shared memory, its rows in parallel
  __shared__ float Fs[WMAX], ls[WMAX];
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * W;
    __syncthreads();
    for (int r = threadIdx.x; r < W; r += blockDim.x) {
      Fs[r] = Fb[t0 + r];
      ls[r] = lib[t0 + r];
    }
    __syncthreads();
    const float ftot = Fs[W - 1];
    const float mn = c + 1 < nc ? ms[c + 1] : m_end;
    for (int r = threadIdx.x; r < W; r += blockDim.x) {
      const long long i = bh * S + t0 + r;
      w.wkv[i] = expf(((ftot - Fs[r]) + ls[r]) - mn);
      float mx = -INFINITY;
      for (int u = 0; u <= r; ++u) mx = fmaxf(mx, (Fs[r] - Fs[u]) + ls[u]);
      const float bi = Fs[r] + ms[c];
      const float mj = fmaxf(mx, bi);
      w.mj[i] = mj;
      w.inter[i] = expf(bi - mj);
    }
  }
}

// ---- states: C_c[:, cols] and n_c of every chunk, recomputed ----

size_t states_smem(int Dk) {
  const int ldk = Dk + 4;
  return sizeof(float) * (Dk * DVB + Dk + TU * ldk + TU * DVB);
}

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_states_kernel(const T* __restrict__ k, const T* __restrict__ v,
                  Strides sk, Strides sv, Work w, Dims dm) {
  extern __shared__ __align__(16) float smem[];
  const int Dk = dm.Dk, Dv = dm.Dv, W = dm.W, nc = dm.nc;
  const int ldk = Dk + 4;
  float* Cs = smem;                   // [Dk][DVB]
  float* ns = Cs + Dk * DVB;          // [Dk]
  float* kt = ns + Dk;                // [TU][ldk] w_t k_t
  float* vu = kt + TU * ldk;          // [TU][DVB]
  const int col0 = blockIdx.x * DVB;
  const int bh = blockIdx.y;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;   // cols tx*4 + j, rows ty*16 + i
  const bool lead = blockIdx.x == 0;       // the block that keeps n
  const T* kh = k + b * sk.b + hh * sk.h;
  const T* vh = v + b * sv.b + hh * sv.h;
  for (int i = tid; i < Dk * DVB; i += NT) Cs[i] = 0.f;
  for (int i = tid; i < Dk; i += NT) ns[i] = 0.f;
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    const long long tb = (long long)c * W;
    const long long chunk = (long long)bh * nc + c;
    for (int e = tid; e < Dk * DVB; e += NT) {
      const int d = e / DVB, cc = e % DVB;
      if (col0 + cc < Dv) w.C0[(chunk * Dk + d) * Dv + col0 + cc] = Cs[e];
    }
    if (lead)
      for (int d = tid; d < Dk; d += NT) w.n0[chunk * Dk + d] = ns[d];
    if (c + 1 == nc) break;           // the last chunk's end is not needed
    const float g = w.decay[chunk];
    const float* wc = w.wkv + (long long)bh * dm.S + tb;
    float acc[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float np0 = 0.f, np1 = 0.f;
    for (int t0 = 0; t0 < W; t0 += TU) {
      __syncthreads();
      for (int e = tid; e < TU * Dk; e += NT) {
        const int u = e / Dk, d = e % Dk, t = t0 + u;
        kt[u * ldk + d] = t < W ? wc[t] * ld(kh + (tb + t) * sk.s + d) : 0.f;
      }
      for (int e = tid; e < TU * DVB; e += NT) {
        const int u = e / DVB, cc = e % DVB, t = t0 + u;
        vu[e] = t < W && col0 + cc < Dv ? ld(vh + (tb + t) * sv.s + col0 + cc)
                                        : 0.f;
      }
      __syncthreads();
      if (lead) {
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          if (tid < Dk) np0 += kt[u * ldk + tid];
          if (tid + NT < Dk) np1 += kt[u * ldk + tid + NT];
        }
      }
      if (ty * 16 < Dk) {
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          float kk[16], vv[4];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            kk[i] = ty * 16 + i < Dk ? kt[u * ldk + ty * 16 + i] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = vu[u * DVB + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kk[i], vv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = ty * 16 + i;
      if (d >= Dk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* cp = &Cs[d * DVB + tx * 4 + j];
        *cp = g * *cp + acc[i][j];
      }
    }
    if (lead) {
      if (tid < Dk) ns[tid] = g * ns[tid] + np0;
      if (tid + NT < Dk) ns[tid + NT] = g * ns[tid + NT] + np1;
    }
    __syncthreads();
  }
}

// ---- scores: S, den, M, dden, dS, dP and dwlog's sums ----

size_t scores_smem() {
  return sizeof(float) *
         (TD * LDR + TD * LDW + 2 * WMAX + 4 * RB + TD + (NT / 32) * WMAX);
}

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, Strides sq, Strides sk, Strides sv,
                  const float* __restrict__ li, const float* __restrict__ h,
                  const float* __restrict__ dh, Work w, Dims dm,
                  float scale) {
  extern __shared__ __align__(16) float smem[];
  float* at = smem;                   // [TD][LDR] scale q or dnum, depth-major
  float* bt = at + TD * LDR;          // [TD][LDW] k or v, depth-major
  float* Fc = bt + TD * LDW;          // [WMAX]
  float* lic = Fc + WMAX;             // [WMAX]
  float* mjc = lic + WMAX;            // [RB]
  float* Mc = mjc + RB;               // [RB] the denominators M
  float* ddc = Mc + RB;               // [RB] dden
  float* qnc = ddc + RB;              // [RB] scale q . n_c
  float* nct = qnc + RB;              // [TD] n_c's tile
  float* csum = nct + TD;             // [NT / 32][WMAX] per-warp column sums

  const int Dk = dm.Dk, Dv = dm.Dv, W = dm.W, nc = dm.nc;
  const int r0 = blockIdx.x * RB;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x;
  const long long chunk = (long long)bh * nc + c;
  const long long row0 = (long long)bh * dm.S + (long long)c * W;
  const long long tb = (long long)c * W;
  for (int t = tid; t < W; t += NT) {
    Fc[t] = w.F[row0 + t];
    lic[t] = li[row0 + t];
  }
  const int rows = min(RB, W - r0);   // rows of this block
  const int tmax = r0 + rows;         // keys t < tmax can be live
  const int tpad = (tmax + 31) & ~31;
  if (tid < RB) mjc[tid] = tid < rows ? w.mj[row0 + r0 + tid] : 0.f;

  const int ty = tid >> 5, tx = tid & 31;   // rows ty*8 + i, keys tx + 32 j
  const T* qb = q + b * sq.b + hh * sq.h + (tb + r0) * sq.s;
  const T* kb = k + b * sk.b + hh * sk.h + tb * sk.s;
  const T* vb = v + b * sv.b + hh * sv.h + tb * sv.s;
  const float* nb = w.n0 + chunk * Dk;

  // P = (scale q) k^T over this block's rows and the keys t < tmax, and
  // scale q . n_c (threads tid < RB, a row each)
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float qn = 0.f;
  for (int d0 = 0; d0 < Dk; d0 += TD) {
    __syncthreads();
    for (int e = tid; e < RB * TD; e += NT) {
      const int r = e / TD, dd = e % TD;
      at[dd * LDR + r] =
          r < rows && d0 + dd < Dk ? ld(qb + r * sq.s + d0 + dd) * scale : 0.f;
    }
    for (int e = tid; e < tpad * TD; e += NT) {
      const int t = e / TD, dd = e % TD;
      bt[dd * LDW + t] =
          t < tmax && d0 + dd < Dk ? ld(kb + t * sk.s + d0 + dd) : 0.f;
    }
    if (tid < TD) nct[tid] = d0 + tid < Dk ? nb[d0 + tid] : 0.f;
    __syncthreads();
    const int jn = tpad >> 5;
    for (int dd = 0; dd < TD; ++dd) {
      float a[8], kv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = at[dd * LDR + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = j < jn ? bt[dd * LDW + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], kv[j], acc[i][j]);
    }
    if (tid < RB)
      for (int dd = 0; dd < TD; ++dd)
        qn = fmaf(at[dd * LDR + tid], nct[dd], qn);
  }
  if (tid < RB) qnc[tid] = qn;

  // S = P D (zero above the diagonal), then each row's den, M and dden;
  // warp ty owns rows ty*8 .. ty*8 + 7
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = ty * 8 + i, r = r0 + rr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = tx + 32 * j;
      acc[i][j] = rr < rows && t <= r
                      ? acc[i][j] * expf(((Fc[r] - Fc[t]) + lic[t]) - mjc[rr])
                      : 0.f;
    }
  }
  __syncthreads();                    // qnc
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = ty * 8 + i;
    float srow = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) srow += acc[i][j];
    srow = warp_sum(srow);
    float delta = 0.f;
    if (rr < rows) {
      const float* hr = h + (row0 + r0 + rr) * Dv;
      const float* dr = dh + (row0 + r0 + rr) * Dv;
      for (int x = tx; x < Dv; x += 32) delta = fmaf(dr[x], hr[x], delta);
    }
    delta = warp_sum(delta);
    if (tx == 0 && rr < rows) {
      const long long row = row0 + r0 + rr;
      const float den = srow + w.inter[row] * qnc[rr];
      const float floor = expf(-mjc[rr]);
      const float M = fmaxf(fabsf(den), floor);
      const float dd =
          fabsf(den) >= floor ? (-(den > 0.f ? 1.f : -1.f) * delta) / M : 0.f;
      Mc[rr] = M;
      ddc[rr] = dd;
      w.Md[row] = M;
      w.dden[row] = dd;
    }
  }

  // dnum v^T over the same rows and keys
  float acc2[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc2[i][j] = 0.f;
  for (int d0 = 0; d0 < Dv; d0 += TD) {
    __syncthreads();                  // Mc, and the last tile's readers
    for (int e = tid; e < RB * TD; e += NT) {
      const int r = e / TD, dd = e % TD;
      at[dd * LDR + r] = r < rows && d0 + dd < Dv
                             ? dh[(row0 + r0 + r) * Dv + d0 + dd] / Mc[r]
                             : 0.f;
    }
    for (int e = tid; e < tpad * TD; e += NT) {
      const int t = e / TD, dd = e % TD;
      bt[dd * LDW + t] =
          t < tmax && d0 + dd < Dv ? ld(vb + t * sv.s + d0 + dd) : 0.f;
    }
    __syncthreads();
    const int jn = tpad >> 5;
    for (int dd = 0; dd < TD; ++dd) {
      float a[8], vv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = at[dd * LDR + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        vv[j] = j < jn ? bt[dd * LDW + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(a[i], vv[j], acc2[i][j]);
    }
  }

  // dS = dnum v^T + dden, dP = dS D, dwlog = dS S: S and dP to scratch
  // (every key of every row, zeros above the diagonal), dwlog's row sums
  // and this block's column sums
  float* Sb = w.Sx + chunk * W * W;
  float* Pb = w.dPx + chunk * W * W;
  float col[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) col[j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = ty * 8 + i, r = r0 + rr;
    const bool live = rr < rows;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = tx + 32 * j;
      float dP = 0.f, dwl = 0.f;
      if (live && t <= r) {
        const float dS = acc2[i][j] + ddc[rr];
        dP = dS * expf(((Fc[r] - Fc[t]) + lic[t]) - mjc[rr]);
        dwl = dS * acc[i][j];
      }
      rs += dwl;
      col[j] += dwl;
      if (live && t < W) {
        Sb[(long long)r * W + t] = acc[i][j];
        Pb[(long long)r * W + t] = dP;
      }
    }
    rs = warp_sum(rs);
    if (tx == 0 && live) w.rsum[row0 + r] = rs;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) csum[ty * WMAX + tx + 32 * j] = col[j];
  __syncthreads();
  for (int t = tid; t < W; t += NT) {
    float s = 0.f;
    for (int y = 0; y < NT / 32; ++y) s += csum[y * WMAX + t];
    w.csum_p[(chunk * dm.nrb + blockIdx.x) * W + t] = s;
  }
}

// ---- sweep: dC and dn from the last chunk to the first; dv ----

struct SweepSmem {
  int total;
  int ldq;                            // padded row of the q tile
  int tile;                           // floats of the operand tiles
  __host__ __device__ SweepSmem(int Dk) {
    ldq = Dk + 4;
    int t = TD * LDW;
    t = t > TD * LDW + TD * DVB ? t : TD * LDW + TD * DVB;
    t = t > TU * ldq + TU * DVB ? t : TU * ldq + TU * DVB;
    tile = t;
    total = (int)sizeof(float) * (Dk * DVB + Dk + 4 * WMAX + tile);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_sweep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 Strides sq, Strides sk, const float* __restrict__ dh,
                 T* __restrict__ dv, Work w, Dims dm, float scale) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[NT / 32];
  const int Dk = dm.Dk, Dv = dm.Dv, W = dm.W, nc = dm.nc;
  const SweepSmem L(Dk);
  float* dCs = smem;                  // [Dk][DVB]
  float* dns = dCs + Dk * DVB;        // [Dk]
  float* ic = dns + Dk;               // [WMAX] e
  float* wc = ic + WMAX;              // [WMAX] w
  float* Mc = wc + WMAX;              // [WMAX] M
  float* ddc = Mc + WMAX;             // [WMAX] dden
  float* tile = ddc + WMAX;           // the products' operand tiles

  const int col0 = blockIdx.x * DVB;
  const int bh = blockIdx.y;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, wid = tid >> 5;
  const bool lead = blockIdx.x == 0;  // the block that keeps dn
  const T* qh = q + b * sq.b + hh * sq.h;
  const T* kh = k + b * sk.b + hh * sk.h;
  for (int i = tid; i < Dk * DVB; i += NT) dCs[i] = 0.f;
  for (int i = tid; i < Dk; i += NT) dns[i] = 0.f;

  for (int c = nc - 1; c >= 0; --c) {
    const long long tb = (long long)c * W;
    const long long chunk = (long long)bh * nc + c;
    const long long row0 = (long long)bh * dm.S + tb;
    __syncthreads();                  // the last chunk's dC and dn
    for (int t = tid; t < W; t += NT) {
      ic[t] = w.inter[row0 + t];
      wc[t] = w.wkv[row0 + t];
      Mc[t] = w.Md[row0 + t];
      ddc[t] = w.dden[row0 + t];
    }
    const float g = w.decay[chunk];

    // the gradient at the chunk's end, for dqdk, and <dC, C_c>
    float part = 0.f;
    for (int e = tid; e < Dk * DVB; e += NT) {
      const int d = e / DVB, cc = e % DVB;
      if (col0 + cc >= Dv) continue;
      const long long at = (chunk * Dk + d) * Dv + col0 + cc;
      w.dC1[at] = dCs[e];
      part = fmaf(dCs[e], w.C0[at], part);
    }
    if (lead)
      for (int d = tid; d < Dk; d += NT) {
        w.dn1[chunk * Dk + d] = dns[d];
        part = fmaf(dns[d], w.n0[chunk * Dk + d], part);
      }
    part = warp_sum(part);
    if (lane == 0) red[wid] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < NT / 32; ++i) s += red[i];
      w.dg_p[chunk * dm.ndv + blockIdx.x] = s;
    }

    // dv[t, cols] = w_t (k_t . dC[:, cols]) + sum_j S[j, t] dnum_j[cols]:
    // rows t = ty*8 + i, cols tx*4 + j
    const int tx = tid & 7, ty = tid >> 3;
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float* kt = tile;                 // [TD][LDW] k, depth-major
    for (int d0 = 0; d0 < Dk; d0 += TD) {
      __syncthreads();
      for (int e = tid; e < W * TD; e += NT) {
        const int t = e / TD, dd = e % TD;
        kt[dd * LDW + t] = d0 + dd < Dk ? ld(kh + (tb + t) * sk.s + d0 + dd)
                                        : 0.f;
      }
      __syncthreads();
      if (ty * 8 < W) {
        for (int dd = 0; dd < TD; ++dd) {
          if (d0 + dd >= Dk) break;
          float a[8], cc[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = kt[dd * LDW + ty * 8 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) cc[j] = dCs[(d0 + dd) * DVB + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], cc[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wt = ty * 8 + i < W ? wc[ty * 8 + i] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= wt;
    }
    float* stt = tile;                // [TD][LDW] S rows j, keys t
    float* dnt = tile + TD * LDW;     // [TD][DVB] dnum rows j
    const float* Sb = w.Sx + chunk * W * W;
    for (int j0 = 0; j0 < W; j0 += TD) {
      __syncthreads();
      for (int e = tid; e < TD * W; e += NT) {
        const int jj = e / W, t = e % W;
        stt[jj * LDW + t] = j0 + jj < W ? Sb[(long long)(j0 + jj) * W + t] : 0.f;
      }
      for (int e = tid; e < TD * DVB; e += NT) {
        const int jj = e / DVB, cc = e % DVB, j = j0 + jj;
        dnt[e] = j < W && col0 + cc < Dv
                     ? dh[(row0 + j) * Dv + col0 + cc] / Mc[j]
                     : 0.f;
      }
      __syncthreads();
      if (ty * 8 < W && j0 + TD > ty * 8) {   // S[j, t] = 0 for j < t
        for (int jj = 0; jj < TD; ++jj) {
          float a[8], vv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = stt[jj * LDW + ty * 8 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = dnt[jj * DVB + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], vv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty * 8 + i;
      if (t >= W) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col0 + tx * 4 + j < Dv)
          st(dv + (row0 + t) * Dv + col0 + tx * 4 + j, acc[i][j]);
    }

    // dC[:, cols] = g dC + sum_j (e_j scale q_j) dnum_j[cols]; dn = g dn +
    // sum_j (e_j scale q_j) dden_j. Rows d = ty2*16 + i, cols tx*4 + j
    const int ty2 = tid >> 3;
    float acc2[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
    float np0 = 0.f, np1 = 0.f;
    float* qt = tile;                 // [TU][ldq]
    float* dnu = tile + TU * L.ldq;   // [TU][DVB]
    for (int j0 = 0; j0 < W; j0 += TU) {
      __syncthreads();
      for (int e = tid; e < TU * Dk; e += NT) {
        const int u = e / Dk, d = e % Dk, j = j0 + u;
        qt[u * L.ldq + d] =
            j < W ? (ic[j] * scale) * ld(qh + (tb + j) * sq.s + d) : 0.f;
      }
      for (int e = tid; e < TU * DVB; e += NT) {
        const int u = e / DVB, cc = e % DVB, j = j0 + u;
        dnu[e] = j < W && col0 + cc < Dv
                     ? dh[(row0 + j) * Dv + col0 + cc] / Mc[j]
                     : 0.f;
      }
      __syncthreads();
      if (lead) {
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          const float dd = j0 + u < W ? ddc[j0 + u] : 0.f;
          if (tid < Dk) np0 = fmaf(qt[u * L.ldq + tid], dd, np0);
          if (tid + NT < Dk) np1 = fmaf(qt[u * L.ldq + tid + NT], dd, np1);
        }
      }
      if (ty2 * 16 < Dk) {
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          float kk[16], vv[4];
#pragma unroll
          for (int i = 0; i < 16; ++i)
            kk[i] = ty2 * 16 + i < Dk ? qt[u * L.ldq + ty2 * 16 + i] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = dnu[u * DVB + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 16; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc2[i][j] = fmaf(kk[i], vv[j], acc2[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int d = ty2 * 16 + i;
      if (d >= Dk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* cp = &dCs[d * DVB + tx * 4 + j];
        *cp = g * *cp + acc2[i][j];
      }
    }
    if (lead) {
      if (tid < Dk) dns[tid] = g * dns[tid] + np0;
      if (tid + NT < Dk) dns[tid + NT] = g * dns[tid + NT] + np1;
    }
  }
}

// ---- dqdk: dq, dk and the partial de and dw over 64 key columns ----

size_t dqdk_smem() { return sizeof(float) * (TD * LDR + TD * LDB); }

template <typename T>
__global__ void __launch_bounds__(NT)
bwd_dqdk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, Strides sq, Strides sk, Strides sv,
                const float* __restrict__ dh, T* __restrict__ dq,
                T* __restrict__ dk, Work w, Dims dm, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* at = smem;                   // [TD][LDR] the rows' operand
  float* bt = at + TD * LDR;          // [TD][LDB] the key columns' operand
  const int Dk = dm.Dk, Dv = dm.Dv, W = dm.W, nc = dm.nc;
  const int d0 = blockIdx.x * DKB;
  const int r0 = blockIdx.y * RB;
  const int c = blockIdx.z % nc;
  const int bh = blockIdx.z / nc;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;   // rows tr*4 + i, cols tc*4 + j
  const long long tb = (long long)c * W;
  const long long chunk = (long long)bh * nc + c;
  const long long row0 = (long long)bh * dm.S + tb;
  const int rows = min(RB, W - r0);
  const T* qh = q + b * sq.b + hh * sq.h + tb * sq.s;
  const T* kh = k + b * sk.b + hh * sk.h + tb * sk.s;
  const T* vh = v + b * sv.b + hh * sv.h + tb * sv.s;
  const float* Pb = w.dPx + chunk * W * W;
  const float* Cc = w.C0 + chunk * Dk * Dv;
  const float* dCc = w.dC1 + chunk * Dk * Dv;

  float aq[4][4], au[4][4], ak[4][4], ar[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) aq[i][j] = au[i][j] = ak[i][j] = ar[i][j] = 0.f;

  // acc += at^T bt over depths [p0, p1), the tiles filled by fill(p0)
  auto product = [&](float (&acc)[4][4], int p0, int p1, auto fill) {
    for (int p = p0; p < p1; p += TD) {
      __syncthreads();
      fill(p);
      __syncthreads();
      for (int pp = 0; pp < TD; ++pp) {
        float a[4], bb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = at[pp * LDR + tr * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bb[j] = bt[pp * LDB + tc * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
  };
  // dP k: depth t < r0 + rows (dP[r, t] = 0 for t > r)
  const int tend = r0 + rows;
  product(aq, 0, tend, [&](int p) {
    for (int e = tid; e < RB * TD; e += NT) {
      const int r = e / TD, pp = e % TD, t = p + pp;
      at[pp * LDR + r] =
          r < rows && t < tend ? Pb[(long long)(r0 + r) * W + t] : 0.f;
    }
    for (int e = tid; e < TD * DKB; e += NT) {
      const int pp = e / DKB, dd = e % DKB, t = p + pp;
      bt[pp * LDB + dd] =
          t < tend && d0 + dd < Dk ? ld(kh + t * sk.s + d0 + dd) : 0.f;
    }
  });
  // C_c dnum: depth v
  product(au, 0, Dv, [&](int p) {
    for (int e = tid; e < RB * TD; e += NT) {
      const int r = e / TD, pp = e % TD, x = p + pp;
      at[pp * LDR + r] = r < rows && x < Dv
                             ? dh[(row0 + r0 + r) * Dv + x] / w.Md[row0 + r0 + r]
                             : 0.f;
    }
    for (int e = tid; e < TD * DKB; e += NT) {
      const int dd = e / TD, pp = e % TD, x = p + pp;
      bt[pp * LDB + dd] =
          d0 + dd < Dk && x < Dv ? Cc[(long long)(d0 + dd) * Dv + x] : 0.f;
    }
  });
  // dP^T (scale q): depth j in [r0, W) (dP[j, t] = 0 for j < t)
  product(ak, r0, W, [&](int p) {
    for (int e = tid; e < TD * RB; e += NT) {
      const int pp = e / RB, r = e % RB, j = p + pp;
      at[pp * LDR + r] = j < W && r < rows ? Pb[(long long)j * W + r0 + r] : 0.f;
    }
    for (int e = tid; e < TD * DKB; e += NT) {
      const int pp = e / DKB, dd = e % DKB, j = p + pp;
      bt[pp * LDB + dd] =
          j < W && d0 + dd < Dk ? ld(qh + j * sq.s + d0 + dd) * scale : 0.f;
    }
  });
  // dC v: depth v
  product(ar, 0, Dv, [&](int p) {
    for (int e = tid; e < RB * TD; e += NT) {
      const int r = e / TD, pp = e % TD, x = p + pp;
      at[pp * LDR + r] =
          r < rows && x < Dv ? ld(vh + (long long)(r0 + r) * sv.s + x) : 0.f;
    }
    for (int e = tid; e < TD * DKB; e += NT) {
      const int dd = e / TD, pp = e % TD, x = p + pp;
      bt[pp * LDB + dd] =
          d0 + dd < Dk && x < Dv ? dCc[(long long)(d0 + dd) * Dv + x] : 0.f;
    }
  });

  // the epilogue: dq, dk, and de, dw summed over this block's columns
  const float* nb = w.n0 + chunk * Dk;
  const float* dnb = w.dn1 + chunk * Dk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = tr * 4 + i, r = r0 + rr;
    const bool live = rr < rows;
    const long long row = row0 + r;
    const float e = live ? w.inter[row] : 0.f;
    const float dd = live ? w.dden[row] : 0.f;
    const float wt = live ? w.wkv[row] : 0.f;
    float pe = 0.f, pw = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int d = d0 + tc * 4 + j;
      if (!live || d >= Dk) continue;
      const float qs = ld(qh + (long long)r * sq.s + d) * scale;
      const float kv = ld(kh + (long long)r * sk.s + d);
      const float rv = ar[i][j] + dnb[d];
      pe = fmaf(qs, au[i][j], pe);
      pe = fmaf(dd * qs, nb[d], pe);
      pw = fmaf(kv, rv, pw);
      st(dq + row * Dk + d,
         scale * (aq[i][j] + e * au[i][j] + (e * dd) * nb[d]));
      st(dk + row * Dk + d, ak[i][j] + wt * rv);
    }
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      pe += __shfl_xor_sync(0xffffffffu, pe, o);
      pw += __shfl_xor_sync(0xffffffffu, pw, o);
    }
    if (tc == 0 && live) {
      w.dinter_p[row * dm.nds + blockIdx.x] = pe;
      w.dwkv_p[row * dm.nds + blockIdx.x] = pw;
    }
  }
}

// ---- grads: dli and dlf ----

__global__ void bwd_grads_kernel(Work w, Dims dm, float* __restrict__ dli,
                                 float* __restrict__ dlf) {
  const int bh = blockIdx.x;
  const int S = dm.S, W = dm.W, nc = dm.nc;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int c = i / W, t = i % W;
    const long long row = (long long)bh * S + i;
    const long long chunk = (long long)bh * nc + c;
    float cols = 0.f;
    for (int rb = 0; rb < dm.nrb; ++rb)
      cols += w.csum_p[(chunk * dm.nrb + rb) * W + t];
    float de = 0.f, dw = 0.f;
    for (int x = 0; x < dm.nds; ++x) {
      de += w.dinter_p[row * dm.nds + x];
      dw += w.dwkv_p[row * dm.nds + x];
    }
    const float dww = dw * w.wkv[row];
    dli[row] = cols + dww;
    dlf[row] = ((w.rsum[row] - cols) + de * w.inter[row]) - dww;  // dF
    w.dww[row] = dww;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const long long chunk = (long long)bh * nc + c;
    const long long base = (long long)bh * S + (long long)c * W;
    float dg = 0.f;
    for (int x = 0; x < dm.ndv; ++x) dg += w.dg_p[chunk * dm.ndv + x];
    float sdw = 0.f;
    for (int t = 0; t < W; ++t) sdw += w.dww[base + t];
    dlf[base + W - 1] += dg * w.decay[chunk] + sdw;
    float acc = 0.f;                  // the reversed in-chunk sum
    for (int t = W - 1; t >= 0; --t) {
      acc += dlf[base + t];
      dlf[base + t] = acc;
    }
  }
}

template <typename T>
cudaError_t launch(const void* q_, const void* k_, const void* v_,
                   const float* li, const float* lf, const float* h,
                   const float* dh, void* dq_, void* dk_, void* dv_,
                   float* dli, float* dlf, float* ws, const Dims& dm,
                   const long long* strides, float scale,
                   cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  Work w;
  carve(w, ws, dm);
  const int BH = dm.B * dm.H;
  cudaError_t err;

  bwd_gates_kernel<<<BH, 128, 0, stream>>>(li, lf, w, dm.S, dm.W, dm.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t sm_states = states_smem(dm.Dk);
  err = cudaFuncSetAttribute(bwd_states_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm_states);
  if (err != cudaSuccess) return err;
  bwd_states_kernel<T><<<dim3(dm.ndv, BH), NT, sm_states, stream>>>(
      k, v, sk, sv, w, dm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t sm_scores = scores_smem();
  err = cudaFuncSetAttribute(bwd_scores_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm_scores);
  if (err != cudaSuccess) return err;
  bwd_scores_kernel<T><<<dim3(dm.nrb, dm.nc, BH), NT, sm_scores, stream>>>(
      q, k, v, sq, sk, sv, li, h, dh, w, dm, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const SweepSmem L(dm.Dk);
  err = cudaFuncSetAttribute(bwd_sweep_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.total);
  if (err != cudaSuccess) return err;
  bwd_sweep_kernel<T><<<dim3(dm.ndv, BH), NT, L.total, stream>>>(
      q, k, sq, sk, dh, dv, w, dm, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_dqdk_kernel<T><<<dim3(dm.nds, dm.nrb, dm.nc * BH), NT, dqdk_smem(),
                       stream>>>(q, k, v, sq, sk, sv, dh, dq, dk, w, dm,
                                 scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  bwd_grads_kernel<<<BH, NT, 0, stream>>>(w, dm, dli, dlf);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The tensor-core path (namespace tc): bf16 q, k, v with Dk 512, Dv and
// W multiples of 64, 16-byte aligned rows (the wrapper's
// uses_tensor_cores, as the forward's). Nine kernels in order on the
// caller's stream, through the same scratch buffer, whose f32 regions
// for S, dP, C_c and dC hold bf16 hi and lo halves instead:
//   gates   the FMA path's bwd_gates_kernel.
//   n       one block per (32 key columns, b, h): n_c at each chunk's
//           start, w_t k_t summed down the chunk by 16 lanes (f32 FMAs).
//   states  one warpgroup per (64 value columns, 256 key columns, b, h):
//           C_c^T in the accumulator registers across the chunks, the
//           forward's C update C^T = g C^T + ((w v)^T hi + lo) k on
//           wgmma (m64n256, k read MN-major); C_c written as hi and lo at
//           each chunk's start, (B H nc, Dv, Dk).
//   scores  one warpgroup per 64 rows of a chunk: P = q k^T (exact bf16
//           products), S = scale P D, den, M, dden; then dnum v^T with
//           dnum = dh / M split into hi + lo in registers (v read
//           K-major), dS, scale dP = scale dS D and dwlog = dS S; S and
//           scale dP written as hi and lo (W x W a chunk, zeros above the
//           diagonal), M, dden, dwlog's row sums and its column sums.
//   dn      as n, in reverse: dn at each chunk's end from e_j scale dden_j
//           q_j, and <dn, n_c> over its 32 columns.
//   sweep   as states, in reverse: dC^T = g dC^T + (e scale dnum)^T q,
//           dnum from dh split in registers, q read MN-major; dC at each
//           chunk's end written as hi and lo, and <dC, C_c> a block.
//   dqdk    one warpgroup per 64 rows of a chunk and 256 key columns, dq
//           or dk (four blocks a row block): dq = scale e (C_c dnum +
//           dden n_c) + (scale dP) k, C_c dnum from dnum split in
//           registers and C_c hi, lo (three products); dk = w (dC v + dn)
//           + (scale dP)^T q, dP^T read MN-major from dP's rows; the
//           rows' partial de and dw over those columns.
//   dv      one warpgroup per 64 value columns of a chunk: dv^T = w (dC^T
//           k^T) + dnum^T S over all the chunk's keys (m64n256), S read
//           MN-major, dnum^T split in registers (three products).
//   grads   the FMA path's bwd_grads_kernel.
// Every f32 operand of a product is carried as bf16 hi + lo, about 2^-17
// of |x| (one bf16 or TF32 rounding would miss the 1e-4 allowance):
// two products where the other operand is exact in bf16 (q, k, v), three
// (hi hi + hi lo + lo hi) where both are f32 (dnum against C_c and S).
// The states and the sweep walk each (b, h)'s chunks in series, its
// state split over (Dv / 64) x 2 (value, key) tiles: 512 blocks at B 4 x
// S 512 and 128 at B 1 x S 2048 (an H100 has 132 SMs); no partial sum
// crosses blocks but the rows' de, dw and dg terms, which grads adds in a
// fixed order (no atomics). Bound on an H100 SXM: the products as run
// (mlstm_chunk.mlstm_bwd_tc_flops, the splits counted two or three
// times) at 989 TFLOP/s: 106.3 GFLOP, 0.11 ms at B 4 x S 512, and 119.2
// GFLOP, 0.12 ms at B 1 x S 2048 (Dk 512, Dv 1024, W 256).
// ---------------------------------------------------------------------
namespace tc {

using namespace mlstm_tc;

constexpr int DK = 512;           // key width
constexpr int DT = 256;           // key columns of a state, dq or dk block
constexpr int NDT = DK / DT;      // key tiles
constexpr int XT = 64;            // value columns of a state or dv block
constexpr int LDR = 72;           // f32 row of a dh tile read along rows
constexpr int LDC = 68;           // f32 row of a dh tile read down columns
constexpr int VLD = 72;           // bf16 row of a v tile read down columns
constexpr int NL = 16;            // lanes down the rows of an n column

// the bf16 hi and lo halves of a scratch region of n f32
struct Split {
  bf16 *hi, *lo;
  __host__ __device__ Split(float* p, long long n)
      : hi(reinterpret_cast<bf16*>(p)), lo(reinterpret_cast<bf16*>(p) + n) {}
};

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(bf16 x) { return __bfloat162float(x); }

// hi + lo of a packed pair's element e
__device__ __forceinline__ float hilo(uint32_t hi, uint32_t lo, int e) {
  return e ? bf(hi >> 16) + bf(lo >> 16) : bf(hi & 0xffffu) + bf(lo & 0xffffu);
}

// A fragment of k-step kk from an f32 tile read along its rows: element
// (m, k) is a[m * LDR + k] / den[m] (dnum = dh / M), split into hi + lo
__device__ __forceinline__ void frag_rows(const float* a, const float* den,
                                          int kk, int w, int lane,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int m = 16 * w + lane / 4 + 8 * (x & 1);
    const int k = 16 * kk + 2 * (lane % 4) + 8 * (x >> 1);
    const float2 p = *reinterpret_cast<const float2*>(a + m * LDR + k);
    split2(p.x / den[m], p.y / den[m], hi[x], lo[x]);
  }
}

// A fragment of k-step kk from a tile read down its columns: element (m,
// k) is a[k * ld + m] * coef[k], split into hi + lo
template <typename T>
__device__ __forceinline__ void frag_cols(const T* a, int ld,
                                          const float* coef, int kk, int w,
                                          int lane, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int m = 16 * w + lane / 4 + 8 * (x & 1);
    const int k = 16 * kk + 2 * (lane % 4) + 8 * (x >> 1);
    split2(val(a[k * ld + m]) * coef[k], val(a[(k + 1) * ld + m]) * coef[k + 1],
           hi[x], lo[x]);
  }
}

// 64 rows of 64 f32 from `src` (row stride `ld`) into a tile of row
// stride `lds`, 16 bytes a cp.async
__device__ __forceinline__ void load_f32(float* tile, int lds,
                                         const float* src, long long ld,
                                         int tid) {
  for (int e = tid; e < 64 * 16; e += 128) {
    const int r = e >> 4, c4 = e & 15;
    cp_async16(tile + r * lds + c4 * 4, src + r * ld + c4 * 4, 16);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// ---- n and dn: n at each chunk's start, dn at each chunk's end ----

// out[c] = the sum so far; then sum = decay_c sum + mult sum_t c1_t c2_t
// x_t over chunk c's rows, the chunks in order (REV: in reverse, with
// <out[c], dot[c]> over this block's columns into dg_p[c * ndv + slot])
template <bool REV>
__device__ __forceinline__ void nvec_body(
    const bf16* __restrict__ x, Strides sx, const float* __restrict__ c1,
    const float* __restrict__ c2, float mult, const float* __restrict__ decay,
    float* __restrict__ out, const float* __restrict__ dot,
    float* __restrict__ dg_p, int ndv, int slot, int H, int S, int Dk,
    int W, int nc) {
  __shared__ float part[NL][33];
  const int lane = threadIdx.x & 31, tl = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const bf16* xh = x + b * sx.b + hh * sx.h;
  const float* c1b = c1 + (long long)bh * S;
  const float* c2b = c2 + (long long)bh * S;
  float n = 0.f;
  for (int s = 0; s < nc; ++s) {
    const int c = REV ? nc - 1 - s : s;
    float acc = 0.f;
    if (d < Dk)
      for (int t = c * W + tl; t < (c + 1) * W; t += NL)
        acc = fmaf(REV ? c1b[t] * c2b[t] : c1b[t],
                   __bfloat162float(xh[t * sx.s + d]), acc);
    part[tl][lane] = acc;
    __syncthreads();
    if (tl == 0) {
      const long long o = ((long long)bh * nc + c) * Dk + d;
      if (REV) {
        const float pd = warp_sum(d < Dk ? n * dot[o] : 0.f);
        if (lane == 0) dg_p[((long long)bh * nc + c) * ndv + slot] = pd;
      }
      if (d < Dk) {
        out[o] = n;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < NL; ++u) sum += part[u][lane];
        n = decay[(long long)bh * nc + c] * n + mult * sum;
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(32 * NL)
bwd_n_kernel(const bf16* __restrict__ k, Strides sk,
             const float* __restrict__ wkv, const float* __restrict__ decay,
             float* __restrict__ n0, int H, int S, int Dk, int W, int nc) {
  nvec_body<false>(k, sk, wkv, wkv, 1.f, decay, n0, nullptr, nullptr, 0, 0,
                   H, S, Dk, W, nc);
}

// dn at each chunk's end, and <dn, n_c> over the block's 32 columns into
// dg_p's slots from ndv - Dk / 32 on
__global__ void __launch_bounds__(32 * NL)
bwd_dn_kernel(const bf16* __restrict__ q, Strides sq,
              const float* __restrict__ inter, const float* __restrict__ dden,
              float scale, const float* __restrict__ decay,
              float* __restrict__ dn1, const float* __restrict__ n0,
              float* __restrict__ dg_p, int ndv, int H, int S, int Dk, int W,
              int nc) {
  nvec_body<true>(q, sq, inter, dden, scale, decay, dn1, n0, dg_p, ndv,
                  ndv - Dk / 32 + blockIdx.x, H, S, Dk, W, nc);
}

// ---- states and sweep: the chain over a (b, h)'s chunks ----

// a slot of the two-slot ring: 64 rows x 256 key columns of k or q
// (MN-major), 64 rows x 64 value columns of v (bf16) or dh (f32), and
// the rows' two weight factors
constexpr int CH_SLOT = 51200;
constexpr int CH_A = 32768;
constexpr int CH_CO = CH_A + 64 * LDC * 4;
constexpr int CH_SMEM = 1024 + 2 * CH_SLOT + 512;

// X^T (64 value columns x 256 key columns) in the accumulator registers:
// at each step out[c] = X^T (hi and lo, (chunk, Dv, Dk)), then X^T = g_c
// X^T + (a A)^T Bm over chunk c's rows, a_t = c1_t (REV: c1_t mult /
// c2_t), A the value rows (v, or dh), Bm the key rows (k, or q). The
// chunks in order (REV: in reverse, with <X^T, dot[c]> a block into
// dg_p); the last step only writes.
template <bool REV, typename TA>
__device__ __forceinline__ void chain_body(
    const bf16* __restrict__ kq, Strides sb, const TA* __restrict__ av,
    Strides sa, const float* __restrict__ c1, const float* __restrict__ c2,
    float mult, const float* __restrict__ decay, Split out, Split dot,
    float* __restrict__ dg_p, int ndv, int H, int S, int Dv, int W, int nc) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  float* red = reinterpret_cast<float*>(base + 2 * CH_SLOT);
  constexpr int LDA = sizeof(TA) == 4 ? LDC : VLD;
  constexpr int PER = 16 / sizeof(TA);        // elements a 16-byte copy
  const int col0 = blockIdx.x * XT, d0 = blockIdx.y * DT;
  const int bh = blockIdx.z, b = bh / H, hh = bh % H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const bf16* bh_ = kq + b * sb.b + hh * sb.h + d0;
  const TA* ah = av + b * sa.b + hh * sa.h + col0;
  const int R = W / 64, total = (nc - 1) * R;
  auto chunk_of = [&](int s) { return REV ? nc - 1 - s : s; };

  auto fetch = [&](int p) {
    const int c = chunk_of(p / R), i = p % R;
    uint8_t* slot = base + (p & 1) * CH_SLOT;
    const long long t0 = (long long)c * W + 64 * i;
    load_tile(slot, bh_ + t0 * sb.s, sb.s, 64, DT, 64, DT, tid, 128);
    TA* at = reinterpret_cast<TA*>(slot + CH_A);
    for (int e = tid; e < 64 * (64 / PER); e += 128) {
      const int r = e / (64 / PER), cc = e % (64 / PER);
      cp_async16(at + r * LDA + cc * PER, ah + (t0 + r) * sa.s + cc * PER, 16);
    }
    if (tid < 32) {
      float* co = reinterpret_cast<float*>(slot + CH_CO);
      const float* src = (tid < 16 ? c1 : c2) + (long long)bh * S + t0;
      cp_async16(co + (tid / 16) * 64 + (tid % 16) * 4, src + (tid % 16) * 4,
                 REV || tid < 16 ? 16 : 0);
    }
  };

  float acc[128];
  zero(acc);
  if (total > 0) fetch(0);
  cp_async_commit();
  for (int p = 0; p <= total; ++p) {
    const int s = p / R, i = p % R, c = chunk_of(s);
    if (i == 0) {
      // X^T out at this step's chunk, with <X^T, dot[c]> for the sweep
      const long long o0 = ((long long)bh * nc + c) * Dv;
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < DT / 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int x = col0 + 16 * w + lane / 4 + 8 * hf;
          const int d = d0 + 8 * j + 2 * (lane % 4);
          const long long o = ((o0 + x) * DK + d) >> 1;
          uint32_t hi, lo;
          split2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1], hi, lo);
          reinterpret_cast<uint32_t*>(out.hi)[o] = hi;
          reinterpret_cast<uint32_t*>(out.lo)[o] = lo;
          if (REV) {
            const uint32_t ch = reinterpret_cast<const uint32_t*>(dot.hi)[o];
            const uint32_t cl = reinterpret_cast<const uint32_t*>(dot.lo)[o];
            part = fmaf(acc[4 * j + 2 * hf], hilo(ch, cl, 0), part);
            part = fmaf(acc[4 * j + 2 * hf + 1], hilo(ch, cl, 1), part);
          }
        }
      if (REV) {
        part = warp_sum(part);
        if (lane == 0) red[w] = part;
        __syncthreads();
        if (tid == 0)
          dg_p[((long long)bh * nc + c) * ndv + blockIdx.y * gridDim.x +
               blockIdx.x] = ((red[0] + red[1]) + red[2]) + red[3];
        __syncthreads();
      }
      if (p == total) break;
      const float g = decay[(long long)bh * nc + c];
#pragma unroll
      for (int u = 0; u < 128; ++u) acc[u] *= g;
    }
    if (p + 1 < total) fetch(p + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint8_t* slot = base + (p & 1) * CH_SLOT;
    const TA* at = reinterpret_cast<const TA*>(slot + CH_A);
    const float* co = reinterpret_cast<const float*>(slot + CH_CO);
    float* coef = red + 4;            // [64]
    if (tid < 64) coef[tid] = REV ? co[tid] * mult / co[64 + tid] : co[tid];
    __syncthreads();
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      frag_cols(at, LDA, coef, kk, w, lane, hi[kk], lo[kk]);
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = mnmaj(slot, 0, kk);
      mma_rs_n256_mn(acc, hi[kk], bd);
      mma_rs_n256_mn(acc, lo[kk], bd);
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    __syncthreads();
  }
}

// C_c at each chunk's start, from (w v)^T k
__global__ void __launch_bounds__(128, 1)
bwd_states_tc(const bf16* __restrict__ k, Strides sk,
              const bf16* __restrict__ v, Strides sv,
              const float* __restrict__ wkv, const float* __restrict__ decay,
              Split C0, int H, int S, int Dv, int W, int nc) {
  chain_body<false>(k, sk, v, sv, wkv, wkv, 1.f, decay, C0, C0, nullptr, 0,
                    H, S, Dv, W, nc);
}

// dC at each chunk's end, from (e scale dnum)^T q, and <dC, C_c>
__global__ void __launch_bounds__(128, 1)
bwd_sweep_tc(const bf16* __restrict__ q, Strides sq,
             const float* __restrict__ dh, Strides sdh,
             const float* __restrict__ inter, const float* __restrict__ Md,
             float scale, const float* __restrict__ decay, Split dC1,
             Split C0, float* __restrict__ dg_p, int ndv, int H, int S,
             int Dv, int W, int nc) {
  chain_body<true>(q, sq, dh, sdh, inter, Md, scale, decay, dC1, C0, dg_p,
                   ndv, H, S, Dv, W, nc);
}

// the product loop of the scores, dq, dk and dv blocks: for p in [p0,
// p1) fetch(p) loads slot p & 1 (SLOT bytes each), then mma(p, slot)
// multiplies it, each piece's loads in flight while the one before is
// multiplied
template <int SLOT, typename Fetch, typename Mma>
__device__ __forceinline__ void pieces(uint8_t* base, int p0, int p1,
                                       Fetch fetch, Mma mma) {
  if (p0 < p1) fetch(p0, base + (p0 & 1) * SLOT);
  cp_async_commit();
  for (int p = p0; p < p1; ++p) {
    if (p + 1 < p1) fetch(p + 1, base + ((p + 1) & 1) * SLOT);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    mma(p, base + (p & 1) * SLOT);
    __syncthreads();
  }
}

// ---- scores ----

// a slot: phase 1 k rows [1][256][64] at 0 and q rows [1][64][64] at
// 32768; phase 2 v rows [1][256][64] at 0 and dh rows [64][LDR] f32 at
// 32768
constexpr int SC_SLOT = 51200;
constexpr int SC_SMALL = 2 * 256 + 6 * 64 + DK + 4 * 256;   // floats
constexpr int SC_SMEM = 1024 + 2 * SC_SLOT + SC_SMALL * 4;

__global__ void __launch_bounds__(128, 1)
bwd_scores_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
              const float* __restrict__ li, const float* __restrict__ h,
              const float* __restrict__ dh, Work wk, Dims dm, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  float* Fc = reinterpret_cast<float*>(base + 2 * SC_SLOT);   // [256]
  float* lic = Fc + 256;              // [256]
  float* mjc = lic + 256;             // [64] this block's rows
  float* Mc = mjc + 64;               // [64]
  float* ddc = Mc + 64;               // [64]
  float* qnc = ddc + 64;              // [64] q . n_c
  float* part = qnc + 64;             // [64] row sums
  float* dlt = part + 64;             // [64] dh . h
  float* ns = dlt + 64;               // [DK] n_c
  float* csum = ns + DK;              // [4][256] per-warp column sums

  const int W = dm.W, nc = dm.nc, Dv = dm.Dv;
  const int rb = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int r0 = rb * 64;
  const long long chunk = (long long)bh * nc + c;
  const long long row0 = (long long)bh * dm.S + (long long)c * W;
  const long long tb = (long long)c * W;
  const bf16* qb = q + b * sq.b + hh * sq.h + (tb + r0) * sq.s;
  const bf16* kb = k + b * sk.b + hh * sk.h + tb * sk.s;
  const bf16* vb = v + b * sv.b + hh * sv.h + tb * sv.s;
  const float* dhb = dh + (row0 + r0) * Dv;
  const long long nss = (long long)dm.B * dm.H * nc * W * W;
  const Split Sx(wk.Sx, nss), dPx(wk.dPx, nss);
  for (int t = tid; t < 256; t += 128) {
    Fc[t] = t < W ? wk.F[row0 + t] : 0.f;
    lic[t] = t < W ? li[row0 + t] : 0.f;
  }
  for (int d = tid; d < DK; d += 128) ns[d] = wk.n0[chunk * DK + d];
  if (tid < 64) mjc[tid] = wk.mj[row0 + r0 + tid];

  // P = q k^T over Dk in 64-wide pieces (k rows past W zero); q . n_c
  // alongside, two threads a row
  float acc[128];
  zero(acc);
  float qn = 0.f;
  pieces<SC_SLOT>(base, 0, DK / 64, [&](int p, uint8_t* slot) {
    load_tile(slot, kb + 64 * p, sk.s, 256, 64, W, 64, tid, 128);
    load_tile(slot + 32768, qb + 64 * p, sq.s, 64, 64, 64, 64, tid, 128);
  }, [&](int p, const uint8_t* slot) {
    const uint8_t* qt = slot + 32768;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss_n256<0, 0>(acc, kmaj(qt, kk), kmaj(slot, kk));
    wgmma_commit();
    const int rr = tid >> 1, half = tid & 1;
#pragma unroll
    for (int ch = 4 * half; ch < 4 * half + 4; ++ch) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          qt + sw128_offset(64, rr, 0, ch));
      const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qn = fmaf(bf(wd[u] & 0xffffu), ns[64 * p + 8 * ch + 2 * u], qn);
        qn = fmaf(bf(wd[u] >> 16), ns[64 * p + 8 * ch + 2 * u + 1], qn);
      }
    }
    wgmma_wait();
    fence_regs(acc);
  });

  // S = scale P D over this block's rows and every key (zeros above the
  // diagonal and past W), written as hi and lo; the row sums, then den,
  // M and dden
  {
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = 16 * w + lane / 4 + 8 * hf, r = r0 + rr;
        const int t = 8 * j + 2 * (lane % 4);
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[e] = t + e <= r ? acc[4 * j + 2 * hf + e] * scale *
                                  expf(((Fc[r] - Fc[t + e]) + lic[t + e]) -
                                       mjc[rr])
                            : 0.f;
          rs[hf] += x[e];
        }
        if (t < W) {
          const long long o = ((chunk * W + r) * W + t) >> 1;
          uint32_t hi, lo;
          split2(x[0], x[1], hi, lo);
          reinterpret_cast<uint32_t*>(Sx.hi)[o] = hi;
          reinterpret_cast<uint32_t*>(Sx.lo)[o] = lo;
        }
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = rs[hf];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (lane % 4 == 0) part[16 * w + lane / 4 + 8 * hf] = x;
    }
  }
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  if ((tid & 1) == 0) qnc[tid >> 1] = qn;
  // dh . h, a warp a row
  for (int rr = w * 16; rr < w * 16 + 16; ++rr) {
    const float4* hr =
        reinterpret_cast<const float4*>(h + (row0 + r0 + rr) * Dv);
    const float4* dr = reinterpret_cast<const float4*>(dhb + rr * Dv);
    float dl = 0.f;
    for (int x4 = lane; x4 < Dv / 4; x4 += 32) {
      const float4 a = dr[x4], bb = hr[x4];
      dl = fmaf(a.x, bb.x, dl);
      dl = fmaf(a.y, bb.y, dl);
      dl = fmaf(a.z, bb.z, dl);
      dl = fmaf(a.w, bb.w, dl);
    }
    dl = warp_sum(dl);
    if (lane == 0) dlt[rr] = dl;
  }
  __syncthreads();
  if (tid < 64) {
    const long long row = row0 + r0 + tid;
    const float den = part[tid] + wk.inter[row] * (scale * qnc[tid]);
    const float floor = expf(-mjc[tid]);
    const float M = fmaxf(fabsf(den), floor);
    const float dd = fabsf(den) >= floor
                         ? (-(den > 0.f ? 1.f : -1.f) * dlt[tid]) / M
                         : 0.f;
    Mc[tid] = M;
    ddc[tid] = dd;
    wk.Md[row] = M;
    wk.dden[row] = dd;
  }
  __syncthreads();

  // dnum v^T over Dv in 64-wide pieces, dnum split in registers
  zero(acc);
  pieces<SC_SLOT>(base, 0, Dv / 64, [&](int p, uint8_t* slot) {
    load_tile(slot, vb + 64 * p, sv.s, 256, 64, W, 64, tid, 128);
    load_f32(reinterpret_cast<float*>(slot + 32768), LDR, dhb + 64 * p, Dv,
             tid);
  }, [&](int p, const uint8_t* slot) {
    const float* at = reinterpret_cast<const float*>(slot + 32768);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      frag_rows(at, Mc, kk, w, lane, hi[kk], lo[kk]);
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs_n256<0>(acc, hi[kk], kmaj(slot, kk));
      mma_rs_n256<0>(acc, lo[kk], kmaj(slot, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  });

  // dS = dnum v^T + dden, scale dP = scale dS D, dwlog = dS S: scale dP
  // as hi and lo, dwlog's row sums and this block's column sums
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float col[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = 16 * w + lane / 4 + 8 * hf, r = r0 + rr;
      const int t = 8 * j + 2 * (lane % 4);
      if (t >= W) continue;
      const long long o = ((chunk * W + r) * W + t) >> 1;
      const uint32_t sh = reinterpret_cast<const uint32_t*>(Sx.hi)[o];
      const uint32_t sl = reinterpret_cast<const uint32_t*>(Sx.lo)[o];
      float dp[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[e] = 0.f;
        if (t + e <= r) {
          const float dS = acc[4 * j + 2 * hf + e] + ddc[rr];
          dp[e] = dS * expf(((Fc[r] - Fc[t + e]) + lic[t + e]) - mjc[rr]) *
                  scale;
          const float dwl = dS * hilo(sh, sl, e);
          rs[hf] += dwl;
          col[e] += dwl;
        }
      }
      uint32_t hi, lo;
      split2(dp[0], dp[1], hi, lo);
      reinterpret_cast<uint32_t*>(dPx.hi)[o] = hi;
      reinterpret_cast<uint32_t*>(dPx.lo)[o] = lo;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = col[e];
      x += __shfl_xor_sync(0xffffffffu, x, 4);
      x += __shfl_xor_sync(0xffffffffu, x, 8);
      x += __shfl_xor_sync(0xffffffffu, x, 16);
      if (lane < 4) csum[w * 256 + 8 * j + 2 * lane + e] = x;
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float x = rs[hf];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (lane % 4 == 0) wk.rsum[row0 + r0 + 16 * w + lane / 4 + 8 * hf] = x;
  }
  __syncthreads();
  for (int t = tid; t < W; t += 128)
    wk.csum_p[(chunk * dm.nrb + rb) * W + t] =
        ((csum[t] + csum[256 + t]) + csum[512 + t]) + csum[768 + t];
}

// ---- dq, dk and dv ----

// a slot: two [4][64][64] B tiles (hi, lo; or one) at 0 and 32768, the A
// side at 65536: a dh tile of f32 rows, or two [1][64][64] tiles (hi,
// lo; or one)
constexpr int DQ_SLOT = 83968;
constexpr int DQ_A = 65536;
constexpr int DQ_SMEM = 1024 + 2 * DQ_SLOT + 4 * 256 * 4;

// blockIdx.x: 0, 1 dq over key columns [256 x, 256 x + 256), 2, 3 dk;
// blockIdx.y the 64-row block, blockIdx.z the chunk of a (b, h)
__global__ void __launch_bounds__(128, 1)
bwd_dqdk_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, Strides sq, Strides sk, Strides sv,
            const float* __restrict__ dh, bf16* __restrict__ dq,
            bf16* __restrict__ dk, Work wk, Dims dm, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  float* Mc = reinterpret_cast<float*>(base + 2 * DQ_SLOT);   // [64]
  float* vec = Mc + 64;               // [256] n_c or dn on these columns
  const int W = dm.W, nc = dm.nc, Dv = dm.Dv, R = W / 64;
  const bool is_dq = blockIdx.x < NDT;
  const int d0 = (blockIdx.x % NDT) * DT;
  const int rb = blockIdx.y, c = blockIdx.z % nc, bh = blockIdx.z / nc;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int r0 = rb * 64;
  const long long chunk = (long long)bh * nc + c;
  const long long row0 = (long long)bh * dm.S + (long long)c * W;
  const long long tb = (long long)c * W;
  const bf16* qh = q + b * sq.b + hh * sq.h + tb * sq.s + d0;
  const bf16* kh = k + b * sk.b + hh * sk.h + tb * sk.s + d0;
  const bf16* vh = v + b * sv.b + hh * sv.h + tb * sv.s;
  const long long nss = (long long)dm.B * dm.H * nc * W * W;
  const long long nst = (long long)dm.B * dm.H * nc * DK * Dv;
  const Split dPx(wk.dPx, nss), C0(wk.C0, nst), dC1(wk.dC1, nst);
  const long long sbase = chunk * W * W;          // S, dP rows of the chunk
  const long long cbase = chunk * Dv * DK;        // C_c^T, dC^T of it
  if (tid < 64) Mc[tid] = wk.Md[row0 + r0 + tid];
  for (int d = tid; d < DT; d += 128)
    vec[d] = (is_dq ? wk.n0 : wk.dn1)[chunk * DK + d0 + d];
  __syncthreads();

  float acc[128];
  zero(acc);
  const int PA = Dv / 64;
  if (is_dq) {
    // u = dnum C_c^T: dnum split in registers, C_c^T hi and lo
    pieces<DQ_SLOT>(base, 0, PA, [&](int p, uint8_t* slot) {
      load_tile(slot, C0.hi + cbase + 64 * p * DK + d0, DK, 64, DT, 64, DT,
                tid, 128);
      load_tile(slot + 32768, C0.lo + cbase + 64 * p * DK + d0, DK, 64, DT,
                64, DT, tid, 128);
      load_f32(reinterpret_cast<float*>(slot + DQ_A), LDR,
               dh + (row0 + r0) * Dv + 64 * p, Dv, tid);
    }, [&](int p, const uint8_t* slot) {
      const float* at = reinterpret_cast<const float*>(slot + DQ_A);
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        frag_rows(at, Mc, kk, w, lane, hi[kk], lo[kk]);
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_rs_n256_mn(acc, hi[kk], mnmaj(slot, 0, kk));
        mma_rs_n256_mn(acc, hi[kk], mnmaj(slot + 32768, 0, kk));
        mma_rs_n256_mn(acc, lo[kk], mnmaj(slot, 0, kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
      fence_regs(hi);
      fence_regs(lo);
    });
    // de over these columns: sum_d scale q (u + dden n_c); then acc =
    // scale e (u + dden n_c)
    float pe[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = 16 * w + lane / 4 + 8 * hf;
      const long long row = row0 + r0 + rr;
      const float dd = wk.dden[row], se = scale * wk.inter[row];
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int dl = 8 * j + 2 * (lane % 4);
        const uint32_t qq = *reinterpret_cast<const uint32_t*>(
            qh + (long long)(r0 + rr) * sq.s + dl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = fmaf(dd, vec[dl + e], acc[4 * j + 2 * hf + e]);
          pe[hf] = fmaf(bf(e ? qq >> 16 : qq & 0xffffu) * scale, x,
                        pe[hf]);
          acc[4 * j + 2 * hf + e] = se * x;
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = pe[hf];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (lane % 4 == 0)
        wk.dinter_p[(row0 + r0 + 16 * w + lane / 4 + 8 * hf) * dm.nds +
                    blockIdx.x % NDT] = x;
    }
    // + (scale dP) k over the keys t < r0 + 64
    pieces<DQ_SLOT>(base, 0, rb + 1, [&](int p, uint8_t* slot) {
      load_tile(slot, kh + 64 * p * sk.s, sk.s, 64, DT, 64, DT, tid, 128);
      load_tile(slot + DQ_A, dPx.hi + sbase + r0 * W + 64 * p, W, 64, 64,
                64, 64, tid, 128);
      load_tile(slot + DQ_A + 8192, dPx.lo + sbase + r0 * W + 64 * p, W, 64,
                64, 64, 64, tid, 128);
    }, [&](int p, const uint8_t* slot) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_n256<0, 1>(acc, kmaj(slot + DQ_A, kk), mnmaj(slot, 0, kk));
        mma_ss_n256<0, 1>(acc, kmaj(slot + DQ_A + 8192, kk),
                          mnmaj(slot, 0, kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    });
  } else {
    // r = v dC^T (v exact), dC^T hi and lo
    pieces<DQ_SLOT>(base, 0, PA, [&](int p, uint8_t* slot) {
      load_tile(slot, dC1.hi + cbase + 64 * p * DK + d0, DK, 64, DT, 64, DT,
                tid, 128);
      load_tile(slot + 32768, dC1.lo + cbase + 64 * p * DK + d0, DK, 64, DT,
                64, DT, tid, 128);
      load_tile(slot + DQ_A, vh + (long long)r0 * sv.s + 64 * p, sv.s, 64,
                64, 64, 64, tid, 128);
    }, [&](int p, const uint8_t* slot) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_n256<0, 1>(acc, kmaj(slot + DQ_A, kk), mnmaj(slot, 0, kk));
        mma_ss_n256<0, 1>(acc, kmaj(slot + DQ_A, kk),
                          mnmaj(slot + 32768, 0, kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    });
    // dw over these columns: sum_d k (r + dn); then acc = w (r + dn)
    float pw[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = 16 * w + lane / 4 + 8 * hf;
      const float wt = wk.wkv[row0 + r0 + rr];
#pragma unroll
      for (int j = 0; j < DT / 8; ++j) {
        const int dl = 8 * j + 2 * (lane % 4);
        const uint32_t kv = *reinterpret_cast<const uint32_t*>(
            kh + (long long)(r0 + rr) * sk.s + dl);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * j + 2 * hf + e] + vec[dl + e];
          pw[hf] = fmaf(bf(e ? kv >> 16 : kv & 0xffffu), x, pw[hf]);
          acc[4 * j + 2 * hf + e] = wt * x;
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float x = pw[hf];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (lane % 4 == 0)
        wk.dwkv_p[(row0 + r0 + 16 * w + lane / 4 + 8 * hf) * dm.nds +
                  blockIdx.x % NDT] = x;
    }
    // + (scale dP)^T q over the rows j >= r0: dP's rows read MN-major
    pieces<DQ_SLOT>(base, rb, R, [&](int p, uint8_t* slot) {
      load_tile(slot, qh + 64 * p * sq.s, sq.s, 64, DT, 64, DT, tid, 128);
      load_tile(slot + DQ_A, dPx.hi + sbase + 64 * p * W + r0, W, 64, 64, 64,
                64, tid, 128);
      load_tile(slot + DQ_A + 8192, dPx.lo + sbase + 64 * p * W + r0, W, 64,
                64, 64, 64, tid, 128);
    }, [&](int p, const uint8_t* slot) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        mma_ss_n256<1, 1>(acc, mnmaj(slot + DQ_A, 0, kk), mnmaj(slot, 0, kk));
        mma_ss_n256<1, 1>(acc, mnmaj(slot + DQ_A + 8192, 0, kk),
                          mnmaj(slot, 0, kk));
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(acc);
    });
  }
  bf16* out = is_dq ? dq : dk;
#pragma unroll
  for (int j = 0; j < DT / 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = 16 * w + lane / 4 + 8 * hf;
      const int d = d0 + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(out + (row0 + r0 + rr) * DK + d) =
          pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
}

// one block per 64 value columns of a chunk: dv^T = w (dC^T k^T) + dnum^T S
__global__ void __launch_bounds__(128, 1)
bwd_dv_tc(const bf16* __restrict__ k, Strides sk,
          const float* __restrict__ dh, bf16* __restrict__ dv, Work wk,
          Dims dm) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  float* Mc = reinterpret_cast<float*>(base + 2 * DQ_SLOT);   // [256]
  float* wc = Mc + 256;               // [256]
  const int W = dm.W, nc = dm.nc, Dv = dm.Dv, R = W / 64;
  const int col0 = blockIdx.x * XT, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / dm.H, hh = bh % dm.H;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const long long chunk = (long long)bh * nc + c;
  const long long row0 = (long long)bh * dm.S + (long long)c * W;
  const bf16* kh = k + b * sk.b + hh * sk.h + (long long)c * W * sk.s;
  const long long nss = (long long)dm.B * dm.H * nc * W * W;
  const long long nst = (long long)dm.B * dm.H * nc * DK * Dv;
  const Split Sx(wk.Sx, nss), dC1(wk.dC1, nst);
  const long long sbase = chunk * W * W, cbase = (chunk * Dv + col0) * DK;
  for (int t = tid; t < 256; t += 128) {
    Mc[t] = t < W ? wk.Md[row0 + t] : 1.f;
    wc[t] = t < W ? wk.wkv[row0 + t] : 0.f;
  }
  __syncthreads();

  float acc[128];
  zero(acc);
  // dC^T k^T over the key columns: dC^T hi and lo, k exact, K-major both
  pieces<DQ_SLOT>(base, 0, DK / 64, [&](int p, uint8_t* slot) {
    load_tile(slot, kh + 64 * p, sk.s, 256, 64, W, 64, tid, 128);
    load_tile(slot + DQ_A, dC1.hi + cbase + 64 * p, DK, 64, 64, 64, 64, tid,
              128);
    load_tile(slot + DQ_A + 8192, dC1.lo + cbase + 64 * p, DK, 64, 64, 64,
              64, tid, 128);
  }, [&](int p, const uint8_t* slot) {
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_ss_n256<0, 0>(acc, kmaj(slot + DQ_A, kk), kmaj(slot, kk));
      mma_ss_n256<0, 0>(acc, kmaj(slot + DQ_A + 8192, kk), kmaj(slot, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
  });
  // times w_t, column t = 8 j + 2 (lane % 4) + e % 2
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * j + e] *= wc[8 * j + 2 * (lane % 4) + (e & 1)];
  // + dnum^T S over the chunk's rows: dnum^T split in registers, S hi and
  // lo read MN-major
  pieces<DQ_SLOT>(base, 0, R, [&](int p, uint8_t* slot) {
    load_tile(slot, Sx.hi + sbase + 64 * p * W, W, 64, 256, 64, W, tid, 128);
    load_tile(slot + 32768, Sx.lo + sbase + 64 * p * W, W, 64, 256, 64, W,
              tid, 128);
    load_f32(reinterpret_cast<float*>(slot + DQ_A), LDC,
             dh + (row0 + 64 * p) * Dv + col0, Dv, tid);
  }, [&](int p, const uint8_t* slot) {
    const float* at = reinterpret_cast<const float*>(slot + DQ_A);
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int m = 16 * w + lane / 4 + 8 * (x & 1);
        const int kr = 16 * kk + 2 * (lane % 4) + 8 * (x >> 1);
        split2(at[kr * LDC + m] / Mc[64 * p + kr],
               at[(kr + 1) * LDC + m] / Mc[64 * p + kr + 1], hi[kk][x],
               lo[kk][x]);
      }
    }
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_rs_n256_mn(acc, hi[kk], mnmaj(slot, 0, kk));
      mma_rs_n256_mn(acc, hi[kk], mnmaj(slot + 32768, 0, kk));
      mma_rs_n256_mn(acc, lo[kk], mnmaj(slot, 0, kk));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
  });
  // dv[t, x] from dv^T's element (x, t)
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = col0 + 16 * w + lane / 4 + 8 * (e >> 1);
      const int t = 8 * j + 2 * (lane % 4) + (e & 1);
      if (t < W) dv[(row0 + t) * Dv + x] = __float2bfloat16(acc[4 * j + e]);
    }
}

cudaError_t launch(const void* q_, const void* k_, const void* v_,
                   const float* li, const float* lf, const float* h,
                   const float* dh, void* dq_, void* dk_, void* dv_,
                   float* dli, float* dlf, float* ws, const Dims& dm,
                   const long long* strides, float scale,
                   cudaStream_t stream) {
  const bf16* q = static_cast<const bf16*>(q_);
  const bf16* k = static_cast<const bf16*>(k_);
  const bf16* v = static_cast<const bf16*>(v_);
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides sdh{(long long)dm.H * dm.S * dm.Dv, (long long)dm.S * dm.Dv,
                    dm.Dv};
  Work w;
  carve(w, ws, dm);
  const int BH = dm.B * dm.H;
  const long long nst = (long long)BH * dm.nc * DK * dm.Dv;
  const Split C0(w.C0, nst), dC1(w.dC1, nst);
  cudaError_t err;
  auto smem = [](const void* fn, int bytes) {
    return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                bytes);
  };

  bwd_gates_kernel<<<BH, 128, 0, stream>>>(li, lf, w, dm.S, dm.W, dm.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_n_kernel<<<dim3(DK / 32, BH), 32 * NL, 0, stream>>>(
      k, sk, w.wkv, w.decay, w.n0, dm.H, dm.S, DK, dm.W, dm.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = smem((const void*)bwd_states_tc, CH_SMEM)) != cudaSuccess)
    return err;
  bwd_states_tc<<<dim3(dm.Dv / XT, NDT, BH), 128, CH_SMEM, stream>>>(
      k, sk, v, sv, w.wkv, w.decay, C0, dm.H, dm.S, dm.Dv, dm.W, dm.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = smem((const void*)bwd_scores_tc, SC_SMEM)) != cudaSuccess)
    return err;
  bwd_scores_tc<<<dim3(dm.W / 64, dm.nc, BH), 128, SC_SMEM, stream>>>(
      q, k, v, sq, sk, sv, li, h, dh, w, dm, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_dn_kernel<<<dim3(DK / 32, BH), 32 * NL, 0, stream>>>(
      q, sq, w.inter, w.dden, scale, w.decay, w.dn1, w.n0, w.dg_p, dm.ndv,
      dm.H, dm.S, DK, dm.W, dm.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = smem((const void*)bwd_sweep_tc, CH_SMEM)) != cudaSuccess)
    return err;
  bwd_sweep_tc<<<dim3(dm.Dv / XT, NDT, BH), 128, CH_SMEM, stream>>>(
      q, sq, dh, sdh, w.inter, w.Md, scale, w.decay, dC1, C0, w.dg_p,
      dm.ndv, dm.H, dm.S, dm.Dv, dm.W, dm.nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = smem((const void*)bwd_dqdk_tc, DQ_SMEM)) != cudaSuccess)
    return err;
  bwd_dqdk_tc<<<dim3(2 * NDT, dm.W / 64, dm.nc * BH), 128, DQ_SMEM,
                stream>>>(q, k, v, sq, sk, sv, dh, static_cast<bf16*>(dq_),
                          static_cast<bf16*>(dk_), w, dm, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = smem((const void*)bwd_dv_tc, DQ_SMEM)) != cudaSuccess)
    return err;
  bwd_dv_tc<<<dim3(dm.Dv / XT, dm.nc, BH), 128, DQ_SMEM, stream>>>(
      k, sk, dh, static_cast<bf16*>(dv_), w, dm);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_grads_kernel<<<BH, NT, 0, stream>>>(w, dm, dli, dlf);
  return cudaGetLastError();
}

}  // namespace tc

bool dims_ok(int B, int H, int S, int Dk, int Dv, int W, bool tc) {
  if (B < 1 || H < 1 || W < 1 || W > WMAX || S < W || S % W || Dk < 1 ||
      Dk > DKMAX || Dv < 1)
    return false;
  if (tc && (Dk != tc::DK || Dv % 64 || W % 64)) return false;
  const long long bh = (long long)B * H;
  return bh <= 65535 && bh * (S / W) <= 65535;
}

}  // namespace

extern "C" {

// Floats of the scratch buffer that mlstm_chunk_bwd_launch takes on the
// path tensor_cores names, or -1 for shapes it refuses.
long long mlstm_chunk_bwd_workspace(int B, int H, int S, int Dk, int Dv,
                                    int W, int tensor_cores) {
  if (!dims_ok(B, H, S, Dk, Dv, W, tensor_cores)) return -1;
  Work w;
  return carve(w, nullptr, make_dims(B, H, S, Dk, Dv, W, tensor_cores));
}

// Launches the backward on `stream`; returns 0 or a cudaError_t. strides
// holds q's, k's and v's b, h and s strides in elements; ws holds
// mlstm_chunk_bwd_workspace(..., tensor_cores) floats. tensor_cores
// selects the tc path (bf16, Dk 512, Dv and W multiples of 64, q, k, v
// and their b/h/s strides 16-byte aligned, as the wrapper's
// uses_tensor_cores checks); else the FMA kernels.
int mlstm_chunk_bwd_launch(const void* q, const void* k, const void* v,
                           const float* li, const float* lf, const float* h,
                           const float* dh, void* dq, void* dk, void* dv,
                           float* dli, float* dlf, float* ws, int bf16,
                           int tensor_cores, int B, int H, int S, int Dk,
                           int Dv, int W, const long long* strides,
                           float scale, void* stream) {
  if (!dims_ok(B, H, S, Dk, Dv, W, tensor_cores) || (tensor_cores && !bf16))
    return (int)cudaErrorInvalidValue;
  const Dims dm = make_dims(B, H, S, Dk, Dv, W, tensor_cores);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores)
    return (int)tc::launch(q, k, v, li, lf, h, dh, dq, dk, dv, dli, dlf, ws,
                           dm, strides, scale, st);
  return (int)(bf16 ? launch<__nv_bfloat16>(q, k, v, li, lf, h, dh, dq, dk,
                                            dv, dli, dlf, ws, dm, strides,
                                            scale, st)
                    : launch<float>(q, k, v, li, lf, h, dh, dq, dk, dv, dli,
                                    dlf, ws, dm, strides, scale, st));
}

const char* mlstm_chunk_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
