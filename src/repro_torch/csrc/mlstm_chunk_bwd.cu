// Gradient of the chunkwise stabilised mLSTM forward (csrc/mlstm_chunk.cu)
// for Hopper (sm_90a), with a plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package trains the mLSTM through
// jax.grad of its scan, src/repro/models/ssm.py::_mlstm_chunk_scan, and
// has no Pallas backward. Inputs are the forward's: q, k (B, H, S, Dk),
// v (B, H, S, Dv) in f32 or bf16 with any b/h/s strides and unit stride
// along the last dimension; li, lf (B, H, S) f32; h and its gradient dh
// (B, H, S, Dv) f32, contiguous. Out: dq, dk, dv in the inputs' type and
// dli, dlf f32, all contiguous; C, n and m carry no gradient. Every
// product runs in f32 on the FMA units and each output is rounded once.
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
// Six kernels, in order on the caller's stream, through one f32 scratch
// buffer that the wrapper allocates (mlstm_chunk_bwd_workspace floats):
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
// Bound on an H100 SXM, per chunk of a (b, h): the causal products P, dnum
// v^T, S^T dnum, dP k and dP^T q (W (W + 1) (3 Dk + 2 Dv) operations) and
// the state products (C_c dnum, dC v, k dC, the dC update and the
// recomputed C update: 10 W Dk Dv) at 67 TFLOP/s: at B 4, H 4, S 512, Dk
// 512, Dv 1024, W 256 that is 50.5 GFLOP, 0.75 ms, against 0.04 ms of
// bytes (bf16 q, k, v and their gradients, f32 h, dh and the gates'
// rows: 134 MB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

Dims make_dims(int B, int H, int S, int Dk, int Dv, int W) {
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
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int c = i / W, t0 = c * W;
    const float ftot = Fb[t0 + W - 1];
    const float mn = c + 1 < nc ? ms[c + 1] : m_end;
    w.wkv[bh * S + i] = expf(((ftot - Fb[i]) + lib[i]) - mn);
    float mx = -INFINITY;
    for (int t = t0; t <= i; ++t) mx = fmaxf(mx, (Fb[i] - Fb[t]) + lib[t]);
    const float bi = Fb[i] + ms[c];
    const float mj = fmaxf(mx, bi);
    w.mj[bh * S + i] = mj;
    w.inter[bh * S + i] = expf(bi - mj);
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

bool dims_ok(int B, int H, int S, int Dk, int Dv, int W) {
  if (B < 1 || H < 1 || W < 1 || W > WMAX || S < W || S % W || Dk < 1 ||
      Dk > DKMAX || Dv < 1)
    return false;
  const long long bh = (long long)B * H;
  return bh <= 65535 && bh * (S / W) <= 65535;
}

}  // namespace

extern "C" {

// Floats of the scratch buffer that mlstm_chunk_bwd_launch takes, or -1
// for shapes it refuses.
long long mlstm_chunk_bwd_workspace(int B, int H, int S, int Dk, int Dv,
                                    int W) {
  if (!dims_ok(B, H, S, Dk, Dv, W)) return -1;
  Work w;
  return carve(w, nullptr, make_dims(B, H, S, Dk, Dv, W));
}

// Launches the backward on `stream`; returns 0 or a cudaError_t. strides
// holds q's, k's and v's b, h and s strides in elements; ws holds
// mlstm_chunk_bwd_workspace(...) floats.
int mlstm_chunk_bwd_launch(const void* q, const void* k, const void* v,
                           const float* li, const float* lf, const float* h,
                           const float* dh, void* dq, void* dk, void* dv,
                           float* dli, float* dlf, float* ws, int bf16, int B,
                           int H, int S, int Dk, int Dv, int W,
                           const long long* strides, float scale,
                           void* stream) {
  if (!dims_ok(B, H, S, Dk, Dv, W)) return (int)cudaErrorInvalidValue;
  const Dims dm = make_dims(B, H, S, Dk, Dv, W);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
