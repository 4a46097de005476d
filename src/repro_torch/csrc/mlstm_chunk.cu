// Chunkwise stabilised mLSTM forward for Hopper (sm_90a), from a zero
// state, with a plain C interface for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mlstm_chunk.py::mlstm_chunk
// (oracle: src/repro/models/ssm.py::_mlstm_chunk_scan). q, k (B, H, S,
// Dk), v (B, H, S, Dv) in f32 or bf16 with any b/h/s strides and unit
// stride along the last dimension (the model's v is a view of its (B, S,
// H, Dv) up-projection); li, lf (B, H, S) f32 contiguous. Out: h (B, H,
// S, Dv), C (B, H, Dk, Dv), n (B, H, Dk), m (B, H), f32 contiguous. Per
// chunk of W rows (S = nc W), with F the inclusive cumulative sum of lf
// in the chunk and m the carried stabiliser (0 at the start):
//   mj_r   = max(max_{t<=r} (F_r - F_t) + li_t, F_r + m)
//   s_rt   = (scale q_r . k_t) exp((F_r - F_t) + li_t - mj_r), t <= r
//   h_r    = (s_r v + e_r scale q_r C) / max(|sum_t s_rt + e_r scale q_r n|,
//            exp(-mj_r)),   e_r = exp(F_r + m - mj_r)
//   m'     = max(Ftot + m, max_t (Ftot - F_t) + li_t)
//   C'     = exp(Ftot + m - m') C + sum_t w_t k_t v_t^T,
//   n'     = exp(Ftot + m - m') n + sum_t w_t k_t,
//            w_t = exp((Ftot - F_t) + li_t - m')
// The stabilisers depend on the gates alone, so they are computed before
// any product and nothing is rescaled online.
//
// Two paths. bf16 inputs at xlstm's widths take the tensor cores
// (namespace tc below: four kernels, the products on wgmma). Every other
// input takes three FMA kernels, in order on the caller's stream:
//   gates   one block per (b, h): F (each chunk's sum taken in sequence,
//           as the reference takes it), the chain of m over the chunks,
//           w and each chunk's decay; the final m.
//   scores  one block per 64 rows of a chunk of a (b, h): mj, e and the
//           masked, decayed scores s (W x W a chunk, zeros above the
//           diagonal) into scratch. Every state block reads them: they
//           do not depend on the value columns.
//   state   one block per (b, h) and 32 value columns: keeps C[:, cols]
//           (Dk x 32 f32, 64 KB at Dk 512) and n in shared memory across
//           its loop over the chunks, and per chunk computes q C and
//           q n, adds s v and sum_t s, writes h, then updates C and n.
//           C goes to device memory once, at the end. B H (Dv / 32)
//           blocks: 1024 at B 8, H 4, Dv 1024 and 128 at B 1, two a SM.
//
// Products run on the FMA units in f32 from shared-memory tiles, each
// thread holding a register tile (8 x 4 outputs for h, 16 x 4 for C,
// 8 x 8 for s). The state kernel streams its operand tiles (q, s and v,
// k and v) through registers: a tile's global loads are issued before
// the products of the one before, so the products hide their latency.
// Bound on an H100 SXM: W (W + 1) (Dk + Dv) + 4 W Dk Dv operations a
// chunk of a (b, h) at 67 TFLOP/s; at the serving shape 2.43 ms against
// 0.18 ms of bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mlstm_tc.cuh"

namespace {

constexpr int NT = 256;           // threads of the scores and state blocks
constexpr int WMAX = 256;         // rows of a chunk at most
constexpr int DKMAX = 512;        // key width at most
constexpr int DVB = 32;           // value columns a state block owns
constexpr int RB = 64;            // rows of a scores block
constexpr int TD = 32;            // key-dim depth of a q or k tile
constexpr int TT = 32;            // time depth of an s v tile
constexpr int TU = 8;             // time depth of a state-update tile
constexpr int LDW = WMAX + 4;     // padded (depth, row) tile row
constexpr int LDR = RB + 4;

struct Strides {
  long long b, h, s;              // in elements; the last stride is 1
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__global__ void mlstm_gates_kernel(const float* __restrict__ li,
                                   const float* __restrict__ lf,
                                   float* __restrict__ F,
                                   float* __restrict__ wkv,
                                   float* __restrict__ mstart,
                                   float* __restrict__ decay,
                                   float* __restrict__ m_out, int S, int W,
                                   int nc) {
  const long long bh = blockIdx.x;
  const float* lib = li + bh * S;
  const float* lfb = lf + bh * S;
  float* Fb = F + bh * S;
  float* ms = mstart + bh * nc;
  float* dc = decay + bh * nc;
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
    m_out[bh] = m;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    const int c = i / W;
    const float ftot = Fb[c * W + W - 1];
    const float mn = c + 1 < nc ? ms[c + 1] : m_out[bh];
    wkv[bh * S + i] = expf(((ftot - Fb[i]) + lib[i]) - mn);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlstm_scores_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    Strides sq, Strides sk, const float* __restrict__ F,
                    const float* __restrict__ li,
                    const float* __restrict__ mstart,
                    float* __restrict__ mj_out, float* __restrict__ inter_out,
                    float* __restrict__ s_out, int H, int S, int Dk, int W,
                    int nc, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                   // [TD][LDR] scale q, depth-major
  float* kt = qt + TD * LDR;          // [TD][LDW] k, depth-major
  float* Fc = kt + TD * LDW;          // [WMAX]
  float* lic = Fc + WMAX;             // [WMAX]
  float* mjc = lic + WMAX;            // [RB]

  const int r0 = blockIdx.x * RB;
  const int c = blockIdx.y;
  const int bh = blockIdx.z;
  const int b = bh / H, hh = bh % H;
  const int tid = threadIdx.x;
  const long long row0 = (long long)bh * S + (long long)c * W;
  for (int t = tid; t < W; t += NT) {
    Fc[t] = F[row0 + t];
    lic[t] = li[row0 + t];
  }
  __syncthreads();

  const int rows = min(RB, W - r0);   // rows of this block
  const int tmax = r0 + rows;         // keys t < tmax can be live
  const int tpad = (tmax + 31) & ~31;
  {
    // mj and e, four lanes a row
    const int rr = tid >> 2, part = tid & 3, r = r0 + rr;
    float mx = -INFINITY;
    if (rr < rows)
      for (int t = part; t <= r; t += 4)
        mx = fmaxf(mx, (Fc[r] - Fc[t]) + lic[t]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if (part == 0 && rr < rows) {
      const float bi = Fc[r] + mstart[(long long)bh * nc + c];
      const float mj = fmaxf(mx, bi);
      mjc[rr] = mj;
      mj_out[row0 + r] = mj;
      inter_out[row0 + r] = expf(bi - mj);
    }
  }

  const int ty = tid >> 5, tx = tid & 31;   // rows ty*8 + i, keys tx + 32 j
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const T* qb = q + b * sq.b + hh * sq.h + ((long long)c * W + r0) * sq.s;
  const T* kb = k + b * sk.b + hh * sk.h + (long long)c * W * sk.s;
  for (int d0 = 0; d0 < Dk; d0 += TD) {
    for (int e = tid; e < RB * TD; e += NT) {
      const int r = e / TD, dd = e % TD;
      float x = 0.f;
      if (r < rows && d0 + dd < Dk) x = ld(qb + r * sq.s + d0 + dd) * scale;
      qt[dd * LDR + r] = x;
    }
    for (int e = tid; e < tpad * TD; e += NT) {
      const int t = e / TD, dd = e % TD;
      float x = 0.f;
      if (t < tmax && d0 + dd < Dk) x = ld(kb + t * sk.s + d0 + dd);
      kt[dd * LDW + t] = x;
    }
    __syncthreads();
    const int jn = tpad >> 5;         // key groups this block reaches
#pragma unroll 4
    for (int dd = 0; dd < TD; ++dd) {
      const float4 a0 = *reinterpret_cast<const float4*>(&qt[dd * LDR + ty * 8]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&qt[dd * LDR + ty * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float kv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = j < jn ? kt[dd * LDW + tx + 32 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* sb = s_out + ((long long)bh * nc + c) * W * W;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rr = ty * 8 + i;
    if (rr >= rows) continue;
    const int r = r0 + rr;
    const float Fr = Fc[r], mj = mjc[rr];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int t = tx + 32 * j;
      if (t >= W) continue;
      float val = 0.f;
      if (t <= r) val = acc[i][j] * expf(((Fr - Fc[t]) + lic[t]) - mj);
      sb[(long long)r * W + t] = val;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
mlstm_state_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, Strides sq, Strides sk,
                   Strides sv, const float* __restrict__ mj,
                   const float* __restrict__ inter,
                   const float* __restrict__ wkv,
                   const float* __restrict__ decay,
                   const float* __restrict__ s_in, float* __restrict__ hout,
                   float* __restrict__ Cout, float* __restrict__ nout, int H,
                   int S, int Dk, int Dv, int W, int nc, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int dkp = (Dk + TD - 1) & ~(TD - 1);  // rows past Dk stay zero
  const int ldk = dkp + 4;            // padded k tile row
  float* Cs = smem;                   // [dkp][DVB]
  float* ns = Cs + dkp * DVB;         // [dkp]
  float* mjc = ns + dkp;              // [WMAX]
  float* ic = mjc + WMAX;             // [WMAX] inter-chunk weights e
  float* wc = ic + WMAX;              // [WMAX] key weights w
  float* dn = wc + WMAX;              // [WMAX] denominators
  float* tile = dn + WMAX;            // the products' operand tiles

  const int col0 = blockIdx.x * DVB;
  const int bh = blockIdx.y;
  const int b = bh / H, hh = bh % H;
  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;  // products: cols tx*4 + j
  const int lane = tid & 31, wid = tid >> 5;  // loads: lanes along rows
  for (int i = tid; i < dkp * DVB; i += NT) Cs[i] = 0.f;
  for (int i = tid; i < dkp; i += NT) ns[i] = 0.f;
  const T* qh = q + b * sq.b + hh * sq.h;
  const T* kh = k + b * sk.b + hh * sk.h;
  const T* vh = v + b * sv.b + hh * sv.h;

  // Each phase streams its operand tiles through registers: the next
  // tile's global loads are issued before the current tile's products,
  // so their latency hides behind them, and stored after.
  float pre[32];
  float pre_v[4];

  for (int c = 0; c < nc; ++c) {
    const long long t_base = (long long)c * W;
    const long long row0 = (long long)bh * S + t_base;
    for (int t = tid; t < W; t += NT) {
      mjc[t] = mj[row0 + t];
      ic[t] = inter[row0 + t];
      wc[t] = wkv[row0 + t];
    }
    const float dec = decay[(long long)bh * nc + c];

    // h's numerator: e_r scale q_r C, and q_r n for the denominator.
    // q tile [TD][LDW], depth-major: warp wid loads rows wid + 8u, its
    // lanes 32 consecutive depths
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    float qn = 0.f;
    float* qt = tile;
    auto load_q = [&](int d0) {
      const bool live = d0 + lane < Dk;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int r = wid + 8 * u;
        pre[u] = live && r < W
                     ? ld(qh + (t_base + r) * sq.s + d0 + lane) * scale
                     : 0.f;
      }
    };
    load_q(0);
    for (int d0 = 0; d0 < Dk; d0 += TD) {
      __syncthreads();                // the last tile's readers are done
#pragma unroll
      for (int u = 0; u < 32; ++u) qt[lane * LDW + wid + 8 * u] = pre[u];
      __syncthreads();
      if (d0 + TD < Dk) load_q(d0 + TD);
      if (ty * 8 < W) {
#pragma unroll 8
        for (int dd = 0; dd < TD; ++dd) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(&qt[dd * LDW + ty * 8]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&qt[dd * LDW + ty * 8 + 4]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                              a1.x, a1.y, a1.z, a1.w};
          const float4 cv =
              *reinterpret_cast<const float4*>(&Cs[(d0 + dd) * DVB + tx * 4]);
          const float cc[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], cc[j], acc[i][j]);
          qn = fmaf(qt[dd * LDW + ty * 8 + tx], ns[d0 + dd], qn);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float e = ty * 8 + i < W ? ic[ty * 8 + i] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= e;
    }

    // + s v, and sum_t s for the denominator. s tile [TT][LDW],
    // time-major, loaded as the q tile; v tile [TT][DVB]
    float ssum = 0.f;
    float* st = tile;
    float* vt = tile + TT * LDW;
    const float* sb = s_in + ((long long)bh * nc + c) * W * W;
    auto load_s = [&](int t0) {
      const bool live = t0 + lane < W;
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int r = wid + 8 * u;
        pre[u] = live && r < W ? sb[(long long)r * W + t0 + lane] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + wid + 8 * u;
        pre_v[u] = t < W && col0 + lane < Dv
                       ? ld(vh + (t_base + t) * sv.s + col0 + lane)
                       : 0.f;
      }
    };
    load_s(0);
    for (int t0 = 0; t0 < W; t0 += TT) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 32; ++u) st[lane * LDW + wid + 8 * u] = pre[u];
#pragma unroll
      for (int u = 0; u < 4; ++u) vt[(wid + 8 * u) * DVB + lane] = pre_v[u];
      __syncthreads();
      if (t0 + TT < W) load_s(t0 + TT);
      if (ty * 8 < W && t0 <= ty * 8 + 7) {   // rows above t0 see zeros
#pragma unroll 8
        for (int tt = 0; tt < TT; ++tt) {
          const float4 a0 =
              *reinterpret_cast<const float4*>(&st[tt * LDW + ty * 8]);
          const float4 a1 =
              *reinterpret_cast<const float4*>(&st[tt * LDW + ty * 8 + 4]);
          const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                              a1.x, a1.y, a1.z, a1.w};
          const float4 bv = *reinterpret_cast<const float4*>(&vt[tt * DVB + tx * 4]);
          const float vv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], vv[j], acc[i][j]);
          ssum += st[tt * LDW + ty * 8 + tx];
        }
      }
    }

    // h = numerator / max(|sum_t s + e q n|, exp(-mj))
    {
      const int r = ty * 8 + tx;
      if (r < W) dn[r] = ssum + ic[r] * qn;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty * 8 + i;
      if (r >= W) continue;
      const float den = fmaxf(fabsf(dn[r]), expf(-mjc[r]));
      float* hr = hout + (row0 + r) * Dv + col0 + tx * 4;
      if ((Dv & 3) == 0 && col0 + tx * 4 + 4 <= Dv) {
        *reinterpret_cast<float4*>(hr) = make_float4(
            acc[i][0] / den, acc[i][1] / den, acc[i][2] / den,
            acc[i][3] / den);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + tx * 4 + j < Dv) hr[j] = acc[i][j] / den;
      }
    }

    // C' = decay C + sum_t (w_t k_t) v_t^T over this block's columns;
    // n' = decay n + sum_t w_t k_t. k tile [TU][ldk] time-major, each
    // thread loading depths tid and tid + NT of its TU rows (and adding
    // them into n as it stores them); v tile [TU][DVB]
    float acc2[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[i][j] = 0.f;
    float np0 = 0.f, np1 = 0.f;
    float* kt = tile;
    float* vu = tile + TU * ldk;
    auto load_k = [&](int t0) {
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const int t = t0 + u;
        const T* kr = kh + (t_base + t) * sk.s;
        pre[2 * u] = t < W && tid < Dk ? ld(kr + tid) : 0.f;
        pre[2 * u + 1] = t < W && tid + NT < Dk ? ld(kr + tid + NT) : 0.f;
      }
      const int t = t0 + wid;
      pre_v[0] = t < W && col0 + lane < Dv
                     ? ld(vh + (t_base + t) * sv.s + col0 + lane)
                     : 0.f;
    };
    load_k(0);
    for (int t0 = 0; t0 < W; t0 += TU) {
      __syncthreads();
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        const float w = t0 + u < W ? wc[t0 + u] : 0.f;
        const float k0 = w * pre[2 * u], k1 = w * pre[2 * u + 1];
        if (tid < dkp) kt[u * ldk + tid] = k0;
        if (tid + NT < dkp) kt[u * ldk + tid + NT] = k1;
        np0 += k0;
        np1 += k1;
      }
      vu[wid * DVB + lane] = pre_v[0];
      __syncthreads();
      if (t0 + TU < W) load_k(t0 + TU);
      if (ty * 16 < Dk) {
#pragma unroll
        for (int tt = 0; tt < TU; ++tt) {
          float kk[16];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float4 x =
                *reinterpret_cast<const float4*>(&kt[tt * ldk + ty * 16 + 4 * u]);
            kk[4 * u] = x.x;
            kk[4 * u + 1] = x.y;
            kk[4 * u + 2] = x.z;
            kk[4 * u + 3] = x.w;
          }
          const float4 bv = *reinterpret_cast<const float4*>(&vu[tt * DVB + tx * 4]);
          const float vv[4] = {bv.x, bv.y, bv.z, bv.w};
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
      const int d = ty * 16 + i;
      if (d >= Dk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* cp = &Cs[d * DVB + tx * 4 + j];
        *cp = dec * *cp + acc2[i][j];
      }
    }
    if (tid < Dk) ns[tid] = dec * ns[tid] + np0;
    if (tid + NT < Dk) ns[tid + NT] = dec * ns[tid + NT] + np1;
    __syncthreads();
  }

  for (int e = tid; e < Dk * DVB; e += NT) {
    const int d = e / DVB, cc = e % DVB;
    if (col0 + cc < Dv) Cout[((long long)bh * Dk + d) * Dv + col0 + cc] = Cs[e];
  }
  if (blockIdx.x == 0)
    for (int d = tid; d < Dk; d += NT) nout[(long long)bh * Dk + d] = ns[d];
}

size_t scores_smem() {
  return sizeof(float) * (TD * LDR + TD * LDW + 2 * WMAX + RB);
}

size_t state_smem(int Dk) {
  const int dkp = (Dk + TD - 1) & ~(TD - 1);
  const int ldk = dkp + 4;
  int tile = TD * LDW;
  tile = tile > TT * LDW + TT * DVB ? tile : TT * LDW + TT * DVB;
  tile = tile > TU * ldk + TU * DVB ? tile : TU * ldk + TU * DVB;
  return sizeof(float) * (dkp * DVB + dkp + 4 * WMAX + tile);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* li, const float* lf, float* h, float* C,
                   float* n, float* m, float* F, float* wkv, float* mstart,
                   float* decay, float* mj, float* inter, float* s, int B,
                   int H, int S, int Dk, int Dv, int W,
                   const long long* strides, float scale,
                   cudaStream_t stream) {
  const int nc = S / W, BH = B * H;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);

  mlstm_gates_kernel<<<BH, 128, 0, stream>>>(li, lf, F, wkv, mstart, decay,
                                             m, S, W, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t sm1 = scores_smem();
  err = cudaFuncSetAttribute(mlstm_scores_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm1);
  if (err != cudaSuccess) return err;
  const dim3 g1((W + RB - 1) / RB, nc, BH);
  mlstm_scores_kernel<T><<<g1, NT, sm1, stream>>>(
      qt, kt, sq, sk, F, li, mstart, mj, inter, s, H, S, Dk, W, nc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t sm2 = state_smem(Dk);
  err = cudaFuncSetAttribute(mlstm_state_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm2);
  if (err != cudaSuccess) return err;
  const dim3 g2((Dv + DVB - 1) / DVB, BH);
  mlstm_state_kernel<T><<<g2, NT, sm2, stream>>>(
      qt, kt, vt, sq, sk, sv, mj, inter, wkv, decay, s, h, C, n, H, S, Dk,
      Dv, W, nc, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// The tensor-core path (namespace tc): bf16 q, k, v with Dk 512 (xlstm's
// heads), Dv and W multiples of 64, 16-byte aligned rows (the wrapper's
// uses_tensor_cores). Four kernels: the gates kernel above, then
//   n       one block per (32 keys' columns, b, h): n at each chunk's
//           start (f32 FMAs, the weighted keys summed over the chunk by
//           16 lanes) and the final n;
//   scores  one warpgroup per 64 rows of a chunk: s = q k^T on wgmma
//           (m64n64k16, both operands K-major in shared memory, exact:
//           bf16 products summed in f32), masked and decayed in f32 as
//           above, written as bf16 hi = bf16(s) and lo = bf16(s - hi)
//           (s = hi + lo to 2^-17 of |s|); the row's e and its
//           denominator max(|sum_t s + e scale q . n|, exp(-mj));
//   state   one block per (b, h) and 64 value columns, two consumer
//           warpgroups. C^T (64 columns x Dk) lives in the accumulator
//           registers across the chunk loop, Dk / 2 = 256 keys' columns
//           a warpgroup (128 registers a thread). Per chunk,
//           for each 64 rows: the numerator^T = (C^T hi + C^T lo) q^T
//           (C^T split in registers, the register A operand; q the
//           K-major B operand), scaled by scale e per row, plus v^T
//           (s hi + s lo)^T (v^T the register A operand, exact in bf16;
//           s K-major), each warpgroup its half of Dk and half of the
//           causal keys; the two halves are summed through shared memory
//           and each warpgroup writes 32 rows of h. Then C^T = decay C^T
//           + ((w v)^T hi + lo) k, k the MN-major B operand (m64n256).
//           h reads C before the chunk's update. q, k, s and v come in
//           by cp.async into 128-byte-swizzled tiles, a two-slot ring of
//           64 KB pieces (q rows, s rows, k rows in turn) so that each
//           piece loads while the one before is multiplied.
// The f32 operands of the products (C, s and w v) are each carried as
// bf16 hi + lo, two products each: about 2^-17 of |x|, where one bf16 or
// TF32 rounding (2^-9 to 2^-11) would miss the 1e-4 tolerance.
// Bound on an H100 SXM: the products above, each split one counted
// twice, W^2 Dk (causal q k^T) + 2 W^2 Dv (s v) + 4 W Dk Dv (q C) + 4 W
// Dk Dv (the update) a chunk of a (b, h), at 989 TFLOP/s: 0.32 ms at the
// serving shape, against 0.18 ms of bytes.
// ---------------------------------------------------------------------
namespace tc {

using namespace mlstm_tc;

constexpr int THREADS = 256;      // two consumer warpgroups (state)
constexpr int VLD = 72;           // a v tile row: 64 columns and 8 pad
constexpr int DK = 512;           // key width
constexpr int NH = DK / 2;        // keys' columns a warpgroup owns

// n at each chunk's start (nstart, (B H, nc, Dk)) and the final n: 32
// columns a block, NL lanes down the chunk's rows for each
constexpr int NL = 16;

__global__ void __launch_bounds__(32 * NL)
mlstm_n_kernel(const bf16* __restrict__ k, Strides sk,
               const float* __restrict__ wkv,
               const float* __restrict__ decay, float* __restrict__ nstart,
               float* __restrict__ nout, int H, int S, int Dk, int W,
               int nc) {
  __shared__ float part[NL][33];
  const int lane = threadIdx.x & 31, tl = threadIdx.x >> 5;
  const int d = blockIdx.x * 32 + lane;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const bf16* kh = k + b * sk.b + hh * sk.h;
  const float* wb = wkv + (long long)bh * S;
  float n = 0.f;
  for (int c = 0; c < nc; ++c) {
    float acc = 0.f;
    if (d < Dk)
      for (int t = c * W + tl; t < (c + 1) * W; t += NL)
        acc = fmaf(wb[t], ld(kh + t * sk.s + d), acc);
    part[tl][lane] = acc;
    __syncthreads();
    if (tl == 0 && d < Dk) {
      nstart[((long long)bh * nc + c) * Dk + d] = n;
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < NL; ++u) sum += part[u][lane];
      n = decay[(long long)bh * nc + c] * n + sum;
    }
    __syncthreads();
  }
  if (tl == 0 && d < Dk) nout[(long long)bh * Dk + d] = n;
}

// s hi and lo of rows [64 rb, 64 rb + 64) of chunk c, their e (inter) and
// denominators. One warpgroup; q's tile and a two-slot ring of k tiles.
__global__ void __launch_bounds__(128)
mlstm_scores_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                Strides sq, Strides sk, const float* __restrict__ F,
                const float* __restrict__ li,
                const float* __restrict__ mstart,
                const float* __restrict__ nstart,
                float* __restrict__ inter_out, float* __restrict__ den_out,
                uint32_t* __restrict__ sh, uint32_t* __restrict__ sl, int H,
                int S, int Dk, int W, int nc, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qt = align_1024(smem_raw);
  const int tb = Dk * 128;            // bytes of a 64-row tile
  uint8_t* kt0 = qt + tb;
  float* Fc = reinterpret_cast<float*>(kt0 + 2 * tb);   // [W]
  float* lic = Fc + W;                // [W]
  float* mjc = lic + W;               // [64]
  float* ns = mjc + 64;               // [Dk]
  float* part = ns + Dk;              // [64][2] row sums' halves

  const int rb = blockIdx.x, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / H, hh = bh % H, tid = threadIdx.x;
  const int r0 = rb * 64;
  const long long row0 = (long long)bh * S + (long long)c * W;
  const bf16* qb = q + b * sq.b + hh * sq.h + ((long long)c * W + r0) * sq.s;
  const bf16* kb = k + b * sk.b + hh * sk.h + (long long)c * W * sk.s;
  load_rows(qt, qb, sq.s, Dk, tid, 128);
  load_rows(kt0, kb, sk.s, Dk, tid, 128);
  cp_async_commit();
  for (int t = tid; t < W; t += 128) {
    Fc[t] = F[row0 + t];
    lic[t] = li[row0 + t];
  }
  for (int d = tid; d < Dk; d += 128)
    ns[d] = nstart[((long long)bh * nc + c) * Dk + d];
  __syncthreads();
  {
    // mj and e, two lanes a row
    const int rr = tid >> 1, part2 = tid & 1, r = r0 + rr;
    float mx = -INFINITY;
    for (int t = part2; t <= r; t += 2)
      mx = fmaxf(mx, (Fc[r] - Fc[t]) + lic[t]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    if (part2 == 0) {
      const float bi = Fc[r] + mstart[(long long)bh * nc + c];
      const float mj = fmaxf(mx, bi);
      mjc[rr] = mj;
      inter_out[row0 + r] = expf(bi - mj);
    }
  }

  const int w = tid / 32, lane = tid % 32;
  float ssum[2] = {0.f, 0.f};
  for (int kb_i = 0; kb_i <= rb; ++kb_i) {
    if (kb_i < rb)
      load_rows(kt0 + ((kb_i + 1) & 1) * tb, kb + (kb_i + 1) * 64 * sk.s,
                sk.s, Dk, tid, 128);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint8_t* kt = kt0 + (kb_i & 1) * tb;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    fence_regs(acc);
    wgmma_fence();
    for (int kk = 0; kk < Dk / 16; ++kk)
      mma_ss_n64(acc, kmaj(qt, kk), kmaj(kt, kk));
    wgmma_commit();
    wgmma_wait();
    fence_regs(acc);
    // element e of n-block j: row 16 w + lane / 4 + 8 (e / 2), key
    // 8 j + 2 (lane % 4) + e % 2 of this key block
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = 16 * w + lane / 4 + 8 * hf, r = r0 + rr;
        const int t = kb_i * 64 + 8 * j + 2 * (lane % 4);
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = t + e <= r ? acc[4 * j + 2 * hf + e] * scale *
                                  expf(((Fc[r] - Fc[t + e]) + lic[t + e]) -
                                       mjc[rr])
                            : 0.f;
        ssum[hf] += v[0] + v[1];
        uint32_t hi, lo;
        split2(v[0], v[1], hi, lo);
        const long long o = (((long long)bh * nc + c) * W + r) * W + t;
        sh[o >> 1] = hi;
        sl[o >> 1] = lo;
      }
    __syncthreads();
  }
  // the row sums (a row's four lanes), then q . n: two threads a row
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float x = ssum[hf];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (lane % 4 == 0) part[(16 * w + lane / 4 + 8 * hf) * 2] = x;
  }
  {
    const int rr = tid >> 1, half = tid & 1;
    float qn = 0.f;
    for (int c8 = half * Dk / 16; c8 < (half + 1) * Dk / 16; ++c8) {
      const uint4 x = *reinterpret_cast<const uint4*>(
          qt + sw128_offset(64, rr, c8 >> 3, c8 & 7));
      const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qn = fmaf(bf(wd[u] & 0xffffu), ns[c8 * 8 + 2 * u], qn);
        qn = fmaf(bf(wd[u] >> 16), ns[c8 * 8 + 2 * u + 1], qn);
      }
    }
    qn += __shfl_xor_sync(0xffffffffu, qn, 1);
    __syncthreads();
    if (half == 0) {
      const int r = r0 + rr;
      const float e = inter_out[row0 + r];
      den_out[row0 + r] = fmaxf(fabsf(part[rr * 2] + e * scale * qn),
                                expf(-mjc[rr]));
    }
  }
}

// the state kernel's shared memory: two 64 KB-class slots, two v tiles,
// the exchange buffer and two sets of per-row weights
struct StateSmem {
  int slot, vtile, off_v, off_x, off_small, total;
  __host__ __device__ StateSmem(int Dk, int W) {
    slot = Dk * 128 > W * 256 ? Dk * 128 : W * 256;
    vtile = W * VLD * 2;
    off_v = 2 * slot;
    off_x = off_v + 2 * vtile;
    off_small = off_x + 2 * 16 * 128 * 4;
    total = off_small + 2 * 3 * W * 4 + 1024;
  }
};

__global__ void __launch_bounds__(THREADS, 1)
mlstm_state_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, Strides sq, Strides sk,
               Strides sv, const float* __restrict__ inter,
               const float* __restrict__ den,
               const float* __restrict__ wkv,
               const float* __restrict__ decay,
               const bf16* __restrict__ sh, const bf16* __restrict__ sl,
               float* __restrict__ hout, float* __restrict__ Cout, int H,
               int S, int Dv, int W, int nc, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  const StateSmem L(DK, W);
  uint8_t* slots = base;
  uint16_t* vb0 = reinterpret_cast<uint16_t*>(base + L.off_v);
  float* xb = reinterpret_cast<float*>(base + L.off_x);
  float* sm0 = reinterpret_cast<float*>(base + L.off_small);

  const int col0 = blockIdx.x * 64;
  const int bh = blockIdx.y, b = bh / H, hh = bh % H;
  const int tid = threadIdx.x, g = tid / 128, tw = tid % 128;
  const int w = tw / 32, lane = tw % 32;
  const bf16* qh = q + b * sq.b + hh * sq.h;
  const bf16* kh = k + b * sk.b + hh * sk.h;
  const bf16* vh = v + b * sv.b + hh * sv.h + col0;
  const int R = W / 64, P = 3 * R, total = nc * P;

  // piece i of chunk c: q rows of round i / 2 (i even, i < 2 R), s rows
  // of round i / 2 (i odd, i < 2 R), k rows of block i - 2 R; a chunk's
  // first piece brings its v tile and per-row weights
  auto fetch = [&](int p) {
    const int c = p / P, i = p % P;
    uint8_t* slot = slots + (p & 1) * L.slot;
    const long long t0 = (long long)c * W;
    if (p % P == 0) {
      uint16_t* vb = vb0 + (c & 1) * W * VLD;
      for (int e = tid; e < W * 8; e += THREADS) {
        const int t = e >> 3, ch = e & 7;
        cp_async16(vb + t * VLD + ch * 8, vh + (t0 + t) * sv.s + ch * 8, 16);
      }
      float* sm = sm0 + (c & 1) * 3 * W;
      const long long row0 = (long long)bh * S + t0;
      for (int e = tid; e < 3 * W / 4; e += THREADS) {
        const int a = e / (W / 4), o = (e % (W / 4)) * 4;
        const float* src = a == 0 ? inter : (a == 1 ? den : wkv);
        cp_async16(sm + a * W + o, src + row0 + o, 16);
      }
    }
    if (i < 2 * R && (i & 1) == 0) {
      const int rho = i / 2;
      load_rows(slot, qh + (t0 + 64 * rho) * sq.s, sq.s, DK, tid, THREADS);
    } else if (i < 2 * R) {
      const int rho = i / 2;
      const long long o = (((long long)bh * nc + c) * W + 64 * rho) * W;
      const int per_row = (rho + 1) * 8;
      for (int e = tid; e < 2 * 64 * per_row; e += THREADS) {
        const int lo = e >= 64 * per_row, q2 = e - lo * 64 * per_row;
        const int r = q2 / per_row, c8 = q2 % per_row;
        cp_async16(slot + lo * W * 128 + sw128_offset(64, r, c8 >> 3, c8 & 7),
                   (lo ? sl : sh) + o + (long long)r * W + c8 * 8, 16);
      }
    } else {
      const int tb = i - 2 * R;
      load_rows(slot, kh + (t0 + 64 * tb) * sk.s, sk.s, DK, tid, THREADS);
    }
  };

  float Cacc[NH / 2];
#pragma unroll
  for (int i = 0; i < NH / 2; ++i) Cacc[i] = 0.f;
  float P32[32];

  fetch(0);
  cp_async_commit();
  for (int p = 0; p < total; ++p) {
    if (p + 1 < total) fetch(p + 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int c = p / P, i = p % P;
    const uint8_t* slot = slots + (p & 1) * L.slot;
    const uint16_t* vb = vb0 + (c & 1) * W * VLD;
    const float* sm = sm0 + (c & 1) * 3 * W;
    if (i < 2 * R && (i & 1) == 0) {
      // this warpgroup's half of (C^T hi + C^T lo) q^T, in batches of 4
      // k-steps (the A registers must hold until their products end)
#pragma unroll
      for (int u = 0; u < 32; ++u) P32[u] = 0.f;
#pragma unroll
      for (int kb = 0; kb < NH / 16; kb += 4) {
        uint32_t hi[4][4], lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split2(Cacc[8 * (kb + kk) + 2 * x], Cacc[8 * (kb + kk) + 2 * x + 1],
                   hi[kk][x], lo[kk][x]);
        fence_regs(P32);
        fence_regs(hi);
        fence_regs(lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t bd = kmaj(slot, g * NH / 16 + kb + kk);
          mma_rs_n64_k(P32, hi[kk], bd);
          mma_rs_n64_k(P32, lo[kk], bd);
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(P32);
        fence_regs(hi);
        fence_regs(lo);
      }
      // times scale e of the row: element e of n-block j is row
      // 8 j + 2 (lane % 4) + e % 2 of the round
      const int rho = i / 2;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          P32[4 * j + e] *= scale * sm[64 * rho + 8 * j + 2 * (lane % 4) +
                                       (e & 1)];
    } else if (i < 2 * R) {
      // + v^T (s hi + s lo)^T over this warpgroup's key steps
      const int rho = i / 2, steps = 4 * (rho + 1);
      const uint8_t* shi = slot;
      const uint8_t* slo = slot + W * 128;
      for (int kt0 = g; kt0 < steps; kt0 += 8) {
        uint32_t va[4][4];
        const int n = min(4, (steps - kt0 + 1) / 2);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int kt = kt0 + 2 * u;
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int m = 16 * w + lane / 4 + 8 * (x & 1);
            const int t = 16 * kt + 2 * (lane % 4) + 8 * (x >> 1);
            va[u][x] = u < n ? (uint32_t)vb[t * VLD + m] |
                                   (uint32_t)vb[(t + 1) * VLD + m] << 16
                             : 0u;
          }
        }
        fence_regs(P32);
        fence_regs(va);
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (u < n) {
            mma_rs_n64_k(P32, va[u], kmaj(shi, kt0 + 2 * u));
            mma_rs_n64_k(P32, va[u], kmaj(slo, kt0 + 2 * u));
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(P32);
        fence_regs(va);
      }
      // the halves: warpgroup g keeps rows [32 g, 32 g + 32) (n-blocks
      // 4 g to 4 g + 3) and hands the other half to its partner
      // (registers indexed by constants only: a g-dependent index would
      // put P32 in local memory)
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (g == 0)
          xb[(16 + u) * 128 + tw] = P32[16 + u];
        else
          xb[u * 128 + tw] = P32[u];
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < 16; ++u) {
        if (g == 0)
          P32[u] += xb[u * 128 + tw];
        else
          P32[16 + u] += xb[(16 + u) * 128 + tw];
      }
      const long long t0 = (long long)c * W + 64 * rho;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 8 * (4 * g + jj) + 2 * (lane % 4) + (e & 1);
          const int m = 16 * w + lane / 4 + 8 * (e >> 1);
          const float x = g ? P32[16 + 4 * jj + e] : P32[4 * jj + e];
          hout[((long long)bh * S + t0 + rr) * Dv + col0 + m] =
              x / sm[W + 64 * rho + rr];
        }
    } else {
      // C^T = decay C^T + ((w v)^T hi + lo) k over this block of keys
      const int tb = i - 2 * R;
      if (tb == 0) {
        const float dec = decay[(long long)bh * nc + c];
#pragma unroll
        for (int u = 0; u < NH / 2; ++u) Cacc[u] *= dec;
      }
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kt = 0; kt < 4; ++kt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int m = 16 * w + lane / 4 + 8 * (x & 1);
          const int t = 64 * tb + 16 * kt + 2 * (lane % 4) + 8 * (x >> 1);
          split2(bf(vb[t * VLD + m]) * sm[2 * W + t],
                 bf(vb[(t + 1) * VLD + m]) * sm[2 * W + t + 1], hi[kt][x],
                 lo[kt][x]);
        }
      fence_regs(Cacc);
      fence_regs(hi);
      fence_regs(lo);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        const uint64_t bd = mnmaj(slot, g * NH / 64, kt);
        mma_rs_n256_mn(Cacc, hi[kt], bd);
        mma_rs_n256_mn(Cacc, lo[kt], bd);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(Cacc);
      fence_regs(hi);
      fence_regs(lo);
    }
    __syncthreads();
  }
  // C^T's element e of n-block j: value column 16 w + lane / 4 +
  // 8 (e / 2), key column g NH + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
  for (int j = 0; j < NH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 16 * w + lane / 4 + 8 * (e >> 1);
      const int d = g * NH + 8 * j + 2 * (lane % 4) + (e & 1);
      Cout[((long long)bh * DK + d) * Dv + col0 + m] = Cacc[4 * j + e];
    }
}

size_t scores_smem(int Dk, int W) {
  return 1024 + 3 * (size_t)Dk * 128 + sizeof(float) * (2 * W + 64 + Dk +
                                                        128);
}

cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* li, const float* lf, float* h, float* C,
                   float* n, float* m, float* F, float* wkv, float* mstart,
                   float* decay, float* den, float* inter, float* s,
                   float* nstart, int B, int H, int S, int Dk, int Dv, int W,
                   const long long* strides, float scale,
                   cudaStream_t stream) {
  const int nc = S / W, BH = B * H;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  bf16* sh = reinterpret_cast<bf16*>(s);
  bf16* sl = sh + (size_t)BH * nc * W * W;

  mlstm_gates_kernel<<<BH, 128, 0, stream>>>(li, lf, F, wkv, mstart, decay,
                                             m, S, W, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mlstm_n_kernel<<<dim3(Dk / 32, BH), 32 * NL, 0, stream>>>(
      kt, sk, wkv, decay, nstart, n, H, S, Dk, W, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t sm1 = scores_smem(Dk, W);
  err = cudaFuncSetAttribute(mlstm_scores_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sm1);
  if (err != cudaSuccess) return err;
  mlstm_scores_tc<<<dim3(W / 64, nc, BH), 128, sm1, stream>>>(
      qt, kt, sq, sk, F, li, mstart, nstart, inter, den,
      reinterpret_cast<uint32_t*>(sh), reinterpret_cast<uint32_t*>(sl), H, S,
      Dk, W, nc, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const StateSmem L(DK, W);
  err = cudaFuncSetAttribute(mlstm_state_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L.total);
  if (err != cudaSuccess) return err;
  mlstm_state_tc<<<dim3(Dv / 64, BH), THREADS, L.total, stream>>>(
      qt, kt, vt, sq, sk, sv, inter, den, wkv, decay, sh, sl, h, C, H, S, Dv,
      W, nc, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// tensor_cores selects the tc path (bf16, Dk 512, Dv and W
// multiples of 64, q, k, v and their b/h/s strides 16-byte aligned, as the
// wrapper's uses_tensor_cores checks); mj then holds the denominators,
// s the hi and lo scores (bf16, the same bytes) and nstart (B H nc Dk
// floats) each chunk's starting n. Else the FMA kernels; nstart unused.
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const float* li,
    const float* lf, float* h, float* C, float* n, float* m, float* F,
    float* wkv, float* mstart, float* decay, float* mj, float* inter,
    float* s, float* nstart, int bf16, int tensor_cores, int B, int H,
    int S, int Dk, int Dv, int W, const long long* strides, float scale,
    void* stream) {
  if (B < 1 || H < 1 || W < 1 || W > WMAX || S % W || Dk < 1 ||
      Dk > DKMAX || Dv < 1 || B * H > 65535 || S / W > 65535)
    return (int)cudaErrorInvalidValue;
  if (tensor_cores && (!bf16 || Dk != tc::DK || Dv % 64 || W % 64))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores)
    return (int)tc::launch(q, k, v, li, lf, h, C, n, m, F, wkv, mstart,
                           decay, mj, inter, s, nstart, B, H, S, Dk, Dv, W,
                           strides, scale, st);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, li, lf, h, C, n, m, F, wkv,
                                   mstart, decay, mj, inter, s, B, H, S, Dk,
                                   Dv, W, strides, scale, st)
           : launch<float>(q, k, v, li, lf, h, C, n, m, F, wkv, mstart,
                           decay, mj, inter, s, B, H, S, Dk, Dv, W, strides,
                           scale, st);
  return (int)err;
}

extern "C" const char* mlstm_chunk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
