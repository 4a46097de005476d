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
// Three kernels, in order on the caller's stream:
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
// the products of the one before, so the products hide their latency. Bound on an H100 SXM: W (W + 1) (Dk + Dv) + 4 W Dk Dv
// operations a chunk of a (b, h) at 67 TFLOP/s; at the serving shape
// 2.43 ms against 0.18 ms of bytes. No cp.async, TMA or tensor cores
// yet: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const float* li,
    const float* lf, float* h, float* C, float* n, float* m, float* F,
    float* wkv, float* mstart, float* decay, float* mj, float* inter,
    float* s, int bf16, int B, int H, int S, int Dk, int Dv, int W,
    const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || W < 1 || W > WMAX || S % W || Dk < 1 ||
      Dk > DKMAX || Dv < 1 || B * H > 65535 || S / W > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
