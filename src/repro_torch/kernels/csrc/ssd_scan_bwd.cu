// Mamba-2 SSD chunked scan backward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// The reference has no Pallas backward: it trains zamba2 by autodiff of the
// model path src/repro/models/mamba2.py:ssd_chunked (:57-107).  This kernel
// computes what that autodiff computes (and what ssd_scan_bwd_plain in
// ssd_scan.py writes out in torch ops), per (batch, head) and chunk of Q = 64
// timesteps.  With cum the inclusive cumsum of dA = dt A within the chunk,
// L_ij = exp(cum_i - cum_j) for i >= j, G = (C B^T) o L, h the state at the
// chunk's start and dh the gradient of the state at its end:
//   d(xdt)_j = sum_i G_ij dy_i + exp(cum_Q - cum_j) dh B_j
//   dB_j     = sum_i L_ij (dy_i . xdt_j) C_i + exp(cum_Q - cum_j) xdt_j^T dh
//   dC_i     = sum_j L_ij (dy_i . xdt_j) B_j + exp(cum_i) dy_i^T h
//   dh      <- exp(cum_Q) dh + sum_i exp(cum_i) dy_i^T C_i      (carried backward)
//   d(cum)_i = rowsum_i(M) - colsum_i(M) + exp(cum_i) C_i . (dy_i^T h)
//              - exp(cum_Q - cum_i) B_i . (xdt_i^T dh)
//              (+ on the last row: exp(cum_Q) <h, dh> + the sum of the last term)
//   with M = G o (dy . xdt^T); d(dA) is the reverse cumsum of d(cum).
// Then, as autograd does, d(xdt) is rounded to x's dtype and
//   dx = d(xdt) dt (in x's dtype), ddt = sum_p d(xdt) x + d(dA) A,
//   dA (the parameter) = sum over batch and time of d(dA) dt.
// Every exponent is <= 0, as in the forward.
//
// What it takes: the forward's inputs (x, B, C strided views of the conv
// output; dt strided; h0 optional), dy contiguous (B,S,H,P), dh_last
// optional, any S (the last chunk is masked).  No atomics, so a gradient
// is the same from run to run (a crash-resumed run compares bit for bit):
//   * dB and dC sum over the heads (n_groups = 1): each block writes its
//     head's share into (B,S,H,N) f32 partials, and the wrapper sums them
//     over H with torch.sum;
//   * dA sums over batch and time: each block sums its time steps in a fixed
//     order into (B,H), and the wrapper sums over B.
//
// Design (simple, right first; the tensor cores are later work): one block
// of 256 threads (16 x 16, a 4 x 4 patch of every 64 x 64 product a thread)
// per (batch, head).  A forward walk over the chunks recomputes the
// chunk-start states and writes them to a (B,H,nc,P,N) f32 scratch; a
// backward walk carries dh in registers and shared memory and does every
// product as f32 FMA loops over operands staged in shared memory (rows
// padded to 65 floats: no bank conflicts).  Both dtypes compute in f32.
//
// What bounds it on the card.  At the zamba2-7b train shape (B 4, S 512,
// 112 heads of P = 64, N = 64, bf16) the function reads x, dy, B, C, dt and
// writes dx, ddt, dB, dC: 98 MB, 0.029 ms at 3.35 TB/s (chip_smoke.py's
// ssd_bwd_bound); this kernel moves about 450 MB more through its scratch
// and partials.  Its products (the forward walk's state update and 10 more
// per chunk) are 14.2 GFLOP: 0.21 ms on the CUDA cores' 67 TFLOP/s, 0.014
// ms on the bf16 tensor cores.  So on this design the FMAs bind; on the
// tensor cores the bytes would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;            // timesteps per chunk (the forward's)
constexpr int W = 64;            // P = N
constexpr int LD = W + 1;        // padded row of a staged 64-wide tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int R = 4;             // rows (and columns) of a thread's patch

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;               // may be null
  const void* dy;                // contiguous (B,S,H,P)
  const float* dh_last;          // may be null
  float* states;                 // (B,H,nc,P,N) scratch
  void* dx;                      // contiguous (B,S,H,P), x's dtype
  float* ddt;                    // contiguous (B,S,H)
  float* dA_part;                // (B,H)
  float* dB_part;                // contiguous (B,S,H,N)
  float* dC_part;                // contiguous (B,S,H,N)
  float* dh0;                    // (B,H,P,N)
  int S, H, nc;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// x rounded to T and back (the rounding of a tensor of x's dtype).
template <typename T>
__device__ __forceinline__ float rnd(float v);
template <>
__device__ __forceinline__ float rnd<float>(float v) { return v; }
template <>
__device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Sum over the 16 threads of a half-warp (the tx of one ty), fixed order.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a whole warp, fixed order.
__device__ __forceinline__ float sum32(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int smem_floats() {
  // xdt, dy, B, C, h, dh, G, W: eight Q x LD tiles; column partials of M
  // (16 x Q); per-row vectors cum, exp(cum), exp(cum_Q - cum), dt, row sums
  // of M, inter term, state term, x part of ddt; 8 warp partials.
  return 8 * Q * LD + 16 * Q + 8 * Q + 8;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* x_s = smem;                   // Q x LD: xdt, rounded as the forward rounds it
  float* dy_s = x_s + Q * LD;          // Q x LD
  float* b_s = dy_s + Q * LD;          // Q x LD
  float* c_s = b_s + Q * LD;           // Q x LD
  float* h_s = c_s + Q * LD;           // P x LD: state at the chunk's start
  float* dh_s = h_s + Q * LD;          // P x LD: gradient of the state at its end
  float* g_s = dh_s + Q * LD;          // Q x LD: G[i][j]
  float* w_s = g_s + Q * LD;           // Q x LD: W[i][j] = L o (dy_i . xdt_j)
  float* colp_s = w_s + Q * LD;        // 16 x Q: column partials of M, one row per ty
  float* cum_s = colp_s + 16 * Q;      // Q: dA, then its inclusive cumsum
  float* ecum_s = cum_s + Q;           // Q: exp(cum)
  float* dend_s = ecum_s + Q;          // Q: exp(cum_Q - cum)
  float* dt_s = dend_s + Q;            // Q: dt
  float* rowm_s = dt_s + Q;            // Q: row sums of M, then d(cum)
  float* inter_s = rowm_s + Q;         // Q: exp(cum_i) C_i . (dy_i^T h)
  float* kst_s = inter_s + Q;          // Q: exp(cum_Q - cum_j) B_j . (xdt_j^T dh)
  float* xp_s = kst_s + Q;             // Q: sum_p d(xdt) x
  float* red_s = xp_s + Q;             // 8: one partial a warp

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const float A = p.A[h];
  const int S = p.S, H = p.H;

  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.c_sb;
  const T* dyb = static_cast<const T*>(p.dy) + ((long long)b * S * H + h) * W;
  T* dxb = static_cast<T*>(p.dx) + ((long long)b * S * H + h) * W;
  const long long row = (long long)H * W;          // time stride of dy, dx, dB/dC partials
  const long long hbase = ((long long)b * H + h) * W * W;
  float* states = p.states + hbase * p.nc;

  // Stage rows [c0, c0 + nv) of xdt (and dy) and B (and C) and dt, dA; rows
  // past S are zero (dt = 0 too, so the padded steps change nothing).
  auto stage = [&](int c0, int nv, bool with_dy) {
    for (int e = tid; e < Q * W; e += THREADS) {
      const int r = e / W, c = e % W;
      const long long t = c0 + r;
      const bool ok = r < nv;
      x_s[r * LD + c] = ok ? rnd<T>(ld(xb + t * p.x_ss + c) * rnd<T>(dtb[t * p.dt_ss])) : 0.f;
      b_s[r * LD + c] = ok ? ld(bb + t * p.b_ss + c) : 0.f;
      if (with_dy) {
        dy_s[r * LD + c] = ok ? ld(dyb + t * row + c) : 0.f;
        c_s[r * LD + c] = ok ? ld(cb + t * p.c_ss + c) : 0.f;
      }
    }
    if (tid < Q) {
      const float d = tid < nv ? dtb[(long long)(c0 + tid) * p.dt_ss] : 0.f;
      dt_s[tid] = d;
      cum_s[tid] = d * A;
    }
  };

  // Inclusive cumsum of dA over the chunk in warp 0 (two rows a lane), then
  // exp(cum) and exp(cum_Q - cum), every exponent <= 0.
  auto scan = [&]() {
    if (tid < 32) {
      const float a0 = cum_s[2 * lane], s1 = a0 + cum_s[2 * lane + 1];
      float incl = s1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float ca = excl + a0, cbv = excl + s1;
      const float last = __shfl_sync(0xffffffffu, cbv, 31);
      cum_s[2 * lane] = ca;
      cum_s[2 * lane + 1] = cbv;
      ecum_s[2 * lane] = expf(ca);
      ecum_s[2 * lane + 1] = expf(cbv);
      dend_s[2 * lane] = expf(last - ca);
      dend_s[2 * lane + 1] = expf(last - cbv);
    }
  };

  // ---- Forward walk: the chunk-start states into the scratch. ----
  {
    float hr[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int k = 0; k < R; ++k)
        hr[i][k] = p.h0 ? p.h0[hbase + (ty + 16 * i) * W + tx + 16 * k] : 0.f;
    for (int c = 0; c < p.nc; ++c) {
      const int c0 = c * Q, nv = min(Q, S - c0);
      float* out = states + (long long)c * W * W;
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) out[(ty + 16 * i) * W + tx + 16 * k] = hr[i][k];
      if (c == p.nc - 1) break;          // the last chunk's end state is not needed
      stage(c0, nv, false);
      __syncthreads();
      scan();
      __syncthreads();
      float s[R][R] = {};
#pragma unroll 4
      for (int j = 0; j < nv; ++j) {
        const float d = dend_s[j];
        float xv[R], bv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) xv[i] = x_s[j * LD + ty + 16 * i] * d;
#pragma unroll
        for (int k = 0; k < R; ++k) bv[k] = b_s[j * LD + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int k = 0; k < R; ++k) s[i][k] = fmaf(xv[i], bv[k], s[i][k]);
      }
      const float elast = ecum_s[Q - 1];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int k = 0; k < R; ++k) hr[i][k] = hr[i][k] * elast + s[i][k];
      __syncthreads();                   // every read of the staged tiles is done
    }
  }

  // ---- Backward walk, carrying dh (rows p = ty + 16 i, columns n = tx + 16 k). ----
  float dhr[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int o = (ty + 16 * i) * W + tx + 16 * k;
      dhr[i][k] = p.dh_last ? p.dh_last[hbase + o] : 0.f;
      dh_s[(ty + 16 * i) * LD + tx + 16 * k] = dhr[i][k];
    }
  float dA_acc = 0.f;                    // warp 0, lane 0: sum of d(dA) dt over the block's steps

  for (int c = p.nc - 1; c >= 0; --c) {
    const int c0 = c * Q, nv = min(Q, S - c0);
    const float* hin = states + (long long)c * W * W;
    __syncthreads();                     // the previous chunk's reads are done
    stage(c0, nv, true);
    for (int e = tid; e < W * W; e += THREADS) h_s[(e / W) * LD + e % W] = hin[e];
    __syncthreads();
    scan();
    __syncthreads();

    // (1) G, W and M over the i >= j half: rows i = ty + 16 a, columns j = tx + 16 k.
    {
      float cbv[R][R] = {}, dxd[R][R] = {};
#pragma unroll 4
      for (int n = 0; n < W; ++n) {
        float cv[R], bv[R], dv[R], xv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) {
          cv[a] = c_s[(ty + 16 * a) * LD + n];
          dv[a] = dy_s[(ty + 16 * a) * LD + n];
        }
#pragma unroll
        for (int k = 0; k < R; ++k) {
          bv[k] = b_s[(tx + 16 * k) * LD + n];
          xv[k] = x_s[(tx + 16 * k) * LD + n];
        }
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) {
            cbv[a][k] = fmaf(cv[a], bv[k], cbv[a][k]);
            dxd[a][k] = fmaf(dv[a], xv[k], dxd[a][k]);
          }
      }
      float colm[R] = {};
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = ty + 16 * a;
        float rowm = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int j = tx + 16 * k;
          // the masked half has cum_i - cum_j > 0: never exponentiate it
          const float L = i >= j ? expf(cum_s[i] - cum_s[j]) : 0.f;
          const float g = cbv[a][k] * L, w = dxd[a][k] * L, m = g * dxd[a][k];
          g_s[i * LD + j] = g;
          w_s[i * LD + j] = w;
          rowm += m;
          colm[k] += m;
        }
        rowm = sum16(rowm);
        if (tx == 0) rowm_s[i] = rowm;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) colp_s[ty * Q + tx + 16 * k] = colm[k];
    }
    __syncthreads();

    // (2) Rows r = ty + 16 a of the Q x P and Q x N products, columns tx + 16 k.
    // d(xdt)_j = sum_{i >= j} G_ij dy_i + exp(cum_Q - cum_j) dh B_j, rounded
    // to x's dtype; dx, and the x part of ddt.
    {
      float acc[R][R] = {}, acc2[R][R] = {};
      for (int i = ty; i < nv; ++i) {            // G_ij = 0 for i < j, and j >= ty
        float gv[R], dv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) gv[a] = g_s[i * LD + ty + 16 * a];
#pragma unroll
        for (int k = 0; k < R; ++k) dv[k] = dy_s[i * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[a][k] = fmaf(gv[a], dv[k], acc[a][k]);
      }
#pragma unroll 4
      for (int n = 0; n < W; ++n) {
        float bv[R], dhv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) bv[a] = b_s[(ty + 16 * a) * LD + n];
#pragma unroll
        for (int k = 0; k < R; ++k) dhv[k] = dh_s[(tx + 16 * k) * LD + n];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) acc2[a][k] = fmaf(bv[a], dhv[k], acc2[a][k]);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int j = ty + 16 * a;
        const bool ok = j < nv;
        const long long t = c0 + j;
        const float dtr = rnd<T>(dt_s[j]);
        float xp = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int pp = tx + 16 * k;
          const float g = rnd<T>(acc[a][k] + dend_s[j] * acc2[a][k]);
          if (ok) {
            xp = fmaf(g, ld(xb + t * p.x_ss + pp), xp);
            st(dxb + t * row + pp, g * dtr);
          }
        }
        xp = sum16(xp);
        if (tx == 0) xp_s[j] = xp;
      }
    }
    // dB_j = sum_{i >= j} W_ij C_i + exp(cum_Q - cum_j) xdt_j^T dh; the
    // state term of d(cum).
    {
      float acc[R][R] = {}, acc2[R][R] = {};
      for (int i = ty; i < nv; ++i) {
        float wv[R], cv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) wv[a] = w_s[i * LD + ty + 16 * a];
#pragma unroll
        for (int k = 0; k < R; ++k) cv[k] = c_s[i * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[a][k] = fmaf(wv[a], cv[k], acc[a][k]);
      }
#pragma unroll 4
      for (int pp = 0; pp < W; ++pp) {
        float xv[R], dhv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) xv[a] = x_s[(ty + 16 * a) * LD + pp];
#pragma unroll
        for (int k = 0; k < R; ++k) dhv[k] = dh_s[pp * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) acc2[a][k] = fmaf(xv[a], dhv[k], acc2[a][k]);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int j = ty + 16 * a;
        const float d = dend_s[j];
        float ks = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int n = tx + 16 * k;
          ks = fmaf(acc2[a][k], b_s[j * LD + n], ks);
          if (j < nv) p.dB_part[(c0 + j) * row + ((long long)b * S * H + h) * W + n] =
              acc[a][k] + d * acc2[a][k];
        }
        ks = sum16(ks);
        if (tx == 0) kst_s[j] = d * ks;
      }
    }
    // dC_i = sum_{j <= i} W_ij B_j + exp(cum_i) dy_i^T h; the inter term of d(cum).
    {
      float acc[R][R] = {}, acc2[R][R] = {};
      const int jmax = min(nv, ty + 16 * (R - 1) + 1);
      for (int j = 0; j < jmax; ++j) {
        float wv[R], bv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) wv[a] = w_s[(ty + 16 * a) * LD + j];
#pragma unroll
        for (int k = 0; k < R; ++k) bv[k] = b_s[j * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) acc[a][k] = fmaf(wv[a], bv[k], acc[a][k]);
      }
#pragma unroll 4
      for (int pp = 0; pp < W; ++pp) {
        float dv[R], hv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) dv[a] = dy_s[(ty + 16 * a) * LD + pp];
#pragma unroll
        for (int k = 0; k < R; ++k) hv[k] = h_s[pp * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) acc2[a][k] = fmaf(dv[a], hv[k], acc2[a][k]);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int i = ty + 16 * a;
        const float e = ecum_s[i];
        float in = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int n = tx + 16 * k;
          const float dcv = e * acc2[a][k];
          in = fmaf(dcv, c_s[i * LD + n], in);
          if (i < nv) p.dC_part[(c0 + i) * row + ((long long)b * S * H + h) * W + n] =
              acc[a][k] + dcv;
        }
        in = sum16(in);
        if (tx == 0) inter_s[i] = in;
      }
    }

    // (3) <h, dh> (dh before this chunk's update) and the new dh =
    // exp(cum_Q) dh + sum_i exp(cum_i) dy_i^T C_i, rows p = ty + 16 i.
    float hdh = 0.f;
    {
      float s[R][R] = {};
      for (int i = 0; i < nv; ++i) {
        const float e = ecum_s[i];
        float dv[R], cv[R];
#pragma unroll
        for (int a = 0; a < R; ++a) dv[a] = dy_s[i * LD + ty + 16 * a] * e;
#pragma unroll
        for (int k = 0; k < R; ++k) cv[k] = c_s[i * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < R; ++a)
#pragma unroll
          for (int k = 0; k < R; ++k) s[a][k] = fmaf(dv[a], cv[k], s[a][k]);
      }
      const float elast = ecum_s[Q - 1];
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int k = 0; k < R; ++k) {
          hdh = fmaf(h_s[(ty + 16 * a) * LD + tx + 16 * k], dhr[a][k], hdh);
          dhr[a][k] = dhr[a][k] * elast + s[a][k];
        }
      hdh = sum32(hdh);
      if (lane == 0) red_s[warp] = hdh;
    }
    __syncthreads();                     // every read of dh_s and of the row vectors' inputs is done
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int k = 0; k < R; ++k) dh_s[(ty + 16 * a) * LD + tx + 16 * k] = dhr[a][k];

    // (4) d(cum), its reverse cumsum d(dA), then ddt and the dA share (warp 0,
    // two rows a lane).
    if (tid < 32) {
      float hsum = 0.f;
#pragma unroll
      for (int w = 0; w < THREADS / 32; ++w) hsum += red_s[w];
      const float ksum = sum32(kst_s[2 * lane] + kst_s[2 * lane + 1]);
      float d[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * lane + q;
        float col = 0.f;
#pragma unroll
        for (int y = 0; y < 16; ++y) col += colp_s[y * Q + i];
        d[q] = rowm_s[i] - col + inter_s[i] - kst_s[i];
        if (i == nv - 1) d[q] += ecum_s[Q - 1] * hsum + ksum;
      }
      // suffix sums over the lanes above, then within the pair
      float suf = d[0] + d[1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += t;
      }
      float above = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) above = 0.f;
      const float g1 = above + d[1], g0 = g1 + d[0];
      float share = 0.f;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * lane + q;
        const float g = q ? g1 : g0;
        if (i < nv) {
          p.ddt[((long long)b * S + c0 + i) * H + h] = xp_s[i] + g * A;
          share = fmaf(g, dt_s[i], share);
        }
      }
      share = sum32(share);
      if (lane == 0) dA_acc += share;
    }
  }

#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int k = 0; k < R; ++k) p.dh0[hbase + (ty + 16 * a) * W + tx + 16 * k] = dhr[a][k];
  if (tid == 0) p.dA_part[(long long)b * H + h] = dA_acc;
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  ssd_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a block takes (both dtypes compute in f32).
extern "C" int ssd_scan_bwd_smem_bytes() { return smem_floats() * (int)sizeof(float); }

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of x, B and C must be contiguous; dy, dx, ddt and the dB / dC
// partials are contiguous.  h0 and dh_last may be null.  dtype of x, B, C,
// dy and dx: 0 = float32, 1 = bfloat16; everything else is float32.
// states is a (B,H,nc,P,N) f32 scratch, nc = ceil(S / 64).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, const void* dy,
                            const void* dh_last, void* states, void* dx, void* ddt,
                            void* dA_part, void* dB_part, void* dC_part, void* dh0,
                            int B, int S, int H, int P, int N,
                            long long x_sb, long long x_ss, long long x_sh,
                            long long dt_sb, long long dt_ss, long long dt_sh,
                            long long b_sb, long long b_ss,
                            long long c_sb, long long c_ss,
                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P != W || N != W) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt); p.A = static_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm; p.h0 = static_cast<const float*>(h0);
  p.dy = dy; p.dh_last = static_cast<const float*>(dh_last);
  p.states = static_cast<float*>(states);
  p.dx = dx; p.ddt = static_cast<float*>(ddt); p.dA_part = static_cast<float*>(dA_part);
  p.dB_part = static_cast<float*>(dB_part); p.dC_part = static_cast<float*>(dC_part);
  p.dh0 = static_cast<float*>(dh0);
  p.S = S; p.H = H; p.nc = (S + Q - 1) / Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.b_sb = b_sb; p.b_ss = b_ss;
  p.c_sb = c_sb; p.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
