// RWKV-6 WKV backward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// The reference has no Pallas backward: it trains RWKV-6 by autodiff of the
// model path src/repro/models/rwkv6.py:wkv_chunked (:85-128).  This kernel
// computes what that autodiff computes (and what wkv6_bwd_plain in wkv6.py
// writes out in torch ops), per (batch, head) and chunk of Q = 32 steps.
// With cw the inclusive cumsum of w = logw over the chunk (per channel),
// a = cw - w, e_ti = exp(a_t - cw_i) for i < t (every exponent <= 0),
// A_ti = sum_c r_t e_ti k_i, D_ti = dy_t . v_i, S the state at the chunk's
// start and dS the gradient of the state at its end:
//   dv_i = sum_{t>i} A_ti dy_t + (r_i . u o k_i) dy_i + (k_i o exp(cw_Q - cw_i)) dS
//   dr_t = sum_{i<t} D_ti e_ti o k_i + exp(a_t) o S dy_t + u o k_t D_tt
//   dk_i = sum_{t>i} D_ti e_ti o r_t + exp(cw_Q - cw_i) o dS v_i + u o r_i D_ii
//   du   = sum over batch and time of r_t o k_t D_tt
//   dS  <- exp(cw_Q) o dS + sum_t (r_t o exp(a_t))^T dy_t       (carried backward)
// and dlogw, which reaches w through cw and through a = cw - w:
//   da_t = r_t o (dr_t less its u term), dcw_i = -k_i o (dk_i less its u term),
//   on the last row dcw += exp(cw_Q) o rowsum(S o dS) + sum_i k_i o (its dS term),
//   dlogw = revcumsum_t(dcw + da) - da within the chunk.
//
// What it takes: the forward's inputs (r, k, v strided bf16 or f32, logw
// strided f32, u, s0 optional), dy contiguous f32 (y is f32), dS_last
// optional, any S (the last chunk is masked).  No atomics, so a gradient is
// the same from run to run: du sums over batch and time, so each block sums
// its steps in a fixed order into a (B,H,hd) partial, and the wrapper sums
// it over B.
//
// Design (simple, right first; the tensor cores are later work): one block
// of 256 threads (16 x 16) per (batch, head).  A forward walk over the
// chunks recomputes the chunk-start states and writes them to a
// (B,H,nc,hd,hd) f32 scratch; a backward walk carries dS in registers and
// shared memory.  Every product is an f32 FMA loop over operands staged in
// shared memory (rows padded to 65 floats); the decays e_ti are formed where
// they are used (exp of a difference <= 0, the masked half never
// exponentiated), once in A and once each in dr and dk.  Both dtypes compute
// in f32.
//
// What bounds it on the card.  At the rwkv6-1.6b train shape (B 4, S 512,
// 32 heads of 64, bf16 r, k, v) the function reads r, k, v, logw, dy and
// writes dr, dk, dv, dlogw: 103 MB, 0.031 ms at 3.35 TB/s; its operations
// (products, exponentials and sums, chip_smoke.py's wkv_bwd_bound) are 3.8
// GFLOP: 0.056 ms on the CUDA cores' 67 TFLOP/s.  So on this design the
// operations bind; on the tensor cores the bytes would.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;            // steps per chunk (the forward's)
constexpr int W = 64;            // head dim (key and value)
constexpr int LD = W + 1;        // padded row of a staged 64-wide tile
constexpr int QL = Q + 1;        // padded row of a Q x Q tile
constexpr int THREADS = 256;     // 16 x 16

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;               // may be null
  const float* dy;               // contiguous (B,S,H,hd)
  const float* dS_last;          // may be null
  float* states;                 // (B,H,nc,hd,hd) scratch
  void* dr;                      // contiguous (B,S,H,hd), r's dtype
  void* dk;
  void* dv;
  float* dlogw;                  // contiguous (B,S,H,hd)
  float* du_part;                // (B,H,hd)
  float* ds0;                    // (B,H,hd,hd)
  int S, H, nc;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Sum over the 16 threads of a half-warp (the tx of one ty), fixed order.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr int smem_floats() {
  // r, k, v, dy, cw, a, dcw + da, da: eight Q x LD tiles; S and dS: two
  // W x LD; A and D: two Q x QL; column partials (16 x W); rowsum(S o dS)
  // (W); the u terms r_t . u o k_t (Q).
  return 8 * Q * LD + 2 * W * LD + 2 * Q * QL + 16 * W + W + Q;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv6_bwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* r_s = smem;                   // Q x LD
  float* k_s = r_s + Q * LD;           // Q x LD
  float* v_s = k_s + Q * LD;           // Q x LD
  float* dy_s = v_s + Q * LD;          // Q x LD
  float* cw_s = dy_s + Q * LD;         // Q x LD: w, then its inclusive cumsum
  float* a_s = cw_s + Q * LD;          // Q x LD: cw - w
  float* tot_s = a_s + Q * LD;         // Q x LD: dcw + da
  float* da_s = tot_s + Q * LD;        // Q x LD: da
  float* st_s = da_s + Q * LD;         // W x LD: state at the chunk's start
  float* ds_s = st_s + W * LD;         // W x LD: gradient of the state at its end
  float* att_s = ds_s + W * LD;        // Q x QL: A[t][i]
  float* dvd_s = att_s + Q * QL;       // Q x QL: D[t][i] = dy_t . v_i
  float* colp_s = dvd_s + Q * QL;      // 16 x W: column partials, one row per ty
  float* srow_s = colp_s + 16 * W;     // W: rowsum(S o dS)
  float* bonus_s = srow_s + W;         // Q: r_t . u o k_t

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int S = p.S, H = p.H;

  const T* rb = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.logw + b * p.w_sb + h * p.w_sh;
  const float* ub = p.u + (long long)h * W;
  const long long row = (long long)H * W;           // time stride of dy and the outputs
  const long long obase = ((long long)b * S * H + h) * W;
  const long long hbase = ((long long)b * H + h) * W * W;
  float* states = p.states + hbase * p.nc;

  // Stage rows [c0, c0 + nv) (zero past S), then the per-channel cumsum of
  // w in threads 0..63, sequential over the chunk.
  auto stage = [&](int c0, int nv, bool all) {
    for (int e = tid; e < Q * W; e += THREADS) {
      const int t = e / W, c = e % W;
      const long long s = c0 + t;
      const bool ok = t < nv;
      k_s[t * LD + c] = ok ? ld(kb + s * p.k_ss + c) : 0.f;
      v_s[t * LD + c] = ok ? ld(vb + s * p.v_ss + c) : 0.f;
      cw_s[t * LD + c] = ok ? wb[s * p.w_ss + c] : 0.f;
      if (all) {
        r_s[t * LD + c] = ok ? ld(rb + s * p.r_ss + c) : 0.f;
        dy_s[t * LD + c] = ok ? p.dy[obase + s * row + c] : 0.f;
      }
    }
  };
  auto cumsum = [&]() {
    if (tid < W) {
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float w = cw_s[t * LD + tid];
        run += w;
        cw_s[t * LD + tid] = run;
        a_s[t * LD + tid] = run - w;
      }
    }
  };

  // ---- Forward walk: the chunk-start states into the scratch. ----
  {
    float sr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sr[i][j] = p.s0 ? p.s0[hbase + (ty + 16 * i) * W + tx + 16 * j] : 0.f;
    for (int c = 0; c < p.nc; ++c) {
      const int c0 = c * Q, nv = min(Q, S - c0);
      float* out = states + (long long)c * W * W;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) out[(ty + 16 * i) * W + tx + 16 * j] = sr[i][j];
      if (c == p.nc - 1) break;          // the last chunk's end state is not needed
      stage(c0, nv, false);
      __syncthreads();
      cumsum();
      __syncthreads();
      float cq[4], acc[4][4] = {};
#pragma unroll
      for (int i = 0; i < 4; ++i) cq[i] = cw_s[(Q - 1) * LD + ty + 16 * i];
      for (int t = 0; t < nv; ++t) {
        float kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = ty + 16 * i;
          kv[i] = k_s[t * LD + kk] * expf(cq[i] - cw_s[t * LD + kk]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = v_s[t * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(kv[i], vv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(cq[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) sr[i][j] = sr[i][j] * e + acc[i][j];
      }
      __syncthreads();                   // every read of the staged tiles is done
    }
  }

  // ---- Backward walk, carrying dS (rows ty + 16 i, columns tx + 16 j). ----
  float dsr[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dsr[i][j] = p.dS_last ? p.dS_last[hbase + (ty + 16 * i) * W + tx + 16 * j] : 0.f;
      ds_s[(ty + 16 * i) * LD + tx + 16 * j] = dsr[i][j];
    }
  float du_acc[4] = {};                  // channels tx + 16 k, over this thread's rows

  for (int c = p.nc - 1; c >= 0; --c) {
    const int c0 = c * Q, nv = min(Q, S - c0);
    const float* sbeg = states + (long long)c * W * W;
    __syncthreads();                     // the previous chunk's reads are done
    stage(c0, nv, true);
    for (int e = tid; e < W * W; e += THREADS) st_s[(e / W) * LD + e % W] = sbeg[e];
    __syncthreads();
    cumsum();
    if (tid >= W && tid < W + Q) {       // the u terms, one row a thread
      const int t = tid - W;
      float s = 0.f;
      for (int cc = 0; cc < W; ++cc) s = fmaf(r_s[t * LD + cc] * ub[cc], k_s[t * LD + cc], s);
      bonus_s[t] = s;
    }
    __syncthreads();

    // (1) A[t][i] (i < t) and D[t][i]: rows t = ty + 16 a, columns i = tx + 16 q.
    {
      float at[2][2] = {}, dd[2][2] = {};
#pragma unroll 4
      for (int cc = 0; cc < W; ++cc) {
        float rv[2], av[2], yv[2], kv[2], cv[2], vv[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int t = ty + 16 * a;
          rv[a] = r_s[t * LD + cc];
          av[a] = a_s[t * LD + cc];
          yv[a] = dy_s[t * LD + cc];
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int i = tx + 16 * q;
          kv[q] = k_s[i * LD + cc];
          cv[q] = cw_s[i * LD + cc];
          vv[q] = v_s[i * LD + cc];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // the masked half (i >= t) has a_t - cw_i > 0: never exponentiate it
            if (tx + 16 * q < ty + 16 * a) at[a][q] = fmaf(rv[a] * kv[q], expf(av[a] - cv[q]),
                                                          at[a][q]);
            dd[a][q] = fmaf(yv[a], vv[q], dd[a][q]);
          }
      }
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          att_s[(ty + 16 * a) * QL + tx + 16 * q] = at[a][q];
          dvd_s[(ty + 16 * a) * QL + tx + 16 * q] = dd[a][q];
        }
    }
    __syncthreads();

    // (2) Rows t = ty + 16 a, channels c = tx + 16 k: dr, dk, dv, du, and
    // the two terms of dlogw.
    {
      float dra[2][4] = {}, dka[2][4] = {}, dvv[2][4] = {}, dks[2][4] = {};
      // dr: sum_{i<t} D_ti e_ti k_i, then + exp(a_t) S dy_t
      for (int i = 0; i < ty + 16; ++i) {
        float kv[4], cv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          kv[k] = k_s[i * LD + tx + 16 * k];
          cv[k] = cw_s[i * LD + tx + 16 * k];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int t = ty + 16 * a;
          if (i < t) {
            const float d = dvd_s[t * QL + i];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              dra[a][k] = fmaf(d * kv[k], expf(a_s[t * LD + tx + 16 * k] - cv[k]), dra[a][k]);
          }
        }
      }
      {
        float sd[2][4] = {};
#pragma unroll 4
        for (int vv = 0; vv < W; ++vv) {
          float sv[4], yv[2];
#pragma unroll
          for (int k = 0; k < 4; ++k) sv[k] = st_s[(tx + 16 * k) * LD + vv];
#pragma unroll
          for (int a = 0; a < 2; ++a) yv[a] = dy_s[(ty + 16 * a) * LD + vv];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) sd[a][k] = fmaf(sv[k], yv[a], sd[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            dra[a][k] = fmaf(expf(a_s[(ty + 16 * a) * LD + tx + 16 * k]), sd[a][k], dra[a][k]);
      }
      // dk (row i = ty + 16 a): sum_{t>i} D_ti e_ti r_t, then + exp(cw_Q - cw_i) dS v_i
      for (int t = ty + 1; t < nv; ++t) {
        float rv[4], av[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rv[k] = r_s[t * LD + tx + 16 * k];
          av[k] = a_s[t * LD + tx + 16 * k];
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = ty + 16 * a;
          if (t > i) {
            const float d = dvd_s[t * QL + i];
#pragma unroll
            for (int k = 0; k < 4; ++k)
              dka[a][k] = fmaf(d * rv[k], expf(av[k] - cw_s[i * LD + tx + 16 * k]), dka[a][k]);
          }
        }
      }
      {
#pragma unroll 4
        for (int vv = 0; vv < W; ++vv) {
          float sv[4], xv[2];
#pragma unroll
          for (int k = 0; k < 4; ++k) sv[k] = ds_s[(tx + 16 * k) * LD + vv];
#pragma unroll
          for (int a = 0; a < 2; ++a) xv[a] = v_s[(ty + 16 * a) * LD + vv];
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) dks[a][k] = fmaf(sv[k], xv[a], dks[a][k]);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int cc = tx + 16 * k;
            dks[a][k] *= expf(cw_s[(Q - 1) * LD + cc] - cw_s[(ty + 16 * a) * LD + cc]);
            dka[a][k] += dks[a][k];
          }
      }
      // dv (row i = ty + 16 a, channel v = tx + 16 k): sum_{t>i} A_ti dy_t,
      // + (r_i . u o k_i) dy_i, + (k_i o exp(cw_Q - cw_i)) dS
      for (int t = ty + 1; t < nv; ++t) {
        float yv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) yv[k] = dy_s[t * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = ty + 16 * a;
          if (t > i) {
            const float at = att_s[t * QL + i];
#pragma unroll
            for (int k = 0; k < 4; ++k) dvv[a][k] = fmaf(at, yv[k], dvv[a][k]);
          }
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < W; ++kk) {
        const float cq = cw_s[(Q - 1) * LD + kk];
        float kd[2], sv[4];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int i = ty + 16 * a;
          kd[a] = k_s[i * LD + kk] * expf(cq - cw_s[i * LD + kk]);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) sv[k] = ds_s[kk * LD + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int k = 0; k < 4; ++k) dvv[a][k] = fmaf(kd[a], sv[k], dvv[a][k]);
      }
      // write; the dlogw terms into shared memory
      float colp[4] = {};
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const int t = ty + 16 * a;
        const float diag = dvd_s[t * QL + t], bon = bonus_s[t];
        const bool ok = t < nv;
        const long long o = obase + (c0 + t) * row;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int cc = tx + 16 * k;
          const float rv = r_s[t * LD + cc], kv = k_s[t * LD + cc], uv = ub[cc];
          const float da = rv * dra[a][k];
          tot_s[t * LD + cc] = da - kv * dka[a][k];
          da_s[t * LD + cc] = da;
          colp[k] = fmaf(kv, dks[a][k], colp[k]);
          if (ok) {
            st(static_cast<T*>(p.dr) + o + cc, dra[a][k] + uv * kv * diag);
            st(static_cast<T*>(p.dk) + o + cc, dka[a][k] + uv * rv * diag);
            st(static_cast<T*>(p.dv) + o + cc, dvv[a][k] + bon * dy_s[t * LD + cc]);
            du_acc[k] = fmaf(rv * kv, diag, du_acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) colp_s[ty * W + tx + 16 * k] = colp[k];
    }

    // (3) rowsum(S o dS) with dS before this chunk's update, and the new dS =
    // exp(cw_Q) o dS + sum_t (r_t o exp(a_t))^T dy_t in registers.
    {
      float acc[4][4] = {};
      for (int t = 0; t < nv; ++t) {
        float rv[4], yv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kk = ty + 16 * i;
          rv[i] = r_s[t * LD + kk] * expf(a_s[t * LD + kk]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) yv[j] = dy_s[t * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(rv[i], yv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = ty + 16 * i;
        float sr = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) sr = fmaf(st_s[kk * LD + tx + 16 * j], dsr[i][j], sr);
        sr = sum16(sr);
        if (tx == 0) srow_s[kk] = sr;
        const float e = expf(cw_s[(Q - 1) * LD + kk]);
#pragma unroll
        for (int j = 0; j < 4; ++j) dsr[i][j] = dsr[i][j] * e + acc[i][j];
      }
    }
    __syncthreads();                     // every read of ds_s, colp_s and tot_s's writes are done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ds_s[(ty + 16 * i) * LD + tx + 16 * j] = dsr[i][j];

    // (4) dlogw = revcumsum(dcw + da) - da per channel, with the last-row term.
    if (tid < W) {
      const int cc = tid;
      float last = expf(cw_s[(Q - 1) * LD + cc]) * srow_s[cc];
      for (int y = 0; y < 16; ++y) last += colp_s[y * W + cc];
      float run = last;
      for (int t = nv - 1; t >= 0; --t) {
        run += tot_s[t * LD + cc];
        p.dlogw[obase + (c0 + t) * row + cc] = run - da_s[t * LD + cc];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) p.ds0[hbase + (ty + 16 * i) * W + tx + 16 * j] = dsr[i][j];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) colp_s[ty * W + tx + 16 * k] = du_acc[k];
  __syncthreads();
  if (tid < W) {
    float s = 0.f;
    for (int y = 0; y < 16; ++y) s += colp_s[y * W + tid];
    p.du_part[((long long)b * H + h) * W + tid] = s;
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  wkv6_bwd_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory a block takes (both dtypes compute in f32).
extern "C" int wkv6_bwd_smem_bytes() { return smem_floats() * (int)sizeof(float); }

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of r, k, v and logw must be contiguous; dy and every output are
// contiguous.  s0 and dS_last may be null.  dtype of r, k, v and of dr, dk,
// dv: 0 = float32, 1 = bfloat16; everything else is float32.  states is a
// (B,H,nc,hd,hd) f32 scratch, nc = ceil(S / 32).  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
                        const void* u, const void* s0, const void* dy, const void* dS_last,
                        void* states, void* dr, void* dk, void* dv, void* dlogw,
                        void* du_part, void* ds0, int B, int S, int H, int hd,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd != W) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v; p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u); p.s0 = static_cast<const float*>(s0);
  p.dy = static_cast<const float*>(dy); p.dS_last = static_cast<const float*>(dS_last);
  p.states = static_cast<float*>(states);
  p.dr = dr; p.dk = dk; p.dv = dv; p.dlogw = static_cast<float*>(dlogw);
  p.du_part = static_cast<float*>(du_part); p.ds0 = static_cast<float*>(ds0);
  p.S = S; p.H = H; p.nc = (S + Q - 1) / Q;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}
