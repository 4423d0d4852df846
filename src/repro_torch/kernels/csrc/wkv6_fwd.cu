// RWKV-6 WKV forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (`_kernel` +
// `wkv6`, pallas_call at :76).  Same function, per (batch, head) and chunk
// of Q = 32 timesteps, with cw the inclusive cumsum of the log-decay w <= 0
// (per channel c) and S the (dk x dv) state in f32:
//   intra  y_t += sum_{i < t} (sum_c r_tc e^{cw_tc - w_tc - cw_ic} k_ic) v_i
//   bonus  y_t += (sum_c r_tc u_c k_tc) v_t
//   inter  y_t += (r_t o e^{cw_t - w_t}) S
//   state  S    = diag(e^{cw_Q}) S + sum_i (k_i o e^{cw_Q - cw_i})^T v_i
// Every exponent is formed as one difference that is <= 0 (cw_t - w_t -
// cw_i for i < t; the strict-lower mask), never factored into e^{cw_t} e^{-cw_i},
// which overflows.  y is f32 whatever the input dtype.  It is what the model
// path repro.models.rwkv6.wkv_chunked computes, which is wider than the
// Pallas kernel:
//   * s0 in (may be null: zero state) and S_last (B,H,dk,dv) f32 out;
//   * any S, including S = 1 (every decode step): the last chunk is masked
//     (r = k = v = w = 0 past S, which leaves y and S unchanged), where the
//     Pallas wrapper asserts that the chunk divides S;
//   * r, k, v in bf16 or f32 and logw, u in f32, read as they are (no copy
//     upcast on the host), through their strides.
//
// Design (simple first): one block of 256 threads owns one (batch, head)
// and walks its chunks in order, with the state in registers (each thread
// owns a D/16 x D/16 patch) and a copy in shared memory.  Per chunk it
// stages r, k, v, w as f32, scans w down each channel, forms r o e^{cw-w}
// and k o e^{cw_Q-cw}, then the 32 x 32 score matrix (the exponent per
// (t, i, c)), y and the new state, with FMA loops on the CUDA cores.  Shared
// memory at D = 64: 79,872 bytes.
//
// What bounds it on the card: for rwkv6-1.6b prefill (B=4, S=512, 32 heads
// of 64, r/k/v bf16) it moves about 61 MB (r, k, v in bf16; logw, y, S_last
// in f32) against about 1.5 GFLOP and 73 M exponentials, so the bound is the
// bytes (about 0.02 ms at 3.35 TB/s).  This version does not reach it: f32
// FMA products on the CUDA cores (no mma.sync / wgmma), no overlap of the
// next chunk's loads with compute, and B*H = 128 blocks at full width, one
// wave on 132 SMs with one block per SM, so four SMs idle and no SM hides
// one block's latency behind another's.  Splitting a (batch, head) across
// blocks (a second pass over chunk states) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;            // timesteps per chunk, as the reference
constexpr int THREADS = 256;     // 16 x 16
constexpr int TR = Q / 16;       // chunk rows per thread

template <int D>
constexpr int smem_bytes() {
  // r, k, v, cw, cw - w, r o e^{cw-w}, k o e^{cw_Q-cw} (Q rows), scores
  // (Q x Q), state (D x D), rows padded by one; u, cw_Q, e^{cw_Q}.
  return (int)((7 * Q * (D + 1) + Q * (Q + 1) + D * (D + 1) + 3 * D) * sizeof(float));
}

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* w;
  const float* u;                // (H, D) contiguous
  const float* s0;               // may be null
  float* y;
  float* s_last;
  int S, H;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
  long long y_sb, y_ss;          // y is (B,S,H,D) with its last two dims contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) wkv6_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  float* r_s = smem;                       // Q x LD
  float* k_s = r_s + Q * LD;
  float* v_s = k_s + Q * LD;
  float* cw_s = v_s + Q * LD;              // inclusive cumsum of w
  float* cwm_s = cw_s + Q * LD;            // w, then cw - w
  float* rd_s = cwm_s + Q * LD;            // r o e^{cw - w}
  float* kd_s = rd_s + Q * LD;             // k o e^{cw_Q - cw}
  float* a_s = kd_s + Q * LD;              // Q x (Q + 1): scores with the bonus on the diagonal
  float* s_s = a_s + Q * (Q + 1);          // D x LD: state at the chunk's start
  float* u_s = s_s + D * LD;               // D
  float* wl_s = u_s + D;                   // D: cw_Q
  float* ewl_s = wl_s + D;                 // D: e^{cw_Q}

  constexpr int SP = D / 16;               // state patch per thread is SP x SP
  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* rb = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.w + b * p.w_sb + h * p.w_sh;
  float* yb = p.y + b * p.y_sb + (long long)h * D;
  const long long sbase = ((long long)b * p.H + h) * D * D;

  if (tid < D) u_s[tid] = p.u[h * D + tid];
  float sr[SP][SP];
#pragma unroll
  for (int i = 0; i < SP; ++i)
#pragma unroll
    for (int j = 0; j < SP; ++j) {
      const int c = ty + 16 * i, q = tx + 16 * j;
      sr[i][j] = p.s0 ? p.s0[sbase + c * D + q] : 0.f;
      s_s[c * LD + q] = sr[i][j];
    }

  for (int c0 = 0; c0 < p.S; c0 += Q) {
    const int nv = min(Q, p.S - c0);      // valid rows of this chunk

    // (1) Stage r, k, v, w as f32; rows past S are zero.
    for (int e = tid; e < Q * D; e += THREADS) {
      const int t = e / D, c = e % D;
      const bool ok = t < nv;
      const long long pos = c0 + t;
      r_s[t * LD + c] = ok ? to_f32(rb[pos * p.r_ss + c]) : 0.f;
      k_s[t * LD + c] = ok ? to_f32(kb[pos * p.k_ss + c]) : 0.f;
      v_s[t * LD + c] = ok ? to_f32(vb[pos * p.v_ss + c]) : 0.f;
      cwm_s[t * LD + c] = ok ? wb[pos * p.w_ss + c] : 0.f;
    }
    __syncthreads();

    // (2) Scan w down each channel: cw (inclusive) and cw - w.
    if (tid < D) {
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        const float w = cwm_s[t * LD + tid];
        run += w;
        cw_s[t * LD + tid] = run;
        cwm_s[t * LD + tid] = run - w;
      }
      wl_s[tid] = run;
      ewl_s[tid] = expf(run);
    }
    __syncthreads();
    for (int e = tid; e < Q * D; e += THREADS) {
      const int t = e / D, c = e % D;
      rd_s[t * LD + c] = r_s[t * LD + c] * expf(cwm_s[t * LD + c]);
      kd_s[t * LD + c] = k_s[t * LD + c] * expf(wl_s[c] - cw_s[t * LD + c]);
    }

    // (3) Scores: a[t][i] = sum_c r_tc e^{cw_tc - w_tc - cw_ic} k_ic for
    // i < t, the bonus sum_c r_tc u_c k_tc for i = t, 0 above.
#pragma unroll
    for (int a = 0; a < TR; ++a)
#pragma unroll
      for (int bq = 0; bq < TR; ++bq) {
        const int t = ty + 16 * a, i = tx + 16 * bq;
        float acc = 0.f;
        if (i < t) {
#pragma unroll 8
          for (int c = 0; c < D; ++c)
            acc = fmaf(r_s[t * LD + c] * expf(cwm_s[t * LD + c] - cw_s[i * LD + c]),
                       k_s[i * LD + c], acc);
        } else if (i == t) {
#pragma unroll 8
          for (int c = 0; c < D; ++c)
            acc = fmaf(r_s[t * LD + c] * u_s[c], k_s[t * LD + c], acc);
        }
        a_s[t * (Q + 1) + i] = acc;
      }
    __syncthreads();

    // (4) y_t = sum_{i <= t} a[t][i] v_i + (r_t o e^{cw_t - w_t}) S, valid rows.
    {
      float acc[TR][SP], acc2[TR][SP];
#pragma unroll
      for (int a = 0; a < TR; ++a)
#pragma unroll
        for (int j = 0; j < SP; ++j) acc[a][j] = acc2[a][j] = 0.f;
      const int imax = min(nv, ty + 16 * (TR - 1) + 1);   // a[t][i] = 0 for i > t
#pragma unroll 4
      for (int i = 0; i < imax; ++i) {
        float av[TR], vv[SP];
#pragma unroll
        for (int a = 0; a < TR; ++a) av[a] = a_s[(ty + 16 * a) * (Q + 1) + i];
#pragma unroll
        for (int j = 0; j < SP; ++j) vv[j] = v_s[i * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int j = 0; j < SP; ++j) acc[a][j] = fmaf(av[a], vv[j], acc[a][j]);
      }
#pragma unroll 8
      for (int c = 0; c < D; ++c) {
        float rv[TR], sv[SP];
#pragma unroll
        for (int a = 0; a < TR; ++a) rv[a] = rd_s[(ty + 16 * a) * LD + c];
#pragma unroll
        for (int j = 0; j < SP; ++j) sv[j] = s_s[c * LD + tx + 16 * j];
#pragma unroll
        for (int a = 0; a < TR; ++a)
#pragma unroll
          for (int j = 0; j < SP; ++j) acc2[a][j] = fmaf(rv[a], sv[j], acc2[a][j]);
      }
#pragma unroll
      for (int a = 0; a < TR; ++a) {
        const int t = ty + 16 * a;
        if (t >= nv) continue;
        float* yrow = yb + (long long)(c0 + t) * p.y_ss;
#pragma unroll
        for (int j = 0; j < SP; ++j) yrow[tx + 16 * j] = acc[a][j] + acc2[a][j];
      }
    }

    // (5) S = diag(e^{cw_Q}) S + sum_i (k_i o e^{cw_Q - cw_i})^T v_i.
    {
      float s[SP][SP];
#pragma unroll
      for (int i = 0; i < SP; ++i)
#pragma unroll
        for (int j = 0; j < SP; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int t = 0; t < nv; ++t) {
        float kv[SP], vv[SP];
#pragma unroll
        for (int i = 0; i < SP; ++i) kv[i] = kd_s[t * LD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < SP; ++j) vv[j] = v_s[t * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < SP; ++i)
#pragma unroll
          for (int j = 0; j < SP; ++j) s[i][j] = fmaf(kv[i], vv[j], s[i][j]);
      }
      __syncthreads();                      // every read of s_s and the tiles is done
#pragma unroll
      for (int i = 0; i < SP; ++i) {
        const float decay = ewl_s[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < SP; ++j) {
          sr[i][j] = sr[i][j] * decay + s[i][j];
          s_s[(ty + 16 * i) * LD + tx + 16 * j] = sr[i][j];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < SP; ++i)
#pragma unroll
    for (int j = 0; j < SP; ++j)
      p.s_last[sbase + (ty + 16 * i) * D + tx + 16 * j] = sr[i][j];
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(wkv6_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  wkv6_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernel is written for any D that is a multiple of 16 (up to what
// shared memory and registers hold); it is instantiated for rwkv6-1.6b's.
template <typename T>
cudaError_t dispatch(const Params& p, int B, int D, cudaStream_t stream) {
  if (D == 64) return launch<T, 64>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared memory a block takes at head dim D (-1 if D is not supported).
extern "C" int wkv6_fwd_smem_bytes(int D) {
  return D == 64 ? smem_bytes<64>() : -1;
}

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of r, k, v and w must be contiguous, u is a contiguous (H, D), y
// a contiguous (B,S,H,D) f32 tensor (its batch and time strides are passed),
// s0 (may be null) and s_last contiguous (B,H,D,D) f32.  dtype of r, k, v:
// 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_last,
                        int B, int S, int H, int D,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        long long y_sb, long long y_ss,
                        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v; p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u); p.s0 = static_cast<const float*>(s0);
  p.y = static_cast<float*>(y); p.s_last = static_cast<float*>(s_last);
  p.S = S; p.H = H;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  p.y_sb = y_sb; p.y_ss = y_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch<float>(p, B, D, s);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(p, B, D, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
