// Mamba-2 SSD chunked scan forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py (`_kernel` +
// `ssd_scan`, pallas_call at :77).  Same function, per (batch, head) and
// chunk of Q timesteps, with cum the inclusive cumsum of dA = dt * A (f32):
//   intra  y_i += sum_{j <= i} exp(cum_i - cum_j) (C_i . B_j) xdt_j
//   inter  y_i += exp(cum_i) C_i . h
//   state  h    = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) xdt_j^T B_j   (P x N, f32)
// with B and C shared by all heads (n_groups = 1: indexed by batch only,
// never copied per head).  It is what the model path
// repro.models.mamba2.ssd_chunked computes, which is wider than the Pallas
// kernel:
//   * h0 in (may be null: zero state) and h_last (B,H,P,N) f32 out; the
//     Pallas kernel zero-initialises its state and never writes it out;
//   * any S: the last chunk is masked (dt = x = B = C = 0 past S, which
//     leaves y and h unchanged), where the Pallas wrapper asserts that the
//     chunk divides S and the model path falls back to one chunk of S;
//   * xdt = x * dt is rounded to x's dtype as in the model path, from x and
//     dt read in place; y is written in x's dtype;
//   * strided inputs: x (B,S,H,P), B and C (B,S,N) are read through their
//     strides (the model passes views of the conv output), dt (B,S,H) too.
// The masked half of the decay matrix (j > i, where cum_i - cum_j > 0 and
// exp overflows) is never exponentiated.
//
// Design (simple first): one block of 256 threads owns one (batch, head)
// and walks its chunks of Q = 64 in order, with the state in registers (each
// thread owns a 4 x N/16 patch of h) and a copy in shared memory for the
// inter-chunk product.  Per chunk it stages xdt, B and C as f32, scans dA in
// one warp, forms the masked 64 x 64 matrix G = (C B^T) o L, then y = G xdt
// + exp(cum) C h^T and the new state, all with FMA loops on the CUDA cores
// (each thread owns 4 rows x 4 columns of a 64-wide tile; padded rows, no
// bank conflicts).  Shared memory at P = N = 64: 83,968 bytes, two blocks
// per SM.
//
// What bounds it on the card: for zamba2-7b prefill (B=4, S=512, 112 heads
// of 64, N=64, bf16) the function moves about 67 MB (x and y in bf16, dt,
// h_last in f32) against about 7 GFLOP of chunked products, so the bound is
// the bytes (about 0.02 ms at 3.35 TB/s).  This version does not reach it: it
// runs its products on the CUDA cores in f32 (no mma.sync / wgmma), and it
// does not overlap the next chunk's loads with compute (no cp.async or TMA
// pipeline).  Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;            // timesteps per chunk
constexpr int THREADS = 256;     // 16 x 16
constexpr int ROWS = Q / 16;     // chunk rows per thread

template <int P, int N>
constexpr int smem_bytes() {
  // xdt, B, C (Q rows), G (Q x Q), h (P x N), rows padded by one; cum,
  // exp(cum), exp(cum_Q - cum).
  return (int)((Q * (P + 1) + 2 * Q * (N + 1) + Q * (Q + 1) + P * (N + 1) + 3 * Q)
               * sizeof(float));
}

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;               // may be null
  void* y;
  float* h_last;
  int S, H;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss;          // y is (B,S,H,P) with its last two dims contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the model path's rounding of dt and of x * dt.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* x_s = smem;                       // Q x (P + 1): xdt
  float* b_s = x_s + Q * (P + 1);          // Q x (N + 1)
  float* c_s = b_s + Q * (N + 1);          // Q x (N + 1)
  float* g_s = c_s + Q * (N + 1);          // Q x (Q + 1): (C B^T) o L
  float* h_s = g_s + Q * (Q + 1);          // P x (N + 1): state at the chunk's start
  float* cum_s = h_s + P * (N + 1);        // Q: dA, then its inclusive cumsum
  float* ecum_s = cum_s + Q;               // Q: exp(cum)
  float* dend_s = ecum_s + Q;              // Q: exp(cum_Q - cum)

  constexpr int HR = P / 16, HC = N / 16;  // state patch per thread
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float A = p.A[h];

  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* bb = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* cb = static_cast<const T*>(p.Cm) + b * p.c_sb;
  T* yb = static_cast<T*>(p.y) + b * p.y_sb + (long long)h * P;
  const long long hbase = ((long long)b * p.H + h) * P * N;

  float hr[HR][HC];
#pragma unroll
  for (int i = 0; i < HR; ++i)
#pragma unroll
    for (int j = 0; j < HC; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      hr[i][j] = p.h0 ? p.h0[hbase + r * N + c] : 0.f;
      h_s[r * (N + 1) + c] = hr[i][j];
    }

  for (int c0 = 0; c0 < p.S; c0 += Q) {
    const int nv = min(Q, p.S - c0);      // valid rows of this chunk

    // (1) Stage xdt, B, C and dA; rows past S are zero.  The previous
    // chunk's last reads of these buffers came before its final barrier.
    for (int e = threadIdx.x; e < Q * P; e += THREADS) {
      const int r = e / P, c = e % P;
      float v = 0.f;
      if (r < nv) {
        const long long t = c0 + r;
        const float dtv = round_to<T>(dtb[t * p.dt_ss]);
        v = round_to<T>(to_f32(xb[t * p.x_ss + c]) * dtv);
      }
      x_s[r * (P + 1) + c] = v;
    }
    for (int e = threadIdx.x; e < Q * N; e += THREADS) {
      const int r = e / N, c = e % N;
      const long long t = c0 + r;
      b_s[r * (N + 1) + c] = r < nv ? to_f32(bb[t * p.b_ss + c]) : 0.f;
      c_s[r * (N + 1) + c] = r < nv ? to_f32(cb[t * p.c_ss + c]) : 0.f;
    }
    const int tid = threadIdx.x;
    if (tid < Q) cum_s[tid] = tid < nv ? dtb[(long long)(c0 + tid) * p.dt_ss] * A : 0.f;
    __syncthreads();

    // (2) Inclusive cumsum of dA over the chunk in warp 0 (two rows a lane).
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
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
    __syncthreads();

    // (3) G[i][j] = exp(cum_i - cum_j) (C_i . B_j) for i >= j, else 0.
    {
      float g[ROWS][ROWS];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int k = 0; k < ROWS; ++k) g[a][k] = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[ROWS], bv[ROWS];
#pragma unroll
        for (int a = 0; a < ROWS; ++a) cv[a] = c_s[(ty + 16 * a) * (N + 1) + n];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) bv[k] = b_s[(tx + 16 * k) * (N + 1) + n];
#pragma unroll
        for (int a = 0; a < ROWS; ++a)
#pragma unroll
          for (int k = 0; k < ROWS; ++k) g[a][k] = fmaf(cv[a], bv[k], g[a][k]);
      }
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int i = ty + 16 * a, j = tx + 16 * k;
          g_s[i * (Q + 1) + j] = i >= j ? expf(cum_s[i] - cum_s[j]) * g[a][k] : 0.f;
        }
    }
    __syncthreads();

    // (4) y_i = sum_j G[i][j] xdt_j + exp(cum_i) C_i . h, for the valid rows.
    {
      constexpr int YC = P / 16;
      float acc[ROWS][YC], acc2[ROWS][YC];
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int k = 0; k < YC; ++k) acc[a][k] = acc2[a][k] = 0.f;
      const int jmax = min(nv, ty + 16 * (ROWS - 1) + 1);   // G[i][j] = 0 for j > i
#pragma unroll 4
      for (int j = 0; j < jmax; ++j) {
        float gv[ROWS], xv[YC];
#pragma unroll
        for (int a = 0; a < ROWS; ++a) gv[a] = g_s[(ty + 16 * a) * (Q + 1) + j];
#pragma unroll
        for (int k = 0; k < YC; ++k) xv[k] = x_s[j * (P + 1) + tx + 16 * k];
#pragma unroll
        for (int a = 0; a < ROWS; ++a)
#pragma unroll
          for (int k = 0; k < YC; ++k) acc[a][k] = fmaf(gv[a], xv[k], acc[a][k]);
      }
#pragma unroll 8
      for (int n = 0; n < N; ++n) {
        float cv[ROWS], hv[YC];
#pragma unroll
        for (int a = 0; a < ROWS; ++a) cv[a] = c_s[(ty + 16 * a) * (N + 1) + n];
#pragma unroll
        for (int k = 0; k < YC; ++k) hv[k] = h_s[(tx + 16 * k) * (N + 1) + n];
#pragma unroll
        for (int a = 0; a < ROWS; ++a)
#pragma unroll
          for (int k = 0; k < YC; ++k) acc2[a][k] = fmaf(cv[a], hv[k], acc2[a][k]);
      }
#pragma unroll
      for (int a = 0; a < ROWS; ++a) {
        const int i = ty + 16 * a;
        if (i >= nv) continue;
        T* yrow = yb + (long long)(c0 + i) * p.y_ss;
#pragma unroll
        for (int k = 0; k < YC; ++k)
          yrow[tx + 16 * k] = from_f32<T>(acc[a][k] + ecum_s[i] * acc2[a][k]);
      }
    }

    // (5) h = exp(cum_Q) h + sum_j exp(cum_Q - cum_j) xdt_j^T B_j.
    {
      float s[HR][HC];
#pragma unroll
      for (int i = 0; i < HR; ++i)
#pragma unroll
        for (int j = 0; j < HC; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int j = 0; j < nv; ++j) {
        const float d = dend_s[j];
        float xv[HR], bv[HC];
#pragma unroll
        for (int i = 0; i < HR; ++i) xv[i] = x_s[j * (P + 1) + ty + 16 * i] * d;
#pragma unroll
        for (int k = 0; k < HC; ++k) bv[k] = b_s[j * (N + 1) + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < HR; ++i)
#pragma unroll
          for (int k = 0; k < HC; ++k) s[i][k] = fmaf(xv[i], bv[k], s[i][k]);
      }
      const float elast = ecum_s[Q - 1];
      __syncthreads();                      // every read of h_s and the tiles is done
#pragma unroll
      for (int i = 0; i < HR; ++i)
#pragma unroll
        for (int k = 0; k < HC; ++k) {
          hr[i][k] = hr[i][k] * elast + s[i][k];
          h_s[(ty + 16 * i) * (N + 1) + tx + 16 * k] = hr[i][k];
        }
    }
  }

#pragma unroll
  for (int i = 0; i < HR; ++i)
#pragma unroll
    for (int k = 0; k < HC; ++k)
      p.h_last[hbase + (ty + 16 * i) * N + tx + 16 * k] = hr[i][k];
}

template <typename T, int P, int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  ssd_fwd_kernel<T, P, N><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernel is written for any P, N that are multiples of 16 (up to what
// shared memory and registers hold); it is instantiated for zamba2-7b's.
template <typename T>
cudaError_t dispatch(const Params& p, int B, int P, int N, cudaStream_t stream) {
  if (P == 64 && N == 64) return launch<T, 64, 64>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Shared memory a block takes at head dim P and state N (-1 if unsupported).
extern "C" int ssd_scan_fwd_smem_bytes(int P, int N) {
  return (P == 64 && N == 64) ? smem_bytes<64, 64>() : -1;
}

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of x, B and C must be contiguous, and y is a contiguous
// (B,S,H,P) tensor (its batch and time strides are passed).  h0 may be null.
// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A, h0 and h_last
// are float32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* h_last,
                            int B, int S, int H, int P, int N,
                            long long x_sb, long long x_ss, long long x_sh,
                            long long dt_sb, long long dt_ss, long long dt_sh,
                            long long b_sb, long long b_ss,
                            long long c_sb, long long c_ss,
                            long long y_sb, long long y_ss,
                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x; p.dt = static_cast<const float*>(dt); p.A = static_cast<const float*>(A);
  p.Bm = Bm; p.Cm = Cm; p.h0 = static_cast<const float*>(h0);
  p.y = y; p.h_last = static_cast<float*>(h_last);
  p.S = S; p.H = H;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.b_sb = b_sb; p.b_ss = b_ss;
  p.c_sb = c_sb; p.c_ss = c_ss;
  p.y_sb = y_sb; p.y_ss = y_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch<float>(p, B, P, N, s);
  else if (dtype == 1) err = dispatch<__nv_bfloat16>(p, B, P, N, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
