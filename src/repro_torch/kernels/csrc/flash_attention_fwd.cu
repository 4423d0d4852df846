// Flash attention forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_kernel` + `flash_attention`, pallas_call at :110).  Same function:
// online-softmax attention forward over q (B,Sq,Hq,d), k/v (B,Sk,Hkv,d),
// GQA/MQA by kv_head = q_head / (Hq/Hkv) with no repeated K/V, causal and
// sliding-window masks, f32 running max / denominator / accumulator, output
// in q's dtype divided by max(l, 1e-30).  It differs from the Pallas kernel
// where that one is narrower:
//   * causal offset: query row i sits at key position Sk - Sq + i, as in
//     repro.kernels.ref.attention_ref (the Pallas mask has no offset, so it
//     is right only for Sq == Sk);
//   * ragged lengths: the last q and k tiles are masked here, where the
//     Pallas wrapper asserts that the blocks divide the lengths;
//   * layout: (B,S,H,d) is read in place through its strides, no transposes;
//   * it also writes lse = m + log(l) (f32, (B,Hq,Sq)) for the backward.
//
// Design (simple first): one block of 256 threads per (q tile of 64 rows,
// q head, batch).  The block stages its Q tile in shared memory as f32 and
// walks the k tiles of its band [lo, hi) only; tiles wholly outside the
// causal/window band are never loaded.  For each k tile it stages K, forms
// the 64x64 scores with FMA loops (each thread owns 4 rows x 4 columns),
// masks the ragged edge and the band, updates the row max and sum in the
// log2 domain, writes P to shared memory, then stages V in the same buffer
// and accumulates P.V (each thread owns 4 rows x d/16 columns in registers).
//
// What bounds it on the card: for llama2-7b prefill (B=4, S=512, 32 heads,
// d=128, causal) the work is ~67 MB of q/k/v/o against ~8.6 GFLOP, so the
// bound is the bytes (~0.02 ms at 3.35 TB/s); from S of about 2048 up the
// FLOPs bind (989 TFLOP/s bf16).  This first version does not reach either:
// it runs the products on the CUDA cores in f32 (no mma.sync / wgmma), and
// it does not overlap the K/V loads with compute (no cp.async or TMA
// pipeline).  Tensor-core products and a load pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int ROWS = BQ / 16;    // query rows per thread
constexpr int COLS = BK / 16;    // score columns per thread

// Dynamic shared memory of one block: Q and one K/V tile (f32, rows padded
// to D + 1) and the P tile (f32, rows padded to BK + 1).
constexpr int smem_bytes(int D) {
  return (int)(((BQ + BK) * (D + 1) + BQ * (BK + 1)) * sizeof(float));
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int Sq, Sk, Hq, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  float scale_log2;              // softmax scale * log2(e)
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage 64 rows (row stride `ss` elements) of a (S, D) slab into shared
// memory as f32 with a padded row stride of D + 1 (conflict-free column
// reads).  Rows at or past `n_valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ss, int n_valid) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < n_valid ? to_f32(src[(long long)r * ss + c]) : 0.f;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  extern __shared__ float smem[];
  float* q_s = smem;                    // BQ x (D + 1)
  float* kv_s = q_s + BQ * (D + 1);     // BK x (D + 1): K, then V, of one tile
  float* p_s = kv_s + BK * (D + 1);     // BQ x (BK + 1)

  // Heaviest causal tiles (the last ones) are scheduled first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tx = threadIdx.x % 16;      // score / output column group
  const int ty = threadIdx.x / 16;      // row group; a row's 16 threads share a half-warp
  const int q0 = qt * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const int off = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D>(q_s, qb, p.q_ss, nq);

  // Keys this q tile can see: [lo, hi).
  int hi = p.Sk;
  if (p.causal) hi = min(hi, off + q0 + nq);
  int lo = 0;
  if (p.window) lo = max(0, off + q0 - p.window + 1);

  float m[ROWS], l[ROWS], acc[ROWS][D / 16];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();                    // previous V tile consumed; Q staged
    load_tile<T, D>(kv_s, kb + k0 * p.k_ss, p.k_ss, nk);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = q_s[(ty + 16 * i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = kv_s[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = ty + 16 * i;
      const int qpos = off + q0 + r;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        bool ok = c < nk;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window) ok = ok && qpos - kpos < p.window;
        s[i][j] = ok ? s[i][j] * p.scale_log2 : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;   // row fully masked so far
      const float corr = exp2f(m[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        sum += s[i][j];
        p_s[r * (BK + 1) + tx + 16 * j] = s[i][j];
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                    // K reads done, P visible
    load_tile<T, D>(kv_s, vb + k0 * p.v_ss, p.v_ss, nk);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const float vv = kv_s[c * (D + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lc;
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + q0 + r] = (m[i] + log2f(lc)) * 0.69314718055994531f;
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(p, B, stream);
    case 112: return launch<T, 112>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    case 256: return launch<T, 256>(p, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory a block takes at head dim D (-1 if D is not supported).
extern "C" int flash_attention_fwd_smem_bytes(int D) {
  return (D == 64 || D == 112 || D == 128 || D == 256) ? smem_bytes(D) : -1;
}

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of q, k, v and o must be contiguous.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                   long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   float scale, int causal, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = static_cast<float*>(lse);
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) err = dispatch_d<float>(p, B, D, s);
  else if (dtype == 1) err = dispatch_d<__nv_bfloat16>(p, B, D, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
