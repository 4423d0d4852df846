// Flash attention backward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the FlashAttention-2 backward that the JAX package writes at the
// HLO level, src/repro/models/flash.py:_vjp_bwd (:146-214, defvjp at :217);
// the Pallas kernel src/repro/kernels/flash_attention.py has no backward.
// Same function: given q (B,Sq,Hq,dk), k (B,Sk,Hkv,dk), v (B,Sk,Hkv,dv), the
// forward's o (B,Sq,Hq,dv) and lse (natural log, f32, (B,Hq,Sq)) and the
// output gradient do (B,Sq,Hq,dv),
//   delta_i = sum_c do_ic o_ic                        (f32, one per row, over dv)
//   P_ij    = exp(scale q_i . k_j - lse_i)            (recomputed, never stored)
//   dS_ij   = P_ij (do_i . v_j - delta_i) scale
//   dq = dS k,  dk = dS^T q,  dv = P^T do             (f32 sums, out in q's dtype)
// with GQA/MQA by kv_head = q_head / (Hq/Hkv), the causal mask with the
// Sk - Sq offset (query row i sits at key position Sk - Sq + i), a sliding
// window, and ragged lengths (the last q and k tiles are masked).  Inputs are
// read in place through their (B,S,H,d) strides; any strides are taken, with
// the last dim contiguous.  dq, dk, dv are written contiguous.
//
// Every kernel is templated on the two head dims <DK, DV>, as the forward
// (flash_attention_fwd.cu): Q, K, dq and dk rows are DK wide, V, O, dO and
// dv rows DV wide.  The pairs built are (d, d) for d in 64, 96, 112, 128,
// 256 and DeepSeek-V3's MLA pair (192, 128) (128 nope + 64 rope for q/k, 128
// for v); for DK == DV the code is the one-dim kernel it was.
//
// Two kernels, run in this order on one stream:
//   * dq kernel, one block per (q tile, q head, batch), as pass A of the
//     reference (:169-186).  Its prologue computes delta for its rows from
//     do and o and writes it out for the next kernel; then it walks the k
//     tiles of its causal/window band and sums dS k in registers.
//   * dk/dv kernel, one block per (k tile, kv head, batch), as pass B
//     (:188-213).  It walks the G query heads of its GQA group and, for each,
//     the q tiles whose band meets this k tile, and sums P^T do and dS^T q in
//     registers.  The group's sum stays inside the block: no atomics, so the
//     result is the same bits from run to run.
//
// What bounds it on the card.  Per (query, key) pair of the band the
// gradient needs five products (S and dq, dk of length dk; dP and dv of
// length dv): 6 dk + 4 dv operations (10 d at dk = dv).  At the llama2-7b
// training shape (B 4, S 512, 32 heads of 128, causal) that is 21.5 GFLOP
// against 134.7 MB of q, k, v, o, do, dq, dk, dv, lse and delta: 0.022 ms at
// 989 TFLOP/s in bf16 and 0.040 ms at 3.35 TB/s, so the bytes bind in bf16,
// and the operations (0.32 ms at 67 TFLOP/s) in f32.  At DeepSeek-V3's
// (B 4, S 512, 128 heads of 192 / 128) it is 112 GFLOP against 671 MB:
// 0.113 and 0.200 ms, the bytes again.  Both passes recompute S and dP
// (seven products, not five): the price of summing without atomics.
//
// bf16 at (64, 64), (96, 96), (112, 112), (128, 128) and (192, 128) (the
// training paths): tensor-core kernels built from the forward kernel's pieces
// (flash_attention_fwd.cu): 4 warps a block, each owning 16 rows; operands
// copied by cp.async.cg 16 bytes a thread into bf16 shared memory with rows
// padded by 16 bytes, moved by ldmatrix (.trans where the product's depth
// runs down the rows), and every product an mma.sync.m16n8k16 bf16 x bf16 ->
// f32.  P and dS never leave registers: the m16n8 accumulator layout of
// S^(T) is the A-fragment layout of the next product, so they are packed to
// bf16 pairs (where the reference casts p and ds to the input dtype) and fed
// straight on.
//   * dq: a block holds 64 query rows of Q and dO and walks the band's key
//     tiles (32 keys at dk >= 128, 64 below), double-buffered by cp.async:
//     S = Q K^T, dP = dO V^T, dS, then dq += dS K with K through
//     ldmatrix.trans.  delta for its rows is computed first, one thread a
//     row, and written out.
//   * dk/dv: a block holds 64 keys of K and V and walks (query head of the
//     group, q tile of 32 rows) pairs as one double-buffered sequence:
//     S^T = K Q^T, dP^T = V dO^T, then dv += P^T dO and dk += dS^T Q, with
//     each column's lse and delta read from shared memory.  dk and dv
//     ((dk + dv)/8 x 4 floats a thread: 160 at (192, 128), against 128 at
//     (128, 128) and 96 at (96, 96)) stay in registers.  At d 96 the rows
//     are 104 elements (208 bytes) apart in shared memory, as in the
//     forward: the 8 rows an ldmatrix reads fall in 8 different 16-byte
//     bank groups.
// Left out: wgmma, TMA, warp specialisation, and one K/V tile shared by the
// q heads of a group in the dq pass.
//
// f32, and bf16 at d = 256 (where the dk/dv accumulators would not fit in
// registers): a CUDA-core kernel pair with the same structure.  Every
// product runs as f32 FMAs from tiles staged as f32 in shared memory (rows
// padded to d + 1 floats, so the 16 rows a half-warp reads sit in 16
// different banks); each thread owns a 4 x 4 (2 x 2 at dk > 128) block of the
// score tile and a 4 x dk/16 (2 x dk/16) block of its accumulators.  f32 runs
// in the tests and the card-vs-CPU training check, whose limits a TF32
// product would miss.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  int Sq, Sk, Hq, Hkv, group;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  float scale;                   // softmax scale
  float scale_log2;              // scale * log2(e)
  int causal, window;
};

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 256;     // 16 x 16

// Rows of a q tile and keys of a k tile (the same count), for head dims
// <DK, DV>.
template <int DK, int DV>
struct Tile {
  static_assert(DV <= DK, "o is staged in the rows of the K tile");
  static constexpr int BT = DK <= 128 ? 64 : 32;
  static constexpr int R = BT / 16;       // tile rows (and score columns) per thread
  static constexpr int C = DK / 16;       // q/k head-dim columns per thread
  static constexpr int CV = DV / 16;      // v/o head-dim columns per thread
  static constexpr int LD = DK + 1;       // shared row stride of a (BT, DK) tile
  static constexpr int LDV = DV + 1;      // shared row stride of a (BT, DV) tile
  static constexpr int LB = BT + 1;       // shared row stride of a (BT, BT) tile
  static constexpr int DQ_SMEM = (2 * BT * (LD + LDV) + BT * LB + 2 * BT) * 4;
  static constexpr int DKV_SMEM = (2 * BT * (LD + LDV) + 2 * BT * LB + 2 * BT) * 4;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Stage `n_valid` rows (row stride `ss` elements) of a (rows, D) slab into
// shared memory as f32 with row stride D + 1; rows at or past n_valid are 0.
template <int D, int ROWS, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long ss, int n_valid) {
  for (int e = threadIdx.x; e < ROWS * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < n_valid ? ld(src + r * ss + c) : 0.f;
  }
}

// Whether query row `qpos` (key coordinates) sees key `kpos`.
__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  bool ok = true;
  if (p.causal) ok = kpos <= qpos;
  if (p.window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// dq, and delta for the dk/dv kernel.
template <int DK, int DV, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(const Params p) {
  using Tl = Tile<DK, DV>;
  constexpr int BT = Tl::BT, R = Tl::R, C = Tl::C, LD = Tl::LD, LDV = Tl::LDV, LB = Tl::LB;
  extern __shared__ float smem[];
  float* q_s = smem;              // BT x LD
  float* do_s = q_s + BT * LD;    // BT x LDV
  float* k_s = do_s + BT * LDV;   // BT x LD; o (BT x LDV) in the prologue
  float* v_s = k_s + BT * LD;     // BT x LDV
  float* ds_s = v_s + BT * LDV;   // BT x LB
  float* lse_s = ds_s + BT * LB;  // BT, in log2 units
  float* dl_s = lse_s + BT;       // BT

  // Heaviest causal tiles (the last ones) are scheduled first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = qt * BT;
  const int nq = min(BT, p.Sq - q0);
  const int off = p.Sk - p.Sq;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* ob = static_cast<const T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_rows<DK, BT>(q_s, qb, p.q_ss, nq);
  load_rows<DV, BT>(do_s, dob, p.do_ss, nq);
  load_rows<DV, BT>(k_s, ob, p.o_ss, nq);
  __syncthreads();
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq + q0;
  for (int r = threadIdx.x; r < BT; r += THREADS) {
    float acc = 0.f;
    for (int c = 0; c < DV; ++c) acc = fmaf(do_s[r * LDV + c], k_s[r * LDV + c], acc);
    dl_s[r] = acc;
    lse_s[r] = r < nq ? p.lse[row0 + r] * LOG2E : 0.f;
    if (r < nq) p.delta[row0 + r] = acc;
  }

  // Keys this q tile can see: [lo, hi).
  int hi = p.Sk;
  if (p.causal) hi = min(hi, off + q0 + nq);
  int lo = 0;
  if (p.window) lo = max(0, off + q0 - p.window + 1);

  float acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[i][j] = 0.f;

  for (int k0 = (lo / BT) * BT; k0 < hi; k0 += BT) {
    const int nk = min(BT, p.Sk - k0);
    __syncthreads();              // the last tile's (or the prologue's) reads are done
    load_rows<DK, BT>(k_s, kb + k0 * p.k_ss, p.k_ss, nk);
    load_rows<DV, BT>(v_s, vb + k0 * p.v_ss, p.v_ss, nk);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DK; ++c) {
      float qv[R], kv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = q_s[(ty + 16 * i) * LD + c];
        kv[i] = k_s[(tx + 16 * i) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      if (c < DV) {               // always, at DK == DV
        float dov[R], vv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          dov[i] = do_s[(ty + 16 * i) * LDV + c];
          vv[i] = v_s[(tx + 16 * i) * LDV + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kc = tx + 16 * j;
        const bool ok = r < nq && kc < nk && visible(p, off + q0 + r, k0 + kc);
        const float pij = ok ? exp2f(s[i][j] * p.scale_log2 - lse_s[r]) : 0.f;
        ds_s[r * LB + kc] = pij * (dp[i][j] - dl_s[r]) * p.scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BT; ++kk) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds_s[(ty + 16 * i) * LB + kk];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float kv = k_s[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    T* row = dqb + (((long long)b * p.Sq + q0 + r) * p.Hq + h) * DK;
#pragma unroll
    for (int j = 0; j < C; ++j) st(row + tx + 16 * j, acc[i][j]);
  }
}

// dk and dv; needs the delta the dq kernel wrote.
template <int DK, int DV, typename T>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkdv_kernel(const Params p) {
  using Tl = Tile<DK, DV>;
  constexpr int BT = Tl::BT, R = Tl::R, C = Tl::C, CV = Tl::CV, LD = Tl::LD, LDV = Tl::LDV;
  constexpr int LB = Tl::LB;
  extern __shared__ float smem[];
  float* k_s = smem;              // BT x LD
  float* v_s = k_s + BT * LD;     // BT x LDV
  float* q_s = v_s + BT * LDV;    // BT x LD
  float* do_s = q_s + BT * LD;    // BT x LDV
  float* p_s = do_s + BT * LDV;   // BT x LB: P of (q row, key)
  float* ds_s = p_s + BT * LB;    // BT x LB: dS of (q row, key)
  float* lse_s = ds_s + BT * LB;  // BT, in log2 units
  float* dl_s = lse_s + BT;       // BT

  // Heaviest causal tiles (the first ones) are scheduled first.
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = kt * BT;
  const int nk = min(BT, p.Sk - k0);
  const int off = p.Sk - p.Sq;

  load_rows<DK, BT>(k_s, static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss,
                    p.k_ss, nk);
  load_rows<DV, BT>(v_s, static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss,
                    p.v_ss, nk);

  // Query rows that see a key of this tile: [qlo, qhi).  Query i sees key j
  // when j <= off + i (causal) and off + i - j < window.
  int qlo = 0, qhi = p.Sq;
  if (p.causal) qlo = max(0, k0 - off);
  if (p.window) qhi = min(qhi, k0 + nk - 1 + p.window - off);

  float dk_acc[R][C], dv_acc[R][CV];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < C; ++j) dk_acc[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < CV; ++j) dv_acc[i][j] = 0.f;
  }

  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const T* qh = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* doh = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const long long hrow = ((long long)b * p.Hq + h) * p.Sq;
    for (int q0 = (qlo / BT) * BT; q0 < qhi; q0 += BT) {
      const int nq = min(BT, p.Sq - q0);
      __syncthreads();            // the last tile's reads are done
      load_rows<DK, BT>(q_s, qh + q0 * p.q_ss, p.q_ss, nq);
      load_rows<DV, BT>(do_s, doh + q0 * p.do_ss, p.do_ss, nq);
      for (int r = threadIdx.x; r < BT; r += THREADS) {
        lse_s[r] = r < nq ? p.lse[hrow + q0 + r] * LOG2E : 0.f;
        dl_s[r] = r < nq ? p.delta[hrow + q0 + r] : 0.f;
      }
      __syncthreads();

      // Scores of q rows ty + 16 i against keys tx + 16 j.
      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int c = 0; c < DK; ++c) {
        float qv[R], kv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          qv[i] = q_s[(ty + 16 * i) * LD + c];
          kv[i] = k_s[(tx + 16 * i) * LD + c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        if (c < DV) {             // always, at DK == DV
          float dov[R], vv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dov[i] = do_s[(ty + 16 * i) * LDV + c];
            vv[i] = v_s[(tx + 16 * i) * LDV + c];
          }
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < R; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int kc = tx + 16 * j;
          const bool ok = r < nq && kc < nk && visible(p, off + q0 + r, k0 + kc);
          const float pij = ok ? exp2f(s[i][j] * p.scale_log2 - lse_s[r]) : 0.f;
          p_s[r * LB + kc] = pij;
          ds_s[r * LB + kc] = pij * (dp[i][j] - dl_s[r]) * p.scale;
        }
      }
      __syncthreads();

      // Keys ty + 16 i, head-dim columns tx + 16 j.
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = p_s[r * LB + ty + 16 * i];
          dsv[i] = ds_s[r * LB + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < C; ++j) {
          const float qv = q_s[r * LD + tx + 16 * j];
          if (j < CV) {
            const float dov = do_s[r * LDV + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < R; ++i) dv_acc[i][j] = fmaf(pv[i], dov, dv_acc[i][j]);
          }
#pragma unroll
          for (int i = 0; i < R; ++i) dk_acc[i][j] = fmaf(dsv[i], qv, dk_acc[i][j]);
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk);
  T* dvb = static_cast<T*>(p.dv);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    if (r >= nk) continue;
    const long long row = ((long long)b * p.Sk + k0 + r) * p.Hkv + hk;
#pragma unroll
    for (int j = 0; j < C; ++j) st(dkb + row * DK + tx + 16 * j, dk_acc[i][j]);
#pragma unroll
    for (int j = 0; j < CV; ++j) st(dvb + row * DV + tx + 16 * j, dv_acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels (dk < 256)
// ---------------------------------------------------------------------------

namespace tc {

typedef __nv_bfloat16 bf16;

// The forward kernel's helpers (flash_attention_fwd.cu), copied: each source
// builds into a library of its own.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU op (results below 2^-126 flush to 0; x = -inf gives 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats as a bf16 pair: lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of a 16 x 16 block from two m16n8 accumulators side by side.
__device__ __forceinline__ void to_a(uint32_t (&a)[4], const float (&lo)[4], const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

template <int DK, int DV>
struct Cfg {
  static_assert(DV <= DK, "the dP and dv loops ride on the S and dk ones");
  static constexpr int THREADS = 128;            // 4 warps, 16 rows each
  static constexpr int LD = DK + 8;              // shared row stride of Q, K (elements)
  static constexpr int LDV = DV + 8;             // shared row stride of dO, V
  static constexpr int CH = DK / 8;              // 16-byte chunks per Q / K row
  static constexpr int CHV = DV / 8;             // 16-byte chunks per dO / V row
  static constexpr int KS = DK / 16;             // k-steps of a product over dk
  static constexpr int KSV = DV / 16;            // k-steps of a product over dv
  static constexpr int DT = DK / 8;              // n-tiles over dk
  static constexpr int DTV = DV / 8;             // n-tiles over dv
  // dq kernel: 64 query rows a block, BN keys a tile.
  static constexpr int BQ = 64, BN = DK >= 128 ? 32 : 64, NT = BN / 8;
  static constexpr int DQ_SMEM = (BQ + 2 * BN) * (LD + LDV) * 2 + 2 * BQ * 4;
  // dk/dv kernel: 64 keys a block, BQT query rows a tile.
  static constexpr int BK = 64, BQT = 32, NQ = BQT / 8;
  static constexpr int DKV_SMEM = (BK + 2 * BQT) * (LD + LDV) * 2 + 4 * BQT * 4;
};

// cp.async ROWS rows of a (DK-wide) tile A and a (DV-wide) tile B, row
// strides `ss*` elements in global memory and LD / LDV in shared memory;
// rows at or past n_valid are zero-filled.  At DK == DV one loop moves both,
// as the one-dim kernel did.
template <int DK, int DV, int ROWS>
__device__ __forceinline__ void load_pair(bf16* dst_a, const bf16* src_a, long long ss_a,
                                          bf16* dst_b, const bf16* src_b, long long ss_b,
                                          int n_valid, int tid) {
  using C = Cfg<DK, DV>;
  constexpr int LD = C::LD, LDV = C::LDV, CH = C::CH, CHV = C::CHV, THREADS = C::THREADS;
  for (int e = tid; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = r < n_valid;
    cp_async16(smem_u32(dst_a + r * LD + c), src_a + (ok ? r * ss_a : 0) + c, ok);
    if constexpr (DK == DV)
      cp_async16(smem_u32(dst_b + r * LDV + c), src_b + (ok ? r * ss_b : 0) + c, ok);
  }
  if constexpr (DK != DV) {
    for (int e = tid; e < ROWS * CHV; e += THREADS) {
      const int r = e / CHV, c = (e % CHV) * 8;
      const bool ok = r < n_valid;
      cp_async16(smem_u32(dst_b + r * LDV + c), src_b + (ok ? r * ss_b : 0) + c, ok);
    }
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(Cfg<DK, DV>::THREADS)
    flash_bwd_dq_bf16_kernel(const Params p) {
  using C = Cfg<DK, DV>;
  constexpr int BQ = C::BQ, BN = C::BN, LD = C::LD, LDV = C::LDV, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);    // BQ x LD
  bf16* sdO = sQ + BQ * LD;                         // BQ x LDV
  bf16* sK = sdO + BQ * LDV;                        // 2 x BN x LD
  bf16* sV = sK + 2 * BN * LD;                      // 2 x BN x LDV
  float* lse_s = reinterpret_cast<float*>(sV + 2 * BN * LDV);  // BQ, log2 units
  float* dl_s = lse_s + BQ;                                      // BQ

  // Heaviest causal tiles (the last ones) are scheduled first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int wrow = warp * 16;
  const int q0 = qt * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const int off = p.Sk - p.Sq;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh + q0 * p.do_ss;
  const bf16* ob = static_cast<const bf16*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Keys this q tile can see: [lo, hi), as key tiles [t_begin, t_end).
  int hi = p.Sk;
  if (p.causal) hi = min(hi, off + q0 + nq);
  int lo = 0;
  if (p.window) lo = max(0, off + q0 - p.window + 1);
  const int t_begin = lo / BN;
  const int t_end = hi > 0 ? (hi + BN - 1) / BN : 0;

  load_pair<DK, DV, BQ>(sQ, qb, p.q_ss, sdO, dob, p.do_ss, nq, tid);
  cp_async_commit();                               // group: Q and dO
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BN;
    const int nk = min(BN, p.Sk - k0);
    load_pair<DK, DV, BN>(sK + stage * BN * LD, kb + (long long)k0 * p.k_ss, p.k_ss,
                          sV + stage * BN * LDV, vb + (long long)k0 * p.v_ss, p.v_ss, nk, tid);
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();                               // group: the first K/V tile
  cp_async_wait<1>();
  __syncthreads();

  // delta = rowsum(do o) over dv and lse (log2 units; +inf past the last
  // row, so that P is 0 there), one thread a row.
  const long long row0 = ((long long)b * p.Hq + h) * p.Sq + q0;
  if (tid < BQ) {
    float acc = 0.f;
    if (tid < nq) {
      const bf16* orow = ob + tid * p.o_ss;
      for (int c = 0; c < DV; ++c)
        acc = fmaf(__bfloat162float(sdO[tid * LDV + c]), __bfloat162float(orow[c]), acc);
      p.delta[row0 + tid] = acc;
    }
    dl_s[tid] = acc;
    lse_s[tid] = tid < nq ? p.lse[row0 + tid] * LOG2E : CUDART_INF_F;
  }
  __syncthreads();
  float lse_r[2], dl_r[2];                         // rows g and g + 8 of the warp
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = lse_s[wrow + g + 8 * r];
    dl_r[r] = dl_s[wrow + g + 8 * r];
  }

  // ldmatrix row addresses of this lane (as in the forward kernel): A
  // operands (rows lane % 16, column half lane / 16); B operands stored n x k
  // (two n-tiles per x4); B operands stored k x n, through .trans.
  const uint32_t q_addr = smem_u32(sQ + (wrow + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t do_addr = smem_u32(sdO + (wrow + (lane & 15)) * LDV + (lane >> 4) * 8);
  const int nk_row = (lane & 7) + ((lane >> 4) << 3), nk_col = ((lane >> 3) & 1) * 8;
  const int nk_lane = nk_row * LD + nk_col;
  const int nk_lane_v = nk_row * LDV + nk_col;
  const int kn_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + (lane >> 4) * 8;

  float acc[C::DT][4];
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int qpos = off + q0 + wrow + g;            // key position of row g

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T (depth dk) and dP = dO V^T (depth dv), 16 x BN a warp.
    float s[C::NT][4], dp[C::NT][4];
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const uint32_t k_base = smem_u32(sK + stage * BN * LD + nk_lane);
    const uint32_t v_base = smem_u32(sV + stage * BN * LDV + nk_lane_v);
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      uint32_t aq[4], ad[4];
      ldsm_x4(aq, q_addr + ks * 32);
      if (ks < C::KSV) ldsm_x4(ad, do_addr + ks * 32);
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t kf[4], vf[4];
        ldsm_x4(kf, k_base + (np * 16 * LD + ks * 16) * 2);
        if (ks < C::KSV) ldsm_x4(vf, v_base + (np * 16 * LDV + ks * 16) * 2);
        mma_bf16(s[2 * np], aq, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], aq, kf[2], kf[3]);
        if (ks < C::KSV) {
          mma_bf16(dp[2 * np], ad, vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], ad, vf[2], vf[3]);
        }
      }
    }

    // dS = P (dP - delta) scale, in place of S.
    const int k0 = t * BN;
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k0 + j * 8 + 2 * tg + (e & 1);
        const bool ok = kpos < p.Sk && visible(p, qpos + 8 * r, kpos);
        const float pv = ok ? ex2(s[j][e] * p.scale_log2 - lse_r[r]) : 0.f;
        s[j][e] = pv * (dp[j][e] - dl_r[r]) * p.scale;
      }

    // dq += dS K, K read k x n through .trans.
    const uint32_t kt_base = smem_u32(sK + stage * BN * LD + kn_lane);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dq2 = 0; dq2 < C::DT / 2; ++dq2) {
        uint32_t kf[4];
        ldsm_x4_trans(kf, kt_base + (kk * 16 * LD + dq2 * 16) * 2);
        mma_bf16(acc[2 * dq2], a, kf[0], kf[1]);
        mma_bf16(acc[2 * dq2 + 1], a, kf[2], kf[3]);
      }
    }
    __syncthreads();                               // this stage is refilled next
  }
  cp_async_wait<0>();                              // the first K/V group, when the band was empty

  bf16* dqb = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= nq) continue;
    bf16* out = dqb + (((long long)b * p.Sq + q0 + row) * p.Hq + h) * DK + 2 * tg;
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8) = pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(Cfg<DK, DV>::THREADS)
    flash_bwd_dkdv_bf16_kernel(const Params p) {
  using C = Cfg<DK, DV>;
  constexpr int BK = C::BK, BQT = C::BQT, LD = C::LD, LDV = C::LDV, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);    // BK x LD
  bf16* sV = sK + BK * LD;                          // BK x LDV
  bf16* sQ = sV + BK * LDV;                         // 2 x BQT x LD
  bf16* sdO = sQ + 2 * BQT * LD;                    // 2 x BQT x LDV
  float* lse_s = reinterpret_cast<float*>(sdO + 2 * BQT * LDV);  // 2 x BQT, log2 units
  float* dl_s = lse_s + 2 * BQT;                                   // 2 x BQT

  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;
  const int wrow = warp * 16;
  const int k0 = kt * BK;
  const int nk = min(BK, p.Sk - k0);
  const int off = p.Sk - p.Sq;

  // Query rows that see a key of this tile: [qlo, qhi), as q tiles; the
  // (head of the group, q tile) pairs form one sequence of n_tiles.
  int qlo = 0, qhi = p.Sq;
  if (p.causal) qlo = max(0, k0 - off);
  if (p.window) qhi = min(qhi, k0 + nk - 1 + p.window - off);
  const int qt_begin = qlo / BQT;
  const int n_qt = qhi > qlo ? (qhi + BQT - 1) / BQT - qt_begin : 0;
  const int n_tiles = p.group * n_qt;

  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh + k0 * p.k_ss;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh + k0 * p.v_ss;
  load_pair<DK, DV, BK>(sK, kb, p.k_ss, sV, vb, p.v_ss, nk, tid);
  auto head_of = [&](int i) { return hk * p.group + i / n_qt; };
  auto q0_of = [&](int i) { return (qt_begin + i % n_qt) * BQT; };
  auto load_q = [&](int i, int stage) {
    const int h = head_of(i), q0 = q0_of(i);
    const int nq = min(BQT, p.Sq - q0);
    const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
    const bf16* dob = static_cast<const bf16*>(p.dout) + b * p.do_sb + h * p.do_sh +
                      q0 * p.do_ss;
    load_pair<DK, DV, BQT>(sQ + stage * BQT * LD, qb, p.q_ss, sdO + stage * BQT * LDV, dob,
                           p.do_ss, nq, tid);
  };
  if (n_tiles > 0) load_q(0, 0);
  cp_async_commit();                               // group: K, V and the first Q/dO tile

  const uint32_t ka_addr = smem_u32(sK + (wrow + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t va_addr = smem_u32(sV + (wrow + (lane & 15)) * LDV + (lane >> 4) * 8);
  const int nk_row = (lane & 7) + ((lane >> 4) << 3), nk_col = ((lane >> 3) & 1) * 8;
  const int kn_row = (lane & 7) + (((lane >> 3) & 1) << 3), kn_col = (lane >> 4) * 8;
  const int nk_lane = nk_row * LD + nk_col, nk_lane_v = nk_row * LDV + nk_col;
  const int kn_lane = kn_row * LD + kn_col, kn_lane_v = kn_row * LDV + kn_col;

  float dk[C::DT][4], dv[C::DTV][4];
#pragma unroll
  for (int j = 0; j < C::DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < C::DTV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[j][e] = 0.f;
  const int kpos = k0 + wrow + g;                  // key of row g

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1;
    const int q0 = q0_of(i);
    if (tid < BQT) {                               // this tile's lse and delta
      const long long row = ((long long)b * p.Hq + head_of(i)) * p.Sq + q0 + tid;
      const bool ok = q0 + tid < p.Sq;
      lse_s[stage * BQT + tid] = ok ? p.lse[row] * LOG2E : CUDART_INF_F;
      dl_s[stage * BQT + tid] = ok ? p.delta[row] : 0.f;
    }
    if (i + 1 < n_tiles) {
      load_q(i + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S^T = K Q^T (depth dk) and dP^T = V dO^T (depth dv), 16 keys x BQT a warp.
    float s[C::NQ][4], dp[C::NQ][4];
#pragma unroll
    for (int j = 0; j < C::NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    const uint32_t q_base = smem_u32(sQ + stage * BQT * LD + nk_lane);
    const uint32_t do_base = smem_u32(sdO + stage * BQT * LDV + nk_lane_v);
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, ka_addr + ks * 32);
      if (ks < C::KSV) ldsm_x4(av, va_addr + ks * 32);
#pragma unroll
      for (int np = 0; np < C::NQ / 2; ++np) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, q_base + (np * 16 * LD + ks * 16) * 2);
        if (ks < C::KSV) ldsm_x4(df, do_base + (np * 16 * LDV + ks * 16) * 2);
        mma_bf16(s[2 * np], ak, qf[0], qf[1]);
        mma_bf16(s[2 * np + 1], ak, qf[2], qf[3]);
        if (ks < C::KSV) {
          mma_bf16(dp[2 * np], av, df[0], df[1]);
          mma_bf16(dp[2 * np + 1], av, df[2], df[3]);
        }
      }
    }

    // P^T in s, dS^T in dp; column c is query row q0 + c.
    const float* ls = lse_s + stage * BQT;
    const float* dls = dl_s + stage * BQT;
#pragma unroll
    for (int j = 0; j < C::NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tg + (e & 1);
        const int kp = kpos + 8 * (e >> 1);
        const bool ok = kp < p.Sk && visible(p, off + q0 + c, kp);
        const float pv = ok ? ex2(s[j][e] * p.scale_log2 - ls[c]) : 0.f;
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - dls[c]) * p.scale;
      }

    // dv += P^T dO and dk += dS^T Q, dO and Q read k x n through .trans.
    const uint32_t qt_base = smem_u32(sQ + stage * BQT * LD + kn_lane);
    const uint32_t dot_base = smem_u32(sdO + stage * BQT * LDV + kn_lane_v);
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk) {
      uint32_t ap[4], ad[4];
      to_a(ap, s[2 * kk], s[2 * kk + 1]);
      to_a(ad, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int d2 = 0; d2 < C::DT / 2; ++d2) {
        uint32_t of[4], qf[4];
        if (d2 < C::DTV / 2) ldsm_x4_trans(of, dot_base + (kk * 16 * LDV + d2 * 16) * 2);
        ldsm_x4_trans(qf, qt_base + (kk * 16 * LD + d2 * 16) * 2);
        if (d2 < C::DTV / 2) {
          mma_bf16(dv[2 * d2], ap, of[0], of[1]);
          mma_bf16(dv[2 * d2 + 1], ap, of[2], of[3]);
        }
        mma_bf16(dk[2 * d2], ad, qf[0], qf[1]);
        mma_bf16(dk[2 * d2 + 1], ad, qf[2], qf[3]);
      }
    }
    __syncthreads();                               // this stage is refilled next
  }
  cp_async_wait<0>();                              // K and V, when no q tile met this k tile

  bf16* dkb = static_cast<bf16*>(p.dk);
  bf16* dvb = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    if (row >= nk) continue;
    const long long at = ((long long)b * p.Sk + k0 + row) * p.Hkv + hk;
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
      *reinterpret_cast<uint32_t*>(dkb + at * DK + 2 * tg + j * 8) =
          pack_bf16(dk[j][2 * r], dk[j][2 * r + 1]);
#pragma unroll
    for (int j = 0; j < C::DTV; ++j)
      *reinterpret_cast<uint32_t*>(dvb + at * DV + 2 * tg + j * 8) =
          pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_bf16_kernel<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.Sq + C::BQ - 1) / C::BQ, p.Hq, B);
  flash_bwd_dq_bf16_kernel<DK, DV><<<grid_q, C::THREADS, C::DQ_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((p.Sk + C::BK - 1) / C::BK, p.Hkv, B);
  flash_bwd_dkdv_bf16_kernel<DK, DV><<<grid_k, C::THREADS, C::DKV_SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <int DK, int DV, typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using Tl = Tile<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<DK, DV, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::DQ_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<DK, DV, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::DKV_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((p.Sq + Tl::BT - 1) / Tl::BT, p.Hq, B);
  flash_bwd_dq_kernel<DK, DV, T><<<grid_q, THREADS, Tl::DQ_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((p.Sk + Tl::BT - 1) / Tl::BT, p.Hkv, B);
  flash_bwd_dkdv_kernel<DK, DV, T><<<grid_k, THREADS, Tl::DKV_SMEM, stream>>>(p);
  return cudaGetLastError();
}

// bf16 runs the tensor-core kernels at dk < 256 ((64, 64), (96, 96),
// (112, 112), (128, 128), (192, 128)); f32, and bf16 at 256, the CUDA-core
// ones.
// dtype: 0 = float32, 1 = bfloat16.
template <int DK, int DV>
constexpr bool on_tensor_cores() { return DK < 256; }

template <int DK, int DV>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0) return launch<DK, DV, float>(p, B, stream);
  if (dtype != 1) return cudaErrorInvalidValue;
  if constexpr (on_tensor_cores<DK, DV>()) {
    return tc::launch<DK, DV>(p, B, stream);
  } else {
    return launch<DK, DV, __nv_bfloat16>(p, B, stream);
  }
}

template <int DK, int DV>
int smem_of(int dtype, int kernel) {
  if (dtype != 0 && dtype != 1) return -1;
  if constexpr (on_tensor_cores<DK, DV>()) {
    if (dtype == 1) return kernel == 0 ? tc::Cfg<DK, DV>::DQ_SMEM : tc::Cfg<DK, DV>::DKV_SMEM;
  }
  return kernel == 0 ? Tile<DK, DV>::DQ_SMEM : Tile<DK, DV>::DKV_SMEM;
}

}  // namespace

// Shared memory a block of the dq kernel (kernel 0) or the dk/dv kernel
// (kernel 1) takes at head dims (D, Dv) for dtype (0 = float32,
// 1 = bfloat16); -1 if the pair is not taken.
extern "C" int flash_attention_bwd_smem_bytes(int D, int Dv, int dtype, int kernel) {
  if (D == 192 && Dv == 128) return smem_of<192, 128>(dtype, kernel);
  if (D != Dv) return -1;
  switch (D) {
    case 64: return smem_of<64, 64>(dtype, kernel);
    case 96: return smem_of<96, 96>(dtype, kernel);
    case 112: return smem_of<112, 112>(dtype, kernel);
    case 128: return smem_of<128, 128>(dtype, kernel);
    case 256: return smem_of<256, 256>(dtype, kernel);
    default: return -1;
  }
}

// Plain C entry point (loaded with ctypes).  q and k are D wide, v, o and do
// Dv wide; the pairs (D, Dv) taken are (64, 64), (96, 96), (112, 112),
// (128, 128), (256, 256) and (192, 128).  Strides of q, k, v, o and do are in elements,
// their last dim contiguous; for bfloat16 at D < 256 the data of q, k, v and
// do must be 16-byte aligned and their batch, row and head strides multiples
// of 8 (the wrapper checks).  lse and delta are (B,Hq,Sq) f32, contiguous;
// delta is written.  dq (B,Sq,Hq,D), dk (B,Sk,Hkv,D) and dv (B,Sk,Hkv,Dv)
// are written contiguous in the input dtype.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the cudaError_t of the launches (0 on success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Sq, int Sk, int Hq, int Hkv,
                                   int D, int Dv, long long q_sb, long long q_ss, long long q_sh,
                                   long long k_sb, long long k_ss, long long k_sh,
                                   long long v_sb, long long v_ss, long long v_sh,
                                   long long o_sb, long long o_ss, long long o_sh,
                                   long long do_sb, long long do_ss, long long do_sh,
                                   float scale, int causal, int window, int dtype,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.dout = dout;
  p.lse = static_cast<const float*>(lse); p.delta = static_cast<float*>(delta);
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.Sq = Sq; p.Sk = Sk; p.Hq = Hq; p.Hkv = Hkv; p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 192 && Dv == 128) return (int)launch<192, 128>(p, B, dtype, s);
  if (D != Dv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64: return (int)launch<64, 64>(p, B, dtype, s);
    case 96: return (int)launch<96, 96>(p, B, dtype, s);
    case 112: return (int)launch<112, 112>(p, B, dtype, s);
    case 128: return (int)launch<128, 128>(p, B, dtype, s);
    case 256: return (int)launch<256, 256>(p, B, dtype, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
