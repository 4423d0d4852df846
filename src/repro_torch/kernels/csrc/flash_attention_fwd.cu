// Flash attention forward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`_kernel` + `flash_attention`, pallas_call at :110).  Same function:
// online-softmax attention forward over q (B,Sq,Hq,d), k (B,Sk,Hkv,d) and
// v (B,Sk,Hkv,dv), with dv = d or, for DeepSeek-V3's multi-head latent
// attention, d = 192 (128 nope + 64 rope) and dv = 128,
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
//   * it also writes lse = m + log(l) (natural log, f32, (B,Hq,Sq)).
// Both kernels are templated on the two head dims <DK, DV>: Q and K rows
// are DK wide, V and O rows DV wide.  The pairs built are (d, d) for d in
// 64, 96, 112, 128, 256 and (192, 128); for DK == DV the code is the one-dim
// kernel it was.  Nothing assumes a power of two: DK and DV need only be
// multiples of 16 (k-steps of the QK^T product, pairs of 8-wide n-tiles of
// O, 16-byte chunks of a row), so 96 (phi-3-vision: 6 k-steps, 12 chunks a
// row, a 208-byte shared row whose 8 ldmatrix rows still hit distinct
// banks) and 112 run the same code as 64 and 128.
//
// What bounds it on the card.  At the llama2-7b prefill shape (B 4, S 512,
// 32 heads, d 128, causal, bf16) the kernel must move about 67.4 MB of
// q/k/v/o/lse, 0.020 ms at 3.35 TB/s, and do 8.6 GFLOP over the causal band,
// 0.0087 ms at 989 TFLOP/s: the bytes bind.  From S of about 2048 up the
// products bind instead.  The design below reads q, k, v once per 64-row q
// tile and keeps S, P and O on chip; on an H100 SXM at 700 W it takes about
// 0.067 ms at that shape (3.3x the bound, 2x SDPA) and about 220 TFLOP/s at
// S = 4096 (SDPA: about 550).
//
// bf16 design (the serving path): one block of 4 warps per (64-row q tile,
// q head, batch); each warp owns 16 query rows.
//   * Q is copied once to shared memory by cp.async and, for d <= 128,
//     moved by ldmatrix into mma A fragments that stay in registers for the
//     whole key loop (at d = 256 they are re-read from shared memory, which
//     saves 64 registers a thread).
//   * K and V tiles are double-buffered in bf16 shared memory and filled by
//     cp.async.cg, 16 bytes a thread, with commit/wait groups: tile t+1
//     arrives while tile t computes.  Tiles hold 64 keys at d = 64 and 112
//     and 32 at d = 128 and 256: at d = 128 that is 164 registers and 52 KB
//     a block, so three blocks fit an SM where 64-key tiles (87 KB) allow
//     two, and the serving shape runs 10-12% faster (measured with
//     tools/flash_tile_sweep.py, which also tries 8 warps and 32 rows a
//     warp).  Rows are padded by 16 bytes so the 8 rows of each ldmatrix hit
//     distinct banks.  Rows past the ragged end are zero-filled (src-size 0).
//   * S = Q K^T and O += P V run on the tensor cores as
//     mma.sync.m16n8k16 bf16 x bf16 -> f32; K fragments come by ldmatrix,
//     V fragments by ldmatrix.trans.
//   * The online softmax runs on the S accumulator in registers: a row
//     lives in one quad of lanes (two shuffles for its max; the sum stays
//     per lane and is reduced once at the end), the scale times log2(e) is
//     one multiply, and each exponential is one ex2.approx.  Masks are
//     applied only to the tiles that cross the causal diagonal, the window
//     edge or the ragged end of the keys; interior tiles run without them.
//   * P never leaves registers: the m16n8 accumulator layout of S is the
//     A-fragment layout of the next m16n8k16, so P is packed to bf16 pairs
//     and fed straight to the PV product.
//   * Epilogue: O is normalised in registers, staged through the warp's own
//     rows of the Q buffer and written with 16-byte stores; one lse a row.
//   * Only the key tiles of a q tile's causal/window band [lo, hi) are
//     loaded, and the heaviest causal q tiles are launched first.
// Left out: wgmma, TMA, warp specialisation and a persistent grid (which
// would overlap one tile's epilogue with the next one's loads), and reuse of
// one K/V tile across the q heads of a GQA group.
//
// f32 path: the earlier CUDA-core kernel, kept as the float32
// instantiation.  The port serves in bf16; f32 runs only in the tests and in
// the card-vs-CPU reference phase of chip_smoke.py, whose limits (2e-4 per
// row, 1e-4 on logits) a TF32 tensor-core product (about 1e-3 relative)
// would miss.  It stages Q and one K/V tile as f32 in shared memory and runs
// both products as FMA loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

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

constexpr float LN2 = 0.69314718055994531f;

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

// Tile shape for head dim D: warps per block, m16 tiles (16 query rows) per
// warp, keys per K/V tile.  Chosen by measurement at the serving shapes
// (tools/flash_tile_sweep.py, which rewrites this one line to time others).
template <int D> struct Tile { static constexpr int WARPS = 4, MT = 1, BN = D >= 128 ? 32 : 64; };

// The tile is chosen by the QK head dim DK (at (192, 128): 32 keys, as at
// 128 and 256).
template <int DK, int DV>
struct Cfg {
  static_assert(DV <= DK, "O is staged in the rows of the Q buffer");
  static constexpr int WARPS = Tile<DK>::WARPS, MT = Tile<DK>::MT, BN = Tile<DK>::BN;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * MT * WARPS;     // query rows per block
  static constexpr int LD = DK + 8;              // shared row stride of Q and K (elements)
  static constexpr int LDV = DV + 8;             // shared row stride of V
  static constexpr int CH = DK / 8;              // 16-byte chunks per Q / K row
  static constexpr int CHV = DV / 8;             // 16-byte chunks per V / O row
  static constexpr int KS = DK / 16;             // k-steps of Q K^T
  static constexpr int NT = BN / 8;              // n-tiles of S
  static constexpr int DT = DV / 8;              // n-tiles of O
  static constexpr bool Q_REGS = MT * DK <= 128; // Q fragments kept in registers
  // Q, then two stages of K, then two stages of V.
  static constexpr int SMEM = ((BQ + 2 * BN) * LD + 2 * BN * LDV) * 2;
};

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

template <int DK, int DV>
__global__ void __launch_bounds__(Cfg<DK, DV>::THREADS) flash_fwd_bf16_kernel(const Params p) {
  using C = Cfg<DK, DV>;
  constexpr int BQ = C::BQ, BN = C::BN, LD = C::LD, LDV = C::LDV, CH = C::CH, CHV = C::CHV;
  constexpr int MT = C::MT, THREADS = C::THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // BQ x LD
  __nv_bfloat16* sK = sQ + BQ * LD;                                   // 2 x BN x LD
  __nv_bfloat16* sV = sK + 2 * BN * LD;                               // 2 x BN x LDV

  // Heaviest causal tiles (the last ones) are scheduled first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tg = lane & 3;       // mma row group, thread in group
  const int wrow = warp * 16 * MT;              // first row of this warp in the tile
  const int q0 = qt * BQ;
  const int nq = min(BQ, p.Sq - q0);
  const int off = p.Sk - p.Sq;

  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb +
                            h * p.q_sh + q0 * p.q_ss;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // Keys this q tile can see: [lo, hi), as key tiles [t_begin, t_end).
  int hi = p.Sk;
  if (p.causal) hi = min(hi, off + q0 + nq);
  int lo = 0;
  if (p.window) lo = max(0, off + q0 - p.window + 1);
  const int t_begin = lo / BN;
  const int t_end = hi > 0 ? (hi + BN - 1) / BN : 0;

  for (int e = tid; e < BQ * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = r < nq;
    cp_async16(smem_u32(sQ + r * LD + c), qb + (ok ? r * p.q_ss : 0) + c, ok);
  }
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BN;
    const int nk = min(BN, p.Sk - k0);
    __nv_bfloat16* dk = sK + stage * BN * LD;
    __nv_bfloat16* dv = sV + stage * BN * LDV;
    if constexpr (DK == DV) {
      for (int e = tid; e < BN * CH; e += THREADS) {
        const int r = e / CH, c = (e % CH) * 8;
        const bool ok = r < nk;
        const long long row = ok ? k0 + r : 0;
        cp_async16(smem_u32(dk + r * LD + c), kb + row * p.k_ss + c, ok);
        cp_async16(smem_u32(dv + r * LDV + c), vb + row * p.v_ss + c, ok);
      }
    } else {
      for (int e = tid; e < BN * CH; e += THREADS) {
        const int r = e / CH, c = (e % CH) * 8;
        const bool ok = r < nk;
        cp_async16(smem_u32(dk + r * LD + c), kb + (ok ? k0 + r : 0) * p.k_ss + c, ok);
      }
      for (int e = tid; e < BN * CHV; e += THREADS) {
        const int r = e / CHV, c = (e % CHV) * 8;
        const bool ok = r < nk;
        cp_async16(smem_u32(dv + r * LDV + c), vb + (ok ? k0 + r : 0) * p.v_ss + c, ok);
      }
    }
  };
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();                              // group: Q and the first K/V tile

  // ldmatrix row addresses of this lane.  Q (A operand): rows lane % 16,
  // column half lane / 16.  K (B operand, two n-tiles per x4): keys
  // (lane & 7) + 8 * (lane / 16), column half (lane / 8) & 1.  V (B operand
  // through .trans, two d-tiles per x4): keys (lane & 7) + 8 * ((lane / 8) & 1),
  // column half lane / 16.
  const uint32_t q_addr = smem_u32(sQ + (wrow + (lane & 15)) * LD + (lane >> 4) * 8);
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + (((lane >> 3) & 1) << 3)) * LDV + (lane >> 4) * 8;

  // Per lane: rows g and g + 8 of each of the warp's MT m-tiles.
  uint32_t qf[C::Q_REGS ? MT * C::KS : 1][4];
  float acc[MT][C::DT][4];
  float m[MT][2], l[MT][2];                     // running max (log2 units), lane's part of the sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < C::DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -CUDART_INF_F;
      l[mt][r] = 0.f;
    }
  }
  const int qpos = off + q0 + wrow + g;          // key position of row (mt 0, g)

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
    if constexpr (C::Q_REGS) {
      if (t == t_begin) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int ks = 0; ks < C::KS; ++ks)
            ldsm_x4(qf[mt * C::KS + ks], q_addr + mt * 16 * LD * 2 + ks * 32);
      }
    }

    // S = Q K^T: 16 MT x BN a warp, f32.
    float s[MT][C::NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
    const uint32_t k_base = smem_u32(sK + stage * BN * LD + k_lane);
#pragma unroll
    for (int ks = 0; ks < C::KS; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if constexpr (C::Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[mt][e] = qf[mt * C::KS + ks][e];
        } else {
          ldsm_x4(a[mt], q_addr + mt * 16 * LD * 2 + ks * 32);
        }
      }
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, k_base + (np * 16 * LD + ks * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * np], a[mt], kf[0], kf[1]);
          mma_bf16(s[mt][2 * np + 1], a[mt], kf[2], kf[3]);
        }
      }
    }

    // Scale to log2 units; mask only tiles at the diagonal, window edge or ragged end.
    const int k0 = t * BN;
    const bool need_mask = k0 + BN > p.Sk || (p.causal && k0 + BN - 1 > off + q0) ||
                           (p.window && k0 <= off + q0 + BQ - 1 - p.window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e] * p.scale_log2;
          if (need_mask) {
            const int kpos = k0 + j * 8 + 2 * tg + (e & 1);
            const int qp = qpos + mt * 16 + (e >> 1) * 8;
            bool ok = kpos < p.Sk;
            if (p.causal) ok = ok && kpos <= qp;
            if (p.window) ok = ok && qp - kpos < p.window;
            x = ok ? x : -CUDART_INF_F;
          }
          s[mt][j][e] = x;
        }

    // Online softmax on the accumulator; a row lives in one quad of lanes.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[mt][r];
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          mx = fmaxf(mx, fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mu[r] = mx == -CUDART_INF_F ? 0.f : mx;   // row fully masked so far
        const float corr = ex2(m[mt][r] - mu[r]);
        m[mt][r] = mx;
        l[mt][r] *= corr;
#pragma unroll
        for (int j = 0; j < C::DT; ++j) {
          acc[mt][j][2 * r] *= corr;
          acc[mt][j][2 * r + 1] *= corr;
        }
      }
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[mt][j][e] = ex2(s[mt][j][e] - mu[e >> 1]);
          l[mt][e >> 1] += s[mt][j][e];
        }
    }

    // O += P V, P as bf16 A fragments straight from the S accumulator.
    const uint32_t v_base = smem_u32(sV + stage * BN * LDV + v_lane);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < C::DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, v_base + (kk * 16 * LDV + dp * 16) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * dp], a[mt], vf[0], vf[1]);
          mma_bf16(acc[mt][2 * dp + 1], a[mt], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                              // this stage is refilled next
  }
  cp_async_wait<0>();                             // Q's copy, when the band was empty
  __syncthreads();

  // Epilogue: finish the row sums, normalise, stage the warp's rows in its
  // own rows of sQ, then 16-byte stores.
  __nv_bfloat16* so = sQ + wrow * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 1);
      l[mt][r] += __shfl_xor_sync(0xffffffffu, l[mt][r], 2);
      l[mt][r] = fmaxf(l[mt][r], 1e-30f);
      inv[r] = 1.f / l[mt][r];
    }
#pragma unroll
    for (int j = 0; j < C::DT; ++j) {
      *reinterpret_cast<uint32_t*>(so + (mt * 16 + g) * LD + j * 8 + 2 * tg) =
          pack_bf16(acc[mt][j][0] * inv[0], acc[mt][j][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(so + (mt * 16 + g + 8) * LD + j * 8 + 2 * tg) =
          pack_bf16(acc[mt][j][2] * inv[1], acc[mt][j][3] * inv[1]);
    }
  }
  __syncwarp();
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh +
                      q0 * p.o_ss;
  for (int e = lane; e < 16 * MT * CHV; e += 32) {
    const int r = e / CHV, c = (e % CHV) * 8;
    const int row = wrow + r;
    if (row < nq)
      *reinterpret_cast<uint4*>(ob + row * p.o_ss + c) =
          *reinterpret_cast<const uint4*>(so + r * LD + c);
  }
  if (tg == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wrow + mt * 16 + g + 8 * r;
        if (row < nq)
          p.lse[((long long)b * p.Hq + h) * p.Sq + q0 + row] =
              (m[mt][r] + log2f(l[mt][r])) * LN2;
      }
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + C::BQ - 1) / C::BQ, p.Hq, B);
  flash_fwd_bf16_kernel<DK, DV><<<grid, C::THREADS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int ROWS = BQ / 16;    // query rows per thread
constexpr int COLS = BK / 16;    // score columns per thread

// Dynamic shared memory of one block: Q (rows padded to DK + 1), one K or
// V tile (rows padded to DK + 1 or DV + 1; DV <= DK) and the P tile (rows
// padded to BK + 1).
constexpr int smem_bytes(int DK) {
  return (int)(((BQ + BK) * (DK + 1) + BQ * (BK + 1)) * sizeof(float));
}

// Stage 64 rows (row stride `ss` elements) of a (S, D) slab into shared
// memory with a padded row stride of D + 1 (conflict-free column reads).
// Rows at or past `n_valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long ss, int n_valid) {
  for (int e = threadIdx.x; e < 64 * D; e += THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r < n_valid ? src[(long long)r * ss + c] : 0.f;
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

template <int DK, int DV>
__global__ void __launch_bounds__(THREADS) flash_fwd_f32_kernel(const Params p) {
  static_assert(DV <= DK, "V shares the K tile's buffer");
  extern __shared__ float smem[];
  float* q_s = smem;                    // BQ x (DK + 1)
  float* kv_s = q_s + BQ * (DK + 1);    // BK x (DK + 1), then BK x (DV + 1): K, then V
  float* p_s = kv_s + BK * (DK + 1);    // BQ x (BK + 1)

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

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<DK>(q_s, qb, p.q_ss, nq);

  // Keys this q tile can see: [lo, hi).
  int hi = p.Sk;
  if (p.causal) hi = min(hi, off + q0 + nq);
  int lo = 0;
  if (p.window) lo = max(0, off + q0 - p.window + 1);

  float m[ROWS], l[ROWS], acc[ROWS][DV / 16];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    const int nk = min(BK, p.Sk - k0);
    __syncthreads();                    // previous V tile consumed; Q staged
    load_tile<DK>(kv_s, kb + k0 * p.k_ss, p.k_ss, nk);
    __syncthreads();

    float s[ROWS][COLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float qv[ROWS], kv[COLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) qv[i] = q_s[(ty + 16 * i) * (DK + 1) + c];
#pragma unroll
      for (int j = 0; j < COLS; ++j) kv[j] = kv_s[(tx + 16 * j) * (DK + 1) + c];
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
      for (int j = 0; j < DV / 16; ++j) acc[i][j] *= corr;
    }

    __syncthreads();                    // K reads done, P visible
    load_tile<DV>(kv_s, vb + k0 * p.v_ss, p.v_ss, nk);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = p_s[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DV / 16; ++j) {
        const float vv = kv_s[c * (DV + 1) + tx + 16 * j];
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
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh + (long long)(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < DV / 16; ++j) orow[tx + 16 * j] = acc[i][j] * inv;
    if (tx == 0)
      p.lse[((long long)b * p.Hq + h) * p.Sq + q0 + r] = (m[i] + log2f(lc)) * LN2;
  }
}

template <int DK, int DV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes(DK);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<DK, DV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, B);
  flash_fwd_f32_kernel<DK, DV><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

// dtype: 0 = float32, 1 = bfloat16.
template <int DK, int DV>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0) return f32::launch<DK, DV>(p, B, stream);
  if (dtype == 1) return tc::launch<DK, DV>(p, B, stream);
  return cudaErrorInvalidValue;
}

template <int DK, int DV>
int smem_of(int dtype) {
  return dtype == 0 ? f32::smem_bytes(DK) : dtype == 1 ? tc::Cfg<DK, DV>::SMEM : -1;
}

}  // namespace

// Shared memory a block takes at head dims (D, Dv) for dtype (0 = float32,
// 1 = bfloat16); -1 if the pair is not supported.
extern "C" int flash_attention_fwd_smem_bytes(int D, int Dv, int dtype) {
  if (D == 192 && Dv == 128) return smem_of<192, 128>(dtype);
  if (D != Dv) return -1;
  switch (D) {
    case 64: return smem_of<64, 64>(dtype);
    case 96: return smem_of<96, 96>(dtype);
    case 112: return smem_of<112, 112>(dtype);
    case 128: return smem_of<128, 128>(dtype);
    case 256: return smem_of<256, 256>(dtype);
    default: return -1;
  }
}

// Plain C entry point (loaded with ctypes).  q and k are D wide, v and o Dv
// wide; the pairs (D, Dv) taken are (64, 64), (96, 96), (112, 112),
// (128, 128), (256, 256) and (192, 128).  Strides are in elements; the last dim of q,
// k, v and o must be contiguous.  For bfloat16 the data pointers must be
// 16-byte aligned and the batch, row and head strides multiples of 8 (the
// wrapper checks).  dtype: 0 = float32, 1 = bfloat16.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Sq, int Sk, int Hq, int Hkv, int D,
                                   int Dv, long long q_sb, long long q_ss, long long q_sh,
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
