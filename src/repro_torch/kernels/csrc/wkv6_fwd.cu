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
// Every exponent is formed so that it is <= 0, never as e^{cw_t} e^{-cw_i},
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
// What bounds it on the card: for rwkv6-1.6b prefill (B 4, S 512, 32 heads
// of 64, r/k/v bf16) it moves about 61 MB (r, k, v in bf16; logw, y, S_last
// in f32) against about 1.5 GFLOP and 31 M exponentials, so the bytes bind
// (about 0.018 ms at 3.35 TB/s).  A decode step (S = 1) moves the state in
// and out, 4.2 MB at batch 4: 0.0013 ms.
//
// Three kernels:
//
// bf16, S > 1 (namespace tc, the served prefill): the chunk algebra of the
// Pallas kernel on the tensor cores.  One block of 8 warps per (column slab
// of the state, head, batch).  The state's dv columns are independent (y's
// columns need only S's and v's), so a (batch, head) may be split over
// NSPLIT blocks of 64 / NSPLIT columns, each recomputing the chunk's cumsum
// and scores; the sweep chose NSPLIT = 1 (below).  Per chunk:
//   * r, k and the v slab (bf16) are double-buffered by cp.async, 16 bytes a
//     thread, rows past S zero-filled; w (f32) is loaded into registers one
//     chunk ahead.
//   * Each warp scans the cumsum of 8 channels down the chunk's 32
//     rows with shuffles (lane = row), and forms the decayed operands rd = r
//     o e^{cw-w}, kd = k o e^{cw_Q-cw} and, for the scores, k~_i = k_i o
//     e^{cw_b - cw_i} (rows 0-15) and r~_t = r_t o e^{cw_{t-1} - cw_b} (rows
//     16-31), b = 15: both exponents are <= 0 (ex2.approx on log2e-scaled
//     sums).  Each is rounded to a bf16 hi and a bf16 lo half: bf16 alone
//     (2^-9) would miss the 2e-5 limit on y and S_last; hi + lo leaves
//     about 2^-17 per term.  Only r, k and v are exact in bf16.
//   * Scores by sub-chunks of 16.  Rows 16-31 x columns 0-15 factor as
//     r~ k~^T: one mma.sync m16n8k16 product with both operands split (3
//     terms: hi hi, hi lo, lo hi), kept in registers as the A operand of
//     A v.  The two diagonal 16 x 16 blocks keep the exact per-(t, i, c)
//     exponent on the CUDA cores (15,360 exponentials a chunk instead of
//     31,744), with the bonus on their diagonal: each lane takes rows t and
//     15 - t of a block (15 entries, one loop with no branch) for a group of
//     channels, and the lanes of a group sum by halving exchanges.
//     Factoring at the chunk's start would need exponents down to -93,
//     which underflows: 16 is the largest safe sub-chunk.
//   * y = A v (A split hi + lo, v exact: 2 terms) + rd S (both split: 3
//     terms); S = e^{cw_Q} o S + kd^T v (kd split: 2 terms).  The state stays
//     in f32 registers in the accumulator layout (four row tiles of 16 x
//     the column groups over the warps), with a hi + lo bf16 copy in shared
//     memory for rd S.
//   * Three barriers a chunk: tiles landed; scan products visible; scores
//     and every read of the old state copy done.
//   NSPLIT and the blocks per SM the launch bounds ask for are one `Tile`
//   line, chosen by tools/wkv_tile_sweep.py: at the rwkv6-1.6b prefill
//   shape NSPLIT = 2 loses more to the recomputed scores than it gains from
//   more blocks (it wins at batch 1), and 8 warps beat 4.  What holds the
//   kernel at 3.5x its bound is the latency of one block's chain per chunk
//   (about 6,650 cycles: scan 1,350, diagonal scores 2,200, products and
//   barriers the rest; tools/wkv_phase_probe.py), with one block an SM
//   (PERF.md).  r, k, v need 16-byte-aligned data and batch / time / head
//   strides in multiples of 8 elements, logw 16-byte-aligned data and
//   strides in multiples of 4 (the wrapper checks; nothing copies).
//
// S = 1, both dtypes (namespace dec, every decode step): cw - w = 0 and
// cw = w, so the step is y = r S + (sum_c r_c u_c k_c) v and S' = e^w o S +
// k^T v: elementwise work and one 64-wide reduction per column, all in f32.
// One block of 128 threads per (16-column slab, head, batch): each thread
// reads two rows x 4 columns of s0 as float4 and writes them back decayed;
// y's reduction over c runs by shuffles, then across the 4 warps.
//
// f32, S > 1 (namespace f32): the earlier CUDA-core kernel, kept on
// purpose.  The port serves in bf16; f32 runs only in the tests and the
// card-vs-CPU reference of chip_smoke.py, whose limits (2e-5 on y and the
// state, 1e-4 on logits) it holds with plain f32 FMAs.  One block of 256
// threads per (batch, head) walks the chunks with the state in registers
// and every product as an FMA loop; 79,872 bytes of shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;            // timesteps per chunk, as the reference
constexpr float L2E = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// bf16, S > 1: tensor-core kernel (D = 64)
// ---------------------------------------------------------------------------

namespace tc {

// Column blocks per (batch, head), and blocks per SM the launch bounds ask
// for.  Chosen by measurement (tools/wkv_tile_sweep.py rewrites this line).
struct Tile { static constexpr int NSPLIT = 1, MIN_BLOCKS = 1; };

constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int D = 64;                          // dk = dv = head dim
constexpr int DV = D / Tile::NSPLIT;           // state columns of a block
constexpr int CW = D / WARPS;                  // channels a warp scans: 8
constexpr int NT = DV / 32;                    // y n-tiles (of 8 columns) a warp: 4 groups x 2 row tiles
constexpr int NS = DV / 16;                    // state n-tiles a warp: 2 groups x 4 row tiles
constexpr int CG = 4;                          // channels a lane sums in the diagonal blocks
constexpr int NG = D / CG;                     // lanes that share one score: 16
constexpr int LD = D + 8;                      // bf16 row of a 64-wide tile, padded 16 bytes
constexpr int LDV = DV + 8;                    // bf16 row of a DV-wide tile, padded 16 bytes
constexpr int LDF = D + 4;                     // f32 row of a 64-wide tile
constexpr int LDA = Q + 8;                     // f32 row of the score tile
constexpr int TILE = Q * LD, VTILE = Q * LDV;
// f32: cw and cw - w (log2e-scaled, Q x LDF), the scores (Q x LDA); bf16:
// two stages of r, k (Q x LD) and v (Q x LDV), hi and lo of rd, kd and rk~
// (Q x LD), hi and lo of the state copy (D x LDV).
constexpr int SMEM = 4 * (2 * Q * LDF + Q * LDA) + 2 * (2 * (2 * TILE + VTILE) + 6 * TILE +
                                                        2 * D * LDV);
static_assert(Tile::NSPLIT == 1 || Tile::NSPLIT == 2, "NSPLIT");


using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two floats as a bf16 pair: lo in the low half (the lower column).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The pair (a, b) as hi + lo bf16 pairs: a + b's error drops to about 2^-17.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// 2^x, about 2 ulp; 0 for very negative x.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[8]) {
  f[0] = bf_lo(q.x); f[1] = bf_hi(q.x); f[2] = bf_lo(q.y); f[3] = bf_hi(q.y);
  f[4] = bf_lo(q.z); f[5] = bf_hi(q.z); f[6] = bf_lo(q.w); f[7] = bf_hi(q.w);
}

// 4 consecutive values (16-byte aligned for f32, 8-byte for bf16).
__device__ __forceinline__ void load_f4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void load_bf4(const bf16* p, float (&f)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  f[0] = bf_lo(q.x); f[1] = bf_hi(q.x); f[2] = bf_lo(q.y); f[3] = bf_hi(q.y);
}

// B fragments of N n-tiles (8 columns each, from 16-byte chunk c0 on) of a
// row-major (k x n) bf16 tile with row length ld, k rows k0..k0+15.
template <int N>
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&f)[N][2], uint32_t base, int k0, int c0,
                                             int ld, int lane) {
  const int row = k0 + (lane & 15), h1 = lane >> 4;
#pragma unroll
  for (int np = 0; np < N / 2; ++np) {
    uint32_t x[4];
    ldsm_x4_trans(x, base + 2u * static_cast<uint32_t>(row * ld + (c0 + 2 * np + h1) * 8));
    f[2 * np][0] = x[0]; f[2 * np][1] = x[1];
    f[2 * np + 1][0] = x[2]; f[2 * np + 1][1] = x[3];
  }
  if (N & 1) {
    uint32_t x[2];
    ldsm_x2_trans(x, base + 2u * static_cast<uint32_t>(row * ld + (c0 + N - 1) * 8));
    f[N - 1][0] = x[0]; f[N - 1][1] = x[1];
  }
}

__global__ void __launch_bounds__(THREADS, Tile::MIN_BLOCKS)
    wkv6_fwd_bf16_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sCw = reinterpret_cast<float*>(smem_raw);  // Q x LDF: cw * log2e
  float* sCm = sCw + Q * LDF;                        // Q x LDF: (cw - w) * log2e
  float* sA = sCm + Q * LDF;                         // Q x LDA: the diagonal score blocks
  bf16* sR = reinterpret_cast<bf16*>(sA + Q * LDA);  // 2 stages of r
  bf16* sK = sR + 2 * TILE;                          // 2 stages of k
  bf16* sV = sK + 2 * TILE;                          // 2 stages of the v slab
  bf16* sP = sV + 2 * VTILE;                         // rd, kd, rk~: hi, lo of each
  bf16* sS = sP + 6 * TILE;                          // the state copy: hi, lo

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;            // mma row group, thread in group
  const int col0 = blockIdx.x * DV;                  // the block's state columns
  const int h = blockIdx.y, b = blockIdx.z;
  const int S = p.S;

  const bf16* rb = static_cast<const bf16*>(p.r) + b * p.r_sb + h * p.r_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh + col0;
  const float* wb = p.w + b * p.w_sb + h * p.w_sh;
  const long long sbase = ((long long)b * p.H + h) * D * D;

  // Entries of the score tile that no chunk writes stay 0.
  for (int e = tid; e < Q * LDA; e += THREADS) sA[e] = 0.f;

  // Copies of one chunk: r and k 256 pieces of 16 bytes each, v Q * DV / 8.
  auto load_chunk = [&](int c, int stage) {
    const int t0 = c * Q, nv = min(Q, S - t0);
#pragma unroll
    for (int pc = tid; pc < Q * 8; pc += THREADS) {
      const int row = pc >> 3, ch = pc & 7;
      const bool ok = row < nv;
      const long long t = ok ? t0 + row : t0;
      const int off = stage * TILE + row * LD + ch * 8;
      cp_async16(smem_u32(sR + off), rb + t * p.r_ss + ch * 8, ok);
      cp_async16(smem_u32(sK + off), kb + t * p.k_ss + ch * 8, ok);
    }
    constexpr int VC = DV / 8;                       // pieces of a v row
    for (int pc = tid; pc < Q * VC; pc += THREADS) {
      const int row = pc / VC, ch = pc % VC;
      const bool ok = row < nv;
      const long long t = ok ? t0 + row : t0;
      cp_async16(smem_u32(sV + stage * VTILE + row * LDV + ch * 8), vb + t * p.v_ss + ch * 8, ok);
    }
  };
  // w of row `lane` of chunk c, the warp's CW channels (0 past S).
  auto load_w = [&](int c, float (&wv)[CW]) {
    const long long t = (long long)c * Q + lane;
    if (t < S) {
      const float4* src = reinterpret_cast<const float4*>(wb + t * p.w_ss + CW * warp);
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        const float4 x = src[q];
        wv[4 * q] = x.x; wv[4 * q + 1] = x.y; wv[4 * q + 2] = x.z; wv[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < CW; ++j) wv[j] = 0.f;
    }
  };
  // This warp's part of the state: rows 16 srow + g and + 8, columns scol +
  // 8 nt + 2 tg + {0, 1} of the slab.
  const int srow = 16 * (warp & 3), scol = (warp >> 2) * NS * 8;
  // The hi + lo copy of the state, this lane's part.
  auto store_state = [&](const float (&hc)[NS][4]) {
    const int ra = srow + g;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      const int c = scol + 8 * nt + 2 * tg;
      uint32_t hi, lo;
      split2(hc[nt][0], hc[nt][1], hi, lo);
      *reinterpret_cast<uint32_t*>(sS + ra * LDV + c) = hi;
      *reinterpret_cast<uint32_t*>(sS + D * LDV + ra * LDV + c) = lo;
      split2(hc[nt][2], hc[nt][3], hi, lo);
      *reinterpret_cast<uint32_t*>(sS + (ra + 8) * LDV + c) = hi;
      *reinterpret_cast<uint32_t*>(sS + D * LDV + (ra + 8) * LDV + c) = lo;
    }
  };

  // The state (f32) in the m16n8 accumulator layout.
  float hc[NS][4];
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    const long long off = sbase + (srow + g) * D + col0 + scol + 8 * nt + 2 * tg;
    float2 v0 = make_float2(0.f, 0.f), v1 = v0;
    if (p.s0) {
      v0 = *reinterpret_cast<const float2*>(p.s0 + off);
      v1 = *reinterpret_cast<const float2*>(p.s0 + off + 8 * D);
    }
    hc[nt][0] = v0.x; hc[nt][1] = v0.y; hc[nt][2] = v1.x; hc[nt][3] = v1.y;
  }
  store_state(hc);

  // The bonus u of this lane's channels in the diagonal blocks (CG de ..).
  const int de = lane % NG;
  float ug[CG];
#pragma unroll
  for (int j = 0; j < CG; ++j) ug[j] = p.u[h * D + CG * de + j];

  // ldmatrix lane addresses.  Pattern 1 (A non-trans, B trans): row lane & 15,
  // chunk + (lane >> 4).  Pattern 2 (B non-trans, A trans): row (lane & 7) +
  // 8 (lane >> 4), chunk + ((lane >> 3) & 1).
  const int r1 = lane & 15, h1 = lane >> 4;
  const int r2 = (lane & 7) + ((lane >> 4) << 3), h2 = (lane >> 3) & 1;
  auto at = [](uint32_t base, int row, int chunk) {
    return base + 2u * static_cast<uint32_t>(row * LD + chunk * 8);
  };
  const int mt = warp & 1;                           // y rows 16 mt .. 16 mt + 15
  const int yc = (warp >> 1) * (NT);                 // first 16-byte chunk of its y columns

  const int nchunks = (S + Q - 1) / Q;
  load_chunk(0, 0);
  cp_async_commit();
  float wn[CW];
  load_w(0, wn);

  for (int c = 0; c < nchunks; ++c) {
    const int stage = c & 1, t0 = c * Q, nv = min(Q, S - t0);
    const bf16* cR = sR + stage * TILE;
    const bf16* cK = sK + stage * TILE;
    const uint32_t vS = smem_u32(sV + stage * VTILE);

    // (a) This chunk's tiles, last chunk's state copy, and every read of
    // the buffers written below are behind this barrier.
    cp_async_wait_all();
    __syncthreads();
    if (c + 1 < nchunks) {
      load_chunk(c + 1, stage ^ 1);
      cp_async_commit();
    }

    // (1) Cumsum of w down the chunk (lane = row) for the warp's CW
    // channels, and the decayed operands of row `lane`, split hi + lo.
    {
      float cw[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) cw[j] = wn[j];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const float x = __shfl_up_sync(FULL, cw[j], off);
          if (lane >= off) cw[j] += x;
        }
      const int col = CW * warp;                     // the warp's channels col .. col + 7
      float rv[8], kv[8];
      unpack8(*reinterpret_cast<const uint4*>(cR + lane * LD + col), rv);
      unpack8(*reinterpret_cast<const uint4*>(cK + lane * LD + col), kv);
      uint32_t o[6][4];                            // rd, kd, rk~ (hi, lo) as bf16 pairs
      float cws[8], cms[8];
#pragma unroll
      for (int jj = 0; jj < 8; jj += 2) {
        float rd[2], kd[2], rk[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = jj + e;
          const float x = cw[j], m = x - wn[j];
          const float xq = __shfl_sync(FULL, x, 31), xb = __shfl_sync(FULL, x, 15);
          rd[e] = rv[jj + e] * ex2(m * L2E);
          kd[e] = kv[jj + e] * ex2((xq - x) * L2E);
          rk[e] = (lane < 16 ? kv[jj + e] : rv[jj + e]) *
                  ex2((lane < 16 ? xb - x : m - xb) * L2E);
          cws[jj + e] = x * L2E;
          cms[jj + e] = m * L2E;
        }
        split2(rd[0], rd[1], o[0][jj / 2], o[1][jj / 2]);
        split2(kd[0], kd[1], o[2][jj / 2], o[3][jj / 2]);
        split2(rk[0], rk[1], o[4][jj / 2], o[5][jj / 2]);
      }
#pragma unroll
      for (int m = 0; m < 6; ++m)
        *reinterpret_cast<uint4*>(sP + m * TILE + lane * LD + col) =
            make_uint4(o[m][0], o[m][1], o[m][2], o[m][3]);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        *reinterpret_cast<float4*>(sCw + lane * LDF + col + 4 * q) =
            make_float4(cws[4 * q], cws[4 * q + 1], cws[4 * q + 2], cws[4 * q + 3]);
        *reinterpret_cast<float4*>(sCm + lane * LDF + col + 4 * q) =
            make_float4(cms[4 * q], cms[4 * q + 1], cms[4 * q + 2], cms[4 * q + 3]);
      }
    }
    if (c + 1 < nchunks) load_w(c + 1, wn);
    __syncthreads();                                 // (b) the operands are visible
    // e^{cw_Q} of this lane's two state rows.
    const float eq0 = exp2f(sCw[(Q - 1) * LDF + srow + g]);
    const float eq1 = exp2f(sCw[(Q - 1) * LDF + srow + g + 8]);

    // (2) The diagonal score blocks, exact on the CUDA cores.  Lane = (channel
    // group de of CG channels, sub-chunk); warp w takes rows ta = w and tb =
    // 15 - w of each sub-chunk (local), whose 15 strict entries (w below ta,
    // 15 - w below tb) are one loop of 15 with no branch, and the two bonus
    // terms.  The NG = 16 lanes of a group then sum all 16 values (15
    // entries and ta's bonus) by halving exchanges: 15 shuffles, after which
    // each lane holds one sum and stores it.
    {
      const int sub = lane / NG, base = 16 * sub;
      const int tl = warp;
      const int ta = base + tl, tb = base + 15 - tl;
      const int c0 = CG * de;
      float ra[CG], ma[CG], rb_[CG], mb[CG], v[16], bonus_b;
      load_bf4(cR + ta * LD + c0, ra);
      load_f4(sCm + ta * LDF + c0, ma);
      load_bf4(cR + tb * LD + c0, rb_);
      load_f4(sCm + tb * LDF + c0, mb);
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const bool on_a = j < tl;
        const int i = base + (on_a ? j : j - tl);
        float ki[CG], ci[CG];
        load_bf4(cK + i * LD + c0, ki);
        load_f4(sCw + i * LDF + c0, ci);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < CG; ++e) {
          const float rt = on_a ? ra[e] : rb_[e], mt = on_a ? ma[e] : mb[e];
          acc = fmaf(rt * ki[e], ex2(mt - ci[e]), acc);
        }
        v[j] = acc;
      }
      {
        float ka[CG], kb_[CG];
        load_bf4(cK + ta * LD + c0, ka);
        load_bf4(cK + tb * LD + c0, kb_);
        v[15] = 0.f;
        bonus_b = 0.f;
#pragma unroll
        for (int e = 0; e < CG; ++e) {
          v[15] = fmaf(ra[e] * ug[e], ka[e], v[15]);
          bonus_b = fmaf(rb_[e] * ug[e], kb_[e], bonus_b);
        }
      }
      // Halving exchanges over lane bits 1, 2, 4, 8: the lane with the bit
      // set keeps the upper half.  Lane bits b0 b1 b2 b3 leave v[0] = the sum
      // of value 8 b0 + 4 b1 + 2 b2 + b3.
      int n = 16;
#pragma unroll
      for (int m = 1; m < NG; m <<= 1) {
        n >>= 1;
        const bool up = lane & m;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < n) {
            const float send = up ? v[q] : v[q + n];
            const float keep = up ? v[q + n] : v[q];
            v[q] = keep + __shfl_xor_sync(FULL, send, m);
          }
        }
      }
#pragma unroll
      for (int m = 1; m < NG; m <<= 1) bonus_b += __shfl_xor_sync(FULL, bonus_b, m);
      const int j = 8 * (lane & 1) + 4 * ((lane >> 1) & 1) + 2 * ((lane >> 2) & 1) +
                    ((lane >> 3) & 1);               // the value v[0] now sums
      if (j == 15) sA[ta * LDA + ta] = v[0];
      else if (j < tl) sA[ta * LDA + base + j] = v[0];
      else sA[tb * LDA + base + j - tl] = v[0];
      if (de == 0) sA[tb * LDA + tb] = bonus_b;
    }

    const uint32_t pS = smem_u32(sP);
    const uint32_t rdH = pS, rdL = pS + 2u * TILE, kdH = pS + 4u * TILE, kdL = pS + 6u * TILE;
    const uint32_t rkH = pS + 8u * TILE, rkL = pS + 10u * TILE;
    const uint32_t sH = smem_u32(sS), sL = sH + 2u * D * LDV;

    // (3) The factored block (rows 16-31 x columns 0-15) r~ k~^T in the
    // warps of rows 16-31, packed as A fragments (k = columns 0-15).
    uint32_t oh[4] = {0u, 0u, 0u, 0u}, ol[4] = {0u, 0u, 0u, 0u};
    if (mt == 1) {
      // hi hi and the two correction terms in separate sums: shorter chains.
      float s[2][4], sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = sc[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ah[4], al[4], bh[4], bl[4];
        ldsm_x4(ah, at(rkH, 16 + r1, 2 * ks + h1));
        ldsm_x4(al, at(rkL, 16 + r1, 2 * ks + h1));
        ldsm_x4(bh, at(rkH, r2, 2 * ks + h2));
        ldsm_x4(bl, at(rkL, r2, 2 * ks + h2));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(s[nt], ah, bh[2 * nt], bh[2 * nt + 1]);
          mma_bf16(sc[nt], ah, bl[2 * nt], bl[2 * nt + 1]);
          mma_bf16(sc[nt], al, bh[2 * nt], bh[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += sc[nt][e];
      split2(s[0][0], s[0][1], oh[0], ol[0]);
      split2(s[0][2], s[0][3], oh[1], ol[1]);
      split2(s[1][0], s[1][1], oh[2], ol[2]);
      split2(s[1][2], s[1][3], oh[3], ol[3]);
    }

    // (4) y = rd S for this warp's 16 rows and DV / 2 columns (3 terms).
    float y[NT][4], yc2[NT][4];                      // hi hi, and the correction terms
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] = yc2[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4], fh[NT][2], fl[NT][2];
      ldsm_x4(ah, at(rdH, 16 * mt + r1, 2 * ks + h1));
      ldsm_x4(al, at(rdL, 16 * mt + r1, 2 * ks + h1));
      ldsm_b_trans<NT>(fh, sH, 16 * ks, yc, LDV, lane);
      ldsm_b_trans<NT>(fl, sL, 16 * ks, yc, LDV, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(y[nt], ah, fh[nt][0], fh[nt][1]);
        mma_bf16(yc2[nt], ah, fl[nt][0], fl[nt][1]);
        mma_bf16(yc2[nt], al, fh[nt][0], fh[nt][1]);
      }
    }

    // (5) S = e^{cw_Q} o S + kd^T v for the warp's state rows (2 terms).
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      hc[nt][0] *= eq0; hc[nt][1] *= eq0; hc[nt][2] *= eq1; hc[nt][3] *= eq1;
    }
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t ah[4], al[4], f[NS][2];
      ldsm_x4_trans(ah, at(kdH, 16 * ks + r2, srow / 8 + h2));
      ldsm_x4_trans(al, at(kdL, 16 * ks + r2, srow / 8 + h2));
      ldsm_b_trans<NS>(f, vS, 16 * ks, scol / 8, LDV, lane);
#pragma unroll
      for (int nt = 0; nt < NS; ++nt) {
        mma_bf16(hc[nt], ah, f[nt][0], f[nt][1]);
        mma_bf16(hc[nt], al, f[nt][0], f[nt][1]);
      }
    }

    // (c) The scores are written, and every warp has read the old state copy.
    __syncthreads();
    store_state(hc);

    // (6) y += A v: the diagonal block from shared memory (f32, split hi +
    // lo), and for rows 16-31 the factored block from registers (2 terms).
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      if (kk > mt) continue;
      uint32_t ah[4], al[4];
      if (kk == mt) {
        const float* a0 = sA + (16 * mt + g) * LDA + 16 * kk + 2 * tg;
        const float2 x0 = *reinterpret_cast<const float2*>(a0);
        const float2 x1 = *reinterpret_cast<const float2*>(a0 + 8 * LDA);
        const float2 x2 = *reinterpret_cast<const float2*>(a0 + 8);
        const float2 x3 = *reinterpret_cast<const float2*>(a0 + 8 * LDA + 8);
        split2(x0.x, x0.y, ah[0], al[0]);
        split2(x1.x, x1.y, ah[1], al[1]);
        split2(x2.x, x2.y, ah[2], al[2]);
        split2(x3.x, x3.y, ah[3], al[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) { ah[e] = oh[e]; al[e] = ol[e]; }
      }
      uint32_t f[NT][2];
      ldsm_b_trans<NT>(f, vS, 16 * kk, yc, LDV, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mma_bf16(y[nt], ah, f[nt][0], f[nt][1]);
        mma_bf16(yc2[nt], al, f[nt][0], f[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) y[nt][e] += yc2[nt][e];
    {
      const int row = 16 * mt + g;
      float* y0 = p.y + b * p.y_sb + (long long)(t0 + row) * p.y_ss + h * D + col0 + 8 * yc +
                  2 * tg;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (row < nv) *reinterpret_cast<float2*>(y0 + 8 * nt) = make_float2(y[nt][0], y[nt][1]);
        if (row + 8 < nv)
          *reinterpret_cast<float2*>(y0 + 8 * p.y_ss + 8 * nt) = make_float2(y[nt][2], y[nt][3]);
      }
    }
  }

  float* sl = p.s_last + sbase + (srow + g) * D + col0 + scol + 2 * tg;
#pragma unroll
  for (int nt = 0; nt < NS; ++nt) {
    *reinterpret_cast<float2*>(sl + 8 * nt) = make_float2(hc[nt][0], hc[nt][1]);
    *reinterpret_cast<float2*>(sl + 8 * D + 8 * nt) = make_float2(hc[nt][2], hc[nt][3]);
  }
}

cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wkv6_fwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_fwd_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  wkv6_fwd_bf16_kernel<<<dim3(Tile::NSPLIT, p.H, B), THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

int blocks_per_sm() {
  int n = 0;
  cudaFuncSetAttribute(wkv6_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(wkv6_fwd_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv6_fwd_bf16_kernel, THREADS, SMEM) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// S = 1 (a decode step), both dtypes: one step of the recurrence in f32
// ---------------------------------------------------------------------------

namespace dec {

constexpr int D = 64, COLS = 16, THREADS = 128;    // a block: 16 columns, 4 threads x float4

template <typename T>
__global__ void __launch_bounds__(THREADS) wkv6_decode_kernel(const Params p) {
  __shared__ float red[THREADS / 32][5][4];        // per warp: y of 4 x 4 columns, the bonus
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cq = tid & 3, rq = tid >> 2;           // columns 4 cq .. + 3, rows rq and rq + 32
  const int h = blockIdx.y, b = blockIdx.z;
  const int col = blockIdx.x * COLS + 4 * cq;
  const T* rb = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.w + b * p.w_sb + h * p.w_sh;
  const long long sbase = ((long long)b * p.H + h) * D * D;

  float v4[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v4[j] = to_f32(vb[col + j]);
  float y4[4] = {0.f, 0.f, 0.f, 0.f}, bonus = 0.f;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int c = rq + 32 * rr;
    const float rc = to_f32(rb[c]), kc = to_f32(kb[c]), e = expf(wb[c]);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p.s0) s = *reinterpret_cast<const float4*>(p.s0 + sbase + c * D + col);
    y4[0] = fmaf(rc, s.x, y4[0]); y4[1] = fmaf(rc, s.y, y4[1]);
    y4[2] = fmaf(rc, s.z, y4[2]); y4[3] = fmaf(rc, s.w, y4[3]);
    if (cq == 0) bonus = fmaf(rc * p.u[h * D + c], kc, bonus);
    *reinterpret_cast<float4*>(p.s_last + sbase + c * D + col) =
        make_float4(fmaf(e, s.x, kc * v4[0]), fmaf(e, s.y, kc * v4[1]),
                    fmaf(e, s.z, kc * v4[2]), fmaf(e, s.w, kc * v4[3]));
  }
  // Sum over the rows: the lanes of one cq within the warp, then the warps.
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j) y4[j] += __shfl_xor_sync(0xffffffffu, y4[j], off);
    bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][j][lane] = y4[j];
    red[warp][4][lane] = bonus;                      // nonzero in lane 0 only
  }
  __syncthreads();
  if (tid < 4) {
    float bo = 0.f, out[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      bo += red[w][4][0];
#pragma unroll
      for (int j = 0; j < 4; ++j) out[j] += red[w][j][tid];
    }
    *reinterpret_cast<float4*>(p.y + b * p.y_sb + h * D + col) =
        make_float4(fmaf(bo, v4[0], out[0]), fmaf(bo, v4[1], out[1]), fmaf(bo, v4[2], out[2]),
                    fmaf(bo, v4[3], out[3]));
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  wkv6_decode_kernel<T><<<dim3(D / COLS, p.H, B), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace dec

// ---------------------------------------------------------------------------
// f32, S > 1: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int THREADS = 256;     // 16 x 16
constexpr int TR = Q / 16;       // chunk rows per thread

template <int D>
constexpr int smem_bytes() {
  // r, k, v, cw, cw - w, r o e^{cw-w}, k o e^{cw_Q-cw} (Q rows), scores
  // (Q x Q), state (D x D), rows padded by one; u, cw_Q, e^{cw_Q}.
  return (int)((7 * Q * (D + 1) + Q * (Q + 1) + D * (D + 1) + 3 * D) * sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(THREADS) wkv6_fwd_f32_kernel(const Params p) {
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

  const float* rb = static_cast<const float*>(p.r) + b * p.r_sb + h * p.r_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
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
      r_s[t * LD + c] = ok ? rb[pos * p.r_ss + c] : 0.f;
      k_s[t * LD + c] = ok ? kb[pos * p.k_ss + c] : 0.f;
      v_s[t * LD + c] = ok ? vb[pos * p.v_ss + c] : 0.f;
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

template <int D>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(wkv6_fwd_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  wkv6_fwd_f32_kernel<D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Shared memory a block takes at head dim D for dtype (0 = float32, 1 =
// bfloat16) at S > 1 (-1 if unsupported).  The decode kernel takes 320 bytes.
extern "C" int wkv6_fwd_smem_bytes(int D, int dtype) {
  if (D != 64) return -1;
  return dtype == 0 ? f32::smem_bytes<64>() : dtype == 1 ? tc::SMEM : -1;
}

// Blocks of the bf16 kernel that fit one SM (its occupancy), -1 on error.
extern "C" int wkv6_fwd_bf16_blocks_per_sm() { return tc::blocks_per_sm(); }

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of r, k, v and w must be contiguous, u is a contiguous (H, D), y
// a contiguous (B,S,H,D) f32 tensor (its batch and time strides are passed),
// s0 (may be null) and s_last contiguous, 16-byte-aligned (B,H,D,D) f32.
// dtype of r, k, v: 0 = float32, 1 = bfloat16.  S = 1 runs the decode
// kernel; S > 1 the tensor-core kernel for bfloat16 (r, k, v 16-byte
// aligned with batch, time and head strides in multiples of 8; w 16-byte
// aligned with strides in multiples of 4: the wrapper checks) and the
// CUDA-core kernel for float32.  Returns the cudaError_t of the launch.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* s0, void* y, void* s_last,
                        int B, int S, int H, int D,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        long long y_sb, long long y_ss,
                        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != 64 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
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
  if (S == 1) err = dtype == 0 ? dec::launch<float>(p, B, s) : dec::launch<__nv_bfloat16>(p, B, s);
  else err = dtype == 0 ? f32::launch<64>(p, B, s) : tc::launch(p, B, s);
  return (int)err;
}
