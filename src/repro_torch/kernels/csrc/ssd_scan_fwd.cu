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
// What bounds it on the card.  At the zamba2-7b prefill shape (B 4, S 512,
// 112 heads of P = 64, N = 64, bf16) the function moves 67.5 MB (x and y in
// bf16, dt and h_last in f32, B and C once per batch): 0.020 ms at 3.35
// TB/s.  Its chunked products are about 5.7 GFLOP, 0.006 ms on the bf16
// tensor cores.  So the bytes bind.
//
// bf16 design (the serving path; namespace tc): one block of 4 warps per
// (batch, head) walks the chunks of Q = 64 in order; warp w owns chunk rows
// [16w, 16w + 16) of y and state rows p in [16w, 16w + 16) of h.  Against
// the four limits of the earlier CUDA-core kernel (kept below for f32):
//   * Products on the tensor cores.  C B^T, G xdt, C h^T and the state
//     update are mma.sync.m16n8k16 bf16 x bf16 -> f32, with operands moved
//     by ldmatrix / ldmatrix.trans.  C and B are exact bf16, so C B^T is as
//     exact as f32 FMAs.  G = (C B^T) o L never leaves registers: the m16n8
//     accumulator layout is the A-fragment layout of the next m16n8k16, so
//     the decay is applied there (its exponent clamped at 0, so the masked
//     half never exponentiates a positive number) and the mask j <= i on
//     the diagonal tile only; G is rounded to bf16 and multiplied by xdt;
//     tiles above the diagonal are skipped in both products.  C h^T reads h as bf16
//     from shared memory.  These two roundings (G and h to bf16) touch only
//     y, about 2^-9 relative against its bf16 limit of 3e-2.  The state
//     update feeds h_last, held at 2e-5: its operand d o xdt (d_j =
//     exp(cum_Q - cum_j)) is formed in f32 from the ldmatrix.trans fragments
//     and split into hi + lo bf16 halves, two products per k-step (error
//     about 2^-17 relative per term); B is exact bf16.  The carry h stays
//     in f32 registers in the accumulator layout: exp(cum_Q) h is one
//     multiply and the update accumulates onto it.
//   * A load pipeline.  x, B and C of chunk c + 1 are copied by cp.async.cg,
//     16 bytes a thread, into the other of two stages while chunk c
//     computes; rows past S are zero-filled (src-size 0).  dt of the next
//     chunk is loaded into registers one chunk ahead.  Each thread
//     forms xdt = bf16(x * bf16(dt)) in place on the pieces it copied, once
//     they land.
//   * Few barriers.  Each warp scans the chunk's 64 dA values itself with
//     shuffles (no warp waits on another for the cumsum) and writes its y
//     rows from registers.  One barrier per chunk makes the tiles visible;
//     a second keeps the rewrite of the bf16 copy of h behind every warp's
//     read of it (a second copy would save it, but its 8 KB cost the
//     fourth block an SM, which is worth more).
//   * One wave.  Tiles are 64 x 64 bf16 rows of 128 bytes, unpadded, with
//     the 16-byte chunks XOR-swizzled by row so every ldmatrix and cp.async
//     is conflict-free: 2 stages x (x, B, C) + h = 57,344 bytes a block, so
//     four blocks fit an SM (228 KB with 1 KB reserved each) and 448
//     (batch, head) blocks of zamba2-7b prefill are one wave on 132 SMs.
//   The blocks per SM the launch bounds ask for (hence the registers a
//   thread may use) are one `Tile` line, chosen by tools/ssd_tile_sweep.py.
// Inputs need 16-byte-aligned data and batch / time / head strides in
// multiples of 8 elements (the wrapper checks; nothing copies).  dt may have
// any strides.
//
// f32 path (namespace f32): the earlier CUDA-core kernel, kept on purpose.
// The port serves in bf16; f32 runs only in the tests and in the card-vs-CPU
// reference phase of chip_smoke.py, whose limits (y at 2e-5 relative,
// logits at 1e-4) a TF32 or bf16 tensor-core product would miss.  It
// stages xdt, B and C as f32 in shared memory and runs every product as
// FMA loops: one block of 256 threads per (batch, head), 83,968 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;            // timesteps per chunk

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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (P = N = 64)
// ---------------------------------------------------------------------------

namespace tc {

// Blocks per SM the launch bounds ask for: 4 caps a thread at 128
// registers.  Chosen by measurement (tools/ssd_tile_sweep.py rewrites this
// one line).
struct Tile { static constexpr int MIN_BLOCKS = 4; };

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int W = 64;                         // P = N = width of every tile
constexpr int TILE = Q * W;                   // elements of one 64 x 64 tile
// Two stages of x, B and C, then the bf16 copy of h.
constexpr int SMEM = 7 * TILE * 2;

using bf16 = __nv_bfloat16;

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

// x rounded to bf16 and back.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// A bf16 pair scaled by (d0, d1) in f32, split into hi + lo bf16 pairs.
__device__ __forceinline__ void scale_split(uint32_t v, float d0, float d1, uint32_t& hi,
                                            uint32_t& lo) {
  const float a = bf_lo(v) * d0, b = bf_hi(v) * d1;
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// The block's index, read again where it is used.  Base addresses formed
// from blockIdx once are loop invariants that every chunk's register peak
// has to carry (at 128 registers one was spilled); from a volatile read
// they are formed again where they are used, for a few integer operations.
__device__ __forceinline__ unsigned ctaid_x() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned ctaid_y() {
  unsigned v;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(v));
  return v;
}

// Element offset of (row, 16-byte chunk) in a swizzled 64 x 64 tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 3);
}

// Value v_{j} of a per-lane pair (v0 = v_{2 lane}, v1 = v_{2 lane + 1}).
__device__ __forceinline__ float pick(float v0, float v1, int j) {
  const float a = __shfl_sync(0xffffffffu, v0, j >> 1);
  const float b = __shfl_sync(0xffffffffu, v1, j >> 1);
  return (j & 1) ? b : a;
}

__global__ void __launch_bounds__(THREADS, Tile::MIN_BLOCKS)
    ssd_fwd_bf16_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sX = reinterpret_cast<bf16*>(smem_raw);   // 2 stages: x, then xdt in place
  bf16* sB = sX + 2 * TILE;                        // 2 stages
  bf16* sC = sB + 2 * TILE;                        // 2 stages
  bf16* sH = sC + 2 * TILE;                        // bf16 copy of h (p rows, n columns)

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;          // mma row group, thread in group
  const int row0 = 16 * warp + g;                  // this lane's rows: row0 and row0 + 8
  const int S = p.S;
  const float A = p.A[h];

  const long long hbase = ((long long)b * p.H + h) * W * W;

  // Copies of one chunk: 512 pieces of 16 bytes per tile, 4 a thread, all
  // in rows (tid >> 3) + 16 k and chunk tid & 7.
  auto load_chunk = [&](int c, int stage) {
    const long long bi = ctaid_y(), hi = ctaid_x();
    const bf16* xb = static_cast<const bf16*>(p.x) + bi * p.x_sb + hi * p.x_sh;
    const bf16* bb = static_cast<const bf16*>(p.Bm) + bi * p.b_sb;
    const bf16* cb = static_cast<const bf16*>(p.Cm) + bi * p.c_sb;
    const int c0 = c * Q;
    const int nv = min(Q, S - c0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (tid >> 3) + 16 * k, ch = tid & 7;
      const bool ok = r < nv;
      const long long t = ok ? c0 + r : c0;
      const int off = stage * TILE + swz(r, ch);
      cp_async16(smem_u32(sX + off), xb + t * p.x_ss + ch * 8, ok);
      cp_async16(smem_u32(sB + off), bb + t * p.b_ss + ch * 8, ok);
      cp_async16(smem_u32(sC + off), cb + t * p.c_ss + ch * 8, ok);
    }
  };
  // dt of rows 2 lane and 2 lane + 1 of chunk c (0 past S).
  auto load_dt = [&](int c, float& d0, float& d1) {
    const float* dtb = p.dt + (long long)ctaid_y() * p.dt_sb + (long long)ctaid_x() * p.dt_sh;
    const long long t = (long long)c * Q + 2 * lane;
    d0 = t < S ? dtb[t * p.dt_ss] : 0.f;
    d1 = t + 1 < S ? dtb[(t + 1) * p.dt_ss] : 0.f;
  };
  // The bf16 copy of h, rows row0 and row0 + 8 of this lane.
  auto store_h = [&](const float (&hc)[8][4]) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = ((nt ^ g) << 3) + 2 * tg;          // (row0 + 8) & 7 == row0 & 7 == g
      *reinterpret_cast<uint32_t*>(sH + row0 * W + c) = pack_bf16(hc[nt][0], hc[nt][1]);
      *reinterpret_cast<uint32_t*>(sH + (row0 + 8) * W + c) = pack_bf16(hc[nt][2], hc[nt][3]);
    }
  };

  // The carry h (f32) in the m16n8 accumulator layout: state rows p = row0,
  // row0 + 8, columns n = 8 nt + 2 tg + {0, 1}.
  float hc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + 2 * tg;
    float2 v0 = make_float2(0.f, 0.f), v1 = v0;
    if (p.h0) {
      v0 = *reinterpret_cast<const float2*>(p.h0 + hbase + row0 * W + n);
      v1 = *reinterpret_cast<const float2*>(p.h0 + hbase + (row0 + 8) * W + n);
    }
    hc[nt][0] = v0.x; hc[nt][1] = v0.y; hc[nt][2] = v1.x; hc[nt][3] = v1.y;
  }
  store_h(hc);

  // ldmatrix lane addresses.  Pattern 1 (A non-trans, B trans): row lane & 15,
  // chunk + (lane >> 4).  Pattern 2 (B non-trans, A trans): row (lane & 7) +
  // 8 (lane >> 4), chunk + ((lane >> 3) & 1).  Both rows are = lane mod 8.
  const int r1 = lane & 15, h1 = lane >> 4;
  const int r2 = (lane & 7) + ((lane >> 4) << 3), h2 = (lane >> 3) & 1;

  const int nchunks = (S + Q - 1) / Q;
  load_chunk(0, 0);
  cp_async_commit();
  float dn0, dn1;
  load_dt(0, dn0, dn1);

  for (int c = 0; c < nchunks; ++c) {
    const int stage = c & 1;
    const int c0 = c * Q;
    const int nv = min(Q, S - c0);
    const float dt0 = dn0, dt1 = dn1;

    // (1) This chunk's tiles; xdt = bf16(x * bf16(dt)) in place on the
    // pieces this thread copied (dt of row r is in lane r / 2 of every warp).
    cp_async_wait_all();
    {
      const float q0 = round_bf16(dt0), q1 = round_bf16(dt1);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = (tid >> 3) + 16 * k;
        const float d = pick(q0, q1, r);
        uint4* v = reinterpret_cast<uint4*>(sX + stage * TILE + swz(r, tid & 7));
        uint4 u = *v;
        u.x = pack_bf16(bf_lo(u.x) * d, bf_hi(u.x) * d);
        u.y = pack_bf16(bf_lo(u.y) * d, bf_hi(u.y) * d);
        u.z = pack_bf16(bf_lo(u.z) * d, bf_hi(u.z) * d);
        u.w = pack_bf16(bf_lo(u.w) * d, bf_hi(u.w) * d);
        *v = u;
      }
    }
    __syncthreads();

    // (2) The next chunk's copies, in flight while this one computes (its
    // dt is loaded before (8), where fewer registers are live).
    if (c + 1 < nchunks) {
      load_chunk(c + 1, stage ^ 1);
      cp_async_commit();
    }

    // (3) Inclusive cumsum of dA over the chunk, in every warp (two rows a lane).
    const float a0 = dt0 * A, s1 = a0 + dt1 * A;
    float incl = s1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    const float cum0 = excl + a0, cum1 = excl + s1;
    const float cumQ = __shfl_sync(0xffffffffu, cum1, 31);
    const float dend0 = expf(cumQ - cum0), dend1 = expf(cumQ - cum1);
    const float ci0 = pick(cum0, cum1, row0), ci1 = pick(cum0, cum1, row0 + 8);

    const uint32_t xs = smem_u32(sX + stage * TILE);
    const uint32_t bs = smem_u32(sB + stage * TILE);
    const uint32_t hs = smem_u32(sH);
    auto at = [](uint32_t base, int row, int chunk) {
      return base + 2u * static_cast<uint32_t>(swz(row, chunk));
    };

    const uint32_t cs = smem_u32(sC + stage * TILE);

    // (4) G = (C B^T) o L for the column tiles kk <= warp (the rest is
    // above the diagonal), all at once so that their products overlap; the
    // decay on every tile, the mask j <= i only on the diagonal one; then
    // packed to bf16 A fragments, so only 16 registers carry it to (6).
    uint32_t ga[4][4];
    {
      float s[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kk][t][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, at(cs, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk <= warp) {
            uint32_t f[4];
            ldsm_x4(f, at(bs, 16 * kk + r2, 2 * ks + h2));
            mma_bf16(s[kk][0], a, f[0], f[1]);
            mma_bf16(s[kk][1], a, f[2], f[3]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk > warp) continue;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = 16 * kk + 8 * t + 2 * tg;    // columns j, j + 1
          const float cj0 = __shfl_sync(0xffffffffu, cum0, j >> 1);
          const float cj1 = __shfl_sync(0xffffffffu, cum1, j >> 1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float ci = (e >> 1) ? ci1 : ci0, cj = (e & 1) ? cj1 : cj0;
            s[kk][t][e] *= __expf(fminf(ci - cj, 0.f));
            if (kk == warp && j + (e & 1) > row0 + 8 * (e >> 1)) s[kk][t][e] = 0.f;
          }
        }
        ga[kk][0] = pack_bf16(s[kk][0][0], s[kk][0][1]);
        ga[kk][1] = pack_bf16(s[kk][0][2], s[kk][0][3]);
        ga[kk][2] = pack_bf16(s[kk][1][0], s[kk][1][1]);
        ga[kk][3] = pack_bf16(s[kk][1][2], s[kk][1][3]);
      }
    }

    // (5) y = exp(cum_i) C_i . h + G xdt in two halves of 32 columns p (16
    // accumulators each): C as A operand (k = n), h as bf16 B operand (k =
    // n), then G from registers times xdt through ldmatrix.trans (k = j).
    // Each half is written from registers as bf16 pairs.
    {
      const float e0 = expf(ci0), e1 = expf(ci1);
      const bool ok0 = row0 < nv, ok1 = row0 + 8 < nv;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float y[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t a[4];
          ldsm_x4(a, at(cs, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t f[4];
            ldsm_x4(f, at(hs, 16 * (2 * half + np) + r2, 2 * ks + h2));
            mma_bf16(y[2 * np], a, f[0], f[1]);
            mma_bf16(y[2 * np + 1], a, f[2], f[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          y[nt][0] *= e0; y[nt][1] *= e0; y[nt][2] *= e1; y[nt][3] *= e1;
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > warp) continue;
#pragma unroll
          for (int dp = 0; dp < 2; ++dp) {
            uint32_t f[4];
            ldsm_x4_trans(f, at(xs, 16 * kk + r1, 2 * (2 * half + dp) + h1));
            mma_bf16(y[2 * dp], ga[kk], f[0], f[1]);
            mma_bf16(y[2 * dp + 1], ga[kk], f[2], f[3]);
          }
        }
        bf16* y0 = static_cast<bf16*>(p.y) + (long long)ctaid_y() * p.y_sb +
                   (long long)ctaid_x() * W + (long long)(c0 + row0) * p.y_ss + 2 * tg;
        bf16* y1 = y0 + 8 * p.y_ss;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * half + 8 * nt;
          if (ok0) *reinterpret_cast<uint32_t*>(y0 + col) = pack_bf16(y[nt][0], y[nt][1]);
          if (ok1) *reinterpret_cast<uint32_t*>(y1 + col) = pack_bf16(y[nt][2], y[nt][3]);
        }
      }
    }

    if (c + 1 < nchunks) load_dt(c + 1, dn0, dn1);

    // (8) h = exp(cum_Q) h + (d o xdt)^T B for this warp's state rows: A
    // operand (d o xdt)^T by ldmatrix.trans, scaled in f32 and split hi + lo.
    {
      const float eQ = expf(cumQ);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hc[nt][e] *= eQ;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t xa[4], hi[4], lo[4];
        ldsm_x4_trans(xa, at(xs, 16 * ks + r2, 2 * warp + h2));
        // xa[0], xa[1]: j = 16 ks + 2 tg + {0, 1}; xa[2], xa[3]: j + 8.
        const float d00 = __shfl_sync(0xffffffffu, dend0, 8 * ks + tg);
        const float d01 = __shfl_sync(0xffffffffu, dend1, 8 * ks + tg);
        const float d10 = __shfl_sync(0xffffffffu, dend0, 8 * ks + 4 + tg);
        const float d11 = __shfl_sync(0xffffffffu, dend1, 8 * ks + 4 + tg);
        scale_split(xa[0], d00, d01, hi[0], lo[0]);
        scale_split(xa[1], d00, d01, hi[1], lo[1]);
        scale_split(xa[2], d10, d11, hi[2], lo[2]);
        scale_split(xa[3], d10, d11, hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t f[4];
          ldsm_x4_trans(f, at(bs, 16 * ks + r1, 2 * np + h1));
          mma_bf16(hc[2 * np], hi, f[0], f[1]);
          mma_bf16(hc[2 * np], lo, f[0], f[1]);
          mma_bf16(hc[2 * np + 1], hi, f[2], f[3]);
          mma_bf16(hc[2 * np + 1], lo, f[2], f[3]);
        }
      }
    }

    // (9) The bf16 copy of h for the next chunk's (5), once every warp's
    // (5) has read the old one.
    __syncthreads();
    store_h(hc);
  }

  float* hl = p.h_last + ((long long)ctaid_y() * p.H + ctaid_x()) * W * W + row0 * W + 2 * tg;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    *reinterpret_cast<float2*>(hl + 8 * nt) = make_float2(hc[nt][0], hc[nt][1]);
    *reinterpret_cast<float2*>(hl + 8 * W + 8 * nt) = make_float2(hc[nt][2], hc[nt][3]);
  }
}

cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_fwd_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  ssd_fwd_bf16_kernel<<<dim3(p.H, B), THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

int blocks_per_sm() {
  int n = 0;
  cudaFuncSetAttribute(ssd_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(ssd_fwd_bf16_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_fwd_bf16_kernel, THREADS, SMEM) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int THREADS = 256;     // 16 x 16
constexpr int ROWS = Q / 16;     // chunk rows per thread

template <int P, int N>
constexpr int smem_bytes() {
  // xdt, B, C (Q rows), G (Q x Q), h (P x N), rows padded by one; cum,
  // exp(cum), exp(cum_Q - cum).
  return (int)((Q * (P + 1) + 2 * Q * (N + 1) + Q * (Q + 1) + P * (N + 1) + 3 * Q)
               * sizeof(float));
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_fwd_f32_kernel(const Params p) {
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

  const float* xb = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* bb = static_cast<const float*>(p.Bm) + b * p.b_sb;
  const float* cb = static_cast<const float*>(p.Cm) + b * p.c_sb;
  float* yb = static_cast<float*>(p.y) + b * p.y_sb + (long long)h * P;
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
        v = xb[t * p.x_ss + c] * dtb[t * p.dt_ss];
      }
      x_s[r * (P + 1) + c] = v;
    }
    for (int e = threadIdx.x; e < Q * N; e += THREADS) {
      const int r = e / N, c = e % N;
      const long long t = c0 + r;
      b_s[r * (N + 1) + c] = r < nv ? bb[t * p.b_ss + c] : 0.f;
      c_s[r * (N + 1) + c] = r < nv ? cb[t * p.c_ss + c] : 0.f;
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
        float* yrow = yb + (long long)(c0 + i) * p.y_ss;
#pragma unroll
        for (int k = 0; k < YC; ++k)
          yrow[tx + 16 * k] = acc[a][k] + ecum_s[i] * acc2[a][k];
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

template <int P, int N>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes<P, N>();
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_f32_kernel<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  ssd_fwd_f32_kernel<P, N><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Shared memory a block takes at head dim P and state N for dtype
// (0 = float32, 1 = bfloat16); -1 if unsupported.
extern "C" int ssd_scan_fwd_smem_bytes(int P, int N, int dtype) {
  if (P != 64 || N != 64) return -1;
  return dtype == 0 ? f32::smem_bytes<64, 64>() : dtype == 1 ? tc::SMEM : -1;
}

// Blocks of the bf16 kernel that fit one SM (its occupancy), -1 on error.
extern "C" int ssd_scan_fwd_bf16_blocks_per_sm() { return tc::blocks_per_sm(); }

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of x, B and C must be contiguous, and y is a contiguous
// (B,S,H,P) tensor (its batch and time strides are passed).  h0 may be null.
// dtype of x, B, C and y: 0 = float32, 1 = bfloat16; dt, A, h0 and h_last
// are float32.  For bfloat16 the data pointers of x, B and C must be
// 16-byte aligned and their batch, time (and x's head) strides multiples of
// 8 (the wrapper checks).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                            const void* Cm, const void* h0, void* y, void* h_last,
                            int B, int S, int H, int P, int N,
                            long long x_sb, long long x_ss, long long x_sh,
                            long long dt_sb, long long dt_ss, long long dt_sh,
                            long long b_sb, long long b_ss,
                            long long c_sb, long long c_ss,
                            long long y_sb, long long y_ss,
                            int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P != 64 || N != 64) return (int)cudaErrorInvalidValue;
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
  if (dtype == 0) err = f32::launch<64, 64>(p, B, s);
  else if (dtype == 1) err = tc::launch(p, B, s);
  else err = cudaErrorInvalidValue;
  return (int)err;
}
