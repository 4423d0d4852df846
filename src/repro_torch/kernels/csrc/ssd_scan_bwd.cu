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
// Every exponent is <= 0, as in the forward; the masked half of L is never
// exponentiated.
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
// bf16 design (the training path; namespace tc), two kernels in stream order.
// The states kernel recomputes the chunk-start states into a scratch; the
// backward walk carries dh from the last chunk to the first and does the 11
// products of a chunk.  Each block has 4 warps; warp w owns rows [16 w,
// 16 w + 16) of every 64-row product (chunk rows i for dC, rows j for d(xdt)
// and dB, state rows p for the states and dh).
//   * Every product is mma.sync.m16n8k16 bf16 x bf16 -> f32, operands moved
//     by ldmatrix / ldmatrix.trans as in the forward kernel.  B, C, dy and
//     xdt (rounded to bf16 as the forward rounds it) are exact bf16, so C
//     B^T, B C^T, dy xdt^T and xdt dy^T are as exact as f32 FMAs.  Every f32
//     operand of a gradient's path goes in as hi + lo bf16 halves (about
//     2^-17 relative), two products per k-step: G^T, W, W^T, h, dh, the
//     decayed e o dy of the dh update and d o xdt of the state update.
//     Nothing f32 is rounded to a single bf16 operand: tests/
//     test_torch_ssm_train.py emulates this arithmetic on the CPU, holds it
//     to the plain version at the card's limits, and shows that rounding
//     any one of these seven operands to a single bf16 misses them.
//   * G, W and their transposes never leave registers: warp w computes C B^T
//     and dy xdt^T for its rows i (column tiles j <= i), and B C^T and xdt
//     dy^T for its rows j (column tiles i >= j); the decay and mask are
//     applied in the accumulators, whose m16n8 layout is the A-fragment
//     layout of the next product.  The row sums of M come from the first
//     pair, its column sums (as row sums) from the second, both from f32
//     accumulators, so d(cum) of a row is formed in the warp that owns it.
//   * The backward walk stages x, B, C and dy as bf16 (8 KB a 64 x 64 tile,
//     16-byte pieces XOR-swizzled by row, so ldmatrix and cp.async are
//     conflict-free), the chunk-start state's hi / lo tiles and dt, in two
//     stages: chunk c - 1 is copied by cp.async while chunk c computes.  dt
//     comes by cp.async too (a global load held across the chunk stalled it
//     at 255 registers).  Three barriers a chunk.  12 stage tiles, dh's two
//     tiles and 800 bytes of vectors make 115,488 bytes a block: two blocks
//     an SM (8 warps), 255 registers a thread.
//   * The states kernel (the forward walk) copies x, B and dt of chunk c + 1
//     while chunk c computes, 53,248 bytes a block: four blocks an SM, so
//     zamba2-7b's 448 (batch, head) blocks are one wave.  It writes each
//     state as its hi / lo tiles (16 KB, the bytes of the f32 state) in the
//     swizzled layout, staged in shared memory and stored 16 bytes a thread
//     (stored from the accumulator layout, 4 bytes at a time over 8 rows,
//     they were slower); the backward walk copies them back as they lie.
//   * One head a block: each block writes its own (B,S,H,N) partials of dB
//     and dC, and the wrapper sums the 112 of zamba2-7b.
// Inputs need 16-byte-aligned data and batch / time / head strides in
// multiples of 8 elements for x, B, C and dy, and 8-byte-aligned h0 and
// dh_last (the wrapper checks; nothing copies).  dt may have any strides.
//
// What bounds it on the card.  At the zamba2-7b train shape (B 4, S 512,
// 112 heads of P = 64, N = 64, bf16) the function reads x, dy, B, C, dt and
// writes dx, ddt, dB, dC, dh0: 98 MB, 0.029 ms at 3.35 TB/s (chip_smoke.py's
// ssd_bwd_bound), and its products are 14.2 GFLOP, 0.014 ms on the bf16
// tensor cores.  These kernels run 30.1 GFLOP of mma.sync (the splits and
// the transposed pairs: 0.030 ms) and move about 410 MB more than the
// function (x read twice more, 59 MB; the scratch written and read, 117 MB;
// the partials written and read back by the wrapper's sums, 235 MB): 0.15
// ms at 3.35 TB/s.  On an H100 80GB HBM3 at 700 W the wrapper takes 0.38 ms
// (about 0.045 ms the states kernel, 0.28 the backward walk, 0.05 the
// sums).  Latency, not bytes or products, holds the backward walk: its 26.8
// GFLOP run at about 96 TFLOP/s, a tenth of the bf16 peak, in 448 blocks on
// 264 slots (two rounds of 8 warps an SM).
//
// f32 path (namespace f32): the earlier CUDA-core kernel, kept on purpose.
// f32 runs only in the tests and in the card-vs-CPU reference phases of
// chip_smoke.py, whose limits (2e-5) a TF32 or bf16 tensor-core product
// would miss.  One block of 256 threads (16 x 16, a 4 x 4 patch of every
// 64 x 64 product a thread) per (batch, head); a forward walk writes the
// chunk-start states to a (B,H,nc,P,N) f32 scratch; the backward walk does
// every product as f32 FMA loops over operands staged in shared memory
// (rows padded to 65 floats), 139,296 bytes a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;            // timesteps per chunk (the forward's)
constexpr int W = 64;            // P = N

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* h0;               // may be null
  const void* dy;                // contiguous (B,S,H,P)
  const float* dh_last;          // may be null
  void* states;                  // chunk-start states' scratch (each kernel's layout)
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

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (P = N = 64)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int WARPS = 4, THREADS = 32 * WARPS;
constexpr int TILE = Q * W;                   // elements of one 64 x 64 tile
// The tiles of one stage: x (then xdt in place), B, C, dy, and the state at
// the chunk's start as hi and lo bf16 halves.
enum { TX, TB, TC, TDY, THI, TLO, NT };
// Two stages, dh as hi and lo tiles, then five vectors: dt of the chunk, the
// per-row part of d(cum) and the x part of ddt (Q each), the per-warp sums
// of <h, dh> and of the state term (WARPS each).
constexpr int SMEM = (2 * NT + 2) * TILE * 2 + (3 * Q + 2 * WARPS) * 4;
// The states kernel: two stages of x and B tiles and the dt of each
// thread's rows, and the hi / lo tiles of the state it writes out.
constexpr int SMEM_STATES = 2 * (2 * TILE * 2 + 4 * THREADS * 4) + 2 * TILE * 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

// 4 bytes global -> shared (through L1); zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
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

// c += (hi + lo) b: an f32 operand as two bf16 halves, two products.
__device__ __forceinline__ void mma_split(float (&c)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4], uint32_t b0, uint32_t b1) {
  mma_bf16(c, hi, b0, b1);
  mma_bf16(c, lo, b0, b1);
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

// An f32 pair as hi + lo bf16 pairs (about 2^-17 relative).
__device__ __forceinline__ void split(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// The four A fragments of a 16 x 16 f32 tile held as two m16n8 accumulators.
__device__ __forceinline__ void split_frag(const float (&t)[2][4], uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  split(t[0][0], t[0][1], hi[0], lo[0]);
  split(t[0][2], t[0][3], hi[1], lo[1]);
  split(t[1][0], t[1][1], hi[2], lo[2]);
  split(t[1][2], t[1][3], hi[3], lo[3]);
}

// Element offset of (row, 16-byte chunk) in a swizzled 64 x 64 tile.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 3);
}

// Element offset of (row, col) in a swizzled tile.
__device__ __forceinline__ int swz_at(int row, int col) { return swz(row, col >> 3) + (col & 7); }

// Value v_{j} of a per-lane pair (v0 = v_{2 lane}, v1 = v_{2 lane + 1}).
__device__ __forceinline__ float pick(float v0, float v1, int j) {
  const float a = __shfl_sync(0xffffffffu, v0, j >> 1);
  const float b = __shfl_sync(0xffffffffu, v1, j >> 1);
  return (j & 1) ? b : a;
}

// Sum over the 4 lanes of an mma row group (one row of an accumulator).
__device__ __forceinline__ float sum_quad(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A float2 of a dB / dC partial.
__device__ __forceinline__ void put_part(float* q, float a, float b) {
  *reinterpret_cast<float2*>(q) = make_float2(a, b);
}

// The ldmatrix address of (row r, 16-byte chunk ch) of a swizzled tile at base.
__device__ __forceinline__ uint32_t at(uint32_t base, int r, int ch) {
  return base + 2u * static_cast<uint32_t>(swz(r, ch));
}

// Copies of x and B of chunk c of head h into the tiles xt and bt, 16 bytes
// each, rows past S zero-filled; with dt of this thread's rows (tid >> 3) +
// 16 k into dts[4 tid + k] when dts is given (dt values are copied one by
// one: the chunk's time steps of one head lie H apart).
__device__ __forceinline__ void load_xb(const Params& p, int b, int h, int c, bf16* xt,
                                        bf16* bt, float* dts) {
  const int tid = threadIdx.x;
  const bf16* xb = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  const bf16* bb = static_cast<const bf16*>(p.Bm) + b * p.b_sb;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const int c0 = c * Q, nv = min(Q, p.S - c0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (tid >> 3) + 16 * k, ch = tid & 7;
    const bool ok = r < nv;
    const long long t = ok ? c0 + r : c0;
    cp_async16(smem_u32(xt + swz(r, ch)), xb + t * p.x_ss + ch * 8, ok);
    cp_async16(smem_u32(bt + swz(r, ch)), bb + t * p.b_ss + ch * 8, ok);
    if (dts) cp_async4(smem_u32(dts + 4 * tid + k), dtb + t * p.dt_ss, ok);
  }
}

// xdt = bf16(x * bf16(dt)) in place on the pieces this thread copied, rows
// (tid >> 3) + 16 k, whose dt are dr[k].
__device__ __forceinline__ void make_xdt(bf16* xt, const float (&dr)[4]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = (tid >> 3) + 16 * k;
    const float d = round_bf16(dr[k]);
    uint4* v = reinterpret_cast<uint4*>(xt + swz(r, tid & 7));
    uint4 u = *v;
    u.x = pack_bf16(bf_lo(u.x) * d, bf_hi(u.x) * d);
    u.y = pack_bf16(bf_lo(u.y) * d, bf_hi(u.y) * d);
    u.z = pack_bf16(bf_lo(u.z) * d, bf_hi(u.z) * d);
    u.w = pack_bf16(bf_lo(u.w) * d, bf_hi(u.w) * d);
    *v = u;
  }
}

// Inclusive cumsum of dA = dt A over the chunk (two rows a lane: dt0, dt1 of
// rows 2 lane, 2 lane + 1) and its total.
__device__ __forceinline__ void scan(float dt0, float dt1, float A, float& cum0, float& cum1,
                                     float& cumQ) {
  const int lane = threadIdx.x & 31;
  const float a0 = dt0 * A, s1 = a0 + dt1 * A;
  float incl = s1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum0 = excl + a0;
  cum1 = excl + s1;
  cumQ = __shfl_sync(0xffffffffu, cum1, 31);
}

// A (P, N) f32 state in the accumulator layout of warp w (rows 16 w + g and
// 16 w + g + 8, columns 8 nt + 2 tg + {0, 1}): read from src (zero if
// null), and written as hi and lo bf16 tiles, swizzled.
__device__ __forceinline__ void read_state(const float* src, float (&v)[8][4]) {
  const int lane = threadIdx.x & 31, row0 = 16 * (threadIdx.x >> 5) + (lane >> 2);
  const int tg = lane & 3;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    float2 a = make_float2(0.f, 0.f), c = a;
    if (src) {
      a = *reinterpret_cast<const float2*>(src + row0 * W + 8 * nt + 2 * tg);
      c = *reinterpret_cast<const float2*>(src + (row0 + 8) * W + 8 * nt + 2 * tg);
    }
    v[nt][0] = a.x; v[nt][1] = a.y; v[nt][2] = c.x; v[nt][3] = c.y;
  }
}

__device__ __forceinline__ void write_split(bf16* hi, bf16* lo, const float (&v)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int row0 = 16 * (threadIdx.x >> 5) + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = ((nt ^ g) << 3) + 2 * tg;          // (row0 + 8) & 7 == row0 & 7 == g
    uint32_t a, c;
    split(v[nt][0], v[nt][1], a, c);
    *reinterpret_cast<uint32_t*>(hi + row0 * W + col) = a;
    *reinterpret_cast<uint32_t*>(lo + row0 * W + col) = c;
    split(v[nt][2], v[nt][3], a, c);
    *reinterpret_cast<uint32_t*>(hi + (row0 + 8) * W + col) = a;
    *reinterpret_cast<uint32_t*>(lo + (row0 + 8) * W + col) = c;
  }
}

// The chunk-start states, one (batch, head) a block, into the scratch: (B,
// H, nc) states, each as hi and lo tiles in the swizzled layout.  h =
// exp(cum_Q) h + (d o xdt)^T B, d_j = exp(cum_Q - cum_j): the forward
// kernel's state update (warp w: state rows 16 w ..), A operand (d o xdt)^T
// by ldmatrix.trans, split hi + lo.  The last chunk's end state is not
// needed.
__global__ void __launch_bounds__(THREADS, 4) ssd_bwd_states_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const xb_s = reinterpret_cast<bf16*>(smem_raw);               // 2 stages of x, B
  float* const fdt = reinterpret_cast<float*>(xb_s + 4 * TILE);        // 2 stages of 4 x THREADS
  bf16* const out_s = reinterpret_cast<bf16*>(fdt + 2 * 4 * THREADS);  // hi, lo
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, tg = lane & 3;
  const int r1 = lane & 15, h1 = lane >> 4;
  const int r2 = (lane & 7) + ((lane >> 4) << 3), h2 = (lane >> 3) & 1;
  const int nc = p.nc;
  const float A = p.A[h];
  const long long hbase = ((long long)b * p.H + h) * W * W;
  bf16* const scratch = static_cast<bf16*>(p.states) + ((long long)b * p.H + h) * nc * 2 * TILE;
  // State c as hi / lo tiles into out_s, then 16-byte pieces into the
  // scratch (the accumulator layout scatters 4-byte pieces over 8 rows: as
  // global stores they took most of this kernel's time).  The caller's next
  // barrier keeps the next write of out_s behind these reads.
  auto put_state = [&](int c, const float (&v)[8][4]) {
    write_split(out_s, out_s + TILE, v);
    __syncthreads();
    const uint4* src = reinterpret_cast<const uint4*>(out_s);
    uint4* dst = reinterpret_cast<uint4*>(scratch + (long long)c * 2 * TILE);
#pragma unroll
    for (int k = 0; k < 2 * TILE / (8 * THREADS); ++k) dst[tid + THREADS * k] = src[tid + THREADS * k];
  };

  float hc[8][4];
  read_state(p.h0 ? p.h0 + hbase : nullptr, hc);
  put_state(0, hc);
  if (nc > 1) {
    load_xb(p, b, h, 0, xb_s, xb_s + TILE, fdt);
    cp_async_commit();
  }
  for (int c = 0; c + 1 < nc; ++c) {
    const int st = c & 1;
    bf16* const xt = xb_s + 2 * st * TILE;
    const float* const dts = fdt + st * 4 * THREADS;
    cp_async_wait_all();
    {
      const float4 d = *reinterpret_cast<const float4*>(dts + 4 * tid);
      const float dr[4] = {d.x, d.y, d.z, d.w};
      make_xdt(xt, dr);
    }
    __syncthreads();
    // dt of rows 2 lane and 2 lane + 1, from the copies of the threads that
    // copied those rows (row r: thread 8 (r & 15), its k = r >> 4)
    const float dt0 = dts[32 * ((2 * lane) & 15) + ((2 * lane) >> 4)];
    const float dt1 = dts[32 * ((2 * lane + 1) & 15) + ((2 * lane + 1) >> 4)];
    // chunk c + 1 into the stage chunk c - 1 read before the barrier; the
    // last chunk's end state is not needed
    if (c + 2 < nc) {
      load_xb(p, b, h, c + 1, xb_s + 2 * (st ^ 1) * TILE, xb_s + (2 * (st ^ 1) + 1) * TILE,
              fdt + (st ^ 1) * 4 * THREADS);
      cp_async_commit();
    }
    float cum0, cum1, cumQ;
    scan(dt0, dt1, A, cum0, cum1, cumQ);
    const float dend0 = expf(cumQ - cum0), dend1 = expf(cumQ - cum1);
    const float eQ = expf(cumQ);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) hc[nt][e] *= eQ;
    const uint32_t xs = smem_u32(xt), bs = smem_u32(xt + TILE);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t xa[4], hi[4], lo[4];
      ldsm_x4_trans(xa, at(xs, 16 * ks + r2, 2 * warp + h2));
      // xa[0], xa[1]: j = 16 ks + 2 tg + {0, 1}; xa[2], xa[3]: j + 8.
      const float d00 = __shfl_sync(0xffffffffu, dend0, 8 * ks + tg);
      const float d01 = __shfl_sync(0xffffffffu, dend1, 8 * ks + tg);
      const float d10 = __shfl_sync(0xffffffffu, dend0, 8 * ks + 4 + tg);
      const float d11 = __shfl_sync(0xffffffffu, dend1, 8 * ks + 4 + tg);
      split(bf_lo(xa[0]) * d00, bf_hi(xa[0]) * d01, hi[0], lo[0]);
      split(bf_lo(xa[1]) * d00, bf_hi(xa[1]) * d01, hi[1], lo[1]);
      split(bf_lo(xa[2]) * d10, bf_hi(xa[2]) * d11, hi[2], lo[2]);
      split(bf_lo(xa[3]) * d10, bf_hi(xa[3]) * d11, hi[3], lo[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t f[4];
        ldsm_x4_trans(f, at(bs, 16 * ks + r1, 2 * np + h1));
        mma_split(hc[2 * np], hi, lo, f[0], f[1]);
        mma_split(hc[2 * np + 1], hi, lo, f[2], f[3]);
      }
    }
    put_state(c + 1, hc);
  }
}

// The backward walk, a block per (head, batch), from the last chunk to the
// first, reading the chunk-start states from the scratch.
__global__ void __launch_bounds__(THREADS, 2) ssd_bwd_bf16_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* const sT = reinterpret_cast<bf16*>(smem_raw);        // 2 stages of NT tiles
  bf16* const sDh = sT + 2 * NT * TILE;                      // dh: hi, lo
  float* const dt_s = reinterpret_cast<float*>(sDh + 2 * TILE);
  float* const dpart_s = dt_s + Q;
  float* const xp_s = dpart_s + Q;
  float* const hdh_s = xp_s + Q;
  float* const kst_s = hdh_s + WARPS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;          // mma row group, thread in group
  const int row0 = 16 * warp + g;                  // this lane's rows: row0 and row0 + 8
  const int S = p.S, H = p.H, nc = p.nc;
  // ldmatrix lane addresses.  Pattern 1 (A non-trans, B trans): row lane & 15,
  // chunk + (lane >> 4).  Pattern 2 (B non-trans, A trans): row (lane & 7) +
  // 8 (lane >> 4), chunk + ((lane >> 3) & 1).
  const int r1 = lane & 15, h1 = lane >> 4;
  const int r2 = (lane & 7) + ((lane >> 4) << 3), h2 = (lane >> 3) & 1;

  const long long row = (long long)H * W;          // time stride of dy, dx and the partials
  float* const dBb = p.dB_part + ((long long)b * p.S * H + h) * W;
  float* const dCb = p.dC_part + ((long long)b * p.S * H + h) * W;

  auto tp = [&](int st, int k) { return sT + (st * NT + k) * TILE; };
  auto ld32 = [](const bf16* t, int r, int col) {
    return *reinterpret_cast<const uint32_t*>(t + swz_at(r, col));
  };

  // Copies of chunk c into stage st, rows past S zero-filled: x,
  // B, C, dy and the chunk-start state (copied as it lies in the scratch),
  // 16 bytes each, and dt into dt_s.
  auto load_chunk = [&](int c, int st) {
    load_xb(p, b, h, c, tp(st, TX), tp(st, TB), nullptr);
    const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
    const bf16* cb = static_cast<const bf16*>(p.Cm) + b * p.c_sb;
    const bf16* dyb = static_cast<const bf16*>(p.dy) + ((long long)b * S * H + h) * W;
    const int c0 = c * Q, nv = min(Q, S - c0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (tid >> 3) + 16 * k, ch = tid & 7;
      const bool ok = r < nv;
      const long long t = ok ? c0 + r : c0;
      const int off = swz(r, ch);
      cp_async16(smem_u32(tp(st, TC) + off), cb + t * p.c_ss + ch * 8, ok);
      cp_async16(smem_u32(tp(st, TDY) + off), dyb + t * row + ch * 8, ok);
    }
    if (tid < Q)
      cp_async4(smem_u32(dt_s + tid), dtb + (long long)(tid < nv ? c0 + tid : c0) * p.dt_ss,
                tid < nv);
    const bf16* hs =
        static_cast<const bf16*>(p.states) + (((long long)b * H + h) * nc + c) * 2 * TILE;
#pragma unroll
    for (int k = 0; k < 2 * TILE / (8 * THREADS); ++k) {
      const int e = 8 * (tid + THREADS * k);
      cp_async16(smem_u32(tp(st, THI) + e), hs + e, true);
    }
  };

  const float A = p.A[h];
  const long long hbase = ((long long)b * H + h) * W * W;

  // ---- Backward walk, carrying dh (f32, the accumulator layout: state
  // rows p = row0, row0 + 8 of warp w) and its hi / lo tiles. ----
  float dhc[8][4];
  read_state(p.dh_last ? p.dh_last + hbase : nullptr, dhc);
  write_split(sDh, sDh + TILE, dhc);
  float dA_acc = 0.f;                    // warp 0, lane 0: sum of d(dA) dt
  const bf16* xg = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh;
  bf16* dxg = static_cast<bf16*>(p.dx) + ((long long)b * S * H + h) * W;
  load_chunk(nc - 1, 0);
  cp_async_commit();

  for (int it = 0; it < nc; ++it) {
    const int c = nc - 1 - it, st = it & 1;
    const int c0 = c * Q, nv = min(Q, S - c0);
    cp_async_wait_all();
    __syncthreads();                     // this chunk's copies and the dh tiles
    const float dt0 = dt_s[2 * lane], dt1 = dt_s[2 * lane + 1];
    {
      const int r = tid >> 3;
      const float dr[4] = {dt_s[r], dt_s[r + 16], dt_s[r + 32], dt_s[r + 48]};
      make_xdt(tp(st, TX), dr);
    }
    __syncthreads();                     // xdt, and every read of dt_s
    if (c > 0) {
      load_chunk(c - 1, st ^ 1);
      cp_async_commit();
    }
    float cum0, cum1, cumQ;
    scan(dt0, dt1, A, cum0, cum1, cumQ);
    // Own rows' cum, exp(cum) and exp(cum_Q - cum): rows i in (A), j in (B).
    const float cr0 = pick(cum0, cum1, row0), cr1 = pick(cum0, cum1, row0 + 8);
    const float ei0 = expf(cr0), ei1 = expf(cr1);
    const float de0 = expf(cumQ - cr0), de1 = expf(cumQ - cr1);

    const uint32_t xs = smem_u32(tp(st, TX)), bs = smem_u32(tp(st, TB));
    const uint32_t cs = smem_u32(tp(st, TC)), ys = smem_u32(tp(st, TDY));
    const uint32_t hhs = smem_u32(tp(st, THI)), hls = smem_u32(tp(st, TLO));
    const uint32_t dhs = smem_u32(sDh), dls = smem_u32(sDh + TILE);

    // (A) Rows i of this warp.  C B^T and dy xdt^T over the column tiles
    // kk <= warp (the rest is above the diagonal); L = exp(cum_i - cum_j)
    // (exponent clamped at 0, the mask on the diagonal tile), G = (C B^T)
    // o L, W = L o (dy xdt^T), the row sums of M = G o (dy xdt^T) from the
    // f32 accumulators; W kept as hi / lo A fragments.  Then
    //   dC_i = sum_j W_ij B_j + exp(cum_i) dy_i^T h,
    // and the inter term exp(cum_i) C_i . (dy_i^T h) of d(cum).
    float rowm0 = 0.f, rowm1 = 0.f, inter0 = 0.f, inter1 = 0.f;
    {
      uint32_t wh[4][4], wl[4][4];
      {
        float sc[4][2][4], sd[4][2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[kk][t][e] = sd[kk][t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ac[4], ad[4];
          ldsm_x4(ac, at(cs, 16 * warp + r1, 2 * ks + h1));
          ldsm_x4(ad, at(ys, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk <= warp) {
              uint32_t fb[4], fx[4];
              ldsm_x4(fb, at(bs, 16 * kk + r2, 2 * ks + h2));
              ldsm_x4(fx, at(xs, 16 * kk + r2, 2 * ks + h2));
              mma_bf16(sc[kk][0], ac, fb[0], fb[1]);
              mma_bf16(sc[kk][1], ac, fb[2], fb[3]);
              mma_bf16(sd[kk][0], ad, fx[0], fx[1]);
              mma_bf16(sd[kk][1], ad, fx[2], fx[3]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > warp) continue;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int j = 16 * kk + 8 * t + 2 * tg;        // columns j, j + 1
            const float cj0 = __shfl_sync(0xffffffffu, cum0, j >> 1);
            const float cj1 = __shfl_sync(0xffffffffu, cum1, j >> 1);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ci = (e >> 1) ? cr1 : cr0, cj = (e & 1) ? cj1 : cj0;
              float L = __expf(fminf(ci - cj, 0.f));
              if (kk == warp && j + (e & 1) > row0 + 8 * (e >> 1)) L = 0.f;
              const float m = sc[kk][t][e] * L * sd[kk][t][e];
              if (e >> 1) rowm1 += m; else rowm0 += m;
              sd[kk][t][e] *= L;
            }
          }
          split_frag(sd[kk], wh[kk], wl[kk]);
        }
      }
      const bf16* ct = tp(st, TC);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float aw[4][4], ah[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) aw[nt][e] = ah[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk > warp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t f[4];
            ldsm_x4_trans(f, at(bs, 16 * kk + r1, 2 * (2 * half + np) + h1));
            mma_split(aw[2 * np], wh[kk], wl[kk], f[0], f[1]);
            mma_split(aw[2 * np + 1], wh[kk], wl[kk], f[2], f[3]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ad[4];
          ldsm_x4(ad, at(ys, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t fh[4], fl[4];
            ldsm_x4_trans(fh, at(hhs, 16 * ks + r1, 2 * (2 * half + np) + h1));
            ldsm_x4_trans(fl, at(hls, 16 * ks + r1, 2 * (2 * half + np) + h1));
            mma_bf16(ah[2 * np], ad, fh[0], fh[1]);
            mma_bf16(ah[2 * np], ad, fl[0], fl[1]);
            mma_bf16(ah[2 * np + 1], ad, fh[2], fh[3]);
            mma_bf16(ah[2 * np + 1], ad, fl[2], fl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = 32 * half + 8 * nt + 2 * tg;
          const uint32_t cv0 = ld32(ct, row0, n), cv1 = ld32(ct, row0 + 8, n);
          const float d00 = ei0 * ah[nt][0], d01 = ei0 * ah[nt][1];
          const float d10 = ei1 * ah[nt][2], d11 = ei1 * ah[nt][3];
          inter0 = fmaf(d01, bf_hi(cv0), fmaf(d00, bf_lo(cv0), inter0));
          inter1 = fmaf(d11, bf_hi(cv1), fmaf(d10, bf_lo(cv1), inter1));
          if (row0 < nv)
            put_part(dCb + (c0 + row0) * row + n, aw[nt][0] + d00, aw[nt][1] + d01);
          if (row0 + 8 < nv)
            put_part(dCb + (c0 + row0 + 8) * row + n, aw[nt][2] + d10, aw[nt][3] + d11);
        }
      }
    }

    // (B) Rows j of this warp.  B C^T and xdt dy^T over the column tiles
    // kk >= warp: G^T and W^T (the mask and decay transposed), whose
    // products feed the column sums of M (as row sums here) and become
    // hi / lo A fragments.  Then
    //   d(xdt)_j = sum_i G_ij dy_i + exp(cum_Q - cum_j) dh B_j,
    // rounded to bf16: dx and the x part of ddt; and
    //   dB_j = sum_i W_ij C_i + exp(cum_Q - cum_j) xdt_j^T dh,
    // with the state term exp(cum_Q - cum_j) B_j . (xdt_j^T dh) of d(cum).
    float colm0 = 0.f, colm1 = 0.f, xp0 = 0.f, xp1 = 0.f, ks0 = 0.f, ks1 = 0.f;
    {
      uint32_t gh[4][4], gl[4][4], th[4][4], tl[4][4];
      {
        float sb[4][2][4], sx[4][2][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) sb[kk][t][e] = sx[kk][t][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ab[4], ax[4];
          ldsm_x4(ab, at(bs, 16 * warp + r1, 2 * ks + h1));
          ldsm_x4(ax, at(xs, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            if (kk >= warp) {
              uint32_t fc[4], fy[4];
              ldsm_x4(fc, at(cs, 16 * kk + r2, 2 * ks + h2));
              ldsm_x4(fy, at(ys, 16 * kk + r2, 2 * ks + h2));
              mma_bf16(sb[kk][0], ab, fc[0], fc[1]);
              mma_bf16(sb[kk][1], ab, fc[2], fc[3]);
              mma_bf16(sx[kk][0], ax, fy[0], fy[1]);
              mma_bf16(sx[kk][1], ax, fy[2], fy[3]);
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < warp) continue;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            const int i = 16 * kk + 8 * t + 2 * tg;        // columns i, i + 1
            const float ci0 = __shfl_sync(0xffffffffu, cum0, i >> 1);
            const float ci1 = __shfl_sync(0xffffffffu, cum1, i >> 1);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float cj = (e >> 1) ? cr1 : cr0, ci = (e & 1) ? ci1 : ci0;
              float L = __expf(fminf(ci - cj, 0.f));
              if (kk == warp && i + (e & 1) < row0 + 8 * (e >> 1)) L = 0.f;
              sb[kk][t][e] *= L;
              const float m = sb[kk][t][e] * sx[kk][t][e];
              if (e >> 1) colm1 += m; else colm0 += m;
              sx[kk][t][e] *= L;
            }
          }
          split_frag(sb[kk], gh[kk], gl[kk]);
          split_frag(sx[kk], th[kk], tl[kk]);
        }
      }
      const float dq0 = round_bf16(pick(dt0, dt1, row0));
      const float dq1 = round_bf16(pick(dt0, dt1, row0 + 8));
      const bf16* x0 = xg + (long long)(c0 + row0) * p.x_ss;
      const bf16* x1 = x0 + 8 * p.x_ss;
      bf16* dx0 = dxg + (long long)(c0 + row0) * row;
      bf16* dx1 = dx0 + 8 * row;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        // x of this lane's elements for the x part of ddt, loaded before the
        // products so that its latency hides behind them (rows past S read
        // a valid row and are not used)
        uint32_t xv0[4], xv1[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int pp = 32 * half + 8 * nt + 2 * tg;
          xv0[nt] = *reinterpret_cast<const uint32_t*>((row0 < nv ? x0 : xg + c0 * p.x_ss) + pp);
          xv1[nt] = *reinterpret_cast<const uint32_t*>((row0 + 8 < nv ? x1 : xg + c0 * p.x_ss) + pp);
        }
        float ag[4][4], ab2[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) ag[nt][e] = ab2[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < warp) continue;
#pragma unroll
          for (int dp = 0; dp < 2; ++dp) {
            uint32_t f[4];
            ldsm_x4_trans(f, at(ys, 16 * kk + r1, 2 * (2 * half + dp) + h1));
            mma_split(ag[2 * dp], gh[kk], gl[kk], f[0], f[1]);
            mma_split(ag[2 * dp + 1], gh[kk], gl[kk], f[2], f[3]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ab[4];
          ldsm_x4(ab, at(bs, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t fh[4], fl[4];
            ldsm_x4(fh, at(dhs, 16 * (2 * half + np) + r2, 2 * ks + h2));
            ldsm_x4(fl, at(dls, 16 * (2 * half + np) + r2, 2 * ks + h2));
            mma_bf16(ab2[2 * np], ab, fh[0], fh[1]);
            mma_bf16(ab2[2 * np], ab, fl[0], fl[1]);
            mma_bf16(ab2[2 * np + 1], ab, fh[2], fh[3]);
            mma_bf16(ab2[2 * np + 1], ab, fl[2], fl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int pp = 32 * half + 8 * nt + 2 * tg;
          const float g00 = round_bf16(ag[nt][0] + de0 * ab2[nt][0]);
          const float g01 = round_bf16(ag[nt][1] + de0 * ab2[nt][1]);
          const float g10 = round_bf16(ag[nt][2] + de1 * ab2[nt][2]);
          const float g11 = round_bf16(ag[nt][3] + de1 * ab2[nt][3]);
          if (row0 < nv) {
            xp0 = fmaf(g01, bf_hi(xv0[nt]), fmaf(g00, bf_lo(xv0[nt]), xp0));
            *reinterpret_cast<uint32_t*>(dx0 + pp) = pack_bf16(g00 * dq0, g01 * dq0);
          }
          if (row0 + 8 < nv) {
            xp1 = fmaf(g11, bf_hi(xv1[nt]), fmaf(g10, bf_lo(xv1[nt]), xp1));
            *reinterpret_cast<uint32_t*>(dx1 + pp) = pack_bf16(g10 * dq1, g11 * dq1);
          }
        }
      }
      const bf16* bt = tp(st, TB);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float aw[4][4], ax2[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) aw[nt][e] = ax2[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < warp) continue;
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t f[4];
            ldsm_x4_trans(f, at(cs, 16 * kk + r1, 2 * (2 * half + np) + h1));
            mma_split(aw[2 * np], th[kk], tl[kk], f[0], f[1]);
            mma_split(aw[2 * np + 1], th[kk], tl[kk], f[2], f[3]);
          }
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          uint32_t ax[4];
          ldsm_x4(ax, at(xs, 16 * warp + r1, 2 * ks + h1));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t fh[4], fl[4];
            ldsm_x4_trans(fh, at(dhs, 16 * ks + r1, 2 * (2 * half + np) + h1));
            ldsm_x4_trans(fl, at(dls, 16 * ks + r1, 2 * (2 * half + np) + h1));
            mma_bf16(ax2[2 * np], ax, fh[0], fh[1]);
            mma_bf16(ax2[2 * np], ax, fl[0], fl[1]);
            mma_bf16(ax2[2 * np + 1], ax, fh[2], fh[3]);
            mma_bf16(ax2[2 * np + 1], ax, fl[2], fl[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = 32 * half + 8 * nt + 2 * tg;
          const uint32_t bv0 = ld32(bt, row0, n), bv1 = ld32(bt, row0 + 8, n);
          ks0 = fmaf(ax2[nt][1], bf_hi(bv0), fmaf(ax2[nt][0], bf_lo(bv0), ks0));
          ks1 = fmaf(ax2[nt][3], bf_hi(bv1), fmaf(ax2[nt][2], bf_lo(bv1), ks1));
          if (row0 < nv)
            put_part(dBb + (c0 + row0) * row + n, aw[nt][0] + de0 * ax2[nt][0],
                     aw[nt][1] + de0 * ax2[nt][1]);
          if (row0 + 8 < nv)
            put_part(dBb + (c0 + row0 + 8) * row + n, aw[nt][2] + de1 * ax2[nt][2],
                     aw[nt][3] + de1 * ax2[nt][3]);
        }
      }
    }

    // <h, dh> (dh before this chunk's update) over this warp's state rows.
    {
      const bf16* hh = tp(st, THI);
      const bf16* hl = tp(st, TLO);
      float hdh = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = ((nt ^ g) << 3) + 2 * tg;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = (row0 + 8 * r) * W + col;
          const uint32_t a = *reinterpret_cast<const uint32_t*>(hh + o);
          const uint32_t c = *reinterpret_cast<const uint32_t*>(hl + o);
          hdh = fmaf(bf_lo(a) + bf_lo(c), dhc[nt][2 * r], hdh);
          hdh = fmaf(bf_hi(a) + bf_hi(c), dhc[nt][2 * r + 1], hdh);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) hdh += __shfl_xor_sync(0xffffffffu, hdh, off);
      if (lane == 0) hdh_s[warp] = hdh;
    }
    // This warp's rows of d(cum) without the chunk-wide terms of its last row.
    {
      rowm0 = sum_quad(rowm0); rowm1 = sum_quad(rowm1);
      colm0 = sum_quad(colm0); colm1 = sum_quad(colm1);
      inter0 = sum_quad(inter0); inter1 = sum_quad(inter1);
      xp0 = sum_quad(xp0); xp1 = sum_quad(xp1);
      const float kst0 = de0 * sum_quad(ks0), kst1 = de1 * sum_quad(ks1);
      if (tg == 0) {
        dpart_s[row0] = rowm0 - colm0 + inter0 - kst0;
        dpart_s[row0 + 8] = rowm1 - colm1 + inter1 - kst1;
        xp_s[row0] = xp0;
        xp_s[row0 + 8] = xp1;
      }
      float kw = kst0 + kst1;            // the same on the 4 lanes of a group
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) kw += __shfl_xor_sync(0xffffffffu, kw, off);
      if (lane == 0) kst_s[warp] = kw;
    }
    __syncthreads();                     // every read of the dh tiles is done; the parts are in

    // (C) dh = exp(cum_Q) dh + sum_i exp(cum_i) dy_i^T C_i for this warp's
    // state rows: A operand (e o dy)^T by ldmatrix.trans, scaled in f32 and
    // split hi + lo; then its hi / lo tiles for the next chunk.
    const float eQ = expf(cumQ);
    {
      const float ecum0 = expf(cum0), ecum1 = expf(cum1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dhc[nt][e] *= eQ;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t ya[4], hi[4], lo[4];
        ldsm_x4_trans(ya, at(ys, 16 * ks + r2, 2 * warp + h2));
        const float e00 = __shfl_sync(0xffffffffu, ecum0, 8 * ks + tg);
        const float e01 = __shfl_sync(0xffffffffu, ecum1, 8 * ks + tg);
        const float e10 = __shfl_sync(0xffffffffu, ecum0, 8 * ks + 4 + tg);
        const float e11 = __shfl_sync(0xffffffffu, ecum1, 8 * ks + 4 + tg);
        split(bf_lo(ya[0]) * e00, bf_hi(ya[0]) * e01, hi[0], lo[0]);
        split(bf_lo(ya[1]) * e00, bf_hi(ya[1]) * e01, hi[1], lo[1]);
        split(bf_lo(ya[2]) * e10, bf_hi(ya[2]) * e11, hi[2], lo[2]);
        split(bf_lo(ya[3]) * e10, bf_hi(ya[3]) * e11, hi[3], lo[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t f[4];
          ldsm_x4_trans(f, at(cs, 16 * ks + r1, 2 * np + h1));
          mma_split(dhc[2 * np], hi, lo, f[0], f[1]);
          mma_split(dhc[2 * np + 1], hi, lo, f[2], f[3]);
        }
      }
      write_split(sDh, sDh + TILE, dhc);
    }

    // (D) d(cum) with the last row's chunk-wide terms, its reverse cumsum
    // d(dA), then ddt and the dA share (warp 0, two rows a lane).
    if (warp == 0) {
      const float hsum = ((hdh_s[0] + hdh_s[1]) + hdh_s[2]) + hdh_s[3];
      const float ksum = ((kst_s[0] + kst_s[1]) + kst_s[2]) + kst_s[3];
      float d[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int i = 2 * lane + q;
        d[q] = dpart_s[i];
        if (i == nv - 1) d[q] += eQ * hsum + ksum;
      }
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
        const float gq = q ? g1 : g0;
        if (i < nv) {
          p.ddt[((long long)b * S + c0 + i) * H + h] = xp_s[i] + gq * A;
          share = fmaf(gq, q ? dt1 : dt0, share);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) share += __shfl_xor_sync(0xffffffffu, share, off);
      if (lane == 0) dA_acc += share;
    }
  }

  float* dh0 = p.dh0 + hbase;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = 8 * nt + 2 * tg;
    *reinterpret_cast<float2*>(dh0 + row0 * W + n) = make_float2(dhc[nt][0], dhc[nt][1]);
    *reinterpret_cast<float2*>(dh0 + (row0 + 8) * W + n) = make_float2(dhc[nt][2], dhc[nt][3]);
  }
  if (tid == 0) p.dA_part[(long long)b * H + h] = dA_acc;
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The states kernel, then the backward walk, in stream order.
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = prepare(ssd_bwd_states_kernel, SMEM_STATES);
  if (err != cudaSuccess) return err;
  err = prepare(ssd_bwd_bf16_kernel, SMEM);
  if (err != cudaSuccess) return err;
  ssd_bwd_states_kernel<<<dim3(p.H, B), THREADS, SMEM_STATES, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_bf16_kernel<<<dim3(p.H, B), THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Blocks an SM of the backward walk (kernel 0) or the states kernel (1).
int blocks_per_sm(int kernel) {
  int n = 0;
  cudaError_t err = kernel == 0
      ? prepare(ssd_bwd_bf16_kernel, SMEM)
      : prepare(ssd_bwd_states_kernel, SMEM_STATES);
  if (err != cudaSuccess) return -1;
  err = kernel == 0
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_bwd_bf16_kernel, THREADS, SMEM)
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_bwd_states_kernel, THREADS,
                                                      SMEM_STATES);
  return err == cudaSuccess ? n : -1;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: CUDA-core kernel
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int LD = W + 1;        // padded row of a staged 64-wide tile
constexpr int THREADS = 256;     // 16 x 16
constexpr int R = 4;             // rows (and columns) of a thread's patch

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

__global__ void __launch_bounds__(THREADS) ssd_bwd_f32_kernel(const Params p) {
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

  const float* xb = static_cast<const float*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* bb = static_cast<const float*>(p.Bm) + b * p.b_sb;
  const float* cb = static_cast<const float*>(p.Cm) + b * p.c_sb;
  const float* dyb = static_cast<const float*>(p.dy) + ((long long)b * S * H + h) * W;
  float* dxb = static_cast<float*>(p.dx) + ((long long)b * S * H + h) * W;
  const long long row = (long long)H * W;          // time stride of dy, dx, dB/dC partials
  const long long hbase = ((long long)b * H + h) * W * W;
  float* states = static_cast<float*>(p.states) + hbase * p.nc;

  // Stage rows [c0, c0 + nv) of xdt (and dy) and B (and C) and dt, dA; rows
  // past S are zero (dt = 0 too, so the padded steps change nothing).
  auto stage = [&](int c0, int nv, bool with_dy) {
    for (int e = tid; e < Q * W; e += THREADS) {
      const int r = e / W, c = e % W;
      const long long t = c0 + r;
      const bool ok = r < nv;
      x_s[r * LD + c] = ok ? xb[t * p.x_ss + c] * dtb[t * p.dt_ss] : 0.f;
      b_s[r * LD + c] = ok ? bb[t * p.b_ss + c] : 0.f;
      if (with_dy) {
        dy_s[r * LD + c] = ok ? dyb[t * row + c] : 0.f;
        c_s[r * LD + c] = ok ? cb[t * p.c_ss + c] : 0.f;
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
        const float dtr = dt_s[j];
        float xp = 0.f;
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int pp = tx + 16 * k;
          const float g = acc[a][k] + dend_s[j] * acc2[a][k];
          if (ok) {
            xp = fmaf(g, xb[t * p.x_ss + pp], xp);
            dxb[t * row + pp] = g * dtr;
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

cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  ssd_bwd_f32_kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Shared memory a block takes for dtype (0 = float32, 1 = bfloat16) and
// kernel (0: the backward walk; 1: the bf16 states kernel); -1 if none.
extern "C" int ssd_scan_bwd_smem_bytes(int dtype, int kernel) {
  if (kernel == 0) return dtype == 0 ? f32::smem_floats() * (int)sizeof(float)
                         : dtype == 1 ? tc::SMEM : -1;
  return dtype == 1 && kernel == 1 ? tc::SMEM_STATES : -1;
}

// Blocks of a bf16 kernel that fit one SM (its occupancy): kernel 0 is the
// backward walk, 1 the states kernel; -1 on error.
extern "C" int ssd_scan_bwd_bf16_blocks_per_sm(int kernel) {
  return kernel == 0 || kernel == 1 ? tc::blocks_per_sm(kernel) : -1;
}

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of x, B and C must be contiguous; dy, dx, ddt and the dB / dC
// partials are contiguous.  h0 and dh_last may be null.  dtype of x, B, C,
// dy and dx: 0 = float32, 1 = bfloat16; everything else is float32.  With
// nc = ceil(S / 64), the dB / dC partials are (B,S,H,N) f32 and states is a scratch of
// B * H * nc * P * N floats.  For bfloat16 the data pointers of x, B, C
// and dy must be 16-byte aligned, their batch, time (and x's head) strides
// multiples of 8, and h0 and dh_last 8-byte aligned (the wrapper checks).
// Returns the cudaError_t of the launch (0 on success).
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
  p.states = states;
  p.dx = dx; p.ddt = static_cast<float*>(ddt); p.dA_part = static_cast<float*>(dA_part);
  p.dB_part = static_cast<float*>(dB_part); p.dC_part = static_cast<float*>(dC_part);
  p.dh0 = static_cast<float*>(dh0);
  p.S = S; p.H = H; p.nc = (S + Q - 1) / Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.b_sb = b_sb; p.b_ss = b_ss;
  p.c_sb = c_sb; p.c_ss = c_ss;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32::launch(p, B, s);
  if (dtype == 1) return (int)tc::launch(p, B, s);
  return (int)cudaErrorInvalidValue;
}
