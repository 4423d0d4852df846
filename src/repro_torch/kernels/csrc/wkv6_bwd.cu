// RWKV-6 WKV backward for Hopper (sm_90a), bound to PyTorch via ctypes.
//
// The reference has no Pallas backward: it trains RWKV-6 by autodiff of the
// model path src/repro/models/rwkv6.py:wkv_chunked (:85-128).  These kernels
// compute what that autodiff computes (and what wkv6_bwd_plain in wkv6.py
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
// its steps in a fixed order into a partial, and the wrapper sums those.
//
// bf16 (namespace tc, the training path): three kernels in stream order.
// Once S_c (the state at chunk c's start) and dS_c (the gradient at its
// end) are known, every gradient of a chunk depends on that chunk alone;
// and S_c, dS_c follow from each chunk's own terms by an elementwise scan.
//   1. sums, one block of 8 warps per (chunk, head, batch): the cumsum of w
//      (shuffles down the 32 rows), kd = k o e^{cw_Q - cw}, rd = r o e^a,
//      and U_c = kd^T v (2 terms), W_c = rd^T dy (3 terms) on mma.sync, with
//      e^{cw_Q}, into the scratch (f32).
//   2. scan, elementwise (a thread per 4 entries of a state): S_{c+1} =
//      e^{cw_Q} o S_c + U_c from s0 up, dS_{c-1} = e^{cw_Q} o dS_c + W_c
//      from dS_last down (ds0 at the end), each S_c and dS_c written as hi /
//      lo bf16 halves (the bytes of the f32 state).
//   3. chunk, one block of 8 warps per (chunk, head, batch), 2,048 blocks
//      at the train shape where the CUDA-core kernel has 128: warp w owns the 16 x
//      16 tile (rows 16 (w & 1), columns 16 (w >> 1)) of dr, dk and dv.
//      Chunk rows, S_c and dS_c come by cp.async (rows past S zero-filled);
//      the cumsum as in (1); then, by sub-chunks of 16 with reference row b
//      = 15 as in the forward (factoring at the chunk's start would need
//      exponents down to -93, which underflow):
//      * D = dy v^T (dy split: 2 terms).  Its off-diagonal 16 x 16 block
//        stays in registers as an A fragment: D in the warps of rows 16-31,
//        its transpose v dy^T (a second exact product) in the others.
//      * The factored block of A, r~ k~^T (r~_t = r_t o e^{a_t - cw_b}, k~_i
//        = k_i o e^{cw_b - cw_i}, both split: 3 terms), and from the same
//        operands dr_t = e^{a_t - cw_b} o (D k~) and dk_i = e^{cw_b - cw_i} o
//        (D^T r~): no third set of exponentials.
//      * The diagonal blocks on the CUDA cores with the exact exponent, each
//        e_ti formed twice (for A and dr, then for dk), as the forward's
//        lane layout (rows w and 15 - w of each sub-chunk, A summed by
//        halving exchanges), the u-bonus on A's diagonal.
//      * The state terms: dy S^T (3 terms), v dS^T (2), kd dS (3); dv = A^T
//        dy (3 terms, A^T's fragments read from the f32 tile).
//      * rowsum(S o dS), the u terms, du and dlogw's reverse cumsum in f32.
//      Six barriers; the rows come in one cp.async group and S_c, dS_c in a
//      second, waited for only before the state products.  105,728 bytes of
//      shared memory (the state tiles take the diagonal blocks' dr and dk
//      terms once the state products are done): two blocks an SM, 128
//      registers (12 bytes spilled).
// Every f32 operand of a product goes in as hi + lo bf16 halves (about 2^-17
// relative); r, k, v are exact.  tests/test_torch_ssm_train.py emulates this
// arithmetic on the CPU, holds it to the plain version at the card's limits
// and shows that rounding any one of its eight split operands (dy, S, dS,
// r~ k~, kd, rd, A, D) to a single bf16 misses them.  r, k, v need
// 16-byte-aligned data and batch / time / head strides in multiples of 8
// elements, logw and dy 16-byte-aligned data (logw's strides in multiples
// of 4), s0 and dS_last 16-byte alignment (the wrapper checks; nothing
// copies).
//
// f32 (namespace f32): the first design, on the CUDA cores, kept.  One
// block of 256 threads per (batch, head) walks the chunks forward
// (chunk-start states into an f32 scratch) and back (carrying dS); every
// product an f32 FMA loop over tiles staged in shared memory.
//
// What bounds it on the card.  At the rwkv6-1.6b train shape (B 4, S 512,
// 32 heads of 64, bf16 r, k, v) the function reads r, k, v, logw, dy and
// writes dr, dk, dv, dlogw: 103 MB, 0.031 ms at 3.35 TB/s (chip_smoke.py's
// wkv_bwd_bound), against 3.8 GFLOP.  This design adds a scratch of 134.7 MB
// (65,792 bytes a chunk of a head: S_c and dS_c hi / lo, U_c, W_c, e^{cw_Q}),
// written once and read once, and the sums kernel reads the inputs a second
// time: about 430 MB in all, 0.13 ms at 3.35 TB/s.  Measured on an H100 80GB
// HBM3 at 700 W (PERF.md): 0.2113-0.2129 ms by CUDA-graph replay, the
// CUDA-core kernel 0.786-0.805 in the same calls.  By kernel, from a
// profiler trace of a rwkv6-1.6b train step: sums 0.050 ms, scan 0.047,
// chunk 0.116 (before its loads were split in two groups, which took 0.005
// ms off the whole).  The scan moves its 134 MB at about 2.9 TB/s and the
// sums their 126 MB at 2.5: bytes bind them.  The chunk kernel moves 168 MB
// at 1.4 TB/s: latency binds it, two blocks an SM with their phases in
// series.  tools/wkv_bwd_phase_probe.py reads a block's 22,800 cycles as:
// copies 4,000, cumsum and operands 2,900, D and A's block 1,900, state
// products 2,600, diagonal blocks 5,300 (the exponentials formed twice),
// factored blocks, dv and stores 4,500, and (8) 1,700 in two warps only
// (spreading (8) over all eight warps behind one more barrier was 1%
// slower).  A first version that walked the chunks in 1,024 slab blocks
// (the forward walk and the dS walk, 16 dependent chunk steps each) in
// place of (1) and (2) took 0.2358-0.2366 ms in one call with this one's
// 0.2113-0.2128: its walks alone about 0.12 ms, each step waiting on its
// loads.  The SSD backward's layout (a states kernel, then one walk per
// (head, batch) doing every product) was not built: it would put the chunk
// kernel's work, 0.116 ms over 2,048 blocks, on 128 blocks, one an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 32;            // steps per chunk (the forward's)

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const float* logw;
  const float* u;
  const float* s0;               // may be null
  const float* dy;               // contiguous (B,S,H,hd)
  const float* dS_last;          // may be null
  void* scratch;                 // see wkv6_bwd_scratch_bytes
  void* dr;                      // contiguous (B,S,H,hd), r's dtype
  void* dk;
  void* dv;
  float* dlogw;                  // contiguous (B,S,H,hd)
  float* du_part;                // (B,parts,H,hd), parts = wkv6_bwd_du_parts
  float* ds0;                    // (B,H,hd,hd)
  int S, H, nc;
  long long r_sb, r_ss, r_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long w_sb, w_ss, w_sh;
};

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels (D = 64)
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float L2E = 1.4426950408889634f;
constexpr int D = 64;                        // dk = dv = head dim
constexpr int HB = 16;                       // sub-chunk; the factored block's row b = HB - 1
constexpr int LD = D + 8;                    // bf16 row of a 64-wide tile, padded 16 bytes
constexpr int LDF = D + 4;                   // f32 row of a 64-wide tile
constexpr int LDA = Q + 4;                   // f32 row of the D and A tiles (A^T conflict-free)
constexpr int TILE = Q * LD;                 // a 32-row bf16 tile
constexpr int STILE = D * LD;                // a 64-row bf16 tile (a state's hi or lo half)
constexpr int PLANE = D * D;                 // a state's hi or lo half in the scratch
constexpr long long CHUNK_SCRATCH = 2 * PLANE;   // bf16 elements of one state (hi, lo)

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

// All but the last group committed have landed.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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
__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

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

__device__ __forceinline__ void load_f4(const float* p, float (&f)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}

__device__ __forceinline__ void load_bf4(const bf16* p, float (&f)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  f[0] = bf_lo(q.x); f[1] = bf_hi(q.x); f[2] = bf_lo(q.y); f[3] = bf_hi(q.y);
}

// Shared address of 16-byte chunk `chunk` of row `row` of a bf16 tile with rows of ld.
__device__ __forceinline__ uint32_t at(uint32_t base, int row, int chunk, int ld) {
  return base + 2u * static_cast<uint32_t>(row * ld + chunk * 8);
}

// B fragments of 2 n-tiles (8 columns each, from 16-byte chunk c0 on) of a
// row-major (k x n) bf16 tile with row length ld, k rows k0..k0+15.
__device__ __forceinline__ void ldsm_b_trans(uint32_t (&f)[2][2], uint32_t base, int k0, int c0,
                                             int ld, int lane) {
  uint32_t x[4];
  ldsm_x4_trans(x, at(base, k0 + (lane & 15), c0 + (lane >> 4), ld));
  f[0][0] = x[0]; f[0][1] = x[1];
  f[1][0] = x[2]; f[1][1] = x[3];
}

// B fragments of 2 n-tiles (rows n0..n0+15 of a row-major (n x k) tile) at
// k-step ks: b[0], b[1] for rows n0..n0+7, b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], uint32_t base, int n0, int ks, int ld,
                                       int lane) {
  ldsm_x4(b, at(base, n0 + (lane & 7) + ((lane >> 4) << 3), 2 * ks + ((lane >> 3) & 1), ld));
}

// A fragment of rows m0..m0+15 of a row-major (m x k) tile at k-step ks.
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], uint32_t base, int m0, int ks, int ld,
                                       int lane) {
  ldsm_x4(a, at(base, m0 + (lane & 15), 2 * ks + (lane >> 4), ld));
}

// A fragment of the transpose of a row-major (k x m) tile: rows m0..m0+15
// of the transpose (16-byte chunk m0 / 8 on), k rows 16 ks..16 ks + 15.
__device__ __forceinline__ void ldsm_a_trans(uint32_t (&a)[4], uint32_t base, int m0, int ks,
                                             int ld, int lane) {
  ldsm_x4_trans(a, at(base, 16 * ks + (lane & 7) + ((lane >> 4) << 3), m0 / 8 + ((lane >> 3) & 1),
                      ld));
}

// m16n8 accumulators of 2 n-tiles as the A fragment (hi, lo) of a 16 x 16 tile.
__device__ __forceinline__ void acc_to_a(const float (&s)[2][4], uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  split2(s[0][0], s[0][1], hi[0], lo[0]);
  split2(s[0][2], s[0][3], hi[1], lo[1]);
  split2(s[1][0], s[1][1], hi[2], lo[2]);
  split2(s[1][2], s[1][3], hi[3], lo[3]);
}

// ---- The scratch: the states S_c and dS_c as hi / lo bf16 halves (2 x
// (B,H,nc,2,D,D)), each chunk's own terms U_c = kd_c^T v_c and W_c = rd_c^T
// dy_c (f32, 2 x (B,H,nc,D,D)) and e^{cw_Q} of each chunk (f32, (B,H,nc,D)).

struct Scratch {
  bf16* st;
  bf16* ds;
  float* u;
  float* w;
  float* eq;
};

__device__ __forceinline__ Scratch scratch_of(const Params& p, int B) {
  const long long n = (long long)B * p.H * p.nc;
  Scratch s;
  s.st = static_cast<bf16*>(p.scratch);
  s.ds = s.st + n * CHUNK_SCRATCH;
  s.u = reinterpret_cast<float*>(s.ds + n * CHUNK_SCRATCH);
  s.w = s.u + n * PLANE;
  s.eq = s.w + n * PLANE;
  return s;
}

// ---- The chunks' own terms, all chunks at once: U_c = kd^T v (kd = k o
// e^{cw_Q - cw} split: 2 terms) and W_c = rd^T dy (rd = r o e^{cw - w} and dy
// split: 3 terms), and e^{cw_Q}.

constexpr int SWARPS = 8, STHREADS = 32 * SWARPS;
// w and dy (f32, Q x LDF); r, k, v, kd (hi, lo), rd (hi, lo), dy (hi, lo) as
// bf16 32-row tiles
constexpr int SUMS_SMEM = 2 * Q * LDF * 4 + 9 * TILE * 2;

// blockIdx = (chunk, head, batch).  Warp w owns rows 16 (w & 3) (channels)
// and columns 32 (w >> 2) of U_c and W_c.
__global__ void __launch_bounds__(STHREADS) wkv6_bwd_sums_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sW = reinterpret_cast<float*>(smem);        // Q x LDF
  float* sY = sW + Q * LDF;                           // Q x LDF
  bf16* sR = reinterpret_cast<bf16*>(sY + Q * LDF);
  bf16* sK = sR + TILE;
  bf16* sV = sK + TILE;
  bf16* sKDh = sV + TILE;
  bf16* sKDl = sKDh + TILE;
  bf16* sRDh = sKDl + TILE;
  bf16* sRDl = sRDh + TILE;
  bf16* sYh = sRDl + TILE;
  bf16* sYl = sYh + TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, nc = p.nc;
  const int t0 = c * Q, nv = min(Q, S - t0);
  const bf16* rb = static_cast<const bf16*>(p.r) + b * p.r_sb + h * p.r_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.logw + b * p.w_sb + h * p.w_sh;
  const long long row = (long long)H * D;
  const long long obase = ((long long)b * S * H + h) * D;
  const long long bhc = ((long long)b * H + h) * nc + c;
  const Scratch sc = scratch_of(p, gridDim.z);

  for (int pc = tid; pc < Q * 8; pc += STHREADS) {
    const int r_ = pc >> 3, ch = pc & 7;
    const bool ok = r_ < nv;
    const long long t = t0 + (ok ? r_ : 0);
    const int o = r_ * LD + ch * 8;
    cp_async16(smem_u32(sR + o), rb + t * p.r_ss + ch * 8, ok);
    cp_async16(smem_u32(sK + o), kb + t * p.k_ss + ch * 8, ok);
    cp_async16(smem_u32(sV + o), vb + t * p.v_ss + ch * 8, ok);
  }
  for (int pc = tid; pc < Q * 16; pc += STHREADS) {
    const int r_ = pc >> 4, ch = pc & 15;
    const bool ok = r_ < nv;
    const long long t = t0 + (ok ? r_ : 0);
    cp_async16(smem_u32(sW + r_ * LDF + ch * 4), wb + t * p.w_ss + ch * 4, ok);
    cp_async16(smem_u32(sY + r_ * LDF + ch * 4), p.dy + obase + t * row + ch * 4, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // The cumsum of w down the chunk (lane = row) for the warp's 8 channels;
  // kd, rd and dy of row `lane` split hi + lo; e^{cw_Q} of the channels.
  {
    const int col = 8 * warp;
    float wv[8], cw[8], rv[8], kv[8], yv[8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(sW + lane * LDF + col + 4 * q);
      wv[4 * q] = x.x; wv[4 * q + 1] = x.y; wv[4 * q + 2] = x.z; wv[4 * q + 3] = x.w;
      const float4 y = *reinterpret_cast<const float4*>(sY + lane * LDF + col + 4 * q);
      yv[4 * q] = y.x; yv[4 * q + 1] = y.y; yv[4 * q + 2] = y.z; yv[4 * q + 3] = y.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cw[j] = wv[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = __shfl_up_sync(FULL, cw[j], off);
        if (lane >= off) cw[j] += x;
      }
    unpack8(*reinterpret_cast<const uint4*>(sR + lane * LD + col), rv);
    unpack8(*reinterpret_cast<const uint4*>(sK + lane * LD + col), kv);
    uint32_t o[6][4];                        // kd, rd, dy: hi, lo of each
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      float kd[2], rd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jj + e;
        const float xq = __shfl_sync(FULL, cw[j], Q - 1);
        kd[e] = kv[j] * ex2((xq - cw[j]) * L2E);
        rd[e] = rv[j] * ex2((cw[j] - wv[j]) * L2E);
        if (lane == Q - 1) sc.eq[bhc * D + col + j] = ex2(cw[j] * L2E);
      }
      split2(kd[0], kd[1], o[0][jj / 2], o[1][jj / 2]);
      split2(rd[0], rd[1], o[2][jj / 2], o[3][jj / 2]);
      split2(yv[jj], yv[jj + 1], o[4][jj / 2], o[5][jj / 2]);
    }
    bf16* dst[6] = {sKDh, sKDl, sRDh, sRDl, sYh, sYl};
#pragma unroll
    for (int m = 0; m < 6; ++m)
      *reinterpret_cast<uint4*>(dst[m] + lane * LD + col) =
          make_uint4(o[m][0], o[m][1], o[m][2], o[m][3]);
  }
  __syncthreads();

  const int m0 = 16 * (warp & 3), n0 = 32 * (warp >> 2);
  float u[4][4] = {}, wsum[4][4] = {}, w2[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t kh[4], kl[4], rh[4], rl[4];
    ldsm_a_trans(kh, smem_u32(sKDh), m0, ks, LD, lane);
    ldsm_a_trans(kl, smem_u32(sKDl), m0, ks, LD, lane);
    ldsm_a_trans(rh, smem_u32(sRDh), m0, ks, LD, lane);
    ldsm_a_trans(rl, smem_u32(sRDl), m0, ks, LD, lane);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t fv[2][2], fh[2][2], fl[2][2];
      ldsm_b_trans(fv, smem_u32(sV), 16 * ks, n0 / 8 + 2 * np, LD, lane);
      ldsm_b_trans(fh, smem_u32(sYh), 16 * ks, n0 / 8 + 2 * np, LD, lane);
      ldsm_b_trans(fl, smem_u32(sYl), 16 * ks, n0 / 8 + 2 * np, LD, lane);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int nt = 2 * np + q;
        mma_bf16(u[nt], kh, fv[q][0], fv[q][1]);
        mma_bf16(u[nt], kl, fv[q][0], fv[q][1]);
        mma_bf16(wsum[nt], rh, fh[q][0], fh[q][1]);
        mma_bf16(w2[nt], rh, fl[q][0], fl[q][1]);
        mma_bf16(w2[nt], rl, fh[q][0], fh[q][1]);
      }
    }
  }
  float* uo = sc.u + bhc * PLANE + (m0 + g) * D + n0 + 2 * tg;
  float* wo = sc.w + bhc * PLANE + (m0 + g) * D + n0 + 2 * tg;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    *reinterpret_cast<float2*>(uo + 8 * nt) = make_float2(u[nt][0], u[nt][1]);
    *reinterpret_cast<float2*>(uo + 8 * D + 8 * nt) = make_float2(u[nt][2], u[nt][3]);
    *reinterpret_cast<float2*>(wo + 8 * nt) =
        make_float2(wsum[nt][0] + w2[nt][0], wsum[nt][1] + w2[nt][1]);
    *reinterpret_cast<float2*>(wo + 8 * D + 8 * nt) =
        make_float2(wsum[nt][2] + w2[nt][2], wsum[nt][3] + w2[nt][3]);
  }
}

// ---- The scans over chunks, elementwise: S_{c+1} = e^{cw_Q} o S_c + U_c
// from s0 (chunk 0 up), dS_{c-1} = e^{cw_Q} o dS_c + W_c from dS_last (the
// last chunk down; ds0 after chunk 0).  Each state is written, before its
// chunk's update, as hi / lo bf16 halves.

constexpr int SCAN_THREADS = 128, SCAN_BLOCKS = D * D / (4 * SCAN_THREADS);

// blockIdx = (element block, head, z): z < B scans the states of batch z,
// z >= B the state gradients of batch z - B.  A thread takes 4 consecutive
// elements of one state row.
__global__ void __launch_bounds__(SCAN_THREADS) wkv6_bwd_scan_kernel(const Params p, int B) {
  const int e = 4 * (blockIdx.x * SCAN_THREADS + threadIdx.x), kr = e / D;
  const int h = blockIdx.y;
  const bool back = blockIdx.z >= B;
  const int b = back ? blockIdx.z - B : blockIdx.z;
  const int nc = p.nc;
  const long long bh = (long long)b * p.H + h;
  const Scratch sc = scratch_of(p, B);
  const float* sums = (back ? sc.w : sc.u) + bh * nc * PLANE + e;
  const float* eq = sc.eq + bh * nc * D + kr;
  bf16* out = (back ? sc.ds : sc.st) + bh * nc * CHUNK_SCRATCH + e;
  const float* init = back ? p.dS_last : p.s0;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (init) s = *reinterpret_cast<const float4*>(init + bh * PLANE + e);
  for (int n = 0; n < nc; ++n) {
    const int c = back ? nc - 1 - n : n;
    uint32_t h0, l0, h1, l1;
    split2(s.x, s.y, h0, l0);
    split2(s.z, s.w, h1, l1);
    *reinterpret_cast<uint2*>(out + c * CHUNK_SCRATCH) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(out + c * CHUNK_SCRATCH + PLANE) = make_uint2(l0, l1);
    if (!back && n == nc - 1) break;               // the state after the last chunk is unused
    const float4 u = *reinterpret_cast<const float4*>(sums + (long long)c * PLANE);
    const float q = eq[c * D];
    s = make_float4(fmaf(q, s.x, u.x), fmaf(q, s.y, u.y), fmaf(q, s.z, u.z), fmaf(q, s.w, u.w));
  }
  if (back) *reinterpret_cast<float4*>(p.ds0 + bh * PLANE + e) = s;
}

// ---- The chunk kernel: every gradient of one chunk from S_c and dS_c.

constexpr int CWARPS = 8, CTHREADS = 32 * CWARPS;
constexpr int CG = 4;                        // channels a lane takes in the diagonal blocks
constexpr int NG = D / CG;                   // lanes that share one score: 16
// Shared memory, bytes: dy (f32, Q x LDF) while it is split, then the D and A
// tiles (f32, Q x LDA each); cw and cw - w (f32, log2e-scaled); rowsum(S o
// dS) and two rows of column partials; r, k, v, dy (hi, lo), rk~ (hi, lo),
// kd (hi, lo) as bf16 32-row tiles; S_c and dS_c (hi, lo) as 64-row tiles,
// whose room takes the diagonal blocks' dr and dk terms (f32, Q x LDF) once
// the state products are done.
constexpr int F1 = 2 * Q * LDA * 4;
constexpr int CHUNK_SMEM = F1 + 2 * Q * LDF * 4 + 3 * D * 4 + 9 * TILE * 2 + 4 * STILE * 2;
static_assert(Q * LDF <= 2 * Q * LDA, "dy's f32 tile fits the room of D and A");
static_assert(2 * Q * LDF * 4 <= 4 * STILE * 2, "the dr and dk terms fit the state tiles' room");

// blockIdx = (chunk, head, batch).  Warp w owns the 16 x 16 tile (rows 16 mt,
// columns 16 cg; mt = w & 1, cg = w >> 1) of dr, dk and dv.
__global__ void __launch_bounds__(CTHREADS, 2) wkv6_bwd_chunk_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sF1 = reinterpret_cast<float*>(smem);
  float* sD = sF1;                           // Q x LDA: D_ti = dy_t . v_i (diagonal blocks)
  float* sA = sF1 + Q * LDA;                 // Q x LDA: the scores, u-bonus on the diagonal
  float* sCw = reinterpret_cast<float*>(smem + F1);   // Q x LDF: w, then cw * log2e
  float* sCm = sCw + Q * LDF;                // Q x LDF: (cw - w) * log2e
  float* sRow = sCm + Q * LDF;               // D: rowsum(S o dS)
  float* sColp = sRow + D;                   // 2 x D: sum_i k_i o (its dS term), by row half
  bf16* sR = reinterpret_cast<bf16*>(sColp + 2 * D);
  bf16* sK = sR + TILE;
  bf16* sV = sK + TILE;
  bf16* sYh = sV + TILE;                     // dy, hi and lo
  bf16* sYl = sYh + TILE;
  bf16* sRKh = sYl + TILE;                   // k~ (rows 0-15) and r~ (rows 16-31), hi and lo
  bf16* sRKl = sRKh + TILE;
  bf16* sKDh = sRKl + TILE;                  // kd = k o e^{cw_Q - cw}, hi and lo
  bf16* sKDl = sKDh + TILE;
  bf16* sSh = sKDl + TILE;                   // S_c, hi and lo (D x LD)
  bf16* sSl = sSh + STILE;
  bf16* sGh = sSl + STILE;                   // dS_c, hi and lo
  bf16* sGl = sGh + STILE;
  float* sDR = reinterpret_cast<float*>(sSh);   // Q x LDF, after the state products
  float* sDK = sDR + Q * LDF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, nc = p.nc;
  const int t0 = c * Q, nv = min(Q, S - t0);
  const bf16* rb = static_cast<const bf16*>(p.r) + b * p.r_sb + h * p.r_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.logw + b * p.w_sb + h * p.w_sh;
  const float* ub = p.u + (long long)h * D;
  const long long row = (long long)H * D;                 // time stride of dy and the outputs
  const long long obase = ((long long)b * S * H + h) * D;
  const Scratch scr = scratch_of(p, gridDim.z);
  const long long bhc = ((long long)b * H + h) * nc + c;
  const bf16* st_in = scr.st + bhc * CHUNK_SCRATCH;
  const bf16* ds_in = scr.ds + bhc * CHUNK_SCRATCH;

  // (0) The chunk's rows (zero past S), S_c and dS_c.
  for (int pc = tid; pc < Q * 8; pc += CTHREADS) {
    const int r_ = pc >> 3, ch = pc & 7;
    const bool ok = r_ < nv;
    const long long t = t0 + (ok ? r_ : 0);
    const int o = r_ * LD + ch * 8;
    cp_async16(smem_u32(sR + o), rb + t * p.r_ss + ch * 8, ok);
    cp_async16(smem_u32(sK + o), kb + t * p.k_ss + ch * 8, ok);
    cp_async16(smem_u32(sV + o), vb + t * p.v_ss + ch * 8, ok);
  }
  for (int pc = tid; pc < Q * 16; pc += CTHREADS) {
    const int r_ = pc >> 4, ch = pc & 15;
    const bool ok = r_ < nv;
    const long long t = t0 + (ok ? r_ : 0);
    cp_async16(smem_u32(sCw + r_ * LDF + ch * 4), wb + t * p.w_ss + ch * 4, ok);
    cp_async16(smem_u32(sF1 + r_ * LDF + ch * 4), p.dy + obase + t * row + ch * 4, ok);
  }
  cp_async_commit();
  for (int pc = tid; pc < D * 8; pc += CTHREADS) {
    const int r_ = pc >> 3, ch = pc & 7;
    const int o = r_ * LD + ch * 8, gi = r_ * D + ch * 8;
    cp_async16(smem_u32(sSh + o), st_in + gi, true);
    cp_async16(smem_u32(sSl + o), st_in + PLANE + gi, true);
    cp_async16(smem_u32(sGh + o), ds_in + gi, true);
    cp_async16(smem_u32(sGl + o), ds_in + PLANE + gi, true);
  }
  cp_async_commit();
  cp_async_wait_prior();
  __syncthreads();                           // (a) the rows; S_c, dS_c land in (1)-(3)

  // (1) The cumsum of w down the chunk (lane = row) for the warp's 8
  // channels, and row `lane`'s operands split hi + lo: k~_i = k_i o
  // e^{cw_b - cw_i} (rows 0-15) and r~_t = r_t o e^{a_t - cw_b} (rows 16-31),
  // b = 15, a = cw - w; kd = k o e^{cw_Q - cw}; dy.  Every exponent <= 0.
  {
    const int col = 8 * warp;
    float wv[8], cw[8], rv[8], kv[8], yv[8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(sCw + lane * LDF + col + 4 * q);
      wv[4 * q] = x.x; wv[4 * q + 1] = x.y; wv[4 * q + 2] = x.z; wv[4 * q + 3] = x.w;
      const float4 y = *reinterpret_cast<const float4*>(sF1 + lane * LDF + col + 4 * q);
      yv[4 * q] = y.x; yv[4 * q + 1] = y.y; yv[4 * q + 2] = y.z; yv[4 * q + 3] = y.w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cw[j] = wv[j];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float x = __shfl_up_sync(FULL, cw[j], off);
        if (lane >= off) cw[j] += x;
      }
    unpack8(*reinterpret_cast<const uint4*>(sR + lane * LD + col), rv);
    unpack8(*reinterpret_cast<const uint4*>(sK + lane * LD + col), kv);
    uint32_t o[6][4];                        // rk~, kd, dy: hi, lo of each
    float cws[8], cms[8];
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2) {
      float rk[2], kd[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = jj + e;
        const float x = cw[j], m = x - wv[j];
        const float xq = __shfl_sync(FULL, x, Q - 1), xb = __shfl_sync(FULL, x, HB - 1);
        kd[e] = kv[j] * ex2((xq - x) * L2E);
        rk[e] = (lane < HB ? kv[j] : rv[j]) * ex2((lane < HB ? xb - x : m - xb) * L2E);
        cws[j] = x * L2E;
        cms[j] = m * L2E;
      }
      split2(rk[0], rk[1], o[0][jj / 2], o[1][jj / 2]);
      split2(kd[0], kd[1], o[2][jj / 2], o[3][jj / 2]);
      split2(yv[jj], yv[jj + 1], o[4][jj / 2], o[5][jj / 2]);
    }
    bf16* dst[6] = {sRKh, sRKl, sKDh, sKDl, sYh, sYl};
#pragma unroll
    for (int m = 0; m < 6; ++m)
      *reinterpret_cast<uint4*>(dst[m] + lane * LD + col) =
          make_uint4(o[m][0], o[m][1], o[m][2], o[m][3]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      *reinterpret_cast<float4*>(sCw + lane * LDF + col + 4 * q) =
          make_float4(cws[4 * q], cws[4 * q + 1], cws[4 * q + 2], cws[4 * q + 3]);
      *reinterpret_cast<float4*>(sCm + lane * LDF + col + 4 * q) =
          make_float4(cms[4 * q], cms[4 * q + 1], cms[4 * q + 2], cms[4 * q + 3]);
    }
  }
  __syncthreads();                           // (b) the operands are visible

  const uint32_t uV = smem_u32(sV), uYh = smem_u32(sYh), uYl = smem_u32(sYl);
  const uint32_t uRKh = smem_u32(sRKh), uRKl = smem_u32(sRKl);
  const uint32_t uKDh = smem_u32(sKDh), uKDl = smem_u32(sKDl);
  const uint32_t uSh = smem_u32(sSh), uSl = smem_u32(sSl), uGh = smem_u32(sGh), uGl = smem_u32(sGl);
  const int mt = warp & 1, cg = warp >> 1;

  // (2) D's off-diagonal block (rows t 16-31, columns i 0-15) as an A
  // fragment (hi, lo): D = dy v^T in the warps of rows 16-31, its transpose
  // v dy^T (a second exact product) in the others.  dy split: 2 terms.
  uint32_t dfh[4], dfl[4];
  {
    float s[2][4] = {}, s2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4], a2[4], bb[4], bb2[4];
      if (mt) {
        ldsm_a(a, uYh, HB, ks, LD, lane);
        ldsm_a(a2, uYl, HB, ks, LD, lane);
        ldsm_b(bb, uV, 0, ks, LD, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(s[nt], a, bb[2 * nt], bb[2 * nt + 1]);
          mma_bf16(s2[nt], a2, bb[2 * nt], bb[2 * nt + 1]);
        }
      } else {
        ldsm_a(a, uV, 0, ks, LD, lane);
        ldsm_b(bb, uYh, HB, ks, LD, lane);
        ldsm_b(bb2, uYl, HB, ks, LD, lane);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(s[nt], a, bb[2 * nt], bb[2 * nt + 1]);
          mma_bf16(s2[nt], a, bb2[2 * nt], bb2[2 * nt + 1]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += s2[nt][e];
    acc_to_a(s, dfh, dfl);
  }

  // (3) Warps 0 and 1: D's diagonal block `warp` (f32) into sD.  Warp 2: the
  // factored block r~ k~^T (both split: 3 terms) into sA.  Warps 4-7: zero
  // sA's diagonal blocks, whose strict lower halves and diagonals (5) writes.
  if (warp < 2) {
    const int r0 = HB * warp;
    float s[2][4] = {}, s2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t a[4], a2[4], bb[4];
      ldsm_a(a, uYh, r0, ks, LD, lane);
      ldsm_a(a2, uYl, r0, ks, LD, lane);
      ldsm_b(bb, uV, r0, ks, LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_bf16(s[nt], a, bb[2 * nt], bb[2 * nt + 1]);
        mma_bf16(s2[nt], a2, bb[2 * nt], bb[2 * nt + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* d0 = sD + (r0 + g) * LDA + r0 + 8 * nt + 2 * tg;
      *reinterpret_cast<float2*>(d0) = make_float2(s[nt][0] + s2[nt][0], s[nt][1] + s2[nt][1]);
      *reinterpret_cast<float2*>(d0 + 8 * LDA) =
          make_float2(s[nt][2] + s2[nt][2], s[nt][3] + s2[nt][3]);
    }
  } else if (warp == 2) {
    float s[2][4] = {}, s2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      ldsm_a(ah, uRKh, HB, ks, LD, lane);
      ldsm_a(al, uRKl, HB, ks, LD, lane);
      ldsm_b(bh, uRKh, 0, ks, LD, lane);
      ldsm_b(bl, uRKl, 0, ks, LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_bf16(s[nt], ah, bh[2 * nt], bh[2 * nt + 1]);
        mma_bf16(s2[nt], ah, bl[2 * nt], bl[2 * nt + 1]);
        mma_bf16(s2[nt], al, bh[2 * nt], bh[2 * nt + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float* a0 = sA + (HB + g) * LDA + 8 * nt + 2 * tg;
      *reinterpret_cast<float2*>(a0) = make_float2(s[nt][0] + s2[nt][0], s[nt][1] + s2[nt][1]);
      *reinterpret_cast<float2*>(a0 + 8 * LDA) =
          make_float2(s[nt][2] + s2[nt][2], s[nt][3] + s2[nt][3]);
    }
  } else if (warp >= 4) {
    for (int e = tid - 4 * 32; e < 2 * HB * HB; e += 4 * 32) {
      const int blk = e / (HB * HB), rr = (e / HB) % HB, cc = e % HB;
      sA[(HB * blk + rr) * LDA + HB * blk + cc] = 0.f;
    }
  }

  // (4) The state products of this warp's tile: dy S^T (dr; both split: 3
  // terms), v dS^T (dk; 2 terms), kd dS (dv; 3 terms).  Then rowsum(S o dS)
  // per channel, from the hi + lo halves.
  cp_async_wait_all();
  __syncthreads();                           // S_c and dS_c have landed
  float drS[2][4] = {}, dkS[2][4] = {}, dvS[2][4] = {};
  {
    float s2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4], bh[4], bl[4];
      ldsm_a(ah, uYh, HB * mt, ks, LD, lane);
      ldsm_a(al, uYl, HB * mt, ks, LD, lane);
      ldsm_b(bh, uSh, HB * cg, ks, LD, lane);
      ldsm_b(bl, uSl, HB * cg, ks, LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_bf16(drS[nt], ah, bh[2 * nt], bh[2 * nt + 1]);
        mma_bf16(s2[nt], ah, bl[2 * nt], bl[2 * nt + 1]);
        mma_bf16(s2[nt], al, bh[2 * nt], bh[2 * nt + 1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) drS[nt][e] += s2[nt][e];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[4], bh[4], bl[4];
    ldsm_a(a, uV, HB * mt, ks, LD, lane);
    ldsm_b(bh, uGh, HB * cg, ks, LD, lane);
    ldsm_b(bl, uGl, HB * cg, ks, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma_bf16(dkS[nt], a, bh[2 * nt], bh[2 * nt + 1]);
      mma_bf16(dkS[nt], a, bl[2 * nt], bl[2 * nt + 1]);
    }
  }
  {
    float s2[2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t ah[4], al[4], fh[2][2], fl[2][2];
      ldsm_a(ah, uKDh, HB * mt, ks, LD, lane);
      ldsm_a(al, uKDl, HB * mt, ks, LD, lane);
      ldsm_b_trans(fh, uGh, HB * ks, 2 * cg, LD, lane);
      ldsm_b_trans(fl, uGl, HB * ks, 2 * cg, LD, lane);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_bf16(dvS[nt], ah, fh[nt][0], fh[nt][1]);
        mma_bf16(s2[nt], ah, fl[nt][0], fl[nt][1]);
        mma_bf16(s2[nt], al, fh[nt][0], fh[nt][1]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dvS[nt][e] += s2[nt][e];
  }
  {
    const int ch = tid >> 2, q = tid & 3;    // channel, quarter of its 64 columns
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 16; j += 8) {
      const int o = ch * LD + 16 * q + j;
      float sh[8], sl[8], gh[8], gl[8];
      unpack8(*reinterpret_cast<const uint4*>(sSh + o), sh);
      unpack8(*reinterpret_cast<const uint4*>(sSl + o), sl);
      unpack8(*reinterpret_cast<const uint4*>(sGh + o), gh);
      unpack8(*reinterpret_cast<const uint4*>(sGl + o), gl);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(sh[e] + sl[e], gh[e] + gl[e], acc);
    }
    acc += __shfl_xor_sync(FULL, acc, 1);
    acc += __shfl_xor_sync(FULL, acc, 2);
    if (q == 0) sRow[ch] = acc;
  }
  __syncthreads();                           // (c) sD is written; the state tiles are free

  // (5) The diagonal blocks, exact on the CUDA cores (each e_ti formed twice:
  // once for A and dr, once for dk).  Lane = (channel group de of CG
  // channels, sub-chunk).  First warp w takes rows ta = w and tb = 15 - w of
  // each sub-chunk (local): the 15 strict entries (w below ta, 15 - w below
  // tb) are one loop with no branch; A's entries sum over the NG lanes of a
  // group by halving exchanges (as the forward's), dr's terms are the
  // lane's own.  Then warp w takes columns ia = w and ib = 15 - w, whose
  // 15 entries (15 - w right of ia, w right of ib) make dk's terms.
  {
    const int de = lane % NG, sub = lane / NG, base = HB * sub;
    const int tl = warp, c0 = CG * de;
    {
      const int ta = base + tl, tb = base + 15 - tl;
      float ra[CG], ma[CG], rb_[CG], mb[CG], v[16], dra[CG] = {}, drb[CG] = {}, bonus_b;
      load_bf4(sR + ta * LD + c0, ra);
      load_f4(sCm + ta * LDF + c0, ma);
      load_bf4(sR + tb * LD + c0, rb_);
      load_f4(sCm + tb * LDF + c0, mb);
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const bool on_a = j < tl;
        const int i = base + (on_a ? j : j - tl);
        const int t = on_a ? ta : tb;
        const float d = sD[t * LDA + i];
        float ki[CG], ci[CG];
        load_bf4(sK + i * LD + c0, ki);
        load_f4(sCw + i * LDF + c0, ci);
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < CG; ++e) {
          const float rt = on_a ? ra[e] : rb_[e], mtv = on_a ? ma[e] : mb[e];
          const float ex = ex2(mtv - ci[e]);
          acc = fmaf(rt * ki[e], ex, acc);
          const float dd = d * ki[e] * ex;
          if (on_a) dra[e] += dd;
          else drb[e] += dd;
        }
        v[j] = acc;
      }
      {
        float ka[CG], kb_[CG], ug[CG];
        load_bf4(sK + ta * LD + c0, ka);
        load_bf4(sK + tb * LD + c0, kb_);
#pragma unroll
        for (int e = 0; e < CG; ++e) ug[e] = ub[c0 + e];
        v[15] = 0.f;
        bonus_b = 0.f;
#pragma unroll
        for (int e = 0; e < CG; ++e) {
          v[15] = fmaf(ra[e] * ug[e], ka[e], v[15]);
          bonus_b = fmaf(rb_[e] * ug[e], kb_[e], bonus_b);
        }
      }
      *reinterpret_cast<float4*>(sDR + ta * LDF + c0) = make_float4(dra[0], dra[1], dra[2], dra[3]);
      *reinterpret_cast<float4*>(sDR + tb * LDF + c0) = make_float4(drb[0], drb[1], drb[2], drb[3]);
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
                    ((lane >> 3) & 1);       // the value v[0] now sums
      if (j == 15) sA[ta * LDA + ta] = v[0];
      else if (j < tl) sA[ta * LDA + base + j] = v[0];
      else sA[tb * LDA + base + j - tl] = v[0];
      if (de == 0) sA[tb * LDA + tb] = bonus_b;
    }
    {
      const int ia = base + tl, ib = base + 15 - tl, na = 15 - tl;
      float ca[CG], cb[CG], dka[CG] = {}, dkb[CG] = {};
      load_f4(sCw + ia * LDF + c0, ca);
      load_f4(sCw + ib * LDF + c0, cb);
#pragma unroll
      for (int j = 0; j < 15; ++j) {
        const bool on_a = j < na;
        const int i = on_a ? ia : ib;
        const int t = on_a ? ia + 1 + j : ib + 1 + j - na;
        const float d = sD[t * LDA + i];
        float rt[CG], mtv[CG];
        load_bf4(sR + t * LD + c0, rt);
        load_f4(sCm + t * LDF + c0, mtv);
#pragma unroll
        for (int e = 0; e < CG; ++e) {
          const float dd = d * rt[e] * ex2(mtv[e] - (on_a ? ca[e] : cb[e]));
          if (on_a) dka[e] += dd;
          else dkb[e] += dd;
        }
      }
      *reinterpret_cast<float4*>(sDK + ia * LDF + c0) = make_float4(dka[0], dka[1], dka[2], dka[3]);
      *reinterpret_cast<float4*>(sDK + ib * LDF + c0) = make_float4(dkb[0], dkb[1], dkb[2], dkb[3]);
    }
  }
  __syncthreads();                           // (d) A, dr's and dk's diagonal terms are written

  // (6) The factored blocks: dr_t = e^{a_t - cw_b} o (D k~) for rows 16-31,
  // dk_i = e^{cw_b - cw_i} o (D^T r~) for rows 0-15 (both split: 3 terms);
  // dv = A^T dy (both split: 3 terms), A^T's fragments read from sA (f32).
  float dO[2][4] = {}, dvA[2][4] = {};
  {
    uint32_t fh[2][2], fl[2][2];
    ldsm_b_trans(fh, uRKh, mt ? 0 : HB, 2 * cg, LD, lane);
    ldsm_b_trans(fl, uRKl, mt ? 0 : HB, 2 * cg, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma_bf16(dO[nt], dfh, fh[nt][0], fh[nt][1]);
      mma_bf16(dO[nt], dfh, fl[nt][0], fl[nt][1]);
      mma_bf16(dO[nt], dfl, fh[nt][0], fh[nt][1]);
    }
  }
  for (int kk = mt; kk < 2; ++kk) {
    uint32_t ah[4], al[4], fh[2][2], fl[2][2];
    const float* a0 = sA + (HB * kk + 2 * tg) * LDA + HB * mt + g;
    split2(a0[0], a0[LDA], ah[0], al[0]);
    split2(a0[8], a0[LDA + 8], ah[1], al[1]);
    split2(a0[8 * LDA], a0[9 * LDA], ah[2], al[2]);
    split2(a0[8 * LDA + 8], a0[9 * LDA + 8], ah[3], al[3]);
    ldsm_b_trans(fh, uYh, HB * kk, 2 * cg, LD, lane);
    ldsm_b_trans(fl, uYl, HB * kk, 2 * cg, LD, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma_bf16(dvA[nt], ah, fh[nt][0], fh[nt][1]);
      mma_bf16(dvA[nt], ah, fl[nt][0], fl[nt][1]);
      mma_bf16(dvA[nt], al, fh[nt][0], fh[nt][1]);
    }
  }

  // (7) This warp's tile of dr, dk, dv: the decays on the accumulators, the u
  // terms, the stores (rows < nv).  dlogw's terms go back into sDR (da_t = r_t
  // o dr_t less its u term) and sDK (da_t - k_t o (dk_t less its u term)), and
  // the column sums of k_i o (its dS term) into sColp.
  {
    const float* cwQ = sCw + (Q - 1) * LDF;
    const float* cwB = sCw + (HB - 1) * LDF;
    float colp[2][2] = {};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int c2 = HB * cg + 8 * nt + 2 * tg;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int t = HB * mt + g + 8 * hr;
        const float dtt = sD[t * LDA + t];
        float o_dr[2], o_dk[2], o_dv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 2 * hr + q, cc = c2 + q;
          const float cm = sCm[t * LDF + cc], cwt = sCw[t * LDF + cc];
          const float rv = bf(sR + t * LD + cc), kv = bf(sK + t * LD + cc), uv = ub[cc];
          float dra = sDR[t * LDF + cc] + ex2(cm) * drS[nt][e];
          const float dks = ex2(cwQ[cc] - cwt) * dkS[nt][e];
          float dka = sDK[t * LDF + cc] + dks;
          if (mt) dra += ex2(cm - cwB[cc]) * dO[nt][e];
          else dka += ex2(cwB[cc] - cwt) * dO[nt][e];
          o_dr[q] = dra + uv * kv * dtt;
          o_dk[q] = dka + uv * rv * dtt;
          o_dv[q] = dvA[nt][e] + dvS[nt][e];
          const float da = rv * dra;
          sDR[t * LDF + cc] = da;
          sDK[t * LDF + cc] = da - kv * dka;
          colp[nt][q] = fmaf(kv, dks, colp[nt][q]);
        }
        if (t < nv) {
          const long long o = obase + (t0 + t) * row + c2;
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dr) + o) = pack_bf16(o_dr[0], o_dr[1]);
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dk) + o) = pack_bf16(o_dk[0], o_dk[1]);
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p.dv) + o) = pack_bf16(o_dv[0], o_dv[1]);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float x = colp[nt][q];
        x += __shfl_xor_sync(FULL, x, 4);
        x += __shfl_xor_sync(FULL, x, 8);
        x += __shfl_xor_sync(FULL, x, 16);
        if (g == 0) sColp[mt * D + HB * cg + 8 * nt + 2 * tg + q] = x;
      }
  }
  __syncthreads();                           // (e) dlogw's terms are in place

  // (8) dlogw = revcumsum(dcw + da) - da per channel, with the last row's
  // e^{cw_Q} rowsum(S o dS) + sum_i k_i o (its dS term); du's partial of
  // this chunk, summed over its rows in order.
  if (tid < D) {
    const int cc = tid;
    float run = ex2(sCw[(Q - 1) * LDF + cc]) * sRow[cc] + sColp[cc] + sColp[D + cc];
    for (int t = nv - 1; t >= 0; --t) {
      run += sDK[t * LDF + cc];
      p.dlogw[obase + (t0 + t) * row + cc] = run - sDR[t * LDF + cc];
    }
  } else if (tid < 2 * D) {
    const int cc = tid - D;
    float s = 0.f;
    for (int t = 0; t < nv; ++t)
      s = fmaf(bf(sR + t * LD + cc) * bf(sK + t * LD + cc), sD[t * LDA + t], s);
    p.du_part[(((long long)b * nc + c) * H + h) * D + cc] = s;
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  cudaError_t err = prepare(wkv6_bwd_sums_kernel, SUMS_SMEM);
  if (err != cudaSuccess) return err;
  err = prepare(wkv6_bwd_chunk_kernel, CHUNK_SMEM);
  if (err != cudaSuccess) return err;
  wkv6_bwd_sums_kernel<<<dim3(p.nc, p.H, B), STHREADS, SUMS_SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_scan_kernel<<<dim3(SCAN_BLOCKS, p.H, 2 * B), SCAN_THREADS, 0, stream>>>(p, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_chunk_kernel<<<dim3(p.nc, p.H, B), CTHREADS, CHUNK_SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Blocks an SM holds: kernel 0 the sums, 1 the chunk kernel.
int blocks_per_sm(int kernel) {
  int n = 0;
  cudaError_t err = kernel == 0 ? prepare(wkv6_bwd_sums_kernel, SUMS_SMEM)
                                : prepare(wkv6_bwd_chunk_kernel, CHUNK_SMEM);
  if (err != cudaSuccess) return -1;
  err = kernel == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv6_bwd_sums_kernel,
                                                                    STHREADS, SUMS_SMEM)
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv6_bwd_chunk_kernel,
                                                                    CTHREADS, CHUNK_SMEM);
  return err == cudaSuccess ? n : -1;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel (the first design, kept for float32 inputs)
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int W = 64;            // head dim (key and value)
constexpr int LD = W + 1;        // padded row of a staged 64-wide tile
constexpr int QL = Q + 1;        // padded row of a Q x Q tile
constexpr int THREADS = 256;     // 16 x 16

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

  const float* rb = static_cast<const float*>(p.r) + b * p.r_sb + h * p.r_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* wb = p.logw + b * p.w_sb + h * p.w_sh;
  const float* ub = p.u + (long long)h * W;
  const long long row = (long long)H * W;           // time stride of dy and the outputs
  const long long obase = ((long long)b * S * H + h) * W;
  const long long hbase = ((long long)b * H + h) * W * W;
  float* states = static_cast<float*>(p.scratch) + hbase * p.nc;

  // Stage rows [c0, c0 + nv) (zero past S), then the per-channel cumsum of
  // w in threads 0..63, sequential over the chunk.
  auto stage = [&](int c0, int nv, bool all) {
    for (int e = tid; e < Q * W; e += THREADS) {
      const int t = e / W, c = e % W;
      const long long s = c0 + t;
      const bool ok = t < nv;
      k_s[t * LD + c] = ok ? kb[s * p.k_ss + c] : 0.f;
      v_s[t * LD + c] = ok ? vb[s * p.v_ss + c] : 0.f;
      cw_s[t * LD + c] = ok ? wb[s * p.w_ss + c] : 0.f;
      if (all) {
        r_s[t * LD + c] = ok ? rb[s * p.r_ss + c] : 0.f;
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
            static_cast<float*>(p.dr)[o + cc] = dra[a][k] + uv * kv * diag;
            static_cast<float*>(p.dk)[o + cc] = dka[a][k] + uv * rv * diag;
            static_cast<float*>(p.dv)[o + cc] = dvv[a][k] + bon * dy_s[t * LD + cc];
            du_acc[k] = fmaf(rv * kv, diag, du_acc[k]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) colp_s[ty * W + tx + 16 * k] = colp[k];
    }

    // (3) rowsum(S o dS) with dS before this chunk's update, and the new dS =
    // exp(cw_Q) o dS + sum_t (r_t o exp(a_t))^float dy_t in registers.
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

cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int smem = smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(wkv6_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, B);
  wkv6_bwd_kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}


}  // namespace f32

}  // namespace

// Shared memory a block takes: dtype 1 (bf16) kernel 0 the sums, 1 the
// chunk kernel (the scans take none); dtype 0 (f32) the CUDA-core kernel.
extern "C" int wkv6_bwd_smem_bytes(int dtype, int kernel) {
  if (dtype == 0) return f32::smem_floats() * (int)sizeof(float);
  if (dtype == 1) return kernel == 0 ? tc::SUMS_SMEM : tc::CHUNK_SMEM;
  return -1;
}

// Blocks an SM holds of a bf16 kernel (0 the sums, 1 the chunk kernel).
extern "C" int wkv6_bwd_bf16_blocks_per_sm(int kernel) {
  return kernel == 0 || kernel == 1 ? tc::blocks_per_sm(kernel) : -1;
}

// Bytes of the scratch: bf16, tc::Scratch (the chunk-start states and the
// end-of-chunk state gradients as hi / lo bf16 halves, each chunk's U_c and
// W_c in f32, e^{cw_Q} of each chunk); f32, the chunk-start states,
// (B,H,nc,hd,hd) f32.
extern "C" long long wkv6_bwd_scratch_bytes(int B, int S, int H, int dtype) {
  const long long chunks = (long long)B * H * ((S + Q - 1) / Q), plane = 64 * 64;
  return dtype == 1 ? chunks * (2 * 2 * plane * 2 + 2 * plane * 4 + 64 * 4) : chunks * plane * 4;
}

// Rows of du's partials per batch: one per chunk (bf16), one (f32).
extern "C" int wkv6_bwd_du_parts(int S, int dtype) { return dtype == 1 ? (S + Q - 1) / Q : 1; }

// Plain C entry point (loaded with ctypes).  Strides are in elements; the
// last dim of r, k, v and logw must be contiguous; dy and every output are
// contiguous.  s0 and dS_last may be null.  dtype of r, k, v and of dr, dk,
// dv: 0 = float32, 1 = bfloat16; everything else is float32.  scratch holds
// wkv6_bwd_scratch_bytes, du_part (B, wkv6_bwd_du_parts, H, hd) f32.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* logw,
                        const void* u, const void* s0, const void* dy, const void* dS_last,
                        void* scratch, void* dr, void* dk, void* dv, void* dlogw,
                        void* du_part, void* ds0, int B, int S, int H, int hd,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || hd != 64) return (int)cudaErrorInvalidValue;
  Params p;
  p.r = r; p.k = k; p.v = v; p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u); p.s0 = static_cast<const float*>(s0);
  p.dy = static_cast<const float*>(dy); p.dS_last = static_cast<const float*>(dS_last);
  p.scratch = scratch;
  p.dr = dr; p.dk = dk; p.dv = dv; p.dlogw = static_cast<float*>(dlogw);
  p.du_part = static_cast<float*>(du_part); p.ds0 = static_cast<float*>(ds0);
  p.S = S; p.H = H; p.nc = (S + Q - 1) / Q;
  p.r_sb = r_sb; p.r_ss = r_ss; p.r_sh = r_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.w_sb = w_sb; p.w_ss = w_ss; p.w_sh = w_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)f32::launch(p, B, s);
  if (dtype == 1) return (int)tc::launch(p, B, s);
  return (int)cudaErrorInvalidValue;
}
