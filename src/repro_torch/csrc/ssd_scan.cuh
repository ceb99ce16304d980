// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas
// (_ssd_kernel).  The Pallas grid (B, H, L/Q) walks the chunk axis in
// order and carries the (P, N) state in VMEM scratch.  Blocks on the card
// run in no order, so a thread block loops over the chunks itself.  Per
// chunk of q <= Q steps (the last one may be ragged and is masked):
//
//   cum_t   = sum_{u<=t} log_a_u                      (block scan)
//   y_t     = sum_{s<=t} exp(cum_t - cum_s) (c_t . b_s) x_s
//             + exp(cum_t) c_t . S                     (S: state before)
//   S       = exp(cum_q) S + sum_s exp(cum_q - cum_s) x_s b_s^T
//
// x, b and c arrive as bf16 (in place, or staged as hi and lo halves:
// the operand modes below), log_a and the state as f32; x, b and c are read in their (B,
// L, ., .) layouts through batch and time strides (no transposed copy);
// head h reads B/C group h / (H / G).  The builds: ssd_scan.cu (bf16 in
// place) and ssd_scan_staged.cu (staged hi / lo).
//
// Bound on an H100: bytes.  The products come to about q^2 (N + P) + 4qPN
// flops per (b, h) and chunk, which the tensor cores run in less time than
// it takes to read and write the f32 state (B H P N x 4 bytes, each way)
// and the x/b/c/y rows, at every serving shape.  The design:
//
// * P split across blocks.  The grid is (P / PT, H, B): a block owns rows
//   [p0, p0 + PT) of its head's state and the same columns of y, so the
//   state stays on chip over the chunk loop with no exchange between
//   blocks (B 2, H 80, P 64: 320 blocks on 132 SMs, where one block per
//   (b, h) gave 160).  Each block recomputes C B^T for its chunk.
// * All products on mma.sync m16n8k16 bf16 -> f32.  The intra-chunk part
//   is causal attention with C as queries, B as keys, x as values and the
//   decay in place of the softmax: a warp takes 16 rows t, loads their C
//   fragments from device memory into registers, and walks the keys
//   s <= t in 16-key tiles.  G = C B^T is exact on bf16 operands; M = G o
//   decay is f32 and enters the product with x as bf16 hi + lo, hi =
//   bf16(M), lo = bf16(M - hi), about 16 bits (the prefill kernels'
//   EXACT scheme).  In C S^T the state enters as hi + lo; in the update
//   x^T (w o B), w o B is split the same way in registers after ldmatrix.
//   TF32 (10 bits) could not hold the state to 1e-4.
// * The state lives in registers: each warp owns (16 p x 8 n) tiles of
//   the update, sums the chunk's products on the tensor cores into a zero
//   accumulator and folds them in as S = exp(cum_q) S + U with f32 FMAs.
//   Its hi and lo halves wait in shared memory for the next chunk's C S^T.
//   It enters and leaves through shared memory by 16-byte coalesced copies.
// * Short and ragged chunks run as 16-row tiles: rows from q on are
//   zero-filled by cp.async (their cum is cum_q, their weight w = 0).
//   exp(cum_t - cum_s) is formed only where s <= t, by a select: on the
//   other side it can overflow, and 0 * inf would be NaN.
// * Shared memory holds the chunk's B rows, x slice, the state's halves
//   and cum (at q 256, N 128: 106 KB, two blocks per SM).
// * N past 128 (the slabbed build: every multiple of 128, as N / 128
//   column slabs of 128 over blocks, the slab count a grid dimension): a
//   block owns its P rows of one 128-column slab of the state, so it runs
//   the N-128 body (its registers, its shared layout, two blocks per SM)
//   at N / 128 times the grid.  A slab's state is updated from its own
//   columns of B alone; y sums over N, so each block writes its slab's
//   share of y as f32 partials, (B, L, H, NS, P), and
//   ssd_scan_fwd_sum_kernel adds them in slab order.  One block of the
//   full width at N 256 would hold 32 + 32 f32 of state and update a
//   thread and 190 KB of shared memory at q 256 in FAST (one block per
//   SM), and 346 KB in SPLIT, past the 227 KB a block may use.
//
// Operand modes (the MODE parameter of every kernel here).  FAST reads
// bf16 x, b and c in place (heads, groups and features packed, rows on
// 16-byte boundaries, N one of the builds, P a multiple of 8): the path
// and numbers of the bf16 serving and training shapes.  Any other operand
// the reference's scan takes is first copied by ssd_stage_kernel
// (ssd_scan_staged.cu) into a packed, zero-padded scratch: x and dY as
// (B, L, H, Pp), Pp = P rounded up to 8, b and c as (B, L, G, N) on the
// next build up (columns past the true width zero: they add nothing to
// C B^T, and the state's columns past it stay zero).  SPLIT holds the
// bf16 hi and lo halves of every element, lo = bf16(v - hi) (0 for bf16
// data), at a fixed element offset from hi.  Each product of two data
// operands is then three tensor-core products,
// hi hi + lo hi + hi lo (about 16 bits, as the f32 factors), and the
// register-held operand's lo fragments are read from device memory where
// they are used.  Outputs go straight to the caller's dtype and layout:
// y and dX per element (masked at a ragged P), the state at its true
// width.
#pragma once
#include <atomic>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;   // threads per block; also the largest chunk (one scan step each)
constexpr int NW = NT / 32;
constexpr int PT = 32;    // state rows (features p of the head) per block
constexpr int FAST = 0, SPLIT = 1;   // operand modes (see above)

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// shared memory, for rows = q rounded up to 16: B rows (rows x N bf16),
// which at the start and the end hold the f32 state slice (PT x N) instead
// | x slice (rows x PT) bf16 | the state's hi and lo halves (PT x N) bf16
// | cum (rows) f32 | scan partials (NW) f32.  Row strides are padded by 16
// bytes, so ldmatrix and the accumulator layout's accesses hit no bank
// twice.  In SPLIT the B rows and the x slice are each followed by their
// lo halves.  kernels/ssd_scan.py:launch_geometry mirrors this layout.
template <int N, int MODE = FAST>
struct SsdSmem {
  static constexpr int K = MODE == SPLIT ? 2 : 1;   // bf16 copies of a data row
  static constexpr int LDB = N + 8;
  static constexpr int LDX = PT + 8;
  static constexpr int LDF = N + 8;
  size_t b, x, sh, sl, cum, part, bytes;
  __host__ __device__ SsdSmem(int rows) {
    b = 0;
    x = cmax(K * sizeof(bf16) * rows * LDB, sizeof(float) * PT * LDF);
    sh = x + K * sizeof(bf16) * rows * LDX;
    sl = sh + sizeof(bf16) * PT * LDB;
    cum = sl + sizeof(bf16) * PT * LDB;
    part = cum + sizeof(float) * rows;
    bytes = part + sizeof(float) * NW;
  }
};

// two f32 values as bf16 hi and lo halves (hi = bf16(v), lo = bf16(v - hi))
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(a, b);
  lo = pack_bf16(a - __uint_as_float(hi << 16), b - __uint_as_float(hi & 0xffff0000u));
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// an output's element type (y, dX, dB and dC, dlog_a: ScanArgs.flags)
enum : int { OT_BF16 = 0, OT_F32 = 1, OT_F16 = 2 };

// one value into the caller's array of type ot
__device__ __forceinline__ void put_out(void* out, long long i, float v, int ot) {
  if (ot == OT_F32) reinterpret_cast<float*>(out)[i] = v;
  else if (ot == OT_F16) reinterpret_cast<__half*>(out)[i] = __float2half_rn(v);
  else reinterpret_cast<bf16*>(out)[i] = __float2bfloat16_rn(v);
}

// one k16 chunk (k) of load_frags' A fragments: rows ra and rb of a bf16
// matrix in device memory, row pitch ld elements, every column live
__device__ __forceinline__ void load_frag(uint32_t (&f)[4], const bf16* base, long long ld,
                                          int ra, int rb, bool a_in, bool b_in, int k, int t4) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(base + (a_in ? ra : 0) * ld) + t4;
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(base + (b_in ? rb : 0) * ld) + t4;
  f[0] = a_in ? __ldg(pa + k * 8) : 0u;
  f[1] = b_in ? __ldg(pb + k * 8) : 0u;
  f[2] = a_in ? __ldg(pa + k * 8 + 4) : 0u;
  f[3] = b_in ? __ldg(pb + k * 8 + 4) : 0u;
}

// The forward.  Past FAST's arguments: xp, x's head pitch (Pp when
// staged); nst, the state's true width (the final state's row pitch);
// xlo and blo, the element offsets of x's and b's / c's lo halves
// (SPLIT); yt, y's type (OT_*; bf16 in FAST: y's type below).  NS 0: the
// slabbed build (see above), N the slab's width and nsl the slab count
// (else NS 1 and nsl unused); y is then the f32 partials.
template <int N, int MODE, int NS = 1>
__global__ void __launch_bounds__(NT, MODE == SPLIT ? 1 : 2)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                const float* __restrict__ init, bf16* __restrict__ y,
                float* __restrict__ st, float* __restrict__ cst, int L, int H, int P, int G, int Q,
                long long sxb, long long sxl, long long sab, long long sal,
                long long sbb, long long sbl, int xp, int nst, long long xlo, long long blo,
                int yt, int nsl) {
  using Sm = SsdSmem<N, MODE>;
  constexpr int LDB = Sm::LDB, LDX = Sm::LDX, LDF = Sm::LDF;
  const int ns_n = NS ? NS : nsl;   // column slabs
  const int NF = N * ns_n;   // the build width: the state's and b's / c's row pitch
  constexpr int KC = N / 16;   // k16 chunks of C B^T and C S^T
  constexpr int YT = PT / 8;   // n8 tiles of a y row tile
  // the update's (16 p x 8 n) tiles: with at least NW n8 columns a warp
  // owns UN of them over both p tiles, else one (p tile, n8 tile) each
  constexpr bool WIDE = N / 8 >= NW;
  constexpr int UN = WIDE ? N / 8 / NW : 1;
  constexpr int UP = WIDE ? PT / 16 : 1;
  static_assert(UN <= 2 && PT % 16 == 0, "one x4 ldmatrix of B per k16 step");
  extern __shared__ __align__(128) unsigned char smem[];
  const Sm sm((Q + 15) & ~15);
  bf16* Bs = reinterpret_cast<bf16*>(smem + sm.b);
  float* Sf = reinterpret_cast<float*>(smem + sm.b);
  bf16* Xs = reinterpret_cast<bf16*>(smem + sm.x);
  bf16* Sh = reinterpret_cast<bf16*>(smem + sm.sh);
  bf16* Sl = reinterpret_cast<bf16*>(smem + sm.sl);
  float* cum = reinterpret_cast<float*>(smem + sm.cum);
  float* part = reinterpret_cast<float*>(smem + sm.part);

  const int ns = blockIdx.x % ns_n, n0 = ns * N;   // this block's column slab
  const int p0 = blockIdx.x / ns_n * PT, h = blockIdx.y, bb = blockIdx.z;
  const int prow = min(PT, P - p0);   // live state rows of this block
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int xpitch = MODE == FAST ? P : xp;
  const bf16* xb = x + bb * sxb + (long long)h * xpitch + p0;
  const float* ab = la + bb * sab + h;
  const bf16* bg = bm + bb * sbb + (long long)grp * NF + n0;
  const bf16* cg = cm + bb * sbb + (long long)grp * NF + n0;
  const long long ystep = (long long)H * ns_n * P;
  bf16* yb = y + (long long)bb * L * ystep + (long long)h * P + p0;
  const long long soff = (((long long)bb * H + h) * P + p0) * NF + n0;
  const int un0 = WIDE ? warp * UN : warp >> 1;   // this warp's first n8 tile
  const int up0 = WIDE ? 0 : warp & 1;            // and first p tile
  const bool upd = WIDE || warp < 2 * (N / 8);

  // the state slice in: 16-byte copies into Sf (rows from P on, or no
  // init: zeros), then the update's accumulators and the hi / lo halves
  for (int i = tid; i < PT * N / 4; i += NT) {
    const int r = i / (N / 4), c4 = (i % (N / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (init != nullptr && r < prow)
      v = __ldg(reinterpret_cast<const float4*>(init + soff + (long long)r * NF + c4));
    *reinterpret_cast<float4*>(Sf + r * LDF + c4) = v;
  }
  __syncthreads();
  float sacc[UP][UN][4];
  #pragma unroll
  for (int up = 0; up < UP; ++up) {
    #pragma unroll
    for (int un = 0; un < UN; ++un) {
      const int r = (up0 + up) * 16 + g, c = (un0 + un) * 8 + 2 * t4;
      const float2 a = upd ? *reinterpret_cast<const float2*>(Sf + r * LDF + c) : float2{};
      const float2 b = upd ? *reinterpret_cast<const float2*>(Sf + (r + 8) * LDF + c) : float2{};
      sacc[up][un][0] = a.x;
      sacc[up][un][1] = a.y;
      sacc[up][un][2] = b.x;
      sacc[up][un][3] = b.y;
    }
  }
  for (int i = tid; i < PT * N / 2; i += NT) {
    const int r = i / (N / 2), c = (i % (N / 2)) * 2;
    const float2 v = *reinterpret_cast<const float2*>(Sf + r * LDF + c);
    uint32_t hi, lo;
    split_bf16(v.x, v.y, hi, lo);
    *reinterpret_cast<uint32_t*>(Sh + r * LDB + c) = hi;
    *reinterpret_cast<uint32_t*>(Sl + r * LDB + c) = lo;
  }
  __syncthreads();   // Sf is read: B rows may overwrite it

  const int nc = (L + Q - 1) / Q;
  for (int t0 = 0; t0 < L; t0 += Q) {
    const int q = min(Q, L - t0), rows = (q + 15) & ~15;
    // under grad, the state entering this chunk for the backward: the
    // accumulators' live rows as they stand, (B, H, nc, P, N) f32
    if (cst != nullptr && upd) {
      float* dst = cst + ((((long long)bb * H + h) * nc + t0 / Q) * P + p0) * NF + n0;
      #pragma unroll
      for (int up = 0; up < UP; ++up) {
        #pragma unroll
        for (int un = 0; un < UN; ++un) {
          const int r = (up0 + up) * 16 + g, c = (un0 + un) * 8 + 2 * t4;
          if (r < prow)
            *reinterpret_cast<float2*>(dst + (long long)r * NF + c) =
                make_float2(sacc[up][un][0], sacc[up][un][1]);
          if (r + 8 < prow)
            *reinterpret_cast<float2*>(dst + (long long)(r + 8) * NF + c) =
                make_float2(sacc[up][un][2], sacc[up][un][3]);
        }
      }
    }
    // this chunk's B rows and x slice; rows from q on (and x columns from
    // P on) zero-filled, reading nothing
    for (int i = tid; i < rows * (N / 8); i += NT) {
      const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
      const bool in = r < q;
      cp_async16_fill(Bs + r * LDB + c8, bg + (long long)(t0 + (in ? r : 0)) * sbl + c8,
                      in ? 16 : 0);
    }
    for (int i = tid; i < rows * (PT / 8); i += NT) {
      const int r = i / (PT / 8), c8 = (i % (PT / 8)) * 8;
      const bool in = r < q && c8 < prow;
      cp_async16_fill(Xs + r * LDX + c8, xb + (long long)(t0 + (in ? r : 0)) * sxl + (in ? c8 : 0),
                      in ? 16 : 0);
    }
    if constexpr (MODE == SPLIT) {   // the lo halves after the hi ones
      for (int i = tid; i < rows * (N / 8); i += NT) {
        const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
        const bool in = r < q;
        cp_async16_fill(Bs + rows * LDB + r * LDB + c8,
                        bg + blo + (long long)(t0 + (in ? r : 0)) * sbl + c8, in ? 16 : 0);
      }
      for (int i = tid; i < rows * (PT / 8); i += NT) {
        const int r = i / (PT / 8), c8 = (i % (PT / 8)) * 8;
        const bool in = r < q && c8 < prow;
        cp_async16_fill(Xs + rows * LDX + r * LDX + c8,
                        xb + xlo + (long long)(t0 + (in ? r : 0)) * sxl + (in ? c8 : 0),
                        in ? 16 : 0);
      }
    }
    cp_async_commit();

    // inclusive block scan of log_a over the chunk (one step per thread,
    // 0 from q on, so rows past the ragged edge carry cum_q)
    float v = tid < q ? ab[(long long)(t0 + tid) * sal] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) part[warp] = v;
    cp_async_wait<0>();
    __syncthreads();
    float pre = 0.f;
    for (int w = 0; w < warp; ++w) pre += part[w];
    if (tid < rows) cum[tid] = v + pre;
    __syncthreads();
    const float cum_end = cum[q - 1];

    // y, one 16-row tile per warp at a time; tiles longest first, in a
    // snake over the warps so that each warp's total is about even
    const int n_rt = rows / 16;
    for (int k = 0; k * NW < n_rt; ++k) {
      const int idx = k * NW + ((k & 1) ? NW - 1 - warp : warp);
      if (idx >= n_rt) continue;
      const int r0 = (n_rt - 1 - idx) * 16;
      const int ta = r0 + g, tb = ta + 8;   // this thread's rows
      // C rows ta and tb as A fragments, from device memory (zeros from q on)
      uint32_t cf[KC][4];
      const uint32_t* ca = reinterpret_cast<const uint32_t*>(cg + (long long)(t0 + min(ta, q - 1)) * sbl) + t4;
      const uint32_t* cb = reinterpret_cast<const uint32_t*>(cg + (long long)(t0 + min(tb, q - 1)) * sbl) + t4;
      #pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        cf[kc][0] = ta < q ? __ldg(ca + kc * 8) : 0u;
        cf[kc][1] = tb < q ? __ldg(cb + kc * 8) : 0u;
        cf[kc][2] = ta < q ? __ldg(ca + kc * 8 + 4) : 0u;
        cf[kc][3] = tb < q ? __ldg(cb + kc * 8 + 4) : 0u;
      }
      // SPLIT: C's lo halves, rows ta and tb (zeros from q on)
      uint32_t cl[MODE == SPLIT ? KC : 1][4];
      if constexpr (MODE == SPLIT) {
        #pragma unroll
        for (int kc = 0; kc < KC; ++kc)
          load_frag(cl[kc], cg + blo + (long long)t0 * sbl, sbl, ta, tb, ta < q, tb < q, kc, t4);
      }
      // exp(cum_t) C S^T, S as hi + lo (n8 tiles of p)
      float acc[YT * 4];
      #pragma unroll
      for (int i = 0; i < YT * 4; ++i) acc[i] = 0.f;
      #pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        #pragma unroll
        for (int pp = 0; pp < PT / 16; ++pp) {
          const int off = (pp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB + kc * 16 +
                          ((lane >> 3) & 1) * 8;
          uint32_t sb[4];
          ldsm_x4(sb, Sh + off);
          mma16816(acc + 8 * pp, cf[kc], sb[0], sb[1]);
          mma16816(acc + 8 * pp + 4, cf[kc], sb[2], sb[3]);
          if constexpr (MODE == SPLIT) {
            mma16816(acc + 8 * pp, cl[kc], sb[0], sb[1]);
            mma16816(acc + 8 * pp + 4, cl[kc], sb[2], sb[3]);
          }
          ldsm_x4(sb, Sl + off);
          mma16816(acc + 8 * pp, cf[kc], sb[0], sb[1]);
          mma16816(acc + 8 * pp + 4, cf[kc], sb[2], sb[3]);
        }
      }
      const float cum_a = cum[ta], cum_b = cum[tb];
      const float ea = expf(cum_a), eb = expf(cum_b);
      #pragma unroll
      for (int n = 0; n < YT; ++n) {
        acc[4 * n] *= ea;
        acc[4 * n + 1] *= ea;
        acc[4 * n + 2] *= eb;
        acc[4 * n + 3] *= eb;
      }
      // + sum_{s<=t} M[t][s] x_s over 16-key tiles
      for (int s0 = 0; s0 <= r0; s0 += 16) {
        float gs[8];
        #pragma unroll
        for (int i = 0; i < 8; ++i) gs[i] = 0.f;
        #pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t kb[4];
          ldsm_x4(kb, Bs + (s0 + (lane & 7) + ((lane >> 4) << 3)) * LDB + kc * 16 +
                          ((lane >> 3) & 1) * 8);
          mma16816(gs, cf[kc], kb[0], kb[1]);
          mma16816(gs + 4, cf[kc], kb[2], kb[3]);
          if constexpr (MODE == SPLIT) {   // + C_lo B_hi + C_hi B_lo
            mma16816(gs, cl[kc], kb[0], kb[1]);
            mma16816(gs + 4, cl[kc], kb[2], kb[3]);
            ldsm_x4(kb, Bs + (rows + s0 + (lane & 7) + ((lane >> 4) << 3)) * LDB + kc * 16 +
                            ((lane >> 3) & 1) * 8);
            mma16816(gs, cf[kc], kb[0], kb[1]);
            mma16816(gs + 4, cf[kc], kb[2], kb[3]);
          }
        }
        // M = G o exp(cum_t - cum_s) where s <= t, else 0 (a select)
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = s0 + 8 * j + 2 * t4;
          const float2 cs = *reinterpret_cast<const float2*>(cum + s);
          float* e = gs + 4 * j;
          e[0] = s <= ta ? e[0] * ex2((cum_a - cs.x) * LOG2E) : 0.f;
          e[1] = s + 1 <= ta ? e[1] * ex2((cum_a - cs.y) * LOG2E) : 0.f;
          e[2] = s <= tb ? e[2] * ex2((cum_b - cs.x) * LOG2E) : 0.f;
          e[3] = s + 1 <= tb ? e[3] * ex2((cum_b - cs.y) * LOG2E) : 0.f;
        }
        // the accumulator of the two n8 tiles is M's A fragment for these
        // 16 keys, as bf16 hi + lo
        uint32_t mh[4], ml[4];
        #pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(gs[2 * i], gs[2 * i + 1], mh[i], ml[i]);
        #pragma unroll
        for (int dp = 0; dp < PT / 16; ++dp) {
          uint32_t xv[4];
          ldsm_x4_t(xv, Xs + (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX + dp * 16 +
                            (lane >> 4) * 8);
          mma16816(acc + 8 * dp, mh, xv[0], xv[1]);
          mma16816(acc + 8 * dp + 4, mh, xv[2], xv[3]);
          mma16816(acc + 8 * dp, ml, xv[0], xv[1]);
          mma16816(acc + 8 * dp + 4, ml, xv[2], xv[3]);
          if constexpr (MODE == SPLIT) {   // + M_hi x_lo
            ldsm_x4_t(xv, Xs + (rows + s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX +
                              dp * 16 + (lane >> 4) * 8);
            mma16816(acc + 8 * dp, mh, xv[0], xv[1]);
            mma16816(acc + 8 * dp + 4, mh, xv[2], xv[3]);
          }
        }
      }
      if constexpr (MODE == FAST && NS == 1) {
        #pragma unroll
        for (int n = 0; n < YT; ++n) {
          const int c = n * 8 + 2 * t4;
          if (c < prow) {
            if (ta < q)
              *reinterpret_cast<uint32_t*>(yb + (long long)(t0 + ta) * ystep + c) =
                  pack_bf16(acc[4 * n], acc[4 * n + 1]);
            if (tb < q)
              *reinterpret_cast<uint32_t*>(yb + (long long)(t0 + tb) * ystep + c) =
                  pack_bf16(acc[4 * n + 2], acc[4 * n + 3]);
          }
        }
      } else {   // per element, in y's dtype (f32 partials past one slab), masked at a ragged P
        const int ot = NS != 1 ? OT_F32 : yt;
        #pragma unroll
        for (int n = 0; n < YT; ++n) {
          const int c = n * 8 + 2 * t4;
          const long long yo = (long long)bb * L * ystep + ((long long)h * ns_n + ns) * P + p0;
          const long long ra = yo + (long long)(t0 + ta) * ystep + c;
          const long long rb = yo + (long long)(t0 + tb) * ystep + c;
          if (ta < q && c < prow) put_out(y, ra, acc[4 * n], ot);
          if (ta < q && c + 1 < prow) put_out(y, ra + 1, acc[4 * n + 1], ot);
          if (tb < q && c < prow) put_out(y, rb, acc[4 * n + 2], ot);
          if (tb < q && c + 1 < prow) put_out(y, rb + 1, acc[4 * n + 3], ot);
        }
      }
    }

    // S = exp(cum_q) S + x^T (w o B), w_s = exp(cum_q - cum_s) (0 from q
    // on); U, the chunk's sum, in a zero accumulator
    if (upd) {
      float u[UP][UN][4] = {};
      for (int s0 = 0; s0 < rows; s0 += 16) {
        uint32_t xa[UP][4];   // x^T: rows p, k = s
        uint32_t xal[MODE == SPLIT ? UP : 1][4];
        #pragma unroll
        for (int up = 0; up < UP; ++up) {
          ldsm_x4_t(xa[up], Xs + (s0 + (lane & 7) + (lane >> 4) * 8) * LDX + (up0 + up) * 16 +
                                ((lane >> 3) & 1) * 8);
          if constexpr (MODE == SPLIT)
            ldsm_x4_t(xal[up], Xs + (rows + s0 + (lane & 7) + (lane >> 4) * 8) * LDX +
                                   (up0 + up) * 16 + ((lane >> 3) & 1) * 8);
        }
        const int s = s0 + 2 * t4;   // this thread's keys s, s + 1, s + 8, s + 9
        const float2 c01 = *reinterpret_cast<const float2*>(cum + s);
        const float2 c89 = *reinterpret_cast<const float2*>(cum + s + 8);
        const float w0 = s < q ? expf(cum_end - c01.x) : 0.f;
        const float w1 = s + 1 < q ? expf(cum_end - c01.y) : 0.f;
        const float w8 = s + 8 < q ? expf(cum_end - c89.x) : 0.f;
        const float w9 = s + 9 < q ? expf(cum_end - c89.y) : 0.f;
        uint32_t bv[4];   // B: rows k = s, n8 tiles un0, un0 + 1
        ldsm_x4_t(bv, Bs + (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + un0 * 8 +
                          (UN == 2 ? (lane >> 4) * 8 : 0));
        if constexpr (MODE == SPLIT) {   // w o B from B's hi + lo
          uint32_t bl[4];
          ldsm_x4_t(bl, Bs + (rows + s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDB + un0 * 8 +
                            (UN == 2 ? (lane >> 4) * 8 : 0));
          #pragma unroll
          for (int un = 0; un < UN; ++un) {
            const uint32_t b0 = bv[2 * un], b1 = bv[2 * un + 1];
            const uint32_t e0 = bl[2 * un], e1 = bl[2 * un + 1];
            uint32_t h0, l0, h1, l1;
            split_bf16((bf_lo(b0) + bf_lo(e0)) * w0, (bf_hi(b0) + bf_hi(e0)) * w1, h0, l0);
            split_bf16((bf_lo(b1) + bf_lo(e1)) * w8, (bf_hi(b1) + bf_hi(e1)) * w9, h1, l1);
            #pragma unroll
            for (int up = 0; up < UP; ++up) {
              mma16816(u[up][un], xa[up], h0, h1);
              mma16816(u[up][un], xa[up], l0, l1);
              mma16816(u[up][un], xal[up], h0, h1);
            }
          }
        } else {
          #pragma unroll
          for (int un = 0; un < UN; ++un) {
            const uint32_t b0 = bv[2 * un], b1 = bv[2 * un + 1];
            uint32_t h0, l0, h1, l1;
            split_bf16(__uint_as_float(b0 << 16) * w0, __uint_as_float(b0 & 0xffff0000u) * w1, h0, l0);
            split_bf16(__uint_as_float(b1 << 16) * w8, __uint_as_float(b1 & 0xffff0000u) * w9, h1, l1);
            #pragma unroll
            for (int up = 0; up < UP; ++up) {
              mma16816(u[up][un], xa[up], h0, h1);
              mma16816(u[up][un], xa[up], l0, l1);
            }
          }
        }
      }
      const float dec = expf(cum_end);
      #pragma unroll
      for (int up = 0; up < UP; ++up) {
        #pragma unroll
        for (int un = 0; un < UN; ++un) {
          #pragma unroll
          for (int i = 0; i < 4; ++i) sacc[up][un][i] = fmaf(dec, sacc[up][un][i], u[up][un][i]);
        }
      }
    }
    __syncthreads();   // every warp is done with Bs, Xs, cum and the old halves
    if (upd && t0 + Q < L) {
      #pragma unroll
      for (int up = 0; up < UP; ++up) {
        #pragma unroll
        for (int un = 0; un < UN; ++un) {
          const int r = (up0 + up) * 16 + g, c = (un0 + un) * 8 + 2 * t4;
          uint32_t hi, lo;
          split_bf16(sacc[up][un][0], sacc[up][un][1], hi, lo);
          *reinterpret_cast<uint32_t*>(Sh + r * LDB + c) = hi;
          *reinterpret_cast<uint32_t*>(Sl + r * LDB + c) = lo;
          split_bf16(sacc[up][un][2], sacc[up][un][3], hi, lo);
          *reinterpret_cast<uint32_t*>(Sh + (r + 8) * LDB + c) = hi;
          *reinterpret_cast<uint32_t*>(Sl + (r + 8) * LDB + c) = lo;
        }
      }
    }
  }

  // the state out through Sf (the last chunk ended on a barrier), by
  // 16-byte coalesced stores of the live rows
  if (upd) {
    #pragma unroll
    for (int up = 0; up < UP; ++up) {
      #pragma unroll
      for (int un = 0; un < UN; ++un) {
        const int r = (up0 + up) * 16 + g, c = (un0 + un) * 8 + 2 * t4;
        *reinterpret_cast<float2*>(Sf + r * LDF + c) = make_float2(sacc[up][un][0], sacc[up][un][1]);
        *reinterpret_cast<float2*>(Sf + (r + 8) * LDF + c) =
            make_float2(sacc[up][un][2], sacc[up][un][3]);
      }
    }
  }
  __syncthreads();
  if constexpr (MODE == FAST) {
    for (int i = tid; i < prow * N / 4; i += NT) {
      const int r = i / (N / 4), c4 = (i % (N / 4)) * 4;
      *reinterpret_cast<float4*>(st + soff + (long long)r * NF + c4) =
          *reinterpret_cast<const float4*>(Sf + r * LDF + c4);
    }
  } else {   // the true width nst, per element (the slab's columns below it)
    const long long so = (((long long)bb * H + h) * P + p0) * nst + n0;
    const int ncol = NS == 1 ? nst : min(N, nst - n0);
    for (int i = tid; i < prow * ncol; i += NT) {
      const int r = i / ncol, c = i % ncol;
      st[so + (long long)r * nst + c] = Sf[r * LDF + c];
    }
  }
}

// the forward's launch arguments past the operands (ssd_scan.cu and
// ssd_scan_staged.cu pass them through): FAST reads only the first row
struct ScanArgs {
  int B, L, H, P, G, Q;
  long long sxb, sxl, sab, sal, sbb, sbl;
  int xp, nst;            // x's (and dY's) head pitch; the state's true width
  long long xlo, blo;     // SPLIT: element offsets of the lo halves
  int flags;              // OUT_* bits: the outputs' dtypes
};
constexpr int OUT_F32 = 1;       // y, or dX, is f32 (else bf16)
constexpr int OUT_BC_F32 = 2;    // dB and dC are f32 (else bf16)
constexpr int OUT_LA_BF16 = 4;   // dlog_a is bf16 (else f32)
constexpr int OUT_F16 = 8;       // y, or dX, is f16 (staged builds)
constexpr int OUT_BC_F16 = 16;   // dB and dC are f16
constexpr int OUT_LA_F16 = 32;   // dlog_a is f16
// the outputs' types (OT_*) from the flags: y or dX, dB and dC, dlog_a
inline int y_type(int f) { return f & OUT_F32 ? OT_F32 : f & OUT_F16 ? OT_F16 : OT_BF16; }
inline int bc_type(int f) { return f & OUT_BC_F32 ? OT_F32 : f & OUT_BC_F16 ? OT_F16 : OT_BF16; }
inline int la_type(int f) { return f & OUT_LA_BF16 ? OT_BF16 : f & OUT_LA_F16 ? OT_F16 : OT_F32; }

// a kernel's opt-in to `bytes` of dynamic shared memory, once per device
// (the attribute belongs to the function, not to the launch)
template <typename F>
int opt_in(F* kernel, std::atomic<unsigned long long>& opted, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((opted.load(std::memory_order_relaxed) >> dev) & 1)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    opted.fetch_or(1ull << dev, std::memory_order_relaxed);
  }
  return 0;
}

// out[i, j] = sum over k, in order, of part[i, k, j] (f32 partials of J
// columns; the first Jo of them out), in out's type ot
__device__ __forceinline__ void sum_rows(const float* __restrict__ part, void* __restrict__ out,
                                         int ot, long long I, int K, int J, int Jo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I * Jo) return;
  const long long row = i / Jo;
  const int j = (int)(i % Jo);
  const float* src = part + row * K * J + j;
  float sum = 0.f;
  for (int k = 0; k < K; ++k) sum += src[(long long)k * J];
  put_out(out, i, sum, ot);
}

// the backward's sums (dB, dC, dX and dlog_a partials)
__global__ void sum_mid_kernel(const float* __restrict__ part, void* __restrict__ out, int ot,
                               long long I, int K, int J, int Jo) {
  sum_rows(part, out, ot, I, K, J, Jo);
}

// the forward's: y's partials per column slab of the slabbed build (a name
// of its own, so a profile counts it with the forward)
__global__ void ssd_scan_fwd_sum_kernel(const float* __restrict__ part, void* __restrict__ out,
                                        int ot, long long I, int K, int J, int Jo) {
  sum_rows(part, out, ot, I, K, J, Jo);
}

// the sum into `out` of type ot (OT_*), by the backward's kernel or (fwd)
// the forward's
int sum_mid(const float* part, void* out, int ot, long long I, int K, int J, int Jo,
            cudaStream_t stream, bool fwd = false) {
  const long long n = I * Jo;
  auto* kernel = fwd ? ssd_scan_fwd_sum_kernel : sum_mid_kernel;
  kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(part, out, ot, I, K, J, Jo);
  return (int)cudaGetLastError();
}

// The builds: one block's state widths (16, 32, 64, 128), and the
// slabbed build, every multiple of 128 past it as N / 128 column slabs of
// 128 over blocks (the slab count a grid dimension, not a template
// argument).  The state widths the entry points take, and their slabs.
constexpr int N_SLAB = 128;
__host__ __device__ constexpr bool is_build(int N) {
  return N == 16 || N == 32 || N == 64 || N == 128 || (N > N_SLAB && N % N_SLAB == 0);
}
__host__ __device__ constexpr int slabs_of(int N) { return N > N_SLAB ? N / N_SLAB : 1; }

// ypart: the slabbed build's y partials, (B, L, H, ns, P) f32 (else
// unused).  N: one block's width (NS 1), or N_SLAB with NS 0 and ns slabs
template <int N, int MODE, int NS>
int launch(const void* x, const float* log_a, const void* b, const void* c, const float* init,
           void* y, float* st, float* cst, float* ypart, const ScanArgs& a, int ns,
           cudaStream_t stream) {
  // the kernel opts in to the largest chunk's shared bytes
  static std::atomic<unsigned long long> opted{0};
  const int rc = opt_in(ssd_scan_kernel<N, MODE, NS>, opted, SsdSmem<N, MODE>(NT).bytes);
  if (rc != 0) return rc;
  const size_t smem = SsdSmem<N, MODE>((a.Q + 15) & ~15).bytes;
  dim3 grid((a.P + PT - 1) / PT * ns, a.H, a.B);
  ssd_scan_kernel<N, MODE, NS><<<grid, NT, smem, stream>>>(
      (const bf16*)x, log_a, (const bf16*)b, (const bf16*)c, init,
      (bf16*)(NS != 1 ? (void*)ypart : y), st, cst, a.L, a.H, a.P, a.G, a.Q, a.sxb, a.sxl,
      a.sab, a.sal, a.sbb, a.sbl, a.xp, a.nst, a.xlo, a.blo, y_type(a.flags), ns);
  const int err = (int)cudaGetLastError();
  if (err != 0 || NS == 1) return err;
  // y: the slabs' partials in slab order, in y's dtype
  return sum_mid(ypart, y, y_type(a.flags), (long long)a.B * a.L * a.H, ns, a.P, a.P, stream,
                 true);
}

// the forward at build width N (is_build(N))
template <int MODE>
int launch_n(int N, const void* x, const float* log_a, const void* b, const void* c,
             const float* init, void* y, float* st, float* cst, float* ypart, const ScanArgs& a,
             cudaStream_t stream) {
  switch (N) {
#define CS_SSD_N(n) \
  case n: return launch<n, MODE, 1>(x, log_a, b, c, init, y, st, cst, ypart, a, 1, stream);
    CS_SSD_N(16) CS_SSD_N(32) CS_SSD_N(64) CS_SSD_N(128)
#undef CS_SSD_N
    default:
      return launch<N_SLAB, MODE, 0>(x, log_a, b, c, init, y, st, cst, ypart, a, slabs_of(N),
                                     stream);
  }
}

// ---------------------------------------------------------------------
// The backward.  No TPU kernel to replace: the reference trains through
// its plain scan, which jax.grad differentiates.  Per (b, h) and chunk
// of q steps, with D[t,s] = exp(cum_t - cum_s) for s <= t (else 0),
// G = C B^T, M = D o G, R = dY X^T, K = M o R, w_s = exp(cum_q - cum_s),
// e_t = exp(cum_t), S_in the state entering the chunk (the forward
// writes it under grad) and dS the gradient of the state leaving it:
//
//   dX     = M^T dY + w o (B dS^T)
//   dB     = (D o R)^T C + w o (X dS)           (summed over B's group)
//   dC     = (D o R) B + e o (dY S_in)           (summed over C's group)
//   dS_in  = exp(cum_q) dS + (e o dY)^T C        (the previous chunk's dS)
//   dcum_t = sum_s K[t,s] - sum_s K[s,t] + e_t (dY_t . S_in C_t)
//            - w_t (dS . X_t^T B_t)
//   dcum_q += exp(cum_q) <dS, S_in> + sum_s w_s (dS . X_s^T B_s)
//   dlog_a = the reverse cumulative sum of dcum within the chunk
//
// Bound on an H100: operations.  About q^2 (3N + 2P) + 8qPN flops per
// (b, h) and chunk (ssd_scan_bwd_work), all of them products of bf16
// operands or of f32 factors that enter as bf16 hi + lo, against the
// bytes of x, dY, b, c and one state per chunk.  This replaces a first
// version that ran every product as f32 FMAs on the CUDA cores, one
// block of 8 warps per SM walking all chunks of a (P slice, head) in
// order, with f32 partials per P slice (13 ms at mamba2-2.7b's training
// shape, 200x its bound).  Only dS is carried from chunk to chunk;
// everything quadratic in q is chunk-local.  So three launches (the
// upstream Mamba-2 Triton backward's split), then the fixed-order sums:
//
// (a) ssd_scan_bwd_chunk_kernel, grid (chunks x P slabs, H, B): each
//     chunk's (e o dY)^T C (P x N f32) into the dS scratch, and cum_q.
//     mma.sync with e o dY as hi + lo (ldmatrix.trans of dY, scaled and
//     split in registers) and C bf16.  107.5 KB at q 256, N 128: two
//     blocks per SM.
// (b) ssd_scan_bwd_state_kernel, grid (P N / 1024, H, B): the one
//     sequential pass, f32 and elementwise.  From the last chunk, each
//     slot's (e o dY)^T C is replaced by the dS leaving that chunk, and
//     dS = exp(cum_q) dS + (e o dY)^T C; d_init is what is left.  The
//     scratch is (B, H, nc, P, N) f32, the size of the chunk states
//     (42 MB at the training shape), read and written once.
// (c) ssd_scan_bwd_kernel, grid (chunks x P slabs, H / hb, B): the rest,
//     with a whole P slab of up to PB = 64 columns (all of P at every
//     model's width) in one block, so R is whole and dlog_a is finished
//     in the block.  A block takes hb = 2 heads of one group when the
//     group's head count is even (B 2, L 2048, H 80: 640 blocks), else
//     one.  Pass 1, a warp per 16-row tile t: G, R, D o R, the row sums
//     of K, dC += (D o R) B over s <= t and the state terms; pass 2, a
//     warp per 16-row tile s: G^T, R^T, dX += M^T dY and dB += (D o R)^T
//     C over t >= s, the column sums of K and the state terms.  A warp
//     walks its tile's heads in turn, summing dC or dB over them in one
//     accumulator.  Tiles are dealt longest first in a snake over the
//     warps.
//
// Every product is mma.sync m16n8k16 bf16 -> f32.  G and R take bf16
// operands as they are (exact products, f32 sums).  The f32 factors
// enter as hi = bf16(v), lo = bf16(v - hi) (about 16 bits, as in the
// forward): M and D o R from their accumulators, the states S_in and dS
// (split once as they are staged in shared memory), and e o dY, w o X
// where an accumulator already holds other heads' sums (three products:
// hi hi, lo hi, hi lo).  K and its row and column sums stay f32 on the
// accumulator fragments, and the dot products of the dcum terms are
// taken on accumulators of C_t S_in^T and B_s dS^T against the dY_t
// and X_s fragments: dlog_a cancels, and no bf16 rounding enters it.
// exp(cum_t - cum_s) is formed only where s <= t, by a select.
//
// dB and dC sum over a group's heads (80 at mamba2-2.7b) without
// atomics: a block sums its hb heads in registers and writes f32
// partials per (step, head block, P slab), and sum_mid_kernel adds them
// in a fixed order, so two calls on the same inputs are bitwise equal.
// Partials at the training shape: 2 x 2 x 2048 x 40 x 128 x 4 bytes =
// 168 MB (the first version's: 671 MB).  Shared memory of (c), q 256,
// N 128: B or C rows 69.6 KB, x or dY rows of both heads 73.7 KB, the
// states' halves of both heads 69.6 KB, cum, dcum and the w terms 6 KB:
// 219 KB, one block of 8 warps per SM (the occupancy calculator: (c) 1,
// (a) 2 / 3 / 4 at N 128 / 64 / 16, (b) 8).  Registers decide that as
// well: a warp holds its tile's 16 x N f32 accumulator (64 registers at
// N 128) and its rows' C or B fragments (32) and dY or x fragments,
// which two blocks per SM (128 registers a thread) could not hold.
// ptxas gives (c) 255 / 246 / 156 registers at N 128 / 64 / 16 and no
// spill, with every shared operand addressed by a 32-bit shared address
// plus per-lane offsets computed once (generic pointers spilled 16-36
// bytes at N 128).
//
// SPLIT doubles every data operand (hi and lo rows in shared memory, lo
// fragments read from device memory where they are used), so its (c)
// takes one head a block and P slabs of 32 columns (16 at N 128): 196 KB
// of shared memory at q 256, N 128, and the register-held fragments of a
// narrower slab (at N 128 and 32 columns ptxas spilled 60 bytes).
//
// N past 128 (the slabbed build) runs (a) and (c) on N / 128 column slabs of 128
// over blocks, each the N-128 body, so no accumulator grows: (c) at N
// 256 would hold a 16 x 256 f32 dB or dC tile (128 registers a thread)
// beside C's or B's fragments (64), past 255.  Every term is linear in
// the sums over N: a slab's columns of dB, dC and dS are whole in its
// block, and the terms that sum over N (C B^T in M, B dS^T in dX, C S^T
// and the dot products in dcum, <dS, S_in>) are the slabs' partials:
// dX goes out as f32 partials (B, L, H, NS, P) and dlog_a as per-slab
// partials, and sum_mid_kernel adds them in a fixed order.  (b) takes
// the full width as it is.
constexpr unsigned FULL = 0xffffffffu;
constexpr int PB = 64;          // P columns of a slab, one block's share of P
constexpr int HB_MAX = 2;       // heads per block of (c)

// (c)'s P slab and largest head count per operand mode (and N)
__host__ __device__ constexpr int slab_of(int mode, int N) {
  return mode != SPLIT ? PB : N == 128 ? 16 : 32;
}
__host__ __device__ constexpr int heads_of(int mode) { return mode == SPLIT ? 1 : HB_MAX; }

// heads per block of (c): a pair of one group's heads where the group's
// head count is even (kernels/ssd_scan.py:bwd_launch_geometry mirrors it)
int bwd_heads(int H, int G, int mode) {
  return heads_of(mode) == 2 && (H / G) % 2 == 0 ? 2 : 1;
}

// an A fragment of bf16 pairs as bf16 hi and lo halves, each value
// scaled first: a[i]'s low and high halves by s(2i) and s(2i + 1) (rows
// g and g + 8 by one factor each, or k columns 2t4, 2t4 + 1, 2t4 + 8,
// 2t4 + 9)
__device__ __forceinline__ void scale_split(const uint32_t (&a)[4], float s0, float s1,
                                            float s2, float s3, float s4, float s5, float s6,
                                            float s7, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(bf_lo(a[0]) * s0, bf_hi(a[0]) * s1, hi[0], lo[0]);
  split_bf16(bf_lo(a[1]) * s2, bf_hi(a[1]) * s3, hi[1], lo[1]);
  split_bf16(bf_lo(a[2]) * s4, bf_hi(a[2]) * s5, hi[2], lo[2]);
  split_bf16(bf_lo(a[3]) * s6, bf_hi(a[3]) * s7, hi[3], lo[3]);
}

// scale_split of the values a + e (an operand's hi and lo halves)
__device__ __forceinline__ void scale_split2(const uint32_t (&a)[4], const uint32_t (&e)[4],
                                             float s0, float s1, float s2, float s3, float s4,
                                             float s5, float s6, float s7, uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_bf16((bf_lo(a[0]) + bf_lo(e[0])) * s0, (bf_hi(a[0]) + bf_hi(e[0])) * s1, hi[0], lo[0]);
  split_bf16((bf_lo(a[1]) + bf_lo(e[1])) * s2, (bf_hi(a[1]) + bf_hi(e[1])) * s3, hi[1], lo[1]);
  split_bf16((bf_lo(a[2]) + bf_lo(e[2])) * s4, (bf_hi(a[2]) + bf_hi(e[2])) * s5, hi[2], lo[2]);
  split_bf16((bf_lo(a[3]) + bf_lo(e[3])) * s6, (bf_hi(a[3]) + bf_hi(e[3])) * s7, hi[3], lo[3]);
}

// sum over this thread's accumulator elements of acc (16 x 8 tiles, as
// many as a's k16 chunks times two) times a's values at the same (row,
// column): a's A fragment layout is two n8 tiles of the accumulator's.
// Rows g (ra) and g + 8 (rb).
template <int K16>
__device__ __forceinline__ void frag_dot(const float (&acc)[2 * K16][4], const uint32_t (&a)[K16][4],
                                         int live, float& ra, float& rb) {
  #pragma unroll
  for (int k = 0; k < K16; ++k) {
    if (k * 16 >= live) break;
    ra += acc[2 * k][0] * bf_lo(a[k][0]) + acc[2 * k][1] * bf_hi(a[k][0]) +
          acc[2 * k + 1][0] * bf_lo(a[k][2]) + acc[2 * k + 1][1] * bf_hi(a[k][2]);
    rb += acc[2 * k][2] * bf_lo(a[k][1]) + acc[2 * k][3] * bf_hi(a[k][1]) +
          acc[2 * k + 1][2] * bf_lo(a[k][3]) + acc[2 * k + 1][3] * bf_hi(a[k][3]);
  }
}

// ldmatrix x4 (and .trans) at a 32-bit shared address
__device__ __forceinline__ void lds4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void lds4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// A fragments of rows ra and rb (zero where a row is not live) of a
// bf16 matrix in device memory, row pitch ld elements, K16 k16 chunks of
// which the columns from `live` on are zero
template <int K16>
__device__ __forceinline__ void load_frags(uint32_t (&f)[K16][4], const bf16* base, long long ld,
                                           int ra, int rb, bool a_in, bool b_in, int live,
                                           int t4) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(base + (a_in ? ra : 0) * ld) + t4;
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(base + (b_in ? rb : 0) * ld) + t4;
  #pragma unroll
  for (int k = 0; k < K16; ++k) {
    const bool c0 = k * 16 + 2 * t4 < live, c8 = k * 16 + 8 + 2 * t4 < live;
    f[k][0] = a_in && c0 ? __ldg(pa + k * 8) : 0u;
    f[k][1] = b_in && c0 ? __ldg(pb + k * 8) : 0u;
    f[k][2] = a_in && c8 ? __ldg(pa + k * 8 + 4) : 0u;
    f[k][3] = b_in && c8 ? __ldg(pb + k * 8 + 4) : 0u;
  }
}

// inclusive block scan of log_a over the chunk (one step per thread, 0
// from q on, so rows past the ragged edge carry cum_q); part: NW floats
__device__ __forceinline__ float chunk_scan(const float* ab, long long sal, int q, float* part,
                                            int tid, int lane, int warp) {
  float v = tid < q ? ab[(long long)tid * sal] : 0.f;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) part[warp] = v;
  __syncthreads();
  float pre = 0.f;
  for (int w = 0; w < warp; ++w) pre += part[w];
  return v + pre;
}

// (a)'s shared memory, rows = q rounded up to 16: C rows (rows x N
// bf16) | the dY slab (rows x PB bf16) | e (rows f32) | scan partials;
// in SPLIT the C rows and the dY slab each followed by their lo halves
template <int N, int MODE = FAST>
struct ChunkSmem {
  static constexpr int K = MODE == SPLIT ? 2 : 1;
  static constexpr int LDN = N + 8;
  static constexpr int LDP = PB + 8;
  size_t c, y, e, part, bytes;
  __host__ __device__ ChunkSmem(int rows) {
    c = 0;
    y = c + K * sizeof(bf16) * rows * LDN;
    e = y + K * sizeof(bf16) * rows * LDP;
    part = e + sizeof(float) * rows;
    bytes = part + sizeof(float) * NW;
  }
};

// (a): E = (e o dY)^T C over one chunk for one P slab of one head, P x N
// f32 into dsc (B, H, nc, P, N), and cum_q into cq (B, H, nc).  A warp
// owns one 16-row p tile and half of the n16 column blocks.  NS 0: one
// column slab of N of the nsl N-wide slabs of the state a block.
template <int N, int MODE, int NS = 1>
__global__ void __launch_bounds__(NT, 2)
ssd_scan_bwd_chunk_kernel(const float* __restrict__ la, const bf16* __restrict__ cm,
                          const bf16* __restrict__ dy, float* __restrict__ dsc,
                          float* __restrict__ cq, int L, int H, int P, int G, int Q, int nps,
                          long long sab, long long sal, long long sbb, long long sbl, int xp,
                          long long xlo, long long blo, int nsl) {
  using Sm = ChunkSmem<N, MODE>;
  constexpr int LDN = Sm::LDN, LDP = Sm::LDP;
  constexpr int NB16 = N / 16, NPW = (NB16 + 1) / 2;
  const int ns_n = NS ? NS : nsl;   // column slabs
  const int NF = N * ns_n;   // the build width
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = blockIdx.x / (nps * ns_n), slab = blockIdx.x / ns_n % nps, p0 = slab * PB;
  const int ns = blockIdx.x % ns_n;   // the column slab
  const int pc = min(PB, P - p0);
  const int h = blockIdx.y, bb = blockIdx.z, grp = h / (H / G);
  const int nc = (L + Q - 1) / Q, t0 = k * Q, q = min(Q, L - t0), rows = (q + 15) & ~15;
  const Sm sm(rows);
  bf16* Cs = reinterpret_cast<bf16*>(smem + sm.c);
  bf16* Ys = reinterpret_cast<bf16*>(smem + sm.y);
  float* ev = reinterpret_cast<float*>(smem + sm.e);
  float* part = reinterpret_cast<float*>(smem + sm.part);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* cg = cm + bb * sbb + (long long)t0 * sbl + (long long)grp * NF + ns * N;
  const int xpitch = MODE == FAST ? P : xp;
  const long long ystep = (long long)H * xpitch;
  const bf16* yb = dy + ((long long)bb * L + t0) * ystep + (long long)h * xpitch + p0;

  for (int i = tid; i < rows * (N / 8); i += NT) {
    const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
    const bool in = r < q;
    cp_async16_fill(Cs + r * LDN + c8, cg + (long long)(in ? r : 0) * sbl + c8, in ? 16 : 0);
  }
  for (int i = tid; i < rows * (PB / 8); i += NT) {
    const int r = i / (PB / 8), c8 = (i % (PB / 8)) * 8;
    const bool in = r < q && c8 < pc;
    cp_async16_fill(Ys + r * LDP + c8, yb + (in ? r * ystep + c8 : 0), in ? 16 : 0);
  }
  if constexpr (MODE == SPLIT) {
    for (int i = tid; i < rows * (N / 8); i += NT) {
      const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
      const bool in = r < q;
      cp_async16_fill(Cs + (rows + r) * LDN + c8, cg + blo + (long long)(in ? r : 0) * sbl + c8,
                      in ? 16 : 0);
    }
    for (int i = tid; i < rows * (PB / 8); i += NT) {
      const int r = i / (PB / 8), c8 = (i % (PB / 8)) * 8;
      const bool in = r < q && c8 < pc;
      cp_async16_fill(Ys + (rows + r) * LDP + c8, yb + xlo + (in ? r * ystep + c8 : 0),
                      in ? 16 : 0);
    }
  }
  cp_async_commit();
  const float cum = chunk_scan(la + bb * sab + (long long)t0 * sal + h, sal, q, part, tid, lane,
                               warp);
  if (tid < rows) ev[tid] = tid < q ? expf(cum) : 0.f;
  if (tid == q - 1 && slab == 0 && ns == 0) cq[((long long)bb * H + h) * nc + k] = cum;
  cp_async_wait<0>();
  __syncthreads();

  const int pt = warp & 3, nb0 = (warp >> 2) * NPW;
  if (pt * 16 >= pc) return;
  float acc[2 * NPW][4] = {};
  for (int s0 = 0; s0 < rows; s0 += 16) {
    uint32_t a[4], ah[4], al[4];   // (e o dY)^T: rows p, k = t
    const int yo = (s0 + (lane & 7) + (lane >> 4) * 8) * LDP + pt * 16 + ((lane >> 3) & 1) * 8;
    ldsm_x4_t(a, Ys + yo);
    const int kt = s0 + 2 * t4;
    const float e0 = ev[kt], e1 = ev[kt + 1], e8 = ev[kt + 8], e9 = ev[kt + 9];
    if constexpr (MODE == SPLIT) {
      uint32_t e[4];
      ldsm_x4_t(e, Ys + rows * LDP + yo);
      scale_split2(a, e, e0, e1, e0, e1, e8, e9, e8, e9, ah, al);
    } else {
      scale_split(a, e0, e1, e0, e1, e8, e9, e8, e9, ah, al);
    }
    #pragma unroll
    for (int j = 0; j < NPW; ++j) {
      if (nb0 + j >= NB16) break;
      uint32_t v[4];   // C: rows k = t, n16 block nb0 + j
      const int co = (s0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDN + (nb0 + j) * 16 +
                     (lane >> 4) * 8;
      ldsm_x4_t(v, Cs + co);
      mma16816(acc[2 * j], ah, v[0], v[1]);
      mma16816(acc[2 * j], al, v[0], v[1]);
      mma16816(acc[2 * j + 1], ah, v[2], v[3]);
      mma16816(acc[2 * j + 1], al, v[2], v[3]);
      if constexpr (MODE == SPLIT) {   // + (e o dY)_hi C_lo
        ldsm_x4_t(v, Cs + rows * LDN + co);
        mma16816(acc[2 * j], ah, v[0], v[1]);
        mma16816(acc[2 * j + 1], ah, v[2], v[3]);
      }
    }
  }
  float* dst = dsc + ((((long long)bb * H + h) * nc + k) * P + p0 + pt * 16 + g) * NF + ns * N;
  #pragma unroll
  for (int j = 0; j < 2 * NPW; ++j) {
    if (nb0 + j / 2 >= NB16) break;
    const int c = (nb0 + j / 2) * 16 + (j & 1) * 8 + 2 * t4;
    if (pt * 16 + g < pc)
      *reinterpret_cast<float2*>(dst + c) = make_float2(acc[j][0], acc[j][1]);
    if (pt * 16 + g + 8 < pc)
      *reinterpret_cast<float2*>(dst + 8 * NF + c) = make_float2(acc[j][2], acc[j][3]);
  }
}

// (b): dsc holds each chunk's (e o dY)^T C; from the last chunk, its
// slot takes the dS leaving the chunk, and dS = exp(cum_q) dS + that
// product.  Four f32 elements of one (b, h)'s P x N per thread.  RAG:
// dfin and dinit have rows of the true width nst < N, read and written
// per element.
template <bool RAG>
__global__ void __launch_bounds__(NT)
ssd_scan_bwd_state_kernel(float* __restrict__ dsc, const float* __restrict__ cq,
                          const float* __restrict__ dfin, float* __restrict__ dinit, int H,
                          int nc, int PN, int N, int nst) {
  const int i = (blockIdx.x * NT + threadIdx.x) * 4;
  if (i >= PN) return;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  float4 cur = make_float4(0.f, 0.f, 0.f, 0.f);
  const int r = i / N, c = i % N;
  const long long ro = bh * (PN / N) * nst + (long long)r * nst + c;   // RAG: (r, c) at pitch nst
  if constexpr (RAG) {
    if (dfin != nullptr) {
      float* v = &cur.x;
      for (int j = 0; j < 4; ++j) v[j] = c + j < nst ? __ldg(dfin + ro + j) : 0.f;
    }
  } else if (dfin != nullptr) {
    cur = __ldg(reinterpret_cast<const float4*>(dfin + bh * PN + i));
  }
  for (int k = nc - 1; k >= 0; --k) {
    float4* slot = reinterpret_cast<float4*>(dsc + (bh * nc + k) * PN + i);
    const float4 e = *slot;
    *slot = cur;
    const float d = expf(cq[bh * nc + k]);
    cur = make_float4(fmaf(d, cur.x, e.x), fmaf(d, cur.y, e.y), fmaf(d, cur.z, e.z),
                      fmaf(d, cur.w, e.w));
  }
  if constexpr (RAG) {
    if (dinit != nullptr) {
      const float* v = &cur.x;
      for (int j = 0; j < 4; ++j)
        if (c + j < nst) dinit[ro + j] = v[j];
    }
  } else if (dinit != nullptr) {
    *reinterpret_cast<float4*>(dinit + bh * PN + i) = cur;
  }
}

// (c)'s shared memory, rows = q rounded up to 16: B rows in pass 1, C
// rows in pass 2 (rows x N bf16) | x rows, then dY rows, of each head
// (HB_MAX x rows x PB bf16) | S_in's, then dS's, hi and lo halves of
// each head (HB_MAX x 2 x PB x N bf16) | cum, dcum and the w terms of
// each head (rows f32 each) | scan and reduction partials.  Row pitches
// padded by 16 bytes, as in the forward.  In SPLIT the B or C rows and
// the x or dY rows are each followed by their lo halves, the slab is
// slab_of's and one head.  kernels/ssd_scan.py:bwd_launch_geometry mirrors
// this layout.
template <int N, int MODE = FAST>
struct BwdSmem {
  static constexpr int K = MODE == SPLIT ? 2 : 1;
  static constexpr int SB = slab_of(MODE, N), HB = heads_of(MODE);
  static constexpr int LDN = N + 8;
  static constexpr int LDP = SB + 8;
  size_t bc, xy, st, cum, dcum, wt, red, bytes;
  __host__ __device__ BwdSmem(int rows) {
    bc = 0;
    xy = bc + K * sizeof(bf16) * rows * LDN;
    st = xy + K * sizeof(bf16) * HB * rows * LDP;
    cum = st + sizeof(bf16) * HB * 2 * SB * LDN;
    dcum = cum + sizeof(float) * HB * rows;
    wt = dcum + sizeof(float) * HB * rows;
    red = wt + sizeof(float) * HB * rows;
    bytes = red + sizeof(float) * 2 * HB * NW;
  }
};

// stage a (B, H, nc, P, NF) f32 state slab of hb heads, N of its
// columns, as bf16 hi / lo halves (rows from pc on zero); with `other`,
// also each head's <state, other> over the slab, warp partials into
// red[hh * NW + warp]
template <int N, int SB>
__device__ __forceinline__ void stage_states(bf16* st, const float* src, const float* other,
                                             float* red, int hb, int pc, int tid, int lane,
                                             int warp, long long head_stride, int NF) {
  constexpr int LDN = N + 8;
  for (int hh = 0; hh < hb; ++hh) {
    bf16* hi = st + hh * 2 * SB * LDN;
    bf16* lo = hi + SB * LDN;
    const float* s = src + hh * head_stride;
    const float* o = other != nullptr ? other + hh * head_stride : nullptr;
    float ip = 0.f;
    for (int i = tid; i < SB * N / 4; i += NT) {
      const int r = i / (N / 4), c4 = (i % (N / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f), w = v;
      if (r < pc) {
        v = __ldg(reinterpret_cast<const float4*>(s + (long long)r * NF + c4));
        if (other != nullptr) w = __ldg(reinterpret_cast<const float4*>(o + (long long)r * NF + c4));
      }
      ip += v.x * w.x + v.y * w.y + v.z * w.z + v.w * w.w;
      uint32_t h0, l0, h1, l1;
      split_bf16(v.x, v.y, h0, l0);
      split_bf16(v.z, v.w, h1, l1);
      *reinterpret_cast<uint2*>(hi + r * LDN + c4) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(lo + r * LDN + c4) = make_uint2(l0, l1);
    }
    if (other != nullptr) {
      for (int o2 = 16; o2 > 0; o2 >>= 1) ip += __shfl_xor_sync(FULL, ip, o2);
      if (lane == 0) red[hh * NW + warp] = ip;
    }
  }
}

// (c): see the note above.  Block (chunk k x P slab x column slab, head
// block, b).  Past FAST's arguments: xp, x's and dY's head pitch; xlo
// and blo, the lo halves' element offsets (SPLIT); dxt, dX's type (OT_*)
// (else bf16).  NS 0 (nsl column slabs): dxv is dX's f32 partials, dl
// holds nps x nsl partials a row.
template <int N, int MODE, int NS = 1>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const float* __restrict__ cst, const bf16* __restrict__ dy,
                    const float* __restrict__ dsc, void* __restrict__ dxv,
                    float* __restrict__ dbp, float* __restrict__ dcp, float* __restrict__ dl,
                    int L, int H, int P, int G, int Q, int nps, int hb, long long sxb,
                    long long sxl, long long sab, long long sal, long long sbb, long long sbl,
                    int xp, long long xlo, long long blo, int dxt, int nsl) {
  using Sm = BwdSmem<N, MODE>;
  constexpr int LDN = Sm::LDN, LDP = Sm::LDP, PB = Sm::SB, HB_MAX = Sm::HB;
  constexpr bool SP = MODE == SPLIT;
  constexpr int KC = N / 16;    // k16 chunks over N
  constexpr int PK = PB / 16;   // k16 chunks over a P slab
  const int ns_n = NS ? NS : nsl;   // column slabs
  const int NF = N * ns_n;    // the build width
  extern __shared__ __align__(128) unsigned char smem[];
  const int k = blockIdx.x / (nps * ns_n), slab = blockIdx.x / ns_n % nps, p0 = slab * PB;
  const int ns = blockIdx.x % ns_n, n0 = ns * N;   // the column slab
  const int pc = min(PB, P - p0);   // live columns of the slab
  const int h0 = blockIdx.y * hb, bb = blockIdx.z, grp = h0 / (H / G);
  const int nc = (L + Q - 1) / Q, t0 = k * Q, q = min(Q, L - t0), rows = (q + 15) & ~15;
  const int n_rt = rows / 16;
  const Sm sm(rows);
  bf16* BC = reinterpret_cast<bf16*>(smem + sm.bc);
  bf16* XY = reinterpret_cast<bf16*>(smem + sm.xy);
  bf16* ST = reinterpret_cast<bf16*>(smem + sm.st);
  float* cum = reinterpret_cast<float*>(smem + sm.cum);
  float* dcum = reinterpret_cast<float*>(smem + sm.dcum);
  float* wt = reinterpret_cast<float*>(smem + sm.wt);
  float* red = reinterpret_cast<float*>(smem + sm.red);   // HB_MAX x NW scan, HB_MAX x NW <dS, S_in>
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  // shared addresses, and this lane's ldmatrix row in bytes within a
  // 16-row tile of pitch LDN or LDP: B operands read as (n, k) rows (n)
  // and as (k, n) rows through .trans (t)
  const uint32_t bc_a = smem_addr(BC), xy_a = smem_addr(XY), st_a = smem_addr(ST);
  const uint32_t oNn = 2 * (((lane & 7) + ((lane >> 4) << 3)) * LDN + ((lane >> 3) & 1) * 8);
  const uint32_t oNt = 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LDN + (lane >> 4) * 8);
  const uint32_t oPn = 2 * (((lane & 7) + ((lane >> 4) << 3)) * LDP + ((lane >> 3) & 1) * 8);
  const uint32_t oPt = 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LDP + (lane >> 4) * 8);
  const bf16* bg = bm + bb * sbb + (long long)t0 * sbl + (long long)grp * NF + n0;
  const bf16* cg = cm + bb * sbb + (long long)t0 * sbl + (long long)grp * NF + n0;
  const int xpitch = MODE == FAST ? P : xp;
  const long long ystep = (long long)H * xpitch;        // dY's row pitch
  const long long ostep = (long long)H * ns_n * P;        // dX's (its partials' past one slab)
  const bf16* xb = x + bb * sxb + (long long)t0 * sxl + (long long)h0 * xpitch + p0;
  const bf16* yb = dy + ((long long)bb * L + t0) * ystep + (long long)h0 * xpitch + p0;
  const long long dxo = ((long long)bb * L + t0) * ostep + ((long long)h0 * ns_n + ns) * P + p0;
  bf16* dxb = reinterpret_cast<bf16*>(dxv) + dxo;
  float* dxf = reinterpret_cast<float*>(dxv) + dxo;   // NS 0: the f32 partials
  // SPLIT: the lo rows' byte offsets in shared memory
  const uint32_t bc_lo = 2 * rows * LDN, xy_lo = 2 * HB_MAX * rows * LDP;
  const long long soff = ((((long long)bb * H + h0) * nc + k) * P + p0) * NF + n0;
  const long long shead = (long long)nc * P * NF;   // one head further in the states
  // a block's partial rows: (step, head block, P slab) of N f32 (NF
  // wide, this slab's columns from n0 on); dlog_a's, nps x ns_n a row
  const long long prow = (long long)(H / hb) * nps;
  const long long poff = (long long)blockIdx.y * nps + slab;

  // pass 1's operands: B rows, x rows of each head, S_in's halves (and
  // <dS, S_in> of each head), and each head's cum
  for (int i = tid; i < rows * (N / 8); i += NT) {
    const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
    const bool in = r < q;
    cp_async16_fill(BC + r * LDN + c8, bg + (long long)(in ? r : 0) * sbl + c8, in ? 16 : 0);
  }
  for (int i = tid; i < hb * rows * (PB / 8); i += NT) {
    const int hh = i / (rows * (PB / 8)), r = (i / (PB / 8)) % rows, c8 = (i % (PB / 8)) * 8;
    const bool in = r < q && c8 < pc;
    cp_async16_fill(XY + (hh * rows + r) * LDP + c8,
                    xb + (in ? (long long)r * sxl + hh * xpitch + c8 : 0), in ? 16 : 0);
  }
  if constexpr (SP) {
    for (int i = tid; i < rows * (N / 8); i += NT) {
      const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
      const bool in = r < q;
      cp_async16_fill(BC + (rows + r) * LDN + c8, bg + blo + (long long)(in ? r : 0) * sbl + c8,
                      in ? 16 : 0);
    }
    for (int i = tid; i < hb * rows * (PB / 8); i += NT) {
      const int hh = i / (rows * (PB / 8)), r = (i / (PB / 8)) % rows, c8 = (i % (PB / 8)) * 8;
      const bool in = r < q && c8 < pc;
      cp_async16_fill(XY + ((HB_MAX + hh) * rows + r) * LDP + c8,
                      xb + xlo + (in ? (long long)r * sxl + hh * xpitch + c8 : 0), in ? 16 : 0);
    }
  }
  cp_async_commit();
  stage_states<N, PB>(ST, cst + soff, dsc + soff, red + HB_MAX * NW, hb, pc, tid, lane,
                      warp, shead, NF);
  for (int hh = 0; hh < hb; ++hh) {
    const float v = chunk_scan(la + bb * sab + (long long)t0 * sal + h0 + hh, sal, q, red + hh * NW,
                               tid, lane, warp);
    if (tid < rows) cum[hh * rows + tid] = v;
  }
  cp_async_wait<0>();
  __syncthreads();

  // pass 1: a warp per 16-row tile t, over key tiles s <= t
  #pragma unroll 1
  for (int it = 0; it * NW < n_rt; ++it) {
    const int idx = it * NW + ((it & 1) ? NW - 1 - warp : warp);
    if (idx >= n_rt) continue;
    const int r0 = (n_rt - 1 - idx) * 16;
    const int ta = r0 + g, tb = ta + 8;
    uint32_t cf[KC][4];
    load_frags<KC>(cf, cg, sbl, ta, tb, ta < q, tb < q, N, t4);
    float acc[N / 8][4] = {};   // dC of rows ta, tb over the block's heads
    #pragma unroll 1
    for (int hh = 0; hh < hb; ++hh) {
      const uint32_t sh = st_a + 2 * hh * 2 * PB * LDN, sl = sh + 2 * PB * LDN;
      const float* cu = cum + hh * rows;
      uint32_t yf[PK][4], yl[SP ? PK : 1][4];
      load_frags<PK>(yf, yb + hh * xpitch, ystep, ta, tb, ta < q, tb < q, pc, t4);
      if constexpr (SP) load_frags<PK>(yl, yb + xlo + hh * xpitch, ystep, ta, tb, ta < q, tb < q, pc, t4);
      // state terms: e_t dY_t . (S_in C_t) from C_t S_in^T, and
      // dC += (e o dY_t) S_in
      float ys[2 * PK][4] = {};
      #pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t cl[4];
        if constexpr (SP) load_frag(cl, cg + blo, sbl, ta, tb, ta < q, tb < q, kc, t4);
        #pragma unroll
        for (int pp = 0; pp < PK; ++pp) {
          if (pp * 16 >= pc) break;
          const uint32_t off = oNn + 2 * (pp * 16 * LDN + kc * 16);
          uint32_t v[4];
          lds4(v, sh + off);
          mma16816(ys[2 * pp], cf[kc], v[0], v[1]);
          mma16816(ys[2 * pp + 1], cf[kc], v[2], v[3]);
          if constexpr (SP) {
            mma16816(ys[2 * pp], cl, v[0], v[1]);
            mma16816(ys[2 * pp + 1], cl, v[2], v[3]);
          }
          lds4(v, sl + off);
          mma16816(ys[2 * pp], cf[kc], v[0], v[1]);
          mma16816(ys[2 * pp + 1], cf[kc], v[2], v[3]);
        }
      }
      float ra = 0.f, rb = 0.f;   // row sums of K and the e_t dot, rows ta and tb
      frag_dot<PK>(ys, yf, pc, ra, rb);
      if constexpr (SP) frag_dot<PK>(ys, yl, pc, ra, rb);
      const float ca = cu[ta], cb = cu[tb];
      const float ea = ta < q ? expf(ca) : 0.f, eb = tb < q ? expf(cb) : 0.f;
      ra *= ea;
      rb *= eb;
      #pragma unroll
      for (int pk = 0; pk < PK; ++pk) {
        if (pk * 16 >= pc) break;
        uint32_t ah[4], al[4];
        if constexpr (SP) scale_split2(yf[pk], yl[pk], ea, ea, eb, eb, ea, ea, eb, eb, ah, al);
        else scale_split(yf[pk], ea, ea, eb, eb, ea, ea, eb, eb, ah, al);
        #pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
          const uint32_t off = oNt + 2 * (pk * 16 * LDN + nb * 16);
          uint32_t vh[4], vl[4];
          lds4t(vh, sh + off);
          lds4t(vl, sl + off);
          mma16816(acc[2 * nb], ah, vh[0], vh[1]);
          mma16816(acc[2 * nb], al, vh[0], vh[1]);
          mma16816(acc[2 * nb], ah, vl[0], vl[1]);
          mma16816(acc[2 * nb + 1], ah, vh[2], vh[3]);
          mma16816(acc[2 * nb + 1], al, vh[2], vh[3]);
          mma16816(acc[2 * nb + 1], ah, vl[2], vl[3]);
        }
      }
      #pragma unroll 1
      for (int s0 = 0; s0 <= r0; s0 += 16) {
        const uint32_t brow = bc_a + 2 * s0 * LDN, xrow = xy_a + 2 * (hh * rows + s0) * LDP;
        float gs[8] = {}, rs[8] = {};   // G = C_t B_s^T, R = dY_t X_s^T
        #pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t v[4];
          lds4(v, brow + oNn + 32 * kc);
          mma16816(gs, cf[kc], v[0], v[1]);
          mma16816(gs + 4, cf[kc], v[2], v[3]);
          if constexpr (SP) {   // + C_lo B_hi + C_hi B_lo
            uint32_t cl[4];
            load_frag(cl, cg + blo, sbl, ta, tb, ta < q, tb < q, kc, t4);
            mma16816(gs, cl, v[0], v[1]);
            mma16816(gs + 4, cl, v[2], v[3]);
            lds4(v, brow + bc_lo + oNn + 32 * kc);
            mma16816(gs, cf[kc], v[0], v[1]);
            mma16816(gs + 4, cf[kc], v[2], v[3]);
          }
        }
        #pragma unroll
        for (int pk = 0; pk < PK; ++pk) {
          if (pk * 16 >= pc) break;
          uint32_t v[4];
          lds4(v, xrow + oPn + 32 * pk);
          mma16816(rs, yf[pk], v[0], v[1]);
          mma16816(rs + 4, yf[pk], v[2], v[3]);
          if constexpr (SP) {   // + dY_lo X_hi + dY_hi X_lo
            mma16816(rs, yl[pk], v[0], v[1]);
            mma16816(rs + 4, yl[pk], v[2], v[3]);
            lds4(v, xrow + xy_lo + oPn + 32 * pk);
            mma16816(rs, yf[pk], v[0], v[1]);
            mma16816(rs + 4, yf[pk], v[2], v[3]);
          }
        }
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int s = s0 + 8 * j + 2 * t4;
          const float2 cs = *reinterpret_cast<const float2*>(cu + s);
          float* r = rs + 4 * j;
          const float* m = gs + 4 * j;
          r[0] = s <= ta ? r[0] * ex2((ca - cs.x) * LOG2E) : 0.f;
          r[1] = s + 1 <= ta ? r[1] * ex2((ca - cs.y) * LOG2E) : 0.f;
          r[2] = s <= tb ? r[2] * ex2((cb - cs.x) * LOG2E) : 0.f;
          r[3] = s + 1 <= tb ? r[3] * ex2((cb - cs.y) * LOG2E) : 0.f;
          ra += r[0] * m[0] + r[1] * m[1];
          rb += r[2] * m[2] + r[3] * m[3];
        }
        uint32_t dh[4], dlo[4];   // D o R as an A fragment (k = s)
        #pragma unroll
        for (int i = 0; i < 4; ++i) split_bf16(rs[2 * i], rs[2 * i + 1], dh[i], dlo[i]);
        // dC += (D o R) B_s, B rows as (k = s, n) through ldmatrix.trans
        #pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
          uint32_t v[4];
          lds4t(v, brow + oNt + 32 * nb);
          mma16816(acc[2 * nb], dh, v[0], v[1]);
          mma16816(acc[2 * nb], dlo, v[0], v[1]);
          mma16816(acc[2 * nb + 1], dh, v[2], v[3]);
          mma16816(acc[2 * nb + 1], dlo, v[2], v[3]);
          if constexpr (SP) {
            lds4t(v, brow + bc_lo + oNt + 32 * nb);
            mma16816(acc[2 * nb], dh, v[0], v[1]);
            mma16816(acc[2 * nb + 1], dh, v[2], v[3]);
          }
        }
      }
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      if (t4 == 0) {
        dcum[hh * rows + ta] = ra;
        dcum[hh * rows + tb] = rb;
      }
    }
    float* pa = dcp + ((long long)bb * L * prow + (long long)(t0 + ta) * prow + poff) * NF + n0;
    float* pb = pa + 8 * prow * NF;
    #pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (ta < q) *reinterpret_cast<float2*>(pa + c) = make_float2(acc[j][0], acc[j][1]);
      if (tb < q) *reinterpret_cast<float2*>(pb + c) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();   // every warp is done with B, x and S_in

  // pass 2's operands: C rows, dY rows of each head, dS's halves
  for (int i = tid; i < rows * (N / 8); i += NT) {
    const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
    const bool in = r < q;
    cp_async16_fill(BC + r * LDN + c8, cg + (long long)(in ? r : 0) * sbl + c8, in ? 16 : 0);
  }
  for (int i = tid; i < hb * rows * (PB / 8); i += NT) {
    const int hh = i / (rows * (PB / 8)), r = (i / (PB / 8)) % rows, c8 = (i % (PB / 8)) * 8;
    const bool in = r < q && c8 < pc;
    cp_async16_fill(XY + (hh * rows + r) * LDP + c8,
                    yb + (in ? (long long)r * ystep + hh * xpitch + c8 : 0), in ? 16 : 0);
  }
  if constexpr (SP) {
    for (int i = tid; i < rows * (N / 8); i += NT) {
      const int r = i / (N / 8), c8 = (i % (N / 8)) * 8;
      const bool in = r < q;
      cp_async16_fill(BC + (rows + r) * LDN + c8, cg + blo + (long long)(in ? r : 0) * sbl + c8,
                      in ? 16 : 0);
    }
    for (int i = tid; i < hb * rows * (PB / 8); i += NT) {
      const int hh = i / (rows * (PB / 8)), r = (i / (PB / 8)) % rows, c8 = (i % (PB / 8)) * 8;
      const bool in = r < q && c8 < pc;
      cp_async16_fill(XY + ((HB_MAX + hh) * rows + r) * LDP + c8,
                      yb + xlo + (in ? (long long)r * ystep + hh * xpitch + c8 : 0), in ? 16 : 0);
    }
  }
  cp_async_commit();
  stage_states<N, PB>(ST, dsc + soff, nullptr, nullptr, hb, pc, tid, lane, warp, shead, NF);
  cp_async_wait<0>();
  __syncthreads();

  // pass 2: a warp per 16-row tile s, over query tiles t >= s
  #pragma unroll 1
  for (int it = 0; it * NW < n_rt; ++it) {
    const int idx = it * NW + ((it & 1) ? NW - 1 - warp : warp);
    if (idx >= n_rt) continue;
    const int r0 = idx * 16;
    const int sa = r0 + g, sb = sa + 8;
    uint32_t bf[KC][4];
    load_frags<KC>(bf, bg, sbl, sa, sb, sa < q, sb < q, N, t4);
    float acc[N / 8][4] = {};   // dB of rows sa, sb over the block's heads
    #pragma unroll 1
    for (int hh = 0; hh < hb; ++hh) {
      const uint32_t sh = st_a + 2 * hh * 2 * PB * LDN, sl = sh + 2 * PB * LDN;
      const float* cu = cum + hh * rows;
      uint32_t xf[PK][4], xl[SP ? PK : 1][4];
      load_frags<PK>(xf, xb + hh * xpitch, sxl, sa, sb, sa < q, sb < q, pc, t4);
      if constexpr (SP) load_frags<PK>(xl, xb + xlo + hh * xpitch, sxl, sa, sb, sa < q, sb < q, pc, t4);
      // dX starts as w o (B_s dS^T); its rows' dot with X_s is the w term
      float ax[2 * PK][4] = {};
      #pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t bl[4];
        if constexpr (SP) load_frag(bl, bg + blo, sbl, sa, sb, sa < q, sb < q, kc, t4);
        #pragma unroll
        for (int pp = 0; pp < PK; ++pp) {
          if (pp * 16 >= pc) break;
          const uint32_t off = oNn + 2 * (pp * 16 * LDN + kc * 16);
          uint32_t v[4];
          lds4(v, sh + off);
          mma16816(ax[2 * pp], bf[kc], v[0], v[1]);
          mma16816(ax[2 * pp + 1], bf[kc], v[2], v[3]);
          if constexpr (SP) {
            mma16816(ax[2 * pp], bl, v[0], v[1]);
            mma16816(ax[2 * pp + 1], bl, v[2], v[3]);
          }
          lds4(v, sl + off);
          mma16816(ax[2 * pp], bf[kc], v[0], v[1]);
          mma16816(ax[2 * pp + 1], bf[kc], v[2], v[3]);
        }
      }
      float wa = 0.f, wb = 0.f;
      frag_dot<PK>(ax, xf, pc, wa, wb);
      if constexpr (SP) frag_dot<PK>(ax, xl, pc, wa, wb);
      const float cs_a = cu[sa], cs_b = cu[sb], c_end = cu[q - 1];
      const float w_a = sa < q ? expf(c_end - cs_a) : 0.f;
      const float w_b = sb < q ? expf(c_end - cs_b) : 0.f;
      wa *= w_a;
      wb *= w_b;
      #pragma unroll
      for (int j = 0; j < 2 * PK; ++j) {
        ax[j][0] *= w_a;
        ax[j][1] *= w_a;
        ax[j][2] *= w_b;
        ax[j][3] *= w_b;
      }
      // dB += (w o X_s) dS, dS rows as (k = p, n) through ldmatrix.trans
      #pragma unroll
      for (int pk = 0; pk < PK; ++pk) {
        if (pk * 16 >= pc) break;
        uint32_t ah[4], al[4];
        if constexpr (SP) scale_split2(xf[pk], xl[pk], w_a, w_a, w_b, w_b, w_a, w_a, w_b, w_b, ah, al);
        else scale_split(xf[pk], w_a, w_a, w_b, w_b, w_a, w_a, w_b, w_b, ah, al);
        #pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
          const uint32_t off = oNt + 2 * (pk * 16 * LDN + nb * 16);
          uint32_t vh[4], vl[4];
          lds4t(vh, sh + off);
          lds4t(vl, sl + off);
          mma16816(acc[2 * nb], ah, vh[0], vh[1]);
          mma16816(acc[2 * nb], al, vh[0], vh[1]);
          mma16816(acc[2 * nb], ah, vl[0], vl[1]);
          mma16816(acc[2 * nb + 1], ah, vh[2], vh[3]);
          mma16816(acc[2 * nb + 1], al, vh[2], vh[3]);
          mma16816(acc[2 * nb + 1], ah, vl[2], vl[3]);
        }
      }
      float ka = 0.f, kb = 0.f;   // column sums of K, rows sa and sb
      #pragma unroll 1
      for (int u0 = r0; u0 < rows; u0 += 16) {
        const uint32_t crow = bc_a + 2 * u0 * LDN, yrow = xy_a + 2 * (hh * rows + u0) * LDP;
        float gs[8] = {}, rs[8] = {};   // G^T = B_s C_u^T, R^T = X_s dY_u^T
        #pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          uint32_t v[4];
          lds4(v, crow + oNn + 32 * kc);
          mma16816(gs, bf[kc], v[0], v[1]);
          mma16816(gs + 4, bf[kc], v[2], v[3]);
          if constexpr (SP) {   // + B_lo C_hi + B_hi C_lo
            uint32_t bl[4];
            load_frag(bl, bg + blo, sbl, sa, sb, sa < q, sb < q, kc, t4);
            mma16816(gs, bl, v[0], v[1]);
            mma16816(gs + 4, bl, v[2], v[3]);
            lds4(v, crow + bc_lo + oNn + 32 * kc);
            mma16816(gs, bf[kc], v[0], v[1]);
            mma16816(gs + 4, bf[kc], v[2], v[3]);
          }
        }
        #pragma unroll
        for (int pk = 0; pk < PK; ++pk) {
          if (pk * 16 >= pc) break;
          uint32_t v[4];
          lds4(v, yrow + oPn + 32 * pk);
          mma16816(rs, xf[pk], v[0], v[1]);
          mma16816(rs + 4, xf[pk], v[2], v[3]);
          if constexpr (SP) {   // + X_lo dY_hi + X_hi dY_lo
            mma16816(rs, xl[pk], v[0], v[1]);
            mma16816(rs + 4, xl[pk], v[2], v[3]);
            lds4(v, yrow + xy_lo + oPn + 32 * pk);
            mma16816(rs, xf[pk], v[0], v[1]);
            mma16816(rs + 4, xf[pk], v[2], v[3]);
          }
        }
        #pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int t = u0 + 8 * j + 2 * t4;
          const float2 ct = *reinterpret_cast<const float2*>(cu + t);
          float* m = gs + 4 * j;
          float* r = rs + 4 * j;
          const float d0 = sa <= t ? ex2((ct.x - cs_a) * LOG2E) : 0.f;
          const float d1 = sa <= t + 1 ? ex2((ct.y - cs_a) * LOG2E) : 0.f;
          const float d2 = sb <= t ? ex2((ct.x - cs_b) * LOG2E) : 0.f;
          const float d3 = sb <= t + 1 ? ex2((ct.y - cs_b) * LOG2E) : 0.f;
          m[0] *= d0;
          m[1] *= d1;
          m[2] *= d2;
          m[3] *= d3;
          ka += m[0] * r[0] + m[1] * r[1];
          kb += m[2] * r[2] + m[3] * r[3];
          r[0] *= d0;
          r[1] *= d1;
          r[2] *= d2;
          r[3] *= d3;
        }
        uint32_t mh[4], ml[4], dh[4], dlo[4];   // M^T and (D o R)^T as A fragments (k = t)
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_bf16(gs[2 * i], gs[2 * i + 1], mh[i], ml[i]);
          split_bf16(rs[2 * i], rs[2 * i + 1], dh[i], dlo[i]);
        }
        // dX += M^T dY_u and dB += (D o R)^T C_u, (k = t) rows through
        // ldmatrix.trans
        #pragma unroll
        for (int pp = 0; pp < PK; ++pp) {
          if (pp * 16 >= pc) break;
          uint32_t v[4];
          lds4t(v, yrow + oPt + 32 * pp);
          mma16816(ax[2 * pp], mh, v[0], v[1]);
          mma16816(ax[2 * pp], ml, v[0], v[1]);
          mma16816(ax[2 * pp + 1], mh, v[2], v[3]);
          mma16816(ax[2 * pp + 1], ml, v[2], v[3]);
          if constexpr (SP) {
            lds4t(v, yrow + xy_lo + oPt + 32 * pp);
            mma16816(ax[2 * pp], mh, v[0], v[1]);
            mma16816(ax[2 * pp + 1], mh, v[2], v[3]);
          }
        }
        #pragma unroll
        for (int nb = 0; nb < N / 16; ++nb) {
          uint32_t v[4];
          lds4t(v, crow + oNt + 32 * nb);
          mma16816(acc[2 * nb], dh, v[0], v[1]);
          mma16816(acc[2 * nb], dlo, v[0], v[1]);
          mma16816(acc[2 * nb + 1], dh, v[2], v[3]);
          mma16816(acc[2 * nb + 1], dlo, v[2], v[3]);
          if constexpr (SP) {
            lds4t(v, crow + bc_lo + oNt + 32 * nb);
            mma16816(acc[2 * nb], dh, v[0], v[1]);
            mma16816(acc[2 * nb + 1], dh, v[2], v[3]);
          }
        }
      }
      if constexpr (MODE == FAST && NS == 1) {
        bf16* xo = dxb + hh * P;
        #pragma unroll
        for (int j = 0; j < 2 * PK; ++j) {
          const int c = j * 8 + 2 * t4;
          if (c >= pc) break;
          if (sa < q)
            *reinterpret_cast<uint32_t*>(xo + (long long)sa * ostep + c) = pack_bf16(ax[j][0], ax[j][1]);
          if (sb < q)
            *reinterpret_cast<uint32_t*>(xo + (long long)sb * ostep + c) = pack_bf16(ax[j][2], ax[j][3]);
        }
      } else if constexpr (MODE == FAST) {   // f32 pairs of this column slab's partials
        float* xo = dxf + hh * ns_n * P;
        #pragma unroll
        for (int j = 0; j < 2 * PK; ++j) {
          const int c = j * 8 + 2 * t4;
          if (c >= pc) break;
          if (sa < q)
            *reinterpret_cast<float2*>(xo + (long long)sa * ostep + c) = make_float2(ax[j][0], ax[j][1]);
          if (sb < q)
            *reinterpret_cast<float2*>(xo + (long long)sb * ostep + c) = make_float2(ax[j][2], ax[j][3]);
        }
      } else if constexpr (NS != 1) {   // f32 partials of this column slab, masked at a ragged P
        float* xo = dxf + hh * ns_n * P;
        #pragma unroll
        for (int j = 0; j < 2 * PK; ++j) {
          const int c = j * 8 + 2 * t4;
          if (c >= pc) break;
          float* ra = xo + (long long)sa * ostep + c;
          float* rb = xo + (long long)sb * ostep + c;
          if (sa < q) ra[0] = ax[j][0];
          if (sa < q && c + 1 < pc) ra[1] = ax[j][1];
          if (sb < q) rb[0] = ax[j][2];
          if (sb < q && c + 1 < pc) rb[1] = ax[j][3];
        }
      } else {   // per element, in x's dtype, masked at a ragged P
        #pragma unroll
        for (int j = 0; j < 2 * PK; ++j) {
          const int c = j * 8 + 2 * t4;
          if (c >= pc) break;
          const long long oa = dxo + (long long)hh * P + (long long)sa * ostep + c;
          const long long ob = dxo + (long long)hh * P + (long long)sb * ostep + c;
          if (sa < q) put_out(dxv, oa, ax[j][0], dxt);
          if (sa < q && c + 1 < pc) put_out(dxv, oa + 1, ax[j][1], dxt);
          if (sb < q) put_out(dxv, ob, ax[j][2], dxt);
          if (sb < q && c + 1 < pc) put_out(dxv, ob + 1, ax[j][3], dxt);
        }
      }
      ka = quad_sum(ka);
      kb = quad_sum(kb);
      wa = quad_sum(wa);
      wb = quad_sum(wb);
      if (t4 == 0) {
        dcum[hh * rows + sa] -= ka + wa;
        dcum[hh * rows + sb] -= kb + wb;
        wt[hh * rows + sa] = wa;
        wt[hh * rows + sb] = wb;
      }
    }
    float* pa = dbp + ((long long)bb * L * prow + (long long)(t0 + sa) * prow + poff) * NF + n0;
    float* pb = pa + 8 * prow * NF;
    #pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      if (sa < q) *reinterpret_cast<float2*>(pa + c) = make_float2(acc[j][0], acc[j][1]);
      if (sb < q) *reinterpret_cast<float2*>(pb + c) = make_float2(acc[j][2], acc[j][3]);
    }
  }
  __syncthreads();   // dcum and the w terms complete

  // dcum_q += exp(cum_q) <dS, S_in> + sum_s w_s (dS . X_s^T B_s), each
  // sum in a fixed order; then dlog_a, the reverse inclusive scan of
  // dcum within the chunk
  if (tid < hb) {
    float ip = 0.f, sw = 0.f;
    for (int w = 0; w < NW; ++w) ip += red[HB_MAX * NW + tid * NW + w];
    for (int s = 0; s < q; ++s) sw += wt[tid * rows + s];
    dcum[tid * rows + q - 1] += expf(cum[tid * rows + q - 1]) * ip + sw;
  }
  __syncthreads();
  for (int hh = 0; hh < hb; ++hh) {
    float r = tid < q ? dcum[hh * rows + tid] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_down_sync(FULL, r, o);
      if (lane + o < 32) r += u;
    }
    if (lane == 0) red[warp] = r;
    __syncthreads();
    float post = 0.f;
    for (int w = NW - 1; w > warp; --w) post += red[w];
    if (tid < q)
      dl[(((long long)bb * L + t0 + tid) * H + h0 + hh) * (nps * ns_n) + slab * ns_n + ns] = r + post;
    __syncthreads();   // red is free again
  }
}

// (a) and (c) opt in to their largest chunk's shared bytes (one block's
// width N, or N_SLAB with NS 0: the slabbed build)
template <int N, int MODE, int NS>
int bwd_opt_in() {
  static std::atomic<unsigned long long> opted_a{0}, opted_c{0};
  const int rc = opt_in(ssd_scan_bwd_chunk_kernel<N, MODE, NS>, opted_a,
                        ChunkSmem<N, MODE>(NT).bytes);
  return rc != 0 ? rc : opt_in(ssd_scan_bwd_kernel<N, MODE, NS>, opted_c,
                               BwdSmem<N, MODE>(NT).bytes);
}

// blocks per SM of (a), (b) and (c) at chunk Q, from the runtime's
// occupancy calculator
template <int N, int MODE, int NS>
int bwd_occupancy(int Q, int* blocks) {
  int rc = bwd_opt_in<N, MODE, NS>();
  if (rc != 0) return rc;
  const int rows = (Q + 15) & ~15;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_scan_bwd_chunk_kernel<N, MODE, NS>, NT, ChunkSmem<N, MODE>(rows).bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks + 1,
                                                        ssd_scan_bwd_state_kernel<MODE != FAST>,
                                                        NT, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks + 2, ssd_scan_bwd_kernel<N, MODE, NS>, NT, BwdSmem<N, MODE>(rows).bytes);
  return (int)err;
}

// The backward's launches.  x, b, c and dy as the forward reads them
// (staged in SPLIT, dy at x's head pitch); states and the dS
// slots at the build width NC x ns; dfin and dinit at the true width
// a.nst.  NS 1: one block's width NC; NS 0: the slabbed build, (a) and
// (c) on ns column slabs of NC = N_SLAB (see the note above).
template <int NC, int MODE, int NS>
int launch_bwd(const void* x, const float* log_a, const void* b, const void* c,
               const float* states, const void* dy, const float* dfin, void* dx, void* dla,
               void* db, void* dc, float* dinit, float* part, float* lpart, const ScanArgs& a,
               int ns, cudaStream_t stream) {
  int rc = bwd_opt_in<NC, MODE, NS>();
  if (rc != 0) return rc;
  const int B = a.B, L = a.L, H = a.H, P = a.P, G = a.G, Q = a.Q, N = NC * ns;
  constexpr int SB = slab_of(MODE, NC);
  const int nc = (L + Q - 1) / Q, rows = (Q + 15) & ~15;
  const int nps_a = (P + PB - 1) / PB, nps = (P + SB - 1) / SB;
  const int hb = bwd_heads(H, G, MODE);
  // scratch (kernels/ssd_scan.py:bwd_launch_geometry): the dS slots
  // (B, H, nc, P, N), cum_q (B, H, nc; padded to 4), the dB and dC
  // partials (B, L, H / hb, nps, N) each, and past one column slab dX's
  // partials (B, L, H, ns, P)
  const long long PN = (long long)P * N;
  float* dsc = part;
  float* cq = dsc + (long long)B * H * nc * PN;
  float* dbp = cq + ((long long)B * H * nc + 3) / 4 * 4;
  const long long n_part = (long long)B * L * (H / hb) * nps * N;
  float* dcp = dbp + n_part;
  float* dxp = dcp + n_part;
  // dlog_a straight out when it is f32 and one block's slab holds P and
  // N, else its partials per slab into lpart, summed below
  const bool la_direct = nps * ns == 1 && la_type(a.flags) == OT_F32;
  float* dl = la_direct ? (float*)dla : lpart;
  ssd_scan_bwd_chunk_kernel<NC, MODE, NS><<<dim3(nc * nps_a * ns, H, B), NT,
                                            ChunkSmem<NC, MODE>(rows).bytes, stream>>>(
      log_a, (const bf16*)c, (const bf16*)dy, dsc, cq, L, H, P, G, Q, nps_a, a.sab, a.sal, a.sbb,
      a.sbl, a.xp, a.xlo, a.blo, ns);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  const dim3 sgrid((unsigned)((PN / 4 + NT - 1) / NT), H, B);
  if (a.nst == N)
    ssd_scan_bwd_state_kernel<false><<<sgrid, NT, 0, stream>>>(dsc, cq, dfin, dinit, H, nc,
                                                                (int)PN, N, N);
  else
    ssd_scan_bwd_state_kernel<true><<<sgrid, NT, 0, stream>>>(dsc, cq, dfin, dinit, H, nc,
                                                               (int)PN, N, a.nst);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  ssd_scan_bwd_kernel<NC, MODE, NS><<<dim3(nc * nps * ns, H / hb, B), NT,
                                      BwdSmem<NC, MODE>(rows).bytes, stream>>>(
      (const bf16*)x, log_a, (const bf16*)b, (const bf16*)c, states, (const bf16*)dy, dsc,
      NS != 1 ? (void*)dxp : dx, dbp, dcp, dl, L, H, P, G, Q, nps, hb, a.sxb, a.sxl, a.sab,
      a.sal, a.sbb, a.sbl, a.xp, a.xlo, a.blo, y_type(a.flags), ns);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;
  // dB and dC: the head blocks of each group and the P slabs, in that
  // order, at the true width; dX: the column slabs, in order
  const long long n_rows = (long long)B * L * G;
  const int per = (H / G / hb) * nps;
  const int bct = bc_type(a.flags);
  if ((rc = sum_mid(dbp, db, bct, n_rows, per, N, a.nst, stream)) != 0) return rc;
  if ((rc = sum_mid(dcp, dc, bct, n_rows, per, N, a.nst, stream)) != 0) return rc;
  if (NS != 1 && (rc = sum_mid(dxp, dx, y_type(a.flags), (long long)B * L * H, ns, P, P,
                               stream)) != 0)
    return rc;
  return la_direct ? 0 : sum_mid(lpart, dla, la_type(a.flags), (long long)B * L * H,
                                 nps * ns, 1, 1, stream);
}

// the backward at build width N (is_build(N)), and its occupancy
template <int MODE>
int launch_bwd_n(int N, const void* x, const float* log_a, const void* b, const void* c,
                 const float* states, const void* dy, const float* dfin, void* dx, void* dla,
                 void* db, void* dc, float* dinit, float* part, float* lpart, const ScanArgs& a,
                 cudaStream_t stream) {
  switch (N) {
#define CS_SSD_N(n)                                                                          \
  case n:                                                                                    \
    return launch_bwd<n, MODE, 1>(x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, \
                                  part, lpart, a, 1, stream);
    CS_SSD_N(16) CS_SSD_N(32) CS_SSD_N(64) CS_SSD_N(128)
#undef CS_SSD_N
    default:
      return launch_bwd<N_SLAB, MODE, 0>(x, log_a, b, c, states, dy, dfin, dx, dla, db, dc,
                                         dinit, part, lpart, a, slabs_of(N), stream);
  }
}

template <int MODE>
int bwd_occupancy_n(int N, int Q, int* blocks) {
  switch (N) {
    case 16: return bwd_occupancy<16, MODE, 1>(Q, blocks);
    case 32: return bwd_occupancy<32, MODE, 1>(Q, blocks);
    case 64: return bwd_occupancy<64, MODE, 1>(Q, blocks);
    case 128: return bwd_occupancy<128, MODE, 1>(Q, blocks);
    default: return bwd_occupancy<N_SLAB, MODE, 0>(Q, blocks);
  }
}

}  // namespace
