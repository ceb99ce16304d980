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
// x, b and c arrive as bf16, log_a and the state as f32; x, b and c are
// read in their (B, L, ., .) layouts through batch and time strides (no
// transposed copy); head h reads B/C group h / (H / G).
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
#include <atomic>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;   // threads per block; also the largest chunk (one scan step each)
constexpr int NW = NT / 32;
constexpr int PT = 32;    // state rows (features p of the head) per block

__host__ __device__ constexpr size_t cmax(size_t a, size_t b) { return a > b ? a : b; }

// shared memory, for rows = q rounded up to 16: B rows (rows x N bf16),
// which at the start and the end hold the f32 state slice (PT x N) instead
// | x slice (rows x PT) bf16 | the state's hi and lo halves (PT x N) bf16
// | cum (rows) f32 | scan partials (NW) f32.  Row strides are padded by 16
// bytes, so ldmatrix and the accumulator layout's accesses hit no bank
// twice.  kernels/ssd_scan.py:launch_geometry mirrors this layout.
template <int N>
struct SsdSmem {
  static constexpr int LDB = N + 8;
  static constexpr int LDX = PT + 8;
  static constexpr int LDF = N + 8;
  size_t b, x, sh, sl, cum, part, bytes;
  __host__ __device__ SsdSmem(int rows) {
    b = 0;
    x = cmax(sizeof(bf16) * rows * LDB, sizeof(float) * PT * LDF);
    sh = x + sizeof(bf16) * rows * LDX;
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

template <int N>
__global__ void __launch_bounds__(NT, 2)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                const float* __restrict__ init, bf16* __restrict__ y,
                float* __restrict__ st, float* __restrict__ cst, int L, int H, int P, int G, int Q,
                long long sxb, long long sxl, long long sab, long long sal,
                long long sbb, long long sbl) {
  using Sm = SsdSmem<N>;
  constexpr int LDB = Sm::LDB, LDX = Sm::LDX, LDF = Sm::LDF;
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

  const int p0 = blockIdx.x * PT, h = blockIdx.y, bb = blockIdx.z;
  const int prow = min(PT, P - p0);   // live state rows of this block
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* xb = x + bb * sxb + (long long)h * P + p0;
  const float* ab = la + bb * sab + h;
  const bf16* bg = bm + bb * sbb + (long long)grp * N;
  const bf16* cg = cm + bb * sbb + (long long)grp * N;
  const long long ystep = (long long)H * P;
  bf16* yb = y + (long long)bb * L * ystep + (long long)h * P + p0;
  const long long soff = (((long long)bb * H + h) * P + p0) * N;
  const int un0 = WIDE ? warp * UN : warp >> 1;   // this warp's first n8 tile
  const int up0 = WIDE ? 0 : warp & 1;            // and first p tile
  const bool upd = WIDE || warp < 2 * (N / 8);

  // the state slice in: 16-byte copies into Sf (rows from P on, or no
  // init: zeros), then the update's accumulators and the hi / lo halves
  for (int i = tid; i < PT * N / 4; i += NT) {
    const int r = i / (N / 4), c4 = (i % (N / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (init != nullptr && r < prow)
      v = __ldg(reinterpret_cast<const float4*>(init + soff + (long long)r * N + c4));
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
      float* dst = cst + ((((long long)bb * H + h) * nc + t0 / Q) * P + p0) * N;
      #pragma unroll
      for (int up = 0; up < UP; ++up) {
        #pragma unroll
        for (int un = 0; un < UN; ++un) {
          const int r = (up0 + up) * 16 + g, c = (un0 + un) * 8 + 2 * t4;
          if (r < prow)
            *reinterpret_cast<float2*>(dst + (long long)r * N + c) =
                make_float2(sacc[up][un][0], sacc[up][un][1]);
          if (r + 8 < prow)
            *reinterpret_cast<float2*>(dst + (long long)(r + 8) * N + c) =
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
        }
      }
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
    }

    // S = exp(cum_q) S + x^T (w o B), w_s = exp(cum_q - cum_s) (0 from q
    // on); U, the chunk's sum, in a zero accumulator
    if (upd) {
      float u[UP][UN][4] = {};
      for (int s0 = 0; s0 < rows; s0 += 16) {
        uint32_t xa[UP][4];   // x^T: rows p, k = s
        #pragma unroll
        for (int up = 0; up < UP; ++up) {
          ldsm_x4_t(xa[up], Xs + (s0 + (lane & 7) + (lane >> 4) * 8) * LDX + (up0 + up) * 16 +
                                ((lane >> 3) & 1) * 8);
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
  for (int i = tid; i < prow * N / 4; i += NT) {
    const int r = i / (N / 4), c4 = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(st + soff + (long long)r * N + c4) =
        *reinterpret_cast<const float4*>(Sf + r * LDF + c4);
  }
}

template <int N>
int launch(const void* x, const float* log_a, const void* b, const void* c, const float* init,
           void* y, float* st, float* cst, int B, int L, int H, int P, int G, int Q, long long sxb,
           long long sxl, long long sab, long long sal, long long sbb, long long sbl,
           cudaStream_t stream) {
  // the kernel opts in to the largest chunk's shared bytes once per
  // device: the attribute belongs to the function, not to the launch
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((opted.load(std::memory_order_relaxed) >> dev) & 1)) {
    err = cudaFuncSetAttribute(ssd_scan_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SsdSmem<N>(NT).bytes);
    if (err != cudaSuccess) return (int)err;
    opted.fetch_or(1ull << dev, std::memory_order_relaxed);
  }
  const size_t smem = SsdSmem<N>((Q + 15) & ~15).bytes;
  dim3 grid((P + PT - 1) / PT, H, B);
  ssd_scan_kernel<N><<<grid, NT, smem, stream>>>(
      (const bf16*)x, log_a, (const bf16*)b, (const bf16*)c, init, (bf16*)y, st, cst,
      L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// The backward.  No TPU kernel to replace: the reference trains through
// its plain scan, which jax.grad differentiates.  Per (b, h) and chunk
// of q steps, with D[t,s] = exp(cum_t - cum_s) for s <= t (else 0),
// M = D o (C B^T), R = dY X^T, K = M o R, w_s = exp(cum_q - cum_s),
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
// (b, h) and chunk against the bytes of x, dY, b, c and one state per
// chunk; this first version runs them on the CUDA cores in f32 (every
// bf16 operand widened as it is read), so the f32 rate bounds it.  The
// design:
//
// * The forward's grid (P / PT, H, B): a block owns rows [p0, p0 + PT)
//   of its head's state and walks the chunks from the last to the first,
//   carrying its PT x N slice of dS in shared memory.  dX is its own;
//   dB, dC and dlog_a sum over P (and dB, dC over the heads of a group),
//   so the block writes f32 partials per (step, head, P slice) and a
//   second kernel sums them in a fixed order: no atomics, so two calls
//   on the same inputs are bitwise equal.
// * Two passes over 32 x 32 tiles of the chunk's causal (t, s) plane.
//   A thread owns one row of the tile (8 threads a row) and four of its
//   columns, and forms C_t . B_s and dY_t . X_s for them from shared
//   memory.  Pass 1 walks rows t: dC[t] += (D o R)[t, :] B, and the
//   row sums of K.  Pass 2 walks columns s: dX[s] += M[:, s]^T dY,
//   dB[s] += (D o R)[:, s]^T C, and the column sums of K.  The tile's
//   factors go through shared memory, the row sums through a fixed
//   shuffle tree.
// * exp(cum_t - cum_s) only where s <= t, by a select (as the forward);
//   e_t and w_s only for steps before q.  Rows from q on are zero-filled,
//   so they add nothing.
// * Shared memory: B and C rows (rows x N bf16), the x and dY slices
//   (rows x PT bf16), S_in and dS (PT x N f32), cum, exp(cum), dcum and
//   the w terms (rows f32), two tiles (at q 256, N 128: 208 KB, one
//   block per SM).  Odd word pitches keep each access conflict-free.
constexpr int BT = 32;   // edge of the backward's (t, s) tiles
constexpr unsigned FULL = 0xffffffffu;

template <int N>
struct BwdSmem {
  static constexpr int LDN = N + 2;    // bf16 pitch of B and C rows
  static constexpr int LDP = PT + 2;   // bf16 pitch of the x and dY rows
  static constexpr int LDS = N + 1;    // f32 pitch of S_in and dS rows
  static constexpr int LDT = BT + 1;   // f32 pitch of a tile
  size_t b, c, x, dy, s, ds, cum, ecum, dcum, wt, tm, tr, part, bytes;
  __host__ __device__ BwdSmem(int rows) {
    b = 0;
    c = b + sizeof(bf16) * rows * LDN;
    x = c + sizeof(bf16) * rows * LDN;
    dy = x + sizeof(bf16) * rows * LDP;
    s = dy + sizeof(bf16) * rows * LDP;
    ds = s + sizeof(float) * PT * LDS;
    cum = ds + sizeof(float) * PT * LDS;
    ecum = cum + sizeof(float) * rows;
    dcum = ecum + sizeof(float) * rows;
    wt = dcum + sizeof(float) * rows;
    tm = wt + sizeof(float) * rows;
    tr = tm + sizeof(float) * BT * LDT;
    part = tr + sizeof(float) * BT * LDT;
    bytes = part + sizeof(float) * NW;
  }
};

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int N>
__global__ void __launch_bounds__(NT, 1)
ssd_scan_bwd_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                    const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                    const float* __restrict__ cst, const bf16* __restrict__ dy,
                    const float* __restrict__ dfin, bf16* __restrict__ dx,
                    float* __restrict__ dinit, float* __restrict__ dbp,
                    float* __restrict__ dcp, float* __restrict__ dlap, int L, int H, int P,
                    int G, int Q, long long sxb, long long sxl, long long sab, long long sal,
                    long long sbb, long long sbl) {
  using Sm = BwdSmem<N>;
  constexpr int LDN = Sm::LDN, LDP = Sm::LDP, LDS = Sm::LDS, LDT = Sm::LDT;
  constexpr int NN = N / 16;    // column pairs of N a thread owns: 2 jj + 16 m
  constexpr int NP = PT / 16;   // column pairs of P a thread owns
  extern __shared__ __align__(16) unsigned char smem[];
  const Sm sm((Q + BT - 1) / BT * BT);
  bf16* Bs = reinterpret_cast<bf16*>(smem + sm.b);
  bf16* Cs = reinterpret_cast<bf16*>(smem + sm.c);
  bf16* Xs = reinterpret_cast<bf16*>(smem + sm.x);
  bf16* Ys = reinterpret_cast<bf16*>(smem + sm.dy);
  float* Ss = reinterpret_cast<float*>(smem + sm.s);
  float* dSs = reinterpret_cast<float*>(smem + sm.ds);
  float* cum = reinterpret_cast<float*>(smem + sm.cum);
  float* ecum = reinterpret_cast<float*>(smem + sm.ecum);
  float* dcum = reinterpret_cast<float*>(smem + sm.dcum);
  float* wt = reinterpret_cast<float*>(smem + sm.wt);
  float* TM = reinterpret_cast<float*>(smem + sm.tm);
  float* TR = reinterpret_cast<float*>(smem + sm.tr);
  float* part = reinterpret_cast<float*>(smem + sm.part);

  const int ps = blockIdx.x, p0 = ps * PT, h = blockIdx.y, bb = blockIdx.z;
  const int nps = gridDim.x;
  const int prow = min(PT, P - p0);
  const int grp = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rr = tid >> 3, jj = tid & 7;   // a tile row, and the thread's columns in it
  const bf16* xb = x + bb * sxb + (long long)h * P + p0;
  const float* ab = la + bb * sab + h;
  const bf16* bg = bm + bb * sbb + (long long)grp * N;
  const bf16* cg = cm + bb * sbb + (long long)grp * N;
  const long long ystep = (long long)H * P;
  const bf16* yb = dy + (long long)bb * L * ystep + (long long)h * P + p0;
  bf16* dxb = dx + (long long)bb * L * ystep + (long long)h * P + p0;
  const long long soff = (((long long)bb * H + h) * P + p0) * N;
  const int nc = (L + Q - 1) / Q;

  // dS of the last chunk: the final state's cotangent, or zeros
  for (int i = tid; i < PT * N; i += NT) {
    const int r = i / N, cc = i % N;
    dSs[r * LDS + cc] = dfin != nullptr && r < prow ? __ldg(dfin + soff + (long long)r * N + cc)
                                                    : 0.f;
  }

  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * Q, q = min(Q, L - t0), rows = (q + BT - 1) / BT * BT;
    const int n_tiles = rows / BT;
    // this chunk's rows (zeros from q on, and x / dY columns from P on)
    for (int i = tid; i < rows * (N / 2); i += NT) {
      const int r = i / (N / 2), c2 = (i % (N / 2)) * 2;
      uint32_t vb = 0u, vc = 0u;
      if (r < q) {
        const long long off = (long long)(t0 + r) * sbl + c2;
        vb = __ldg(reinterpret_cast<const unsigned int*>(bg + off));
        vc = __ldg(reinterpret_cast<const unsigned int*>(cg + off));
      }
      *reinterpret_cast<uint32_t*>(Bs + r * LDN + c2) = vb;
      *reinterpret_cast<uint32_t*>(Cs + r * LDN + c2) = vc;
    }
    for (int i = tid; i < rows * (PT / 2); i += NT) {
      const int r = i / (PT / 2), c2 = (i % (PT / 2)) * 2;
      uint32_t vx = 0u, vy = 0u;
      if (r < q && c2 < prow) {
        vx = __ldg(reinterpret_cast<const unsigned int*>(xb + (long long)(t0 + r) * sxl + c2));
        vy = __ldg(reinterpret_cast<const unsigned int*>(yb + (long long)(t0 + r) * ystep + c2));
      }
      *reinterpret_cast<uint32_t*>(Xs + r * LDP + c2) = vx;
      *reinterpret_cast<uint32_t*>(Ys + r * LDP + c2) = vy;
    }
    const float* s_in = cst + ((((long long)bb * H + h) * nc + k) * P + p0) * N;
    for (int i = tid; i < PT * N; i += NT) {
      const int r = i / N, cc = i % N;
      Ss[r * LDS + cc] = r < prow ? __ldg(s_in + (long long)r * N + cc) : 0.f;
    }
    // inclusive block scan of log_a (one step per thread; rows from q on
    // carry cum_q)
    float v = tid < q ? ab[(long long)(t0 + tid) * sal] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) part[warp] = v;
    __syncthreads();
    float pre = 0.f;
    for (int w = 0; w < warp; ++w) pre += part[w];
    if (tid < rows) {
      cum[tid] = v + pre;
      ecum[tid] = tid < q ? expf(v + pre) : 0.f;
    }
    __syncthreads();
    const float cum_end = cum[q - 1];

    // pass 1: rows t of the tile, columns s <= t
    for (int it = 0; it < n_tiles; ++it) {
      const int t = it * BT + rr;
      const float cum_t = cum[t];
      float acc[2 * NN];
      #pragma unroll
      for (int i = 0; i < 2 * NN; ++i) acc[i] = 0.f;
      float rowk = 0.f;
      for (int is = 0; is <= it; ++is) {
        const int si0 = is * BT;
        float gk[4] = {0.f, 0.f, 0.f, 0.f}, rk[4] = {0.f, 0.f, 0.f, 0.f};
        #pragma unroll 4
        for (int n = 0; n < N; n += 2) {
          const float2 cv = ld_bf2(Cs + t * LDN + n);
          #pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 bv = ld_bf2(Bs + (si0 + jj + 8 * kk) * LDN + n);
            gk[kk] = fmaf(cv.x, bv.x, fmaf(cv.y, bv.y, gk[kk]));
          }
        }
        #pragma unroll 4
        for (int pp = 0; pp < PT; pp += 2) {
          const float2 yv = ld_bf2(Ys + t * LDP + pp);
          #pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 xv = ld_bf2(Xs + (si0 + jj + 8 * kk) * LDP + pp);
            rk[kk] = fmaf(yv.x, xv.x, fmaf(yv.y, xv.y, rk[kk]));
          }
        }
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int sl = jj + 8 * kk, s = si0 + sl;
          const float d = s <= t ? expf(cum_t - cum[s]) : 0.f;
          const float dr = d * rk[kk];
          TR[rr * LDT + sl] = dr;
          rowk = fmaf(dr, gk[kk], rowk);
        }
        __syncthreads();
        for (int sl = 0; sl < BT; ++sl) {
          const float dr = TR[rr * LDT + sl];
          const bf16* brow = Bs + (si0 + sl) * LDN + 2 * jj;
          #pragma unroll
          for (int m = 0; m < NN; ++m) {
            const float2 bv = ld_bf2(brow + 16 * m);
            acc[2 * m] = fmaf(dr, bv.x, acc[2 * m]);
            acc[2 * m + 1] = fmaf(dr, bv.y, acc[2 * m + 1]);
          }
        }
        __syncthreads();   // TR is read
      }
      // dC[t] += e_t dY_t S_in; dcum_t = row sum of K + e_t C_t . (dY_t S_in)
      float z[2 * NN];
      #pragma unroll
      for (int i = 0; i < 2 * NN; ++i) z[i] = 0.f;
      for (int pp = 0; pp < PT; ++pp) {
        const float yv = __bfloat162float(Ys[t * LDP + pp]);
        const float* srow = Ss + pp * LDS + 2 * jj;
        #pragma unroll
        for (int m = 0; m < NN; ++m) {
          z[2 * m] = fmaf(yv, srow[16 * m], z[2 * m]);
          z[2 * m + 1] = fmaf(yv, srow[16 * m + 1], z[2 * m + 1]);
        }
      }
      const float e_t = ecum[t];
      float cz = 0.f;
      #pragma unroll
      for (int m = 0; m < NN; ++m) {
        const float2 cv = ld_bf2(Cs + t * LDN + 2 * jj + 16 * m);
        cz = fmaf(cv.x, z[2 * m], fmaf(cv.y, z[2 * m + 1], cz));
        acc[2 * m] = fmaf(e_t, z[2 * m], acc[2 * m]);
        acc[2 * m + 1] = fmaf(e_t, z[2 * m + 1], acc[2 * m + 1]);
      }
      float tot = fmaf(e_t, cz, rowk);
      tot += __shfl_xor_sync(FULL, tot, 1);
      tot += __shfl_xor_sync(FULL, tot, 2);
      tot += __shfl_xor_sync(FULL, tot, 4);
      if (jj == 0) dcum[t] = tot;
      if (t < q) {
        float* dst = dcp + ((((long long)bb * L + t0 + t) * H + h) * nps + ps) * N + 2 * jj;
        #pragma unroll
        for (int m = 0; m < NN; ++m)
          *reinterpret_cast<float2*>(dst + 16 * m) = make_float2(acc[2 * m], acc[2 * m + 1]);
      }
    }
    __syncthreads();

    // pass 2: rows s of the tile, columns t >= s
    for (int is = 0; is < n_tiles; ++is) {
      const int s = is * BT + rr;
      const float cum_s = cum[s];
      float ax[2 * NP], acc[2 * NN];
      #pragma unroll
      for (int i = 0; i < 2 * NP; ++i) ax[i] = 0.f;
      #pragma unroll
      for (int i = 0; i < 2 * NN; ++i) acc[i] = 0.f;
      float colk = 0.f;
      for (int it = is; it < n_tiles; ++it) {
        const int ti0 = it * BT;
        float gk[4] = {0.f, 0.f, 0.f, 0.f}, rk[4] = {0.f, 0.f, 0.f, 0.f};
        #pragma unroll 4
        for (int n = 0; n < N; n += 2) {
          const float2 bv = ld_bf2(Bs + s * LDN + n);
          #pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 cv = ld_bf2(Cs + (ti0 + jj + 8 * kk) * LDN + n);
            gk[kk] = fmaf(cv.x, bv.x, fmaf(cv.y, bv.y, gk[kk]));
          }
        }
        #pragma unroll 4
        for (int pp = 0; pp < PT; pp += 2) {
          const float2 xv = ld_bf2(Xs + s * LDP + pp);
          #pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float2 yv = ld_bf2(Ys + (ti0 + jj + 8 * kk) * LDP + pp);
            rk[kk] = fmaf(yv.x, xv.x, fmaf(yv.y, xv.y, rk[kk]));
          }
        }
        #pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int tl = jj + 8 * kk, t = ti0 + tl;
          const float d = s <= t ? expf(cum[t] - cum_s) : 0.f;
          const float mv = d * gk[kk];
          TM[rr * LDT + tl] = mv;
          TR[rr * LDT + tl] = d * rk[kk];
          colk = fmaf(mv, rk[kk], colk);
        }
        __syncthreads();
        for (int tl = 0; tl < BT; ++tl) {
          const float mv = TM[rr * LDT + tl], dr = TR[rr * LDT + tl];
          const bf16* yrow = Ys + (ti0 + tl) * LDP + 2 * jj;
          const bf16* crow = Cs + (ti0 + tl) * LDN + 2 * jj;
          #pragma unroll
          for (int m = 0; m < NP; ++m) {
            const float2 yv = ld_bf2(yrow + 16 * m);
            ax[2 * m] = fmaf(mv, yv.x, ax[2 * m]);
            ax[2 * m + 1] = fmaf(mv, yv.y, ax[2 * m + 1]);
          }
          #pragma unroll
          for (int m = 0; m < NN; ++m) {
            const float2 cv = ld_bf2(crow + 16 * m);
            acc[2 * m] = fmaf(dr, cv.x, acc[2 * m]);
            acc[2 * m + 1] = fmaf(dr, cv.y, acc[2 * m + 1]);
          }
        }
        __syncthreads();   // TM and TR are read
      }
      // dB[s] += w_s X_s dS; dX[s] += w_s B_s dS^T; dcum_s -= the column
      // sum of K and w_s B_s . (X_s dS)
      const float w_s = s < q ? expf(cum_end - cum_s) : 0.f;
      float z[2 * NN];
      #pragma unroll
      for (int i = 0; i < 2 * NN; ++i) z[i] = 0.f;
      for (int pp = 0; pp < PT; ++pp) {
        const float xv = __bfloat162float(Xs[s * LDP + pp]);
        const float* drow = dSs + pp * LDS + 2 * jj;
        #pragma unroll
        for (int m = 0; m < NN; ++m) {
          z[2 * m] = fmaf(xv, drow[16 * m], z[2 * m]);
          z[2 * m + 1] = fmaf(xv, drow[16 * m + 1], z[2 * m + 1]);
        }
      }
      float bz = 0.f;
      #pragma unroll
      for (int m = 0; m < NN; ++m) {
        const float2 bv = ld_bf2(Bs + s * LDN + 2 * jj + 16 * m);
        bz = fmaf(bv.x, z[2 * m], fmaf(bv.y, z[2 * m + 1], bz));
        acc[2 * m] = fmaf(w_s, z[2 * m], acc[2 * m]);
        acc[2 * m + 1] = fmaf(w_s, z[2 * m + 1], acc[2 * m + 1]);
      }
      float u[2 * NP];
      #pragma unroll
      for (int i = 0; i < 2 * NP; ++i) u[i] = 0.f;
      for (int n = 0; n < N; ++n) {
        const float bv = __bfloat162float(Bs[s * LDN + n]);
        #pragma unroll
        for (int m = 0; m < NP; ++m) {
          u[2 * m] = fmaf(bv, dSs[(2 * jj + 16 * m) * LDS + n], u[2 * m]);
          u[2 * m + 1] = fmaf(bv, dSs[(2 * jj + 16 * m + 1) * LDS + n], u[2 * m + 1]);
        }
      }
      float wb = w_s * bz;
      wb += __shfl_xor_sync(FULL, wb, 1);
      wb += __shfl_xor_sync(FULL, wb, 2);
      wb += __shfl_xor_sync(FULL, wb, 4);
      colk += __shfl_xor_sync(FULL, colk, 1);
      colk += __shfl_xor_sync(FULL, colk, 2);
      colk += __shfl_xor_sync(FULL, colk, 4);
      if (jj == 0) {
        dcum[s] -= colk + wb;
        wt[s] = wb;
      }
      if (s < q) {
        bf16* xo = dxb + (long long)(t0 + s) * ystep + 2 * jj;
        #pragma unroll
        for (int m = 0; m < NP; ++m) {
          if (2 * jj + 16 * m < prow)
            *reinterpret_cast<uint32_t*>(xo + 16 * m) =
                pack_bf16(fmaf(w_s, u[2 * m], ax[2 * m]), fmaf(w_s, u[2 * m + 1], ax[2 * m + 1]));
        }
        float* dst = dbp + ((((long long)bb * L + t0 + s) * H + h) * nps + ps) * N + 2 * jj;
        #pragma unroll
        for (int m = 0; m < NN; ++m)
          *reinterpret_cast<float2*>(dst + 16 * m) = make_float2(acc[2 * m], acc[2 * m + 1]);
      }
    }
    __syncthreads();   // dcum, wt complete; every read of dS is done

    // dS_in = exp(cum_q) dS + (e o dY)^T C, and <dS, S_in>
    {
      const int pr = rr;
      float a[2 * NN];
      #pragma unroll
      for (int i = 0; i < 2 * NN; ++i) a[i] = 0.f;
      for (int t = 0; t < q; ++t) {
        const float ey = ecum[t] * __bfloat162float(Ys[t * LDP + pr]);
        const bf16* crow = Cs + t * LDN + 2 * jj;
        #pragma unroll
        for (int m = 0; m < NN; ++m) {
          const float2 cv = ld_bf2(crow + 16 * m);
          a[2 * m] = fmaf(ey, cv.x, a[2 * m]);
          a[2 * m + 1] = fmaf(ey, cv.y, a[2 * m + 1]);
        }
      }
      const float dec = expf(cum_end);
      float inner = 0.f;
      #pragma unroll
      for (int m = 0; m < NN; ++m) {
        #pragma unroll
        for (int i = 0; i < 2; ++i) {
          float* e = dSs + pr * LDS + 2 * jj + 16 * m + i;
          inner = fmaf(*e, Ss[pr * LDS + 2 * jj + 16 * m + i], inner);
          *e = fmaf(dec, *e, a[2 * m + i]);   // this thread's element alone
        }
      }
      #pragma unroll
      for (int o = 16; o > 0; o >>= 1) inner += __shfl_xor_sync(FULL, inner, o);
      if (lane == 0) part[warp] = inner;
      __syncthreads();
      if (tid == 0) {
        float sum = 0.f;
        for (int w = 0; w < NW; ++w) sum += part[w];
        float sw = 0.f;
        for (int s = 0; s < q; ++s) sw += wt[s];
        dcum[q - 1] += dec * sum + sw;
      }
      __syncthreads();
    }

    // dlog_a: the reverse inclusive scan of dcum within the chunk
    {
      float r = tid < q ? dcum[tid] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_down_sync(FULL, r, o);
        if (lane + o < 32) r += u;
      }
      if (lane == 0) part[warp] = r;
      __syncthreads();
      float post = 0.f;
      for (int w = NW - 1; w > warp; --w) post += part[w];
      if (tid < q) dlap[(((long long)bb * L + t0 + tid) * H + h) * nps + ps] = r + post;
      __syncthreads();   // part, and every row of this chunk, are free again
    }
  }

  if (dinit != nullptr) {
    for (int i = tid; i < prow * N; i += NT) {
      const int r = i / N, cc = i % N;
      dinit[soff + (long long)r * N + cc] = dSs[r * LDS + cc];
    }
  }
}

// out[i, j] = sum over k, in order, of part[i, k, j] (f32 partials), as
// bf16 (out_bf) or f32 (out_f)
__global__ void sum_mid_kernel(const float* __restrict__ part, bf16* __restrict__ out_bf,
                               float* __restrict__ out_f, long long I, int K, int J) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= I * J) return;
  const long long row = i / J;
  const int j = (int)(i % J);
  const float* src = part + row * K * J + j;
  float sum = 0.f;
  for (int k = 0; k < K; ++k) sum += src[(long long)k * J];
  if (out_bf != nullptr) out_bf[i] = __float2bfloat16_rn(sum);
  else out_f[i] = sum;
}

int sum_mid(const float* part, bf16* out_bf, float* out_f, long long I, int K, int J,
            cudaStream_t stream) {
  const long long n = I * J;
  sum_mid_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(part, out_bf, out_f, I, K, J);
  return (int)cudaGetLastError();
}

template <int N>
int launch_bwd(const void* x, const float* log_a, const void* b, const void* c,
               const float* states, const void* dy, const float* dfin, void* dx, float* dla,
               void* db, void* dc, float* dinit, float* part, float* lpart, int B, int L, int H,
               int P, int G, int Q, long long sxb, long long sxl, long long sab, long long sal,
               long long sbb, long long sbl, cudaStream_t stream) {
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((opted.load(std::memory_order_relaxed) >> dev) & 1)) {
    err = cudaFuncSetAttribute(ssd_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)BwdSmem<N>(NT).bytes);
    if (err != cudaSuccess) return (int)err;
    opted.fetch_or(1ull << dev, std::memory_order_relaxed);
  }
  const int nps = (P + PT - 1) / PT;
  const size_t smem = BwdSmem<N>((Q + BT - 1) / BT * BT).bytes;
  const long long n_part = (long long)B * L * H * nps * N;
  dim3 grid(nps, H, B);
  ssd_scan_bwd_kernel<N><<<grid, NT, smem, stream>>>(
      (const bf16*)x, log_a, (const bf16*)b, (const bf16*)c, states, (const bf16*)dy, dfin,
      (bf16*)dx, dinit, part, part + n_part, lpart, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  // dB and dC: the heads of each group and the P slices, in that order
  const long long rows = (long long)B * L * G;
  const int per = (H / G) * nps;
  if ((rc = sum_mid(part, (bf16*)db, nullptr, rows, per, N, stream)) != 0) return rc;
  if ((rc = sum_mid(part + n_part, (bf16*)dc, nullptr, rows, per, N, stream)) != 0) return rc;
  return sum_mid(lpart, nullptr, dla, (long long)B * L * H, nps, 1, stream);
}

}  // namespace

// x: (B, L, H, P) bf16 at batch/time strides sxb/sxl (H, P packed);
// log_a: (B, L, H) f32 at sab/sal (H packed); b, c: (B, L, G, N) bf16 at
// sbb/sbl (G, N packed); init: (B, H, P, N) f32 contiguous or null (zeros);
// y: (B, L, H, P) bf16 contiguous; st: (B, H, P, N) f32; cst: null, or
// (B, H, nc, P, N) f32 for the state entering each of the nc chunks.
// Q: chunk <= 256; N in {16, 64, 128}; P a multiple of 8; x, b, c, init
// and st on 16-byte boundaries, with strides sxb, sxl, sbb, sbl
// multiples of 8.
CS_EXPORT int cs_ssd_scan(const void* x, const float* log_a, const void* b,
                          const void* c, const float* init, void* y, float* st, float* cst,
                          int B, int L, int H, int P, int G, int N, int Q,
                          long long sxb, long long sxl, long long sab,
                          long long sal, long long sbb, long long sbl,
                          cudaStream_t stream) {
  if (Q < 1 || Q > NT || G < 1 || H % G != 0 || P < 1 || P % 8 != 0)
    return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch<16>(x, log_a, b, c, init, y, st, cst, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    case 64: return launch<64>(x, log_a, b, c, init, y, st, cst, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    case 128: return launch<128>(x, log_a, b, c, init, y, st, cst, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward, on the forward's operands (same layouts and limits) and
// states: (B, H, nc, P, N) f32 as cs_ssd_scan writes them; dy: (B, L, H,
// P) bf16 contiguous; dfin: (B, H, P, N) f32 or null (zeros).  Writes
// dx (B, L, H, P) bf16, dla (B, L, H) f32, db and dc (B, L, G, N) bf16
// and, unless null, dinit (B, H, P, N) f32.  part: 2 B L H nps N f32 and
// lpart: B L H nps f32 scratch, nps = ceil(P / 32).
CS_EXPORT int cs_ssd_scan_bwd(const void* x, const float* log_a, const void* b,
                              const void* c, const float* states, const void* dy,
                              const float* dfin, void* dx, float* dla, void* db, void* dc,
                              float* dinit, float* part, float* lpart, int B, int L, int H,
                              int P, int G, int N, int Q, long long sxb, long long sxl,
                              long long sab, long long sal, long long sbb, long long sbl,
                              cudaStream_t stream) {
  if (Q < 1 || Q > NT || G < 1 || H % G != 0 || P < 1 || P % 8 != 0)
    return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch_bwd<16>(x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, part, lpart, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    case 64: return launch_bwd<64>(x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, part, lpart, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    case 128: return launch_bwd<128>(x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, part, lpart, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
