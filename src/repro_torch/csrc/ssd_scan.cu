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
                float* __restrict__ st, int L, int H, int P, int G, int Q,
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

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int q = min(Q, L - t0), rows = (q + 15) & ~15;
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
           void* y, float* st, int B, int L, int H, int P, int G, int Q, long long sxb,
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
      (const bf16*)x, log_a, (const bf16*)b, (const bf16*)c, init, (bf16*)y, st,
      L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, L, H, P) bf16 at batch/time strides sxb/sxl (H, P packed);
// log_a: (B, L, H) f32 at sab/sal (H packed); b, c: (B, L, G, N) bf16 at
// sbb/sbl (G, N packed); init: (B, H, P, N) f32 contiguous or null (zeros);
// y: (B, L, H, P) bf16 contiguous; st: (B, H, P, N) f32.  Q: chunk <= 256;
// N in {16, 64, 128}; P a multiple of 8; x, b, c, init and st on
// 16-byte boundaries, with strides sxb, sxl, sbb, sbl multiples of 8.
CS_EXPORT int cs_ssd_scan(const void* x, const float* log_a, const void* b,
                          const void* c, const float* init, void* y, float* st,
                          int B, int L, int H, int P, int G, int N, int Q,
                          long long sxb, long long sxl, long long sab,
                          long long sal, long long sbb, long long sbl,
                          cudaStream_t stream) {
  if (Q < 1 || Q > NT || G < 1 || H % G != 0 || P < 1 || P % 8 != 0)
    return (int)cudaErrorInvalidValue;
  switch (N) {
    case 16: return launch<16>(x, log_a, b, c, init, y, st, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    case 64: return launch<64>(x, log_a, b, c, init, y, st, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    case 128: return launch<128>(x, log_a, b, c, init, y, st, B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
