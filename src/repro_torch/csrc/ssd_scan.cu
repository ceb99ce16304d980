// Mamba-2 SSD chunked scan (state-space duality, arXiv:2405.21060).
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py:ssd_scan_pallas
// (_ssd_kernel).  The Pallas grid (B, H, L/Q) walks the chunk axis in
// order and carries the (P, N) state in VMEM scratch.  Blocks on the card
// run in no order, so here one thread block owns one (batch row, head) and
// loops over the chunks itself, with the state in shared memory.  Per
// chunk of q <= Q steps (the last one may be ragged and is masked):
//
//   cum_t   = sum_{u<=t} log_a_u                      (block scan)
//   y_t     = sum_{s<=t} exp(cum_t - cum_s) (c_t . b_s) x_s
//             + exp(cum_t) c_t . S                     (S: state before)
//   S       = exp(cum_q) S + sum_s exp(cum_q - cum_s) x_s b_s^T
//
// All math is f32, like the Pallas body; x, b and c arrive as bf16 and
// are widened exactly.  exp(cum_t - cum_s) is formed only where s <= t:
// on the other side it can overflow, and 0 * inf would be NaN.  The
// (q x q) matrix (c b^T) * decay does not fit a block's shared memory at
// Q = 256 in f32, so query rows go in slices of TQ.  x, b and c are read
// in their (B, L, ., .) layouts through batch and time strides (no
// transposed copy); head h reads B/C group h / (H / G).
//
// Bound on an H100: the f32 operations, about q(q+1)(N + P) + 4qPN flops
// per (b, h) and chunk on q(P + 2N) bf16 values.  This first version runs
// them as scalar FMAs from shared memory on the CUDA cores (row strides
// padded against bank conflicts), one block of 256 threads per SM.
#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;   // threads per block; also the largest chunk
constexpr int TQ = 32;    // query rows per slice of the intra-chunk product

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// shared memory: S (P x N+1) f32 | x (Q x P) bf16 | b (Q x N+2) bf16 |
// c slice (TQ x N) f32 | M slice (TQ x Q) f32 | cum (Q) | w (Q) | scan (32)
struct SsdSmem {
  int lds, ldb;
  size_t s, x, b, c, m, cum, w, part, bytes;
  __host__ __device__ SsdSmem(int Q, int P, int N) {
    lds = N + 1;
    ldb = N + 2;
    s = 0;
    x = align16(s + sizeof(float) * P * lds);
    b = align16(x + sizeof(bf16) * Q * P);
    c = align16(b + sizeof(bf16) * Q * ldb);
    m = align16(c + sizeof(float) * TQ * N);
    cum = align16(m + sizeof(float) * TQ * Q);
    w = align16(cum + sizeof(float) * Q);
    part = align16(w + sizeof(float) * Q);
    bytes = part + sizeof(float) * 32;
  }
};

__global__ void __launch_bounds__(NT)
ssd_scan_kernel(const bf16* __restrict__ x, const float* __restrict__ la,
                const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                const float* __restrict__ init, bf16* __restrict__ y,
                float* __restrict__ st, int L, int H, int P, int G, int N, int Q,
                long long sxb, long long sxl, long long sab, long long sal,
                long long sbb, long long sbl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const SsdSmem sm(Q, P, N);
  const int lds = sm.lds, ldb = sm.ldb;
  float* S = reinterpret_cast<float*>(smem + sm.s);
  bf16* xs = reinterpret_cast<bf16*>(smem + sm.x);
  bf16* bs = reinterpret_cast<bf16*>(smem + sm.b);
  float* cs = reinterpret_cast<float*>(smem + sm.c);
  float* M = reinterpret_cast<float*>(smem + sm.m);
  float* cum = reinterpret_cast<float*>(smem + sm.cum);
  float* w = reinterpret_cast<float*>(smem + sm.w);
  float* part = reinterpret_cast<float*>(smem + sm.part);

  const int h = blockIdx.x, bb = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bf16* xb = x + bb * sxb + (long long)h * P;
  const float* ab = la + bb * sab + h;
  const bf16* bg = bm + bb * sbb + (long long)g * N;
  const bf16* cg = cm + bb * sbb + (long long)g * N;
  const long long ystep = (long long)H * P;
  bf16* yb = y + (long long)bb * L * ystep + (long long)h * P;
  const long long soff = ((long long)bb * H + h) * P * N;

  for (int i = tid; i < P * N; i += NT)
    S[(i / N) * lds + i % N] = init ? init[soff + i] : 0.f;

  for (int t0 = 0; t0 < L; t0 += Q) {
    const int q = min(Q, L - t0);
    __syncthreads();   // the previous chunk is done with xs, bs, w and S

    // inclusive block scan of log_a over the chunk (one step per thread)
    float v = tid < q ? ab[(t0 + tid) * sal] : 0.f;
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += u;
    }
    if (lane == 31) part[warp] = v;
    __syncthreads();
    if (warp == 0) {
      float u = lane < NT / 32 ? part[lane] : 0.f;
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, u, o);
        if (lane >= o) u += t;
      }
      if (lane < NT / 32) part[lane] = u;
    }
    __syncthreads();
    if (warp > 0) v += part[warp - 1];
    if (tid < Q) cum[tid] = v;

    // this chunk's x and b rows; rows past the ragged edge are zeros
    for (int i = tid; i < Q * P; i += NT) {
      const int s = i / P, p = i % P;
      xs[s * P + p] = s < q ? xb[(t0 + s) * sxl + p] : __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < Q * N; i += NT) {
      const int s = i / N, n = i % N;
      bs[s * ldb + n] = s < q ? bg[(t0 + s) * sbl + n] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    const float cum_end = cum[q - 1];
    if (tid < Q) w[tid] = tid < q ? expf(cum_end - cum[tid]) : 0.f;

    for (int r0 = 0; r0 < q; r0 += TQ) {
      const int nr = min(TQ, q - r0);
      const int ns = r0 + nr;           // keys s < ns reach some row here
      __syncthreads();                  // cs and M of the last slice are read
      for (int i = tid; i < nr * N; i += NT) {
        const int r = i / N, n = i % N;
        cs[r * N + n] = __bfloat162float(cg[(t0 + r0 + r) * sbl + n]);
      }
      __syncthreads();
      // M[r][s] = (c_t . b_s) exp(cum_t - cum_s) where s <= t, else 0
      for (int i = tid; i < nr * ns; i += NT) {
        const int r = i / ns, s = i % ns, t = r0 + r;
        float m = 0.f;
        if (s <= t) {
          float dot = 0.f;
          for (int n = 0; n < N; ++n) dot += cs[r * N + n] * __bfloat162float(bs[s * ldb + n]);
          m = dot * expf(cum[t] - cum[s]);
        }
        M[r * Q + s] = m;
      }
      __syncthreads();
      // y_t = sum_{s<=t} M[r][s] x_s + exp(cum_t) c_t . S
      for (int i = tid; i < nr * P; i += NT) {
        const int r = i / P, p = i % P, t = r0 + r;
        float acc = 0.f;
        for (int s = 0; s <= t; ++s) acc += M[r * Q + s] * __bfloat162float(xs[s * P + p]);
        float inter = 0.f;
        for (int n = 0; n < N; ++n) inter += cs[r * N + n] * S[p * lds + n];
        acc += expf(cum[t]) * inter;
        yb[(t0 + t) * ystep + p] = __float2bfloat16_rn(acc);
      }
    }
    __syncthreads();   // every row of the chunk read S

    // S = exp(cum_end) S + sum_s x_s (w_s b_s)^T
    const float dec = expf(cum_end);
    for (int i = tid; i < P * N; i += NT) {
      const int p = i / N, n = i % N;
      float acc = 0.f;
      for (int s = 0; s < q; ++s)
        acc += __bfloat162float(xs[s * P + p]) * (__bfloat162float(bs[s * ldb + n]) * w[s]);
      S[p * lds + n] = dec * S[p * lds + n] + acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += NT) st[soff + i] = S[(i / N) * lds + i % N];
}

}  // namespace

// x: (B, L, H, P) bf16 at batch/time strides sxb/sxl (H, P packed);
// log_a: (B, L, H) f32 at sab/sal (H packed); b, c: (B, L, G, N) bf16 at
// sbb/sbl (G, N packed); init: (B, H, P, N) f32 contiguous or null (zeros);
// y: (B, L, H, P) bf16 contiguous; st: (B, H, P, N) f32.  Q: chunk <= 256.
CS_EXPORT int cs_ssd_scan(const void* x, const float* log_a, const void* b,
                          const void* c, const float* init, void* y, float* st,
                          int B, int L, int H, int P, int G, int N, int Q,
                          long long sxb, long long sxl, long long sab,
                          long long sal, long long sbb, long long sbl,
                          cudaStream_t stream) {
  if (Q < 1 || Q > NT || G < 1 || H % G != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = SsdSmem(Q, P, N).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, B);
  ssd_scan_kernel<<<grid, NT, smem, stream>>>(
      (const bf16*)x, log_a, (const bf16*)b, (const bf16*)c, init, (bf16*)y, st,
      L, H, P, G, N, Q, sxb, sxl, sab, sal, sbb, sbl);
  return (int)cudaGetLastError();
}
