// The scan's staged builds (ssd_scan.cuh, mode SPLIT): every operand the
// reference's scan takes that the bf16 builds do not read in place.
// ssd_stage_kernel copies it, through its four strides, into a packed
// scratch that the kernels read as they read bf16 in place: x and dY (B,
// L, H, Pp), Pp = P rounded up to 8; b and c (B, L, G, N) on the build N,
// the next of 16, 32, 64 and 128 up from the true width, or past 128 the
// next multiple of 128 (the slabbed build); columns past the true width
// zero.  Data is written as bf16 hi and lo
// halves, which keep about 16 bits of f32 data through the tensor-core
// products (a bf16 value's lo half is 0).  An f16 value is exactly its
// bf16 hi + lo: 11 significant bits, and an exponent range inside bf16's
// (its subnormals too), so f16 operands reach the products exactly, and
// the staged kernels compute on them what they compute on the same values
// in f32 (no f16 scan body: a chunk's decay factors exp(cum) fall far
// below f16's smallest normal, 6.1e-5).  The same kernel widens a bf16,
// f16 or strided log_a to packed f32 and copies an init_state the kernel
// does not read in place to (B, H, P, N) f32.  The pass reads
// each staged operand once and writes it once (twice the bf16 bytes in
// SPLIT); y, dX, dB, dC, dlog_a and the states are written straight into
// the caller's dtype and layout by the kernels.
#include "ssd_scan.cuh"

namespace {

// src (d0, d1, d2, d3) of type src_type (0 bf16, 1 f32, 2 f16) at strides
// s0..s3 -> dst (d0, d1, d2, W) packed, columns from d3 on zero: split,
// bf16 hi with its lo half at dst + lo_off; else f32
__global__ void ssd_stage_kernel(const void* __restrict__ src, int src_type, int d1, int d2,
                                 int d3, long long s0, long long s1, long long s2, long long s3,
                                 void* __restrict__ dst, int W, int split, long long lo_off,
                                 long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int col = (int)(i % W);
    long long r = i / W;
    const int i2 = (int)(r % d2);
    r /= d2;
    const int i1 = (int)(r % d1);
    const long long i0 = r / d1;
    float v = 0.f;
    if (col < d3) {
      const long long off = i0 * s0 + i1 * s1 + i2 * s2 + col * s3;
      v = src_type == 1   ? reinterpret_cast<const float*>(src)[off]
          : src_type == 2 ? __half2float(reinterpret_cast<const __half*>(src)[off])
                          : __bfloat162float(reinterpret_cast<const bf16*>(src)[off]);
    }
    if (split) {
      const bf16 h = __float2bfloat16_rn(v);
      reinterpret_cast<bf16*>(dst)[i] = h;
      reinterpret_cast<bf16*>(dst)[i + lo_off] = __float2bfloat16_rn(v - __bfloat162float(h));
    } else {
      reinterpret_cast<float*>(dst)[i] = v;
    }
  }
}

bool bad_geometry(int Q, int G, int H, int P, int N, int nst, int xp) {
  return Q < 1 || Q > NT || G < 1 || H % G != 0 || P < 1 || nst < 1 || nst > N || xp < P ||
         xp % 8 != 0 || !is_build(N);
}

}  // namespace

// Stage one operand (see ssd_stage_kernel); n = d0 d1 d2 W elements out.
CS_EXPORT int cs_ssd_stage(const void* src, int src_type, long long d0, int d1, int d2, int d3,
                           long long s0, long long s1, long long s2, long long s3, void* dst,
                           int W, int split, long long lo_off, cudaStream_t stream) {
  if (d1 < 1 || d2 < 1 || d3 < 1 || W < d3) return (int)cudaErrorInvalidValue;
  const long long n = d0 * d1 * d2 * W;
  if (n == 0) return 0;
  const long long want = (n + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);   // grid-stride past 8 a SM
  ssd_stage_kernel<<<blocks, 256, 0, stream>>>(src, src_type, d1, d2, d3, s0, s1, s2, s3, dst, W,
                                               split, lo_off, n);
  return (int)cudaGetLastError();
}

// As cs_ssd_scan on staged operands: x (B, L, H, xp) and b, c (B, L, G,
// N) bf16 at the strides given (packed), with their lo halves xlo and blo
// elements on (mode 1, SPLIT); N the build, nst <= N the true width
// (st is (B, H, P, nst)); init (B, H, P, N) f32 contiguous or null; y
// (B, L, H, P) contiguous, f32 with OUT_F32 in flags, f16 with OUT_F16,
// else bf16; ypart as
// cs_ssd_scan's.
CS_EXPORT int cs_ssd_scan_staged(const void* x, const float* log_a, const void* b,
                                 const void* c, const float* init, void* y, float* st, float* cst,
                                 float* ypart,
                                 int B, int L, int H, int P, int G, int N, int Q,
                                 long long sxb, long long sxl, long long sab,
                                 long long sal, long long sbb, long long sbl, int xp, int nst,
                                 long long xlo, long long blo, int flags, int mode,
                                 cudaStream_t stream) {
  if (bad_geometry(Q, G, H, P, N, nst, xp) || mode != SPLIT || (N > N_SLAB && ypart == nullptr))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, xp, nst, xlo, blo, flags};
  return launch_n<SPLIT>(N, x, log_a, b, c, init, y, st, cst, ypart, a, stream);
}

// As cs_ssd_scan_bwd on staged operands (dy staged as x is, at its
// strides); dx in x's layout (B, L, H, P), f32 with OUT_F32, f16 with
// OUT_F16; db and dc (B, L, G, nst), f32 with OUT_BC_F32, f16 with
// OUT_BC_F16; dla f32, or bf16 with OUT_LA_BF16, f16 with OUT_LA_F16;
// dfin and dinit (B, H, P, nst) f32.  part and lpart as
// kernels/ssd_scan.py:bwd_launch_geometry lays them out for SPLIT (one
// head a block, P slabs of 32, 16 at N 128 and past it).
CS_EXPORT int cs_ssd_scan_bwd_staged(const void* x, const float* log_a, const void* b,
                                     const void* c, const float* states, const void* dy,
                                     const float* dfin, void* dx, void* dla, void* db, void* dc,
                                     float* dinit, float* part, float* lpart, int B, int L,
                                     int H, int P, int G, int N, int Q, long long sxb,
                                     long long sxl, long long sab, long long sal, long long sbb,
                                     long long sbl, int xp, int nst, long long xlo, long long blo,
                                     int flags, int mode, cudaStream_t stream) {
  if (bad_geometry(Q, G, H, P, N, nst, xp) || mode != SPLIT) return (int)cudaErrorInvalidValue;
  const ScanArgs a{B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, xp, nst, xlo, blo, flags};
  return launch_bwd_n<SPLIT>(N, x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, part,
                             lpart, a, stream);
}

// blocks per SM of the staged backward's kernels (a), (b) and (c)
CS_EXPORT int cs_ssd_scan_bwd_occupancy_staged(int N, int Q, int* blocks) {
  if (Q < 1 || Q > NT || !is_build(N)) return (int)cudaErrorInvalidValue;
  return bwd_occupancy_n<SPLIT>(N, Q, blocks);
}
