// The scan's bf16 builds (FAST: x, b and c read in place) and their entry
// points; the kernels are in ssd_scan.cuh, the staged builds (any other
// operand of the reference's scan) in ssd_scan_staged.cu.  Exact state
// widths N 16, 32, 64 and 128 (jamba; the JAX benchmarks' audit row;
// mamba2), and 256 (the wide build: two column slabs of 128 over blocks;
// Mamba-2's state expansion).
#include "ssd_scan.cuh"

namespace {

#define SSD_DISPATCH_N(N, CALL)                      \
  switch (N) {                                       \
    case 16: return CALL(16);                        \
    case 32: return CALL(32);                        \
    case 64: return CALL(64);                        \
    case 128: return CALL(128);                      \
    case 256: return CALL(256);                      \
    default: return (int)cudaErrorInvalidValue;      \
  }

bool bad_geometry(int Q, int G, int H, int P) {
  return Q < 1 || Q > NT || G < 1 || H % G != 0 || P < 1;
}

}  // namespace

// x: (B, L, H, P) bf16 at batch/time strides sxb/sxl (H, P packed);
// log_a: (B, L, H) f32 at sab/sal (H packed); b, c: (B, L, G, N) bf16 at
// sbb/sbl (G, N packed); init: (B, H, P, N) f32 contiguous or null (zeros);
// y: (B, L, H, P) bf16 contiguous; st: (B, H, P, N) f32; cst: null, or
// (B, H, nc, P, N) f32 for the state entering each of the nc chunks;
// ypart: at N 256, f32 scratch for y's partials (B, L, H, 2, P), else
// unused (may be null).
// Q: chunk <= 256; N in {16, 32, 64, 128, 256}; P a multiple of 8; x, b, c,
// init and st on 16-byte boundaries, with strides sxb, sxl, sbb, sbl
// multiples of 8.  xp, nst, xlo, blo and flags are the staged builds'
// (ssd_scan_staged.cu): here xp = P, nst = N, mode 0 (FAST).
CS_EXPORT int cs_ssd_scan(const void* x, const float* log_a, const void* b,
                          const void* c, const float* init, void* y, float* st, float* cst,
                          float* ypart,
                          int B, int L, int H, int P, int G, int N, int Q,
                          long long sxb, long long sxl, long long sab,
                          long long sal, long long sbb, long long sbl, int xp, int nst,
                          long long xlo, long long blo, int flags, int mode,
                          cudaStream_t stream) {
  if (bad_geometry(Q, G, H, P) || P % 8 != 0 || mode != FAST || nst != N ||
      (N > 128 && ypart == nullptr))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, P, N, 0, 0, flags};
#define CALL(n) launch<n, FAST>(x, log_a, b, c, init, y, st, cst, ypart, a, stream)
  SSD_DISPATCH_N(N, CALL)
#undef CALL
}

// The backward, on the forward's operands (same layouts and limits) and
// states: (B, H, nc, P, N) f32 as cs_ssd_scan writes them; dy: (B, L, H,
// P) bf16 contiguous; dfin: (B, H, P, N) f32 or null (zeros).  Writes
// dx (B, L, H, P) bf16, dla (B, L, H) f32 (bf16 with OUT_LA_BF16), db and
// dc (B, L, G, N) bf16 and, unless null, dinit (B, H, P, N) f32.  part:
// f32 scratch of B H nc P N + B H nc (rounded up to 4) + 2 B L (H / hb)
// nps N elements, hb the heads per block (2 where H / G is even, else 1),
// nps = ceil(P / 64), and at N 256 B L H 2 P more (dX's partials); lpart:
// B L H nps NS f32 scratch (NS 2 at N 256, else 1) when nps NS > 1 or dla
// is bf16, else unused (may be null).
CS_EXPORT int cs_ssd_scan_bwd(const void* x, const float* log_a, const void* b,
                              const void* c, const float* states, const void* dy,
                              const float* dfin, void* dx, void* dla, void* db, void* dc,
                              float* dinit, float* part, float* lpart, int B, int L, int H,
                              int P, int G, int N, int Q, long long sxb, long long sxl,
                              long long sab, long long sal, long long sbb, long long sbl,
                              int xp, int nst, long long xlo, long long blo, int flags, int mode,
                              cudaStream_t stream) {
  if (bad_geometry(Q, G, H, P) || P % 8 != 0 || mode != FAST || nst != N ||
      (flags & (OUT_F32 | OUT_BC_F32)))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, P, N, 0, 0, flags};
#define CALL(n) launch_bwd<n, FAST>(x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, \
                                    part, lpart, a, stream)
  SSD_DISPATCH_N(N, CALL)
#undef CALL
}

// blocks per SM of the backward's kernels (a), (b) and (c) for state
// width N at chunk Q, into blocks[0..2]
CS_EXPORT int cs_ssd_scan_bwd_occupancy(int N, int Q, int* blocks) {
  if (Q < 1 || Q > NT) return (int)cudaErrorInvalidValue;
#define CALL(n) bwd_occupancy<n, FAST>(Q, blocks)
  SSD_DISPATCH_N(N, CALL)
#undef CALL
}
