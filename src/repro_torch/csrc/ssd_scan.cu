// The scan's bf16 builds (FAST: x, b and c read in place) and their entry
// points; the kernels are in ssd_scan.cuh, the staged builds (any other
// operand of the reference's scan takes) in ssd_scan_staged.cu.  Exact
// state widths N 16, 32, 64 and 128 (jamba; the JAX benchmarks' audit
// row; mamba2), and every multiple of 128 past it on the slabbed build
// (N / 128 column slabs of 128 over blocks, the slab count a grid
// dimension; Mamba-2's state expansion: 256, 512).
#include "ssd_scan.cuh"

namespace {

bool bad_geometry(int Q, int G, int H, int P) {
  return Q < 1 || Q > NT || G < 1 || H % G != 0 || P < 1;
}

}  // namespace

// x: (B, L, H, P) bf16 at batch/time strides sxb/sxl (H, P packed);
// log_a: (B, L, H) f32 at sab/sal (H packed); b, c: (B, L, G, N) bf16 at
// sbb/sbl (G, N packed); init: (B, H, P, N) f32 contiguous or null (zeros);
// y: (B, L, H, P) bf16 contiguous; st: (B, H, P, N) f32; cst: null, or
// (B, H, nc, P, N) f32 for the state entering each of the nc chunks;
// ypart: past N 128, f32 scratch for y's partials (B, L, H, N / 128, P),
// else unused (may be null).
// Q: chunk <= 256; N 16, 32, 64, 128 or a multiple of 128; P a multiple of
// 8; x, b, c, init and st on 16-byte boundaries, with strides sxb, sxl,
// sbb, sbl multiples of 8.  xp, nst, xlo, blo and flags are the staged
// builds' (ssd_scan_staged.cu): here xp = P, nst = N, mode 0 (FAST).
CS_EXPORT int cs_ssd_scan(const void* x, const float* log_a, const void* b,
                          const void* c, const float* init, void* y, float* st, float* cst,
                          float* ypart,
                          int B, int L, int H, int P, int G, int N, int Q,
                          long long sxb, long long sxl, long long sab,
                          long long sal, long long sbb, long long sbl, int xp, int nst,
                          long long xlo, long long blo, int flags, int mode,
                          cudaStream_t stream) {
  if (bad_geometry(Q, G, H, P) || !is_build(N) || P % 8 != 0 || mode != FAST || nst != N ||
      (N > N_SLAB && ypart == nullptr))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, P, N, 0, 0, flags};
  return launch_n<FAST>(N, x, log_a, b, c, init, y, st, cst, ypart, a, stream);
}

// The backward, on the forward's operands (same layouts and limits) and
// states: (B, H, nc, P, N) f32 as cs_ssd_scan writes them; dy: (B, L, H,
// P) bf16 contiguous; dfin: (B, H, P, N) f32 or null (zeros).  Writes
// dx (B, L, H, P) bf16, dla (B, L, H) f32 (bf16 with OUT_LA_BF16), db and
// dc (B, L, G, N) bf16 and, unless null, dinit (B, H, P, N) f32.  part:
// f32 scratch of B H nc P N + B H nc (rounded up to 4) + 2 B L (H / hb)
// nps N elements, hb the heads per block (2 where H / G is even, else 1),
// nps = ceil(P / 64), and past N 128 B L H NS P more (dX's partials, NS =
// N / 128); lpart: B L H nps NS f32 scratch (NS 1 up to N 128) when nps
// NS > 1 or dla is bf16, else unused (may be null).
CS_EXPORT int cs_ssd_scan_bwd(const void* x, const float* log_a, const void* b,
                              const void* c, const float* states, const void* dy,
                              const float* dfin, void* dx, void* dla, void* db, void* dc,
                              float* dinit, float* part, float* lpart, int B, int L, int H,
                              int P, int G, int N, int Q, long long sxb, long long sxl,
                              long long sab, long long sal, long long sbb, long long sbl,
                              int xp, int nst, long long xlo, long long blo, int flags, int mode,
                              cudaStream_t stream) {
  if (bad_geometry(Q, G, H, P) || !is_build(N) || P % 8 != 0 || mode != FAST || nst != N ||
      (flags & (OUT_F32 | OUT_BC_F32 | OUT_F16 | OUT_BC_F16)))
    return (int)cudaErrorInvalidValue;
  const ScanArgs a{B, L, H, P, G, Q, sxb, sxl, sab, sal, sbb, sbl, P, N, 0, 0, flags};
  return launch_bwd_n<FAST>(N, x, log_a, b, c, states, dy, dfin, dx, dla, db, dc, dinit, part,
                            lpart, a, stream);
}

// blocks per SM of the backward's kernels (a), (b) and (c) for state
// width N at chunk Q, into blocks[0..2]
CS_EXPORT int cs_ssd_scan_bwd_occupancy(int N, int Q, int* blocks) {
  if (Q < 1 || Q > NT || !is_build(N)) return (int)cudaErrorInvalidValue;
  return bwd_occupancy_n<FAST>(N, Q, blocks);
}
