// rope_shift: Eq. 5 position correction of reused keys, K' = R(delta) K.
//
// Replaces the TPU kernel repro/kernels/rope_shift.py:rope_shift_pallas.
// Bound on an H100: bytes, one read and one write of the key block; the
// angle of a (token, rotation pair) is the same for every kv head.
//
// A thread owns one token and one chunk of CH rotation pairs: W bytes of
// each half of a head, the widest of 16, 8, 4 (and 2 in bf16 and f16) that
// half the head dim holds a whole number of, so every chunk is aligned (8
// bf16 or f16 or 4 f32 pairs at 16 bytes; 4 bf16, 8 bytes, at D 24; one
// pair, 2 bytes in bf16 or f16 or 4 in f32, at an odd half, as at D 90).  It builds the
// chunk's CH angles delta * freq[p] once in f32, from the plain version's
// own inverse frequencies theta^(-p/half), which the wrapper hands over (a
// powf here differed from them by an ulp at some head dims, as at D 320:
// 1e-4 rad at |delta| 2000), then walks the token's n_kv heads: per head one
// load of k[p, p + CH), one of k[p + half, p + half + CH), and two stores
// of the rotated pairs in the key's dtype.  The block is (chunks per
// token, tokens): the token comes from the grid and the chunk from
// threadIdx.x (stepping by blockDim.x past 256 chunks: an odd half of
// more than 256 pairs), so no index is divided, and neighbouring threads
// touch neighbouring words.  The angles reach hundreds of radians on the
// serving path (delta = -shift_tokens), so the accurate sincosf is
// used: the fast intrinsics lose all accuracy at that size.  Built
// without --use_fast_math for the same reason.
#include "common.cuh"

namespace {

// the chunk's word of W bytes
template <int W> struct Word;
template <> struct Word<16> { using T = uint4; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<4> { using T = uint32_t; };
template <> struct Word<2> { using T = uint16_t; };

// W: the chunk's bytes of each half (see above)
template <typename T, int W>
__global__ void __launch_bounds__(256)
rope_shift_kernel(const T* __restrict__ k, const int* __restrict__ delta,
                  T* __restrict__ out, long long n_tok, int n_kv, int d_h,
                  const float* __restrict__ inv_freq) {
  using Vec = typename Word<W>::T;
  constexpr int CH = W / sizeof(T);    // pairs per chunk
  const long long tok = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (tok >= n_tok) return;
  const int half = d_h / 2;
  const float dt = (float)delta[tok];
  for (int p0 = threadIdx.x * CH; p0 < half; p0 += blockDim.x * CH) {
    float c[CH], s[CH];
    #pragma unroll
    for (int e = 0; e < CH; ++e) {
      sincosf(dt * inv_freq[p0 + e], &s[e], &c[e]);
    }
    const T* kr = k + tok * n_kv * d_h + p0;
    T* o = out + tok * n_kv * d_h + p0;
    #pragma unroll 4
    for (int h = 0; h < n_kv; ++h) {
      const Vec r1 = *reinterpret_cast<const Vec*>(kr + h * d_h);
      const Vec r2 = *reinterpret_cast<const Vec*>(kr + h * d_h + half);
      const T* e1 = reinterpret_cast<const T*>(&r1);
      const T* e2 = reinterpret_cast<const T*>(&r2);
      __align__(W) T w1[CH], w2[CH];
      #pragma unroll
      for (int e = 0; e < CH; ++e) {
        const float k1 = cs_to_float(e1[e]), k2 = cs_to_float(e2[e]);
        w1[e] = cs_from_float<T>(k1 * c[e] - k2 * s[e]);
        w2[e] = cs_from_float<T>(k2 * c[e] + k1 * s[e]);
      }
      *reinterpret_cast<Vec*>(o + h * d_h) = *reinterpret_cast<const Vec*>(w1);
      *reinterpret_cast<Vec*>(o + h * d_h + half) = *reinterpret_cast<const Vec*>(w2);
    }
  }
}

template <typename T, int W>
int launch(const void* k, const int* delta, void* out, long long n_tok, int n_kv, int d_h,
           const float* inv_freq, cudaStream_t stream) {
  constexpr int CH = W / sizeof(T);
  if (d_h % (2 * CH) != 0) return (int)cudaErrorInvalidValue;
  const int chunks = d_h / (2 * CH) < 256 ? d_h / (2 * CH) : 256;
  const dim3 block(chunks, 256 / chunks);
  const long long blocks = (n_tok + block.y - 1) / block.y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rope_shift_kernel<T, W><<<(unsigned)blocks, block, 0, stream>>>(
      (const T*)k, delta, (T*)out, n_tok, n_kv, d_h, inv_freq);
  return (int)cudaGetLastError();
}

}  // namespace

// k, out: (n_tok, n_kv, d_h) contiguous, 16-byte aligned, d_h even;
// delta: (n_tok,) i32; inv_freq: (d_h / 2,) f32, theta^(-p / (d_h / 2)).
// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (chunks as above: 16 bytes
// where half is a multiple of 8 bf16 or f16 or 4 f32 pairs).  The rotation
// runs in f32 and is rounded once to the key's dtype.
CS_EXPORT int cs_rope_shift(const void* k, const int* delta, void* out,
                            long long n_tok, int n_kv, int d_h, const float* inv_freq,
                            int dtype, cudaStream_t stream) {
  if (n_tok * n_kv == 0) return 0;
  if (d_h < 2 || d_h % 2 != 0) return (int)cudaErrorInvalidValue;
  const int half = d_h / 2;
#define CS_ROPE(T, W) launch<T, W>(k, delta, out, n_tok, n_kv, d_h, inv_freq, stream)
  if (dtype == 0)
    return half % 4 == 0 ? CS_ROPE(float, 16) : half % 2 == 0 ? CS_ROPE(float, 8)
                                                               : CS_ROPE(float, 4);
  if (dtype == 1)
    return half % 8 == 0   ? CS_ROPE(__nv_bfloat16, 16)
           : half % 4 == 0 ? CS_ROPE(__nv_bfloat16, 8)
           : half % 2 == 0 ? CS_ROPE(__nv_bfloat16, 4)
                           : CS_ROPE(__nv_bfloat16, 2);
  if (dtype == 2)
    return half % 8 == 0   ? CS_ROPE(__half, 16)
           : half % 4 == 0 ? CS_ROPE(__half, 8)
           : half % 2 == 0 ? CS_ROPE(__half, 4)
                           : CS_ROPE(__half, 2);
#undef CS_ROPE
  return (int)cudaErrorInvalidValue;
}
