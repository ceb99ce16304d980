// rope_shift: Eq. 5 position correction of reused keys, K' = R(delta) K.
//
// Replaces the TPU kernel repro/kernels/rope_shift.py:rope_shift_pallas.
// Bound on an H100: bytes, one read and one write of the key block; the
// angle of a (token, rotation pair) is the same for every kv head.
//
// A thread owns one token and one chunk of CH rotation pairs (8 for bf16,
// 4 for f32: 16 bytes of each half of a head).  It builds the chunk's CH
// angles delta * theta^(-p/half) once, in f32 exactly as the plain version
// does, then walks the token's n_kv heads: per head one 16-byte load of
// k[p, p + CH), one of k[p + half, p + half + CH), and two 16-byte stores
// of the rotated pairs in the key's dtype.  The block is (chunks per
// token, tokens): the token comes from the grid and the chunk from
// threadIdx.x, so no index is divided, and neighbouring threads touch
// neighbouring 16-byte words.  The angles reach hundreds of radians on
// the serving path (delta = -shift_tokens), so the accurate sincosf/powf
// are used: the fast intrinsics lose all accuracy at that size.  Built
// without --use_fast_math for the same reason.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
rope_shift_kernel(const T* __restrict__ k, const int* __restrict__ delta,
                  T* __restrict__ out, long long n_tok, int n_kv, int d_h, float theta) {
  constexpr int CH = 16 / sizeof(T);   // pairs per chunk: 16 bytes of each half
  const long long tok = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  if (tok >= n_tok) return;
  const int half = d_h / 2;
  const int p0 = threadIdx.x * CH;
  const float dt = (float)delta[tok];
  float c[CH], s[CH];
  #pragma unroll
  for (int e = 0; e < CH; ++e) {
    const float freq = 1.0f / powf(theta, (float)(p0 + e) / (float)half);
    sincosf(dt * freq, &s[e], &c[e]);
  }
  const T* kr = k + tok * n_kv * d_h + p0;
  T* o = out + tok * n_kv * d_h + p0;
  #pragma unroll 4
  for (int h = 0; h < n_kv; ++h) {
    const uint4 r1 = *reinterpret_cast<const uint4*>(kr + h * d_h);
    const uint4 r2 = *reinterpret_cast<const uint4*>(kr + h * d_h + half);
    const T* e1 = reinterpret_cast<const T*>(&r1);
    const T* e2 = reinterpret_cast<const T*>(&r2);
    __align__(16) T w1[CH], w2[CH];
    #pragma unroll
    for (int e = 0; e < CH; ++e) {
      const float k1 = cs_to_float(e1[e]), k2 = cs_to_float(e2[e]);
      w1[e] = cs_from_float<T>(k1 * c[e] - k2 * s[e]);
      w2[e] = cs_from_float<T>(k2 * c[e] + k1 * s[e]);
    }
    *reinterpret_cast<uint4*>(o + h * d_h) = *reinterpret_cast<const uint4*>(w1);
    *reinterpret_cast<uint4*>(o + h * d_h + half) = *reinterpret_cast<const uint4*>(w2);
  }
}

template <typename T>
int launch(const void* k, const int* delta, void* out, long long n_tok, int n_kv, int d_h,
           float theta, cudaStream_t stream) {
  constexpr int CH = 16 / sizeof(T);
  if (d_h % (2 * CH) != 0 || d_h / (2 * CH) > 256) return (int)cudaErrorInvalidValue;
  const int chunks = d_h / (2 * CH);
  const dim3 block(chunks, 256 / chunks);
  const long long blocks = (n_tok + block.y - 1) / block.y;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rope_shift_kernel<T><<<(unsigned)blocks, block, 0, stream>>>(
      (const T*)k, delta, (T*)out, n_tok, n_kv, d_h, theta);
  return (int)cudaGetLastError();
}

}  // namespace

// k, out: (n_tok, n_kv, d_h) contiguous, 16-byte aligned, d_h a multiple
// of 16 (bf16) or 8 (f32); delta: (n_tok,) i32.  dtype: 0 = float32,
// 1 = bfloat16.
CS_EXPORT int cs_rope_shift(const void* k, const int* delta, void* out,
                            long long n_tok, int n_kv, int d_h, float theta,
                            int dtype, cudaStream_t stream) {
  if (n_tok * n_kv == 0) return 0;
  if (dtype == 0) return launch<float>(k, delta, out, n_tok, n_kv, d_h, theta, stream);
  if (dtype == 1) return launch<__nv_bfloat16>(k, delta, out, n_tok, n_kv, d_h, theta, stream);
  return (int)cudaErrorInvalidValue;
}
