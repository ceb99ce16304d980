// rope_shift: Eq. 5 position correction of reused keys, K' = R(delta) K.
//
// Replaces the TPU kernel repro/kernels/rope_shift.py:rope_shift_pallas.
// One thread per (token, kv head, rotation pair): it reads the pair
// (k[i], k[i + half]), builds the angle delta * theta^(-i/half) in f32
// exactly as the plain version does, and writes the rotated pair in the
// key's dtype.  The angles reach hundreds of radians on the serving
// path (delta = -shift_tokens), so the accurate sincosf/powf are used:
// the fast intrinsics lose all accuracy at that size.  Built without
// --use_fast_math for the same reason.
//
// Bound on an H100: bytes.  One read and one write of the key block;
// the trigonometry is recomputed per head, which costs arithmetic the
// memory time hides.
#include "common.cuh"

template <typename T>
__global__ void rope_shift_kernel(const T* __restrict__ k,
                                  const int* __restrict__ delta,
                                  T* __restrict__ out, long long n_tok,
                                  int n_kv, int d_h, float theta) {
  const int half = d_h / 2;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_tok * n_kv * half) return;
  const int p = (int)(i % half);
  const long long row = i / half;        // token * n_kv + head
  const long long tok = row / n_kv;
  const float freq = 1.0f / powf(theta, (float)p / (float)half);
  const float ang = (float)delta[tok] * freq;
  float s, c;
  sincosf(ang, &s, &c);
  const T* kr = k + row * d_h;
  T* o = out + row * d_h;
  const float k1 = cs_to_float(kr[p]), k2 = cs_to_float(kr[p + half]);
  o[p] = cs_from_float<T>(k1 * c - k2 * s);
  o[p + half] = cs_from_float<T>(k2 * c + k1 * s);
}

// k, out: (n_tok, n_kv, d_h) contiguous; delta: (n_tok,) i32.
// dtype: 0 = float32, 1 = bfloat16.
CS_EXPORT int cs_rope_shift(const void* k, const int* delta, void* out,
                            long long n_tok, int n_kv, int d_h, float theta,
                            int dtype, cudaStream_t stream) {
  const long long n = n_tok * n_kv * (d_h / 2);
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (n == 0) return 0;
  if (dtype == 0) {
    rope_shift_kernel<float><<<blocks, threads, 0, stream>>>(
        (const float*)k, delta, (float*)out, n_tok, n_kv, d_h, theta);
  } else if (dtype == 1) {
    rope_shift_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        (const __nv_bfloat16*)k, delta, (__nv_bfloat16*)out, n_tok, n_kv, d_h, theta);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
