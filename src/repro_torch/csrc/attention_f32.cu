// flash_packed and flash_prefill over f32 K and V and a bf16, f16 or f32
// query (a ViT from an f32 checkpoint; the dense prefill of an f32 model),
// any head dim d (the WIDE D-256 build runs two stages of four arrays, 203
// KB; 257 to 512 the SLAB build of width 512, two warps over 32 query rows
// in 16-key steps, 167 KB; past 512 the DEEP build, the same shape over
// depth chunks of 256 columns, 135 KB), the output in q's type.  Their
// oracles round nothing before the output, so every operand enters the
// tensor-core products as two bf16 halves, hi = bf16(x) and lo = bf16(x -
// hi), about 16 bits: split_bf16_kernel writes K's and V's halves into the
// caller's scratch (four bf16 arrays of k's size: the bytes of the f32 K
// and V read once and written once), then the body (attention.cuh,
// OPS_F32) fills its ring from them by cp.async as for bf16 and sums three
// products a tile where bf16 takes one.  Each of the four arrays starts on
// a 16-byte boundary (its size rounded up to 8 elements), so a row of any d
// sits at the alignment its d gives it.  The query, read in its own type,
// is split as it is staged (past 512 by the DEEP build's pre-pass, into two
// more arrays after the four: B x Sq x H rows of d rounded up to 16; a
// bf16 query's low half is zero, an f16 one's holds the rest exactly).  A
// pre-pass, not a split on staging, because a K/V tile is staged once per
// query tile that visits it, and cp.async cannot convert.
#include "attention.cuh"

namespace {

// x (n f32, 16-byte aligned) -> hi = bf16(x), lo = bf16(x - hi), four
// at a time and the last n % 4 one by one
__global__ void split_bf16_kernel(const float4* __restrict__ x, uint2* __restrict__ hi,
                                  uint2* __restrict__ lo, long long n) {
  const long long n4 = n / 4;
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const long long j = n4 * 4 + threadIdx.x;
    const float a = reinterpret_cast<const float*>(x)[j];
    const bf16 h = __float2bfloat16_rn(a);
    reinterpret_cast<bf16*>(hi)[j] = h;
    reinterpret_cast<bf16*>(lo)[j] = __float2bfloat16_rn(a - __bfloat162float(h));
  }
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const float4 a = x[i];
    const __nv_bfloat162 h0 = __floats2bfloat162_rn(a.x, a.y);
    const __nv_bfloat162 h1 = __floats2bfloat162_rn(a.z, a.w);
    const float2 f0 = __bfloat1622float2(h0), f1 = __bfloat1622float2(h1);
    const __nv_bfloat162 l0 = __floats2bfloat162_rn(a.x - f0.x, a.y - f0.y);
    const __nv_bfloat162 l1 = __floats2bfloat162_rn(a.z - f1.x, a.w - f1.y);
    hi[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&h0),
                       *reinterpret_cast<const uint32_t*>(&h1));
    lo[i] = make_uint2(*reinterpret_cast<const uint32_t*>(&l0),
                       *reinterpret_cast<const uint32_t*>(&l1));
  }
}

// the elements of one of the scratch's four arrays: n rounded up to 8
long long padded(long long n) { return (n + 7) / 8 * 8; }

// k, v (n f32 each) -> scratch: k_hi, k_lo, v_hi, v_lo (n bf16 each, at
// strides of padded(n))
int split_kv(const void* k, const void* v, bf16* scratch, long long n, cudaStream_t stream) {
  const long long want = (n / 4 + 255) / 256;
  const int blocks = (int)(want < 1 ? 1 : want < 132 * 8 ? want : 132 * 8);   // grid-stride past 8 a SM
  if (n == 0) return 0;
  const void* src[2] = {k, v};
  const long long np = padded(n);
  for (int i = 0; i < 2; ++i) {
    bf16* hi = scratch + 2 * i * np;
    split_bf16_kernel<<<blocks, 256, 0, stream>>>(
        (const float4*)src[i], (uint2*)hi, (uint2*)(hi + np), n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// As cs_attn_packed_bf16 over f32 k, v and a q of type qt (bf16, f16 or
// f32; out in q's type); scratch: 4 arrays of
// R x L x Hkv x D bf16 each rounded up to 8 elements, 16-byte aligned (D
// past 512: and 2 arrays of R x L x H rows of D rounded up to 16).
CS_EXPORT int cs_attn_packed_f32(const void* q, const void* k, const void* v, void* out,
                                 const int* span, const int* tile_ids, const int* tile_count,
                                 int R, int L, int H, int Hkv, int D, int t_max, float scale,
                                 int qt, void* scratch, cudaStream_t stream) {
  const long long n = (long long)R * L * Hkv * D, np = padded(n);
  bf16* s = (bf16*)scratch;
  const int err = split_kv(k, v, s, n, stream);
  if (err != 0) return err;
  Packed prob{span, tile_ids, tile_count, L, L / TILE, t_max};
  if (D > 512)
    return Deep<OPS_F32>{s + 4 * np}(D, q, s, s + 2 * np, out, R, L, H, Hkv, scale, qt, prob, stream,
                                    s + np, s + 3 * np);
  if (D > 256)
    return Any512<OPS_F32>()(D, q, s, s + 2 * np, out, R, L, H, Hkv, scale, qt, prob, stream,
                             s + np, s + 3 * np);
  return Any<OPS_F32>()(D, q, s, s + 2 * np, out, R, L, H, Hkv, scale, qt, prob, stream, s + np,
                        s + 3 * np);
}

// As cs_attn_prefill_bf16 over f32 k, v and a q of type qt (out in q's
// type); scratch: 4 arrays
// of B x Sk x Hkv x D bf16 each rounded up to 8 elements, 16-byte aligned
// (D past 512: and 2 arrays of B x Sq x H rows of D rounded up to 16).
CS_EXPORT int cs_attn_prefill_f32(const void* q, const void* k, const void* v, void* out,
                                  int B, int Sq, int Sk, int H, int Hkv, int D, int q_offset,
                                  int causal, int window, float scale, int qt,
                                  void* scratch, cudaStream_t stream) {
  const long long n = (long long)B * Sk * Hkv * D, np = padded(n);
  bf16* s = (bf16*)scratch;
  const int err = split_kv(k, v, s, n, stream);
  if (err != 0) return err;
  Prefill prob{{Sq, Sk, q_offset, causal, window, (Sk + TILE - 1) / TILE}};
  if (D > 512)
    return Deep<OPS_F32>{s + 4 * np}(D, q, s, s + 2 * np, out, B, Sq, H, Hkv, scale, qt, prob, stream,
                                    s + np, s + 3 * np);
  if (D > 256)
    return Any512<OPS_F32>()(D, q, s, s + 2 * np, out, B, Sq, H, Hkv, scale, qt, prob, stream,
                             s + np, s + 3 * np);
  return Any<OPS_F32>()(D, q, s, s + 2 * np, out, B, Sq, H, Hkv, scale, qt, prob, stream, s + np,
                        s + 3 * np);
}
