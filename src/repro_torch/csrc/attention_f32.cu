// flash_packed and flash_prefill over f32 q, k and v (a ViT from an f32
// checkpoint; the dense prefill of an f32 model), any head dim d that is
// a multiple of 8 up to 256 (the WIDE D-256 build runs two stages of
// four arrays, 203 KB), f32 output.  Their oracles round nothing, so
// every operand enters the tensor-core products as two bf16 halves, hi =
// bf16(x) and lo = bf16(x - hi), about 16 bits: split_bf16_kernel writes
// K's and V's halves into the caller's scratch (four bf16 arrays of k's
// size: the bytes of the f32 K and V read once and written once), then
// the body (attention.cuh, OPS_F32) fills its ring from them by cp.async
// as for bf16 and sums three products a tile where bf16 takes one.  The
// query is split as it is staged.  A pre-pass, not a split on staging,
// because a K/V tile is staged once per query tile that visits it, and
// cp.async cannot convert.
#include "attention.cuh"

namespace {

// x (n f32, n a multiple of 4, 16-byte aligned) -> hi = bf16(x), lo =
// bf16(x - hi)
__global__ void split_bf16_kernel(const float4* __restrict__ x, uint2* __restrict__ hi,
                                  uint2* __restrict__ lo, long long n4) {
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

// k, v (n f32 each) -> scratch: k_hi, k_lo, v_hi, v_lo (n bf16 each)
int split_kv(const void* k, const void* v, bf16* scratch, long long n, cudaStream_t stream) {
  const long long n4 = n / 4, want = (n4 + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);   // grid-stride past 8 a SM
  if (blocks == 0) return 0;
  const void* src[2] = {k, v};
  for (int i = 0; i < 2; ++i) {
    bf16* hi = scratch + 2 * i * n;
    split_bf16_kernel<<<blocks, 256, 0, stream>>>(
        (const float4*)src[i], (uint2*)hi, (uint2*)(hi + n), n4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// As cs_attn_packed_bf16 over f32 q, k, v (out f32); scratch: 4 x R x L x
// Hkv x D bf16, 16-byte aligned.
CS_EXPORT int cs_attn_packed_f32(const void* q, const void* k, const void* v, void* out,
                                 const int* span, const int* tile_ids, const int* tile_count,
                                 int R, int L, int H, int Hkv, int D, int t_max, float scale,
                                 void* scratch, cudaStream_t stream) {
  const long long n = (long long)R * L * Hkv * D;
  bf16* s = (bf16*)scratch;
  const int err = split_kv(k, v, s, n, stream);
  if (err != 0) return err;
  Packed prob{span, tile_ids, tile_count, L, L / TILE, t_max};
  return Any<OPS_F32>()(D, q, s, s + 2 * n, out, R, L, H, Hkv, scale, prob, stream, s + n,
                        s + 3 * n);
}

// As cs_attn_prefill_bf16 over f32 q, k, v (out f32); scratch: 4 x B x
// Sk x Hkv x D bf16, 16-byte aligned.
CS_EXPORT int cs_attn_prefill_f32(const void* q, const void* k, const void* v, void* out,
                                  int B, int Sq, int Sk, int H, int Hkv, int D, int q_offset,
                                  int causal, int window, float scale, void* scratch,
                                  cudaStream_t stream) {
  const long long n = (long long)B * Sk * Hkv * D;
  bf16* s = (bf16*)scratch;
  const int err = split_kv(k, v, s, n, stream);
  if (err != 0) return err;
  Prefill prob{{Sq, Sk, q_offset, causal, window, (Sk + TILE - 1) / TILE}};
  return Any<OPS_F32>()(D, q, s, s + 2 * n, out, B, Sq, H, Hkv, scale, prob, stream, s + n,
                        s + 3 * n);
}
