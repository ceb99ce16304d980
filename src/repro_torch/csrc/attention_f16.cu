// The attention kernels over f16 K/V and an f16 query (the refresh and
// packed kernels: also a bf16 or f32 one; the output in q's type) at every
// head dim d from 1 to 256, each on the smallest ragged build that holds it (24,
// 32, 64, 128, or the WIDE 256: attention.cuh), rows copied 16, 8 or 4
// bytes at a time, or element by element at an odd d.  The body is the
// bf16 one with f16 for bf16 (OPS_F16): the products on mma.sync
// m16n8k16 f16 -> f32, q x scale and P rounded to f16 as the refresh
// oracle rounds them to K's and V's type, P split into two f16 halves in
// the prefill kernels, an int8 cold page dequantised in f32 and rounded to
// f16 (the hot slab's type).  Ragged builds alone: at multiples of 8 they
// take 1-8 % more device time than the bf16 exact ones at D 128 on an
// H100, and nvcc compiles fewer.  257 to 512: attention_f16_512.cu; past
// 512: attention_f16_deep.cu.
#include "attention.cuh"

CS_ATTN_F16_EXPORTS(, Any<OPS_F16>)
