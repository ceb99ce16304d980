// The prefill kernels (dense, paged, paged with int8 cold pages) over f16
// K/V and a bf16 or f32 query, at every head dim: the ragged builds to 256,
// the SLAB build of width 512 (128-column slabs of V and O, 16-key steps)
// and past 512 the DEEP build (attention.cuh, OPS_Q16).  Their oracle keeps
// the query exact in f32 and the products are f16, so the query enters
// them as two f16 halves, hi + lo, as OPS_Q32's f32 query enters bf16
// products; f16's range would lose a bf16 or f32 value past 65504 or below
// its normals, so each query row is first scaled by the power of two that
// puts its largest |q| in [2^14, 2^15), and the factor comes back exactly
// in S's exponent factor (the DEEP build's pre-pass writes the rows and
// their factors).  The output is in q's type.  The refresh and packed
// kernels round q x scale to f16 as their oracle rounds it to K's type, so
// they take such a query on the f16 builds (attention_f16*.cu).
#include "attention.cuh"

CS_ATTN_Q16_EXPORTS(, Any<OPS_Q16>)
CS_ATTN_Q16_EXPORTS(_512, Any512<OPS_Q16>)
CS_ATTN_Q16_DEEP_EXPORTS(_deep)
