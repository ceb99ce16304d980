// The attention kernels over f32 or f16 queries and bf16 K/V (an f32 LM's
// queries over its bf16 caches and slab), any head dim d up to 256 (past
// 256: attention_q32_512.cu), each on the smallest ragged build that holds
// it (24, 32, 64, 128, or the WIDE 256: attention.cuh); the output is in
// q's type (a launch argument).  The refresh and packed kernels round q x
// scale and P to bf16 as their oracle does, so their products are the bf16
// kernels'; the prefill kernels keep the query exact as two bf16 halves
// (hi K + lo K; an f16 value is exactly its two).  The body
// and the TPU kernels each entry point replaces: attention.cuh.
#include "attention.cuh"

CS_ATTN_EXPORTS(_q32, Any<OPS_Q32>)
