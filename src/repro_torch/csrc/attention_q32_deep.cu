// The attention kernels over f32 or f16 queries and bf16 K/V at every head
// dim past 512, on the DEEP build (attention.cuh, "The DEEP body": Q K^T
// over depth chunks of 256 columns, 128-column slabs of V and O over
// blocks); the output is in q's type.  The pre-pass rounds q x scale to bf16 as the
// refresh oracle does, or in the prefill kernels splits the unscaled
// query into its two bf16 halves (hi K + lo K, as attention_q32.cu).
#include "attention.cuh"

CS_ATTN_DEEP_EXPORTS(_q32_deep, OPS_Q32)
