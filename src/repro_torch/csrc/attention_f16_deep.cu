// The attention kernels over f16 K/V and an f16 query (the refresh and
// packed kernels: any query type; the output in q's type) at every head dim
// past 512, on the DEEP build (attention.cuh, "The DEEP body": Q K^T over
// depth chunks of 256 columns, 256-column slabs of V and O in the refresh
// and packed kernels, 128 in the prefill ones).  The pre-pass rounds q x
// scale to f16 as the refresh oracle rounds it to K's type (the prefill
// kernels' query unscaled) into the caller's scratch.  The numerics are
// attention_f16.cu's.
#include "attention.cuh"

CS_ATTN_F16_DEEP_EXPORTS(_deep)
