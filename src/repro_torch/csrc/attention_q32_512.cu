// The attention kernels over f32 or f16 queries and bf16 K/V (an f32 LM's
// queries over its bf16 caches and slab) at head dims 257 to 512, on the
// ragged SLAB build of width 512 (four 128-column slabs of V and O over
// blocks, 16-key steps: attention.cuh, "The SLAB body"); the output is in
// q's type.  The
// numerics are attention_q32.cu's.
#include "attention.cuh"

CS_ATTN_EXPORTS(_q32_512, Any512<OPS_Q32>)
