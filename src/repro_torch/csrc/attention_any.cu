// The attention kernels over bf16 q, k and v at every head dim d that is
// a multiple of 8 up to 256 and not one of the exact builds' (24, 32, 64,
// 128, 256: attention.cu), each on the smallest ragged build that holds
// it: d 8 and 16 on D 24, d 40 to 56 on D 64, d 72 to 120 on D 128, d 136
// to 248 on the WIDE D 256 (the padded products cost up to D / d more:
// 1.6x at d 80, 1.9x at d 136).  The body, its numerics
// and the TPU kernels each entry point replaces: attention.cuh.
#include "attention.cuh"

CS_ATTN_EXPORTS(_any, Any<OPS_BF16>)
