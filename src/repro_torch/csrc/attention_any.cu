// The attention kernels over bf16 q, k and v at every head dim d from 1 to
// 256 that is not one of the exact builds' (24, 32, 64, 128, 256:
// attention.cu; 257 to 512: attention_512.cu), each on the smallest ragged
// build that holds it: d up to 23 on D 24, d 25 to 63 on D 64, d 65 to 127
// on D 128, d 129 to 255 on the WIDE D 256 (the padded products cost up to
// D / d more: 1.6x at d 80, 1.9x at d 136).  Rows that are not 16-byte
// aligned (d not a multiple of 8) are copied in 8- or 4-byte chunks, or
// element by element at an odd d (attention.cuh, narrow_rows).  The body,
// its numerics and the TPU kernels each entry point replaces:
// attention.cuh.
#include "attention.cuh"

CS_ATTN_EXPORTS(_any, Any<OPS_BF16>)
