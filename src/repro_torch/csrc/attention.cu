// The attention kernels at the exact head dims 24, 32, 64, 128 and 256
// over bf16 q, k and v: d == D.  The first four compile to the code
// before the ragged and f32 builds existed (and before the ragged builds
// took head dims off the 8-column grid); 256 is the WIDE build (4
// warps own 64 query rows in 32-key steps, attention.cuh).  The body and
// the TPU kernels each entry point replaces: attention.cuh.  Other head dims:
// attention_any.cu, and 257 to 512 attention_512.cu; f32 queries:
// attention_q32.cu (past 256 attention_q32_512.cu); f32 q/k/v:
// attention_f32.cu (each source compiles in its own nvcc process).
#include "attention.cuh"

CS_ATTN_EXPORTS(, Exact)
