// The attention kernels at the head dims they were first built for (24,
// 32, 64 and 128) over bf16 q, k and v: exact builds, d == D, the code
// before the ragged and f32 builds existed.  The body and the TPU kernels
// each entry point replaces: attention.cuh.  Other head dims:
// attention_any.cu; f32 queries: attention_q32.cu; f32 q/k/v:
// attention_f32.cu (each source compiles in its own nvcc process).
#include "attention.cuh"

CS_ATTN_EXPORTS(, Exact)
