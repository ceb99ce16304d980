// The attention kernels over bf16 q, k and v at head dims 257 to 512: the
// exact SLAB build at d 512 and the ragged one (every d from 257 to 511,
// rows copied 16, 8 or 4 bytes at a time, or element by element at an
// odd d) on width 512.  Each block runs the D-256 body's shape (4 warps,
// 64 query rows, 32-key steps) on one of two 256-column slabs of V and O,
// the slab a grid dimension, recomputing the whole head's Q K^T and
// softmax per slab (attention.cuh, "The SLAB body").  Its own source so
// that nvcc compiles it beside the narrower builds.  f32 queries:
// attention_q32_512.cu; f32 q/k/v: attention_f32.cu.
#include "attention.cuh"

CS_ATTN_EXPORTS(_512, Any512<OPS_BF16>)
