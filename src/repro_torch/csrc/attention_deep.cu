// The attention kernels over bf16 q, k and v at every head dim past 512
// (520, 1000, 1023, 1024, 4096, ...): the DEEP build (attention.cuh, "The
// DEEP body").  Q K^T is summed over depth chunks of 256 columns, the
// chunk count a runtime argument, so one build takes every width; each
// block owns one 256-column slab of V and O (ceil(d / 256) slabs, the slab
// a grid dimension) and recomputes the whole head's Q K^T and softmax.  A
// pre-pass writes q x scale rounded to bf16 (the refresh oracle's query;
// the prefill kernels' unscaled) in rows zero-padded to a multiple of 16
// into the caller's scratch, which the body streams a chunk at a time.
// Its own source so that nvcc compiles it beside the other builds.  f32
// queries: attention_q32_deep.cu; f32 q/k/v: attention_f32.cu.
#include "attention.cuh"

CS_ATTN_DEEP_EXPORTS(_deep, OPS_BF16)
