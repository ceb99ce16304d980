// The attention kernels over f16 K/V and an f16 query (the refresh and
// packed kernels: any query type; the output in q's type) at head dims 257
// to 512 on the ragged SLAB build of width 512 (two 256-column slabs of V
// and O over blocks, 16-key steps: attention.cuh, "The SLAB body").  No
// exact f16 build at d 512: the ragged one takes it too.
// The numerics are attention_f16.cu's.
#include "attention.cuh"

CS_ATTN_F16_EXPORTS(_512, Any512<OPS_F16>)
