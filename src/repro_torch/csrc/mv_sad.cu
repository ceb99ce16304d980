// mv_sad: full-search block matching for the codec ingest stage.
//
// Replaces the TPU kernel repro/kernels/mv_sad.py:mv_sad_pallas.  One
// thread block per macroblock, one thread per pixel of it.  The block
// stages its (block + 2r)^2 reference band in shared memory with clamped
// indices (the edge padding of the reference, without a padded copy),
// then walks the (2r+1)^2 candidates in dy-major order: each warp sums
// its pixels' |cur - ref| with shuffles and parks the partial sum; one
// thread adds the partials and keeps the best candidate under a strict
// '<', so the first minimum wins as in the plain version.
//
// Bound on an H100: bytes.  Each frame pair is read once (2 x H x W x 4
// bytes) and 81 candidates cost 3 flops a pixel, about 243 flops per
// 8 bytes: far below the card's ratio, and a 448^2 frame is only 784
// blocks, so the launch itself dominates.  The design keeps every
// reread in shared memory and makes one pass over device memory.
#include "common.cuh"

__global__ void mv_sad_kernel(const float* __restrict__ cur,
                              const float* __restrict__ prev, int H, int W,
                              int block, int radius, int* __restrict__ mv,
                              float* __restrict__ sad) {
  extern __shared__ float smem[];
  const int band = block + 2 * radius;
  const int n_cand = 2 * radius + 1;
  const int n_warps = blockDim.x >> 5;
  float* ref = smem;                    // band * band
  float* part = smem + band * band;     // n_cand^2 * n_warps
  const int bx = blockIdx.x, by = blockIdx.y;
  const int tid = threadIdx.x;
  const int ty = tid / block, tx = tid % block;
  const int y0 = by * block - radius, x0 = bx * block - radius;
  for (int i = tid; i < band * band; i += blockDim.x) {
    const int yy = min(max(y0 + i / band, 0), H - 1);
    const int xx = min(max(x0 + i % band, 0), W - 1);
    ref[i] = prev[(size_t)yy * W + xx];
  }
  const float c = cur[(size_t)(by * block + ty) * W + bx * block + tx];
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  for (int idx = 0; idx < n_cand * n_cand; ++idx) {
    const int dy = idx / n_cand, dx = idx % n_cand;
    float d = fabsf(c - ref[(ty + dy) * band + tx + dx]);
    for (int o = 16; o > 0; o >>= 1) d += __shfl_down_sync(0xffffffffu, d, o);
    if (lane == 0) part[idx * n_warps + warp] = d;
  }
  __syncthreads();
  if (tid == 0) {
    float best = __int_as_float(0x7f800000);  // +inf
    int best_idx = 0;
    for (int idx = 0; idx < n_cand * n_cand; ++idx) {
      float s = 0.f;
      for (int w = 0; w < n_warps; ++w) s += part[idx * n_warps + w];
      if (s < best) {
        best = s;
        best_idx = idx;
      }
    }
    const int o = by * (W / block) + bx;
    mv[2 * o] = best_idx / n_cand - radius;
    mv[2 * o + 1] = best_idx % n_cand - radius;
    sad[o] = best;
  }
}

// cur, prev: (H, W) f32; mv: (H/block, W/block, 2) i32; sad: (H/block, W/block) f32.
// block * block threads per macroblock: block * block must be a multiple of
// 32 and at most 1024 (the Python wrapper checks).
CS_EXPORT int cs_mv_sad_f32(const float* cur, const float* prev, int H, int W,
                            int block, int radius, int* mv, float* sad,
                            cudaStream_t stream) {
  const int threads = block * block;
  const int band = block + 2 * radius;
  const int n_cand = 2 * radius + 1;
  const size_t smem = sizeof(float) * (band * band + n_cand * n_cand * (threads / 32));
  dim3 grid(W / block, H / block);
  mv_sad_kernel<<<grid, threads, smem, stream>>>(cur, prev, H, W, block, radius, mv, sad);
  return (int)cudaGetLastError();
}
