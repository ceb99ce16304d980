// mv_sad: full-search block matching for the codec ingest stage.
//
// Replaces the TPU kernel repro/kernels/mv_sad.py:mv_sad_pallas.  One
// thread block per macroblock, any block edge and any search radius.  The
// block stages the macroblock and its (block + 2r)^2 reference band in
// shared memory once, the band with clamped indices (the edge padding of
// the reference, without a padded copy); a band past the 48 KB a block
// gets by default opts in to dynamic shared memory, up to the card's
// 227 KB.  Each thread walks the candidates tid, tid + blockDim.x, ... in
// dy-major order and sums each candidate's block^2 values |cur - ref| in
// registers (four running sums, one per column mod 4: float4 rows where
// the block edge is a multiple of 4, scalar ones elsewhere), keeping its
// first minimum under a strict '<'.  The first minimum over all
// candidates is then a reduction on (SAD, index) pairs, the smaller index
// winning a tie: a shuffle reduction in each warp and one short step
// across the warps, so no thread walks the candidates alone and the
// answer is the reference's first minimum whatever the number of threads.
// The threads (at most 1024) are as few whole warps as share the
// candidates evenly: 81 candidates (radius 4) take 96 threads, one each;
// 1089 (radius 16) take 576, two each.
//
// Bank conflicts: the lanes of a warp hold consecutive candidates idx =
// dy * n_cand + dx and read the band at dy * ldr + dx from a common
// pixel.  The row stride ldr is padded to n_cand (mod 32), so those words
// are idx apart mod 32 and no two lanes share a bank; the macroblock's
// pixels are broadcast reads.
//
// Bound on an H100: bytes.  Each frame pair is read once (2 x H x W x 4
// bytes) and 81 candidates cost 3 flops a pixel, about 30 flops per
// byte, far below the card's ratio; a 448^2 frame moves 1.6 MB in 784
// blocks, so launch latency is the practical floor.  At radius 16 the
// 1089 candidates cost 400 flops a byte: the f32 CUDA cores bound it.
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int DEFAULT_SMEM = 48 * 1024;     // without opting in
constexpr int MAX_SMEM = 232448;            // 227 KB: an H100 block's most

// BLOCK: the macroblock edge (16, the codec's), or 0 for the runtime argument
template <int BLOCK>
__global__ void mv_sad_kernel(const float* __restrict__ cur, const float* __restrict__ prev,
                              int H, int W, int block_arg, int radius, int ldr,
                              int* __restrict__ mv, float* __restrict__ sad) {
  extern __shared__ __align__(16) float smem[];
  const int block = BLOCK ? BLOCK : block_arg;
  const int band = block + 2 * radius, n_cand = 2 * radius + 1;
  const int n_warps = blockDim.x >> 5;
  float* cs = smem;                                        // block x block
  float* ref = cs + block * block;                         // band rows of ldr
  float* red_sad = ref + band * ldr;                       // per warp
  int* red_idx = reinterpret_cast<int*>(red_sad + n_warps);
  const int bx = blockIdx.x, by = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int y0 = by * block - radius, x0 = bx * block - radius;
  for (int i = tid; i < block * block; i += blockDim.x)
    cs[i] = cur[(size_t)(by * block + i / block) * W + bx * block + i % block];
  for (int i = tid; i < band * band; i += blockDim.x) {
    const int yy = min(max(y0 + i / band, 0), H - 1);
    const int xx = min(max(x0 + i % band, 0), W - 1);
    ref[(i / band) * ldr + i % band] = prev[(size_t)yy * W + xx];
  }
  __syncthreads();

  // this thread's candidates (dy, dx) = divmod(c, n_cand), c = tid, tid +
  // blockDim.x, ...: the first minimum under '<' (threads with none carry
  // +inf)
  float best = __int_as_float(0x7f800000);
  int bi = tid;
  for (int c = tid; c < n_cand * n_cand; c += blockDim.x) {
    const float* rr = ref + (c / n_cand) * ldr + c % n_cand;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (block % 4 == 0) {
      #pragma unroll 2
      for (int r = 0; r < block; ++r) {
        #pragma unroll
        for (int x = 0; x < block; x += 4) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + r * block + x);
          const float* rf = rr + r * ldr + x;
          acc[0] += fabsf(cv.x - rf[0]);
          acc[1] += fabsf(cv.y - rf[1]);
          acc[2] += fabsf(cv.z - rf[2]);
          acc[3] += fabsf(cv.w - rf[3]);
        }
      }
    } else {
      for (int r = 0; r < block; ++r)
        for (int x = 0; x < block; ++x)
          acc[x & 3] += fabsf(cs[r * block + x] - rr[r * ldr + x]);
    }
    const float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    if (s < best) {
      best = s;
      bi = c;
    }
  }

  // argmin over (SAD, index), the smaller index winning a tie
  auto reduce = [&](float& s, int& i) {
    #pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
      if (s2 < s || (s2 == s && i2 < i)) {
        s = s2;
        i = i2;
      }
    }
  };
  reduce(best, bi);
  if (lane == 0) {
    red_sad[warp] = best;
    red_idx[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < n_warps ? red_sad[lane] : __int_as_float(0x7f800000);
    bi = lane < n_warps ? red_idx[lane] : 0x7fffffff;
    reduce(best, bi);
    if (lane == 0) {
      const int o = by * (W / block) + bx;
      mv[2 * o] = bi / n_cand - radius;
      mv[2 * o + 1] = bi % n_cand - radius;
      sad[o] = best;
    }
  }
}

template <int BLOCK>
int launch(dim3 grid, int threads, size_t smem, cudaStream_t stream, const float* cur,
           const float* prev, int H, int W, int block, int radius, int ldr, int* mv,
           float* sad) {
  if (smem > DEFAULT_SMEM) {
    const cudaError_t err = cudaFuncSetAttribute(
        mv_sad_kernel<BLOCK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mv_sad_kernel<BLOCK><<<grid, threads, smem, stream>>>(cur, prev, H, W, block, radius, ldr,
                                                        mv, sad);
  return (int)cudaGetLastError();
}

}  // namespace

// cur, prev: (H, W) f32; mv: (H/block, W/block, 2) i32; sad: (H/block,
// W/block) f32.  Any block edge and radius >= 1 whose macroblock and band
// fit 227 KB of shared memory.  kernels/mv_sad.py:launch_geometry gives
// the same threads and shared bytes (and checks them).
CS_EXPORT int cs_mv_sad_f32(const float* cur, const float* prev, int H, int W,
                            int block, int radius, int* mv, float* sad,
                            cudaStream_t stream) {
  const int band = block + 2 * radius;
  const int n_cand = 2 * radius + 1, n2 = n_cand * n_cand;
  const int ldr = band + ((n_cand - band) % 32 + 32) % 32;
  const int per = (n2 + MAX_THREADS - 1) / MAX_THREADS;            // candidates a thread
  const int threads = ((n2 + per - 1) / per + 31) / 32 * 32;
  const size_t smem =
      sizeof(float) * (block * block + band * ldr + 2 * (threads / 32));
  if (block < 1 || radius < 1 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  dim3 grid(W / block, H / block);
  if (block == 16)
    return launch<16>(grid, threads, smem, stream, cur, prev, H, W, block, radius, ldr, mv, sad);
  return launch<0>(grid, threads, smem, stream, cur, prev, H, W, block, radius, ldr, mv, sad);
}
