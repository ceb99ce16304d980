// mv_sad: full-search block matching for the codec ingest stage.
//
// Replaces the TPU kernel repro/kernels/mv_sad.py:mv_sad_pallas.  One
// thread block per macroblock, any block edge and any search radius.
// Where they fit (mv_sad_kernel), the block stages the macroblock and its
// (block + 2r)^2 reference band in shared memory once, the band with
// clamped indices (the edge padding of the reference, without a padded
// copy); a band past the 48 KB a block gets by default opts in to dynamic
// shared memory, up to the card's 227 KB.  Past that (mv_sad_tiled_kernel,
// below) the candidates are walked in tiles and the macroblock in row
// strips, one tile's band slice staged at a time.  Each thread walks the
// candidates tid, tid + blockDim.x, ... in dy-major order and sums each
// candidate's block^2 values |cur - ref| in registers (four running sums, one per column mod 4: float4 rows where
// the block edge is a multiple of 4, scalar ones elsewhere), keeping its
// first minimum under a strict '<'.  The first minimum over all
// candidates is then a reduction on (SAD, index) pairs, the smaller index
// winning a tie: a shuffle reduction in each warp and one short step
// across the warps, so no thread walks the candidates alone and the
// answer is the reference's first minimum whatever the number of threads.
// The threads (at most 1024) are as few whole warps as share the
// candidates evenly: 81 candidates (radius 4) take 96 threads, one each;
// 1089 (radius 16) take 576, two each.  The tiled kernel keeps the same
// per-candidate sums and merge, so its answers are the ones one band
// would give.
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

// The tiled kernel, for a band (or a macroblock) past 227 KB: radius 128
// at block 16 (a 272^2 band, 296 KB), block 64 at radius 96, block 240
// at radius 1 (its macroblock alone is 230 KB).  The (2r + 1)^2
// candidates are walked in tiles of ty dy rows by tx dx columns, and the
// macroblock in strips of rs rows; per (tile, strip) the block stages the
// strip and the band slice it meets, (ty - 1 + rs) rows of (tx - 1 +
// block) pixels, with clamped indices.  A thread owns the tile's
// candidates tid + k * 1024, k < PER, and keeps their sums in registers
// across the strips (four per candidate, by column mod 4, summed in the
// order of mv_sad_kernel: rows in order, so the SAD is the same float);
// after the last strip it folds them into its minimum on (SAD, index)
// pairs, the smaller index winning a tie, which makes the order of tiles
// immaterial; the block's merge is mv_sad_kernel's.  ldr pads the slice's
// rows as that kernel pads the band's (tx mod 32), so a warp's
// consecutive candidates hit distinct banks.  kernels/mv_sad.py:
// launch_geometry computes the same tiling.
constexpr int PER = 4;                       // candidates a thread holds per tile
constexpr int TILE_CAND = MAX_THREADS * PER; // candidates a tile

__global__ void __launch_bounds__(MAX_THREADS)
mv_sad_tiled_kernel(const float* __restrict__ cur, const float* __restrict__ prev, int H, int W,
                    int block, int radius, int ty, int tx, int rs, int ldr,
                    int* __restrict__ mv, float* __restrict__ sad) {
  extern __shared__ __align__(16) float smem[];
  const int n_cand = 2 * radius + 1;
  const int n_warps = blockDim.x >> 5;
  float* cs = smem;                                        // rs x block
  float* ref = cs + rs * block;                            // ty - 1 + rs rows of ldr
  float* red_sad = ref + (ty - 1 + rs) * ldr;              // per warp
  int* red_idx = reinterpret_cast<int*>(red_sad + n_warps);
  const int bx = blockIdx.x, by = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int y0 = by * block - radius, x0 = bx * block - radius;
  const bool vec = block % 4 == 0;
  float best = __int_as_float(0x7f800000);
  int bi = 0x7fffffff;
  for (int cy = 0; cy < n_cand; cy += ty) {
    const int tyn = min(ty, n_cand - cy);
    for (int cx = 0; cx < n_cand; cx += tx) {
      const int txn = min(tx, n_cand - cx), n_tile = tyn * txn, bw = txn - 1 + block;
      float acc[PER][4];
      #pragma unroll
      for (int k = 0; k < PER; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
      for (int r0 = 0; r0 < block; r0 += rs) {
        const int rn = min(rs, block - r0), bh = tyn - 1 + rn;
        __syncthreads();   // the last strip's readers are done
        for (int i = tid; i < rn * block; i += blockDim.x)
          cs[i] = cur[(size_t)(by * block + r0 + i / block) * W + bx * block + i % block];
        for (int i = tid; i < bh * bw; i += blockDim.x) {
          const int yy = min(max(y0 + cy + r0 + i / bw, 0), H - 1);
          const int xx = min(max(x0 + cx + i % bw, 0), W - 1);
          ref[(i / bw) * ldr + i % bw] = prev[(size_t)yy * W + xx];
        }
        __syncthreads();
        #pragma unroll
        for (int k = 0; k < PER; ++k) {
          const int c = tid + k * MAX_THREADS;
          if (c >= n_tile) break;
          const float* rr = ref + (c / txn) * ldr + c % txn;
          if (vec) {
            #pragma unroll 2
            for (int r = 0; r < rn; ++r) {
              for (int x = 0; x < block; x += 4) {
                const float4 cv = *reinterpret_cast<const float4*>(cs + r * block + x);
                const float* rf = rr + r * ldr + x;
                acc[k][0] += fabsf(cv.x - rf[0]);
                acc[k][1] += fabsf(cv.y - rf[1]);
                acc[k][2] += fabsf(cv.z - rf[2]);
                acc[k][3] += fabsf(cv.w - rf[3]);
              }
            }
          } else {
            for (int r = 0; r < rn; ++r)
              for (int x = 0; x < block; ++x)
                acc[k][x & 3] += fabsf(cs[r * block + x] - rr[r * ldr + x]);
          }
        }
      }
      #pragma unroll
      for (int k = 0; k < PER; ++k) {
        const int c = tid + k * MAX_THREADS;
        if (c >= n_tile) break;
        const float s = (acc[k][0] + acc[k][1]) + (acc[k][2] + acc[k][3]);
        const int gi = (cy + c / txn) * n_cand + cx + c % txn;
        if (s < best || (s == best && gi < bi)) {
          best = s;
          bi = gi;
        }
      }
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

// the tiled kernel's tiling (mirrored by kernels/mv_sad.py:launch_geometry):
// tx the widest dx range up to TILE_CAND whose one-row strip and slice
// fit; ty as many dy rows as a tile holds, cut to fit with the whole
// macroblock; else strips of rs rows, the most that fit beside ty rows
// (ty cut to 1 if even one row does not).  Shared bytes into *smem; false
// if nothing fits (a macroblock edge past about 29,000 pixels).
bool tiling(int block, int radius, int* ty, int* tx, int* rs, int* ldr, size_t* smem) {
  const long long n_cand = 2LL * radius + 1;
  const long long avail = MAX_SMEM / 4 - 2 * (MAX_THREADS / 32);
  const long long pad = ((1 - block) % 32 + 32) % 32;
  long long x = n_cand < TILE_CAND ? n_cand : TILE_CAND;
  const long long x_fit = avail - 2LL * block - pad + 1;
  if (x_fit < 1) return false;
  if (x > x_fit) x = x_fit;
  const long long l = x - 1 + block + pad;
  long long y = TILE_CAND / x < n_cand ? TILE_CAND / x : n_cand;
  long long r = block;
  const long long y_fit = (avail - (long long)block * block) / l + 1 - block;
  if (y_fit >= 1) {
    if (y > y_fit) y = y_fit;
  } else {
    r = (avail - (y - 1) * l) / (block + l);
    if (r < 1) {
      y = 1;
      r = avail / (block + l);
    }
  }
  *ty = (int)y;
  *tx = (int)x;
  *rs = (int)r;
  *ldr = (int)l;
  *smem = sizeof(float) * (r * block + (y - 1 + r) * l + 2 * (MAX_THREADS / 32));
  return true;
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
// W/block) f32.  Any block edge and radius >= 1: mv_sad_kernel where the
// macroblock and its band fit 227 KB of shared memory, else the tiled
// kernel.  kernels/mv_sad.py:launch_geometry gives the same threads,
// shared bytes and tiling (and checks them).
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
  if (block < 1 || radius < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(W / block, H / block);
  if (smem > MAX_SMEM) {
    int ty, tx, rs, l;
    size_t tsmem;
    if (!tiling(block, radius, &ty, &tx, &rs, &l, &tsmem)) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cudaFuncSetAttribute(
        mv_sad_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tsmem);
    if (err != cudaSuccess) return (int)err;
    mv_sad_tiled_kernel<<<grid, MAX_THREADS, tsmem, stream>>>(cur, prev, H, W, block, radius, ty,
                                                               tx, rs, l, mv, sad);
    return (int)cudaGetLastError();
  }
  if (block == 16)
    return launch<16>(grid, threads, smem, stream, cur, prev, H, W, block, radius, ldr, mv, sad);
  return launch<0>(grid, threads, smem, stream, cur, prev, H, W, block, radius, ldr, mv, sad);
}
