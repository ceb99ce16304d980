// Block-sparse online-softmax attention over 128-row tiles, shared by the
// attention kernels:
//
//   * cs_attn_refresh_bf16 replaces the TPU kernel
//     repro/kernels/flash_refresh.py:flash_refresh_pallas (_refresh_kernel).
//     GQA attention of gathered queries over per-stream caches
//     (B, Sk, Hkv, D): visit list tile_ids[iq, it] -> 128-row tile of
//     stream b's cache.  Mask: kv_valid (per stream) AND causal (+ sliding
//     window) on the query positions q_pos (-1 marks padding rows).
//   * cs_attn_refresh_paged_bf16 replaces flash_refresh_paged_pallas (its
//     bf16 body _refresh_paged_kernel): the same attention over one
//     batchless KV slab, visit list -> page table pt[b, tile] -> physical
//     128-row page.
//   * cs_attn_refresh_paged_int8 replaces the int8 body of the same
//     function (_refresh_paged_quant_kernel): page-table entries >= n_hot
//     address cold page entry - n_hot of an int8 slab with one f32 scale
//     per (cold page, kv head).  The tile load dequantises int8 x scale in
//     f32 and rounds to bf16 into shared memory, the value the plain
//     version's gather produces; the products after it are the bf16
//     kernel's, so an all-hot page table gives bitwise the bf16 result.
//   * cs_attn_packed_bf16 replaces repro/kernels/flash_packed.py:
//     flash_packed_pallas.  Bidirectional block-diagonal attention over
//     packed ViT rows: per-row visit lists, mask seg_q == seg_k && seg_q >= 0.
//   * cs_attn_prefill_bf16 replaces repro/kernels/flash_prefill.py:
//     flash_prefill_pallas (_flash_kernel): dense causal / sliding-window
//     GQA attention, query row i at position i + q_offset, key j at j.
//     There is no host visit list: each block derives the tiles its query
//     tile can reach from that band.  Sq and Sk need not be multiples of
//     128 (the ragged edges are masked and never read or written).
//   * cs_attn_prefill_paged_bf16 / _int8 replace flash_prefill_paged_pallas
//     (_flash_paged_kernel, _flash_paged_quant_kernel): the same over the
//     batchless slab through the page table, causal, with the int8 body's
//     cold-tile load shared with cs_attn_refresh_paged_int8.
//
// All share one templated body; the problem struct supplies the visit
// list, the K/V tile load and the mask.  A thread block owns 64 query
// rows (half of a 128-row map tile, following that tile's visit list) for
// one (batch row, head); its four warps own 16 rows each.  For every
// visited tile it streams the 128 keys through shared memory in two
// 64-key steps: S = Q K^T on the tensor cores (WMMA bf16 -> f32), an f32
// online softmax with the masked multiply p = mask ? exp(s - m) : 0 (so
// recycled pages and fully masked rows contribute exact zeros), then
// O += P V on the tensor cores.  The refresh and packed kernels follow
// the refresh oracle: the query is scaled in f32 and rounded to bf16
// before QK^T, and P is rounded to bf16.  The prefill oracle and its
// Pallas body keep f32 throughout, and so do the prefill kernels (their
// problem struct sets EXACT): the query enters QK^T unscaled (bf16 x bf16
// products are exact in f32) and the scale multiplies the f32 scores, and
// P V is the sum of two products, hi V + lo V with hi = bf16(p) and
// lo = bf16(p - hi), so P keeps about 16 bits (V is bf16 already).  In the
// refresh and packed kernels rows that no key reaches end
// with l = 0 and write acc / max(l, 1e-30) = 0.  The prefill oracle masks
// with the finite -1e30 instead, so a row with no visible key (a negative
// q_offset, a window past Sk) softmaxes uniformly to the mean of V: its
// tile visits every key and its scores are replaced by one constant
// (the problem struct's uniform()).
//
// Bound on an H100: at the serving shapes each (q tile, kv tile) pair does
// 4 * 128 * 128 * D flops on 2 * 128 * D * 2 bytes of K/V (half of that
// for an int8 page), far above the card's flops-per-byte ratio, so the
// bound is the tensor cores.  This first version keeps the accumulator in
// shared memory and uses the WMMA (mma.sync) path, not wgmma/TMA; it is a
// correct baseline that a later version makes fast.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 128;     // map tile = KV page
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per inner step
constexpr int NTHREADS = 128; // 4 warps x 16 rows
constexpr float NEG_INF = -1e30f;

template <int D>
struct Smem {
  static constexpr int LDH = D + 8;   // bf16 Q/K/V rows
  static constexpr int LDS = BK + 4;  // f32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // f32 accumulator
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v = k + sizeof(bf16) * BK * LDH;
  static constexpr size_t s = v + sizeof(bf16) * BK * LDH;
  static constexpr size_t p = s + sizeof(float) * BQ * LDS;
  static constexpr size_t o = p + sizeof(bf16) * BQ * LDP;
  static constexpr size_t m = o + sizeof(float) * BQ * LDO;
  static constexpr size_t l = m + sizeof(float) * BQ;
  static constexpr size_t qi = l + sizeof(float) * BQ;
  static constexpr size_t ki = qi + sizeof(int) * BQ;
  static constexpr size_t bytes = ki + sizeof(int) * BK;
};

// mask and visit list of the refresh kernels, in logical coordinates
struct RefreshMask {
  static constexpr bool EXACT = false;   // bf16 scaled query and P
  const int* qpos;         // (Sq,) logical query positions, -1 = padding
  const uint8_t* kv_valid; // (B, n_tiles * TILE) logical validity
  const int* tile_ids;     // (n_q_tiles, t_max) logical tiles to visit
  const int* tile_count;   // (n_q_tiles,)
  int n_tiles, t_max, causal, window;

  __device__ int count(int, int iq) const { return tile_count[iq]; }
  __device__ int tile(int, int iq, int it) const { return tile_ids[iq * t_max + it]; }
  __device__ int q_info(int, int row) const { return qpos[row]; }
  __device__ bool q_live(int qp) const { return !causal || qp >= 0; }
  __device__ bool uniform(int) const { return false; }
  __device__ int k_info(int b, int j, int c) const {
    return kv_valid[(long long)b * n_tiles * TILE + j * TILE + c];
  }
  __device__ bool mask(int qp, int valid, int kp) const {
    bool m = valid != 0;
    if (causal) m = m && kp <= qp;
    if (window >= 0) m = m && kp > qp - window;
    return m;
  }
};

// K/V rows [row0, row0 + BK) of kv head kvh -> shared memory (16-byte
// loads); rows from n_valid on (past a ragged end) are zeros, never read
template <int D>
__device__ void load_rows(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v,
                          long long row0, int Hkv, int kvh, int tid, int n_valid = BK) {
  constexpr int LDH = Smem<D>::LDH;
  for (int i = tid; i < BK * D / 8; i += NTHREADS) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    uint4 rk = make_uint4(0, 0, 0, 0), rv = rk;
    if (r < n_valid) {
      const long long off = ((row0 + r) * Hkv + kvh) * D + c8;
      rk = *reinterpret_cast<const uint4*>(k + off);
      rv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(Ks + r * LDH + c8) = rk;
    *reinterpret_cast<uint4*>(Vs + r * LDH + c8) = rv;
  }
}

// an int8 cold group beside a bf16 slab: page ids >= n_hot address cold
// page id - n_hot, dequantised int8 x scale[page, kv head] in f32 and
// rounded to bf16 as it is loaded (the plain version's gathered value)
struct ColdPages {
  const int8_t* k8;        // (n_cold * TILE, Hkv, D)
  const int8_t* v8;
  const float* k_scale;    // (n_cold, Hkv)
  const float* v_scale;
  int n_hot;

  // rows [c0, c0 + BK) of page `entry` (uniform over the block)
  template <int D>
  __device__ void load(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int entry,
                       int c0, int Hkv, int kvh, int tid) const {
    if (entry < n_hot) {
      load_rows<D>(Ks, Vs, k, v, (long long)entry * TILE + c0, Hkv, kvh, tid);
      return;
    }
    constexpr int LDH = Smem<D>::LDH;
    const int cp = entry - n_hot;
    const float ks = k_scale[cp * Hkv + kvh], vs = v_scale[cp * Hkv + kvh];
    for (int i = tid; i < BK * D / 8; i += NTHREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const long long off = (((long long)cp * TILE + c0 + r) * Hkv + kvh) * D + c8;
      const uint2 rk = *reinterpret_cast<const uint2*>(k8 + off);
      const uint2 rv = *reinterpret_cast<const uint2*>(v8 + off);
      const int8_t* ek = reinterpret_cast<const int8_t*>(&rk);
      const int8_t* ev = reinterpret_cast<const int8_t*>(&rv);
      #pragma unroll
      for (int t = 0; t < 8; ++t) {
        Ks[r * LDH + c8 + t] = __float2bfloat16_rn((float)ek[t] * ks);
        Vs[r * LDH + c8 + t] = __float2bfloat16_rn((float)ev[t] * vs);
      }
    }
  }
};

// per-stream caches: tile j of stream b is rows b * Sk + j * TILE
struct Refresh : RefreshMask {
  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int b,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    load_rows<D>(Ks, Vs, k, v, ((long long)b * n_tiles + j) * TILE + c0, Hkv, kvh, tid);
  }
};

// batchless slab: tile j of stream b is physical page pt[b, j]
struct RefreshPaged : RefreshMask {
  const int* pt;           // (B, n_tiles) physical page per logical tile

  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int b,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    load_rows<D>(Ks, Vs, k, v, (long long)pt[b * n_tiles + j] * TILE + c0, Hkv, kvh, tid);
  }
};

// two-precision slab: entries >= n_hot are int8 cold pages
struct RefreshPagedQuant : RefreshPaged {
  ColdPages cold;

  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int b,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    cold.load<D>(Ks, Vs, k, v, pt[b * n_tiles + j], c0, Hkv, kvh, tid);
  }
};

struct Packed {
  static constexpr bool EXACT = false;
  const int* seg;          // (R, L) segment id per slot, -1 = padding
  const int* tile_ids;     // (R, L / TILE, t_max)
  const int* tile_count;   // (R, L / TILE)
  int L, n_q_tiles, t_max;

  __device__ int count(int r, int iq) const { return tile_count[r * n_q_tiles + iq]; }
  __device__ int tile(int r, int iq, int it) const {
    return tile_ids[(r * n_q_tiles + iq) * t_max + it];
  }
  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int r,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    load_rows<D>(Ks, Vs, k, v, (long long)r * L + j * TILE + c0, Hkv, kvh, tid);
  }
  __device__ int q_info(int r, int row) const { return seg[r * L + row]; }
  __device__ bool q_live(int s) const { return s >= 0; }
  __device__ bool uniform(int) const { return false; }
  __device__ int k_info(int r, int j, int c) const { return seg[r * L + j * TILE + c]; }
  __device__ bool mask(int sq, int sk, int) const { return sq >= 0 && sq == sk; }
};

// positional mask of the prefill kernels: query row i at i + q_offset,
// key j at j; rows past Sq carry PAD.  The tiles a 128-row query tile
// visits come from the band of its first and last row (the keys a row
// can see, [k_lo, k_hi], move monotonically with its position, and rows
// with none form a prefix (q position < 0 under causality) and a suffix
// (a window past Sk), so the tile's end rows tell whether it has any).
constexpr int PAD = -(1 << 30);

struct PrefillMask {
  static constexpr bool EXACT = true;    // f32 scores, P as bf16 hi + lo
  int Sq, Sk, q_offset, causal, window, n_k_tiles;

  __device__ int q_info(int, int row) const { return row < Sq ? row + q_offset : PAD; }
  __device__ bool q_live(int qp) const { return qp != PAD; }
  __device__ int k_lo(int qp) const { return window >= 0 ? max(0, qp - window + 1) : 0; }
  __device__ int k_hi(int qp) const { return causal ? min(qp, Sk - 1) : Sk - 1; }
  __device__ bool dead(int qp) const { return k_lo(qp) > k_hi(qp); }
  // a row with no visible key: every key, one score (the oracle's uniform softmax)
  __device__ bool uniform(int qp) const { return qp != PAD && dead(qp); }
  __device__ int2 band(int iq) const {
    const int p0 = iq * TILE + q_offset;
    const int p1 = min(iq * TILE + TILE, Sq) - 1 + q_offset;
    if (dead(p0) || dead(p1)) return make_int2(0, n_k_tiles);
    return make_int2(k_lo(p0) / TILE, k_hi(p1) / TILE + 1);
  }
  __device__ int count(int, int iq) const { const int2 r = band(iq); return r.y - r.x; }
  __device__ int tile(int, int iq, int it) const { return band(iq).x + it; }
  __device__ int k_info(int, int j, int c) const { return j * TILE + c < Sk; }
  __device__ bool mask(int qp, int valid, int kp) const {
    if (!valid || qp == PAD) return false;
    if (dead(qp)) return true;
    bool m = true;
    if (causal) m = m && kp <= qp;
    if (window >= 0) m = m && kp > qp - window;
    return m;
  }
};

// per-stream K/V (B, Sk, Hkv, D), any Sk
struct Prefill : PrefillMask {
  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int b,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    load_rows<D>(Ks, Vs, k, v, (long long)b * Sk + j * TILE + c0, Hkv, kvh, tid,
                 Sk - (j * TILE + c0));
  }
};

// batchless slab through the page table; Sk = n_pages * TILE
struct PrefillPaged : PrefillMask {
  const int* pt;           // (B, n_k_tiles) physical page per logical tile

  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int b,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    load_rows<D>(Ks, Vs, k, v, (long long)pt[b * n_k_tiles + j] * TILE + c0, Hkv, kvh, tid);
  }
};

// two-precision slab: entries >= n_hot are int8 cold pages
struct PrefillPagedQuant : PrefillPaged {
  ColdPages cold;

  template <int D>
  __device__ void load_kv(bf16* Ks, bf16* Vs, const bf16* k, const bf16* v, int b,
                          int j, int c0, int Hkv, int kvh, int tid) const {
    cold.load<D>(Ks, Vs, k, v, pt[b * n_k_tiles + j], c0, Hkv, kvh, tid);
  }
};

template <int D, class P>
__global__ void __launch_bounds__(NTHREADS)
attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int H,
            int Hkv, float scale, P prob) {
  using L = Smem<D>;
  constexpr int LDH = L::LDH, LDS = L::LDS, LDP = L::LDP, LDO = L::LDO;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::v);
  float* Ss = reinterpret_cast<float*>(smem + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::p);
  float* Os = reinterpret_cast<float*>(smem + L::o);
  float* m_s = reinterpret_cast<float*>(smem + L::m);
  float* l_s = reinterpret_cast<float*>(smem + L::l);
  int* qinfo = reinterpret_cast<int*>(smem + L::qi);
  int* kinfo = reinterpret_cast<int*>(smem + L::ki);
  // P::EXACT: lo = bf16(p - hi) goes to this warp's rows of Ss (bf16 rows
  // of 2 * LDS), which the softmax has read by the time it writes them
  bf16* Plo = reinterpret_cast<bf16*>(smem + L::s);
  constexpr int LDL = 2 * LDS;
  const float qscale = P::EXACT ? 1.f : scale, sscale = P::EXACT ? scale : 1.f;

  const int iq = blockIdx.x >> 1;
  const int q0 = iq * TILE + (blockIdx.x & 1) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q_stride = (long long)H * D;   // between query rows
  const bf16* qb = q + ((long long)b * Sq + q0) * q_stride + (long long)h * D;
  bf16* ob = out + ((long long)b * Sq + q0) * q_stride + (long long)h * D;

  // rows that no key can reach (padding) are exact zeros: skip the loop;
  // rows from Sq on (a ragged end) are neither read nor written
  const int n_rows = min(BQ, Sq - q0);
  const int live = tid < BQ ? prob.q_live(prob.q_info(b, q0 + tid)) : 0;
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < n_rows * D; i += NTHREADS)
      ob[(i / D) * q_stride + i % D] = __float2bfloat16_rn(0.f);
    return;
  }

  // Q: scaled in f32 and rounded to bf16 (the refresh oracle's numerics),
  // or copied as it is where the scale goes to the f32 scores (EXACT)
  for (int i = tid; i < BQ * D / 8; i += NTHREADS) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const uint4 raw = r < n_rows ? *reinterpret_cast<const uint4*>(qb + r * q_stride + c8)
                                 : make_uint4(0, 0, 0, 0);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    #pragma unroll
    for (int t = 0; t < 8; ++t)
      Qs[r * LDH + c8 + t] = __float2bfloat16_rn(__bfloat162float(e[t]) * qscale);
  }
  for (int i = tid; i < BQ * LDO; i += NTHREADS) Os[i] = 0.f;
  if (tid < BQ) {
    qinfo[tid] = prob.q_info(b, q0 + tid);
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const int n_visit = prob.count(b, iq);
  for (int it = 0; it < n_visit; ++it) {
    const int j = prob.tile(b, iq, it);
    for (int c0 = 0; c0 < TILE; c0 += BK) {
      prob.template load_kv<D>(Ks, Vs, k, v, b, j, c0, Hkv, kvh, tid);
      if (tid < BK) kinfo[tid] = prob.k_info(b, j, c0 + tid);
      __syncthreads();

      // S[16 rows of this warp, BK] = Q K^T
      #pragma unroll
      for (int n = 0; n < BK / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        #pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Qs + warp * 16 * LDH + kk * 16, LDH);
          wmma::load_matrix_sync(fb, Ks + n * 16 * LDH + kk * 16, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(Ss + warp * 16 * LDS + n * 16, acc, LDS, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax over this warp's rows; two key columns per lane
      for (int rr = 0; rr < 16; ++rr) {
        const int r = warp * 16 + rr;
        const int qi = qinfo[r];
        const int kp = j * TILE + c0 + lane;
        const bool m0 = prob.mask(qi, kinfo[lane], kp);
        const bool m1 = prob.mask(qi, kinfo[lane + 32], kp + 32);
        const bool flat = prob.uniform(qi);
        const float x0 = m0 ? (flat ? 0.f : Ss[r * LDS + lane] * sscale) : NEG_INF;
        const float x1 = m1 ? (flat ? 0.f : Ss[r * LDS + lane + 32] * sscale) : NEG_INF;
        float mx = fmaxf(x0, x1);
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = m0 ? expf(x0 - m_new) : 0.f;
        const float p1 = m1 ? expf(x1 - m_new) : 0.f;
        float sum = p0 + p1;
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m_old - m_new);
        // every lane's x0, x1 entered the reductions above, so the row of Ss
        // is read and its first half may take lo
        const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
        Ps[r * LDP + lane] = h0;
        Ps[r * LDP + lane + 32] = h1;
        if constexpr (P::EXACT) {
          Plo[r * LDL + lane] = __float2bfloat16_rn(p0 - __bfloat162float(h0));
          Plo[r * LDL + lane + 32] = __float2bfloat16_rn(p1 - __bfloat162float(h1));
        }
        for (int d = lane; d < D; d += 32) Os[r * LDO + d] *= corr;
        __syncwarp();
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * corr + sum;
        }
      }
      __syncwarp();

      // O[16 rows of this warp, D] += P V
      #pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::load_matrix_sync(acc, Os + warp * 16 * LDO + n * 16, LDO, wmma::mem_row_major);
        #pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, Ps + warp * 16 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, Vs + kk * 16 * LDH + n * 16, LDH);
          wmma::mma_sync(acc, fa, fb, acc);
          if constexpr (P::EXACT) {
            wmma::load_matrix_sync(fa, Plo + warp * 16 * LDL + kk * 16, LDL);
            wmma::mma_sync(acc, fa, fb, acc);
          }
        }
        wmma::store_matrix_sync(Os + warp * 16 * LDO + n * 16, acc, LDO, wmma::mem_row_major);
      }
      __syncthreads();   // Ks/Vs are overwritten by the next step
    }
  }

  // out = acc / max(l, 1e-30): rows no key reached give exact zeros
  for (int rr = 0; rr < 16; ++rr) {
    const int r = warp * 16 + rr;
    if (r >= n_rows) break;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    for (int d = lane; d < D; d += 32)
      ob[r * q_stride + d] = __float2bfloat16_rn(Os[r * LDO + d] * inv);
  }
}

template <int D, class P>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int H, int Hkv, float scale, const P& prob,
           cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<D, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(((Sq + TILE - 1) / TILE) * 2, H, B);
  attn_kernel<D, P><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, H, Hkv, scale, prob);
  return (int)cudaGetLastError();
}

template <class P>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int Sq, int H, int Hkv, float scale, const P& prob,
             cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    case 64: return launch<64>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    case 128: return launch<128>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, Sq, H, D) bf16, Sq % 128 == 0; k, v: (B, n_tiles * 128, Hkv,
// D) bf16 per-stream caches; q_pos: (Sq,) i32; kv_valid: (B, n_tiles * 128)
// u8; tile_ids: (Sq / 128, t_max) i32; tile_count: (Sq / 128,) i32.
// window < 0 means no sliding window.
CS_EXPORT int cs_attn_refresh_bf16(
    const void* q, const void* k, const void* v, void* out, const int* q_pos,
    const uint8_t* kv_valid, const int* tile_ids, const int* tile_count, int B,
    int Sq, int H, int Hkv, int D, int n_tiles, int t_max, int causal,
    int window, float scale, cudaStream_t stream) {
  Refresh prob{{q_pos, kv_valid, tile_ids, tile_count, n_tiles, t_max, causal, window}};
  return launch_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// q, out: (B, Sq, H, D) bf16, Sq % 128 == 0; k, v: (P_phys, Hkv, D) bf16
// slab; q_pos: (Sq,) i32; kv_valid: (B, n_pages * 128) u8; pt: (B, n_pages)
// i32; tile_ids: (Sq / 128, t_max) i32; tile_count: (Sq / 128,) i32.
// window < 0 means no sliding window.
CS_EXPORT int cs_attn_refresh_paged_bf16(
    const void* q, const void* k, const void* v, void* out, const int* q_pos,
    const uint8_t* kv_valid, const int* pt, const int* tile_ids,
    const int* tile_count, int B, int Sq, int H, int Hkv, int D, int n_pages,
    int t_max, int causal, int window, float scale, cudaStream_t stream) {
  RefreshPaged prob{{q_pos, kv_valid, tile_ids, tile_count, n_pages, t_max, causal, window}, pt};
  return launch_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// As cs_attn_refresh_paged_bf16, with k, v the hot slab (n_hot * 128, Hkv,
// D) bf16 and the cold group k8, v8: (n_cold * 128, Hkv, D) i8; k_scale,
// v_scale: (n_cold, Hkv) f32.  pt entries >= n_hot are cold pages.
CS_EXPORT int cs_attn_refresh_paged_int8(
    const void* q, const void* k, const void* v, void* out, const int* q_pos,
    const uint8_t* kv_valid, const int* pt, const int* tile_ids,
    const int* tile_count, const int8_t* k8, const int8_t* v8,
    const float* k_scale, const float* v_scale, int n_hot, int B, int Sq, int H,
    int Hkv, int D, int n_pages, int t_max, int causal, int window, float scale,
    cudaStream_t stream) {
  RefreshPagedQuant prob{
      {{q_pos, kv_valid, tile_ids, tile_count, n_pages, t_max, causal, window}, pt},
      {k8, v8, k_scale, v_scale, n_hot}};
  return launch_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// q, out: (R, L, H, D) bf16, L % 128 == 0; k, v: (R, L, Hkv, D) bf16;
// seg: (R, L) i32; tile_ids: (R, L / 128, t_max) i32; tile_count: (R, L / 128) i32.
CS_EXPORT int cs_attn_packed_bf16(const void* q, const void* k, const void* v,
                                  void* out, const int* seg, const int* tile_ids,
                                  const int* tile_count, int R, int L, int H,
                                  int Hkv, int D, int t_max, float scale,
                                  cudaStream_t stream) {
  Packed prob{seg, tile_ids, tile_count, L, L / TILE, t_max};
  return launch_d(D, q, k, v, out, R, L, H, Hkv, scale, prob, stream);
}

// q, out: (B, Sq, H, D) bf16; k, v: (B, Sk, Hkv, D) bf16 (any Sq, Sk).
// Query row i sits at position i + q_offset; window < 0 means none.
CS_EXPORT int cs_attn_prefill_bf16(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int H, int Hkv,
                                   int D, int q_offset, int causal, int window,
                                   float scale, cudaStream_t stream) {
  Prefill prob{{Sq, Sk, q_offset, causal, window, (Sk + TILE - 1) / TILE}};
  return launch_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// q, out: (B, Sq, H, D) bf16 (any Sq); k, v: (P_phys, Hkv, D) bf16 slab;
// pt: (B, n_pages) i32, the logical keys [0, n_pages * 128).  Causal.
CS_EXPORT int cs_attn_prefill_paged_bf16(const void* q, const void* k, const void* v,
                                         void* out, const int* pt, int B, int Sq, int H,
                                         int Hkv, int D, int n_pages, int q_offset,
                                         int window, float scale, cudaStream_t stream) {
  PrefillPaged prob{{Sq, n_pages * TILE, q_offset, 1, window, n_pages}, pt};
  return launch_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// As cs_attn_prefill_paged_bf16, with k, v the hot slab (n_hot * 128, Hkv,
// D) bf16 and the cold group k8, v8: (n_cold * 128, Hkv, D) i8; k_scale,
// v_scale: (n_cold, Hkv) f32.  pt entries >= n_hot are cold pages.
CS_EXPORT int cs_attn_prefill_paged_int8(
    const void* q, const void* k, const void* v, void* out, const int* pt,
    const int8_t* k8, const int8_t* v8, const float* k_scale, const float* v_scale,
    int n_hot, int B, int Sq, int H, int Hkv, int D, int n_pages, int q_offset,
    int window, float scale, cudaStream_t stream) {
  PrefillPagedQuant prob{{{Sq, n_pages * TILE, q_offset, 1, window, n_pages}, pt},
                         {k8, v8, k_scale, v_scale, n_hot}};
  return launch_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}
