// Block-sparse and dense online-softmax attention over 128-row tiles:
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
//     per (cold page, kv head).  A cold tile is dequantised int8 x scale
//     in f32 and rounded to bf16, the value the plain version's gather
//     produces; the products after it are the bf16 kernel's, so an
//     all-hot page table gives bitwise the bf16 result.
//   * cs_attn_prefill_bf16 replaces repro/kernels/flash_prefill.py:
//     flash_prefill_pallas (_flash_kernel): dense causal / sliding-window
//     GQA attention, query row i at position i + q_offset, key j at j.
//     There is no host visit list: each block derives the tiles its query
//     tile can reach from that band.  Sq and Sk need not be multiples of
//     128 (the ragged edges are masked and never read or written).
//   * cs_attn_prefill_paged_bf16 / _int8 replace flash_prefill_paged_pallas
//     (_flash_paged_kernel, _flash_paged_quant_kernel): the same over the
//     batchless slab through the page table, causal; the int8 one shares
//     the refresh int8 kernel's cold-tile path (ColdPages).
//   * cs_attn_packed_bf16 replaces repro/kernels/flash_packed.py:
//     flash_packed_pallas.  Bidirectional GQA attention over packed ViT
//     rows (R, L, H, D) with per-(row, q tile) visit lists; slot i sees
//     slot j iff both carry the same segment id >= 0.  Every segment is
//     one contiguous run of its row (pack_plan lays each frame's kept
//     patches out so; the wrapper refuses other layouts), so a slot's
//     mask is the key range [first, last] of its run, which the host
//     hands over per slot as first | last << 16 (-1: padding).
//
// One templated body (mma_kernel) runs them all.  A problem struct
// supplies visits / tile (the key tiles in order), fetch_kv / finish_kv
// (asynchronous tile loads), q_info / q_live (a query row's mask datum and
// whether any key can reach it), key_range (the row's mask as a key range)
// and, under KEY_BITS, k_info_row / k_live (a live bit per key).
//
// Bound on an H100: at the serving shapes each (q tile, kv tile) pair does
// 4 * 128 * 128 * D flops on 2 * 128 * D * 2 bytes of K/V (half of that
// for an int8 page), far above the card's flops-per-byte ratio, so the
// bound is the tensor cores; decode (one query row per stream) is bound
// by the bytes of the keys it reads.
//
// The body: a thread block owns a whole 128-row query tile for one
// (batch row, head), so every visited K/V tile is read once per query
// tile; its eight warps own 16 query rows each.  K/V (and the tile's
// kv_valid bytes) reach shared memory by 16-byte cp.async copies into a
// ring of STAGES slots of 64 keys, started STAGES - 1 steps ahead of the
// products.  An int8 cold tile is copied the same way into a staging slot
// and dequantised into the ring slot after it lands.  The products are
// mma.sync m16n8k16 bf16 -> f32 fed by ldmatrix, and S, P and O stay in
// registers: the query fragments are loaded once, the S accumulator
// becomes P's A operand with no trip through shared memory, and the online
// softmax reduces row max and sum over the four lanes of a quad and
// rescales O once per step (a wgmma version of the same products, waiting
// on each, measured slower at every shape, PERF.md).  The softmax's
// integer and float work was the step's bottleneck (a per-element mask
// took a dozen instructions), so a row's mask is built once per step as a
// 64-bit word (its key range AND, under KEY_BITS, a ballot of the keys'
// live bits), masked scores become -inf, and exp is one FFMA and ex2.
// Query rows from Sq on (a ragged end) are neither read nor written, and a
// warp whose rows are all padding skips the products.  Head dims 24, 32,
// 64 and 128: at D 24 Q K^T runs two k16 steps over rows zero-padded to
// 32 columns in shared memory, P V three n8 tiles (the third through an
// x2 ldmatrix), and an int8 cold row (24 bytes) arrives in 8-byte copies.  Steps are 64 keys:
// at D 128 the 64 f32 accumulators of O, 32 registers of query fragments
// and 32 f32 scores per thread (216 registers in all) leave no room for
// 128-key steps.  Compile-time hooks whose refresh values keep the refresh
// kernels' code: no per-key bits (KEY_BITS false, prefill and packed: the
// key range is the whole mask, and the kv_valid copies and ballots compile
// away), key rows from Sk on zero-filled by the copy with nothing read for
// them (a masked score gives p = 0, but 0 x NaN would reach O), the
// prefill oracle's numerics (EXACT, below), and query tiles launched
// longest first (q_tile: a causal tile visits iq + 1 key tiles, so the
// short ones fill the tail).
//
// Numerics.  Both products accumulate in f32; the softmax is an f32
// online softmax with the masked multiply p = mask ? exp(s - m) : 0, so
// recycled pages and fully masked rows contribute exact zeros (-inf
// scores give exp(-inf) = 0, and a row with no visible key yet subtracts
// 0 from them, not -inf).  The refresh and packed kernels follow the
// refresh oracle: the query is scaled in f32 and rounded to bf16 before
// QK^T, and P is rounded to bf16; rows that no key reaches (padding) end
// with l = 0 and write acc / max(l, 1e-30) = 0.  The prefill oracle and
// its Pallas body keep f32 throughout, and so do the prefill kernels
// (EXACT): the query enters QK^T unscaled (bf16 x bf16 products are exact
// in f32), the scale multiplies the f32 scores (folded into the
// exponent's factor), and P V is the sum of two products, hi V + lo V
// with hi = bf16(p) and lo = bf16(p - hi), so P keeps about 16 bits (V is
// bf16 already).  The prefill oracle masks with the finite -1e30 instead,
// so a row with no visible key (a negative q_offset, a window past Sk)
// softmaxes uniformly to the mean of V: its key range is every key below
// Sk and its scores are replaced by one constant.
#include <math.h>   // INFINITY

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 128;     // map tile = KV page = query tile

// ---- asynchronous tile loads ---------------------------------------------
constexpr int MMA_THREADS = 256;   // 8 warps x 16 query rows
constexpr int MMA_BK = 64;         // keys per step (one ring slot)

// one ring slot: 64 keys of K and V (bf16, in the body's layout), and
// (int8 problems) the staging bytes of a cold tile
struct Slot {
  bf16* K;
  bf16* V;
  int8_t* K8;
  int8_t* V8;
};

// Where row r, columns [c8, c8 + 8) of a ring slot's K or V live (in
// elements).  A row holds DK columns, D rounded up to Q K^T's k16 step (D
// 24: 32; K's columns from D on are zeros, written once per block), and is
// padded by 16 bytes: ldmatrix reads eight 16-byte rows at once, and a
// pitch of an odd number of 16-byte units (5 at D 24 and 32, 9, 17) puts
// them on distinct banks.
template <int D>
struct PaddedRows {
  static constexpr int DK = (D + 15) / 16 * 16;
  static_assert(DK == D || DK == D + 8, "D is a multiple of 8");
  static constexpr int LDH = DK + 8;
  static constexpr int ELEMS = MMA_BK * LDH;
  __device__ static int at(int r, int c8) { return r * LDH + c8; }
};

// K/V rows [row0, row0 + MMA_BK) of kv head kvh -> a slot, by cp.async
template <int D>
__device__ void async_rows(const Slot& st, const bf16* k, const bf16* v, long long row0,
                           int Hkv, int kvh, int tid) {
  for (int i = tid; i < MMA_BK * D / 8; i += MMA_THREADS) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const long long off = ((row0 + r) * Hkv + kvh) * D + c8;
    cp_async16(st.K + PaddedRows<D>::at(r, c8), k + off);
    cp_async16(st.V + PaddedRows<D>::at(r, c8), v + off);
  }
}

// an int8 cold group beside a bf16 slab: page ids >= n_hot address cold
// page id - n_hot, dequantised int8 x scale[page, kv head] in f32 and
// rounded to bf16 (the plain version's gathered value).  A cold tile's
// bytes are copied into the slot's staging area (fetch) and widened into
// its bf16 rows once they landed (finish).
struct ColdPages {
  const int8_t* k8;        // (n_cold * TILE, Hkv, D)
  const int8_t* v8;
  const float* k_scale;    // (n_cold, Hkv)
  const float* v_scale;
  int n_hot;

  // rows [c0, c0 + MMA_BK) of cold entry `entry` -> the slot's staging
  // bytes, in 16-byte copies (8-byte ones where a row is not a multiple of
  // 16 bytes: D 24)
  template <int D>
  __device__ void fetch(const Slot& st, int entry, int c0, int Hkv, int kvh, int tid) const {
    constexpr int CH = D % 16 == 0 ? 16 : 8;
    const long long row0 = (long long)(entry - n_hot) * TILE + c0;
    for (int i = tid; i < MMA_BK * D / CH; i += MMA_THREADS) {
      const int r = i / (D / CH), c = (i % (D / CH)) * CH;
      const long long off = ((row0 + r) * Hkv + kvh) * D + c;
      if constexpr (CH == 16) {
        cp_async16(st.K8 + r * D + c, k8 + off);
        cp_async16(st.V8 + r * D + c, v8 + off);
      } else {
        cp_async8(st.K8 + r * D + c, k8 + off);
        cp_async8(st.V8 + r * D + c, v8 + off);
      }
    }
  }
  // after the slot's copies landed (block-uniform): dequantise a cold
  // tile into the slot's bf16 rows; true if the caller must synchronise
  template <int D>
  __device__ bool finish(const Slot& st, int entry, int Hkv, int kvh, int tid) const {
    if (entry < n_hot) return false;
    const int cp = entry - n_hot;
    const float ks = k_scale[cp * Hkv + kvh], vs = v_scale[cp * Hkv + kvh];
    for (int i = tid; i < MMA_BK * D / 8; i += MMA_THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const uint2 rk = *reinterpret_cast<const uint2*>(st.K8 + r * D + c8);
      const uint2 rv = *reinterpret_cast<const uint2*>(st.V8 + r * D + c8);
      const int8_t* ek = reinterpret_cast<const int8_t*>(&rk);
      const int8_t* ev = reinterpret_cast<const int8_t*>(&rv);
      __align__(16) bf16 ok[8], ov[8];
      #pragma unroll
      for (int t = 0; t < 8; ++t) {
        ok[t] = __float2bfloat16_rn((float)ek[t] * ks);
        ov[t] = __float2bfloat16_rn((float)ev[t] * vs);
      }
      *reinterpret_cast<uint4*>(st.K + PaddedRows<D>::at(r, c8)) = *reinterpret_cast<const uint4*>(ok);
      *reinterpret_cast<uint4*>(st.V + PaddedRows<D>::at(r, c8)) = *reinterpret_cast<const uint4*>(ov);
    }
    return true;
  }
};

// a query tile's visit list, computed once per block: n key tiles, the
// it-th of which is the problem struct's tile(visits, it): entry first +
// it of a host list (refresh maps) or tile first + it of a band (prefill).
// (An index, not a pointer: a pointer held over the loop took 10 more
// registers at D 128.)
struct Visits {
  int first, n;
};

// mask and visit list of the refresh kernels, in logical coordinates
struct RefreshMask {
  static constexpr bool COLD = false;      // no int8 staging slots
  static constexpr bool KEY_BITS = true;   // kv_valid: a live bit per key
  static constexpr bool EXACT = false;     // the refresh oracle's numerics
  const int* qpos;         // (Sq,) logical query positions, -1 = padding
  const uint8_t* kv_valid; // (B, n_tiles * TILE) logical validity
  const int* tile_ids;     // (n_q_tiles, t_max) logical tiles to visit
  const int* tile_count;   // (n_q_tiles,)
  int n_tiles, t_max, causal, window;

  __device__ int q_tile(int bx) const { return bx; }
  __device__ Visits visits(int, int iq) const { return {iq * t_max, tile_count[iq]}; }
  __device__ int tile(const Visits& vs, int it) const { return tile_ids[vs.first + it]; }
  __device__ int q_info(int, int row) const { return qpos[row]; }
  __device__ bool q_live(int qp) const { return !causal || qp >= 0; }
  // the kv_valid bytes of logical tile j's 128 keys, 16-byte aligned
  __device__ const uint8_t* k_info_row(int b, int j) const {
    return kv_valid + ((long long)b * n_tiles + j) * TILE;
  }
  // the mask: the keys kp0 + [lo, hi] that row qp sees by position
  // (causal, sliding window), and of those the ones whose kv_valid is live
  __device__ int2 key_range(int qp, int kp0) const {
    return make_int2(window >= 0 ? qp - window + 1 - kp0 : -(1 << 30),
                     causal ? qp - kp0 : (1 << 30));
  }
  __device__ bool k_live(uint8_t valid) const { return valid != 0; }
  // after a slot's copies landed: a bf16 tile needs no further work
  template <int D>
  __device__ bool finish_kv(const Slot&, int, int, int, int, int) const { return false; }
};

// per-stream caches: tile j of stream b is rows b * Sk + j * TILE
struct Refresh : RefreshMask {
  template <int D>
  __device__ void fetch_kv(const Slot& st, const bf16* k, const bf16* v, int b, int j,
                           int c0, int Hkv, int kvh, int tid) const {
    async_rows<D>(st, k, v, ((long long)b * n_tiles + j) * TILE + c0, Hkv, kvh, tid);
  }
};

// batchless slab: tile j of stream b is physical page pt[b, j]
struct RefreshPaged : RefreshMask {
  const int* pt;           // (B, n_tiles) physical page per logical tile

  __device__ int page(int b, int j) const { return pt[b * n_tiles + j]; }
  template <int D>
  __device__ void fetch_kv(const Slot& st, const bf16* k, const bf16* v, int b, int j,
                           int c0, int Hkv, int kvh, int tid) const {
    async_rows<D>(st, k, v, (long long)page(b, j) * TILE + c0, Hkv, kvh, tid);
  }
};

// positional mask of the prefill kernels: query row i at i + q_offset,
// key j at j.  Row qp sees the keys [k_lo, k_hi]; both move monotonically
// with qp, and rows that see none form a prefix (a position < 0 under
// causality) and a suffix (a window past Sk), so a query tile's first
// and last rows give the band of key tiles it visits.
struct PrefillMask {
  static constexpr bool COLD = false;
  static constexpr bool KEY_BITS = false;  // the positional range is the whole mask
  static constexpr bool EXACT = true;      // the prefill oracle's numerics
  int Sq, Sk, q_offset, causal, window, n_k_tiles;

  // longest first: causal query tile iq visits iq + 1 key tiles
  __device__ int q_tile(int bx) const { return gridDim.x - 1 - bx; }
  __device__ int q_info(int, int row) const { return row + q_offset; }
  __device__ bool q_live(int) const { return true; }
  __device__ int k_lo(int qp) const { return window >= 0 ? max(0, qp - window + 1) : 0; }
  __device__ int k_hi(int qp) const { return causal ? min(qp, Sk - 1) : Sk - 1; }
  __device__ bool dead(int qp) const { return k_lo(qp) > k_hi(qp); }
  __device__ int tile(const Visits& vs, int it) const { return vs.first + it; }
  __device__ Visits visits(int, int iq) const {
    const int p0 = iq * TILE + q_offset;
    const int p1 = min(iq * TILE + TILE, Sq) - 1 + q_offset;
    if (dead(p0) || dead(p1)) return {0, n_k_tiles};
    const int first = k_lo(p0) / TILE;
    return {first, k_hi(p1) / TILE + 1 - first};
  }
  // the keys kp0 + [lo, hi] that row qp sees; a row with none sees every
  // key below Sk (with one score: the oracle's uniform softmax)
  __device__ int2 key_range(int qp, int kp0) const {
    const int lo = k_lo(qp), hi = k_hi(qp);
    return lo > hi ? make_int2(-kp0, Sk - 1 - kp0) : make_int2(lo - kp0, hi - kp0);
  }
  template <int D>
  __device__ bool finish_kv(const Slot&, int, int, int, int, int) const { return false; }
};

// per-stream K/V (B, Sk, Hkv, D), any Sk: key rows from Sk on (a ragged
// end) are zero-filled by the copy, which reads nothing for them
struct Prefill : PrefillMask {
  template <int D>
  __device__ void fetch_kv(const Slot& st, const bf16* k, const bf16* v, int b, int j,
                           int c0, int Hkv, int kvh, int tid) const {
    const int key0 = j * TILE + c0;
    for (int i = tid; i < MMA_BK * D / 8; i += MMA_THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      const bool in = key0 + r < Sk;
      const long long off = (((long long)b * Sk + (in ? key0 + r : 0)) * Hkv + kvh) * D + c8;
      cp_async16_fill(st.K + PaddedRows<D>::at(r, c8), k + off, in ? 16 : 0);
      cp_async16_fill(st.V + PaddedRows<D>::at(r, c8), v + off, in ? 16 : 0);
    }
  }
};

// batchless slab through the page table; Sk = n_pages * TILE
struct PrefillPaged : PrefillMask {
  const int* pt;           // (B, n_k_tiles) physical page per logical tile

  __device__ int page(int b, int j) const { return pt[b * n_k_tiles + j]; }
  template <int D>
  __device__ void fetch_kv(const Slot& st, const bf16* k, const bf16* v, int b, int j,
                           int c0, int Hkv, int kvh, int tid) const {
    async_rows<D>(st, k, v, (long long)page(b, j) * TILE + c0, Hkv, kvh, tid);
  }
};

// two-precision slab: entries >= n_hot are int8 cold pages.  A hot tile
// takes the bf16 path; a cold tile goes through ColdPages' staging copy
// and dequantisation.
template <class Paged>
struct WithColdPages : Paged {
  static constexpr bool COLD = true;
  ColdPages cold;

  template <int D>
  __device__ void fetch_kv(const Slot& st, const bf16* k, const bf16* v, int b, int j,
                           int c0, int Hkv, int kvh, int tid) const {
    const int entry = this->page(b, j);
    if (entry < cold.n_hot)
      async_rows<D>(st, k, v, (long long)entry * TILE + c0, Hkv, kvh, tid);
    else
      cold.fetch<D>(st, entry, c0, Hkv, kvh, tid);
  }
  template <int D>
  __device__ bool finish_kv(const Slot& st, int b, int j, int Hkv, int kvh, int tid) const {
    return cold.finish<D>(st, this->page(b, j), Hkv, kvh, tid);
  }
};
using RefreshPagedQuant = WithColdPages<RefreshPaged>;
using PrefillPagedQuant = WithColdPages<PrefillPaged>;

// packed ViT rows: q, k, v (R, L, ., D), per-(row, q tile) visit lists;
// a slot's mask is the key range of its segment's run in the row
struct Packed {
  static constexpr bool COLD = false;
  static constexpr bool KEY_BITS = false;  // the run's key range is the whole mask
  static constexpr bool EXACT = false;     // the refresh oracle's numerics
  const int* span;         // (R, L) first | last << 16 of the slot's run, -1 = padding
  const int* tile_ids;     // (R, n_q_tiles, t_max) key tiles to visit
  const int* tile_count;   // (R, n_q_tiles)
  int L, n_q_tiles, t_max;

  __device__ int q_tile(int bx) const { return bx; }
  __device__ Visits visits(int b, int iq) const {
    const int e = b * n_q_tiles + iq;
    return {e * t_max, tile_count[e]};
  }
  __device__ int tile(const Visits& vs, int it) const { return tile_ids[vs.first + it]; }
  __device__ int q_info(int b, int row) const { return span[b * L + row]; }
  __device__ bool q_live(int sp) const { return sp >= 0; }
  __device__ int2 key_range(int sp, int kp0) const {
    return make_int2((sp & 0xffff) - kp0, (sp >> 16) - kp0);
  }
  template <int D>
  __device__ void fetch_kv(const Slot& st, const bf16* k, const bf16* v, int b, int j,
                           int c0, int Hkv, int kvh, int tid) const {
    async_rows<D>(st, k, v, (long long)b * L + j * TILE + c0, Hkv, kvh, tid);
  }
  template <int D>
  __device__ bool finish_kv(const Slot&, int, int, int, int, int) const { return false; }
};

// ---- the body: S, P and O in registers -----------------------------------
// mma.sync m16n8k16, each warp its 16 rows, K and V through ldmatrix; a
// warp's S and O accumulators are m16n8 tiles, and S becomes P's A
// fragment in place.

// bits [max(lo, 0), min(hi, 63)] of a 64-bit mask (2 << 63 wraps to 0)
__device__ __forceinline__ uint64_t span_bits(int2 r) {
  const int lo = max(r.x, 0), hi = min(r.y, 63);
  return lo > hi ? 0 : ((2ull << hi) - 1) & (~0ull << lo);
}

template <int D, class P>
struct MmaSmem {
  static constexpr int LDQ = PaddedRows<D>::LDH;   // padded query rows (ldmatrix)
  static constexpr int STAGES = 3;
  static constexpr size_t slot_kv = sizeof(bf16) * PaddedRows<D>::ELEMS;
  static constexpr size_t slot_ki = P::KEY_BITS ? MMA_BK : 0;   // kv_valid bytes
  static constexpr size_t slot_i8 = P::COLD ? MMA_BK * D : 0;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + sizeof(bf16) * TILE * LDQ;
  static constexpr size_t v = k + STAGES * slot_kv;
  static constexpr size_t ki = v + STAGES * slot_kv;
  static constexpr size_t k8 = ki + ((STAGES * slot_ki + 15) / 16) * 16;
  static constexpr size_t v8 = k8 + STAGES * slot_i8;
  static constexpr size_t bytes = v8 + STAGES * slot_i8;
};

template <int D, class P>
__global__ void __launch_bounds__(MMA_THREADS, 1)
mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ out, int Sq, int H,
           int Hkv, float scale, P prob) {
  using L = MmaSmem<D, P>;
  constexpr int LDQ = L::LDQ, STAGES = L::STAGES;
  constexpr int SPT = TILE / MMA_BK;     // steps per visited tile
  constexpr int NT = MMA_BK / 8;         // n8 tiles of S per step
  constexpr int DK = PaddedRows<D>::DK;  // Q K^T's depth: D, or D 24 zero-padded to 32
  constexpr int DT = D / 8;              // n8 tiles of O (odd at D 24)
  constexpr int KC = DK / 16;            // k16 chunks of Q K^T
  constexpr int KI_COPIES = MMA_BK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  uint8_t* Ki = reinterpret_cast<uint8_t*>(smem + L::ki);
  auto slot = [&](int i) {
    return Slot{reinterpret_cast<bf16*>(smem + L::k + i * L::slot_kv),
                reinterpret_cast<bf16*>(smem + L::v + i * L::slot_kv),
                reinterpret_cast<int8_t*>(smem + L::k8 + i * L::slot_i8),
                reinterpret_cast<int8_t*>(smem + L::v8 + i * L::slot_i8)};
  };
  // the query's factor before QK^T, and the scores' factor in exp(x - m) =
  // 2^(x c - m c): the refresh oracle scales the query, EXACT the scores
  const float qscale = P::EXACT ? 1.f : scale;
  const float c2 = P::EXACT ? scale * LOG2E : LOG2E;

  const int iq = prob.q_tile(blockIdx.x), h = blockIdx.y, b = blockIdx.z;
  const int q0 = iq * TILE;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long q_stride = (long long)H * D;   // between query rows
  const bf16* qb = q + ((long long)b * Sq + q0) * q_stride + (long long)h * D;
  bf16* ob = out + ((long long)b * Sq + q0) * q_stride + (long long)h * D;

  // rows that no key can reach (padding) are exact zeros: a tile with no
  // live row skips the loop; rows from Sq on are neither read nor written
  const int n_rows = min(TILE, Sq - q0);
  const int live = tid < n_rows ? prob.q_live(prob.q_info(b, q0 + tid)) : 0;
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < n_rows * D / 8; i += MMA_THREADS)
      *reinterpret_cast<uint4*>(ob + (i / (D / 8)) * q_stride + (i % (D / 8)) * 8) =
          make_uint4(0, 0, 0, 0);
    return;
  }

  // the ring: step s = visited tile s / SPT, keys (s % SPT) * MMA_BK.., in
  // slot s % STAGES; one commit group per step (empty past the end)
  const auto tiles = prob.visits(b, iq);
  const int n_steps = tiles.n * SPT;
  auto fetch = [&](int s) {
    if (s < n_steps) {
      const int j = prob.tile(tiles, s / SPT), c0 = (s % SPT) * MMA_BK;
      prob.template fetch_kv<D>(slot(s % STAGES), k, v, b, j, c0, Hkv, kvh, tid);
      if constexpr (P::KEY_BITS) {
        if (tid < KI_COPIES)
          cp_async16(Ki + (s % STAGES) * MMA_BK + tid * 16, prob.k_info_row(b, j) + c0 + tid * 16);
      }
    }
    cp_async_commit();
  };
  // K's columns [D, DK), which Q K^T's last k16 step reads against Q's
  // zeros, are zeros too: the copies never write them (garbage there could
  // be a NaN, and 0 x NaN would reach a score)
  if constexpr (DK > D) {
    for (int i = tid; i < STAGES * MMA_BK; i += MMA_THREADS)
      *reinterpret_cast<uint4*>(slot(i / MMA_BK).K + PaddedRows<D>::at(i % MMA_BK, D)) =
          make_uint4(0, 0, 0, 0);
  }
  #pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // this thread's two rows (g and g + 8 of the warp's 16); a warp whose
  // rows are all padding skips the products
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int qp0 = r0 < n_rows ? prob.q_info(b, q0 + r0) : -1;
  const int qp1 = r1 < n_rows ? prob.q_info(b, q0 + r1) : -1;
  const bool ok0 = r0 < n_rows && prob.q_live(qp0);
  const bool ok1 = r1 < n_rows && prob.q_live(qp1);
  const bool compute = __any_sync(0xffffffffu, ok0 || ok1);
  // EXACT: rows with no visible key (their scores become one constant)
  bool dead0 = false, dead1 = false, any_dead = false;
  if constexpr (P::EXACT) {
    dead0 = ok0 && prob.dead(qp0);
    dead1 = ok1 && prob.dead(qp1);
    any_dead = __any_sync(0xffffffffu, dead0 || dead1);
  }

  // Q, times qscale in f32 and rounded to bf16, while the first tiles are
  // in flight (columns [D, DK) zeros); then each warp's fragments
  for (int i = tid; i < TILE * DK / 8; i += MMA_THREADS) {
    const int r = i / (DK / 8), c8 = (i % (DK / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r < n_rows && c8 < D) raw = *reinterpret_cast<const uint4*>(qb + r * q_stride + c8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
    __align__(16) bf16 sc[8];
    #pragma unroll
    for (int t = 0; t < 8; ++t) sc[t] = __float2bfloat16_rn(__bfloat162float(e[t]) * qscale);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c8) = *reinterpret_cast<const uint4*>(sc);
  }
  __syncthreads();
  uint32_t qf[KC][4];
  #pragma unroll
  for (int kc = 0; kc < KC; ++kc)
    ldsm_x4(qf[kc], Qs + (warp * 16 + (lane & 15)) * LDQ + kc * 16 + (lane >> 4) * 8);

  float o[DT * 4];
  #pragma unroll
  for (int i = 0; i < DT * 4; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // l: this thread's columns

  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();             // step s landed; step s - 1's slot is free
    fetch(s + STAGES - 1);
    const int j = prob.tile(tiles, s / SPT), c0 = (s % SPT) * MMA_BK;
    const Slot st = slot(s % STAGES);
    if (prob.template finish_kv<D>(st, b, j, Hkv, kvh, tid)) __syncthreads();
    if (!compute) continue;

    // S = Q K^T (16 rows x MMA_BK keys per warp)
    float sc[NT * 4];
    #pragma unroll
    for (int i = 0; i < NT * 4; ++i) sc[i] = 0.f;
    #pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      #pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, st.K + PaddedRows<D>::at(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                             kc * 16 + ((lane >> 3) & 1) * 8));
        mma16816(sc + 8 * np, qf[kc], kb[0], kb[1]);
        mma16816(sc + 8 * np + 4, qf[kc], kb[2], kb[3]);
      }
    }
    if constexpr (P::EXACT) {
      if (any_dead) {
        #pragma unroll
        for (int i = 0; i < NT * 4; ++i) sc[i] = ((i & 2) ? dead1 : dead0) ? 0.f : sc[i];
      }
    }

    // mask: a row sees the columns of its positional range whose key is
    // live; one 64-bit mask per row and step (bit c: column kp0 + c),
    // masked scores are -inf, so the masked multiply p = mask ? exp(s -
    // m) : 0 gives exact zeros
    uint64_t live_keys = ~0ull;
    if constexpr (P::KEY_BITS) {
      const uint8_t* kin = Ki + (s % STAGES) * MMA_BK;
      live_keys = ((uint64_t)__ballot_sync(0xffffffffu, prob.k_live(kin[lane + 32])) << 32 |
                   __ballot_sync(0xffffffffu, prob.k_live(kin[lane]))) >> (2 * t4);
    }
    const int kp0 = j * TILE + c0 + 2 * t4;     // this thread's column 0
    const uint64_t vis0 = ok0 ? live_keys & span_bits(prob.key_range(qp0, kp0)) : 0;
    const uint64_t vis1 = ok1 ? live_keys & span_bits(prob.key_range(qp1, kp0)) : 0;
    float mx0 = -INFINITY, mx1 = -INFINITY;
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* x = sc + 4 * n;
      #pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[e] = (vis0 >> (8 * n + e)) & 1 ? x[e] : -INFINITY;
        x[e + 2] = (vis1 >> (8 * n + e)) & 1 ? x[e + 2] : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(x[0], x[1]));
      mx1 = fmaxf(mx1, fmaxf(x[2], x[3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // exp(x - m) = 2^(x c2 - m c2); a row with nothing visible yet keeps
    // m = -inf and subtracts 0 (its p are exp(-inf) = 0); an unchanged
    // max gives corr = 2^0 = 1 exactly (both products rounded)
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 == -INFINITY ? 0.f : __fmul_rn(mn0, c2);
    const float ms1 = mn1 == -INFINITY ? 0.f : __fmul_rn(mn1, c2);
    const float corr0 = ex2(__fmul_rn(m0, c2) - ms0);
    const float corr1 = ex2(__fmul_rn(m1, c2) - ms1);
    #pragma unroll
    for (int dn = 0; dn < DT; ++dn) {
      o[4 * dn] *= corr0;
      o[4 * dn + 1] *= corr0;
      o[4 * dn + 2] *= corr1;
      o[4 * dn + 3] *= corr1;
    }
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    #pragma unroll
    for (int n = 0; n < NT; ++n) {
      float* x = sc + 4 * n;
      x[0] = ex2(fmaf(x[0], c2, -ms0));
      x[1] = ex2(fmaf(x[1], c2, -ms0));
      x[2] = ex2(fmaf(x[2], c2, -ms1));
      x[3] = ex2(fmaf(x[3], c2, -ms1));
      sum0 += x[0] + x[1];
      sum1 += x[2] + x[3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;

    // O += P V: the S accumulator of n8 tiles 2kk, 2kk + 1 is P's A
    // fragment for keys 16kk.., rounded to bf16
    uint32_t pa[MMA_BK / 16][4];
    #pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    #pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      // EXACT: P's second bf16 half for the same keys, lo = bf16(p - hi)
      // (a bf16 widens to f32 by a 16-bit shift)
      [[maybe_unused]] uint32_t pl[4];
      if constexpr (P::EXACT) {
        #pragma unroll
        for (int i = 0; i < 4; ++i)
          pl[i] = pack_bf16(sc[8 * kk + 2 * i] - __uint_as_float(pa[kk][i] << 16),
                            sc[8 * kk + 2 * i + 1] - __uint_as_float(pa[kk][i] & 0xffff0000u));
      }
      #pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        ldsm_x4_t(vb, st.V + PaddedRows<D>::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               dp * 16 + (lane >> 4) * 8));
        mma16816(o + 8 * dp, pa[kk], vb[0], vb[1]);
        mma16816(o + 8 * dp + 4, pa[kk], vb[2], vb[3]);
        if constexpr (P::EXACT) {
          mma16816(o + 8 * dp, pl, vb[0], vb[1]);
          mma16816(o + 8 * dp + 4, pl, vb[2], vb[3]);
        }
      }
      if constexpr (DT % 2 == 1) {   // D 24: the last n8 tile of O alone
        uint32_t vb[2];
        ldsm_x2_t(vb, st.V + PaddedRows<D>::at(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                               (DT - 1) * 8));
        mma16816(o + 4 * (DT - 1), pa[kk], vb[0], vb[1]);
        if constexpr (P::EXACT) mma16816(o + 4 * (DT - 1), pl, vb[0], vb[1]);
      }
    }
  }
  cp_async_wait<0>();

  // out = acc / max(l, 1e-30): rows no key reached give exact zeros
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  #pragma unroll
  for (int dn = 0; dn < DT; ++dn) {
    const int c = dn * 8 + 2 * t4;
    if (r0 < n_rows)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(o[4 * dn] * inv0, o[4 * dn + 1] * inv0);
    if (r1 < n_rows)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(o[4 * dn + 2] * inv1, o[4 * dn + 3] * inv1);
  }
}

template <int D, class P>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int Sq,
               int H, int Hkv, float scale, const P& prob, cudaStream_t stream) {
  const size_t smem = MmaSmem<D, P>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mma_kernel<D, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + TILE - 1) / TILE, H, B);
  mma_kernel<D, P><<<grid, MMA_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, Sq, H, Hkv, scale, prob);
  return (int)cudaGetLastError();
}

template <class P>
int launch_mma_d(int D, const void* q, const void* k, const void* v, void* out, int B,
                 int Sq, int H, int Hkv, float scale, const P& prob, cudaStream_t stream) {
  switch (D) {
    case 24: return launch_mma<24>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    case 32: return launch_mma<32>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    case 64: return launch_mma<64>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    case 128: return launch_mma<128>(q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, Sq, H, D) bf16, any Sq; k, v: (B, n_tiles * 128, Hkv, D)
// bf16 per-stream caches; q_pos: (n_q_tiles * 128,) i32 (the map's, padded
// with -1); kv_valid: (B, n_tiles * 128) u8; tile_ids: (n_q_tiles, t_max)
// i32; tile_count: (n_q_tiles,) i32, n_q_tiles = ceil(Sq / 128).  Every
// pointer 16-byte aligned.  window < 0 means no sliding window.
CS_EXPORT int cs_attn_refresh_bf16(
    const void* q, const void* k, const void* v, void* out, const int* q_pos,
    const uint8_t* kv_valid, const int* tile_ids, const int* tile_count, int B,
    int Sq, int H, int Hkv, int D, int n_tiles, int t_max, int causal,
    int window, float scale, cudaStream_t stream) {
  Refresh prob{{q_pos, kv_valid, tile_ids, tile_count, n_tiles, t_max, causal, window}};
  return launch_mma_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// As cs_attn_refresh_bf16 over k, v: (P_phys, Hkv, D) bf16 slab through
// pt: (B, n_pages) i32; kv_valid: (B, n_pages * 128) u8.
CS_EXPORT int cs_attn_refresh_paged_bf16(
    const void* q, const void* k, const void* v, void* out, const int* q_pos,
    const uint8_t* kv_valid, const int* pt, const int* tile_ids,
    const int* tile_count, int B, int Sq, int H, int Hkv, int D, int n_pages,
    int t_max, int causal, int window, float scale, cudaStream_t stream) {
  RefreshPaged prob{{q_pos, kv_valid, tile_ids, tile_count, n_pages, t_max, causal, window}, pt};
  return launch_mma_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
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
  return launch_mma_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// q, out: (R, L, H, D) bf16, L % 128 == 0 and L <= 32768; k, v: (R, L,
// Hkv, D) bf16; span: (R, L) i32, per slot the first and last slot of its
// segment's run, first | last << 16, -1 for padding; tile_ids: (R, L /
// 128, t_max) i32; tile_count: (R, L / 128) i32.  q, k, v 16-byte aligned.
CS_EXPORT int cs_attn_packed_bf16(const void* q, const void* k, const void* v,
                                  void* out, const int* span, const int* tile_ids,
                                  const int* tile_count, int R, int L, int H,
                                  int Hkv, int D, int t_max, float scale,
                                  cudaStream_t stream) {
  Packed prob{span, tile_ids, tile_count, L, L / TILE, t_max};
  return launch_mma_d(D, q, k, v, out, R, L, H, Hkv, scale, prob, stream);
}

// q, out: (B, Sq, H, D) bf16; k, v: (B, Sk, Hkv, D) bf16 (any Sq, Sk).
// Query row i sits at position i + q_offset; window < 0 means none.
CS_EXPORT int cs_attn_prefill_bf16(const void* q, const void* k, const void* v,
                                   void* out, int B, int Sq, int Sk, int H, int Hkv,
                                   int D, int q_offset, int causal, int window,
                                   float scale, cudaStream_t stream) {
  Prefill prob{{Sq, Sk, q_offset, causal, window, (Sk + TILE - 1) / TILE}};
  return launch_mma_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}

// q, out: (B, Sq, H, D) bf16 (any Sq); k, v: (P_phys, Hkv, D) bf16 slab;
// pt: (B, n_pages) i32, the logical keys [0, n_pages * 128).  Causal.
CS_EXPORT int cs_attn_prefill_paged_bf16(const void* q, const void* k, const void* v,
                                         void* out, const int* pt, int B, int Sq, int H,
                                         int Hkv, int D, int n_pages, int q_offset,
                                         int window, float scale, cudaStream_t stream) {
  PrefillPaged prob{{Sq, n_pages * TILE, q_offset, 1, window, n_pages}, pt};
  return launch_mma_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
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
  return launch_mma_d(D, q, k, v, out, B, Sq, H, Hkv, scale, prob, stream);
}
