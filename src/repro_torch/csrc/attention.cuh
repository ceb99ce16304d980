// Block-sparse and dense online-softmax attention over 128-row tiles: the
// body every attention kernel shares, and the seven entry points each
// source instantiates (CS_ATTN_EXPORTS, at the end).
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
// and, under KEY_BITS, k_info_row / k_live (a live bit per key).  A Build
// supplies the widths and the operands' types:
//
//   * head dims: a build of width D (24, 32, 64, 128, 256 or 512) lays out
//     shared memory and runs the products for D columns; past 512 the
//     DEEP build (below) runs them over depth chunks of 256.  An exact build
//     (attention.cu; attention_512.cu at 512) takes d == D, and the ones
//     up to 256 compile to the code these kernels had before other widths
//     were taken; a ragged build takes any head dim d <= D
//     (attention_any.cu, attention_512.cu, and every f32 build): it copies a
//     row's live 8-column chunks, zeroes K's columns [d, DK) once per
//     block (Q's are zeros too, so Q K^T is exact), and stores d output
//     columns.  A row of d bf16 is 16-byte aligned only where d is a
//     multiple of 8; else it goes in pieces of 8-byte (d a multiple of 4)
//     or 4-byte (d even) cp.async copies, or at an odd d (2-byte rows)
//     in plain loads and shared stores, a row's pieces on consecutive
//     lanes (Build::cw, chosen once per launch; narrow_rows); an int8
//     cold row of d bytes in 4-byte copies or 2- or 1-byte loads; q and
//     the output element by element.  Each d runs on the smallest build
//     that holds it (d 1-24 on 24; 33-64 on 64, and 25-31 in bf16; 65-128
//     on 128; 129-255 on 256; 257-511 on 512), whose padded products cost
//     up to D / d more (1.6x at d 80, 1.9x at d 136).  D 256 is WIDE and D
//     512 SLAB (below: block shapes of their own); every d past 512 runs
//     on the DEEP build;
//   * operand types: K's and V's type picks the build, and q's type
//     (Build::qt: bf16, f16 or f32, the output's too) is a launch argument
//     that changes only Q's staging (read in q's type, converted to f32)
//     and the output's store, which run once per block; the products
//     stay those of K/V's type.  OPS_BF16: bf16 K/V and a bf16 q (the
//     exact builds keep the code they had before q's type was an
//     argument).  OPS_Q32: bf16 K/V and an f32 or f16 q (what an f32 LM
//     hands the refresh kernels: its caches and slab are bf16).  OPS_F16:
//     f16 K/V and an f16 q, and in the refresh and packed kernels a bf16
//     or f32 one too.  OPS_Q16: f16 K/V and a bf16 or f32 q in the
//     prefill kernels (attention_q16.cu).  OPS_F32: f32 K/V (the packed
//     ViT of an f32 checkpoint and the dense prefill) and any q.  Each
//     build takes the q types q_types gives it; a build of one q type
//     folds the run-time tests away (QType).  OPS_F16 is OPS_BF16 with
//     f16 for bf16: the same copies (element-size code), the products on
//     mma.sync ...f32.f16.f16.f32, every rounding (q x scale, P, a
//     dequantised cold page, P's split halves) to f16, which its oracles'
//     roundings to K's and V's type are; its builds take every head dim,
//     ragged all (attention_f16.cu, attention_f16_512.cu,
//     attention_f16_deep.cu).  An f32 q is read with plain loads and
//     rounded on its way to shared memory (cp.async cannot convert).
//     Under the refresh oracle's numerics (below) the oracle itself
//     rounds q x scale to K's type and P to V's, so a query of another
//     type changes nothing in the products: OPS_Q32's are the bf16
//     kernel's, and a bf16 or f32 q over f16 K/V runs the f16 kernel (q
//     x scale past 65504 becomes inf there, as in the oracle).  Where the
//     oracle keeps f32 (EXACT, or f32 K/V) a query wider than the
//     products enters them as two halves of the products' type, hi = E(x)
//     and lo = E(x - hi): an f32 or f16 q over bf16 K/V as two bf16 halves
//     (an f16 value is exactly its two), a bf16 or f32 one over f16 K/V
//     as two f16 halves (OPS_Q16).  f16 holds neither bf16's range nor
//     f32's, so OPS_Q16 first scales each query row by the power of two
//     2^-e that puts its largest |q| in [2^14, 2^15) (row_factor), which
//     leaves about 22 bits of every element the row's scores can feel,
//     and multiplies 2^e back into the row's exponent factor: S stays the
//     f32 scores over 2^e exactly, masks and maxima in the same units.
//     Where the oracle keeps f32 the two halves are hi = bf16(x) and lo =
//     bf16(x - hi), about 16 bits: Q (both halves in shared memory, their
//     fragments loaded each step, which frees the registers of the query
//     fragments), P (as EXACT already splits it) and, under OPS_F32, K
//     and V, whose halves split_bf16_kernel writes before the launch
//     (attention_f32.cu; its bytes count in the bound), so the ring fills
//     by cp.async as for bf16.  Q K^T then sums hi K_hi + lo K_hi + hi
//     K_lo and P V likewise: three products where bf16 takes one; the
//     lo x lo term is below f32's own rounding of the sum.  OPS_F32
//     rings hold four arrays a slot, so at D 128 they run two stages
//     (Q's halves 68 KB and 2 x 68 KB of ring: 204 KB of the 227 KB).
//
// Bound on an H100: at the serving shapes each (q tile, kv tile) pair does
// 4 * 128 * 128 * D flops on 2 * 128 * D * 2 bytes of K/V (half of that
// for an int8 page), far above the card's flops-per-byte ratio, so the
// bound is the tensor cores; decode (one query row per stream) is bound
// by the bytes of the keys it reads.
//
// The body (up to D 128): a thread block owns a whole 128-row query tile for one
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
// warp whose rows are all padding skips the products.  At D 24 Q K^T runs
// two k16 steps over rows zero-padded to 32 columns in shared memory, P V
// three n8 tiles (the third through an x2 ldmatrix), and an int8 cold row
// (24 bytes, or any ragged d) arrives in 8-byte copies.  Steps are 64 keys:
// at D 128 the 64 f32 accumulators of O, 32 registers of query fragments
// and 32 f32 scores per thread (216 registers in all) leave no room for
// 128-key steps.
//
// The WIDE body (D 256) does not fit that shape: O alone takes 128 f32
// registers a thread, and a 128-row Q tile (67.6 KB at rows of 264) with
// three stages of 64-key K and V slots (33.8 KB each) passes 227 KB.  So a
// WIDE block has four warps own 64 query rows, half a map tile (two
// blocks share a tile's visit list, page table and kv_valid rows, and
// each reads the tile's K/V), in 32-key steps (16 f32 scores a thread)
// over two stages, and reads the query's fragments from shared memory at
// every k16 step, as a split query does.  Shared memory: Q 33.8 KB (67.6
// with its low half), a K or V slot 16.9 KB; bf16 101 KB (two blocks an
// SM), + int8 staging 134 KB, OPS_F32's four arrays a slot 203 KB.
// OPS_Q16 takes 16-key steps here (its split query, f16 P halves and row
// factors spilled past 255 registers in the dense prefill at 32).
//
// The SLAB body (D 512) splits O's columns over blocks: O's 512 columns
// would take 256 f32 registers a thread.  Each block runs the WIDE body on
// one slab of DV = 256 (or 128) columns of V and O (the slab a grid
// dimension: blockIdx.y = head x SLABS + slab), while Q K^T sums over
// every column of Q and K, so each slab's softmax is the whole head's,
// recomputed per slab: the blocks of a query block compute the same S bit
// for bit, read the same K tiles, and each its own slab of V.  On two
// slabs Q K^T's work is done twice (the products cost 1.5x their ideal
// count; 2.5x on four).  Shared memory
// at rows of 520 bf16 (1040 B): Q 66.6 KB, a 32-key K slot 33.3 KB, its V
// slot 16.9 KB: bf16 167 KB in two stages, + int8 staging (K's 512 bytes
// a row and the slab's 256) 216 KB.  The ragged bf16 build halves the key
// step to 16, whose narrow copies otherwise pass 255 registers beside O's
// 128 in the prefill kernels (117 KB, + int8 141 KB).  An f32 query takes
// 16-key steps too, on four slabs of 128 columns (O's 64 registers: its
// split query and P passed 255 beside 128 in the int8 prefill; Q's low
// half, where the oracle keeps it, 66.6 KB more: 175 KB, + int8 196 KB),
// whose slabs past a ragged d exit at once.  OPS_F32's four arrays a slot
// halve the query rows to 32 (two warps: Q's halves 66.6 KB, two 16-key
// stages 100 KB).
//
// The DEEP body (every d past 512) sums Q K^T over depth chunks of D = 256
// columns, so that no shared memory and no register depends on d: the
// chunk count nc = ceil(d / 256) and the slab count ceil(d / DV) are
// runtime values, and one build takes every width.  It runs the SLAB
// body's block shape (4 warps over 64 query rows, 2 and 32 for f32 q/k/v)
// in 16-key steps, on one slab of DV columns of V and O (blockIdx.y = head
// x slabs + slab: H x ceil(d / DV) < 65536, which at H 40 and slabs of 256
// holds d up to 419,424).  Each key step is nc units in the two-stage
// ring: unit c brings chunk c of Q's rows and of the step's keys, the
// first also the step's V slab (and kv_valid bytes), into buffers indexed
// by step parity; the products add chunk c's Q_c K_c^T to S (8 f32
// scores a thread) and, after the last chunk, the online softmax and the
// slab's P V run as in the SLAB body.  Q is streamed, not resident: a
// pre-pass (q_deep_kernel) writes its rows as the body's Q staging would
// round them (q x scale to bf16 under the refresh oracle, the unscaled
// query and its low half where it is split; OPS_Q16: q_deep_rows_kernel,
// each row over its factor, and the factors after the halves) into the
// caller's scratch,
// zero-padded to a multiple of 16 columns, so every unit copies its Q
// chunk by 16-byte cp.async and a last chunk of dk columns runs
// ceil(dk / 16) k16 steps against Q's zeros (K's ring is zeroed once, so
// that no stale NaN meets them).  The cost: Q is read from L2 once a key
// step (64 rows x d where K brings 16 x d), and every slab recomputes the
// whole head's Q K^T (the products (slabs + 1) / 2 times their count at
// slabs of 256: 2.5x at d 1024, 8.5x at 4096).  Slabs are 256 columns in
// the bf16 refresh and packed kernels, 128 in the prefill ones (P split in
// halves) and for f32 operands, whose products pass 255 registers beside
// O's 128 otherwise.  Shared memory: a unit's Q chunk 33.8 KB and K chunk
// 8.4 KB, a V slab 8.4 KB (4.4 at 128 columns): bf16 101 KB (two blocks an
// SM), + int8 staging 118 KB; bf16 prefill 93 KB, + int8 105 KB; an f32
// query's split Q 161 KB, + int8 173 KB; f32 q/k/v 119 KB.
// Compile-time hooks whose refresh values keep the refresh
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
// refresh oracle: the query is scaled in f32 and rounded to K's type
// before QK^T (bf16 K: one bf16; f32 K: kept as two halves), and P is
// rounded to V's type; rows that no key reaches (padding) end with l = 0
// and write acc / max(l, 1e-30) = 0.  The prefill oracle and its Pallas
// body keep f32 throughout, and so do the prefill kernels (EXACT): the
// query enters QK^T unscaled (bf16 x bf16 products are exact in f32; an
// f32 query as its two halves), the scale multiplies the f32 scores
// (folded into the exponent's factor), and P V is the sum of two
// products, hi V + lo V with hi = bf16(p) and lo = bf16(p - hi), so P
// keeps about 16 bits.  The prefill oracle masks with the finite -1e30
// instead, so a row with no visible key (a negative q_offset, a window
// past Sk) softmaxes uniformly to the mean of V: its key range is every
// key below Sk and its scores are replaced by one constant.
#pragma once
#include <math.h>   // INFINITY
#include <type_traits>

#include "common.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TILE = 128;     // map tile = KV page = query tile

// operand types of a build (see the header): K's and V's type, and
// whether the prefill kernels take the query as two halves
enum : int { OPS_BF16 = 0, OPS_Q32 = 1, OPS_F32 = 2, OPS_F16 = 3, OPS_Q16 = 4 };
// q's (and the output's) element type, a launch argument (Build::qt)
enum : int { Q_BF16 = 0, Q_F16 = 1, Q_F32 = 2 };

// A build: its width D (shared-memory rows, the products' columns),
// whether it takes a ragged head dim dh <= D, and its operand types.  A
// ragged dh copies its rows in chunks of cw elements: 8 (16 bytes of
// bf16) where dh is a multiple of 8, else the widest that rows of dh
// elements stay aligned to (4, 2; 1 at an odd dh).
// Its block shape (see the header): up to D 128, THREADS 256 (8 warps)
// own a whole 128-row query tile in BK = 64-key steps; a WIDE build (D
// 256) has 4 warps own QROWS = 64 rows, half a tile, in 32-key steps; a
// SLAB build (D 512) runs that shape on one of SLABS column slabs of DV
// columns of V and O (16-key steps for the OPS_Q32 and OPS_Q16 builds and a
// ragged d, slabs of 128 for those builds, and 2 warps over 32 rows for
// f32 K/V; OPS_Q16's WIDE build takes 16-key steps too).  A
// DEEP build (any dh past 512; DEEP_DV_ > 0) runs the SLAB shape in 16-key
// steps on slab_count(dh) = ceil(dh / DV) slabs of DV = DEEP_DV_ columns,
// a runtime count, summing Q K^T over depth chunks of D = 256 columns.
template <int D_, bool RAGGED_, int OPS_, int DEEP_DV_ = 0>
struct Build {
  static constexpr int D = D_;
  static constexpr bool RAGGED = RAGGED_;
  static constexpr int OPS = OPS_;
  static constexpr bool DEEP = DEEP_DV_ > 0;
  static constexpr bool F16 = OPS_ == OPS_F16 || OPS_ == OPS_Q16;   // f16 products (else bf16)
  static constexpr bool HALF = OPS_ == OPS_BF16 || OPS_ == OPS_F16;  // 16-bit K/V, Q one half
  static constexpr bool SPLIT_KV = OPS_ == OPS_F32;   // K, V as bf16 hi + lo
  static constexpr bool WIDE = D_ > 128;
  // V's and O's column slabs: 256 columns (128 for OPS_Q32 and OPS_Q16, whose
  // split query and P pass 255 registers beside O's 128 in the int8
  // prefill); DEEP: slab_count(dh) of them
  static constexpr int SLABS =
      DEEP ? 0 : D_ > 256 ? D_ / (OPS_ == OPS_Q32 || OPS_ == OPS_Q16 ? 128 : 256) : 1;
  static constexpr bool SLAB = DEEP || SLABS > 1;
  static constexpr int DV = DEEP ? DEEP_DV_ : D_ / SLABS;   // V's and O's columns a block
  static constexpr int THREADS = !WIDE ? 256 : SLAB && SPLIT_KV ? 64 : 128;  // 16 rows a warp
  // keys a step (one ring slot)
  static constexpr int BK = !WIDE ? 64 : (SLAB && (!HALF || RAGGED_)) || OPS_ == OPS_Q16 ? 16 : 32;
  static constexpr int QROWS = THREADS / 2;            // query rows a block
  static_assert(!DEEP || (D_ == 256 && RAGGED_), "a DEEP build: chunks of 256, any d");
  int dh;                                              // the operands' head dim
  int cw;                                              // its copy chunk (elements)
  int qt;                                              // q's and the output's type (Q_*)
  // the operands' head dim, and whether columns [c8, c8 + 8) hold data
  __device__ __forceinline__ int d() const { return RAGGED ? dh : D; }
  __device__ __forceinline__ bool col(int c8) const { return !RAGGED || c8 < dh; }
  // whether rows go in whole 16-byte chunks (every exact build)
  __device__ __forceinline__ bool whole() const { return !RAGGED || cw == 8; }
  // the live columns of the chunk at c8 (< 8 only in the last one)
  __device__ __forceinline__ int live(int c8) const { return RAGGED ? min(8, dh - c8) : 8; }
};

// build B's column slabs of V and O at head dim dh (the grid's blockIdx.y:
// head x slabs + slab): SLABS, or for a DEEP build ceil(dh / DV)
template <class B>
__host__ __device__ __forceinline__ int slab_count(int dh) {
  if constexpr (B::DEEP) return (dh + B::DV - 1) / B::DV;
  else return B::SLABS;
}

// a head dim's copy chunk (Build::cw)
inline int copy_chunk(int dh) { return dh % 8 == 0 ? 8 : dh % 4 == 0 ? 4 : dh % 2 == 0 ? 2 : 1; }

// the products' element type: what the ring, Q's staging and P hold (f16
// under OPS_F16, else bf16; shared memory and the copies are typed bf16,
// as 16-bit words)
template <class B>
using ET = std::conditional_t<B::F16, __half, bf16>;

// ---- asynchronous tile loads ---------------------------------------------
// one ring slot: a step's keys of K and V (bf16, in the body's layout), their
// low halves (OPS_F32), and (int8 problems) the staging bytes of a cold
// tile
struct Slot {
  bf16* K;
  bf16* V;
  int8_t* K8;
  int8_t* V8;
  bf16* Klo;
  bf16* Vlo;
};

// the K/V operands in device memory (k_lo, v_lo: OPS_F32's low halves);
// a SLAB build's block reads V's columns [v0, v0 + dv) of its slab
// (neither is read by the other builds)
struct KV {
  const bf16* k;
  const bf16* v;
  const bf16* k_lo;
  const bf16* v_lo;
  int v0, dv;
};

// a DEEP build's unit (the KV its loads and finish_kv are handed): K's
// depth chunk [k0, k0 + dk), the step's V slab with its first chunk (k0
// == 0) and, for a cold page, V dequantised with its last (last).  A type
// of its own, so that the other builds' KV keeps its layout.
struct DeepKV : KV {
  int k0, dk;
  bool last;
};
__device__ __forceinline__ const DeepKV& deep_kv(const KV& kv) {
  return static_cast<const DeepKV&>(kv);
}

// Where row r, columns [c8, c8 + 8) of a ring slot's K or V live (in
// elements).  A row holds DK columns, D rounded up to Q K^T's k16 step (D
// 24: 32; K's columns from d on are zeros, written once per block), and is
// padded by 16 bytes: ldmatrix reads eight 16-byte rows at once, and a
// pitch of an odd number of 16-byte units (5 at D 24 and 32, 9, 17) puts
// them on distinct banks.
template <int D>
struct PaddedRows {
  static constexpr int DK = (D + 15) / 16 * 16;
  static_assert(DK == D || DK == D + 8, "D is a multiple of 8");
  static constexpr int LDH = DK + 8;
  __device__ static int at(int r, int c8) { return r * LDH + c8; }
};

// one piece of cw bf16 columns (cw < 8: a row not on 16-byte
// boundaries) into shared memory: an 8-byte (cw 4) or 4-byte (cw 2)
// cp.async reading the piece if `in` and zero-filling it otherwise, or at
// an odd head dim (cw 1, rows 2-byte aligned) a plain load and shared
// store, which the barrier before the slot is read orders as it orders
// the copies
__device__ __forceinline__ void narrow_piece(bf16* dst, const bf16* src, int cw, bool in) {
  if (cw == 4) cp_async_ca<8>(dst, src, in ? 8 : 0);
  else if (cw == 2) cp_async_ca<4>(dst, src, in ? 4 : 0);
  else *dst = in ? *src : __float2bfloat16_rn(0.f);
}

// lanes given to one row of np pieces: np rounded up to a power of two,
// at most 32; returns its log2 (thread i: row i >> lg, lane i & (2^lg - 1))
__device__ __forceinline__ int row_lanes_log2(int np) {
  return np >= 32 ? 5 : 32 - __clz(np - 1);
}

// K/V rows [row0, row0 + BK) of kv head kvh -> a slot, by cp.async: a
// 16-byte chunk a thread, or where rows are not on 16-byte boundaries
// (a ragged build's cw < 8; decided once per call) pieces of cw columns,
// a row's consecutive pieces on consecutive lanes (rows [n_in, BK)
// zero-filled, nothing read for them: key rows past Sk)
template <class B>
__device__ void narrow_rows(const Slot& st, const KV& kv, long long row0, int Hkv, int kvh,
                            int tid, const B& bd, int n_in = B::BK) {
  constexpr int D = B::D, DV = B::DV;
  const int lg = row_lanes_log2(bd.dh / bd.cw);
  for (int i = tid; i < (B::BK << lg); i += B::THREADS) {
    const int r = i >> lg;
    const bool in = r < n_in;
    const long long off = ((row0 + (in ? r : 0)) * Hkv + kvh) * bd.dh;
    const int c1 = (i & ((1 << lg) - 1)) * bd.cw;    // this thread's first piece
    for (int c = c1; c < bd.dh; c += bd.cw << lg) {
      narrow_piece(st.K + PaddedRows<D>::at(r, c), kv.k + off + c, bd.cw, in);
      if constexpr (!B::SLAB)
        narrow_piece(st.V + PaddedRows<D>::at(r, c), kv.v + off + c, bd.cw, in);
      if constexpr (B::SPLIT_KV) {
        narrow_piece(st.Klo + PaddedRows<D>::at(r, c), kv.k_lo + off + c, bd.cw, in);
        if constexpr (!B::SLAB)
          narrow_piece(st.Vlo + PaddedRows<D>::at(r, c), kv.v_lo + off + c, bd.cw, in);
      }
    }
    if constexpr (B::SLAB) {   // V: the slab's columns only
      for (int c = c1; c < kv.dv; c += bd.cw << lg) {
        narrow_piece(st.V + PaddedRows<DV>::at(r, c), kv.v + off + kv.v0 + c, bd.cw, in);
        if constexpr (B::SPLIT_KV)
          narrow_piece(st.Vlo + PaddedRows<DV>::at(r, c), kv.v_lo + off + kv.v0 + c, bd.cw, in);
      }
    }
  }
}

// a SLAB build's rows in whole 16-byte chunks: K's d columns, then the
// slab's dv columns of V (rows [n_in, BK) zero-filled, nothing read for
// them: key rows past Sk)
template <class B>
__device__ void slab_rows(const Slot& st, const KV& kv, long long row0, int Hkv, int kvh,
                          int tid, const B& bd, int n_in) {
  constexpr int D = B::D, DV = B::DV;
  for (int i = tid; i < B::BK * D / 8; i += B::THREADS) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    if (!bd.col(c8)) continue;
    const bool in = r < n_in;
    const long long off = ((row0 + (in ? r : 0)) * Hkv + kvh) * bd.d() + c8;
    cp_async16_fill(st.K + PaddedRows<D>::at(r, c8), kv.k + off, in ? 16 : 0);
    if constexpr (B::SPLIT_KV)
      cp_async16_fill(st.Klo + PaddedRows<D>::at(r, c8), kv.k_lo + off, in ? 16 : 0);
  }
  for (int i = tid; i < B::BK * DV / 8; i += B::THREADS) {
    const int r = i / (DV / 8), c8 = (i % (DV / 8)) * 8;
    if (B::RAGGED && c8 >= kv.dv) continue;
    const bool in = r < n_in;
    const long long off = ((row0 + (in ? r : 0)) * Hkv + kvh) * bd.d() + kv.v0 + c8;
    cp_async16_fill(st.V + PaddedRows<DV>::at(r, c8), kv.v + off, in ? 16 : 0);
    if constexpr (B::SPLIT_KV)
      cp_async16_fill(st.Vlo + PaddedRows<DV>::at(r, c8), kv.v_lo + off, in ? 16 : 0);
  }
}

// rows [row0, row0 + BK) of one operand (rows of dh elements), columns
// [col0, col0 + n), into a slot's rows of W columns: 16-byte copies, or
// where rows are not on 16-byte boundaries narrow_piece's pieces of cw
// columns, a row's pieces on consecutive lanes (rows [n_in, BK)
// zero-filled, nothing read for them: key rows past Sk).  cw divides both
// dh and col0, so a piece is live or past n as a whole.
template <class B, int W>
__device__ void copy_cols(bf16* dst, const bf16* src, long long row0, int Hkv, int kvh,
                          int col0, int n, int tid, const B& bd, int n_in) {
  if (bd.whole()) {
    for (int i = tid; i < B::BK * W / 8; i += B::THREADS) {
      const int r = i / (W / 8), c8 = (i % (W / 8)) * 8;
      if (c8 >= n) continue;
      const bool in = r < n_in;
      const long long off = ((row0 + (in ? r : 0)) * Hkv + kvh) * bd.dh + col0 + c8;
      cp_async16_fill(dst + PaddedRows<W>::at(r, c8), src + off, in ? 16 : 0);
    }
    return;
  }
  const int lg = row_lanes_log2(n / bd.cw);
  for (int i = tid; i < (B::BK << lg); i += B::THREADS) {
    const int r = i >> lg;
    const bool in = r < n_in;
    const long long off = ((row0 + (in ? r : 0)) * Hkv + kvh) * bd.dh + col0;
    for (int c = (i & ((1 << lg) - 1)) * bd.cw; c < n; c += bd.cw << lg)
      narrow_piece(dst + PaddedRows<W>::at(r, c), src + off + c, bd.cw, in);
  }
}

// a DEEP build's unit: K's depth chunk [k0, k0 + dk) of rows [row0, row0
// + BK), and with the step's first chunk the slab's dv columns of V (and
// their low halves under OPS_F32)
template <class B>
__device__ void deep_rows(const Slot& st, const KV& kv_, long long row0, int Hkv, int kvh,
                          int tid, const B& bd, int n_in = B::BK) {
  const DeepKV& kv = deep_kv(kv_);
  copy_cols<B, B::D>(st.K, kv.k, row0, Hkv, kvh, kv.k0, kv.dk, tid, bd, n_in);
  if constexpr (B::SPLIT_KV)
    copy_cols<B, B::D>(st.Klo, kv.k_lo, row0, Hkv, kvh, kv.k0, kv.dk, tid, bd, n_in);
  if (kv.k0 == 0) {
    copy_cols<B, B::DV>(st.V, kv.v, row0, Hkv, kvh, kv.v0, kv.dv, tid, bd, n_in);
    if constexpr (B::SPLIT_KV)
      copy_cols<B, B::DV>(st.Vlo, kv.v_lo, row0, Hkv, kvh, kv.v0, kv.dv, tid, bd, n_in);
  }
}

template <class B>
__device__ void async_rows(const Slot& st, const KV& kv, long long row0, int Hkv, int kvh,
                           int tid, const B& bd) {
  constexpr int D = B::D;
  if constexpr (B::DEEP) {
    deep_rows(st, kv, row0, Hkv, kvh, tid, bd);
    return;
  }
  if (!bd.whole()) {
    narrow_rows(st, kv, row0, Hkv, kvh, tid, bd);
    return;
  }
  if constexpr (B::SLAB) {
    slab_rows(st, kv, row0, Hkv, kvh, tid, bd, B::BK);
    return;
  }
  for (int i = tid; i < B::BK * D / 8; i += B::THREADS) {
    const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
    if (!bd.col(c8)) continue;
    const long long off = ((row0 + r) * Hkv + kvh) * bd.d() + c8;
    cp_async16(st.K + PaddedRows<D>::at(r, c8), kv.k + off);
    cp_async16(st.V + PaddedRows<D>::at(r, c8), kv.v + off);
    if constexpr (B::SPLIT_KV) {
      cp_async16(st.Klo + PaddedRows<D>::at(r, c8), kv.k_lo + off);
      cp_async16(st.Vlo + PaddedRows<D>::at(r, c8), kv.v_lo + off);
    }
  }
}

// a SLAB build's int8 cold rows [row0, row0 + BK) of one operand: columns
// [col0, col0 + n) of rows of d bytes -> staging rows of W bytes, in 16-
// or 8-byte copies (rows on 16- or 8-byte boundaries) or in fetch's
// narrow pieces
template <class B, int W>
__device__ void cold_slab_rows(int8_t* dst, const int8_t* src, long long row0, int Hkv,
                               int kvh, int col0, int n, int tid, const B& bd) {
  if (bd.whole()) {
    constexpr int CH = B::RAGGED ? 8 : 16;
    for (int i = tid; i < B::BK * W / CH; i += B::THREADS) {
      const int r = i / (W / CH), c = (i % (W / CH)) * CH;
      if (B::RAGGED && c >= n) continue;
      const long long off = ((row0 + r) * Hkv + kvh) * bd.d() + col0 + c;
      if constexpr (CH == 16) cp_async16(dst + r * W + c, src + off);
      else cp_async8(dst + r * W + c, src + off);
    }
    return;
  }
  const int w = bd.dh % 4 == 0 ? 4 : bd.dh % 2 == 0 ? 2 : 1;
  const int lg = row_lanes_log2(bd.dh / w);
  for (int i = tid; i < (B::BK << lg); i += B::THREADS) {
    const int r = i >> lg;
    const long long off = ((row0 + r) * Hkv + kvh) * bd.dh + col0;
    for (int c = (i & ((1 << lg) - 1)) * w; c < n; c += w << lg) {
      if (w == 4) cp_async_ca<4>(dst + r * W + c, src + off + c);
      else if (w == 2)   // plain 2-byte loads (cp.async copies 4 bytes at least)
        *reinterpret_cast<uint16_t*>(dst + r * W + c) =
            *reinterpret_cast<const uint16_t*>(src + off + c);
      else dst[r * W + c] = src[off + c];
    }
  }
}

// a SLAB build's staged int8 rows of W bytes, n of them live, times s in
// f32 and rounded to the build's element type -> a slot's rows (a last
// chunk's columns from n on as zeros)
template <class B, int W>
__device__ void dequant_slab_rows(bf16* dst, const int8_t* src, float s, int n, int tid,
                                  const B& bd) {
  for (int i = tid; i < B::BK * W / 8; i += B::THREADS) {
    const int r = i / (W / 8), c8 = (i % (W / 8)) * 8;
    if (B::RAGGED && c8 >= n) continue;
    const uint2 raw = *reinterpret_cast<const uint2*>(src + r * W + c8);
    const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
    __align__(16) ET<B> o[8];
    const int m = bd.whole() ? 8 : min(8, n - c8);
    #pragma unroll
    for (int t = 0; t < 8; ++t) o[t] = cs_from_float<ET<B>>(t < m ? (float)e[t] * s : 0.f);
    *reinterpret_cast<uint4*>(dst + PaddedRows<W>::at(r, c8)) = *reinterpret_cast<const uint4*>(o);
  }
}

// an int8 cold group beside a bf16 (or f16) slab: page ids >= n_hot
// address cold page id - n_hot, dequantised int8 x scale[page, kv head] in
// f32 and rounded to the slab's type (the plain version's gathered value).
// A cold tile's bytes are copied into the slot's staging area (fetch) and
// widened into its 16-bit rows once they landed (finish).
struct ColdPages {
  const int8_t* k8;        // (n_cold * TILE, Hkv, d)
  const int8_t* v8;
  const float* k_scale;    // (n_cold, Hkv)
  const float* v_scale;
  int n_hot;

  // rows [c0, c0 + BK) of cold entry `entry` -> the slot's staging
  // bytes (rows of D bytes), in 16-byte copies (8-byte ones where a row is
  // not a multiple of 16 bytes: D 24, and any ragged d); a d that is not a
  // multiple of 8 in pieces of 4 bytes (cp.async) where d is a multiple
  // of 4, else of 2 or 1 bytes by plain loads
  // (SLAB: K's d bytes a row, and the slab's dv bytes of V into rows of
  // DV bytes)
  template <class B>
  __device__ void fetch(const Slot& st, const KV& kv, int entry, int c0, int Hkv, int kvh,
                        int tid, const B& bd) const {
    constexpr int D = B::D;
    constexpr int CH = !B::RAGGED && D % 16 == 0 ? 16 : 8;
    const long long row0 = (long long)(entry - n_hot) * TILE + c0;
    if constexpr (B::DEEP) {   // K's depth chunk; V's slab with the first
      const DeepKV& u = deep_kv(kv);
      cold_slab_rows<B, D>(st.K8, k8, row0, Hkv, kvh, u.k0, u.dk, tid, bd);
      if (u.k0 == 0) cold_slab_rows<B, B::DV>(st.V8, v8, row0, Hkv, kvh, u.v0, u.dv, tid, bd);
      return;
    }
    if constexpr (B::SLAB) {
      cold_slab_rows<B, D>(st.K8, k8, row0, Hkv, kvh, 0, bd.d(), tid, bd);
      cold_slab_rows<B, B::DV>(st.V8, v8, row0, Hkv, kvh, kv.v0, kv.dv, tid, bd);
      return;
    }
    if (!bd.whole()) {     // pieces of w bytes laid out as narrow_rows lays them
      const int w = bd.dh % 4 == 0 ? 4 : bd.dh % 2 == 0 ? 2 : 1;
      const int lg = row_lanes_log2(bd.dh / w);
      for (int i = tid; i < (B::BK << lg); i += B::THREADS) {
        const int r = i >> lg;
        const long long off = ((row0 + r) * Hkv + kvh) * bd.dh;
        for (int c = (i & ((1 << lg) - 1)) * w; c < bd.dh; c += w << lg) {
          int8_t* dk = st.K8 + r * D + c;
          int8_t* dv = st.V8 + r * D + c;
          if (w == 4) {
            cp_async_ca<4>(dk, k8 + off + c);
            cp_async_ca<4>(dv, v8 + off + c);
          } else if (w == 2) {   // plain 2-byte loads (cp.async copies 4 bytes at least)
            const uint16_t a = *reinterpret_cast<const uint16_t*>(k8 + off + c);
            const uint16_t b = *reinterpret_cast<const uint16_t*>(v8 + off + c);
            *reinterpret_cast<uint16_t*>(dk) = a;
            *reinterpret_cast<uint16_t*>(dv) = b;
          } else {
            const int8_t a = k8[off + c], b = v8[off + c];
            *dk = a;
            *dv = b;
          }
        }
      }
      return;
    }
    for (int i = tid; i < B::BK * D / CH; i += B::THREADS) {
      const int r = i / (D / CH), c = (i % (D / CH)) * CH;
      if (!bd.col(c)) continue;
      const long long off = ((row0 + r) * Hkv + kvh) * bd.d() + c;
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
  // tile into the slot's bf16 rows (a last chunk's columns from d on as
  // zeros, as K's must be); true if the caller must synchronise
  template <class B>
  __device__ bool finish(const Slot& st, const KV& kv, int entry, int Hkv, int kvh, int tid,
                         const B& bd) const {
    constexpr int D = B::D;
    if (entry < n_hot) return false;
    const int cp = entry - n_hot;
    const float ks = k_scale[cp * Hkv + kvh], vs = v_scale[cp * Hkv + kvh];
    if constexpr (B::DEEP) {   // K's depth chunk; V's slab with the last
      const DeepKV& u = deep_kv(kv);
      dequant_slab_rows<B, D>(st.K, st.K8, ks, u.dk, tid, bd);
      if (u.last) dequant_slab_rows<B, B::DV>(st.V, st.V8, vs, u.dv, tid, bd);
      return true;
    }
    if constexpr (B::SLAB) {
      dequant_slab_rows<B, D>(st.K, st.K8, ks, bd.d(), tid, bd);
      dequant_slab_rows<B, B::DV>(st.V, st.V8, vs, kv.dv, tid, bd);
      return true;
    }
    for (int i = tid; i < B::BK * D / 8; i += B::THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      if (!bd.col(c8)) continue;
      const uint2 rk = *reinterpret_cast<const uint2*>(st.K8 + r * D + c8);
      const uint2 rv = *reinterpret_cast<const uint2*>(st.V8 + r * D + c8);
      const int8_t* ek = reinterpret_cast<const int8_t*>(&rk);
      const int8_t* ev = reinterpret_cast<const int8_t*>(&rv);
      __align__(16) ET<B> ok[8], ov[8];
      const int n = bd.whole() ? 8 : bd.live(c8);
      #pragma unroll
      for (int t = 0; t < 8; ++t) {
        ok[t] = cs_from_float<ET<B>>(t < n ? (float)ek[t] * ks : 0.f);
        ov[t] = cs_from_float<ET<B>>(t < n ? (float)ev[t] * vs : 0.f);
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
  template <class B>
  __device__ bool finish_kv(const Slot&, const KV&, int, int, int, int, int, const B&) const {
    return false;
  }
};

// per-stream caches: tile j of stream b is rows b * Sk + j * TILE
struct Refresh : RefreshMask {
  template <class B>
  __device__ void fetch_kv(const Slot& st, const KV& kv, int b, int j, int c0, int Hkv,
                           int kvh, int tid, const B& bd) const {
    async_rows(st, kv, ((long long)b * n_tiles + j) * TILE + c0, Hkv, kvh, tid, bd);
  }
};

// batchless slab: tile j of stream b is physical page pt[b, j]
struct RefreshPaged : RefreshMask {
  const int* pt;           // (B, n_tiles) physical page per logical tile

  __device__ int page(int b, int j) const { return pt[b * n_tiles + j]; }
  template <class B>
  __device__ void fetch_kv(const Slot& st, const KV& kv, int b, int j, int c0, int Hkv,
                           int kvh, int tid, const B& bd) const {
    async_rows(st, kv, (long long)page(b, j) * TILE + c0, Hkv, kvh, tid, bd);
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
  template <class B>
  __device__ bool finish_kv(const Slot&, const KV&, int, int, int, int, int, const B&) const {
    return false;
  }
};

// per-stream K/V (B, Sk, Hkv, D), any Sk: key rows from Sk on (a ragged
// end) are zero-filled by the copy, which reads nothing for them
struct Prefill : PrefillMask {
  template <class B>
  __device__ void fetch_kv(const Slot& st, const KV& kv, int b, int j, int c0, int Hkv,
                           int kvh, int tid, const B& bd) const {
    constexpr int D = B::D;
    const int key0 = j * TILE + c0;
    if constexpr (B::DEEP) {
      deep_rows(st, kv, (long long)b * Sk + key0, Hkv, kvh, tid, bd, Sk - key0);
      return;
    }
    if (!bd.whole()) {
      narrow_rows(st, kv, (long long)b * Sk + key0, Hkv, kvh, tid, bd, Sk - key0);
      return;
    }
    if constexpr (B::SLAB) {
      slab_rows(st, kv, (long long)b * Sk + key0, Hkv, kvh, tid, bd, Sk - key0);
      return;
    }
    for (int i = tid; i < B::BK * D / 8; i += B::THREADS) {
      const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
      if (!bd.col(c8)) continue;
      const bool in = key0 + r < Sk;
      const long long off = (((long long)b * Sk + (in ? key0 + r : 0)) * Hkv + kvh) * bd.d() + c8;
      cp_async16_fill(st.K + PaddedRows<D>::at(r, c8), kv.k + off, in ? 16 : 0);
      cp_async16_fill(st.V + PaddedRows<D>::at(r, c8), kv.v + off, in ? 16 : 0);
      if constexpr (B::SPLIT_KV) {
        cp_async16_fill(st.Klo + PaddedRows<D>::at(r, c8), kv.k_lo + off, in ? 16 : 0);
        cp_async16_fill(st.Vlo + PaddedRows<D>::at(r, c8), kv.v_lo + off, in ? 16 : 0);
      }
    }
  }
};

// batchless slab through the page table; Sk = n_pages * TILE
struct PrefillPaged : PrefillMask {
  const int* pt;           // (B, n_k_tiles) physical page per logical tile

  __device__ int page(int b, int j) const { return pt[b * n_k_tiles + j]; }
  template <class B>
  __device__ void fetch_kv(const Slot& st, const KV& kv, int b, int j, int c0, int Hkv,
                           int kvh, int tid, const B& bd) const {
    async_rows(st, kv, (long long)page(b, j) * TILE + c0, Hkv, kvh, tid, bd);
  }
};

// two-precision slab: entries >= n_hot are int8 cold pages.  A hot tile
// takes the bf16 path; a cold tile goes through ColdPages' staging copy
// and dequantisation.
template <class Paged>
struct WithColdPages : Paged {
  static constexpr bool COLD = true;
  ColdPages cold;

  template <class B>
  __device__ void fetch_kv(const Slot& st, const KV& kv, int b, int j, int c0, int Hkv,
                           int kvh, int tid, const B& bd) const {
    const int entry = this->page(b, j);
    if (entry < cold.n_hot)
      async_rows(st, kv, (long long)entry * TILE + c0, Hkv, kvh, tid, bd);
    else
      cold.fetch(st, kv, entry, c0, Hkv, kvh, tid, bd);
  }
  template <class B>
  __device__ bool finish_kv(const Slot& st, const KV& kv, int b, int j, int Hkv, int kvh,
                            int tid, const B& bd) const {
    return cold.finish(st, kv, this->page(b, j), Hkv, kvh, tid, bd);
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
  template <class B>
  __device__ void fetch_kv(const Slot& st, const KV& kv, int b, int j, int c0, int Hkv,
                           int kvh, int tid, const B& bd) const {
    async_rows(st, kv, (long long)b * L + j * TILE + c0, Hkv, kvh, tid, bd);
  }
  template <class B>
  __device__ bool finish_kv(const Slot&, const KV&, int, int, int, int, int, const B&) const {
    return false;
  }
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

// which operands enter the products as two halves (see the header)
template <class B, class P>
struct Split {
  static constexpr bool kv = B::SPLIT_KV;                          // K's and V's halves
  static constexpr bool q = kv || (!B::HALF && P::EXACT);          // Q's
  static constexpr bool p = kv || P::EXACT;                         // P's
  // Q's rows scaled by a power of two each (f16 halves of a bf16 or f32
  // query: OPS_Q16), undone on S's exponent factor
  static constexpr bool rows = B::OPS == OPS_Q16 && P::EXACT;
};

// the q types build B takes over problem P (a mask of 1 << Q_*): its
// products are K's type's, q's type changes only Q's staging and the
// output's store (see the header)
template <class B, class P>
__host__ __device__ constexpr int q_types() {
  if constexpr (B::OPS == OPS_BF16) return 1 << Q_BF16;
  else if constexpr (B::OPS == OPS_Q32) return 1 << Q_F32 | 1 << Q_F16;
  else if constexpr (B::OPS == OPS_Q16) return 1 << Q_F32 | 1 << Q_BF16;
  else if constexpr (B::OPS == OPS_F16) return P::EXACT ? 1 << Q_F16 : 7;
  else return 7;   // OPS_F32
}

// q's type at run time among the mask TYPES: each test folds to a
// constant where TYPES leaves one answer (a build of one q type compiles
// its loads and stores as before).  Offsets are in elements of q's type.
template <int TYPES>
struct QType {
  int qt;
  __device__ __forceinline__ bool f32() const {
    return (TYPES >> Q_F32 & 1) && (TYPES == 1 << Q_F32 || qt == Q_F32);
  }
  // of the 16-bit types, f16 (else bf16)
  __device__ __forceinline__ bool f16() const {
    return (TYPES >> Q_F16 & 1) && (!(TYPES >> Q_BF16 & 1) || qt == Q_F16);
  }
  __device__ __forceinline__ int size() const { return f32() ? 4 : 2; }
  __device__ __forceinline__ float load(const void* p, long long i) const {
    if (f32()) return static_cast<const float*>(p)[i];
    if (f16()) return __half2float(static_cast<const __half*>(p)[i]);
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
  }
  // 8 elements from i, on a 16-byte boundary
  __device__ __forceinline__ void load8(float (&x)[8], const void* p, long long i) const {
    if (f32()) {
      const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
      const float4 a = f[0], c = f[1];
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
      x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
      return;
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(p) + i);
    #pragma unroll
    for (int t = 0; t < 8; ++t)
      x[t] = f16() ? __half2float(reinterpret_cast<const __half*>(&raw)[t])
                   : __bfloat162float(reinterpret_cast<const bf16*>(&raw)[t]);
  }
  __device__ __forceinline__ void store(void* p, long long i, float v) const {
    if (f32()) static_cast<float*>(p)[i] = v;
    else if (f16()) static_cast<__half*>(p)[i] = __float2half_rn(v);
    else static_cast<bf16*>(p)[i] = __float2bfloat16_rn(v);
  }
  // elements i and i + 1, on an 8- (f32) or 4-byte boundary
  __device__ __forceinline__ void store2(void* p, long long i, float a, float b) const {
    if (f32()) *reinterpret_cast<float2*>(static_cast<float*>(p) + i) = make_float2(a, b);
    else *reinterpret_cast<uint32_t*>(static_cast<bf16*>(p) + i) =
        f16() ? pack2<__half>(a, b) : pack2<bf16>(a, b);
  }
  // 8 zeros from i, on a 16-byte boundary
  __device__ __forceinline__ void zero8(void* p, long long i) const {
    uint4* o = reinterpret_cast<uint4*>(static_cast<unsigned char*>(p) + i * size());
    o[0] = make_uint4(0, 0, 0, 0);
    if (f32()) o[1] = make_uint4(0, 0, 0, 0);
  }
};

// OPS_Q16's row factor: the power of two 2^e that brings a row's largest
// |q| into [2^14, 2^15), where its f16 halves hold about 22 bits of every
// element (e within +-100; 1 for a row of zeros, or one holding an inf or
// a NaN, which the products carry to S as the oracle's f32 does)
__device__ __forceinline__ float row_factor(float mx) {
  if (!(mx > 0.f) || !isfinite(mx)) return 1.f;
  return ldexpf(1.f, min(max(ilogbf(mx) - 14, -100), 100));
}

// the largest |x| of a warp's values, in every lane
__device__ __forceinline__ float warp_max(float x) {
  #pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <class B, class P>
struct MmaSmem {
  static constexpr int D = B::D, DV = B::DV;
  static constexpr int LDQ = PaddedRows<D>::LDH;   // padded query rows (ldmatrix)
  // two stages at D 256 and 512 (a bf16 block's 101 KB at D 256 lets two
  // blocks share an SM) and for OPS_F32 at D 128
  static constexpr int STAGES = B::WIDE || (B::SPLIT_KV && D == 128) ? 2 : 3;
  static constexpr size_t slot_kv = sizeof(bf16) * B::BK * PaddedRows<D>::LDH;  // a K slot
  static constexpr size_t slot_v = sizeof(bf16) * B::BK * PaddedRows<DV>::LDH;  // a V slot
  static constexpr size_t slot_lo = B::SPLIT_KV ? slot_kv : 0;      // K and V low halves
  static constexpr size_t slot_vlo = B::SPLIT_KV ? slot_v : 0;
  static constexpr size_t slot_ki = P::KEY_BITS ? B::BK : 0;    // kv_valid bytes
  static constexpr size_t slot_i8 = P::COLD ? B::BK * D : 0;
  static constexpr size_t slot_v8 = P::COLD ? B::BK * DV : 0;
  // Q's rows (DEEP: a depth chunk of them a ring slot)
  static constexpr int QBUF = B::DEEP ? STAGES : 1;
  static constexpr size_t q_bytes = sizeof(bf16) * B::QROWS * LDQ;
  static constexpr size_t q = 0;
  static constexpr size_t qlo = q + QBUF * q_bytes;               // Q's low half
  static constexpr size_t k = qlo + (Split<B, P>::q ? QBUF * q_bytes : 0);
  static constexpr size_t v = k + STAGES * slot_kv;
  static constexpr size_t klo = v + STAGES * slot_v;
  static constexpr size_t vlo = klo + STAGES * slot_lo;
  static constexpr size_t ki = vlo + STAGES * slot_vlo;
  static constexpr size_t k8 = ki + ((STAGES * slot_ki + 15) / 16) * 16;
  static constexpr size_t v8 = k8 + STAGES * slot_i8;
  // Q16's row factors (its DEEP build reads them from the pre-pass's scratch)
  static constexpr size_t rf = v8 + STAGES * slot_v8;
  static constexpr size_t bytes = rf + (Split<B, P>::rows && !B::DEEP ? 4 * B::QROWS : 0);
  static_assert(bytes <= 232448, "an H100 block has 227 KB of shared memory");
};

template <class B, class P>
__global__ void __launch_bounds__(B::THREADS, 1)
mma_kernel(const void* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, void* __restrict__ out, int Sq, int H,
           int Hkv, float scale, P prob, B bd, const bf16* __restrict__ k_lo,
           const bf16* __restrict__ v_lo) {
  using L = MmaSmem<B, P>;
  using S = Split<B, P>;
  constexpr int D = B::D, DV = B::DV;
  constexpr int THREADS = B::THREADS, BK = B::BK, QROWS = B::QROWS;
  constexpr int LDQ = L::LDQ, STAGES = L::STAGES;
  constexpr int SPT = TILE / BK;         // steps per visited tile
  constexpr int NT = BK / 8;             // n8 tiles of S per step
  constexpr int DK = PaddedRows<D>::DK;  // Q K^T's depth: D, or D 24 zero-padded to 32
  constexpr int DT = DV / 8;             // n8 tiles of O (odd at D 24)
  constexpr int KC = DK / 16;            // k16 chunks of Q K^T
  constexpr int KI_COPIES = BK / 16;
  const QType<q_types<B, P>()> QT{bd.qt};
  constexpr bool F16 = B::F16;
  using E = ET<B>;
  // the query's fragments stay in registers, unless they are split or the
  // build is WIDE: then each k16 step loads them from shared memory
  constexpr bool Q_REGS = !S::q && !B::WIDE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::q);
  bf16* Qlo = reinterpret_cast<bf16*>(smem + L::qlo);
  uint8_t* Ki = reinterpret_cast<uint8_t*>(smem + L::ki);
  auto slot = [&](int i) {
    return Slot{reinterpret_cast<bf16*>(smem + L::k + i * L::slot_kv),
                reinterpret_cast<bf16*>(smem + L::v + i * L::slot_v),
                reinterpret_cast<int8_t*>(smem + L::k8 + i * L::slot_i8),
                reinterpret_cast<int8_t*>(smem + L::v8 + i * L::slot_v8),
                reinterpret_cast<bf16*>(smem + L::klo + i * L::slot_lo),
                reinterpret_cast<bf16*>(smem + L::vlo + i * L::slot_vlo)};
  };
  // the query's factor before QK^T, and the scores' factor in exp(x - m) =
  // 2^(x c - m c): the refresh oracle scales the query, EXACT the scores
  const float qscale = P::EXACT ? 1.f : scale;
  const float c2 = P::EXACT ? scale * LOG2E : LOG2E;

  // the block's QROWS query rows from q0, in map tile iq (whose visit list
  // it walks: a WIDE block owns half of it), and (SLAB) its slab of V and
  // O: columns [v0, v0 + dv)
  const int bq = prob.q_tile(blockIdx.x), h = blockIdx.y / slab_count<B>(bd.dh), b = blockIdx.z;
  const int iq = bq / (TILE / QROWS);
  const int q0 = bq * QROWS;
  const int kvh = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int d = bd.d();
  const int v0 = (blockIdx.y % slab_count<B>(bd.dh)) * DV;
  if (B::SLAB && v0 >= d) return;       // a slab past a ragged d (f32 query: 128 columns)
  const int dv = B::SLAB ? min(DV, d - v0) : d;
  const KV kv{k, v, k_lo, v_lo, v0, dv};
  const long long q_stride = (long long)H * d;   // between query rows
  // the block's first query row and output element (QT's element offsets)
  const long long qb = ((long long)b * Sq + q0) * q_stride + (long long)h * d;
  const long long ob = qb + v0;
  // whether O's columns [c8, c8 + 8) of the block hold data, and how many
  auto o_col = [&](int c8) { return B::SLAB ? !B::RAGGED || c8 < dv : bd.col(c8); };
  auto o_live = [&](int c8) { return B::SLAB ? (B::RAGGED ? min(8, dv - c8) : 8) : bd.live(c8); };

  // rows that no key can reach (padding) are exact zeros: a block with no
  // live row skips the loop; rows from Sq on are neither read nor written
  const int n_rows = min(QROWS, Sq - q0);
  const int live = tid < n_rows ? prob.q_live(prob.q_info(b, q0 + tid)) : 0;
  if (!__syncthreads_or(live)) {
    for (int i = tid; i < n_rows * DV / 8; i += THREADS) {
      const int c8 = (i % (DV / 8)) * 8;
      if (!o_col(c8)) continue;
      const long long orow = ob + (i / (DV / 8)) * q_stride + c8;
      if (!bd.whole()) {   // rows not on 16-byte boundaries: element by element
        for (int t = 0; t < o_live(c8); ++t) QT.store(out, orow + t, 0.f);
        continue;
      }
      QT.zero8(out, orow);
    }
    return;
  }

  // the ring: step s = visited tile s / SPT, keys (s % SPT) * BK.., in
  // slot s % STAGES; one commit group per step (empty past the end).
  // DEEP: fetch(u) brings unit u = step s x nc + chunk c (nc = ceil(d / D))
  // into ring slot u % STAGES, Q's and K's depth chunk c of D columns, and
  // with c = 0 the step's V slab and kv_valid bytes into slot s % STAGES
  // (STAGES is 2); Q from the pre-pass's rows of dq columns (q_deep_kernel:
  // scaled, split and zero-padded bf16)
  const auto tiles = prob.visits(b, iq);
  const int n_steps = tiles.n * SPT;
  auto fetch = [&](int s) {
    if constexpr (B::DEEP) {
      const int nc = (d + D - 1) / D, u = s;
      if (u < n_steps * nc) {
        s = u / nc;
        const int c = u - s * nc;
        const int j = prob.tile(tiles, s / SPT), c0 = (s % SPT) * BK;
        const int k0 = c * D, dk = min(D, d - k0), dkq = (dk + 15) / 16 * 16;
        const int dq = (d + 15) / 16 * 16;
        const long long q_rows = (long long)H * dq;        // between query rows
        const bf16* qd = static_cast<const bf16*>(q) + ((long long)b * Sq + q0) * q_rows +
                         (long long)h * dq + k0;
        [[maybe_unused]] const bf16* qd_lo = qd + (long long)gridDim.z * Sq * q_rows;
        bf16* Qd = Qs + (u % STAGES) * QROWS * LDQ;
        [[maybe_unused]] bf16* Qd_lo = Qlo + (u % STAGES) * QROWS * LDQ;
        for (int i = tid; i < QROWS * D / 8; i += THREADS) {
          const int r = i / (D / 8), c8 = (i % (D / 8)) * 8;
          if (c8 >= dkq) continue;
          const bool in = r < n_rows;
          const long long off = (in ? r : 0) * q_rows + c8;
          cp_async16_fill(Qd + r * LDQ + c8, qd + off, in ? 16 : 0);
          if constexpr (S::q) cp_async16_fill(Qd_lo + r * LDQ + c8, qd_lo + off, in ? 16 : 0);
        }
        const Slot ring = slot(u % STAGES), vs = slot(s % STAGES);
        const DeepKV kvu{{k, v, k_lo, v_lo, v0, dv}, k0, dk, c == nc - 1};
        prob.fetch_kv(Slot{ring.K, vs.V, ring.K8, vs.V8, ring.Klo, vs.Vlo}, kvu, b, j, c0, Hkv,
                      kvh, tid, bd);
        if constexpr (P::KEY_BITS) {
          if (c == 0 && tid < KI_COPIES)
            cp_async16(Ki + (s % STAGES) * BK + tid * 16, prob.k_info_row(b, j) + c0 + tid * 16);
        }
      }
    } else if (s < n_steps) {
      const int j = prob.tile(tiles, s / SPT), c0 = (s % SPT) * BK;
      prob.fetch_kv(slot(s % STAGES), kv, b, j, c0, Hkv, kvh, tid, bd);
      if constexpr (P::KEY_BITS) {
        if (tid < KI_COPIES)
          cp_async16(Ki + (s % STAGES) * BK + tid * 16, prob.k_info_row(b, j) + c0 + tid * 16);
      }
    }
    cp_async_commit();
  };
  if constexpr (B::DEEP) {
    // K's ring (and its low halves) zeroed once: the products of a last
    // chunk's k16 step read columns [dk, 16) of it against Q's zeros
    for (int i = tid; i < STAGES * BK * (DK / 8); i += THREADS) {
      const int r = i / (DK / 8), c8 = (i % (DK / 8)) * 8;
      const Slot st = slot(r / BK);
      *reinterpret_cast<uint4*>(st.K + PaddedRows<D>::at(r % BK, c8)) = make_uint4(0, 0, 0, 0);
      if constexpr (S::kv)
        *reinterpret_cast<uint4*>(st.Klo + PaddedRows<D>::at(r % BK, c8)) = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    #pragma unroll
    for (int u = 0; u < STAGES - 1; ++u) fetch(u);
  } else {
    // K's columns [d, DK), which Q K^T's last k16 steps read against Q's
    // zeros, are zeros too: the copies never write them (garbage there could
    // be a NaN, and 0 x NaN would reach a score).  V's columns from d on
    // reach only output columns that are not stored.  A chunk that holds
    // column d keeps its live columns for the copies (other bytes: no race).
    if constexpr (B::RAGGED) {
      for (int i = tid; i < STAGES * BK * (DK / 8); i += THREADS) {
        const int r = i / (DK / 8), c8 = (i % (DK / 8)) * 8;
        if (c8 + 8 <= d) continue;
        const Slot st = slot(r / BK);
        bf16* kz = st.K + PaddedRows<D>::at(r % BK, c8);
        [[maybe_unused]] bf16* kl = st.Klo + PaddedRows<D>::at(r % BK, c8);
        if (c8 < d) {
          for (int t = d - c8; t < 8; ++t) {
            kz[t] = __float2bfloat16_rn(0.f);
            if constexpr (S::kv) kl[t] = __float2bfloat16_rn(0.f);
          }
          continue;
        }
        *reinterpret_cast<uint4*>(kz) = make_uint4(0, 0, 0, 0);
        if constexpr (S::kv) *reinterpret_cast<uint4*>(kl) = make_uint4(0, 0, 0, 0);
      }
    } else if constexpr (DK > D) {
      for (int i = tid; i < STAGES * BK; i += THREADS)
        *reinterpret_cast<uint4*>(slot(i / BK).K + PaddedRows<D>::at(i % BK, D)) =
            make_uint4(0, 0, 0, 0);
    }
    #pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fetch(s);
  }
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

  // S's factors of this thread's rows (Q16: each row's 2^e, row_factor)
  [[maybe_unused]] float rf0 = 1.f, rf1 = 1.f;
  if constexpr (!B::DEEP) {
    // chunk i of Q's rows (row i / (DK / 8), 8 columns) in f32, zeros past d
    auto q_chunk = [&](int i, float (&x)[8]) {
      const int r = i / (DK / 8), c8 = (i % (DK / 8)) * 8;
      const bool in = r < n_rows && c8 < D && bd.col(c8);
      if (!bd.whole()) {   // rows not on 16-byte boundaries: element by element
        #pragma unroll
        for (int t = 0; t < 8; ++t)
          x[t] = in && c8 + t < d ? QT.load(q, qb + r * q_stride + c8 + t) : 0.f;
      } else if (QT.f32()) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
        if (in) {
          const float4* f = reinterpret_cast<const float4*>(static_cast<const float*>(q) + qb +
                                                             r * q_stride + c8);
          a = f[0];
          c = f[1];
        }
        x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
        x[4] = c.x; x[5] = c.y; x[6] = c.z; x[7] = c.w;
      } else {
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (in) raw = *reinterpret_cast<const uint4*>(static_cast<const bf16*>(q) + qb +
                                                      r * q_stride + c8);
        #pragma unroll
        for (int t = 0; t < 8; ++t)
          x[t] = QT.f16() ? __half2float(reinterpret_cast<const __half*>(&raw)[t])
                          : __bfloat162float(reinterpret_cast<const bf16*>(&raw)[t]);
      }
    };
    [[maybe_unused]] float* Rf = reinterpret_cast<float*>(smem + L::rf);
    if constexpr (S::rows) {
      // each row's largest |q| (a non-negative f32's bits order as an
      // unsigned int's), read as the staging below reads Q; then its factor
      unsigned* Rm = reinterpret_cast<unsigned*>(Rf);
      for (int r = tid; r < QROWS; r += THREADS) Rm[r] = 0u;
      __syncthreads();
      for (int i = tid; i < QROWS * DK / 8; i += THREADS) {
        float x[8], mx = 0.f;
        q_chunk(i, x);
        #pragma unroll
        for (int t = 0; t < 8; ++t) mx = fmaxf(mx, fabsf(x[t]));
        if (mx > 0.f) atomicMax(Rm + i / (DK / 8), __float_as_uint(mx));
      }
      __syncthreads();
      for (int r = tid; r < QROWS; r += THREADS) Rf[r] = row_factor(__uint_as_float(Rm[r]));
      __syncthreads();
    }
    // Q in q's type, times qscale in f32 (Q16: over its row's factor) and
    // rounded to bf16 or f16 (split: and the rest, to its low half), while
    // the first tiles are in flight (columns [d, DK) zeros); then each
    // warp's fragments, unless they are split or WIDE (loaded each step)
    for (int i = tid; i < QROWS * DK / 8; i += THREADS) {
      const int r = i / (DK / 8), c8 = (i % (DK / 8)) * 8;
      float x[8];
      q_chunk(i, x);
      float qs = qscale;
      if constexpr (S::rows) qs = 1.f / Rf[r];     // a power of two: exact
      __align__(16) E hi[8], lo[8];
      #pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xs = x[t] * qs;
        hi[t] = cs_from_float<E>(xs);
        if constexpr (S::q) lo[t] = cs_from_float<E>(xs - cs_to_float(hi[t]));
      }
      *reinterpret_cast<uint4*>(Qs + r * LDQ + c8) = *reinterpret_cast<const uint4*>(hi);
      if constexpr (S::q)
        *reinterpret_cast<uint4*>(Qlo + r * LDQ + c8) = *reinterpret_cast<const uint4*>(lo);
    }
    __syncthreads();
    if constexpr (S::rows) {
      rf0 = Rf[r0];
      rf1 = Rf[r1];
    }
  } else if constexpr (S::rows) {   // the pre-pass's factors, after Q's two halves
    const int dq = (d + 15) / 16 * 16;
    const long long rows = (long long)gridDim.z * Sq * H;
    const float* qf = reinterpret_cast<const float*>(static_cast<const bf16*>(q) + 2 * rows * dq);
    if (r0 < n_rows) rf0 = qf[((long long)b * Sq + q0 + r0) * H + h];
    if (r1 < n_rows) rf1 = qf[((long long)b * Sq + q0 + r1) * H + h];
  }
  uint32_t qf[Q_REGS ? KC : 1][4];
  if constexpr (Q_REGS) {
    #pragma unroll
    for (int kc = 0; kc < KC; ++kc)
      ldsm_x4(qf[kc], Qs + (warp * 16 + (lane & 15)) * LDQ + kc * 16 + (lane >> 4) * 8);
  }

  float o[DT * 4];
  #pragma unroll
  for (int i = 0; i < DT * 4; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;   // l: this thread's columns

  for (int s = 0; s < n_steps; ++s) {
    float sc[NT * 4];
    int j, c0;
    Slot st;
    if constexpr (B::DEEP) {
      // S = sum over the depth chunks c of Q_c K_c^T: unit s x nc + c
      // brings chunk c of Q's rows and of the step's keys (and with c = 0
      // the step's V slab); a last chunk of dk columns runs ceil(dk / 16)
      // k16 steps (Q's columns past d are the pre-pass's zeros)
      j = prob.tile(tiles, s / SPT);
      c0 = (s % SPT) * BK;
      #pragma unroll
      for (int i = 0; i < NT * 4; ++i) sc[i] = 0.f;
      const int nc = (d + D - 1) / D;
      for (int c = 0; c < nc; ++c) {
        const int u = s * nc + c;
        cp_async_wait<STAGES - 2>();
        __syncthreads();           // unit u landed; unit u - 1's slot is free
        fetch(u + STAGES - 1);
        const int k0 = c * D, dk = min(D, d - k0);
        const Slot ring = slot(u % STAGES), vs = slot(s % STAGES);
        st = Slot{ring.K, vs.V, ring.K8, vs.V8, ring.Klo, vs.Vlo};
        const DeepKV kvu{{k, v, k_lo, v_lo, v0, dv}, k0, dk, c == nc - 1};
        if (prob.finish_kv(st, kvu, b, j, Hkv, kvh, tid, bd)) __syncthreads();
        if (!compute) continue;
        const bf16* Qc = Qs + (u % STAGES) * QROWS * LDQ;
        [[maybe_unused]] const bf16* Qc_lo = Qlo + (u % STAGES) * QROWS * LDQ;
        const int kcs = (dk + 15) / 16;
        #pragma unroll
        for (int kc = 0; kc < KC; ++kc) {
          if (kc < kcs) {
            uint32_t qh[4];
            [[maybe_unused]] uint32_t ql[4];
            ldsm_x4(qh, Qc + (warp * 16 + (lane & 15)) * LDQ + kc * 16 + (lane >> 4) * 8);
            if constexpr (S::q)
              ldsm_x4(ql, Qc_lo + (warp * 16 + (lane & 15)) * LDQ + kc * 16 + (lane >> 4) * 8);
            #pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
              const int kcol = kc * 16 + ((lane >> 3) & 1) * 8;
              uint32_t kb[4];
              ldsm_x4(kb, st.K + PaddedRows<D>::at(kr, kcol));
              mma16816<F16>(sc + 8 * np, qh, kb[0], kb[1]);
              mma16816<F16>(sc + 8 * np + 4, qh, kb[2], kb[3]);
              if constexpr (S::q) {
                mma16816<F16>(sc + 8 * np, ql, kb[0], kb[1]);
                mma16816<F16>(sc + 8 * np + 4, ql, kb[2], kb[3]);
              }
              if constexpr (S::kv) {
                ldsm_x4(kb, st.Klo + PaddedRows<D>::at(kr, kcol));
                mma16816<F16>(sc + 8 * np, qh, kb[0], kb[1]);
                mma16816<F16>(sc + 8 * np + 4, qh, kb[2], kb[3]);
              }
            }
          }
        }
      }
      if (!compute) continue;
    } else {
      cp_async_wait<STAGES - 2>();
      __syncthreads();             // step s landed; step s - 1's slot is free
      fetch(s + STAGES - 1);
      j = prob.tile(tiles, s / SPT);
      c0 = (s % SPT) * BK;
      st = slot(s % STAGES);
      if (prob.finish_kv(st, kv, b, j, Hkv, kvh, tid, bd)) __syncthreads();
      if (!compute) continue;

      // S = Q K^T (16 rows x BK keys per warp); split: hi K + lo K (+ hi
      // K_lo)
      #pragma unroll
      for (int i = 0; i < NT * 4; ++i) sc[i] = 0.f;
      #pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if constexpr (!Q_REGS) {
          uint32_t qh[4];
          [[maybe_unused]] uint32_t ql[4];
          ldsm_x4(qh, Qs + (warp * 16 + (lane & 15)) * LDQ + kc * 16 + (lane >> 4) * 8);
          if constexpr (S::q)
            ldsm_x4(ql, Qlo + (warp * 16 + (lane & 15)) * LDQ + kc * 16 + (lane >> 4) * 8);
          #pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            const int kr = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int kcol = kc * 16 + ((lane >> 3) & 1) * 8;
            uint32_t kb[4];
            ldsm_x4(kb, st.K + PaddedRows<D>::at(kr, kcol));
            mma16816<F16>(sc + 8 * np, qh, kb[0], kb[1]);
            mma16816<F16>(sc + 8 * np + 4, qh, kb[2], kb[3]);
            if constexpr (S::q) {
              mma16816<F16>(sc + 8 * np, ql, kb[0], kb[1]);
              mma16816<F16>(sc + 8 * np + 4, ql, kb[2], kb[3]);
            }
            if constexpr (S::kv) {
              ldsm_x4(kb, st.Klo + PaddedRows<D>::at(kr, kcol));
              mma16816<F16>(sc + 8 * np, qh, kb[0], kb[1]);
              mma16816<F16>(sc + 8 * np + 4, qh, kb[2], kb[3]);
            }
          }
        } else {
          #pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t kb[4];
            ldsm_x4(kb, st.K + PaddedRows<D>::at(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                                 kc * 16 + ((lane >> 3) & 1) * 8));
            mma16816<F16>(sc + 8 * np, qf[kc], kb[0], kb[1]);
            mma16816<F16>(sc + 8 * np + 4, qf[kc], kb[2], kb[3]);
          }
        }
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
      const uint8_t* kin = Ki + (s % STAGES) * BK;
      if constexpr (BK == 64)
        live_keys = ((uint64_t)__ballot_sync(0xffffffffu, prob.k_live(kin[lane + 32])) << 32 |
                     __ballot_sync(0xffffffffu, prob.k_live(kin[lane]))) >> (2 * t4);
      else if constexpr (BK == 32)
        live_keys = (uint64_t)__ballot_sync(0xffffffffu, prob.k_live(kin[lane])) >> (2 * t4);
      else     // 16-key steps: lanes 16-31 hold no key
        live_keys = (uint64_t)__ballot_sync(0xffffffffu, lane < BK && prob.k_live(kin[lane]))
                    >> (2 * t4);
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
    // (Q16: S's rows are 2^-e of the scores, so their factors carry 2^e)
    const float c20 = S::rows ? c2 * rf0 : c2, c21 = S::rows ? c2 * rf1 : c2;
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float ms0 = mn0 == -INFINITY ? 0.f : __fmul_rn(mn0, c20);
    const float ms1 = mn1 == -INFINITY ? 0.f : __fmul_rn(mn1, c21);
    const float corr0 = ex2(__fmul_rn(m0, c20) - ms0);
    const float corr1 = ex2(__fmul_rn(m1, c21) - ms1);
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
      x[0] = ex2(fmaf(x[0], c20, -ms0));
      x[1] = ex2(fmaf(x[1], c20, -ms0));
      x[2] = ex2(fmaf(x[2], c21, -ms1));
      x[3] = ex2(fmaf(x[3], c21, -ms1));
      sum0 += x[0] + x[1];
      sum1 += x[2] + x[3];
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;

    // O += P V: the S accumulator of n8 tiles 2kk, 2kk + 1 is P's A
    // fragment for keys 16kk.., rounded to bf16 (f16)
    uint32_t pa[BK / 16][4];
    #pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack2<E>(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack2<E>(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack2<E>(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack2<E>(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    #pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // split P: its second half for the same keys, lo = bf16(p - hi) (hi
      // widened by integer ops: unpack_p2; f16: lo = f16(p - hi), which
      // p <= 1 leaves within f16's subnormal step 2^-24 of p - hi)
      [[maybe_unused]] uint32_t pl[4];
      if constexpr (S::p) {
        #pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 h = unpack_p2<E>(pa[kk][i]);
          pl[i] = pack2<E>(sc[8 * kk + 2 * i] - h.x, sc[8 * kk + 2 * i + 1] - h.y);
        }
      }
      #pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int vcol = dp * 16 + (lane >> 4) * 8;
        uint32_t vb[4];
        ldsm_x4_t(vb, st.V + PaddedRows<DV>::at(vr, vcol));
        mma16816<F16>(o + 8 * dp, pa[kk], vb[0], vb[1]);
        mma16816<F16>(o + 8 * dp + 4, pa[kk], vb[2], vb[3]);
        if constexpr (S::p) {
          mma16816<F16>(o + 8 * dp, pl, vb[0], vb[1]);
          mma16816<F16>(o + 8 * dp + 4, pl, vb[2], vb[3]);
        }
        if constexpr (S::kv) {
          ldsm_x4_t(vb, st.Vlo + PaddedRows<DV>::at(vr, vcol));
          mma16816<F16>(o + 8 * dp, pa[kk], vb[0], vb[1]);
          mma16816<F16>(o + 8 * dp + 4, pa[kk], vb[2], vb[3]);
        }
      }
      if constexpr (DT % 2 == 1) {   // D 24: the last n8 tile of O alone
        const int vr = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t vb[2];
        ldsm_x2_t(vb, st.V + PaddedRows<DV>::at(vr, (DT - 1) * 8));
        mma16816<F16>(o + 4 * (DT - 1), pa[kk], vb[0], vb[1]);
        if constexpr (S::p) mma16816<F16>(o + 4 * (DT - 1), pl, vb[0], vb[1]);
        if constexpr (S::kv) {
          ldsm_x2_t(vb, st.Vlo + PaddedRows<DV>::at(vr, (DT - 1) * 8));
          mma16816<F16>(o + 4 * (DT - 1), pa[kk], vb[0], vb[1]);
        }
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
    if (!o_col(dn * 8)) continue;
    if (!bd.whole()) {   // rows not on 16-byte boundaries: element by element, to column d
      if (c >= dv) continue;
      const bool pair = c + 1 < dv;
      if (r0 < n_rows) {
        QT.store(out, ob + r0 * q_stride + c, o[4 * dn] * inv0);
        if (pair) QT.store(out, ob + r0 * q_stride + c + 1, o[4 * dn + 1] * inv0);
      }
      if (r1 < n_rows) {
        QT.store(out, ob + r1 * q_stride + c, o[4 * dn + 2] * inv1);
        if (pair) QT.store(out, ob + r1 * q_stride + c + 1, o[4 * dn + 3] * inv1);
      }
      continue;
    }
    if (r0 < n_rows) QT.store2(out, ob + r0 * q_stride + c, o[4 * dn] * inv0, o[4 * dn + 1] * inv0);
    if (r1 < n_rows)
      QT.store2(out, ob + r1 * q_stride + c, o[4 * dn + 2] * inv1, o[4 * dn + 3] * inv1);
  }
}

// the DEEP build's pre-pass: rows of d q elements (bf16, f16 or f32) ->
// rows of dq E (bf16, or f16 for an f16 build; d rounded up to Q K^T's k16
// step), hi = E(x * qscale) and, where lo is given, lo = E(x * qscale -
// hi), as the body's Q staging rounds them; columns [d, dq) zeros.  A
// thread per 8 output columns.
template <class T, class E>
__global__ void q_deep_kernel(const T* __restrict__ q, E* __restrict__ hi,
                              E* __restrict__ lo, long long rows, int d, int dq,
                              float qscale) {
  const long long n = rows * (dq / 8);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / (dq / 8);
    const int c8 = (int)(i % (dq / 8)) * 8;
    __align__(16) E h[8], l[8];
    #pragma unroll
    for (int t = 0; t < 8; ++t) {
      const float xs = c8 + t < d ? cs_to_float(q[r * d + c8 + t]) * qscale : 0.f;
      h[t] = cs_from_float<E>(xs);
      l[t] = cs_from_float<E>(xs - cs_to_float(h[t]));
    }
    *reinterpret_cast<uint4*>(hi + r * dq + c8) = *reinterpret_cast<const uint4*>(h);
    if (lo != nullptr)
      *reinterpret_cast<uint4*>(lo + r * dq + c8) = *reinterpret_cast<const uint4*>(l);
  }
}

// OPS_Q16's pre-pass (prefill, DEEP): each row of d q elements (bf16 or
// f32) over its row_factor f -> rows of dq f16, hi = f16(x / f) and lo =
// f16(x / f - hi), as the body's staging rounds them (columns [d, dq)
// zeros), and f into rf[row].  A warp a row.
template <class T>
__global__ void q_deep_rows_kernel(const T* __restrict__ q, __half* __restrict__ hi,
                                   __half* __restrict__ lo, float* __restrict__ rf,
                                   long long rows, int d, int dq) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  for (long long r = (blockIdx.x * (long long)blockDim.x + threadIdx.x) / 32; r < rows;
       r += warps) {
    float mx = 0.f;
    for (int c = lane; c < d; c += 32) mx = fmaxf(mx, fabsf(cs_to_float(q[r * d + c])));
    const float f = row_factor(warp_max(mx)), inv = 1.f / f;
    for (int c8 = lane * 8; c8 < dq; c8 += 256) {
      __align__(16) __half h[8], l[8];
      #pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float xs = c8 + t < d ? cs_to_float(q[r * d + c8 + t]) * inv : 0.f;
        h[t] = __float2half_rn(xs);
        l[t] = __float2half_rn(xs - __half2float(h[t]));
      }
      *reinterpret_cast<uint4*>(hi + r * dq + c8) = *reinterpret_cast<const uint4*>(h);
      *reinterpret_cast<uint4*>(lo + r * dq + c8) = *reinterpret_cast<const uint4*>(l);
    }
    if (lane == 0) rf[r] = f;
  }
}

// f(T*) with T the element type of q type qt, for the types of the mask
// TYPES (others: nothing is called)
template <int TYPES, class F>
void with_q_type(int qt, F&& f) {
  if constexpr (TYPES >> Q_F32 & 1)
    if (qt == Q_F32) return f(static_cast<float*>(nullptr));
  if constexpr (TYPES >> Q_F16 & 1)
    if (qt == Q_F16) return f(static_cast<__half*>(nullptr));
  if constexpr (TYPES >> Q_BF16 & 1)
    if (qt == Q_BF16) return f(static_cast<bf16*>(nullptr));
}

// Launch build B over problem P with q (and the output) of type qt:
// Sq / QROWS query blocks, H x slabs blocks a head (blockIdx.y < 65536: H
// x slabs at most 65535, which at 256-column slabs holds H 40 to d
// 419,424), Bn batch rows.  A q type the build does not take (q_types)
// is refused.  A DEEP build first runs q_deep_kernel (Q16's prefill:
// q_deep_rows_kernel) into q_scratch (16-bit, Bn x Sq x H rows of dq
// columns, a second such array of low halves where Q is split, then
// Q16's row factors, f32), and its body reads Q there.
template <class B, class P>
int launch_mma(int dh, const void* q, const void* k, const void* v, void* out, int Bn, int Sq,
               int H, int Hkv, float scale, int qt, const P& prob, cudaStream_t stream,
               const void* k_lo, const void* v_lo, void* q_scratch = nullptr) {
  constexpr int TYPES = q_types<B, P>();
  if (qt < 0 || qt > Q_F32 || !(TYPES >> qt & 1)) return (int)cudaErrorInvalidValue;
  const size_t smem = MmaSmem<B, P>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mma_kernel<B, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const B bd{dh, copy_chunk(dh), qt};
  const int slabs = slab_count<B>(dh);
  if ((long long)H * slabs > 65535) return (int)cudaErrorInvalidConfiguration;
  if constexpr (B::DEEP) {
    const int dq = (dh + 15) / 16 * 16;
    const long long rows = (long long)Bn * Sq * H, n = rows * (dq / 8);
    ET<B>* hi = (ET<B>*)q_scratch;
    ET<B>* lo = Split<B, P>::q ? hi + rows * dq : nullptr;
    if constexpr (Split<B, P>::rows) {
      const long long want = (rows * 32 + 255) / 256;
      const int blocks = (int)(want < 1 ? 1 : want < 132 * 8 ? want : 132 * 8);
      with_q_type<TYPES>(qt, [&](auto* t) {
        using T = std::remove_pointer_t<decltype(t)>;
        q_deep_rows_kernel<<<blocks, 256, 0, stream>>>((const T*)q, hi, lo,
                                                      (float*)(hi + 2 * rows * dq), rows, dh, dq);
      });
    } else {
      const long long want = (n + 255) / 256;
      const int blocks = (int)(want < 1 ? 1 : want < 132 * 8 ? want : 132 * 8);
      with_q_type<TYPES>(qt, [&](auto* t) {
        using T = std::remove_pointer_t<decltype(t)>;
        q_deep_kernel<<<blocks, 256, 0, stream>>>((const T*)q, hi, lo, rows, dh, dq,
                                                 P::EXACT ? 1.f : scale);
      });
    }
    q = hi;
  }
  dim3 grid((Sq + B::QROWS - 1) / B::QROWS, H * slabs, Bn);
  mma_kernel<B, P><<<grid, B::THREADS, smem, stream>>>(
      q, (const bf16*)k, (const bf16*)v, out, Sq, H, Hkv, scale, prob, bd, (const bf16*)k_lo,
      (const bf16*)v_lo);
  return (int)cudaGetLastError();
}

// the exact bf16 builds: head dims 24, 32, 64, 128 and 256 (attention.cu)
struct Exact {
  template <class P>
  int operator()(int dh, const void* q, const void* k, const void* v, void* out, int Bn,
                 int Sq, int H, int Hkv, float scale, int qt, const P& prob,
                 cudaStream_t stream, const void* k_lo = nullptr,
                 const void* v_lo = nullptr) const {
    switch (dh) {
#define CS_EXACT_CASE(W)                                                                 \
  case W:                                                                                \
    return launch_mma<Build<W, false, OPS_BF16>>(dh, q, k, v, out, Bn, Sq, H, Hkv, scale, \
                                                 qt, prob, stream, k_lo, v_lo);
      CS_EXACT_CASE(24) CS_EXACT_CASE(32) CS_EXACT_CASE(64) CS_EXACT_CASE(128)
      CS_EXACT_CASE(256)
#undef CS_EXACT_CASE
      default: return (int)cudaErrorInvalidValue;
    }
  }
};

// any head dim d = 1, 2, ..., 256 on the smallest ragged build of
// operand types OPS that holds it: 24, 32 (not for OPS_BF16, whose d 32
// is exact: d 25-31 run on 64), 64, 128 or 256 (attention_any.cu,
// attention_q32.cu, attention_f16.cu, attention_q16.cu and
// attention_f32.cu's f32 K/V)
template <int OPS>
struct Any {
  template <class P>
  int operator()(int dh, const void* q, const void* k, const void* v, void* out, int Bn,
                 int Sq, int H, int Hkv, float scale, int qt, const P& prob,
                 cudaStream_t stream, const void* k_lo = nullptr,
                 const void* v_lo = nullptr) const {
    if (dh <= 0 || dh > 256) return (int)cudaErrorInvalidValue;
#define CS_ANY_BUILD(W)                                                                  \
  launch_mma<Build<W, true, OPS>>(dh, q, k, v, out, Bn, Sq, H, Hkv, scale, qt, prob,     \
                                  stream, k_lo, v_lo)
    if (dh <= 24) return CS_ANY_BUILD(24);
    if constexpr (OPS != OPS_BF16) {
      if (dh <= 32) return CS_ANY_BUILD(32);
    }
    if (dh <= 64) return CS_ANY_BUILD(64);
    if (dh <= 128) return CS_ANY_BUILD(128);
    return CS_ANY_BUILD(256);
#undef CS_ANY_BUILD
  }
};

// head dims d = 257, ..., 512 on the SLAB build of width 512 (two column
// slabs of V and O over blocks): the exact build at d 512 for bf16
// operands (32-key steps; the ragged one takes 16), the ragged one
// otherwise (attention_512.cu,
// attention_q32_512.cu, attention_f16_512.cu, attention_q16.cu, and
// attention_f32.cu's f32 K/V)
template <int OPS>
struct Any512 {
  template <class P>
  int operator()(int dh, const void* q, const void* k, const void* v, void* out, int Bn,
                 int Sq, int H, int Hkv, float scale, int qt, const P& prob,
                 cudaStream_t stream, const void* k_lo = nullptr,
                 const void* v_lo = nullptr) const {
    if (dh <= 256 || dh > 512) return (int)cudaErrorInvalidValue;
    if constexpr (OPS == OPS_BF16) {
      if (dh == 512)
        return launch_mma<Build<512, false, OPS>>(dh, q, k, v, out, Bn, Sq, H, Hkv, scale,
                                                  qt, prob, stream, k_lo, v_lo);
    }
    return launch_mma<Build<512, true, OPS>>(dh, q, k, v, out, Bn, Sq, H, Hkv, scale, qt,
                                             prob, stream, k_lo, v_lo);
  }
};

// head dims d past 512 on the DEEP build of operand types OPS (Q K^T over
// depth chunks of 256 columns, ceil(d / DV) column slabs of V and O over
// blocks): attention_deep.cu, attention_q32_deep.cu, attention_f16_deep.cu,
// attention_q16.cu, and attention_f32.cu's f32 K/V.  Slabs of 256 columns
// for bf16 (and f16) K/V in the refresh and packed kernels; of 128 for the
// OPS_Q32 and OPS_Q16 builds, f32 K/V and the prefill
// kernels (EXACT: P split in two halves), whose split products pass 255
// registers beside O's 128 with the depth chunks' loop.  q_scratch: Q's
// pre-pass rows (launch_mma).
template <int OPS>
struct Deep {
  void* q_scratch;
  template <class P>
  int operator()(int dh, const void* q, const void* k, const void* v, void* out, int Bn,
                 int Sq, int H, int Hkv, float scale, int qt, const P& prob,
                 cudaStream_t stream, const void* k_lo = nullptr,
                 const void* v_lo = nullptr) const {
    if (dh <= 512) return (int)cudaErrorInvalidValue;
    constexpr int DV = (OPS == OPS_BF16 || OPS == OPS_F16) && !P::EXACT ? 256 : 128;
    return launch_mma<Build<256, true, OPS, DV>>(dh, q, k, v, out, Bn, Sq, H, Hkv, scale,
                                                 qt, prob, stream, k_lo, v_lo, q_scratch);
  }
};

}  // namespace

// The seven entry points, named cs_attn_<op>SUFFIX (the f16 builds':
// <op>_f16SUFFIX), each launching through LAUNCH (Exact, Any<OPS> or
// Any512<OPS>; the DEEP exports: Deep<OPS>, whose entry points take one
// more argument before the stream, q_scratch: 16-bit, B x Sq x H rows of
// D rounded up to 16, twice where the query is split, then Q16's B x Sq x
// H row factors in f32).  q, out: (B, Sq, H, D) of type qt (Q_BF16,
// Q_F16 or Q_F32; each build takes the types q_types gives it), any Sq;
// k, v bf16 (f16 for OPS_F16 and OPS_Q16).  The Q16 builds export the
// three prefill entry points alone (<op>_f16_q16SUFFIX): the refresh and
// packed kernels take a bf16 or f32 query over f16 K/V on the f16 builds.
//
// refresh: k, v (B, n_tiles * 128, Hkv, D) per-stream caches; q_pos:
// (n_q_tiles * 128,) i32 (the map's, padded with -1); kv_valid: (B,
// n_tiles * 128) u8; tile_ids: (n_q_tiles, t_max) i32; tile_count:
// (n_q_tiles,) i32, n_q_tiles = ceil(Sq / 128).  Every pointer 16-byte
// aligned.  window < 0 means no sliding window.
// refresh_paged: the same over k, v (P_phys, Hkv, D) through pt: (B,
// n_pages) i32; kv_valid: (B, n_pages * 128) u8.
// refresh_paged_int8: k, v the hot slab (n_hot * 128, Hkv, D) and the
// cold group k8, v8: (n_cold * 128, Hkv, D) i8; k_scale, v_scale:
// (n_cold, Hkv) f32.  pt entries >= n_hot are cold pages.
// packed: q, out (R, L, H, D), L % 128 == 0 and L <= 32768; k, v (R, L,
// Hkv, D); span: (R, L) i32, per slot the first and last slot of its
// segment's run, first | last << 16, -1 for padding; tile_ids: (R, L /
// 128, t_max) i32; tile_count: (R, L / 128) i32.
// prefill: k, v (B, Sk, Hkv, D) (any Sq, Sk); query row i sits at
// position i + q_offset; window < 0 means none.
// prefill_paged: k, v (P_phys, Hkv, D) slab; pt: (B, n_pages) i32, the
// logical keys [0, n_pages * 128).  Causal.  prefill_paged_int8: as
// refresh_paged_int8's cold group.
// (SCRATCH names a function-like macro, expanded only where it is
// called: its comma must not split the arguments the macros pass on)
#define CS_ATTN_NO_SCRATCH()
#define CS_ATTN_SCRATCH() , void* q_scratch
#define CS_ATTN_EXPORTS(SUFFIX, LAUNCH) \
  CS_ATTN_EXPORTS_(bf16##SUFFIX, int8##SUFFIX, LAUNCH, CS_ATTN_NO_SCRATCH, )
#define CS_ATTN_DEEP_EXPORTS(SUFFIX, OPS) \
  CS_ATTN_EXPORTS_(bf16##SUFFIX, int8##SUFFIX, Deep<OPS>, CS_ATTN_SCRATCH, q_scratch)
// the f16 builds' entry points: cs_attn_<op>_f16SUFFIX, the int8 ones
// cs_attn_<op>_int8_f16SUFFIX (k, v f16; the hot slab f16)
#define CS_ATTN_F16_EXPORTS(SUFFIX, LAUNCH) \
  CS_ATTN_EXPORTS_(f16##SUFFIX, int8_f16##SUFFIX, LAUNCH, CS_ATTN_NO_SCRATCH, )
#define CS_ATTN_F16_DEEP_EXPORTS(SUFFIX) \
  CS_ATTN_EXPORTS_(f16##SUFFIX, int8_f16##SUFFIX, Deep<OPS_F16>, CS_ATTN_SCRATCH, q_scratch)
// the Q16 builds' prefill entry points: cs_attn_<op>_f16_q16SUFFIX, the
// int8 one cs_attn_prefill_paged_int8_f16_q16SUFFIX
#define CS_ATTN_Q16_EXPORTS(SUFFIX, LAUNCH) \
  CS_ATTN_PREFILL_EXPORTS_(f16_q16##SUFFIX, int8_f16_q16##SUFFIX, LAUNCH, CS_ATTN_NO_SCRATCH, )
#define CS_ATTN_Q16_DEEP_EXPORTS(SUFFIX)                                              \
  CS_ATTN_PREFILL_EXPORTS_(f16_q16##SUFFIX, int8_f16_q16##SUFFIX, Deep<OPS_Q16>, \
                           CS_ATTN_SCRATCH, q_scratch)
#define CS_ATTN_EXPORTS_(HOT, COLD, LAUNCH, SCRATCH, ARG) \
  CS_ATTN_REFRESH_EXPORTS_(HOT, COLD, LAUNCH, SCRATCH, ARG) \
  CS_ATTN_PREFILL_EXPORTS_(HOT, COLD, LAUNCH, SCRATCH, ARG)
#define CS_ATTN_REFRESH_EXPORTS_(HOT, COLD, LAUNCH, SCRATCH, ARG)                         \
  CS_EXPORT int cs_attn_refresh_##HOT(                                                    \
      const void* q, const void* k, const void* v, void* out, const int* q_pos,           \
      const uint8_t* kv_valid, const int* tile_ids, const int* tile_count, int B,         \
      int Sq, int H, int Hkv, int D, int n_tiles, int t_max, int causal, int window,      \
      float scale, int qt SCRATCH(), cudaStream_t stream) {                                 \
    Refresh prob{{q_pos, kv_valid, tile_ids, tile_count, n_tiles, t_max, causal, window}}; \
    return LAUNCH{ARG}(D, q, k, v, out, B, Sq, H, Hkv, scale, qt, prob, stream);          \
  }                                                                                       \
  CS_EXPORT int cs_attn_refresh_paged_##HOT(                                              \
      const void* q, const void* k, const void* v, void* out, const int* q_pos,           \
      const uint8_t* kv_valid, const int* pt, const int* tile_ids,                        \
      const int* tile_count, int B, int Sq, int H, int Hkv, int D, int n_pages,           \
      int t_max, int causal, int window, float scale, int qt SCRATCH(),                     \
      cudaStream_t stream) {                                                              \
    RefreshPaged prob{                                                                    \
        {q_pos, kv_valid, tile_ids, tile_count, n_pages, t_max, causal, window}, pt};     \
    return LAUNCH{ARG}(D, q, k, v, out, B, Sq, H, Hkv, scale, qt, prob, stream);          \
  }                                                                                       \
  CS_EXPORT int cs_attn_refresh_paged_##COLD(                                             \
      const void* q, const void* k, const void* v, void* out, const int* q_pos,           \
      const uint8_t* kv_valid, const int* pt, const int* tile_ids,                        \
      const int* tile_count, const int8_t* k8, const int8_t* v8,                          \
      const float* k_scale, const float* v_scale, int n_hot, int B, int Sq, int H,        \
      int Hkv, int D, int n_pages, int t_max, int causal, int window, float scale,        \
      int qt SCRATCH(), cudaStream_t stream) {                                              \
    RefreshPagedQuant prob{                                                               \
        {{q_pos, kv_valid, tile_ids, tile_count, n_pages, t_max, causal, window}, pt},    \
        {k8, v8, k_scale, v_scale, n_hot}};                                               \
    return LAUNCH{ARG}(D, q, k, v, out, B, Sq, H, Hkv, scale, qt, prob, stream);          \
  }                                                                                       \
  CS_EXPORT int cs_attn_packed_##HOT(                                                     \
      const void* q, const void* k, const void* v, void* out, const int* span,            \
      const int* tile_ids, const int* tile_count, int R, int L, int H, int Hkv, int D,    \
      int t_max, float scale, int qt SCRATCH(), cudaStream_t stream) {                      \
    Packed prob{span, tile_ids, tile_count, L, L / TILE, t_max};                          \
    return LAUNCH{ARG}(D, q, k, v, out, R, L, H, Hkv, scale, qt, prob, stream);           \
  }
#define CS_ATTN_PREFILL_EXPORTS_(HOT, COLD, LAUNCH, SCRATCH, ARG)                         \
  CS_EXPORT int cs_attn_prefill_##HOT(                                                    \
      const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk,      \
      int H, int Hkv, int D, int q_offset, int causal, int window, float scale,           \
      int qt SCRATCH(), cudaStream_t stream) {                                              \
    Prefill prob{{Sq, Sk, q_offset, causal, window, (Sk + TILE - 1) / TILE}};             \
    return LAUNCH{ARG}(D, q, k, v, out, B, Sq, H, Hkv, scale, qt, prob, stream);          \
  }                                                                                       \
  CS_EXPORT int cs_attn_prefill_paged_##HOT(                                              \
      const void* q, const void* k, const void* v, void* out, const int* pt, int B,       \
      int Sq, int H, int Hkv, int D, int n_pages, int q_offset, int window, float scale,  \
      int qt SCRATCH(), cudaStream_t stream) {                                              \
    PrefillPaged prob{{Sq, n_pages * TILE, q_offset, 1, window, n_pages}, pt};            \
    return LAUNCH{ARG}(D, q, k, v, out, B, Sq, H, Hkv, scale, qt, prob, stream);          \
  }                                                                                       \
  CS_EXPORT int cs_attn_prefill_paged_##COLD(                                             \
      const void* q, const void* k, const void* v, void* out, const int* pt,              \
      const int8_t* k8, const int8_t* v8, const float* k_scale, const float* v_scale,     \
      int n_hot, int B, int Sq, int H, int Hkv, int D, int n_pages, int q_offset,         \
      int window, float scale, int qt SCRATCH(), cudaStream_t stream) {                     \
    PrefillPagedQuant prob{{{Sq, n_pages * TILE, q_offset, 1, window, n_pages}, pt},      \
                           {k8, v8, k_scale, v_scale, n_hot}};                            \
    return LAUNCH{ARG}(D, q, k, v, out, B, Sq, H, Hkv, scale, qt, prob, stream);          \
  }
