"""Composable serving stages + per-stream session state (paper Fig. 8).

  CodecFrontend     encode/ingest + single-pass decode + window slicing
  VisualEncoder     full (I-frame, or every frame without pruning) /
                    packed pruned (P-frame) ViT encode, batched over
                    streams x frames
  AttentionPrefill  fresh prefill, and KVC reuse (Eq. 5) + selective
                    refresh for incremental windows, on the paged slab
                    (bf16 or with int8 cold pages) or per-stream caches
  RecurrentPrefill  the SSM and hybrid families: the stream's recurrent
                    state (with a hybrid stack's per-stream attention
                    KV) is its context; each window appends only its
                    new frames
  GreedyDecoder     yes/no answer + greedy continuation

``ServingPipeline`` composes the stages and serves a batch of
same-phase windows (one per stream).  Modes (paper §5): ``codecflow``
and the baselines ``fullcomp`` | ``prune_only`` | ``refresh_only`` |
``cacheblend`` | ``vlcache``, with the packed ViT, on dense, MoE and
VLM attention models and on SSM and hybrid models (every mode of those
two families prefills through ``RecurrentPrefill``).  Everything runs
on the pipeline's device: ``"cuda"`` unless the caller asks for
``"cpu"``.

The JAX package runs its oracle where a pass has no static visit list
(the per-stream fresh prefill, every decode, ``vlcache`` and
``cacheblend``); here every pass builds a map for its positions (host
integers), so the kernels run on all of them with the reference's masks.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec import StreamDecoder, encode_stream
from ..codec.metadata import CodecMetadata
from ..configs.base import CodecCfg, ModelCfg, ViTCfg
from ..core import (
    WindowLayout, capacity_groups, motion_mask, pack_plan, refresh_block_map,
    reuse_caches, select_tokens, shift_valid,
)
from ..core import kv_pool
from ..core.pruning import HostDecision, to_host
from ..kernels.flash_refresh import RefreshBlockMap, build_block_map
from ..kernels.ref import apply_rope_ref, paged_gather_quant_ref, paged_gather_ref
from ..kernels.transfer import HostCopy, host_of, upload, with_host
from ..models import layers
from ..models import transformer as tfm
from ..models.init import detached
from ..models import vit as vitm
from . import flops as flopcount
from .config import EngineCfg

# token conventions for the anomaly-detection workload
YES, NO = 2, 3
QUERY_IDS = (5, 6, 7, 8, 9, 10, 11, 12)   # "describe ... abuse? yes/no"

MODES = ("codecflow", "fullcomp", "prune_only", "refresh_only",
         "cacheblend", "vlcache")
PRUNE_MODES = ("codecflow", "prune_only", "cacheblend", "vlcache")
REUSE_MODES = ("codecflow", "refresh_only", "cacheblend", "vlcache")


def resolve_device(device) -> torch.device:
    """The device the port runs on: CUDA unless the caller asks for the
    CPU.  Raises when CUDA is asked for and no card is found."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return dev


@dataclasses.dataclass
class WindowStats:
    answer: int
    logits_yes_no: Tuple[float, float]
    tokens_vis: int
    tokens_valid: int
    tokens_refreshed: int
    vit_patches: int
    vit_slots: int               # ViT lanes actually computed (packed
    flops_vit: float             # buffer slots)
    flops_prefill: float
    flops_decode: float
    t_codec: float
    t_vit: float
    t_prefill: float
    t_decode: float
    t_overhead: float
    # steady-state KV bytes this stream occupies (paged slab share, with
    # int8 cold pages where demoted, or the per-stream allocation)
    kv_bytes_per_stream: int = 0


# ======================================================================
# Session dataclasses
# ======================================================================
@dataclasses.dataclass(frozen=True)
class StreamRequest:
    """One stream of raw luma frames submitted to the scheduler."""

    stream_id: Any
    frames: np.ndarray               # (T, H, W) raw luma in [0, 255]
    tag: Any = None                  # opaque caller payload (e.g. label)


@dataclasses.dataclass(frozen=True)
class WindowResult:
    stream_id: Any
    session_id: int
    window: int
    stats: WindowStats


@dataclasses.dataclass
class CodecStream:
    """Codec front-end state: the single-pass decode buffer + metadata."""

    decoder: StreamDecoder
    t_ingest: float                  # encode + single-pass decode wall time
    n_windows: int


class StreamSession:
    """Per-stream serving state: codec buffer + KV/layout state."""

    def __init__(self, sid: int, request: StreamRequest, stream: CodecStream):
        self.sid = sid
        self.request = request
        self.stream = stream
        self.next_window = 0
        self.state: Optional[Dict[str, Any]] = None   # backend KV state
        self.results: List[WindowResult] = []

    @property
    def done(self) -> bool:
        return self.next_window >= self.stream.n_windows

    @property
    def answers(self) -> List[int]:
        return [r.stats.answer for r in self.results]


# ======================================================================
# Stage 1: codec front end
# ======================================================================
class CodecFrontend:
    """Encode/ingest + single-pass decode + sliding-window slicing.
    Ingest cost is amortized over the stream's windows here."""

    def __init__(self, codec: CodecCfg, device="cuda"):
        self.codec = codec
        self.device = resolve_device(device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open(self, frames: np.ndarray) -> CodecStream:
        t0 = time.perf_counter()
        x = torch.as_tensor(np.asarray(frames, np.float32), device=self.device)
        bs, meta = encode_stream(x, self.codec)
        dec = StreamDecoder(self.codec)
        dec.ingest(bs, meta)
        self._sync()
        return CodecStream(dec, time.perf_counter() - t0, dec.n_windows())

    def window_host(self, cs: CodecStream, k: int
                    ) -> Tuple[torch.Tensor, CodecMetadata, float]:
        """k-th window for an ingest worker thread (the async scheduler's
        stage-1 surface): (frames (W, H, Wd), metadata, amortized
        t_codec).  The decode buffer already lives on the stream's device,
        so this is a view of it and of the metadata: no copy, no device
        work, safe beside the main thread's dispatches."""
        wframes, wmeta = cs.decoder.window(k)
        return wframes, wmeta, cs.t_ingest / max(cs.n_windows, 1)

    def window(self, cs: CodecStream, k: int
               ) -> Tuple[torch.Tensor, CodecMetadata, float]:
        """k-th window: (frames (W, H, Wd), metadata, amortized t_codec)."""
        return self.window_host(cs, k)


# ======================================================================
# Stage 2: visual encoder
# ======================================================================
class VisualEncoder:
    """Full/pruned ViT encode of window frames, batched across streams:
    all fully encoded frames of all streams (the I-frames, or every frame
    when ``prune`` is off) in one call, all pruned P-frames packed into
    shared variable-capacity buffers in one call."""

    PACK_TILE = 128

    def __init__(self, v: ViTCfg, vparams, codec: CodecCfg,
                 layout: WindowLayout, prune: bool = True):
        self.v = v
        self.vparams = vparams
        self.codec = codec
        self.layout = layout
        self.prune = prune
        self._index: Dict[tuple, torch.Tensor] = {}

    def _split_range(self, frame_range: range) -> Tuple[List[int], List[int]]:
        lay = self.layout
        i_idx = [f for f in frame_range if lay.frame_is_i(f) or not self.prune]
        p_idx = [f for f in frame_range if f not in i_idx]
        return i_idx, p_idx

    def _frames(self, frames: torch.Tensor, idx: List[int]) -> torch.Tensor:
        """frames[:, idx] through an index uploaded once per frame list (a
        Python list as an index would be copied to the card with a sync)."""
        key = (tuple(idx), str(frames.device))
        sel = self._index.get(key)
        if sel is None:
            sel = self._index[key] = upload(np.asarray(idx), frames.device, torch.long)
        return frames.index_select(1, sel)

    def decide(self, metas: Sequence[CodecMetadata], frame_range: range
               ) -> Optional[List[HostDecision]]:
        """Each stream's prune decision for its P-frames in ``frame_range``
        on the host (None when the range has none): motion masks and group
        ranking on the device for every frame of the window, one fetch,
        then the P-frames' rows picked on the host.  Rows are independent,
        so the decision of one window alone equals its rows of a batch."""
        _, p_idx = self._split_range(frame_range)
        if not p_idx:
            return None
        v = self.v
        dyn, sco = zip(*(motion_mask(m, self.codec, v.patches_per_side) for m in metas))
        dyn, sco = torch.stack(dyn), torch.stack(sco)          # (S, W, pp, pp)
        S, W = dyn.shape[:2]
        flat = to_host(select_tokens(dyn.reshape((S * W,) + dyn.shape[2:]),
                                     sco.reshape((S * W,) + sco.shape[2:]),
                                     v, self.layout.k_tokens))
        gv = flat.group_valid.reshape(S, W, -1)[:, p_idx]
        pi = flat.patch_idx.reshape(S, W, -1)[:, p_idx]
        return [HostDecision(gv[i], pi[i]) for i in range(S)]

    def _encode_packed(self, pframes: torch.Tensor, dec: HostDecision
                       ) -> Tuple[torch.Tensor, int]:
        """Packed pruned encode of a flat (B, H, W) P-frame batch.
        Returns ((B, k_tokens, d_lm) tokens, packed slot count)."""
        v, kg = self.v, self.layout.k_tokens
        plan = pack_plan(dec, v, tile=self.PACK_TILE)
        dev = pframes.device
        toks = vitm.encode_packed_tokens(
            self.vparams, v, pframes, upload(plan.patch_src, dev),
            upload(plan.seg_id, dev), upload(plan.group_src, dev),
            upload(plan.group_dst, dev), plan.block_map, n_out=plan.n_frames * kg,
        )
        return toks.reshape(plan.n_frames, kg, -1), plan.n_slots

    def encode(self, frames: torch.Tensor, metas: Sequence[CodecMetadata],
               frame_range: range, decisions: Optional[Sequence[HostDecision]] = None):
        """Encode frames [range) of every stream's window; ``decisions``
        are the streams' ``decide`` results where already made.

        Returns (embeds (S, n_tok, d), valid (S, n_tok), patches (S,),
        slots (S,)).
        """
        lay, v = self.layout, self.v
        S = frames.shape[0]
        dev = frames.device
        i_idx, p_idx = self._split_range(frame_range)
        toks_by_frame: dict = {}
        val_by_frame: dict = {}
        patches = np.zeros((S,), np.int64)
        slots = np.zeros((S,), np.int64)

        if i_idx:
            sel = self._frames(frames, i_idx)                # (S, Ni, H, Wd)
            batch = sel.reshape((S * len(i_idx),) + sel.shape[2:])
            toks = vitm.encode_full(self.vparams, v, batch)
            toks = toks.reshape((S, len(i_idx)) + toks.shape[1:])
            for j, f in enumerate(i_idx):
                n_tok = lay.frame_tokens[f]
                toks_by_frame[f] = toks[:, j, :n_tok]
                val_by_frame[f] = torch.ones((S, n_tok), dtype=torch.bool, device=dev)
            patches += len(i_idx) * v.n_patches
            slots += len(i_idx) * v.n_patches

        if p_idx:
            if decisions is None:
                decisions = self.decide(metas, frame_range)
            Np = len(p_idx)
            gv = np.concatenate([d.group_valid for d in decisions])   # (S * Np, Kg)
            pi = np.concatenate([d.patch_idx for d in decisions])
            pframes = self._frames(frames, p_idx).reshape((S * Np,) + frames.shape[2:])
            toks, n_slots = self._encode_packed(pframes, HostDecision(gv, pi))
            slots += -(-n_slots // S)    # shared buffer: attribute evenly
            toks = toks.reshape((S, Np) + toks.shape[1:])
            gval = upload(gv.reshape(S, Np, -1), dev)
            patches += gv.reshape(S, -1).sum(axis=1) * v.group ** 2
            for j, f in enumerate(p_idx):
                n_tok = lay.frame_tokens[f]
                toks_by_frame[f] = toks[:, j, :n_tok]
                val_by_frame[f] = gval[:, j, :n_tok]

        embeds = torch.cat([toks_by_frame[f] for f in frame_range], 1)
        valids = torch.cat([val_by_frame[f] for f in frame_range], 1)
        return embeds, valids, patches, slots


# ======================================================================
# Stage 3: prefill (attention family)
# ======================================================================
class PrefillResult(NamedTuple):
    """Output of the prefill stage for one batch of windows."""

    logits: torch.Tensor         # (S, V) last-position logits
    decode_caches: Any           # caches the decoder continues from
    decode_start: int            # position of the first decoded token
    flops_len: Any               # i -> attended context len of step i
    state: Dict[str, Any]        # batched per-stream state for window k+1
    tokens_vis: int
    tokens_valid: torch.Tensor   # (S,) on the device until finalize
    n_refreshed: int
    flops: float                 # prefill FLOPs per stream
    t_select: float              # refresh-set selection time (host wall)
    page_table: Any = None       # (S, pages/stream) slab pages, paged mode


class AttentionPrefill:
    """Fresh prefill + KVC reuse / selective refresh (Eq. 5).

    Reuse modes keep per-stream KV in one shared slab (``core.kv_pool``)
    unless ``KVCfg(paged_kv=False)``; the per-stream state then carries
    page ids.  With ``stale_page_dtype="int8"`` overlap pages a stream
    carried for ``demote_after`` windows are demoted to an int8 cold
    slab.  Without reuse (``fullcomp``, ``prune_only``) and with
    ``paged_kv=False`` each group owns per-stream caches that the state
    carries.  Caches are written in place.

    Every attention pass runs with a visit list for its query positions:
    per layout for fresh windows and static refresh sets, per stream and
    window for ``cacheblend``'s online set (host time in ``t_map``).
    """

    KV_TILE = 128

    def __init__(self, cfg: ModelCfg, params, layout: WindowLayout,
                 ecfg: EngineCfg, device):
        if ecfg.kv.stale_page_dtype not in ("bf16", "int8"):
            raise ValueError(f"stale_page_dtype {ecfg.kv.stale_page_dtype!r}")
        self.cfg = cfg
        self.params = params
        self.layout = layout
        self.ecfg = ecfg
        self.device = device
        need = layout.total_len + ecfg.max_new_tokens
        self.cache_slots = -(-need // self.KV_TILE) * self.KV_TILE
        self.pages_per_stream = self.cache_slots // self.KV_TILE
        self.paged = bool(ecfg.kv.paged_kv and ecfg.mode in REUSE_MODES)
        self.quant = self.paged and ecfg.kv.stale_page_dtype == "int8"
        self.cold_per_stream = (len(kv_pool.demotable_pages(layout, self.KV_TILE))
                                if self.quant else 0)
        self.demote_after = max(1, ecfg.kv.demote_after)
        self.pool: Optional[kv_pool.KVPool] = None
        self._pool_hint = ecfg.kv.pool_streams or 1
        window = cfg.sliding_window
        # per-layout visit lists: [0, total_len) for fresh windows, the
        # refresh set for incremental ones where it is layout-static
        self.fresh_map: RefreshBlockMap = build_block_map(
            np.arange(layout.total_len, dtype=np.int32), self.cache_slots,
            causal=True, window=window)
        self._fresh_idx = upload(np.arange(layout.total_len), device, torch.long)
        self._static_ridx = self._static_refresh_set()
        self._static_ridx_dev = (None if self._static_ridx is None else
                                 upload(self._static_ridx, device, torch.long))
        self.block_map: Optional[RefreshBlockMap] = None
        if self._static_ridx is not None:
            self.block_map = (
                refresh_block_map(layout, window=window, kv_len=self.cache_slots)
                if ecfg.mode in ("codecflow", "refresh_only") else
                build_block_map(self._static_ridx, self.cache_slots, window=window))
        self.t_map = 0.0         # host seconds building per-window maps

    def _static_refresh_set(self) -> Optional[np.ndarray]:
        mode, lay = self.ecfg.mode, self.layout
        if mode in ("codecflow", "refresh_only"):
            return lay.refresh_token_idx
        if mode == "vlcache":
            tail = np.arange(lay.overlap_tokens, lay.total_len, dtype=np.int32)
            budget = len(lay.anchor_token_idx)
            r = max(1, int(self.ecfg.refresh.vlcache_ratio * lay.overlap_tokens))
            sel = np.linspace(0, lay.overlap_tokens - 1, min(r, budget) or 1).astype(np.int32)
            return np.unique(np.concatenate([sel, tail]))
        return None

    # -- paged pool lifecycle ------------------------------------------
    def ensure_pool(self, n_streams: int) -> None:
        """Size the slab for ``n_streams`` concurrent streams (growing is
        only legal while no pages are in use).  With int8 cold pages a
        steady stream holds P - D hot and D cold pages and admission is
        all hot, so hot = N (P - D) + D and cold = N D: streams admit
        staggered, each after the previous one demoted."""
        if not self.paged:
            return
        if self.ecfg.kv.pool_streams is not None:
            want = self.ecfg.kv.pool_streams
        else:
            self._pool_hint = max(self._pool_hint, n_streams)
            want = self._pool_hint
        D = self.cold_per_stream
        need = want * (self.pages_per_stream - D) + D
        need_cold = want * D
        if self.pool is None or self.pool.n_pages < need or self.pool.n_cold < need_cold:
            if self.pool is not None and self.pool.used_pages:
                raise RuntimeError("cannot grow a pool with pages in use; pin pool_streams")
            self.pool = None     # free the old slab before the new one
            self.pool = kv_pool.KVPool(self.cfg, need, page=self.KV_TILE,
                                       device=self.device, cold_pages=need_cold)

    def can_admit(self, n_streams: int) -> bool:
        if not self.paged or self.pool is None:
            return True
        return self.pool.can_admit_streams(n_streams, self.pages_per_stream,
                                           self.cold_per_stream)

    def release(self, state: Optional[Dict[str, Any]]) -> None:
        """Return a finished stream's pages to the free lists (no copy)."""
        if state is None:
            return
        pages = state.pop("pages", None)
        if pages is not None and self.pool is not None:
            if self.quant and not (np.asarray(pages) >= self.pool.n_pages).any():
                # evicted before its first demotion: drop its reservation
                self.pool.unreserve_cold(self.cold_per_stream)
            self.pool.evict(pages)

    def kv_bytes_per_stream(self) -> int:
        """Steady-state KV bytes one admitted stream occupies: its share of
        the slab (hot tail + int8 overlap, scales included, when
        quantised) or the full per-stream bf16 allocation."""
        if self.paged:
            if self.pool is None:
                return 0
            D = self.cold_per_stream
            return self.pool.bytes_per_stream(self.pages_per_stream - D, D)
        cfg = self.cfg
        return cfg.repeats * cfg.period * 2 * self.cache_slots * cfg.n_kv * cfg.d_head * 2

    def _page_table(self, pages: np.ndarray) -> torch.Tensor:
        return upload(pages, self.device, torch.int32)

    def _result(self, logits, vis, vval, caches, kv_valid, valid, n_refreshed,
                flops, t_select, pages=None, page_table=None, age=None) -> PrefillResult:
        lay = self.layout
        if pages is not None:
            state = {"vis": vis, "vval": vval, "kv_valid": kv_valid, "pages": pages}
            if age is not None:
                state["age"] = age      # windows the overlap pages survived
        else:
            state = {"vis": vis, "vval": vval, "caches": caches, "kv_valid": kv_valid}
        return PrefillResult(
            logits=logits, decode_caches=caches,
            decode_start=lay.total_len,
            flops_len=lambda i: lay.total_len + i + 1,
            state=state, tokens_vis=lay.vis_len,
            tokens_valid=valid.sum(dim=1),
            n_refreshed=n_refreshed, flops=flops, t_select=t_select,
            page_table=page_table,
        )

    def _run(self, h, idx, kv_valid, caches, page_table, block_map):
        """Scatter-mode pass: write K/V of positions ``idx`` and attend;
        returns last-position logits."""
        S = h.shape[0]
        positions = with_host(idx[None].expand(S, idx.shape[0]),
                              np.broadcast_to(host_of(idx)[None], (S, idx.shape[0])))
        h, _, _ = tfm.run_stack(
            self.cfg, self.params, h, positions, None, caches,
            cache_offset=None, cache_len=self.cache_slots, scatter_idx=idx,
            kv_valid=kv_valid, q_chunk=self.ecfg.q_chunk, block_map=block_map,
            page_table=page_table, page_size=self.KV_TILE,
        )
        hn = layers.rmsnorm(self.params["final_norm"], h, self.cfg.norm_eps)
        return tfm.lm_logits(self.cfg, self.params, hn[:, -1])

    # -- fresh window --------------------------------------------------
    def fresh(self, vis: torch.Tensor, vval: torch.Tensor,
              qe: torch.Tensor) -> PrefillResult:
        lay, alloc = self.layout, self.cache_slots
        S = vis.shape[0]
        embeds = torch.cat([vis, qe], 1)
        valid = torch.cat(
            [vval, torch.ones((S, lay.query_len), dtype=torch.bool, device=vis.device)], 1)
        kv_valid = torch.zeros((S, alloc), dtype=torch.bool, device=vis.device)
        kv_valid[:, : lay.total_len] = valid
        h = embeds.to(self.params["embed"].dtype)
        flops = flopcount.prefill_flops(self.cfg, lay.total_len, lay.total_len)
        if not self.paged:
            caches = tfm.init_caches(self.cfg, S, alloc, device=self.device)
            logits, caches, _ = tfm.prefill(
                self.cfg, self.params, torch.zeros((S, lay.total_len), dtype=torch.long,
                                                   device=vis.device),
                caches, valid=valid, inputs_embeds=h, q_chunk=self.ecfg.q_chunk,
                block_map=self.fresh_map)
            return self._result(logits, vis, vval, caches, kv_valid, valid,
                                lay.total_len, flops, 0.0)
        self.ensure_pool(S)
        pages = self.pool.admit_streams(S, self.pages_per_stream, self.cold_per_stream)
        pt = self._page_table(pages)
        logits = self._run(h, self._fresh_idx, kv_valid, self.pool.slab, pt,
                           self.fresh_map)
        age = np.zeros((S,), np.int32) if self.quant else None
        return self._result(logits, vis, vval, self.pool.slab, kv_valid, valid,
                            lay.total_len, flops, 0.0, pages=pages, page_table=pt,
                            age=age)

    # -- incremental window (reuse + selective refresh) ----------------
    def step(self, vis_new: torch.Tensor, vval_new: torch.Tensor,
             qe: torch.Tensor, state) -> PrefillResult:
        lay, alloc = self.layout, self.cache_slots
        S = vis_new.shape[0]
        dev = vis_new.device
        # splice cached overlap embeddings with the new-stride tokens
        # (the ViT is NOT re-run for the overlap, §3.4.1)
        vis = torch.cat([state["vis"][:, lay.shift_tokens:], vis_new], 1)
        vval = torch.cat([state["vval"][:, lay.shift_tokens:], vval_new], 1)
        embeds = torch.cat([vis, qe], 1)
        valid = torch.cat(
            [vval, torch.ones((S, lay.query_len), dtype=torch.bool, device=dev)], 1)
        pages = pt = age = None
        if self.paged:
            pages = state["pages"]
            pt = self._page_table(pages)
            caches = kv_pool.reuse_pool_caches(self.cfg, self.pool.slab, pt, lay,
                                               self.KV_TILE)
            if self.quant:
                # reuse first (it rewrote the overlap), then demote the
                # streams now eligible; the refresh below reads and writes
                # through the updated mixed-precision page table
                age = state["age"] + 1
                pages, pt = self._demote(caches, pages, age)
        else:
            caches = reuse_caches(self.cfg, state["caches"], lay)
        # validity after this refresh: the shifted overlap, then the
        # refresh set's own validity (queries at invalid slots are masked)
        kv_full = shift_valid(state["kv_valid"], lay)
        t0 = time.perf_counter()
        ridx_np = self.refresh_indices(embeds, caches, page_table=pt)
        t_select = time.perf_counter() - t0
        bm, ridx = self.block_map, self._static_ridx_dev
        if bm is None:
            t0 = time.perf_counter()
            bm = build_block_map(ridx_np, alloc, window=self.cfg.sliding_window)
            self.t_map += time.perf_counter() - t0
            ridx = upload(ridx_np, dev, torch.long)
        kv_full[:, ridx] = valid[:, ridx]
        h = embeds[:, ridx].to(self.params["embed"].dtype)
        logits = self._run(h, ridx, kv_full, caches, pt, bm)
        flops = flopcount.prefill_flops(self.cfg, len(ridx_np), lay.total_len)
        return self._result(logits, vis, vval, caches, kv_full, valid, len(ridx_np),
                            flops, t_select, pages=pages, page_table=pt, age=age)

    def _demote(self, caches, pages: np.ndarray, age: np.ndarray):
        """Codec-guided demotion: quantise eligible streams' overlap pages
        into the int8 cold slab and swap the cold ids into their page
        tables.  A stream is eligible once its overlap pages survived
        ``demote_after`` reuse windows and it has not demoted yet; the
        demotable set is the layout-static prefix pages [0, D)."""
        D = self.cold_per_stream
        if D:
            demoted = (pages[:, :D] >= self.pool.n_pages).any(axis=1)
            rows = np.nonzero((age >= self.demote_after) & ~demoted)[0]
            if rows.size:
                src = pages[rows][:, :D]
                dst = self.pool.demote(src).reshape(src.shape)
                kv_pool.demote_pool_caches(caches, self._page_table(src),
                                           self._page_table(dst), self.KV_TILE)
                pages = pages.copy()
                pages[rows[:, None], np.arange(D)[None, :]] = dst
        return pages, self._page_table(pages)

    def absorb_decode(self, state) -> None:
        """Decode wrote the caches in place; its slots become valid for the
        next window's shift."""
        lay, nd = self.layout, self.ecfg.max_new_tokens
        kv = state["kv_valid"].clone()
        kv[:, lay.total_len: lay.total_len + nd] = True
        state["kv_valid"] = kv

    # -- refresh policy (the *when/where* of C2) -----------------------
    @property
    def batchable_step(self) -> bool:
        """cacheblend ranks per stream online: its refresh sets differ
        across streams, so its incremental windows are served alone."""
        return self.ecfg.mode != "cacheblend"

    def refresh_indices(self, embeds, reused_caches, page_table=None) -> np.ndarray:
        """The refresh set (host int32): layout-static, or for
        ``cacheblend`` the top-``budget`` overlap tokens by
        ``cacheblend_deviation``, with the new stride and query."""
        if self._static_ridx is not None:
            return self._static_ridx
        lay = self.layout
        tail = np.arange(lay.overlap_tokens, lay.total_len, dtype=np.int32)
        budget = len(lay.anchor_token_idx)
        dev = self.cacheblend_deviation(embeds, reused_caches, page_table)
        top = torch.argsort(-dev, stable=True)[:budget].cpu().numpy().astype(np.int32)
        return np.unique(np.concatenate([top, tail]))

    def cacheblend_deviation(self, embeds, reused_caches, page_table=None) -> torch.Tensor:
        """cacheblend's online probe (overlap_tokens,) f32: per overlap
        token, the norm of the difference between the reused layer-0 keys
        and keys recomputed from the current embeddings."""
        lay, cfg = self.layout, self.cfg
        if embeds.shape[0] != 1:
            raise ValueError("cacheblend refresh is per stream")
        ov = lay.overlap_tokens
        p0 = tfm.unstack(self.params["blocks"][0])[0]
        hn = layers.rmsnorm(p0["ln1"], embeds[:, :ov], cfg.norm_eps)
        kq = (hn @ p0["mixer"]["wk"]).reshape(1, ov, cfg.n_kv, cfg.d_head)
        pos = torch.arange(ov, device=embeds.device)[None]
        k_new = apply_rope_ref(kq, pos, cfg.rope_theta)
        b0 = reused_caches.blocks[0]
        blk0 = b0.k[0]
        if page_table is not None:
            # the stream's logical view; demoted pages dequantise through
            # the storage dtype, exactly what the kernel reads
            blk0 = (paged_gather_quant_ref(blk0, b0.k8[0], b0.k_scale[0], page_table,
                                           self.KV_TILE)
                    if isinstance(b0, layers.QuantKVCache)
                    else paged_gather_ref(blk0, page_table, self.KV_TILE))
        k_reused = blk0[:, :ov]
        return torch.linalg.norm((k_new - k_reused.to(k_new.dtype)).float(), dim=(-1, -2))[0]


class RecurrentPrefill:
    """SSM and hybrid boundary-state streaming.

    The stream's state is its recurrent cache (conv tails and SSD state
    of every mamba layer, and in a hybrid stack the attention layers'
    per-stream KV): each window appends only the new frames' tokens to
    it, then the query and the decode run past it, so they do not enter
    the boundary state.  The JAX package forks the cache for free (its
    arrays are immutable); here the caches are written in place, so the
    query pass gets its own copy of the mamba states.  The attention KV
    needs none: the query and decode write the slots past the offset,
    which no pass reads before the next window's append overwrites them
    (a contiguous pass sees keys up to its own last position only).

    The attention caches hold the JAX package's ``default_max_hist()``
    slots, rounded up to the kernel's 128-row tiles (the slots past
    ``max_hist`` are never written, and the causal mask hides them).
    Where the JAX package would write past ``max_hist`` (its contiguous
    write then clamps silently), this raises ``ValueError``.
    """

    paged = False
    pool = None

    def __init__(self, cfg: ModelCfg, params, layout: WindowLayout,
                 ecfg: EngineCfg, device):
        self.cfg = cfg
        self.params = params
        self.layout = layout
        self.ecfg = ecfg
        self.device = device
        self.has_attention = tfm.has_attention(cfg)
        self.max_hist = 4 * layout.vis_len + layout.query_len + ecfg.max_new_tokens
        tile = AttentionPrefill.KV_TILE
        self.cache_slots = (-(-self.max_hist // tile) * tile if self.has_attention
                            else layout.total_len + ecfg.max_new_tokens)
        self._maps: Dict[Tuple[int, int], RefreshBlockMap] = {}

    # -- lifecycle: no pool, every stream admits --------------------------
    def ensure_pool(self, n_streams: int) -> None:
        """No shared pool: each stream carries its own state."""

    def can_admit(self, n_streams: int) -> bool:
        return True

    def release(self, state: Optional[Dict[str, Any]]) -> None:
        """Nothing to return: the state is dropped with the session."""

    def kv_bytes_per_stream(self) -> int:
        """0, as in the JAX package, whose recurrent backend reports no KV
        bytes (a hybrid stream's attention KV is part of its state)."""
        return 0

    def fresh(self, vis, vval, qe) -> PrefillResult:
        return self._append(vis, vval, qe, None)

    def step(self, vis, vval, qe, state) -> PrefillResult:
        return self._append(vis, vval, qe, state)

    def absorb_decode(self, state) -> None:
        """No-op: query and decode ran past the boundary state."""

    def block_map(self, offset: int, n: int) -> Optional[RefreshBlockMap]:
        """Visit list of the contiguous pass at positions ``offset + arange(n)``
        over the attention caches (None for a stack without attention)."""
        if not self.has_attention:
            return None
        key = (offset, n)
        if key not in self._maps:
            self._maps[key] = build_block_map(
                np.arange(offset, offset + n, dtype=np.int32), self.cache_slots,
                causal=True, window=self.cfg.sliding_window)
        return self._maps[key]

    def _append(self, vis, vval, qe, state) -> PrefillResult:
        """Extend the boundary state with the new visual tokens, then run
        the query past it."""
        lay, cfg, dev = self.layout, self.cfg, self.device
        S, n_new = vis.shape[0], vis.shape[1]
        if state is None:
            caches = tfm.init_caches(cfg, S, self.cache_slots if self.has_attention else 0,
                                     device=dev)
            offset = 0
        else:
            caches, offset = state["caches"], state["offset"]
        offset_vis = offset + n_new
        end = offset_vis + lay.query_len + self.ecfg.max_new_tokens
        if self.has_attention and end > self.max_hist:
            raise ValueError(
                f"{cfg.name}: the window would fill slots up to {end}, past the "
                f"attention caches' max_hist {self.max_hist}")
        qc = self.ecfg.q_chunk
        tfm.prefill(cfg, self.params, torch.zeros((S, n_new), dtype=torch.long, device=dev),
                    caches, valid=vval, inputs_embeds=vis, cache_offset=offset, q_chunk=qc,
                    block_map=self.block_map(offset, n_new))
        q_caches = tfm.Caches(tuple(
            blk if isinstance(blk, layers.KVCache) else type(blk)(*(leaf.clone() for leaf in blk))
            for blk in caches.blocks), None)
        q_logits, q_caches, _ = tfm.prefill(
            cfg, self.params, torch.zeros((S, lay.query_len), dtype=torch.long, device=dev),
            q_caches, valid=torch.ones((S, lay.query_len), dtype=torch.bool, device=dev),
            inputs_embeds=qe, cache_offset=offset_vis, q_chunk=qc,
            block_map=self.block_map(offset_vis, lay.query_len))
        flops = flopcount.prefill_flops(cfg, n_new + lay.query_len,
                                        offset_vis + lay.query_len)
        return PrefillResult(
            logits=q_logits, decode_caches=q_caches,
            decode_start=offset_vis + lay.query_len,
            flops_len=lambda i: offset_vis + lay.query_len + i,
            state={"caches": caches, "offset": offset_vis},
            tokens_vis=n_new, tokens_valid=vval.sum(dim=1),
            n_refreshed=n_new + lay.query_len, flops=flops, t_select=0.0,
        )


# ======================================================================
# Stage 4: decoder
# ======================================================================
class DecodePending(NamedTuple):
    """Dispatched greedy decode; ``finalize_stats`` fetches the answers."""

    answers: torch.Tensor        # (S,) bool: yes-logit > no-logit
    yes_no: torch.Tensor         # (S, 2) last-prefill yes/no logits
    flops_decode: float


class GreedyDecoder:
    """Yes/no answer extraction + greedy continuation on the paged slab,
    the per-stream caches or the recurrent state.

    The JAX package's decode has no visit list and so runs its oracle;
    here every decode step of a stack with attention runs the attention
    kernel with a map built for its one position (causal mask only, as
    in the JAX package).  An attention-free stack needs no map."""

    def __init__(self, cfg: ModelCfg, params, ecfg: EngineCfg):
        self.cfg = cfg
        self.params = params
        self.max_new_tokens = ecfg.max_new_tokens
        self.has_attention = tfm.has_attention(cfg)
        self._maps: Dict[Tuple[int, int], RefreshBlockMap] = {}

    def decode_map(self, pos: int, cache_len: int) -> Optional[RefreshBlockMap]:
        if not self.has_attention:
            return None
        key = (pos, cache_len)
        if key not in self._maps:
            self._maps[key] = build_block_map(
                [pos], cache_len, causal=True, window=self.cfg.sliding_window)
        return self._maps[key]

    def start(self, logits: torch.Tensor, caches, start_pos: int, flops_len,
              page_table: Optional[torch.Tensor], cache_len: int) -> DecodePending:
        """``page_table`` None: ``caches`` are per-stream caches of
        ``cache_len`` slots; otherwise the shared slab."""
        yes_no = torch.stack((logits[:, YES], logits[:, NO]), dim=1)
        answers = yes_no[:, 0] > yes_no[:, 1]
        tok = torch.where(answers, YES, NO)[:, None]
        f_decode = 0.0
        for i in range(self.max_new_tokens):
            pos = start_pos + i
            logits_d, caches = tfm.decode_step(
                self.cfg, self.params, tok, caches, pos, page_table=page_table,
                cache_len=cache_len, block_map=self.decode_map(pos, cache_len),
            )
            tok = torch.argmax(logits_d, -1)[:, None]
            f_decode += flopcount.decode_flops(self.cfg, flops_len(i))
        return DecodePending(answers, yes_no, f_decode)


# ======================================================================
# Pipeline: stage composition
# ======================================================================
class StageTimer:
    """Times one stage's dispatch: host wall always and, on the card, a
    pair of timing events on the compute stream around its work.
    ``seconds`` is the events' device span on the card (read it only
    after the window's sync) and the host wall on the CPU, where every
    call returns when its work is done."""

    def __init__(self, device: torch.device):
        self._t0 = time.perf_counter()
        self.host = 0.0
        self._events = None
        if device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()

    def stop(self) -> "StageTimer":
        self.host = time.perf_counter() - self._t0
        if self._events is not None:
            self._events[1].record()
        return self

    @property
    def on_device(self) -> bool:
        return self._events is not None

    @property
    def seconds(self) -> float:
        if self._events is None:
            return self.host
        return self._events[0].elapsed_time(self._events[1]) / 1e3


class EncodedWindows(NamedTuple):
    vis: torch.Tensor            # (S, T, D) visual embeds
    vval: torch.Tensor           # (S, T) validity mask
    qe: torch.Tensor             # (S, Q, D) query embeds
    patches: np.ndarray          # (S,) kept patch counts (host)
    slots: np.ndarray            # (S,) packed-slot counts (host)
    fresh: bool
    t_vit: Optional[StageTimer]  # None for a group re-staged from rows


class PrefilledWindows(NamedTuple):
    pr: PrefillResult
    t_prefill: StageTimer


class DecodedWindows(NamedTuple):
    pend: DecodePending
    t_decode: StageTimer
    # (S, 4) f64 on its way to the host: yes logit, no logit, answer,
    # tokens_valid; the one device-to-host copy of the window
    host: HostCopy


class ServingPipeline:
    """Composes the four stages; serves a batch of same-phase windows
    (one per stream).

    The stage surfaces ``encode_windows``, ``prefill_windows`` and
    ``decode_windows`` only dispatch: on the card they return once their
    work is queued on the compute stream, and ``finalize_stats`` (or the
    scheduler's finalize) is the one place that waits for a window.  All
    device work of the serving state (prefill, reuse, int8 demotion,
    decode) runs on that one stream, in dispatch order: the paged slab,
    the per-stream caches and the recurrent states are written in place,
    and stream order is what keeps a window's reads behind the previous
    window's writes.  Only ``decide`` runs on a side stream, and it
    touches no serving state.  Stage times are device spans from timing
    events on the card and host wall times on the CPU.  The parameter
    trees are taken detached (``models.init.detached``): weights fresh
    from training, leaves that require grad, serve without recording an
    autograd graph, and reach the kernels, which have no backward."""

    def __init__(self, cfg: ModelCfg, vit_cfg: ViTCfg, params_lm,
                 params_vit, ecfg: EngineCfg, device="cuda"):
        if cfg.vit is not None and cfg.vit != vit_cfg:
            raise ValueError("vit_cfg does not match the model's ViT")
        if ecfg.mode not in MODES:
            raise ValueError(f"mode {ecfg.mode!r} is not one of {MODES}")
        if not ecfg.prune.packed_vit:
            raise NotImplementedError("the padded ViT (packed_vit=False) is not ported")
        self.device = resolve_device(device)
        params_lm, params_vit = detached(params_lm), detached(params_vit)
        self.cfg = cfg
        self.v = vit_cfg
        self.params = params_lm
        self.vparams = params_vit
        self.ecfg = ecfg
        c = ecfg.codec
        self.prune = ecfg.mode in PRUNE_MODES
        self.reuse = ecfg.mode in REUSE_MODES
        kg = capacity_groups(vit_cfg, c.keep_ratio) if self.prune else vit_cfg.n_groups
        self.layout = WindowLayout(
            window=c.window_frames, stride=c.stride_frames, gop=c.gop,
            g_tokens=vit_cfg.n_groups, k_tokens=kg, query_len=len(QUERY_IDS),
        )
        self.frontend = CodecFrontend(c, self.device)
        self.encoder = VisualEncoder(vit_cfg, params_vit, c, self.layout, self.prune)
        self.is_streaming_family = cfg.family in ("ssm", "hybrid")
        backend = RecurrentPrefill if self.is_streaming_family else AttentionPrefill
        self.backend = backend(cfg, params_lm, self.layout, ecfg, self.device)
        self.decoder = GreedyDecoder(cfg, params_lm, ecfg)
        self.cache_slots = self.backend.cache_slots
        self.paged = self.backend.paged
        self._query_ids = upload(np.asarray(QUERY_IDS)[None], self.device, torch.long)
        self._side = threading.local()      # per-thread side stream of ``decide``

    @property
    def kernels(self) -> frozenset:
        """The kernels (``ops.KERNELS`` names) serving launches: motion
        search always, the packed ViT when pruning, and either the SSD
        scan (SSM and hybrid families, the latter with the per-stream
        attention kernel) or RoPE shift when reusing and the attention
        kernel of the KV layout."""
        prune = {"flash_packed"} if self.prune else set()
        if self.is_streaming_family:
            attn = {"flash_refresh"} if self.backend.has_attention else set()
            return frozenset({"mv_sad", "ssd_scan"} | attn | prune)
        attn = ("flash_refresh" if not self.paged else
                "flash_refresh_paged_int8" if self.backend.quant else "flash_refresh_paged")
        return frozenset({"mv_sad", attn} | prune
                         | ({"rope_shift"} if self.reuse else set()))

    # -- paged pool lifecycle (no-ops for per-stream caches and states) --
    def ensure_capacity(self, n_streams: int) -> None:
        self.backend.ensure_pool(n_streams)

    def can_admit(self, n_streams: int = 1) -> bool:
        return self.backend.can_admit(n_streams)

    def release_state(self, state: Optional[Dict[str, Any]]) -> None:
        if self.paged:
            self.backend.release(state)

    def kv_bytes_per_stream(self) -> int:
        return self.backend.kv_bytes_per_stream()

    # ------------------------------------------------------------------
    def _query_embeds(self, S: int) -> torch.Tensor:
        qe = tfm.embed_tokens(self.cfg, self.params, self._query_ids)
        return qe.expand((S,) + qe.shape[1:])

    def batch_key(self, state: Optional[Dict[str, Any]]) -> tuple:
        """Windows sharing a key may be fused into one batched call
        (recurrent states only at the same offset)."""
        if state is None or not self.reuse:
            return ("fresh",)
        if self.is_streaming_family:
            return ("inc", state["offset"])
        if not self.backend.batchable_step:
            return ("inc", id(state))     # never batched (cacheblend)
        return ("inc",)

    def _frame_range(self, fresh: bool) -> range:
        lay = self.layout
        return range(lay.window) if fresh else range(lay.window - lay.stride, lay.window)

    def decide(self, metas: Sequence[CodecMetadata], fresh: bool
               ) -> Optional[List[HostDecision]]:
        """The prune decisions the encode of these windows needs, on the
        host (``VisualEncoder.decide``), so an ingest worker can make them
        before the encode is dispatched.  On the card they run on a side
        stream of the calling thread: its one device-to-host copy waits
        for that stream alone, not for the prefill and decode queued on
        the compute stream.  The codec metadata they read was synced at
        ``open``."""
        rng = self._frame_range(fresh)
        if self.device.type != "cuda":
            return self.encoder.decide(metas, rng)
        side = getattr(self._side, "stream", None)
        if side is None:
            side = self._side.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(side):
            return self.encoder.decide(metas, rng)

    def encode_windows(self, frames: torch.Tensor, metas: Sequence[CodecMetadata],
                       fresh: bool, decisions: Optional[Sequence[HostDecision]] = None
                       ) -> EncodedWindows:
        """Stage 2: ViT-encode one fused group (full window if fresh,
        last stride otherwise), from the streams' ``decide`` results where
        given.  Needs no per-stream state, so the async scheduler may run
        it ahead of the previous window's prefill and decode."""
        timer = StageTimer(self.device)
        vis, vval, patches, slots = self.encoder.encode(
            frames, metas, self._frame_range(fresh), decisions)
        qe = self._query_embeds(frames.shape[0])
        return EncodedWindows(vis, vval, qe, patches, slots, fresh, timer.stop())

    def prefill_windows(self, enc: EncodedWindows,
                        state: Optional[Dict[str, Any]]) -> PrefilledWindows:
        """Stage 3: build/extend LLM context for one fused group."""
        timer = StageTimer(self.device)
        if enc.fresh:
            pr = self.backend.fresh(enc.vis, enc.vval, enc.qe)
        else:
            pr = self.backend.step(enc.vis, enc.vval, enc.qe, state)
        return PrefilledWindows(pr, timer.stop())

    def decode_windows(self, pf: PrefilledWindows) -> DecodedWindows:
        """Stage 4: greedy continuation; folds the decode slots into the
        stream state and queues the window's answers for the host."""
        pr = pf.pr
        timer = StageTimer(self.device)
        pend = self.decoder.start(
            pr.logits, pr.decode_caches, pr.decode_start, pr.flops_len,
            page_table=pr.page_table, cache_len=self.cache_slots,
        )
        self.backend.absorb_decode(pr.state)
        timer.stop()
        out = torch.cat([pend.yes_no.double(), pend.answers.double()[:, None],
                         pr.tokens_valid.double()[:, None]], dim=1)
        return DecodedWindows(pend, timer, HostCopy(out))

    # -- stage 5 ---------------------------------------------------------
    @staticmethod
    def prefill_seconds(pf: PrefilledWindows) -> float:
        """The group's prefill time without its host refresh-set selection
        (``t_select``, reported as overhead; the card waits meanwhile)."""
        return max(pf.t_prefill.seconds - pf.pr.t_select, 0.0)

    @staticmethod
    def decode_seconds(dec: DecodedWindows, t_sync: float) -> float:
        """The group's decode time: the device span on the card; on the
        CPU the host wall with the fetch, the tail of the decode."""
        return dec.t_decode.seconds + (0.0 if dec.t_decode.on_device else t_sync)

    def window_stats(self, pf: PrefilledWindows, dec: DecodedWindows,
                     host: np.ndarray, i: int, patches: int, slots: int,
                     t_vit: float, t_prefill: float, t_decode: float,
                     t_overhead: float) -> WindowStats:
        """Stream ``i``'s stats from its group's fetched rows ``host``."""
        pr = pf.pr
        return WindowStats(
            answer=int(host[i, 2]),
            logits_yes_no=(float(host[i, 0]), float(host[i, 1])),
            tokens_vis=pr.tokens_vis,
            tokens_valid=int(host[i, 3]),
            tokens_refreshed=pr.n_refreshed,
            vit_patches=int(patches),
            vit_slots=int(slots),
            flops_vit=flopcount.vit_flops(self.v, int(patches)),
            flops_prefill=pr.flops,
            flops_decode=dec.pend.flops_decode,
            t_codec=0.0, t_vit=t_vit, t_prefill=t_prefill,
            t_decode=t_decode, t_overhead=t_overhead,
            kv_bytes_per_stream=self.kv_bytes_per_stream(),
        )

    def finalize_stats(self, enc: EncodedWindows, pf: PrefilledWindows,
                       dec: DecodedWindows) -> List[WindowStats]:
        """Stage 5, the one sync: wait for the group's answers and
        assemble per-stream stats."""
        S = len(enc.patches)
        t0 = time.perf_counter()
        host = dec.host.result()
        t_sync = time.perf_counter() - t0
        t_prefill = self.prefill_seconds(pf) / S
        t_decode = self.decode_seconds(dec, t_sync) / S
        return [self.window_stats(pf, dec, host, i, enc.patches[i], enc.slots[i],
                                  enc.t_vit.seconds / S, t_prefill, t_decode,
                                  pf.pr.t_select / S)
                for i in range(S)]

    def serve_batch(self, frames: torch.Tensor, metas: Sequence[CodecMetadata],
                    state: Optional[Dict[str, Any]]
                    ) -> Tuple[List[WindowStats], Dict[str, Any]]:
        """Serve one window of S same-layout, same-phase streams: the
        synchronous composition of the stage surfaces."""
        fresh = state is None or not self.reuse
        enc = self.encode_windows(frames, metas, fresh)
        pf = self.prefill_windows(enc, state)
        dec = self.decode_windows(pf)
        stats = self.finalize_stats(enc, pf, dec)
        return stats, pf.pr.state
