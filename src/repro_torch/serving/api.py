"""Composable serving stages + per-stream session state (paper Fig. 8).

  CodecFrontend     encode/ingest + single-pass decode + window slicing
  VisualEncoder     full (I-frame) / packed pruned (P-frame) ViT encode,
                    batched over streams x frames
  AttentionPrefill  paged fresh prefill, and KVC reuse (Eq. 5) +
                    selective refresh for incremental windows
  GreedyDecoder     yes/no answer + greedy continuation on the paged slab

``ServingPipeline`` composes the stages and serves a batch of
same-phase windows (one per stream).  This slice of the port serves the
JAX package's main path: mode ``codecflow`` with the packed ViT and the
paged bf16 KV slab, attention-family models.  Everything runs on the
pipeline's device: ``"cuda"`` unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..codec import StreamDecoder, encode_stream
from ..codec.metadata import CodecMetadata
from ..configs.base import CodecCfg, ModelCfg, ViTCfg
from ..core import (
    WindowLayout, capacity_groups, motion_mask, pack_plan, refresh_block_map,
    select_tokens,
)
from ..core import kv_pool
from ..kernels.flash_refresh import RefreshBlockMap, build_block_map
from ..models import layers
from ..models import transformer as tfm
from ..models import vit as vitm
from . import flops as flopcount
from .config import EngineCfg

# token conventions for the anomaly-detection workload
YES, NO = 2, 3
QUERY_IDS = (5, 6, 7, 8, 9, 10, 11, 12)   # "describe ... abuse? yes/no"

MODES = ("codecflow",)                    # the modes this slice serves


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
    # steady-state KV bytes this stream occupies in the paged slab
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

    def window(self, cs: CodecStream, k: int
               ) -> Tuple[torch.Tensor, CodecMetadata, float]:
        """k-th window on the device: (frames (W, H, Wd), metadata,
        amortized t_codec)."""
        wframes, wmeta = cs.decoder.window(k)
        return wframes, wmeta, cs.t_ingest / max(cs.n_windows, 1)


# ======================================================================
# Stage 2: visual encoder
# ======================================================================
class VisualEncoder:
    """Full/pruned ViT encode of window frames, batched across streams:
    all I-frames of all streams in one full-capacity call, all P-frames
    packed into shared variable-capacity buffers in one call."""

    PACK_TILE = 128

    def __init__(self, v: ViTCfg, vparams, codec: CodecCfg,
                 layout: WindowLayout):
        self.v = v
        self.vparams = vparams
        self.codec = codec
        self.layout = layout

    def _split_range(self, frame_range: range) -> Tuple[List[int], List[int]]:
        lay = self.layout
        i_idx = [f for f in frame_range if lay.frame_is_i(f)]
        p_idx = [f for f in frame_range if not lay.frame_is_i(f)]
        return i_idx, p_idx

    def _encode_packed(self, pframes: torch.Tensor, dec) -> Tuple[torch.Tensor, int]:
        """Packed pruned encode of a flat (B, H, W) P-frame batch.
        Returns ((B, k_tokens, d_lm) tokens, packed slot count)."""
        v, kg = self.v, self.layout.k_tokens
        plan = pack_plan(dec, v, tile=self.PACK_TILE)
        dev = pframes.device

        def t(a):
            return torch.as_tensor(a).to(dev)

        toks = vitm.encode_packed_tokens(
            self.vparams, v, pframes, t(plan.patch_src), t(plan.seg_id),
            t(plan.group_src), t(plan.group_dst), plan.block_map,
            n_out=plan.n_frames * kg,
        )
        return toks.reshape(plan.n_frames, kg, -1), plan.n_slots

    def encode(self, frames: torch.Tensor, metas: Sequence[CodecMetadata],
               frame_range: range):
        """Encode frames [range) of every stream's window.

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
            sel = frames[:, i_idx]                           # (S, Ni, H, Wd)
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
            dyn, sco = zip(*(motion_mask(m, self.codec, v.patches_per_side)
                             for m in metas))
            dyn, sco = torch.stack(dyn), torch.stack(sco)    # (S, W, pp, pp)
            Np = len(p_idx)
            dsel = dyn[:, p_idx].reshape((S * Np,) + dyn.shape[2:])
            ssel = sco[:, p_idx].reshape((S * Np,) + sco.shape[2:])
            dec = select_tokens(dsel, ssel, v, lay.k_tokens)
            pframes = frames[:, p_idx].reshape((S * Np,) + frames.shape[2:])
            toks, n_slots = self._encode_packed(pframes, dec)
            slots += -(-n_slots // S)    # shared buffer: attribute evenly
            toks = toks.reshape((S, Np) + toks.shape[1:])
            gval = dec.group_valid.reshape(S, Np, -1)
            patches += dec.patch_valid.reshape(S, -1).sum(dim=1).cpu().numpy()
            for j, f in enumerate(p_idx):
                n_tok = lay.frame_tokens[f]
                toks_by_frame[f] = toks[:, j, :n_tok]
                val_by_frame[f] = gval[:, j, :n_tok]

        embeds = torch.cat([toks_by_frame[f] for f in frame_range], 1)
        valids = torch.cat([val_by_frame[f] for f in frame_range], 1)
        return embeds, valids, patches, slots


# ======================================================================
# Stage 3: prefill (attention family, paged slab)
# ======================================================================
class PrefillResult(NamedTuple):
    """Output of the prefill stage for one batch of windows."""

    logits: torch.Tensor         # (S, V) last-position logits
    decode_caches: Any           # caches the decoder continues from
    decode_start: int            # position of the first decoded token
    flops_len: Any               # i -> attended context len of step i
    state: Dict[str, Any]        # batched per-stream state for window k+1
    tokens_vis: int
    tokens_valid: np.ndarray     # (S,)
    n_refreshed: int
    flops: float                 # prefill FLOPs per stream
    page_table: Any = None       # (S, pages/stream) slab pages


class AttentionPrefill:
    """Paged fresh prefill + KVC reuse / selective refresh (Eq. 5).

    Per-stream KV lives in one shared bf16 slab (``core.kv_pool``),
    updated in place; the per-stream state carries page ids.  Fresh
    windows and the refresh pass run scatter-mode attention with
    per-layout visit lists.
    """

    KV_TILE = 128

    def __init__(self, cfg: ModelCfg, params, layout: WindowLayout,
                 ecfg: EngineCfg, device):
        if ecfg.mode != "codecflow" or not ecfg.kv.paged_kv \
                or ecfg.kv.stale_page_dtype != "bf16":
            raise NotImplementedError(
                "the port serves mode 'codecflow' on the paged bf16 slab")
        self.cfg = cfg
        self.params = params
        self.layout = layout
        self.ecfg = ecfg
        self.device = device
        need = layout.total_len + ecfg.max_new_tokens
        self.cache_slots = -(-need // self.KV_TILE) * self.KV_TILE
        self.pages_per_stream = self.cache_slots // self.KV_TILE
        self.pool: Optional[kv_pool.KVPool] = None
        self._pool_hint = ecfg.kv.pool_streams or 1
        # both visit lists are per-layout constants: the refresh set's
        # positions for incremental windows, [0, total_len) for fresh ones
        self.block_map: RefreshBlockMap = refresh_block_map(
            layout, window=cfg.sliding_window, kv_len=self.cache_slots)
        self.fresh_map: RefreshBlockMap = build_block_map(
            np.arange(layout.total_len, dtype=np.int32), self.cache_slots,
            causal=True, window=cfg.sliding_window)
        self._ridx = torch.as_tensor(layout.refresh_token_idx).long().to(device)
        self._fresh_idx = torch.arange(layout.total_len, device=device)

    # -- paged pool lifecycle ------------------------------------------
    def ensure_pool(self, n_streams: int) -> None:
        """Size the slab for ``n_streams`` concurrent streams (growing is
        only legal while no pages are in use)."""
        if self.ecfg.kv.pool_streams is not None:
            want = self.ecfg.kv.pool_streams
        else:
            self._pool_hint = max(self._pool_hint, n_streams)
            want = self._pool_hint
        need = want * self.pages_per_stream
        if self.pool is None or self.pool.n_pages < need:
            if self.pool is not None and self.pool.used_pages:
                raise RuntimeError("cannot grow a pool with pages in use; pin pool_streams")
            self.pool = None     # free the old slab before the new one
            self.pool = kv_pool.KVPool(self.cfg, need, page=self.KV_TILE,
                                       device=self.device)

    def can_admit(self, n_streams: int) -> bool:
        if self.pool is None:
            return True
        return self.pool.can_admit(n_streams * self.pages_per_stream)

    def release(self, state: Optional[Dict[str, Any]]) -> None:
        """Return a finished stream's pages to the free list (no copy)."""
        if state is None:
            return
        pages = state.pop("pages", None)
        if pages is not None and self.pool is not None:
            self.pool.evict(pages)

    def kv_bytes_per_stream(self) -> int:
        if self.pool is None:
            return 0
        return self.pool.bytes_per_stream(self.pages_per_stream)

    def _page_table(self, pages: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(pages, dtype=torch.int32).to(self.device)

    def _result(self, logits, vis, vval, kv_valid, valid, n_refreshed, flops,
                pages, page_table) -> PrefillResult:
        lay = self.layout
        state = {"vis": vis, "vval": vval, "kv_valid": kv_valid, "pages": pages}
        return PrefillResult(
            logits=logits, decode_caches=self.pool.slab,
            decode_start=lay.total_len,
            flops_len=lambda i: lay.total_len + i + 1,
            state=state, tokens_vis=lay.vis_len,
            tokens_valid=valid.sum(dim=1).cpu().numpy(),
            n_refreshed=n_refreshed, flops=flops, page_table=page_table,
        )

    def _run(self, h, idx, kv_valid, page_table, block_map):
        """Scatter-mode pass over the slab: write K/V of positions ``idx``
        and attend; returns last-position logits."""
        S = h.shape[0]
        positions = idx[None].expand(S, idx.shape[0])
        h, _ = tfm.run_stack(
            self.cfg, self.params, h, positions, None, self.pool.slab,
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
        self.ensure_pool(S)
        pages = self.pool.admit_streams(S, self.pages_per_stream)
        pt = self._page_table(pages)
        kv_valid = torch.zeros((S, alloc), dtype=torch.bool, device=vis.device)
        kv_valid[:, : lay.total_len] = valid
        h = embeds.to(self.params["embed"].dtype)
        logits = self._run(h, self._fresh_idx, kv_valid, pt, self.fresh_map)
        flops = flopcount.prefill_flops(self.cfg, lay.total_len, lay.total_len)
        return self._result(logits, vis, vval, kv_valid, valid, lay.total_len,
                            flops, pages, pt)

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
        pages = state["pages"]
        pt = self._page_table(pages)
        kv_pool.reuse_pool_caches(self.cfg, self.pool.slab, pt, lay, self.KV_TILE)
        # validity after this refresh: the shifted overlap, then the
        # refresh set's own validity (queries at invalid slots are masked)
        kv_full = torch.zeros((S, alloc), dtype=torch.bool, device=dev)
        kv_full[:, : lay.overlap_tokens] = state["kv_valid"][:, lay.shift_tokens: lay.vis_len]
        ridx = self._ridx                  # codecflow: the layout's refresh set
        kv_full[:, ridx] = valid[:, ridx]
        h = embeds[:, ridx].to(self.params["embed"].dtype)
        logits = self._run(h, ridx, kv_full, pt, self.block_map)
        flops = flopcount.prefill_flops(self.cfg, len(ridx), lay.total_len)
        return self._result(logits, vis, vval, kv_full, valid, len(ridx),
                            flops, pages, pt)

    def absorb_decode(self, state) -> None:
        """Decode wrote the shared slab in place; its slots become valid
        for the next window's shift."""
        lay, nd = self.layout, self.ecfg.max_new_tokens
        kv = state["kv_valid"].clone()
        kv[:, lay.total_len: lay.total_len + nd] = True
        state["kv_valid"] = kv


# ======================================================================
# Stage 4: decoder
# ======================================================================
class DecodePending(NamedTuple):
    """Dispatched greedy decode; ``finalize_stats`` fetches the answers."""

    answers: torch.Tensor        # (S,) bool: yes-logit > no-logit
    yes_no: torch.Tensor         # (S, 2) last-prefill yes/no logits
    flops_decode: float


class GreedyDecoder:
    """Yes/no answer extraction + greedy continuation on the paged slab.

    The JAX package's paged decode has no visit list and so runs its
    oracle; here every decode step runs the paged attention kernel with
    a map built for its one position (causal mask only, as in the JAX
    package)."""

    def __init__(self, cfg: ModelCfg, params, ecfg: EngineCfg):
        self.cfg = cfg
        self.params = params
        self.max_new_tokens = ecfg.max_new_tokens
        self._maps: Dict[Tuple[int, int], RefreshBlockMap] = {}

    def decode_map(self, pos: int, cache_len: int) -> RefreshBlockMap:
        key = (pos, cache_len)
        if key not in self._maps:
            self._maps[key] = build_block_map(
                [pos], cache_len, causal=True, window=self.cfg.sliding_window)
        return self._maps[key]

    def start(self, logits: torch.Tensor, caches, start_pos: int, flops_len,
              page_table: torch.Tensor, cache_len: int) -> DecodePending:
        yes_no = logits[:, [YES, NO]]
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
class EncodedWindows(NamedTuple):
    vis: torch.Tensor            # (S, T, D) visual embeds
    vval: torch.Tensor           # (S, T) validity mask
    qe: torch.Tensor             # (S, Q, D) query embeds
    patches: np.ndarray          # (S,) kept patch counts (host)
    slots: np.ndarray            # (S,) packed-slot counts (host)
    fresh: bool
    t_vit: float


class PrefilledWindows(NamedTuple):
    pr: PrefillResult
    t_prefill: float


class DecodedWindows(NamedTuple):
    pend: DecodePending
    t_decode: float


class ServingPipeline:
    """Composes the four stages; serves a batch of same-phase windows
    (one per stream).  Stage times are host wall times around work that
    ends in a device sync."""

    def __init__(self, cfg: ModelCfg, vit_cfg: ViTCfg, params_lm,
                 params_vit, ecfg: EngineCfg, device="cuda"):
        if cfg.vit is not None and cfg.vit != vit_cfg:
            raise ValueError("vit_cfg does not match the model's ViT")
        if ecfg.mode not in MODES or not ecfg.prune.packed_vit:
            raise NotImplementedError(
                f"mode {ecfg.mode!r} (packed_vit={ecfg.prune.packed_vit}) "
                "is not ported; this slice serves 'codecflow' with the packed ViT")
        if cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError("recurrent families are not ported")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.v = vit_cfg
        self.params = params_lm
        self.vparams = params_vit
        self.ecfg = ecfg
        c = ecfg.codec
        kg = capacity_groups(vit_cfg, c.keep_ratio)
        self.layout = WindowLayout(
            window=c.window_frames, stride=c.stride_frames, gop=c.gop,
            g_tokens=vit_cfg.n_groups, k_tokens=kg, query_len=len(QUERY_IDS),
        )
        self.frontend = CodecFrontend(c, self.device)
        self.encoder = VisualEncoder(vit_cfg, params_vit, c, self.layout)
        self.backend = AttentionPrefill(cfg, params_lm, self.layout, ecfg, self.device)
        self.decoder = GreedyDecoder(cfg, params_lm, ecfg)
        self.cache_slots = self.backend.cache_slots

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- paged pool lifecycle ------------------------------------------
    def ensure_capacity(self, n_streams: int) -> None:
        self.backend.ensure_pool(n_streams)

    def can_admit(self, n_streams: int = 1) -> bool:
        return self.backend.can_admit(n_streams)

    def release_state(self, state: Optional[Dict[str, Any]]) -> None:
        self.backend.release(state)

    def kv_bytes_per_stream(self) -> int:
        return self.backend.kv_bytes_per_stream()

    # ------------------------------------------------------------------
    def _query_embeds(self, S: int) -> torch.Tensor:
        ids = torch.as_tensor(QUERY_IDS, dtype=torch.long, device=self.device)[None]
        qe = tfm.embed_tokens(self.cfg, self.params, ids)
        return qe.expand((S,) + qe.shape[1:])

    def batch_key(self, state: Optional[Dict[str, Any]]) -> tuple:
        """Windows sharing a key may be fused into one batched call."""
        return ("fresh",) if state is None else ("inc",)

    def encode_windows(self, frames: torch.Tensor, metas: Sequence[CodecMetadata],
                       fresh: bool) -> EncodedWindows:
        """Stage 2: ViT-encode one fused group (full window if fresh,
        last stride otherwise)."""
        lay = self.layout
        t0 = time.perf_counter()
        rng = range(lay.window) if fresh else range(lay.window - lay.stride, lay.window)
        vis, vval, patches, slots = self.encoder.encode(frames, metas, rng)
        qe = self._query_embeds(frames.shape[0])
        self._sync()
        t_vit = time.perf_counter() - t0
        return EncodedWindows(vis, vval, qe, patches, slots, fresh, t_vit)

    def prefill_windows(self, enc: EncodedWindows,
                        state: Optional[Dict[str, Any]]) -> PrefilledWindows:
        """Stage 3: build/extend LLM context for one fused group."""
        t0 = time.perf_counter()
        if enc.fresh:
            pr = self.backend.fresh(enc.vis, enc.vval, enc.qe)
        else:
            pr = self.backend.step(enc.vis, enc.vval, enc.qe, state)
        self._sync()
        t_prefill = time.perf_counter() - t0
        return PrefilledWindows(pr, t_prefill)

    def decode_windows(self, pf: PrefilledWindows) -> DecodedWindows:
        """Stage 4: greedy continuation; folds the decode slots into the
        stream state."""
        pr = pf.pr
        t0 = time.perf_counter()
        pend = self.decoder.start(
            pr.logits, pr.decode_caches, pr.decode_start, pr.flops_len,
            page_table=pr.page_table, cache_len=self.cache_slots,
        )
        self.backend.absorb_decode(pr.state)
        self._sync()
        t_decode = time.perf_counter() - t0
        return DecodedWindows(pend, t_decode)

    def finalize_stats(self, enc: EncodedWindows, pf: PrefilledWindows,
                       dec: DecodedWindows) -> List[WindowStats]:
        """Stage 5: fetch the answers and assemble per-stream stats."""
        pr, pend = pf.pr, dec.pend
        S = pend.answers.shape[0]
        t0 = time.perf_counter()
        yes_no = pend.yes_no.cpu().numpy().astype(np.float64)
        answers = pend.answers.cpu().numpy().astype(np.int64)
        t_decode = dec.t_decode + (time.perf_counter() - t0)
        kv_bytes = self.kv_bytes_per_stream()
        return [
            WindowStats(
                answer=int(answers[i]),
                logits_yes_no=(float(yes_no[i, 0]), float(yes_no[i, 1])),
                tokens_vis=pr.tokens_vis,
                tokens_valid=int(pr.tokens_valid[i]),
                tokens_refreshed=pr.n_refreshed,
                vit_patches=int(enc.patches[i]),
                vit_slots=int(enc.slots[i]),
                flops_vit=flopcount.vit_flops(self.v, int(enc.patches[i])),
                flops_prefill=pr.flops,
                flops_decode=pend.flops_decode,
                t_codec=0.0, t_vit=enc.t_vit / S,
                t_prefill=pf.t_prefill / S,
                t_decode=t_decode / S, t_overhead=0.0,
                kv_bytes_per_stream=kv_bytes,
            )
            for i in range(S)
        ]

    def serve_batch(self, frames: torch.Tensor, metas: Sequence[CodecMetadata],
                    state: Optional[Dict[str, Any]]
                    ) -> Tuple[List[WindowStats], Dict[str, Any]]:
        """Serve one window of S same-layout, same-phase streams."""
        fresh = state is None
        enc = self.encode_windows(frames, metas, fresh)
        pf = self.prefill_windows(enc, state)
        dec = self.decode_windows(pf)
        stats = self.finalize_stats(enc, pf, dec)
        return stats, pf.pr.state
