"""Software video encoder: GOP structure, motion search, residual coding.

The codec metadata the serving pipeline consumes (MVs, residuals, frame
types) is a byproduct of this block-based inter-frame encoder.  The
motion search is its hot spot and runs on the ``mv_sad`` kernel on the
card (``kernels/ops.py``); a Python loop over frames replaces the JAX
package's ``lax.scan``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..configs.base import CodecCfg
from ..kernels import ops
from .metadata import I_FRAME, Bitstream, CodecMetadata, gop_frame_types


def motion_compensate(ref_frame: torch.Tensor, mv: torch.Tensor, block: int) -> torch.Tensor:
    """Prediction frame: each block shifted by its MV (dy, dx); reads
    outside the frame clamp to its edge (matches the padded search)."""
    H, W = ref_frame.shape
    dev = ref_frame.device
    yy, xx = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    dy = mv[..., 0].repeat_interleave(block, 0).repeat_interleave(block, 1)
    dx = mv[..., 1].repeat_interleave(block, 0).repeat_interleave(block, 1)
    src_y = torch.clamp(yy + dy, 0, H - 1)
    src_x = torch.clamp(xx + dx, 0, W - 1)
    return ref_frame[src_y, src_x]


def _quantize(x: torch.Tensor, step: float) -> torch.Tensor:
    return torch.round(x / step) * step        # half-to-even, as jnp.round


def encode_stream(frames: torch.Tensor, cfg: CodecCfg, quant_step: float = 4.0
                  ) -> Tuple[Bitstream, CodecMetadata]:
    """Encode a luma stream (T, H, W) in [0, 255].

    The encoder tracks the reconstructed previous frame as its reference,
    so decode(encode(x)) is exact by construction.  The motion search
    runs on every frame (its result is discarded on I-frames), as in the
    JAX package.
    """
    frames = frames.to(torch.float32)
    T, H, W = frames.shape
    hb, wb = H // cfg.block, W // cfg.block
    dev = frames.device
    ftypes = gop_frame_types(T, cfg.gop, dev)
    prev = torch.zeros((H, W), dtype=torch.float32, device=dev)
    idata, mvs, resids, blk_resids = [], [], [], []
    zeros = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for t in range(T):
        frame = frames[t]
        is_i = t % cfg.gop == 0
        mv, _ = ops.mv_sad(frame, prev, cfg.block, cfg.search_radius)
        if is_i:
            mv = torch.zeros_like(mv)
        pred = motion_compensate(prev, mv, cfg.block)
        resid = frame - pred
        resid_q = _quantize(resid, quant_step)
        if is_i:
            recon = _quantize(frame, quant_step / 2.0)
            idata.append(recon)
            resids.append(zeros)
            blk_resids.append(torch.zeros((hb, wb), dtype=torch.float32, device=dev))
        else:
            recon = pred + resid_q
            idata.append(zeros)
            resids.append(resid_q)
            blk_resids.append(
                resid.abs().reshape(hb, cfg.block, wb, cfg.block).mean(dim=(1, 3)))
        mvs.append(mv)
        prev = recon
    mvs_t = torch.stack(mvs)
    bs = Bitstream(ftypes, torch.stack(idata), mvs_t, torch.stack(resids))
    md = CodecMetadata(ftypes, mvs_t, torch.stack(blk_resids))
    return bs, md


def estimate_bits(bitstream: Bitstream, quant_step: float = 4.0) -> dict:
    """Empirical-entropy size model of the encoded stream (numpy, on the
    host): the symbol entropy of the quantised I-frame data, residuals
    and MVs lower-bounds what an entropy coder would spend, the
    transmission figure of paper Fig. 11.  The all-intra baseline is the
    same call on a stream encoded with gop 1."""
    ft = bitstream.frame_types.cpu().numpy()
    i_mask, p_mask = ft == I_FRAME, ft != I_FRAME

    def entropy_bits(sym: np.ndarray) -> float:
        if sym.size == 0:
            return 0.0
        _, counts = np.unique(sym, return_counts=True)
        p = counts / sym.size
        return float(sym.size * -(p * np.log2(p)).sum())

    idata = bitstream.iframe_data.cpu().numpy()[i_mask]
    resid = bitstream.residual_q.cpu().numpy()[p_mask]
    mv = bitstream.mv.cpu().numpy()[p_mask]
    out = {
        "iframe_bits": entropy_bits(np.round(idata / (quant_step / 2)).astype(np.int32)),
        "residual_bits": entropy_bits(np.round(resid / quant_step).astype(np.int32)),
        "mv_bits": entropy_bits(mv.reshape(-1)),
    }
    out["total_bits"] = out["iframe_bits"] + out["residual_bits"] + out["mv_bits"]
    T, H, W = bitstream.iframe_data.shape
    out["raw_bits"] = float(T * H * W * 8)
    out["compression_ratio"] = out["raw_bits"] / max(out["total_bits"], 1.0)
    return out
