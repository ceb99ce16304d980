#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --only flash_packed,rope_shift [--src DIR]
    python3 chip_smoke.py --only whisper [--src DIR]
    python3 chip_smoke.py --only families [--src DIR]
    python3 chip_smoke.py --only mesh
    python3 chip_smoke.py --only hosttime [--src DIR]

With no arguments it runs every phase below.  ``--only`` runs phases 1-3
for the named kernels' checks alone (names as in the kernels line) and
prints their rows and the card's line, with no serve phase and no
contract line (``--only mha``, ``--only families``, ``--only whisper``,
``--only mesh`` and ``--only hosttime``: phase 3's mha probe, phase 7
alone, phase 8(b) alone, phase 8(b) then 9, and phase 3(c)'s host time
per call alone); ``--src`` drives the ``repro_torch`` of another checkout's
``src`` directory (built there), so an earlier commit unpacked with
``git archive`` can be timed in the same call: parent, change, change,
parent.

Phases (any failure exits non-zero):

  1. device  — require CUDA; print the card's name and power limit; TF32 off.
  2. build   — compile the hand-written kernels from src/repro_torch/csrc
               (one nvcc per source, in parallel) and print what ptxas
               reports per kernel (registers, spills); an attention
               kernel that spills fails.
  3. kernels — each kernel against its plain PyTorch version on the card
               at the serving path's shapes for internvl3-14b at 448^2
               (flash_refresh_paged at fresh prefill, selective refresh
               and decode; flash_refresh on per-stream caches at the
               pruned and unpruned fresh prefill, selective refresh and
               decode; flash_refresh_paged with int8 cold pages at the
               selective refresh with 15 of 21 pages per stream cold, and
               all hot, where it must equal the bf16 kernel bitwise), of
               mamba2-2.7b for ssd_scan (the fresh window, incremental
               window and query of 2 streams, a long and a ragged
               prefill, and groups G > 1 at a small width), and at
               internvl3-14b attention widths for flash_prefill (causal,
               a chunk at an offset, a sliding window, a ragged length,
               rows with no visible key, which must be the mean of V;
               SDPA's is_causal timed beside the masked call where it is
               the same function) and flash_prefill_paged (a shuffled slab, bf16 and with 15
               of 21 pages per stream int8, and all hot, bitwise equal to
               bf16), and flash_packed at three packings of window 0's
               24 P-frames (the serve path's, busy: every frame keeps its
               whole budget, mixed: seeded random budgets), with the
               stated tolerance; flash_refresh_paged also at olmoe-1b-7b's
               heads (H 16 = Hkv 16, D 128) on its codecflow layout,
               flash_refresh at jamba-v0.1-52b's (H 32, Hkv 8, D 128) on
               its recurrent passes over max_hist slots (window 0's and
               the last window's append, query and decode, fullcomp's
               append), ssd_scan at jamba's serving shapes (H 128, P 64,
               N 16); kernel, plain and library
               (scaled_dot_product_attention, after a gather where the KV
               is paged; none for ssd_scan) times from CUDA events around
               calls made one by one (``ms``: the wrapper's host time
               counts where it is longer than the launch); for ssd_scan,
               mv_sad, flash_packed and rope_shift also ``device_ms``, the
               device time per launch from a replayed CUDA graph over
               inputs cycled past the L2 cache; the least time the card
               could take (bytes
               over 3.35 TB/s, operations over the peak rate of their
               type: bf16 tensor cores for ssd_scan, with the f32 CUDA
               cores' figure printed beside it).  Then the
               LM head: lm_logits at internvl3-14b's head width, untied
               and tied, against the f32 product of its bf16 operands
               (it must keep the f32 result, not a bf16 one).  Head dim
               24: every attention kernel and rope_shift (bf16, its 8-byte
               path, and f32) also at benchmarks/common.py's VLM (LM H 4
               over Hkv 2, ViT H 4) on its 112^2 layout and at a larger
               D-24 width (H 32 over Hkv 8 on internvl3-14b's layout; the
               ViT at H 16 on its packings), each row's further cases
               under ``cases``; the refresh kernels and rope_shift also at
               internvl3-14b-smoke's LM (H 4, D 64) and flash_packed at
               its ViT (D 32).  Then the dense mha (a library GEMM, no
               row): at whisper-large-v3's cross-attention and
               internvl3-14b's encode_full against the f32-widened
               formula within HEAD_TOL, with no f32 copy of K, V or P and
               a peak below the widened formula's.
     (c) contracts — every eligibility rule of kernels/contracts.py
               provoked once on the card (kernels.audit.refusal_cases):
               the call must raise KernelIneligibleError naming the rule,
               with no launch; the same call on CPU tensors must record the
               same code in ops.card_verdicts() and equal the plain
               version.  Every op once at the full serving widths
               (kernels.audit.serving_cases: internvl3-14b's LM and ViT,
               448^2 frames, mamba2-2.7b's SSD): the registry takes it on
               meta tensors and it launches on the card.  Then the host
               time per call of ops.mv_sad, ops.ssd_scan and
               ops.flash_refresh_paged and of their CUDA wrappers at
               serving shapes (``--only hosttime`` prints these alone, for
               a parent/change A/B).  card_verdicts() is set to 0 before
               phase 4; after phase 7 it must hold only "ok", and every
               window served in phases 4, 5 and 7 must report
               kernel_fallbacks 0.
  4. serve   — internvl3-14b at full width and depth with random weights
               made on the card from a seed: 2 streams x 24 frames at
               448^2 (one fresh and two incremental windows each) through
               the lockstep Scheduler (as every run of this phase and of
               phase 6), mode codecflow on the paged bf16
               slab.  Every kernel of that path must have launched
               during this run, and no plain version may have run on a
               CUDA tensor.  Then, with the same weights, the same
               serve once per further path: codecflow on per-stream
               caches, codecflow with int8 cold pages, and the baselines
               fullcomp, prune_only, refresh_only, vlcache and cacheblend;
               each must launch its path's kernels with no plain call on a
               CUDA tensor.  The int8 run must demote pages, and its
               window-0 logits must equal bitwise those of the bf16 paged
               run served one stream at a time (the int8 run admits its
               streams one after the other, so each window 0 is a batch
               of one there).  The padded ViT
               (PruneCfg(packed_vit=False)) in prune_only and codecflow
               must launch no flash_packed, its window-0 logits must
               agree with the packed path's within the composite
               tolerance, and window 0's FLOP ledger must give
               vit_padded_flops / vit_packed_flops >= 1.5 (the
               reference's gate); encode seconds and ViT slots are
               printed beside the packed path's.  Then the SSM family: mamba2-2.7b at full
               width and depth (64 SSD layers, random bf16 weights from
               the seed) with the launcher's 112^2 ViT, 2 streams x 40
               frames (one fresh and six incremental windows each where
               the mode reuses), in codecflow and fullcomp; each must
               launch ssd_scan and its path's other kernels, with no
               plain call on a CUDA tensor.
  5. engines — the lockstep and the stage-pipelined (async) scheduler
               side by side, each run wrapped in EventProtocolValidator, in
               the order lockstep, async, async, lockstep: (a) internvl3-14b
               codecflow on the paged bf16 slab, four streams of 40, 24, 24
               and 40 frames at 448^2 with max_concurrent 3 (the fourth is
               admitted while two streams are mid-stream); (b) the same
               model on phase 4's fleet; (c) mamba2-2.7b codecflow on phase
               4's fleet; then (d) codecflow with int8 cold pages, async
               once.  Every run must launch its path's kernels with no
               plain call on a CUDA tensor, and both engines must deliver
               the same events per stream.  In (b) and (c) the groups are
               the same in both engines and the yes/no logits must be
               bitwise equal; in (a), and in (d) against phase 4's lockstep
               int8 run, within the composite phase's tolerance, answers
               equal where the margin exceeds twice it; (d) must demote
               pages.  Each run prints wall time and windows/s, stage busy
               seconds, the stage-span share (the event-timed stage spans
               over the wall: on one stream they do not overlap, so it
               bounds the card's busy share from above), synchronising
               calls per window (those torch.cuda.set_sync_debug_mode
               reports, by main and ingest threads and call site, and the
               finalize waits) and peak memory.
  6. composite — one fresh and one incremental window group at full width
               and 4 layers, through the kernels and then through
               kernel_mode("plain"), for codecflow and for each further
               path of internvl3-14b, and for both paths of mamba2-2.7b;
               the yes/no logits must agree.
  7. families — the MoE and hybrid families, with the launcher's 112^2
               ViT and random bf16 weights made on the card from the seed,
               each model's weights freed before the next: (a)
               olmoe-1b-7b at full width and depth (16 layers, d 2048, 64
               experts top-8), codecflow on the paged bf16 slab, 2 streams
               x 24 frames; (b) jamba-v0.1-52b at full width with 16 of its
               32 layers (d 4096, 32/8 heads, 16 experts top-2, SSD
               d_state 16), codecflow and fullcomp through the recurrent
               backend, 2 streams x 40 frames.  Each case is served
               lockstep, async, async, lockstep as in phase 5, with the
               same checks and printout (and the state bytes per stream
               of the hybrid's attention caches and SSD states); the
               yes/no logits of all four runs must be bitwise equal.
               Before each case one MoE layer is called at the largest
               serving shape and at a decode step's: it must report no
               sync and repeat bitwise; its dispatch buffer, measured
               peak and time beside its bytes bound are printed.
               Then each path's composite check, as in phase 6, through
               the first layers of the same weights (olmoe 4, jamba 8:
               one period of its pattern), the plain run taking the
               kernel run's expert choices (a bf16 step can move a near
               tie; the tokens that would have chosen otherwise are
               counted and printed).
  8. train — (a) one train step of whisper-large-v3-smoke (with remat)
               and of olmoe-1b-7b-smoke (the CPU run's expert choices
               forced on the card) on the card and on the CPU, from the
               same weights and batch: loss within 1e-3 and grad_norm
               1e-2 relative, every gradient leaf within 2^-5 of its
               largest |g| (the CPU tests' limits); (b) whisper-large-v3
               at full size (2.02 B parameters, random bf16 weights from
               the seed) trained 4 steps through launch.train.train
               (remat, batch 2, decoder seq 448, 1500 stub encoder
               features): loss and grad_norm finite at every step, every
               leaf moved, no plain call on a CUDA tensor; printing peak
               memory, the time of steps 2-4, tokens/s and the model
               FLOPs (8 x parameters met x positions) over the bf16 peak;
               one more step under torch.profiler (the largest kernels
               and the device time by kernel group); then with the
               trained weights the encoder, the cross K/V, a 32-token
               prefill and 2 decode steps over 128-slot per-stream caches,
               which must launch flash_refresh in every layer with no
               plain call, and whose logits must agree with
               kernel_mode("plain")'s within the composite tolerance;
               (c) the bigram task (tests/test_training.py's recipe):
               the loss must fall by more than 0.3 in 120 steps; (d) the
               anomaly task: train_tiny_vlm on benchmarks/common.py's
               recipe and model (LM d 96, 4 heads over 2; ViT d 96, 4
               heads: head dim 24 in both), the NLL falling; its
               checkpoint saved, reloaded and bitwise equal; fullcomp and
               codecflow (paged bf16, lockstep) served on 6 held-out
               videos x 28 frames (seed 100) with the trained weights
               handed over as trainable leaves: each must launch its
               kernels with no plain call on a CUDA tensor and no output
               that requires grad, and its yes/no logits over the 24
               windows must agree with the same windows served under
               kernel_mode("plain") within the composite tolerance
               (flash_packed at ViT D 24, the refresh kernels and
               rope_shift at the LM's H 4 / Hkv 2 / D 24); precision,
               recall and F1 printed per mode, with codecflow's F1 drop
               (not gated).  Phase 3 also holds flash_refresh at
               whisper's prefill and decode shapes.
  9. mesh    — (a) one train step of whisper-large-v3-smoke and
               olmoe-1b-7b-smoke under a 1x1 DeviceMesh over a
               world-size-1 NCCL group (parameters placed by the sharding
               rules as DTensors) against the same step without a mesh,
               from the same weights and batch: loss, grad_norm and every
               parameter bitwise equal, or else within (a)'s limits of
               phase 8 (the phase prints which held); the same for phase
               8(b)'s whisper-large-v3 at full size over 3 steps, each
               step timed on the mesh and without it (DTensor's host
               cost at full size), beside phase 8(b)'s step; then
               launch.train.train(mesh_kind="host") for 2 steps; (b)
               analysis.roofline.count_step over one step of phase 8(b)'s
               whisper-large-v3 (full size, batch 2, seq 448): compute and
               memory terms, dominant, useful ratio, and the larger term
               over phase 8(b)'s measured step (the roofline share), which
               must lie in (0, 1.05]; (c) python -m repro_torch.launch.dryrun
               in a subprocess for deepseek-7b train_4k and jamba-v0.1-52b
               prefill_32k on the single (16 x 16) mesh: each report ok
               with finite, positive terms, printing the peak GiB per
               device, the terms, the dominant one, the kernel ops' work
               and the seconds.
 10. examples — examples/torch_quickstart.py, torch_streaming_analytics.py
               (2 streams x 16 frames) and torch_train_anomaly_vlm.py (20
               steps, 4 videos), each a subprocess on the card: exit 0 and
               the lines of their JAX twins.

The two lines before the last are the JSON kernel table and the card's
name and power limit as nvidia-smi gives them; the last line is
{"ok": true, "device": {...}}.  In the table a kernel's ``launches`` is
the count from the run of the path named in ``launches_path``: the
first path that launches it, and for flash_prefill and
flash_prefill_paged, which no serving path calls, this slice's main
path (mamba2-2.7b, codecflow), where they count 0.  ``launches_by_path``
has the count of every path's own run, and of the kernel phase (the
checks and their timing loops; counts set to 0 just before it).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the H100's rates, read from repro_torch.analysis.roofline in main()
HBM_BYTES_PER_S = BF16_TENSOR_FLOPS = F32_FLOPS = None
ARCH = "internvl3-14b"
HW = 448
SSM_ARCH = "mamba2-2.7b"
SSM_HW = 112                     # the launcher's default ViT for mamba2-2.7b
SSM_FRAMES = 40
SSM_PATHS = ("codecflow", "fullcomp")
MOE_ARCH = "olmoe-1b-7b"         # full width and depth, the launcher's 112^2 ViT
MOE_FRAMES = 24
HYBRID_ARCH = "jamba-v0.1-52b"   # full width, HYBRID_LAYERS of its 32 layers
HYBRID_LAYERS = 16               # 2 of 4 periods: ~48 GiB of bf16 weights
HYBRID_FRAMES = 40
HYBRID_PATHS = ("codecflow", "fullcomp")
FAMILY_HW = 112
WHISPER_ARCH = "whisper-large-v3"  # full size: 32 + 32 layers, d 1280, 20 heads (D 64)
WHISPER_BATCH, WHISPER_SEQ, WHISPER_STEPS = 2, 448, 4
WHISPER_PREFILL, WHISPER_DECODE, WHISPER_SLOTS = 32, 2, 128
# benchmarks/common.py's VLM (copied, not imported): head dim 24 in the LM
# (d 96, 4 heads over 2 kv heads) and in the ViT (d 96, 4 heads)
BENCH_LM = dict(name="bench-vlm", family="vlm", n_layers=4, d_model=96, n_heads=4, n_kv=2,
                d_ff=192, vocab=64, tied_embeddings=True)
BENCH_VIT = dict(n_layers=2, d_model=96, n_heads=4, d_ff=192, patch=14, image=112, group=2)
BENCH_CODEC = dict(gop=4, block=16, search_radius=4, window_frames=16, stride_frames=4,
                   keep_ratio=0.5, mv_threshold=0.25)
SMOKE_ARCH = "internvl3-14b-smoke"     # LM D 64 at 4 heads, ViT D 32
WIDE_D24 = dict(n_heads=32, n_kv=8, d_head=24)   # a larger D-24 case on internvl3-14b's layout
SEED = 0
# card step vs CPU step, and the CPU tests' step limits
# (tests/torch_train_parity.py): loss 1e-3 and grad_norm 1e-2 relative,
# every gradient leaf within 2^-5 of its largest |g|
STEP_LOSS_TOL, STEP_GNORM_TOL, STEP_GRAD_TOL = 1e-3, 1e-2, 2.0 ** -5
# attention kernels vs plain: max over (.., head) rows of max |k - p| /
# max |p|.  The refresh and packed kernels round their unnormalised
# probabilities to bf16 and the plain version its normalised ones, and
# both round the output: two bf16 steps (2^-7 relative each) of the row's
# largest value.  The prefill kernels keep the oracle's f32 numerics (P as
# two bf16 halves, about 16 bits), so only the output's rounding differs:
# one bf16 step.
ROW_TOL = 2.0 ** -6
PREFILL_ROW_TOL = 2.0 ** -7
# lm_logits vs the f32 product of its bf16 operands: max over rows of
# max |k - p| / max |p|.  Both sum d_model products in f32, in other
# orders (a few 1e-6 relative); the product rounded to bf16 misses by up
# to 2^-8, and the check requires it to miss this limit on the data.
HEAD_TOL = 2.0 ** -14


# readings one phase leaves for a later one (phase 8(b)'s step time)
READINGS: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float, rate: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


ATTN_STRUCTS = ("RefreshPaged", "Refresh", "PrefillPaged", "Prefill", "Packed")


def kernel_label(mangled: str) -> str:
    """mma_kernel<D, problem struct> of an attention kernel's mangled name
    ("+cold": the struct with int8 cold pages), name<n> of another kernel
    templated on one integer; other names unchanged."""
    d = re.search(r"ILi(\d+)E", mangled)
    struct = next((s for s in ATTN_STRUCTS if s in mangled), None)
    if "mma_kernel" not in mangled or d is None or struct is None:
        m = re.search(r"([a-z_]+_kernel)ILi(\d+)E", mangled)
        return f"{m.group(1)}<{m.group(2)}>" if m else mangled
    cold = "+cold" if "WithColdPages" in mangled else ""
    return f"mma_kernel<{d.group(1)}, {struct}{cold}>"


def ptxas_kernels(text: str):
    """[(kernel, registers, spill bytes)] from nvcc's -Xptxas -v output."""
    found, name, spill = [], None, 0
    for line in text.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spill = m.group(1), 0
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif (m := re.search(r"Used (\d+) registers", line)) and name is not None:
            found.append((kernel_label(name), int(m.group(1)), spill))
            name = None
    return found


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_BYTES = 50 * 2 ** 20          # H100 L2 cache


def device_ms(torch, fn, args, in_bytes: float, replays: int = 5,
              min_copies: int = 8) -> float:
    """Device time per launch of ``fn(*args)``: launches over enough
    copies of ``args`` (at least ``min_copies``) that their ``in_bytes``
    each pass twice the L2 cache (so each launch reads its inputs from
    device memory, as the serving path does), captured in one CUDA graph
    and replayed, timed with CUDA events.  No host time between launches
    enters, where ``cuda_ms``, which times the calls one by one on the
    same inputs, also counts the wrapper's host time when that is
    longer."""
    n = max(min_copies, int(-(-2 * L2_BYTES // max(in_bytes, 1))))
    copies = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                       for _ in range(n - 1)]
    for cp in copies[:2]:
        fn(*cp)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for cp in copies:
            fn(*cp)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * n)
    del graph, copies
    return ms


def attn_errors(torch, out_k, out_p):
    """(max |k - p|, max over (.., head) rows of max |k - p| / max |p|)."""
    d = (out_k.float() - out_p.float()).abs()
    scale = out_p.float().abs().amax(-1, keepdim=True)
    rel = d / scale.clamp_min(torch.finfo(torch.float32).tiny)
    return float(d.max()), float(rel.max())


def codec_cfg():
    from repro_torch.configs import CodecCfg
    return CodecCfg(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ----------------------------------------------------------------------
def check_mv_sad(torch, videos):
    from repro_torch.codec.encoder import motion_compensate
    from repro_torch.kernels.mv_sad import mv_sad_cuda, mv_sad_plain
    block, radius = 16, 4
    cur = torch.as_tensor(videos[0][0][1], device="cuda")
    prev = torch.round(torch.as_tensor(videos[0][0][0], device="cuda") / 2.0) * 2.0
    mv_k, sad_k = mv_sad_cuda(cur, prev, block, radius)
    mv_p, sad_p = mv_sad_plain(cur, prev, block, radius)
    torch.cuda.synchronize()
    hb, wb = sad_p.shape

    def sad_at(mv):
        pred = motion_compensate(prev, mv, block)
        return (cur - pred).abs().reshape(hb, block, wb, block).sum(dim=(1, 3))

    # rule: MVs equal, except a near tie where the kernel's candidate has
    # the plain version's minimal SAD within the f32 summation tolerance
    tol = 1e-4 * torch.clamp(sad_p, min=1.0)
    flipped = (mv_k != mv_p).any(dim=-1)
    near_tie = (sad_at(mv_k) - sad_p).abs() <= tol
    mv_ok = bool((~flipped | near_tie).all())
    err = float((sad_k - sad_p).abs().max())
    ok = mv_ok and bool(((sad_k - sad_p).abs() <= tol).all())
    H, W = cur.shape
    ms = cuda_ms(torch, lambda: mv_sad_cuda(cur, prev, block, radius), 50)
    dev_ms = device_ms(torch, lambda a, b: mv_sad_cuda(a, b, block, radius), (cur, prev),
                       2 * H * W * 4)
    plain = cuda_ms(torch, lambda: mv_sad_plain(cur, prev, block, radius), 10)
    n_bytes = 2 * H * W * 4 + hb * wb * (2 * 4 + 4)
    b_ms, b_by = bound_ms(n_bytes, 3 * H * W * (2 * radius + 1) ** 2, F32_FLOPS)
    log(f"mv_sad: {H}x{W} f32, {hb}x{wb} blocks, radius {radius}: "
        f"max |dSAD| {err:.3g} (tol 1e-4 x SAD), MVs flipped {int(flipped.sum())} "
        f"(all near ties: {mv_ok}); kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the "
        f"device), plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    return ok, dict(name="mv_sad", route="cuda", source="src/repro_torch/csrc/mv_sad.cu",
                    replaces="src/repro/kernels/mv_sad.py:50", max_abs_err=err,
                    ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None)


def check_rope_shift(torch, cfg, layout, n_streams, dtype=None, label=None):
    """The overlap's keys of every layer and stream rotated by the
    window's shift, at ``cfg``'s kv heads and head dim, in bf16 (at D 24
    the kernel's 8-byte path) or ``dtype``."""
    from repro_torch.kernels.rope_shift import rope_shift_cuda, rope_shift_plain
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(1)
    n = cfg.repeats * n_streams
    ov, sh = layout.overlap_tokens, layout.shift_tokens
    k = torch.randn((n, ov, cfg.n_kv, cfg.d_head), generator=g, device="cuda").to(dtype)
    delta = torch.full((n, ov), -sh, dtype=torch.int32, device="cuda")
    out_k = rope_shift_cuda(k, delta, cfg.rope_theta)
    out_p = rope_shift_plain(k, delta, cfg.rope_theta)
    # elementwise: one bf16 step of the value (2^-7 relative; none in f32)
    # plus 1e-3 for the f32 angle (|delta * freq| ~ 640 rad: one f32 ulp
    # of the angle moves the result by ~1e-4 |k|)
    d = (out_k.float() - out_p.float()).abs()
    err = float(d.max())
    step = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    excess = float((d - step * out_p.float().abs()).max())
    ms = cuda_ms(torch, lambda: rope_shift_cuda(k, delta, cfg.rope_theta), 20)
    # internvl3-14b's k alone is 377 MB, past the L2 many times over
    dev_ms = device_ms(torch, lambda a, b: rope_shift_cuda(a, b, cfg.rope_theta), (k, delta),
                       k.numel() * k.element_size(), min_copies=2)
    plain = cuda_ms(torch, lambda: rope_shift_plain(k, delta, cfg.rope_theta), 5)
    n_bytes = 2 * k.numel() * k.element_size() + delta.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 3 * k.numel(), F32_FLOPS)
    name = "rope_shift" if label is None else f"rope_shift ({label})"
    log(f"{name}: k {tuple(k.shape)} {str(dtype)[6:]}, delta {-sh}: max abs err {err:.3g}; "
        f"max (|k-p| - {'2^-7 |p|' if step else '0'}) {excess:.3g} (limit 1e-3); kernel "
        f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return excess <= 1e-3, dict(name="rope_shift", route="cuda",
                            source="src/repro_torch/csrc/rope_shift.cu",
                            replaces="src/repro/kernels/rope_shift.py:40",
                            max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)


REFRESH_CASES = ("fresh prefill", "selective refresh", "decode")


def _refresh_inputs(torch, cfg, layout, cache_slots, n_streams, case: str):
    """Query rows, slab, page table, validity and map shaped as on the
    serving path: fresh prefill ([0, total_len)), the selective refresh
    set, or the first decode step (one query at total_len, keys up to
    it, causal only as in the reference's decode)."""
    import numpy as np
    from repro_torch.core import refresh_block_map
    from repro_torch.kernels.flash_refresh import build_block_map
    rng = np.random.default_rng(3)
    g = torch.Generator(device="cuda").manual_seed(2)
    n_pages = cache_slots // 128
    P = n_pages * n_streams
    pt = torch.as_tensor(rng.permutation(P).reshape(n_streams, n_pages),
                         dtype=torch.int32, device="cuda")
    valid = np.zeros((n_streams, cache_slots), bool)
    for f in range(layout.window):
        sl = layout.frame_token_slice(f)
        valid[:, sl] = True if layout.frame_is_i(f) else rng.random((n_streams, sl.stop - sl.start)) < 0.6
    valid[:, layout.vis_len: layout.total_len] = True
    if case == "fresh prefill":
        bm = build_block_map(np.arange(layout.total_len), cache_slots)
    elif case == "selective refresh":
        bm = refresh_block_map(layout, kv_len=cache_slots)
        valid[:, layout.overlap_tokens: layout.vis_len] = True
    else:
        bm = build_block_map([layout.total_len], cache_slots)
        valid = np.broadcast_to(np.arange(cache_slots) <= layout.total_len,
                                (n_streams, cache_slots)).copy()
    kv_valid = torch.as_tensor(valid, device="cuda")
    Sq = bm.n_q
    q = torch.randn((n_streams, Sq, cfg.n_heads, cfg.d_head), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((P * 128, cfg.n_kv, cfg.d_head), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((P * 128, cfg.n_kv, cfg.d_head), generator=g, device="cuda").to(torch.bfloat16)
    q_pos = torch.as_tensor(bm.q_pos[:Sq], dtype=torch.long, device="cuda")[None].expand(n_streams, Sq)
    return q, k, v, q_pos, kv_valid, pt, bm


def refresh_mask(torch, q_pos, kv_valid):
    """(B, Sq, slots): causal on the query positions AND kv_valid."""
    kpos = torch.arange(kv_valid.shape[1], device="cuda")
    return (kpos[None, None, :] <= q_pos[:, :, None]) & kv_valid[:, None, :]


def check_attention(torch, kernel, plain, library, q, n_kv, mask, key_bytes,
                    extra_bytes, dead_rows_zero=True, tol=ROW_TOL):
    """Hold one attention kernel against its plain version on the same
    inputs: the row-relative error within ``tol`` and, where
    ``dead_rows_zero`` (the refresh kernels), rows with no visible key
    exactly 0.  ``mask`` (B or 1, Sq, slots) bool is the attention mask.
    Times the kernel, the plain version and ``library(mask)``.  The
    bound: q read and the output written once, ``key_bytes(needed)``
    bytes per (kv head, d_head) element summed over the key rows some
    query needs (``needed`` (B, slots) bool) for K and V, plus
    ``extra_bytes`` of masks and tables; 4 D H flops per live (query,
    key) pair.  Returns (ok, readings)."""
    out_k, out_p = kernel(), plain()
    err, rel = attn_errors(torch, out_k, out_p)
    B, Sq, H, D = q.shape
    r = dict(max_abs_err=err, rel=rel, tol=tol)
    if dead_rows_zero:
        r["dead_zero"] = bool((out_k[~mask.expand(B, -1, -1).any(-1)] == 0).all())
    live = float(mask.sum()) * (B // mask.shape[0])
    n_bytes = (2 * q.numel() * 2 + key_bytes(mask.any(1).expand(B, -1)) * n_kv * D * 2
               + extra_bytes)
    b_ms, b_by = bound_ms(n_bytes, 4.0 * D * H * live, BF16_TENSOR_FLOPS)
    r.update(ms=cuda_ms(torch, kernel, 10), plain_ms=cuda_ms(torch, plain, 3),
             library_ms=cuda_ms(torch, lambda: library(mask), 5),
             bound_ms=b_ms, bound_by=b_by)
    return rel <= tol and r.get("dead_zero", True), r


def attention_reading(r, library: str) -> str:
    dead = f", masked rows exact zero: {r['dead_zero']}" if "dead_zero" in r else ""
    return (f"max abs err {r['max_abs_err']:.3g}, max row-relative err {r['rel']:.3g} "
            f"(limit {r['tol']:.3g}){dead}; kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, {library} {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def kernel_row(name, replaces, r):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict(name=name, route="cuda", source="src/repro_torch/csrc/attention.cu",
                replaces=replaces, **{k: r[k] for k in keys})


def with_cases(main, extra: dict):
    """A check's (ok, row) with further cases of the same kernel: each
    case's readings under the row's ``cases``, and ok only if every case
    passed.  The row's other figures stay the main case's."""
    ok, row = main
    for label, (ok_case, r) in extra.items():
        row.setdefault("cases", {})[label] = {
            k: v for k, v in r.items() if k not in ("name", "route", "source", "replaces")}
        ok = ok and ok_case
    return ok, row


def bf16_keys(needed):
    return 2 * float(needed.sum())


def check_flash_refresh_paged(torch, cfg, layout, cache_slots, n_streams, families=()):
    """All three serving shapes are held to ROW_TOL, at ``cfg``'s heads and
    at each of ``families`` ((label, cfg, layout, cache slots) of another
    model's paged path); the kernels line reports ``cfg``'s selective
    refresh's times, the largest error, and every family case's readings
    under ``families``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_refresh import flash_refresh_paged_cuda, flash_refresh_paged_plain
    from repro_torch.kernels.ref import paged_gather_ref
    ok, row, worst, readings = True, None, 0.0, {}
    cases = [(None, cfg, layout, cache_slots, case) for case in REFRESH_CASES] + [
        (label, fcfg, flay, fslots, case) for label, fcfg, flay, fslots in families
        for case in REFRESH_CASES]
    for label, cfg, layout, cache_slots, case in cases:
        q, k, v, q_pos, kv_valid, pt, bm = _refresh_inputs(
            torch, cfg, layout, cache_slots, n_streams, case)
        g = q.shape[2] // k.shape[1]

        def library(mask):
            kg = paged_gather_ref(k, pt, 128).repeat_interleave(g, dim=2).transpose(1, 2)
            vg = paged_gather_ref(v, pt, 128).repeat_interleave(g, dim=2).transpose(1, 2)
            return F.scaled_dot_product_attention(q.transpose(1, 2), kg, vg,
                                                  attn_mask=mask[:, None])

        ok_here, r = check_attention(
            torch, lambda: flash_refresh_paged_cuda(q, k, v, kv_valid, pt, bm),
            lambda: flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, pt), library,
            q, k.shape[1], refresh_mask(torch, q_pos, kv_valid), bf16_keys,
            kv_valid.numel() + pt.numel() * 4)
        worst = max(worst, r["max_abs_err"])
        name = case if label is None else f"{label}, {case}"
        log(f"flash_refresh_paged ({name}): q {tuple(q.shape)} bf16, slab "
            f"{tuple(k.shape)}, {bm.visited} visited tiles of {bm.n_q_tiles}x{bm.n_kv_tiles}: "
            + attention_reading(r, "gather+SDPA"))
        ok = ok and ok_here
        if label is not None:
            readings[name] = dict(q=list(q.shape), slab=list(k.shape), **r)
        elif case == "selective refresh":
            row = kernel_row("flash_refresh_paged", "src/repro/kernels/flash_refresh.py:458", r)
    row["max_abs_err"] = worst
    if readings:
        row["families"] = readings
    return ok, row


def _stream_inputs(torch, cfg, slots, n_streams, offset, T):
    """Query rows, per-stream caches, validity and map of a contiguous
    pass of the recurrent backend's attention layers: T positions from
    ``offset`` over ``slots``; keys up to the pass's last position are
    visible, the chunk's own invalid slots masked (a fifth of them, where
    it holds visual tokens: more than 8), earlier ones kept as the
    reference keeps them."""
    import numpy as np
    from repro_torch.kernels.flash_refresh import build_block_map
    rng = np.random.default_rng(6)
    g = torch.Generator(device="cuda").manual_seed(7)
    valid = np.broadcast_to(np.arange(slots) < offset + T, (n_streams, slots)).copy()
    if T > 8:
        valid[:, offset:offset + T] &= rng.random((n_streams, T)) < 0.8
    bm = build_block_map(np.arange(offset, offset + T), slots)
    q = torch.randn((n_streams, T, cfg.n_heads, cfg.d_head), generator=g,
                    device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((n_streams, slots, cfg.n_kv, cfg.d_head), generator=g,
                        device="cuda").to(torch.bfloat16) for _ in range(2))
    q_pos = torch.arange(offset, offset + T, device="cuda")[None].expand(n_streams, T)
    return q, k, v, q_pos, torch.as_tensor(valid, device="cuda"), bm


def check_flash_refresh(torch, cases, n_streams, families=()):
    """The per-stream kernel on the logical view of the same inputs as
    the paged checks: (label, cfg, layout, cache slots, refresh case) per
    row of ``cases``; then each of ``families`` ((label, cfg, cache slots,
    offset, T): a contiguous pass of the recurrent backend's attention
    layers, ``_stream_inputs``).  The kernels line reports the selective
    refresh's times, the largest error, and every family case's readings
    under ``families``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_refresh import flash_refresh_cuda, flash_refresh_plain
    from repro_torch.kernels.ref import paged_gather_ref
    ok, row, worst, readings = True, None, 0.0, {}
    for label, fcfg, slots, offset, T in families:
        q, k, v, q_pos, kv_valid, bm = _stream_inputs(torch, fcfg, slots, n_streams, offset, T)
        ok_here, r = check_attention(
            torch, lambda: flash_refresh_cuda(q, k, v, kv_valid, bm),
            lambda: flash_refresh_plain(q, k, v, q_pos, kv_valid),
            lambda mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=True),
            q, k.shape[2], refresh_mask(torch, q_pos, kv_valid), bf16_keys, kv_valid.numel())
        worst = max(worst, r["max_abs_err"])
        log(f"flash_refresh ({label}): q {tuple(q.shape)} bf16 at positions "
            f"[{offset}, {offset + T}), caches {tuple(k.shape)}, {bm.visited} visited tiles "
            f"of {bm.n_q_tiles}x{bm.n_kv_tiles}: " + attention_reading(r, "SDPA"))
        ok = ok and ok_here
        readings[label] = dict(q=list(q.shape), caches=list(k.shape), **r)
        del q, k, v
    for label, cfg, layout, slots, case in cases:
        q, ks, vs, q_pos, kv_valid, pt, bm = _refresh_inputs(
            torch, cfg, layout, slots, n_streams, case)
        k, v = paged_gather_ref(ks, pt, 128), paged_gather_ref(vs, pt, 128)
        del ks, vs
        ok_here, r = check_attention(
            torch, lambda: flash_refresh_cuda(q, k, v, kv_valid, bm),
            lambda: flash_refresh_plain(q, k, v, q_pos, kv_valid),
            lambda mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=True),
            q, k.shape[2], refresh_mask(torch, q_pos, kv_valid), bf16_keys, kv_valid.numel())
        worst = max(worst, r["max_abs_err"])
        log(f"flash_refresh ({label}): q {tuple(q.shape)} bf16, caches {tuple(k.shape)}, "
            f"{bm.visited} visited tiles of {bm.n_q_tiles}x{bm.n_kv_tiles}: "
            + attention_reading(r, "SDPA"))
        ok = ok and ok_here
        if label == "selective refresh":
            row = kernel_row("flash_refresh", "src/repro/kernels/flash_refresh.py:236", r)
        else:
            readings[label] = dict(q=list(q.shape), caches=list(k.shape), **r)
    row["max_abs_err"] = worst
    if readings:
        row["families"] = readings
    return ok, row


def cold_pages(torch, k, v, pt, D):
    """Each stream's pages [0, D) quantised into an int8 cold slab with
    per-(page, kv head) scales, as demotion leaves them.  Returns (cold
    group, the page table naming them, (B, slots) cold mask)."""
    from repro_torch.models.layers import page_quant_scale, quantize_kv
    n_hot, n_kv, dh = k.shape[0] // 128, k.shape[1], k.shape[2]
    n_streams = pt.shape[0]
    src = pt[:, :D].reshape(-1).long()
    rows = (src[:, None] * 128 + torch.arange(128, device="cuda")).reshape(-1)

    def quant(slab):
        pages = slab[rows].reshape(-1, 128, n_kv, dh)
        sc = page_quant_scale(pages, (1, 3))                       # (n_cold, n_kv)
        return quantize_kv(pages, sc[:, None, :]).reshape(-1, n_kv, dh), sc

    (k8, ks), (v8, vs) = quant(k), quant(v)
    pt8 = pt.clone()
    pt8[:, :D] = n_hot + torch.arange(n_streams * D, dtype=torch.int32,
                                      device="cuda").reshape(n_streams, D)
    return (k8, v8, ks, vs), pt8, (pt8 >= n_hot).repeat_interleave(128, dim=1)


def check_flash_refresh_paged_int8(torch, cfg, layout, cache_slots, n_streams, n_cold=None,
                                   label=None):
    """The two-precision kernel at the selective refresh: each stream's
    overlap pages [0, D) (15 of 21 at internvl3-14b; ``n_cold`` where
    given) quantised into an int8 cold slab with per-(page, kv head)
    scales, as demotion leaves them.  Held to the plain version
    (dequant-gather + the same attention); with every entry hot it must
    equal the bf16 kernel bitwise."""
    import torch.nn.functional as F
    from repro_torch.core import demotable_pages
    from repro_torch.kernels.flash_refresh import (
        flash_refresh_paged_cuda, flash_refresh_paged_plain,
    )
    from repro_torch.kernels.ref import paged_gather
    q, k, v, q_pos, kv_valid, pt, bm = _refresh_inputs(
        torch, cfg, layout, cache_slots, n_streams, "selective refresh")
    n_kv = k.shape[1]
    D = len(demotable_pages(layout)) if n_cold is None else n_cold
    cold, pt8, is_cold = cold_pages(torch, k, v, pt, D)
    k8, ks = cold[0], cold[2]

    def library(mask):
        kg, vg = paged_gather(k, v, pt8, 128, cold)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True)

    def key_bytes(needed):    # int8 rows at 1 B, bf16 rows at 2 B
        cold_keys = float((needed & is_cold).sum())
        return 2 * (float(needed.sum()) - cold_keys) + cold_keys

    ok, r = check_attention(
        torch, lambda: flash_refresh_paged_cuda(q, k, v, kv_valid, pt8, bm, cold=cold),
        lambda: flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, pt8, cold=cold),
        library, q, n_kv, refresh_mask(torch, q_pos, kv_valid), key_bytes,
        kv_valid.numel() + pt8.numel() * 4 + 2 * ks.numel() * 4)
    out_bf16 = flash_refresh_paged_cuda(q, k, v, kv_valid, pt, bm)
    all_hot = torch.equal(flash_refresh_paged_cuda(q, k, v, kv_valid, pt, bm, cold=cold),
                          out_bf16)
    _, quant_rel = attn_errors(
        torch, flash_refresh_paged_cuda(q, k, v, kv_valid, pt8, bm, cold=cold), out_bf16)
    log(f"flash_refresh_paged_int8 ({label or 'selective refresh'}): q {tuple(q.shape)} bf16, "
        f"hot slab "
        f"{tuple(k.shape)}, cold slab {tuple(k8.shape)} int8, {D} of {pt.shape[1]} pages "
        f"per stream cold, all-hot bitwise equal to bf16 kernel: {all_hot}, row-relative "
        f"change from quantisation {quant_rel:.3g}: " + attention_reading(r, "dequant-gather+SDPA"))
    return ok and all_hot, kernel_row("flash_refresh_paged_int8",
                                      "src/repro/kernels/flash_refresh.py:380", r)


def packings(torch, pipe, streams):
    """(label, PackPlan) of the three packings flash_packed is held at,
    all of the 24 P-frames of window 0 of both streams: the serve path's
    own (its motion masks), busy (every frame keeps its whole budget of
    capacity groups: select_tokens on all-dynamic masks) and mixed (each
    frame keeps a count of groups drawn from a seeded generator in [1,
    budget], so segments share rows and cross 128-slot tiles)."""
    import numpy as np
    from repro_torch.core import motion_mask, pack_plan, select_tokens
    lay, v = pipe.layout, pipe.v
    metas = [pipe.frontend.window(cs, 0)[1] for cs in streams]
    p_idx = [f for f in range(lay.window) if not lay.frame_is_i(f)]
    dyn, sco = zip(*(motion_mask(m, pipe.ecfg.codec, v.patches_per_side) for m in metas))
    dsel = torch.stack(dyn)[:, p_idx].flatten(0, 1)
    ssel = torch.stack(sco)[:, p_idx].flatten(0, 1)
    T, gs, g = dsel.shape[0], v.groups_per_side, v.group
    rng = np.random.default_rng(8)
    gdyn = np.zeros((T, v.n_groups), bool)
    for f, n in enumerate(rng.integers(1, lay.k_tokens + 1, T)):
        gdyn[f, rng.choice(v.n_groups, n, replace=False)] = True
    mixed = torch.as_tensor(np.repeat(np.repeat(gdyn.reshape(T, gs, gs), g, 1), g, 2),
                            device=dsel.device)
    return [(label, pack_plan(select_tokens(d, ssel, v, lay.k_tokens), v))
            for label, d in (("serve", dsel), ("busy", torch.ones_like(dsel)),
                             ("mixed", mixed))]


def check_flash_packed(torch, pipe, streams, heads=None, label=None):
    """The kernel through ops.flash_packed, as the ViT calls it, at the
    three packings of ``packings``: each against the plain version
    (ROW_TOL, padding exact zero) and masked SDPA, timed per call and on
    the device, at the pipeline ViT's heads or ``heads`` (H, D).  The
    kernels line reports the serve packing's times, the largest error,
    and every packing's readings under ``packings``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_packed import flash_packed_plain
    v = pipe.v
    H, D = heads or (v.n_heads, v.d_model // v.n_heads)
    name = "flash_packed" if label is None else f"flash_packed [{label}]"
    g = torch.Generator(device="cuda").manual_seed(4)
    ok, row, worst, readings = True, None, 0.0, {}
    for label_p, plan in packings(torch, pipe, streams):
        R, L = plan.seg_id.shape
        q, k, vv = (torch.randn((R, L, H, D), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(3))
        seg = torch.as_tensor(plan.seg_id, device="cuda")
        bm = plan.block_map

        def kernel(q_=q, k_=k, v_=vv, seg=seg, bm=bm):
            return ops.flash_packed(q_, k_, v_, seg, bm)

        out_k = kernel()
        out_p = flash_packed_plain(q, k, vv, seg)
        err, rel = attn_errors(torch, out_k, out_p)
        pad_zero = bool((out_k[seg < 0] == 0).all())
        ms = cuda_ms(torch, kernel, 20)
        dev_ms = device_ms(torch, kernel, (q, k, vv), 3 * q.numel() * 2)
        plain = cuda_ms(torch, lambda: flash_packed_plain(q, k, vv, seg), 5)
        mask = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask[:, None]), 10)
        live = float((seg >= 0).sum())
        n_bytes = live * H * D * 2 * 3 + q.numel() * 2 + seg.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * D * H * float(mask.sum()), BF16_TENSOR_FLOPS)
        log(f"{name} ({label_p}): {plan.n_frames} P-frames packed into ({R}, {L}), H {H}, "
            f"D {D}, {bm.visited} visited tiles, fill {plan.fill:.3f}: max abs err {err:.3g}, "
            f"max row-relative err {rel:.3g} (limit {ROW_TOL:.3g}), padding exact zero: "
            f"{pad_zero}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain "
            f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        ok = ok and rel <= ROW_TOL and pad_zero
        worst = max(worst, err)
        readings[label_p] = dict(shape=[R, L], visited=bm.visited, max_abs_err=err, rel=rel,
                                 ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b_ms, bound_by=b_by)
        if label_p == "serve":
            row = dict(name="flash_packed", route="cuda",
                       source="src/repro_torch/csrc/attention.cu",
                       replaces="src/repro/kernels/flash_packed.py:211", max_abs_err=err,
                       ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib)
        del q, k, vv, out_k, out_p, mask
    row["max_abs_err"] = worst
    row["packings"] = readings
    return ok, row


def widened_mha(torch, q, k, v, causal: bool = False, q_chunk: int = 1024):
    """The dense mha's formula with K, V and P widened to f32 (the port's
    CPU path, and its card path before the bf16 products), unmasked but
    for ``causal``, on the card; the output is not rounded."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    kf, vf = k.float(), v.float()
    outs = []
    for i in range(0, Sq, q_chunk):
        qc = q[:, i:i + q_chunk]
        Tq = qc.shape[1]
        qq = (qc.float() * dh ** -0.5).to(k.dtype).reshape(B, Tq, K, H // K, dh)
        logits = torch.einsum("btkgd,bskd->bkgts", qq.float(), kf)
        if causal:
            m = (torch.arange(Sk, device="cuda")[None, :]
                 <= torch.arange(i, i + Tq, device="cuda")[:, None])
            logits = logits.masked_fill(~m, -1e30)
        p = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgts,bskd->btkgd", p.float(), vf).reshape(B, Tq, H, dh))
    return torch.cat(outs, 1)


def widenings(torch):
    """A dispatch mode that records the element count of every bf16 ->
    f32 conversion (``_to_copy``, or ``copy_`` into an f32 tensor) made
    while it is active."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten

    class Widenings(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.numels = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            src = args[0] if func is aten._to_copy.default else (
                args[1] if func is aten.copy_.default else None)
            dst = out if func is aten._to_copy.default else args[0]
            if (src is not None and torch.is_tensor(src) and src.dtype == torch.bfloat16
                    and dst.dtype == torch.float32):
                self.numels.append(src.numel())
            return out
    return Widenings()


def mha_probe(torch) -> bool:
    """The dense ``layers.mha`` on the card (bf16 tensor-core products
    with f32 outputs) at whisper-large-v3's cross-attention (B 2, 448
    queries over 1500 keys, H 20, D 64) and at internvl3-14b's
    encode_full (24 frames x 1024 patches, H 16, D 64), unmasked as
    both callers run it.  Three checks: (1) against the f32-widened
    formula on the same operands within HEAD_TOL of each row's largest
    value; operands lie on a grid of 2^-3, so every score is exact in
    f32 whatever the summation order and both round P alike (a last-bit
    difference can flip a bf16 rounding of P, which moves a row by up
    to 2^-8 p |v|); the query is f32, so the output is not rounded;
    (2) no f32 copy of K, V or P: no bf16 -> f32 conversion of their
    size runs inside the mha (the widened formula makes three); (3) its
    peak above its inputs below the widened formula's.  Each peak is
    printed beside the f32 copy of K and V and one query chunk's f32
    scores, and both times."""
    from repro_torch.models.layers import mha
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cases = (("whisper-large-v3 cross-attention", 2, 448, 1500, 20, 20, 64),
             ("internvl3-14b encode_full", 24, 1024, 1024, 16, 16, 64))
    ok = True
    for label, B, Sq, Sk, H, K, D in cases:
        def grid(*shape):
            return torch.randint(-8, 9, shape, generator=g, device="cuda").float() / 8
        q = grid(B, Sq, H, D)
        k, v = grid(B, Sk, K, D).bfloat16(), grid(B, Sk, K, D).bfloat16()
        qpos = torch.zeros((B, Sq), dtype=torch.int32, device="cuda")
        kpos = torch.zeros((B, Sk), dtype=torch.int32, device="cuda")
        p_numel = B * H * min(Sq, 1024) * Sk
        runs = {}
        for name, fn in (("mha", lambda: mha(q, k, v, qpos, kpos, None, causal=False)),
                         ("widened", lambda: widened_mha(torch, q, k, v))):
            gc.collect()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad(), widenings(torch) as w:
                out = fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            big = [n for n in w.numels if n in (k.numel(), v.numel(), p_numel)]
            runs[name] = (out, peak, big, cuda_ms(torch, fn, 3))
            del out
        (out, peak, big, ms), (want, peak_w, big_w, ms_w) = runs["mha"], runs["widened"]
        scale = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        rel = float(((out - want).abs() / scale).max())
        kv32 = 2 * k.numel() * 4
        scores = p_numel * 4
        here = (out.dtype == torch.float32 and rel <= HEAD_TOL and not big
                and len(big_w) >= 3 and peak < peak_w)
        log(f"mha ({label}): q {tuple(q.shape)}, k/v {tuple(k.shape)} bf16: max row-relative "
            f"err vs the widened formula {rel:.3g} (limit {HEAD_TOL:.3g}); bf16 -> f32 "
            f"conversions of K/V/P size {len(big)} (the widened formula's {len(big_w)}); peak "
            f"above inputs {peak / 2**20:.1f} MiB vs the widened formula's "
            f"{peak_w / 2**20:.1f} MiB (an f32 copy of K and V {kv32 / 2**20:.1f} MiB, one "
            f"chunk's f32 scores {scores / 2**20:.1f} MiB); {ms:.4f} ms vs {ms_w:.4f} ms "
            f"widened: {'ok' if here else 'FAIL'}")
        ok = ok and here
        del q, k, v, out, want, runs
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def check_lm_head(torch, cfg, params):
    """The LM head keeps its f32 result on the card (one bf16 GEMM with
    an f32 output): ``lm_logits`` of 8 random rows, through ``cfg``'s
    untied head and tied to its embedding, against the f32 product of
    the same bf16 operands, within HEAD_TOL of each row's largest logit,
    where the bf16-rounded product must miss that limit."""
    from repro_torch.models.transformer import lm_logits
    g = torch.Generator(device="cuda").manual_seed(SEED)
    h = torch.randn(8, cfg.d_model, generator=g, device="cuda").bfloat16()
    ok = True
    for tied in (False, True):
        head = params["embed"].T if tied else params["lm_head"]
        out = lm_logits(dataclasses.replace(cfg, tied_embeddings=tied), params, h)
        ref = torch.cat([h.float() @ head[:, i:i + 16384].float()
                         for i in range(0, head.shape[1], 16384)], dim=-1)
        scale = ref.abs().amax(-1, keepdim=True)
        rel = ((out.float() - ref).abs() / scale).max().item()
        rel_bf16 = ((ref.bfloat16().float() - ref).abs() / scale).max().item()
        f32 = out.dtype == torch.float32
        log(f"lm_logits ({'tied' if tied else 'untied'} head {tuple(head.shape)}): "
            f"f32 output {f32}, max row-relative err {rel:.3g} (limit {HEAD_TOL:.3g}); "
            f"the bf16-rounded product {rel_bf16:.3g}")
        ok = ok and f32 and rel <= HEAD_TOL < rel_bf16
    return ok


def check_ssd_scan(torch):
    """ssd_scan at the serving shapes of mamba2-2.7b (B 2, H 80, P 64,
    N 128, G 1: a fresh window L 160, an incremental one L 40 and the
    query L 8, each from a non-zero state), a long prefill (L 4096, 16
    chunks of 256), a ragged one (L 1000), groups G 4 at a small width,
    and jamba-v0.1-52b's three serving shapes (H 128, P 64, N 16).  y
    (bf16) row-relative within one bf16 step: both round f32
    values that differ by the summation order.  The f32 state within
    1e-4 of each (b, head) state's largest value: sums of up to 256
    terms and the cumulative log-decay in another order (a block scan
    against a sequential cumsum), the latter entering through exp; the
    kernel's f32 factors enter the tensor-core products as bf16 hi + lo
    (about 16 bits, 2^-17 relative per product).  The
    kernels line reports the fresh window's times (its longest launch on
    the path) and the largest error."""
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda, ssd_scan_plain, ssd_scan_work
    cases = (("fresh window", 2, 160, 80, 64, 1, 128, 256, True),
             ("incremental window", 2, 40, 80, 64, 1, 128, 256, True),
             ("query", 2, 8, 80, 64, 1, 128, 256, True),
             ("long prefill", 1, 4096, 80, 64, 1, 128, 256, False),
             ("ragged prefill", 1, 1000, 80, 64, 1, 128, 256, True),
             ("groups", 2, 300, 16, 32, 4, 64, 64, True),
             (f"{HYBRID_ARCH} fresh window", 2, 160, 128, 64, 1, 16, 256, True),
             (f"{HYBRID_ARCH} incremental window", 2, 40, 128, 64, 1, 16, 256, True),
             (f"{HYBRID_ARCH} query", 2, 8, 128, 64, 1, 16, 256, True))
    g = torch.Generator(device="cuda").manual_seed(5)
    ok, row, worst = True, None, 0.0
    for label, B, L, H, P, G, N, chunk, with_init in cases:
        x = torch.randn((B, L, H, P), generator=g, device="cuda").bfloat16()
        la = -(torch.rand((B, L, H), generator=g, device="cuda") * 0.999 + 1e-3)
        b, c = ((torch.randn((B, L, G, N), generator=g, device="cuda") * 0.3).bfloat16()
                for _ in range(2))
        init = (torch.randn((B, H, P, N), generator=g, device="cuda")
                if with_init else None)
        y_k, s_k = ssd_scan_cuda(x, la, b, c, init, chunk)
        y_p, s_p = ssd_scan_plain(x, la, b, c, init, chunk)
        y_err, y_rel = attn_errors(torch, y_k, y_p)
        s_d = (s_k - s_p).abs()
        s_rel = float((s_d.amax((-1, -2)) / s_p.abs().amax((-1, -2)).clamp_min(
            torch.finfo(torch.float32).tiny)).max())
        err = max(y_err, float(s_d.max()))
        worst = max(worst, err)
        flops, n_bytes = ssd_scan_work(L, H, P, G, N, chunk, B)
        in_bytes = sum(t.numel() * t.element_size() for t in (x, la, b, c, init)
                       if t is not None)
        ms = cuda_ms(torch, lambda: ssd_scan_cuda(x, la, b, c, init, chunk), 10)
        dev_ms = device_ms(torch, lambda *a: ssd_scan_cuda(*a, chunk), (x, la, b, c, init),
                           in_bytes)
        plain = cuda_ms(torch, lambda: ssd_scan_plain(x, la, b, c, init, chunk), 3)
        # the products run on the tensor cores: the bound is the larger of
        # the bytes and the flops at the bf16 rate; the f32 CUDA-core
        # figure of the first port is printed beside it
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_TENSOR_FLOPS)
        f32_ms = flops / F32_FLOPS * 1e3
        here = y_rel <= 2.0 ** -7 and s_rel <= 1e-4
        log(f"ssd_scan ({label}): x {tuple(x.shape)} bf16, b/c {tuple(b.shape)} bf16, "
            f"chunk {chunk}, init {'yes' if with_init else 'zeros'}: y max abs err "
            f"{y_err:.3g}, row-relative {y_rel:.3g} (limit {2.0 ** -7:.3g}); state max abs "
            f"err {float(s_d.max()):.3g}, relative {s_rel:.3g} (limit 1e-4); kernel "
            f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain {plain:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}): bytes "
            f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({n_bytes / 1e6:.4g} MB), bf16 "
            f"tensor {flops / BF16_TENSOR_FLOPS * 1e3:.4f} ms ({flops / 1e9:.4g} GFLOP); "
            f"f32 CUDA cores {f32_ms:.4f} ms")
        ok = ok and here
        if label == "fresh window":
            row = dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
                       replaces="src/repro/kernels/ssd_scan.py:74", max_abs_err=err, ms=ms,
                       device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
    row["max_abs_err"] = worst
    return ok, row


def family_kernel_cases():
    """The attention kernels' cases at the families phase's serving shapes
    (pipelines built without weights, for their layouts): the paged
    kernel at olmoe-1b-7b's heads (H 16 = Hkv 16, D 128, GQA group 1) on
    its codecflow layout, and the per-stream kernel at jamba-v0.1-52b's
    (H 32, Hkv 8, D 128) over its attention caches' max_hist slots: the
    codecflow passes of window 0 and of the last window of a 40-frame
    stream (append, query, the first decode step) and fullcomp's fresh
    append; and the per-stream kernel at whisper-large-v3's decoder
    self-attention (H 20 = Hkv 20, D 64) over phase 8's 128 slots: its
    32-token prefill and first decode step."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import default_vit
    from repro_torch.serving import ServingPipeline

    def layout_of(arch, mode):
        c = get_config(arch)
        return c, ServingPipeline(c, default_vit(c), {}, {}, path_ecfg(mode, {}),
                                  device="cuda")
    mcfg, mp = layout_of(MOE_ARCH, "codecflow")
    paged = [(MOE_ARCH, mcfg, mp.layout, mp.cache_slots)]
    hcfg, hp = layout_of(HYBRID_ARCH, "codecflow")
    _, hf = layout_of(HYBRID_ARCH, "fullcomp")
    lay, slots = hp.layout, hp.cache_slots
    n_new = sum(lay.frame_tokens[f] for f in range(lay.window - lay.stride, lay.window))
    last = (HYBRID_FRAMES - lay.window) // lay.stride          # the last window's index
    off = lay.vis_len + (last - 1) * n_new                     # its append's offset
    q_off = off + n_new
    stream = [
        (f"{HYBRID_ARCH} append, window 0", hcfg, slots, 0, lay.vis_len),
        (f"{HYBRID_ARCH} append, window {last}", hcfg, slots, off, n_new),
        (f"{HYBRID_ARCH} query, window {last}", hcfg, slots, q_off, lay.query_len),
        (f"{HYBRID_ARCH} decode, window {last}", hcfg, slots, q_off + lay.query_len, 1),
        (f"{HYBRID_ARCH} fullcomp append", hcfg, hf.cache_slots, 0, hf.layout.vis_len),
    ]
    wcfg = get_config(WHISPER_ARCH)
    stream += [
        (f"{WHISPER_ARCH} prefill", wcfg, WHISPER_SLOTS, 0, WHISPER_PREFILL),
        (f"{WHISPER_ARCH} decode", wcfg, WHISPER_SLOTS, WHISPER_PREFILL, 1),
    ]
    return paged, stream


def positional_mask(torch, Sq, Sk, q_offset, window, causal=True):
    qpos = torch.arange(Sq, device="cuda")[:, None] + q_offset
    kpos = torch.arange(Sk, device="cuda")[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask[None]


def check_flash_prefill(torch, cfg, total_len, n_streams, only=None, label=None):
    """flash_prefill at internvl3-14b attention widths (H 40, Hkv 8,
    D 128, bf16, 2 streams): causal from position 0, a 512-row chunk at
    offset 2048 against 2560 keys, a 512-key sliding window, and the
    ragged length of a fresh window (total_len rows and keys), and a
    chunk at a negative offset whose first rows see no key (they must be
    the mean of V).  Library: scaled_dot_product_attention with enable_gqa
    and the same mask; where is_causal is the same function (q_offset 0,
    Sq == Sk, no window) its is_causal call is timed beside it.  The
    kernels line reports the causal case's times and the largest error.
    ``only``: the labels of the cases to run; ``label`` names ``cfg``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda, flash_prefill_plain
    g = torch.Generator(device="cuda").manual_seed(6)
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    cases = (("causal", 2048, 2048, None, 0), ("chunk at an offset", 512, 2560, None, 2048),
             ("sliding window", 2048, 2048, 512, 0),
             ("ragged", total_len, total_len, None, 0),
             ("rows with no visible key", 512, 1024, None, -200))
    ok, row, worst = True, None, 0.0
    name = "flash_prefill" if label is None else f"flash_prefill [{label}]"
    for case, Sq, Sk, window, off in cases:
        if only is not None and case not in only:
            continue
        q = torch.randn((n_streams, Sq, H, D), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((n_streams, Sk, Hkv, D), generator=g, device="cuda").bfloat16()
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ok_here, r = check_attention(
            torch, lambda: flash_prefill_cuda(q, k, v, window=window, q_offset=off),
            lambda: flash_prefill_plain(q, k, v, window=window, q_offset=off),
            lambda mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                                        enable_gqa=True),
            q, Hkv, positional_mask(torch, Sq, Sk, off, window), bf16_keys, 0,
            dead_rows_zero=False, tol=PREFILL_ROW_TOL)
        note = ""
        if off == 0 and Sq == Sk and window is None:
            r["sdpa_causal_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 5)
            note = f", SDPA is_causal {r['sdpa_causal_ms']:.4f} ms"
        if off < 0:
            n_dead = -off
            mean_v = v.float().mean(1, keepdim=True).repeat_interleave(H // Hkv, dim=2)
            _, dead_rel = attn_errors(torch, flash_prefill_cuda(q, k, v, q_offset=off)[:, :n_dead],
                                      mean_v.expand(-1, n_dead, -1, -1))
            note = (f", rows without keys vs the mean of V: row-relative err "
                    f"{dead_rel:.3g} (limit {PREFILL_ROW_TOL:.3g})")
            ok_here = ok_here and dead_rel <= PREFILL_ROW_TOL
        worst = max(worst, r["max_abs_err"])
        log(f"{name} ({case}): q {tuple(q.shape)} bf16, k/v {tuple(k.shape)}, "
            f"q_offset {off}, window {window}: " + attention_reading(r, "SDPA") + note)
        ok = ok and ok_here
        if case == "causal":
            row = kernel_row("flash_prefill", "src/repro/kernels/flash_prefill.py:79", r)
            row["sdpa_causal_ms"] = r["sdpa_causal_ms"]
    row["max_abs_err"] = worst
    return ok, row


def check_flash_prefill_paged(torch, cfg, layout, cache_slots, n_streams, n_cold=None,
                              label=None):
    """flash_prefill_paged at the fresh prefill of internvl3-14b
    (total_len queries from position 0 over cache_slots logical keys) on
    a shuffled slab, bf16 and with each stream's pages [0, D) (15 of 21)
    int8 cold (``n_cold`` where given); the int8 kernel with every entry
    hot must equal the bf16 kernel bitwise.  Library: gather (+ dequant)
    + SDPA.  Returns ((ok, bf16 row), (ok, int8 row))."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core import demotable_pages
    from repro_torch.kernels.flash_prefill import (
        flash_prefill_paged_cuda, flash_prefill_paged_plain,
    )
    from repro_torch.kernels.ref import paged_gather
    rng = np.random.default_rng(7)
    g = torch.Generator(device="cuda").manual_seed(7)
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    n_pages = cache_slots // 128
    P = n_pages * n_streams
    pt = torch.as_tensor(rng.permutation(P).reshape(n_streams, n_pages), dtype=torch.int32,
                         device="cuda")
    Sq = layout.total_len
    q = torch.randn((n_streams, Sq, H, D), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((P * 128, Hkv, D), generator=g, device="cuda").bfloat16()
            for _ in range(2))
    mask = positional_mask(torch, Sq, cache_slots, 0, None)
    n_cold = len(demotable_pages(layout)) if n_cold is None else n_cold
    cold, pt8, is_cold = cold_pages(torch, k, v, pt, n_cold)
    rows = []
    name = "flash_prefill_paged" if label is None else f"flash_prefill_paged [{label}]"
    for case, table, grp in (("bf16", pt, None), ("int8", pt8, cold)):
        def library(mask, table=table, grp=grp):
            kg, vg = paged_gather(k, v, table, 128, grp)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=True)

        def key_bytes(needed, grp=grp):     # int8 rows at 1 B, bf16 rows at 2 B
            cold_keys = float((needed & is_cold).sum()) if grp is not None else 0.0
            return 2 * (float(needed.sum()) - cold_keys) + cold_keys

        extra = pt.numel() * 4 + (0 if grp is None else 2 * cold[2].numel() * 4)
        ok, r = check_attention(
            torch, lambda table=table, grp=grp: flash_prefill_paged_cuda(q, k, v, table,
                                                                         cold=grp),
            lambda table=table, grp=grp: flash_prefill_paged_plain(q, k, v, table, cold=grp),
            library, q, Hkv, mask, key_bytes, extra, dead_rows_zero=False,
            tol=PREFILL_ROW_TOL)
        note = ""
        if grp is not None:
            all_hot = torch.equal(flash_prefill_paged_cuda(q, k, v, pt, cold=grp),
                                  flash_prefill_paged_cuda(q, k, v, pt))
            note = (f", {n_cold} of {n_pages} pages per stream cold, "
                    f"all-hot bitwise equal to bf16 kernel: {all_hot}")
            ok = ok and all_hot
        log(f"{name} ({case}): q {tuple(q.shape)} bf16, slab {tuple(k.shape)}, "
            f"{n_pages} shuffled pages per stream{note}: "
            + attention_reading(r, "gather+SDPA" if grp is None else "dequant-gather+SDPA"))
        row_name = "flash_prefill_paged" if grp is None else "flash_prefill_paged_int8"
        rows.append((ok, kernel_row(row_name, "src/repro/kernels/flash_prefill.py:258", r)))
    return rows


# ----------------------------------------------------------------------
# phases 4 and 5
# ----------------------------------------------------------------------
def serve(torch, pipe, videos, on_event=None):
    """Drive the serving path once through the lockstep engine; returns
    per-stream window stats.  ``on_event`` sees every scheduler event as
    it occurs."""
    import numpy as np
    from repro_torch.serving import Scheduler, SchedulerCfg, StreamRequest
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=len(videos), pipelined=False))
    t0 = time.perf_counter()
    sids = [sched.submit(StreamRequest(i, np.asarray(f), tag=lab))
            for i, (f, lab) in enumerate(videos)]
    for ev in sched.events():
        if on_event is not None:
            on_event(ev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    results = [sched.session(s).results for s in sids]
    tally_fallbacks(results)
    return sched, results, wall


# (label, mode, KVCfg overrides and packed_vit) of the paths served after
# codecflow on the paged bf16 slab; "codecflow, bf16, one stream at a
# time" is the reference of the int8 run's window 0, and each padded-ViT
# path's window 0 is held to its packed twin's (PADDED)
PATHS = (
    ("codecflow, per-stream KV", "codecflow", dict(paged_kv=False)),
    ("codecflow, bf16, one stream at a time", "codecflow", dict(pool_streams=1)),
    ("codecflow, int8 cold pages", "codecflow", dict(stale_page_dtype="int8")),
    ("fullcomp", "fullcomp", {}),
    ("prune_only", "prune_only", {}),
    ("refresh_only", "refresh_only", {}),
    ("vlcache", "vlcache", {}),
    ("cacheblend", "cacheblend", {}),
    ("prune_only, padded ViT", "prune_only", dict(packed_vit=False)),
    ("codecflow, padded ViT", "codecflow", dict(packed_vit=False)),
)
PADDED = {"prune_only, padded ViT": "prune_only", "codecflow, padded ViT": "codecflow"}


# the path whose own run gives a kernel's "launches" in the kernels line:
# its first path to launch it (the slice-1 kernels: "codecflow", paged
# bf16); the prefill kernels, which no serving path calls, read the SSM
# main path's own count (0)
MAIN = "codecflow"
SSM_MAIN = f"{SSM_ARCH}, codecflow"
KERNEL_PHASE = "kernel phase"
LAUNCH_PATH = {"flash_refresh": "codecflow, per-stream KV",
               "flash_refresh_paged_int8": "codecflow, int8 cold pages",
               "ssd_scan": SSM_MAIN,
               "flash_prefill": SSM_MAIN,
               "flash_prefill_paged": SSM_MAIN,
               "flash_prefill_paged_int8": SSM_MAIN}


def path_ecfg(mode: str, opts: dict):
    """The engine config of a path: ``opts`` are KVCfg fields and
    ``packed_vit``."""
    from repro_torch.serving import EngineCfg, KVCfg, PruneCfg
    kv = {k: v for k, v in opts.items() if k != "packed_vit"}
    return EngineCfg(mode=mode, codec=codec_cfg(), kv=KVCfg(**kv),
                     prune=PruneCfg(packed_vit=opts.get("packed_vit", True)))


def vit_flop_ratio(torch, pipe, videos):
    """The reference's gate of the packed ViT (benchmarks/bench_kernels.py
    :278-281) on window 0's 24 P-frames of ``pipe``'s fleet at keep 0.5:
    vit_padded_flops / vit_packed_flops of the serve packing.  Returns
    (ratio, padded FLOPs, packed FLOPs)."""
    from repro_torch.serving.flops import vit_packed_flops, vit_padded_flops
    streams = [pipe.frontend.open(f) for f, _ in videos]
    plan = dict(packings(torch, pipe, streams))["serve"]
    v, bm = pipe.v, plan.block_map
    pad = vit_padded_flops(v, plan.n_frames, pipe.layout.k_tokens * v.group ** 2)
    pack = vit_packed_flops(v, plan.n_slots, bm.visited, bm.tq, bm.tk, plan.k_pack)
    return pad / pack, pad, pack


def serve_paths(torch, cfg, params, vparams, videos, main_run):
    """Phase 4, further paths: each served once with the counts set to 0
    just before and read just after.  A padded-ViT path must launch no
    flash_packed, its window 0 must agree with its packed twin's (the
    main run, ``main_run``'s (per-stream yes/no logits, encode s, ViT
    slots), for codecflow) within the composite tolerance, and the
    packed path's FLOP ledger must beat it by the reference's gate.
    Returns (ok, launches per path, per-stream yes/no logits per path)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingPipeline, WindowDone
    by_path: dict = {}
    window0: dict = {MAIN: [res[0] for res in main_run[0]]}
    encode = {MAIN: main_run[1:]}
    served: dict = {}
    ok = True
    for label, mode, kv in PATHS:
        pipe = ServingPipeline(cfg, cfg.vit, params, vparams, path_ecfg(mode, kv),
                               device="cuda")
        seen = {}

        def on_event(ev, pipe=pipe, seen=seen):
            pool = pipe.backend.pool
            if isinstance(ev, WindowDone) and ev.window == 1 and pool is not None:
                seen.setdefault("cold_after_w1", sum(
                    1 for p in pool._in_use if p >= pool.n_pages))

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ops.reset_dispatch_counts()
        sched, per_stream, wall = serve(torch, pipe, videos, on_event)
        launches = ops.launch_counts()
        plain_on_cuda = ops.plain_calls_on_cuda()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_win = sum(len(r) for r in per_stream)
        logits = np.array([r.stats.logits_yes_no for res in per_stream for r in res])
        want = pipe.kernels
        busy = {k: round(v, 4) for k, v in sched.stage_busy.items()}
        kv_bytes = per_stream[0][-1].stats.kv_bytes_per_stream
        log(f"serve [{label}]: {n_win} windows in {wall:.3f} s ({n_win / wall:.4f} "
            f"windows/s incl. codec ingest); stage busy s {busy}; peak memory {peak:.2f} "
            f"GiB; kv bytes per stream {kv_bytes}; t_map {pipe.backend.t_map:.4f} s; "
            f"launches {launches}; plain on CUDA {plain_on_cuda}")
        for i, res in enumerate(per_stream):
            log(f"  stream {i}: answers {[r.stats.answer for r in res]}, yes/no logits "
                f"{[tuple(round(x, 4) for x in r.stats.logits_yes_no) for r in res]}")
        here = (n_win == 6 and bool(np.isfinite(logits).all())
                and all(launches.get(k, 0) > 0 for k in want)
                and not any(plain_on_cuda.values()))
        window0[label] = [res[0].stats.logits_yes_no for res in per_stream]
        served[label] = [[r.stats.logits_yes_no for r in res] for res in per_stream]
        slots = sum(r.stats.vit_slots for res in per_stream for r in res)
        encode[label] = (sched.stage_busy["encode"], slots)
        if label in PADDED:
            twin = PADDED[label]
            ratio, pad, pack = vit_flop_ratio(torch, pipe, videos)
            diff, tol, ans_ok = logit_agreement(np.array(window0[label]),
                                                np.array(window0[twin]))
            no_packed = launches.get("flash_packed", 0) == 0
            log(f"  padded ViT: encode {encode[label][0]:.4f} s, {slots} ViT slots vs the "
                f"packed path's ({twin}) {encode[twin][0]:.4f} s, {encode[twin][1]} slots; "
                f"window 0's 24 P-frames: vit_padded_flops {pad / 1e12:.3f} T / "
                f"vit_packed_flops {pack / 1e12:.3f} T = {ratio:.3f} (gate >= 1.5); window-0 "
                f"yes/no logits vs the packed path's: max |d| {diff:.4g} (tol {tol:.3g}), "
                f"answers agree where the margin exceeds twice it: {ans_ok}; flash_packed "
                f"launched: {not no_packed}")
            here = here and ratio >= 1.5 and diff <= tol and ans_ok and no_packed
        if kv.get("stale_page_dtype") == "int8":
            cold = seen.get("cold_after_w1", 0)
            ref = window0["codecflow, bf16, one stream at a time"]
            same = window0[label] == ref
            log(f"  int8: cold pages in use after window 1: {cold}; window-0 yes/no logits "
                f"bitwise equal to the bf16 run one stream at a time: {same}")
            here = here and cold > 0 and same
        if not here:
            log(f"FAIL: serve [{label}] (kernels wanted {sorted(want)})")
        ok = ok and here
        by_path[label] = launches
        del sched, pipe, per_stream
    gc.collect()
    torch.cuda.empty_cache()
    return ok, by_path, served


@contextmanager
def expert_choices(log: list, force=None):
    """While active, each routing of ``moe_block`` appends its (gates, own
    choices) to ``log``; with ``force`` (another run's log), call i takes
    that run's choices of call i instead of its own."""
    from repro_torch.models import layers
    orig = layers.top_k_lower_first
    calls = iter(force) if force is not None else None

    def recorded(gates, k):
        vals, idx = orig(gates, k)
        log.append((gates.detach(), idx))
        if calls is not None:
            idx = next(calls)[1].to(gates.device)
            vals = gates.gather(1, idx)
        return vals, idx
    layers.top_k_lower_first = recorded
    try:
        yield log
    finally:
        layers.top_k_lower_first = orig


def choice_flips(torch, ref: list, own: list):
    """(tokens whose expert set differs, the largest gate margin of the
    reference's choice among them) over calls paired one for one."""
    n, worst = 0, 0.0
    for (g_ref, e_ref), (_, e_own) in zip(ref, own, strict=True):
        diff = (e_ref.sort(1).values != e_own.sort(1).values).any(1)
        if bool(diff.any()):
            k = e_ref.shape[1]
            top = g_ref[diff].sort(1, descending=True).values
            worst = max(worst, float((top[:, k - 1] - top[:, k]).max()))
            n += int(diff.sum())
    return n, worst


def composite(torch, cfg4, vit, params, vparams, videos, mode, kv):
    """One fresh and one incremental window group at 4 layers through the
    kernels and through their plain versions.  With MoE layers the plain
    run takes the kernel run's expert choices (a bf16 step between the
    two can move a near tie, after which the runs diverge by more than
    the kernels' rounding), and prints how many tokens would have chosen
    otherwise, with the largest gate margin among them.  Returns (max |d
    yes/no logit|, its tolerance, answers agree where the margin exceeds
    twice it, all checks passed)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingPipeline
    ecfg = path_ecfg(mode, kv)
    moe = cfg4.moe is not None
    chosen, plain_own = [], []
    pipe = ServingPipeline(cfg4, vit, params, vparams, ecfg, device="cuda")
    with expert_choices(chosen):
        _, res_k, _ = serve(torch, pipe, videos)
    del pipe
    pipe_p = ServingPipeline(cfg4, vit, params, vparams, ecfg,
                             device="cuda")       # same weights, own KV
    with ops.kernel_mode("plain"), expert_choices(plain_own, force=chosen if moe else None):
        _, res_p, _ = serve(torch, pipe_p, videos)
    del pipe_p
    if moe:
        n, margin = choice_flips(torch, chosen, plain_own)
        log(f"  composite [{cfg4.name}, {mode}]: the plain run took the kernel run's "
            f"expert choices; {n} tokens would have chosen otherwise (largest gate margin "
            f"{margin:.3g})")
    lk = np.array([r.stats.logits_yes_no for res in res_k for r in res])
    lp = np.array([r.stats.logits_yes_no for res in res_p for r in res])
    diff, tol, ans_ok = logit_agreement(lk, lp)
    return diff, tol, ans_ok, diff <= tol and ans_ok and lk.shape == (4, 2)


def logit_agreement(lk, lp):
    """(max |d yes/no logit|, the tolerance 5e-2 x max(1, max |lp|), and
    whether the answers agree wherever ``lp``'s margin exceeds twice it)."""
    import numpy as np
    tol = 5e-2 * max(1.0, float(np.abs(lp).max()))
    diff = float(np.abs(lk - lp).max())
    margin = np.abs(lp[:, 0] - lp[:, 1])
    ans_ok = bool((((lk[:, 0] > lk[:, 1]) == (lp[:, 0] > lp[:, 1])) | (margin <= 2 * tol)).all())
    return diff, tol, ans_ok


def serve_ssm(torch):
    """Phase 4, the SSM family: mamba2-2.7b at full width and depth,
    random bf16 weights made on the card from the seed, the launcher's
    112^2 ViT; 2 streams x 40 frames through the lockstep Scheduler once
    per path of SSM_PATHS, with the counts set to 0 just before each run
    and read just after.  Returns (ok, launches per path label, the
    codecflow pipeline: its weights serve phase 5)."""
    import numpy as np
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_pipeline
    videos = anomaly_dataset(2, SSM_FRAMES, SSM_HW, SSM_HW, seed=SEED)
    ok, by_path, pipe, keep = True, {}, None, None
    for mode in SSM_PATHS:
        t0 = time.perf_counter()
        if pipe is None:
            pipe = build_pipeline(SSM_ARCH, mode, codec_cfg(), seed=SEED, device="cuda")
            torch.cuda.synchronize()
            cfg = pipe.cfg
            log(f"weights: {SSM_ARCH} ({cfg.n_layers} SSD layers, d {cfg.d_model}, "
                f"{cfg.ssm.n_heads(cfg.d_model)} heads of {cfg.ssm.head_dim}, d_state "
                f"{cfg.ssm.d_state}, chunk {cfg.ssm.chunk}) made on the card in "
                f"{time.perf_counter() - t0:.1f} s")
        else:
            from repro_torch.serving import ServingPipeline
            pipe = ServingPipeline(pipe.cfg, pipe.v, pipe.params, pipe.vparams,
                                   path_ecfg(mode, {}), device="cuda")
        label = f"{SSM_ARCH}, {mode}"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        ops.reset_dispatch_counts()
        sched, per_stream, wall = serve(torch, pipe, videos)
        launches = ops.launch_counts()
        plain_on_cuda = ops.plain_calls_on_cuda()
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_win = sum(len(r) for r in per_stream)
        logits = np.array([r.stats.logits_yes_no for res in per_stream for r in res])
        busy = {k: round(v, 4) for k, v in sched.stage_busy.items()}
        log(f"serve [{label}]: {n_win} windows in {wall:.3f} s ({n_win / wall:.4f} "
            f"windows/s incl. codec ingest); stage busy s {busy}; peak memory {peak:.2f} "
            f"GiB; launches {launches}; plain on CUDA {plain_on_cuda}")
        for i, res in enumerate(per_stream):
            log(f"  stream {i}: answers {[r.stats.answer for r in res]}, yes/no logits "
                f"{[tuple(round(x, 4) for x in r.stats.logits_yes_no) for r in res]}")
        want = pipe.kernels
        n_expect = 2 * ((SSM_FRAMES - 16) // 4 + 1)
        here = (n_win == n_expect and bool(np.isfinite(logits).all())
                and "ssd_scan" in want and all(launches.get(k, 0) > 0 for k in want)
                and not any(plain_on_cuda.values()))
        if not here:
            log(f"FAIL: serve [{label}] (kernels wanted {sorted(want)})")
        ok = ok and here
        by_path[label] = launches
        keep = keep or pipe
        del sched, per_stream
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return ok, by_path, keep

# ----------------------------------------------------------------------
# phase 5: the lockstep and the stage-pipelined engine side by side
# ----------------------------------------------------------------------
ENGINE_ORDER = (False, True, True, False)        # lockstep, async, async, lockstep
ENGINE_NAME = {False: "lockstep", True: "async"}
STAGGERED = (40, 24, 24, 40)                     # frames per stream of fleet (a)


class SyncWatch:
    """While active: the synchronising CUDA calls that
    ``torch.cuda.set_sync_debug_mode("warn")`` reports, by thread (the
    ``codec-ingest`` workers or the main thread) and Python call site, and
    the finalize waits (``HostCopy.result``, one per served group)."""

    def __init__(self, torch):
        self.torch = torch
        self.sites: Counter = Counter()
        self.waits = 0

    def __enter__(self):
        import warnings
        from repro_torch.kernels import transfer
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if "synchroniz" not in str(message):
                return shown(message, category, filename, lineno, file, line)
            thread = threading.current_thread().name
            kind = "ingest" if thread.startswith("codec-ingest") else "main"
            self.sites[(kind, f"{Path(filename).name}:{lineno}")] += 1
        warnings.showwarning = show
        self._result = transfer.HostCopy.result

        def result(copy, watch=self):
            watch.waits += 1
            return watch._result(copy)
        transfer.HostCopy.result = result
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import transfer
        self.torch.cuda.set_sync_debug_mode(0)
        transfer.HostCopy.result = self._result
        self._catch.__exit__(*exc)

    def count(self, kind: str) -> int:
        return sum(n for (k, _), n in self.sites.items() if k == kind)


def sync_probe(torch) -> None:
    """Print which calls the sync debug mode reports on this build."""
    x = torch.ones(4, device="cuda")

    def event_sync():
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
    calls = (("tensor.cpu()", lambda: x.cpu()),
             ("torch.cuda.synchronize()", torch.cuda.synchronize),
             ("Event.synchronize()", event_sync),
             ("pageable upload", lambda: torch.ones(4).to("cuda")),
             ("pinned non_blocking upload",
              lambda: torch.ones(4).pin_memory().to("cuda", non_blocking=True)),
             ("index by a Python list", lambda: x[[0, 1]]),
             ("torch.nonzero", lambda: torch.nonzero(x)))
    flagged = {}
    for name, fn in calls:
        with SyncWatch(torch) as watch:
            fn()
        flagged[name] = watch.count("main")
    torch.cuda.synchronize()
    log(f"engines: sync debug mode reports (calls per probe): {flagged}")


def engine_run(torch, pipe, videos, pipelined: bool, max_concurrent: int, on_event=None):
    """Serve ``videos`` once through one engine, every event checked by
    the protocol validator, the counts set to 0 just before and read just
    after.  Returns the run's record."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import (
        EventProtocolValidator, Scheduler, SchedulerCfg, StreamRequest,
    )
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sched = Scheduler(pipe, SchedulerCfg(max_concurrent=max_concurrent, pipelined=pipelined))
    validator = EventProtocolValidator()
    events = []
    ops.reset_launch_counts()
    ops.reset_dispatch_counts()
    with SyncWatch(torch) as watch:
        t0 = time.perf_counter()
        sids = [sched.submit(StreamRequest(i, np.asarray(f), tag=lab))
                for i, (f, lab) in enumerate(videos)]
        at_submit = watch.count("main")
        for ev in validator.wrap(sched.events()):
            events.append((type(ev).__name__, ev.sid, getattr(ev, "window", None)))
            if on_event is not None:
                on_event(ev)
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    validator.assert_complete()
    res = [sched.session(s).results for s in sids]
    tally_fallbacks(res)
    n = sum(len(r) for r in res)
    spans = sum(r.stats.t_vit + r.stats.t_prefill + r.stats.t_decode for rr in res for r in rr)
    return dict(
        engine=ENGINE_NAME[pipelined], n=n, wall=wall,
        busy={k: round(v, 4) for k, v in sched.stage_busy.items()},
        share=spans / wall, submit=at_submit / len(videos),
        main=(watch.count("main") - at_submit) / n, ingest=watch.count("ingest") / n,
        waits=watch.waits / n, sites=watch.sites,
        peak=torch.cuda.max_memory_allocated() / 2**30,
        launches=ops.launch_counts(), plain=ops.plain_calls_on_cuda(),
        per_stream=sorted(events, key=lambda e: e[1]),
        logits=[[r.stats.logits_yes_no for r in rr] for rr in res],
        answers=[[r.stats.answer for r in rr] for rr in res],
        kv_bytes=res[0][-1].stats.kv_bytes_per_stream if res[0] else 0,
    )


def within(run, ref, label: str) -> bool:
    """Logits within the composite phase's tolerance of ``ref``'s and the
    answers equal where ``ref``'s margin exceeds twice it."""
    import numpy as np
    diff, tol, ans = logit_agreement(np.array([x for rr in run for x in rr]),
                                     np.array([x for rr in ref for x in rr]))
    log(f"  {label}: max |d yes/no logit| {diff:.4g} (tol {tol:.3g}), bitwise "
        f"{diff == 0.0}; answers agree where the margin exceeds 2 x tol: {ans}")
    return diff <= tol and ans


def engine_case(torch, phase, key, label, make, fleet, conc, want_n, order, by_path):
    """One case of the engines or families phase: ``fleet`` served through
    a fresh ``make()`` pipeline once per engine of ``order`` (each run's
    counts set to 0 just before it and read just after, stored in
    ``by_path``).  Every run must serve ``want_n`` windows with finite
    logits, launch each kernel of its path with no plain call on a CUDA
    tensor (where the pipeline has a pool, after demoting pages by window
    1 if it is int8), and deliver the same events per stream.  Returns
    (ok, the runs)."""
    import numpy as np
    from repro_torch.serving import WindowDone
    ok, runs = True, []
    for i, pipelined in enumerate(order):
        pipe = make()
        seen = {}

        def on_event(ev, pipe=pipe, seen=seen):
            pool = pipe.backend.pool
            if isinstance(ev, WindowDone) and ev.window == 1 and pool is not None:
                seen.setdefault("cold", sum(1 for p in pool._in_use if p >= pool.n_pages))
        r = engine_run(torch, pipe, fleet, pipelined, conc, on_event)
        top = ", ".join(f"{k} {site} x{n}" for (k, site), n in r["sites"].most_common(8))
        log(f"{phase} {key} [{label}] {r['engine']} run {i + 1}: {r['n']} windows in "
            f"{r['wall']:.3f} s ({r['n'] / r['wall']:.4f} windows/s incl. codec ingest); "
            f"stage busy s {r['busy']}; stage-span share {r['share']:.4f}; syncs per "
            f"window: main {r['main']:.2f}, ingest threads {r['ingest']:.2f}, finalize "
            f"waits {r['waits']:.2f} (and {r['submit']:.2f} per stream at submit); "
            f"peak memory {r['peak']:.2f} GiB; kv bytes per stream {r['kv_bytes']}; "
            f"launches {r['launches']}; plain on CUDA {r['plain']}")
        log(f"  sync sites: {top or 'none'}")
        here = (r["n"] == want_n and bool(np.isfinite(np.array(
            [x for rr in r["logits"] for x in rr])).all())
            and all(r["launches"].get(k, 0) > 0 for k in pipe.kernels)
            and not any(r["plain"].values()))
        if getattr(pipe.backend, "quant", False):
            log(f"  int8: cold pages in use after window 1: {seen.get('cold', 0)}")
            here = here and seen.get("cold", 0) > 0
        if not here:
            log(f"FAIL: {phase} {key} {r['engine']} run {i + 1} (kernels wanted "
                f"{sorted(pipe.kernels)})")
        ok = ok and here
        by_path[f"{phase} {key} {r['engine']} run {i + 1}"] = r["launches"]
        runs.append(r)
        del pipe
    same_events = all(r["per_stream"] == runs[0]["per_stream"] for r in runs)
    if not same_events:
        log(f"FAIL: {phase} {key}: the engines delivered other events per stream")
    for engine in ("lockstep", "async"):
        mine = [r for r in runs if r["engine"] == engine]
        if mine:
            wps = [r["n"] / r["wall"] for r in mine]
            log(f"  {key} {engine}: windows/s {[round(w, 4) for w in wps]}, stage-span "
                f"share {[round(r['share'], 4) for r in mine]}")
    return ok and same_events, runs


def serve_engines(torch, cfg, params, vparams, videos, ssm_pipe, int8_ref):
    """Phase 5: each case served in the order lockstep, async, async,
    lockstep ((d): async once).  Returns (ok, launches per run)."""
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.serving import ServingPipeline
    sync_probe(torch)
    big = anomaly_dataset(len(STAGGERED), max(STAGGERED), HW, HW, seed=SEED)
    fleet_a = [(f[:n], lab) for (f, lab), n in zip(big, STAGGERED)]
    ssm_videos = anomaly_dataset(2, SSM_FRAMES, SSM_HW, SSM_HW, seed=SEED)

    def lm(kv=None):
        return ServingPipeline(cfg, cfg.vit, params, vparams, path_ecfg("codecflow", kv or {}),
                               device="cuda")

    def ssm():
        return ServingPipeline(ssm_pipe.cfg, ssm_pipe.v, ssm_pipe.params, ssm_pipe.vparams,
                               path_ecfg("codecflow", {}), device="cuda")
    n_win = [(n - 16) // 4 + 1 for n in STAGGERED]
    cases = (  # key, label, pipeline, fleet, max_concurrent, windows, engines
        ("(a)", f"{ARCH} codecflow paged, streams of {STAGGERED} frames, max_concurrent 3",
         lm, fleet_a, 3, sum(n_win), ENGINE_ORDER),
        ("(b)", f"{ARCH} codecflow paged, phase 4's fleet", lm, videos, len(videos), 6,
         ENGINE_ORDER),
        ("(c)", f"{SSM_ARCH} codecflow, phase 4's fleet", ssm, ssm_videos, 2,
         2 * ((SSM_FRAMES - 16) // 4 + 1), ENGINE_ORDER),
        ("(d)", f"{ARCH} codecflow, int8 cold pages",
         lambda: lm(dict(stale_page_dtype="int8")), videos, len(videos), 6, (True,)),
    )
    ok, by_path = True, {}
    for key, label, make, fleet, conc, want_n, order in cases:
        here, runs = engine_case(torch, "engines", key, label, make, fleet, conc, want_n,
                                 order, by_path)
        ok = ok and here
        if key in ("(b)", "(c)"):
            bitwise = all(r["logits"] == runs[0]["logits"] for r in runs)
            log(f"  {key}: yes/no logits of every run bitwise equal: {bitwise}")
            ok = ok and bitwise
        elif key == "(a)":
            for r in runs[1:]:
                ok = within(r["logits"], runs[0]["logits"],
                            f"{key} {r['engine']} vs lockstep run 1") and ok
        else:
            ok = within(runs[0]["logits"], int8_ref,
                        f"{key} async vs phase 4's lockstep int8 run") and ok
    gc.collect()
    torch.cuda.empty_cache()
    return ok, by_path


# ----------------------------------------------------------------------
# phase 7: the MoE and hybrid families
# ----------------------------------------------------------------------
def moe_probe(torch, cfg, params, n_rows: int) -> bool:
    """One MoE layer of ``cfg`` (its first, with the run's weights) on
    random rows at the largest serving call's shape (``n_rows``) and at
    a decode step's (2 rows: cap 1), after a warm-up call.  Prints for
    each the capacity, the dispatch buffer's and the expert activations'
    bytes, the measured peak of the call above what was allocated before
    it, its time beside its bound (every expert's weights read once, as
    each has at least one slot; the products over every slot), and the
    syncs the debug mode reports; it must report none and give the same
    output bitwise when called again."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import unstack
    m = cfg.moe
    p = unstack(params["blocks"][cfg.ffn_pattern.index("moe")])[0]["ffn"]
    g = torch.Generator(device="cuda").manual_seed(9)
    w_bytes = sum(p[k].numel() * p[k].element_size() for k in ("router", "wg", "wu", "wd"))
    with SyncWatch(torch):
        pass     # a process's first watch reports the mode switch itself as a sync
    ok = True
    for n in (n_rows, 2):
        x = torch.randn((2, n // 2, cfg.d_model), generator=g, device="cuda").bfloat16()
        layers.moe_block(p, m, x)        # warm-up: first-call library set-up may sync
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with SyncWatch(torch) as watch:
            out, _ = layers.moe_block(p, m, x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        again, _ = layers.moe_block(p, m, x)
        bitwise = torch.equal(out, again)
        cap = int(m.capacity_factor * n * m.top_k / m.n_experts) + 1
        ms = cuda_ms(torch, lambda: layers.moe_block(p, m, x), 5)
        # every slot of every expert goes through the three products
        flops = 2.0 * 3 * m.n_experts * cap * cfg.d_model * m.d_ff_expert
        b_ms, b_by = bound_ms(w_bytes + 2 * x.numel() * 2, flops, BF16_TENSOR_FLOPS)
        sites = ", ".join(f"{site} x{k}" for (_, site), k in watch.sites.items())
        log(f"moe_block ({cfg.name}, n {n}, E {m.n_experts}, top-{m.top_k}, cap {cap}): "
            f"dispatch buffer E*cap*d {m.n_experts * cap * cfg.d_model * 2 / 2**20:.1f} MiB, "
            f"E*cap*d_ff_expert {m.n_experts * cap * m.d_ff_expert * 2 / 2**20:.1f} MiB bf16; "
            f"measured peak above the inputs {peak / 2**20:.1f} MiB; {ms:.4f} ms per call, "
            f"bound {b_ms:.4f} ms ({b_by}; {w_bytes / 2**20:.0f} MiB of weights); syncs "
            f"reported {watch.count('main')} ({sites or 'none'}); bitwise equal when called "
            f"again: {bitwise}")
        ok = ok and bitwise and watch.count("main") == 0
    return ok


def state_bytes(cfg, slots: int) -> int:
    """Bytes of one stream's recurrent state: attention K/V over ``slots``
    (bf16) plus every mamba layer's conv tail (bf16) and SSD state (f32)."""
    n = 0
    for pos in range(cfg.period):
        if cfg.block_kind(pos)[0] == "attn":
            n += 2 * slots * cfg.n_kv * cfg.d_head * 2
        else:
            s = cfg.ssm
            conv = (s.d_conv - 1) * (s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state) * 2
            n += conv + s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
    return n * cfg.repeats


def serve_families(torch):
    """Phase 7: (a) olmoe-1b-7b at full size, codecflow on the paged bf16
    slab; (b) jamba-v0.1-52b at full width with HYBRID_LAYERS layers,
    codecflow and fullcomp through the recurrent backend; both with the
    launcher's 112^2 ViT and random bf16 weights made on the card from
    the seed, each case served lockstep, async, async, lockstep, the
    yes/no logits of every run bitwise equal.  Each model's weights are
    freed before the next.  Returns (ok, launches per run)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.launch.serve import default_vit
    from repro_torch.models.init import init_lm_params, init_vit_params, map_tree, tree_leaves
    from repro_torch.serving import ServingPipeline
    ok, by_path = True, {}
    models = (
        (MOE_ARCH, get_config(MOE_ARCH), ("codecflow",), MOE_FRAMES, "full width and depth"),
        (HYBRID_ARCH, dataclasses.replace(get_config(HYBRID_ARCH), n_layers=HYBRID_LAYERS),
         HYBRID_PATHS, HYBRID_FRAMES,
         f"full width, {HYBRID_LAYERS} of {get_config(HYBRID_ARCH).n_layers} layers"),
    )
    for key, (arch, cfg, modes, frames, depth) in zip(("(a)", "(b)"), models):
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        v = default_vit(cfg)
        params = init_lm_params(cfg, SEED, "cuda")
        vparams = init_vit_params(v, cfg.d_model, SEED + 1, "cuda")
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        log(f"weights: {arch} ({depth}: {cfg.n_layers} layers, d {cfg.d_model}, "
            f"{cfg.n_heads}/{cfg.n_kv} heads, {cfg.moe.n_experts} experts top-"
            f"{cfg.moe.top_k}) {n_bytes / 2**30:.2f} GiB made on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        videos = anomaly_dataset(2, frames, FAMILY_HW, FAMILY_HW, seed=SEED)
        want_n = 2 * ((frames - 16) // 4 + 1)
        makers = {mode: (lambda mode=mode: ServingPipeline(
            cfg, v, params, vparams, path_ecfg(mode, {}), device="cuda")) for mode in modes}
        largest = 0          # rows of the largest call: a fresh append or paged prefill
        for mode, make in makers.items():
            probe = make()
            lay = probe.layout
            largest = max(largest, len(videos) * (
                lay.vis_len if probe.is_streaming_family else lay.total_len))
            if probe.is_streaming_family:
                log(f"  {arch} {mode}: attention caches of {probe.backend.cache_slots} slots "
                    f"(max_hist {probe.backend.max_hist}); state bytes per stream "
                    f"{state_bytes(cfg, probe.backend.cache_slots)}")
            del probe
        ok = moe_probe(torch, cfg, params, largest) and ok
        for mode, make in makers.items():
            label = f"{arch} {mode}" + (", paged bf16" if mode == "codecflow" and
                                        cfg.family == "moe" else "")
            here, runs = engine_case(torch, "families", f"{key} {mode}", label, make,
                                     videos, 2, want_n, ENGINE_ORDER, by_path)
            bitwise = all(r["logits"] == runs[0]["logits"] for r in runs)
            log(f"  {key} {mode}: yes/no logits of every run bitwise equal: {bitwise}")
            for i, res in enumerate(runs[0]["logits"]):
                log(f"  stream {i}: answers {runs[0]['answers'][i]}, yes/no logits "
                    f"{[tuple(round(x, 4) for x in lg) for lg in res]}")
            ok = ok and here and bitwise
        # kernels against their plain versions through the first layers
        # of the same weights (views), as phase 6 does at 4 layers
        cut_cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, max(4, cfg.period)))
        r = cut_cfg.repeats
        cut = dict(params, blocks=tuple(map_tree(lambda t: t[:r], blk)
                                        for blk in params["blocks"]))
        short = [(f[:20], lab) for f, lab in videos]    # one fresh + one incremental window
        for mode in modes:
            diff, tol, ans_ok, here = composite(torch, cut_cfg, v, cut, vparams, short, mode,
                                                {})
            log(f"composite [{arch}, {mode}] ({cut_cfg.n_layers} layers, full width): max "
                f"|d yes/no logit| {diff:.4g} (tol {tol:.3g}); answers agree where the "
                f"margin exceeds 2 x tol: {ans_ok}")
            if not here:
                log(f"FAIL: composite check [{arch}, {mode}]")
            ok = ok and here
        del params, vparams, cut
    gc.collect()
    torch.cuda.empty_cache()
    return ok, by_path


# ----------------------------------------------------------------------
# phase 8: training
# ----------------------------------------------------------------------
@contextmanager
def wrapped(mod, name: str, wrap):
    """While active, ``mod.name`` is ``wrap(mod.name)``."""
    orig = getattr(mod, name)
    setattr(mod, name, wrap(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def step_readings(torch, cfg, params, batch, remat, log, force=None):
    """One train step of a copy of ``params`` (on the batch's device):
    (loss, grad_norm, every gradient leaf as CPU f32), the expert
    choices appended to ``log`` (and taken from ``force``)."""
    from repro_torch.models.init import map_tree, trainable, tree_leaves
    from repro_torch.training import optimizer as topt
    from repro_torch.training import train_step as tts
    p = trainable(map_tree(lambda t: t.clone(), params))
    ocfg = topt.OptCfg(lr=1e-3, warmup=1, total_steps=10)
    with expert_choices(log, force=force):
        loss, _ = tts.loss_fn(cfg, p, batch, q_chunk=16, remat=remat)
        grads = tts.tree_grads(loss, p)
    _, _, m = topt.apply_updates(p, grads, topt.init_opt_state(p, ocfg), ocfg)
    return (float(loss.detach()), float(m["grad_norm"]),
            [g.float().cpu() for g in tree_leaves(grads)])


def card_step_vs_cpu(torch):
    """One train step of whisper-large-v3-smoke (with remat) and of
    olmoe-1b-7b-smoke (the CPU run's expert choices forced on the card)
    on the card and on the CPU, from the same weights and batch: loss,
    grad_norm and every gradient leaf within the CPU tests' limits."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.init import init_lm_params, map_tree
    ok = True
    for arch, remat in (("whisper-large-v3-smoke", True), ("olmoe-1b-7b-smoke", False)):
        cfg = get_config(arch)
        params = init_lm_params(cfg, SEED, "cpu")
        batches = [next(lm_batches(cfg, 2, 32, seed=SEED, device=d)) for d in ("cpu", "cuda")]
        ref, own = [], []
        lc, gc_, grads_c = step_readings(torch, cfg, params, batches[0], remat, ref)
        lk, gk, grads_k = step_readings(torch, cfg, map_tree(lambda t: t.to("cuda"), params),
                                        batches[1], remat, own,
                                        force=ref if cfg.moe is not None else None)
        gap = max(float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                  for a, b in zip(grads_c, grads_k))
        flips = ""
        if cfg.moe is not None:
            n, margin = choice_flips(torch, ref, [(g.cpu(), e.cpu()) for g, e in own])
            flips = (f"; the card took the CPU's expert choices, {n} tokens would have "
                     f"chosen otherwise (largest gate margin {margin:.3g})")
        here = (abs(lk - lc) <= STEP_LOSS_TOL * abs(lc)
                and abs(gk - gc_) <= STEP_GNORM_TOL * gc_ and gap <= STEP_GRAD_TOL)
        log(f"  card step vs CPU step [{arch}{', remat' if remat else ''}]: loss {lk:.6f} vs "
            f"{lc:.6f}, grad_norm {gk:.5f} vs {gc_:.5f}, largest gradient gap "
            f"{gap:.4g} of its leaf's max (limits {STEP_LOSS_TOL:g}, {STEP_GNORM_TOL:g}, "
            f"2^-5){flips}: {'ok' if here else 'FAIL'}")
        ok = ok and here
    return ok


def model_flops(cfg, batch: int, seq: int) -> float:
    """8 x parameters x tokens of one train step with per-layer
    recomputation (forward twice, backward twice the forward), each
    position through the weights it meets: an encoder position through
    enc_embed, the encoder layers and every decoder layer's cross K/V
    projections, a decoder position through the decoder layers (self
    and cross q/o included) and the head.  Attention's score and value
    products are not counted."""
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    qo, kv = 2 * d * cfg.n_heads * cfg.d_head, 2 * d * cfg.n_kv * cfg.d_head
    enc_pos = d * d + cfg.enc_layers * (qo + kv + 3 * d * f) + L * kv
    dec_pos = L * (qo + kv + qo + 3 * d * f) + d * cfg.vocab
    return 8.0 * batch * (cfg.enc_seq * enc_pos + seq * dec_pos)


def train_whisper(torch):
    """whisper-large-v3 at full size trained WHISPER_STEPS steps through
    ``launch.train.train`` (remat, batch 2, decoder seq 448, 1500 stub
    encoder features), then decoded with the trained weights.  Returns
    (ok, the decode's launches)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.init import detached, init_lm_params, tree_leaves
    cfg = get_config(WHISPER_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, finite, mark = [], [], [time.perf_counter()]

    def timed(make):
        """``make_train_step`` whose steps record their time (from the
        last step's end, the batch included) and whether the loss and
        grad_norm are finite."""
        def make_timed(*a, **k):
            step = make(*a, **k)

            def run(*args):
                out = step(*args)
                torch.cuda.synchronize()
                now = time.perf_counter()
                times.append(now - mark[0])
                mark[0] = now
                m = out[2]
                finite.append(bool(torch.isfinite(m["loss"]))
                              and bool(torch.isfinite(m["grad_norm"])))
                return out
            return run
        return make_timed

    ops.reset_dispatch_counts()
    with wrapped(tlaunch, "make_train_step", timed):
        mark[0] = time.perf_counter()
        trained, losses = tlaunch.train(WHISPER_ARCH, WHISPER_STEPS, WHISPER_BATCH,
                                        WHISPER_SEQ, seed=SEED, device="cuda", log_every=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain = ops.plain_calls_on_cuda()
    leaves = tree_leaves(trained)
    n_params = sum(t.numel() for t in leaves)
    t0 = time.perf_counter()
    fresh = tree_leaves(init_lm_params(cfg, SEED, "cuda"))     # the seed's weights again
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    moved = all(not torch.equal(a, b) for a, b in zip(fresh, leaves))
    del fresh
    log(f"weights: {WHISPER_ARCH} ({cfg.enc_layers} encoder + {cfg.n_layers} decoder layers, "
        f"d {cfg.d_model}, {cfg.n_heads} heads, vocab {cfg.vocab}): {n_params / 1e9:.3f} B "
        f"parameters, {sum(t.numel() * t.element_size() for t in leaves) / 2**30:.2f} GiB, "
        f"made on the card from the seed in {t_init:.1f} s")
    t_step = sum(times[1:]) / len(times[1:])
    READINGS["whisper_step_s"] = t_step
    flops = model_flops(cfg, WHISPER_BATCH, WHISPER_SEQ)
    dec_tok, enc_pos = WHISPER_BATCH * WHISPER_SEQ, WHISPER_BATCH * cfg.enc_seq
    log(f"train [{WHISPER_ARCH}, full size, remat]: losses {[round(x, 4) for x in losses]}; "
        f"step s {[round(x, 4) for x in times]} (step 1 includes the first calls' set-up); "
        f"steps 2-{WHISPER_STEPS} {t_step:.4f} s each: {dec_tok / t_step:.1f} decoder tokens/s, "
        f"{(dec_tok + enc_pos) / t_step:.1f} positions/s with the {enc_pos} encoder positions; "
        f"model FLOPs per step {flops / 1e12:.2f} T (8 x parameters met x positions, "
        f"attention scores not counted): {flops / t_step / BF16_TENSOR_FLOPS:.4f} of the bf16 "
        f"peak; peak memory {peak:.2f} GiB (parameters, gradients and f32 moments "
        f"{n_params * (2 + 2 + 8) / 2**30:.2f} GiB); finite every step: {all(finite)}; "
        f"every leaf moved: {moved}; plain on CUDA: {plain}")
    ok = all(finite) and len(finite) == WHISPER_STEPS and moved and not any(plain.values())
    profile_step(torch, cfg, trained)
    serve_params = detached(trained)
    del trained, leaves
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.kernels.flash_refresh import build_block_map
    from repro_torch.models import transformer as tfm
    rng = np.random.default_rng(SEED + 2)
    B = WHISPER_BATCH
    feats = torch.from_numpy(rng.normal(0, 0.5, (B, cfg.enc_seq, cfg.d_model))
                             .astype(np.float32)).to("cuda")
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, WHISPER_PREFILL))).to("cuda")
    maps = [build_block_map(np.arange(WHISPER_PREFILL), WHISPER_SLOTS)] + [
        build_block_map([WHISPER_PREFILL + i], WHISPER_SLOTS) for i in range(WHISPER_DECODE)]

    def decode(toks=None):
        out, chosen = [], []
        with torch.no_grad():
            enc = tfm.run_encoder(cfg, serve_params, feats)
            caches = tfm.Caches(tfm.init_caches(cfg, B, WHISPER_SLOTS, device="cuda").blocks,
                                tfm.build_cross_kv(cfg, serve_params, enc))
            logits, caches, _ = tfm.prefill(cfg, serve_params, tokens, caches,
                                            block_map=maps[0])
            out.append(logits)
            for i in range(WHISPER_DECODE):
                tok = toks[i] if toks is not None else torch.argmax(logits, -1)[:, None]
                chosen.append(tok)
                logits, caches = tfm.decode_step(cfg, serve_params, tok, caches,
                                                 WHISPER_PREFILL + i, block_map=maps[1 + i])
                out.append(logits)
        return torch.stack(out).cpu().numpy(), chosen

    ops.reset_launch_counts()
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    lk, toks = decode()
    t_dec = time.perf_counter() - t0
    launches, plain = ops.launch_counts(), ops.plain_calls_on_cuda()
    with ops.kernel_mode("plain"):
        lp, _ = decode(toks)
    tol = 5e-2 * max(1.0, float(np.abs(lp).max()))
    diff = float(np.abs(lk - lp).max())
    want = cfg.n_layers * (1 + WHISPER_DECODE)
    here = (bool(np.isfinite(lk).all()) and launches.get("flash_refresh", 0) == want
            and not any(plain.values()) and diff <= tol)
    log(f"decode [{WHISPER_ARCH}, trained weights]: encoder over {B} x {cfg.enc_seq}, cross "
        f"K/V, a {WHISPER_PREFILL}-token prefill and {WHISPER_DECODE} decode steps over "
        f"{WHISPER_SLOTS}-slot caches in {t_dec:.3f} s; launches {launches} (want "
        f"flash_refresh {want}); plain on CUDA: {plain}; composite vs kernel_mode('plain'): "
        f"max |d logit| {diff:.4g} (tol {tol:.3g}) over {lk.size} logits: "
        f"{'ok' if here else 'FAIL'}")
    del serve_params, feats
    gc.collect()
    torch.cuda.empty_cache()
    return ok and here, launches


def profile_step(torch, cfg, params, top: int = 12) -> None:
    """One more train step of ``params`` (a trainable tree; fresh moments,
    the next batch of the seed) under ``torch.profiler``: the kernels'
    device time by name, the largest ``top`` of them, and their sum over
    the step's wall time (the profiler's host overhead lengthens the
    wall, so the busy share it gives is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    ocfg = OptCfg(lr=3e-4, warmup=1, total_steps=WHISPER_STEPS)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    batch = next(lm_batches(cfg, WHISPER_BATCH, WHISPER_SEQ, seed=SEED + 1, device="cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = sorted(((getattr(e, "self_device_time_total", 0) / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     reverse=True)
    busy = sum(ms for ms, _, _ in kernels)
    if not busy:
        log("  profile: the profiler saw no device time")
        return
    log(f"  profile [{WHISPER_ARCH}, one step under torch.profiler]: wall {wall * 1e3:.1f} ms, "
        f"kernels {busy:.1f} ms on the device ({busy / (wall * 1e3):.3f} of the wall), "
        f"{sum(n for _, n, _ in kernels)} launches of {len(kernels)} kernels; the largest:")
    for ms, n, name in kernels[:top]:
        log(f"    {ms:9.2f} ms {ms / busy:6.3f}  x{n:<6d} {name[:110]}")
    groups = Counter()
    for ms, _, name in kernels:
        groups[kernel_group(name)] += ms
    log("  by group: " + ", ".join(f"{g} {ms:.1f} ms ({ms / busy:.3f})"
                                   for g, ms in groups.most_common()))
    del opt


def kernel_group(name: str) -> str:
    """A profiled kernel's group, by its name: f32 GEMMs on the CUDA
    cores (cuBLAS ``f32f32`` / ``sgemm``), other GEMMs, copies and casts,
    softmax, reductions, the rest elementwise."""
    low = name.lower()
    if "gemm" in low and ("f32f32_f32f32" in low or "sgemm" in low):
        return "f32 GEMM"
    if "gemm" in low or "nvjet" in low or "cutlass" in low:
        return "other GEMM"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copies and casts"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reductions"
    return "other elementwise"


def bigram_on_card(torch):
    """The JAX package's bigram recipe (tests/test_training.py) on the
    card: the mean of the last 10 of 120 losses below that of the first
    10 minus 0.3."""
    from repro_torch.configs.base import ModelCfg
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.init import init_lm_params, trainable
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    cfg = ModelCfg(name="b", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                   d_ff=128, vocab=64, tied_embeddings=True)
    ocfg = OptCfg(lr=3e-3, warmup=10, total_steps=120)
    params = trainable(init_lm_params(cfg, 3, "cuda"))
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    it = lm_batches(cfg, 8, 32, seed=0, device="cuda")
    t0 = time.perf_counter()
    losses = []
    for _ in range(120):
        params, opt, m = step(params, opt, next(it))
        losses.append(m["loss"])
    losses = torch.stack(losses).cpu().tolist()
    t = time.perf_counter() - t0
    first, last = sum(losses[:10]) / 10, sum(losses[-10:]) / 10
    ok = last < first - 0.3
    log(f"bigram on the card: 120 steps in {t:.2f} s; mean loss of the first 10 {first:.4f}, "
        f"of the last 10 {last:.4f} (must fall by more than 0.3): {'ok' if ok else 'FAIL'}")
    return ok


@contextmanager
def output_watch(torch, seen: list):
    """While active, the LM head's and the ViT's outputs append whether
    they require grad to ``seen``."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models import vit as vitm
    names = ((tfm, "lm_logits"), (vitm, "encode_full"), (vitm, "encode_packed_tokens"))
    origs = [getattr(mod, name) for mod, name in names]

    def watched(fn):
        def call(*a, **k):
            out = fn(*a, **k)
            seen.append(bool(out.requires_grad))
            return out
        return call
    for (mod, name), fn in zip(names, origs):
        setattr(mod, name, watched(fn))
    try:
        yield seen
    finally:
        for (mod, name), fn in zip(names, origs):
            setattr(mod, name, fn)


def anomaly_on_card(torch):
    """The anomaly task trained on the card (``train_tiny_vlm`` on
    benchmarks/common.py's recipe and model: LM and ViT at head dim 24),
    its checkpoint round-tripped, then fullcomp and codecflow (paged
    bf16, lockstep) served on 6 held-out videos with the trained
    weights handed over as trainable leaves, each path's yes/no logits
    held against the same windows through the kernels' plain versions
    (the composite rule).  Returns (ok, launches per path)."""
    import numpy as np
    from repro_torch.configs import CodecCfg, ModelCfg, ViTCfg
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.kernels import ops
    from repro_torch.models.init import (
        init_lm_params, init_vit_params, trainable, tree_leaves,
    )
    from repro_torch.serving import (
        EngineCfg, KVCfg, ServingPipeline, precision_recall_f1, video_prediction,
    )
    from repro_torch.training import anomaly_task, checkpoint
    codec = CodecCfg(**BENCH_CODEC)
    cfg, v = ModelCfg(**BENCH_LM), ViTCfg(**BENCH_VIT)
    hist = []

    def recorded(loss_fn):
        def run(*a):
            nll, acc = loss_fn(*a)
            hist.append((nll.detach(), acc))
            return nll, acc
        return run
    t0 = time.perf_counter()
    with wrapped(anomaly_task, "loss_fn", recorded):
        lm, vit = anomaly_task.train_tiny_vlm(cfg, v, codec, n_videos=36, n_frames=28,
                                              steps=250, batch=16, device="cuda")
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    nll = torch.stack([n for n, _ in hist]).cpu()
    acc = torch.stack([a for _, a in hist]).cpu()
    first, last = float(nll[:20].mean()), float(nll[-20:].mean())
    ok = last < first
    log(f"anomaly task [{cfg.name}, LM d {cfg.d_model} / {cfg.n_heads} heads (D "
        f"{cfg.d_head}), ViT d {v.d_model} / {v.n_heads} heads, {v.image}^2]: {len(hist)} steps x 16 windows in "
        f"{t_train:.2f} s (data included); mean NLL of the first 20 steps {first:.4f}, of "
        f"the last 20 {last:.4f} (must fall): {'ok' if ok else 'FAIL'}; mean accuracy of "
        f"the last 20 {float(acc[-20:].mean()):.3f}")
    path = ROOT / "build" / "anomaly_vlm.npz"
    trained = {"lm": lm, "vit": vit}
    checkpoint.save(str(path), trained, None, 250)
    back, step = checkpoint.load(str(path), {"lm": init_lm_params(cfg, SEED + 7, "cuda"),
                                             "vit": init_vit_params(v, cfg.d_model, SEED + 8,
                                                                    "cuda")})
    path.unlink()
    bitwise = step == 250 and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                                  zip(tree_leaves(trained), tree_leaves(back)))
    log(f"  checkpoint round trip: bitwise equal: {bitwise}")
    ok = ok and bitwise
    videos = anomaly_dataset(6, 28, v.image, v.image, seed=100)
    truths = [lab for _, lab in videos]
    by_path, f1s = {}, {}
    for mode in ("fullcomp", "codecflow"):
        ecfg = EngineCfg(mode=mode, codec=codec, kv=KVCfg())
        pipe = ServingPipeline(cfg, v, trainable(lm), trainable(vit), ecfg, device="cuda")
        ops.reset_launch_counts()
        ops.reset_dispatch_counts()
        seen = []
        with output_watch(torch, seen):
            _, per_stream, wall = serve(torch, pipe, videos)
        launches, plain = ops.launch_counts(), ops.plain_calls_on_cuda()
        want = pipe.kernels
        del pipe
        # the same windows through the kernels' plain versions (own KV)
        pipe_p = ServingPipeline(cfg, v, lm, vit, ecfg, device="cuda")
        with ops.kernel_mode("plain"):
            _, plain_stream, _ = serve(torch, pipe_p, videos)
        del pipe_p
        lk = np.array([r.stats.logits_yes_no for res in per_stream for r in res])
        lp = np.array([r.stats.logits_yes_no for res in plain_stream for r in res])
        diff, tol, ans_ok = logit_agreement(lk, lp)
        preds = [video_prediction([r.stats.answer for r in res]) for res in per_stream]
        p, r, f1 = precision_recall_f1(preds, truths)
        f1s[mode] = f1
        n_win = sum(len(res) for res in per_stream)
        here = (n_win == 24 and lk.shape == lp.shape and bool(np.isfinite(lk).all())
                and all(launches.get(k, 0) > 0 for k in want)
                and not any(plain.values()) and bool(seen) and not any(seen)
                and diff <= tol and ans_ok)
        log(f"  serve [{cfg.name} trained, {mode}]: {n_win} windows in {wall:.3f} s; "
            f"launches {launches}; plain on CUDA: {plain}; outputs requiring grad "
            f"{sum(seen)} of {len(seen)}; composite vs kernel_mode('plain') over the "
            f"{lk.shape[0]} windows: max |d yes/no logit| {diff:.4g} (tol {tol:.3g}), answers "
            f"agree where the margin exceeds twice it: {ans_ok}; video predictions {preds} vs "
            f"truth {truths}: precision {p:.3f}, recall {r:.3f}, F1 {f1:.3f}: "
            f"{'ok' if here else 'FAIL'}")
        by_path[f"anomaly {mode}"] = launches
        ok = ok and here
    log(f"  F1 drop of codecflow against fullcomp: {f1s['fullcomp'] - f1s['codecflow']:+.3f} "
        f"(printed, not gated)")
    return ok, by_path


def train_phase(torch):
    """Phase 8: returns (ok, launches per path)."""
    t0 = time.perf_counter()
    ok = card_step_vs_cpu(torch)
    here, dec = train_whisper(torch)
    ok = ok and here
    ok = bigram_on_card(torch) and ok
    here, by_path = anomaly_on_card(torch)
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return ok and here, {f"{WHISPER_ARCH} decode": dec, **by_path}


# ----------------------------------------------------------------------
# phase 9: meshes, the roofline, the dry run
# ----------------------------------------------------------------------
MESH_ARCHS = ("whisper-large-v3-smoke", "olmoe-1b-7b-smoke")
MESH_WHISPER_STEPS = 3
DRYRUNS = (("deepseek-7b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"))
DRYRUN_TIMEOUT = 420


def timed_steps(torch, times: list):
    """A wrapper of ``make_train_step``: each step it makes appends its
    seconds, to the card's end of the step, to ``times``."""
    def wrap(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*args):
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                return out
            return run
        return made
    return wrap


def mesh_vs_meshless(torch, ref_ms, mesh_ms, ref, on_mesh):
    """(bitwise equal, within phase 8(a)'s limits, the largest parameter
    gap over its leaf's max) of a mesh run's per-step losses and grad
    norms and final parameters against the meshless run's."""
    from repro_torch.models.init import tree_leaves
    lr_, lm = ([float(m["loss"]) for m in ms] for ms in (ref_ms, mesh_ms))
    gr, gm = ([float(m["grad_norm"]) for m in ms] for ms in (ref_ms, mesh_ms))
    bitwise, gap = lr_ == lm and gr == gm, 0.0
    for a, b in zip(tree_leaves(ref), tree_leaves(on_mesh)):
        a, b = a.detach(), b.full_tensor().detach()
        bitwise = bitwise and torch.equal(a, b)
        gap = max(gap, float((a.float() - b.float()).abs().max())
                  / max(float(a.float().abs().max()), 1e-30))
    within = (all(abs(y - x) <= STEP_LOSS_TOL * abs(x) for x, y in zip(lr_, lm))
              and all(abs(y - x) <= STEP_GNORM_TOL * x for x, y in zip(gr, gm))
              and gap <= STEP_GRAD_TOL)
    return bitwise, within, gap


def held_text(bitwise: bool, within: bool) -> str:
    return "bitwise equal" if bitwise else (
        "within phase 8(a)'s limits (not bitwise)" if within else "FAIL")


def whisper_on_host_mesh(torch, mesh, smi: str) -> bool:
    """9(a) at full size: phase 8(b)'s whisper-large-v3 (batch 2, decoder
    seq 448, remat) trained MESH_WHISPER_STEPS steps from the seed's
    weights on the same batches, first without a mesh, then on the 1x1
    mesh (every op a DTensor op); each step timed to the card's end."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.init import init_lm_params, trainable
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(WHISPER_ARCH)
    ocfg = topt.OptCfg(warmup=1, total_steps=WHISPER_STEPS)      # as launch.train's
    it = lm_batches(cfg, WHISPER_BATCH, WHISPER_SEQ, seed=SEED, device="cuda")
    batches = [next(it) for _ in range(MESH_WHISPER_STEPS)]
    gc.collect()
    torch.cuda.empty_cache()
    ref_t, mesh_t, ref_ms = [], [], []
    ref = trainable(init_lm_params(cfg, SEED, "cuda"))
    opt = topt.init_opt_state(ref, ocfg)
    step = timed_steps(torch, ref_t)(make_train_step)(cfg, ocfg)
    for b in batches:
        ref, opt, m = step(ref, opt, b)
        ref_ms.append(m)
    del opt, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with wrapped(tlaunch, "make_train_step", timed_steps(torch, mesh_t)):
        on_mesh, opt, mesh_ms = tlaunch.train_on_mesh(
            cfg, mesh, ocfg, init_lm_params(cfg, SEED, "cuda"), iter(batches),
            MESH_WHISPER_STEPS, log_every=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del opt
    bitwise, within, gap = mesh_vs_meshless(torch, ref_ms, mesh_ms, ref, on_mesh)
    finite = all(math.isfinite(float(m["loss"])) for m in mesh_ms)
    t_ref, t_mesh = (sum(t[1:]) / len(t[1:]) for t in (ref_t, mesh_t))
    log(f"  host mesh [{WHISPER_ARCH}, full size, batch {WHISPER_BATCH}, seq {WHISPER_SEQ}, "
        f"remat; {smi}]: losses {[round(float(m['loss']), 6) for m in mesh_ms]} on the 1x1 "
        f"mesh vs {[round(float(m['loss']), 6) for m in ref_ms]} without; grad_norm "
        f"{[round(float(m['grad_norm']), 6) for m in mesh_ms]} vs "
        f"{[round(float(m['grad_norm']), 6) for m in ref_ms]}; largest parameter gap "
        f"{gap:.3g} of its leaf's max; step s on the mesh {[round(x, 4) for x in mesh_t]}, "
        f"without {[round(x, 4) for x in ref_t]} (step 1 includes the first calls' "
        f"set-up); steps 2-{MESH_WHISPER_STEPS}: {t_mesh:.4f} s on the mesh, {t_ref:.4f} s "
        f"without ({t_mesh / t_ref:.4f}x), phase 8(b)'s {READINGS.get('whisper_step_s')} s; "
        f"peak memory on the mesh {peak:.2f} GiB: {held_text(bitwise, within)}")
    del ref, on_mesh, batches
    gc.collect()
    torch.cuda.empty_cache()
    return (bitwise or within) and finite


def host_mesh_steps(torch, smi: str):
    """9(a): each arch's step on a 1x1 DeviceMesh vs without a mesh, then
    whisper-large-v3 at full size (``whisper_on_host_mesh``) and the
    entry point."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.init import init_lm_params, map_tree, trainable, tree_leaves
    from repro_torch.training import optimizer as topt
    from repro_torch.training.train_step import make_train_step
    mesh = make_host_mesh("cuda")
    ok = True
    for arch in MESH_ARCHS:
        cfg = get_config(arch)
        params = init_lm_params(cfg, SEED, "cuda")
        batch = next(lm_batches(cfg, 2, 32, seed=SEED, device="cuda"))
        ocfg = topt.OptCfg(lr=1e-3, warmup=1, total_steps=10)
        ref = trainable(map_tree(lambda t: t.clone(), params))
        ref, _, m_ref = make_train_step(cfg, ocfg, q_chunk=16)(
            ref, topt.init_opt_state(ref, ocfg), batch)
        t0 = time.perf_counter()
        on_mesh, _, [got] = tlaunch.train_on_mesh(
            cfg, mesh, ocfg, map_tree(lambda t: t.clone(), params), iter([batch]), 1,
            q_chunk=16, log_every=10**9)
        torch.cuda.synchronize()
        t_mesh = time.perf_counter() - t0
        bitwise, within, gap = mesh_vs_meshless(torch, [m_ref], [got], ref, on_mesh)
        log(f"  host mesh [{arch}] (1x1 DeviceMesh, world-size-1 NCCL, DTensor "
            f"parameters by the rules): loss {float(got['loss']):.6f} vs "
            f"{float(m_ref['loss']):.6f} without a mesh, grad_norm "
            f"{float(got['grad_norm']):.6f} vs {float(m_ref['grad_norm']):.6f}, largest "
            f"parameter gap {gap:.3g} of its leaf's max over {len(tree_leaves(ref))} leaves; "
            f"{t_mesh:.2f} s with DTensor's first calls: {held_text(bitwise, within)}")
        ok = ok and (bitwise or within)
        del params, ref, on_mesh
    ok = whisper_on_host_mesh(torch, mesh, smi) and ok
    _, losses = tlaunch.train(MESH_ARCHS[1], 2, 2, 32, mesh_kind="host", seed=SEED,
                              device="cuda", log_every=1)
    here = len(losses) == 2 and all(math.isfinite(x) for x in losses)
    log(f"  launch.train.train({MESH_ARCHS[1]!r}, mesh_kind='host'): losses "
        f"{[round(x, 4) for x in losses]}: {'ok' if here else 'FAIL'}")
    import torch.distributed as dist
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return ok and here


def whisper_roofline(torch, smi: str):
    """9(b): count one step of phase 8(b)'s whisper-large-v3 and hold its
    larger roofline term against phase 8(b)'s measured step time."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.init import init_lm_params, trainable
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(WHISPER_ARCH)
    params = trainable(init_lm_params(cfg, SEED, "cuda"))
    ocfg = OptCfg(warmup=1, total_steps=WHISPER_STEPS)
    opt = init_opt_state(params, ocfg)
    batch = next(lm_batches(cfg, WHISPER_BATCH, WHISPER_SEQ, seed=SEED, device="cuda"))
    step = make_train_step(cfg, ocfg)
    t0 = time.perf_counter()
    d = roofline.count_step(step, params, opt, batch)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    rep = roofline.Report(arch=WHISPER_ARCH, shape=f"train b{WHISPER_BATCH} s{WHISPER_SEQ}",
                          mesh="one card", chips=1, ok=True)
    rep.flops_per_device = d["flops"]
    rep.bytes_per_device = d["bytes_accessed"]
    rep.coll_bytes_per_device = d["coll_operand_bytes"]
    rep.model_flops = model_flops(cfg, WHISPER_BATCH, WHISPER_SEQ)
    t_step = READINGS.get("whisper_step_s")
    bound = max(rep.t_compute, rep.t_memory, rep.t_collective)
    share = bound / t_step if t_step else float("nan")
    mfu = rep.model_flops / t_step / BF16_TENSOR_FLOPS if t_step else float("nan")
    ok = t_step is not None and 0 < share <= 1.05
    log(f"  roofline [{WHISPER_ARCH}, full size, one step, {smi}]: counted "
        f"{d['flops'] / 1e12:.3f} T FLOPs (matrix products and attention), "
        f"{d['bytes_accessed'] / 1e9:.2f} GB accessed (every op's inputs and outputs once, "
        f"unfused), collectives {d['coll_operand_bytes']:.0f} B; t_compute "
        f"{rep.t_compute:.5f} s, t_memory {rep.t_memory:.5f} s, dominant {rep.dominant}, "
        f"useful ratio {rep.useful_ratio:.4f}; model FLOPs {rep.model_flops / 1e12:.2f} T "
        f"over the bf16 peak in the measured step: {mfu:.4f}; roofline share "
        f"(larger term over phase 8(b)'s step of {t_step} s): {share:.4f} (must lie in "
        f"(0, 1.05]); counted run {t_count:.1f} s, peak live "
        f"{d['peak_bytes'] / 2**30:.2f} GiB: {'ok' if ok else 'FAIL'}")
    del params, opt, batch, d
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def dry_runs(smi: str):
    """9(c): the dry run of each of DRYRUNS in a subprocess."""
    ok = True
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch, shape in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
               "--shape", shape, "--mesh", "single", "--outdir",
               str(ROOT / "experiments" / "dryrun_torch")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=DRYRUN_TIMEOUT, cwd=str(ROOT))
        secs = time.perf_counter() - t0
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        r = json.loads(lines[-1]) if lines else {}
        terms = [r.get(k, float("nan")) for k in ("t_compute_s", "t_memory_s", "t_collective_s")]
        here = (proc.returncode == 0 and r.get("ok") is True
                and all(math.isfinite(t) and t > 0 for t in terms))
        log(f"  dry run [{arch} {shape}, single mesh 16x16, fake 256-rank group, meta "
            f"device; numbers per H100 of {smi}]: ok {r.get('ok')}, peak "
            f"{r.get('peak_GiB_per_device', float('nan')):.2f} GiB per device, t_compute "
            f"{terms[0]:.4g} s, t_memory {terms[1]:.4g} s, t_collective {terms[2]:.4g} s, "
            f"dominant {r.get('dominant')}, useful ratio {r.get('useful_ratio')}, kernel ops "
            f"{r.get('kernels', {})}, counted in {r.get('compile_s')} s, {secs:.1f} s in all: "
            f"{'ok' if here else 'FAIL'}")
        if not here:
            log(proc.stdout[-3000:] + proc.stderr[-6000:])
        ok = ok and here
    return ok


def mesh_phase(torch, smi: str) -> bool:
    """Phase 9: each part runs, and is reported, whatever the others did;
    the phase passes only if all three pass."""
    import traceback
    t0 = time.perf_counter()
    ok = True
    for part in (lambda: host_mesh_steps(torch, smi), lambda: whisper_roofline(torch, smi),
                 lambda: dry_runs(smi)):
        try:
            here = part()
        except Exception:  # noqa: BLE001 - reported, and the phase fails
            traceback.print_exc()
            here = False
        ok = ok and here
    log(f"mesh phase: {time.perf_counter() - t0:.1f} s")
    return ok


# ----------------------------------------------------------------------
# phase 3(c): the kernel-contract registry on the card
# ----------------------------------------------------------------------
# windows served in phases 4, 5 and 7, and those reporting kernel calls
# the card refused (there must be none: a refused call raises)
SERVED = Counter()


def tally_fallbacks(results) -> None:
    """Count the windows of ``results`` (per-stream lists of
    WindowResult) and those with ``kernel_fallbacks`` above 0."""
    for rr in results:
        for r in rr:
            SERVED["windows"] += 1
            SERVED["with fallbacks"] += r.stats.kernel_fallbacks > 0


def same_outputs(torch, out, want) -> bool:
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    return len(outs) == len(wants) and all(torch.equal(a, b) for a, b in zip(outs, wants))


def contracts_phase(torch) -> bool:
    """Every eligibility rule provoked on the card and on CPU tensors,
    every op at its full serving widths, then the ops' host time."""
    from repro_torch.kernels import audit, contracts, ops
    t0 = time.perf_counter()
    on_card, on_cpu = audit.refusal_cases("cuda"), audit.refusal_cases("cpu")
    bad = []
    for key in sorted(on_card):
        (contract, code), (op, call, _) = key, on_card[key]
        before = ops.launch_counts().get(op, 0)
        try:
            call()
            got = "launched"
        except contracts.KernelIneligibleError as e:
            got = "raised" if f"eligibility '{code}' failed" in str(e) else f"raised: {e}"
        torch.cuda.synchronize()
        launched = ops.launch_counts().get(op, 0) - before
        op_c, call_c, plain_c = on_cpu[key]
        ops.reset_card_verdicts()
        out = call_c()
        verdicts = ops.card_verdicts()
        if not (got == "raised" and launched == 0 and verdicts == {op_c: {code: 1}}
                and same_outputs(torch, out, plain_c())):
            bad.append(f"{contract} '{code}': card {got}, {launched} launches; CPU verdicts "
                       f"{verdicts}")
    log(f"contracts: {len(on_card)} eligibility rules of {len(contracts.CONTRACTS)} ops "
        f"provoked on the card, each refused naming its rule with no launch, and on CPU "
        f"tensors, each recorded in card_verdicts() with the plain version's output: "
        f"{len(on_card) - len(bad)} of {len(on_card)} held; rules no ops call reaches first: "
        f"{sorted(audit.SHADOWED)}")
    for b in bad:
        log(f"FAIL: contracts: {b}")
    ops.reset_card_verdicts()
    for call in audit.serving_cases("meta").values():
        call()
    meta = ops.card_verdicts()
    cases = audit.serving_cases("cuda")
    launched = {}
    for op, call in cases.items():
        before = ops.launch_counts().get(op, 0)
        call()
        launched[op] = ops.launch_counts().get(op, 0) - before
    torch.cuda.synchronize()
    del cases
    full_ok = (meta == {op: {"ok": 1} for op in launched}
               and all(n == 1 for n in launched.values()))
    log(f"contracts: full serving widths (internvl3-14b LM H 40 / Hkv 8 D 128, ViT H 16 D 64, "
        f"448^2 frames, mamba2-2.7b SSD H 80 P 64 N 128): verdicts on meta tensors {meta}; "
        f"launches on the card {launched}")
    if not full_ok:
        log("FAIL: contracts: an op at serving widths was refused or did not launch")
    log(f"contracts: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return not bad and full_ok and host_times(torch)


def host_times(torch, calls: int = 200, reps: int = 9) -> bool:
    """Host time per call of ops.mv_sad, ops.ssd_scan and
    ops.flash_refresh_paged and of their CUDA wrappers at internvl3-14b's
    and mamba2-2.7b's serving shapes: ``reps`` runs of ``calls`` calls
    with no sync between them (the card runs behind); the median and the
    least run (the host is shared, so the least is the least disturbed).
    Uses only what every checkout since the wrappers were split from ops
    has, so ``--src`` can time a parent in the same call."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import WindowLayout, capacity_groups, refresh_block_map
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_refresh import build_block_map, flash_refresh_paged_cuda
    from repro_torch.kernels.mv_sad import mv_sad_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    g = torch.Generator(device="cuda").manual_seed(SEED)
    cur = torch.rand((HW, HW), generator=g, device="cuda") * 255
    prev = torch.roll(cur, (2, 3), (0, 1))
    x = torch.randn((2, 8, 80, 64), generator=g, device="cuda").bfloat16()
    la = -torch.rand((2, 8, 80), generator=g, device="cuda")
    b = torch.randn((2, 8, 1, 128), generator=g, device="cuda").bfloat16()
    init = torch.randn((2, 80, 64, 128), generator=g, device="cuda")
    v = get_config(ARCH).vit
    lay = WindowLayout(window=16, stride=4, gop=4, g_tokens=v.n_groups,
                       k_tokens=capacity_groups(v, 0.5), query_len=16)
    slots = -(-(lay.total_len + 16) // 128) * 128
    pps = slots // 128
    slab = torch.randn((2 * slots, 8, 128), generator=g, device="cuda").bfloat16()
    pt = torch.arange(2 * pps, dtype=torch.int32, device="cuda").reshape(2, pps)
    kvv = torch.ones((2, slots), dtype=torch.bool, device="cuda")
    cases = {}
    for label, bm in (("decode", build_block_map([lay.total_len], slots)),
                      ("selective refresh", refresh_block_map(lay, kv_len=slots))):
        qp = torch.as_tensor(np.broadcast_to(bm.q_pos[:bm.n_q], (2, bm.n_q)).copy(),
                             device="cuda")
        q = torch.randn((2, bm.n_q, 40, 128), generator=g, device="cuda").bfloat16()
        cases[f"flash_refresh_paged ({label}, q {tuple(q.shape)})"] = (
            lambda q=q, qp=qp, bm=bm: ops.flash_refresh_paged(q, slab, slab, qp, kvv, pt,
                                                              block_map=bm),
            lambda q=q, bm=bm: flash_refresh_paged_cuda(q, slab, slab, kvv, pt, bm))
    cases = {
        f"mv_sad ({HW}^2)": (lambda: ops.mv_sad(cur, prev, 16, 4),
                             lambda: mv_sad_cuda(cur, prev, 16, 4)),
        "ssd_scan (query, x (2, 8, 80, 64), N 128)": (
            lambda: ops.ssd_scan(x, la, b, b, init, 256),
            lambda: ssd_scan_cuda(x, la, b, b, init, 256)),
        **cases,
    }
    with torch.no_grad():
        for name, fns in cases.items():
            got = []
            for fn in fns:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                wall = []
                for _ in range(reps):
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        fn()
                    wall.append((time.perf_counter() - t0) / calls * 1e6)
                    torch.cuda.synchronize()
                got.append((float(np.median(wall)), min(wall)))
            (ow, ol), (ww, wl) = got
            READINGS.setdefault("hosttime", {})[name] = dict(ops=ow, wrapper=ww)
            log(f"hosttime: {name}: ops {ow:.2f} us per call (least {ol:.2f}), wrapper "
                f"{ww:.2f} us (least {wl:.2f}); median of {reps} runs of {calls} calls")
    return True


# ----------------------------------------------------------------------
# phase 10: the examples on the card
# ----------------------------------------------------------------------
EXAMPLES = (
    ("torch_quickstart.py", (), (
        r"^stream: \(16, 112, 112\), anomaly frames: 8$",
        r"^motion vectors: \(16, 7, 7, 2\), mean \|v\| on P-frames: \d+\.\d\d px$",
        r"^pruning: \{'kept_tokens': \d+, 'total_tokens': 256, ",
        r"^window: answer=(Yes|No) tokens=\d+/\d+ refreshed=\d+ GFLOP=\d+\.\d{3}$")),
    ("torch_streaming_analytics.py", ("--streams", "2", "--frames", "16"), (
        r"^  cam-[01]: done after 3 windows$",
        r"^mode=codecflow arch=internvl3-14b-smoke$",
        r"^streams=2 windows=6 wall=\d+\.\ds \(\d+\.\d\d windows/s aggregate\)$",
        r"^window latency p50=\d+\.\d{3}s p99=\d+\.\d{3}s  ttft p50=\d+\.\d{3}s$",
        r"^decisions=\[[01], [01]\] truths=\[[01], [01]\]  P=\d\.\d\d R=\d\.\d\d F1=\d\.\d\d$",
        r"^total GFLOP=\d+\.\d\d$")),
    ("torch_train_anomaly_vlm.py", ("--steps", "20", "--videos", "4"), (
        r"^training tiny VLM \(0\.\dM params\) for 20 steps on synthetic anomaly streams\.\.\.$",
        r"^  anomaly-train step   19 nll \d+\.\d{4} acc \d\.\d\d$",
        r"^eval fullcomp   F1=\d\.\d\d$",
        r"^eval codecflow  F1=\d\.\d\d$")),
)


def examples_phase(src: Path) -> bool:
    """Each example in a subprocess on the card (its default device):
    exit 0 and every line its JAX twin prints."""
    ok = True
    for name, flags, patterns in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / name), *flags],
                              env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
                              text=True, timeout=600, cwd=ROOT)
        lines = proc.stdout.splitlines()
        missing = [p for p in patterns if not any(re.search(p, ln) for ln in lines)]
        here = proc.returncode == 0 and not missing
        log(f"examples: {name} {' '.join(flags)}: exit {proc.returncode} in "
            f"{time.perf_counter() - t0:.1f} s; last lines {lines[-2:]}")
        if not here:
            log(f"FAIL: examples: {name}: missing {missing}; stderr {proc.stderr[-2000:]}")
        ok = ok and here
    return ok


def h100_rates():
    """(HBM bytes/s, bf16 tensor FLOP/s, f32 FLOP/s) from this checkout's
    ``analysis/roofline.py``, the port's one copy of them, whichever
    ``--src`` is driven (an earlier checkout may have none): the module
    is imported from here and forgotten again."""
    here = str(ROOT / "src")
    sys.path.insert(0, here)
    try:
        from repro_torch.analysis import roofline
        return roofline.HBM_BW, roofline.PEAK_FLOPS, roofline.F32_FLOPS
    finally:
        sys.path.remove(here)
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--only", default="",
                    help="comma-separated kernel names: their checks alone (phases 1-3); "
                         "or 'mha' (phase 3's mha probe), 'families' (phase 7), 'whisper' "
                         "(phase 8(b)) and 'mesh' (phase 8(b), then phase 9), each alone "
                         "after phases 1-2")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is driven")
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    global HBM_BYTES_PER_S, BF16_TENSOR_FLOPS, F32_FLOPS
    HBM_BYTES_PER_S, BF16_TENSOR_FLOPS, F32_FLOPS = h100_rates()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    from repro_torch.configs import ModelCfg, ViTCfg, get_config
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.kernels import cuda, ops
    from repro_torch.launch.serve import build_pipeline, default_vit
    from repro_torch.models.init import init_lm_params, init_vit_params
    from repro_torch.serving import ServingPipeline

    # -- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    cuda.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    spilled = []
    for src, text in cuda.build_log().items():
        for label, regs, spill in ptxas_kernels(text):
            log(f"  ptxas[{src}]: {label}: {regs} registers, {spill} bytes spilled")
            if spill and src == "attention.cu":
                spilled.append(label)
    if spilled:
        log(f"FAIL: attention kernels spill registers: {spilled}")
        return 1
    probes = {"mha": lambda: mha_probe(torch), "whisper": lambda: train_whisper(torch)[0],
              "hosttime": lambda: host_times(torch),
              "mesh": lambda: train_whisper(torch)[0] and mesh_phase(torch, smi),
              "families": lambda: serve_families(torch)[0]}
    if only and only <= set(probes):
        ok = all([probes[name]() for name in sorted(only)])
        print(smi)
        return 0 if ok else 1

    # -- 3. kernels vs plain versions -----------------------------------
    ops.reset_launch_counts()
    cfg = get_config(ARCH)
    videos = anomaly_dataset(2, 24, HW, HW, seed=SEED)
    t0 = time.perf_counter()
    pipe = build_pipeline(ARCH, "codecflow", codec_cfg(), seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"weights: {ARCH} ({cfg.n_layers} layers, d {cfg.d_model}) made on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    streams = [pipe.frontend.open(f) for f, _ in videos]
    unpruned = ServingPipeline(cfg, cfg.vit, pipe.params, pipe.vparams,
                               path_ecfg("fullcomp", {}), device="cuda")
    # head dim 24: benchmarks/common.py's VLM on its own layout (112^2),
    # and a larger case (H 32, Hkv 8) on internvl3-14b's; the smoke
    # model's widths (LM D 64 at 4 heads, ViT D 32), which phase 8(d)
    # held until it took the benchmark VLM
    bcfg, bvit = ModelCfg(**BENCH_LM), ViTCfg(**BENCH_VIT)
    bench = ServingPipeline(bcfg, bvit, {}, {}, path_ecfg("codecflow", {}), device="cuda")
    bench_streams = [bench.frontend.open(f) for f, _ in
                     anomaly_dataset(2, 24, bvit.image, bvit.image, seed=SEED)]
    blay, bslots = bench.layout, bench.cache_slots
    wide = dataclasses.replace(cfg, name="d24-wide", **WIDE_D24)
    smoke = get_config(SMOKE_ARCH)
    B24, W24 = "bench VLM, D 24", "D 24, H 32 / Hkv 8"
    stream_cases = (
        ("fresh prefill", cfg, pipe.layout, pipe.cache_slots, "fresh prefill"),
        ("fresh prefill, unpruned", cfg, unpruned.layout, unpruned.cache_slots,
         "fresh prefill"),
        ("selective refresh", cfg, pipe.layout, pipe.cache_slots, "selective refresh"),
        ("decode", cfg, pipe.layout, pipe.cache_slots, "decode"),
    ) + tuple((f"{B24}, {case}", bcfg, blay, bslots, case) for case in REFRESH_CASES) + (
        (f"{W24}, fresh prefill", wide, pipe.layout, pipe.cache_slots, "fresh prefill"),)
    n = len(videos)
    paged_families, stream_families = family_kernel_cases()
    paged_families += [(B24, bcfg, blay, bslots), (W24, wide, pipe.layout, pipe.cache_slots),
                       (f"{SMOKE_ARCH}, D 64", smoke, blay, bslots)]

    def prefill_paged():
        main = check_flash_prefill_paged(torch, cfg, pipe.layout, pipe.cache_slots, n)
        extra = {B24: check_flash_prefill_paged(torch, bcfg, blay, bslots, n, n_cold=1,
                                                label=B24),
                 W24: check_flash_prefill_paged(torch, wide, pipe.layout, pipe.cache_slots, n,
                                                label=W24)}
        return [with_cases(m, {lab: rows[i] for lab, rows in extra.items()})
                for i, m in enumerate(main)]

    checks = {   # kernel name -> its check; flash_prefill_paged's covers the int8 row too
        "mv_sad": lambda: [check_mv_sad(torch, videos)],
        "rope_shift": lambda: [with_cases(check_rope_shift(torch, cfg, pipe.layout, n), {
            f"{B24}, bf16": check_rope_shift(torch, bcfg, blay, n, label=f"{B24}, bf16"),
            f"{B24}, f32": check_rope_shift(torch, bcfg, blay, n, torch.float32,
                                            label=f"{B24}, f32"),
            W24: check_rope_shift(torch, wide, pipe.layout, n, label=W24),
            f"{SMOKE_ARCH}, D 64": check_rope_shift(torch, smoke, blay, n,
                                                    label=f"{SMOKE_ARCH}, D 64")})],
        "flash_refresh_paged": lambda: [check_flash_refresh_paged(
            torch, cfg, pipe.layout, pipe.cache_slots, n, paged_families)],
        "flash_packed": lambda: [with_cases(check_flash_packed(torch, pipe, streams), {
            B24: check_flash_packed(torch, bench, bench_streams, label=B24),
            "D 24, H 16 on internvl3-14b's packings": check_flash_packed(
                torch, pipe, streams, heads=(16, 24), label="D 24, H 16"),
            f"{SMOKE_ARCH} ViT, D 32": check_flash_packed(
                torch, bench, bench_streams, heads=(4, 32), label=f"{SMOKE_ARCH} ViT, D 32")})],
        "flash_refresh": lambda: [check_flash_refresh(torch, stream_cases, n, stream_families)],
        "flash_refresh_paged_int8": lambda: [with_cases(
            check_flash_refresh_paged_int8(torch, cfg, pipe.layout, pipe.cache_slots, n), {
                B24: check_flash_refresh_paged_int8(torch, bcfg, blay, bslots, n, n_cold=1,
                                                    label=B24),
                W24: check_flash_refresh_paged_int8(torch, wide, pipe.layout, pipe.cache_slots,
                                                    n, label=W24)})],
        "ssd_scan": lambda: [check_ssd_scan(torch)],
        "flash_prefill": lambda: [with_cases(
            check_flash_prefill(torch, cfg, pipe.layout.total_len, n), {
                lab: check_flash_prefill(torch, c, total, n, only=("causal", "ragged"),
                                         label=lab)
                for lab, c, total in ((B24, bcfg, blay.total_len),
                                      (W24, wide, pipe.layout.total_len))})],
        "flash_prefill_paged": prefill_paged,
    }
    if only - set(checks):
        log(f"FAIL: --only names no check: {sorted(only - set(checks))}")
        return 1
    results = [r for name, run in checks.items() if not only or name in only for r in run()]
    phase_launches = ops.launch_counts()
    del streams, unpruned, bench, bench_streams
    gc.collect()
    torch.cuda.empty_cache()
    rows = [r for _, r in results]
    if not all(ok for ok, _ in results):
        log("FAIL: a kernel disagrees with its plain version")
        return 1
    if only:
        print(json.dumps({"kernels": rows}))
        print(smi)
        return 0
    if not check_lm_head(torch, cfg, pipe.params):
        log("FAIL: lm_logits does not keep the head product's f32 result")
        return 1
    if not mha_probe(torch):
        log("FAIL: the dense mha")
        return 1
    if not contracts_phase(torch):
        log("FAIL: contracts phase")
        return 1

    # -- 4. serve -------------------------------------------------------
    ops.reset_launch_counts()
    ops.reset_dispatch_counts()
    ops.reset_card_verdicts()
    SERVED.clear()
    torch.cuda.reset_peak_memory_stats()
    sched, per_stream, wall = serve(torch, pipe, videos)
    launches = ops.launch_counts()
    plain_on_cuda = ops.plain_calls_on_cuda()
    n_win = sum(len(r) for r in per_stream)
    for i, res in enumerate(per_stream):
        log(f"stream {i}: answers {[r.stats.answer for r in res]}, yes/no logits "
            f"{[tuple(round(x, 4) for x in r.stats.logits_yes_no) for r in res]}")
    occ = {k: round(v, 4) for k, v in sched.stage_busy.items()}
    log(f"serve: {n_win} windows in {wall:.3f} s ({n_win / wall:.4f} windows/s incl. "
        f"codec ingest); stage busy s {occ}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"launches during serve: {launches}; plain on CUDA: {plain_on_cuda}")
    logits = np.array([r.stats.logits_yes_no for res in per_stream for r in res])
    ok = (n_win == 6 and bool(np.isfinite(logits).all())
          and all(launches.get(k, 0) > 0 for k in pipe.kernels)
          and not any(plain_on_cuda.values()))
    if not ok:
        log("FAIL: serve phase")
        return 1
    params, vparams = pipe.params, pipe.vparams
    main_run = ([[r.stats.logits_yes_no for r in res] for res in per_stream],
                sched.stage_busy["encode"],
                sum(r.stats.vit_slots for res in per_stream for r in res))
    del sched, pipe
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4, further paths: same weights, each path served once -------------
    t0 = time.perf_counter()
    ok, by_path, served = serve_paths(torch, cfg, params, vparams, videos, main_run)
    log(f"further paths: {time.perf_counter() - t0:.1f} s")
    if not ok:
        return 1

    # -- 4, the SSM family: mamba2-2.7b at full size --------------------
    t0 = time.perf_counter()
    ok, ssm_by_path, ssm_pipe = serve_ssm(torch)
    log(f"SSM paths: {time.perf_counter() - t0:.1f} s")
    if not ok:
        return 1

    # -- 5. engines: lockstep and async side by side ---------------------
    t0 = time.perf_counter()
    ok, engine_by_path = serve_engines(torch, cfg, params, vparams, videos, ssm_pipe,
                                       served["codecflow, int8 cold pages"])
    log(f"engines: {time.perf_counter() - t0:.1f} s")
    if not ok:
        log("FAIL: engines phase")
        return 1
    del params, vparams, ssm_pipe
    gc.collect()
    torch.cuda.empty_cache()
    by_path = {KERNEL_PHASE: phase_launches, MAIN: launches, **by_path, **ssm_by_path,
               **engine_by_path}
    for row in rows:
        name = row["name"]
        row["launches_path"] = LAUNCH_PATH.get(name, MAIN)
        row["launches"] = by_path[row["launches_path"]].get(name, 0)
        row["launches_by_path"] = {lab: n[name] for lab, n in by_path.items() if name in n}

    # -- 6. composite: kernels vs plain versions at 4 layers -------------
    short = [(f[:20], lab) for f, lab in videos]   # one fresh + one incremental window
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    params = init_lm_params(cfg4, SEED, "cuda")
    vparams = init_vit_params(cfg4.vit, cfg4.d_model, SEED + 1, "cuda")
    composites = [("codecflow", "codecflow", {})] + [
        p for p in PATHS if "pool_streams" not in p[2]]
    for label, mode, kv in composites:
        diff, tol, ans_ok, ok = composite(torch, cfg4, cfg4.vit, params, vparams, short,
                                          mode, kv)
        log(f"composite [{label}] (4 layers, full width): max |d yes/no logit| {diff:.4g} "
            f"(tol {tol:.3g}); answers agree where the margin exceeds 2 x tol: {ans_ok}")
        if not ok:
            log(f"FAIL: composite check [{label}]")
            return 1
    del params, vparams
    gc.collect()
    torch.cuda.empty_cache()
    scfg4 = dataclasses.replace(get_config(SSM_ARCH), n_layers=4)
    svit = default_vit(scfg4)
    params = init_lm_params(scfg4, SEED, "cuda")
    vparams = init_vit_params(svit, scfg4.d_model, SEED + 1, "cuda")
    ssm_short = [(f[:20], lab) for f, lab in anomaly_dataset(2, 20, SSM_HW, SSM_HW, seed=SEED)]
    for mode in SSM_PATHS:
        diff, tol, ans_ok, ok = composite(torch, scfg4, svit, params, vparams, ssm_short,
                                          mode, {})
        log(f"composite [{SSM_ARCH}, {mode}] (4 layers, full width): max |d yes/no logit| "
            f"{diff:.4g} (tol {tol:.3g}); answers agree where the margin exceeds 2 x tol: "
            f"{ans_ok}")
        if not ok:
            log(f"FAIL: composite check [{SSM_ARCH}, {mode}]")
            return 1
    del params, vparams

    # -- 7. families: MoE and hybrid at full width ------------------------
    t0 = time.perf_counter()
    ok, family_by_path = serve_families(torch)
    log(f"families: {time.perf_counter() - t0:.1f} s")
    if not ok:
        log("FAIL: families phase")
        return 1
    for row in rows:
        row["launches_by_path"].update(
            {lab: n[row["name"]] for lab, n in family_by_path.items() if row["name"] in n})
    verdicts = ops.card_verdicts()
    log(f"contracts: card_verdicts() over phases 4-7 {verdicts}; windows served in phases 4, "
        f"5 and 7: {SERVED['windows']}, with kernel_fallbacks > 0: {SERVED['with fallbacks']}")
    if (any(set(c) != {"ok"} for c in verdicts.values()) or SERVED["with fallbacks"]
            or not SERVED["windows"]):
        log("FAIL: a serving call the card refuses")
        return 1

    # -- 8. training: whisper-large-v3 at full size, the anomaly task ------
    ok, train_by_path = train_phase(torch)
    if not ok:
        log("FAIL: train phase")
        return 1
    for row in rows:
        row["launches_by_path"].update(
            {lab: n[row["name"]] for lab, n in train_by_path.items() if row["name"] in n})

    # -- 9. mesh: the host mesh, the roofline of a step, the dry run -------
    if not mesh_phase(torch, smi):
        log("FAIL: mesh phase")
        return 1

    # -- 10. the examples on the card -------------------------------------
    if not examples_phase(Path(args.src).resolve()):
        log("FAIL: examples phase")
        return 1

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
