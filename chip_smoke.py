#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --only flash_packed,rope_shift [--src DIR]
    python3 chip_smoke.py --only whisper [--src DIR]
    python3 chip_smoke.py --only families [--src DIR]
    python3 chip_smoke.py --only mesh
    python3 chip_smoke.py --only mamba
    python3 chip_smoke.py --only f32-ssm
    python3 chip_smoke.py --only d256
    python3 chip_smoke.py --only n256-ssm
    python3 chip_smoke.py --only odd-heads
    python3 chip_smoke.py --only n512-ssm
    python3 chip_smoke.py --only d512
    python3 chip_smoke.py --only d1024
    python3 chip_smoke.py --only f16
    python3 chip_smoke.py --only mixed
    python3 chip_smoke.py --only deep-step
    python3 chip_smoke.py --only hosttime [--src DIR]

With no arguments it runs every phase below.  ``--only`` runs phases 1-3
for the named kernels' checks alone (names as in the kernels line) and
prints their rows and the card's line, with no serve phase and no
contract line (``--only mha``, ``--only families``, ``--only whisper``,
``--only mamba``, ``--only f32-ssm``, ``--only d256``, ``--only n256-ssm``,
``--only odd-heads``, ``--only n512-ssm``, ``--only d512``, ``--only d1024``,
``--only mesh``, ``--only hosttime`` and ``--only deep-step``: phase 3's
mha probe, phase 7 alone, phase 8(b) alone, phase 8(e) with its
roofline, phases 7(f) and 8(f) (mamba2-2.7b in f32) alone, phase 7(g)
(internvl3-14b with LM heads of 256) alone, phases 7(h) and 8(g)
(mamba2-2.7b at d_state 256) alone, phase 7(i) (internvl3-14b with heads
of 90 and 75 at search radius 128) alone, phases 7(j) and 8(h)
(mamba2-2.7b at d_state 512) alone, phase 7(k) (internvl3-14b with LM and
ViT heads of 512) alone, phase 7(l) (heads of 1024) alone, phases 8(b)
and 8(e) then 9, phase 3(c)'s
host time per call alone, and phase 8(a)'s jamba-v0.1-52b-smoke step
over several seeds, in bf16 and f32); ``--src`` drives the ``repro_torch`` of another checkout's
``src`` directory (built there), so an earlier commit unpacked with
``git archive`` can be timed in the same call: parent, change, change,
parent.

Phases (any failure exits non-zero):

  1. device  — require CUDA; print the card's name and power limit; TF32 off.
  2. build   — compile the hand-written kernels from src/repro_torch/csrc
               (one nvcc per source, in parallel) and print what ptxas
               reports per kernel (registers, spills); an attention
               kernel or a scan kernel (forward or backward) that
               spills fails.
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
               heads (H 16 = Hkv 16, D 128; moonshot-v1-16b-a3b's too) and
               deepseek-7b's (H 32 = Hkv 32, D 128) on their codecflow
               layouts (total_len 168, vis_len 160, query 8, 256 slots),
               flash_refresh at jamba-v0.1-52b's (H 32, Hkv 8, D 128) on
               its recurrent passes over max_hist slots (window 0's and
               the last window's append, query and decode, fullcomp's
               append), ssd_scan at jamba's serving shapes (H 128, P 64,
               N 16); ssd_scan's backward kernel (no TPU counterpart)
               against ssd_scan_bwd_plain on the chunk states the forward
               kernel writes under grad, at mamba2-2.7b's training shape
               (B 2, L 2048, H 80, P 64, N 128), a ragged L 1000 without
               init or final-state cotangent, G 4 at a small width and
               jamba's widths: dx, db, dc within one bf16 step and dlog_a,
               d_init within 1e-3 of their slice's largest value, bitwise
               repeat, its bound at the bf16 tensor rate (the f32
               CUDA-core figure beside), and its three kernels' blocks
               per SM at each N; the scan's slabbed build (N / 128
               column slabs of 128 over blocks, the slab count a grid
               dimension) at mamba2-2.7b's widths re-cut to d_state 256
               and 512: the forward at the fresh, incremental, query,
               long and ragged shapes (bf16 in place), the fresh window
               in f32, N 384 in place, N 192, 136 and 320 on the next
               multiple of 128 (ragged L), the backward at the training
               shape at N 256 (bf16 and f32), 192, 512, 384 and 320,
               each line with its kernels' registers; kernel,
               plain and library (scaled_dot_product_attention, after a
               gather where the KV is paged; none for ssd_scan) times
               from CUDA events around
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
               its ViT (D 32).  Head dims without an exact build
               (RAGGED_WIDTHS: 16, 40, 72, 80, 96, 112 at H 16 over Hkv 4
               on internvl3-14b's layout) in every attention kernel, and
               the head dims off the 8-column grid (ODD_WIDTHS: 2, 20,
               33, 90, 100; rows 8-, 4- or 2-byte aligned), also with f32
               queries (f32 q/k/v in flash_packed and flash_prefill);
               f32 queries over the bf16 slab and caches at internvl3-
               14b's fresh, refresh and decode shapes (the paged, per-
               stream and int8 kernels; paged prefill bf16 and int8);
               f32 q/k/v at flash_packed's busy packing and
               flash_prefill's causal shape (within F32_ROW_TOL, their
               split pre-pass's bytes printed beside the bound, not in
               it); head dim 256 (the WIDE build) in every attention
               kernel at internvl3-14b's widths re-cut to 20 heads of 256
               over 4 (WIDE_HEADS: the same operations and bytes as its
               D-128 rows): the refresh kernels at fresh, refresh and
               decode (int8 at refresh), prefill causal, at an offset,
               windowed and ragged, paged prefill bf16 and int8,
               flash_packed's busy packing at H 8; f32 queries (f32
               q/k/v in flash_packed and flash_prefill), the ragged widths
               WIDE_RAGGED (192, 136, 130, 250) on it (130 and 250 also
               with f32 queries, and f32 q/k/v), and rope_shift at D 256
               and at D 20, 90 (an odd half of 45) and 130; head dims
               257 to 512 (the SLAB build: two 256-column slabs of V and
               O over blocks) at internvl3-14b's widths re-cut to 10
               heads of 512 over 2 (HEADS_512), d 264, 320, 384, 500,
               511 and 512 (SLAB_WIDTHS) in every attention kernel and
               operand mode it takes: bf16 (the refresh kernels at the
               selective refresh, and at 512 also the fresh prefill and
               decode; prefill causal, and at 512 at an offset, windowed
               and ragged; paged prefill bf16 and int8; flash_packed's
               busy packing at H 2), f32 queries over bf16 K/V in the
               refresh and paged kernels and f32 q/k/v in flash_packed
               and flash_prefill, one line each with its device ms,
               error against its limit and registers (slab_table), and
               rope_shift at D 320 and 512; head dims past 512 (the DEEP
               build: Q K^T over depth chunks of 256 columns,
               ceil(d / 256) column slabs of V and O), d 520, 640, 1000,
               1023 and 1024 (DEEP_WIDTHS) at internvl3-14b's widths
               re-cut to 5 heads over 1 (HEADS_1024) and d 2048 and 4096
               (DEEP_WIDE) at 2 heads over 1 on the bench VLM's layout,
               in the same kernels and modes as the SLAB widths (at 1024
               also the fresh prefill and decode, and the prefill at an
               offset, windowed and ragged; flash_packed at H 1), in the
               same table, and rope_shift at D 1024 and 2048; each
               attention case also prints device_ms (launches
               over copies of its inputs, L2-cold, in one replayed CUDA
               graph); mv_sad
               at 448^2 with radius 16 and 32 and block 8, and past one
               band's 227 KB (the tiled kernel: radius 128, block 64 at
               radius 96, and block 240 at radius 1 on a 240^2 frame)
               (MV_SEARCHES, tie_frames: bitwise).  Then the f16 phase
               (``--only f16``, check_f16): every kernel with a float
               operand in f16 (F16_ROWS: rope_shift at internvl3-14b's
               overlap keys (96 x 1920, 8, 128); the refresh kernels at
               its D-128 fresh, refresh and decode shapes, int8 with 15
               of 21 pages cold; flash_packed at the serve and busy
               packings, H 16, D 64; flash_prefill causal, 2 x 2048;
               paged prefill bf16 and int8; each attention kernel also at
               d 90, 512 and 1024; ssd_scan at mamba2-2.7b's fresh, step,
               query and long shapes and at N 256; its backward at the
               training shape), operands drawn in f16, each against its
               plain version on the same inputs within its limit
               (F16_ROW_TOL, 2^-9, for attention; the staged f32 limits
               plus one f16 step for the scan; one f16 step plus 1e-3 for
               rope_shift), while the kernel fed the operands rounded
               through bf16 must fail it; the int8 kernels' all-hot table
               bitwise the f16 kernel, its device ms beside the bf16
               build's on ``.bfloat16()`` copies, its bound and its f16
               library call (SDPA, gather + SDPA); each cache kernel's
               case once with its K/V in f32, which must raise
               'kernel-dtype' with no launch; then each
               kernel's first case once through ``ops`` (the f16 path: its
               rows' launches).  Then the mixed phase (``--only mixed``,
               after the f16 cases it takes; check_mixed): each attention
               kernel's first f16 case at D 128 (the ViT's D 64) and at d
               90, 512 and 1024 with a query of another type than its K/V
               (MIXED_PAIRS: f16 over bf16, bf16 or f32 over f16; in
               flash_packed and flash_prefill also bf16 or f16 over f32),
               operands drawn in f32 and rounded once, against its plain
               version within mixed_tol, its output in q's type, one
               launch; at D 128 (64) its device ms beside the build that
               does the same products (mixed_base), within MIXED_RATIO
               (1.15x) of it at D 128, a profiler trace of five calls that lists no
               kernel but the entry's own and no host copy or cast op,
               its bound; then each pair once
               through ``ops`` (the mixed path: its rows' launches, no
               plain call on CUDA).  Then the dense mha (a library GEMM, no
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
  7. families — the MoE, hybrid and dense families, with the launcher's 112^2
               ViT and random bf16 weights made on the card from the seed,
               each model's weights freed before the next: (a)
               olmoe-1b-7b at full width and depth (16 layers, d 2048, 64
               experts top-8), codecflow on the paged bf16 slab, 2 streams
               x 24 frames; (b) jamba-v0.1-52b at full width with 16 of its
               32 layers (d 4096, 32/8 heads, 16 experts top-2, SSD
               d_state 16), codecflow and fullcomp through the recurrent
               backend, 2 streams x 40 frames; (c) deepseek-7b (dense:
               30 layers, d 4096, 32 = 32 heads of 128) and (d)
               moonshot-v1-16b-a3b (48 layers, d 2048, 64 experts
               top-6) at full width and depth, codecflow on the paged
               bf16 slab, 2 streams x 24 frames; (e) deepseek-7b with
               f32 weights (f32 queries over the bf16 slab) ingested at
               search radius 16 (FAMILY_CODECS), the same path; (f)
               mamba2-2.7b with f32 weights; (g) internvl3-14b at full
               width with 20 LM heads of 256 over 4 (the
               attention kernels' D-256 build; its own ViT, 448^2
               frames), codecflow on the paged bf16 slab and then once
               on per-stream caches and once with int8 cold pages (which
               must demote pages), each path's windows/s, stage seconds,
               peak memory and launches printed beside phase 4's run of
               the same path at heads of 128 (at full depth); (h)
               mamba2-2.7b at full
               width and depth with its SSD state widened to 256
               (WIDE_STATE: two column slabs of the scan's slabbed
               build), codecflow, 2 x 40 frames, beside phase 4's
               d_state-128 run; (i) internvl3-14b at full width
               with 40 LM heads of 90 over 8 and its ViT re-cut to 16
               heads of 75 (ODD_ARCH: head dims off the 8-column grid,
               rope_shift at an odd half), ingested at search radius 128
               (mv_sad's tiled kernel), served as (g) (paged, per-stream,
               int8 cold pages); (j) mamba2-2.7b at d_state 512
               (WIDER_STATE: four column slabs), served as (h); (k)
               internvl3-14b at full width and depth with 10 LM heads of
               512 over 2 and its ViT re-cut to 2 heads of 512 (HEADS_512:
               the attention kernels' SLAB build in flash_packed,
               flash_refresh_paged and flash_refresh, rope_shift at D
               512), served as (g); (l) internvl3-14b at full width and
               depth with 5 LM heads of 1024 over 1 and its ViT re-cut to
               1 head of 1024 (HEADS_1024: the DEEP build, rope_shift at
               D 1024), served as (g); (g), (i) and (k) serve CUT_LAYERS
               (12) of the 48 layers; each case's seconds are printed.  Each case is served
               lockstep, async, async, lockstep as in phase 5, with the
               same checks and printout (and the state bytes per stream
               of the hybrid's attention caches and SSD states); the
               yes/no logits of all four runs must be bitwise equal.
               Before each MoE case one MoE layer is called at the largest
               serving shape and at a decode step's: it must report no
               sync and repeat bitwise; its dispatch buffer, measured
               peak and time beside its bytes bound are printed.
               Then each path's composite check, as in phase 6, through
               the first layers of the same weights (olmoe, deepseek
               and moonshot 4, jamba 8: one period of its pattern), the
               plain run taking the
               kernel run's expert choices (a bf16 step can move a near
               tie; the tokens that would have chosen otherwise are
               counted and printed).
  8. train — (a) one train step of whisper-large-v3-smoke (with remat),
               of olmoe-1b-7b-smoke (the CPU run's expert choices
               forced on the card), of mamba2-2.7b-smoke (with remat:
               both scan kernels) and of jamba-v0.1-52b-smoke (forced
               choices) on the card and on the CPU, from the same weights
               and batch: loss within 1e-3 and grad_norm 1e-2 relative,
               every gradient leaf within 2^-5 of its largest |g| (the
               CPU tests' limits), the card's kernel_mode("plain") step
               read beside; jamba's 16 bf16 layers, where rounding alone
               moves a leaf by more than that, are held to the plain
               step's gap plus 2^-5, and its f32 step (plain versions,
               card against CPU) within 1e-3 (see STEP_ARCHS);
               (b) whisper-large-v3
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
               whisper's prefill and decode shapes; (e) mamba2-2.7b at
               full size (64 layers, random bf16 weights from the seed)
               trained 4 steps through launch.train.train (remat, batch
               2, seq 2048): loss and grad_norm finite at every step,
               every leaf moved, no plain call on a CUDA tensor, 128
               forward and 64 backward scan launches a step (forward and
               remat's recompute, one backward per layer); printing peak
               memory, the time of steps 2-4, tokens/s and the model-FLOPs
               share (8 x parameters x positions over the bf16 peak); one
               more step under torch.profiler, with the backward kernel's
               share of the device time; (g) the same model at d_state
               256 (two column slabs) for 2 steps (the second timed) and
               one profiled step, its step time, peak and scan forward
               and backward device ms printed beside 8(e)'s; (h) the same
               at d_state 512.
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
               launch.train.train(mesh_kind="host") for 2 steps (olmoe,
               mamba2 and jamba smoke); mamba2-2.7b-smoke's 1x1-mesh step
               as the others'; (b)
               analysis.roofline.count_step over one step of phase 8(b)'s
               whisper-large-v3 (full size, batch 2, seq 448): compute and
               memory terms, dominant, useful ratio, and the larger term
               over phase 8(b)'s measured step (the roofline share), which
               must lie in (0, 1.05]; the same over one step of phase
               8(e)'s mamba2-2.7b, whose count must hold ssd_scan_bwd once
               per layer; (c) python -m repro_torch.launch.dryrun
               in a subprocess for deepseek-7b train_4k and jamba-v0.1-52b
               prefill_32k and train_4k on the single (16 x 16) mesh (the
               training program's count holds ssd_scan_bwd once per mamba
               layer per microbatch, ssd_scan twice): each report ok
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
path (mamba2-2.7b, codecflow), where they count 0; for ssd_scan_bwd,
which only training launches, phase 8(e)'s run; for the f16 rows
(``<kernel>_f16``: no model makes f16 operands, so a library caller's
``ops`` calls are their path), the f16 phase's run of the ops; for the
mixed rows (``<kernel>_mixed``), the mixed phase's.  ``launches_by_path``
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
TRAIN_PATH = f"{SSM_ARCH} training"      # phase 8(e): the scan's backward kernel's launches
MOE_ARCH = "olmoe-1b-7b"         # full width and depth, the launcher's 112^2 ViT
MOE_FRAMES = 24
HYBRID_ARCH = "jamba-v0.1-52b"   # full width, HYBRID_LAYERS of its 32 layers
HYBRID_LAYERS = 16               # 2 of 4 periods: ~48 GiB of bf16 weights
HYBRID_FRAMES = 40
HYBRID_PATHS = ("codecflow", "fullcomp")
# deepseek-7b (arXiv:2401.02954): dense, 30 layers, d 4096, 32 = 32 heads
# of 128 (GQA group 1), d_ff 11008, vocab 102400; 12.9 GiB of bf16 weights
DENSE_ARCH = "deepseek-7b"
# moonshot-v1-16b-a3b (hf:moonshotai/Moonlight-16B-A3B): 48 MoE layers,
# d 2048, 16 = 16 heads of 128, 64 experts top-6 of d_ff 1408, vocab
# 163840; 52.3 GiB of bf16 weights
WIDE_MOE_ARCH = "moonshot-v1-16b-a3b"
# deepseek-7b with dtype="float32": 25.8 GiB of f32 weights, served at
# search radius 16 (phase 7(e))
DENSE_F32 = "deepseek-7b f32"
# mamba2-2.7b with dtype="float32": 10.3 GiB of f32 weights, served in
# phase 7(f) and trained in phase 8(f) (x, b and c reach the scan in f32)
SSM_F32 = f"{SSM_ARCH} f32"
# mamba2-2.7b with its SSD state widened to 256 (SSMCfg.d_state; the Mamba-2
# paper's state-size ablations run N 16 to 256): two column slabs,
# served in phase 7(h) and trained in phase 8(g)
WIDE_STATE = 256
SSM_N256 = f"{SSM_ARCH}, d_state {WIDE_STATE}"
# ... and to 512 (four column slabs of 128 on the scan's slabbed build, the
# slab count a grid dimension): phases 7(j) and 8(h)
WIDER_STATE = 512
SSM_N512 = f"{SSM_ARCH}, d_state {WIDER_STATE}"
# internvl3-14b with LM heads of 90 (40 over 8 kv heads: bf16 rows 4-byte
# aligned, int8 cold rows 2-byte aligned, rope_shift at an odd half of 45,
# refresh on the D-128 build), its ViT re-cut to d_model 1200 in 16 heads of
# 75 (odd: flash_packed's rows 2-byte aligned), ingested at search radius
# 128 (a 272^2 band at block 16: mv_sad's tiled kernel): phase 7(i)
ODD_ARCH = f"{ARCH}, heads of 90 and 75, radius 128"
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
# f32 q/k/v (flash_packed, flash_prefill): every operand enters the
# products as two bf16 halves (about 16 bits) and the output is f32, so
# the row-relative error is near f32's: held to 2^-10.  So are f32
# queries in the prefill kernels (kept as two halves over bf16 K/V; the
# output is not rounded).  An f32 query in the refresh kernels keeps
# ROW_TOL: their oracle rounds q x scale to bf16 and P to V's type.
F32_ROW_TOL = 2.0 ** -10
# f16 q/k/v (every attention kernel): the kernels round as their bf16
# builds do, but to f16 (2^-11 relative), and the readings sit near two f16
# steps of the row's largest value (0.0009-0.0011 on an H100): held to
# 2^-9, which a path through bf16 fails by far (the plain version fed
# operands rounded through bf16 reads 0.005-0.010 against its f16 answer,
# an output rounded through bf16 0.0039), and each f16 case also holds a
# control: the kernel fed its operands rounded through bf16 must fail it
F16_ROW_TOL = 2.0 ** -9
# head dims the exact builds (24, 32, 64, 128) do not have, each run on the
# smallest ragged build that holds it (csrc/attention.cuh), at H 16 over
# Hkv 4 on internvl3-14b's layout; the f32 cases at its own widths
RAGGED_WIDTHS = (16, 40, 72, 80, 96, 112)
# head dims off the 8-column grid (2, 4 or 6 mod 8, and odd: rows 8-, 4- or
# 2-byte aligned, copied in narrower chunks and their last chunk masked),
# at the same heads; also with f32 queries (f32 q/k/v in flash_packed and
# flash_prefill)
ODD_WIDTHS = (2, 20, 33, 90, 100)
# internvl3-14b re-cut to LM heads of 256 (phase 3's D-256 cases, and
# phase 7(g)): 20 heads over 4 kv heads keep d_model 5120 and the GQA
# group of 5, so the parameters, the KV bytes per stream and the
# attention FLOPs are those of its 40 heads of 128 over 8
WIDE_HEADS = dict(n_heads=20, n_kv=4, d_head=256)
WIDE_ARCH = f"{ARCH}, 20 heads of 256"
# head dims on the WIDE build's ragged path (d 129 to 255), at H 20 over
# Hkv 4; the last two off the 8-column grid (ODD_WIDTHS' f32 cases too)
WIDE_RAGGED = (192, 136, 130, 250)
ODD_WIDE = (130, 250)
# internvl3-14b re-cut to LM heads of 512 (phase 3's D-512 cases, and
# phase 7(k), whose ViT is re-cut to 2 heads of 512): 10 heads over 2 kv
# heads keep d_model 5120 and the GQA group of 5, so the parameters, the
# KV bytes per stream and the attention FLOPs are those of its 40 heads of
# 128 over 8 (kernels.audit.HEADS_512)
HEADS_512 = dict(n_heads=10, n_kv=2, d_head=512)
D512_ARCH = f"{ARCH}, LM and ViT heads of 512"
# head dims on the SLAB build (two 256-column slabs of V and O over
# blocks): 264 to 511 ragged (500: rows 8-byte aligned; 511: odd, 2-byte),
# 512 exact, at H 10 over Hkv 2 (flash_packed: the 7(k) ViT's H 2)
SLAB_WIDTHS = (264, 320, 384, 500, 511, 512)
# internvl3-14b re-cut to LM heads of 1024 (phase 3's DEEP cases at 7(l)'s
# layout, and phase 7(l), whose ViT is re-cut to 1 head of 1024): 5 heads
# over 1 kv head keep d_model 5120 and the GQA group of 5
# (kernels.audit.HEADS_1024)
HEADS_1024 = dict(n_heads=5, n_kv=1, d_head=1024)
D1024_ARCH = f"{ARCH}, LM and ViT heads of 1024"
# head dims on the DEEP build (Q K^T over depth chunks of 256 columns,
# ceil(d / 256) column slabs of V and O): just past the SLAB build (520,
# 640), 8-byte rows (1000), odd 2-byte rows (1023) and 1024 at H 5 over Hkv
# 1 on internvl3-14b's layout (flash_packed: the 7(l) ViT's H 1); 2048 and
# 4096 at H 2 over Hkv 1 on the bench VLM's smaller layout (flash_packed:
# H 1)
DEEP_WIDTHS = (520, 640, 1000, 1023, 1024)
DEEP_WIDE = (2048, 4096)
# the builds phase 3's width table reads: SLAB_WIDTHS on the D-512 one,
# the rest past it on the DEEP one
WIDTH_TABLE = SLAB_WIDTHS + DEEP_WIDTHS + DEEP_WIDE
# depth of the re-cut internvl3-14b cases 7(g), 7(i) and 7(k) (of 48
# layers): their kernels and bitwise checks run at every layer count, and
# 7(l) serves the full depth at full attention width
CUT_LAYERS = 12
# mv_sad beyond the codec's radius 4: (frame edge, block, radius); the last
# three past one band's 227 KB of shared memory (the tiled kernel: a 272^2
# band, a 256^2 one, and block 240's 230 KB macroblock in row strips)
MV_SEARCHES = ((448, 16, 16), (448, 16, 32), (448, 8, 16), (448, 16, 128), (448, 64, 96),
               (240, 240, 1))
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


# csrc/attention.cuh's operand types (OPS_BF16 = 0 is the exact label)
BUILD_OPS = {"1": ", f32 q", "2": ", f32 q/k/v", "3": ", f16", "4": ", f16 k/v, split q"}
# csrc/ssd_scan.cuh's operand modes
SCAN_MODES = {"0": "bf16 in place", "1": "staged hi/lo"}


def kernel_label(mangled: str) -> str:
    """mma_kernel<D, problem struct> of an attention kernel's mangled name
    (D "deep": the DEEP build; "+cold": the struct with int8 cold pages;
    ", any d": a ragged bf16 build, ", f16" and ", f16, any d": the f16
    builds, ", f32 q" and ", f32 q/k/v": the f32 builds, ragged too),
    name<n> of another kernel templated on one integer; other names
    unchanged."""
    b = re.search(r"BuildILi(\d+)ELb([01])ELi(\d)ELi(\d+)E", mangled)
    struct = next((s for s in ATTN_STRUCTS if s in mangled), None)
    if "mma_kernel" not in mangled or b is None or struct is None:
        m = re.search(r"([a-z_]+_kernel)ILi(\d+)ELi(\d)E(?:Li(\d)E)?", mangled)
        if m:     # the scan's kernels: <build N (slab count 0: any, a grid dimension), mode>
            n = m.group(2) if m.group(4) != "0" else f"{m.group(2)} x slabs"
            return f"{m.group(1)}<{n}, {SCAN_MODES.get(m.group(3), m.group(3))}>"
        m = re.search(r"([a-z_]+_kernel)ILb([01])E", mangled)
        if m:
            return f"{m.group(1)}<{'ragged N' if m.group(2) == '1' else 'exact N'}>"
        m = re.search(r"([a-z_]+_kernel)ILi(\d+)E", mangled)
        if m:
            return f"{m.group(1)}<{m.group(2)}>"
        m = re.search(r"\d((?:[a-z_]|(?<=bf)16)+_kernel)E", mangled)
        return m.group(1) if m else mangled
    cold = "+cold" if "WithColdPages" in mangled else ""
    width, ragged, ops_, deep = b.groups()
    kind = BUILD_OPS.get(ops_, "") + (", any d" if ragged == "1" and ops_ in "03" else "")
    return f"mma_kernel<{width if deep == '0' else 'deep'}, {struct}{cold}{kind}>"


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


# a call slower than SLOW_MS is timed over fewer calls: cuda_ms keeps to
# about TIME_BUDGET_MS of calls, device_ms to 2 copies replayed once (the
# head dims past 512 with narrow rows or f32 operands take 20-400 ms a
# call, and phase 3 would pass its share of the time limit)
SLOW_MS, TIME_BUDGET_MS = 10.0, 100.0


def one_call_ms(torch, fn) -> float:
    """One call of ``fn`` on the card, timed with CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean time of ``fn`` on the card from CUDA events, after warm-up
    (the first warm-up call timed: past SLOW_MS, the second is skipped and
    ``iters`` cut to TIME_BUDGET_MS of calls, at least one)."""
    first = one_call_ms(torch, fn) if warmup else 0.0
    if first > SLOW_MS:
        iters = max(1, min(iters, int(TIME_BUDGET_MS / first)))
    else:
        for _ in range(warmup - 1):
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
    longer.  A launch slower than SLOW_MS takes at least 2 copies,
    replayed once."""
    if one_call_ms(torch, lambda: fn(*args)) > SLOW_MS:
        min_copies, replays = 2, 1
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
    """(max |k - p|, max over (.., head) rows of max |k - p| / max |p|).
    A row is the scale the limits (bf16 steps of the row's largest value)
    rest on: the largest of its values is of the order of the summed
    terms.  Under 4 values a head (head dim 1 or 2) it is not, since two
    weighted averages of random V often both cancel far below it (the
    plain version then reads 0.14 to 7.5 from the unrounded function at
    head dim 2 and 1), so there the row is the query row over its heads."""
    if out_p.dim() >= 3 and out_p.shape[-1] < 4:
        out_k, out_p = out_k.flatten(-2), out_p.flatten(-2)
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


def tie_frames(torch, hw: int, seed: int):
    """Integer-valued frames (every SAD exact in any summation order),
    constant over 8x8 blocks in half the 32x32 regions (many exact ties),
    and the current frame the reference shifted by (11, -9) (motion past
    radius 4)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prev = rng.integers(0, 256, (hw, hw)).astype(np.float32)
    flat = np.repeat(np.repeat(rng.integers(0, 256, (-(-hw // 8),) * 2), 8, 0), 8, 1)[:hw, :hw]
    mask = np.repeat(np.repeat(rng.random((-(-hw // 32),) * 2) < 0.5, 32, 0), 32, 1)[:hw, :hw]
    prev = np.where(mask, flat, prev).astype(np.float32)
    cur = np.roll(prev, (11, -9), axis=(0, 1))
    return (torch.as_tensor(cur.copy(), device="cuda"),
            torch.as_tensor(prev, device="cuda"))


def check_mv_search(torch, hw: int, block: int, radius: int):
    """mv_sad at a radius or block edge past the codec's (several
    candidates a thread; block 8's band) on ``tie_frames``: MVs and SADs
    bitwise the plain version's first minimum.  (ok, readings)."""
    from repro_torch.kernels.mv_sad import launch_geometry, mv_sad_cuda, mv_sad_plain
    cur, prev = tie_frames(torch, hw, seed=block + radius)
    mv_k, sad_k = mv_sad_cuda(cur, prev, block, radius)
    mv_p, sad_p = mv_sad_plain(cur, prev, block, radius)
    bitwise = torch.equal(mv_k, mv_p) and torch.equal(sad_k, sad_p)
    n_cand = (2 * radius + 1) ** 2
    threads, _, smem, tile = launch_geometry(block, radius)
    ms = cuda_ms(torch, lambda: mv_sad_cuda(cur, prev, block, radius), 20)
    dev_ms = device_ms(torch, lambda a, b: mv_sad_cuda(a, b, block, radius), (cur, prev),
                       2 * hw * hw * 4)
    plain = cuda_ms(torch, lambda: mv_sad_plain(cur, prev, block, radius), 2, warmup=1)
    hb = hw // block
    b_ms, b_by = bound_ms(2 * hw * hw * 4 + hb * hb * 12, 3 * hw * hw * n_cand, F32_FLOPS)
    tiling = ("" if tile is None else f", tiled: {tile[0]} x {tile[1]} candidates a tile, "
              f"macroblock strips of {tile[2]} rows")
    log(f"mv_sad ({hw}^2, block {block}, radius {radius}: {n_cand} candidates over {threads} "
        f"threads, {smem} shared bytes{tiling}): MVs and SADs bitwise the plain version's: "
        f"{bitwise}, "
        f"MVs past radius 4: {int((mv_p.abs() > 4).any(-1).sum())} of {hb * hb}; kernel "
        f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    return bitwise, dict(max_abs_err=float((sad_k - sad_p).abs().max()), ms=ms,
                         device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, threads=threads, shared_bytes=smem, tile=tile)


def check_rope_shift(torch, cfg, layout, n_streams, dtype=None, label=None):
    """The overlap's keys of every layer and stream rotated by the
    window's shift, at ``cfg``'s kv heads and head dim, in bf16 (at D 24
    the kernel's 8-byte path) or ``dtype``.  In f16 also the bf16 build's
    device ms on ``k.bfloat16()``, and the control: the kernel fed k
    rounded through bf16 must fail the limit."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.rope_shift import rope_shift_cuda, rope_shift_plain
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(1)
    n = cfg.repeats * n_streams
    ov, sh = layout.overlap_tokens, layout.shift_tokens
    k = torch.randn((n, ov, cfg.n_kv, cfg.d_head), generator=g, device="cuda").to(dtype)
    delta = torch.full((n, ov), -sh, dtype=torch.int32, device="cuda")
    out_k = rope_shift_cuda(k, delta, cfg.rope_theta)
    out_p = rope_shift_plain(k, delta, cfg.rope_theta)
    # elementwise: one step of the value in k's dtype (bf16 2^-7, f16 2^-10
    # relative; none in f32) plus 1e-3 for the f32 angle (|delta * freq| ~
    # 640 rad: one f32 ulp of the angle moves the result by ~1e-4 |k|)
    step = {torch.bfloat16: 2.0 ** -7, torch.float16: F16_ROPE_STEP}.get(dtype, 0.0)

    def excess_of(out):
        return float(((out.float() - out_p.float()).abs() - step * out_p.float().abs()).max())
    err = float((out_k.float() - out_p.float()).abs().max())
    excess = excess_of(out_k)
    ms = cuda_ms(torch, lambda: rope_shift_cuda(k, delta, cfg.rope_theta), 20)
    # internvl3-14b's k alone is 377 MB, past the L2 many times over
    dev_ms = device_ms(torch, lambda a, b: rope_shift_cuda(a, b, cfg.rope_theta), (k, delta),
                       k.numel() * k.element_size(), min_copies=2)
    plain = cuda_ms(torch, lambda: rope_shift_plain(k, delta, cfg.rope_theta), 5)
    n_bytes = 2 * k.numel() * k.element_size() + delta.numel() * 4
    b_ms, b_by = bound_ms(n_bytes, 3 * k.numel(), F32_FLOPS)
    name = "rope_shift" if label is None else f"rope_shift ({label})"
    ok, f16 = excess <= 1e-3, {}
    if dtype == torch.float16:
        kb = k.bfloat16()
        f16 = dict(bf16_device_ms=device_ms(
            torch, lambda a, b: rope_shift_cuda(a, b, cfg.rope_theta), (kb, delta),
            kb.numel() * kb.element_size(), min_copies=2),
            control_excess=excess_of(rope_shift_cuda(kb.half(), delta, cfg.rope_theta)))
        ok = ok and f16["control_excess"] > 1e-3 and out_k.dtype == torch.float16
        F16_CALLS.setdefault("rope_shift", (lambda k, d: ops.rope_shift(k, d, cfg.rope_theta),
                                            (k, delta)))
        del kb
    log(f"{name}: k {tuple(k.shape)} {str(dtype)[6:]}, delta {-sh}: max abs err {err:.3g}; "
        f"max (|k-p| - {f'2^{math.log2(step):.0f} |p|' if step else '0'}) {excess:.3g} (limit "
        f"1e-3); kernel "
        f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})" + (
            f"; f16: bf16 build {f16['bf16_device_ms']:.4f} ms on the device, k through bf16 "
            f"{f16['control_excess']:.3g} (must exceed the limit)" if f16 else ""))
    return ok, dict(name="rope_shift", route="cuda", source="src/repro_torch/csrc/rope_shift.cu",
                    replaces="src/repro/kernels/rope_shift.py:40",
                    max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None, **f16)


REFRESH_CASES = ("fresh prefill", "selective refresh", "decode")


def _refresh_inputs(torch, cfg, layout, cache_slots, n_streams, case: str, q_dtype=None):
    """Query rows, slab, page table, validity and map shaped as on the
    serving path: fresh prefill ([0, total_len)), the selective refresh
    set, or the first decode step (one query at total_len, keys up to
    it, causal only as in the reference's decode); the query in
    ``q_dtype`` (bf16 by default; an f32 LM's is f32), the slab bf16 (f16
    under an f16 query: the f16 build takes q, k and v in f16), every
    operand drawn in f32 and rounded once to its type."""
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
    kv_dtype = torch.float16 if q_dtype == torch.float16 else torch.bfloat16
    q = torch.randn((n_streams, Sq, cfg.n_heads, cfg.d_head), generator=g,
                    device="cuda").to(q_dtype or torch.bfloat16)
    k = torch.randn((P * 128, cfg.n_kv, cfg.d_head), generator=g, device="cuda").to(kv_dtype)
    v = torch.randn((P * 128, cfg.n_kv, cfg.d_head), generator=g, device="cuda").to(kv_dtype)
    q_pos = torch.as_tensor(bm.q_pos[:Sq], dtype=torch.long, device="cuda")[None].expand(n_streams, Sq)
    return q, k, v, q_pos, kv_valid, pt, bm


def refresh_mask(torch, q_pos, kv_valid):
    """(B, Sq, slots): causal on the query positions AND kv_valid."""
    kpos = torch.arange(kv_valid.shape[1], device="cuda")
    return (kpos[None, None, :] <= q_pos[:, :, None]) & kv_valid[:, None, :]


def check_attention(torch, kernel, args, plain, library, q, n_kv, mask, key_bytes,
                    extra_bytes, dead_rows_zero=True, tol=ROW_TOL, op=None):
    """Hold one attention kernel, ``kernel(*args)``, against its plain
    version on the same inputs: the row-relative error within ``tol``
    (F16_ROW_TOL for f16 q/k/v, with ``f16_readings``) and,
    where ``dead_rows_zero`` (the refresh kernels), rows with no visible
    key exactly 0.  ``mask`` (B or 1, Sq, slots) bool is the attention
    mask.  Times the kernel per call and on the device (``device_ms``,
    over copies of ``args``), the plain version and ``library(mask)``.
    The bound: q read and the output written once, ``key_bytes(needed)``
    bytes per (kv head, d_head) element summed over the key rows some
    query needs (``needed`` (B, slots) bool) for K and V, plus
    ``extra_bytes`` of masks and tables; 4 D H flops per live (query,
    key) pair.  ``op``: (kernel name, its ``ops`` entry point over
    ``args``), which the f16 phase's path calls once (F16_CALLS: an f16
    kernel's first case) and the mixed phase runs with q and K/V of two
    types (MIXED_CASES: an f16 kernel's first case at each head dim).
    Returns (ok, readings)."""
    out_k, out_p = kernel(*args), plain()
    err, rel = attn_errors(torch, out_k, out_p)
    B, Sq, H, D = q.shape
    f16 = q.dtype == torch.float16
    if f16:
        tol = F16_ROW_TOL
    r = dict(max_abs_err=err, rel=rel, tol=tol)
    if dead_rows_zero:
        r["dead_zero"] = bool((out_k[~mask.expand(B, -1, -1).any(-1)] == 0).all())
    live = float(mask.sum()) * (B // mask.shape[0])
    kv_bytes = key_bytes(mask.any(1).expand(B, -1)) * n_kv * D * 2

    def work(q_size, kv_size):     # (flops, bytes) with q and K/V elements of these sizes
        return (4.0 * D * H * live, 2 * q.numel() * q_size
                + kv_bytes * kv_size / k_size + extra_bytes)
    k_size = args[1].element_size()
    flops, n_bytes = work(q.element_size(), k_size)
    b_ms, b_by = bound_ms(n_bytes, flops, BF16_TENSOR_FLOPS)
    in_bytes = sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
    r.update(ms=cuda_ms(torch, lambda: kernel(*args), 10),
             device_ms=device_ms(torch, kernel, args, in_bytes),
             plain_ms=cuda_ms(torch, plain, 3),
             library_ms=cuda_ms(torch, lambda: library(mask), 5),
             bound_ms=b_ms, bound_by=b_by)
    ok = rel <= tol and r.get("dead_zero", True)
    if f16:
        ok = f16_readings(torch, kernel, args, out_k, out_p, r, in_bytes,
                          refuse_f32_kv=op is None or op[0] != "flash_prefill") and ok
        if op is not None:
            F16_CALLS.setdefault(op[0], (op[1], args))
            MIXED_CASES.setdefault((op[0], D), (kernel, op[1], args, work))
    return ok, r


# the f16 phase's path: kernel name -> (its ops entry point, the operands of
# its first f16 case), filled by the checks as they run, called once by
# check_f16
F16_CALLS = {}
# the mixed phase's cases: (kernel name, head dim) -> (its wrapper over the
# args, its ops entry point, the args of its first f16 case at that head
# dim, work(q element size, K/V element size) -> (flops, bytes)), filled
# by the f16 phase's checks, run by check_mixed
MIXED_CASES = {}


def f16_readings(torch, kernel, args, out_k, out_p, r, in_bytes, refuse_f32_kv=True) -> bool:
    """An f16 attention case's further readings into ``r`` (which holds its
    ``tol``): the bf16 build's device ms on ``.bfloat16()`` copies of the
    f16 operands in ``args``; the control, the kernel fed those operands
    rounded through bf16 (what a path reading f16 as bf16 computes), whose
    row-relative error against ``out_p`` must exceed ``tol``; and, where
    ``refuse_f32_kv`` (the cache kernels), the f16 query over K/V in f32,
    which must raise 'kernel-dtype' with no launch (flash_packed and
    flash_prefill take it: the mixed phase).  True if all held and
    ``out_k`` is f16."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.cuda import KernelError
    half = [torch.is_tensor(a) and a.dtype == torch.float16 for a in args]
    bf = [a.bfloat16() if h else a for a, h in zip(args, half)]
    r["bf16_device_ms"] = device_ms(torch, kernel, bf, in_bytes)
    _, r["control_rel"] = attn_errors(
        torch, kernel(*[a.half() if h else a for a, h in zip(bf, half)]), out_p)
    launched = 0
    if refuse_f32_kv:
        before = sum(ops.launch_counts().values())
        try:
            kernel(args[0], args[1].float(), args[2].float(), *args[3:])
            r["f32_kv"] = "no refusal"
        except KernelError as e:
            r["f32_kv"] = "kernel-dtype" if "kernel-dtype" in str(e) else str(e)
        launched = sum(ops.launch_counts().values()) - before
    return (out_k.dtype == torch.float16 and r["control_rel"] > r["tol"]
            and r.get("f32_kv", "kernel-dtype") == "kernel-dtype" and launched == 0)


def attention_reading(r, library: str) -> str:
    dead = f", masked rows exact zero: {r['dead_zero']}" if "dead_zero" in r else ""
    return (f"max abs err {r['max_abs_err']:.3g}, max row-relative err {r['rel']:.3g} "
            f"(limit {r['tol']:.3g}){dead}; kernel {r['ms']:.4f} ms ({r['device_ms']:.4f} ms on "
            f"the device), plain "
            f"{r['plain_ms']:.4f} ms, {library} {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}){f16_note(r)}")


def f16_note(r) -> str:
    """f16_readings' readings in words ('' for a case in another dtype)."""
    if "control_rel" not in r:
        return ""
    f32_kv = f", f32 K/V: {r['f32_kv']}" if "f32_kv" in r else ""
    return (f"; f16: bf16 build {r['bf16_device_ms']:.4f} ms on the device, operands through "
            f"bf16 {r['control_rel']:.3g} (must exceed the limit){f32_kv}")


def kernel_row(name, replaces, r):
    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return dict(name=name, route="cuda", source="src/repro_torch/csrc/attention.cuh",
                replaces=replaces, **{k: r[k] for k in keys},
                **{k: r[k] for k in ("rel", "tol", *F16_KEYS) if k in r})


F16_KEYS = ("bf16_device_ms", "control_rel", "f32_kv")   # f16_readings' keys


# csrc/attention.cuh's problem struct per kernel line
ATTN_STRUCT = {"flash_refresh_paged": "RefreshPaged", "flash_refresh_paged_int8":
               "RefreshPaged+cold", "flash_refresh": "Refresh", "flash_packed": "Packed",
               "flash_prefill": "Prefill", "flash_prefill_paged": "PrefillPaged",
               "flash_prefill_paged_int8": "PrefillPaged+cold"}


def slab_table(rows) -> None:
    """One line per phase-3 case on the SLAB or DEEP build (a label "D d"
    with d in WIDTH_TABLE, under a kernel line's families or cases): device
    ms, the row-relative error against its limit, and the build's
    registers from phase 2."""
    regs = READINGS.get("registers", {})
    for row in rows:
        struct = ATTN_STRUCT.get(row["name"])
        if struct is None:
            continue
        for lab, r in {**row.get("families", {}), **row.get("cases", {})}.items():
            m = re.match(r"D (\d+)\b", lab)
            if m is None or int(m.group(1)) not in WIDTH_TABLE:
                continue
            d = int(m.group(1))
            r = r.get("packings", {}).get("busy", r)
            mode = (", f32 q/k/v" if "f32 q/k/v" in lab else ", f32 q" if "f32 q" in lab
                    else "" if d == 512 else ", any d")
            build = "512" if d <= 512 else "deep"
            label = f"mma_kernel<{build}, {struct}{mode}>"
            rel = f"{r['rel']:.3g} (limit {r['tol']:.3g})" if "tol" in r else (
                f"{r['rel']:.3g}" if "rel" in r else "n/a")
            log(f"  {'D-512' if d <= 512 else 'DEEP'} build: {row['name']} [{lab}]: device "
                f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms; row-relative err "
                f"{rel}; {label}: {regs.get(label, 'not built')} registers")


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


def f32_keys(needed):
    return 4 * float(needed.sum())


def split_reading(k) -> tuple:
    """The f32 q/k/v kernels' split pre-pass, which is how they are
    built and not part of the function, so not in the bound: each of K
    and V (``k``'s shape) read in f32 and written as two bf16 halves,
    8 B an element.  Returns (ms at the memory rate, the log's words)."""
    n_bytes = 2 * k.numel() * 8
    ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return ms, f"; the split pre-pass's own traffic {ms:.4f} ms ({n_bytes / 1e6:.4g} MB), not in the bound"


def dt_name(t) -> str:
    return str(t.dtype)[6:]


def check_flash_refresh_paged(torch, cfg, layout, cache_slots, n_streams, families=(),
                              dtype=None):
    """All three serving shapes are held to ROW_TOL, at ``cfg``'s heads and
    at each of ``families`` ((label, cfg, layout, cache slots[, q dtype[,
    cases]]) of another model's paged path, or another head dim or query
    type); ``dtype``: the q dtype of ``cfg``'s cases (bf16 by default); the
    kernels line reports ``cfg``'s selective refresh's times,
    the largest error, and every family case's readings under
    ``families``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_refresh import flash_refresh_paged_cuda, flash_refresh_paged_plain
    from repro_torch.kernels.ref import paged_gather_ref
    ok, row, worst, readings = True, None, 0.0, {}
    cases = [(None, cfg, layout, cache_slots, dtype, case) for case in REFRESH_CASES] + [
        (label, fcfg, flay, fslots, rest[0] if rest else None, case)
        for label, fcfg, flay, fslots, *rest in families
        for case in (rest[1] if len(rest) > 1 else REFRESH_CASES)]
    for label, cfg, layout, cache_slots, q_dt, case in cases:
        q, k, v, q_pos, kv_valid, pt, bm = _refresh_inputs(
            torch, cfg, layout, cache_slots, n_streams, case, q_dt)
        g = q.shape[2] // k.shape[1]

        def library(mask):     # K/V in q's type (SDPA takes one type)
            kg, vg = (paged_gather_ref(x, pt, 128).to(q.dtype).repeat_interleave(g, dim=2)
                      .transpose(1, 2) for x in (k, v))
            return F.scaled_dot_product_attention(q.transpose(1, 2), kg, vg,
                                                  attn_mask=mask[:, None])

        ok_here, r = check_attention(
            torch, lambda *a, bm=bm: flash_refresh_paged_cuda(*a, bm), (q, k, v, kv_valid, pt),
            lambda: flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, pt), library,
            q, k.shape[1], refresh_mask(torch, q_pos, kv_valid), bf16_keys,
            kv_valid.numel() + pt.numel() * 4,
            op=("flash_refresh_paged", lambda q, k, v, m, t, q_pos=q_pos, bm=bm:
                ops.flash_refresh_paged(q, k, v, q_pos, m, t, block_map=bm)))
        worst = max(worst, r["max_abs_err"])
        name = case if label is None else f"{label}, {case}"
        log(f"flash_refresh_paged ({name}): q {tuple(q.shape)} {dt_name(q)}, slab "
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
    the paged checks: (label, cfg, layout, cache slots, refresh case[, q
    dtype]) per row of ``cases``; then each of ``families`` ((label, cfg, cache slots,
    offset, T): a contiguous pass of the recurrent backend's attention
    layers, ``_stream_inputs``).  The kernels line reports the selective
    refresh's times, the largest error, and every family case's readings
    under ``families``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_refresh import flash_refresh_cuda, flash_refresh_plain
    from repro_torch.kernels.ref import paged_gather_ref
    ok, row, worst, readings = True, None, 0.0, {}
    for label, fcfg, slots, offset, T in families:
        q, k, v, q_pos, kv_valid, bm = _stream_inputs(torch, fcfg, slots, n_streams, offset, T)
        ok_here, r = check_attention(
            torch, lambda *a, bm=bm: flash_refresh_cuda(*a, bm), (q, k, v, kv_valid),
            lambda: flash_refresh_plain(q, k, v, q_pos, kv_valid),
            lambda mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2).to(q.dtype), v.transpose(1, 2).to(q.dtype),
                attn_mask=mask[:, None], enable_gqa=True),
            q, k.shape[2], refresh_mask(torch, q_pos, kv_valid), bf16_keys, kv_valid.numel())
        worst = max(worst, r["max_abs_err"])
        log(f"flash_refresh ({label}): q {tuple(q.shape)} bf16 at positions "
            f"[{offset}, {offset + T}), caches {tuple(k.shape)}, {bm.visited} visited tiles "
            f"of {bm.n_q_tiles}x{bm.n_kv_tiles}: " + attention_reading(r, "SDPA"))
        ok = ok and ok_here
        readings[label] = dict(q=list(q.shape), caches=list(k.shape), **r)
        del q, k, v
    for label, cfg, layout, slots, case, *q_dt in cases:
        q, ks, vs, q_pos, kv_valid, pt, bm = _refresh_inputs(
            torch, cfg, layout, slots, n_streams, case, *q_dt)
        k, v = paged_gather_ref(ks, pt, 128), paged_gather_ref(vs, pt, 128)
        del ks, vs
        ok_here, r = check_attention(
            torch, lambda *a, bm=bm: flash_refresh_cuda(*a, bm), (q, k, v, kv_valid),
            lambda: flash_refresh_plain(q, k, v, q_pos, kv_valid),
            lambda mask: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2).to(q.dtype), v.transpose(1, 2).to(q.dtype),
                attn_mask=mask[:, None], enable_gqa=True),
            q, k.shape[2], refresh_mask(torch, q_pos, kv_valid), bf16_keys, kv_valid.numel(),
            op=("flash_refresh", lambda q, k, v, m, q_pos=q_pos, bm=bm:
                ops.flash_refresh(q, k, v, q_pos, m, block_map=bm)))
        worst = max(worst, r["max_abs_err"])
        log(f"flash_refresh ({label}): q {tuple(q.shape)} {dt_name(q)}, caches {tuple(k.shape)}, "
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
                                   label=None, q_dtype=None):
    """The two-precision kernel at the selective refresh: each stream's
    overlap pages [0, D) (15 of 21 at internvl3-14b; ``n_cold`` where
    given) quantised into an int8 cold slab with per-(page, kv head)
    scales, as demotion leaves them.  Held to the plain version
    (dequant-gather + the same attention); with every entry hot it must
    equal the bf16 kernel bitwise.  Both are also read against the same
    function with P and the output unrounded (f32; q x scale and the
    dequantised pages rounded to bf16, as the function defines them),
    and the kernel held within ROW_TOL of it: where the kernel and the
    plain version sit near ROW_TOL apart (narrow head dims), each is
    about half of it from the unrounded answer.  An f16 ``q_dtype`` makes
    the hot slab f16 too, and the all-hot table is held to the f16
    kernel."""
    import torch.nn.functional as F
    from repro_torch.core import demotable_pages
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_refresh import (
        flash_refresh_paged_cuda, flash_refresh_paged_plain,
    )
    from repro_torch.kernels.ref import flash_refresh_ref, paged_gather
    q, k, v, q_pos, kv_valid, pt, bm = _refresh_inputs(
        torch, cfg, layout, cache_slots, n_streams, "selective refresh", q_dtype)
    n_kv = k.shape[1]
    D = len(demotable_pages(layout)) if n_cold is None else n_cold
    cold, pt8, is_cold = cold_pages(torch, k, v, pt, D)
    k8, ks = cold[0], cold[2]

    def library(mask):
        kg, vg = (x.to(q.dtype) for x in paged_gather(k, v, pt8, 128, cold))
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
            attn_mask=mask[:, None], enable_gqa=True)

    def key_bytes(needed):    # int8 rows at 1 B, bf16 rows at 2 B
        cold_keys = float((needed & is_cold).sum())
        return 2 * (float(needed.sum()) - cold_keys) + cold_keys

    ok, r = check_attention(
        torch, lambda q, k, v, kvv, pt, *c: flash_refresh_paged_cuda(q, k, v, kvv, pt, bm,
                                                                    cold=c),
        (q, k, v, kv_valid, pt8, *cold),
        lambda: flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, pt8, cold=cold),
        library, q, n_kv, refresh_mask(torch, q_pos, kv_valid), key_bytes,
        kv_valid.numel() + pt8.numel() * 4 + 2 * ks.numel() * 4,
        op=("flash_refresh_paged_int8", lambda q, k, v, m, t, *c: ops.flash_refresh_paged(
            q, k, v, q_pos, m, t, block_map=bm, cold=c)))
    out_hot = flash_refresh_paged_cuda(q, k, v, kv_valid, pt, bm)
    all_hot = torch.equal(flash_refresh_paged_cuda(q, k, v, kv_valid, pt, bm, cold=cold),
                          out_hot)
    out_k = flash_refresh_paged_cuda(q, k, v, kv_valid, pt8, bm, cold=cold)
    _, quant_rel = attn_errors(torch, out_k, out_hot)
    kg, vg = paged_gather(k, v, pt8, 128, cold)
    qs = (q.float() * q.shape[-1] ** -0.5).to(k.dtype).float()
    unrounded = flash_refresh_ref(qs, kg.float(), vg.float(), q_pos, kv_valid, scale=1.0)
    del kg, vg, qs
    _, r["rel_unrounded"] = attn_errors(torch, out_k, unrounded)
    _, r["plain_rel_unrounded"] = attn_errors(
        torch, flash_refresh_paged_plain(q, k, v, q_pos, kv_valid, pt8, cold=cold), unrounded)
    del unrounded, out_k
    near = r["rel_unrounded"] <= ROW_TOL
    log(f"flash_refresh_paged_int8 ({label or 'selective refresh'}): q {tuple(q.shape)} "
        f"{dt_name(q)}, "
        f"hot slab "
        f"{tuple(k.shape)}, cold slab {tuple(k8.shape)} int8, {D} of {pt.shape[1]} pages "
        f"per stream cold, all-hot bitwise equal to {'f16' if k.dtype == torch.float16 else 'bf16'} kernel: {all_hot}, row-relative "
        f"change from quantisation {quant_rel:.3g}, against P and O unrounded: kernel "
        f"{r['rel_unrounded']:.3g} (limit {ROW_TOL:.3g}), plain {r['plain_rel_unrounded']:.3g}: "
        + attention_reading(r, "dequant-gather+SDPA"))
    return ok and all_hot and near, kernel_row("flash_refresh_paged_int8",
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


def check_flash_packed(torch, pipe, streams, heads=None, label=None, dtype=None, only=None):
    """The kernel through ops.flash_packed, as the ViT calls it, at the
    three packings of ``packings`` (``only``: those named): each against
    the plain version (ROW_TOL, F32_ROW_TOL for f32 q/k/v; padding exact
    zero) and masked SDPA, timed per call and on the device, at the
    pipeline ViT's heads or ``heads`` (H, D), q/k/v in ``dtype`` (bf16 by
    default; f32: the split pre-pass's bytes printed beside the bound).  The
    kernels line reports the serve packing's times, the largest error,
    and every packing's readings under ``packings``."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_packed import flash_packed_plain
    v = pipe.v
    H, D = heads or (v.n_heads, v.d_model // v.n_heads)
    name = "flash_packed" if label is None else f"flash_packed [{label}]"
    g = torch.Generator(device="cuda").manual_seed(4)
    dtype = dtype or torch.bfloat16
    tol = {torch.float32: F32_ROW_TOL, torch.float16: F16_ROW_TOL}.get(dtype, ROW_TOL)
    ok, row, worst, readings = True, None, 0.0, {}
    for label_p, plan in packings(torch, pipe, streams):
        if only is not None and label_p not in only:
            continue
        R, L = plan.seg_id.shape
        q, k, vv = (torch.randn((R, L, H, D), generator=g, device="cuda").to(dtype)
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
        dev_ms = device_ms(torch, kernel, (q, k, vv), 3 * q.numel() * q.element_size())
        plain = cuda_ms(torch, lambda: flash_packed_plain(q, k, vv, seg), 5)
        mask = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0)
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), vv.transpose(1, 2),
            attn_mask=mask[:, None]), 10)
        live = float((seg >= 0).sum())
        esz = q.element_size()
        n_bytes = live * H * D * esz * 3 + q.numel() * esz + seg.numel() * 4
        b_ms, b_by = bound_ms(n_bytes, 4.0 * D * H * float(mask.sum()), BF16_TENSOR_FLOPS)
        split_ms, split_note = split_reading(k) if esz == 4 else (None, "")
        r = dict(tol=tol)
        if dtype == torch.float16:
            ok = f16_readings(torch, kernel, (q, k, vv), out_k, out_p, r,
                              3 * q.numel() * esz, refuse_f32_kv=False) and ok
            F16_CALLS.setdefault("flash_packed", (kernel, (q, k, vv)))

            def work(q_size, kv_size, live=live, H=H, D=D, q=q, seg=seg, mask=mask):
                return (4.0 * D * H * float(mask.sum()), live * H * D * (q_size + 2 * kv_size)
                        + q.numel() * q_size + seg.numel() * 4)
            MIXED_CASES.setdefault(("flash_packed", D), (kernel, kernel, (q, k, vv), work))
        log(f"{name} ({label_p}): {plan.n_frames} P-frames packed into ({R}, {L}), H {H}, "
            f"D {D}, {dt_name(q)}, {bm.visited} visited tiles, fill {plan.fill:.3f}: max abs "
            f"err {err:.3g}, max row-relative err {rel:.3g} (limit {tol:.3g}), padding exact zero: "
            f"{pad_zero}; kernel {ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain "
            f"{plain:.4f} ms, SDPA {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by}){split_note}"
            f"{f16_note(r)}")
        ok = ok and rel <= tol and pad_zero
        worst = max(worst, err)
        readings[label_p] = dict(shape=[R, L], visited=bm.visited, max_abs_err=err, rel=rel,
                                 tol=tol, ms=ms, device_ms=dev_ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b_ms, bound_by=b_by,
                                 **({} if split_ms is None else {"split_ms": split_ms}),
                                 **{k_: r[k_] for k_ in F16_KEYS if k_ in r})
        if row is None:
            row = dict(name="flash_packed", route="cuda",
                       source="src/repro_torch/csrc/attention.cuh",
                       replaces="src/repro/kernels/flash_packed.py:211", max_abs_err=err,
                       ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib, **{k_: r[k_] for k_ in F16_KEYS if k_ in r})
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


# ssd_scan's cases past the bf16 serving layout: (label, B, L, H, P, G, N,
# chunk, init, x/b/c dtype, log_a dtype, layout) -- f32 at mamba2-2.7b's
# serving shapes and jamba's widths, the JAX benchmarks' f32 row, the
# audit's N 32 at G 2, ragged N (24, 8) and P (12, 40), chunk 512, a
# strided x and a bf16 log_a
SCAN_WIDE = (
    ("f32 fresh window", 2, 160, 80, 64, 1, 128, 256, True, "float32", "float32", "packed"),
    ("f32 incremental window", 2, 40, 80, 64, 1, 128, 256, True, "float32", "float32",
     "packed"),
    ("f32 query", 2, 8, 80, 64, 1, 128, 256, True, "float32", "float32", "packed"),
    ("f32 long prefill", 1, 4096, 80, 64, 1, 128, 256, False, "float32", "float32", "packed"),
    ("f32 ragged prefill", 1, 1000, 80, 64, 1, 128, 256, True, "float32", "float32", "packed"),
    (f"f32 {HYBRID_ARCH} fresh window", 2, 160, 128, 64, 1, 16, 256, True, "float32",
     "float32", "packed"),
    ("f32 JAX benchmarks' row", 1, 1024, 8, 64, 1, 16, 128, False, "float32", "float32",
     "packed"),
    ("N 32, G 2 (audit row)", 2, 100, 8, 64, 2, 32, 128, True, "bfloat16", "float32", "packed"),
    ("f32 N 32, G 2 (audit row)", 2, 100, 8, 64, 2, 32, 128, True, "float32", "float32",
     "packed"),
    ("N 24", 2, 160, 80, 64, 1, 24, 256, True, "bfloat16", "float32", "packed"),
    ("N 8", 2, 160, 80, 64, 1, 8, 256, True, "bfloat16", "float32", "packed"),
    ("P 12", 2, 160, 80, 12, 1, 128, 256, True, "bfloat16", "float32", "packed"),
    ("P 40", 2, 160, 80, 40, 1, 128, 256, True, "bfloat16", "float32", "packed"),
    ("chunk 512", 1, 1000, 80, 64, 1, 128, 512, True, "bfloat16", "float32", "packed"),
    ("strided x", 2, 160, 80, 64, 1, 128, 256, True, "bfloat16", "float32", "strided"),
    ("bf16 log_a", 2, 160, 80, 64, 1, 128, 256, True, "bfloat16", "bfloat16", "packed"),
)
SCAN_F32_TOL = 2.0 ** -10       # f32 y: the f32 attention kernels' row-relative limit
# ssd_scan on its slabbed build (N / 128 column slabs of 128 over blocks,
# the slab count a grid dimension): mamba2-2.7b's serving and prefill
# shapes at d_state 256 (WIDE_STATE) and 512 (WIDER_STATE) in bf16 read in
# place, the fresh window in f32 (staged), N 384 in place, and N 192, 136
# and 320 on the next multiple of 128 (staged, columns past N zero) over a
# ragged L
SCAN_SLABBED = tuple(
    (label, B, L, 80, 64, 1, n, 256, init, dt, "float32", "packed")
    for label, B, L, n, init, dt in (
        ("N 256 fresh window", 2, 160, 256, True, "bfloat16"),
        ("N 256 incremental window", 2, 40, 256, True, "bfloat16"),
        ("N 256 query", 2, 8, 256, True, "bfloat16"),
        ("N 256 long prefill", 1, 4096, 256, False, "bfloat16"),
        ("N 256 ragged prefill", 1, 1000, 256, True, "bfloat16"),
        ("f32 N 256 fresh window", 2, 160, 256, True, "float32"),
        ("N 192 ragged prefill", 1, 1000, 192, True, "bfloat16"),
        ("N 136 ragged prefill", 1, 1000, 136, True, "bfloat16"),
        ("N 512 fresh window", 2, 160, 512, True, "bfloat16"),
        ("N 512 incremental window", 2, 40, 512, True, "bfloat16"),
        ("N 512 query", 2, 8, 512, True, "bfloat16"),
        ("N 512 long prefill", 1, 4096, 512, False, "bfloat16"),
        ("f32 N 512 fresh window", 2, 160, 512, True, "float32"),
        ("N 384 fresh window", 2, 160, 384, True, "bfloat16"),
        ("N 320 ragged prefill", 1, 1000, 320, True, "bfloat16")))


def scan_f64(torch, x, la, b, c, init):
    """y of the SSD recurrence in f64, step by step (S_t = a_t S_{t-1} +
    x_t b_t^T, y_t = S_t c_t, head h on group h / (H / G)): the exact
    function the bf16 readings near their limit are held to."""
    B, L, H, P = x.shape
    rep = H // b.shape[2]
    xd, ad = x.double(), la.double().exp()
    bd, cd = (t.double().repeat_interleave(rep, dim=2) for t in (b, c))
    S = (torch.zeros((B, H, P, b.shape[3]), dtype=torch.float64, device=x.device)
         if init is None else init.double())
    y = torch.empty((B, L, H, P), dtype=torch.float64, device=x.device)
    for t in range(L):
        S = ad[:, t, :, None, None] * S + xd[:, t, :, :, None] * bd[:, t, :, None, :]
        y[:, t] = torch.einsum("bhpn,bhn->bhp", S, cd[:, t])
    return y


def scan_registers(name: str, mode: int, n: int) -> str:
    """Registers of the scan kernel ``name`` at build width n and operand
    mode, from phase 2's ptxas readings ("not read" when this process
    did not build)."""
    from repro_torch.kernels.ssd_scan import N_SLAB, build_width
    n = build_width(n)
    label = f"{name}<{n if n <= N_SLAB else f'{N_SLAB} x slabs'}, {SCAN_MODES[str(mode)]}>"
    return str(READINGS.get("registers", {}).get(label, "not read"))


def scan_operands(torch, g, B, L, H, P, G, N, with_init, dt="bfloat16", la_dt="float32",
                  layout="packed"):
    """Random scan operands on the card from generator ``g``."""
    dt, la_dt = getattr(torch, dt), getattr(torch, la_dt)
    x = torch.randn((B, L, H, P), generator=g, device="cuda").to(dt)
    if layout == "strided":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    la = (-(torch.rand((B, L, H), generator=g, device="cuda") * 0.999 + 1e-3)).to(la_dt)
    b, c = ((torch.randn((B, L, G, N), generator=g, device="cuda") * 0.3).to(dt)
            for _ in range(2))
    init = torch.randn((B, H, P, N), generator=g, device="cuda") if with_init else None
    return x, la, b, c, init


def check_ssd_scan(torch):
    """ssd_scan at the serving shapes of mamba2-2.7b (B 2, H 80, P 64,
    N 128, G 1: a fresh window L 160, an incremental one L 40 and the
    query L 8, each from a non-zero state), a long prefill (L 4096, 16
    chunks of 256), a ragged one (L 1000), groups G 4 at a small width,
    and jamba-v0.1-52b's three serving shapes (H 128, P 64, N 16); then
    SCAN_WIDE's operands, which the bf16 builds do not read in place (f32
    x/b/c as bf16 hi + lo halves, ragged N and P, sub-chunks, a strided x,
    a bf16 log_a: the staging pass, then the kernel).  y (bf16)
    row-relative within one bf16 step: both round f32 values that differ
    by the summation order; f32 y within SCAN_F32_TOL.  The f32 state
    within 1e-4 of each (b, head) state's largest value: sums of up to 256
    terms and the cumulative log-decay in another order (a block scan
    against a sequential cumsum), the latter entering through exp; the
    kernel's f32 factors enter the tensor-core products as bf16 hi + lo
    (about 16 bits, 2^-17 relative per product).  The bound counts the
    operands at their element sizes; the staging pass's bytes are
    printed beside it.  Then SCAN_SLABBED, the slabbed build, each line
    with its kernel's registers; its bf16 cases and the long prefill at N 128
    also print the kernel's and the plain version's y against a
    sequential f64 scan (each rounds y to bf16 once: about 2^-8 of a row
    apart from it at most).  The kernels line reports the fresh window's
    times (its longest launch on the path) and the largest error."""
    from repro_torch.kernels.ssd_scan import (
        operand_mode, ssd_scan_cuda, ssd_scan_plain, ssd_scan_work, staged_bytes,
    )
    cases = [(label, B, L, H, P, G, N, chunk, init, "bfloat16", "float32", "packed")
             for label, B, L, H, P, G, N, chunk, init in (
                 ("fresh window", 2, 160, 80, 64, 1, 128, 256, True),
                 ("incremental window", 2, 40, 80, 64, 1, 128, 256, True),
                 ("query", 2, 8, 80, 64, 1, 128, 256, True),
                 ("long prefill", 1, 4096, 80, 64, 1, 128, 256, False),
                 ("ragged prefill", 1, 1000, 80, 64, 1, 128, 256, True),
                 ("groups", 2, 300, 16, 32, 4, 64, 64, True),
                 (f"{HYBRID_ARCH} fresh window", 2, 160, 128, 64, 1, 16, 256, True),
                 (f"{HYBRID_ARCH} incremental window", 2, 40, 128, 64, 1, 16, 256, True),
                 (f"{HYBRID_ARCH} query", 2, 8, 128, 64, 1, 16, 256, True))]
    g = torch.Generator(device="cuda").manual_seed(5)
    ok, row, worst, wide, slabbed = True, None, 0.0, {}, {}
    for label, B, L, H, P, G, N, chunk, with_init, dt, la_dt, layout in (
            cases + list(SCAN_WIDE) + list(SCAN_SLABBED)):
        x, la, b, c, init = scan_operands(torch, g, B, L, H, P, G, N, with_init, dt, la_dt,
                                          layout)
        y_k, s_k = ssd_scan_cuda(x, la, b, c, init, chunk)
        y_p, s_p = ssd_scan_plain(x, la, b, c, init, chunk)
        y_err, y_rel = attn_errors(torch, y_k, y_p)
        s_d = (s_k - s_p).abs()
        s_rel = float((s_d.amax((-1, -2)) / s_p.abs().amax((-1, -2)).clamp_min(
            torch.finfo(torch.float32).tiny)).max())
        err = max(y_err, float(s_d.max()))
        worst = max(worst, err)
        sizes = (x.element_size(), b.element_size(), la.element_size())
        flops, n_bytes = ssd_scan_work(L, H, P, G, N, chunk, B, *sizes)
        mode = operand_mode(x, b, c)
        staged = staged_bytes(B, L, H, P, G, N, mode, sizes[0], sizes[1])
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
        y_tol = SCAN_F32_TOL if y_k.dtype == torch.float32 else 2.0 ** -7
        here = y_rel <= y_tol and s_rel <= 1e-4 and y_k.dtype == x.dtype
        regs = (f"; registers {scan_registers('ssd_scan_kernel', mode, N)}"
                if N > 128 else "")
        exact = None
        if y_k.dtype == torch.bfloat16 and (N > 128 or label == "long prefill"):
            y64 = scan_f64(torch, x, la, b, c, init)
            exact = (attn_errors(torch, y_k, y64)[1], attn_errors(torch, y_p, y64)[1])
            regs += (f"; y against a sequential f64 scan: kernel {exact[0]:.3g}, plain "
                     f"{exact[1]:.3g}")
            del y64
        log(f"ssd_scan ({label}): x {tuple(x.shape)} {dt_name(x)}{', strided' if layout == 'strided' else ''}, "
            f"b/c {tuple(b.shape)} {dt_name(b)}, log_a {dt_name(la)}, chunk {chunk}, init "
            f"{'yes' if with_init else 'zeros'}, operand mode {mode}: y {dt_name(y_k)} max abs "
            f"err {y_err:.3g}, row-relative {y_rel:.3g} (limit {y_tol:.3g}); state max abs "
            f"err {float(s_d.max()):.3g}, relative {s_rel:.3g} (limit 1e-4); kernel "
            f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain {plain:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}): bytes "
            f"{n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({n_bytes / 1e6:.4g} MB), bf16 "
            f"tensor {flops / BF16_TENSOR_FLOPS * 1e3:.4f} ms ({flops / 1e9:.4g} GFLOP); "
            f"f32 CUDA cores {f32_ms:.4f} ms; staging pass {staged / 1e6:.4g} MB "
            f"({staged / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate){regs}: "
            f"{'ok' if here else 'FAIL'}")
        ok = ok and here
        if label == "fresh window":
            row = dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cuh",
                       replaces="src/repro/kernels/ssd_scan.py:74", max_abs_err=err, ms=ms,
                       device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None)
        if label in {c[0] for c in SCAN_WIDE}:
            wide[label] = dict(ms=ms, device_ms=dev_ms, bound_ms=b_ms, rel=y_rel)
        if N > 128:
            slabbed[label] = dict(mode=mode, ms=ms, device_ms=dev_ms, bound_ms=b_ms,
                               plain_ms=plain, rel=y_rel, state_rel=s_rel, f64_rel=exact,
                               registers=scan_registers("ssd_scan_kernel", mode, N))
        del x, la, b, c, init, y_k, y_p, s_k, s_p
    row["max_abs_err"] = worst
    row["wide_cases"] = wide
    row["slabbed_cases"] = slabbed
    gc.collect()
    torch.cuda.empty_cache()
    return ok, row


# ssd_scan's backward vs its plain version: dx, db and dc (bf16) within one
# bf16 step of their (batch row, head or group) slice's largest value;
# dlog_a and d_init (f32) within 1e-3 of theirs (the plain version sums
# the same f32 products in other orders, and dlog_a is a difference of
# two such sums)
BWD_TOL, BWD_F32_TOL = 2.0 ** -7, 1e-3
# f32 dx, db and dc (operands as bf16 hi + lo halves): the f32 attention
# kernels' limit
BWD_F32_OUT_TOL = 2.0 ** -10
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, SSM_TRAIN_STEPS = 2, 2048, 4


def kernel_ms(torch, fn, calls: int = 3) -> dict:
    """Device ms per call of each kernel that ``fn`` launches, by its
    short name, from torch.profiler over ``calls`` calls after a warm
    one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = Counter()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+_kernel(<\d+>)?)", e.key)
            out[m.group(1) if m else e.key[:40]] += (
                getattr(e, "self_device_time_total", 0) / 1e3 / calls)
    return dict(out)


def slice_rel(torch, k, p, dims) -> float:
    """max over slices of max |k - p| / the slice's max |p|."""
    d = (k.float() - p.float()).abs().amax(dims)
    return float((d / p.float().abs().amax(dims).clamp_min(
        torch.finfo(torch.float32).tiny)).max())


def check_ssd_scan_bwd(torch):
    """ssd_scan's backward kernel (no TPU counterpart) against
    ssd_scan_bwd_plain on the chunk states the forward kernel writes under
    grad: mamba2-2.7b's training shape (B 2, L 2048, H 80, P 64, N 128,
    chunk 256) with init and a final-state cotangent, a ragged L 1000
    without either, groups G 4 at a small width, and jamba-v0.1-52b's
    widths (H 128, P 64, N 16) at L 2048; then the training shape in f32,
    N 32 at G 2, P 12 (f32) and chunk 512 over L 1000 (f32): the staged
    operands; then the slabbed build at the training shape, N 256 in bf16
    and f32, N 192 on it, and N 512, 384 and 320 (staged on 384), each
    line with (a)'s and (c)'s registers.  Each reading beside its limit (BWD_TOL, or BWD_F32_OUT_TOL
    for f32 dx, db and dc; BWD_F32_TOL), a bitwise repeat, the chunk
    states within the forward's 1e-4; times per call (CUDA events), on
    the device (replayed graph), the plain version's, and the bound from
    ssd_scan_bwd_work at the bf16 tensor rate (its five q^2 products
    multiply bf16 operands, or bf16 halves), with the f32 CUDA-core figure
    of the same flops beside it (the first version's arithmetic) and the
    staging pass's bytes; blocks per SM of its three kernels at each N
    and operand mode (the runtime's occupancy calculator).  The row keeps
    the training shape's times."""
    from repro_torch.kernels.ssd_scan import (
        FAST, SPLIT, STATE_WIDTHS, bwd_occupancy, operand_mode, ssd_scan_bwd_cuda,
        ssd_scan_bwd_plain, ssd_scan_bwd_work, ssd_scan_fwd_plain, ssd_scan_launch, staged_bytes,
    )
    for mode in (FAST, SPLIT):
        for n in STATE_WIDTHS + (512,):     # 512: the slabbed build (any N past 128)
            log(f"ssd_scan_bwd kernels, N {n}, chunk 256, operand mode {mode}: blocks per SM "
                f"{bwd_occupancy(n, 256, mode)}")
    cases = (("mamba2-2.7b training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 128, 256, True, True,
              "bfloat16"),
             ("ragged", 1, 1000, 80, 64, 1, 128, 256, False, False, "bfloat16"),
             ("groups", 2, 300, 16, 32, 4, 64, 64, True, True, "bfloat16"),
             (f"{HYBRID_ARCH} widths", 2, SSM_TRAIN_SEQ, 128, 64, 1, 16, 256, False, True,
              "bfloat16"),
             ("f32 mamba2-2.7b training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 128, 256, True, True,
              "float32"),
             ("N 32, G 2", 2, 1000, 8, 64, 2, 32, 128, True, True, "bfloat16"),
             ("f32 P 12", 2, 1000, 80, 12, 1, 128, 256, True, True, "float32"),
             ("f32 chunk 512", 1, 1000, 80, 64, 1, 128, 512, True, True, "float32"),
             # two column slabs: mamba2-2.7b's training shape at d_state 256
             # in bf16 (read in place) and f32, and N 192 on the build
             ("N 256 training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 256, 256, True, True,
              "bfloat16"),
             ("f32 N 256 training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 256, 256, True, True,
              "float32"),
             ("N 192 training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 192, 256, True, True,
              "bfloat16"),
             # past two slabs: d_state 512 in place, N 384 in place, N 320
             # staged on 384
             ("N 512 training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 512, 256, True, True,
              "bfloat16"),
             ("N 384 training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 384, 256, True, True,
              "bfloat16"),
             ("N 320 training", 2, SSM_TRAIN_SEQ, 80, 64, 1, 320, 256, True, True,
              "bfloat16"))
    g = torch.Generator(device="cuda").manual_seed(6)
    ok, row, worst, wide = True, None, 0.0, {}
    for label, B, L, H, P, G, N, chunk, with_init, with_dfin, dt in cases:
        x, la, b, c, init = scan_operands(torch, g, B, L, H, P, G, N, with_init, dt)
        dy = torch.randn((B, L, H, P), generator=g, device="cuda").to(x.dtype)
        dfin = torch.randn((B, H, P, N), generator=g, device="cuda") if with_dfin else None
        _, _, states = ssd_scan_launch(x, la, b, c, init, chunk, states=True)
        states_p = ssd_scan_fwd_plain(x, la, b, c, init, chunk)[2]
        st_rel = slice_rel(torch, states[..., :N], states_p, (-1, -2))
        got = ssd_scan_bwd_cuda(x, la, b, c, states, dy, dfin, chunk)
        again = ssd_scan_bwd_cuda(x, la, b, c, states, dy, dfin, chunk)
        want = ssd_scan_bwd_plain(x, la, b, c, states_p, dy, dfin, chunk)
        torch.cuda.synchronize()
        bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
        out_tol = BWD_F32_OUT_TOL if x.dtype == torch.float32 else BWD_TOL
        readings = {n: (slice_rel(torch, k, w, dims), tol) for n, k, w, dims, tol in zip(
            ("dx", "dlog_a", "db", "dc", "d_init"), got, want,
            ((1, 3), (1,), (1, 3), (1, 3), (-1, -2)),
            (out_tol, BWD_F32_TOL, out_tol, out_tol, BWD_F32_TOL))}
        err = max(float((k.float() - w.float()).abs().max()) for k, w in zip(got, want))
        worst = max(worst, err)
        sizes = (x.element_size(), b.element_size(), la.element_size())
        flops, n_bytes = ssd_scan_bwd_work(L, H, P, G, N, chunk, B, *sizes)
        mode = operand_mode(x, b, c, dy)
        staged = staged_bytes(B, L, H, P, G, N, mode, sizes[0], sizes[1], backward=True)
        args = (x, la, b, c, states, dy, dfin)
        in_bytes = sum(t.numel() * t.element_size() for t in args if t is not None)
        ms = cuda_ms(torch, lambda: ssd_scan_bwd_cuda(*args, chunk), 5)
        dev_ms = device_ms(torch, lambda *a: ssd_scan_bwd_cuda(*a, chunk), args, in_bytes,
                           replays=2, min_copies=2)
        plain = cuda_ms(torch, lambda: ssd_scan_bwd_plain(x, la, b, c, states_p, dy, dfin,
                                                          chunk), 2, warmup=1)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_TENSOR_FLOPS)
        if row is None or label in ("f32 mamba2-2.7b training", "N 256 training",
                                    "f32 N 256 training", "N 512 training"):
            stages = kernel_ms(torch, lambda: ssd_scan_bwd_cuda(*args, chunk))
            log(f"ssd_scan_bwd ({label}): device ms per call by kernel (torch.profiler): "
                + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
        dtypes_ok = [t.dtype for t in got[:4]] == [x.dtype, la.dtype, b.dtype, c.dtype]
        here = (bitwise and st_rel <= 1e-4 and dtypes_ok
                and all(v <= tol for v, tol in readings.values()))
        regs = (f"; registers (a) {scan_registers('ssd_scan_bwd_chunk_kernel', mode, N)}, "
                f"(c) {scan_registers('ssd_scan_bwd_kernel', mode, N)}" if N > 128 else "")
        log(f"ssd_scan_bwd ({label}): x {tuple(x.shape)} {dt_name(x)}, b/c {tuple(b.shape)} "
            f"{dt_name(b)}, chunk {chunk}, init {'yes' if with_init else 'none'}, final-state "
            f"cotangent {'yes' if with_dfin else 'none'}, operand mode {mode}: " + ", ".join(
                f"{n} {v:.3g} (limit {tol:.3g})" for n, (v, tol) in readings.items())
            + f"; chunk states {st_rel:.3g} (limit 1e-4); bitwise repeat {bitwise}; output "
            f"dtypes {[dt_name(t) for t in got[:4]]}; kernel "
            f"{ms:.4f} ms per call ({dev_ms:.4f} ms on the device), plain {plain:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}): bf16 tensor {flops / BF16_TENSOR_FLOPS * 1e3:.4f} "
            f"ms ({flops / 1e9:.4g} GFLOP), bytes {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
            f"({n_bytes / 1e6:.4g} MB); the same flops on the f32 CUDA cores "
            f"{flops / F32_FLOPS * 1e3:.4f} ms; staging pass {staged / 1e6:.4g} MB "
            f"({staged / HBM_BYTES_PER_S * 1e3:.4f} ms at the memory rate){regs}: "
            f"{'ok' if here else 'FAIL'}")
        ok = ok and here
        if row is None:
            row = dict(name="ssd_scan_bwd", route="cuda",
                       source="src/repro_torch/csrc/ssd_scan.cuh",
                       replaces="none (the reference trains through its plain scan)",
                       max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
        else:
            wide[label] = dict(ms=ms, device_ms=dev_ms, bound_ms=b_ms, plain_ms=plain)
        del x, b, c, init, dy, dfin, states, states_p, got, again, want, args
    row["max_abs_err"] = worst
    row["wide_cases"] = wide
    gc.collect()
    torch.cuda.empty_cache()
    return ok, row


def family_kernel_cases(device="cuda"):
    """The attention kernels' cases at the families phase's serving shapes
    (pipelines built without weights on ``device``, for their layouts):
    the paged kernel at olmoe-1b-7b's heads (H 16 = Hkv 16, D 128, GQA
    group 1; moonshot-v1-16b-a3b's too) and at deepseek-7b's (H 32 = Hkv
    32, D 128; with bf16 and with f32 queries, as phase 7's (c) and (e)
    launch it) on their codecflow layouts, and the per-stream kernel at
    jamba-v0.1-52b's (H 32, Hkv 8, D 128) over its attention caches'
    max_hist slots: the
    codecflow passes of window 0 and of the last window of a 40-frame
    stream (append, query, the first decode step) and fullcomp's fresh
    append; and the per-stream kernel at whisper-large-v3's decoder
    self-attention (H 20 = Hkv 20, D 64) over phase 8's 128 slots: its
    32-token prefill and first decode step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import default_vit
    from repro_torch.serving import ServingPipeline

    def layout_of(arch, mode):
        c = get_config(arch)
        return c, ServingPipeline(c, default_vit(c), {}, {}, path_ecfg(mode, {}),
                                  device=device)
    paged = []
    for arch in (MOE_ARCH, DENSE_ARCH):
        c, p = layout_of(arch, "codecflow")
        paged.append((arch, c, p.layout, p.cache_slots))
    paged.append((f"{DENSE_ARCH}, f32 q", dataclasses.replace(c, dtype="float32"), p.layout,
                  p.cache_slots, torch.float32))
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


def check_flash_prefill(torch, cfg, total_len, n_streams, only=None, label=None, dtype=None):
    """flash_prefill at internvl3-14b attention widths (H 40, Hkv 8,
    D 128, bf16, 2 streams): causal from position 0, a 512-row chunk at
    offset 2048 against 2560 keys, a 512-key sliding window, and the
    ragged length of a fresh window (total_len rows and keys), and a
    chunk at a negative offset whose first rows see no key (they must be
    the mean of V).  Library: scaled_dot_product_attention with enable_gqa
    and the same mask; where is_causal is the same function (q_offset 0,
    Sq == Sk, no window) its is_causal call is timed beside it.  The
    kernels line reports the causal case's times and the largest error.
    ``only``: the labels of the cases to run; ``label`` names ``cfg``;
    ``dtype``: q/k/v's (bf16 by default; f32: within F32_ROW_TOL, the
    split pre-pass's bytes printed beside the bound; f16: F16_ROW_TOL)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda, flash_prefill_plain
    g = torch.Generator(device="cuda").manual_seed(6)
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    tol = F32_ROW_TOL if f32 else PREFILL_ROW_TOL
    cases = (("causal", 2048, 2048, None, 0), ("chunk at an offset", 512, 2560, None, 2048),
             ("sliding window", 2048, 2048, 512, 0),
             ("ragged", total_len, total_len, None, 0),
             ("rows with no visible key", 512, 1024, None, -200))
    ok, row, worst = True, None, 0.0
    name = "flash_prefill" if label is None else f"flash_prefill [{label}]"
    for case, Sq, Sk, window, off in cases:
        if only is not None and case not in only:
            continue
        q = torch.randn((n_streams, Sq, H, D), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((n_streams, Sk, Hkv, D), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ok_here, r = check_attention(
            torch, lambda *a, w=window, o=off: flash_prefill_cuda(*a, window=w, q_offset=o),
            (q, k, v),
            lambda: flash_prefill_plain(q, k, v, window=window, q_offset=off),
            lambda mask: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                                        enable_gqa=True),
            q, Hkv, positional_mask(torch, Sq, Sk, off, window),
            f32_keys if f32 else bf16_keys, 0, dead_rows_zero=False, tol=tol,
            op=("flash_prefill", lambda q, k, v, window=window, off=off: ops.flash_prefill(
                q, k, v, window=window, q_offset=off)))
        note = ""
        if f32:
            r["split_ms"], note = split_reading(k)
        if off == 0 and Sq == Sk and window is None:
            r["sdpa_causal_ms"] = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 5)
            note += f", SDPA is_causal {r['sdpa_causal_ms']:.4f} ms"
        if off < 0:
            n_dead = -off
            mean_v = v.float().mean(1, keepdim=True).repeat_interleave(H // Hkv, dim=2)
            _, dead_rel = attn_errors(torch, flash_prefill_cuda(q, k, v, q_offset=off)[:, :n_dead],
                                      mean_v.expand(-1, n_dead, -1, -1))
            note += (f", rows without keys vs the mean of V: row-relative err "
                    f"{dead_rel:.3g} (limit {tol:.3g})")
            ok_here = ok_here and dead_rel <= tol
        worst = max(worst, r["max_abs_err"])
        log(f"{name} ({case}): q {tuple(q.shape)} {dt_name(q)}, k/v {tuple(k.shape)}, "
            f"q_offset {off}, window {window}: " + attention_reading(r, "SDPA") + note)
        ok = ok and ok_here
        if row is None:
            row = kernel_row("flash_prefill", "src/repro/kernels/flash_prefill.py:79", r)
            row["sdpa_causal_ms"] = r.get("sdpa_causal_ms")
    row["max_abs_err"] = worst
    return ok, row


def check_flash_prefill_paged(torch, cfg, layout, cache_slots, n_streams, n_cold=None,
                              label=None, q_dtype=None):
    """flash_prefill_paged at the fresh prefill of internvl3-14b
    (total_len queries from position 0 over cache_slots logical keys) on
    a shuffled slab, bf16 and with each stream's pages [0, D) (15 of 21)
    int8 cold (``n_cold`` where given); the int8 kernel with every entry
    hot must equal the bf16 kernel bitwise.  Library: gather (+ dequant)
    + SDPA.  An f16 ``q_dtype`` makes the slab f16 too (the int8 kernel's
    all-hot table then held to the f16 kernel).  Returns ((ok, bf16
    row), (ok, int8 row))."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.core import demotable_pages
    from repro_torch.kernels import ops
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
    q = torch.randn((n_streams, Sq, H, D), generator=g, device="cuda").to(q_dtype or torch.bfloat16)
    f16 = q.dtype == torch.float16
    hot = "f16" if f16 else "bf16"
    k, v = (torch.randn((P * 128, Hkv, D), generator=g, device="cuda").to(
        torch.float16 if f16 else torch.bfloat16) for _ in range(2))
    mask = positional_mask(torch, Sq, cache_slots, 0, None)
    n_cold = len(demotable_pages(layout)) if n_cold is None else n_cold
    cold, pt8, is_cold = cold_pages(torch, k, v, pt, n_cold)
    rows = []
    name = "flash_prefill_paged" if label is None else f"flash_prefill_paged [{label}]"
    for case, table, grp in ((hot, pt, None), ("int8", pt8, cold)):
        def library(mask, table=table, grp=grp):
            kg, vg = (x.to(q.dtype) for x in paged_gather(k, v, table, 128, grp))
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kg.transpose(1, 2), vg.transpose(1, 2),
                attn_mask=mask[:, None], enable_gqa=True)

        def key_bytes(needed, grp=grp):     # int8 rows at 1 B, bf16 (f16) rows at 2 B
            cold_keys = float((needed & is_cold).sum()) if grp is not None else 0.0
            return 2 * (float(needed.sum()) - cold_keys) + cold_keys

        extra = pt.numel() * 4 + (0 if grp is None else 2 * cold[2].numel() * 4)
        row_name = "flash_prefill_paged" if grp is None else "flash_prefill_paged_int8"
        ok, r = check_attention(
            torch, lambda q, k, v, table, *c: flash_prefill_paged_cuda(q, k, v, table,
                                                                       cold=c or None),
            (q, k, v, table, *(grp or ())),
            lambda table=table, grp=grp: flash_prefill_paged_plain(q, k, v, table, cold=grp),
            library, q, Hkv, mask, key_bytes, extra, dead_rows_zero=False,
            tol=F32_ROW_TOL if q.dtype == torch.float32 else PREFILL_ROW_TOL,
            op=(row_name, lambda q, k, v, t, *c: ops.flash_prefill_paged(q, k, v, t,
                                                                         cold=c or None)))
        note = ""
        if grp is not None:
            all_hot = torch.equal(flash_prefill_paged_cuda(q, k, v, pt, cold=grp),
                                  flash_prefill_paged_cuda(q, k, v, pt))
            note = (f", {n_cold} of {n_pages} pages per stream cold, "
                    f"all-hot bitwise equal to {hot} kernel: {all_hot}")
            ok = ok and all_hot
        log(f"{name} ({case}): q {tuple(q.shape)} {dt_name(q)}, slab {tuple(k.shape)}, "
            f"{n_pages} shuffled pages per stream{note}: "
            + attention_reading(r, "gather+SDPA" if grp is None else "dequant-gather+SDPA"))
        rows.append((ok, kernel_row(row_name, "src/repro/kernels/flash_prefill.py:258", r)))
    return rows


# ----------------------------------------------------------------------
# phase 3, f16 (``--only f16``; its cases run in the full run's phase 3)
# ----------------------------------------------------------------------
# f16 operands are drawn in f32 and rounded once to f16 (all 11 bits
# live), the bf16 build timed on ``.bfloat16()`` copies of them.  Limits:
# the attention kernels F16_ROW_TOL; rope_shift one f16 step of the value
# (2^-10 relative, as bf16's is 2^-7) plus the f32 angle's 1e-3; the
# scan's f16 x, b and c are staged as bf16 hi + lo halves, which hold f16
# exactly, so y and the gradients are held to the staged f32 mode's limits
# plus one f16 step of their row's or slice's largest value (2^-10).  Each
# case holds a control: the kernel fed its f16 operands rounded through
# bf16 (what a path reading f16 as bf16, or a staging pass dropping the lo
# half, computes) must fail the limit
F16_ROPE_STEP = 2.0 ** -10
F16_STEP = 2.0 ** -10
# the attention kernels' further widths in f16: a ragged d off the 8-column
# grid, the SLAB build's 512 and the DEEP build's 1024, at the heads of
# their bf16 cases (H 16 / Hkv 4, HEADS_512, HEADS_1024; flash_packed's
# F16_PACKED_HEADS)
F16_WIDE = ("D 90", "D 512", "D 1024")
F16_PACKED_HEADS = {"D 90": (16, 90), "D 512": (2, 512), "D 1024": (1, 1024)}
# the scan in f16 (x, b and c; log_a and init f32) at mamba2-2.7b's serving
# shapes and one at d_state 256: (B, L, H, P, G, N, chunk, init)
SCAN_F16 = {"fresh window": (2, 160, 80, 64, 1, 128, 256, True),
            "incremental window": (2, 40, 80, 64, 1, 128, 256, True),
            "query": (2, 8, 80, 64, 1, 128, 256, True),
            "long prefill": (1, 4096, 80, 64, 1, 128, 256, False),
            "N 256 fresh window": (2, 160, 80, 64, 1, 256, 256, True)}
# ... and its backward at mamba2-2.7b's training shape, with init and a
# final-state cotangent
SCAN_BWD_F16 = {"mamba2-2.7b training": (2, SSM_TRAIN_SEQ, 80, 64, 1, 128, 256)}
# every kernel with a float operand (PERF.md's rows 2-10), its f16 row:
# name -> (the TPU kernel it replaces, the f16 build's source, its cases:
# at internvl3-14b's D 128 (the ViT's D 64), then F16_WIDE)
F16_ROWS = {
    "rope_shift": ("src/repro/kernels/rope_shift.py:40", "src/repro_torch/csrc/rope_shift.cu",
                   ("overlap keys",)),
    "flash_refresh_paged": ("src/repro/kernels/flash_refresh.py:458",
                            "src/repro_torch/csrc/attention_f16.cu",
                            REFRESH_CASES + F16_WIDE),
    "flash_refresh_paged_int8": ("src/repro/kernels/flash_refresh.py:380",
                                 "src/repro_torch/csrc/attention_f16.cu",
                                 ("selective refresh",) + F16_WIDE),
    "flash_refresh": ("src/repro/kernels/flash_refresh.py:236",
                      "src/repro_torch/csrc/attention_f16.cu",
                      ("selective refresh", "decode") + F16_WIDE),
    "flash_packed": ("src/repro/kernels/flash_packed.py:211",
                     "src/repro_torch/csrc/attention_f16.cu", ("serve", "busy") + F16_WIDE),
    "flash_prefill": ("src/repro/kernels/flash_prefill.py:79",
                      "src/repro_torch/csrc/attention_f16.cu", ("causal",) + F16_WIDE),
    "flash_prefill_paged": ("src/repro/kernels/flash_prefill.py:258",
                            "src/repro_torch/csrc/attention_f16.cu",
                            ("fresh prefill",) + F16_WIDE),
    "flash_prefill_paged_int8": ("src/repro/kernels/flash_prefill.py:258",
                                 "src/repro_torch/csrc/attention_f16.cu",
                                 ("fresh prefill",) + F16_WIDE),
    "ssd_scan": ("src/repro/kernels/ssd_scan.py:74", "src/repro_torch/csrc/ssd_scan_staged.cu",
                 tuple(SCAN_F16)),
    "ssd_scan_bwd": ("none (the reference trains through its plain scan)",
                     "src/repro_torch/csrc/ssd_scan_staged.cu", tuple(SCAN_BWD_F16)),
}
# the f16 builds past 256 and 512 (a case "D 512" or "D 1024" runs there)
F16_SOURCES = {"D 512": "src/repro_torch/csrc/attention_f16_512.cu",
               "D 1024": "src/repro_torch/csrc/attention_f16_deep.cu"}
F16_PATH = "f16 ops"      # the f16 phase's run of the ops, one call a kernel
F16_NAME = "{}_f16"       # a kernel's f16 row in the kernels line


def through_bf16(*ts):
    """Each f16 tensor of ``ts`` rounded through bf16 (the controls'
    operands)."""
    return [t.bfloat16().half() for t in ts]


def f16_scan(torch):
    """ssd_scan with f16 x, b and c (staged: each f16 value is exactly its
    bf16 hi + lo) at SCAN_F16's shapes: y within SCAN_F32_TOL + F16_STEP
    of its row's largest value, the state within 1e-4; then the backward
    at SCAN_BWD_F16's shape (dx, db, dc within BWD_F32_OUT_TOL + F16_STEP,
    dlog_a and d_init 1e-3, bitwise repeat).  Each case with the bf16
    build's device ms on ``.bfloat16()`` copies (read in place) and its
    control, which must fail: x, b, c (and dY) rounded through bf16.
    Returns {name: (ok, row)}."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import (
        ssd_scan_bwd_cuda, ssd_scan_bwd_plain, ssd_scan_bwd_work, ssd_scan_cuda,
        ssd_scan_fwd_plain, ssd_scan_launch, ssd_scan_plain, ssd_scan_work,
    )
    g = torch.Generator(device="cuda").manual_seed(5)
    rows, ok_all, row, worst = {}, True, None, 0.0
    for label, (B, L, H, P, G, N, chunk, with_init) in SCAN_F16.items():
        x, la, b, c, init = scan_operands(torch, g, B, L, H, P, G, N, with_init, dt="float16")
        xb, bb, cb = x.bfloat16(), b.bfloat16(), c.bfloat16()
        y_k, s_k = ssd_scan_cuda(x, la, b, c, init, chunk)
        y_p, s_p = ssd_scan_plain(x, la, b, c, init, chunk)
        y_err, y_rel = attn_errors(torch, y_k, y_p)
        xc, bc, cc = through_bf16(x, b, c)
        _, ctl = attn_errors(torch, ssd_scan_cuda(xc, la, bc, cc, init, chunk)[0], y_p)
        s_rel = slice_rel(torch, s_k, s_p, (-1, -2))
        tol = SCAN_F32_TOL + F16_STEP
        here = y_rel <= tol and s_rel <= 1e-4 and y_k.dtype == torch.float16 and ctl > tol
        flops, n_bytes = ssd_scan_work(L, H, P, G, N, chunk, B, 2, 2, 4)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_TENSOR_FLOPS)
        in_bytes = sum(t.numel() * t.element_size() for t in (x, la, b, c, init)
                       if t is not None)
        fn = lambda *a: ssd_scan_cuda(*a, chunk)  # noqa: E731
        r = dict(max_abs_err=max(y_err, float((s_k - s_p).abs().max())), rel=y_rel, tol=tol,
                 state_rel=s_rel, control_rel=ctl,
                 ms=cuda_ms(torch, lambda: fn(x, la, b, c, init), 10),
                 device_ms=device_ms(torch, fn, (x, la, b, c, init), in_bytes),
                 bf16_device_ms=device_ms(torch, fn, (xb, la, bb, cb, init), in_bytes),
                 plain_ms=cuda_ms(torch, lambda: ssd_scan_plain(x, la, b, c, init, chunk), 3),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None)
        log(f"ssd_scan f16 ({label}): x {tuple(x.shape)}, b/c {tuple(b.shape)} f16, chunk "
            f"{chunk}: y row-relative {y_rel:.3g} (limit {tol:.3g}), state {s_rel:.3g} (limit "
            f"1e-4), x/b/c through bf16 {ctl:.3g} (must exceed the limit); kernel "
            f"{r['ms']:.4f} ms per call ({r['device_ms']:.4f} ms on the device), "
            f"bf16 build {r['bf16_device_ms']:.4f} ms on the device, plain {r['plain_ms']:.4f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}): {'ok' if here else 'FAIL'}")
        ok_all = ok_all and here
        worst = max(worst, r["max_abs_err"])
        if row is None:
            row = dict(name="ssd_scan", route="cuda", **r)
            F16_CALLS["ssd_scan"] = (lambda *a, chunk=chunk: scan_step(torch, ops, *a, chunk),
                                     (x, la, b, c, init))
        else:
            row.setdefault("cases", {})[label] = r
        del xb, bb, cb, xc, bc, cc, y_k, y_p
    row["max_abs_err"] = worst
    rows["ssd_scan"] = (ok_all, row)
    for label, (B, L, H, P, G, N, chunk) in SCAN_BWD_F16.items():
        x, la, b, c, init = scan_operands(torch, g, B, L, H, P, G, N, True, dt="float16")
        dy = torch.randn((B, L, H, P), generator=g, device="cuda").half()
        dfin = torch.randn((B, H, P, N), generator=g, device="cuda")
        _, _, states = ssd_scan_launch(x, la, b, c, init, chunk, states=True)
        states_p = ssd_scan_fwd_plain(x, la, b, c, init, chunk)[2]
        got = ssd_scan_bwd_cuda(x, la, b, c, states, dy, dfin, chunk)
        again = ssd_scan_bwd_cuda(x, la, b, c, states, dy, dfin, chunk)
        want = ssd_scan_bwd_plain(x, la, b, c, states_p, dy, dfin, chunk)
        xc, bc, cc, dyc = through_bf16(x, b, c, dy)
        control = ssd_scan_bwd_cuda(xc, la, bc, cc, states, dyc, dfin, chunk)
        bitwise = all(torch.equal(u, v) for u, v in zip(got, again))
        out_tol = BWD_F32_OUT_TOL + F16_STEP
        dims = ((1, 3), (1,), (1, 3), (1, 3), (-1, -2))
        tols = (out_tol, BWD_F32_TOL, out_tol, out_tol, BWD_F32_TOL)
        names = ("dx", "dlog_a", "db", "dc", "d_init")
        readings = {nm: (slice_rel(torch, k_, w_, d_), t_)
                    for nm, k_, w_, d_, t_ in zip(names, got, want, dims, tols)}
        ctl = {nm: slice_rel(torch, k_, w_, d_) for nm, k_, w_, d_ in zip(names, control, want, dims)}
        ctl_fails = any(ctl[nm] > t_ for nm, t_ in zip(names, tols))
        dtypes = [t.dtype for t in got[:4]] == [x.dtype, la.dtype, b.dtype, c.dtype]
        here = bitwise and dtypes and ctl_fails and all(v <= t_ for v, t_ in readings.values())
        flops, n_bytes = ssd_scan_bwd_work(L, H, P, G, N, chunk, B, 2, 2, 4)
        b_ms, b_by = bound_ms(n_bytes, flops, BF16_TENSOR_FLOPS)
        args = (x, la, b, c, states, dy, dfin)
        in_bytes = sum(t.numel() * t.element_size() for t in args)
        fn = lambda *a: ssd_scan_bwd_cuda(*a, chunk)  # noqa: E731
        r = dict(max_abs_err=max(float((k_.float() - w_.float()).abs().max())
                                 for k_, w_ in zip(got, want)),
                 ms=cuda_ms(torch, lambda: fn(*args), 5),
                 device_ms=device_ms(torch, fn, args, in_bytes, replays=2, min_copies=2),
                 bf16_device_ms=device_ms(torch, fn, (x.bfloat16(), la, b.bfloat16(),
                                                      c.bfloat16(), states, dy.bfloat16(), dfin),
                                          in_bytes, replays=2, min_copies=2),
                 plain_ms=cuda_ms(torch, lambda: ssd_scan_bwd_plain(
                     x, la, b, c, states_p, dy, dfin, chunk), 2, warmup=1),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None,
                 readings={k_: v for k_, (v, _) in readings.items()}, control=ctl)
        log(f"ssd_scan_bwd f16 ({label}): x {tuple(x.shape)} f16, " + ", ".join(
            f"{nm} {v:.3g} (limit {t_:.3g})" for nm, (v, t_) in readings.items())
            + f"; x/b/c/dY through bf16 " + ", ".join(f"{nm} {v:.3g}" for nm, v in ctl.items())
            + f" (must exceed a limit: {ctl_fails}); bitwise repeat {bitwise}; output dtypes "
            f"{[dt_name(t) for t in got[:4]]}; kernel {r['ms']:.4f} ms per call "
            f"({r['device_ms']:.4f} ms on the device), bf16 build {r['bf16_device_ms']:.4f} ms "
            f"on the device, plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}): "
            f"{'ok' if here else 'FAIL'}")
        rows["ssd_scan_bwd"] = (here, dict(name="ssd_scan_bwd", route="cuda", **r))
        del x, b, c, dy, states, states_p, got, again, want, control, args
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def scan_step(torch, ops, x, la, b, c, init, chunk):
    """The scan's forward and backward under grad through ``ops``."""
    x = x.detach().requires_grad_()
    y, st = ops.ssd_scan(x, la, b, c, init, chunk)
    return torch.autograd.grad(y.float().sum() + st.sum(), (x,))[0]


def check_f16(torch, cfg, pipe, streams, cfgs, n):
    """The f16 phase: every kernel with a float operand (F16_ROWS) in f16
    against its plain version, through its kernel check with an f16 dtype
    (each attention case with f16_readings) and f16_scan; then the f16
    path: each kernel's first case once through its ``ops`` entry point
    (F16_CALLS), the launch counts read just before and just after
    (READINGS[F16_PATH], each row's ``launches``).  ``cfgs``: width label
    (F16_WIDE) -> (cfg, layout, cache slots).  Returns [(ok, row)]."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    F16_CALLS.clear()
    f16, lay, slots = torch.float16, pipe.layout, pipe.cache_slots
    wide = {w: cfgs[w] for w in F16_WIDE}

    def at_128(name):     # a row's cases at internvl3-14b's widths
        return tuple(c for c in F16_ROWS[name][2] if c not in F16_WIDE)

    paged = [check_flash_prefill_paged(torch, cfg, lay, slots, n, q_dtype=f16)] + [
        check_flash_prefill_paged(torch, *c, n, label=w, q_dtype=f16) for w, c in wide.items()]
    results = {
        "rope_shift": check_rope_shift(torch, cfg, lay, n, f16, label="f16"),
        "flash_refresh_paged": check_flash_refresh_paged(
            torch, cfg, lay, slots, n, [(w, *c, f16, ("selective refresh",))
                                        for w, c in wide.items()], dtype=f16),
        "flash_refresh_paged_int8": with_cases(
            check_flash_refresh_paged_int8(torch, cfg, lay, slots, n, q_dtype=f16),
            {w: check_flash_refresh_paged_int8(torch, *c, n, label=w, q_dtype=f16)
             for w, c in wide.items()}),
        "flash_refresh": check_flash_refresh(
            torch, [(case, cfg, lay, slots, case, f16) for case in at_128("flash_refresh")]
            + [(w, *c, "selective refresh", f16) for w, c in wide.items()], n),
        "flash_packed": with_cases(
            check_flash_packed(torch, pipe, streams, dtype=f16, only=at_128("flash_packed")),
            {w: check_flash_packed(torch, pipe, streams, heads=F16_PACKED_HEADS[w], label=w,
                                   dtype=f16, only=("busy",)) for w in F16_WIDE}),
        "flash_prefill": with_cases(
            check_flash_prefill(torch, cfg, lay.total_len, n, only=at_128("flash_prefill"),
                                dtype=f16),
            {w: check_flash_prefill(torch, c, l_.total_len, n, only=("causal",), label=w,
                                    dtype=f16) for w, (c, l_, _) in wide.items()}),
        **{name: with_cases(paged[0][i], {w: p[i] for w, p in zip(wide, paged[1:])})
           for i, name in enumerate(("flash_prefill_paged", "flash_prefill_paged_int8"))},
        **f16_scan(torch)}
    del paged
    for name, (_, row) in results.items():
        replaces, source, _ = F16_ROWS[name]
        row.update(name=F16_NAME.format(name), source=source, replaces=replaces)
        for lab, r in {**row.get("cases", {}), **row.get("families", {})}.items():
            r["source"] = next((s for w, s in F16_SOURCES.items() if lab.startswith(w)), source)
    before = ops.launch_counts()
    for fn, args in F16_CALLS.values():
        fn(*args)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    counts = {F16_NAME.format(k): after.get(k, 0) - before.get(k, 0) for k in F16_ROWS}
    READINGS[F16_PATH] = counts
    for _, row in results.values():
        row["launches_path"], row["launches"] = F16_PATH, counts[row["name"]]
    missing = [k for k, v in counts.items() if v == 0]
    log(f"f16 path (each kernel's first case through ops): launches {counts}"
        + (f"; FAIL: not launched {missing}" if missing else ""))
    log(f"f16 phase: {time.perf_counter() - t0:.1f} s")
    F16_CALLS.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return [(ok and not missing, row) for ok, row in results.values()]


# ----------------------------------------------------------------------
# phase 3, mixed (``--only mixed``; its cases run in the full run's phase 3
# after the f16 phase, whose cases it takes)
# ----------------------------------------------------------------------
# the (q, K/V) dtype pairs the attention kernels take besides q in K/V's
# type: every q over bf16 and f16 K/V, and (flash_packed, flash_prefill,
# whose oracles round nothing) over f32 K/V.  Operands are drawn in f32 and
# rounded once to their own dtypes, at the f16 phase's first case of each
# kernel at each head dim (MIXED_CASES).  Each case is held within
# mixed_tol and its output must be in q's dtype; at internvl3-14b's widths
# (D 128, the ViT's D 64) its device ms is printed beside the build that
# does the same products (mixed_base), within MIXED_RATIO of it at D 128
# (the ViT's serve packing is a launch of about 9 us), and a profiler trace of
# its calls must list no kernel but the entry's own (MIXED_TRACE_OK) and no
# host copy, cast or elementwise op (COPY_OPS) around them
MIXED_PAIRS = (("float16", "bfloat16"), ("bfloat16", "float16"), ("float32", "float16"))
F32_KV_PAIRS = (("bfloat16", "float32"), ("float16", "float32"))
F32_KV_KERNELS = ("flash_packed", "flash_prefill")
MIXED_RATIO = 1.15
MIXED_TRACE_OK = ("mma_kernel", "split_bf16_kernel", "q_deep")
MIXED_PATH = "mixed ops"  # the mixed phase's run of the ops, each pair once a kernel
MIXED_NAME = "{}_mixed"   # a kernel's mixed row in the kernels line


def mixed_pairs(name: str):
    return MIXED_PAIRS + (F32_KV_PAIRS if name in F32_KV_KERNELS else ())


def mixed_tol(name: str, q_dt: str, kv_dt: str) -> float:
    """Each dtype's own limit (ROW_TOL or PREFILL_ROW_TOL for bf16,
    F16_ROW_TOL, F32_ROW_TOL: the products' roundings and the output's in
    that dtype): the coarser of K/V's and q's in the refresh and packed
    kernels, whose products are K/V's type's and whose output is q's; q's
    alone in the prefill kernels, which keep the query and P to about 16
    bits whatever K/V's type, so that only the output's rounding differs."""
    prefill = name.startswith("flash_prefill")

    def own(dt):
        return {"float32": F32_ROW_TOL, "float16": F16_ROW_TOL}.get(
            dt, PREFILL_ROW_TOL if prefill else ROW_TOL)
    return own(q_dt) if prefill else max(own(q_dt), own(kv_dt))


def mixed_base(name: str, q_dt: str, kv_dt: str):
    """(q dtype, K/V dtype, words) of the existing build that does a mixed
    case's products at its shape: in the refresh and packed kernels K/V's
    type's build with q in that type; in the prefill kernels, whose
    query enters the products as two halves, the f32-query build over
    bf16 K/V (over f32 K/V: the f32 q/k/v build)."""
    if not name.startswith("flash_prefill"):
        return kv_dt, kv_dt, f"q/k/v {kv_dt}"
    if kv_dt == "float32":
        return "float32", "float32", "f32 q/k/v"
    return "float32", "bfloat16", "f32 q over bf16 K/V"


# host ops that copy, cast or compute elementwise: none may run around a
# mixed case's launch (the kernel reads q and writes the output in q's type)
COPY_OPS = ("aten::_to_copy", "aten::copy_", "aten::clone", "aten::fill_", "aten::zero_",
            "aten::mul", "aten::add", "aten::sub", "aten::div", "aten::where", "aten::cat")


def trace_kernels(torch, fn, calls: int = 5, tries: int = 3):
    """(the device kernels, the host ops among COPY_OPS) of ``calls`` calls
    of ``fn`` under torch.profiler, after a warm one, as ``kernel_ms``
    profiles.  A trace that lists no device kernel (the profiler lost the
    device activity, which a run of many profiled phases has shown) is
    taken again, up to ``tries`` times; the host ops are recorded on the
    host whatever the device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sorted({e.key.replace("(anonymous namespace)::", "").split("(")[0]
                          for e in events if e.device_type == torch.autograd.DeviceType.CUDA})
        copies = sorted({e.key for e in events if e.key in COPY_OPS})
        if kernels:
            break
    return kernels, copies


def check_mixed(torch):
    """The mixed phase: each attention kernel of the f16 phase's
    (MIXED_CASES, first case at each head dim) with each pair of
    ``mixed_pairs``, against its plain version (``kernel_mode("plain")``)
    on the same inputs; at the first head dim also its device ms beside
    ``mixed_base``'s, a profiler trace of its calls, its bound; then the
    mixed path: each pair once through the kernel's ``ops`` entry point at
    that head dim, the launch counts read just before and just after
    (READINGS[MIXED_PATH]) with no plain call on CUDA.  Returns [(ok,
    row)]."""
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(12)
    dt = {n: getattr(torch, n) for n in ("bfloat16", "float16", "float32")}
    short = {"bfloat16": "bf16", "float16": "f16", "float32": "f32"}
    rows, path = {}, []

    def operands(args, q_dt, kv_dt):    # q, k, v drawn anew in f32, rounded once
        q, k, v = (torch.randn(a.shape, generator=g, device="cuda") for a in args[:3])
        return (q.to(dt[q_dt]), k.to(dt[kv_dt]), v.to(dt[kv_dt])) + tuple(args[3:])

    for (name, D), (kernel, op, args, work) in MIXED_CASES.items():
        first = name not in rows
        row = rows.setdefault(name, dict(
            name=MIXED_NAME.format(name), route="cuda",
            source="src/repro_torch/csrc/attention.cuh", replaces=F16_ROWS[name][0],
            max_abs_err=0.0, library_ms=None, ok=True, cases={}))
        for q_dt, kv_dt in mixed_pairs(name):
            a = operands(args, q_dt, kv_dt)
            before = ops.launch_counts().get(name, 0)
            out_k = kernel(*a)
            torch.cuda.synchronize()
            launched = ops.launch_counts().get(name, 0) - before
            with ops.kernel_mode("plain"):
                out_p = op(*a)
            err, rel = attn_errors(torch, out_k, out_p)
            tol = mixed_tol(name, q_dt, kv_dt)
            here = rel <= tol and out_k.dtype == dt[q_dt] and launched == 1
            label = f"D {D}, {short[q_dt]} q over {short[kv_dt]} K/V"
            r = dict(max_abs_err=err, rel=rel, tol=tol, out=short[str(out_k.dtype)[6:]])
            note = ""
            if first:
                in_bytes = sum(x.numel() * x.element_size() for x in a if torch.is_tensor(x))
                bq, bkv, bwords = mixed_base(name, q_dt, kv_dt)
                base = (a[0].to(dt[bq]), a[1].to(dt[bkv]), a[2].to(dt[bkv])) + tuple(a[3:])
                r["device_ms"] = device_ms(torch, kernel, a, in_bytes)
                r["base_device_ms"] = device_ms(torch, kernel, base, in_bytes)
                r["ratio"] = r["device_ms"] / r["base_device_ms"]
                kernels, copies = trace_kernels(torch, lambda: kernel(*a))
                r["trace"] = kernels or "device activity not recorded"
                r["host_copies"] = copies
                clean = not copies and all(any(t in k for t in MIXED_TRACE_OK) for k in kernels)
                # the ratio's limit holds at D 128 (the ViT's D-64 packing is printed)
                here = here and (D != 128 or r["ratio"] <= MIXED_RATIO) and clean
                flops, n_bytes = work(a[0].element_size(), a[1].element_size())
                r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops, BF16_TENSOR_FLOPS)
                r["ms"] = cuda_ms(torch, lambda: kernel(*a), 10)
                with ops.kernel_mode("plain"):
                    r["plain_ms"] = cuda_ms(torch, lambda: op(*a), 3)
                note = (f"; device {r['device_ms']:.4f} ms, {bwords} {r['base_device_ms']:.4f} ms "
                        f"({r['ratio']:.3f}x{f', limit {MIXED_RATIO}' if D == 128 else ''}); "
                        f"kernel {r['ms']:.4f} ms per "
                        f"call, plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
                        f"({r['bound_by']}); trace: {r['trace']}, host copy or cast ops "
                        f"{copies}")
                if "ms" not in row:
                    row.update({k: r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                                  "bound_by")})
                path.append((name, op, a))
            log(f"{name} mixed ({label}): max abs err {err:.3g}, row-relative {rel:.3g} (limit "
                f"{tol:.3g}), output {r['out']}, launches {launched}{note}: "
                f"{'ok' if here else 'FAIL'}")
            row["cases"][label] = r
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["ok"] = row["ok"] and here
            del out_k, out_p
            if not first:
                del a
    before, plain_before = ops.launch_counts(), ops.plain_calls_on_cuda()
    for _, op, a in path:
        op(*a)
    torch.cuda.synchronize()
    after, plain_after = ops.launch_counts(), ops.plain_calls_on_cuda()
    counts = {MIXED_NAME.format(k): after.get(k, 0)
              - before.get(k, 0) for k in rows}
    want = {MIXED_NAME.format(k): len(mixed_pairs(k)) for k in rows}
    READINGS[MIXED_PATH] = counts
    plain_moved = plain_after != plain_before
    log(f"mixed path (each pair once through ops at the first head dim): launches {counts}"
        + (f"; FAIL: want {want}" if counts != want else "")
        + ("; FAIL: plain calls on CUDA" if plain_moved else ""))
    log(f"mixed phase: {time.perf_counter() - t0:.1f} s")
    MIXED_CASES.clear()
    del path
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    for row in rows.values():
        ok = row.pop("ok") and counts == want and not plain_moved
        row["launches_path"], row["launches"] = MIXED_PATH, counts[row["name"]]
        out.append((ok, row))
    return out


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
               "ssd_scan_bwd": TRAIN_PATH,
               "flash_prefill": SSM_MAIN,
               "flash_prefill_paged": SSM_MAIN,
               "flash_prefill_paged_int8": SSM_MAIN,
               **{F16_NAME.format(k): F16_PATH for k in F16_ROWS},
               **{MIXED_NAME.format(k): MIXED_PATH for k in F16_ROWS if k in ATTN_STRUCT}}


def path_ecfg(mode: str, opts: dict, codec=None):
    """The engine config of a path: ``opts`` are KVCfg fields and
    ``packed_vit``; ``codec`` overrides CodecCfg fields."""
    from repro_torch.serving import EngineCfg, KVCfg, PruneCfg
    kv = {k: v for k, v in opts.items() if k != "packed_vit"}
    return EngineCfg(mode=mode, codec=dataclasses.replace(codec_cfg(), **(codec or {})),
                     kv=KVCfg(**kv), prune=PruneCfg(packed_vit=opts.get("packed_vit", True)))


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


def served_reading(n_win, wall, busy, peak, launches) -> str:
    """One lockstep run's readings as phase 7(g) prints them beside its own."""
    return (f"{n_win} windows, {n_win / wall:.4f} windows/s; stage busy s {busy}; peak "
            f"memory {peak:.2f} GiB; launches {launches}")


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
        READINGS[f"phase 4 {label}"] = served_reading(n_win, wall, busy, peak, launches)
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


def composite(torch, cfg4, vit, params, vparams, videos, mode, kv, codec=None):
    """One fresh and one incremental window group at 4 layers through the
    kernels and through their plain versions.  With MoE layers the plain
    run takes the kernel run's expert choices (a bf16 step between the
    two can move a near tie, after which the runs diverge by more than
    the kernels' rounding), and prints how many tokens would have chosen
    otherwise, with the largest gate margin among them.  ``codec``: the
    path's CodecCfg fields (path_ecfg).  Returns (max |d yes/no logit|,
    its tolerance, answers agree where the margin exceeds twice it, all
    checks passed)."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingPipeline
    ecfg = path_ecfg(mode, kv, codec)
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
        READINGS[f"phase 4 {label}"] = served_reading(n_win, wall, busy, peak, launches)
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
def moe_probe_rows(cfg, largest: int) -> tuple:
    """The row counts phase 7 calls ``moe_probe`` at: the largest serving
    call's (``largest``) and a decode step's (2 rows: cap 1); none where
    ``cfg`` has no MoE layer."""
    return () if cfg.moe is None else (largest, 2)


def moe_probe(torch, cfg, params, rows) -> bool:
    """One MoE layer of ``cfg`` (its first, with the run's weights) on
    random rows at each count of ``rows`` (``moe_probe_rows``), after a
    warm-up call.  Prints for
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
    for n in rows:
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


def family_models():
    """Phase 7's models, in order: (key, arch, cfg as served, modes, frames
    per stream, what of the model is served); FAMILY_CODECS has the codec
    fields a case sets, FAMILY_FRAMES the frame edge of a case that keeps
    its model's own ViT, FAMILY_PATHS the further paths a case serves."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.audit import heads_512, heads_1024, odd_heads, with_state
    hybrid, full = get_config(HYBRID_ARCH), "full width and depth"
    return (
        ("(a)", MOE_ARCH, get_config(MOE_ARCH), ("codecflow",), MOE_FRAMES, full),
        ("(b)", HYBRID_ARCH, dataclasses.replace(hybrid, n_layers=HYBRID_LAYERS), HYBRID_PATHS,
         HYBRID_FRAMES, f"full width, {HYBRID_LAYERS} of {hybrid.n_layers} layers"),
        ("(c)", DENSE_ARCH, get_config(DENSE_ARCH), ("codecflow",), MOE_FRAMES, full),
        ("(d)", WIDE_MOE_ARCH, get_config(WIDE_MOE_ARCH), ("codecflow",), MOE_FRAMES, full),
        ("(e)", DENSE_F32, dataclasses.replace(get_config(DENSE_ARCH), dtype="float32"),
         ("codecflow",), MOE_FRAMES, f"{full}, f32 weights, search radius 16"),
        ("(f)", SSM_F32, dataclasses.replace(get_config(SSM_ARCH), dtype="float32"),
         ("codecflow",), MOE_FRAMES, f"{full}, f32 weights"),
        ("(g)", WIDE_ARCH, dataclasses.replace(get_config(ARCH), n_layers=CUT_LAYERS,
                                               **WIDE_HEADS), ("codecflow",),
         MOE_FRAMES, f"full width, {CUT_LAYERS} of 48 layers, LM heads of 256, InternViT at "
         f"{HW}^2"),
        ("(h)", SSM_N256, with_state(get_config(SSM_ARCH), WIDE_STATE), ("codecflow",),
         SSM_FRAMES, f"{full}, SSD state {WIDE_STATE}"),
        ("(i)", ODD_ARCH, dataclasses.replace(odd_heads(get_config(ARCH)), n_layers=CUT_LAYERS),
         ("codecflow",), MOE_FRAMES, f"full width, {CUT_LAYERS} of 48 layers, LM heads of 90, "
         f"InternViT re-cut to 16 heads of 75 at {HW}^2"),
        ("(j)", SSM_N512, with_state(get_config(SSM_ARCH), WIDER_STATE), ("codecflow",),
         SSM_FRAMES, f"{full}, SSD state {WIDER_STATE}"),
        ("(k)", D512_ARCH, dataclasses.replace(heads_512(get_config(ARCH)), n_layers=CUT_LAYERS),
         ("codecflow",), MOE_FRAMES, f"full width, {CUT_LAYERS} of 48 layers, LM heads of 512, "
         f"InternViT re-cut to 2 heads of 512 at {HW}^2"),
        ("(l)", D1024_ARCH, heads_1024(get_config(ARCH)), ("codecflow",), MOE_FRAMES,
         f"{full}, LM heads of 1024, InternViT re-cut to 1 head of 1024 at {HW}^2"),
    )


# (e): an f32 LM (f32 queries over the bf16 slab) ingested at the search
# range of a software H.264 encoder; (i) at radius 128 (mv_sad's tiled
# kernel: a 272^2 band at block 16)
FAMILY_CODECS = {"(e)": dict(search_radius=16), "(i)": dict(search_radius=128)}
# (g), (i), (k), (l): internvl3-14b keeps its own ViT (InternViT, 16
# heads of 64, or its re-cuts), which takes 448^2 frames, where the other
# cases take the launcher's 112^2 one
FAMILY_FRAMES = {"(g)": HW, "(i)": HW, "(k)": HW, "(l)": HW}
# phase 4's run that a case's readings are printed beside: (g), (i), (k)
# and (l) at heads of 128 (and radius 4), (h) and (j) at d_state 128
FAMILY_BESIDE = {"(g)": (f"phase 4 {MAIN}", "heads of 128"),
                 "(k)": (f"phase 4 {MAIN}", "heads of 128 and 64"),
                 "(l)": (f"phase 4 {MAIN}", "heads of 128 and 64"),
                 "(h)": (f"phase 4 {SSM_MAIN}", "d_state 128"),
                 "(i)": (f"phase 4 {MAIN}", "heads of 128 and 64, radius 4"),
                 "(j)": (f"phase 4 {SSM_MAIN}", "d_state 128")}
# (g), (i), (k), (l): after the four engine runs on the paged bf16 slab,
# one lockstep run per further path: per-stream caches (flash_refresh) and
# int8 cold pages
FAMILY_PATHS = {key: (("per-stream KV", dict(paged_kv=False)),
                      ("int8 cold pages", dict(stale_page_dtype="int8")))
                for key in ("(g)", "(i)", "(k)", "(l)")}


def model_widths(cfg) -> str:
    """``cfg``'s depth and widths, as phase 7's weights line gives them."""
    ffn = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}" if cfg.moe is not None
           else f"dense FFN d_ff {cfg.d_ff}")
    return (f"{cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv} heads of "
            f"{cfg.d_head}, {ffn}")


def family_label(arch: str, mode: str, streaming: bool) -> str:
    return f"{arch} {mode}" + (", paged bf16" if mode == "codecflow" and not streaming else "")


def serve_families(torch, keys=None):
    """Phase 7: (a) olmoe-1b-7b at full size, codecflow on the paged bf16
    slab; (b) jamba-v0.1-52b at full width with HYBRID_LAYERS layers,
    codecflow and fullcomp through the recurrent backend; (c) deepseek-7b
    (dense) and (d) moonshot-v1-16b-a3b (48 MoE layers) at full size,
    codecflow on the paged bf16 slab; (e) deepseek-7b with f32 weights
    (f32 queries over the bf16 slab) ingested at search radius 16, the
    same path; (f) mamba2-2.7b with f32 weights (f32 x, b and c into the
    scan's staged hi / lo build), codecflow through the recurrent
    backend; all with the launcher's 112^2 ViT and random weights
    made on the card from the seed (bf16 but for (e)'s and (f)'s LM), each case
    served lockstep, async, async, lockstep, the yes/no logits of every
    run bitwise equal; (g) internvl3-14b with 20 LM heads of 256 over 4
    (WIDE_HEADS: the attention kernels' D-256 build) and its own ViT at
    448^2, the same four runs on the paged bf16 slab, then one lockstep
    run on per-stream caches and one with int8 cold pages (which must
    demote pages), each path's readings printed beside phase 4's D-128
    run of the same path; (h) mamba2-2.7b with its SSD state widened to
    256 (WIDE_STATE: two column slabs of the scan's slabbed build),
    codecflow through the recurrent backend, 2 x SSM_FRAMES frames, the
    same four runs, beside phase 4's d_state-128 run; (i) internvl3-14b
    with LM heads of 90 and its ViT re-cut to 16 heads of 75 (ODD_ARCH:
    head dims off the 8-column grid) ingested at search radius 128
    (mv_sad's tiled kernel), served as (g); (j) mamba2-2.7b at d_state 512
    (WIDER_STATE: four column slabs), served as (h); (k) internvl3-14b
    with LM and ViT heads of 512 (HEADS_512: the attention kernels' SLAB
    build), served as (g); (l) internvl3-14b with LM and ViT heads of 1024
    (HEADS_1024: the DEEP build), served as (g).  (g), (i) and (k) serve
    CUT_LAYERS of the 48 layers.
    Each model's weights are freed before the next.  ``keys`` serves only
    those cases.  Returns (ok, launches per run)."""
    from repro_torch.data.pipeline import anomaly_dataset
    from repro_torch.launch.serve import default_vit
    from repro_torch.models.init import init_lm_params, init_vit_params, map_tree, tree_leaves
    from repro_torch.serving import ServingPipeline
    ok, by_path = True, {}
    for key, arch, cfg, modes, frames, depth in family_models():
        if keys is not None and key not in keys:
            continue
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        v = default_vit(cfg)
        params = init_lm_params(cfg, SEED, "cuda")
        vparams = init_vit_params(v, cfg.d_model, SEED + 1, "cuda")
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
        log(f"weights: {arch} ({depth}: {model_widths(cfg)}) {n_bytes / 2**30:.2f} GiB made "
            f"on the card in {time.perf_counter() - t0:.1f} s")
        hw = FAMILY_FRAMES.get(key, FAMILY_HW)
        videos = anomaly_dataset(2, frames, hw, hw, seed=SEED)
        want_n = 2 * ((frames - 16) // 4 + 1)
        codec = FAMILY_CODECS.get(key)
        paths = FAMILY_PATHS.get(key, ())
        makers = {mode: (lambda mode=mode: ServingPipeline(
            cfg, v, params, vparams, path_ecfg(mode, {}, codec), device="cuda"))
            for mode in modes}
        largest = 0          # rows of the largest call: a fresh append or paged prefill
        streaming = {}
        for mode, make in makers.items():
            probe = make()
            lay = probe.layout
            streaming[mode] = probe.is_streaming_family
            largest = max(largest, len(videos) * (
                lay.vis_len if probe.is_streaming_family else lay.total_len))
            if probe.is_streaming_family:
                log(f"  {arch} {mode}: attention caches of {probe.backend.cache_slots} slots "
                    f"(max_hist {probe.backend.max_hist}); state bytes per stream "
                    f"{state_bytes(cfg, probe.backend.cache_slots)}")
            else:
                log(f"  {arch} {mode}: layout total_len {lay.total_len}, vis_len "
                    f"{lay.vis_len}, query {lay.query_len}, cache slots {probe.cache_slots}")
            del probe
        rows = moe_probe_rows(cfg, largest)
        if rows:
            ok = moe_probe(torch, cfg, params, rows) and ok
        for mode, make in makers.items():
            here, runs = engine_case(torch, "families", f"{key} {mode}",
                                     family_label(arch, mode, streaming[mode]), make,
                                     videos, 2, want_n, ENGINE_ORDER, by_path)
            bitwise = all(r["logits"] == runs[0]["logits"] for r in runs)
            log(f"  {key} {mode}: yes/no logits of every run bitwise equal: {bitwise}")
            for i, res in enumerate(runs[0]["logits"]):
                log(f"  stream {i}: answers {runs[0]['answers'][i]}, yes/no logits "
                    f"{[tuple(round(x, 4) for x in lg) for lg in res]}")
            ok = ok and here and bitwise
            if key in FAMILY_BESIDE:
                reading, what = FAMILY_BESIDE[key]
                log(f"  beside {reading} ({what}): {READINGS.get(reading, 'not run')}")
        for label, kv in paths:
            def make(kv=kv):
                return ServingPipeline(cfg, v, params, vparams, path_ecfg("codecflow", kv, codec),
                                       device="cuda")
            here, _ = engine_case(torch, "families", f"{key} codecflow, {label}",
                                  f"{arch} codecflow, {label}", make, videos, 2, want_n,
                                  (False,), by_path)
            log(f"  beside phase 4 (heads of 128) [codecflow, {label}]: "
                f"{READINGS.get(f'phase 4 codecflow, {label}', 'not run')}")
            ok = ok and here
        # kernels against their plain versions through the first layers
        # of the same weights (views), as phase 6 does at 4 layers
        cut_cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, max(4, cfg.period)))
        r = cut_cfg.repeats
        cut = dict(params, blocks=tuple(map_tree(lambda t: t[:r], blk)
                                        for blk in params["blocks"]))
        short = [(f[:20], lab) for f, lab in videos]    # one fresh + one incremental window
        for label, mode, kv in [(m, m, {}) for m in modes] + [
                (f"codecflow, {lab}", "codecflow", kv) for lab, kv in paths]:
            diff, tol, ans_ok, here = composite(torch, cut_cfg, v, cut, vparams, short, mode,
                                                kv, codec)
            log(f"composite [{arch}, {label}] ({cut_cfg.n_layers} layers, full width): max "
                f"|d yes/no logit| {diff:.4g} (tol {tol:.3g}); answers agree where the "
                f"margin exceeds 2 x tol: {ans_ok}")
            if not here:
                log(f"FAIL: composite check [{arch}, {label}]")
            ok = ok and here
        del params, vparams, cut
        log(f"families {key} {arch}: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    return ok, by_path


def served_cleanly(phases: str) -> bool:
    """Every contract verdict since the last reset reads ``ok`` and no
    window served since ``SERVED`` was cleared counted a kernel fallback
    (and some window was served)."""
    from repro_torch.kernels import ops
    verdicts = ops.card_verdicts()
    log(f"contracts: card_verdicts() over {phases} {verdicts}; windows served: "
        f"{SERVED['windows']}, with kernel_fallbacks > 0: {SERVED['with fallbacks']}")
    if (any(set(c) != {"ok"} for c in verdicts.values()) or SERVED["with fallbacks"]
            or not SERVED["windows"]):
        log("FAIL: a serving call the card refuses")
        return False
    return True


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


# (arch, remat, floor): remat recomputes a layer's routing, so the MoE
# archs, whose card run takes the CPU run's expert choices call for call,
# step without it.  jamba-v0.1-52b-smoke (16 bf16 layers: two periods of
# its pattern, where the others have 2) is held to the card's own
# kernel_mode("plain") step as its floor: at that depth bf16 rounding
# alone moves a leaf's gradient by more than 2^-5 of its largest |g| (the
# CPU's bf16 step reads about 0.1 from its f32 step), so the kernels'
# gap from the CPU step may exceed the plain versions' by STEP_GRAD_TOL
# at most; the same step in f32, the card's plain versions against the
# CPU's, must agree within F32_STEP_GRAD_TOL, which shows that floor to be
# rounding and not a difference of the two plain paths
STEP_ARCHS = (("whisper-large-v3-smoke", True, False),
              ("olmoe-1b-7b-smoke", False, False),
              ("mamba2-2.7b-smoke", True, False),
              ("jamba-v0.1-52b-smoke", False, True))
F32_STEP_GRAD_TOL = 1e-3
# the seeds of ``--only deep-step``: phase 8(a)'s jamba-v0.1-52b-smoke
# readings (bf16 and f32) over several weights and batches
DEEP_STEP_SEEDS = (0, 1, 2, 3)


def leaf_gap(ga, gb, names):
    """(the largest |a - b| over a leaf's largest |a|, that leaf's name)."""
    return max((float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30), n)
               for a, b, n in zip(ga, gb, names))


def card_steps(torch, cfg, seed: int, remat: bool, kernels: bool = True, force=None,
               f32: bool = False):
    """One train step of ``cfg`` on the CPU and on the card from the same
    weights and batch (made from ``seed``; with ``f32``, the same weights
    cast to f32 and the step run in f32): the card's with the kernels
    (when ``kernels``) and under kernel_mode("plain"), each taking the
    CPU run's expert choices (every run takes ``force``'s where given).
    Returns a namespace: ``cpu``, ``kern`` (None without ``kernels``) and
    ``plain``, each (loss, grad_norm, grads); ``flips``, the count and
    margin of the kernels' own choices that differ (None without MoE);
    ``names``, the leaves'; ``choices``, the CPU run's own."""
    import dataclasses
    from types import SimpleNamespace
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels import ops
    from repro_torch.models.init import init_lm_params, leaf_paths, map_tree
    params = init_lm_params(cfg, seed, "cpu")
    if f32:
        cfg = dataclasses.replace(cfg, dtype="float32")
        params = map_tree(lambda t: t.float() if t.is_floating_point() else t, params)
    batches = [next(lm_batches(cfg, 2, 32, seed=seed, device=d)) for d in ("cpu", "cuda")]
    r = SimpleNamespace(names=[k for k, _ in leaf_paths(params)], choices=[], kern=None,
                        flips=None)
    r.cpu = step_readings(torch, cfg, params, batches[0], remat, r.choices, force=force)
    on_card = map_tree(lambda t: t.to("cuda"), params)
    if cfg.moe is not None and force is None:
        force = r.choices
    if kernels:
        own = []
        r.kern = step_readings(torch, cfg, on_card, batches[1], remat, own, force=force)
        if cfg.moe is not None:
            r.flips = choice_flips(torch, force, [(g.cpu(), e.cpu()) for g, e in own])
    with ops.kernel_mode("plain"):
        r.plain = step_readings(torch, cfg, on_card, batches[1], remat, [], force=force)
    return r


def f32_floor(torch, cfg, seed: int, remat: bool, force=None):
    """The step of ``cfg`` in f32 from its bf16 weights, the card's plain
    versions against the CPU's (the kernels take bf16 alone), taking
    ``force``'s expert choices where given: the largest leaf gap, its
    leaf, and the CPU's f32 gradients."""
    r = card_steps(torch, cfg, seed, remat, kernels=False, force=force, f32=True)
    return (*leaf_gap(r.cpu[2], r.plain[2], r.names), r.cpu[2])


def card_step_vs_cpu(torch):
    """One train step of whisper-large-v3-smoke (with remat), of
    olmoe-1b-7b-smoke (the CPU run's expert choices forced on the card),
    of mamba2-2.7b-smoke (with remat: both scan kernels on the card) and
    of jamba-v0.1-52b-smoke (forced choices) on the card and on the CPU,
    from the same weights and batch: loss, grad_norm and every gradient
    leaf within the CPU tests' limits.  The card's step under
    kernel_mode("plain") is read beside, as the rounding floor of the
    comparison; jamba's leaves are held to that floor plus STEP_GRAD_TOL,
    and its f32 step (plain versions, card against CPU) within
    F32_STEP_GRAD_TOL (see STEP_ARCHS)."""
    from repro_torch.configs import get_config
    ok = True
    for arch, remat, floored in STEP_ARCHS:
        cfg = get_config(arch)
        r = card_steps(torch, cfg, SEED, remat)
        (lc, gc_, grads_c), (lk, gk, grads_k) = r.cpu, r.kern
        (gap, leaf), (floor, floor_leaf) = (leaf_gap(grads_c, grads_k, r.names),
                                            leaf_gap(grads_c, r.plain[2], r.names))
        grad_tol = floor + STEP_GRAD_TOL if floored else STEP_GRAD_TOL
        extra = ""
        here = (abs(lk - lc) <= STEP_LOSS_TOL * abs(lc)
                and abs(gk - gc_) <= STEP_GNORM_TOL * gc_ and gap <= grad_tol)
        if floored:
            f32_gap, f32_leaf, _ = f32_floor(torch, cfg, SEED, remat, force=r.choices)
            here = here and f32_gap <= F32_STEP_GRAD_TOL
            extra = (f"; in f32 the card's plain versions read {f32_gap:.4g} from the CPU's "
                     f"at {f32_leaf} (limit {F32_STEP_GRAD_TOL:g})")
        if r.flips is not None:
            extra += (f"; the card took the CPU's expert choices, {r.flips[0]} tokens would "
                      f"have chosen otherwise (largest gate margin {r.flips[1]:.3g})")
        log(f"  card step vs CPU step [{arch}{', remat' if remat else ''}]: loss {lk:.6f} vs "
            f"{lc:.6f}, grad_norm {gk:.5f} vs {gc_:.5f}, largest gradient gap "
            f"{gap:.4g} of its leaf's max at {leaf} (limits {STEP_LOSS_TOL:g}, "
            f"{STEP_GNORM_TOL:g}, {grad_tol:.4g}{' = the floor + 2^-5' if floored else ''}; "
            f"the card's plain versions read {floor:.4g} at {floor_leaf}){extra}: "
            f"{'ok' if here else 'FAIL'}")
        ok = ok and here
    return ok


def deep_step_study(torch) -> bool:
    """jamba-v0.1-52b-smoke's step over DEEP_STEP_SEEDS (weights and
    batch from each): in bf16, the kernels' and the plain versions' gaps
    from the CPU step and from each other; in f32, the card's plain
    versions against the CPU's; and the CPU's bf16 step against its f32
    step, what rounding alone moves (every run takes the CPU bf16 run's
    expert choices).  Each reading with its leaf; it fails where phase
    8(a)'s limits fail."""
    from repro_torch.configs import get_config
    cfg = get_config("jamba-v0.1-52b-smoke")
    ok = True
    for seed in DEEP_STEP_SEEDS:
        r = card_steps(torch, cfg, seed, False)
        (lc, gc_, grads_c), (lk, gk, grads_k), (lp, gp, grads_p) = r.cpu, r.kern, r.plain
        (gap, leaf), (floor, floor_leaf), (kp, kp_leaf) = (
            leaf_gap(grads_c, grads_k, r.names), leaf_gap(grads_c, grads_p, r.names),
            leaf_gap(grads_p, grads_k, r.names))
        f32_gap, f32_leaf, grads_32 = f32_floor(torch, cfg, seed, False, force=r.choices)
        rounding, r_leaf = leaf_gap(grads_32, grads_c, r.names)
        here = (abs(lk - lc) <= STEP_LOSS_TOL * abs(lc) and abs(gk - gc_) <= STEP_GNORM_TOL * gc_
                and gap <= floor + STEP_GRAD_TOL and f32_gap <= F32_STEP_GRAD_TOL)
        log(f"  deep step [jamba-v0.1-52b-smoke, seed {seed}]: loss kernels {lk:.6f}, plain "
            f"{lp:.6f}, CPU {lc:.6f}; grad_norm {gk:.5f}, {gp:.5f}, {gc_:.5f}; bf16 gaps: "
            f"kernels vs CPU {gap:.4g} at {leaf}, plain vs CPU {floor:.4g} at {floor_leaf}, "
            f"kernels vs plain {kp:.4g} at {kp_leaf}; f32, plain vs CPU {f32_gap:.4g} at "
            f"{f32_leaf}; CPU bf16 vs CPU f32 {rounding:.4g} at {r_leaf}; {r.flips[0]} tokens "
            f"would have chosen otherwise: {'ok' if here else 'FAIL'}")
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


def profile_step(torch, cfg, params, batch_size: int = WHISPER_BATCH,
                 seq: int = WHISPER_SEQ, top: int = 12) -> dict:
    """One more train step of ``params`` (a trainable tree; fresh moments,
    the next batch of the seed) under ``torch.profiler``: the kernels'
    device time by name, the largest ``top`` of them, and their sum over
    the step's wall time (the profiler's host overhead lengthens the
    wall, so the busy share it gives is a lower bound).  Returns the
    device ms by kernel group (empty if the profiler saw none)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    ocfg = OptCfg(lr=3e-4, warmup=1, total_steps=WHISPER_STEPS)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    batch = next(lm_batches(cfg, batch_size, seq, seed=SEED + 1, device="cuda"))
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
        return {}
    log(f"  profile [{cfg.name}, one step under torch.profiler]: wall {wall * 1e3:.1f} ms, "
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
    return dict(groups)


# the scan's backward: (a) each chunk's (e o dY)^T C, (b) the sequential
# dS pass, (c) the chunk-local rest, and the partials' fixed-order sums
SSD_BWD_KERNELS = ("ssd_scan_bwd_chunk_kernel", "ssd_scan_bwd_state_kernel",
                   "ssd_scan_bwd_kernel", "sum_mid_kernel")


def kernel_group(name: str) -> str:
    """A profiled kernel's group, by its name: the scan's forward and
    backward kernels (the latter's three and its partials' sums), f32 GEMMs
    on the CUDA cores (cuBLAS ``f32f32`` / ``sgemm``), other GEMMs, copies
    and casts, softmax, reductions, the rest elementwise."""
    low = name.lower()
    if any(k in low for k in SSD_BWD_KERNELS):
        return "ssd_scan backward"
    if "ssd_scan_kernel" in low:
        return "ssd_scan forward"
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


def train_mamba(torch, dtype=None, d_state=None, steps: int = SSM_TRAIN_STEPS):
    """8(e): mamba2-2.7b at full size (64 mamba layers, random bf16
    weights from the seed) trained ``steps`` steps through
    ``launch.train.train`` (remat, batch 2, seq 2048): loss and grad_norm
    finite at every step, every leaf moved, no plain call on a CUDA
    tensor, and per step 2 forward launches per layer (the forward and
    remat's recompute) and 1 backward launch; then one profiled step.
    8(f): the same with ``dtype="float32"`` (f32 weights, x, b and c into
    the scan's staged hi / lo builds; full depth: about 60 GiB at its
    peak).  8(g) and 8(h): with ``d_state`` (the SSD state widened to
    256 and 512: two and four column slabs of the slabbed build), its
    profiled scan times printed beside 8(e)'s.  Returns (ok, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as tlaunch
    from repro_torch.models.init import init_lm_params, tree_leaves
    cfg = get_config(SSM_ARCH)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if d_state is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, d_state=d_state))
    variant = dtype is not None or d_state is not None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times, finite = [], []
    ops.reset_dispatch_counts()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    # 8(f), 8(g): launch.train's own config lookup, returning the variant
    as_cfg = (lambda get: lambda arch: cfg) if variant else (lambda get: get)
    with wrapped(tlaunch, "get_config", as_cfg), \
            wrapped(tlaunch, "make_train_step", timed_steps(torch, times, finite)):
        trained, losses = tlaunch.train(SSM_ARCH, steps, SSM_TRAIN_BATCH,
                                        SSM_TRAIN_SEQ, seed=SEED, device="cuda", log_every=1)
    t_all = time.perf_counter() - t0
    launches, plain = ops.launch_counts(), ops.plain_calls_on_cuda()
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = tree_leaves(trained)
    n_params = sum(t.numel() for t in leaves)
    fresh = tree_leaves(init_lm_params(cfg, SEED, "cuda"))     # the seed's weights again
    moved = all(not torch.equal(a, b) for a, b in zip(fresh, leaves))
    del fresh
    n_mamba = sum(k == "mamba" for k in cfg.block_pattern) * cfg.repeats
    want = {"ssd_scan": 2 * n_mamba * steps, "ssd_scan_bwd": n_mamba * steps}
    t_step = sum(times[1:]) / len(times[1:])
    if not variant:
        READINGS["mamba_step_s"] = t_step
    tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    flops = 8.0 * n_params * tokens
    w_bytes = 4 if cfg.dtype == "float32" else 2
    log(f"train [{SSM_ARCH}, full size, {cfg.dtype}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"d_state {cfg.ssm.d_state}, {n_params / 1e9:.3f} B parameters, remat, batch "
        f"{SSM_TRAIN_BATCH}, seq {SSM_TRAIN_SEQ}]: losses {[round(x, 4) for x in losses]}; "
        f"step s {[round(x, 4) for x in times]} (step 1 includes the first calls' set-up; "
        f"{t_all:.1f} s with the weights' set-up); steps 2-{steps} {t_step:.4f} s "
        f"each: {tokens / t_step:.1f} tokens/s; model FLOPs per step {flops / 1e12:.2f} T "
        f"(8 x parameters x positions): {flops / t_step / BF16_TENSOR_FLOPS:.4f} of the bf16 "
        f"peak; peak memory {peak:.2f} GiB (parameters, gradients and f32 moments "
        f"{n_params * (2 * w_bytes + 8) / 2**30:.2f} GiB); finite every step: {all(finite)}; "
        f"every leaf moved: {moved}; launches {launches} (want {want}); plain on CUDA: {plain}")
    ok = (all(finite) and len(finite) == steps and moved
          and not any(plain.values())
          and all(launches.get(k, 0) == n for k, n in want.items()))
    groups = profile_step(torch, cfg, trained, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ)
    busy = sum(groups.values())
    if busy:
        bwd = groups.get("ssd_scan backward", 0.0)
        log(f"  the backward kernel (with its reduction): {bwd:.1f} ms of {busy:.1f} ms of "
            f"kernels in the profiled step ({bwd / busy:.4f}); the forward kernel "
            f"{groups.get('ssd_scan forward', 0.0):.1f} ms")
    if not variant:
        READINGS["mamba_scan_ms"] = (groups.get("ssd_scan forward", 0.0),
                                     groups.get("ssd_scan backward", 0.0), t_step, peak)
    elif d_state is not None:
        fwd, bwd, t8e, p8e = READINGS.get("mamba_scan_ms", (None,) * 4)
        log(f"  beside 8(e) (d_state {get_config(SSM_ARCH).ssm.d_state}): scan forward "
            f"{fwd} ms, backward {bwd} ms, step {t8e} s, peak {p8e} GiB")
    del trained, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches


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
    ok = ok and here
    here, ssm = train_mamba(torch)
    ok = ok and here
    here, ssm32 = train_mamba(torch, "float32")
    ok = ok and here
    here, ssm256 = train_mamba(torch, d_state=WIDE_STATE, steps=2)
    ok = ok and here
    here, ssm512 = train_mamba(torch, d_state=WIDER_STATE, steps=2)
    log(f"train phase: {time.perf_counter() - t0:.1f} s")
    return ok and here, {f"{WHISPER_ARCH} decode": dec, **by_path, TRAIN_PATH: ssm,
                         f"{SSM_F32} training": ssm32, f"{SSM_N256} training": ssm256,
                         f"{SSM_N512} training": ssm512}


# ----------------------------------------------------------------------
# phase 9: meshes, the roofline, the dry run
# ----------------------------------------------------------------------
MESH_ARCHS = ("whisper-large-v3-smoke", "olmoe-1b-7b-smoke", "mamba2-2.7b-smoke")
# launch.train.train(mesh_kind="host") on the card: the MoE, SSM and hybrid families
HOST_TRAIN_ARCHS = ("olmoe-1b-7b-smoke", "mamba2-2.7b-smoke", "jamba-v0.1-52b-smoke")
MESH_WHISPER_STEPS = 3
DRYRUNS = (("deepseek-7b", "train_4k"), ("jamba-v0.1-52b", "prefill_32k"),
           ("jamba-v0.1-52b", "train_4k"))
DRYRUN_TIMEOUT = 420


def timed_steps(torch, times: list, finite: list = None):
    """A wrapper of ``make_train_step``: each step it makes appends its
    seconds, to the card's end of the step, to ``times`` (and whether
    its loss and grad_norm are finite to ``finite``)."""
    def wrap(make):
        def made(*a, **k):
            step = make(*a, **k)

            def run(*args):
                t0 = time.perf_counter()
                out = step(*args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if finite is not None:
                    m = out[2]
                    finite.append(bool(torch.isfinite(m["loss"]))
                                  and bool(torch.isfinite(m["grad_norm"])))
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
    here = True
    for arch in HOST_TRAIN_ARCHS:
        _, losses = tlaunch.train(arch, 2, 2, 32, mesh_kind="host", seed=SEED,
                                  device="cuda", log_every=1)
        good = len(losses) == 2 and all(math.isfinite(x) for x in losses)
        log(f"  launch.train.train({arch!r}, mesh_kind='host'): losses "
            f"{[round(x, 4) for x in losses]}: {'ok' if good else 'FAIL'}")
        here = here and good
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


def mamba_roofline(torch, smi: str):
    """9(b) for the SSM family: count one step of phase 8(e)'s
    mamba2-2.7b (full size, batch 2, seq 2048, remat; the scan's forward
    and backward by their work formulas) and hold its larger roofline
    term against phase 8(e)'s measured step time."""
    from repro_torch.analysis import roofline
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models.init import init_lm_params, trainable, tree_leaves
    from repro_torch.training.optimizer import OptCfg, init_opt_state
    from repro_torch.training.train_step import make_train_step
    cfg = get_config(SSM_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = trainable(init_lm_params(cfg, SEED, "cuda"))
    n_params = sum(t.numel() for t in tree_leaves(params))
    ocfg = OptCfg(warmup=1, total_steps=SSM_TRAIN_STEPS)
    opt = init_opt_state(params, ocfg)
    batch = next(lm_batches(cfg, SSM_TRAIN_BATCH, SSM_TRAIN_SEQ, seed=SEED, device="cuda"))
    t0 = time.perf_counter()
    d = roofline.count_step(make_train_step(cfg, ocfg), params, opt, batch)
    torch.cuda.synchronize()
    t_count = time.perf_counter() - t0
    rep = roofline.Report(arch=SSM_ARCH, shape=f"train b{SSM_TRAIN_BATCH} s{SSM_TRAIN_SEQ}",
                          mesh="one card", chips=1, ok=True)
    rep.flops_per_device = d["flops"]
    rep.bytes_per_device = d["bytes_accessed"]
    rep.coll_bytes_per_device = d["coll_operand_bytes"]
    rep.model_flops = 8.0 * n_params * SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
    t_step = READINGS.get("mamba_step_s")
    bound = max(rep.t_compute, rep.t_memory, rep.t_collective)
    share = bound / t_step if t_step else float("nan")
    n_mamba = sum(k == "mamba" for k in cfg.block_pattern) * cfg.repeats
    kern = d["kernels"]
    ok = (t_step is not None and 0 < share <= 1.05
          and kern.get("ssd_scan_bwd", {}).get("calls") == n_mamba)
    log(f"  roofline [{SSM_ARCH}, full size, one step, {smi}]: counted "
        f"{d['flops'] / 1e12:.3f} T FLOPs (matrix products and the kernel ops' formulas), "
        f"{d['bytes_accessed'] / 1e9:.2f} GB accessed (unfused); kernel ops {kern}; "
        f"t_compute {rep.t_compute:.5f} s, t_memory {rep.t_memory:.5f} s, dominant "
        f"{rep.dominant}, useful ratio {rep.useful_ratio:.4f}; roofline share (larger term over "
        f"phase 8(e)'s step of {t_step} s): {share:.4f} (must lie in (0, 1.05]); counted run "
        f"{t_count:.1f} s, peak live {d['peak_bytes'] / 2**30:.2f} GiB: {'ok' if ok else 'FAIL'}")
    del params, opt, batch, d
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def dry_run_kernels_ok(arch: str, shape: str, kernels: dict) -> bool:
    """A training program's count holds the scan's backward once per
    mamba layer per microbatch: its forward twice as often (remat's
    recompute), and a whole number of microbatches over the mamba layers."""
    from repro_torch.configs import get_config
    if not shape.startswith("train") or get_config(arch).ssm is None:
        return True
    cfg = get_config(arch)
    n_mamba = sum(k == "mamba" for k in cfg.block_pattern) * cfg.repeats
    bwd = kernels.get("ssd_scan_bwd", {}).get("calls", 0)
    fwd = kernels.get("ssd_scan", {}).get("calls", 0)
    log(f"    {arch} {shape}: ssd_scan_bwd {bwd} calls, ssd_scan {fwd}, over {n_mamba} mamba "
        f"layers: {bwd / n_mamba:g} microbatches")
    return bwd > 0 and bwd % n_mamba == 0 and fwd == 2 * bwd


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
                and all(math.isfinite(t) and t > 0 for t in terms)
                and dry_run_kernels_ok(arch, shape, r.get("kernels", {})))
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
                 lambda: mamba_roofline(torch, smi), lambda: dry_runs(smi)):
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
        f"448^2 frames, mamba2-2.7b SSD H 80 P 64 N 128, its backward at L 2048): verdicts on "
        f"meta tensors {meta}; "
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
                    help="comma-separated kernel names: their checks alone (phases 1-3; 'f16': "
                         "every kernel in f16; 'mixed': the attention kernels with q and K/V "
                         "of two types, after the f16 phase); "
                         "or 'mha' (phase 3's mha probe), 'families' (phase 7), 'whisper' "
                         "(phase 8(b)), 'mamba' (phase 8(e) and its roofline), 'f32-ssm' "
                         "(phases 7(f) and 8(f): mamba2-2.7b in f32), 'd256' (phase 7(g): "
                         "internvl3-14b with LM heads of 256), 'n256-ssm' (phases 7(h) and "
                         "8(g): mamba2-2.7b at d_state 256), 'odd-heads' (phase 7(i): "
                         "internvl3-14b with heads of 90 and 75 at search radius 128), "
                         "'n512-ssm' (phases 7(j) and 8(h): d_state 512), 'd512' (phase 7(k): "
                         "internvl3-14b with LM and ViT heads of 512), 'd1024' (phase 7(l): "
                         "heads of 1024), 'mesh' "
                         "(phases 8(b) and 8(e), then phase 9), 'hosttime' (phase 3(c)'s host "
                         "times) and 'deep-step' (phase 8(a)'s jamba step over several seeds), "
                         "each alone after phases 1-2")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is driven")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
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
            READINGS.setdefault("registers", {})[label] = regs
            if spill and (src.startswith("attention") or src.startswith("ssd_scan")):
                spilled.append(label)
    if spilled:
        log(f"FAIL: attention or scan kernels spill registers: {spilled}")
        return 1
    probes = {"mha": lambda: mha_probe(torch), "whisper": lambda: train_whisper(torch)[0],
              "hosttime": lambda: host_times(torch),
              "mesh": lambda: (train_whisper(torch)[0] and train_mamba(torch)[0]
                               and mesh_phase(torch, smi)),
              "mamba": lambda: train_mamba(torch)[0] and mamba_roofline(torch, smi),
              "deep-step": lambda: deep_step_study(torch),
              "families": lambda: serve_families(torch)[0] and served_cleanly("phase 7"),
              "f32-ssm": lambda: (serve_families(torch, ("(f)",))[0]
                                  and served_cleanly("phase 7(f)")
                                  and train_mamba(torch, "float32")[0]),
              "d256": lambda: (serve_families(torch, ("(g)",))[0]
                               and served_cleanly("phase 7(g)")),
              "n256-ssm": lambda: (serve_families(torch, ("(h)",))[0]
                                   and served_cleanly("phase 7(h)")
                                   and train_mamba(torch, d_state=WIDE_STATE, steps=2)[0]),
              "odd-heads": lambda: (serve_families(torch, ("(i)",))[0]
                                    and served_cleanly("phase 7(i)")),
              "d512": lambda: (serve_families(torch, ("(k)",))[0]
                               and served_cleanly("phase 7(k)")),
              "d1024": lambda: (serve_families(torch, ("(l)",))[0]
                                and served_cleanly("phase 7(l)")),
              "n512-ssm": lambda: (serve_families(torch, ("(j)",))[0]
                                   and served_cleanly("phase 7(j)")
                                   and train_mamba(torch, d_state=WIDER_STATE, steps=2)[0])}
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
    # head dims without an exact build, at H 16 over Hkv 4 on internvl3-14b's
    # layout, and f32 queries (an f32 LM's) at its own widths
    F32 = torch.float32
    lay, slots = pipe.layout, pipe.cache_slots
    widths = {f"D {d}": dataclasses.replace(cfg, name=f"d{d}", n_heads=16, n_kv=4, d_head=d)
              for d in RAGGED_WIDTHS + ODD_WIDTHS}
    stream_cases += tuple((f"{lab}, selective refresh", w, lay, slots, "selective refresh")
                          for lab, w in widths.items()) + tuple(
        (f"f32 q, {case}", cfg, lay, slots, case, F32) for case in REFRESH_CASES)
    # the WIDE build: internvl3-14b at 20 heads of 256 (WIDE_HEADS), with
    # bf16 and f32 queries, and ragged widths on it at the same heads
    d256 = dataclasses.replace(cfg, name="d256", **WIDE_HEADS)
    wide_ragged = {f"D {d}": dataclasses.replace(d256, name=f"d{d}", d_head=d)
                   for d in WIDE_RAGGED}
    # f32 queries (f32 q/k/v in flash_packed and flash_prefill) at the head
    # dims off the 8-column grid, on their bf16 cases' heads
    odd_f32 = {f"D {d}, f32 q": {**widths, **wide_ragged}[f"D {d}"]
               for d in ODD_WIDTHS + ODD_WIDE}
    D256, D256_F32 = "D 256", "D 256, f32 q"
    stream_cases += tuple((f"{D256}, {case}", d256, lay, slots, case)
                          for case in REFRESH_CASES) + (
        (f"{D256_F32}, selective refresh", d256, lay, slots, "selective refresh", F32),) + tuple(
        (f"{lab}, selective refresh", w, lay, slots, "selective refresh")
        for lab, w in wide_ragged.items()) + tuple(
        (f"{lab}, selective refresh", w, lay, slots, "selective refresh", F32)
        for lab, w in odd_f32.items())
    # the SLAB build: internvl3-14b at 10 heads of 512 over 2 (HEADS_512)
    # and the ragged widths on it at the same heads, bf16 and f32 queries
    slab_w = {f"D {d}": dataclasses.replace(cfg, name=f"d{d}", **{**HEADS_512, "d_head": d})
              for d in SLAB_WIDTHS}
    slab_f32 = {f"{lab}, f32 q": w for lab, w in slab_w.items()}
    stream_cases += tuple((f"{lab}, selective refresh", w, lay, slots, "selective refresh")
                          for lab, w in slab_w.items()) + (
        ("D 512, decode", slab_w["D 512"], lay, slots, "decode"),) + tuple(
        (f"{lab}, selective refresh", w, lay, slots, "selective refresh", F32)
        for lab, w in slab_f32.items())
    # the DEEP build: internvl3-14b at 5 heads of 1024 over 1 (HEADS_1024)
    # and the widths past 512 at the same heads; 2048 and 4096 at 2 heads
    # over 1 on the bench VLM's layout: label -> (cfg, layout, slots)
    deep = {f"D {d}": (dataclasses.replace(cfg, name=f"d{d}", **{**HEADS_1024, "d_head": d}),
                       lay, slots) for d in DEEP_WIDTHS} | {
        f"D {d}": (dataclasses.replace(cfg, name=f"d{d}", n_heads=2, n_kv=1, d_head=d), blay,
                   bslots) for d in DEEP_WIDE}
    deep_f32 = {f"{lab}, f32 q": c for lab, c in deep.items()}
    # the int8 cases' cold pages a stream: the bench layout's 2 pages hold 1
    deep_cold = {lab: {"n_cold": 1} if c[1] is blay else {}
                 for lab, c in (deep | deep_f32).items()}
    stream_cases += tuple((f"{lab}, selective refresh", *c, "selective refresh")
                          for lab, c in deep.items()) + tuple(
        (f"D 1024, {case}", *deep["D 1024"], case) for case in ("fresh prefill", "decode")) + tuple(
        (f"{lab}, selective refresh", *c, "selective refresh", F32) for lab, c in deep_f32.items())
    n = len(videos)
    paged_families, stream_families = family_kernel_cases()
    paged_families += [(B24, bcfg, blay, bslots), (W24, wide, pipe.layout, pipe.cache_slots),
                       (f"{SMOKE_ARCH}, D 64", smoke, blay, bslots)] + [
        (lab, w, lay, slots, None, ("selective refresh",)) for lab, w in widths.items()] + [
        ("f32 q", cfg, lay, slots, F32), (D256, d256, lay, slots),
        (D256_F32, d256, lay, slots, F32)] + [
        (lab, w, lay, slots, None, ("selective refresh",)) for lab, w in wide_ragged.items()] + [
        (lab, w, lay, slots, F32, ("selective refresh",)) for lab, w in odd_f32.items()] + [
        (lab, w, lay, slots, None, REFRESH_CASES if lab == "D 512" else ("selective refresh",))
        for lab, w in slab_w.items()] + [
        (lab, w, lay, slots, F32, ("selective refresh",)) for lab, w in slab_f32.items()] + [
        (lab, *c, None, REFRESH_CASES if lab == "D 1024" else ("selective refresh",))
        for lab, c in deep.items()] + [
        (lab, *c, F32, ("selective refresh",)) for lab, c in deep_f32.items()]

    def prefill_paged():
        main = check_flash_prefill_paged(torch, cfg, pipe.layout, pipe.cache_slots, n)
        extra = {B24: check_flash_prefill_paged(torch, bcfg, blay, bslots, n, n_cold=1,
                                                label=B24),
                 W24: check_flash_prefill_paged(torch, wide, pipe.layout, pipe.cache_slots, n,
                                                label=W24),
                 **{lab: check_flash_prefill_paged(torch, w, lay, slots, n, label=lab)
                    for lab, w in widths.items()},
                 "f32 q": check_flash_prefill_paged(torch, cfg, lay, slots, n, label="f32 q",
                                                    q_dtype=F32),
                 D256: check_flash_prefill_paged(torch, d256, lay, slots, n, label=D256),
                 D256_F32: check_flash_prefill_paged(torch, d256, lay, slots, n,
                                                     label=D256_F32, q_dtype=F32),
                 **{lab: check_flash_prefill_paged(torch, w, lay, slots, n, label=lab)
                    for lab, w in wide_ragged.items()},
                 **{lab: check_flash_prefill_paged(torch, w, lay, slots, n, label=lab,
                                                   q_dtype=F32)
                    for lab, w in odd_f32.items()},
                 **{lab: check_flash_prefill_paged(torch, w, lay, slots, n, label=lab)
                    for lab, w in slab_w.items()},
                 **{lab: check_flash_prefill_paged(torch, w, lay, slots, n, label=lab,
                                                   q_dtype=F32)
                    for lab, w in slab_f32.items()},
                 **{lab: check_flash_prefill_paged(torch, *c, n, label=lab, **deep_cold[lab])
                    for lab, c in deep.items()},
                 **{lab: check_flash_prefill_paged(torch, *c, n, label=lab, q_dtype=F32,
                                                   **deep_cold[lab])
                    for lab, c in deep_f32.items()}}
        return [with_cases(m, {lab: rows[i] for lab, rows in extra.items()})
                for i, m in enumerate(main)]

    def f16_phase():
        return check_f16(torch, cfg, pipe, streams, {
            "D 128": (cfg, lay, slots), "D 90": (widths["D 90"], lay, slots),
            "D 512": (slab_w["D 512"], lay, slots), "D 1024": deep["D 1024"]}, n)

    checks = {   # kernel name -> its check; flash_prefill_paged's covers the int8 row too
        "mv_sad": lambda: [with_cases(check_mv_sad(torch, videos), {
            f"{hw}^2, block {b}, radius {r}": check_mv_search(torch, hw, b, r)
            for hw, b, r in MV_SEARCHES})],
        "rope_shift": lambda: [with_cases(check_rope_shift(torch, cfg, pipe.layout, n), {
            f"{B24}, bf16": check_rope_shift(torch, bcfg, blay, n, label=f"{B24}, bf16"),
            f"{B24}, f32": check_rope_shift(torch, bcfg, blay, n, torch.float32,
                                            label=f"{B24}, f32"),
            W24: check_rope_shift(torch, wide, pipe.layout, n, label=W24),
            f"{SMOKE_ARCH}, D 64": check_rope_shift(torch, smoke, blay, n,
                                                    label=f"{SMOKE_ARCH}, D 64"),
            D256: check_rope_shift(torch, d256, pipe.layout, n, label=D256),
            **{f"D {d}": check_rope_shift(torch, {**widths, **wide_ragged}[f"D {d}"],
                                          pipe.layout, n, label=f"D {d}")
               for d in (20, 90, 130)},
            **{f"D {d}": check_rope_shift(torch, slab_w[f"D {d}"], pipe.layout, n,
                                          label=f"D {d}")
               for d in (320, 512)},
            **{f"D {d}": check_rope_shift(torch, deep[f"D {d}"][0], deep[f"D {d}"][1], n,
                                          label=f"D {d}")
               for d in (1024, 2048)}})],
        "flash_refresh_paged": lambda: [check_flash_refresh_paged(
            torch, cfg, pipe.layout, pipe.cache_slots, n, paged_families)],
        "flash_packed": lambda: [with_cases(check_flash_packed(torch, pipe, streams), {
            B24: check_flash_packed(torch, bench, bench_streams, label=B24),
            "D 24, H 16 on internvl3-14b's packings": check_flash_packed(
                torch, pipe, streams, heads=(16, 24), label="D 24, H 16"),
            f"{SMOKE_ARCH} ViT, D 32": check_flash_packed(
                torch, bench, bench_streams, heads=(4, 32), label=f"{SMOKE_ARCH} ViT, D 32"),
            **{f"{lab}, H 16, busy": check_flash_packed(
                torch, pipe, streams, heads=(16, w.d_head), label=f"{lab}, H 16", only=("busy",))
               for lab, w in widths.items()},
            "f32 q/k/v, busy": check_flash_packed(torch, pipe, streams, dtype=F32,
                                                  label="f32 q/k/v", only=("busy",)),
            **{f"{lab}, busy": check_flash_packed(torch, pipe, streams, heads=(8, d),
                                                  label=lab, dtype=dt, only=("busy",))
               for lab, d, dt in (("D 256, H 8", 256, None), ("D 256, H 8, f32 q/k/v", 256, F32),
                                  *((f"D {d}, H 8", d, None) for d in WIDE_RAGGED),
                                  *((f"D {d}, H {16 if d <= 128 else 8}, f32 q/k/v", d, F32)
                                    for d in ODD_WIDTHS + ODD_WIDE),
                                  *((f"D {d}, H 2", d, None) for d in SLAB_WIDTHS),
                                  *((f"D {d}, H 2, f32 q/k/v", d, F32) for d in SLAB_WIDTHS))},
            **{f"{lab}, busy": check_flash_packed(torch, pipe, streams, heads=(1, d),
                                                  label=lab, dtype=dt, only=("busy",))
               for lab, d, dt in (*((f"D {d}, H 1", d, None) for d in DEEP_WIDTHS + DEEP_WIDE),
                                  *((f"D {d}, H 1, f32 q/k/v", d, F32)
                                    for d in DEEP_WIDTHS + DEEP_WIDE))}})],
        "flash_refresh": lambda: [check_flash_refresh(torch, stream_cases, n, stream_families)],
        "flash_refresh_paged_int8": lambda: [with_cases(
            check_flash_refresh_paged_int8(torch, cfg, pipe.layout, pipe.cache_slots, n), {
                B24: check_flash_refresh_paged_int8(torch, bcfg, blay, bslots, n, n_cold=1,
                                                    label=B24),
                W24: check_flash_refresh_paged_int8(torch, wide, pipe.layout, pipe.cache_slots,
                                                    n, label=W24),
                **{lab: check_flash_refresh_paged_int8(torch, w, lay, slots, n, label=lab)
                   for lab, w in widths.items()},
                "f32 q": check_flash_refresh_paged_int8(torch, cfg, lay, slots, n,
                                                        label="f32 q", q_dtype=F32),
                D256: check_flash_refresh_paged_int8(torch, d256, lay, slots, n, label=D256),
                D256_F32: check_flash_refresh_paged_int8(torch, d256, lay, slots, n,
                                                         label=D256_F32, q_dtype=F32),
                **{lab: check_flash_refresh_paged_int8(torch, w, lay, slots, n, label=lab)
                   for lab, w in wide_ragged.items()},
                **{lab: check_flash_refresh_paged_int8(torch, w, lay, slots, n, label=lab,
                                                       q_dtype=F32)
                   for lab, w in odd_f32.items()},
                **{lab: check_flash_refresh_paged_int8(torch, w, lay, slots, n, label=lab)
                   for lab, w in slab_w.items()},
                **{lab: check_flash_refresh_paged_int8(torch, w, lay, slots, n, label=lab,
                                                       q_dtype=F32)
                   for lab, w in slab_f32.items()},
                **{lab: check_flash_refresh_paged_int8(torch, *c, n, label=lab,
                                                       **deep_cold[lab])
                   for lab, c in deep.items()},
                **{lab: check_flash_refresh_paged_int8(torch, *c, n, label=lab, q_dtype=F32,
                                                       **deep_cold[lab])
                   for lab, c in deep_f32.items()}})],
        "ssd_scan": lambda: [check_ssd_scan(torch)],
        "ssd_scan_bwd": lambda: [check_ssd_scan_bwd(torch)],
        "flash_prefill": lambda: [with_cases(
            check_flash_prefill(torch, cfg, pipe.layout.total_len, n), {
                lab: check_flash_prefill(torch, c, total, n, only=("causal", "ragged"),
                                         label=lab)
                for lab, c, total in ((B24, bcfg, blay.total_len),
                                      (W24, wide, pipe.layout.total_len))} | {
                lab: check_flash_prefill(torch, w, lay.total_len, n, only=("causal",), label=lab)
                for lab, w in widths.items()} | {
                "f32 q/k/v": check_flash_prefill(torch, cfg, lay.total_len, n,
                                                 only=("causal",), label="f32 q/k/v",
                                                 dtype=F32),
                D256: check_flash_prefill(torch, d256, lay.total_len, n, only=(
                    "causal", "chunk at an offset", "sliding window", "ragged"), label=D256),
                f"{D256}, f32 q/k/v": check_flash_prefill(torch, d256, lay.total_len, n,
                                                          only=("causal",),
                                                          label=f"{D256}, f32 q/k/v",
                                                          dtype=F32)} | {
                lab: check_flash_prefill(torch, w, lay.total_len, n, only=("causal",), label=lab)
                for lab, w in wide_ragged.items()} | {
                f"D {w.d_head}, f32 q/k/v": check_flash_prefill(
                    torch, w, lay.total_len, n, only=("causal",), label=f"D {w.d_head}, f32 q/k/v",
                    dtype=F32)
                for w in odd_f32.values()} | {
                lab: check_flash_prefill(torch, w, lay.total_len, n, label=lab, only=(
                    "causal", "chunk at an offset", "sliding window", "ragged")
                    if lab == "D 512" else ("causal",))
                for lab, w in slab_w.items()} | {
                f"{lab}, f32 q/k/v": check_flash_prefill(
                    torch, w, lay.total_len, n, only=("causal",), label=f"{lab}, f32 q/k/v",
                    dtype=F32)
                for lab, w in slab_w.items()} | {
                lab: check_flash_prefill(torch, w, l_.total_len, n, label=lab, only=(
                    "causal", "chunk at an offset", "sliding window", "ragged")
                    if lab == "D 1024" else ("causal",))
                for lab, (w, l_, _) in deep.items()} | {
                f"{lab}, f32 q/k/v": check_flash_prefill(
                    torch, w, l_.total_len, n, only=("causal",), label=f"{lab}, f32 q/k/v",
                    dtype=F32)
                for lab, (w, l_, _) in deep.items()})],
        "flash_prefill_paged": prefill_paged,
        "f16": f16_phase,
        # the f16 phase's cases with q and K/V of two types (alone: after them)
        "mixed": lambda: ([] if MIXED_CASES else f16_phase()) + check_mixed(torch),
    }
    if only - set(checks):
        log(f"FAIL: --only names no check: {sorted(only - set(checks))}")
        return 1
    t0 = time.perf_counter()
    results = [r for name, run in checks.items() if not only or name in only for r in run()]
    log(f"kernels (phase 3): {time.perf_counter() - t0:.1f} s")
    phase_launches = ops.launch_counts()
    del streams, unpruned, bench, bench_streams
    gc.collect()
    torch.cuda.empty_cache()
    rows = [r for _, r in results]
    slab_table(rows)
    if not all(ok for ok, _ in results):
        log("FAIL: a kernel disagrees with its plain version")
        return 1
    if only:
        print(json.dumps({"kernels": rows}))
        print(smi)
        return 0
    t0 = time.perf_counter()
    if not check_lm_head(torch, cfg, pipe.params):
        log("FAIL: lm_logits does not keep the head product's f32 result")
        return 1
    if not mha_probe(torch):
        log("FAIL: the dense mha")
        return 1
    if not contracts_phase(torch):
        log("FAIL: contracts phase")
        return 1
    log(f"LM head, mha, contracts: {time.perf_counter() - t0:.1f} s")

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
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"serve: {n_win} windows in {wall:.3f} s ({n_win / wall:.4f} windows/s incl. "
        f"codec ingest); stage busy s {occ}; peak memory {peak:.2f} GiB")
    log(f"launches during serve: {launches}; plain on CUDA: {plain_on_cuda}")
    READINGS[f"phase 4 {MAIN}"] = served_reading(n_win, wall, occ, peak, launches)
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
    by_path = {KERNEL_PHASE: phase_launches, F16_PATH: READINGS.get(F16_PATH, {}),
               MIXED_PATH: READINGS.get(MIXED_PATH, {}), MAIN: launches, **by_path, **ssm_by_path, **engine_by_path}
    for row in rows:
        name = row["name"]
        row["launches_path"] = LAUNCH_PATH.get(name, MAIN)
        row["launches"] = by_path.get(row["launches_path"], {}).get(name, 0)
        row["launches_by_path"] = {lab: n[name] for lab, n in by_path.items() if name in n}

    # -- 6. composite: kernels vs plain versions at 4 layers -------------
    t0 = time.perf_counter()
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
    log(f"composite: {time.perf_counter() - t0:.1f} s")

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
    if not served_cleanly("phases 4-7 (windows of phases 4, 5 and 7)"):
        return 1

    # -- 8. training: whisper-large-v3 at full size, the anomaly task ------
    t0 = time.perf_counter()
    ok, train_by_path = train_phase(torch)
    log(f"train: {time.perf_counter() - t0:.1f} s")
    if not ok:
        log("FAIL: train phase")
        return 1
    for row in rows:
        row["launches_by_path"].update(
            {lab: n[row["name"]] for lab, n in train_by_path.items() if row["name"] in n})
        if row["launches_path"] in train_by_path:
            row["launches"] = train_by_path[row["launches_path"]].get(row["name"], 0)

    # -- 9. mesh: the host mesh, the roofline of a step, the dry run -------
    t0 = time.perf_counter()
    if not mesh_phase(torch, smi):
        log("FAIL: mesh phase")
        return 1

    log(f"mesh: {time.perf_counter() - t0:.1f} s")

    # -- 10. the examples on the card -------------------------------------
    t0 = time.perf_counter()
    if not examples_phase(Path(args.src).resolve()):
        log("FAIL: examples phase")
        return 1

    log(f"examples: {time.perf_counter() - t0:.1f} s")
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
