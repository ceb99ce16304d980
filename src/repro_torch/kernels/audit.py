"""Dispatch and map-budget audits of the kernel-contract registry.

The port's counterpart of the JAX package's ``tools/check/dispatch_audit.py``
and ``recompile_audit.py``, in the package because it imports only torch
and ``repro_torch``.

    PYTHONPATH=src python -m repro_torch.kernels.audit

prints three tables and exits 0 iff no row that must reach the kernel is
refused, no row resolves otherwise than it expects, and no map budget is
exceeded:

  * **dispatch coverage** — the reference's geometry matrix (its window
    layouts and cache roundings, the paged, int8, prefill and packed rows,
    the slab rows) through the port's planners (``core.kvc.
    refresh_block_map``, ``core.pruning.pack_plan``) and
    ``contracts.decide``, and through a call of the real ``ops`` on meta
    tensors, whose ``card_verdicts()`` must agree with ``decide``.  A row
    expects ``kernel`` (the card takes it), ``refused:<rule>`` (the card
    refuses it by exactly that rule) or nothing (observed only);
  * **map budgets** — the distinct host builds of a block map or a pack
    map (each uploaded once per device: ``RefreshBlockMap.on``,
    ``PackBlockMap.on``), the port's counterpart of an XLA compile, over
    the reference's scenario suite (motion fills x fleet sizes), against
    each contract's ``recompile_budget``;
  * **configs** — every config of ``configs/registry.py``, at full size
    and ``-smoke``, at its serving geometry (the LM's heads and head dim,
    the launcher's default ViT, mamba's state), and served models that
    are not registry configs (``variant_rows``: the JAX quickstart's
    widths, deepseek-7b in f32 at search radius 16, internvl3-14b with 20
    LM heads of 256, with heads of 90 and 75, with LM and ViT heads of
    512, mamba2-2.7b at d_state 256 and 512): which ops the card takes,
    and the rule that refuses the rest.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..configs import CodecCfg, ModelCfg, ViTCfg
from ..configs.registry import all_configs, get_config
from ..core.kvc import WindowLayout, refresh_block_map
from ..core.pruning import (
    PACK_GROUP_QUANTUM, PACK_LEN_BUCKETS, PACK_ROW_QUANTUM, HostDecision, capacity_groups,
    pack_plan,
)
from . import contracts, ops
from .flash_packed import build_pack_map
from .flash_refresh import build_block_map
from .ssd_scan import chunk_count

BF16, F32, F16, I32 = torch.bfloat16, torch.float32, torch.float16, torch.int32
KV_TILE = 128          # AttentionPrefill's cache rounding
PAGE = 128
MAX_NEW_TOKENS = 16


def _meta(shape, dtype=BF16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class AuditRow:
    op: str
    geometry: str
    expect: Optional[str]   # "kernel" | "refused:<rule>" | None (observed)
    decision: str           # registry verdict: "kernel" | "refused:<rule>"
    observed: str           # ops' card_verdicts() on meta tensors
    trace: str              # "ok" | error string

    @property
    def failure(self) -> Optional[str]:
        if self.trace != "ok":
            return f"meta call failed: {self.trace}"
        if self.decision != self.observed:
            return f"registry says {self.decision} but ops recorded {self.observed}"
        if self.expect is not None and self.decision != self.expect:
            return f"expected {self.expect}, registry resolved {self.decision}"
        return None


def _decision_str(dec: contracts.DispatchDecision) -> str:
    return "kernel" if dec.use_kernel else f"refused:{dec.reason}"


def _observed_str(before, after) -> str:
    """The one verdict ``ops`` recorded between two snapshots."""
    for op, counts in after.items():
        for key, n in counts.items():
            if n - before.get(op, {}).get(key, 0) > 0:
                return "kernel" if key == contracts.OK else f"refused:{key}"
    return "none"


def _run_one(op: str, geometry: str, expect: Optional[str], facts: dict,
             call: Callable[[], object], out_shape: Tuple[int, ...]) -> AuditRow:
    decision = _decision_str(contracts.decide(op, facts))
    before = ops.card_verdicts()
    try:
        res = call()
        got = tuple((res[0] if isinstance(res, tuple) else res).shape)
        trace = "ok" if got == tuple(out_shape) else f"shape {got} != {tuple(out_shape)}"
    except Exception as e:  # noqa: BLE001 - any error is a finding
        trace = f"{type(e).__name__}: {e}"
    return AuditRow(op, geometry, expect, decision,
                    _observed_str(before, ops.card_verdicts()), trace)


# ----------------------------------------------------------------------
# the geometry matrix (the reference's CI test and bench configurations)
# ----------------------------------------------------------------------
LAYOUTS: Tuple[Tuple[WindowLayout, Optional[int]], ...] = tuple(
    (WindowLayout(window=w, stride=s, gop=g, g_tokens=gt, k_tokens=kt, query_len=q), sw)
    for (w, s, g, gt, kt, q, sw) in (
        (16, 4, 4, 256, 128, 16, None),
        (16, 8, 8, 256, 128, 16, None),
        (8, 4, 4, 64, 32, 32, None),
        (16, 4, 4, 256, 128, 16, 4096),
        (32, 8, 8, 144, 96, 16, None),
    )
)
ATTN = dict(H=8, Hkv=4, D=64)
BATCHES = (1, 4)
PAGED_FLEETS = (1, 4, 8)


def _slots(lay: WindowLayout) -> int:
    return -(-(lay.total_len + MAX_NEW_TOKENS) // KV_TILE) * KV_TILE


def _refresh_rows() -> List[AuditRow]:
    """Every serving refresh geometry must reach the kernel: that is what
    the KV_TILE cache rounding exists for."""
    rows = []
    H, Hkv, D = ATTN["H"], ATTN["Hkv"], ATTN["D"]
    for lay, sw in LAYOUTS:
        slots = _slots(lay)
        bm = refresh_block_map(lay, window=sw, kv_len=slots)
        for B in BATCHES:
            q, k = _meta((B, bm.n_q, H, D)), _meta((B, slots, Hkv, D))
            q_pos = _meta((B, bm.n_q), I32)
            rows.append(_run_one(
                "flash_refresh",
                f"w{lay.window}s{lay.stride}g{lay.gop} n_q={bm.n_q} kv={slots} sw={sw} B={B}",
                "kernel",
                contracts.flash_refresh_facts(q, k, k, q_pos, None, causal=True, window=sw,
                                              block_map=bm),
                lambda q=q, k=k, p=q_pos, bm=bm, sw=sw: ops.flash_refresh(
                    q, k, k, p, causal=True, window=sw, block_map=bm),
                (B, bm.n_q, H, D)))
    return rows


def _paged_refresh_rows() -> List[AuditRow]:
    """The same layouts on the shared slab (sized for the largest fleet;
    smaller fleets index the same slab), and a 256-row page against the
    128-tile map, which exactly 'page-tile' must refuse."""
    rows = []
    H, Hkv, D = ATTN["H"], ATTN["Hkv"], ATTN["D"]

    def row(geometry, expect, B, bm, slab_rows, pps, page, sw):
        q, k = _meta((B, bm.n_q, H, D)), _meta((slab_rows, Hkv, D))
        q_pos, kvv = _meta((B, bm.n_q), I32), _meta((B, pps * page), torch.bool)
        pt = _meta((B, pps), I32)
        facts = contracts.flash_refresh_paged_facts(q, k, k, q_pos, kvv, pt, page=page,
                                                    causal=True, window=sw, block_map=bm)
        return _run_one("flash_refresh_paged", geometry, expect, facts,
                        lambda: ops.flash_refresh_paged(q, k, k, q_pos, kvv, pt, page=page,
                                                        causal=True, window=sw, block_map=bm),
                        (B, bm.n_q, H, D))

    for lay, sw in LAYOUTS:
        slots = _slots(lay)
        pps = slots // PAGE
        phys = max(PAGED_FLEETS) * pps * PAGE
        bm = refresh_block_map(lay, window=sw, kv_len=slots)
        for B in PAGED_FLEETS:
            rows.append(row(f"w{lay.window}s{lay.stride}g{lay.gop} n_q={bm.n_q} kv={slots} "
                            f"sw={sw} B={B} pages={pps}/{phys // PAGE}", "kernel",
                            B, bm, phys, pps, PAGE, sw))
    big = build_block_map(np.arange(256, dtype=np.int32), 512)
    rows.append(row("page=256 vs tk=128 map", "refused:page-tile", 1, big, 1024, 2, 256, None))
    return rows


def _quant_paged_rows() -> List[AuditRow]:
    """Two-precision slab geometries: mixed hot/cold tables and the
    all-cold steady state reach the fused-dequant kernel; f16 scales and
    a bf16 'cold' slab are refused by exactly 'scale-f32' and
    'cold-dtype'.  Then the paged prefill with a cold group."""
    rows = []
    H, Hkv, D = ATTN["H"], ATTN["Hkv"], ATTN["D"]
    lay, sw = LAYOUTS[0]
    slots = _slots(lay)
    pps = slots // PAGE
    phys = max(PAGED_FLEETS) * pps * PAGE
    bm = refresh_block_map(lay, window=sw, kv_len=slots)
    d_cold = lay.overlap_tokens // PAGE
    fleet = max(PAGED_FLEETS)
    cases = (
        ("mixed-pt", 1, fleet * d_cold, torch.int8, F32, "kernel"),
        ("mixed-pt", 4, fleet * d_cold, torch.int8, F32, "kernel"),
        ("all-cold-pt", 1, fleet * pps, torch.int8, F32, "kernel"),
        ("f16-scales", 1, fleet * d_cold, torch.int8, torch.float16, "refused:scale-f32"),
        ("bf16-cold-slab", 1, fleet * d_cold, BF16, F32, "refused:cold-dtype"),
    )
    for tag, B, n_cold, cdt, sdt, expect in cases:
        q, k = _meta((B, bm.n_q, H, D)), _meta((phys, Hkv, D))
        q_pos, kvv = _meta((B, bm.n_q), I32), _meta((B, slots), torch.bool)
        pt = _meta((B, pps), I32)
        cold = (_meta((n_cold * PAGE, Hkv, D), cdt), _meta((n_cold * PAGE, Hkv, D), cdt),
                _meta((n_cold, Hkv), sdt), _meta((n_cold, Hkv), sdt))
        facts = contracts.flash_refresh_paged_facts(q, k, k, q_pos, kvv, pt, page=PAGE,
                                                    causal=True, window=sw, block_map=bm,
                                                    cold=cold)
        rows.append(_run_one(
            "flash_refresh_paged",
            f"quant {tag} B={B} cold={n_cold}p {str(cdt)[6:]}/scales-{str(sdt)[6:]}", expect,
            facts,
            lambda q=q, k=k, p=q_pos, m=kvv, t=pt, c=cold: ops.flash_refresh_paged(
                q, k, k, p, m, t, page=PAGE, causal=True, window=sw, block_map=bm, cold=c),
            (B, bm.n_q, H, D)))
    q, k, pt = _meta((1, 256, H, D)), _meta((16 * PAGE, Hkv, D)), _meta((1, 2), I32)
    cold = (_meta((4 * PAGE, Hkv, D), torch.int8), _meta((4 * PAGE, Hkv, D), torch.int8),
            _meta((4, Hkv), F32), _meta((4, Hkv), F32))
    facts = contracts.flash_prefill_paged_facts(q, k, k, pt, page=PAGE, causal=True,
                                                window=None, q_offset=0, cold=cold)
    rows.append(_run_one(
        "flash_prefill_paged", "quant B=1 Sq=256 cold=4p int8/scales-float32", "kernel",
        facts, lambda: ops.flash_prefill_paged(q, k, k, pt, page=PAGE, cold=cold),
        (1, 256, H, D)))
    return rows


def _paged_prefill_rows() -> List[AuditRow]:
    """Paged fresh-prefill geometries over slabs of varying occupancy;
    the ragged query length the reference refuses ('q-tile') reaches the
    port's kernel, which masks ragged tiles."""
    rows = []
    H, Hkv, D = ATTN["H"], ATTN["Hkv"], ATTN["D"]
    for B, Sq, pps, phys_pages, sw in ((1, 256, 2, 16, None), (4, 128, 3, 12, None),
                                       (8, 256, 2, 16, 4096), (1, 192, 2, 16, None)):
        q, k, pt = _meta((B, Sq, H, D)), _meta((phys_pages * PAGE, Hkv, D)), _meta((B, pps), I32)
        facts = contracts.flash_prefill_paged_facts(q, k, k, pt, page=PAGE, causal=True,
                                                    window=sw, q_offset=0)
        rows.append(_run_one(
            "flash_prefill_paged", f"B={B} Sq={Sq} pages={pps}/{phys_pages} sw={sw}", "kernel",
            facts, lambda q=q, k=k, pt=pt, sw=sw: ops.flash_prefill_paged(
                q, k, k, pt, page=PAGE, window=sw), (B, Sq, H, D)))
    return rows


def _prefill_rows() -> List[AuditRow]:
    """The reference's f32 prefill rows and their bf16 twins, ragged
    lengths included, which reach the kernel (f32 q/k/v as bf16 halves),
    an f16 row, which reaches the f16 build, and a query of every other
    type over bf16, f16 and f32 K/V (MIXED_PAIRS), which reach the builds
    of K/V's type."""
    rows = []
    H, Hkv, D = ATTN["H"], ATTN["Hkv"], ATTN["D"]
    for B, Sq, Sk, sw in ((2, 256, 256, None), (1, 512, 512, 4096), (1, 128, 384, None),
                          (1, 192, 256, None), (1, 256, 200, None)):
        for dt, kv_dt, expect in ((F32, F32, "kernel"), (BF16, BF16, "kernel")) + (
                ((F16, F16, "kernel"),) + tuple((q_dt, k_dt, "kernel")
                                              for q_dt, k_dt in MIXED_PAIRS)
                if Sq == 192 else ()):
            q, k = _meta((B, Sq, H, D), dt), _meta((B, Sk, Hkv, D), kv_dt)
            facts = contracts.flash_prefill_facts(q, k, k, causal=True, window=sw, q_offset=0)
            kind = str(dt)[6:] if dt == kv_dt else f"{str(dt)[6:]} q over {str(kv_dt)[6:]} k/v"
            rows.append(_run_one(
                "flash_prefill", f"B={B} Sq={Sq} Sk={Sk} sw={sw} {kind}", expect, facts,
                lambda q=q, k=k, sw=sw: ops.flash_prefill(q, k, k, window=sw), (B, Sq, H, D)))
    return rows


def _width_rows() -> List[AuditRow]:
    """Head dims the kernels' ragged builds take (the JAX quickstart's 16,
    SigLIP's 72, Qwen2-VL's ViT's 80, 136 and 192 on the WIDE D-256
    build; 20, 90 and a ViT's 75, which are not multiples of 8; 320, 500
    and 300 on the SLAB D-512 one; 520, 1000, 1023 and 1024 on the DEEP
    one), the exact 256 (Gemma 2's heads) and 512, with bf16 and f32
    queries over a bf16 slab, f32 and f16 q/k/v in the packed ViT, and a
    query of every other type over bf16, f16 and f32 K/V there
    (MIXED_PAIRS), which reach the builds of K/V's type."""
    rows = []
    lay, sw = LAYOUTS[2]
    slots = _slots(lay)
    bm = refresh_block_map(lay, window=sw, kv_len=slots)
    B, H, Hkv = 2, 8, 2
    for D, dt, expect in ((16, BF16, "kernel"), (72, F32, "kernel"), (80, BF16, "kernel"),
                          (136, BF16, "kernel"), (256, BF16, "kernel"), (192, F32, "kernel"),
                          (90, BF16, "kernel"), (320, BF16, "kernel"), (512, BF16, "kernel"),
                          (500, F32, "kernel"), (520, BF16, "kernel"), (1023, F32, "kernel"),
                          (1024, BF16, "kernel"), (20, F32, "kernel")):
        q, k = _meta((B, bm.n_q, H, D), dt), _meta((B * slots, Hkv, D))
        q_pos, kvv = _meta((B, bm.n_q), I32), _meta((B, slots), torch.bool)
        pt = _meta((B, slots // PAGE), I32)
        rows.append(_run_one(
            "flash_refresh_paged", f"D {D} q {str(dt)[6:]} over a bf16 slab", expect,
            contracts.flash_refresh_paged_facts(q, k, k, q_pos, kvv, pt, page=PAGE, causal=True,
                                                window=sw, block_map=bm),
            lambda q=q, k=k, p=q_pos, m=kvv, t=pt: ops.flash_refresh_paged(
                q, k, k, p, m, t, page=PAGE, causal=True, window=sw, block_map=bm),
            (B, bm.n_q, H, D)))
    plan = pack_plan(synthetic_decision(ViTCfg(), 12, 64, 0.5, seed=3), ViTCfg(), tile=128)
    R, L = plan.seg_id.shape
    for D, dt, kv_dt, expect in (
            (16, F32, F32, "kernel"), (72, F32, F32, "kernel"), (256, F32, F32, "kernel"),
            (75, BF16, BF16, "kernel"), (512, BF16, BF16, "kernel"), (300, F32, F32, "kernel"),
            (1024, BF16, BF16, "kernel"), (1000, F32, F32, "kernel"), (64, F16, F16, "kernel"),
            (90, F16, F16, "kernel"), (1024, F16, F16, "kernel"),
            *((64, q_dt, k_dt, "kernel") for q_dt, k_dt in MIXED_PAIRS)):
        q, k, seg = _meta((R, L, 4, D), dt), _meta((R, L, 4, D), kv_dt), _meta((R, L), I32)
        kind = (f"{str(dt)[6:]} q/k/v" if dt == kv_dt
                else f"{str(dt)[6:]} q over {str(kv_dt)[6:]} k/v")
        rows.append(_run_one(
            "flash_packed", f"ViT D {D} {kind}, rows={R} L={L}", expect,
            contracts.flash_packed_facts(q, k, k, seg, plan.block_map),
            lambda q=q, k=k, seg=seg: ops.flash_packed(q, k, k, seg, plan.block_map),
            (R, L, 4, D)))
    return rows


def synthetic_decision(v: ViTCfg, n_frames: int, k_groups: int, fill: float,
                       seed: int) -> HostDecision:
    """A host decision keeping ``fill`` of ``k_groups`` per frame."""
    rng = np.random.default_rng(seed)
    g2 = v.group * v.group
    gi = np.zeros((n_frames, k_groups), np.int64)
    gv = np.zeros((n_frames, k_groups), bool)
    for t in range(n_frames):
        gi[t] = np.sort(rng.choice(v.n_groups, size=k_groups, replace=False))
        gv[t, :max(1, int(round(fill * k_groups)))] = True
    pi = (np.repeat(gi, g2, axis=1) * g2
          + np.tile(np.arange(g2, dtype=np.int64), (n_frames, k_groups)))
    return HostDecision(gv, pi)


PACK_SCENARIOS: Tuple[Tuple[int, int, float], ...] = (
    # (P-frames in the fused batch, k_groups capacity, kept fill)
    (12, 128, 0.10), (12, 128, 0.50), (12, 128, 1.00),
    (24, 128, 0.30), (48, 64, 0.75), (6, 32, 0.20),
)


def _packed_rows() -> List[AuditRow]:
    """Every pack_plan bucket geometry must reach the kernel: the buckets
    are tile multiples and every frame one run, by construction."""
    rows = []
    v = ViTCfg()
    H, D = 8, 64
    for i, (nf, kg, fill) in enumerate(PACK_SCENARIOS):
        plan = pack_plan(synthetic_decision(v, nf, kg, fill, seed=100 + i), v, tile=128)
        bm = plan.block_map
        R, L = plan.seg_id.shape
        q, seg = _meta((R, L, H, D)), _meta((R, L), I32)
        rows.append(_run_one(
            "flash_packed", f"frames={nf} kg={kg} fill={fill:.2f} rows={R} L={L}", "kernel",
            contracts.flash_packed_facts(q, q, q, seg, bm),
            lambda q=q, seg=seg, bm=bm: ops.flash_packed(q, q, q, seg, bm), (R, L, H, D)))
        assert L in PACK_LEN_BUCKETS, (L, PACK_LEN_BUCKETS)
    split = np.array([[0] * 50 + [1] * 30 + [0] * 48], np.int32)   # segment 0 in two runs
    q, seg = _meta((1, 128, H, D)), _meta((1, 128), I32)
    bm = build_pack_map(split)
    rows.append(_run_one("flash_packed", "segment split in two runs of its row",
                         "refused:single-run", contracts.flash_packed_facts(q, q, q, seg, bm),
                         lambda: ops.flash_packed(q, q, q, seg, bm), (1, 128, H, D)))
    return rows


def _slab_rows() -> List[AuditRow]:
    """rope_shift over the layouts' overlap slabs (any S reaches the
    kernel) and at head dim 90 (an odd half), mv_sad at radius 4, 16 and
    32 and blocks 16, 8, 12 and 6, and past one band's 227 KB of shared
    memory (the tiled kernel) at radius 128, block 64 at radius 96 and
    block 240 at radius 1, and ssd_scan: the reference's f32 row with N
    32 and its bf16 twin, the JAX benchmarks' f32 row (1, 1024, 8, 64) at
    N 16, the serving row of mamba2-2.7b (N 128) in bf16 and in f32, N
    136 and 264 staged on the slabbed build, N 512 in place on it, and f16
    x / b / c (staged as bf16 halves, which hold f16 exactly), all on the
    kernel."""
    rows = []
    for lay, _ in LAYOUTS:
        S = lay.overlap_tokens
        if S == 0:
            continue
        k, delta = _meta((1, S, 4, 64)), _meta((1, S), I32)
        rows.append(_run_one("rope_shift", f"w{lay.window}s{lay.stride} overlap={S}", "kernel",
                             contracts.rope_shift_facts(k, delta),
                             lambda k=k, d=delta: ops.rope_shift(k, d), (1, S, 4, 64)))
    k, delta = _meta((1, 40, 8, 90)), _meta((1, 40), I32)
    rows.append(_run_one("rope_shift", "D 90 (half 45)", "kernel",
                         contracts.rope_shift_facts(k, delta),
                         lambda: ops.rope_shift(k, delta), (1, 40, 8, 90)))
    cur = _meta((240, 240), F32)
    for block, radius, expect in ((16, 4, "kernel"), (16, 16, "kernel"), (16, 32, "kernel"),
                                  (8, 16, "kernel"), (12, 32, "kernel"), (6, 1, "kernel"),
                                  (16, 128, "kernel"), (48, 96, "kernel"), (240, 1, "kernel")):
        n = 240 // block
        rows.append(_run_one("mv_sad", f"240x240 b{block} r{radius}", expect,
                             contracts.mv_sad_facts(cur, cur, block=block, radius=radius),
                             lambda b=block, r=radius: ops.mv_sad(cur, cur, b, r), (n, n, 2)))
    for label, dt, (Bn, L, H, P, G, N), expect in SSD_AUDIT_ROWS:
        x, la = _meta((Bn, L, H, P), dt), _meta((Bn, L, H), F32)
        bc = _meta((Bn, L, G, N), dt)
        rows.append(_run_one("ssd_scan", label, expect,
                             contracts.ssd_scan_facts(x, la, bc, bc, chunk=128),
                             lambda x=x, la=la, bc=bc: ops.ssd_scan(x, la, bc, bc),
                             (Bn, L, H, P)))
    return rows


# ssd_scan's rows of the audit's third table: (label, dtype of x / b / c,
# (B, L, H, P, G, N), expected), chunk 128
SSD_AUDIT_ROWS = (
    ("B2 L100 H8 G2 N32 f32", F32, (2, 100, 8, 64, 2, 32), "kernel"),
    ("B2 L100 H8 G2 N32 bf16", BF16, (2, 100, 8, 64, 2, 32), "kernel"),
    ("B1 L1024 H8 P64 N16 f32 (the JAX benchmarks' row)", F32, (1, 1024, 8, 64, 1, 16),
     "kernel"),
    ("B2 L160 H80 P64 N128 bf16 (mamba2-2.7b)", BF16, (2, 160, 80, 64, 1, 128), "kernel"),
    ("B2 L160 H80 P64 N128 f32 (mamba2-2.7b, dtype f32)", F32, (2, 160, 80, 64, 1, 128),
     "kernel"),
    ("B2 L100 H8 G2 N136 bf16", BF16, (2, 100, 8, 64, 2, 136), "kernel"),
    ("B2 L100 H8 G2 N264 bf16", BF16, (2, 100, 8, 64, 2, 264), "kernel"),
    ("B2 L160 H80 P64 N512 bf16 (mamba2-2.7b at d_state 512)", BF16, (2, 160, 80, 64, 1, 512),
     "kernel"),
    ("B2 L100 H8 G2 N32 f16", F16, (2, 100, 8, 64, 2, 32), "kernel"),
    ("B2 L160 H80 P64 N128 f16 (mamba2-2.7b's widths)", F16, (2, 160, 80, 64, 1, 128), "kernel"),
)


def run_audit() -> Tuple[List[AuditRow], List[str]]:
    """(all rows, failure strings) of the dispatch coverage matrix."""
    rows = (_refresh_rows() + _paged_refresh_rows() + _quant_paged_rows() + _packed_rows()
            + _prefill_rows() + _paged_prefill_rows() + _width_rows() + _slab_rows())
    return rows, [f"{r.op} [{r.geometry}]: {r.failure}" for r in rows if r.failure]


def coverage_table(rows: Sequence[AuditRow]) -> str:
    """Markdown table: what the registry and ``ops`` decide per geometry."""
    lines = ["| kernel | geometry | expected | registry | ops (meta) | call |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(f"| {r.op} | {r.geometry} | {r.expect or '—'} | {r.decision} | "
                     f"{r.observed} | {'ok' if r.trace == 'ok' else 'FAIL'} |")
    refused = sum(1 for r in rows if r.expect == "kernel" and r.decision != "kernel")
    lines += ["", f"{len(rows)} geometries audited; {refused} that must reach the kernel "
              "refused."]
    return "\n".join(lines)


# ----------------------------------------------------------------------
# map budgets
# ----------------------------------------------------------------------
@dataclasses.dataclass
class BudgetResult:
    op: str
    scenarios: int
    distinct_keys: int
    budget: int
    keys: List[tuple]

    @property
    def ok(self) -> bool:
        return self.distinct_keys <= self.budget

    def render(self) -> str:
        return (f"{self.op}: {self.distinct_keys} distinct map keys over {self.scenarios} "
                f"scenarios (budget {self.budget}) — {'ok' if self.ok else 'OVER BUDGET'}")


MOTION_FILLS: Tuple[float, ...] = (0.05, 0.15, 0.30, 0.50, 0.75, 1.00)
FLEET_SIZES: Tuple[int, ...] = (1, 2, 4, 8)
P_FRAMES_PER_WINDOW = 12  # 16-frame window, gop 4 -> 12 P-frames
K_GROUPS = 128


def audit_packed() -> BudgetResult:
    """Distinct pack maps over the suite: (rows, l_pack, k_pack, t_max,
    tq, tk), everything ``pack_plan`` quantizes."""
    v = ViTCfg()
    keys: Set[tuple] = set()
    n = 0
    for fleet in FLEET_SIZES:
        for i, fill in enumerate(MOTION_FILLS):
            for rep in range(3):      # repeated windows, fresh packing noise
                plan = pack_plan(synthetic_decision(v, fleet * P_FRAMES_PER_WINDOW, K_GROUPS,
                                                    fill, seed=1000 + 100 * i + 10 * rep + fleet),
                                 v, tile=128)
                bm = plan.block_map
                keys.add((plan.seg_id.shape[0], plan.l_pack, plan.group_src.shape[0],
                          bm.t_max, bm.tq, bm.tk))
                n += 1
                assert plan.l_pack in PACK_LEN_BUCKETS
                assert plan.seg_id.shape[0] % PACK_ROW_QUANTUM == 0
                assert plan.group_src.shape[0] % PACK_GROUP_QUANTUM == 0
    return BudgetResult("flash_packed", n, len(keys),
                        contracts.FLASH_PACKED.recompile_budget, sorted(keys, key=repr))


def audit_refresh(op: str = "flash_refresh") -> BudgetResult:
    """Distinct refresh maps over (layout, fleet size, repeated window):
    the map is keyed by the layout alone (the batch and the page table
    are launch arguments), so at most one per layout."""
    keys: Set[tuple] = set()
    n = 0
    for lay, sw in LAYOUTS:
        for _fleet in FLEET_SIZES:
            for _rep in range(3):     # steady-state windows: same key
                bm = refresh_block_map(lay, window=sw, kv_len=_slots(lay))
                keys.add((bm.q_pos.shape[0], bm.kv_len, bm.causal, bm.window, bm.tq, bm.tk,
                          bm.t_max))
                n += 1
    res = BudgetResult(op, n, len(keys), contracts.contract(op).recompile_budget,
                       sorted(keys, key=repr))
    assert res.distinct_keys <= len(LAYOUTS), (res.distinct_keys, len(LAYOUTS))
    return res


def run_budgets() -> Tuple[List[BudgetResult], List[str]]:
    results = [audit_packed(), audit_refresh("flash_refresh"),
               audit_refresh("flash_refresh_paged")]
    return results, [r.render() for r in results if not r.ok]


# ----------------------------------------------------------------------
# the configs at their serving geometry
# ----------------------------------------------------------------------
@dataclasses.dataclass
class ConfigRow:
    arch: str
    op: str
    geometry: str
    verdict: str      # "kernel" | "refused:<rule>"


def _serving_vit(cfg) -> ViTCfg:
    return cfg.vit or ViTCfg(n_layers=2, d_model=128, n_heads=4, d_ff=256, patch=14,
                             image=112, group=2)     # launch.serve.default_vit


def config_rows(archs: Optional[Sequence[str]] = None, streams: int = 2) -> List[ConfigRow]:
    """Each config's kernel calls at its serving geometry (codecflow, the
    launcher's codec: gop 4, window 16, stride 4, keep 0.5), decided by
    the registry on meta tensors."""
    archs = archs or [a + s for a in all_configs() for s in ("", "-smoke")]
    out: List[ConfigRow] = []
    for arch in archs:
        cfg = get_config(arch)
        out += _serving_calls(arch, cfg, _serving_vit(cfg), SERVING_CODEC, streams)
    return out


SERVING_CODEC = CodecCfg(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)


# internvl3-14b re-cut to 20 LM heads of 256 over 4 kv heads (chip_smoke
# phase 7(g)): d_model, the GQA group of 5, the parameters and the KV
# bytes per stream stay those of its 40 heads of 128 over 8
WIDE_HEADS = dict(n_heads=20, n_kv=4, d_head=256)
# mamba2-2.7b's SSD state widened to 256 (chip_smoke phases 7(h), 8(g))
WIDE_STATE = 256
# internvl3-14b's LM heads re-cut to 90 wide (bf16 rows 4-byte aligned,
# int8 cold rows 2-byte aligned, rope_shift at an odd half of 45), its
# ViT's to 75 (odd) at the same head count, its codec to search radius
# 128 (a 272^2 band at block 16, past one block's shared memory):
# chip_smoke phase 7(i)
ODD_HEAD, ODD_VIT_HEAD, WIDE_RADIUS = 90, 75, 128
# mamba2-2.7b's SSD state widened to 512: four column slabs of 128
# (chip_smoke phases 7(j), 8(h))
WIDER_STATE = 512
# internvl3-14b re-cut to 10 LM heads of 512 over 2 kv heads and its ViT
# (InternViT, d_model 1024) to 2 heads of 512 (chip_smoke phase 7(k):
# the attention kernels' D-512 build): d_model, the GQA group of 5, the
# parameters, the KV bytes per stream and the attention FLOPs stay those
# of its 40 heads of 128 over 8 and its ViT's 16 heads of 64
HEADS_512 = dict(n_heads=10, n_kv=2, d_head=512)
VIT_HEADS_512 = 2
# ... and to 5 LM heads of 1024 over 1 kv head and its ViT to 1 head of
# 1024 (chip_smoke phase 7(l): the DEEP build, Q K^T over four depth
# chunks, four column slabs of V and O): the same parameters, KV bytes
# per stream, attention FLOPs and GQA group of 5
HEADS_1024 = dict(n_heads=5, n_kv=1, d_head=1024)
VIT_HEADS_1024 = 1


def odd_heads(cfg: ModelCfg) -> ModelCfg:
    """``cfg`` with LM heads of ``ODD_HEAD`` and ViT heads of
    ``ODD_VIT_HEAD`` (its d_model re-cut to keep its head count), as
    phase 7(i) serves internvl3-14b and the CPU tests its smoke."""
    return dataclasses.replace(cfg, d_head=ODD_HEAD, vit=dataclasses.replace(
        cfg.vit, d_model=cfg.vit.n_heads * ODD_VIT_HEAD))


def heads_512(cfg: ModelCfg) -> ModelCfg:
    """``cfg`` with LM heads of 512 (``HEADS_512``) and its ViT re-cut to
    ``VIT_HEADS_512`` heads at its own d_model, as phase 7(k) serves
    internvl3-14b."""
    return dataclasses.replace(cfg, **HEADS_512, vit=dataclasses.replace(
        cfg.vit, n_heads=VIT_HEADS_512))


def heads_1024(cfg: ModelCfg) -> ModelCfg:
    """``cfg`` with LM heads of 1024 (``HEADS_1024``) and its ViT re-cut
    to ``VIT_HEADS_1024`` head at its own d_model, as phase 7(l) serves
    internvl3-14b."""
    return dataclasses.replace(cfg, **HEADS_1024, vit=dataclasses.replace(
        cfg.vit, n_heads=VIT_HEADS_1024))


def with_state(cfg: ModelCfg, d_state: int) -> ModelCfg:
    """``cfg`` with its SSD state widened to ``d_state``."""
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, d_state=d_state))


def variant_rows(streams: int = 2) -> List[ConfigRow]:
    """Served models that are not registry configs: the JAX
    quickstart's (LM 4 heads of 16 over 2 kv heads, ViT 4 heads of 16;
    examples/quickstart.py), deepseek-7b in f32 ingested at search
    radius 16 (chip_smoke phase 7(e)), internvl3-14b with LM heads of
    256 (``WIDE_HEADS``; its ViT keeps InternViT's 16 heads of 64:
    chip_smoke phase 7(g)), internvl3-14b with LM heads of 90, ViT heads
    of 75 and search radius 128 (``odd_heads``: phase 7(i)),
    internvl3-14b with LM and ViT heads of 512 (``heads_512``: phase
    7(k)) and of 1024 (``heads_1024``: phase 7(l)), and mamba2-2.7b with an SSD state of 256 and of 512
    (``WIDE_STATE``, ``WIDER_STATE``: phases 7(h), 7(j))."""
    qs = ModelCfg(name="demo", family="vlm", n_layers=2, d_model=64, n_heads=4, n_kv=2,
                  d_ff=128, vocab=64, tied_embeddings=True)
    qv = ViTCfg(n_layers=2, d_model=64, n_heads=4, d_ff=128, patch=14, image=112, group=2)
    ds = dataclasses.replace(get_config("deepseek-7b"), dtype="float32")
    wide = dataclasses.replace(get_config("internvl3-14b"), **WIDE_HEADS)
    m2 = get_config("mamba2-2.7b")
    odd = odd_heads(get_config("internvl3-14b"))
    h512 = heads_512(get_config("internvl3-14b"))
    h1024 = heads_1024(get_config("internvl3-14b"))
    return (_serving_calls("quickstart (JAX widths)", qs, qv,
                           CodecCfg(gop=4, window_frames=8, stride_frames=4, keep_ratio=0.4),
                           streams)
            + _serving_calls("deepseek-7b f32, radius 16", ds, _serving_vit(ds),
                             dataclasses.replace(SERVING_CODEC, search_radius=16), streams)
            + _serving_calls("internvl3-14b, 20 heads of 256", wide, _serving_vit(wide),
                             SERVING_CODEC, streams)
            + _serving_calls("internvl3-14b, heads of 90 and 75, radius 128", odd, odd.vit,
                             dataclasses.replace(SERVING_CODEC, search_radius=WIDE_RADIUS),
                             streams)
            + _serving_calls("internvl3-14b, LM and ViT heads of 512", h512, h512.vit,
                             SERVING_CODEC, streams)
            + _serving_calls("internvl3-14b, LM and ViT heads of 1024", h1024, h1024.vit,
                             SERVING_CODEC, streams)
            + sum((_serving_calls(f"mamba2-2.7b, d_state {n}", with_state(m2, n),
                                  _serving_vit(m2), SERVING_CODEC, streams)
                   for n in (WIDE_STATE, WIDER_STATE)), []))


# the (q, K/V) dtype pairs the attention kernels take besides q in K/V's
# type: every q over bf16 and f16 K/V, and (flash_packed, flash_prefill)
# over f32 K/V
MIXED_PAIRS = ((F16, BF16), (BF16, F16), (F32, F16), (BF16, F32), (F16, F32))
CACHE_PAIRS = MIXED_PAIRS[:3]        # the cache kernels' (their K/V are not f32)


def mixed_rows(streams: int = 2) -> List[ConfigRow]:
    """Each attention op at internvl3-14b's serving geometry (LM H 40 /
    Hkv 8, D 128; the ViT's H 16, D 64) with a query of another type than
    its K/V: every pair of MIXED_PAIRS the op takes (CACHE_PAIRS in the
    cache kernels)."""
    cfg = get_config("internvl3-14b")
    v = _serving_vit(cfg)
    codec = SERVING_CODEC
    lay = WindowLayout(window=codec.window_frames, stride=codec.stride_frames, gop=codec.gop,
                       g_tokens=v.n_groups, k_tokens=capacity_groups(v, codec.keep_ratio),
                       query_len=16)
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    slots = _slots(lay)
    bm = refresh_block_map(lay, kv_len=slots)
    q_pos, kvv = _meta((streams, bm.n_q), I32), _meta((streams, slots), torch.bool)
    pt = _meta((streams, slots // PAGE), I32)
    i8 = _meta((PAGE, Hkv, D), torch.int8)
    scales = _meta((1, Hkv), F32)
    vd, L = v.d_model // v.n_heads, 128
    seg = _meta((2, L), I32)
    out: List[ConfigRow] = []
    for q_dt, k_dt in MIXED_PAIRS:
        name = f"q {str(q_dt)[6:]} over {str(k_dt)[6:]} K/V"
        arch = "internvl3-14b, q and K/V of two types"
        q = _meta((streams, bm.n_q, H, D), q_dt)
        k, slab = _meta((streams, slots, Hkv, D), k_dt), _meta((streams * slots, Hkv, D), k_dt)
        qv, kv = _meta((2, L, v.n_heads, vd), q_dt), _meta((2, L, v.n_heads, vd), k_dt)
        calls = {"flash_packed": contracts.flash_packed_facts(
            qv, kv, kv, seg, build_pack_map(np.zeros((2, L), np.int32))),
                 "flash_prefill": contracts.flash_prefill_facts(
            q, k, k, causal=True, window=None, q_offset=0)}
        if (q_dt, k_dt) in CACHE_PAIRS:
            calls.update({
                "flash_refresh": contracts.flash_refresh_facts(
                    q, k, k, q_pos, None, causal=True, window=None, block_map=bm),
                "flash_refresh_paged": contracts.flash_refresh_paged_facts(
                    q, slab, slab, q_pos, kvv, pt, page=PAGE, causal=True, window=None,
                    block_map=bm),
                "flash_refresh_paged_int8": contracts.flash_refresh_paged_facts(
                    q, slab, slab, q_pos, kvv, pt, page=PAGE, causal=True, window=None,
                    block_map=bm, cold=(i8, i8, scales, scales)),
                "flash_prefill_paged": contracts.flash_prefill_paged_facts(
                    q, slab, slab, pt, page=PAGE, causal=True, window=None, q_offset=0),
                "flash_prefill_paged_int8": contracts.flash_prefill_paged_facts(
                    q, slab, slab, pt, page=PAGE, causal=True, window=None, q_offset=0,
                    cold=(i8, i8, scales, scales))})
        for op, facts in calls.items():
            contract = op.replace("_int8", "")
            geo = (f"ViT H {v.n_heads}, D {vd}, {name}" if op == "flash_packed"
                   else f"H {H} / Hkv {Hkv}, D {D}, {name}")
            out.append(ConfigRow(arch, op, geo, _decision_str(contracts.decide(contract, facts))))
    return out


def _serving_calls(arch: str, cfg, v: ViTCfg, codec: CodecCfg, streams: int) -> List[ConfigRow]:
    lay = WindowLayout(window=codec.window_frames, stride=codec.stride_frames,
                       gop=codec.gop, g_tokens=v.n_groups,
                       k_tokens=capacity_groups(v, codec.keep_ratio), query_len=16)
    dt = BF16 if cfg.dtype == "bfloat16" else F32
    out: List[ConfigRow] = []

    def add(op, geometry, dec):
        out.append(ConfigRow(arch, op, geometry, _decision_str(dec)))

    cur = _meta((v.image, v.image), F32)
    add("mv_sad", f"{v.image}^2 b{codec.block} r{codec.search_radius}",
        contracts.decide("mv_sad", contracts.mv_sad_facts(
            cur, cur, block=codec.block, radius=codec.search_radius)))
    vd = v.d_model // v.n_heads
    L = 128
    q, seg = _meta((2, L, v.n_heads, vd), BF16), _meta((2, L), I32)
    add("flash_packed", f"ViT H {v.n_heads} D {vd}", contracts.decide(
        "flash_packed", contracts.flash_packed_facts(
            q, q, q, seg, build_pack_map(np.zeros((2, L), np.int32)))))
    mixers = {cfg.block_kind(p)[0] for p in range(cfg.period)}
    if "attn" in mixers:
        H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
        slots = _slots(lay)
        bm = refresh_block_map(lay, kv_len=slots)
        q = _meta((streams, bm.n_q, H, D), dt)
        q_pos = _meta((streams, bm.n_q), I32)
        geo = f"H {H} / Hkv {Hkv}, D {D}, q {str(dt)[6:]} over bf16 K/V"
        add("flash_refresh", geo, contracts.decide("flash_refresh", contracts.flash_refresh_facts(
            q, _meta((streams, slots, Hkv, D)), _meta((streams, slots, Hkv, D)),
            q_pos, None, causal=True, window=None, block_map=bm)))
        if "mamba" not in mixers:
            k = _meta((streams * slots, Hkv, D))
            pt = _meta((streams, slots // PAGE), I32)
            kvv = _meta((streams, slots), torch.bool)
            add("flash_refresh_paged", geo, contracts.decide(
                "flash_refresh_paged", contracts.flash_refresh_paged_facts(
                    q, k, k, q_pos, kvv, pt, page=PAGE, causal=True, window=None,
                    block_map=bm)))
            kr = _meta((streams, lay.overlap_tokens, Hkv, D))
            add("rope_shift", f"Hkv {Hkv}, D {D}, bfloat16", contracts.decide(
                "rope_shift", contracts.rope_shift_facts(
                    kr, _meta((streams, lay.overlap_tokens), I32))))
    if "mamba" in mixers:
        s = cfg.ssm
        Hs, P, N = s.n_heads(cfg.d_model), s.head_dim, s.d_state
        x = _meta((streams, 40, Hs, P), dt)
        bc = _meta((streams, 40, s.n_groups, N), dt)
        add("ssd_scan", f"H {Hs}, P {P}, N {N}, chunk {s.chunk}, {str(dt)[6:]}",
            contracts.decide("ssd_scan", contracts.ssd_scan_facts(
                x, _meta((streams, 40, Hs), F32), bc, bc, chunk=s.chunk,
                init_state=_meta((streams, Hs, P, N), F32))))
    return out


def config_table(rows: Sequence[ConfigRow]) -> str:
    lines = ["| config | op | serving geometry | card |", "|---|---|---|---|"]
    lines += [f"| {r.arch} | {r.op} | {r.geometry} | {r.verdict} |" for r in rows]
    refused = [r for r in rows if r.verdict != "kernel"]
    lines += ["", f"{len(rows)} serving calls over {len({r.arch for r in rows})} configs; "
              f"{len(refused)} refused by the card."]
    return "\n".join(lines)


# ----------------------------------------------------------------------
# calls that provoke each eligibility rule, and calls at serving widths
# ----------------------------------------------------------------------
# rules no call of ``ops`` reaches first: a map built for another query
# count fails the 'positions-match' precondition (it compares the count)
SHADOWED = {("flash_refresh", "map-n-q"), ("flash_refresh_paged", "map-n-q")}


def refusal_cases(device) -> dict:
    """One call per eligibility rule of every contract (but ``SHADOWED``)
    that fails that rule first, on ``device``: {(contract, code): (op,
    call, plain)}, ``op`` the name ``ops`` counts it by, ``plain()`` the
    plain version on the same operands (``ssd_scan`` has no eligibility
    rule: it takes every operand the reference's scan takes).  Values come
    from seeded generators; views the rules look at (misaligned, strided,
    transposed) are made on ``device`` itself."""
    from .flash_packed import PackBlockMap, flash_packed_plain
    from .flash_prefill import flash_prefill_paged_plain, flash_prefill_plain
    from .flash_refresh import flash_refresh_paged_plain, flash_refresh_plain
    from .rope_shift import rope_shift_plain
    dev = torch.device(device)

    def rand(*shape, dtype=F32, seed=0):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(*shape, generator=g).to(dtype).to(dev)

    def misaligned(shape, dtype=F32):
        """Contiguous, one element past a 16-byte boundary."""
        n = int(np.prod(shape))
        out = torch.zeros(n + 1, dtype=dtype, device=dev)[1:].view(shape)
        return out.copy_(rand(*shape, dtype=dtype, seed=5))

    def ints(rows):
        return torch.tensor(rows, dtype=I32, device=dev)

    def rope(k):
        d = torch.arange(k.shape[1], device=dev)[None]
        return "rope_shift", (lambda: ops.rope_shift(k, d)), (lambda: rope_shift_plain(k, d))

    def prefill(q, k):
        return "flash_prefill", (lambda: ops.flash_prefill(q, k, k)), (
            lambda: flash_prefill_plain(q, k, k))

    def prefill_paged(q, slab, page=PAGE, cold=None):
        pt = ints([[1, 0]] if page == PAGE else [[3, 1]])
        op = "flash_prefill_paged" if cold is None else "flash_prefill_paged_int8"
        return op, (lambda: ops.flash_prefill_paged(q, slab, slab, pt, page=page, cold=cold)), (
            lambda: flash_prefill_paged_plain(q, slab, slab, pt, page=page, cold=cold))

    pos = [3, 4, 5, 6]

    def refresh(q, k, bm=None):
        qp = ints([pos])
        return "flash_refresh", (lambda: ops.flash_refresh(q, k, k, qp, block_map=bm)), (
            lambda: flash_refresh_plain(q, k, k, qp))

    def refresh_paged(q, slab, pt, kvv_len, bm, page=PAGE, cold=None):
        qp = torch.arange(3, 3 + q.shape[1], dtype=I32, device=dev)[None]
        kvv = torch.ones(1, kvv_len, dtype=torch.bool, device=dev)
        pt = ints(pt)
        kw = dict(page=page, cold=cold)
        op = "flash_refresh_paged" if cold is None else "flash_refresh_paged_int8"
        return op, (lambda: ops.flash_refresh_paged(q, slab, slab, qp, kvv, pt, block_map=bm,
                                                    **kw)), (
            lambda: flash_refresh_paged_plain(q, slab, slab, qp, kvv, pt, **kw))

    def packed(q, seg, bm, kv=None):
        kv = q if kv is None else kv
        return "flash_packed", (lambda: ops.flash_packed(q, kv, kv, seg, bm)), (
            lambda: flash_packed_plain(q, kv, kv, seg))

    def pack_map(seg, tq=contracts.TILE, tk=contracts.TILE, tile_ids=None, tile_count=None):
        good = build_pack_map(seg)
        return PackBlockMap(tq, tk, good.tile_ids if tile_ids is None else tile_ids,
                            good.tile_count if tile_count is None else tile_count,
                            good.seg_id, good.span, good.single_run)

    def transposed(t, a, b):
        """``t``'s values in a layout with dims a and b swapped in memory."""
        return t.transpose(a, b).contiguous().transpose(a, b)

    seg_np = np.repeat(np.arange(2, dtype=np.int32), 64)[None]
    seg = torch.from_numpy(seg_np).to(dev)
    split = np.array([[0] * 50 + [1] * 30 + [0] * 48], np.int32)
    pq = rand(1, 128, 4, 32, dtype=BF16)
    q4 = rand(1, 4, 4, 32, dtype=BF16)
    k128 = rand(1, 128, 2, 32, dtype=BF16, seed=1)
    slab = rand(256, 2, 32, dtype=BF16, seed=1)
    i8 = (torch.zeros(128, 2, 32, dtype=torch.int8, device=dev),) * 2
    ones = torch.ones(1, 2, device=dev)
    f16 = (torch.ones(1, 2, dtype=torch.float16, device=dev),) * 2
    q8, k8 = rand(1, 8, 4, 32, dtype=BF16), rand(1, 8, 2, 32, dtype=BF16, seed=1)
    return {
        ("rope_shift", "aligned"): rope(misaligned((1, 8, 2, 16))),
        ("flash_prefill", "contiguous"): prefill(transposed(q8, 1, 2), k8),
        ("flash_prefill", "aligned"): prefill(misaligned((1, 8, 4, 32), BF16), k8),
        ("flash_prefill_paged", "page-tile"): prefill_paged(q8, slab, page=64),
        ("flash_prefill_paged", "cold-dtype"): prefill_paged(
            q8, slab[:128], cold=(slab[128:].float(), slab[128:].float(), ones, ones)),
        ("flash_prefill_paged", "scale-f32"): prefill_paged(q8, slab[:128], cold=i8 + f16),
        ("flash_prefill_paged", "kernel-dtype"): prefill_paged(q8.float(), slab.float()),
        ("flash_prefill_paged", "contiguous"): prefill_paged(transposed(q8, 1, 2), slab),
        ("flash_prefill_paged", "aligned"): prefill_paged(misaligned((1, 8, 4, 32), BF16),
                                                          slab),
        ("flash_refresh", "map-present"): refresh(q4, k128),
        ("flash_refresh", "map-kv-len"): refresh(q4, k128, build_block_map(pos, 256)),
        ("flash_refresh", "k-tile"): refresh(q4, k128[:, :100], build_block_map(pos, 100)),
        ("flash_refresh", "map-causal"): refresh(q4, k128, build_block_map(pos, 128,
                                                                          causal=False)),
        ("flash_refresh", "map-window"): refresh(q4, k128, build_block_map(pos, 128, window=2)),
        ("flash_refresh", "map-tile"): refresh(q4, k128, build_block_map(pos, 128, tq=64)),
        ("flash_refresh", "kernel-dtype"): refresh(q4.float(), k128.float(),
                                                   build_block_map(pos, 128)),
        ("flash_refresh", "aligned"): refresh(misaligned((1, 4, 4, 32), BF16), k128,
                                              build_block_map(pos, 128)),
        ("flash_refresh_paged", "map-present"): refresh_paged(q4, slab, [[1]], 128, None),
        ("flash_refresh_paged", "map-kv-len"): refresh_paged(q4, slab, [[1]], 128,
                                                             build_block_map(pos, 256)),
        ("flash_refresh_paged", "page-tile"): refresh_paged(q4, slab, [[0]], 256,
                                                            build_block_map(pos, 256), page=256),
        ("flash_refresh_paged", "map-causal"): refresh_paged(
            q4, slab, [[1]], 128, build_block_map(pos, 128, causal=False)),
        ("flash_refresh_paged", "map-window"): refresh_paged(
            q4, slab, [[1]], 128, build_block_map(pos, 128, window=2)),
        ("flash_refresh_paged", "cold-dtype"): refresh_paged(
            q4, slab[:128], [[1]], 128, build_block_map(pos, 128),
            cold=(slab[128:].float(), slab[128:].float(), ones, ones)),
        ("flash_refresh_paged", "scale-f32"): refresh_paged(
            q4, slab[:128], [[1]], 128, build_block_map(pos, 128), cold=i8 + f16),
        ("flash_refresh_paged", "map-tile"): refresh_paged(
            q4, slab, [[1]], 128, build_block_map(pos, 128, tq=64)),
        ("flash_refresh_paged", "kernel-dtype"): refresh_paged(
            q4.float(), slab.float(), [[1]], 128, build_block_map(pos, 128)),
        ("flash_refresh_paged", "aligned"): refresh_paged(
            misaligned((1, 4, 4, 32), BF16), slab, [[1]], 128, build_block_map(pos, 128)),
        ("flash_packed", "map-present"): packed(pq, seg, None),
        ("flash_packed", "q-tile"): packed(pq, seg, pack_map(seg_np, tq=96)),
        ("flash_packed", "k-tile"): packed(pq, seg, pack_map(seg_np, tk=96)),
        ("flash_packed", "tile-ids-shape"): packed(pq, seg, pack_map(
            seg_np, tile_ids=np.zeros((1, 2, 1), np.int32))),
        ("flash_packed", "tile-count-shape"): packed(pq, seg, pack_map(
            seg_np, tile_count=np.ones((1, 2), np.int32))),
        ("flash_packed", "map-tile"): packed(pq, seg, build_pack_map(seg_np, tq=64, tk=64)),
        ("flash_packed", "single-run"): packed(pq, torch.from_numpy(split).to(dev),
                                               build_pack_map(split)),
        ("flash_packed", "aligned"): packed(misaligned((1, 128, 4, 32), BF16), seg,
                                            build_pack_map(seg_np)),
    }


SERVING_ARCH, SERVING_SSM_ARCH = "internvl3-14b", "mamba2-2.7b"
TRAIN_SEQ = 2048       # mamba2-2.7b's training shape: batch 2 x seq 2048


def serving_cases(device, streams: int = 2) -> dict:
    """One call of every op at the full widths the serving path gives it:
    internvl3-14b (LM H 40 / Hkv 8, D 128 on its codecflow layout at
    448^2, cache slots rounded to 128, the paged slab and, for the int8
    ops, its first page per stream cold; ViT H 16, D 64 on a packing of
    12 P-frames), 448^2 frames for mv_sad, mamba2-2.7b's fresh window
    for ssd_scan (H 80, P 64, N 128, L 160) and its training shape for
    ssd_scan_bwd (L 2048, chunk 256).  {op: call}; zeros, with valid page
    tables and positions (the deferred checks run on the card)."""
    dev = torch.device(device)
    cfg, ssm = get_config(SERVING_ARCH), get_config(SERVING_SSM_ARCH)
    v = cfg.vit
    codec = CodecCfg(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
    lay = WindowLayout(window=codec.window_frames, stride=codec.stride_frames, gop=codec.gop,
                       g_tokens=v.n_groups, k_tokens=capacity_groups(v, codec.keep_ratio),
                       query_len=16)
    H, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.d_head
    slots = _slots(lay)
    pps = slots // PAGE
    bm = refresh_block_map(lay, kv_len=slots)
    B = streams

    def z(*shape, dtype=BF16):
        return torch.zeros(shape, dtype=dtype, device=dev)

    q, qf = z(B, bm.n_q, H, D), z(B, lay.total_len, H, D)
    q_pos = torch.as_tensor(np.broadcast_to(bm.q_pos[:bm.n_q], (B, bm.n_q)).copy(),
                            device=dev)
    kvv = torch.ones(B, slots, dtype=torch.bool, device=dev)
    caches, slab = z(B, slots, Hkv, D), z(B * pps * PAGE, Hkv, D)
    pt = torch.arange(B * pps, dtype=I32, device=dev).reshape(B, pps)
    # int8: each stream's first page is cold (ids n_hot + b), the rest hot
    hot = z((B * pps - B) * PAGE, Hkv, D)
    pt8 = torch.cat([B * (pps - 1) + torch.arange(B, dtype=I32, device=dev)[:, None],
                     torch.arange(B * (pps - 1), dtype=I32, device=dev).reshape(B, pps - 1)],
                    1)
    cold = (z(B * PAGE, Hkv, D, dtype=torch.int8), z(B * PAGE, Hkv, D, dtype=torch.int8),
            torch.ones(B, Hkv, device=dev), torch.ones(B, Hkv, device=dev))
    plan = pack_plan(synthetic_decision(v, 12, capacity_groups(v, codec.keep_ratio), 0.5,
                                        seed=7), v)
    R, L = plan.seg_id.shape
    pq, seg = z(R, L, v.n_heads, v.d_model // v.n_heads), torch.as_tensor(plan.seg_id,
                                                                            device=dev)
    ov = lay.overlap_tokens
    k_ov, delta = z(B, ov, Hkv, D), torch.full((B, ov), 8, dtype=I32, device=dev)
    cur = z(v.image, v.image, dtype=F32)
    s = ssm.ssm
    Hs, P, N = s.n_heads(ssm.d_model), s.head_dim, s.d_state
    x, la = z(B, 160, Hs, P), -torch.ones(B, 160, Hs, device=dev)
    bc, init = z(B, 160, s.n_groups, N), z(B, Hs, P, N, dtype=F32)
    xt, lat = z(B, TRAIN_SEQ, Hs, P), -torch.ones(B, TRAIN_SEQ, Hs, device=dev)
    bct = z(B, TRAIN_SEQ, s.n_groups, N)
    states = z(B, Hs, chunk_count(TRAIN_SEQ, s.chunk), P, N, dtype=F32)
    return {
        "mv_sad": lambda: ops.mv_sad(cur, cur, codec.block, codec.search_radius),
        "rope_shift": lambda: ops.rope_shift(k_ov, delta),
        "flash_refresh_paged": lambda: ops.flash_refresh_paged(
            q, slab, slab, q_pos, kvv, pt, block_map=bm),
        "flash_refresh_paged_int8": lambda: ops.flash_refresh_paged(
            q, hot, hot, q_pos, kvv, pt8, block_map=bm, cold=cold),
        "flash_refresh": lambda: ops.flash_refresh(q, caches, caches, q_pos, kvv, block_map=bm),
        "flash_packed": lambda: ops.flash_packed(pq, pq, pq, seg, plan.block_map),
        "flash_prefill": lambda: ops.flash_prefill(qf, caches, caches),
        "flash_prefill_paged": lambda: ops.flash_prefill_paged(qf, slab, slab, pt),
        "flash_prefill_paged_int8": lambda: ops.flash_prefill_paged(qf, hot, hot, pt8,
                                                                    cold=cold),
        "ssd_scan": lambda: ops.ssd_scan(x, la, bc, bc, init, s.chunk),
        "ssd_scan_bwd": lambda: ops.ssd_scan_bwd(xt, lat, bct, bct, states, xt, init, s.chunk),
    }


def main(argv=None) -> int:
    rows, failures = run_audit()
    budgets, over = run_budgets()
    cfg_rows = config_rows() + variant_rows() + mixed_rows()
    refused = [f"{r.arch} {r.op} [{r.geometry}]: {r.verdict}" for r in cfg_rows
               if r.verdict != "kernel"]
    print("## Dispatch coverage\n")
    print(coverage_table(rows))
    print("\n## Map budgets\n")
    for b in budgets:
        print(f"- {b.render()}")
    print("\n## Configs at their serving geometry\n")
    print(config_table(cfg_rows))
    problems = failures + over + refused
    for p in problems:
        print(f"FAIL: {p}")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
