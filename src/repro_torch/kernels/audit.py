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
    the launcher's default ViT, mamba's state): which ops the card takes,
    and the rule that refuses the rest.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..configs import CodecCfg, ViTCfg
from ..configs.registry import all_configs, get_config
from ..core.kvc import WindowLayout, refresh_block_map
from ..core.pruning import (
    PACK_GROUP_QUANTUM, PACK_LEN_BUCKETS, PACK_ROW_QUANTUM, HostDecision, capacity_groups,
    pack_plan,
)
from . import contracts, ops
from .flash_packed import build_pack_map
from .flash_refresh import build_block_map

BF16, F32, I32 = torch.bfloat16, torch.float32, torch.int32
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
    """The reference's f32 prefill rows (refused here by 'bf16': the
    kernel's products are bf16) and their bf16 twins, ragged lengths
    included, which reach the kernel."""
    rows = []
    H, Hkv, D = ATTN["H"], ATTN["Hkv"], ATTN["D"]
    for B, Sq, Sk, sw in ((2, 256, 256, None), (1, 512, 512, 4096), (1, 128, 384, None),
                          (1, 192, 256, None), (1, 256, 200, None)):
        for dt, expect in ((F32, "refused:bf16"), (BF16, "kernel")):
            q, k = _meta((B, Sq, H, D), dt), _meta((B, Sk, Hkv, D), dt)
            facts = contracts.flash_prefill_facts(q, k, k, causal=True, window=sw, q_offset=0)
            rows.append(_run_one(
                "flash_prefill", f"B={B} Sq={Sq} Sk={Sk} sw={sw} {str(dt)[6:]}", expect, facts,
                lambda q=q, k=k, sw=sw: ops.flash_prefill(q, k, k, window=sw), (B, Sq, H, D)))
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
    kernel), mv_sad, and ssd_scan: the reference's f32 row with N 32
    (refused by 'bf16'), its bf16 twin (refused by 'state-width') and the
    serving row of mamba2-2.7b (N 128)."""
    rows = []
    for lay, _ in LAYOUTS:
        S = lay.overlap_tokens
        if S == 0:
            continue
        k, delta = _meta((1, S, 4, 64)), _meta((1, S), I32)
        rows.append(_run_one("rope_shift", f"w{lay.window}s{lay.stride} overlap={S}", "kernel",
                             contracts.rope_shift_facts(k, delta),
                             lambda k=k, d=delta: ops.rope_shift(k, d), (1, S, 4, 64)))
    cur = _meta((256, 256), F32)
    rows.append(_run_one("mv_sad", "256x256 b16 r4", "kernel",
                         contracts.mv_sad_facts(cur, cur, block=16, radius=4),
                         lambda: ops.mv_sad(cur, cur, 16, 4), (16, 16, 2)))
    for label, dt, (H, P, G, N), expect in (
            ("B2 L100 H8 G2 N32 f32", F32, (8, 64, 2, 32), "refused:bf16"),
            ("B2 L100 H8 G2 N32 bf16", BF16, (8, 64, 2, 32), "refused:state-width"),
            ("B2 L160 H80 P64 N128 bf16 (mamba2-2.7b)", BF16, (80, 64, 1, 128), "kernel")):
        L = 160 if H == 80 else 100
        x, la = _meta((2, L, H, P), dt), _meta((2, L, H), F32)
        bc = _meta((2, L, G, N), dt)
        rows.append(_run_one("ssd_scan", label, expect,
                             contracts.ssd_scan_facts(x, la, bc, bc, chunk=128),
                             lambda x=x, la=la, bc=bc: ops.ssd_scan(x, la, bc, bc),
                             (2, L, H, P)))
    return rows


def run_audit() -> Tuple[List[AuditRow], List[str]]:
    """(all rows, failure strings) of the dispatch coverage matrix."""
    rows = (_refresh_rows() + _paged_refresh_rows() + _quant_paged_rows() + _packed_rows()
            + _prefill_rows() + _paged_prefill_rows() + _slab_rows())
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
    codec = CodecCfg(gop=4, window_frames=16, stride_frames=4, keep_ratio=0.5)
    archs = archs or [a + s for a in all_configs() for s in ("", "-smoke")]
    out: List[ConfigRow] = []
    for arch in archs:
        cfg = get_config(arch)
        v = _serving_vit(cfg)
        lay = WindowLayout(window=codec.window_frames, stride=codec.stride_frames,
                           gop=codec.gop, g_tokens=v.n_groups,
                           k_tokens=capacity_groups(v, codec.keep_ratio), query_len=16)
        dt = BF16 if cfg.dtype == "bfloat16" else F32

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
            geo = f"H {H} / Hkv {Hkv}, D {D}, {str(dt)[6:]}"
            add("flash_refresh", geo, contracts.decide("flash_refresh", contracts.flash_refresh_facts(
                q, _meta((streams, slots, Hkv, D), dt), _meta((streams, slots, Hkv, D), dt),
                q_pos, None, causal=True, window=None, block_map=bm)))
            if "mamba" not in mixers:
                k = _meta((streams * slots, Hkv, D), dt)
                pt = _meta((streams, slots // PAGE), I32)
                kvv = _meta((streams, slots), torch.bool)
                add("flash_refresh_paged", geo, contracts.decide(
                    "flash_refresh_paged", contracts.flash_refresh_paged_facts(
                        q, k, k, q_pos, kvv, pt, page=PAGE, causal=True, window=None,
                        block_map=bm)))
                kr = _meta((streams, lay.overlap_tokens, Hkv, D), dt)
                add("rope_shift", f"Hkv {Hkv}, D {D}, {str(dt)[6:]}", contracts.decide(
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
    plain version on the same operands.  Values come from seeded
    generators; views the rules look at (misaligned, strided,
    transposed) are made on ``device`` itself."""
    from .flash_packed import PackBlockMap, flash_packed_plain
    from .flash_prefill import flash_prefill_paged_plain, flash_prefill_plain
    from .flash_refresh import flash_refresh_paged_plain, flash_refresh_plain
    from .mv_sad import mv_sad_plain
    from .rope_shift import rope_shift_plain
    from .ssd_scan import ssd_scan_plain
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

    def frames(n):
        return rand(n, n) * 60 + 100, rand(n, n, seed=1) * 60 + 100

    def mv(n, block, radius):
        f = frames(n)
        return "mv_sad", (lambda: ops.mv_sad(*f, block, radius)), (
            lambda: mv_sad_plain(*f, block, radius))

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

    def packed(q, seg, bm):
        return "flash_packed", (lambda: ops.flash_packed(q, q, q, seg, bm)), (
            lambda: flash_packed_plain(q, q, q, seg))

    def pack_map(seg, tq=contracts.TILE, tk=contracts.TILE, tile_ids=None, tile_count=None):
        good = build_pack_map(seg)
        return PackBlockMap(tq, tk, good.tile_ids if tile_ids is None else tile_ids,
                            good.tile_count if tile_count is None else tile_count,
                            good.seg_id, good.span, good.single_run)

    def ssd(x, la, b, c, init=None, chunk=16):
        return "ssd_scan", (lambda: ops.ssd_scan(x, la, b, c, init, chunk)), (
            lambda: ssd_scan_plain(x, la, b, c, init, chunk))

    def ssd_ok(L=16, H=4, P=32, N=16):
        return (rand(1, L, H, P, dtype=BF16), -rand(1, L, H).abs(),
                rand(1, L, 1, N, dtype=BF16), rand(1, L, 1, N, dtype=BF16, seed=2),
                rand(1, H, P, N, seed=3))

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
    x, la, b, c, init = ssd_ok()
    conv = rand(1, 16, 33, dtype=BF16)
    conv36 = rand(1, 16, 36, dtype=BF16)
    q8, k8 = rand(1, 8, 4, 32, dtype=BF16), rand(1, 8, 2, 32, dtype=BF16, seed=1)
    return {
        ("mv_sad", "block-4"): mv(36, 6, 1),
        ("mv_sad", "candidates"): mv(32, 16, 16),
        ("mv_sad", "shared-memory"): mv(64, 64, 15),
        ("rope_shift", "kernel-dtype"): rope(rand(1, 8, 2, 16, dtype=torch.float16)),
        ("rope_shift", "head-dim-8"): rope(rand(1, 8, 2, 12)),
        ("rope_shift", "aligned"): rope(misaligned((1, 8, 2, 16))),
        ("flash_prefill", "bf16"): prefill(q8.float(), k8.float()),
        ("flash_prefill", "kernel-head-dim"): prefill(q8[..., :16].contiguous(),
                                                      k8[..., :16].contiguous()),
        ("flash_prefill", "contiguous"): prefill(transposed(q8, 1, 2), k8),
        ("flash_prefill", "aligned"): prefill(misaligned((1, 8, 4, 32), BF16), k8),
        ("flash_prefill_paged", "page-tile"): prefill_paged(q8, slab, page=64),
        ("flash_prefill_paged", "cold-dtype"): prefill_paged(
            q8, slab[:128], cold=(slab[128:].float(), slab[128:].float(), ones, ones)),
        ("flash_prefill_paged", "scale-f32"): prefill_paged(q8, slab[:128], cold=i8 + f16),
        ("flash_prefill_paged", "bf16"): prefill_paged(q8.float(), slab.float()),
        ("flash_prefill_paged", "kernel-head-dim"): prefill_paged(
            q8[..., :16].contiguous(), slab[..., :16].contiguous()),
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
        ("flash_refresh", "bf16"): refresh(q4.float(), k128.float(), build_block_map(pos, 128)),
        ("flash_refresh", "kernel-head-dim"): refresh(
            q4[..., :16].contiguous(), k128[..., :16].contiguous(), build_block_map(pos, 128)),
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
        ("flash_refresh_paged", "bf16"): refresh_paged(
            q4.float(), slab.float(), [[1]], 128, build_block_map(pos, 128)),
        ("flash_refresh_paged", "kernel-head-dim"): refresh_paged(
            q4[..., :16].contiguous(), slab[..., :16].contiguous(), [[1]], 128,
            build_block_map(pos, 128)),
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
        ("flash_packed", "bf16"): packed(pq.float(), seg, build_pack_map(seg_np)),
        ("flash_packed", "kernel-head-dim"): packed(pq[..., :16].contiguous(), seg,
                                                    build_pack_map(seg_np)),
        ("flash_packed", "aligned"): packed(misaligned((1, 128, 4, 32), BF16), seg,
                                            build_pack_map(seg_np)),
        ("ssd_scan", "bf16"): ssd(x.float(), la, b, c, init),
        ("ssd_scan", "log-a-f32"): ssd(x, la.to(BF16), b, c, init),
        ("ssd_scan", "chunk-256"): ssd(*ssd_ok(L=300)[:4], chunk=512),
        ("ssd_scan", "state-width"): ssd(*ssd_ok(N=32)),
        ("ssd_scan", "head-width-8"): ssd(*ssd_ok(P=12)),
        ("ssd_scan", "aligned"): ssd(x, la, conv[..., 1:17].reshape(1, 16, 1, 16),
                                     conv[..., 17:33].reshape(1, 16, 1, 16), init),
        ("ssd_scan", "row-strides"): ssd(x, la, conv36[..., :16].reshape(1, 16, 1, 16),
                                         conv36[..., 16:32].reshape(1, 16, 1, 16), init),
        ("ssd_scan", "packed"): ssd(transposed(x, 2, 3), la, b, c, init),
        ("ssd_scan", "init-state"): ssd(x, la, b, c, transposed(init, 2, 3)),
    }


SERVING_ARCH, SERVING_SSM_ARCH = "internvl3-14b", "mamba2-2.7b"


def serving_cases(device, streams: int = 2) -> dict:
    """One call of every op at the full widths the serving path gives it:
    internvl3-14b (LM H 40 / Hkv 8, D 128 on its codecflow layout at
    448^2, cache slots rounded to 128, the paged slab and, for the int8
    ops, its first page per stream cold; ViT H 16, D 64 on a packing of
    12 P-frames), 448^2 frames for mv_sad, and mamba2-2.7b's fresh window
    for ssd_scan (H 80, P 64, N 128, L 160).  {op: call}; zeros, with
    valid page tables and positions (the deferred checks run on the card)."""
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
    }


def main(argv=None) -> int:
    rows, failures = run_audit()
    budgets, over = run_budgets()
    cfg_rows = config_rows()
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
