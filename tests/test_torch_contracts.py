"""The port's kernel-contract registry (``repro_torch.kernels.contracts``)
against the JAX package's (``repro.kernels.contracts``), and its audits.

* The registry holds the reference's eight contracts, its precondition
  codes in its order plus the port's three deferred ones, and its
  eligibility codes plus and minus exactly the ``DIFFERENCES`` table.
* The facts builders on torch tensors equal the reference's on jnp
  arrays of the same shapes, key for key on the keys both have; the
  port's extra keys are listed here.
* Every guard case of the reference's ``tests/test_kernels.py`` raises
  the same precondition code in the port, or records the same
  eligibility code in ``card_verdicts()`` unless ``DIFFERENCES`` drops
  the rule.
* Every eligibility rule, provoked on CPU tensors, records its code,
  runs the plain version and leaves ``dispatch_counts()`` at
  ``backend:ok``; facts on meta tensors equal those on CPU ones.
* ``kernels.audit``: no failure, the map budgets hold, every config's
  serving calls reach the kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import contracts as jc  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import audit, contracts, ops  # noqa: E402
from repro_torch.kernels.flash_packed import build_pack_map  # noqa: E402
from repro_torch.kernels.flash_refresh import build_block_map  # noqa: E402
from torch_threads import torch_one_thread  # noqa: E402,F401

PORT_PRECONDITIONS = {"flash_refresh": ["positions-match"],
                      "flash_refresh_paged": ["page-range", "positions-match"],
                      "flash_prefill_paged": ["page-range"],
                      "flash_packed": ["segments-match"]}


# ----------------------------------------------------------------------
# the registry mirrors the reference's
# ----------------------------------------------------------------------
def test_registry_names_and_precondition_codes_mirror_the_reference():
    assert list(contracts.CONTRACTS) == list(jc.CONTRACTS)
    for name, ref in jc.CONTRACTS.items():
        port = contracts.CONTRACTS[name]
        want = [r.code for r in ref.preconditions] + PORT_PRECONDITIONS.get(name, [])
        assert [r.code for r in port.preconditions] == want, name
        ref_desc = {r.code: r.description for r in ref.preconditions}
        for r in port.preconditions:
            assert r.deferred == (r.code in PORT_PRECONDITIONS.get(name, []))
            if r.code in ref_desc:
                assert r.description == ref_desc[r.code], (name, r.code)
        assert port.recompile_budget == ref.recompile_budget, name
        assert port.kernel.startswith("repro_torch.kernels.") and port.kernel.endswith("_cuda")
        assert port.oracle.startswith("repro_torch.kernels.") and port.oracle.endswith("_plain")


def test_eligibility_codes_differ_exactly_by_the_differences_table():
    diff = contracts.DIFFERENCES
    assert len({(op, code) for op, code, _, _ in diff}) == len(diff)
    assert all(change in "+-" and why for _, _, change, why in diff)
    for name, ref in jc.CONTRACTS.items():
        port = [r.code for r in contracts.CONTRACTS[name].eligibility]
        ref_codes = [r.code for r in ref.eligibility]
        added = {c for op, c, ch, _ in diff if op == name and ch == "+"}
        dropped = {c for op, c, ch, _ in diff if op == name and ch == "-"}
        assert set(port) == (set(ref_codes) - dropped) | added, name
        assert not added & set(ref_codes) and dropped <= set(ref_codes), name
        kept = [c for c in port if c in ref_codes]     # the reference's, in its order
        assert kept == [c for c in ref_codes if c not in dropped], name


# ----------------------------------------------------------------------
# facts: key for key with the reference's
# ----------------------------------------------------------------------
PORT_EXTRA_FACTS = {
    "mv_sad": {"threads", "shared_bytes"},
    "rope_shift": {"aligned"},
    "flash_prefill": {"contiguous", "aligned"},
    "flash_refresh": {"aligned"},
    "flash_refresh_paged": {"aligned", "pages_in_range"},
    "flash_prefill_paged": {"contiguous", "aligned", "pages_in_range"},
    "flash_packed": {"map_single_run", "segments_match", "aligned"},
    "ssd_scan": {"scan_chunk", "init_dtype"},
}


def _pair(shape, dtype):
    return (torch.zeros(shape, dtype=getattr(torch, dtype)),
            jnp.zeros(shape, dtype=getattr(jnp, dtype if dtype != "bool" else "bool_")))


def _facts_cases():
    bm = build_block_map(np.arange(100, 140), 256, window=64)
    seg = np.repeat(np.arange(4, dtype=np.int32), 64)[None].repeat(2, 0)
    pm = build_pack_map(seg)
    q, qj = _pair((2, 40, 8, 32), "bfloat16")
    k, kj = _pair((2, 256, 2, 32), "bfloat16")
    slab, slabj = _pair((512, 2, 32), "bfloat16")
    qp, qpj = _pair((2, 40), "int32")
    kvv, kvvj = _pair((2, 256), "bool")
    pt, ptj = _pair((2, 2), "int32")
    k8, k8j = _pair((256, 2, 32), "int8")
    sc, scj = _pair((2, 2), "float32")
    pq, pqj = _pair((2, 256, 8, 32), "bfloat16")
    sg, sgj = _pair((2, 256), "int32")
    x, xj = _pair((2, 40, 8, 64), "bfloat16")
    la, laj = _pair((2, 40, 8), "float32")
    bc, bcj = _pair((2, 40, 1, 128), "bfloat16")
    cur, curj = _pair((64, 96), "float32")
    return {
        "mv_sad": (contracts.mv_sad_facts(cur, cur, block=16, radius=4),
                   jc.mv_sad_facts(curj, curj, block=16, radius=4)),
        "rope_shift": (contracts.rope_shift_facts(k, qp), jc.rope_shift_facts(kj, qpj)),
        "flash_prefill": (
            contracts.flash_prefill_facts(q, k, k, causal=True, window=64, q_offset=7),
            jc.flash_prefill_facts(qj, kj, kj, causal=True, window=64, q_offset=7)),
        "flash_refresh": (
            contracts.flash_refresh_facts(q, k, k, qp, kvv, causal=True, window=64,
                                          block_map=bm),
            jc.flash_refresh_facts(qj, kj, kj, qpj, kvvj, causal=True, window=64,
                                   block_map=bm)),
        "flash_refresh_paged": (
            contracts.flash_refresh_paged_facts(q, slab, slab, qp, kvv, pt, page=128,
                                                causal=True, window=64, block_map=bm,
                                                cold=(k8, k8, sc, sc)),
            jc.flash_refresh_paged_facts(qj, slabj, slabj, qpj, kvvj, ptj, page=128,
                                         causal=True, window=64, block_map=bm,
                                         cold=(k8j, k8j, scj, scj))),
        "flash_prefill_paged": (
            contracts.flash_prefill_paged_facts(q, slab, slab, pt, page=128, causal=True,
                                                window=None, q_offset=0, cold=(k8, k8, sc, sc)),
            jc.flash_prefill_paged_facts(qj, slabj, slabj, ptj, page=128, causal=True,
                                         window=None, q_offset=0, cold=(k8j, k8j, scj, scj))),
        "flash_packed": (
            contracts.flash_packed_facts(pq, pq, pq, sg, pm),
            jc.flash_packed_facts(pqj, pqj, pqj, sgj, pm.tile_ids, pm.tile_count,
                                  tq=pm.tq, tk=pm.tk)),
        "ssd_scan": (contracts.ssd_scan_facts(x, la, bc, bc, chunk=256),
                     jc.ssd_scan_facts(xj, laj, bcj, bcj, chunk=256)),
    }


def test_facts_equal_the_references_key_for_key():
    cases = _facts_cases()
    assert set(cases) == set(jc.CONTRACTS)
    for name, (port, ref) in cases.items():
        assert set(port) - set(ref) == PORT_EXTRA_FACTS[name], name
        assert set(ref) <= set(port), (name, set(ref) - set(port))
        for key in ref:
            if callable(ref[key]):
                assert callable(port[key]), (name, key)
            else:
                assert port[key] == ref[key], (name, key, port[key], ref[key])


def test_facts_on_meta_tensors_equal_those_on_cpu():
    q = torch.zeros(2, 40, 8, 32, dtype=torch.bfloat16)
    k = torch.zeros(2, 256, 2, 32, dtype=torch.bfloat16)
    m = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    bm = build_block_map(np.arange(100, 140), 256)
    qp = torch.zeros(2, 40, dtype=torch.int32)
    on_cpu = contracts.flash_refresh_facts(q, k, k, qp, None, causal=True, window=None,
                                           block_map=bm)
    on_meta = contracts.flash_refresh_facts(m(q), m(k), m(k), m(qp), None, causal=True,
                                            window=None, block_map=bm)
    assert {k_: v for k_, v in on_cpu.items() if not callable(v)} == {
        k_: v for k_, v in on_meta.items() if not callable(v)}


# ----------------------------------------------------------------------
# the reference's guard tests (tests/test_kernels.py), in the port
# ----------------------------------------------------------------------
def _z(shape, dtype="float32"):
    """Zeros in both frameworks: (torch, jnp)."""
    return (torch.zeros(shape, dtype=getattr(torch, dtype)),
            jnp.zeros(shape, dtype=getattr(jnp, dtype)))


def _guard(fn, *args, **kw):
    """(port call, reference call) of ``fn`` (an op name) on ``_z`` pairs."""
    t = [a[0] if isinstance(a, tuple) else a for a in args]
    j = [a[1] if isinstance(a, tuple) else a for a in args]
    return (lambda: getattr(ops, fn)(*t, **kw)), (lambda: getattr(jops, fn)(*j, **kw))


_Q, _K = (1, 128, 4, 32), (1, 128, 2, 32)
_SSD = dict(x=(1, 16, 4, 8), la=(1, 16, 4), b=(1, 16, 2, 8))
PRECONDITION_GUARDS = {   # (op, code): the reference's cases, test_kernels.py:473-835
    "mv_sad-block-divisibility": ("block-divisibility",
                                  _guard("mv_sad", _z((60, 64)), _z((60, 64)))),
    "mv_sad-shape-match": ("shape-match", _guard("mv_sad", _z((64, 64)), _z((64, 32)))),
    "mv_sad-rank": ("rank", _guard("mv_sad", _z((1, 64, 64)), _z((1, 64, 64)))),
    "mv_sad-radius": ("radius", _guard("mv_sad", _z((64, 64)), _z((64, 64)), radius=0)),
    "rope-delta-dtype": ("delta-dtype", _guard("rope_shift", _z((1, 128, 2, 32)),
                                               _z((1, 128)))),
    "rope-delta-shape": ("delta-shape", _guard("rope_shift", _z((1, 128, 2, 32)),
                                               _z((1, 64), "int32"))),
    "rope-even-head": ("even-head", _guard("rope_shift", _z((1, 128, 2, 31)),
                                           _z((1, 128), "int32"))),
    "rope-k-dtype": ("k-dtype", _guard("rope_shift", _z((1, 128, 2, 32), "int32"),
                                       _z((1, 128), "int32"))),
    "prefill-batch": ("batch", _guard("flash_prefill", _z(_Q), _z((2, 128, 2, 32)),
                                      _z((2, 128, 2, 32)))),
    "prefill-gqa": ("gqa", _guard("flash_prefill", _z((1, 128, 3, 32)), _z(_K), _z(_K))),
    "prefill-head-dim": ("head-dim", _guard("flash_prefill", _z((1, 128, 4, 64)), _z(_K),
                                            _z(_K))),
    "prefill-dtype": ("dtype", _guard("flash_prefill", _z(_Q), _z(_K, "int32"),
                                      _z(_K, "int32"))),
    "prefill-window": ("window", _guard("flash_prefill", _z(_Q), _z(_K), _z(_K), window=0)),
    "ssd-log-a-shape": ("log-a-shape", _guard("ssd_scan", _z(_SSD["x"]), _z((1, 16, 5)),
                                              _z(_SSD["b"]), _z(_SSD["b"]))),
    "ssd-bc-shape": ("bc-shape", _guard("ssd_scan", _z(_SSD["x"]), _z(_SSD["la"]),
                                        _z(_SSD["b"]), _z((1, 16, 2, 9)))),
    "ssd-gqa": ("gqa", _guard("ssd_scan", _z(_SSD["x"]), _z(_SSD["la"]), _z((1, 16, 3, 8)),
                              _z((1, 16, 3, 8)))),
    "ssd-chunk": ("chunk", _guard("ssd_scan", _z(_SSD["x"]), _z(_SSD["la"]), _z(_SSD["b"]),
                                  _z(_SSD["b"]), chunk=0)),
    "ssd-dtype": ("dtype", _guard("ssd_scan", _z(_SSD["x"], "int32"), _z(_SSD["la"]),
                                  _z(_SSD["b"]), _z(_SSD["b"]))),
    "paged-prefill-causal": ("causal", _guard("flash_prefill_paged", _z((1, 256, 4, 32)),
                                              _z((384, 2, 32)), _z((384, 2, 32)),
                                              _z((1, 2), "int32"), causal=False)),
}


@pytest.mark.parametrize("case", sorted(PRECONDITION_GUARDS))
def test_reference_precondition_guards_raise_the_same_code(case):
    code, (port_call, ref_call) = PRECONDITION_GUARDS[case]
    with pytest.raises(jc.KernelContractError, match=f"'{code}'"):
        ref_call()
    with pytest.raises(contracts.KernelContractError, match=f"'{code}'"):
        port_call()


def _refresh_paged_guard(scale_dtype):
    """The reference's page-tile and scale-f32 cases: a 256-row page
    against a 128-tile map; f16 scales of an int8 cold group."""
    qp = np.arange(64, dtype=np.int32)
    bm = build_block_map(qp, 256)
    if scale_dtype is None:
        args = (_z((1, 64, 4, 32)), _z((512, 2, 32)), _z((512, 2, 32)), (
            torch.from_numpy(qp)[None], jnp.asarray(qp)[None]), _z((1, 256), "bool"),
            _z((1, 1), "int32"))
        return _guard("flash_refresh_paged", *args, page=256, block_map=bm)
    pt = np.array([[2, 0]], np.int32)
    cold = tuple(_z(s, d) for s, d in (((128, 2, 32), "int8"), ((128, 2, 32), "int8"),
                                       ((1, 2), scale_dtype), ((1, 2), scale_dtype)))
    args = (_z((1, 64, 4, 32)), _z((256, 2, 32)), _z((256, 2, 32)), (
        torch.from_numpy(qp)[None], jnp.asarray(qp)[None]), _z((1, 256), "bool"),
        (torch.from_numpy(pt), jnp.asarray(pt)))
    t = [a[0] for a in args]
    j = [a[1] for a in args]
    return ((lambda: ops.flash_refresh_paged(*t, block_map=bm, cold=tuple(c[0] for c in cold))),
            (lambda: jops.flash_refresh_paged(*j, block_map=bm, cold=tuple(c[1] for c in cold))))


ELIGIBILITY_GUARDS = {   # (op, code, port op name, calls)
    "rope-seq-tile": ("rope_shift", "seq-tile", "rope_shift",
                      _guard("rope_shift", _z((1, 192, 2, 32)), _z((1, 192), "int32"))),
    "prefill-q-tile": ("flash_prefill", "q-tile", "flash_prefill",
                       _guard("flash_prefill", _z((1, 192, 4, 32)), _z((1, 256, 2, 32)),
                              _z((1, 256, 2, 32)), q_offset=64)),
    "paged-page-tile": ("flash_refresh_paged", "page-tile", "flash_refresh_paged",
                        _refresh_paged_guard(None)),
    "paged-prefill-q-tile": ("flash_prefill_paged", "q-tile", "flash_prefill_paged",
                             _guard("flash_prefill_paged", _z((1, 192, 4, 32)),
                                    _z((384, 2, 32)), _z((384, 2, 32)),
                                    _z((1, 2), "int32"))),
    "quant-scale-f32": ("flash_refresh_paged", "scale-f32", "flash_refresh_paged_int8",
                        _refresh_paged_guard("float16")),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY_GUARDS))
def test_reference_eligibility_guards_record_the_same_code(case):
    """Where the reference falls back by a rule (counted as
    ``backend:<rule>`` on the CPU) the port records the same code in
    ``card_verdicts``, or ``DIFFERENCES`` drops the rule (the port's
    kernel takes the call)."""
    name, code, op, (port_call, ref_call) = ELIGIBILITY_GUARDS[case]
    jops.reset_dispatch_counts()
    ref_call()
    assert jops.dispatch_counts()[name] == {f"backend:{code}": 1}
    ops.reset_card_verdicts()
    ops.reset_dispatch_counts()
    port_call()
    assert ops.dispatch_counts() == {op: {"backend:ok": 1}}
    if (name, code, "-") not in {d[:3] for d in contracts.DIFFERENCES}:
        assert ops.card_verdicts() == {op: {code: 1}}
        return
    # dropped: 'ok', or a rule of the port's own (these are f32 calls)
    (got,) = ops.card_verdicts()[op]
    assert got == "ok" or (name, got, "+") in {d[:3] for d in contracts.DIFFERENCES}


# ----------------------------------------------------------------------
# every eligibility rule, provoked on CPU tensors (``audit.refusal_cases``,
# which chip_smoke also provokes on the card)
# ----------------------------------------------------------------------
def test_every_eligibility_rule_has_a_provoking_case():
    rules = {(name, r.code) for name, c in contracts.CONTRACTS.items() for r in c.eligibility}
    assert set(audit.refusal_cases("cpu")) | audit.SHADOWED == rules
    assert not set(audit.refusal_cases("cpu")) & audit.SHADOWED


@pytest.mark.parametrize("name", sorted(contracts.CONTRACTS))
def test_eligibility_rules_provoked_on_cpu_record_their_code_and_run_plain(name):
    for (contract, code), (op, call, plain) in sorted(audit.refusal_cases("cpu").items()):
        if contract != name:
            continue
        ops.reset_card_verdicts()
        ops.reset_dispatch_counts()
        out = call()
        assert ops.card_verdicts() == {op: {code: 1}}, (contract, code)
        assert ops.dispatch_counts() == {op: {"backend:ok": 1}}, (contract, code)
        want = plain()
        for a, b in zip(*((o if isinstance(o, tuple) else (o,)) for o in (out, want))):
            assert torch.equal(a, b), (contract, code)


def test_shadowed_rules_decide_on_facts_and_raise_positions_match_in_ops():
    q = torch.zeros(1, 4, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 2, 32, dtype=torch.bfloat16)
    qp = torch.tensor([[3, 4, 5, 6]])
    bm = build_block_map([3, 4, 5, 6, 7], 128)
    facts = contracts.flash_refresh_facts(q, k, k, qp, None, causal=True, window=None,
                                          block_map=bm)
    assert contracts.decide("flash_refresh", facts).reason == "map-n-q"
    with pytest.raises(contracts.KernelContractError, match="positions-match"):
        ops.flash_refresh(q, k, k, qp, block_map=bm)


def test_refusals_name_their_rule_and_are_kernel_errors():
    from repro_torch.kernels.cuda import KernelError
    err = contracts.FLASH_REFRESH.refusal("kernel-dtype", "flash_refresh")
    assert isinstance(err, KernelError) and isinstance(err, contracts.KernelContractError)
    assert str(err) == ("flash_refresh: eligibility 'kernel-dtype' failed (k/v must be the "
                        "bf16 or f16 caches or slab, under any q; f32 k/v are not taken)")


def test_memoized_verdicts_equal_fresh_decisions():
    """The memo key determines the verdict: every provoking case decides
    the same with the memo cleared and after it."""
    for (contract, code), (op, call, _) in sorted(audit.refusal_cases("cpu").items()):
        for _ in range(2):
            contracts.clear_verdicts()
            ops.reset_card_verdicts()
            call()
            call()
            assert ops.card_verdicts() == {op: {code: 2}}, (contract, code)


# ----------------------------------------------------------------------
# the audits
# ----------------------------------------------------------------------
def test_serving_cases_decide_ok_on_meta_tensors():
    """Every op at the full serving widths of internvl3-14b and
    mamba2-2.7b: the registry takes the call (chip_smoke launches them)."""
    cases = audit.serving_cases("meta")
    assert set(cases) == set(ops.KERNELS)
    ops.reset_card_verdicts()
    for call in cases.values():
        call()
    assert ops.card_verdicts() == {op: {"ok": 1} for op in ops.KERNELS}


def test_dispatch_audit_has_no_failures():
    rows, failures = audit.run_audit()
    assert failures == [], "\n".join(failures)
    assert len(rows) >= 60
    assert sum(r.expect == "kernel" for r in rows) >= 45
    assert {r.decision for r in rows if r.expect != "kernel"} >= {
        "refused:page-tile", "refused:scale-f32", "refused:cold-dtype", "refused:single-run"}


def test_map_budgets_hold():
    results, over = audit.run_budgets()
    assert over == []
    assert {r.op: r.budget for r in results} == {"flash_packed": 24, "flash_refresh": 20,
                                                 "flash_refresh_paged": 20}


def test_every_config_serves_through_the_kernels():
    rows = audit.config_rows()
    assert len({r.arch for r in rows}) == 22
    assert [r for r in rows if r.verdict != "kernel"] == []
    ops_of = {r.arch: {r.op for r in rows if r.arch == a} for a in {r.arch for r in rows}
              for r in rows if r.arch == a}
    assert ops_of["mamba2-2.7b"] == {"mv_sad", "flash_packed", "ssd_scan"}
    assert ops_of["jamba-v0.1-52b"] == {"mv_sad", "flash_packed", "ssd_scan", "flash_refresh"}
    assert ops_of["internvl3-14b"] == {"mv_sad", "flash_packed", "flash_refresh",
                                       "flash_refresh_paged", "rope_shift"}


def test_audit_command_line_exits_zero(capsys):
    assert audit.main([]) == 0
    out = capsys.readouterr().out
    assert "## Dispatch coverage" in out and "## Map budgets" in out
    assert "## Configs at their serving geometry" in out and "FAIL" not in out
