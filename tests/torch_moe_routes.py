"""Expert choices of the MoE layers in a JAX package run and in a port
run, call by call, and a port run held to the JAX package's choices.

The two frameworks round bf16 products at different points, so a
router input can differ by a bf16 step between them, and a token whose
k-th and (k+1)-th gates are that close may pick another expert.  The
parity tests therefore (1) record every ``moe_block`` call's gates and
choices in both packages, (2) report each token whose chosen expert set
differs with the JAX gate margin of that choice (k-th minus (k+1)-th
largest gate), and (3) where any differs, serve the port again taking
the JAX package's choices (``force``): its answers are held to the
reference's within the stated tolerance, so a flip never widens one,
and every choice the port would have made otherwise must be a near tie:
its JAX margin at most the two gates' combined drift between the
packages (twice the token's largest gate difference), the only way
rounding can swap two gates.  A flip in the free run changes the next
layers' inputs, so later tokens may flip on wider margins there; in the
forced run the inputs follow the reference's, and only the rounding
itself can flip a choice.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import layers as jlayers
from repro_torch.models import layers as tlayers

@contextlib.contextmanager
def jax_choices(log: list):
    """While active, every call of the JAX package's ``moe_block`` appends
    its (gates (n, E) f32, choices (n, k)) to ``log`` in call order: the
    reference's own first lines, read back with an ordered callback."""
    orig = jlayers.moe_block

    def recorded(p, cfg, x):
        x2 = x.reshape(-1, x.shape[-1])
        gates = jax.nn.softmax((x2 @ p["router"]).astype(jnp.float32), axis=-1)
        _, tope = jax.lax.top_k(gates, cfg.top_k)
        jax.debug.callback(lambda g, e: log.append((np.asarray(g), np.asarray(e))),
                           gates, tope, ordered=True)
        return orig(p, cfg, x)

    jlayers.moe_block = recorded
    try:
        yield log
    finally:
        jlayers.moe_block = orig


@contextlib.contextmanager
def port_choices(log: list, force=None):
    """While active, every routing of the port's ``moe_block`` appends its
    (gates, choices) to ``log``; with ``force`` (a JAX log) call i takes
    the JAX package's choices of call i, and ``log`` records the port's
    own choices beside them."""
    orig = tlayers.top_k_lower_first
    calls = iter(force) if force is not None else None

    def recorded(gates, k):
        vals, idx = orig(gates, k)
        log.append((gates.detach().cpu().numpy(), idx.cpu().numpy()))
        if calls is not None:
            idx = torch.from_numpy(np.array(next(calls)[1])).to(gates.device).long()
            vals = gates.gather(1, idx)
        return vals, idx

    tlayers.top_k_lower_first = recorded
    try:
        yield log
    finally:
        tlayers.top_k_lower_first = orig


def flips(jlog: list, tlog: list):
    """(call, token, JAX experts, port experts, JAX gate margin, the
    token's largest gate difference between the packages) for every
    token whose expert set differs; the logs must pair call for call."""
    assert len(jlog) == len(tlog), (len(jlog), len(tlog))
    out = []
    for c, ((gj, ej), (gt, et)) in enumerate(zip(jlog, tlog)):
        assert ej.shape == et.shape, (c, ej.shape, et.shape)
        k = ej.shape[1]
        for r in np.nonzero((np.sort(ej, 1) != np.sort(et, 1)).any(1))[0]:
            s = np.sort(gj[r])[::-1]
            out.append((c, int(r), sorted(ej[r].tolist()), sorted(et[r].tolist()),
                        float(s[k - 1] - s[k]), float(np.abs(gt[r] - gj[r]).max())))
    return out


def assert_near_ties(found) -> None:
    """Every differing choice is one that rounding can make: its margin
    is at most twice the token's gate drift.  The message reports them
    all, with their margins."""
    assert all(f[4] <= 2 * f[5] for f in found), found


@contextlib.contextmanager
def jax_forced(choices: list):
    """While active, the JAX package's ``moe_block`` call i takes the
    choices ``choices[i]`` (a JAX log's, or its arrays of choices) as
    constants of its trace: the gates at those experts stand in for
    ``jax.lax.top_k``'s values.  Calls pair with choices in trace order,
    which is call order only where every MoE layer is traced once (a
    stack of one period: the layer scan's body holds each position
    once)."""
    orig_block, orig_top_k = jlayers.moe_block, jax.lax.top_k
    calls = iter(choices)

    def forced(p, cfg, x):
        idx = jnp.asarray(np.asarray(next(calls)[1]), jnp.int32)

        def top_k(gates, k):
            assert idx.shape == (gates.shape[0], k), (idx.shape, gates.shape, k)
            return jnp.take_along_axis(gates, idx, axis=1), idx
        jax.lax.top_k = top_k
        try:
            return orig_block(p, cfg, x)
        finally:
            jax.lax.top_k = orig_top_k

    jlayers.moe_block = forced
    try:
        yield
    finally:
        jlayers.moe_block = orig_block
        jax.lax.top_k = orig_top_k
