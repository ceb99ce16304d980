"""The dense and VLM archs the port serves besides internvl3-14b, against
the JAX package.

deepseek-7b, qwen1.5-110b (QKV biases, drawn from a seeded normal since
they are zero at init), mistral-large-123b and internvl2-76b, each at its
``-smoke`` size, served in codecflow on the paged slab through both
lockstep schedulers by ``torch_mode_parity`` (2 streams x 24 frames at
112^2; internvl2 with its own ViT, the others with the launchers'
default one).  Equal: event order, token accounting, refresh sets and
the FLOP ledger.  Yes/no logits within 7e-3, 1.5x the largest gap
measured (4.6e-3, qwen1.5-110b with its biases; 4.05e-3 for the other
three).
"""
import pytest

torch = pytest.importorskip("torch")

from torch_mode_parity import (  # noqa: E402
    assert_parity, assert_plain_dispatch, serve,
)
from torch_threads import torch_one_thread  # noqa: E402,F401

ARCHS = ("deepseek-7b-smoke", "qwen1.5-110b-smoke", "mistral-large-123b-smoke",
         "internvl2-76b-smoke")
LOGIT_TOL = 7e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_arch_serves_like_jax(arch):
    j, t = serve("codecflow", True, arch=arch)
    assert_parity(j, t, tol=LOGIT_TOL)
    assert_plain_dispatch(t)
    if arch.startswith("qwen"):
        bq = t[5].params["blocks"][0]["mixer"]["bq"]
        assert float(bq.float().abs().max()) > 0
