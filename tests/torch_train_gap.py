"""Where the port's bf16 rounding departs from the JAX package's, for the
logit limits of ``test_torch_train.py`` (``forward_train``) and
``test_torch_whisper.py`` (whisper prefill and decode).

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python tests/torch_train_gap.py

Runs the readings twice, each in its own process: once with XLA's
default flags (as the tests run the JAX package), once with
``--xla_allow_excess_precision=false``, under which XLA rounds every bf16
op's result to bf16, as PyTorch does.  Prints, for each case, the
largest |logit| gap

* of the port against the JAX package;
* of the port with its bf16 ``silu`` computed as XLA's CPU backend
  computes ``jax.nn.silu`` (``logistic`` as exp(-x), 1 + that, its
  reciprocal, then the product, each rounded to bf16: bitwise equal to
  the JAX package's with every op rounded);
* of the JAX package under one flag setting against itself under the
  other (the reference's own spread; decode on the same tokens);

then, with every op rounded, each op of whisper's decoder prefill fed
the JAX package's own input (teacher forced): its largest gap in bf16
steps of its largest output, and the share of elements that differ.
About a minute on a CPU.
"""
import os
import subprocess
import sys
import tempfile
from contextlib import contextmanager

import numpy as np

STRICT = "--xla_allow_excess_precision=false"
ARCHS = ("deepseek-7b-smoke", "olmoe-1b-7b-smoke", "internvl3-14b-smoke",
         "mamba2-2.7b-smoke", "whisper-large-v3-smoke")


def xla_silu(x):
    """``jax.nn.silu`` of a bf16 tensor as XLA's CPU backend computes it
    with every op rounded."""
    import torch
    return x * (1 / (1 + torch.exp(-x)))


@contextmanager
def rounded_silu(on: bool):
    import torch
    from repro_torch.models import layers
    orig = layers.F.silu
    if on:
        layers.F.silu = lambda x: xla_silu(x) if x.dtype == torch.bfloat16 else orig(x)
    try:
        yield
    finally:
        layers.F.silu = orig


def forward_pair(arch: str, silu: bool):
    """(JAX, port) ``forward_train`` logits of test_torch_train.py's batch."""
    import jax
    import torch
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    from torch_moe_routes import jax_choices, port_choices
    from torch_train_parity import batch_arrays, f32, jax_batch, port_batch, setup
    jcfg, tcfg, jp, tp = setup(arch)
    a = batch_arrays(jcfg, 2, 32)
    b, pb = jax_batch(a), port_batch(a)
    jlog = []
    with jax_choices(jlog):
        jl, _ = jax.jit(lambda p: jtfm.forward_train(
            jcfg, p, b.tokens, inputs_embeds=b.inputs_embeds, embed_mask=b.embed_mask,
            enc_feats=b.enc_feats, remat=False, q_chunk=16))(jp)
        jl.block_until_ready()
    with torch.no_grad(), rounded_silu(silu), \
            port_choices([], force=jlog if jcfg.moe is not None else None):
        tl, _ = ttfm.forward_train(tcfg, tp, pb.tokens, inputs_embeds=pb.inputs_embeds,
                                   embed_mask=pb.embed_mask, enc_feats=pb.enc_feats,
                                   remat=False, q_chunk=16)
    return f32(jl), f32(tl)


def decode_pair(silu: bool, tokens_in=None):
    """test_torch_whisper.py's prefill and 2 decode steps, each side on
    its own encoder: (JAX logits (3, B, V), port logits, the tokens fed)."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import transformer as jtfm
    from repro_torch.models import transformer as ttfm
    from torch_train_parity import f32, setup
    jcfg, tcfg, jp, tp = setup("whisper-large-v3-smoke")
    B, S = 2, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feats = rng.normal(0, 1, (B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    je = jax.jit(lambda p, f: jtfm.run_encoder(jcfg, p, f, q_chunk=16))(jp, jnp.asarray(feats))
    jkv = jax.jit(lambda p, e: jtfm.build_cross_kv(jcfg, p, e))(jp, je)
    jc = jtfm.init_caches(jcfg, B, S + 4)
    jc = jtfm.Caches(jc.blocks, jkv)
    jl, jc, _ = jax.jit(lambda p, t, c: jtfm.prefill(jcfg, p, t, c))(jp, jnp.asarray(tokens), jc)
    step = jax.jit(lambda p, t, c, n: jtfm.decode_step(jcfg, p, t, c, n))
    js, ts, fed = [f32(jl)], [], []
    with torch.no_grad(), rounded_silu(silu):
        tkv = ttfm.build_cross_kv(tcfg, tp, ttfm.run_encoder(tcfg, tp, torch.from_numpy(feats),
                                                             q_chunk=16))
        tc = ttfm.init_caches(tcfg, B, S + 4)
        tc = ttfm.Caches(tc.blocks, tkv)
        tl, tc, _ = ttfm.prefill(tcfg, tp, torch.from_numpy(tokens).long(), tc)
        ts.append(f32(tl))
        for i in range(2):
            tok = (np.argmax(js[-1], -1)[:, None].astype(np.int32) if tokens_in is None
                   else tokens_in[i])
            fed.append(tok)
            jl, jc = step(jp, jnp.asarray(tok), jc, S + i)
            js.append(f32(jl))
            tl, tc = ttfm.decode_step(tcfg, tp, torch.from_numpy(tok).long(), tc, S + i)
            ts.append(f32(tl))
    return np.stack(js), np.stack(ts), np.stack(fed)


def gap(a, b) -> float:
    return float(np.abs(a - b).max())


def per_op_readings() -> None:
    """Each op of whisper's decoder prefill (every op rounded, XLA's silu
    in the port) on the JAX package's own input."""
    import jax
    import jax.numpy as jnp
    import torch
    from repro.models import layers as jl
    from repro.models import transformer as jtfm
    from repro_torch.models import layers as tl
    from repro_torch.models import transformer as ttfm
    from torch_train_parity import f32, setup
    jcfg, tcfg, jp, tp = setup("whisper-large-v3-smoke")
    B, S = 2, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    feats = rng.normal(0, 1, (B, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    je = jax.jit(lambda p, f: jtfm.run_encoder(jcfg, p, f, q_chunk=16))(jp, jnp.asarray(feats))
    jkv = jax.jit(lambda p, e: jtfm.build_cross_kv(jcfg, p, e))(jp, je)

    def t(x):
        return torch.from_numpy(f32(x)).to(torch.bfloat16 if x.dtype == jnp.bfloat16
                                          else torch.float32)

    def show(name, a, b):
        a, b = f32(a), f32(b)
        top = float(np.abs(a).max())
        step = 2.0 ** (np.floor(np.log2(top)) - 7)
        print(f"  {name}: {gap(a, b) / step:.3g} bf16 steps of its largest output "
              f"({top:.4g}); {float(np.mean(a != b)):.4f} of elements differ", flush=True)

    norm = jax.jit(lambda p, x: jl.rmsnorm(p, x, jcfg.norm_eps))
    attn = jax.jit(lambda p, x, pos, c: jl.attention_block(
        p, jcfg, x, pos, None, cache=c, cache_offset=jnp.int32(0), cache_len=S + 4)[0])
    cross = jax.jit(lambda p, x, kv: jl.cross_attention_block(p, jcfg, x, kv))
    mlp = jax.jit(jl.mlp_block)
    h = jp["embed"][jnp.asarray(tokens)]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S)).astype(jnp.int32)
    zeros = lambda: jnp.zeros((B, S + 4, jcfg.n_kv, jcfg.d_head), jnp.bfloat16)  # noqa: E731
    with torch.no_grad(), rounded_silu(True):
        for li in range(jcfg.repeats):
            print(f" decoder layer {li}:")
            lp = jax.tree_util.tree_map(lambda x: x[li], jp["blocks"][0])
            tlp = jax.tree_util.tree_map(t, lp)
            x = norm(lp["ln1"], h)
            show("ln1", x, tl.rmsnorm(tlp["ln1"], t(h), tcfg.norm_eps))
            a = attn(lp["mixer"], x, pos, jl.KVCache(zeros(), zeros()))
            tc = tl.KVCache(t(zeros()), t(zeros()))
            show("self attention", a, tl.attention_block(
                tlp["mixer"], tcfg, t(x), t(pos).int(), None, cache=tc, cache_offset=0,
                cache_len=S + 4)[0])
            show("h + attention", h + a, t(h) + t(a))
            h = h + a
            x = norm(lp["lnx"], h)
            show("lnx", x, tl.rmsnorm(tlp["lnx"], t(h), tcfg.norm_eps))
            kv = (jkv[0][li], jkv[1][li])
            c = cross(lp["xattn"], x, kv)
            show("cross attention", c, tl.cross_attention_block(
                tlp["xattn"], tcfg, t(x), (t(kv[0]), t(kv[1]))))
            h = h + c
            x = norm(lp["ln2"], h)
            show("ln2", x, tl.rmsnorm(tlp["ln2"], t(h), tcfg.norm_eps))
            m = mlp(lp["ffn"], x)
            show("mlp (silu as XLA's)", m, tl.mlp_block(tlp["ffn"], t(x)))
            h = h + m
        hn = jl.rmsnorm(jp["final_norm"], h, jcfg.norm_eps)[:, -1]
        show("head (the reference rounds it to bf16)",
             jax.jit(lambda p, x: jtfm.lm_logits(jcfg, p, x))(jp, hn),
             ttfm.lm_logits(tcfg, tp, t(hn)))


def child(out: str, tokens_path: str) -> None:
    flags = os.environ.get("XLA_FLAGS") or "default"
    ref = {}
    for arch in ARCHS:
        jlg, tlg = forward_pair(arch, False)
        _, tls = forward_pair(arch, True)
        ref[arch] = jlg
        print(f"[XLA {flags}] forward_train {arch}: port {gap(jlg, tlg):.4g}, port with "
              f"XLA's silu {gap(jlg, tls):.4g}", flush=True)
    toks = np.load(tokens_path) if os.path.exists(tokens_path) else None
    jd, td, fed = decode_pair(False, toks)
    _, tds, _ = decode_pair(True, fed)
    np.save(tokens_path, fed)
    ref["decode"] = jd
    fmt = lambda a, b: ", ".join(f"{gap(x, y):.4g}" for x, y in zip(a, b))  # noqa: E731
    print(f"[XLA {flags}] whisper prefill, decode 1, decode 2: port {fmt(jd, td)}; port "
          f"with XLA's silu {fmt(jd, tds)}", flush=True)
    np.savez(out, **ref)
    if flags != "default":
        per_op_readings()


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(sys.argv[2], sys.argv[3])
        return
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for flags in (None, STRICT):
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)
            if flags:
                env["XLA_FLAGS"] = flags
            runs.append(os.path.join(tmp, f"{len(runs)}.npz"))
            subprocess.run([sys.executable, __file__, "--child", runs[-1],
                            os.path.join(tmp, "tokens.npy")], env=env, check=True)
        a, b = np.load(runs[0]), np.load(runs[1])
        for k in a.files:
            if k == "decode":
                print("the JAX package, default flags vs every op rounded: whisper prefill, "
                      "decode 1, decode 2: "
                      + ", ".join(f"{gap(x, y):.4g}" for x, y in zip(a[k], b[k])))
            else:
                print(f"the JAX package, default flags vs every op rounded: forward_train "
                      f"{k}: {gap(a[k], b[k]):.4g}")


if __name__ == "__main__":
    main()
