"""Configuration dataclasses for the repro framework.

Every architecture in ``repro/configs/<id>.py`` instantiates ``ModelCfg``.
Configs are frozen dataclasses so they can be closed over by jit'd
functions and hashed for compilation caches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoECfg:
    """Mixture-of-Experts sub-config (token-choice top-k routing)."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    # Snowflake-Arctic-style dense residual MLP running in parallel with
    # the routed experts.
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_jitter: float = 0.0


@dataclass(frozen=True)
class SSMCfg:
    """Mamba-2 (SSD) sub-config."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ViTCfg:
    """Vision-encoder sub-config (the CodecFlow pruning target)."""

    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    d_ff: int = 2048
    patch: int = 14          # pixels per ViT patch edge
    image: int = 448         # input resolution (square)
    group: int = 2           # pixel-unshuffle group edge (2x2 -> 1 token)

    @property
    def patches_per_side(self) -> int:
        return self.image // self.patch

    @property
    def n_patches(self) -> int:
        return self.patches_per_side ** 2

    @property
    def groups_per_side(self) -> int:
        return self.patches_per_side // self.group

    @property
    def n_groups(self) -> int:
        return self.groups_per_side ** 2


@dataclass(frozen=True)
class CodecCfg:
    """Software codec + CodecFlow policy knobs (paper §3, §6.3)."""

    gop: int = 16              # frames per GOP (paper optimum)
    block: int = 16            # macroblock edge in pixels
    search_radius: int = 4     # motion-search radius in pixels
    mv_threshold: float = 0.25  # tau, pixels (paper optimum)
    alpha: float = 0.0         # residual weight in Eq. 3 (paper default: 0)
    window_frames: int = 16    # w: frames per sliding window
    stride_frames: int = 4     # s: frames advanced per step (20% ~ paper)
    fps: int = 2
    keep_ratio: float = 0.5    # static pruning capacity (TPU adaptation)


@dataclass(frozen=True)
class ModelCfg:
    """Unified architecture description covering all assigned families."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # Per-layer mixer pattern, tiled over n_layers.  Entries: 'attn'|'mamba'.
    block_pattern: Tuple[str, ...] = ("attn",)
    # FFN kind per pattern position: 'dense'|'moe'.  len == len(block_pattern).
    ffn_pattern: Tuple[str, ...] = ("dense",)

    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None

    # Sliding-window attention (enables long_500k for non-SSM archs).
    sliding_window: Optional[int] = None

    # Encoder-decoder (whisper): n_layers is the decoder depth.
    enc_dec: bool = False
    enc_layers: int = 0
    enc_seq: int = 1500              # stub audio frontend output length

    # VLM: language model consumes stub ViT patch embeddings.
    vit: Optional[ViTCfg] = None
    img_tokens: int = 0              # visual tokens per frame after projector

    # Tie input/output embeddings (small models).
    tied_embeddings: bool = False

    source: str = ""                 # provenance citation

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if len(self.ffn_pattern) != len(self.block_pattern):
            if len(self.ffn_pattern) == 1:
                object.__setattr__(
                    self, "ffn_pattern", self.ffn_pattern * len(self.block_pattern)
                )
            else:
                raise ValueError("ffn_pattern must match block_pattern length")
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"n_layers={self.n_layers} not divisible by pattern period "
                f"{len(self.block_pattern)}"
            )

    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def repeats(self) -> int:
        return self.n_layers // self.period

    def block_kind(self, pos: int) -> Tuple[str, str]:
        return self.block_pattern[pos], self.ffn_pattern[pos]

    # ------------------------------------------------------------------
    # Parameter count (for 6*N*D MODEL_FLOPS and memory estimates).
    def param_count(self, active_only: bool = False) -> int:
        d, dh = self.d_model, self.d_head
        n = 0
        n += self.vocab * d                      # embed
        if not self.tied_embeddings:
            n += self.vocab * d                  # lm head
        per_pos = []
        for pos in range(self.period):
            mixer, ffn = self.block_kind(pos)
            p = 2 * d                            # 2 rmsnorm scales
            if mixer == "attn":
                p += d * (self.n_heads * dh) + 2 * d * (self.n_kv * dh)
                p += (self.n_heads * dh) * d
                if self.qkv_bias:
                    p += (self.n_heads + 2 * self.n_kv) * dh
            else:
                s = self.ssm
                di = s.d_inner(d)
                nh = s.n_heads(d)
                proj_in = di * 2 + 2 * s.n_groups * s.d_state + nh
                p += d * proj_in + di * d
                p += (di + 2 * s.n_groups * s.d_state) * s.d_conv
                p += nh * 2 + di                 # A_log, D, gated-norm scale
            if ffn == "moe":
                m = self.moe
                e_all = m.n_experts
                e_act = m.top_k
                per_exp = 3 * d * m.d_ff_expert
                p += d * e_all                   # router
                p += per_exp * (e_act if active_only else e_all)
                if m.dense_residual:
                    p += 3 * d * self.d_ff
            elif ffn == "none":
                p -= d                           # no ln2
            else:
                p += 3 * d * self.d_ff           # gate/up/down
            per_pos.append(p)
        n += self.repeats * sum(per_pos)
        if self.enc_dec:
            # encoder self-attn + ffn + decoder cross-attn (approx).
            enc = self.enc_layers * (
                4 * d * self.n_heads * dh + 2 * d * self.d_ff + 2 * d
            )
            xattn = self.n_layers * (
                d * self.n_heads * dh + 2 * d * self.n_kv * dh
                + self.n_heads * dh * d + d
            )
            n += enc + xattn
        if self.vit is not None:
            v = self.vit
            n += v.n_layers * (4 * v.d_model ** 2 + 2 * v.d_model * v.d_ff)
            n += v.d_model * (v.group ** 2) * d  # projector
        return n


@dataclass(frozen=True)
class ShapeCfg:
    """An assigned input shape (see task header)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                        # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def smoke_variant(cfg: ModelCfg) -> ModelCfg:
    """Reduced same-family config: 2 periods of layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    d_head = d // n_heads
    n_kv = max(1, min(cfg.n_kv, n_heads))
    if n_heads % n_kv:
        n_kv = 1
    period = cfg.period
    n_layers = 2 * period if period > 1 else 2
    kw = dict(
        name=cfg.name + "-smoke",
        family=cfg.family,
        n_layers=n_layers,
        d_model=d,
        n_heads=n_heads,
        n_kv=n_kv,
        d_head=d_head,
        d_ff=min(cfg.d_ff, 512) if "none" not in cfg.ffn_pattern else 0,
        vocab=min(cfg.vocab, 1024),
        qkv_bias=cfg.qkv_bias,
        block_pattern=cfg.block_pattern,
        ffn_pattern=cfg.ffn_pattern,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else None,
        enc_dec=cfg.enc_dec,
        enc_layers=2 if cfg.enc_dec else 0,
        enc_seq=32 if cfg.enc_dec else cfg.enc_seq,
        img_tokens=min(cfg.img_tokens, 16) if cfg.img_tokens else 0,
        tied_embeddings=True,
        source=cfg.source,
    )
    if cfg.moe is not None:
        kw["moe"] = MoECfg(
            n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=min(cfg.moe.d_ff_expert, 256),
            dense_residual=cfg.moe.dense_residual,
            capacity_factor=2.0,
        )
    if cfg.ssm is not None:
        kw["ssm"] = SSMCfg(
            d_state=16, d_conv=4, expand=2, head_dim=32,
            n_groups=1, chunk=16,
        )
    if cfg.vit is not None:
        kw["vit"] = ViTCfg(
            n_layers=2, d_model=128, n_heads=4, d_ff=256,
            patch=14, image=112, group=2,
        )
    return ModelCfg(**kw)
