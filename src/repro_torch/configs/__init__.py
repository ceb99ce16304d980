from .base import (
    CodecCfg, INPUT_SHAPES, ModelCfg, MoECfg, SSMCfg, ShapeCfg, ViTCfg,
    smoke_variant,
)
from .registry import ASSIGNED, SKIPS, all_configs, get_config, shape_plan
