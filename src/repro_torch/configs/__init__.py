"""Model configurations: the paper's networks (:mod:`.papernets`) and the
language-model zoo's architectures (``get_config(arch_id)`` / ``ARCHS``),
copies of ``src/repro/configs`` so that ``--arch`` names match."""
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    Shape,
    skipped_shapes,
    supported_shapes,
)

from repro_torch.configs.internvl2_2b import ARCH as internvl2_2b
from repro_torch.configs.granite_moe_1b import ARCH as granite_moe_1b
from repro_torch.configs.deepseek_v2_lite import ARCH as deepseek_v2_lite
from repro_torch.configs.stablelm_1_6b import ARCH as stablelm_1_6b
from repro_torch.configs.gemma3_12b import ARCH as gemma3_12b
from repro_torch.configs.h2o_danube3_4b import ARCH as h2o_danube3_4b
from repro_torch.configs.codeqwen15_7b import ARCH as codeqwen15_7b
from repro_torch.configs.whisper_tiny import ARCH as whisper_tiny
from repro_torch.configs.rwkv6_3b import ARCH as rwkv6_3b
from repro_torch.configs.hymba_1_5b import ARCH as hymba_1_5b

ARCHS = {
    c.name: c
    for c in [
        internvl2_2b, granite_moe_1b, deepseek_v2_lite, stablelm_1_6b,
        gemma3_12b, h2o_danube3_4b, codeqwen15_7b, whisper_tiny,
        rwkv6_3b, hymba_1_5b,
    ]
}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "Shape", "get_config", "skipped_shapes",
           "supported_shapes"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
