"""Architecture registry: ``arch`` id -> (config, model builder)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm

_CONFIG_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "qwen2.5-32b": "repro_torch.configs.qwen25_32b",
}

ARCHS = tuple(_CONFIG_MODULES)

# Families the port does not run yet, with the ROADMAP.md item porting them.
_PENDING = {
    "moe": "queue 1 item 9 (MoE)",
    "ssm": "queue 1 item 8 (mamba2/zamba2)",
    "hybrid": "queue 1 item 8 (mamba2/zamba2)",
    "encdec": "queue 1 item 10 (whisper, VLM)",
    "vlm": "queue 1 item 10 (whisper, VLM)",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_CONFIG_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def build_model(cfg: ModelConfig, device=None) -> cm.ModelApply:
    """The model for ``cfg`` on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"`` is given)."""
    if cfg.family != "dense":
        if cfg.family in _PENDING:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md "
                f"{_PENDING[cfg.family]}"
            )
        raise ValueError(f"unknown family: {cfg.family}")
    from repro_torch.models import transformer

    return transformer.build(cfg, resolve_device(device))
