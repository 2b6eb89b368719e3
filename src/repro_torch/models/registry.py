"""Architecture registry: ``arch`` id -> (config, model builder)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm

_CONFIG_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2.5-32b": "repro_torch.configs.qwen25_32b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_27b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
}

ARCHS = tuple(_CONFIG_MODULES)

# Families the port does not run yet, with the title of the ROADMAP.md
# queue 1 item porting them (titles, not item numbers, which shift).
_WHISPER_VLM = "models/whisper.py (encdec) and the VLM cross-attention layers"
_PENDING = {"encdec": _WHISPER_VLM, "vlm": _WHISPER_VLM}
_MODULES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.transformer",
    "ssm": "repro_torch.models.mamba2",
    "hybrid": "repro_torch.models.zamba2",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_CONFIG_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def build_model(cfg: ModelConfig, device=None) -> cm.ModelApply:
    """The model for ``cfg`` on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"`` is given)."""
    if cfg.family not in _MODULES:
        if cfg.family in _PENDING:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md "
                f"queue 1, the item {_PENDING[cfg.family]!r}"
            )
        raise ValueError(f"unknown family: {cfg.family}")
    module = importlib.import_module(_MODULES[cfg.family])
    return module.build(cfg, resolve_device(device))
