"""Architecture registry: ``arch`` id -> (config, model builder)."""
from __future__ import annotations

import importlib

import torch

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
    "whisper-small": "repro_torch.configs.whisper_small",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
}

ARCHS = tuple(_CONFIG_MODULES)

_MODULES = {
    "dense": "repro_torch.models.transformer",
    "moe": "repro_torch.models.transformer",
    "ssm": "repro_torch.models.mamba2",
    "hybrid": "repro_torch.models.zamba2",
    "encdec": "repro_torch.models.whisper",
    "vlm": "repro_torch.models.transformer",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(_CONFIG_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


# The families whose forward and loss run split over a mesh's ``model``
# axis (``distributed.tensor_parallel``): every family.
TENSOR_PARALLEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def build_model(cfg: ModelConfig, device=None, mesh=None) -> cm.ModelApply:
    """The model for ``cfg`` on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"`` is given).

    ``mesh`` (a ``(data, model)`` DeviceMesh) with ``model`` larger than 1
    makes ``init``, ``forward`` and ``loss`` tensor and expert parallel
    over ``model``: each rank holds its ``sharding.param_spec`` block of
    every leaf, and the collectives run inside the model code.  Every
    family (:data:`TENSOR_PARALLEL_FAMILIES`); the split model's cache
    entry points refuse, since serving runs on one rank."""
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family: {cfg.family}")
    from repro_torch.distributed.tensor_parallel import model_parallel
    from repro_torch.launch.mesh import axis_sizes

    module = importlib.import_module(_MODULES[cfg.family])
    if mesh is None or axis_sizes(mesh).get("model", 1) == 1:
        return module.build(cfg, resolve_device(device))
    if cfg.family not in TENSOR_PARALLEL_FAMILIES:
        raise NotImplementedError(
            f"{cfg.arch}: the {cfg.family} family has no tensor-parallel "
            f"execution over 'model'; use a mesh with model = 1")
    return module.build(cfg, resolve_device(device),
                        model_parallel(cfg, mesh))


def param_shapes(cfg: ModelConfig):
    """The whole model's parameter tree as meta tensors (the one-process
    shapes, nothing allocated): what the sharding rules read, whatever
    block of each leaf a rank holds."""
    module = importlib.import_module(_MODULES[cfg.family])
    return module.build(cfg, torch.device("meta")).init(None)
