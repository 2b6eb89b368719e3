"""Architecture registry: ``arch`` id -> (config, model builder)."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import common as cm

_CONFIG_MODULES = {
    "yi-9b": "repro_torch.configs.yi_9b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen2.5-32b": "repro_torch.configs.qwen25_32b",
    "whisper-small": "repro_torch.configs.whisper_small",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_27b",
    "llama-3.2-vision-90b": "repro_torch.configs.llama32_vision_90b",
}

ARCHS = tuple(_CONFIG_MODULES)       # the reference's order

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


# The families whose every entry point runs split over a mesh's ``model``
# axis (``distributed.tensor_parallel``): ``init``, ``forward``, ``loss``
# and the cache entry points on the rank's ``sharding.cache_spec`` block
# of the cache.  Every family.
TENSOR_PARALLEL_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# The families whose ``init``, ``forward`` and ``loss`` run under FSDP
# over ``data`` (``distributed.fsdp``: ``models.transformer``).
FSDP_FAMILIES = ("dense", "moe", "vlm")
FSDP_FAMILIES_ITEM = ("FSDP over 'data' for the mamba2, zamba2 and whisper "
                      "families: ROADMAP queue 1 item 3")


def build_model(cfg: ModelConfig, device=None, mesh=None,
                fsdp: bool = False,
                grad_reduce_dtype: torch.dtype = torch.float32,
                long_context: bool = False) -> cm.ModelApply:
    """The model for ``cfg`` on ``device`` (default: the CUDA card; raises
    without one unless ``device="cpu"`` is given).

    ``mesh`` (a ``(data, model)`` DeviceMesh) with ``model`` larger than 1
    makes ``init``, ``forward`` and ``loss`` tensor and expert parallel
    over ``model``: each rank holds its ``sharding.param_spec`` block of
    every leaf, and the collectives run inside the model code.  Every
    family (:data:`TENSOR_PARALLEL_FAMILIES`), the cache entry points
    included: a rank's cache is its ``sharding.cache_spec`` block (its
    batch rows, the self K/V's sequence block over ``model``).
    ``long_context`` (with a mesh, any ``model`` size): the cache's
    sequence over ``data`` instead, the KV heads over ``model``, for a
    batch the batch axes do not split (long_500k's one sequence).

    ``fsdp`` (with a mesh, any ``model`` size) holds each rank's block of
    every leaf under ``params_shardings(..., fsdp=True)``, ``data`` on
    the large leaves too, and gathers them on use
    (``distributed.fsdp``); the dense, MoE and VLM families
    (:data:`FSDP_FAMILIES`), the others refuse by name; its gradients
    are reduce-scattered in ``grad_reduce_dtype``.  The cache entry
    points of such a model refuse."""
    if cfg.family not in _MODULES:
        raise ValueError(f"unknown family: {cfg.family}")
    from repro_torch.distributed.fsdp import DataShards
    from repro_torch.distributed.tensor_parallel import model_parallel
    from repro_torch.launch.mesh import axis_sizes

    module = importlib.import_module(_MODULES[cfg.family])
    if fsdp:
        if mesh is None:
            raise ValueError(f"{cfg.arch}: fsdp=True needs a mesh with a "
                             f"'data' axis")
        if cfg.family not in FSDP_FAMILIES:
            raise NotImplementedError(
                f"{cfg.arch}: the {cfg.family} family has no FSDP execution "
                f"(it waits on {FSDP_FAMILIES_ITEM}); build it with "
                f"fsdp=False")
        return module.build(cfg, resolve_device(device),
                            model_parallel(cfg, mesh),
                            DataShards(cfg, mesh, grad_reduce_dtype))
    if long_context:
        if mesh is None:
            raise ValueError(f"{cfg.arch}: long_context=True needs a mesh "
                             f"with a 'data' axis")
        return module.build(cfg, resolve_device(device),
                            model_parallel(cfg, mesh, long_context=True))
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


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells after the principled skips:
    long_500k only for sub-quadratic archs (the reference's list)."""
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and not cfg.subquadratic:
                continue
            cells.append((arch, shape_name))
    return cells
