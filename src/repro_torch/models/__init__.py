"""Model definitions in PyTorch (dense decoder family so far)."""
from repro_torch.models.registry import ARCHS, build_model, get_config  # noqa: F401
