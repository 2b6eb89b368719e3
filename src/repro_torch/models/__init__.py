"""Model definitions in PyTorch: the dense decoder, Mamba-2 and the Zamba2
hybrid."""
from repro_torch.models.registry import ARCHS, build_model, get_config  # noqa: F401
