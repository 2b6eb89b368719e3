"""Device-side sampling for the serve engine (greedy only so far).

The reference's stochastic modes (temperature / top-k / top-p) fold
per-request keys from JAX's threefry generator; they wait until that
contract is ported, and constructing them raises.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Sampler:
    mode: str = "greedy"

    def __post_init__(self):
        if self.mode in ("temperature", "top_k", "top_p"):
            raise NotImplementedError(
                f"sampling mode {self.mode!r} is not ported: it depends on "
                "the reference's threefry keys (ROADMAP.md queue 3)")
        if self.mode != "greedy":
            raise ValueError(f"unknown sampling mode: {self.mode!r}")

    @classmethod
    def from_config(cls, cfg) -> "Sampler":
        return cls(mode=cfg.sampling)

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        """(n, v) or (n, s, v) logits -> (n,) int32 argmax (3-D logits
        sample the last position)."""
        if logits.dim() == 3:
            logits = logits[:, -1]
        return logits.float().argmax(dim=-1).to(torch.int32)
