"""Device-side sampling for the serve engine: greedy, temperature, top-k
and top-p, the port of ``repro.serve.sampling``.

The reference draws its Gumbel noise from JAX's threefry generator with
per-request keys ``fold_in(fold_in(PRNGKey(0x5EED), seed), token_index)``.
This module writes the same algorithm out in torch ops, so a key, the
random bits it expands to and their uniforms are bitwise what JAX computes:

* ``threefry2x32``: the 20-round Threefry-2x32 block cipher over int64
  tensors that hold uint32 values (every sum and shift is masked back to
  32 bits, so nothing overflows);
* ``sample_keys``: the two ``fold_in`` steps, each ``threefry(key, (0, x))``;
* ``random_bits``: ``jax.random.bits`` under partitionable counters,
  ``threefry(key, (0, i)) -> y0 ^ y1`` for counter ``i``;
* ``uniform``: the mantissa trick, ``(bits >> 9) | 0x3F800000`` as fp32,
  minus 1, scaled to ``[tiny, 1)``;
* ``gumbel``: ``-log(-log(u))``.  Only ``log`` differs from XLA's, by one
  ulp on some inputs, so the noise agrees to about 1e-6 and a draw agrees
  wherever the top two perturbed scores are further apart than that.

Keys travel as (n, 2) int64 tensors of uint32 values.  Every function has
static shapes and reads nothing back to the host, so the samplers run
inside the engine's captured decode chunk.  The key of token ``i`` of a
request with seed ``s`` depends on ``(s, i)`` only, never on the slot, so
reordered submissions, preemption and speculative verification all
reproduce the same stream.
"""
from __future__ import annotations

import dataclasses

import torch

# Folding a per-request seed and a per-request token index into this base
# key gives each (request, position) pair an independent stream.
_BASE_KEY = 0x5EED
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An integer tensor's values reinterpreted as uint32, held in int64
    (negative int32 seeds wrap as JAX's uint32 cast wraps them)."""
    return x.to(torch.int64) & _M32


def threefry2x32(k0, k1, x0, x1) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pair ``(x0, x1)`` under the
    key ``(k0, k1)``; all int64 tensors of uint32 values, broadcast
    together.  Returns the output pair, uint32 values in int64."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _fold_in(k0, k1, data):
    """``jax.random.fold_in``: the key hashed with the counter (0, data)."""
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def sample_keys(seeds: torch.Tensor, tok_idx: torch.Tensor) -> torch.Tensor:
    """Per-row keys ``fold_in(fold_in(PRNGKey(0x5EED), seed), idx)``.

    ``seeds``/``tok_idx``: (n,) integer tensors -> (n, 2) int64 keys of
    uint32 values, equal to ``repro.serve.sampling.sample_keys``."""
    seeds, idx = _u32(seeds), _u32(tok_idx)
    base = torch.zeros_like(seeds)
    k0, k1 = _fold_in(base, base + _BASE_KEY, seeds)
    return torch.stack(_fold_in(k0, k1, idx), dim=-1)


def random_bits(keys: torch.Tensor, width: int) -> torch.Tensor:
    """``jax.random.bits(key, (width,), uint32)`` for each row's key under
    partitionable counters: (n, 2) keys -> (n, width) uint32 values in
    int64."""
    counter = torch.arange(width, dtype=torch.int64,
                           device=keys.device)[None, :]
    y0, y1 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(counter),
                          counter)
    return y0 ^ y1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(minval=tiny, maxval=1)`` in fp32 from its 32
    random bits: the top 23 as the mantissa of a float in [1, 2), minus 1,
    scaled by (1 - tiny) (1 in fp32), shifted by tiny, at least tiny."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min((f - 1.0) * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(keys: torch.Tensor, width: int) -> torch.Tensor:
    """Standard Gumbel noise, JAX's low-range mode: -log(-log(u))."""
    return -torch.log(-torch.log(uniform(random_bits(keys, width))))


@dataclasses.dataclass(frozen=True)
class Sampler:
    """greedy | temperature | top_k | top_p over the last-position
    logits."""

    mode: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    def __post_init__(self):
        if self.mode not in ("greedy", "temperature", "top_k", "top_p"):
            raise ValueError(f"unknown sampling mode: {self.mode!r}")
        if self.mode == "top_k" and self.top_k < 1:
            raise ValueError("top_k mode needs top_k >= 1")
        if self.mode == "top_p" and not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p mode needs 0 < top_p <= 1")

    @classmethod
    def from_config(cls, cfg) -> "Sampler":
        return cls(mode=cfg.sampling, temperature=cfg.temperature,
                   top_k=cfg.top_k, top_p=cfg.top_p)

    @property
    def needs_keys(self) -> bool:
        return self.mode != "greedy"

    def _mask_logits(self, lf: torch.Tensor) -> torch.Tensor:
        """The mode's support restriction on (n, v) fp32 logits."""
        v = lf.shape[-1]
        if self.mode == "top_k":
            kth = torch.topk(lf, min(self.top_k, v), dim=-1).values[:, -1:]
            return torch.where(lf >= kth, lf, -torch.inf)
        if self.mode == "top_p":
            desc = torch.sort(lf, dim=-1, descending=True).values
            probs = torch.softmax(desc, dim=-1)
            csum = torch.cumsum(probs, dim=-1)
            # Keep the smallest prefix whose mass reaches top_p: a token
            # survives iff the mass strictly before it is < top_p (the
            # first token always survives).
            keep = (csum - probs) < self.top_p
            thr = torch.where(keep, desc, torch.inf).amin(dim=-1,
                                                           keepdim=True)
            return torch.where(lf >= thr, lf, -torch.inf)
        return lf

    def __call__(self, logits: torch.Tensor,
                 keys: torch.Tensor | None = None) -> torch.Tensor:
        """(n, v) or (n, s, v) logits -> (n,) int32 tokens (3-D logits
        sample the last position).  ``keys`` ((n, 2), from
        :func:`sample_keys`) is required by the stochastic modes and
        ignored by greedy."""
        if logits.dim() == 3:
            logits = logits[:, -1]
        lf = logits.float()
        if self.mode == "greedy":
            return lf.argmax(dim=-1).to(torch.int32)
        if keys is None:
            raise ValueError(f"{self.mode} sampling needs PRNG keys")
        # Gumbel-max over temperature-scaled, support-masked logits: as the
        # temperature goes to 0 the scaled gaps dwarf the noise and the
        # draw is the argmax.
        lf = self._mask_logits(lf / max(self.temperature, 1e-8))
        return (gumbel(keys, lf.shape[-1]) + lf).argmax(dim=-1).to(
            torch.int32)
