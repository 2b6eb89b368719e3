"""PyTorch/CUDA port of the ``repro`` serving stack and cache-policy engine
for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing of
it (nor ``jax``) and mirrors its layout: ``hw``, ``core/``, ``configs/``,
``models/``, ``kernels/``, ``serve/``, ``train/``, ``data/``,
``workloads/``, ``distributed/`` and ``launch/`` (its mesh only).  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
