"""Hand-written CUDA kernels for Hopper (sm_90a), one package per ported
Pallas kernel.

Each package ships ``csrc/*.cu`` (the kernel, a plain C interface loaded
with ctypes), ``<name>.py`` (wrappers with launch counters and the plain
PyTorch versions the CPU uses), ``ops.py`` (public entry points with split
planning) and ``ref.py`` (the oracle the tests compare against).
"""
