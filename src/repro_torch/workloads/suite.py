"""The paper's 17 MI workloads (Table 2) as analytical OpSpecs + runnable
torch functions (the port of ``repro.workloads.suite``).

Each workload carries the paper's input configuration (batch size, GPU
footprint) and its expected §VI.A class.  Calibration annotations (all
documented inline) mirror measured gem5/MIOpen behaviour:

* SGEMM/DGEMM: ``achieved_eff=0.3`` — the paper finds these COMPUTE-bound on
  a 12.3 TFLOP/s GPU despite modest arithmetic intensity, implying ~30% of
  peak for MIOpenGEMM's short-K kernels in gem5.
* FwLRN: the cross-channel window reuse is modeled as UNREALIZABLE
  (reuse_distance ~ footprint) because MIOpen's LRN kernel interleaves
  images across the batch — the paper groups LRN with the no-reuse
  throughput-sensitive class.
* RNN cells: per-step cell kernels reuse gate inputs ~4x within small
  windows; FwBw adds write-coalescible wgrad accumulation (paper: write
  caching wins up to 32% on Bw* workloads).

A runnable is split in two: ``inputs(generator)`` draws its tensors on the
generator's device and ``compute(*inputs)`` is the computation, so it can
be fed any inputs (the tests feed it the reference's).  DGEMM's runnable
is float64 under ``build_suite(x64=True)``, float32 otherwise (the
reference picks by ``jax_enable_x64`` at import).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.characterize import (
    conv2d_op,
    elementwise_op,
    matmul_op,
    rowwise_op,
    window_op,
)
from repro_torch.core.policy import OperandProfile, OpSpec, WorkloadClass

MB = 1024 * 1024


def _with_eff(op: OpSpec, eff: float) -> OpSpec:
    return dataclasses.replace(op, meta={**op.meta, "achieved_eff": eff})


@dataclasses.dataclass(frozen=True)
class Runnable:
    """A scaled-down version of a workload: ``inputs(generator)`` -> the
    input tensors, ``compute(*inputs)`` -> the output;
    ``runnable(generator)`` is both."""
    inputs: Callable[[torch.Generator], tuple]
    compute: Callable[..., torch.Tensor]

    def __call__(self, generator: torch.Generator) -> torch.Tensor:
        return self.compute(*self.inputs(generator))


@dataclasses.dataclass
class Workload:
    name: str
    ops: list[OpSpec]
    launches: int                     # total kernels (Table 2)
    footprint_bytes: float
    expected: WorkloadClass
    runnable: Runnable | None = None  # scaled-down torch version


def _normal(gen: torch.Generator, shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)


def _runnable_elementwise(elems):
    return Runnable(lambda gen: (_normal(gen, (elems,)),), torch.relu)


def _runnable_softmax(rows, row_len):
    return Runnable(lambda gen: (_normal(gen, (rows, row_len)),),
                    lambda x: torch.softmax(x, dim=-1))


def _runnable_matmul(m, k, n, dtype=torch.float32):
    def inputs(gen):
        # Both operands from the same generator state, as the reference
        # draws both from one key.
        state = gen.get_state()
        a = _normal(gen, (m, k), dtype)
        gen.set_state(state)
        return a, _normal(gen, (k, n), dtype)
    return Runnable(inputs, torch.matmul)


def _same_pad(size: int, window: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one dim: (low, high), the odd one high."""
    total = max((-(-size // stride) - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def max_pool_same(x: torch.Tensor, window: int = 3,
                  stride: int = 2) -> torch.Tensor:
    """``reduce_window(max, (1, 1, w, w), (1, 1, s, s), "SAME")`` on
    (n, c, h, w): the padding is -inf and uneven (none above and left, one
    row below and one column right at 128 x 128), which ``F.max_pool2d``'s
    symmetric ``padding`` cannot express, so pad first and pool with none."""
    (top, bottom), (left, right) = (_same_pad(x.shape[2], window, stride),
                                    _same_pad(x.shape[3], window, stride))
    x = torch.nn.functional.pad(x, (left, right, top, bottom),
                                value=float("-inf"))
    return torch.nn.functional.max_pool2d(x, window, stride)


def _runnable_pool(n, c, h, w):
    return Runnable(lambda gen: (_normal(gen, (n, c, h, w)),), max_pool_same)


def _rnn_sequence_op(hidden: int, gates: int, steps: int,
                     name: str) -> OpSpec:
    """Weight streaming across the timestep loop.

    The 0.38MB-footprint RNNs are reuse-sensitive in the paper because the
    cell weights (fitting easily in L2/VMEM) are re-touched every timestep;
    with caching they are fetched once.  batch=1 GEMVs run at low MXU
    efficiency (achieved_eff 0.15)."""
    eb = 4
    w_bytes = 2 * hidden * hidden * gates * eb   # input + recurrent weights
    io_bytes = steps * hidden * (gates + 2) * eb
    w = OperandProfile(
        name="w", role="input", shape=(2 * hidden, hidden * gates),
        dtype="f32", unique_bytes=w_bytes,
        touched_bytes_stream=w_bytes * steps,
        reuse_window_bytes=w_bytes,
    )
    h = OperandProfile(
        name="h", role="input", shape=(steps, hidden), dtype="f32",
        unique_bytes=io_bytes,
        touched_bytes_stream=io_bytes * gates,      # gates re-read h/c
        reuse_window_bytes=hidden * (gates + 2) * eb,
    )
    out = OperandProfile(
        name="out", role="output", shape=(steps, hidden), dtype="f32",
        unique_bytes=io_bytes, touched_bytes_stream=io_bytes, revisits=1,
    )
    flops = steps * 2 * (2 * hidden) * hidden * gates
    return OpSpec(kind="rnn_cell", name=name, operands=(w, h, out),
                  flops=flops, dtype="f32",
                  meta={"achieved_eff": 0.15, "elems": steps * hidden})


def _rnn_ops(hidden: int, gates: int, steps: int, bwd: bool, name: str):
    ops = [_rnn_sequence_op(hidden, gates, steps, name)]
    if bwd:
        # wgrad accumulates partial sums over timesteps: the writes are
        # coalescible (split-K style revisits) — the Bw* write-caching win.
        wg = matmul_op(hidden * 2, steps, hidden * gates, dtype="f32",
                       bm=64, bn=64, bk=16, split_k=steps, name=name + "_wg")
        ops.append(_with_eff(wg, 0.15))
        ops.append(_rnn_sequence_op(hidden, gates, steps, name + "_dgrad"))
    return ops


def build_suite(x64: bool = False) -> dict[str, Workload]:
    """The 17 workloads by name; ``x64`` makes DGEMM's runnable float64."""
    C = WorkloadClass
    suite: dict[str, Workload] = {}

    def add(name, ops, launches, footprint_mb, expected, runnable=None):
        suite[name] = Workload(
            name, ops, launches, footprint_mb * MB, expected, runnable
        )

    # --- elementwise activations (throughput-sensitive) -------------------
    add("FwAct", [elementwise_op(200_000_000, dtype="f32", name="FwAct")],
        1, 1600, C.THROUGHPUT_SENSITIVE, _runnable_elementwise(1 << 20))
    add("BwAct",
        [elementwise_op(200_000_000, n_inputs=2, dtype="f32", name="BwAct")],
        1, 2400, C.THROUGHPUT_SENSITIVE, _runnable_elementwise(1 << 20))

    # --- normalization -----------------------------------------------------
    add("FwBN", [rowwise_op(256, 20480, passes=2, dtype="f32", name="FwBN")],
        1, 42, C.REUSE_SENSITIVE, _runnable_softmax(256, 1024))
    bwbn = rowwise_op(512, 1440, passes=3, dtype="f32", name="BwBN")
    # BwBN's dgamma/dbeta partial sums revisit the output: coalescible.
    ops = list(bwbn.operands)
    out = dataclasses.replace(ops[-1], revisits=4)
    bwbn = dataclasses.replace(bwbn, operands=(*ops[:-1], out))
    add("BwBN", [bwbn], 1, 5.88, C.REUSE_SENSITIVE)
    add("FwLRN",
        [window_op(600_000_000, 5, 1, reuse_distance_elems=120_000_000,
                   loads_per_out=2.0, dtype="f32", name="FwLRN")],
        1, 2400, C.THROUGHPUT_SENSITIVE)

    # --- pooling (3x3 stride-2: 2.25x overlapped reads) --------------------
    add("FwPool",
        [window_op(96_000_000, 9, 4, reuse_distance_elems=20_000,
                   loads_per_out=9.0, dtype="f32", name="FwPool")],
        1, 480, C.REUSE_SENSITIVE, _runnable_pool(4, 16, 128, 128))
    bwpool = window_op(50_000_000, 9, 4, reuse_distance_elems=20_000,
                       loads_per_out=9.0, dtype="f32", name="BwPool")
    ops = list(bwpool.operands)
    out = dataclasses.replace(
        ops[-1], revisits=2,
        unique_bytes=ops[0].unique_bytes,          # dx is input-sized
        touched_bytes_stream=ops[0].unique_bytes,
    )
    bwpool = dataclasses.replace(bwpool, operands=(*ops[:-1], out))
    add("BwPool", [bwpool], 1, 252, C.REUSE_SENSITIVE)

    # --- softmax ------------------------------------------------------------
    add("FwSoft", [rowwise_op(512, 5, passes=3, dtype="f32", name="FwSoft")],
        1, 0.01, C.REUSE_SENSITIVE, _runnable_softmax(512, 5))
    add("BwSoft", [rowwise_op(512, 10, passes=2, dtype="f32", name="BwSoft")],
        1, 0.02, C.REUSE_SENSITIVE)

    # --- fully connected / GEMM --------------------------------------------
    # Large well-shaped GEMM: ~75% of peak (vs 30% for the short-K SGEMM
    # benchmarks) — at that rate the uncached 2.4GB DRAM stream is the
    # bottleneck and caching wins (paper: FwFc is reuse-sensitive with a
    # 93% traffic cut).
    add("FwFc",
        [_with_eff(matmul_op(512, 9216, 4096, dtype="f32",
                             bm=64, bn=64, bk=64, name="FwFc"), 0.75)],
        1, 148.2, C.REUSE_SENSITIVE, _runnable_matmul(128, 512, 512))
    add("SGEMM",
        [_with_eff(matmul_op(4096, 128, 4096, dtype="f32",
                             bm=64, bn=64, bk=64, name="SGEMM"), 0.3)],
        1, 68, C.MEMORY_INSENSITIVE, _runnable_matmul(512, 128, 512))
    add("DGEMM",
        [_with_eff(matmul_op(4096, 128, 4096, dtype="f64",
                             bm=64, bn=64, bk=64, name="DGEMM"), 0.3)],
        1, 132, C.MEMORY_INSENSITIVE,
        _runnable_matmul(512, 128, 512,
                         torch.float64 if x64 else torch.float32))

    # --- RNNs (batch 1, seq 16, hidden 128) ---------------------------------
    add("FwLSTM", _rnn_ops(128, 4, 16, False, "FwLSTM"), 150,
        0.38, C.REUSE_SENSITIVE)
    add("FwGRU", _rnn_ops(128, 3, 16, False, "FwGRU"), 150,
        0.38, C.REUSE_SENSITIVE)
    add("FwBwLSTM", _rnn_ops(128, 4, 16, True, "FwBwLSTM"), 363,
        0.48, C.REUSE_SENSITIVE)
    add("FwBwGRU", _rnn_ops(128, 3, 16, True, "FwBwGRU"), 363,
        0.48, C.REUSE_SENSITIVE)

    # --- Composed Model (conv -> pool -> bn -> fc, batch 64) ----------------
    cm_ops = [
        _with_eff(conv2d_op(64, 64, 28, 28, 128, 3, 3, dtype="f32",
                            name="CM_conv"), 0.5),
        window_op(64 * 128 * 28 * 28, 9, 4, reuse_distance_elems=20_000,
                  dtype="f32", name="CM_pool"),
        rowwise_op(64, 128 * 14 * 14, passes=2, dtype="f32", name="CM_bn"),
        _with_eff(matmul_op(64, 128 * 14 * 14, 1000, dtype="f32",
                            bm=64, bn=64, bk=64, name="CM_fc"), 0.3),
    ]
    add("CM", cm_ops, 130, 12.1, C.MEMORY_INSENSITIVE)

    return suite


SUITE = build_suite()
