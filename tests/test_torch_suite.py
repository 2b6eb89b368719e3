"""The port's workload suite (``repro_torch.workloads.suite``) held against
the reference's (``repro.workloads.suite``): every workload's OpSpecs equal
field by field under ``==`` (the reference's converted into the port's
classes), its launches, footprint and expected class; each runnable's
computation on the reference's own inputs within the fp32 tolerance
(2e-3, ``tests/test_kernels.py``); DGEMM under both ``x64`` settings; the
pool's uneven ``"SAME"`` padding."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.workloads import suite as rsuite  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.workloads import suite as tsuite  # noqa: E402

TOL = dict(rtol=2e-3, atol=2e-3)


def _to_port(op):
    """A reference OpSpec converted field by field into the port's."""
    operands = tuple(
        tpol.OperandProfile(**{f.name: getattr(o, f.name)
                               for f in dataclasses.fields(o)})
        for o in op.operands)
    return tpol.OpSpec(kind=op.kind, operands=operands, flops=op.flops,
                       dtype=op.dtype, meta=dict(op.meta), name=op.name)


def test_suite_has_the_reference_workloads_in_order():
    assert list(tsuite.SUITE) == list(rsuite.SUITE)
    assert len(tsuite.SUITE) == 17


@pytest.mark.parametrize("name", list(rsuite.SUITE))
def test_workload_equals_the_reference(name):
    """OpSpecs (every field, operands included), launches, footprint,
    expected class, and whether a runnable exists."""
    want, got = rsuite.SUITE[name], tsuite.SUITE[name]
    assert got.name == want.name
    assert got.ops == [_to_port(op) for op in want.ops]
    assert got.launches == want.launches
    assert got.footprint_bytes == want.footprint_bytes
    assert got.expected.value == want.expected.value
    assert (got.runnable is None) == (want.runnable is None)


def _reference_inputs(port, key, dtype=jnp.float32):
    """The reference runnable's inputs: every one is ``normal(key, shape)``
    of the one key (the matmul's two operands share it)."""
    shapes = [t.shape for t in port.runnable.inputs(torch.Generator())]
    return [jax.random.normal(key, tuple(s), dtype) for s in shapes]


RUNNABLE = [n for n, w in rsuite.SUITE.items() if w.runnable is not None]


@pytest.mark.parametrize("name", RUNNABLE)
def test_runnable_matches_the_reference_on_its_inputs(name):
    key = jax.random.PRNGKey(7)
    port = tsuite.SUITE[name]
    want = np.asarray(rsuite.SUITE[name].runnable(key))
    xs = [torch.from_numpy(np.asarray(x))
          for x in _reference_inputs(port, key)]
    got = port.runnable.compute(*xs)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name", RUNNABLE)
def test_runnable_draws_on_the_generator_device(name):
    """``runnable(generator)``: seeded, repeatable, finite, the reference's
    output shape."""
    run = tsuite.SUITE[name].runnable
    a = run(torch.Generator().manual_seed(3))
    b = run(torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
    want = rsuite.SUITE[name].runnable(jax.random.PRNGKey(0))
    assert tuple(a.shape) == want.shape


def test_matmul_operands_share_the_generator_state():
    """The reference draws a and b from one key: the port draws both from
    one generator state, so a (m, k) operand's values lead b's stream."""
    a, b = tsuite.SUITE["FwFc"].runnable.inputs(
        torch.Generator().manual_seed(1))
    assert torch.equal(a.reshape(-1), b.reshape(-1)[:a.numel()])


@pytest.mark.parametrize("x64", [False, True])
def test_dgemm_dtype_follows_x64(x64):
    """DGEMM is float64 exactly when asked (the reference: under
    ``jax_enable_x64``), and matches the reference built that way."""
    before = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", x64)
        ref = rsuite.build_suite()["DGEMM"]
        key = jax.random.PRNGKey(5)
        want = np.asarray(ref.runnable(key))
        dtype = jnp.float64 if x64 else jnp.float32
        port = tsuite.build_suite(x64=x64)["DGEMM"]
        xs = [torch.from_numpy(np.asarray(x))
              for x in _reference_inputs(port, key, dtype)]
    finally:
        jax.config.update("jax_enable_x64", before)
    got = port.runnable.compute(*xs)
    assert got.dtype == (torch.float64 if x64 else torch.float32)
    assert want.dtype == (np.float64 if x64 else np.float32)
    assert port.runnable(torch.Generator()).dtype == got.dtype
    np.testing.assert_allclose(got.numpy(), want,
                               **(dict(rtol=1e-12, atol=1e-12) if x64
                                  else TOL))


@pytest.mark.parametrize("hw", [(128, 128), (7, 9), (2, 2), (33, 64)])
def test_pool_same_padding_is_uneven(hw):
    """``max_pool_same`` against ``reduce_window(..., "SAME")`` at even and
    odd sizes: the -inf padding lands below and right, never above."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3) + hw).astype(np.float32)
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max,
                                 (1, 1, 3, 3), (1, 1, 2, 2), "SAME")
    got = tsuite.max_pool_same(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
