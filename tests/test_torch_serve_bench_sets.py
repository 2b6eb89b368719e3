"""The port's engine on the request sets of ``benchmarks/serve_bench.py``,
attention families (dense, MoE): greedy streams equal to the JAX engine's
(``serve_bench_sets`` builds the sets and runs both engines; the recurrent
families are in ``test_torch_serve_bench_sets_recurrent.py``)."""
import pytest

torch = pytest.importorskip("torch")
import serve_bench_sets as sets  # noqa: E402

torch.set_num_threads(1)
FAMILIES = ("qwen2.5-32b", "olmoe-1b-7b")


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    return request.param, sets.weights(request.param)


@pytest.mark.parametrize("name", list(sets.SETS))
def test_streams_equal_jax_engine(family, name):
    arch, weights = family
    sets.check_set(weights, name, arch)
