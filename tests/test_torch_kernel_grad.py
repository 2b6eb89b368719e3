"""The kernels refuse to be differentiated: each CUDA entry of the six
kernel wrappers raises when grad mode is on and an input requires grad
(its launch would record no autograd graph).  The CPU cases reach the
check through CPU tensors; the ``cuda`` cases run on the card (this file
imports no JAX, so ``pytest -m cuda`` runs it there)."""
import pytest

torch = pytest.importorskip("torch")


def _guarded_calls(device):
    """(name, call) for the CUDA entry of each of the six kernel wrappers,
    with inputs on ``device``, one of which requires grad."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.flash_attention import flash_attention as fk
    from repro_torch.kernels.fused_norm import fused_norm as nk
    from repro_torch.kernels.matmul import matmul as mk
    from repro_torch.kernels.moe_gmm import moe_gmm as gk
    from repro_torch.kernels.ssd import ssd as sk

    gen = torch.Generator().manual_seed(0)

    def t(*shape, grad=False, dtype=torch.float32):
        x = torch.randn(shape, generator=gen).to(device, dtype)
        return x.requires_grad_(grad)

    pages = torch.arange(4, dtype=torch.int32, device=device).reshape(2, 2)
    lens = torch.tensor([5, 16], dtype=torch.int32, device=device)
    return [
        ("decode_attention", lambda: dk.decode_attention_cuda(
            t(2, 4, 64, grad=True), t(2, 2, 16, 64), t(2, 2, 16, 64), lens)),
        ("paged_decode_attention", lambda: dk.paged_decode_attention_cuda(
            t(2, 4, 64, grad=True), t(4, 8, 2, 64), t(4, 8, 2, 64), pages,
            lens)),
        ("flash_attention", lambda: fk.flash_attention_cuda(
            t(2, 4, 16, 64, grad=True), t(2, 2, 16, 64), t(2, 2, 16, 64))),
        ("paged_flash_attention", lambda: fk.paged_flash_attention_cuda(
            t(2, 4, 16, 64, grad=True), t(4, 8, 2, 64), t(4, 8, 2, 64),
            pages)),
        ("fused_norm", lambda: nk.fused_norm_cuda(
            t(4, 64), t(64, grad=True))),
        ("ssd", lambda: sk.ssd_cuda(
            t(1, 64, 2, 64, grad=True), t(1, 64, 2).abs(), -t(2).abs(),
            t(1, 64, 1, 16), t(1, 64, 1, 16))),
        ("grouped_matmul", lambda: gk.grouped_matmul_cuda(
            t(2, 64, 64), t(2, 64, 64, grad=True))),
        ("matmul", lambda: mk.matmul_cuda(t(64, 64, grad=True),
                                          t(64, 64))),
    ]


def test_refuse_grad_helper():
    from repro_torch.kernels.common import refuse_grad

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        refuse_grad("k", torch.ones(3), x, None)
    with torch.no_grad():
        refuse_grad("k", x)
    with torch.inference_mode():
        refuse_grad("k", torch.ones(3))
    refuse_grad("k", torch.ones(3), None, 2)


@pytest.mark.parametrize("case", range(8))
def test_kernel_entries_refuse_grad_first(case):
    """Each CUDA entry checks grad before anything else: a CPU tensor that
    requires grad is refused for that, not for its device."""
    name, call = _guarded_calls("cpu")[case]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires"):
        call()


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(8))
def test_kernel_wrappers_refuse_grad_on_the_card(case):
    """On the card each CUDA entry refuses a differentiated launch; under
    no_grad the same call launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    name, call = _guarded_calls("cuda")[case]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires"):
        call()
    with torch.no_grad():
        call()
