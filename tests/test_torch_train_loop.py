"""The port's training substrate, case for case with
``tests/test_train_system.py``: the loop, checkpoints, fault tolerance,
the optimizer's effect, data determinism; plus what the port's in-place
state needs (a bf16 leaf round trip, an async save that the next in-place
step cannot tear) and batches bitwise equal to ``repro.data.pipeline``'s.
Restoring across shardings waits for the port's ``distributed/``.
yi-9b SMOKE, fp32, on the CPU."""
import os
import signal
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.models import get_config as jax_config  # noqa: E402
from repro_torch.core.remat import RematPolicy  # noqa: E402
from repro_torch.data.pipeline import MemmapLM, Prefetcher, SyntheticLM  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import loop as train_loop  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainConfig, init_train_state, make_train_step)
from repro_torch.utils import tree  # noqa: E402

torch.set_num_threads(1)


def _fresh(model, seed=0):
    return init_train_state(model, torch.Generator().manual_seed(seed))


def _equal_states(a, b) -> bool:
    la, lb = tree.leaves_with_paths(a), tree.leaves_with_paths(b)
    return all(pa == pb and x.dtype == y.dtype and torch.equal(x, y)
               for (pa, x), (pb, y) in zip(la, lb, strict=True))


@pytest.fixture()
def tiny():
    cfg = get_config("yi-9b", smoke=True)
    tcfg = TrainConfig(
        adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50),
        remat=RematPolicy.SAVE_DOTS,
    )
    train_step, model = make_train_step(cfg, tcfg, "cpu")
    state = _fresh(model)
    data = SyntheticLM(cfg, batch=4, seq=16, seed=7)
    return cfg, train_step, state, data


def test_loss_decreases(tiny):
    cfg, train_step, state, data = tiny
    losses = []
    for step in range(12):
        state, metrics = train_step(state, data(step % 2))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses


def test_checkpoint_roundtrip_and_atomicity(tmp_path, tiny):
    cfg, train_step, state, data = tiny
    state, _ = train_step(state, data(0))
    d = str(tmp_path / "ck")
    ckpt.save(state, d, step=10)
    # a stale tmp dir (simulated crash) must be ignored
    os.makedirs(os.path.join(d, "step_00000020.tmp"))
    assert ckpt.latest_step(d) == 10
    restored, step = ckpt.restore(d, template=state)
    assert step == 10
    assert _equal_states(state, restored)
    assert all(p.requires_grad for p in tree.leaves(restored["params"]))
    # in place: the template's own tensors take the stored values
    other = _fresh(make_train_step(cfg, TrainConfig(), "cpu")[1], seed=1)
    ptrs = [t.data_ptr() for t in tree.leaves(other)]
    back, _ = ckpt.restore(d, template=other, in_place=True)
    assert back is other and _equal_states(state, other)
    assert ptrs == [t.data_ptr() for t in tree.leaves(other)]


def test_checkpoint_retention(tmp_path, tiny):
    _, _, state, _ = tiny
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save(state, d, step=s, keep=2)
    assert ckpt.latest_step(d) == 4
    names = sorted(os.listdir(d))
    assert names == ["step_00000003", "step_00000004"]


def test_bf16_leaf_round_trip(tmp_path):
    """A bf16 leaf is stored as its raw 16-bit words and comes back
    bitwise, NaN and infinities included."""
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    x[0, :3] = torch.tensor([float("nan"), float("inf"), -0.0])
    state = {"w": x, "n": torch.tensor(3, dtype=torch.int32),
             "f": torch.ones(2)}
    d = str(tmp_path / "bf")
    path = ckpt.save(state, d, step=1)
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        recs = {r["path"]: r for r in json.load(f)["leaves"]}
    assert recs["w"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, recs["w"]["file"])).dtype == np.int16
    back, _ = ckpt.restore(d, template={k: torch.empty_like(v)
                                        for k, v in state.items()})
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(back["n"], state["n"])
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(d, template={"w": torch.empty(5, 7), "n": state["n"],
                                  "f": state["f"]})


def test_async_save_is_not_torn_by_the_next_step(tmp_path, tiny):
    """The snapshot is a copy: the train step updates the (CPU) state in
    place right after ``save`` returns, while the writer still runs."""
    cfg, train_step, state, data = tiny
    state, _ = train_step(state, data(0))
    snap = tree.tree_map(lambda t: t.detach().clone(), state)
    saver = ckpt.AsyncCheckpointer(str(tmp_path / "a"))
    real_save = ckpt.save

    def slow_save(*a, **k):
        time.sleep(0.3)                 # the next steps run meanwhile
        return real_save(*a, **k)

    ckpt.save = slow_save
    try:
        saver.save(state, 1)
        for i in range(2):
            state, _ = train_step(state, data(i + 1))
        saver.wait()
    finally:
        ckpt.save = real_save
    assert not _equal_states(state, snap)
    restored, _ = ckpt.restore(str(tmp_path / "a"), template=state)
    assert _equal_states(restored, snap)


def test_loop_resume_determinism(tmp_path):
    """Train 6 steps straight vs 3 + crash + resume 3: identical params
    (bitwise on the CPU), and the resumed run replays the same batches."""
    cfg = get_config("yi-9b", smoke=True)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(lr=1e-3, warmup_steps=0,
                                             total_steps=100))
    train_step, model = make_train_step(cfg, tcfg, "cpu")
    data = SyntheticLM(cfg, batch=2, seq=16, seed=11)
    seen = {"a": {}, "b": {}}

    def recorder(run):
        def source(step):
            batch = data(step)
            seen[run][step] = batch["tokens"].copy()
            return batch
        return source

    straight, _ = train_loop.run(
        train_step, _fresh(model), recorder("a"),
        train_loop.LoopConfig(total_steps=6, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "a"),
                              handle_signals=False),
    )
    # interrupted run: 3 steps, checkpoint, then resume to 6
    st1, rep1 = train_loop.run(
        train_step, _fresh(model), recorder("b"),
        train_loop.LoopConfig(total_steps=3, ckpt_every=3,
                              ckpt_dir=str(tmp_path / "b"),
                              handle_signals=False),
    )
    saved = ckpt.host_copy(st1)
    restored, _ = ckpt.restore(str(tmp_path / "b"), template=_fresh(model))
    assert _equal_states(restored, saved)
    st2, rep2 = train_loop.run(
        train_step, _fresh(model), recorder("b"),
        train_loop.LoopConfig(total_steps=6, ckpt_every=3,
                              ckpt_dir=str(tmp_path / "b"),
                              handle_signals=False),
    )
    assert rep2.resumed_from == 3
    assert sorted(seen["b"]) == list(range(6))
    for step in range(6):
        np.testing.assert_array_equal(seen["a"][step], seen["b"][step])
    assert _equal_states(straight, st2)


def test_loop_preemption_writes_final_checkpoint(tmp_path):
    cfg = get_config("yi-9b", smoke=True)
    tcfg = TrainConfig(adamw=opt.AdamWConfig(warmup_steps=0, total_steps=100))
    train_step, model = make_train_step(cfg, tcfg, "cpu")
    state = _fresh(model)
    data = SyntheticLM(cfg, batch=2, seq=16, seed=1)

    fired = {"done": False}

    def on_step(step, metrics):
        if step == 2 and not fired["done"]:
            fired["done"] = True
            os.kill(os.getpid(), signal.SIGTERM)

    _, report = train_loop.run(
        train_step, state, data,
        train_loop.LoopConfig(total_steps=50, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "c")),
        on_step=on_step,
    )
    assert report.preempted
    assert ckpt.latest_step(str(tmp_path / "c")) == report.final_step


def test_nan_fuse(tmp_path):
    def bad_step(state, batch):
        return state, {"loss": torch.tensor(float("nan"))}

    with pytest.raises(FloatingPointError):
        train_loop.run(
            bad_step, {}, lambda s: {},
            train_loop.LoopConfig(total_steps=3, ckpt_dir=str(tmp_path / "n"),
                                  handle_signals=False),
        )


def test_straggler_watchdog(tmp_path):
    calls = []

    def slow_step(state, batch):
        if len(calls) == 3:
            time.sleep(0.25)
        return state, {"loss": torch.tensor(1.0)}

    def on_straggler(step, ratio):
        calls.append((step, ratio))

    state, report = train_loop.run(
        slow_step, {}, lambda s: calls.append("d") or {},
        train_loop.LoopConfig(total_steps=6, ckpt_every=100,
                              ckpt_dir=str(tmp_path / "ck"),
                              straggler_factor=3.0, handle_signals=False),
        on_straggler=on_straggler,
    )
    del state
    assert report.straggler_steps, report.step_times
    ratios = [c[1] for c in calls if isinstance(c, tuple)]
    assert ratios and ratios[0] > 3.0  # flagged ratio


def test_data_determinism_and_memmap(tmp_path):
    cfg = get_config("yi-9b", smoke=True)
    jcfg = jax_config("yi-9b", smoke=True)
    a = SyntheticLM(cfg, 4, 16, seed=5)(3)
    b = SyntheticLM(cfg, 4, 16, seed=5)(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg, 4, 16, seed=6)(3)
    assert not np.array_equal(a["tokens"], c["tokens"])
    ref = jax_pipeline.SyntheticLM(jcfg, 4, 16, seed=5)(3)
    for k in ref:
        np.testing.assert_array_equal(a[k], ref[k])

    path = str(tmp_path / "corpus.bin")
    np.arange(10000, dtype=np.uint32).tofile(path)
    mm = MemmapLM(path, cfg, batch=2, seq=16, seed=0)
    b0, b1 = mm(0), mm(0)
    np.testing.assert_array_equal(b0["tokens"], b1["tokens"])
    assert (b0["labels"][:, :-1] == b0["tokens"][:, 1:]).all()
    ref = jax_pipeline.MemmapLM(path, jcfg, batch=2, seq=16, seed=0)
    for step in (0, 5):
        for k, v in ref(step).items():
            got = mm(step)[k]
            assert got.dtype == v.dtype
            np.testing.assert_array_equal(got, v)


def test_prefetcher_orders_steps():
    cfg = get_config("yi-9b", smoke=True)
    src = SyntheticLM(cfg, 2, 8, seed=0)
    pf = Prefetcher(src, start_step=5, depth=2)
    it = iter(pf)
    got = [next(it) for _ in range(4)]
    pf.stop()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, batch in got:
        np.testing.assert_array_equal(batch["tokens"], src(s)["tokens"])
