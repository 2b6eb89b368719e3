"""Rank programs for ``tests/test_torch_distributed.py``: each runs in a
spawned process over gloo (a ``file://`` store under the test's tmp dir),
reads its inputs from ``inputs.pt`` there and writes what it computed to
``<job>_rank<r>.pt``.  This module imports only torch and the port, so the
spawned ranks never load JAX."""
from __future__ import annotations

import os
import pickle

import torch
import torch.distributed as dist


def spawn(job: str, world: int, tmp: str) -> list[dict]:
    """Run ``job`` on ``world`` spawned ranks; each rank's result dict."""
    import torch.multiprocessing as mp

    mp.start_processes(_main, args=(world, tmp, job), nprocs=world,
                       start_method="spawn")
    return [torch.load(os.path.join(tmp, f"{job}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _main(rank: int, world: int, tmp: str, job: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, job + '.store')}",
        rank=rank, world_size=world)
    try:
        inputs = torch.load(os.path.join(tmp, "inputs.pt"),
                            weights_only=False)
        out = JOBS[job](rank, world, inputs, tmp)
        torch.save(out, os.path.join(tmp, f"{job}_rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(x.copy())


def _collectives(rank, world, inputs, tmp) -> dict:
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import sp_decode as sp

    out = {}
    gs = [_t(g[rank]) for g in inputs["gs"]]
    out["bucketed"] = coll.bucketed_all_reduce(gs, bucket_bytes=256)
    err = torch.zeros_like(_t(inputs["g"][0][rank]))
    for i, g in enumerate(inputs["g"]):
        g = _t(g[rank])
        out[f"q{i}"] = coll.quantize_int8(
            g + err, coll.shared_amax(g + err))[0]
        out[f"mean{i}"], err = coll.compressed_all_reduce(g, err)
        out[f"err{i}"] = err
    q, k, v, lengths = (_t(inputs[n]) for n in ("q", "k", "v", "lengths"))
    s_local = k.shape[2] // world
    mine = slice(rank * s_local, (rank + 1) * s_local)
    k, v = k[:, :, mine], v[:, :, mine]
    scale = q.shape[-1] ** -0.5
    out["sp"] = sp.sp_decode_attention(q, k, v, lengths)
    out["sp_split"] = sp.sp_decode_attention(q, k, v, lengths, splits=4)
    out["partials"] = sp.local_partials(q, k, v, lengths, rank * s_local,
                                        scale)
    out["partials_split"] = sp.local_partials(
        q, k, v, lengths, rank * s_local, scale, splits=4)
    out.update(_dp(rank, world, inputs["dp"][0], tmp, "dp4"))
    return out


def _state(cfg, params_np, mesh, zero1):
    from repro_torch import convert
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import state_shardings
    from repro_torch.utils import tree

    params = convert.from_jax(params_np, cfg, "cpu")
    for p in tree.leaves(params):
        p.requires_grad_(True)
    shard = state_shardings(cfg, mesh, {"params": params}, zero1=zero1)
    state = {"params": params,
             "opt": opt.init_state(params, shard["opt"]["mu"])}
    return state, shard


def _dp(rank, world, case, tmp, name) -> dict:
    """``steps`` data-parallel ZeRO-1 steps through ``loop.run`` (a
    checkpoint at the end, gathered and written by rank 0); the ranks'
    losses, full parameters, moment blocks and the gathered state."""
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import get_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as train_loop
    from repro_torch.train.step import make_train_step
    from repro_torch.utils import tree

    cfg = get_config(case["arch"], smoke=True)
    mesh = make_local_mesh(world, 1)
    train_step, _ = make_train_step(cfg, case["tcfg"], "cpu", mesh)
    state, shard = _state(cfg, pickle.loads(case["params"]), mesh, True)
    data = SyntheticLM(cfg, batch=case["batch"], seq=case["seq"], seed=0)
    ck = os.path.join(tmp, f"{name}_ckpt")
    state, report = train_loop.run(
        train_step, state, data,
        train_loop.LoopConfig(total_steps=case["steps"],
                              ckpt_every=case["steps"], ckpt_dir=ck,
                              handle_signals=False),
        shardings=shard)
    full = ckpt.gather_state(state, shard)
    out = {f"{name}_losses": report.losses,
           f"{name}_params": [p.detach().clone()
                              for p in tree.leaves(state["params"])],
           f"{name}_mu": [m.clone() for m in tree.leaves(state["opt"]["mu"])],
           f"{name}_full": full, f"{name}_ckpt": ck}
    if case.get("elastic_in"):
        # 1 -> world: a one-process checkpoint cut to this rank's blocks.
        fresh, _ = _state(cfg, pickle.loads(case["params"]), mesh, True)
        restored, step = ckpt.restore(case["elastic_in"], template=fresh,
                                      shardings=shard)
        out[f"{name}_elastic_in"] = (step, restored)
    return out


def _dp2(rank, world, inputs, tmp) -> dict:
    out = {}
    for case in inputs["dp"]:
        out.update(_dp(rank, world, case, tmp, case["name"]))
    return out


JOBS = {"collectives": _collectives, "dp2": _dp2}
