"""Rank programs for ``tests/test_torch_distributed.py`` and
``tests/test_torch_tp.py``: each runs in a spawned process over gloo (a ``file://`` store under the test's tmp dir),
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


def _tp_forward(cfg, params_np, mesh, toks, kernel="xla", src=None,
                fsdp=False):
    """This rank's rows of ``toks`` (split over ``data``), and of the
    source ``src`` (whisper's frames or the VLM's vision tokens) where
    given, through the split model built from the whole bridged
    parameters (``fsdp``: their FSDP blocks, gathered on use); the
    logits."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model

    cfg = dataclasses.replace(cfg, decode_kernel=kernel)
    params = sh.shard_params(convert.from_jax(params_np, cfg, "cpu"), cfg,
                             mesh, fsdp=fsdp)
    n, i = mesh.size(0), mesh.get_local_rank("data")
    rows = slice(i * toks.shape[0] // n, (i + 1) * toks.shape[0] // n)
    source = {}
    if src is not None:
        source["frames" if cfg.family == "encdec" else "vis"] = _t(src[rows])
    with torch.no_grad():
        logits, _ = build_model(cfg, "cpu", mesh, fsdp=fsdp).forward(
            params, _t(toks[rows]), **source)
    return logits


def _tp_train(cfg, params_np, mesh, case, tmp, name, **over) -> dict:
    """``case["steps"]`` ZeRO-1 steps through ``loop.run`` over ``mesh``
    (a checkpoint at the end), ``case["tcfg"]`` with ``over`` replaced
    (``fsdp``, ``microbatch``, ``batch_axes``); the losses, grad norms,
    the gathered state and this rank's parameter and moment blocks."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop as train_loop
    from repro_torch.train.step import make_train_step
    from repro_torch.utils import tree

    tcfg = dataclasses.replace(case["tcfg"], **over)
    train_step, _ = make_train_step(cfg, tcfg, "cpu", mesh)
    state, shard = _tp_state(cfg, params_np, mesh, tcfg.fsdp)
    norms = []
    ck = os.path.join(tmp, f"{name}_ckpt")
    state, report = train_loop.run(
        train_step, state, SyntheticLM(cfg, batch=case["batch"],
                                       seq=case["seq"], seed=0),
        train_loop.LoopConfig(total_steps=case["steps"],
                              ckpt_every=case["steps"], ckpt_dir=ck,
                              handle_signals=False),
        shardings=shard,
        on_step=lambda step, m: norms.append(float(m["grad_norm"])))
    return {f"{name}_losses": report.losses, f"{name}_norms": norms,
            f"{name}_full": ckpt.gather_state(state, shard),
            f"{name}_ckpt": ck,
            f"{name}_shapes": [tuple(t.shape) for t in tree.leaves(
                {"params": state["params"], "mu": state["opt"]["mu"]})]}


def _tp_state(cfg, params_np, mesh, fsdp=False):
    """A ZeRO-1 train state holding this rank's blocks of the bridged
    parameters (``fsdp``: the FSDP rule's), and the state's shardings."""
    from repro_torch import convert
    from repro_torch.distributed import sharding as sh
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import moment_shardings, state_shardings
    from repro_torch.utils import tree

    params = sh.shard_params(convert.from_jax(params_np, cfg, "cpu"), cfg,
                             mesh, fsdp=fsdp)
    for p in tree.leaves(params):
        p.requires_grad_(True)
    state = {"params": params,
             "opt": opt.init_state(params, moment_shardings(cfg, mesh,
                                                            fsdp=fsdp))}
    return state, state_shardings(cfg, mesh, zero1=True, fsdp=fsdp)


def _tp(rank, world, inputs, tmp) -> dict:
    """The tensor/expert parallel cases of ``tests/test_torch_tp.py`` on
    a (1, 4) and a (2, 2) mesh of the same four ranks."""
    import dataclasses

    from repro_torch.distributed import tensor_parallel
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, get_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        state_shardings)
    from repro_torch.utils import tree

    meshes = {(1, 4): make_local_mesh(1, 4), (2, 2): make_local_mesh(2, 2)}
    out = {"coords": {k: tuple(m.get_coordinate())
                      for k, m in meshes.items()}}
    params = {a: pickle.loads(b) for a, b in inputs["params"].items()}
    # Each rank's init: its blocks of the one-process init's leaves.
    for arch in ("yi-9b", "phi3.5-moe-42b-a6.6b", "minicpm-2b",
                 "whisper-small", "llama-3.2-vision-90b", "mamba2-1.3b",
                 "zamba2-2.7b"):
        for shape, mesh in meshes.items():
            cfg = get_config(arch, smoke=True)
            out[f"init_{arch}_{shape}"] = build_model(cfg, "cpu", mesh).init(
                torch.Generator().manual_seed(7))
    # (a) phi3.5-moe SMOKE, dense and sorted dispatch, and sorted with
    # capacity drops; the kernel route (the kernels' plain versions on
    # the CPU) at (1, 4).
    phi = get_config("phi3.5-moe-42b-a6.6b", smoke=True)
    for shape, mesh in meshes.items():
        for case, over in inputs["phi_cases"].items():
            cfg = dataclasses.replace(phi, **over["cfg"])
            out[f"phi_{case}_{shape}"] = _tp_forward(
                cfg, params["phi3.5-moe-42b-a6.6b"], mesh,
                inputs[over["toks"]])
    out["phi_kernel_route"] = _tp_forward(
        phi, params["phi3.5-moe-42b-a6.6b"], meshes[(1, 4)],
        inputs["phi_toks"], kernel="pallas_paged")
    # (c) minicpm SMOKE at (1, 4): head-dim split, tied vocab.
    mini = get_config("minicpm-2b", smoke=True)
    out["minicpm_logits"] = _tp_forward(mini, params["minicpm-2b"],
                                        meshes[(1, 4)], inputs["mini_toks"])
    out.update(_tp_train(mini, params["minicpm-2b"], meshes[(1, 4)],
                         inputs["train"], tmp, "minicpm"))
    # The source families: whisper (heads split on both meshes, the dh
    # split with 6 heads of 16 at (1, 4)) and the VLM (replicated K/V at
    # (1, 4), KV heads split at (2, 2)), the kernel route once each; a
    # ZeRO-1 train step each, whisper's checkpoint restored at one
    # process by the test.
    whisper = get_config("whisper-small", smoke=True)
    vlm = get_config("llama-3.2-vision-90b", smoke=True)
    for shape, mesh in meshes.items():
        out[f"whisper_{shape}"] = _tp_forward(
            whisper, params["whisper-small"], mesh, inputs["wh_toks"],
            src=inputs["wh_frames"])
        out[f"vlm_{shape}"] = _tp_forward(
            vlm, params["llama-3.2-vision-90b"], mesh, inputs["vlm_toks"],
            src=inputs["vlm_vis"])
    out["whisper_dh"] = _tp_forward(
        dataclasses.replace(whisper, **inputs["wh_dh_over"]),
        params["whisper-small/dh"], meshes[(1, 4)], inputs["wh_toks"],
        src=inputs["wh_frames"])
    out["whisper_kernel_route"] = _tp_forward(
        whisper, params["whisper-small"], meshes[(1, 4)], inputs["wh_toks"],
        kernel="pallas_paged", src=inputs["wh_frames"])
    out["vlm_kernel_route"] = _tp_forward(
        vlm, params["llama-3.2-vision-90b"], meshes[(2, 2)],
        inputs["vlm_toks"], kernel="pallas_paged", src=inputs["vlm_vis"])
    out.update(_tp_train(whisper, params["whisper-small"], meshes[(2, 2)],
                         inputs["train"], tmp, "whisper"))
    out.update(_tp_train(vlm, params["llama-3.2-vision-90b"], meshes[(1, 4)],
                         inputs["train"], tmp, "vlm"))
    # The recurrent families: mamba2 and zamba2 on both meshes, the
    # variants (every SSM head on every rank; a replicated conv; a whole
    # ``d_inner``) at (1, 4), the kernel route once each; a ZeRO-1 train
    # step each and of the whole-``d_inner`` variant, mamba2's checkpoint
    # restored at one process by the test.
    ssm = {a: get_config(a, smoke=True)
           for a in ("mamba2-1.3b", "zamba2-2.7b")}
    for shape, mesh in meshes.items():
        for arch, cfg in ssm.items():
            out[f"{arch}_{shape}"] = _tp_forward(cfg, params[arch], mesh,
                                                 inputs["ssm_toks"])
    for name, (arch, over) in inputs["ssm_variants"].items():
        out[name] = _tp_forward(dataclasses.replace(ssm[arch], **over),
                                params[name], meshes[(1, 4)],
                                inputs["ssm_toks"])
    for arch, shape in (("mamba2-1.3b", (2, 2)), ("zamba2-2.7b", (1, 4))):
        out[f"{arch}_kernel_route"] = _tp_forward(
            ssm[arch], params[arch], meshes[shape], inputs["ssm_toks"],
            kernel="pallas_paged")
    out.update(_tp_train(ssm["mamba2-1.3b"], params["mamba2-1.3b"],
                         meshes[(2, 2)], inputs["train"], tmp, "mamba2"))
    out.update(_tp_train(ssm["zamba2-2.7b"], params["zamba2-2.7b"],
                         meshes[(1, 4)], inputs["train"], tmp, "zamba2"))
    rows = "mamba2-1.3b/rows"
    arch, over = inputs["ssm_variants"][rows]
    out.update(_tp_train(dataclasses.replace(ssm[arch], **over),
                         params[rows], meshes[(1, 4)], inputs["train"], tmp,
                         "mamba2_rows"))
    # (b) yi-9b SMOKE on (2, 2) with ZeRO-1, and (e) its checkpoint
    # restored onto (1, 4).
    yi = get_config("yi-9b", smoke=True)
    out.update(_tp_train(yi, params["yi-9b"], meshes[(2, 2)],
                         inputs["train"], tmp, "yi"))
    mesh14 = meshes[(1, 4)]
    _, model14 = make_train_step(yi, inputs["train"]["tcfg"], "cpu", mesh14)
    template = init_train_state(model14, torch.Generator().manual_seed(1),
                                mesh14, zero1=True)
    restored, step = ckpt.restore(out["yi_ckpt"], template=template,
                                  shardings=state_shardings(yi, mesh14,
                                                            zero1=True))
    out["yi_restored_14"] = (step, restored)
    # The split dense model serves from a contiguous cache only: the
    # paged layout stays on one rank.
    try:
        build_model(dataclasses.replace(yi, cache_layout="paged"), "cpu",
                    mesh14).init_cache(None, batch=4, max_len=32)
    except NotImplementedError as e:
        out["serve_refused"] = "paged" in str(e)
    # The split cache path of every family on both meshes (and (4, 1)
    # under long_context), and the trainer's (pod, data) batch axes.
    out.update(_split_serve_cases(inputs, params, meshes))
    out.update(_pod_data_train(yi, params["yi-9b"], inputs["train"]))
    # (d) the split gradient norm: this rank's blocks of whole tensors
    # shaped like yi's leaves.
    from repro_torch.distributed import sharding as sh

    whole = [_t(g) for g in inputs["norm_leaves"]]
    blocks = [sh.shard(g, s) for g, s in zip(whole, tree.leaves(
        state_shardings(yi, mesh14)["params"]))]
    split = ([("model",) if tuple(b.shape) != tuple(g.shape) else ()
              for b, g in zip(blocks, whole)],
             {"model": mesh14.get_group("model")})
    out["norm"] = float(opt.global_norm(blocks, split))
    tensor_parallel.CLOCK.update(on=True, seconds=0.0)
    _tp_forward(phi, params["phi3.5-moe-42b-a6.6b"], mesh14,
                inputs["phi_toks"])
    out["clock_s"] = tensor_parallel.CLOCK["seconds"]
    tensor_parallel.CLOCK.update(on=False)
    out.update(_fsdp_cases(inputs, params, meshes, tmp))
    return out


def _fsdp_cases(inputs, params, meshes, tmp) -> dict:
    """FSDP over ``data`` (``inputs["fsdp"]``): each train case's ZeRO-1
    steps (the widened dense, MoE and VLM SMOKEs) on its mesh, each
    variant's init and a kernel-route forward, the FSDP norm of whole
    tensors' blocks, and the dense (2, 2) checkpoint restored onto
    (1, 4) without FSDP."""
    import dataclasses

    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model, get_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import (_norm_split, init_train_state,
                                        make_train_step, state_shardings)
    from repro_torch.utils import tree

    fs = inputs["fsdp"]
    meshes = {**meshes, (4, 1): make_local_mesh(4, 1),
              "pod": make_local_mesh(2, 1, pod=2)}
    out = {"fsdp_coords_41": tuple(meshes[(4, 1)].get_coordinate())}

    def cfg_of(name):
        arch, over = fs["variants"][name]
        return dataclasses.replace(get_config(arch, smoke=True), **over)

    for name in fs["variants"]:
        cfg = cfg_of(name)
        for shape in ((2, 2), (4, 1)):
            model = build_model(cfg, "cpu", meshes[shape], fsdp=True)
            out[f"fsdp_init_{name}_{shape}"] = model.init(
                torch.Generator().manual_seed(7))
            refused = []
            for entry in ("init_cache", "prefill", "decode_step"):
                try:
                    getattr(model, entry)(None, None, None)
                except NotImplementedError:
                    refused.append(entry)
            out[f"fsdp_serve_refused_{name}_{shape}"] = refused
    for key, case in fs["train"].items():
        over = dict(case["over"], fsdp=True)
        if case["mesh"] == "pod":
            over["batch_axes"] = ("pod", "data")
        out.update(_tp_train(cfg_of(case["variant"]),
                             params[case["variant"]], meshes[case["mesh"]],
                             inputs["train"], tmp, key,
                             **over))
    name = fs["forward"]["variant"]
    out["fsdp_kernel_route"] = _tp_forward(
        cfg_of(name), params[name], meshes[(2, 2)], fs["forward"]["toks"],
        kernel="pallas_paged", fsdp=True)
    # The FSDP norm: this rank's blocks of whole tensors shaped like the
    # variant's leaves, split over ``data`` and ``model``.
    cfg, mesh = cfg_of(name), meshes[(2, 2)]
    whole = [_t(g) for g in fs["norm_leaves"]]
    blocks = [sh.shard(g, s) for g, s in zip(whole, tree.leaves(
        state_shardings(cfg, mesh, fsdp=True)["params"]))]
    out["fsdp_norm"] = float(opt.global_norm(
        blocks, _norm_split(cfg, mesh, True)))
    # The (2, 2) FSDP checkpoint onto (1, 4) without FSDP.
    mesh14 = meshes[(1, 4)]
    tcfg = inputs["train"]["tcfg"]
    _, model14 = make_train_step(cfg, tcfg, "cpu", mesh14)
    template = init_train_state(model14, torch.Generator().manual_seed(1),
                                mesh14, zero1=True)
    out["fsdp_restored_14"] = ckpt.restore(
        out[f"{fs['reshard']}_ckpt"], template=template,
        shardings=state_shardings(cfg, mesh14, zero1=True))[::-1]
    return out


def _split_serve(cfg, params_np, mesh, case) -> dict:
    """This rank's batch rows of ``case``'s prompt through the split
    ``init_cache``/``prefill`` (the source, where the family has one,
    given for the whole batch) and ``case["steps"]`` greedy
    ``decode_step``s (each fed its own argmax); the logits of each step
    and the shape of every cache leaf.  ``case["long"]``: the model built
    with ``long_context`` (the sequence over ``data``, every rank the
    one row)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model
    from repro_torch.utils import tree

    cfg = dataclasses.replace(cfg, decode_kernel=case.get("kernel", "xla"))
    params = sh.shard_params(convert.from_jax(params_np, cfg, "cpu"), cfg,
                             mesh)
    long = bool(case.get("long"))
    model = build_model(cfg, "cpu", mesh, long_context=long)
    toks, seg = case["toks"], case["seg_lens"]
    n, i = mesh.size(0), mesh.get_local_rank("data")
    rows = (slice(0, len(toks)) if len(toks) % n else
            slice(i * len(toks) // n, (i + 1) * len(toks) // n))
    source = {k: _t(v) for k, v in case.get("src", {}).items()}
    logits = []
    with torch.no_grad():
        cache = model.init_cache(params, batch=len(toks),
                                 max_len=case["max_len"], **source)
        out, cache = model.prefill(params, cache, _t(toks[rows]),
                                   seg_lens=_t(seg[rows]))
        logits.append(out)
        for _ in range(case["steps"]):
            out, cache = model.decode_step(params, cache,
                                           out.argmax(-1).to(torch.int32))
            logits.append(out)
    return {"logits": logits, "rows": (rows.start, rows.stop),
            "blocks": {tree.path_str(p): tuple(x.shape)
                       for p, x in tree.leaves_with_paths(cache)}}


def _split_serve_cases(inputs, params, meshes) -> dict:
    import dataclasses

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import get_config

    meshes = {**meshes, (4, 1): make_local_mesh(4, 1)}
    out = {}
    for name, case in inputs["split_serve"].items():
        arch, over = case["variant"]
        cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
        for shape in case["meshes"]:
            out[f"split_{name}_{shape}"] = _split_serve(
                cfg, params[case["params"]], meshes[shape], case)
    return out


def _pod_data_train(cfg, params_np, case) -> dict:
    """Two ZeRO-1 steps on a (pod, data, model) = (2, 2, 1) mesh with the
    batch over ("pod", "data"); the losses and this rank's first moments."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.step import make_train_step
    from repro_torch.utils import tree

    mesh = make_local_mesh(2, 1, pod=2)
    tcfg = dataclasses.replace(case["tcfg"], batch_axes=("pod", "data"))
    train_step, _ = make_train_step(cfg, tcfg, "cpu", mesh)
    state, _ = _state(cfg, params_np, mesh, True)
    data = SyntheticLM(cfg, batch=case["batch"], seq=case["seq"], seed=0)
    losses = []
    for step in range(case["steps"]):
        state, m = train_step(state, data(step))
        losses.append(float(m["loss"]))
    return {"pod_losses": losses,
            "pod_params": [p.detach().clone()
                           for p in tree.leaves(state["params"])],
            "pod_coord": tuple(mesh.get_coordinate())}


JOBS = {"collectives": _collectives, "dp2": _dp2, "tp": _tp}
