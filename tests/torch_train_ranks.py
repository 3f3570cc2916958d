"""Rank bodies of the spawned world of ``tests/test_torch_train_mesh.py``.

The children import this module and the port only (no JAX): the parent
computes the JAX package's references and hands each rank the JAX params
as numpy trees, loaded through ``repro_torch.bridge``. Every rank builds
the same (2, 2) gloo mesh on the CPU and runs every job; what a job
returns is numpy (gathered trees from rank 0 only).
"""

from __future__ import annotations

import dataclasses

import torch

SHAPE = (2, 2)
TRAIN_ARCHS = ("qwen3-14b", "nemotron-4-15b", "deepseek-v3-671b")
SEQ, BATCH, MICRO = 16, 8, 2      # (2, 2): dp 2, so n_micro = 8 // 4 = 2
STEPS = 3


def port_cfg(arch: str, **kw):
    """The port's fp32 smoke config of ``arch``; MoE at no-drop capacity
    unless ``kw`` says otherwise."""
    from repro_torch import configs

    cfg = configs.get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return dataclasses.replace(cfg, **kw)


def cell():
    from repro_torch.configs.base import ShapeCell

    return ShapeCell("mesh", SEQ, BATCH, "train")


def train_cfg(**kw):
    from repro_torch.configs.base import TrainConfig

    return TrainConfig(learning_rate=1e-3, warmup_steps=2,
                       microbatch_per_device=MICRO, **kw)


def _np(tree_):
    from repro_torch import tree

    return tree.map_leaves(lambda t: t.detach().float().numpy(), tree_)


def _nbytes(tree_) -> int:
    from repro_torch import tree

    return sum(t.numel() * t.element_size() for t in tree.leaves(tree_))


def run_steps(cfg, np_params, tcfg, mesh, steps: int = STEPS) -> dict:
    """``steps`` of ``make_jitted_train_step`` on the rank's shards:
    each step's metrics, the rank's resident parameter bytes beside its
    shards' bytes, and (rank 0) the gathered params and moments."""
    from repro_torch import bridge
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import mesh_info
    from repro_torch.launch.train import make_jitted_train_step
    from repro_torch.models.layers import shard_leaf
    from repro_torch.models.registry import get_model
    from repro_torch.optim import compression
    from repro_torch.optim.optimizer import init_state
    from repro_torch import tree

    api = get_model(cfg)
    step, _, p_shard, o_shard, n_micro, use_ef = make_jitted_train_step(
        cfg, tcfg, api, mesh, cell())
    full = bridge.params_from_jax(np_params, device="cpu")
    params = p_shard.place(full)
    shard_bytes = sum(
        shard_leaf(t, s, mesh).numel() * t.element_size()
        for t, s in zip(tree.leaves(full),
                        tree.leaf_specs(full, p_shard.specs)))
    del full
    opt = init_state(params, tcfg)
    ef = compression.init_ef(params) if use_ef else None
    minfo = mesh_info(mesh)
    metrics = []
    for s in range(steps):
        batch = pipeline.shard_batch(
            pipeline.make_batch(cfg, cell(), s, device="cpu"), mesh, minfo)
        params, opt, ef, m = step(params, opt, ef, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "n_micro": n_micro,
           "resident_bytes": _nbytes(params), "shard_bytes": shard_bytes}
    gathered = {"params": p_shard.gather(params),
                "mu": o_shard.mu.gather(opt.mu),
                "nu": o_shard.nu.gather(opt.nu)}
    if mesh.fsdp_rank == 0 and mesh.rank == 0:
        out.update({k: _np(v) for k, v in gathered.items()})
    return out


def replicated_grads(cfg, np_params, batch_np, mesh) -> dict:
    """The gradient of ``loss`` on the rank's shards and rows, for every
    leaf replicated over "model" (gathered over fsdp, divided by the
    data-parallel size: the mean), by path; and the rank's loss."""
    from repro_torch import bridge, tree
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import mesh_info
    from repro_torch.launch.serve import make_tp_spec
    from repro_torch.launch.train import placement, value_and_grad
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import tp

    api = get_model(cfg)
    where = placement(cfg, api, mesh)
    params = where.place(bridge.params_from_jax(np_params, device="cpu"))
    mcfg = make_tp_spec(cfg, api, mesh).cfg_local
    batch = pipeline.shard_batch(
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, mesh,
        mesh_info(mesh))
    with tp.tensor_parallel(mesh.tp_context(where.specs)):
        loss, g = value_and_grad(lambda p, b: api.loss(p, mcfg, b), params,
                                 batch)
        again = _backward_in_another_thread(
            lambda p, b: api.loss(p, mcfg, b), params, batch)
    full = where.gather(g)
    out = {}
    for (path, leaf), spec in zip(tree.leaves_with_path(full),
                                  tree.leaf_specs(full, where.specs)):
        if "model" not in spec:
            out[path] = (leaf / mesh.fsdp_size).numpy()
    return {"grads": out, "loss": float(loss),
            "other_thread_equal": all(torch.equal(a, b) for a, b in zip(
                tree.leaves(g), again))}


def _backward_in_another_thread(loss_fn, params, batch) -> list:
    """The gradients of ``loss_fn`` with the forward in this thread and
    the backward (its remat recompute included) in another, whose
    thread-local context is unset: as autograd's device thread runs a
    backward on the card."""
    import threading

    from repro_torch import tree

    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
        box: dict = {}

        def backward():
            try:
                box["g"] = torch.autograd.grad(loss, leaves,
                                               allow_unused=True)
            except BaseException as e:      # re-raised below
                box["e"] = e

        th = threading.Thread(target=backward)
        th.start()
        th.join(120)
        assert not th.is_alive(), "the backward thread hung"
        if "e" in box:
            raise box["e"]
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, box["g"])]


def moe_losses(cfg, np_params, batch_np, mesh) -> dict:
    """The rank's loss on its rows under ``cfg.moe_dispatch``, and the
    mean over the fsdp group."""
    from repro_torch import bridge
    from repro_torch.data import pipeline
    from repro_torch.launch.mesh import mesh_info
    from repro_torch.launch.serve import make_tp_spec
    from repro_torch.launch.train import placement
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import tp

    api = get_model(cfg)
    where = placement(cfg, api, mesh)
    params = where.place(bridge.params_from_jax(np_params, device="cpu"))
    mcfg = make_tp_spec(cfg, api, mesh).cfg_local
    batch = pipeline.shard_batch(
        {k: torch.from_numpy(v) for k, v in batch_np.items()}, mesh,
        mesh_info(mesh))
    with torch.no_grad(), tp.tensor_parallel(mesh.tp_context(where.specs)):
        local = api.loss(params, mcfg, batch)
        mean = tp.all_reduce(local.clone(), "fsdp") / mesh.fsdp_size
    return {"local": float(local), "mean": float(mean)}


def zero_bytes(cfg, np_params, mesh) -> dict:
    """The bytes ``gather_params`` counts by kind for one layer's
    gather and its backward, with the rank's shard shapes and specs."""
    from repro_torch import bridge, tree
    from repro_torch.launch.train import placement
    from repro_torch.models.registry import get_model
    from repro_torch.parallel import tp

    api = get_model(cfg)
    where = placement(cfg, api, mesh)
    params = where.place(bridge.params_from_jax(np_params, device="cpu"))
    layer, spec = params["layers"][0], where.specs["layers"][0]
    leaves = tree.leaves(layer)
    for t in leaves:
        t.requires_grad_(True)
    tp.reset_coll_bytes()
    with tp.tensor_parallel(mesh.tp_context(where.specs)):
        full = tree.leaves(tp.gather_params(layer, spec))
        torch.autograd.grad(sum(f.float().sum() for f in full), leaves)
    return {"counted": tp.collective_bytes(),
            "shards": [(tuple(t.shape), t.element_size(), s)
                       for t, s in zip(leaves, tree.leaf_specs(layer, spec))]}


def int8_codec(cfg, np_params, mesh, rounds: int = 2) -> dict:
    """``rounds`` of ``compress(..., "int8_ef")`` on the rank's shards of
    a tree (the params standing in for gradients, plus 0.01 a round):
    the gathered decoded values and residual (rank 0)."""
    from repro_torch import bridge
    from repro_torch.launch.train import placement
    from repro_torch.models.registry import get_model
    from repro_torch.optim import compression
    from repro_torch.parallel import tp

    api = get_model(cfg)
    where = placement(cfg, api, mesh)
    grads = where.place(bridge.params_from_jax(np_params, device="cpu"))
    ef = compression.init_ef(grads)
    with tp.tensor_parallel(mesh.tp_context(where.specs)):
        for i in range(rounds):
            g = {"embed": grads["embed"] + 0.01 * i,
                 "final_norm": grads["final_norm"],
                 "layers": grads["layers"]}
            dec, ef = compression.compress(g, "int8_ef", ef)
    out = {"dec": where.gather(dec), "residual": where.gather(ef.residual)}
    if mesh.fsdp_rank or mesh.rank:
        return {}
    return {k: _np(v) for k, v in out.items()}


def trainer_runs(cfg, tcfg, dirs: dict, mesh) -> dict:
    """``Trainer(mesh=)``: 2 steps checkpointing every 2, a resume to 4,
    an uninterrupted 4, and a resume to 3 from a one-device checkpoint
    at step 2."""
    from repro_torch.launch.train import Trainer

    def trainer(d, every):
        return Trainer(cfg, tcfg, cell(), ckpt_dir=d, ckpt_every=every,
                       mesh=mesh)

    first = trainer(dirs["mesh"], 2).run(2)
    resumed = trainer(dirs["mesh"], 2).run(4)
    whole = trainer(dirs["whole"], 100).run(4)
    from_one = trainer(dirs["one"], 100).run(3)
    return {"first": first.losses, "resumed": resumed.losses,
            "resumed_from": resumed.resumed_from, "whole": whole.losses,
            "from_one": from_one.losses,
            "from_one_resumed_from": from_one.resumed_from}


def train_world(rank: int, jobs: dict) -> dict:
    """One rank of the (2, 2) CPU world: every job of ``jobs``."""
    from repro_torch.launch.mesh import make_serving_mesh

    torch.set_num_threads(1)        # four ranks and the parent share the host
    mesh = make_serving_mesh(SHAPE, device="cpu")
    out = {"coords": (mesh.fsdp_rank, mesh.rank), "steps": {}}
    for name, (arch, kw, tkw, np_params, steps) in jobs["steps"].items():
        out["steps"][name] = run_steps(port_cfg(arch, **kw), np_params,
                                       train_cfg(**tkw), mesh, steps)
    out["grads"] = {name: replicated_grads(port_cfg(arch), np_params,
                                           batch, mesh)
                    for name, (arch, np_params, batch) in jobs["grads"].items()}
    arch, np_params, batch = jobs["moe"]
    out["moe"] = {d: moe_losses(port_cfg(arch, capacity_factor=1.25,
                                         moe_dispatch=d), np_params, batch,
                                mesh)
                  for d in ("shard_map", "dense")}
    arch, np_params = jobs["codec"]
    out["codec"] = int8_codec(port_cfg(arch), np_params, mesh)
    arch, np_params = jobs["bytes"]
    out["bytes"] = zero_bytes(port_cfg(arch), np_params, mesh)
    arch, dirs = jobs["trainer"]
    out["trainer"] = trainer_runs(port_cfg(arch), train_cfg(), dirs, mesh)
    return out
