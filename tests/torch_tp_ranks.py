"""Rank bodies of the spawned worlds of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_card.py``.

The children import this module and the port only (no JAX): the parent
computes the JAX package's reference and hands each rank the JAX
params as numpy trees, loaded through ``repro_torch.bridge``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the reference's tp=2 plans and caches (tests/test_mesh_serving.py)
TP_ARCHS = ("nemotron-4-15b", "nemotron-int8", "deepseek-v3-671b")
SERVER = dict(num_slots=4, max_len=48, block_size=8)
COMMS_BATCH, COMMS_LEN, COMMS_POS = 4, 32, 3
COMMS_STEPS = (1, 6)


def port_cfg(arch: str):
    """The port's smoke config of ``arch`` as the reference's tp test
    builds it: int8 KV for "nemotron-int8", the kernels on for the other
    two, MoE at no-drop capacity."""
    from repro_torch import configs

    if arch == "nemotron-int8":
        cfg = dataclasses.replace(configs.get_smoke_config("nemotron-4-15b"),
                                  kv_cache_dtype=torch.int8)
    else:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  use_pallas=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _serve(cfg, np_params, reqs, mesh) -> dict:
    from repro_torch import bridge
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    params = bridge.params_from_jax(np_params, device="cpu")
    srv = PagedContinuousBatchingServer(cfg, params, device="cpu",
                                        mesh=mesh, **SERVER)
    for p, g in reqs:
        srv.submit(p, g)
    done = {r.rid: r.tokens.tolist() for r in srv.run()}
    return {"tokens": done, "tp": srv.tp.size,
            "local_heads": srv.tp.cfg_local.num_heads,
            "keys": srv.executable_cache_keys()}


def _comms(cfg, np_params, mesh) -> dict:
    """Collective bytes counted by one decode step and by a 6-step scan
    of the rank's sharded steps."""
    from repro_torch import bridge
    from repro_torch.launch.serve import Server, make_decode_scan
    from repro_torch.parallel import tp as tplib

    srv = Server(cfg, bridge.params_from_jax(np_params, device="cpu"),
                 max_len=COMMS_LEN, mesh=mesh)
    cache = srv.tp.place_cache(srv.api.init_cache(
        cfg, COMMS_BATCH, COMMS_LEN, device="cpu"))
    toks = torch.zeros((COMMS_BATCH, 1), dtype=torch.int64)
    out = {}
    for steps in COMMS_STEPS:
        scan = make_decode_scan(cfg, srv.api, steps, tp=srv.tp)
        tplib.reset_coll_bytes()
        with torch.no_grad():
            scan(srv.params, toks, cache, COMMS_POS)
        out[steps] = tplib.collective_bytes()
    return out


def _guard(cfg, mesh) -> str:
    """make_tp_spec's refusal of heads the model axis does not divide."""
    from repro_torch.launch.serve import make_tp_spec
    from repro_torch.models.registry import get_model

    bad = dataclasses.replace(cfg, num_heads=3, num_kv_heads=3, head_dim=8)
    try:
        make_tp_spec(bad, get_model(bad), mesh)
    except ValueError as e:
        return str(e)
    return ""


def tp_world(rank: int, shape: tuple, params: dict, reqs: dict,
             comms_params) -> dict:
    """One rank of a (1, 2) CPU world: the paged server on every
    config's traffic, the collective counts and the guard."""
    from repro_torch.launch.mesh import make_serving_mesh

    mesh = make_serving_mesh(shape, device="cpu")
    out = {"rank": mesh.rank, "transport": mesh.transport,
           "serve": {arch: _serve(port_cfg(arch), params[arch], reqs[arch],
                                  mesh)
                     for arch in TP_ARCHS},
           "comms": _comms(port_cfg("nemotron-4-15b"), comms_params, mesh),
           "guard": _guard(port_cfg("nemotron-4-15b"), mesh)}
    return out


def solo_tokens(cfg, np_params, reqs) -> list:
    """The port's solo decode of each request (no mesh)."""
    from repro_torch import bridge
    from repro_torch.launch.serve import Server

    srv = Server(cfg, bridge.params_from_jax(np_params, device="cpu"),
                 max_len=SERVER["max_len"], device="cpu")
    return [np.asarray(srv.generate(torch.as_tensor(p)[None], g,
                                    decode="loop").tokens)[0, p.size:]
            .tolist() for p, g in reqs]


def echo_sum(rank: int, fail_rank: int | None = None,
             hang_rank: int | None = None) -> float:
    """A gloo all-reduce of rank + 1; ``fail_rank`` raises first,
    ``hang_rank`` sleeps past any deadline (the other rank then waits in
    the collective)."""
    import time

    import torch.distributed as dist

    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    if rank == hang_rank:
        time.sleep(3600)
    t = torch.full((2,), float(rank + 1))
    dist.all_reduce(t)
    return float(t[0])
