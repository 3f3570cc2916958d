"""Training: the train step on one device or a mesh, and the
fault-tolerant training loop (port of ``repro.launch.train``).

``make_train_step`` builds

  (params, opt_state, ef_state, batch) -> (params, opt_state, ef_state, metrics)

  * microbatch gradient accumulation: ``n_micro`` = global batch //
    (``microbatch_per_device`` x the data-parallel size); microbatch m
    takes rows {m, m + n_micro, ...} (the JAX step's STRIDED split) and
    the gradients sum in an fp32 accumulator, divided by ``n_micro``;
  * the gradient compression codec (``optim.compression``);
  * AdamW with warmup / inverse-sqrt schedule and global-norm clipping,
    in place on the parameters and moments (``optim.optimizer``).

The gradients come from ``torch.autograd.grad`` of the model's ``loss``
(the JAX step's ``jax.value_and_grad``). Train with ``cfg.use_pallas``
False, as the JAX trainer does: the hand-written kernels have no
backward, and on the card they raise under autograd.

On a mesh (``make_jitted_train_step``; FSDP x TP, the JAX package's
GSPMD-partitioned step) one process a mesh position runs the step on
its shards under a training ``parallel.tp`` context: the model's
leaves are gathered over the fsdp group at use (ZeRO-3) and its
"model"-sharded products run at the rank's heads (``cfg_local``, as
tensor-parallel serving); the batch is the rank's contiguous rows
(``data.pipeline.shard_batch``). Microbatch m of the rank is its rows
{m, m + n_micro, ...}: the data shard of the global strided microbatch
m, as the JAX step's ``with_sharding_constraint`` lays it out. The
gradients come back reduce-scattered over fsdp, are divided by the
data-parallel size (the mean), accumulated in fp32 on the shard, then
compressed, clipped (the whole tree's norm) and applied on the shard;
the loss is the mean over the fsdp group. The mesh path launches no
kernel, as the JAX trainer's runs none.

``Trainer`` is the loop: auto-resume from the newest checkpoint,
async checkpoints every ``ckpt_every`` steps and at the last one, the
straggler watchdog with an eviction hook, and the data stream keyed by
step. With ``mesh=`` every rank of the mesh runs it: the state placed
per rank, the step-keyed global batch cut by ``shard_batch``, the
checkpoints gathered whole and written by rank 0 in the one-device
layout, restored re-sharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Callable

import torch

from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager, config_hash
from repro_torch.configs.base import ModelConfig, ShapeCell, TrainConfig
from repro_torch.data import pipeline
from repro_torch.device import resolve_device
from repro_torch.ft.watchdog import StragglerWatchdog, Verdict
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi, get_model
from repro_torch.optim import compression
from repro_torch.optim.optimizer import (
    AdamState,
    adamw_update,
    init_state,
    state_shardings,
)
from repro_torch.parallel import tp
from repro_torch.parallel.hints import sharding_hints

log = logging.getLogger("repro_torch.train")


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, gradient tree) of ``loss_fn(params, *args)``; each
    gradient in its parameter's type. The parameters take part in
    autograd only for this call (``requires_grad`` is set and cleared
    here), so the optimizer may update them in place afterwards."""
    leaves = tree.leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, *args)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten(params, grads)


def _refuse(cfg: ModelConfig, api: ModelApi) -> None:
    if api.param_specs is None:
        raise NotImplementedError(
            f"training on a mesh of family {cfg.family!r} is not ported "
            "(the transformer's dense, moe and vlm carry a sharding "
            "description; ROADMAP Queue 1 item 6)")


def placement(cfg: ModelConfig, api: ModelApi, mesh) -> L.Placement:
    """Where each parameter lives on ``mesh``: ``api.param_specs`` on its
    axes, sanitized against its sizes."""
    from repro_torch.launch.mesh import mesh_info

    _refuse(cfg, api)
    return L.shardings(mesh, api.param_specs(cfg, mesh_info(mesh)),
                       api.param_shapes(cfg))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, api: ModelApi,
                    minfo: L.MeshInfo, mesh, cell: ShapeCell):
    """(train_step, n_micro, use_ef); ``mesh`` None for one device (then
    ``minfo`` is ``L.HOST``). On a mesh the step takes and returns this
    rank's shards and its rows of the batch."""
    dp = 1 if mesh is None else mesh.fsdp_size   # "pod" x "data" ranks
    n_micro = max(1, cell.global_batch
                  // max(1, tcfg.microbatch_per_device * dp))
    use_ef = tcfg.grad_compression == "int8_ef"
    mcfg, ctx = cfg, None
    if mesh is not None:
        from repro_torch.launch.mesh import mesh_info
        from repro_torch.launch.serve import make_tp_spec

        specs = placement(cfg, api, mesh).specs
        mcfg = make_tp_spec(cfg, api, mesh).cfg_local   # the rank's heads
        ctx = mesh.tp_context(specs)
        minfo = mesh_info(mesh)                         # with the sizes

    def scope():
        return (tp.tensor_parallel(ctx) if ctx is not None
                else contextlib.nullcontext())

    def loss_fn(params, mb):
        rows = next(iter(mb.values())).shape[0]
        with sharding_hints(mesh, minfo, batch=rows * dp):
            return api.loss(params, mcfg, mb)

    def train_step(params, opt_state: AdamState, ef_state, batch):
        with scope():
            if n_micro > 1:
                gacc = None
                lsum = torch.zeros((), dtype=torch.float32)
                for m in range(n_micro):
                    mb = {k: x[m::n_micro] for k, x in batch.items()}
                    loss, g = value_and_grad(loss_fn, params, mb)
                    if gacc is None:
                        gacc = tree.map_leaves(lambda x: x.float(), g)
                    else:
                        for a, x in zip(tree.leaves(gacc), tree.leaves(g)):
                            a.add_(x)
                    del g
                    lsum = lsum.to(loss.device) + loss.float()
                grads = tree.map_leaves(lambda a: a.div_(n_micro), gacc)
                loss = lsum / n_micro
            else:
                loss, grads = value_and_grad(loss_fn, params, batch)
            if dp > 1:
                # the fsdp reduction summed the ranks' gradients: the mean
                grads = tree.map_leaves(lambda g: g.div_(dp), grads)
                loss = tp.all_reduce(loss.float().clone(), "fsdp") / dp
            grads, ef_state = compression.compress(
                grads, tcfg.grad_compression, ef_state)
            params, opt_state, stats = adamw_update(params, grads,
                                                    opt_state, tcfg)
        return params, opt_state, ef_state, {"loss": loss.float(), **stats}

    return train_step, n_micro, use_ef


def make_jitted_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                           api: ModelApi, mesh, cell: ShapeCell):
    """The step over a mesh with its placements: (step, specs,
    p_shard, o_shard, n_micro, use_ef), the JAX function's tuple. There
    is no jit: ``step`` is ``make_train_step``'s on this rank's shards
    (the JAX step's in / out shardings are the placements:
    ``p_shard.place`` cuts a full params tree, ``o_shard`` holds the
    moments' and the step's; the batch is ``shard_batch``'s rows).
    ``specs`` is ``api.param_specs(cfg, mesh_info(mesh))``, unsanitized.
    Families without a sharding description raise (ROADMAP Queue 1 item
    6)."""
    from repro_torch.launch.mesh import mesh_info

    _refuse(cfg, api)
    minfo = mesh_info(mesh)
    step_fn, n_micro, use_ef = make_train_step(cfg, tcfg, api, minfo, mesh,
                                               cell)
    specs = api.param_specs(cfg, minfo)
    p_shard = placement(cfg, api, mesh)
    o_shard = state_shardings(p_shard, mesh)
    return step_fn, specs, p_shard, o_shard, n_micro, use_ef


@dataclasses.dataclass
class TrainerReport:
    steps_run: int
    final_loss: float
    resumed_from: int | None
    straggler_events: int
    evictions: int
    losses: list


class Trainer:
    """Fault-tolerant loop: resume -> train -> checkpoint -> (evict?).
    Runs on ``cuda`` unless given ``device="cpu"``; with ``mesh=`` on
    the mesh's device, every rank of the mesh running it."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, cell: ShapeCell,
                 *, ckpt_dir: str, mesh=None, ckpt_every: int = 20,
                 keep: int = 3, data_cfg: pipeline.DataConfig | None = None,
                 batch_override: int | None = None,
                 watchdog: StragglerWatchdog | None = None,
                 on_evict: Callable[[], None] | None = None,
                 device=None) -> None:
        self.cfg, self.tcfg, self.cell = cfg, tcfg, cell
        self.api = get_model(cfg)
        self.mesh = mesh
        self.ckpt = CheckpointManager(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.dcfg = data_cfg or pipeline.DataConfig()
        self.batch_override = batch_override
        self.watchdog = watchdog or StragglerWatchdog()
        self.on_evict = on_evict
        self.meta = {
            "config": config_hash(cfg),
            "arch": cfg.arch_id,
            "cell": cell.name,
        }
        self.placement = None
        if mesh is None:
            self.device = resolve_device(device)
            self.minfo = L.HOST
            self.step_fn, self.n_micro, self.use_ef = make_train_step(
                cfg, tcfg, self.api, self.minfo, None, cell)
        else:
            from repro_torch.launch.mesh import mesh_info

            self.device = mesh.device
            self.minfo = mesh_info(mesh)
            (self.step_fn, _, self.placement, _, self.n_micro,
             self.use_ef) = make_jitted_train_step(cfg, tcfg, self.api,
                                                   mesh, cell)

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params = self.api.init(self.cfg, seed=seed, device=self.device)
        if self.placement is not None:
            params = self.placement.place(params)
        opt = init_state(params, self.tcfg)
        ef = compression.init_ef(params) if self.use_ef else None
        return params, opt, ef

    def _state_tree(self, params, opt, ef):
        state = {"params": params, "opt": opt._asdict()}
        if ef is not None:
            state["ef"] = ef._asdict()
        return state

    def state_placement(self, ef: bool) -> L.Placement | None:
        """The placement of ``_state_tree``: moments and residual like
        their parameters, the step replicated."""
        if self.placement is None:
            return None
        specs = self.placement.specs
        state = {"params": specs,
                 "opt": {"step": (), "mu": specs, "nu": specs}}
        if ef:
            state["ef"] = {"residual": specs}
        return L.Placement(self.mesh, state)

    def resume_or_init(self, seed: int = 0):
        params, opt, ef = self.init_state(seed)
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt, ef, 0, None
        like = self._state_tree(params, opt, ef)
        restored, _ = self.ckpt.restore(
            latest, like, expect_meta=self.meta,
            placement=self.state_placement(ef is not None))
        params = restored["params"]
        opt = AdamState(**restored["opt"])
        ef = compression.EFState(**restored["ef"]) if ef is not None else None
        return params, opt, ef, latest, latest

    def _agreed(self, flag: bool) -> bool:
        """``flag`` on any rank of the mesh (every rank saves, or none:
        a save is a collective)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        with tp.tensor_parallel(self.mesh.tp_context()):
            tp.all_reduce(tp.all_reduce(t, "fsdp", "max"), "model", "max")
        return bool(t.item())

    def _batch(self, step: int) -> dict:
        batch = pipeline.make_batch(
            self.cfg, self.cell, step, self.dcfg,
            batch_override=self.batch_override, device=self.device)
        if self.mesh is not None:
            batch = pipeline.shard_batch(batch, self.mesh, self.minfo)
        return batch

    # -- loop ---------------------------------------------------------------
    def run(self, num_steps: int, *, seed: int = 0,
            inject_step_times=None) -> TrainerReport:
        params, opt, ef, start, resumed = self.resume_or_init(seed)
        where = self.state_placement(ef is not None)
        losses = []
        evictions = 0
        step = start
        while step < num_steps:
            batch = self._batch(step)
            self.watchdog.start()
            params, opt, ef, metrics = self.step_fn(params, opt, ef, batch)
            loss = float(metrics["loss"])          # waits for the device
            if inject_step_times is not None:
                verdict = self.watchdog.observe(inject_step_times(step))
                self.watchdog._t0 = None
            else:
                verdict = self.watchdog.stop()
            losses.append(loss)
            step += 1
            if self._agreed(verdict is Verdict.EVICT):
                evictions += 1
                log.warning("straggler eviction at step %d", step)
                self.ckpt.save(step, self._state_tree(params, opt, ef),
                               meta=self.meta, placement=where)
                if self.on_evict is not None:
                    self.on_evict()
            if step % self.ckpt_every == 0 or step == num_steps:
                self.ckpt.save_async(
                    step, self._state_tree(params, opt, ef), meta=self.meta,
                    placement=where)
        self.ckpt.wait()
        return TrainerReport(
            steps_run=num_steps - start,
            final_loss=losses[-1] if losses else float("nan"),
            resumed_from=resumed,
            straggler_events=len(self.watchdog.history),
            evictions=evictions,
            losses=losses,
        )
