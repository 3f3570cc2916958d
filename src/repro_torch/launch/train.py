"""Training: the train step and the fault-tolerant training loop (port
of ``repro.launch.train``, one device).

``make_train_step`` builds

  (params, opt_state, ef_state, batch) -> (params, opt_state, ef_state, metrics)

  * microbatch gradient accumulation: ``n_micro`` = global batch //
    ``microbatch_per_device``; microbatch m takes rows {m, m + n_micro,
    ...} (the JAX step's STRIDED split) and the gradients sum in an fp32
    accumulator, divided by ``n_micro``;
  * the gradient compression codec (``optim.compression``);
  * AdamW with warmup / inverse-sqrt schedule and global-norm clipping,
    in place on the parameters and moments (``optim.optimizer``).

The gradients come from ``torch.autograd.grad`` of the model's ``loss``
(the JAX step's ``jax.value_and_grad``). Train with ``cfg.use_pallas``
False, as the JAX trainer does: the hand-written kernels have no
backward, and on the card they raise under autograd.

``Trainer`` is the loop: auto-resume from the newest checkpoint,
async checkpoints every ``ckpt_every`` steps and at the last one, the
straggler watchdog with an eviction hook, and the data stream keyed by
step. The mesh (``make_jitted_train_step``) comes with tensor
parallelism.
"""

from __future__ import annotations

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
from repro_torch.models.registry import ModelApi, get_model
from repro_torch.optim import compression
from repro_torch.optim.optimizer import AdamState, adamw_update, init_state

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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, api: ModelApi,
                    cell: ShapeCell):
    """(train_step, n_micro, use_ef) for one device."""
    n_micro = max(1, cell.global_batch
                  // max(1, tcfg.microbatch_per_device))
    use_ef = tcfg.grad_compression == "int8_ef"

    def loss_fn(params, mb):
        return api.loss(params, cfg, mb)

    def train_step(params, opt_state: AdamState, ef_state, batch):
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
        grads, ef_state = compression.compress(
            grads, tcfg.grad_compression, ef_state)
        params, opt_state, stats = adamw_update(params, grads, opt_state,
                                                tcfg)
        return params, opt_state, ef_state, {"loss": loss.float(), **stats}

    return train_step, n_micro, use_ef


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
    Runs on ``cuda`` unless given ``device="cpu"``."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, cell: ShapeCell,
                 *, ckpt_dir: str, ckpt_every: int = 20, keep: int = 3,
                 data_cfg: pipeline.DataConfig | None = None,
                 batch_override: int | None = None,
                 watchdog: StragglerWatchdog | None = None,
                 on_evict: Callable[[], None] | None = None,
                 device=None) -> None:
        self.cfg, self.tcfg, self.cell = cfg, tcfg, cell
        self.device = resolve_device(device)
        self.api = get_model(cfg)
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
        self.step_fn, self.n_micro, self.use_ef = make_train_step(
            cfg, tcfg, self.api, cell)

    # -- state --------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params = self.api.init(self.cfg, seed=seed, device=self.device)
        opt = init_state(params, self.tcfg)
        ef = compression.init_ef(params) if self.use_ef else None
        return params, opt, ef

    def _state_tree(self, params, opt, ef):
        state = {"params": params, "opt": opt._asdict()}
        if ef is not None:
            state["ef"] = ef._asdict()
        return state

    def resume_or_init(self, seed: int = 0):
        params, opt, ef = self.init_state(seed)
        latest = self.ckpt.latest_step()
        if latest is None:
            return params, opt, ef, 0, None
        like = self._state_tree(params, opt, ef)
        restored, _ = self.ckpt.restore(latest, like, expect_meta=self.meta)
        params = restored["params"]
        opt = AdamState(**restored["opt"])
        ef = compression.EFState(**restored["ef"]) if ef is not None else None
        return params, opt, ef, latest, latest

    # -- loop ---------------------------------------------------------------
    def run(self, num_steps: int, *, seed: int = 0,
            inject_step_times=None) -> TrainerReport:
        params, opt, ef, start, resumed = self.resume_or_init(seed)
        losses = []
        evictions = 0
        step = start
        while step < num_steps:
            batch = pipeline.make_batch(
                self.cfg, self.cell, step, self.dcfg,
                batch_override=self.batch_override, device=self.device)
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
            if verdict is Verdict.EVICT:
                evictions += 1
                log.warning("straggler eviction at step %d", step)
                self.ckpt.save(step, self._state_tree(params, opt, ef),
                               meta=self.meta)
                if self.on_evict is not None:
                    self.on_evict()
            if step % self.ckpt_every == 0 or step == num_steps:
                self.ckpt.save_async(
                    step, self._state_tree(params, opt, ef), meta=self.meta)
        self.ckpt.wait()
        return TrainerReport(
            steps_run=num_steps - start,
            final_loss=losses[-1] if losses else float("nan"),
            resumed_from=resumed,
            straggler_events=len(self.watchdog.history),
            evictions=evictions,
            losses=losses,
        )
