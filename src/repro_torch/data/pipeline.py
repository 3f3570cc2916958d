"""Synthetic deterministic data pipeline (port of
``repro.data.pipeline``).

  * **Step-keyed determinism**: batch(step) is a pure function of
    (seed, step) — restart/resume at step k reproduces the exact batch
    stream, which the fault-tolerance tests rely on. The draw is the
    JAX package's own numpy draw, so both packages see the same tokens.
  * **LM-shaped distribution**: Zipfian token draw (vocab-scale
    realistic branching factor) rather than uniform noise.

Batches are made on the host and moved to the device (``cuda`` unless
the caller passes ``device="cpu"``) with the global logical shape;
``shard_batch`` then keeps a mesh rank's rows (a contiguous block of
the global batch over the batch axes, as ``P(batch_axes)`` lays it
out).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2     # Zipf exponent


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int,
                 a: float) -> np.ndarray:
    # inverse-CDF Zipf truncated to vocab (cheap + deterministic)
    u = rng.random(shape)
    ranks = np.clip((u ** (-1.0 / (a - 1.0))), 1, vocab).astype(np.int64)
    # hash ranks into the vocab so ids aren't ordered by frequency
    ids = (ranks * 2654435761) % vocab
    return ids.astype(np.int32)


def memory_input(cfg: ModelConfig) -> tuple[str, int] | None:
    """The encoder input a family's batch carries beside its tokens, as
    (key, length): the audio family's ``frames`` (encoder_seq of them),
    the VLM's ``image_embeds`` (num_image_tokens); None for the rest."""
    if cfg.family == "audio":
        return "frames", cfg.encoder_seq
    if cfg.family == "vlm":
        return "image_embeds", cfg.num_image_tokens
    return None


def make_batch(cfg: ModelConfig, cell: ShapeCell, step: int,
               dcfg: DataConfig = DataConfig(), *,
               batch_override: int | None = None, device=None) -> dict:
    """One global batch for ``step`` (pure function of (seed, step)):
    int32 ``tokens`` and ``labels`` (the same ids) of shape
    (batch, cell.seq_len); the audio family's ``frames`` (batch,
    encoder_seq, D) and the VLM's ``image_embeds`` (batch,
    num_image_tokens, D), standard normal in ``cfg.dtype``, drawn after
    the tokens from the same generator (the JAX package's draw)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    b = batch_override or cell.global_batch
    tokens = torch.from_numpy(_zipf_tokens(rng, (b, cell.seq_len),
                                           cfg.vocab_size, dcfg.zipf_a))
    tokens = tokens.to(dev)
    batch = {"tokens": tokens, "labels": tokens}
    memory = memory_input(cfg)
    if memory is not None:
        name, t = memory
        x = rng.standard_normal((b, t, cfg.d_model), np.float32)
        batch[name] = torch.from_numpy(x).to(device=dev, dtype=cfg.dtype)
    return batch


def stream(cfg: ModelConfig, cell: ShapeCell, start_step: int = 0,
           dcfg: DataConfig = DataConfig(), *,
           batch_override: int | None = None,
           device=None) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, make_batch(cfg, cell, step, dcfg,
                               batch_override=batch_override, device=device)
        step += 1


def shard_batch(batch: dict, mesh, minfo) -> dict:
    """This rank's rows of a global batch: the batch dim over the mesh's
    batch axes (``launch.input_specs.batch_pspec``), a contiguous block;
    every rank keeps all rows where those axes do not divide them."""
    from repro_torch.launch.input_specs import batch_pspec
    from repro_torch.models.layers import sanitize_pspec, shard_leaf

    return {k: shard_leaf(x, sanitize_pspec(
        mesh, batch_pspec(minfo, x.ndim), x.shape), mesh)
        for k, x in batch.items()}
