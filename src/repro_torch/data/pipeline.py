"""Synthetic deterministic data pipeline (port of
``repro.data.pipeline``).

  * **Step-keyed determinism**: batch(step) is a pure function of
    (seed, step) — restart/resume at step k reproduces the exact batch
    stream, which the fault-tolerance tests rely on. The draw is the
    JAX package's own numpy draw, so both packages see the same tokens.
  * **LM-shaped distribution**: Zipfian token draw (vocab-scale
    realistic branching factor) rather than uniform noise.

Batches are made on the host and moved to the device (``cuda`` unless
the caller passes ``device="cpu"``); one device, no sharding.
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


def make_batch(cfg: ModelConfig, cell: ShapeCell, step: int,
               dcfg: DataConfig = DataConfig(), *,
               batch_override: int | None = None, device=None) -> dict:
    """One global batch for ``step`` (pure function of (seed, step)):
    int32 ``tokens`` and ``labels`` (the same ids) of shape
    (batch, cell.seq_len)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    b = batch_override or cell.global_batch
    tokens = torch.from_numpy(_zipf_tokens(rng, (b, cell.seq_len),
                                           cfg.vocab_size, dcfg.zipf_a))
    tokens = tokens.to(dev)
    return {"tokens": tokens, "labels": tokens}


def stream(cfg: ModelConfig, cell: ShapeCell, start_step: int = 0,
           dcfg: DataConfig = DataConfig(), *,
           batch_override: int | None = None,
           device=None) -> Iterator[tuple[int, dict]]:
    step = start_step
    while True:
        yield step, make_batch(cfg, cell, step, dcfg,
                               batch_override=batch_override, device=device)
        step += 1
