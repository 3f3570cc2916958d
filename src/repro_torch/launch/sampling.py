"""Token selection (mirror of ``repro.launch.sampling``), greedy only.

Temperature 0 (or no ``SamplingParams`` at all) is the exact argmax of
the pad-masked logits, first index on ties like ``jnp.argmax``. Sampled
decoding needs the JAX package's position-keyed PRNG (threefry,
``fold_in``, ``categorical``) ported to torch integer ops to reproduce
its streams; until then a ``SamplingParams`` with ``temperature > 0``
is rejected.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How to turn logits into a token (validated like the JAX one)."""

    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {self.top_k}")
        if self.top_p is not None and not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


def require_greedy(sample: SamplingParams | None) -> None:
    """Reject what the port cannot decode yet."""
    if sample is not None and sample.temperature > 0:
        raise NotImplementedError(
            "sampled decoding (temperature > 0) needs the threefry/"
            "fold_in/categorical port: ROADMAP Queue 1 item 4")


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """logits (B, V), already pad-masked -> (B,) int32 greedy tokens."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
