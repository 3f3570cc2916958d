"""Sampled decoding (mirror of ``repro.launch.sampling``): temperature /
top-k / top-p with a position-keyed PRNG.

Every serving path samples through ONE rule, so their streams are
interchangeable, as in the JAX package:

  * every request owns a **base key** — ``fold_in(PRNGKey(seed), row)``
    where ``row`` is the request's batch row (``Server.generate``) or 0
    (one scheduler request == batch row 0 of a solo generate);
  * the token written at sequence index ``p`` is sampled with
    ``fold_in(base_key, p)``: the key depends only on (seed, position),
    never on batch composition, slot, segment length or decode style.

The PRNG is ``launch.prng``, the JAX package's threefry bit for bit, so
the port draws the JAX package's streams (its Gumbel noise within one
ulp: ``log`` rounds differently).

Per-row sampling *parameters* are tensors (a dict on the logits'
device: ``key`` (B, 2) int64 holding two 32-bit words a row,
``temperature`` (B,) fp32, and ``top_k`` (B,) int64 / ``top_p`` (B,)
fp32 only when some row enables them), so one step function serves any
mix of greedy and sampled rows: a greedy row carries temperature 0 and
takes the argmax branch of ``torch.where``, bit-identical to the pure
greedy path on the same logits. A state with the same keys and shapes
can be copied into a captured step's static buffers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.launch import prng

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How to turn logits into a token (validated like the JAX one).

    temperature 0 is exact greedy argmax (bit-identical to passing no
    sampling at all); ``top_k``/``top_p`` of ``None`` disable the
    respective truncation."""

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


def request_key(seed: int, row: int = 0) -> Tensor:
    """The base key of one request, (2,) int64 on the CPU: row r of a
    batched generate, or a scheduler request (always row 0)."""
    return prng.fold_in(prng.prng_key(seed), row)


def sample_state(sp: SamplingParams, batch: int, device) -> dict:
    """Per-row sampling state for a whole batch sharing ``sp``: rows get
    independent streams (base key folded by row index). ``top_k`` /
    ``top_p`` entries are omitted when disabled, so the temperature-only
    case never runs the truncation sorts."""
    keys = prng.fold_in(prng.prng_key(sp.seed).expand(batch, 2),
                        torch.arange(batch))
    state = {
        "key": keys.to(device),
        "temperature": torch.full((batch,), sp.temperature,
                                  dtype=torch.float32, device=device),
    }
    if sp.top_k is not None:
        state["top_k"] = torch.full((batch,), sp.top_k, dtype=torch.int64,
                                    device=device)
    if sp.top_p is not None:
        state["top_p"] = torch.full((batch,), sp.top_p, dtype=torch.float32,
                                    device=device)
    return state


def merge_rows(rows: list[tuple[Tensor, SamplingParams | None]],
               device) -> dict:
    """Per-row state from heterogeneous requests (the scheduler's slots):
    ``rows`` holds ``(base_key, params-or-None)`` per slot; greedy slots
    (``None``) become temperature-0 rows. ``top_k``/``top_p`` appear only
    when SOME row enables them (disabled rows carry the no-op values 0 /
    1.0)."""
    keys = torch.stack([torch.as_tensor(np.asarray(k), dtype=torch.int64)
                        for k, _ in rows])
    temp = [0.0 if sp is None else sp.temperature for _, sp in rows]
    state = {"key": keys.to(device),
             "temperature": torch.tensor(temp, dtype=torch.float32,
                                         device=device)}
    if any(sp is not None and sp.top_k is not None for _, sp in rows):
        state["top_k"] = torch.tensor(
            [(sp.top_k or 0) if sp else 0 for _, sp in rows],
            dtype=torch.int64, device=device)
    if any(sp is not None and sp.top_p is not None for _, sp in rows):
        state["top_p"] = torch.tensor(
            [1.0 if sp is None or sp.top_p is None else sp.top_p
             for _, sp in rows], dtype=torch.float32, device=device)
    return state


def sample_token_block(logits: Tensor, state: dict | None, pos) -> Tensor:
    """One token per (row, chunk offset): logits (B, S, V) from a chunk
    whose first input token sits at ``pos`` (int or (B,)); offset ``i``
    is keyed by index ``pos + 1 + i``, the key single-token decode folds
    there. Returns (B, S) int32."""
    cols = [sample_tokens(logits[:, i, :], state, pos + 1 + i)
            for i in range(logits.shape[1])]
    return torch.stack(cols, dim=1)


def sample_tokens(logits: Tensor, state: dict | None, pos) -> Tensor:
    """logits (B, V), already pad-masked; ``pos`` (int or (B,)) the
    sequence index the sampled token will occupy -> (B,) int32. Greedy
    rows (temperature 0) return the exact argmax of ``logits``, first
    index on ties like ``jnp.argmax``."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if state is None:
        return greedy
    b, v = logits.shape
    pos = torch.as_tensor(pos, dtype=torch.int64, device=logits.device)
    keys = prng.fold_in(state["key"], pos.expand(b))
    temp = state["temperature"]
    x = logits.float() / torch.clamp_min(temp, 1e-6)[:, None]
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    if "top_k" in state:
        # rank every logit within its row (stable: ties keep index
        # order); a per-row k masks ranks >= k, k == 0 disables the row
        order = torch.argsort(-x, dim=-1, stable=True)
        ranks = torch.empty_like(order).scatter_(
            -1, order, torch.arange(v, device=x.device).expand(b, v))
        k = torch.where(state["top_k"] > 0, state["top_k"],
                        torch.full_like(state["top_k"], v))
        x = torch.where(ranks < k[:, None], x, neg_inf)
    if "top_p" in state:
        # nucleus over the post-top-k distribution: every token at least
        # as probable as the one whose cumulative mass crosses p
        probs = torch.softmax(x, dim=-1)
        desc = torch.sort(probs, dim=-1, descending=True).values
        cum = torch.cumsum(desc, dim=-1)
        crossing = torch.clamp_max(
            torch.sum(cum < state["top_p"][:, None], dim=-1), v - 1)
        cutoff = torch.gather(desc, -1, crossing[:, None])
        x = torch.where(probs >= cutoff, x, neg_inf)
    sampled = prng.categorical(keys, x).to(torch.int32)
    return torch.where(temp > 0.0, sampled, greedy)
