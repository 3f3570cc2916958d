"""Speculative decoding: host-side draft/accept policy, static programs
(mirror of ``repro.launch.spec``).

The Sidebar split at the serving level: what to draft, what to accept
and how to roll back is a host policy between dispatches; the expensive
part is two static programs on the card, captured like the segments
(``launch.graphs``):

  * **Draft.** A small model with its own dense slot cache (it never
    takes pool blocks) proposes K tokens a row in one program: a
    W-wide rowwise prefill (W = K + 1) ingests the tokens the target
    committed since the row's draft frontier, then K - 1 greedy
    ``decode_step`` calls extend it. The cache is written in place, so a
    captured draft program reads and writes the same storage on every
    replay.
  * **Verify.** The target runs ``serve.make_verify_step``: the
    multi-token rowwise prefill through the block tables with
    ``all_logits=True``, its drafted positions written into per-slot
    spare scratch rows the scheduler splices into the tables, returning
    its own position-keyed token at all K + 1 positions.
  * **Accept / rollback.** Host arithmetic (``accepted_prefix``): a row
    emits the accepted drafts plus the target's token after them, and
    rollback is not copying the rejected scratch blocks.

The emitted stream equals plain decode's, greedy and sampled, whatever
the draft: the verifier samples every position with plain decode's
position-keyed rule, and a draft is accepted exactly when it guessed
that token.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi, get_model


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding policy for a paged continuous-batching server.

    ``k`` tokens are drafted and verified a row an iteration; ``k == 0``
    disables speculation (plain segment decode, the same programs).
    ``draft_cfg`` / ``draft_params`` are the draft model; the target's
    own config and params make the "oracle draft" (greedy acceptance
    1.0). ``validate(cfg)`` raises ``ValueError`` when the pairing
    cannot be exact: a vocabulary of another size, or a draft family
    without the rowwise multi-token prefill the draft program needs.
    """

    draft_cfg: ModelConfig
    draft_params: Any
    k: int = 4

    def __post_init__(self) -> None:
        if self.k < 0:
            raise ValueError(f"spec k must be >= 0, got {self.k}")

    def validate(self, cfg: ModelConfig) -> None:
        from repro_torch.launch.serve import PER_LAYER_PLAN_FAMILIES

        if self.draft_cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft vocab_size {self.draft_cfg.vocab_size} != target "
                f"vocab_size {cfg.vocab_size}: draft and target must share "
                "token ids")
        if self.draft_cfg.family not in PER_LAYER_PLAN_FAMILIES:
            raise ValueError(
                f"draft family {self.draft_cfg.family!r} does not support "
                "the rowwise multi-token prefill the draft program needs "
                f"(supported: {PER_LAYER_PLAN_FAMILIES})")

    def draft_api(self) -> ModelApi:
        return get_model(self.draft_cfg)


def make_draft_program(cfg: ModelConfig, api: ModelApi, k: int,
                       max_len: int):
    """The combined ingest-and-draft program:
    ``draft(params, chunk (B, W), chunk_len (B,), start (B,), cache) ->
    drafts (B, k) int32`` with W = k + 1, ``cache`` updated in place.
    Per row: a rowwise prefill writes ``chunk[:chunk_len]`` at positions
    ``start ..`` of the draft's dense slot cache, the logits at the
    chunk's last real token give draft 1 by argmax, and k - 1 greedy
    steps extend it. Greedy even for sampled rows: the draft only
    guesses the target's token; acceptance compares against the
    target's own sample.

    Junk writes: pad positions past ``chunk_len`` and steps past a short
    row's frontier write ahead of that row's frontier, where the next
    ingest overwrites them before the frontier gets there, or at the
    clamped ``max_len - 1``, which no valid stream writes (its last
    token is never fed back), dead behind the ``kpos <= pos`` mask.
    """
    w = k + 1
    max_pos = max_len - 1

    def draft_fn(params, chunk, chunk_len, start, cache):
        logits, _ = api.prefill(params, cfg, {"tokens": chunk}, cache,
                                cache_pos=start, all_logits=True)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        idx = torch.clamp(chunk_len - 1, 0, w - 1).long()
        last = torch.take_along_dim(logits, idx[:, None, None], dim=1)[:, 0]
        tok = torch.argmax(last, dim=-1).to(torch.int32)
        drafts = [tok]
        pos0 = start + chunk_len
        for i in range(k - 1):
            p = torch.clamp_max(pos0 + i, max_pos).long()
            lg, _ = api.decode_step(params, cfg, tok.long()[:, None], cache, p)
            lg = L.mask_pad_logits(lg, cfg.vocab_size)
            tok = torch.argmax(lg[:, -1, :], dim=-1).to(torch.int32)
            drafts.append(tok)
        if k == 0:
            return torch.zeros((chunk.shape[0], 0), dtype=torch.int32,
                               device=chunk.device)
        return torch.stack(drafts, dim=1)

    return draft_fn


def accepted_prefix(drafts: np.ndarray, target: np.ndarray) -> int:
    """Length of one row's accepted draft prefix: draft i is accepted iff
    it equals the target's token there and every earlier draft was
    accepted (a match after a miss was conditioned on the rejected
    token). The row then emits ``target[:m + 1]``, so even a full
    rejection makes one token of progress."""
    m = 0
    k = len(drafts)
    while m < k and drafts[m] == target[m]:
        m += 1
    return m


__all__ = ["SpecConfig", "accepted_prefix", "make_draft_program"]
