"""Serving: batched prefill and captured decode (mirror of
``repro.launch.serve`` without tensor parallelism).

``make_serve_step`` builds the single-token decode and
``make_prefill_step`` the (chunked) prompt-KV writer; both take a
per-row sampling state (``launch.sampling``: the token written at
sequence index p is keyed by (request key, p)), ``None`` for exact
greedy argmax. ``make_decode_scan`` runs N of those steps as one
program: the JAX package scans them into one compiled program; here
the ``Server`` wraps it in a ``graphs.Program``, one CUDA graph of the
N steps on the card (per-row positions from a device buffer) and the
eager loop on the CPU or under ``graphs.disable_capture()``.
``Server`` is the static-batch driver (prefill once, then scan or loop
decode); ``generate`` is the solo reference decoder the schedulers are
held to: whole-prompt prefill, then one step per token at scalar
positions.

``Server(plan=...)`` takes a ``LayerPlan``, an ``ExecutionMode``, a mode
name or an ``ExecutionPlan`` (uniform or per layer; every layer runs
under its ``layer_scope``, so a per-layer plan reaches the kernels). Its
default mode must be SIDEBAR or SIDEBAR_PIPELINED, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.modes import (
    ExecutionMode,
    ExecutionPlan,
    LayerPlan,
    coerce_layer_plan,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.launch import graphs, sampling
from repro_torch.launch.sampling import SamplingParams
from repro_torch.models import layers as L
from repro_torch.models.registry import ModelApi, get_model

# Families whose caches are pure position-masked KV: a reused buffer's
# stale tail is invisible (decode attends kpos <= pos), so prefill can
# overwrite in place.
_CACHE_REUSE_FAMILIES = ("dense", "moe", "vlm")

# Families whose layer stack runs every layer under kops.layer_scope —
# the only ones a heterogeneous (per-layer) ExecutionPlan can reach; the
# schedulers reuse it as their supported-family set.
PER_LAYER_PLAN_FAMILIES = ("dense", "moe")

# features of the JAX servers that are not ported, by ROADMAP item
UNPORTED = {
    "mesh": "tensor parallelism (ROADMAP Queue 1 item 6)",
    "faults": "fault injection (ROADMAP Queue 1 item 4)",
    "scheduling": "EDF/FIFO scheduling (ROADMAP Queue 1 item 4)",
    "spill_region": "preemption and spill (ROADMAP Queue 1 item 4)",
    "priority": "priorities and SLO targets, with EDF scheduling "
                "(ROADMAP Queue 1 item 4)",
    "spec": "speculative decoding (ROADMAP Queue 1 item 5)",
    "rag": "RAG serving (ROADMAP Queue 1 item 5)",
    "rag_overlap": "RAG serving (ROADMAP Queue 1 item 5)",
    "memory": "encoder memory for the audio and VLM families (ROADMAP "
              "Queue 1 item 8)",
}


def make_serve_step(cfg: ModelConfig, api: ModelApi):
    """decode one token: (params, tokens (B, 1), cache, pos[, sample,
    block_tables]) -> (next tokens (B, 1) int32, cache). ``pos`` is an
    int or a per-row (B,) tensor; the token emitted sits at ``pos + 1``
    and is keyed there. ``block_tables`` makes ``cache`` the paged pool,
    decoded in place."""

    def serve_step(params, tokens, cache, pos, sample=None,
                   block_tables=None):
        logits, cache = api.decode_step(params, cfg, tokens, cache, pos,
                                        block_tables=block_tables)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        nxt = sampling.sample_tokens(logits[:, -1, :], sample, pos + 1)
        return nxt[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, api: ModelApi):
    """prompt-KV writer: (params, batch, cache[, sample, cache_pos,
    block_tables]) -> (next tokens (B, 1), cache). ``cache_pos`` (int or
    per-row (B,)) makes the step chunked; a prefill of S tokens from p
    emits (and keys) the token at index p + S. ``block_tables`` routes
    the writes through the paged pool."""

    def prefill_step(params, batch, cache, sample=None, cache_pos=None,
                     block_tables=None):
        logits, cache = api.prefill(params, cfg, batch, cache,
                                    cache_pos=cache_pos,
                                    block_tables=block_tables)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        idx = batch["tokens"].shape[1]
        if cache_pos is not None:
            idx = cache_pos + idx
        nxt = sampling.sample_tokens(logits[:, -1, :], sample, idx)
        return nxt[:, None], cache

    return prefill_step


def make_decode_scan(cfg: ModelConfig, api: ModelApi,
                     num_steps: int) -> Callable:
    """``num_steps`` decode steps as one program:
    ``decode_scan(params, tok (B, 1), cache, pos, sample=None) ->
    (tokens (B, num_steps) int32, cache)``; ``pos`` (int or (B,)) is the
    first step's position. Sampling keys fold (request key, position)
    inside each step, so the scan matches the loop decode."""
    step = make_serve_step(cfg, api)

    def decode_scan(params, tok, cache, pos, sample=None):
        buf = torch.empty((tok.shape[0], num_steps), dtype=torch.int32,
                          device=tok.device)
        for i in range(num_steps):
            nxt, cache = step(params, tok, cache, pos + i, sample)
            buf[:, i] = nxt[:, 0]
            tok = nxt.long()
        return buf, cache

    return decode_scan


@dataclasses.dataclass
class ServeResult:
    tokens: Any           # (B, prompt + generated) int32
    prompt_len: int
    generated: int


class Server:
    """Static-batch decoding server: greedy by default, sampled through
    ``generate(sample=SamplingParams(...))``; ``decode="scan"`` is one
    captured program of all the steps on the card."""

    def __init__(self, cfg: ModelConfig, params, *, mesh=None,
                 max_len: int = 256,
                 execution_mode: ExecutionMode | str | None = None,
                 plan: LayerPlan | ExecutionPlan | ExecutionMode | str |
                 None = None, device=None) -> None:
        if mesh is not None:
            raise NotImplementedError(f"not ported yet: mesh= "
                                      f"({UNPORTED['mesh']})")
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the server on {self.device}")
        self.params = params
        self.max_len = max_len
        if plan is not None and execution_mode is not None:
            raise ValueError("pass either plan= or execution_mode=, not both")
        if plan is None:
            plan = (ExecutionMode.SIDEBAR if execution_mode is None
                    else execution_mode)
        if isinstance(plan, ExecutionPlan):
            base = plan.default
            if not plan.is_uniform and cfg.family not in \
                    PER_LAYER_PLAN_FAMILIES:
                raise ValueError(
                    "a heterogeneous (per-layer) ExecutionPlan is "
                    "realized by running each layer under its layer_scope;"
                    f" family {cfg.family!r} runs a single variant — pass "
                    "a uniform plan or a LayerPlan")
        else:
            plan = base = coerce_layer_plan(plan)
        if base.mode not in (ExecutionMode.SIDEBAR,
                             ExecutionMode.SIDEBAR_PIPELINED):
            raise ValueError(
                "Server serves through the sidebar fast path; the plan's "
                "(default) mode must be SIDEBAR or SIDEBAR_PIPELINED, got "
                f"{base.mode}")
        self.cfg = cfg
        self.api = get_model(cfg)
        self.plan = plan
        self.execution_mode = base.mode
        self._prefill = make_prefill_step(cfg, self.api)
        self._decode = make_serve_step(cfg, self.api)
        # executable cache: one decode program per (step count, mesh
        # identity), as the JAX server keys it; a program captures one
        # graph per batch shape and cache buffer
        self._decode_scans: dict[tuple, graphs.Program] = {}
        self._pool = graphs.new_pool(self.device)
        self._cache_pool: dict[int, Any] = {}

    @property
    def captured(self) -> bool:
        """Whether ``decode="scan"`` replays a graph here."""
        return graphs.captures(self.device)

    # -- KV-cache pooling --------------------------------------------------
    def _take_cache(self, b: int):
        """A (B, max_len) cache: the pooled buffer when the family's
        cache is position-masked KV, else a fresh one."""
        if self.cfg.family in _CACHE_REUSE_FAMILIES:
            pooled = self._cache_pool.pop(b, None)
            if pooled is not None:
                return pooled
        return self.api.init_cache(self.cfg, b, self.max_len,
                                   device=self.device)

    def _return_cache(self, b: int, cache) -> None:
        if self.cfg.family in _CACHE_REUSE_FAMILIES:
            self._cache_pool[b] = cache

    def _decode_scan(self, num_steps: int) -> graphs.Program:
        key = (num_steps, None)
        prog = self._decode_scans.get(key)
        if prog is None:
            scan = make_decode_scan(self.cfg, self.api, num_steps)

            def run(fixed, tok, pos, sample):
                params, cache = fixed
                return scan(params, tok, cache, pos, sample)[0]

            prog = self._decode_scans[key] = graphs.Program(
                run, device=self.device, pool=self._pool)
        return prog

    @torch.no_grad()
    def generate(self, prompts, num_tokens: int, extra: dict | None = None,
                 *, decode: str = "scan",
                 sample: SamplingParams | None = None,
                 prefill_chunk: int | None = None) -> ServeResult:
        """prompts (B, S) int — one bucket; decode ``num_tokens``.

        ``decode="scan"`` runs the steps as one program (a CUDA graph on
        the card), ``"loop"`` one eager step a token: token for token
        identical. ``sample`` switches greedy argmax to temperature /
        top-k / top-p with a position-keyed stream per batch row; the
        same seed reproduces the same tokens under scan and loop, and
        temperature 0 is bit-identical to greedy. ``prefill_chunk``
        splits the prompt's KV build into chunks written at their true
        offsets, token for token identical to whole-prompt prefill (MoE:
        serve no-drop for that parity)."""
        if decode not in ("scan", "loop"):
            raise ValueError(f"decode must be 'scan' or 'loop', got "
                             f"{decode!r}")
        if extra is not None:
            raise NotImplementedError(f"not ported yet: extra= "
                                      f"({UNPORTED['memory']})")
        prompts = torch.as_tensor(np.array(prompts, np.int64)
                                  if isinstance(prompts, np.ndarray)
                                  else prompts).to(self.device).long()
        b, s = prompts.shape
        if s + num_tokens > self.max_len:
            raise ValueError(f"prompt {s} + generate {num_tokens} exceeds "
                             f"max_len {self.max_len}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got "
                             f"{prefill_chunk}")
        state = (sampling.sample_state(sample, b, self.device)
                 if sample is not None else None)
        cache = self._take_cache(b)
        with kops.execution_plan(self.plan):
            if prefill_chunk is not None and s > prefill_chunk:
                for c0 in range(0, s, prefill_chunk):
                    chunk = {"tokens": prompts[:, c0:c0 + prefill_chunk]}
                    nxt, cache = self._prefill(self.params, chunk, cache,
                                               state, c0)
            else:
                nxt, cache = self._prefill(self.params, {"tokens": prompts},
                                           cache, state)
            pieces = [prompts.to(torch.int32), nxt]
            steps = num_tokens - 1
            if steps > 0 and decode == "scan":
                pos = torch.full((b,), s, dtype=torch.int64,
                                 device=self.device)
                pieces.append(self._decode_scan(steps)(
                    (self.params, cache), tok=nxt.long(), pos=pos,
                    sample=state))
            elif steps > 0:
                for i in range(steps):
                    nxt, cache = self._decode(self.params, nxt.long(), cache,
                                              s + i, state)
                    pieces.append(nxt)
        self._return_cache(b, cache)
        return ServeResult(tokens=torch.cat(pieces, dim=1), prompt_len=s,
                           generated=num_tokens)


@torch.inference_mode()
def generate(cfg: ModelConfig, params, prompts: torch.Tensor,
             num_tokens: int, *, max_len: int, device=None,
             sample: SamplingParams | None = None) -> torch.Tensor:
    """Solo decode: prompts (B, S) -> tokens (B, S + num_tokens).
    Whole-prompt prefill, then ``num_tokens - 1`` single-token steps at
    scalar positions on a fresh dense slab cache; ``sample`` as in
    ``Server.generate``."""
    dev = resolve_device(device)
    api = get_model(cfg)
    b, s = prompts.shape
    if s + num_tokens > max_len:
        raise ValueError(f"prompt {s} + generate {num_tokens} exceeds "
                         f"max_len {max_len}")
    prompts = prompts.to(dev).long()
    state = (sampling.sample_state(sample, b, dev) if sample is not None
             else None)
    cache = api.init_cache(cfg, b, max_len, device=dev)
    prefill = make_prefill_step(cfg, api)
    step = make_serve_step(cfg, api)
    nxt, cache = prefill(params, {"tokens": prompts}, cache, state)
    pieces = [prompts.to(torch.int32), nxt]
    for i in range(num_tokens - 1):
        nxt, cache = step(params, nxt.long(), cache, s + i, state)
        pieces.append(nxt)
    return torch.cat(pieces, dim=1)
