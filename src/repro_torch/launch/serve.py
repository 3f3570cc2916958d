"""Serving: batched prefill and captured decode (mirror of
``repro.launch.serve``).

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

Encoder memory (``Server.generate(extra=...)``, as the JAX server): the
audio family's memory is ``whisper.encode`` of ``extra["frames"]``, the
VLM's is ``extra["image_embeds"]``; other families ignore ``extra``. The
prefill gets the whole batch (tokens and ``extra``), each decode step
the memory. A captured scan takes the memory as an input, copied into
its static buffer at every replay, so a later ``generate`` with new
frames or images replays the graph on them.

Tensor-parallel serving (``mesh=``, the JAX package's shard_map'ped
steps): each rank of a ``launch.mesh`` runs the same steps on its shard
(``TpSpec``: the params and caches sliced along the dims their sharding
description names, ``cfg_local`` with the rank's heads) under the
ambient ``parallel.tp`` context, which reduces the row-parallel
partials and gathers the logits over the mesh's "model" group. Tokens,
positions, tables and sampling state are replicated host metadata: all
ranks sample the same token from the same gathered logits. The steps
are built with ``tp=``; their executable-cache keys end in the mesh.
The transformer's families (dense, moe, vlm) carry a sharding
description; the other families, training on a mesh and the
speculative verify step under a mesh are not ported (ROADMAP Queue 1
item 6).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import tree
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
from repro_torch.models import whisper
from repro_torch.models.registry import ModelApi, get_model
from repro_torch.parallel import tp as tplib

# Families whose caches are pure position-masked KV: a reused buffer's
# stale tail is invisible (decode attends kpos <= pos), so prefill can
# overwrite in place. The recurrent families (ssm, hybrid) integrate
# unmasked state, and the JAX server gives them and the audio decoder a
# fresh zero cache: their pooled buffer is zeroed before each request,
# that zero cache at the same addresses, so a captured decode graph
# replays on it.
_CACHE_REUSE_FAMILIES = ("dense", "moe", "vlm")

# Families whose layer stack runs every layer under kops.layer_scope —
# the only ones a heterogeneous (per-layer) ExecutionPlan can reach; the
# schedulers reuse it as their supported-family set.
PER_LAYER_PLAN_FAMILIES = ("dense", "moe")

# ---------------------------------------------------------------------------
# Tensor-parallel serving: every rank runs the whole step on its shard.
# ---------------------------------------------------------------------------

def _walk(tree, specs, fn, path: str = ""):
    """``fn(path, leaf, spec)`` over a params / cache tree (dicts and
    lists) and its sharding description, driven by the tree."""
    if isinstance(tree, dict):
        return {k: _walk(v, specs[k], fn, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, specs[i], fn, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(path, tree, specs)


@dataclasses.dataclass(frozen=True, eq=False)
class TpSpec:
    """What the step builders need to run a serve / prefill step on one
    rank of the mesh's "model" axis.

    The partitioning is Megatron TP driven by the model's sharding
    description (``api.param_pspecs`` / ``cache_pspecs``): every param or
    cache dim whose description names "model" is split (column-parallel
    wq / wk / wv / w_up / w_gate and the vocab-row-sharded embedding,
    row-parallel wo / w_down, the KV heads of slab and pool, expert
    stacks over experts); everything else is replicated.

    ``cfg_local`` is the rank's view: ONLY the head counts change. Every
    other shape the forward derives from the (already sliced) tensors,
    and global quantities (the vocab size of the pad mask, the expert
    count of routing and capacity) stay global.
    """

    mesh: Any
    axis: str                  # "model"
    size: int                  # ranks on that axis
    rank: int                  # this rank's index on it
    cfg_local: ModelConfig
    minfo: L.MeshInfo          # mesh axes with sizes
    param_pspecs: Any          # description tree matching the params
    cache_pspecs: Any          # ... matching a cache or pool

    @property
    def mesh_key(self) -> tuple:
        """Hashable mesh identity for executable-cache keys."""
        return (tuple(self.mesh.shape), tuple(self.mesh.axis_names))

    @property
    def ctx(self) -> tplib.TpContext:
        return self.mesh.tp_context()

    def _place(self, tree, specs):
        def shard(path, t, spec):
            d = tplib.model_dim(spec)
            if d is None or self.size == 1:
                return t
            n = t.shape[d] // self.size
            return t.narrow(d, self.rank * n, n).clone()

        return _walk(tree, specs, shard)

    def place_params(self, params):
        """This rank's shard of a full params tree (at one rank: the
        same tensors)."""
        return self._place(params, self.param_pspecs)

    def place_cache(self, cache):
        """This rank's shard of a full cache or pool."""
        return self._place(cache, self.cache_pspecs)


def make_tp_spec(cfg: ModelConfig, api: ModelApi, mesh) -> TpSpec:
    """Validate ``cfg`` against the mesh and build the serving TpSpec.

    Head-axis sharding only: num_heads (and num_kv_heads for GQA) must
    divide by the model-axis size, since the paged kernels and the
    absorbed MLA products want whole heads a rank. Every model-sharded
    param dim is checked for divisibility, so a bad (config, mesh)
    pairing fails at construction."""
    from repro_torch.launch.mesh import mesh_info

    minfo = mesh_info(mesh)  # asserts the canonical axis names
    if api.param_pspecs is None:
        raise NotImplementedError(
            f"tensor-parallel serving of family {cfg.family!r} is not "
            "ported (the transformer's dense, moe and vlm carry a "
            "sharding description; ROADMAP Queue 1 item 6)")
    size = minfo.size("model")
    problems = []
    if cfg.num_heads % size:
        problems.append(f"num_heads {cfg.num_heads} % tp {size} != 0")
    if not cfg.use_mla and cfg.num_kv_heads % size:
        problems.append(f"num_kv_heads {cfg.num_kv_heads} % tp {size} != 0")
    specs = api.param_pspecs(cfg)

    def check(path, shape_leaf, spec):
        shape = shape_leaf[0]
        d = tplib.model_dim(spec)
        if d is not None and shape[d] % size:
            problems.append(f"param{path}: model-sharded dim {shape[d]} "
                            f"% tp {size} != 0")

    _walk(api.param_shapes(cfg), specs, check)
    if problems:
        raise ValueError(
            f"config {cfg.arch_id!r} cannot tensor-parallel over "
            f"{dict(minfo.sizes)}: " + "; ".join(problems))
    cfg_local = cfg
    if size > 1:
        kw = {"num_heads": cfg.num_heads // size}
        if not cfg.use_mla:
            kw["num_kv_heads"] = cfg.num_kv_heads // size
        cfg_local = dataclasses.replace(cfg, **kw)
    return TpSpec(mesh=mesh, axis="model", size=size, rank=mesh.rank,
                  cfg_local=cfg_local, minfo=minfo, param_pspecs=specs,
                  cache_pspecs=api.cache_pspecs(cfg))


def _tp_scope(tp: TpSpec | None):
    return (tplib.tensor_parallel(tp.ctx) if tp is not None
            else contextlib.nullcontext())


def make_serve_step(cfg: ModelConfig, api: ModelApi,
                    tp: TpSpec | None = None):
    """decode one token: (params, tokens (B, 1), cache, pos[, sample,
    block_tables, memory]) -> (next tokens (B, 1) int32, cache). ``pos``
    is an int or a per-row (B,) tensor; the token emitted sits at ``pos +
    1`` and is keyed there. ``block_tables`` makes ``cache`` the paged
    pool, decoded in place. ``memory`` is the encoder output or the image
    embeddings (B, T, D) the step attends. ``tp`` runs the model on this
    rank's shard (params and cache placed by ``tp``) under the ambient
    TP context; the logits leave it gathered, so every rank samples the
    same token."""
    mcfg = cfg if tp is None else tp.cfg_local

    def serve_step(params, tokens, cache, pos, sample=None,
                   block_tables=None, memory=None):
        kw = {} if memory is None else {"memory": memory}
        with _tp_scope(tp):
            logits, cache = api.decode_step(params, mcfg, tokens, cache, pos,
                                            block_tables=block_tables, **kw)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        nxt = sampling.sample_tokens(logits[:, -1, :], sample, pos + 1)
        return nxt[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, api: ModelApi,
                      tp: TpSpec | None = None):
    """prompt-KV writer: (params, batch, cache[, sample, cache_pos,
    block_tables]) -> (next tokens (B, 1), cache). ``cache_pos`` (int or
    per-row (B,)) makes the step chunked; a prefill of S tokens from p
    emits (and keys) the token at index p + S. ``block_tables`` routes
    the writes through the paged pool. ``tp`` as in
    ``make_serve_step``."""
    mcfg = cfg if tp is None else tp.cfg_local

    def prefill_step(params, batch, cache, sample=None, cache_pos=None,
                     block_tables=None):
        with _tp_scope(tp):
            logits, cache = api.prefill(params, mcfg, batch, cache,
                                        cache_pos=cache_pos,
                                        block_tables=block_tables)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        idx = batch["tokens"].shape[1]
        if cache_pos is not None:
            idx = cache_pos + idx
        nxt = sampling.sample_tokens(logits[:, -1, :], sample, idx)
        return nxt[:, None], cache

    return prefill_step


def make_verify_step(cfg: ModelConfig, api: ModelApi):
    """The speculative verifier, one batched rowwise program:
    ``verify(params, tokens (B, K+1), cache, pos (B,), block_tables,
    sample=None) -> target (B, K+1) int32``. Row r's chunk is its last
    committed token and K drafts, written at ``pos[r] .. pos[r] + K``
    through the block table (drafted positions land in the row's spare
    scratch rows: the caller splices them into the table);
    ``target[r, i]`` is the token the target emits at sequence index
    ``pos[r] + 1 + i`` under the position-keyed rule (greedy rows: exact
    argmax). Comparing the drafts with ``target`` on the host reproduces
    plain decode's stream. The chunk attends through the gathered dense
    view (a multi-token chunk), so it launches no paged decode kernel.
    MoE: co-verified positions share expert capacity — serve no-drop
    for parity."""

    def verify_step(params, tokens, cache, pos, block_tables, sample=None):
        logits, _ = api.prefill(params, cfg, {"tokens": tokens}, cache,
                                cache_pos=pos, block_tables=block_tables,
                                all_logits=True)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)
        return sampling.sample_token_block(logits, sample, pos)

    return verify_step


def make_decode_scan(cfg: ModelConfig, api: ModelApi, num_steps: int,
                     tp: TpSpec | None = None) -> Callable:
    """``num_steps`` decode steps as one program:
    ``decode_scan(params, tok (B, 1), cache, pos, sample=None,
    memory=None) -> (tokens (B, num_steps) int32, cache)``; ``pos`` (int
    or (B,)) is the first step's position. Sampling keys fold (request
    key, position) inside each step, so the scan matches the loop
    decode. Under ``tp`` each step is the rank's sharded step."""
    step = make_serve_step(cfg, api, tp=tp)

    def decode_scan(params, tok, cache, pos, sample=None, memory=None):
        buf = torch.empty((tok.shape[0], num_steps), dtype=torch.int32,
                          device=tok.device)
        for i in range(num_steps):
            nxt, cache = step(params, tok, cache, pos + i, sample,
                              memory=memory)
            buf[:, i] = nxt[:, 0]
            tok = nxt.long()
        return buf, cache

    return decode_scan


def server_device(device, mesh) -> torch.device:
    """A server's device: the mesh's when one is given (``device``, if
    also given, must name the same), else ``cuda`` unless the caller
    asks for another."""
    if mesh is None:
        return resolve_device(device)
    dev = getattr(mesh, "device", None)
    if dev is None:
        return resolve_device(device)       # mesh_info refuses it later
    if device is not None and resolve_device(device).type != dev.type:
        raise ValueError(f"the mesh lives on {dev}, the server was asked "
                         f"for {device}")
    return dev


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
        self.device = server_device(device, mesh)
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
        # mesh => tensor-parallel serving: the steps run on this rank's
        # shard of the params and caches
        self.tp = (make_tp_spec(cfg, self.api, mesh) if mesh is not None
                   else None)
        self._mesh_key = self.tp.mesh_key if self.tp is not None else None
        if self.tp is not None:
            self.params = self.tp.place_params(params)
        self._prefill = make_prefill_step(cfg, self.api, tp=self.tp)
        self._decode = make_serve_step(cfg, self.api, tp=self.tp)
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
        """The pooled (B, max_len) cache, zeroed first for a family
        outside ``_CACHE_REUSE_FAMILIES`` (whose prefill and decode write
        it in place); a new one at a batch size's first request."""
        pooled = self._cache_pool.pop(b, None)
        if pooled is None:
            cache = self.api.init_cache(self.cfg, b, self.max_len,
                                        device=self.device)
            return (self.tp.place_cache(cache) if self.tp is not None
                    else cache)
        if self.cfg.family not in _CACHE_REUSE_FAMILIES:
            for leaf in tree.leaves(pooled):
                leaf.zero_()
        return pooled

    def _return_cache(self, b: int, cache) -> None:
        self._cache_pool[b] = cache

    def _decode_scan(self, num_steps: int) -> graphs.Program:
        key = (num_steps, self._mesh_key)
        prog = self._decode_scans.get(key)
        if prog is None:
            scan = make_decode_scan(self.cfg, self.api, num_steps,
                                    tp=self.tp)

            def run(fixed, tok, pos, sample, memory):
                params, cache = fixed
                return scan(params, tok, cache, pos, sample, memory)[0]

            prog = self._decode_scans[key] = graphs.Program(
                run, device=self.device, pool=self._pool)
        return prog

    @torch.no_grad()
    def generate(self, prompts, num_tokens: int, extra: dict | None = None,
                 *, decode: str = "scan",
                 sample: SamplingParams | None = None,
                 prefill_chunk: int | None = None) -> ServeResult:
        """prompts (B, S) int — one bucket; decode ``num_tokens``.
        ``extra`` holds the audio family's ``frames`` (B, T_enc, D) or
        the VLM's ``image_embeds`` (B, T_img, D), moved to the server's
        device; the other families ignore it, as the JAX server does.

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
        prompts = torch.as_tensor(np.array(prompts, np.int64)
                                  if isinstance(prompts, np.ndarray)
                                  else prompts).to(self.device).long()
        b, s = prompts.shape
        if s + num_tokens > self.max_len:
            raise ValueError(f"prompt {s} + generate {num_tokens} exceeds "
                             f"max_len {self.max_len}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(f"prefill_chunk must be >= 1, got "
                                 f"{prefill_chunk}")
            if self.cfg.family not in PER_LAYER_PLAN_FAMILIES:
                raise ValueError(
                    "chunked prefill needs a prefill that takes a "
                    "cache_pos offset (the transformer's dense/moe "
                    f"stacks); family {self.cfg.family!r} does not")
        state = (sampling.sample_state(sample, b, self.device)
                 if sample is not None else None)
        cache = self._take_cache(b)
        batch = {"tokens": prompts, **{
            k: None if v is None else torch.as_tensor(v).to(self.device)
            for k, v in (extra or {}).items()}}
        with kops.execution_plan(self.plan):
            memory = None
            if self.cfg.family == "audio":
                memory = whisper.encode(self.params, self.cfg,
                                        batch["frames"])
            elif self.cfg.family == "vlm":
                memory = batch.get("image_embeds")
            if prefill_chunk is not None and s > prefill_chunk:
                for c0 in range(0, s, prefill_chunk):
                    chunk = dict(batch,
                                 tokens=prompts[:, c0:c0 + prefill_chunk])
                    nxt, cache = self._prefill(self.params, chunk, cache,
                                               state, c0)
            else:
                nxt, cache = self._prefill(self.params, batch, cache, state)
            pieces = [prompts.to(torch.int32), nxt]
            steps = num_tokens - 1
            if steps > 0 and decode == "scan":
                pos = torch.full((b,), s, dtype=torch.int64,
                                 device=self.device)
                pieces.append(self._decode_scan(steps)(
                    (self.params, cache), tok=nxt.long(), pos=pos,
                    sample=state, memory=memory))
            elif steps > 0:
                for i in range(steps):
                    nxt, cache = self._decode(self.params, nxt.long(), cache,
                                              s + i, state, memory=memory)
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
