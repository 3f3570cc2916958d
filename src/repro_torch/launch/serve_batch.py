"""End-to-end serving driver of the port (mirror of
``examples/serve_batch.py``), on the card unless ``--device cpu``.

Static-batch mode: prefill once, then decode N tokens as one captured
program (``--decode loop`` keeps one eager step a token). The audio and
VLM families (``--arch whisper-medium``, ``llama-3.2-vision-90b``) get
seeded standard-normal ``frames`` or ``image_embeds`` as ``extra``;
only this mode serves them.
``--pipeline-depths 2,4`` builds a per-layer ``ExecutionPlan`` (layer i
gets depth[i % len]).

Continuous mode (``--continuous``): mixed-length traffic through the
slot-cache scheduler (bucketed admission into freed slots between
segments, one persistent slot cache); with ``--paged`` through the
paged KV pool (block tables, prefix caching, chunked prefill-ahead).
``--temperature``/``--top-k``/``--top-p`` sample (every other request in
continuous mode). ``--faults site=rate,...`` gives the paged server a
seeded ``FaultInjector`` (``--fault-seed``, ``--max-faults-per-site``).
``--spec-k K`` (with ``--paged``) decodes speculatively: K drafted
tokens a row, verified in one program; the draft is the target itself
(the oracle: greedy acceptance 1.0) unless ``--draft-arch`` names
another smoke config, with random weights from seed 1. It asserts that
the run speculated, the pool ended empty and, greedy with the oracle,
that every draft was accepted.

RAG mode (``--rag``): queries drawn from a toy corpus of
``--corpus-size`` documents (chunks of ``--chunk-tokens``, one block by
default) through ``submit_query``: retrieval (``--rag-top-k`` chunks) on
the host between dispatches, chunk-addressed KV reuse. It asserts that
every query was retrieved and drained, that distinct queries spliced
each other's chunk blocks, and that the pool ended empty.

Overload mode (``--overload``): 2x-oversubscribed two-class traffic on
the paged server under EDF — a low-priority backlog of 2 x ``--slots``
requests, then ``--slots // 2`` high-priority requests with a TTFT
target after the first step; with a small ``--num-blocks`` the highs
stage by preempting lows (spilled to the Sidebar spill region and
restored later). It asserts that every request finishes, the pool ends
empty and the spill region holds nothing, and with ``--num-blocks``
that preemption and restore happened. Weights are random, from seed 0,
at the smoke size of ``--arch``.

Tensor parallelism (``--mesh DATAxMODEL``, static, continuous and RAG
modes): the steps run on each rank's shard of the weights and caches
over the mesh's "model" group (``launch.mesh``). ``--mesh 1x1`` runs in
this one process (a one-rank group: gloo on the CPU, NCCL on the card).
A larger mesh needs one process a rank with ``RANK`` and ``WORLD_SIZE``
set, as ``python -m torch.distributed.run --nproc-per-node N`` sets them
(NCCL on the card, one card a rank; gloo with ``--device cpu``);
without such a world it raises. Rank 0 prints.

Run: python -m repro_torch.launch.serve_batch --arch nemotron-4-15b \\
         --batch 4 --prompt-len 32 --gen 16 \\
         --execution-mode sidebar_pipelined --pipeline-depth 4
     python -m repro_torch.launch.serve_batch --arch whisper-medium
     python -m repro_torch.launch.serve_batch --continuous --paged \\
         --requests 8 --slots 4 --segment 8 --temperature 0.8
     python -m repro_torch.launch.serve_batch --continuous --paged \\
         --overload --num-blocks 10 --faults alloc=0.1,evict_storm=0.1
     python -m repro_torch.launch.serve_batch --continuous --paged \\
         --spec-k 4
     python -m repro_torch.launch.serve_batch --continuous --paged --rag
     python -m torch.distributed.run --nproc-per-node 2 \\
         -m repro_torch.launch.serve_batch --device cpu --mesh 1x2 \\
         --arch nemotron-4-15b --continuous --paged
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as cfglib
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.data.pipeline import memory_input
from repro_torch.device import resolve_device
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.mesh import destroy as destroy_mesh
from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
from repro_torch.launch.serve import Server
from repro_torch.launch.spec import SpecConfig
from repro_torch.models.registry import get_model
from repro_torch.retrieval import (
    ChunkedCorpus,
    EmbeddingIndex,
    RagPipeline,
    make_toy_corpus,
)


def build_mesh(args, device):
    """``--mesh RxC`` (or RxCxP) -> a canonical serving mesh; the
    "model" (last) axis is the tensor-parallel degree. A mesh of one
    runs in this process; a larger one joins the world of ``RANK`` /
    ``WORLD_SIZE`` (``torch.distributed.run``) and raises without it."""
    if not args.mesh:
        return None
    shape = tuple(int(d) for d in args.mesh.lower().split("x"))
    n = int(np.prod(shape))
    if n == 1 and len(shape) in (2, 3):
        return make_host_mesh(multi_pod=len(shape) == 3, device=device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != n and not dist.is_initialized():
        raise ValueError(
            f"--mesh {args.mesh} needs a world of {n} ranks and this "
            f"process is one of {world}: start it with python -m "
            f"torch.distributed.run --nproc-per-node {n} -m "
            "repro_torch.launch.serve_batch ...")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://")
    return make_serving_mesh(shape, device=None if device.type == "cuda"
                             else device)


def build_sampling(args) -> SamplingParams | None:
    temperature = args.temperature
    if temperature is None:
        if args.top_k is None and args.top_p is None:
            return None                 # no sampling flags: greedy
        temperature = 1.0               # top-k/top-p imply sampling
    return SamplingParams(temperature=temperature, top_k=args.top_k,
                          top_p=args.top_p, seed=args.seed)


def build_faults(args) -> FaultInjector | None:
    """``--faults site=rate,...`` -> a seeded ``FaultInjector`` (sites:
    alloc, evict_storm, stage_stall)."""
    if not args.faults:
        return None
    rates = {}
    for part in args.faults.split(","):
        site, rate = part.split("=")
        rates[site.strip()] = float(rate)
    return FaultInjector(seed=args.fault_seed, rates=rates,
                         max_per_site=args.max_faults_per_site)


def build_spec(args, cfg, params, device) -> SpecConfig | None:
    """``--spec-k K`` -> a ``SpecConfig``; the draft is the target itself
    (the oracle) unless ``--draft-arch`` names one (random weights from
    seed 1). The tokens equal plain decode's either way."""
    if not args.spec_k:
        return None
    if args.draft_arch is None:
        return SpecConfig(draft_cfg=cfg, draft_params=params, k=args.spec_k)
    draft_cfg = cfglib.get_smoke_config(args.draft_arch)
    draft_params = get_model(draft_cfg).init(draft_cfg, seed=1,
                                             device=device)
    return SpecConfig(draft_cfg=draft_cfg, draft_params=draft_params,
                      k=args.spec_k)


def _paged_block_size(args, max_len: int) -> int:
    bs = args.block_size                # must divide max_len: snap down
    while max_len % bs:
        bs -= 1
    return bs


def build_plan(args, cfg):
    if args.pipeline_depths:
        depths = [int(d) for d in args.pipeline_depths.split(",")]
        return ExecutionPlan.by_index([
            LayerPlan(ExecutionMode.SIDEBAR_PIPELINED,
                      depth=depths[i % len(depths)])
            for i in range(cfg.num_layers)])
    return LayerPlan(ExecutionMode(args.execution_mode),
                     depth=args.pipeline_depth)


def build_extra(args, cfg, device) -> dict:
    """The encoder input of the audio and VLM families: ``frames``
    (batch, encoder_seq, D) or ``image_embeds`` (batch, num_image_tokens,
    D), standard normal from seed 2 in ``cfg.dtype``; nothing for the
    other families."""
    memory = memory_input(cfg)
    if memory is None:
        return {}
    name, t = memory
    x = np.random.RandomState(2).standard_normal(
        (args.batch, t, cfg.d_model)).astype(np.float32)
    return {name: torch.from_numpy(x).to(device=device, dtype=cfg.dtype)}


def run_static(args, cfg, params, plan, device, mesh=None) -> None:
    sample = build_sampling(args)
    extra = build_extra(args, cfg, device)
    server = Server(cfg, params, max_len=args.prompt_len + args.gen,
                    plan=plan, device=device, mesh=mesh)
    print(f"arch={cfg.arch_id}, batch={args.batch}, prompt="
          f"{args.prompt_len}, gen={args.gen}, plan={plan}, decode="
          f"{args.decode}, sample={sample}, device={device}, captured="
          f"{server.captured and args.decode == 'scan'}")
    prompts = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    # the first call builds (and, on the card, captures) the program;
    # the timed one replays it
    server.generate(prompts, args.gen, extra, decode=args.decode,
                    sample=sample)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    result = server.generate(prompts, args.gen, extra, decode=args.decode,
                             sample=sample)
    tokens = result.tokens.cpu()
    dt = time.perf_counter() - t0
    total = args.batch * args.gen
    print(f"generated {total} tokens in {dt:.3f}s ({total / dt:.1f} "
          f"tokens/s on {device})")
    print("sample continuation ids:",
          tokens[0, args.prompt_len:args.prompt_len + 8].tolist())


def run_continuous(args, cfg, params, plan, device, mesh=None) -> None:
    sample = build_sampling(args)
    max_len = args.prompt_len + args.gen
    faults = build_faults(args)
    spec = build_spec(args, cfg, params, device)
    if spec is not None and not args.paged:
        raise SystemExit("--spec-k requires --paged (the verifier runs "
                         "through the block pool)")
    if args.paged:
        bs = _paged_block_size(args, max_len)
        sched = PagedContinuousBatchingServer(
            cfg, params, device=device, num_slots=args.slots,
            max_len=max_len, block_size=bs, num_blocks=args.num_blocks,
            prefill_chunk=args.prefill_chunk, segment=args.segment,
            plan=plan, kernel=args.kernel, faults=faults, spec=spec,
            mesh=mesh)
        kind = f"paged (block_size={bs}, kernel={args.kernel}"
        if spec is not None:
            kind += (f", spec k={spec.k} draft={spec.draft_cfg.arch_id}"
                     f"{' (oracle)' if args.draft_arch is None else ''}")
        kind += ")"
    else:
        sched = ContinuousBatchingServer(
            cfg, params, device=device, num_slots=args.slots,
            max_len=max_len,
            buckets=(args.prompt_len // 2, args.prompt_len),
            segment=args.segment, plan=plan, mesh=mesh)
        kind = "slot cache"
    if mesh is not None:
        kind += (f", mesh={'x'.join(map(str, mesh.shape))} "
                 f"{mesh.axis_names} over {mesh.transport}")
    print(f"arch={cfg.arch_id} continuous [{kind}]: requests="
          f"{args.requests}, slots={args.slots}, segment={args.segment}, "
          f"plan={plan}, sample={sample}, device={device}, captured="
          f"{sched.captured}")
    rng = np.random.RandomState(0)
    # paged traffic shares a prefix (the chat system-prompt shape), so
    # prefix caching is exercised
    prefix = rng.randint(0, cfg.vocab_size, size=args.prompt_len // 2)
    useful = 0
    for i in range(args.requests):
        gen = int(rng.randint(1, args.gen))
        useful += gen
        if args.paged:
            tail = int(rng.randint(2, max(3, args.prompt_len // 2)))
            prompt = np.concatenate(
                [prefix, rng.randint(0, cfg.vocab_size, size=tail)])
        else:
            prompt = rng.randint(0, cfg.vocab_size,
                                 size=int(rng.randint(2, args.prompt_len)))
        # every other request sampled: the mixed segment program
        sched.submit(prompt, gen, sample=sample if i % 2 == 0 else None)
    t0 = time.perf_counter()
    done = sched.run()
    dt = time.perf_counter() - t0
    print(f"drained {len(done)} requests / {useful} tokens in {dt:.2f}s "
          f"({useful / dt:.1f} tokens/s on {device}, cold)")
    print(sched.stats.summary())
    if faults is not None:
        print(f"faults injected: {faults.total_injected} "
              f"({dict(faults.injected)})")
    print("executables:", [k[:3] for k in sched.executable_cache_keys()])
    if len(done) != args.requests:
        raise RuntimeError(f"drain lost requests: {len(done)} != "
                           f"{args.requests}")
    if args.paged and args.requests >= 3 \
            and sched.stats.prefix_block_hits == 0:
        raise RuntimeError("shared-prefix traffic produced zero prefix "
                           "hits")
    if spec is not None:
        # it speculated, the pool drained clean, and a greedy oracle
        # draft was accepted whole
        if sched.stats.spec_steps == 0:
            raise RuntimeError("the speculative run never speculated")
        if sched.mgr.alloc.in_use:
            raise RuntimeError("the speculative run leaked pool blocks")
        if (args.draft_arch is None and sample is None
                and sched.stats.spec_acceptance_rate != 1.0):
            raise RuntimeError(
                "the greedy oracle draft must be accepted whole, got "
                f"{sched.stats.spec_acceptance_rate:.2f}")


def run_rag(args, cfg, params, plan, device, mesh=None) -> None:
    """Shared-corpus queries through ``submit_query`` (see the module
    docstring); raises unless every query was retrieved and drained,
    distinct queries spliced each other's chunk blocks and the pool
    ended empty."""
    sample = build_sampling(args)
    max_len = args.prompt_len + args.gen
    bs = _paged_block_size(args, max_len)
    chunk_tokens = args.chunk_tokens or bs
    if chunk_tokens % bs:
        raise SystemExit(f"--chunk-tokens {chunk_tokens} must be a "
                         f"multiple of the pool block size {bs}")
    docs = make_toy_corpus(cfg.vocab_size, n_docs=args.corpus_size,
                           doc_len=max(2 * chunk_tokens, 32),
                           seed=args.seed)
    corpus = ChunkedCorpus(docs, chunk_tokens=chunk_tokens)
    index = EmbeddingIndex(corpus, vocab_size=cfg.vocab_size,
                           seed=args.seed)
    rag = RagPipeline(index, system_prefix=list(range(5, 5 + bs // 2)),
                      block_size=bs, top_k=args.rag_top_k)
    sched = PagedContinuousBatchingServer(
        cfg, params, device=device, num_slots=args.slots, max_len=max_len,
        block_size=bs, prefill_chunk=args.prefill_chunk,
        segment=args.segment, plan=plan, kernel=args.kernel, rag=rag,
        mesh=mesh)
    print(f"arch={cfg.arch_id} rag [paged, block_size={bs}, kernel="
          f"{args.kernel}]: corpus={args.corpus_size} docs x "
          f"{len(corpus.chunks)} chunks ({chunk_tokens} tok), top_k="
          f"{args.rag_top_k}, queries={args.requests}, slots={args.slots}, "
          f"sample={sample}, device={device}, captured={sched.captured}")
    rng = np.random.RandomState(args.seed)
    # queries concentrate on a few documents, so distinct turns retrieve
    # overlapping chunk sets: shared leading block runs the pool splices
    hot = max(1, args.corpus_size // 2)
    useful = 0
    for i in range(args.requests):
        d = docs[rng.randint(hot)]
        lo = int(rng.randint(0, d.size - 6))
        q = d[lo:lo + int(rng.randint(3, 7))]
        gen = int(rng.randint(1, args.gen))
        useful += gen
        sched.submit_query(q, gen, sample=sample if i % 2 == 0 else None)
    t0 = time.perf_counter()
    done = sched.run()
    dt = time.perf_counter() - t0
    print(f"drained {len(done)} requests / {useful} tokens in {dt:.2f}s "
          f"({useful / dt:.1f} tokens/s on {device}, cold)")
    print(sched.stats.summary())
    checks = [
        (len(done) == args.requests,
         f"drain lost requests: {len(done)} != {args.requests}"),
        (sched.stats.retrievals == args.requests,
         f"{sched.stats.retrievals} retrievals for {args.requests} "
         "queries"),
        (sched.stats.retrieval_chunk_blocks > 0,
         "no retrieved-chunk block was staged"),
        (args.requests < 3 or sched.stats.retrieval_chunk_hits > 0,
         "shared-corpus queries produced zero chunk-cache hits"),
        (sched.mgr.alloc.in_use == 0, "the RAG run leaked pool blocks"),
    ]
    for ok, what in checks:
        if not ok:
            raise RuntimeError(what)


def run_overload(args, cfg, params, plan, device) -> None:
    """2x-oversubscribed two-class traffic on the paged server (see the
    module docstring); raises unless every request finished, the pool is
    quiescent and the spill region empty, and — with ``--num-blocks`` —
    unless preemption and restore happened."""
    faults = build_faults(args)
    max_len = args.prompt_len + args.gen
    bs = _paged_block_size(args, max_len)
    sched = PagedContinuousBatchingServer(
        cfg, params, device=device, num_slots=args.slots, max_len=max_len,
        block_size=bs, prefill_chunk=args.prefill_chunk,
        num_blocks=args.num_blocks, segment=args.segment, plan=plan,
        kernel=args.kernel, faults=faults, scheduling="edf")
    pool = (f"{args.num_blocks} blocks" if args.num_blocks
            else "default pool")
    print(f"arch={cfg.arch_id} overload [paged, {pool}, block_size={bs}]: "
          f"slots={args.slots}, faults={args.faults or 'none'} "
          f"(seed={args.fault_seed}), device={device}, captured="
          f"{sched.captured}")
    rng = np.random.RandomState(args.seed)
    n_low = 2 * args.slots              # 2x oversubscription
    n_high = max(1, args.slots // 2)
    for _ in range(n_low):
        p = rng.randint(0, cfg.vocab_size, size=max(2, args.prompt_len // 4))
        sched.submit(p, args.gen, priority=0)
    t0 = time.perf_counter()
    sched.step()                        # the backlog mid-flight ...
    for _ in range(n_high):             # ... then the highs land
        p = rng.randint(0, cfg.vocab_size, size=max(2, args.prompt_len - 1))
        sched.submit(p, max(2, args.gen // 2), priority=1,
                     ttft_target=60.0)
    done = sched.run()                  # every request, the first step's too
    dt = time.perf_counter() - t0
    n_tok = sum(r.generated for r in done)
    print(f"drained {len(done)} requests / {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tokens/s on {device}, cold)")
    print(sched.stats.summary())
    print(f"spill region: peak {sched.spill.peak_bytes} bytes, "
          f"{sched.spill.spills} spills, {sched.spill.restores} restores")
    if faults is not None:
        print(f"faults injected: {faults.total_injected} "
              f"({dict(faults.injected)})")
    alloc = sched.mgr.alloc
    checks = [
        (len(done) == n_low + n_high,
         f"drain lost requests: {len(done)} != {n_low + n_high}"),
        (alloc.in_use == 0, "pool leaked blocks"),
        (alloc.num_free + alloc.num_evictable == alloc.capacity,
         "pool accounting drifted"),
        (len(sched.spill) == 0 and sched.spill.in_use_bytes == 0,
         "spill region holds payloads after a full drain"),
    ]
    if args.num_blocks:                 # tiny pool: overload must preempt
        checks.append((sched.stats.preemptions > 0
                       and sched.stats.restores > 0,
                       "tiny-pool overload never preempted and restored"))
    for ok, what in checks:
        if not ok:
            raise RuntimeError(what)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=cfglib.ARCH_IDS)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--execution-mode", default="sidebar",
                    choices=[ExecutionMode.SIDEBAR.value,
                             ExecutionMode.SIDEBAR_PIPELINED.value])
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="ring depth T for sidebar_pipelined (>= 1)")
    ap.add_argument("--pipeline-depths", default=None,
                    help="comma list of per-layer ring depths (layer i "
                         "gets depths[i %% len])")
    ap.add_argument("--decode", default="scan", choices=["scan", "loop"],
                    help="scan: the N steps as one program (a CUDA graph "
                         "on the card); loop: one eager step a token")
    ap.add_argument("--continuous", action="store_true",
                    help="mixed-length traffic through the slot-cache "
                         "scheduler")
    ap.add_argument("--paged", action="store_true",
                    help="with --continuous: the paged KV pool")
    ap.add_argument("--kernel", default="paged", choices=["paged", "slab"])
    ap.add_argument("--use-pallas", action="store_true",
                    help="the MLP through its Sidebar kernel (the plain "
                         "version on the CPU)")
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=None)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--segment", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=None,
                    help="sampled decoding (temperature 0 = exact greedy)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0,
                    help="sampling seed (same seed => same tokens)")
    ap.add_argument("--overload", action="store_true",
                    help="2x-oversubscribed priority traffic on the paged "
                         "server: EDF admission, preemption, spill and "
                         "restore; asserts completion and no leaks")
    ap.add_argument("--faults", default=None,
                    help="seeded fault injection, 'site=rate,...' (sites: "
                         "alloc, evict_storm, stage_stall)")
    ap.add_argument("--fault-seed", type=int, default=0)
    ap.add_argument("--max-faults-per-site", type=int, default=8,
                    help="bound the Bernoulli firings per site")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="speculative decoding (requires --paged): draft "
                         "K tokens a row a step and verify them in one "
                         "program; 0 disables")
    ap.add_argument("--draft-arch", default=None, choices=cfglib.ARCH_IDS,
                    help="the draft's architecture for --spec-k (default: "
                         "the target itself, the oracle draft)")
    ap.add_argument("--rag", action="store_true",
                    help="shared-corpus queries through submit_query: "
                         "host retrieval between dispatches, chunk-"
                         "addressed KV reuse; asserts chunk-cache hits")
    ap.add_argument("--corpus-size", type=int, default=4,
                    help="with --rag: documents in the toy corpus (queries "
                         "concentrate on the first half)")
    ap.add_argument("--rag-top-k", type=int, default=2,
                    help="with --rag: retrieved chunks a query")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="with --rag: corpus chunk length, a multiple of "
                         "the block size (default: one block)")
    ap.add_argument("--mesh", default=None,
                    help="serving mesh shape 'DATAxMODEL' (e.g. 1x2): "
                         "tensor-parallel over the mesh's 'model' axis; "
                         "beyond 1x1 one process a rank "
                         "(torch.distributed.run)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh = build_mesh(args, device)
    if mesh is not None:
        device = mesh.device
    cfg = cfglib.get_smoke_config(args.arch)
    if args.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    plan = build_plan(args, cfg)
    params = get_model(cfg).init(cfg, seed=0, device=device)
    quiet = mesh is not None and dist.get_rank() != 0   # rank 0 prints
    with (contextlib.redirect_stdout(io.StringIO()) if quiet
          else contextlib.nullcontext()):
        if args.rag:
            run_rag(args, cfg, params, plan, device, mesh)
        elif args.overload:
            run_overload(args, cfg, params, plan, device)
        elif args.continuous:
            run_continuous(args, cfg, params, plan, device, mesh)
        else:
            run_static(args, cfg, params, plan, device, mesh)
    if mesh is not None:
        destroy_mesh()


if __name__ == "__main__":
    main()
