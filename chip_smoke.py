"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints JSON objects on lines of their own; any failure
exits non-zero):

  0. the card (``nvidia-smi`` name and power limit) and the build of
     every CUDA kernel from ``src/repro_torch/csrc``, and of a
     ``device_expr`` variant (mish) of every kernel that applies an
     activation (one ``nvcc`` per library, all started together);
  1. op level: each kernel against its plain PyTorch version on the
     card — smoke shapes in fp32 (ragged rows, columns and contractions,
     ragged lengths, duplicate table entries, scratch-padded tails,
     several activations and epilogues, the rowwise softmax and rmsnorm)
     and nemotron-4-15b, deepseek-7b and deepseek-v3-671b shapes in
     bf16, fp and int8 KV (paged decode at group 6 and at group 1, and
     at group 5 (bf16) and 16 (int8) for the configs of phases 10-12; MLA
     absorbed decode at 128 heads, kvr 512; flash attention at S = T =
     4096 with nemotron's 48 / 8 and deepseek-7b's 32 / 32 heads) —
     with the kernel's time,
     the plain version's time, the bound of the work and the time of one
     PyTorch call of the same function where there is one (the kernels
     redesigned for Hopper -- both MLPs, the ring, flash,
     ``sidebar_matmul``, ``paged_gqa``, ``paged_mla`` and ``activation``
     -- also give their time before the redesign and the time over the
     bound); ``paged_mla`` split-KV at deepseek-v3's widths on its
     tensor-core route with its splits a row, its bound on that route
     and the fp32-FMA bound beside it, equal to a second run bit for bit
     and each row alone equal to its row in the batch, and its FMA route
     at smoke widths with a length-0 row; ``flexible_dma_chain``:
     FLEXIBLE_DMA's whole MLP (five programmatic dependent launches) at
     4 and 64 rows beside the sum of its parts' times and bounds and the
     fused ``sidebar_mlp``, equal with and without a synchronize between
     its launches; ``sidebar_matmul``'s two
     FLEXIBLE_DMA products at 4 and 64 rows on the tensor-core route with
     their partition (one panel: each weight tile read from HBM once),
     and a ragged bf16 product on its fma route; ``paged_gqa`` split-KV
     with its split chunk and splits a row, both equal to a second run
     bit for bit; the ring MLP at depths 1-4, bitwise equal
     across depths, in fp32 and bf16, ragged bf16 widths on its FMA
     route included; the serial MLP at nemotron's widths at 4, 16, 64
     and 4096 rows, bitwise equal to the ring at depths 1-4 (it is the
     ring with one slot) and timed beside the ring at depth 1; the
     gated MLP at 4, 16 and 64 rows of deepseek-7b's and deepseek-v3's
     widths and at 16 and 64 rows of qwen3-14b's (5120 x 17408) and
     llama3-405b's (16384 x 53248) with its route, clusters and D2
     passes, equal to a second run bit for bit; every case names its
     route ("tc": tensor cores, "fma": CUDA cores);
     ``moe_grouped_mm`` (the MoE layers' expert products) at
     llama4-scout's and deepseek-v3's widths at decode and in a staging
     round on the tensor-core route's narrow shape (each row alone equal
     to its row in the batch; its K splits and its time before the
     redesign; the wide shape's time beside it), at 4096 tokens on the
     wide shape against per-group products (a row equal whatever the
     other rows of its group hold), both shapes timed across the
     narrow / wide threshold, and fp32 / ragged bf16 on its FMA
     route; the routed expert pass in its plain form (JAX's: every
     expert on its top-capacity tokens, batched cuBLAS products) and
     its kernel form at those widths at 4, 64 and 4096 tokens, both
     timed, agreeing to 1e-2; and the run-time activation check: mish
     registered with a ``device_expr`` on a fresh function table,
     through all five wrappers that take an activation, an entry
     without one refused, and an expression that
     does not compute its torch callable (``x * tanhf(x)`` for mish)
     refused before any launch; and every CUDA wrapper's refusal of an
     operand that requires grad (no kernel has a backward);
  2. nemotron-4-15b at full width (bf16 weights from a seed) served by
     ``PagedContinuousBatchingServer(kernel="paged")`` with the kernels
     on under the default SIDEBAR plan: 8 requests, half sharing a
     128-token prefix, 32 greedy tokens each; launch counts are reset
     before and read after the run. Its segments run as captured CUDA
     graphs (``launch.graphs``: captured once a key, replayed after),
     as do those of every serving phase, and so does a staging key from
     its ``stage_capture_after``-th round (each row says ``captured``
     and counts ``captures``, ``replays`` and the capture's host
     seconds, the staging rounds' apart: eager, captured, replayed);
     launch counts stay exact through replays;
  5. the same weights and traffic under the paper's other execution
     modes — SIDEBAR_PIPELINED at depth 2, a per-layer plan of depths 2
     and 4, and FLEXIBLE_DMA — with exact launch counts per mode and a
     summary line of tokens/s per mode; the two ring plans must give
     SIDEBAR's greedy tokens, all of them; every FLEXIBLE_DMA product
     takes ``sidebar_matmul``'s tensor-core route;
  3. the same widths with int8 KV (depth cut to 4 layers);
  4. the fp32 smoke configs of all six architectures (MoE at no-drop
     capacity) on the card: ``kernel="paged"`` against
     ``kernel="slab"``, and the SIDEBAR_PIPELINED, FLEXIBLE_DMA and a
     mixed per-layer plan against SIDEBAR, on the same traffic, compared
     by tokens and logits; and a warm drain (its prompts' prefix blocks
     spliced) against the cold drain on one server: equal greedy tokens,
     logits within 1e-4;
  6. deepseek-7b at full width (all 30 layers, bf16 weights from a
     seed) served like phase 2: every layer's MLP through the gated
     kernel, decode attention at group 1, exact launch counts, tokens/s,
     TTFT and peak memory;
  7. deepseek-v3-671b at full width (d 7168, 128 heads, MLA kvr 512,
     all 256 routed experts top-8 plus the shared one, capacity factor
     1.25), its depth cut from 61 to 5 layers (the 3 dense + 2 MoE: the
     whole model does not fit one card), bf16 weights from a seed,
     served like phase 6 on phase 6's traffic: decode attention through
     ``paged_mla`` in place on the compressed pool, the dense layers'
     MLP through the gated kernel, the MoE layers' experts through the
     grouped expert kernel with the routing on the card (captured), exact
     launch counts, no ``gather_blocks``, tokens/s, TTFT and peak memory;
     then on a fresh server a warm-up drain, an eager drain and a
     captured one: the same greedy tokens bit for bit, each with exact
     launch counts;
  8. the training path: (8a) ``forward`` and the loss of nemotron-4-15b
     at full width and depth (phase 2's 32-layer weights) on one
     4096-token sequence under ``no_grad``, with the kernels (exactly 32
     ``flash_attention`` and 32 ``sidebar_mlp`` launches) and without
     them (the chunked attention route), losses within 1e-2; (8b) three
     ``make_train_step`` steps at full width cut to 2 layers (two
     microbatches of 4096 tokens, remat, AdamW), with the kernels'
     refusal under autograd; (8c) ``Trainer`` at the fp32 smoke size:
     checkpoint, resume, and the uninterrupted run's losses;
  9. on phase 2's weights: (9a) the static-batch ``Server`` on 4 prompts
     of 128 tokens, 32 new: ``decode="scan"`` (one graph of the 31
     steps) == ``"loop"`` bit for bit, greedy and sampled (temperature
     0.9, top-k 50, top-p 0.95), temperature 0 and top-k 1 == greedy,
     SIDEBAR_PIPELINED d2 == SIDEBAR, exact ``sidebar_mlp`` launches,
     ms a decode step scan beside loop; (9b) the slot-cache
     ``ContinuousBatchingServer`` on phase 2's traffic, every other
     request sampled: captured == eager (``disable_capture()``) bit for
     bit, compiles/hits, tokens/s, TTFT, peak memory; (9c) the paged
     server on the same traffic, greedy and half sampled, its staging
     keys captured at their first round: captured == eager (staging
     rounds replayed), tokens/s of both in the order
     E C C E, and the count of tokens that differ from the cold
     warm-up drain's;
 10. qwen3-14b (qk-norm, GQA group 5) at full width and depth (40
     layers, ~28 GB of bf16 weights from a seed), served like phase 6;
 11. llama3-405b at full width with its int8 KV pool (GQA group 16),
     depth cut from 126 to 8 layers (~55 GB), served like phase 6;
 12. llama4-scout-17b-a16e at full width (16 experts top-1 and one
     shared expert in every layer), depth cut from 48 to 8 layers (~37
     GB), served like phase 6 and then eager against captured like
     phase 7;
 13. overload on the first 8 layers of phase 2's weights
     (``SIDE_LAYERS``; fewer when ``--layers`` cuts phase 2):
     (13a) the paged server with 4 slots, block 16, max_len 512 and 48
     allocatable blocks, 2x oversubscribed: 8 lows of 96-160 tokens
     (priority 0, 128 greedy tokens), then, after 3 scheduler steps, 2
     highs of 200-240 tokens (priority 1, 64 tokens, the second
     sampled) with a TTFT target of twice their unloaded p95 (measured
     on the ample pool, the second of two runs), under EDF and then
     FIFO on one server (its cached blocks evicted between), and on an
     ample pool. Gates: every request finishes; the pool ends with
     nothing in use and free + evictable == capacity, the spill region
     empty; the tight arms preempt and restore, the ample one does not;
     the first spill's payload equals the blocks its restore leaves in
     the pool on every leaf (``torch.equal``), and no pool leaf moves;
     under EDF each high is admitted before every low still pending when
     it arrived, under FIFO in arrival order; exact launch counts.
     Printed: tokens/s, TTFT p50 / p95 per class, goodput (tokens of
     requests that met their target, a second), the overload counters,
     the spill region's peak bytes, host seconds in spill and restore,
     captures and replays, and the tokens that differ from the ample
     drain (bf16: rows counts differ; not gated). (13b) the three cache
     families at fp32 smoke size (nemotron-4-15b, its int8 KV, deepseek-
     v3 at no-drop capacity): the tight server of
     ``tests/test_preemption.py`` against an ample pool, greedy and
     sampled, equal tokens. (13c) a ``ReplicaRouter`` of two tight
     replicas sharing phase 2's params, with a seeded ``FaultInjector``
     at every site, on 13a's traffic, eagerly: every request finishes,
     every pool and spill region quiescent; stolen requests, quarantines
     and the faults injected are printed;
 14. speculative decoding and RAG on the same 8 layers of phase 2's
     weights: (14a) phase 2's server and greedy traffic on
     three servers — plain, the oracle draft (the model itself) and a
     shallow draft (the model's first 2 layers with its embedding and
     final norm, sharing the weights), k = 4 — each draining cold, then
     warm: tokens/s, TTFT, acceptance, verify calls, draft rounds,
     commit copies, host syncs (two a speculative step) and host
     seconds and device ms a step, captures and replays, and the tokens
     that differ from the plain drain (bf16: printed, not gated); the
     draft and verify programs captured == eager on one warm server at 2
     layers of full width; (14b) the three cache families at fp32 smoke
     size: the oracle draft at k = 3, greedy and half sampled, equal to
     the plain server and solo ``generate``, greedy acceptance exactly
     1.0, and the tight-pool speculative drain preempting with solo
     decode's tokens; (14c) the RAG drive of
     ``benchmarks/serving_bench.py`` (a 2048-document toy corpus in
     32-token chunks, a 20 ms modeled fetch a search, top-2, 4 leads and
     8 waves of 2 queries) on an overlapped and a serial server, cold,
     then warm overlap / serial / overlap, and at fp32 smoke size RAG
     drains equal to plain ``submit`` of their prompts, overlap on and
     off. Gates: completion, quiescence, exact launches (a verify call
     and a staging round are multi-token chunks, no paged kernel; a
     draft round is k forward calls on the draft's slab), each
     speculative drain's allocator traffic equal to the plain drain's,
     every query retrieved, chunk hits, overlap only in the overlap
     arms, the same prompts in every arm;
 15. the analytical Sidebar engine (``core/engine.py``), its energy model
     and its planner on the card, after ``chip_probe`` (the measured
     constants of the port's H100 spec: idle draw, SM clock, a launch,
     a pinned round trip, a flag's one way): (15a) the paper's LeNet on
     CIFAR-10 shapes at batch 256 (fp32 weights from seed 0), relu and
     softplus, through ``engine.run`` under the four modes: within 1e-4
     of the plain ``forward``, every SidebarStats field, ``launches``
     and the accounting equal to a CPU run of the same graph, the
     ``activation`` kernel launched once a relu / softplus op of the
     FLEXIBLE_DMA run (``max_pool`` runs its torch callable), MONOLITHIC
     captured == eager bit for bit and unchanged by a table hot-swap
     after build; each mode's median wall ms beside the modelled
     latency, energy and normalized EDP of ``estimate(account_model(...))``
     under the H100 spec, and the paper's claims (reported, not gated);
     (15b) the MLP task at nemotron-4-15b's widths (d 6144, f 24576,
     squared_relu, fp32) at 4 and 64 rows under the four modes, within
     1e-4 relative of MONOLITHIC, beside phase 1's fused kernel; (15c)
     ``AutoPolicy`` on the H100 spec plans one MLP layer graph a layer
     (4 rows, bf16; its depth follows ``--layers``), and phase 2's
     traffic is served on phase 2's weights under that plan: every
     request finishes, exact launches, every MLP dispatch on its layer's
     planned route, greedy tokens equal to phase 2's SIDEBAR drain (and
     to phase 5's arm of the same plan when phase 5 ran).

The line before the last holds the kernel table, the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM, NVIDIA data sheet (dense): HBM rate and peak operation rates
# (bf16 and TF32 on the tensor cores; fp32 outside them, for elementwise
# work)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, "tf32": 495e12, torch.float32: 67e12}
# torch.cuda._sleep spins for a count of SM clock cycles (H100 SXM:
# 1.98 GHz at most; a lower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 1.98e9
D_MODEL, D_FF, D_LAYERS = 6144, 24576, 32   # nemotron-4-15b
DS_MODEL, DS_FF = 4096, 11008         # deepseek-7b
V3_MODEL, V3_FF = 7168, 18432         # deepseek-v3-671b's dense layers
QW_MODEL, QW_FF = 5120, 17408         # qwen3-14b
L3_MODEL, L3_FF = 16384, 53248        # llama3-405b
KERNELS = ("sidebar_mlp", "paged_gqa", "sidebar_mlp_pipelined",
           "sidebar_matmul", "activation", "sidebar_gated_mlp", "paged_mla",
           "flash_attention", "moe_grouped_mm")
# the run-time activation of phase 0's variant builds and phase 1's check,
# and an expression that does not compute mish (refused by the check)
MISH_EXPR = "x * tanhf(log1pf(expf(x)))"
WRONG_MISH_EXPR = "x * tanhf(x)"
# the redesigned kernels' times before their redesign (chip_smoke.py
# phase 1 on an NVIDIA H100 80GB HBM3 at 700 W: the ring kernel at depth
# 2 by token rows, flash at S = T = 4096 by architecture)
PREVIOUS_MS = {"sidebar_mlp_pipelined": {4: 1.148, 64: 3.659},
               "flash_attention": {"nemotron-4-15b": 1.241,
                                   "deepseek-7b": 0.921},
               # the serial MLP kernels before their redesign (FMA
               # streams): by token rows, and by architecture
               "sidebar_mlp": {4: 0.711, 64: 3.19},
               "sidebar_gated_mlp": {"deepseek-7b": {4: 0.242, 64: 1.15},
                                     "deepseek-v3-671b": {4: 0.794,
                                                          64: 3.29}},
               # the FMA stream of sidebar_matmul and the one-block-per-
               # (row, KV head) paged_gqa, on the same card: by (token
               # rows, role), and by (architecture, KV type)
               "sidebar_matmul": {(4, "producer"): 0.234,
                                  (4, "consumer"): 0.324,
                                  (64, "producer"): 1.420,
                                  (64, "consumer"): 1.445},
               "paged_gqa": {("nemotron-4-15b", "bfloat16"): 0.146,
                             ("nemotron-4-15b", "int8"): 0.139,
                             ("deepseek-7b", "bfloat16"): 0.105,
                             ("deepseek-7b", "int8"): 0.114},
               # the one-block-per-(row, 4 heads) paged_mla on the CUDA
               # cores, and the plain-launch activation by token rows
               "paged_mla": 0.0635,
               "activation": {4: 0.00323, 64: 0.00400},
               # the first design of moe_grouped_mm (mma.sync on 64 x 64
               # tiles, a tile slot for every expert), by (architecture,
               # product, tokens)
               "moe_grouped_mm": {
                   ("llama4-scout-17b-a16e", "gate", 4): 0.124,
                   ("llama4-scout-17b-a16e", "down", 4): 0.129,
                   ("llama4-scout-17b-a16e", "gate", 64): 0.482,
                   ("deepseek-v3-671b", "gate", 4): 0.435,
                   ("deepseek-v3-671b", "down", 4): 0.886,
                   ("deepseek-v3-671b", "gate", 64): 2.309}}


def mish(t: torch.Tensor) -> torch.Tensor:
    return (t.float() * torch.tanh(torch.nn.functional.softplus(t.float()))
            ).to(t.dtype)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events. The
    stream first sleeps for twice the host's time to enqueue the calls,
    so the calls run back to back on the device and a kernel shorter than
    its host-side launch is timed by the device, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep_s = min(2 * host_s * iters, 0.5)
    torch.cuda._sleep(int(sleep_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """The least time of the work on the card: max of bytes over the HBM
    rate and operations over the peak rate of their type (ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    err = (out.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def row_rel_err(out: torch.Tensor, ref: torch.Tensor
                ) -> tuple[float, float]:
    """The largest error, and the worst row's largest error over that
    row's largest |ref| (rows along the last dim): each row is held to
    its own scale, so rows of small values (late causal rows, which
    average thousands of keys) are held as tightly as the large ones."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    err = (o - r).abs().amax(-1)
    rel = err / r.abs().amax(-1).clamp_min(1e-30)
    return err.max().item(), rel.max().item()


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


# ---------------------------------------------------------------------------
# Phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def mlp_ops(seed: int = 0) -> dict:
    from repro_torch.kernels import sidebar_mlp as sm

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    worst = 0.0
    # fp32 smoke widths: exact-fp32 plain version, tolerance 1e-4
    # relative (the two sum D and F in different orders)
    for m in (1, 3, 4, 64, 130):
        for act in ("squared_relu", "relu", "gelu", "silu", "exp_decay",
                    "identity"):
            x = torch.randn(m, 64, generator=g, device=dev)
            w1 = torch.randn(64, 256, generator=g, device=dev) / 8
            w2 = torch.randn(256, 64, generator=g, device=dev) / 16
            out = sm.sidebar_mlp(x, w1, w2, act)
            torch.cuda.synchronize()
            ref = sm.sidebar_mlp_plain(x, w1, w2, act)
            _, rel = rel_err(out, ref)
            check(out.shape == ref.shape and rel <= 1e-4,
                  f"sidebar_mlp fp32 m={m} {act}: rel {rel}")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "sidebar_mlp", "dtype": "float32",
          "rows": [1, 3, 4, 64, 130], "max_rel_err": worst, "tol": 1e-4})
    # a ragged bf16 shape (D, F, D2 not multiples of 8): the FMA body,
    # against the plain version in fp32, bitwise equal to the ring
    x, w1, w2 = (torch.randn(*sh, generator=g, device=dev).bfloat16()
                 for sh in ((4, 100), (100, 260), (260, 68)))
    w1, w2 = w1 / 10, w2 / 16
    out = sm.sidebar_mlp(x, w1, w2, "squared_relu")
    ring = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu", depth=t)
            for t in (1, 2, 3, 4)]
    torch.cuda.synchronize()
    ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                               "squared_relu")
    _, rel = rel_err(out, ref)
    route = sm.route(x, w1, w2)
    check(route == "fma" and rel <= 2e-2,
          f"sidebar_mlp bf16 ragged: route {route}, rel {rel}")
    check(all(torch.equal(out, o) for o in ring),
          "sidebar_mlp bf16 ragged: not the ring's bits")
    emit({"phase": 1, "op": "sidebar_mlp", "dtype": "bfloat16",
          "shape": [4, 100, 260, 68], "route": route, "max_rel_err": rel,
          "tol": 2e-2, "equal_to_ring_at_depths_1_4": True})
    # nemotron-4-15b widths in bf16: decode (4 rows), staging rounds of
    # one request and of four (16, 64 rows) and the training forward's
    # 4096 rows; against the plain version run in fp32 on the same
    # values: 2e-2 relative covers bf16 rounding of f(h) and the output.
    # The serial kernel is the ring with one slot: bitwise equal to it at
    # depths 1-4, timed beside the ring at depth 1 in this call
    w1, w2 = full_weights(g)
    main = None
    for m in (4, 16, 64, 4096):
        x = torch.randn(m, D_MODEL, generator=g, device=dev).bfloat16()
        out = sm.sidebar_mlp(x, w1, w2, "squared_relu")
        torch.cuda.synchronize()
        ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                                   "squared_relu")
        err, rel = rel_err(out, ref)
        del ref
        check(rel <= 2e-2, f"sidebar_mlp bf16 m={m}: rel {rel}")
        route = sm.route(x, w1, w2)
        check(route == "tc", f"sidebar_mlp bf16 m={m}: route {route}")
        row = {"phase": 1, "op": "sidebar_mlp", "dtype": "bfloat16",
               "shape": [m, D_MODEL, D_FF], "route": route,
               "plan": dataclasses.asdict(sm.serial_plan(m, D_FF, route)),
               "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2}
        if m <= 64:
            same = all(torch.equal(out, sm.sidebar_mlp_pipelined(
                x, w1, w2, "squared_relu", depth=t)) for t in (1, 2, 3, 4))
            check(same, f"sidebar_mlp bf16 m={m}: not the ring's bits")
            row["equal_to_ring_at_depths_1_4"] = same
        iters = 20 if m <= 64 else 5
        ms = cuda_ms(lambda: sm.sidebar_mlp(x, w1, w2, "squared_relu"),
                     iters)
        ring1 = cuda_ms(lambda: sm.sidebar_mlp_pipelined(
            x, w1, w2, "squared_relu", depth=1), iters)
        plain_ms = cuda_ms(
            lambda: sm.sidebar_mlp_plain(x, w1, w2, "squared_relu"), iters)
        lib_ms = cuda_ms(
            lambda: (torch.relu(x @ w1) ** 2).to(torch.bfloat16) @ w2, iters)
        nbytes = 2 * (x.numel() + w1.numel() + w2.numel() + m * D_MODEL)
        ops = 2 * 2 * m * D_MODEL * D_FF
        b_ms, b_by = bound(nbytes, ops, torch.bfloat16)
        row.update({
            "ms": ms, "ring_depth1_ms": ring1,
            "previous_ms": PREVIOUS_MS["sidebar_mlp"].get(m),
            "tb_per_s": nbytes / ms / 1e9, "tflop_per_s": ops / ms / 1e9,
            "ms_over_bound": ms / b_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by})
        emit(row)
        if m == 4:
            main = row
        del x, out
    del w1, w2
    torch.cuda.empty_cache()
    return main


def _pool_problem(g, *, b, hkv, group, dh, bs, nb, lengths, qdtype,
                  kvdtype, copies=1):
    """Pools with duplicate table entries and scratch-padded tails."""
    dev = "cuda"
    p = b * nb + 1
    rng = np.random.RandomState(0)
    tables = rng.randint(1, p, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0                 # scratch tail
    if b > 1 and -(-lengths[1] // bs) > 2:
        tables[1, 2] = tables[1, 1]                  # shared block
    probs = []
    for _ in range(copies):
        q = torch.randn(b, hkv * group, dh, generator=g, device=dev
                        ).to(qdtype)
        if kvdtype == torch.int8:
            k = torch.randint(-127, 128, (p, hkv, bs, dh), generator=g,
                              device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, (p, hkv, bs, dh), generator=g,
                              device=dev, dtype=torch.int8)
            ks = (torch.rand(p, hkv, bs, generator=g, device=dev) + .5) / 127
            vs = (torch.rand(p, hkv, bs, generator=g, device=dev) + .5) / 127
        else:
            k = torch.randn(p, hkv, bs, dh, generator=g, device=dev
                            ).to(kvdtype)
            v = torch.randn(p, hkv, bs, dh, generator=g, device=dev
                            ).to(kvdtype)
            ks = vs = None
        probs.append((q, k, v, ks, vs))
    t = torch.as_tensor(tables, device=dev)
    ln = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    return probs, t, ln, dh ** -0.5


def paged_ops(seed: int = 1) -> dict:
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    # smoke widths in fp32 (and int8 KV), block 8: splits of 64
    # positions, rows of one partial split, of two and of 12 blocks;
    # tolerance 1e-4 relative — the kernel's split softmax and merge
    # against the plain two-pass softmax
    smoke_lengths = [5, 70, 96]
    for dh, bs, group in ((16, 8, 4), (8, 8, 4), (16, 8, 1)):
        for kvdt in (torch.float32, torch.int8):
            probs, t, ln, scale = _pool_problem(
                g, b=3, hkv=2, group=group, dh=dh, bs=bs, nb=12,
                lengths=smoke_lengths, qdtype=torch.float32, kvdtype=kvdt)
            q, k, v, ks, vs = probs[0]
            out = pa.paged_gqa(q, k, v, t, ln, scale=scale, k_scale=ks,
                               v_scale=vs)
            torch.cuda.synchronize()
            ref = pa.paged_gqa_reference(q, k, v, t, ln, scale=scale,
                                         k_scale=ks, v_scale=vs)
            _, rel = rel_err(out, ref)
            check(rel <= 1e-4, f"paged_gqa fp32 dh={dh} group={group} "
                               f"{kvdt}: rel {rel}")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "paged_gqa", "dtype": "float32",
          "groups": [4, 1], "lengths": smoke_lengths,
          "chunk": pa.split_chunk(8),
          "splits": [len(pa.split_bounds(n, 8)) for n in smoke_lengths],
          "max_rel_err": worst, "tol": 1e-4})
    # nemotron-4-15b widths (48 query / 8 KV heads: group 6) and
    # deepseek-7b's (32 / 32: group 1, MHA): 4 rows, head_dim 128, block
    # 16, lengths up to 256; bf16 out against a plain run on the same
    # values (2e-2 relative: bf16 rounding of p and the output). Twelve
    # copies of the problem cycle so the 50 MB L2 starts cold, as it does
    # after a layer's MLP has streamed its weights through.
    main = None
    lengths = [256, 241, 200, 129]
    for arch, hkv, group, kvdt in (
            ("nemotron-4-15b", 8, 6, torch.bfloat16),
            ("nemotron-4-15b", 8, 6, torch.int8),
            ("deepseek-7b", 32, 1, torch.bfloat16),
            ("deepseek-7b", 32, 1, torch.int8),
            # qwen3-14b and llama4-scout (40 / 8 heads: group 5, the
            # 6-head tile with one head masked), llama3-405b (128 / 8:
            # group 16, two 8-head tiles) with its int8 pool
            ("qwen3-14b", 8, 5, torch.bfloat16),
            ("llama3-405b", 8, 16, torch.int8)):
        probs, t, ln, scale = _pool_problem(
            g, b=4, hkv=hkv, group=group, dh=128, bs=16, nb=16,
            lengths=lengths, qdtype=torch.bfloat16, kvdtype=kvdt, copies=12)
        q, k, v, ks, vs = probs[0]
        out = pa.paged_gqa(q, k, v, t, ln, scale=scale, k_scale=ks,
                           v_scale=vs)
        torch.cuda.synchronize()
        ref = pa.paged_gqa_reference(q, k, v, t, ln, scale=scale,
                                     k_scale=ks, v_scale=vs)
        err, rel = rel_err(out, ref)
        check(rel <= 2e-2, f"paged_gqa bf16 group={group} {kvdt}: "
                           f"rel {rel}")
        same = torch.equal(out, pa.paged_gqa(q, k, v, t, ln, scale=scale,
                                             k_scale=ks, v_scale=vs))
        check(same, f"paged_gqa bf16 group={group} {kvdt}: a second run "
                    "gave other bits")
        it = {"i": 0}

        def run(fn):
            def call():
                qq, kk, vv, kks, vvs = probs[it["i"] % len(probs)]
                it["i"] += 1
                fn(qq, kk, vv, t, ln, scale=scale, k_scale=kks, v_scale=vvs)
            return call

        ms = cuda_ms(run(pa.paged_gqa), iters=48)
        plain_ms = cuda_ms(run(pa.paged_gqa_reference), iters=48)
        kv_item = 1 if kvdt == torch.int8 else 2
        live = sum(lengths)
        nbytes = (2 * live * hkv * 128 * kv_item        # K and V read once
                  + (2 * live * hkv * 4 if kvdt == torch.int8 else 0)
                  + 2 * 2 * q.numel() + 4 * t.numel() + 4 * 4)
        b_ms, b_by = bound(nbytes, 4 * live * hkv * group * 128,
                           torch.bfloat16)
        kv_name = str(kvdt).replace("torch.", "")
        row = {"phase": 1, "op": "paged_gqa", "arch": arch,
               "heads": [hkv * group, hkv], "group": group,
               "kv_dtype": kv_name, "lengths": lengths,
               "route": "split-kv", "chunk": pa.split_chunk(16),
               "splits": [len(pa.split_bounds(n, 16)) for n in lengths],
               "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
               "same_bits_second_run": same, "ms": ms,
               "previous_ms": PREVIOUS_MS["paged_gqa"].get((arch, kv_name)),
               "ms_over_bound": ms / b_ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if kvdt == torch.bfloat16 and group == 6:
            main = row
    return main


def full_weights(g) -> tuple[torch.Tensor, torch.Tensor]:
    """nemotron-4-15b's W1 (6144, 24576) and W2 (24576, 6144) in bf16."""
    d, f = D_MODEL, D_FF
    w1 = (torch.randn(d, f, generator=g, device="cuda") / d ** 0.5
          ).bfloat16()
    w2 = (torch.randn(f, d, generator=g, device="cuda") / f ** 0.5
          ).bfloat16()
    return w1, w2


def matmul_ops(seed: int = 2) -> dict:
    """sidebar_matmul: the FLEXIBLE_DMA producer and consumer products."""
    from repro_torch.kernels import sidebar_matmul as smm

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    worst = 0.0
    # fp32 smoke shapes, ragged M, K and N (K split across blocks under
    # the identity epilogue, whole under the others): 1e-4 relative, the
    # two sum K in different orders
    shapes = ((1, 64, 128), (3, 100, 130), (4, 4096, 64), (17, 513, 257),
              (64, 1000, 384))
    for m, k, n in shapes:
        for act in ("identity", "squared_relu", "gelu", "sigmoid"):
            a = torch.randn(m, k, generator=g, device=dev)
            b = torch.randn(k, n, generator=g, device=dev) / k ** 0.5
            out = smm.sidebar_matmul(a, b, act)
            torch.cuda.synchronize()
            ref = smm.sidebar_matmul_plain(a, b, act)
            _, rel = rel_err(out, ref)
            check(out.shape == ref.shape and rel <= 1e-4,
                  f"sidebar_matmul fp32 {m}x{k}x{n} {act}: rel {rel}")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "sidebar_matmul", "dtype": "float32",
          "route": "fma", "shapes": shapes, "max_rel_err": worst,
          "tol": 1e-4})
    # a ragged bf16 shape (K, N not multiples of 8): the fma route,
    # against the plain version in fp32 (2e-2: the output's rounding)
    a = torch.randn(4, 100, generator=g, device=dev).bfloat16()
    b = (torch.randn(100, 260, generator=g, device=dev) / 10).bfloat16()
    route = smm.operand_route(a, b)
    _, rel = rel_err(smm.sidebar_matmul(a, b, "squared_relu"),
                     smm.sidebar_matmul_plain(a.float(), b.float(),
                                              "squared_relu"))
    check(route == "fma" and rel <= 2e-2,
          f"sidebar_matmul bf16 ragged: route {route}, rel {rel}")
    emit({"phase": 1, "op": "sidebar_matmul", "dtype": "bfloat16",
          "shape": [4, 100, 260], "route": route, "max_rel_err": rel,
          "tol": 2e-2})
    # the DMA route's two products at full width, bf16, decode (4 rows)
    # and a staging round (64 rows) on the tensor cores; against the
    # plain version in fp32 on the same values (2e-2 relative: bf16
    # rounding of the output); a second run gives the same bits
    w1, w2 = full_weights(g)
    pair = None
    for m in (4, 64):
        x = torch.randn(m, D_MODEL, generator=g, device=dev).bfloat16()
        h = torch.relu(torch.randn(m, D_FF, generator=g, device=dev)
                       ).bfloat16()
        rows = []
        for role, a, b in (("producer", x, w1), ("consumer", h, w2)):
            out = smm.sidebar_matmul(a, b)
            torch.cuda.synchronize()
            ref = smm.sidebar_matmul_plain(a.float(), b.float())
            err, rel = rel_err(out, ref)
            check(rel <= 2e-2, f"sidebar_matmul bf16 {role} m={m}: "
                               f"rel {rel}")
            same = torch.equal(out, smm.sidebar_matmul(a, b))
            check(same, f"sidebar_matmul bf16 {role} m={m}: a second run "
                        "gave other bits")
            k, n = b.shape
            route = smm.operand_route(a, b)
            plan = smm.plan(m, k, n, True, route)
            check(route == "tc" and plan.panels == 1,
                  f"sidebar_matmul bf16 {role} m={m}: route {route}, "
                  f"{plan.panels} panels")
            b_ms, b_by = bound(2 * (a.numel() + b.numel() + m * n),
                               2 * m * k * n, torch.bfloat16)
            ms = cuda_ms(lambda: smm.sidebar_matmul(a, b))
            row = {"phase": 1, "op": "sidebar_matmul", "dtype": "bfloat16",
                   "role": role, "shape": [m, k, n], "route": route,
                   "plan": dataclasses.asdict(plan),
                   "weight_reads_from_hbm": plan.panels,
                   "smem_bytes": smm.smem_bytes(m, a.dtype, route),
                   "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
                   "same_bits_second_run": same, "ms": ms,
                   "previous_ms": PREVIOUS_MS["sidebar_matmul"][(m, role)],
                   "tb_per_s": 2 * (a.numel() + b.numel() + m * n) / ms
                   / 1e9, "ms_over_bound": ms / b_ms,
                   "plain_ms": cuda_ms(
                       lambda: smm.sidebar_matmul_plain(a, b)),
                   "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
        # one MLP's pair of products, summed
        both = {key: rows[0][key] + rows[1][key]
                for key in ("ms", "previous_ms", "plain_ms", "library_ms",
                            "bound_ms")}
        emit({"phase": 1, "op": "sidebar_matmul", "pair_of_rows": m,
              **both})
        if m == 4:
            pair = both
            pair["bound_by"] = rows[0]["bound_by"]
            pair["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    del w1, w2
    return pair


def activation_ops(seed: int = 3) -> dict:
    """activation: the FLEXIBLE_DMA host step, its own launch."""
    from repro_torch.core.function_table import DEFAULT_TABLE
    from repro_torch.kernels import activations as ak

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    worst = 0.0
    # fp32 smoke shapes, every table entry (softmax and rmsnorm rowwise),
    # ragged widths and a tensor of rank 3: 1e-4 relative
    shapes = ((1, 1), (3, 7), (4, 256), (5, 1001), (2, 3, 4099))
    for shape in shapes:
        for act in DEFAULT_TABLE.names():
            x = torch.randn(*shape, generator=g, device=dev) * 3
            out = ak.activation(x, act)
            torch.cuda.synchronize()
            ref = ak.activation_plain(x, act)
            _, rel = rel_err(out, ref)
            check(out.shape == ref.shape and rel <= 1e-4,
                  f"activation fp32 {shape} {act}: rel {rel}")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "activation", "dtype": "float32",
          "shapes": shapes, "max_rel_err": worst, "tol": 1e-4})
    main = None
    for m in (4, 64):
        x = torch.randn(m, D_FF, generator=g, device=dev).bfloat16()
        out = ak.activation_2d(x, "squared_relu")
        torch.cuda.synchronize()
        ref = ak.activation_plain(x, "squared_relu")
        err, rel = rel_err(out, ref)
        check(rel <= 2e-2, f"activation bf16 m={m}: rel {rel}")
        b_ms, b_by = bound(2 * 2 * x.numel(), 2 * x.numel(), torch.float32)
        row = {"phase": 1, "op": "activation", "dtype": "bfloat16",
               "shape": [m, D_FF], "max_abs_err": err, "max_rel_err": rel,
               "tol": 2e-2, "launch": "programmatic dependent",
               "previous_ms": PREVIOUS_MS["activation"][m],
               "ms": cuda_ms(lambda: ak.activation_2d(x, "squared_relu")),
               "plain_ms": cuda_ms(
                   lambda: ak.activation_plain(x, "squared_relu")),
               "library_ms": cuda_ms(lambda: torch.square(torch.relu(x))),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if m == 4:
            main = row
    return main


def dma_chain_ops(seed: int = 9) -> None:
    """flexible_dma_chain: FLEXIBLE_DMA's whole MLP at nemotron's widths
    (producer ``sidebar_matmul``, its split reduce, ``activation``,
    consumer, its split reduce: five programmatic dependent launches),
    timed as the route runs it, beside the sum of its parts timed
    separately, the sum of their bounds and the fused ``sidebar_mlp`` at
    the same rows; the same bits with a synchronize between its calls as
    without (no race between the dependent launches)."""
    from repro_torch.core.modes import ExecutionMode
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import ops
    from repro_torch.kernels import sidebar_matmul as smm
    from repro_torch.kernels import sidebar_mlp as sm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w1, w2 = full_weights(g)
    act = "squared_relu"
    for m in (4, 64):
        x = torch.randn(m, D_MODEL, generator=g, device="cuda").bfloat16()

        def chain():
            with ops.execution_plan(ExecutionMode.FLEXIBLE_DMA):
                return ops.sidebar_mlp(x, w1, w2, act)

        out = chain()
        h = smm.sidebar_matmul(x, w1)
        torch.cuda.synchronize()
        fh = ak.activation(h, act)
        torch.cuda.synchronize()
        synced = smm.sidebar_matmul(fh, w2)
        torch.cuda.synchronize()
        same = torch.equal(out, synced)
        check(same, f"flexible_dma_chain m={m}: other bits with a "
                    "synchronize between the launches")
        ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(), act)
        err, rel = rel_err(out, ref)
        del ref
        check(rel <= 2e-2, f"flexible_dma_chain m={m}: rel {rel}")
        parts = {"producer": cuda_ms(lambda: smm.sidebar_matmul(x, w1)),
                 "activation": cuda_ms(lambda: ak.activation(h, act)),
                 "consumer": cuda_ms(lambda: smm.sidebar_matmul(fh, w2))}
        bounds = {
            "producer": bound(2 * (x.numel() + w1.numel() + h.numel()),
                              2 * m * D_MODEL * D_FF, torch.bfloat16)[0],
            "activation": bound(2 * 2 * h.numel(), 2 * h.numel(),
                                torch.float32)[0],
            "consumer": bound(2 * (fh.numel() + w2.numel() + out.numel()),
                              2 * m * D_FF * D_MODEL, torch.bfloat16)[0]}
        emit({"phase": 1, "op": "flexible_dma_chain", "dtype": "bfloat16",
              "shape": [m, D_MODEL, D_FF], "launches": 5,
              "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
              "same_bits_with_synchronize": same,
              "cuda_ms": cuda_ms(chain), "parts_ms": parts,
              "sum_of_parts_ms": sum(parts.values()),
              "parts_bound_ms": bounds,
              "sum_of_bounds_ms": sum(bounds.values()),
              "fused_sidebar_mlp_ms": cuda_ms(
                  lambda: sm.sidebar_mlp(x, w1, w2, act))})
        del x, h, fh, out, synced
    del w1, w2
    torch.cuda.empty_cache()


def pipelined_ops(seed: int = 4) -> dict:
    """sidebar_mlp_pipelined at depths 1-4: each against the plain
    version, and bitwise equal across depths."""
    from repro_torch.kernels import sidebar_mlp as sm

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    depths = (1, 2, 3, 4)
    worst = 0.0
    # fp32 smoke shapes: ragged rows, ragged F (a partial sub-tile),
    # several F splits; 1e-4 relative
    for m, d, f in ((1, 64, 256), (3, 64, 200), (4, 96, 1000),
                    (64, 64, 320), (130, 64, 2048)):
        for act in ("squared_relu", "relu", "gelu", "exp_decay"):
            x = torch.randn(m, d, generator=g, device=dev)
            w1 = torch.randn(d, f, generator=g, device=dev) / d ** 0.5
            w2 = torch.randn(f, d, generator=g, device=dev) / f ** 0.5
            ref = sm.sidebar_mlp_plain(x, w1, w2, act)
            outs = [sm.sidebar_mlp_pipelined(x, w1, w2, act, depth=t)
                    for t in depths]
            torch.cuda.synchronize()
            _, rel = rel_err(outs[0], ref)
            check(rel <= 1e-4, f"pipelined fp32 m={m} f={f} {act}: "
                               f"rel {rel}")
            check(all(torch.equal(outs[0], o) for o in outs[1:]),
                  f"pipelined fp32 m={m} f={f} {act}: depths differ")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "sidebar_mlp_pipelined", "dtype": "float32",
          "depths": depths, "max_rel_err": worst, "tol": 1e-4,
          "bitwise_equal_across_depths": True})
    # bf16 smoke shapes on the tensor-core cluster ring: 8- and 16-row
    # panels (ragged and full) on clusters of 4, 32-row panels on
    # clusters of 8, ragged F (a partial sub-tile) and D2 (tiles that
    # leave consumers idle), and a D2 walked in three passes; against the
    # plain version in fp32 on the same bf16 values, 2e-2 (bf16 rounding
    # of f(h) and of the output)
    worst = 0.0
    smoke = ((1, 96, 200, 64), (12, 96, 1000, 96), (16, 96, 1000, 64),
             (17, 96, 1000, 96), (130, 64, 2048, 64), (4, 64, 520, 12352))
    for m, d, f, d2 in smoke:
        x = torch.randn(m, d, generator=g, device=dev).bfloat16()
        w1 = (torch.randn(d, f, generator=g, device=dev) / d ** 0.5
              ).bfloat16()
        w2 = (torch.randn(f, d2, generator=g, device=dev) / f ** 0.5
              ).bfloat16()
        ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                                   "squared_relu")
        outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu",
                                         depth=t) for t in depths]
        torch.cuda.synchronize()
        _, rel = rel_err(outs[0], ref)
        check(rel <= 2e-2, f"pipelined bf16 m={m} f={f} d2={d2}: rel {rel}")
        check(all(torch.equal(outs[0], o) for o in outs[1:]),
              f"pipelined bf16 m={m} f={f} d2={d2}: depths differ")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "sidebar_mlp_pipelined", "dtype": "bfloat16",
          "smoke_shapes": smoke, "depths": depths,
          "max_rel_err": worst, "tol": 2e-2,
          "bitwise_equal_across_depths": True})
    # bf16 widths TMA cannot stride (D, F or D2 not a multiple of 8):
    # computed on the FMA body, against the plain version at 2e-2, and
    # bitwise equal across depths
    worst = 0.0
    ragged = ((4, 100, 256, 64), (4, 96, 260, 64), (17, 96, 256, 68))
    for m, d, f, d2 in ragged:
        x = torch.randn(m, d, generator=g, device=dev).bfloat16()
        w1 = (torch.randn(d, f, generator=g, device=dev) / d ** 0.5
              ).bfloat16()
        w2 = (torch.randn(f, d2, generator=g, device=dev) / f ** 0.5
              ).bfloat16()
        check(sm.route(x, w1, w2) == "fma",
              f"pipelined bf16 ragged {d}x{f}x{d2}: not the fma route")
        ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                                   "squared_relu")
        outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu",
                                         depth=t) for t in depths]
        torch.cuda.synchronize()
        _, rel = rel_err(outs[0], ref)
        check(rel <= 2e-2, f"pipelined bf16 ragged {d}x{f}x{d2}: rel {rel}")
        check(all(torch.equal(outs[0], o) for o in outs[1:]),
              f"pipelined bf16 ragged {d}x{f}x{d2}: depths differ")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "sidebar_mlp_pipelined", "dtype": "bfloat16",
          "route": "fma", "ragged_shapes": ragged, "depths": depths,
          "max_rel_err": worst, "tol": 2e-2,
          "bitwise_equal_across_depths": True})
    w1, w2 = full_weights(g)
    main = None
    # the three builds at full width: decode (8-row panels), a staging
    # round of one request (16 rows: prefill chunk = block 16) and of four
    # (32-row panels on clusters of 8)
    for m in (4, 16, 64):
        x = torch.randn(m, D_MODEL, generator=g, device=dev).bfloat16()
        ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                                   "squared_relu")
        outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu",
                                         depth=t) for t in depths]
        torch.cuda.synchronize()
        err, rel = rel_err(outs[0], ref)
        check(rel <= 2e-2, f"pipelined bf16 m={m}: rel {rel}")
        check(all(torch.equal(outs[0], o) for o in outs[1:]),
              f"pipelined bf16 m={m}: depths differ")
        per_depth = {t: cuda_ms(lambda t=t: sm.sidebar_mlp_pipelined(
            x, w1, w2, "squared_relu", depth=t)) for t in depths}
        nbytes = 2 * (x.numel() + w1.numel() + w2.numel() + m * D_MODEL)
        b_ms, b_by = bound(nbytes, 2 * 2 * m * D_MODEL * D_FF,
                           torch.bfloat16)
        route = sm.route(x, w1, w2)
        check(route == "tc", f"pipelined bf16 m={m}: route {route}")
        smem = {t: sm.pipelined_smem_bytes(m, D_FF, t, route)
                for t in depths}
        ms = per_depth[2]
        row = {"phase": 1, "op": "sidebar_mlp_pipelined",
               "dtype": "bfloat16", "shape": [m, D_MODEL, D_FF],
               "route": route,
               "panel_rows": sm.tokens_per_panel(m),
               "cluster_size": sm.cluster_size(m),
               "f_range": sm.f_range_pipelined(m, D_FF),
               "clusters": -(-m // sm.tokens_per_panel(m))
               * -(-D_FF // sm.f_range_pipelined(m, D_FF)),
               "smem_bytes": smem,
               "bitwise_equal_across_depths": True,
               "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
               "ms_by_depth": per_depth, "ms": ms,
               "previous_ms": PREVIOUS_MS["sidebar_mlp_pipelined"].get(m),
               "tb_per_s": nbytes / ms / 1e9, "ms_over_bound": ms / b_ms,
               "plain_ms": cuda_ms(lambda: sm.sidebar_mlp_plain(
                   x, w1, w2, "squared_relu")),
               "library_ms": cuda_ms(
                   lambda: (torch.relu(x @ w1) ** 2).to(torch.bfloat16)
                   @ w2),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if m == 4:
            main = row
    del w1, w2
    return main


def gated_ops(seed: int = 5) -> dict:
    """sidebar_gated_mlp: every MLP launch of deepseek-7b and of
    deepseek-v3's dense layers."""
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_mlp as sm

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    worst = 0.0
    # fp32 smoke shapes: ragged rows, an F that 64 does not divide, a
    # ragged last F split, several activations; 1e-4 relative (the two
    # sum D and F in different orders)
    shapes = ((1, 64, 192), (3, 64, 200), (4, 96, 1000), (64, 64, 192),
              (130, 64, 2048))
    for m, d, f in shapes:
        for act in ("silu", "gelu", "relu", "squared_relu"):
            x = torch.randn(m, d, generator=g, device=dev)
            wg, wu = (torch.randn(d, f, generator=g, device=dev) / d ** 0.5
                      for _ in range(2))
            wd = torch.randn(f, d, generator=g, device=dev) / f ** 0.5
            out = sg.sidebar_gated_mlp(x, wg, wu, wd, act)
            torch.cuda.synchronize()
            ref = sg.sidebar_gated_mlp_plain(x, wg, wu, wd, act)
            _, rel = rel_err(out, ref)
            check(out.shape == ref.shape and rel <= 1e-4,
                  f"sidebar_gated_mlp fp32 {m}x{d}x{f} {act}: rel {rel}")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "sidebar_gated_mlp", "dtype": "float32",
          "shapes": shapes, "max_rel_err": worst, "tol": 1e-4})
    # bf16 widths TMA cannot stride: the stream kernel (fma route)
    x, wg, wu, wd = (torch.randn(*sh, generator=g, device=dev).bfloat16()
                     / 10 for sh in ((4, 100), (100, 260), (100, 260),
                                     (260, 68)))
    out = sg.sidebar_gated_mlp(x, wg, wu, wd, "silu")
    torch.cuda.synchronize()
    ref = sg.sidebar_gated_mlp_plain(x.float(), wg.float(), wu.float(),
                                     wd.float(), "silu")
    _, rel = rel_err(out, ref)
    route = sm.route(x, wg, wu, wd)
    check(route == "fma" and rel <= 2e-2,
          f"sidebar_gated_mlp bf16 ragged: route {route}, rel {rel}")
    emit({"phase": 1, "op": "sidebar_gated_mlp", "dtype": "bfloat16",
          "shape": [4, 100, 260, 68], "route": route, "max_rel_err": rel,
          "tol": 2e-2})
    # deepseek-7b widths and deepseek-v3-671b's dense layers (7168 x
    # 18432) in bf16: decode (4 rows), staging rounds of one request and
    # of four (16, 64 rows), on the tc route; against the plain version
    # run in fp32 on the same values: 2e-2 relative covers bf16 rounding
    # of h and the output; a second run gives the same bits
    silu = torch.nn.functional.silu
    main = None
    for arch, d, f, rows in (("deepseek-7b", DS_MODEL, DS_FF, (4, 16, 64)),
                             ("deepseek-v3-671b", V3_MODEL, V3_FF,
                              (4, 16, 64)),
                             ("qwen3-14b", QW_MODEL, QW_FF, (16, 64)),
                             ("llama3-405b", L3_MODEL, L3_FF, (16, 64))):
        wg, wu = ((torch.randn(d, f, generator=g, device=dev) / d ** 0.5
                   ).bfloat16() for _ in range(2))
        wd = (torch.randn(f, d, generator=g, device=dev) / f ** 0.5
              ).bfloat16()
        for m in rows:
            x = torch.randn(m, d, generator=g, device=dev).bfloat16()
            out = sg.sidebar_gated_mlp(x, wg, wu, wd, "silu")
            again = sg.sidebar_gated_mlp(x, wg, wu, wd, "silu")
            torch.cuda.synchronize()
            ref = sg.sidebar_gated_mlp_plain(x.float(), wg.float(),
                                             wu.float(), wd.float(), "silu")
            err, rel = rel_err(out, ref)
            route = sm.route(x, wg, wu, wd)
            check(rel <= 2e-2 and route == "tc",
                  f"sidebar_gated_mlp bf16 {arch} m={m}: route {route}, "
                  f"rel {rel}")
            check(torch.equal(out, again),
                  f"sidebar_gated_mlp bf16 {arch} m={m}: runs differ")
            passes = sg.gated_passes(m, d)
            if d == V3_MODEL and m <= 16:
                check(passes == 1, f"sidebar_gated_mlp {arch} m={m}: "
                                   f"{passes} D2 passes")
            nbytes = 2 * (x.numel() + wg.numel() + wu.numel() + wd.numel()
                          + m * d)
            b_ms, b_by = bound(nbytes, 3 * 2 * m * d * f, torch.bfloat16)
            clusters = -(-m // sm.tokens_per_panel(m)) * sg.gated_splits(m, f)
            ms = cuda_ms(lambda: sg.sidebar_gated_mlp(x, wg, wu, wd, "silu"))
            row = {"phase": 1, "op": "sidebar_gated_mlp", "arch": arch,
                   "dtype": "bfloat16", "shape": [m, d, f], "route": route,
                   "panel_rows": sm.tokens_per_panel(m),
                   "cluster_size": sg.gated_cluster_size(m),
                   "clusters": clusters,
                   "blocks": clusters * sg.gated_cluster_size(m),
                   "d2_passes": passes,
                   "shares_per_cluster": sorted({-(-n // 64) for _, n in
                                                 sg.gated_f_ranges(m, f)}),
                   "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
                   "equal_to_second_run": True, "ms": ms,
                   "previous_ms": PREVIOUS_MS["sidebar_gated_mlp"].get(
                       arch, {}).get(m),
                   "tb_per_s": nbytes / ms / 1e9, "ms_over_bound": ms / b_ms,
                   "plain_ms": cuda_ms(lambda: sg.sidebar_gated_mlp_plain(
                       x, wg, wu, wd, "silu")),
                   "library_ms": cuda_ms(
                       lambda: torch.matmul(silu(torch.matmul(x, wg))
                                            * torch.matmul(x, wu), wd)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            if m == 4 and main is None:
                main = row
        del wg, wu, wd, out, again, ref
        torch.cuda.empty_cache()
    return main


# MoE layers at decode (4 rows) and in a staging round of four rows of
# 16 tokens: (architecture, product, K, N, experts, top-k, tokens); every
# one takes the narrow tc shape (kernels/moe_experts.py ``tc_tiles``)
MOE_CASES = (("llama4-scout-17b-a16e", "gate", 5120, 8192, 16, 1, 4),
             ("llama4-scout-17b-a16e", "down", 8192, 5120, 16, 1, 4),
             ("llama4-scout-17b-a16e", "gate", 5120, 8192, 16, 1, 64),
             ("deepseek-v3-671b", "gate", 7168, 2048, 256, 8, 4),
             ("deepseek-v3-671b", "down", 2048, 7168, 256, 8, 4),
             ("deepseek-v3-671b", "gate", 7168, 2048, 256, 8, 64))
# a training micro-batch of 4096 tokens: the wide tc shape
MOE_WIDE_CASES = (("llama4-scout-17b-a16e", "gate", 5120, 8192, 16, 1, 4096),
                  ("deepseek-v3-671b", "gate", 7168, 2048, 256, 8, 4096))
# the narrow / wide threshold (``moe_experts.NARROW_GROUP_ROWS``): both
# shapes timed at these rows a group on average, at llama4-scout's gate
# widths (16 experts) and deepseek-v3's (256)
MOE_CROSSOVER_ROWS = (1, 2, 4, 8, 16, 32, 64)


def _moe_groups(g, e: int, top: int, t: int, k: int, dev: str = "cuda"):
    """t tokens' k distinct experts each, drawn at random, grouped as
    ``models/moe.py`` groups the pairs: the rows (t * top, k) bf16 and
    the (E + 1) int32 offsets, and the per-expert counts."""
    ids = torch.rand(t, e, generator=g, device=dev).argsort(-1)[:, :top]
    counts = torch.bincount(ids.reshape(-1), minlength=e)
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    a = torch.randn(t * top, k, generator=g, device=dev).bfloat16()
    return a, off, counts


def _per_group_products(a, w, off) -> torch.Tensor:
    """The reference at sizes where the plain version (every expert over
    every row) would take minutes: each group's rows times its expert in
    fp32 (``allow_tf32`` off: full fp32 products of the bf16 values)."""
    out = torch.zeros(a.shape[0], w.shape[2], device=a.device)
    o = off.tolist()
    for e in range(w.shape[0]):
        if o[e + 1] > o[e]:
            out[o[e]:o[e + 1]] = a[o[e]:o[e + 1]].float() @ w[e].float()
    return out


def _moe_row(me, arch, prod, a, w, off, counts, t, top, ref_name, ref,
             alone=None) -> dict:
    """Check one grouped product against ``ref`` (1e-4 relative by row,
    zeros past the groups, a second run's bits) and time it beside its
    bound and ``torch._grouped_mm``'s bf16-out time."""
    n, k = a.shape
    e, _, nout = w.shape
    p = me.plan(n, e, k, nout, me.route(a, w))
    out = me.grouped_mm(a, w, off)
    again = me.grouped_mm(a, w, off)
    torch.cuda.synchronize()
    grouped = int(off[-1])
    err, rel = row_rel_err(out[:grouped], ref[:grouped])
    check(rel <= 1e-4 and torch.equal(out, again) and p.route == "tc"
          and not out[grouped:].any() and alone is not False,
          f"moe_grouped_mm {arch} {prod} t={t} ({p.tiles.shape}): rel "
          f"{rel}, alone {alone}")
    chosen = int((counts > 0).sum())
    nbytes = 2 * a.numel() + 2 * chosen * k * nout + 4 * n * nout \
        + 4 * off.numel()
    b_ms, b_by = bound(nbytes, 2 * grouped * k * nout, torch.bfloat16)
    ms = cuda_ms(lambda: me.grouped_mm(a, w, off))
    prev = PREVIOUS_MS["moe_grouped_mm"].get((arch, prod, t))
    return {"phase": 1, "op": "moe_grouped_mm", "arch": arch,
            "product": prod, "dtype": "bfloat16", "route": "tc",
            "tc_shape": p.tiles.shape, "rows_per_tile": p.tiles.rows,
            "rows_per_slice": (me.NARROW_SLICE if p.tiles.shape == "narrow"
                               else p.tiles.rows),
            "cols_per_tile": p.tiles.cols, "splits": p.tiles.splits,
            "grid": list(p.grid), "tokens": t, "top_k": top, "rows": n,
            "k": k, "n": nout, "experts": e, "experts_chosen": chosen,
            "reference": ref_name, "max_abs_err": err, "max_rel_err": rel,
            "tol": 1e-4, "equal_to_second_run": True,
            "row_alone_equal": alone, "ms": ms, "previous_ms": prev,
            "ms_over_previous": None if prev is None else ms / prev,
            "ms_over_bound": ms / b_ms, "tb_per_s": nbytes / ms / 1e9,
            # no PyTorch call computes the fp32-out grouped product of
            # bf16 operands; the nearest, with a bf16 output:
            "library_ms": None,
            "library_bf16_out_ms": cuda_ms(lambda: torch._grouped_mm(
                a, w, offs=off[1:])),
            "bound_ms": b_ms, "bound_by": b_by}


def moe_ops(seed: int = 10) -> dict:
    """moe_grouped_mm: the expert products of a MoE layer, each token's
    k pairs grouped by expert as ``models/moe.py`` groups them (experts
    drawn at random, so a decode step of 4 x 8 pairs chooses up to 32 of
    256 experts): at decode and in a staging round on the narrow tc shape
    against the plain version, each row alone equal to its row in the
    batch; at 4096 tokens on the wide shape against per-group products,
    a row equal whatever other rows share its group; a second run's bits
    everywhere; both shapes timed across the narrow / wide threshold;
    fp32 and ragged bf16 on the fma route."""
    from repro_torch.kernels import moe_experts as me

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    # fp32 and ragged bf16 smoke shapes: the fma route
    worst = 0.0
    for dtype, (n, k, nout, e) in ((torch.float32, (12, 64, 128, 4)),
                                   (torch.float32, (40, 64, 64, 8)),
                                   (torch.bfloat16, (12, 60, 36, 4))):
        a = torch.randn(n, k, generator=g, device=dev).to(dtype)
        w = (torch.randn(e, k, nout, generator=g, device=dev) / k ** 0.5
             ).to(dtype)
        off = torch.tensor(np.linspace(0, n - 2, e + 1).round(),
                           dtype=torch.int32, device=dev)
        out = me.grouped_mm(a, w, off)
        torch.cuda.synchronize()
        _, rel = row_rel_err(out[:n - 2], me.grouped_mm_plain(a, w, off)
                             [:n - 2])
        check(me.route(a, w) == "fma" and rel <= 1e-4
              and not out[n - 2:].any(),
              f"moe_grouped_mm {dtype} {n}x{k}x{nout}: rel {rel}")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "moe_grouped_mm", "route": "fma",
          "max_rel_err": worst, "tol": 1e-4})
    main = None
    weights = {}

    def weight(arch, prod, e, k, nout):
        if (arch, prod) not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[(arch, prod)] = (torch.randn(
                e, k, nout, generator=g, device=dev) / k ** 0.5).bfloat16()
        return weights[(arch, prod)]

    for arch, prod, k, nout, e, top, t in MOE_CASES:
        w = weight(arch, prod, e, k, nout)
        a, off, counts = _moe_groups(g, e, top, t, k)
        out = me.grouped_mm(a, w, off)
        # row 0 (the first chosen expert's) alone, a group of one,
        # against its row in the batch
        e0 = int(torch.nonzero(counts)[0])
        one = torch.tensor([0] * (e0 + 1) + [1] * (e - e0),
                           dtype=torch.int32, device=dev)
        alone = torch.equal(me.grouped_mm(a[:1].contiguous(), w, one)[0],
                            out[0])
        row = _moe_row(me, arch, prod, a, w, off, counts, t, top, "plain",
                       me.grouped_mm_plain(a, w, off), alone=alone)
        row["plain_ms"] = cuda_ms(lambda: me.grouped_mm_plain(a, w, off),
                                  iters=3, warmup=1)
        # the other shape at the same call (the rule keeps these narrow)
        wide = me.plan(a.shape[0], e, k, nout, "tc", me.TcTiles(
            "wide", me.WIDE_ROWS, me.WIDE_COLS, 1))
        row["wide_ms"] = cuda_ms(lambda: me.launch(a, w, off, wide))
        check(row["tc_shape"] == "narrow",
              f"moe_grouped_mm {arch} {prod} t={t}: not narrow")
        emit(row)
        if main is None:
            main = row
    for arch, prod, k, nout, e, top, t in MOE_WIDE_CASES:
        w = weight(arch, prod, e, k, nout)
        a, off, counts = _moe_groups(g, e, top, t, k)
        out = me.grouped_mm(a, w, off)
        # row 0 against itself with every other row of its group (and of
        # the batch) drawn anew: the same n, the same groups
        other = torch.randn(a.shape, generator=g, device=dev).bfloat16()
        other[0] = a[0]
        same = torch.equal(me.grouped_mm(other, w, off)[0], out[0])
        row = _moe_row(me, arch, prod, a, w, off, counts, t, top,
                       "per-group fp32 products",
                       _per_group_products(a, w, off))
        # the plain version (every expert over all rows) would take
        # minutes here
        row.update(plain_ms=None, row_equal_whatever_its_group=same)
        check(row["tc_shape"] == "wide" and same,
              f"moe_grouped_mm {arch} {prod} t={t}: shape "
              f"{row['tc_shape']}, row equal {same}")
        emit(row)
        del a, other, out
    # the threshold: both shapes at rising rows a group
    for arch, prod, k, nout, e, top, _ in MOE_CASES[::3]:
        w = weight(arch, prod, e, k, nout)
        for per in MOE_CROSSOVER_ROWS:
            a, off, _ = _moe_groups(g, e, top, e * per // top, k)
            n = a.shape[0]
            p = me.plan(n, e, k, nout, "tc")
            times = {}
            for shape, tiles in (("narrow", me.TcTiles(
                    "narrow", me.NARROW_ROWS, me.NARROW_COLS,
                    me.narrow_splits(k))), ("wide", me.TcTiles(
                        "wide", me.WIDE_ROWS, me.WIDE_COLS, 1))):
                forced = me.plan(n, e, k, nout, "tc", tiles)
                times[shape] = cuda_ms(
                    lambda p_=forced: me.launch(a, w, off, p_),
                    iters=5, warmup=1)
            emit({"phase": 1, "op": "moe_grouped_mm_crossover",
                  "arch": arch, "product": prod, "rows": n, "experts": e,
                  "rows_per_group": n / e, "narrow_ms": times["narrow"],
                  "wide_ms": times["wide"], "rule": p.tiles.shape,
                  "faster": min(times, key=times.get)})
            del a
    weights.clear()
    torch.cuda.empty_cache()
    return main


def moe_pass_ops(seed: int = 11) -> None:
    """The routed expert pass of a MoE layer (``models/moe.py``) in its
    two forms at llama4-scout's and deepseek-v3's widths, bf16 weights
    from a seed: the plain form (JAX's: every expert on its top-``cap``
    tokens, one batched cuBLAS product a weight, the config default and
    the training route) against the kernel form (the kept pairs through
    ``moe_grouped_mm``), at a decode step (4 tokens), a staging round of
    four requests (64) and a training micro-batch (4096). The forms agree
    to 1e-2 of the output's largest magnitude (bf16 rounds g*u and each
    expert's output; the two products sum in different orders)."""
    from repro_torch import configs
    from repro_torch.models import moe

    g = torch.Generator(device="cuda").manual_seed(seed)
    act = torch.nn.functional.silu
    for arch in ("llama4-scout-17b-a16e", "deepseek-v3-671b"):
        cfg = configs.get_config(arch)
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
        ws = [(torch.randn(e, k, n, generator=g, device="cuda") / k ** 0.5
               ).bfloat16() for k, n in ((d, f), (d, f), (f, d))]
        router = (torch.randn(d, e, generator=g, device="cuda")
                  / d ** 0.5).bfloat16()
        for t in (4, 64, 4096):
            x = torch.randn(t, d, generator=g, device="cuda").bfloat16()
            w, ids = moe._route(x, router, cfg)
            forms = {}
            for name, kernel in (("plain", False), ("kernel", True)):
                c = dataclasses.replace(cfg, use_pallas=kernel)
                forms[name] = (c, moe._local_expert_pass(x, w, ids, *ws, c,
                                                         act))
            want, got = forms["plain"][1], forms["kernel"][1]
            err = float((got - want).abs().max() / want.abs().max())
            row = {"phase": 1, "op": "moe_expert_pass", "arch": arch,
                   "tokens": t, "top_k": cfg.experts_per_token,
                   "experts": e, "capacity": moe._capacity(t, cfg),
                   "experts_chosen": int(torch.unique(ids).numel()),
                   "rel_err_kernel_vs_plain": err, "tol": 1e-2}
            for name, (c, _) in forms.items():
                row[f"{name}_ms"] = cuda_ms(
                    lambda c=c: moe._local_expert_pass(x, w, ids, *ws, c,
                                                       act),
                    iters=5, warmup=1)
            emit(row)
            check(err <= 1e-2, f"moe expert pass {arch} t={t}: plain and "
                               f"kernel forms differ by {err}")
        del ws
        torch.cuda.empty_cache()


def _mla_problem(g, *, b, h, kvr, rope, bs, nb, lengths, dtype, copies=1):
    """MLA pools with duplicate table entries and scratch-padded tails."""
    dev = "cuda"
    p = b * nb + 1
    rng = np.random.RandomState(1)
    tables = rng.randint(1, p, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0                 # scratch tail
    if b > 1 and -(-lengths[1] // bs) > 2:
        tables[1, 2] = tables[1, 1]                  # shared block
    probs = []
    for _ in range(copies):
        probs.append((
            torch.randn(b, h, kvr, generator=g, device=dev) / kvr ** 0.5,
            torch.randn(b, h, rope, generator=g, device=dev).to(dtype),
            torch.randn(p, bs, kvr, generator=g, device=dev).to(dtype),
            torch.randn(p, bs, rope, generator=g, device=dev).to(dtype)))
    t = torch.as_tensor(tables, device=dev)
    ln = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    return probs, t, ln


def mla_ops(seed: int = 7) -> dict:
    """paged_mla: deepseek-v3's absorbed decode on the compressed pool."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    # smoke widths in fp32 (H 4, kvr 32, rope 8, block 8; the fma route):
    # 1e-4 relative, the kernel's split online softmax against the plain
    # two-pass one; a length-0 row gives 0
    smoke_route = pa.mla_route(32, 8, 8, torch.float32)
    check(smoke_route == "fma", f"paged_mla smoke route {smoke_route}")
    for b, nb, lengths in ((3, 4, [5, 16, 32]), (4, 4, [1, 9, 30, 2]),
                           (3, 6, [48, 17, 8]), (4, 12, [0, 96, 70, 5])):
        probs, t, ln = _mla_problem(g, b=b, h=4, kvr=32, rope=8, bs=8,
                                    nb=nb, lengths=lengths,
                                    dtype=torch.float32)
        ql, qr, ckv, kr = probs[0]
        scale = (16 + 8) ** -0.5
        out = pa.paged_mla(ql, qr, ckv, kr, t, ln, scale=scale)
        torch.cuda.synchronize()
        ref = pa.paged_mla_reference(ql, qr, ckv, kr, t, ln, scale=scale)
        # rows of length 0: 0 from the kernel (the plain version's
        # all-masked softmax is uniform); the others against the plain one
        live = [r for r, n in enumerate(lengths) if n > 0]
        check(all(not out[r].any() for r, n in enumerate(lengths)
                  if n == 0), f"paged_mla fp32 lengths={lengths}: a "
                              "length-0 row is not 0")
        _, rel = rel_err(out[live], ref[live])
        check(out.shape == ref.shape and rel <= 1e-4,
              f"paged_mla fp32 lengths={lengths}: rel {rel}")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "paged_mla", "dtype": "float32",
          "heads": 4, "kv_lora_rank": 32, "rope_head_dim": 8,
          "route": smoke_route, "max_rel_err": worst, "tol": 1e-4,
          "length_0_row_is_0": True})
    # deepseek-v3-671b widths: 128 heads, kvr 512, rope 64, block 16, a
    # bf16 pool and q_rope, fp32 q_lat; 4 rows at lengths up to 256.
    # 2e-2 relative against the plain version on the same values (bf16
    # inputs, fp32 math on both sides: the tolerance of the bf16 rows).
    # 32 copies (~100 MB) cycle so the 50 MB L2 starts cold, as after a
    # layer's experts have streamed through it.
    lengths = [256, 241, 200, 129]
    h, kvr, rope, bs = 128, 512, 64, 16
    scale = (128 + rope) ** -0.5
    probs, t, ln = _mla_problem(g, b=4, h=h, kvr=kvr, rope=rope, bs=bs,
                                nb=16, lengths=lengths,
                                dtype=torch.bfloat16, copies=32)
    ql, qr, ckv, kr = probs[0]
    route = pa.mla_route(kvr, rope, bs, ckv.dtype)
    check(route == "tc", f"paged_mla bf16 full width: route {route}")
    before = build.launches["paged_mla"]
    out = pa.paged_mla(ql, qr, ckv, kr, t, ln, scale=scale)
    torch.cuda.synchronize()
    counted = build.launches["paged_mla"] - before
    ref = pa.paged_mla_reference(ql, qr, ckv, kr, t, ln, scale=scale)
    err, rel = rel_err(out, ref)
    check(rel <= 2e-2, f"paged_mla bf16: rel {rel}")
    same = torch.equal(out, pa.paged_mla(ql, qr, ckv, kr, t, ln,
                                         scale=scale))
    check(same, "paged_mla bf16: a second run gave other bits")
    # each row alone, on a table cut to its own blocks, against its row
    # in the batch: bit for bit
    alone_same = True
    for r, n in enumerate(lengths):
        nbr = -(-n // bs)
        alone = pa.paged_mla(ql[r:r + 1].contiguous(),
                             qr[r:r + 1].contiguous(), ckv, kr,
                             t[r:r + 1, :nbr].contiguous(),
                             ln[r:r + 1].contiguous(), scale=scale)
        alone_same = alone_same and torch.equal(alone[0], out[r])
    check(alone_same, "paged_mla bf16: a row alone gave other bits than "
                      "in the batch")
    emit({"phase": 1, "op": "paged_mla", "arch": "deepseek-v3-671b",
          "check": "row alone against the batch", "route": route,
          "lengths": lengths, "same_bits": alone_same})
    it = {"i": 0}

    def run(fn):
        def call():
            a, q2, c, k = probs[it["i"] % len(probs)]
            it["i"] += 1
            fn(a, q2, c, k, t, ln, scale=scale)
        return call

    live = sum(lengths)
    nbytes = (4 * ql.numel() + 2 * qr.numel()       # q_lat fp32, q_rope
              + 2 * live * (kvr + rope)              # live pool rows
              + 4 * t.numel() + 4 * ln.numel()       # tables, lengths
              + 4 * ql.numel())                      # ctx_lat fp32
    ops = 2 * live * h * (kvr + rope) + 2 * live * h * kvr
    # the tc route does each product twice (TF32 high and low parts);
    # the first design's fp32 FMA bound stands beside it
    b_ms, b_by = bound(nbytes, 2 * ops, "tf32")
    fma_ms, fma_by = bound(nbytes, ops, torch.float32)
    ms = cuda_ms(run(pa.paged_mla), iters=64)
    row = {"phase": 1, "op": "paged_mla", "arch": "deepseek-v3-671b",
           "heads": h, "kv_lora_rank": kvr, "rope_head_dim": rope,
           "block": bs, "pool_dtype": "bfloat16", "lengths": lengths,
           "route": route, "split_positions": pa.split_chunk(bs),
           "splits_per_row": [len(pa.split_bounds(n, bs)) for n in lengths],
           "head_group": pa.MLA_TC_HEADS,
           "split_blocks": sum(len(pa.split_bounds(n, bs)) for n in lengths)
           * -(-h // pa.MLA_TC_HEADS),
           "launches_counted_per_call": counted,
           "kernel_launches_per_call": 2,
           "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
           "same_bits_second_run": same, "row_alone_same_bits": alone_same,
           "ms": ms, "previous_ms": PREVIOUS_MS["paged_mla"],
           "plain_ms": cuda_ms(run(pa.paged_mla_reference), iters=64),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "ms_over_bound": ms / b_ms, "bound_ms_fp32_fma": fma_ms,
           "bound_by_fp32_fma": fma_by, "bytes": nbytes, "flops": ops}
    emit(row)
    return row


# tests/test_kernels.py FLASH_CASES (B, Hq, Hkv, S, T, Dh, causal), plus
# nemotron's smoke head_dim 8, a ragged S and T, head_dim 96 (a
# tensor-core head dim that is not a power of two), and for the 128-row
# q tiles of the wgmma route an S they do not divide, at GQA group 6 and
# with T > S
FLASH_SMOKE = ((2, 4, 4, 128, 128, 64, True), (1, 8, 2, 128, 128, 64, True),
               (2, 4, 2, 128, 256, 32, True), (1, 4, 4, 128, 128, 128, False),
               (1, 2, 1, 256, 256, 64, True), (2, 8, 2, 128, 128, 8, True),
               (1, 4, 2, 100, 130, 16, True), (1, 4, 2, 128, 192, 96, True),
               (1, 6, 1, 200, 200, 128, True), (1, 12, 2, 130, 300, 64, True))


def flash_ops(seed: int = 8) -> dict:
    """flash_attention: the cache-free training forward's attention."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    worst = 0.0
    # every check is per output row (row_rel_err). fp32: 1e-5 — both
    # sides fp32 on the same values, the kernel's online softmax against
    # the plain two-pass one
    for b, hq, hkv, s, t, dh, causal in FLASH_SMOKE:
        q = torch.randn(b, hq, s, dh, generator=g, device=dev) * 0.3
        k = torch.randn(b, hkv, t, dh, generator=g, device=dev) * 0.3
        v = torch.randn(b, hkv, t, dh, generator=g, device=dev) * 0.3
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        _, rel = row_rel_err(out, ref)
        check(out.shape == ref.shape and rel <= 1e-5,
              f"flash_attention fp32 {(b, hq, hkv, s, t, dh, causal)}: "
              f"row rel {rel}")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "flash_attention", "dtype": "float32",
          "cases": FLASH_SMOKE, "max_row_rel_err": worst, "tol": 1e-5})
    # the same cases in bf16: the tensor-core route at head_dim 16-128,
    # the FMA route at head_dim 8; against the plain version on the same
    # bf16 values (p rounded to bf16 on both sides; the kernel rounds
    # the unnormalised p, the plain version the normalised one). 2e-2
    # of the row's largest |ref|: one bf16 ulp of the output is at most
    # 2^-7 = 7.8e-3 of it, and the p roundings add about 2e-3 more
    worst = 0.0
    for b, hq, hkv, s, t, dh, causal in FLASH_SMOKE:
        q, k, v = (torch.randn(b, h, n, dh, generator=g, device=dev
                               ).bfloat16()
                   for h, n in ((hq, s), (hkv, t), (hkv, t)))
        out = fa.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, causal=causal)
        _, rel = row_rel_err(out, ref)
        check(out.dtype == torch.bfloat16 and rel <= 2e-2,
              f"flash_attention bf16 {(b, hq, hkv, s, t, dh, causal)}: "
              f"row rel {rel}")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "flash_attention", "dtype": "bfloat16",
          "cases": FLASH_SMOKE, "max_row_rel_err": worst, "tol": 2e-2})
    # full training shapes in bf16, S = T = 4096, batch 1, causal: the
    # plain version on the same bf16 values, 2e-2 of each row's largest
    # |ref| as above. A row at position i averages about i keys, so its
    # values shrink like i^-1/2 (about 0.03 at row 4000 against 3.3 at
    # row 0): a limit on the whole output's scale would not see a
    # dropped key tile or a mis-masked diagonal in the late rows
    main = None
    for arch, hq, hkv in (("nemotron-4-15b", 48, 8),
                          ("deepseek-7b", 32, 32)):
        s = t = 4096
        dh = 128
        q, k, v = (torch.randn(1, h, s, dh, generator=g, device=dev
                               ).bfloat16()
                   for h in (hq, hkv, hkv))
        out = fa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v)
        err, rel = row_rel_err(out, ref)
        check(rel <= 2e-2, f"flash_attention bf16 {arch}: row rel {rel}")
        del ref
        torch.cuda.empty_cache()
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * hq * s * t * dh / 2
        b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), iters=10)
        row = {"phase": 1, "op": "flash_attention", "arch": arch,
               "dtype": "bfloat16", "shape": [1, hq, hkv, s, t, dh],
               "route": "wgmma, TMA ring", "causal": True,
               "max_abs_err": err, "max_row_rel_err": rel, "tol": 2e-2,
               "ms": ms, "previous_ms": PREVIOUS_MS["flash_attention"][arch],
               "tflop_per_s": flops / ms / 1e9, "ms_over_bound": ms / b_ms,
               "plain_ms": cuda_ms(
                   lambda: fa.flash_attention_plain(q, k, v), iters=3,
                   warmup=1),
               "library_ms": cuda_ms(
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, is_causal=True, enable_gqa=True),
                   iters=10),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if main is None:
            main = row
        del q, k, v, out
        torch.cuda.empty_cache()
    return main


def autograd_refusals() -> None:
    """Every CUDA kernel wrapper raises when gradient mode is on and an
    operand requires grad (no kernel has a backward), and launches
    nothing; under ``torch.no_grad()`` the same call runs."""
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_experts as me
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_matmul as smm
    from repro_torch.kernels import sidebar_mlp as sm

    dev = "cuda"
    x = torch.randn(4, 64, device=dev, requires_grad=True)
    experts = torch.randn(2, 64, 32, device=dev)
    groups = torch.tensor([0, 1, 4], dtype=torch.int32, device=dev)
    w1, wu = torch.randn(64, 128, device=dev), torch.randn(64, 128, device=dev)
    w2 = torch.randn(128, 64, device=dev)
    probs, t, ln, scale = _pool_problem(
        torch.Generator(device=dev).manual_seed(9), b=3, hkv=2, group=4,
        dh=16, bs=8, nb=4, lengths=[5, 16, 32], qdtype=torch.float32,
        kvdtype=torch.float32)
    q, k, v, _, _ = probs[0]
    mla, mt, mln = _mla_problem(
        torch.Generator(device=dev).manual_seed(9), b=3, h=4, kvr=32,
        rope=8, bs=8, nb=4, lengths=[5, 16, 32], dtype=torch.float32)
    ql, qr, ckv, kr = mla[0]
    fq = torch.randn(1, 4, 128, 16, device=dev)
    fk = torch.randn(1, 2, 128, 16, device=dev)
    calls = {
        "sidebar_mlp": lambda a: sm.sidebar_mlp(a, w1, w2, "relu"),
        "sidebar_mlp_pipelined": lambda a: sm.sidebar_mlp_pipelined(
            a, w1, w2, "relu"),
        "sidebar_gated_mlp": lambda a: sg.sidebar_gated_mlp(a, w1, wu, w2),
        "sidebar_matmul": lambda a: smm.sidebar_matmul(a, w1),
        "activation": lambda a: ak.activation_2d(a, "relu"),
        "paged_gqa": lambda a: pa.paged_gqa(
            q.requires_grad_(a.requires_grad), k, v, t, ln, scale=scale),
        "paged_mla": lambda a: pa.paged_mla(
            ql.requires_grad_(a.requires_grad), qr, ckv, kr, mt, mln,
            scale=0.2),
        "flash_attention": lambda a: fa.flash_attention(
            fq.requires_grad_(a.requires_grad), fk, fk),
        "moe_grouped_mm": lambda a: me.grouped_mm(a, experts, groups),
    }
    check(set(calls) == set(KERNELS), "autograd refusals: a wrapper is "
                                      "missing")
    for name, call in calls.items():
        before = build.launches[name]
        try:
            call(x)
        except RuntimeError as e:
            check("no backward" in str(e), f"{name}: refused with {e}")
        else:
            check(False, f"{name} launched under autograd with an operand "
                         "that requires grad")
        check(build.launches[name] == before,
              f"{name} launched before refusing")
        with torch.no_grad():
            call(x)
        check(build.launches[name] == before + 1,
              f"{name} did not launch under no_grad")
    torch.cuda.synchronize()
    emit({"phase": 1, "op": "autograd_refusal", "wrappers": sorted(calls),
          "refused_under_autograd": True, "runs_under_no_grad": True})


def user_activation_ops(seed: int = 6) -> None:
    """A function registered at run time reaches every kernel that takes
    an activation: mish with a ``device_expr`` on a fresh table, through
    the five wrappers, against their plain versions under the same table
    (fp32, 1e-4 relative; bf16 at a decode shape, 2e-2); an entry without
    a ``device_expr`` is refused on the card."""
    from repro_torch.core.function_table import make_default_table
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import build
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_matmul as smm
    from repro_torch.kernels import sidebar_mlp as sm

    table = make_default_table()
    table.register("mish", mish, device_expr=MISH_EXPR)
    table.register("mish_host_only", mish)
    table.register("mish_wrong", mish, device_expr=WRONG_MISH_EXPR)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"

    def problem(m, d, f, dtype):
        def w(rows, cols):
            return (torch.randn(rows, cols, generator=g, device=dev)
                    / rows ** 0.5).to(dtype)
        return (torch.randn(m, d, generator=g, device=dev).to(dtype),
                w(d, f), w(d, f), w(f, d))

    wrappers = {
        "sidebar_mlp": (
            lambda x, wg, wu, wd, a: sm.sidebar_mlp(x, wg, wd, a,
                                                    table=table),
            lambda x, wg, wu, wd, a: sm.sidebar_mlp_plain(x, wg, wd, a,
                                                          table)),
        "sidebar_mlp_pipelined": (
            lambda x, wg, wu, wd, a: sm.sidebar_mlp_pipelined(
                x, wg, wd, a, table=table, depth=2),
            lambda x, wg, wu, wd, a: sm.sidebar_mlp_plain(x, wg, wd, a,
                                                          table)),
        "sidebar_gated_mlp": (
            lambda x, wg, wu, wd, a: sg.sidebar_gated_mlp(
                x, wg, wu, wd, a, table=table),
            lambda x, wg, wu, wd, a: sg.sidebar_gated_mlp_plain(
                x, wg, wu, wd, a, table)),
        "sidebar_matmul": (
            lambda x, wg, wu, wd, a: smm.sidebar_matmul(x, wg, a,
                                                        table=table),
            lambda x, wg, wu, wd, a: smm.sidebar_matmul_plain(x, wg, a,
                                                              table)),
        "activation": (
            lambda x, wg, wu, wd, a: ak.activation_2d(x, a, table=table),
            lambda x, wg, wu, wd, a: ak.activation_plain(x, a, table)),
    }
    worst = {"float32": dict.fromkeys(wrappers, 0.0),
             "bfloat16": dict.fromkeys(wrappers, 0.0)}
    for m, d, f, dtype, tol in ((3, 64, 200, torch.float32, 1e-4),
                                (64, 96, 384, torch.float32, 1e-4),
                                (4, DS_MODEL, 2048, torch.bfloat16, 2e-2)):
        ops = problem(m, d, f, dtype)
        for name, (kernel, plain) in wrappers.items():
            before = build.launches[name]
            out = kernel(*ops, "mish")
            torch.cuda.synchronize()
            check(build.launches[name] == before + 1,
                  f"run-time activation: {name} did not launch")
            ref = plain(*(t.float() for t in ops), "mish")
            _, rel = rel_err(out, ref)
            check(rel <= tol, f"run-time activation: {name} {dtype} "
                              f"{m}x{d}x{f}: rel {rel}")
            per = worst[str(dtype).removeprefix("torch.")]
            per[name] = max(per[name], rel)
            try:
                kernel(*ops, "mish_host_only")
            except NotImplementedError:
                pass
            else:
                check(False, f"{name} ran an entry without a device_expr "
                             "on the card")
            before = build.launches[name]
            try:
                kernel(*ops, "mish_wrong")
            except ValueError as e:
                check("mish_wrong" in str(e) and "at x = " in str(e),
                      f"{name}: the wrong device_expr refused with {e}")
                refusal = str(e)
            else:
                check(False, f"{name} served a device_expr that does not "
                             "compute its torch callable")
            check(build.launches[name] == before,
                  f"{name} launched before refusing a wrong device_expr")
    check(all((n, MISH_EXPR) in build._loaded for n in wrappers),
          "run-time activation: a wrapper did not load its mish library")
    emit({"phase": 1, "op": "run_time_activation", "name": "mish",
          "device_expr": MISH_EXPR, "max_rel_err": worst,
          "tol": {"float32": 1e-4, "bfloat16": 2e-2},
          "libraries": sorted(build._lib_path(n, MISH_EXPR).name
                              for n in wrappers),
          "entry_without_device_expr": "refused by every wrapper",
          "wrong_device_expr": WRONG_MISH_EXPR,
          "wrong_device_expr_refusal": refusal})


# ---------------------------------------------------------------------------
# Phases 2-5: serving
# ---------------------------------------------------------------------------


def traffic(seed: int, n: int, vocab: int, *, shared: int, lo: int, hi: int):
    """n prompts of lo..hi tokens; every other one starts with the same
    ``shared``-token prefix."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, shared).astype(np.int32)
    out = []
    for i in range(n):
        if i % 2:
            tail = rng.randint(0, vocab, rng.randint(max(lo - shared, 1),
                                                     hi - shared + 1))
            out.append(np.concatenate([prefix, tail]).astype(np.int32))
        else:
            out.append(rng.randint(0, vocab, rng.randint(lo, hi + 1)
                                   ).astype(np.int32))
    return out


def layer_plan(plan, layer: int):
    """The ``LayerPlan`` that ``plan`` (any spelling) gives ``layer``."""
    from repro_torch.core.modes import ExecutionPlan, coerce_layer_plan

    return (plan.for_layer(layer) if isinstance(plan, ExecutionPlan)
            else coerce_layer_plan(plan))


def expected_launches(plan, cfg, decode: int, prefill: int) -> dict:
    """Launches each kernel must count in a drain of ``cfg`` under
    ``plan``: per dense layer and forward call, one MLP launch of the
    plan's route (two products and one activation on the FLEXIBLE_DMA
    route; the gated kernel under every plan for a gated MLP), per MoE
    layer and forward call three grouped expert products (gate, up,
    down; the shared experts are plain products), and per layer and
    decode call one paged decode launch (paged_mla for MLA, else
    paged_gqa) unless the layer is FLEXIBLE_DMA (gathered-view
    attention, no kernel)."""
    from repro_torch.core.modes import ExecutionMode as M
    from repro_torch.models.transformer import layer_kinds

    calls = decode + prefill
    want = dict.fromkeys(KERNELS, 0)
    attn = "paged_mla" if cfg.use_mla else "paged_gqa"
    for i, kind in enumerate(layer_kinds(cfg)):
        lp = layer_plan(plan, i)
        if lp.mode is not M.FLEXIBLE_DMA:
            want[attn] += decode
        if kind == "moe":
            want["moe_grouped_mm"] += 3 * calls
        elif cfg.gated_mlp:
            want["sidebar_gated_mlp"] += calls
        elif lp.mode is M.FLEXIBLE_DMA:
            want["sidebar_matmul"] += 2 * calls
            want["activation"] += calls
        elif lp.mode is M.SIDEBAR_PIPELINED:
            want["sidebar_mlp_pipelined"] += calls
        else:
            want["sidebar_mlp"] += calls
    return want


def _programs(srv) -> dict:
    """Whether ``srv`` runs captured graphs, and its programs' captures
    and replays."""
    progs = srv.programs()
    return {"captured": srv.captured,
            "captures": sum(p.captures for p in progs),
            "replays": sum(p.replays for p in progs),
            "capture_s": sum(p.capture_s for p in progs)}


@contextlib.contextmanager
def counted_calls(srv):
    """Count ``srv``'s forward calls in the block: decode calls by the
    segments' steps, prefill calls by the staging rounds (a replayed
    graph calls no Python step, so both are counted where the server
    dispatches them). Yields the counts; unwraps after, so the server is
    freed with its graphs when its phase lets go of it."""
    calls = {"decode": 0, "prefill": 0, "stage_s": 0.0}
    seg, stage = srv._run_segment, srv._stage_round

    def counted_segment(steps, *a, **k):
        calls["decode"] += steps
        return seg(steps, *a, **k)

    def counted_stage(*a, **k):
        calls["prefill"] += 1
        t0 = time.perf_counter()
        try:
            return stage(*a, **k)
        finally:
            calls["stage_s"] += time.perf_counter() - t0

    srv._run_segment, srv._stage_round = counted_segment, counted_stage
    try:
        yield calls
    finally:
        del srv._run_segment, srv._stage_round


def stage_programs(srv) -> dict:
    """Eager rounds, captures and replays of ``srv``'s staging-round
    programs, and the host seconds their captures took."""
    progs = [p for k, p in srv._exec.items() if k[0] == "stage"]
    return {"stage_keys": len(progs),
            "stage_capture_after": srv.stage_capture_after,
            "stage_eager_rounds": sum(p.eager_calls for p in progs),
            "stage_captures": sum(p.captures for p in progs),
            "stage_replays": sum(p.replays for p in progs),
            "stage_capture_s": sum(p.capture_s for p in progs)}


def serve(cfg, params, prompts, gen: int, *, phase: int, mode: str,
          plan=None, records: list | None = None, **kw
          ) -> tuple[dict, list]:
    """Drive the paged server once under ``plan`` with fresh launch
    counts; returns its JSON row and the generated tokens by rid (and
    appends the drain's dispatch records to ``records``, if given)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    srv = PagedContinuousBatchingServer(cfg, params, plan=plan, **kw)
    recs: list = []
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with counted_calls(srv) as calls, kops.record_dispatches(recs):
        for p in prompts:
            srv.submit(p, gen)
        done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    if records is not None:
        records.extend(recs)
    ops = {r.op for r in recs}
    n_tok = sum(r.generated for r in done)
    toks = np.concatenate([r.tokens for r in done])
    st = srv.stats
    L = cfg.num_layers
    want = expected_launches(srv.plan, cfg, calls["decode"],
                             calls["prefill"])
    graphs = _programs(srv)
    row = {
        "phase": phase, "mode": mode, "arch": cfg.arch_id, "layers": L,
        "kv_cache_dtype": str(cfg.kv_cache_dtype).replace("torch.", ""),
        "requests": len(prompts), "finished": len(done),
        "generated": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_s_median": float(np.median([r.ttft for r in done])),
        "ttft_s_max": float(np.max([r.ttft for r in done])),
        "prefix_block_hits": st.prefix_block_hits,
        "prefix_prompt_blocks": st.prefix_prompt_blocks,
        "decode_calls": calls["decode"], "prefill_calls": calls["prefill"],
        "stage_round_host_s": calls["stage_s"],
        "preemptions": st.preemptions, "restores": st.restores,
        "executable_keys": len(srv.executable_cache_keys()),
        "launches": counts, "expected_launches": want,
        "gather_blocks": sum(r.op == "gather_blocks" for r in recs),
        "scatter_blocks": sum(r.op == "scatter_blocks" for r in recs),
        # the DMA route's products, by the route each launched
        "sidebar_matmul_routes": dict(collections.Counter(
            rt for r in recs for rt in r.routes)),
        **graphs, **stage_programs(srv),
    }
    emit(row)
    check(len(done) == len(prompts) and all(r.generated == gen
                                            for r in done),
          f"phase {phase} {mode}: not every request finished")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"phase {phase} {mode}: token out of vocab")
    check(st.prefix_block_hits > 0, f"phase {phase} {mode}: no prefix hits")
    # an ample pool (the default) never preempts
    check(st.preemptions == 0 and st.restores == 0,
          f"phase {phase} {mode}: preempted on an ample pool")
    check(counts == want, f"phase {phase} {mode}: launches {counts} != "
                          f"expected {want}")
    # every model runs its segments as graphs (captured once a key,
    # replayed when the key recurs); a staging key runs eagerly until its
    # round ``stage_capture_after``, then as a graph
    check(graphs["captured"] and graphs["captures"] > 0,
          f"phase {phase} {mode}: capture {graphs}")
    check(row["stage_eager_rounds"] + row["stage_replays"]
          == calls["prefill"],
          f"phase {phase} {mode}: staging rounds {stage_programs(srv)} "
          f"!= {calls['prefill']} prefill calls")
    check("gather_blocks" not in ops and "scatter_blocks" not in ops,
          f"phase {phase} {mode}: the paged route gathered or scattered "
          "blocks")
    attn = [r for r in recs if r.op == "paged_attention"]
    dma_layers = {i for i in range(L) if layer_plan(srv.plan, i).mode
                  is kops.ExecutionMode.FLEXIBLE_DMA}
    check(bool(attn) and all((r.variant == "dma") == (r.layer in dma_layers)
                             for r in attn),
          f"phase {phase} {mode}: decode attention off its planned route")
    return row, [r.tokens for r in done]


def full_width_params(layers: int | None, *, int8: bool = False,
                      arch: str = "nemotron-4-15b"):
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config(arch), use_pallas=True)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=torch.int8)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


FULL_SERVER = dict(device="cuda", num_slots=4, block_size=16, max_len=1024,
                   segment=8, kernel="paged")


# the servers that hold captured against eager on one warm server
# (phases 7, 9c, 12): every staging key captured at its first round, so
# the captured drains replay staging rounds too
WARM_SERVER = {**FULL_SERVER, "stage_capture_after": 1}


def full_width(phase: int, cfg, params, init_s: float,
               seed: int | None = None) -> tuple[dict, list]:
    """The full-width traffic mix (8 requests of 32-256 tokens, every
    other one sharing a 128-token prefix, 32 greedy tokens each), drawn
    from ``seed`` (default: the phase's), through the paged server."""
    from repro_torch import configs

    prompts = traffic(phase if seed is None else seed, 8, cfg.vocab_size,
                      shared=128, lo=32, hi=256)
    row, tokens = serve(cfg, params, prompts, 32, phase=phase,
                        mode="sidebar", **FULL_SERVER)
    full = configs.get_config(cfg.arch_id).num_layers
    info = {"phase": phase, "arch": cfg.arch_id, "init_s": init_s,
            "depth_cut": cfg.num_layers != full,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    if cfg.num_layers != full:
        info["reduced"] = {"num_layers": f"{full} -> {cfg.num_layers}"}
    emit(info)
    return row, tokens


def eager_then_captured(phase: int, cfg, params, seed: int) -> dict:
    """A fresh paged server (``FULL_SERVER``) on the full-width traffic
    of ``seed``: a warm-up drain (captured: its graphs captured, its
    prompts published), then an eager drain (``disable_capture()``) and
    a captured one, greedy: the same tokens bit for bit, and each drain
    with exact launch counts for the forward calls it made."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import graphs
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    prompts = traffic(seed, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    greedy = [None] * len(prompts)
    srv = PagedContinuousBatchingServer(cfg, params, **WARM_SERVER)
    _drain(srv, prompts, greedy)
    out = {}
    for mode in ("eager", "captured"):
        ctx = (graphs.disable_capture() if mode == "eager"
               else contextlib.nullcontext())
        kops.reset_launch_counts()
        with ctx, counted_calls(srv) as calls:
            wall, toks, ttft = _drain(srv, prompts, greedy)
        counts = kops.launch_counts()
        want = expected_launches(srv.plan, cfg, calls["decode"],
                                 calls["prefill"])
        check(counts == want, f"phase {phase} {mode}: launches {counts} "
                              f"!= expected {want}")
        out[mode] = {"tokens": toks, "tokens_per_s": 32 * len(prompts)
                     / wall, "ttft_s_median": float(np.median(ttft)),
                     "launches": counts, **calls}
    same = all(np.array_equal(a, b) for a, b in zip(
        out["eager"].pop("tokens"), out["captured"].pop("tokens")))
    row = {"phase": phase, "part": "eager_then_captured",
           "arch": cfg.arch_id, "layers": cfg.num_layers,
           "order": "warm-up, E C", "captured_equals_eager": same,
           "eager_drain": out["eager"], "captured_drain": out["captured"],
           **_programs(srv), **stage_programs(srv)}
    emit(row)
    check(same, f"phase {phase}: captured tokens != eager tokens")
    check(row["captured"] and row["replays"] > 0
          and row["stage_replays"] > 0,
          f"phase {phase}: capture {_programs(srv)} {stage_programs(srv)}")
    return row


def plan_modes(cfg, params, sidebar_tokens: list,
               tokens_out: dict | None = None) -> dict:
    """Phase 5: phase 2's weights and traffic under the paper's execution
    modes. The drains run in the order S P L D D L P S, so every mode has
    one early and one late run (host-side time drifts between drains);
    each run's exact launch counts are checked. Greedy tokens equal to
    phase 2's SIDEBAR run are counted; the ring plans (d2 and the
    per-layer d2/d4) must give all of them: the serial kernel is the
    ring with one slot on the ring's partition, so its output equals the
    ring's at every depth, the reference's pipelined == serial gate.
    FLEXIBLE_DMA rounds h and f(h) to x's type: reported, not gated; its
    products must all take ``sidebar_matmul``'s tensor-core route."""
    from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan

    d2 = LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2)
    d4 = LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 4)
    plans = {
        "sidebar": None,
        "sidebar_pipelined_d2": d2,
        "per_layer_d2_d4": ExecutionPlan(
            default=d2,
            layers={i: (d4 if i % 2 else d2)
                    for i in range(cfg.num_layers)}),
        "flexible_dma": ExecutionMode.FLEXIBLE_DMA,
    }
    prompts = traffic(2, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    n = sum(t.size for t in sidebar_tokens)
    runs = {mode: [] for mode in plans}
    for mode in [*plans, *reversed(plans)]:
        row, tokens = serve(cfg, params, prompts, 32, phase=5,
                            mode=mode, plan=plans[mode], **FULL_SERVER)
        routes = row["sidebar_matmul_routes"]
        check(sum(routes.values()) == row["launches"]["sidebar_matmul"]
              and "fma" not in routes,
              f"phase 5 {mode}: sidebar_matmul routes {routes}")
        same = sum(int((a == b).sum())
                   for a, b in zip(tokens, sidebar_tokens))
        runs[mode].append((row, same))
        if tokens_out is not None:
            tokens_out.setdefault(mode, tokens)
    for mode, rr in runs.items():
        tps = [r["tokens_per_s"] for r, _ in rr]
        emit({"phase": 5, "mode": mode, "tokens_per_s": tps,
              "tokens_per_s_mean": sum(tps) / len(tps),
              "ttft_s_median": [r["ttft_s_median"] for r, _ in rr],
              "launches": rr[0][0]["launches"],
              "sidebar_matmul_routes": rr[0][0]["sidebar_matmul_routes"],
              "greedy_tokens_equal_to_sidebar": [same for _, same in rr],
              "of": n})
    emit({"phase": 5, "summary": "tokens_per_s by execution mode",
          "layers": cfg.num_layers, "order": "S P L D D L P S",
          "tokens_per_s_mean": {
              m: sum(r["tokens_per_s"] for r, _ in rr) / len(rr)
              for m, rr in runs.items()},
          "tokens_per_s_runs": {
              m: [r["tokens_per_s"] for r, _ in rr]
              for m, rr in runs.items()}})
    for mode in ("sidebar_pipelined_d2", "per_layer_d2_d4"):
        check(all(same == n for _, same in runs[mode]),
              f"phase 5: {mode} greedy tokens equal to SIDEBAR's "
              f"{[same for _, same in runs[mode]]} of {n}")
    # the first run of each mode other than SIDEBAR (phase 2 is its row)
    return {mode: rr[0][0] for mode, rr in runs.items() if mode != "sidebar"}


def _capture(cfg, params, prompts, gen: int, drains: int = 1, **kw
             ) -> list[tuple[list, list, int]]:
    """Serve ``prompts`` eagerly ``drains`` times on one server (the
    later drains warm: the prompts published by the first), recording
    every decode step's logits; returns (logits per step, tokens per
    request, prefix blocks spliced) of each drain."""
    from repro_torch.launch import graphs
    from repro_torch.launch import scheduler
    from repro_torch.models import layers as L

    seen = []

    def make_step(cfg, api):
        def step(p, tok, cache, pos, sample=None, block_tables=None):
            logits, cache = api.decode_step(p, cfg, tok, cache, pos,
                                            block_tables=block_tables)
            logits = L.mask_pad_logits(logits, cfg.vocab_size)[:, -1]
            seen.append(logits.clone())
            return torch.argmax(logits, -1).to(torch.int32)[:, None], cache
        return step

    orig = scheduler.make_serve_step
    scheduler.make_serve_step = make_step
    try:
        srv = scheduler.PagedContinuousBatchingServer(
            cfg, params, device="cuda", **{
                "num_slots": 3, "max_len": 64, "block_size": 8,
                "segment": 4, **kw})
        out = []
        with graphs.disable_capture():
            for _ in range(drains):
                seen = []
                hits = srv.stats.prefix_block_hits
                for p in prompts:
                    srv.submit(p, gen)
                toks = [r.tokens for r in srv.run()]
                out.append((seen, toks, srv.stats.prefix_block_hits - hits))
        return out
    finally:
        scheduler.make_serve_step = orig


def smoke_routes(arch: str) -> None:
    """Phase 4, an fp32 smoke config on the card: the paged route
    (kernel) against the slab route (gather + dense plain attention), and
    the pipelined, DMA and a mixed per-layer plan against SIDEBAR, on the
    same traffic, compared step by step by their logits while their
    tokens agree. fp32 end to end: the routes differ only in summation
    order, 1e-4. A gated MLP takes its one kernel under every plan; the
    plans then differ in their decode attention."""
    from repro_torch import configs
    from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              use_pallas=True)
    if cfg.num_experts:
        # no-drop capacity, as the JAX package's paged gates run MoE:
        # chunk boundaries must not change expert routing
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=float(cfg.num_experts))
    params = transformer.init(cfg, seed=0, device="cuda")
    prompts = traffic(4, 6, cfg.vocab_size, shared=16, lo=4, hi=30)
    ((la, ta, _),) = _capture(cfg, params, prompts, 12, kernel="paged")
    mixed = ExecutionPlan(
        default=LayerPlan(ExecutionMode.SIDEBAR, 1),
        layers={0: LayerPlan(ExecutionMode.FLEXIBLE_DMA, 1),
                1: LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 3)})
    for name, kw in (("slab", dict(kernel="slab")),
                     ("sidebar_pipelined_d2", dict(
                         plan=LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2))),
                     ("flexible_dma", dict(plan=ExecutionMode.FLEXIBLE_DMA)),
                     ("mixed_dma_pipelined_d3", dict(plan=mixed))):
        kops.reset_launch_counts()
        ((lb, tb, _),) = _capture(cfg, params, prompts, 12, **kw)
        counts = kops.launch_counts()
        same = all(np.array_equal(a, b) for a, b in zip(ta, tb))
        err = max((a - b).abs().max().item() for a, b in zip(la, lb)) \
            if same and len(la) == len(lb) else float("nan")
        emit({"phase": 4, "arch": cfg.arch_id, "against": "paged sidebar",
              "route": name, "tokens_equal": same, "steps": len(lb),
              "max_abs_logit_err": err, "tol": 1e-4, "launches": counts})
        check(same and len(la) == len(lb) and err <= 1e-4,
              f"phase 4: {cfg.arch_id} {name} disagrees with the paged "
              "SIDEBAR route")
        attn = "paged_mla" if cfg.use_mla else "paged_gqa"
        if cfg.gated_mlp:
            # the gated kernel on dense layers, the grouped expert
            # product on MoE layers (llama4-scout has no dense layer)
            mlp = counts["sidebar_gated_mlp"] + counts["moe_grouped_mm"]
            check(mlp > 0 and (counts["moe_grouped_mm"] > 0)
                  == bool(cfg.num_experts)
                  and (counts[attn] > 0) == (
                      name in ("sidebar_pipelined_d2",
                               "mixed_dma_pipelined_d3")),
                  f"phase 4: {cfg.arch_id} {name} launched {counts}")
        elif name != "slab":
            mlp = ["sidebar_mlp_pipelined", "sidebar_matmul", "activation"]
            check(any(counts[k] for k in mlp),
                  f"phase 4: {name} launched none of {mlp}")
    warm_vs_cold(cfg, params, prompts)


def warm_vs_cold(cfg, params, prompts) -> None:
    """Phase 4, ROADMAP Queue 3 item 4: a cold drain, then a warm drain
    on the same server (its prompts' prefix blocks spliced from the
    first), one slot a request so both drains decode in one schedule:
    equal greedy tokens, and every decode step's logits within 1e-4 (the
    warm drain prefills other row counts, and on the card a product
    rounds by its shape)."""
    (lc, tc, hc), (lw, tw, hw) = _capture(cfg, params, prompts, 12,
                                          drains=2, num_slots=len(prompts))
    same = all(np.array_equal(a, b) for a, b in zip(tc, tw))
    err = max((a - b).abs().max().item() for a, b in zip(lc, lw)) \
        if same and len(lc) == len(lw) else float("nan")
    emit({"phase": 4, "arch": cfg.arch_id, "against": "cold drain",
          "route": "warm drain", "tokens_equal": same, "steps": len(lw),
          "prefix_blocks_spliced": {"cold": hc, "warm": hw},
          "max_abs_logit_err": err, "tol": 1e-4})
    check(hw > hc and same and len(lc) == len(lw) and err <= 1e-4,
          f"phase 4: {cfg.arch_id} warm drain disagrees with the cold one")


# ---------------------------------------------------------------------------
# Phase 9: sampling, the static-batch Server, the slot-cache server, and
# captured segments against eager ones, on phase 2's weights
# ---------------------------------------------------------------------------

SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)


def _timed(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def loop_breakdown(run, steps: int, top: int = 10) -> dict:
    """Device time a step of ``run`` (an eager decode of ``steps``
    forward calls) by kernel name, from ``torch.profiler``: the ``top``
    names, the rest, and the total; "not measured" when the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        ms = getattr(evt, "device_time_total",
                     getattr(evt, "cuda_time_total", 0)) / 1e3
        if ms > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            times[evt.key] = times.get(evt.key, 0.0) + ms / steps
    if not times:
        return {"not measured": "the profiler saw no device time"}
    names = sorted(times, key=times.get, reverse=True)
    out = {name[:60]: times[name] for name in names[:top]}
    out["(the rest)"] = sum(times[n] for n in names[top:])
    out["(total)"] = sum(times.values())
    return out


def phase9_server(cfg, params) -> dict:
    """9a: ``Server`` on 4 prompts of 128 seeded tokens, 32 new tokens,
    max_len 1024. ``decode="scan"`` (a graph, replayed) == ``"loop"``
    bit for bit, greedy and sampled; temperature 0 and top-k 1 ==
    greedy; SIDEBAR_PIPELINED d2 == SIDEBAR; sampled != greedy; exact
    ``sidebar_mlp`` launches; ms a decode step, scan beside loop (each
    timed as generate(32) less generate(1), the prefill alone, in the
    order L S S L, medians)."""
    from repro_torch.core.modes import ExecutionMode, LayerPlan
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.launch.serve import Server

    sp = SamplingParams(**SP_KW)
    srv = Server(cfg, params, max_len=1024, device="cuda")
    prompts = np.random.RandomState(9).randint(0, cfg.vocab_size, (4, 128))

    def gen(n=32, **kw):
        return srv.generate(prompts, n, **kw).tokens.cpu().numpy()

    out = {}
    for name, sample in (("greedy", None), ("sampled", sp)):
        first = gen(sample=sample, decode="scan")       # warm-up + capture
        kops.reset_launch_counts()
        scan = gen(sample=sample, decode="scan")        # replay
        counts = kops.launch_counts()
        loop = gen(sample=sample, decode="loop")
        out[name] = scan
        want = dict.fromkeys(KERNELS, 0)
        want["sidebar_mlp"] = cfg.num_layers * 32       # prefill + 31 steps
        check(np.array_equal(first, scan) and np.array_equal(scan, loop),
              f"phase 9a {name}: scan {scan[:, 128:136].tolist()} != loop "
              f"{loop[:, 128:136].tolist()}")
        check(counts == want, f"phase 9a {name}: launches {counts} != "
                              f"{want}")
    t0 = gen(sample=SamplingParams(temperature=0.0, seed=3))
    k1 = gen(sample=SamplingParams(temperature=0.9, top_k=1, seed=5))
    check(np.array_equal(t0, out["greedy"]) and np.array_equal(
        k1, out["greedy"]), "phase 9a: temperature 0 / top-k 1 != greedy")
    check(not np.array_equal(out["sampled"], out["greedy"]),
          "phase 9a: sampled tokens equal greedy everywhere")
    d2 = Server(cfg, params, max_len=1024, device="cuda",
                plan=LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, 2))
    pipe = [d2.generate(prompts, 32).tokens.cpu().numpy() for _ in range(2)]
    check(all(np.array_equal(p, out["greedy"]) for p in pipe),
          "phase 9a: SIDEBAR_PIPELINED d2 != SIDEBAR")
    del d2
    # ms a decode step: (generate(32) - generate(1)) / 31, L S S L x 2
    times = {"scan": [], "loop": []}
    for decode in ("loop", "scan", "scan", "loop") * 2:
        full, _ = _timed(lambda: srv.generate(prompts, 32, decode=decode))
        pre, _ = _timed(lambda: srv.generate(prompts, 1, decode=decode))
        times[decode].append((full - pre) / 31 * 1e3)
    prog = srv._decode_scans[(31, None)]
    row = {"phase": 9, "part": "9a", "arch": cfg.arch_id,
           "device_ms_per_step_by_kernel": loop_breakdown(
               lambda: srv.generate(prompts, 32, decode="loop"), 32),
           "layers": cfg.num_layers, "batch": 4, "prompt": 128, "gen": 32,
           "scan_equals_loop": True, "greedy_equals_t0_and_top_k_1": True,
           "pipelined_d2_equals_sidebar": True,
           "sampled_differs_from_greedy": int(
               (out["sampled"] != out["greedy"]).sum()),
           "sidebar_mlp_launches": cfg.num_layers * 32,
           "captured": srv.captured, "captures": prog.captures,
           "replays": prog.replays, "order": "L S S L L S S L",
           "step_ms_scan": times["scan"], "step_ms_loop": times["loop"],
           "step_ms_scan_median": float(np.median(times["scan"])),
           "step_ms_loop_median": float(np.median(times["loop"]))}
    emit(row)
    check(srv.captured and prog.captures >= 1 and prog.replays > 0,
          f"phase 9a: the scan was not replayed ({prog.captures} "
          f"captures, {prog.replays} replays)")
    return row


def _sampled_every_other(n: int) -> list:
    from repro_torch.launch.sampling import SamplingParams

    return [SamplingParams(**{**SP_KW, "seed": 100 + i}) if i % 2 else None
            for i in range(n)]


def _drain(srv, prompts, samples, gen: int = 32) -> tuple[float, list,
                                                          list]:
    """(wall s, tokens by rid, TTFTs) of one drain of ``srv``."""
    def run():
        for p, sp in zip(prompts, samples):
            srv.submit(p, gen, sample=sp)
        return srv.run()

    wall, done = _timed(run)
    return wall, [r.tokens for r in done], [r.ttft for r in done]


def phase9_slots(cfg, params) -> dict:
    """9b: the slot-cache server on phase 2's traffic (8 requests of
    32-256 tokens, 32 new each, every other one sampled with its own
    seed), 4 slots, segment 8: a captured drain (cold: the programs
    captured), an eager one (``disable_capture()``) and a captured one
    (warm: replays) on one server, bit for bit equal."""
    from repro_torch.launch import graphs
    from repro_torch.launch.scheduler import ContinuousBatchingServer

    torch.cuda.reset_peak_memory_stats()
    prompts = traffic(2, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    samples = _sampled_every_other(len(prompts))
    srv = ContinuousBatchingServer(cfg, params, device="cuda", num_slots=4,
                                   max_len=1024, segment=8)
    cold, tokens, ttft = _drain(srv, prompts, samples)
    with graphs.disable_capture():
        eager, e_tokens, e_ttft = _drain(srv, prompts, samples)
    warm, w_tokens, w_ttft = _drain(srv, prompts, samples)
    n = 32 * len(prompts)
    same = all(np.array_equal(a, b) and np.array_equal(a, c)
               for a, b, c in zip(tokens, e_tokens, w_tokens))
    row = {"phase": 9, "part": "9b", "server": "slot cache",
           "arch": cfg.arch_id, "layers": cfg.num_layers,
           "requests": len(prompts), "generated": n,
           "captured_equals_eager": same,
           "tokens_per_s": {"captured_cold": n / cold, "eager": n / eager,
                            "captured_warm": n / warm},
           "ttft_s_median": {"captured_cold": float(np.median(ttft)),
                             "eager": float(np.median(e_ttft)),
                             "captured_warm": float(np.median(w_ttft))},
           "ttft_s_max": {"captured_cold": float(np.max(ttft)),
                          "eager": float(np.max(e_ttft)),
                          "captured_warm": float(np.max(w_ttft))},
           "compiles": srv.stats.compiles, "hits": srv.stats.hits,
           **_programs(srv),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(row)
    check(same, "phase 9b: captured tokens != eager tokens")
    check(row["captures"] > 0 and row["replays"] > 0,
          f"phase 9b: capture {_programs(srv)}")
    return row


def phase9_paged(cfg, params) -> dict:
    """9c: the paged server (phase 2's set-up) on phase 2's traffic,
    greedy and half sampled: per traffic, one server's warm-up drain
    (captured: its programs captured, its prompts published to the
    prefix index), then eager and captured drains in the order E C C E,
    all bit for bit equal, staging rounds included (eager in E, replayed
    graphs in C). (Not to the warm-up: its staging prefilled whole
    prompts, the later drains splice the published prefix blocks and
    prefill the rest in other row counts, and on the card a product
    rounds by its shape; the row counts the tokens that differ from the
    warm-up's, ROADMAP Queue 3 item 4.)"""
    from repro_torch.launch import graphs
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    prompts = traffic(2, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    out = {}
    for name, samples in (("greedy", [None] * len(prompts)),
                          ("half_sampled", _sampled_every_other(
                              len(prompts)))):
        srv = PagedContinuousBatchingServer(cfg, params, **WARM_SERVER)
        _, cold, _ = _drain(srv, prompts, samples)
        runs = {"eager": [], "captured": []}
        want, same = None, True
        for mode in ("eager", "captured", "captured", "eager"):
            ctx = (graphs.disable_capture() if mode == "eager"
                   else contextlib.nullcontext())
            with ctx:
                wall, got, _ = _drain(srv, prompts, samples)
            runs[mode].append(32 * len(prompts) / wall)
            want = got if want is None else want
            same &= all(np.array_equal(a, b) for a, b in zip(got, want))
        out[name] = {
            "captured_equals_eager": same,
            # ROADMAP Queue 3 item 4: the warm drains' tokens against the
            # cold warm-up's (recorded, not gated)
            "tokens_unequal_to_cold_drain": int(sum(
                (a != b).sum() for a, b in zip(cold, want))),
            "tokens": 32 * len(prompts),
            "tokens_per_s_eager": runs["eager"],
            "tokens_per_s_captured": runs["captured"],
            "tokens_per_s_eager_mean": float(np.mean(runs["eager"])),
            "tokens_per_s_captured_mean": float(np.mean(runs["captured"])),
            **_programs(srv), **stage_programs(srv)}
        check(same, f"phase 9c {name}: captured tokens != eager tokens")
        check(out[name]["stage_replays"] > 0,
              f"phase 9c {name}: no staging round replayed "
              f"{stage_programs(srv)}")
        del srv
    row = {"phase": 9, "part": "9c", "server": "paged", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "order": "warm-up, E C C E", **out}
    emit(row)
    return row


# ---------------------------------------------------------------------------
# Phase 13: overload — lazy growth, preemption with spill / restore,
# EDF / FIFO priorities, seeded faults and the replica router
# ---------------------------------------------------------------------------

# one server of phase 13: 4 slots, 48 allocatable blocks of 16 positions;
# eight lows of 96-160 + 128 tokens need up to 18 blocks each grown, so
# four grown lows (72 blocks) cannot coexist: 2x oversubscribed
OVERLOAD_SERVER = dict(num_slots=4, block_size=16, max_len=512, segment=8,
                       kernel="paged")
OVERLOAD_BLOCKS = 49
LOW_GEN, HIGH_GEN = 128, 64
# scheduler iterations before the highs arrive: the lows staged,
# admitted and grown (``benchmarks/serving_bench.py``'s head steps)
OVERLOAD_HEAD_STEPS = 3
OVERLOAD_FAULTS = dict(rates={"alloc": 0.05, "evict_storm": 0.05,
                              "stage_stall": 0.05, "dispatch": 0.1},
                       max_per_site=8)
# the injector's seed: on 13a's traffic every site fires (the draws
# follow the order of consultation, which the schedule fixes)
OVERLOAD_FAULT_SEED = 1
# phase 13(b): the tight server of tests/test_preemption.py (two grown
# spans of 3 blocks do not fit in 5) against an ample pool
TIGHT_SMOKE = dict(num_slots=2, max_len=48, block_size=8, segment=4)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def overload_traffic(seed: int, vocab: int) -> tuple[list, list, list]:
    """Phase 13's traffic: 8 lows of 96-160 tokens (priority 0, greedy)
    and 2 highs of 200-240 tokens (priority 1, the second sampled)."""
    from repro_torch.launch.sampling import SamplingParams

    # lengths first, from a generator of their own: the schedule (a
    # function of lengths only) is then the same at every vocabulary,
    # so a CPU run at the smoke size predicts the card's counts
    lens = np.random.RandomState(seed)
    n = [int(lens.randint(96, 161)) for _ in range(8)] + [
        int(lens.randint(200, 241)) for _ in range(2)]
    rng = np.random.RandomState(seed + 1)
    prompts = [rng.randint(0, vocab, k).astype(np.int32) for k in n]
    lows, highs = prompts[:8], prompts[8:]
    samples = [None, SamplingParams(**{**SP_KW, "seed": 200})]
    return lows, highs, samples


def _leaf_ptrs(srv) -> list:
    return [leaf.data_ptr() for layer in srv.mgr.pool.cache
            for leaf in layer.values()]


@contextlib.contextmanager
def overload_probe(srv):
    """Record, on ``srv``: the order of fresh admissions (slot order
    within one ``_admit_ready`` call is score order), host seconds in
    spill and restore, and the first spill's payload against the blocks
    its restore leaves in the pool, every leaf (``torch.equal``)."""
    rec = {"admitted": [], "spill_s": 0.0, "restore_s": 0.0,
           "round_trip": None}
    admit, spill_payload = srv._admit_ready, srv._spill_payload
    spill_req, restore_req = srv.mgr.spill_request, srv.mgr.restore_request
    first, last = {}, {}

    def admit_ready():
        fresh = {st.req.rid for st in srv._staging if st.resume is None}
        before = {s.rid for s in srv.slots}
        admit()
        rec["admitted"] += [s.rid for s in srv.slots
                            if s.rid in fresh and s.rid not in before]

    def spill_request(rb, valid_end):
        t0 = time.perf_counter()
        last["payload"] = spill_req(rb, valid_end)
        rec["spill_s"] += time.perf_counter() - t0
        return last["payload"]

    def spill_payload_(rid, rb, valid_end):
        n = spill_payload(rid, rb, valid_end)
        first.setdefault("payload", last["payload"])
        return n

    def restore_request(prompt, payload):
        t0 = time.perf_counter()
        rb = restore_req(prompt, payload)
        rec["restore_s"] += time.perf_counter() - t0
        if (rb is not None and rec["round_trip"] is None
                and payload is first.get("payload")):
            pool = srv.mgr.pool.cache
            rec["round_trip"] = {
                "blocks": len(rb.bids), "bytes": payload["nbytes"],
                "equal": all(
                    torch.equal(pool[li][name][bid].cpu(), host)
                    for j, bid in enumerate(rb.bids)
                    for li, layer in enumerate(payload["blocks"][j])
                    for name, host in layer.items())}
        return rb

    srv._admit_ready, srv._spill_payload = admit_ready, spill_payload_
    srv.mgr.spill_request = spill_request
    srv.mgr.restore_request = restore_request
    try:
        yield rec
    finally:
        del srv._admit_ready, srv._spill_payload
        del srv.mgr.spill_request, srv.mgr.restore_request


_OVERLOAD_COUNTS = ("preemptions", "restores", "unstaged", "spilled_blocks",
                    "restored_blocks", "stage_stalls", "evictions")


def unloaded_ttfts(srv, highs) -> list:
    """TTFTs of the high prompts alone on ``srv`` (one segment's worth
    of tokens, as ``benchmarks/serving_bench.py``'s ``_high_only_ttfts``
    measures them), then every cached block evicted."""
    for p in highs:
        srv.submit(p, 4, priority=1)
    done = srv.run()
    srv.mgr.alloc.evict_cached()
    return [r.ttft for r in done]


def overload_drain(drive, lows, highs, samples, target: float, device
                   ) -> tuple[list, list, list, float, list]:
    """Submit the lows through ``drive`` (a server or a router), take
    ``OVERLOAD_HEAD_STEPS`` steps, submit the highs (TTFT target
    ``target``), drain. Returns (finished by rid, low rids, high rids,
    wall s, the rids a server still held pending when the highs
    arrived)."""
    _sync(device)
    t0 = time.perf_counter()
    low_ids = [drive.submit(p, LOW_GEN, priority=0) for p in lows]
    for _ in range(OVERLOAD_HEAD_STEPS):
        drive.step()
    pending = ([r.rid for r in drive.pending]
               if hasattr(drive, "pending") else [])
    high_ids = [drive.submit(p, HIGH_GEN, sp, priority=1,
                             ttft_target=target)
                for p, sp in zip(highs, samples)]
    done = drive.run()
    _sync(device)
    return done, low_ids, high_ids, time.perf_counter() - t0, pending


def _class_tails(done, high_ids) -> dict:
    out = {}
    for cls, keep in (("low", lambda r: r.rid not in high_ids),
                      ("high", lambda r: r.rid in high_ids)):
        xs = [r.ttft for r in done if keep(r)]
        out[cls] = {"p50": float(np.percentile(xs, 50)),
                    "p95": float(np.percentile(xs, 95))}
    return out


def overload_arm(srv, name: str, cfg, traffic, target: float,
                 ample: list | None, smi: str) -> tuple[dict, list]:
    """One arm of phase 13(a) on ``srv``: the drain with its launch
    counts, counters (this drain's), admission order, spill / restore
    host seconds, round trip and the leaves' addresses; gated as the
    module docstring says. Returns its row and its tokens in arrival
    order; ``ample`` is the ample drain's (None for that drain)."""
    from repro_torch.kernels import ops as kops

    lows, highs, samples = traffic
    device = srv.device
    before = {k: srv.stats[k] for k in _OVERLOAD_COUNTS}
    spills0, peak0 = srv.spill.spills, srv.spill.peak_bytes
    graphs0 = _programs(srv)
    ptrs = _leaf_ptrs(srv)
    kops.reset_launch_counts()
    with counted_calls(srv) as calls, overload_probe(srv) as rec:
        done, low_ids, high_ids, wall, pending = overload_drain(
            srv, lows, highs, samples, target, device)
    counts = kops.launch_counts()
    want = expected_launches(srv.plan, cfg, calls["decode"],
                             calls["prefill"])
    gens = {**{r: LOW_GEN for r in low_ids}, **{r: HIGH_GEN for r in high_ids}}
    by_rid = {r.rid: r.tokens for r in done}
    # by arrival (lows, then highs): rids differ between servers
    tokens = [by_rid.get(r) for r in low_ids + high_ids]
    n_tok = sum(r.generated for r in done)
    met = sum(r.generated for r in done
              if r.rid not in high_ids or r.ttft <= target)
    st = {k: srv.stats[k] - before[k] for k in _OVERLOAD_COUNTS}
    adm = rec["admitted"]
    if srv.scheduling == "edf":
        ordered = all(adm.index(h) < adm.index(lo) for h in high_ids
                      for lo in pending)
    else:
        ordered = adm == sorted(adm)
    graphs = _programs(srv)
    alloc = srv.mgr.alloc
    row = {"phase": 13, "part": "13a", "arm": name, "arch": cfg.arch_id,
           "layers": cfg.num_layers, "scheduling": srv.scheduling,
           "num_blocks": alloc.num_blocks, "requests": len(done),
           "generated": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_s": _class_tails(done, high_ids), "ttft_target_s": target,
           "high_ttft_s": [r.ttft for r in done if r.rid in high_ids],
           "goodput_tokens_per_s": met / wall, **st,
           "spill_region": {"spills": srv.spill.spills - spills0,
                            "peak_bytes": max(srv.spill.peak_bytes, peak0)},
           "spill_host_s": rec["spill_s"], "restore_host_s": rec["restore_s"],
           "kv_round_trip": rec["round_trip"],
           "admission_order": adm, "pending_at_high_arrival": pending,
           "high_rids": high_ids, "priority_order_kept": ordered,
           "decode_calls": calls["decode"], "prefill_calls": calls["prefill"],
           "launches": {k: v for k, v in counts.items() if v},
           "expected_launches": {k: v for k, v in want.items() if v},
           "captures": graphs["captures"] - graphs0["captures"],
           "replays": graphs["replays"] - graphs0["replays"],
           "capture_s": graphs["capture_s"] - graphs0["capture_s"],
           "nvidia_smi": smi}
    if ample is not None:
        row["tokens_unequal_to_ample"] = int(sum(
            (a != b).sum() for a, b in zip(tokens, ample)))
    emit(row)
    check(len(done) == len(gens) and all(r.generated == gens[r.rid]
                                         for r in done),
          f"phase 13a {name}: not every request finished")
    check(alloc.in_use == 0
          and alloc.num_free + alloc.num_evictable == alloc.capacity
          and len(srv.spill) == 0 and srv.spill.in_use_bytes == 0,
          f"phase 13a {name}: pool or spill region not quiescent")
    check(_leaf_ptrs(srv) == ptrs,
          f"phase 13a {name}: a pool leaf moved")
    if ample is None:
        check(st["preemptions"] == 0 and st["restores"] == 0,
              f"phase 13a {name}: the ample pool preempted {st}")
    else:
        check(st["preemptions"] > 0 and st["restores"] > 0,
              f"phase 13a {name}: no preemption and restore {st}")
        check(rec["round_trip"] is not None and rec["round_trip"]["equal"],
              f"phase 13a {name}: KV round trip {rec['round_trip']}")
        check(ordered, f"phase 13a {name}: admission order {adm} (highs "
                       f"{high_ids}, pending at arrival {pending})")
    if device.type == "cuda":
        check(counts == want, f"phase 13a {name}: launches {counts} != "
                              f"expected {want}")
    return row, tokens


def phase13_server(cfg, params, smi: str, device="cuda") -> dict:
    """13(a): phase 2's model on one tight server (EDF, then FIFO after
    its cached blocks are evicted) and on an ample pool (first the
    highs alone, twice: the second gives the unloaded p95 TTFT; the
    highs' target is twice that)."""
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    traffic = overload_traffic(13, cfg.vocab_size)
    ample = PagedContinuousBatchingServer(cfg, params, device=device,
                                          **OVERLOAD_SERVER)
    unloaded_ttfts(ample, traffic[1])
    p95 = float(np.percentile(unloaded_ttfts(ample, traffic[1]), 95))
    target = 2.0 * p95
    _, ample_tokens = overload_arm(ample, "ample", cfg, traffic, target,
                                   None, smi)
    del ample
    tight = PagedContinuousBatchingServer(
        cfg, params, device=device, num_blocks=OVERLOAD_BLOCKS,
        **OVERLOAD_SERVER)
    rows = {}
    for mode in ("edf", "fifo"):
        tight.scheduling = mode
        rows[mode], _ = overload_arm(tight, mode, cfg, traffic, target,
                                     ample_tokens, smi)
        tight.mgr.alloc.evict_cached()
    emit({"phase": 13, "part": "13a", "summary": "EDF against FIFO",
          "unloaded_high_ttft_p95_s": p95, "ttft_target_s": target,
          **{f"{k}_{m}": rows[m][k] for m in rows
             for k in ("tokens_per_s", "goodput_tokens_per_s",
                       "preemptions", "restores")},
          "nvidia_smi": smi})
    return {"target": target, "traffic": traffic, "ample": ample_tokens}


def smoke_model(arch: str, *, int8: bool = False, device="cuda"):
    """The fp32 smoke config of ``arch`` with the kernels on (MoE at
    no-drop capacity) and its weights from seed 0."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              use_pallas=True)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=torch.int8)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg, transformer.init(cfg, seed=0, device=device)


def overload_families(device="cuda") -> None:
    """13(b): the three cache families at fp32 smoke size (the kernels
    on), each on the tight server of ``tests/test_preemption.py`` against
    an ample pool, greedy and sampled: equal tokens, preemption only on
    the tight pool, both quiescent."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    for arch, kv in (("nemotron-4-15b", None), ("nemotron-4-15b", "int8"),
                     ("deepseek-v3-671b", None)):
        cfg, params = smoke_model(arch, int8=bool(kv), device=device)
        rng = np.random.RandomState(3)
        reqs = [rng.randint(0, cfg.vocab_size, 6).astype(np.int32)
                for _ in range(2)]
        samples = [None, SamplingParams(temperature=0.8, top_k=40, seed=13)]
        out = {}
        for pool, nb in (("tight", 6), ("ample", None)):
            srv = PagedContinuousBatchingServer(
                cfg, params, device=device, num_blocks=nb, **TIGHT_SMOKE)
            kops.reset_launch_counts()
            for p, sp in zip(reqs, samples):
                srv.submit(p, 18, sp)
            done = srv.run()
            alloc = srv.mgr.alloc
            out[pool] = {
                "tokens": [r.tokens for r in done],
                # the kernels this family's drain ran
                "launches": {k: v for k, v in kops.launch_counts().items()
                             if v},
                "preemptions": srv.stats.preemptions,
                "restores": srv.stats.restores,
                "quiescent": (alloc.in_use == 0 and len(srv.spill) == 0
                              and srv.spill.in_use_bytes == 0)}
        same = all(np.array_equal(a, b) for a, b in zip(
            out["tight"].pop("tokens"), out["ample"].pop("tokens")))
        emit({"phase": 13, "part": "13b", "arch": cfg.arch_id,
              "kv_cache_dtype": str(cfg.kv_cache_dtype).replace(
                  "torch.", ""), "tokens_equal": same, **out})
        check(same and out["tight"]["quiescent"]
              and out["ample"]["quiescent"],
              f"phase 13b {cfg.arch_id}: tight != ample or not quiescent")
        check(out["tight"]["preemptions"] > 0
              and out["tight"]["restores"] > 0
              and out["ample"]["preemptions"] == 0,
              f"phase 13b {cfg.arch_id}: preemption {out}")


def overload_fleet(cfg, params, ctx: dict, smi: str, device="cuda") -> None:
    """13(c): a ``ReplicaRouter`` of two tight replicas sharing phase 2's
    params, a seeded ``FaultInjector`` at every site, on 13(a)'s
    traffic, eagerly (``disable_capture``: each replica would capture
    its own keys, long segments among them, for one drain): every
    request finishes, every pool and spill region ends empty."""
    from repro_torch.launch import graphs
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.router import ReplicaRouter
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    faults = FaultInjector(OVERLOAD_FAULT_SEED, **OVERLOAD_FAULTS)
    reps = [PagedContinuousBatchingServer(
        cfg, params, device=device, num_blocks=OVERLOAD_BLOCKS,
        faults=faults, **OVERLOAD_SERVER) for _ in range(2)]
    fleet = ReplicaRouter(reps, faults=faults, seed=13)
    lows, highs, samples = ctx["traffic"]
    with contextlib.ExitStack() as stack:
        stack.enter_context(graphs.disable_capture())
        calls = [stack.enter_context(counted_calls(r)) for r in reps]
        done, low_ids, high_ids, wall, _ = overload_drain(
            fleet, lows, highs, samples, ctx["target"], device)
    gens = {**{r: LOW_GEN for r in low_ids}, **{r: HIGH_GEN for r in high_ids}}
    n_tok = sum(r.generated for r in done)
    tot = fleet.stats.totals
    row = {"phase": 13, "part": "13c", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "replicas": len(reps),
           "requests": len(done), "generated": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "ttft_s": _class_tails(done, high_ids),
           "stolen": fleet.stats.stolen,
           "dispatch_errors": fleet.stats.dispatch_errors,
           "quarantine_events": fleet.stats.quarantine_events,
           "faults_injected": dict(faults.injected),
           "decode_calls": [c["decode"] for c in calls],
           "prefill_calls": [c["prefill"] for c in calls],
           **{k: tot[k] for k in _OVERLOAD_COUNTS},
           "captured": False, "nvidia_smi": smi}
    emit(row)
    check(len(done) == len(gens) and all(r.generated == gens[r.rid]
                                         for r in done),
          "phase 13c: not every request finished")
    check(all(r.mgr.alloc.in_use == 0 and len(r.spill) == 0
              and r.spill.in_use_bytes == 0 and r.mgr.alloc.num_free
              + r.mgr.alloc.num_evictable == r.mgr.alloc.capacity
              for r in reps), "phase 13c: a replica is not quiescent")
    check({s.split(":")[0] for s in faults.injected}
          == set(OVERLOAD_FAULTS["rates"]),
          f"phase 13c: a fault site never fired {dict(faults.injected)}")


# ---------------------------------------------------------------------------
# Phase 14: speculative decoding and RAG
# ---------------------------------------------------------------------------


SPEC_K = 4
SPEC_GEN = 32
# the allocator traffic of a drain (``mgr.counters``; the peak moves
# with when spans grow, so it is not compared)
_POOL_COUNTS = ("allocs", "evictions", "cow_copies", "prefix_block_lookups",
                "prefix_block_hits", "prompt_blocks", "chunk_interior_hits")
_SPEC_STATS = ("spec_steps", "spec_drafted", "spec_accepted",
               "spec_commit_copies", "segments", "decode_steps",
               "preemptions", "restores", "retrievals",
               "retrieval_overlapped", "retrieval_chunk_blocks",
               "retrieval_chunk_hits")
# 14(b): the server of tests/test_spec_decode.py
SPEC_SMOKE = dict(num_slots=3, max_len=48, block_size=8, prefill_chunk=8,
                  segment=4)
# 14(c): the RAG drive of benchmarks/serving_bench.py at block 16: a toy
# corpus of 2048 documents of 128 tokens in chunks of two blocks, a
# 20 ms modeled payload fetch a search, a one-block system prefix,
# top-2; queries from 4 hot documents: 4 leads (one a slot), then 8
# waves of 2 queries, a scheduler step after each
RAG_BLOCK, RAG_DOCS, RAG_DOC_LEN, RAG_HOT = 16, 2048, 128, 4
# phases 13 and 14 serve this many of phase 2's layers (shared, not
# copied; fewer when --layers cuts phase 2): their gates hold the host's
# schedule (admission, preemption, drafts, retrieval), which depth does
# not change, and at all 32 layers they took 300 s of a script that is
# to stay inside half of its 1200 s limit
SIDE_LAYERS = 8
RAG_IO_LATENCY = 0.020
RAG_LEAD_GENS = (72, 64, 56, 48)
RAG_WAVES, RAG_PER_WAVE, RAG_WAVE_GEN = 8, 2, 12


@contextlib.contextmanager
def spec_probe(srv):
    """Count and time ``srv``'s speculative work in the block: draft
    rounds and verify calls (device time between CUDA events around each
    program call), host reads of program results (``_fetch``: two a
    step by design) and host seconds inside ``_advance_spec``."""
    rec = {"draft_calls": 0, "verify_calls": 0, "host_syncs": 0,
           "spec_host_s": 0.0, "device_ms": 0.0}
    events: list = []
    cuda = srv.device.type == "cuda"
    compiled, fetch, advance = srv._compiled, srv._fetch, srv._advance_spec

    def timed_compiled(key, make):
        prog = compiled(key, make)
        kind = {"draft": "draft_calls", "specv": "verify_calls"}.get(key[0])
        if kind is None:
            return prog

        def call(*a, **k):
            rec[kind] += 1
            if not cuda:
                return prog(*a, **k)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "01")
            e0.record()
            out = prog(*a, **k)
            e1.record()
            events.append((e0, e1))
            return out

        return call

    def counted_fetch(t):
        rec["host_syncs"] += 1
        return fetch(t)

    def timed_advance(*a, **k):
        t0 = time.perf_counter()
        try:
            return advance(*a, **k)
        finally:
            rec["spec_host_s"] += time.perf_counter() - t0

    srv._compiled, srv._fetch = timed_compiled, counted_fetch
    srv._advance_spec = timed_advance
    try:
        yield rec
    finally:
        del srv._compiled, srv._fetch, srv._advance_spec
        _sync(srv.device)
        rec["device_ms"] = sum(a.elapsed_time(b) for a, b in events)


def expected_spec_launches(srv, calls: dict, rec: dict) -> dict:
    """Launches a drain of ``srv`` must count: the target's forward calls
    (segment steps decode in place on the pool; staging rounds and verify
    calls are multi-token chunks through the gathered view, no paged
    kernel) and the draft's (k forward calls a round, its ingest prefill
    and k - 1 decode steps, on its dense slab: no paged kernel either),
    the draft under the ambient plan."""
    from repro_torch.kernels import ops as kops

    want = expected_launches(srv.plan, srv.cfg, calls["decode"],
                             calls["prefill"] + rec["verify_calls"])
    if srv._spec_on:
        draft = expected_launches(kops.current_plan(), srv.spec.draft_cfg,
                                  0, srv.spec.k * rec["draft_calls"])
        want = {k: want[k] + draft[k] for k in want}
    return want


def _pool_counts(srv) -> dict:
    c = dataclasses.asdict(srv.mgr.counters)
    return {k: c[k] for k in _POOL_COUNTS}


def _quiescent(srv) -> bool:
    alloc = srv.mgr.alloc
    return (alloc.in_use == 0 and len(srv.spill) == 0
            and alloc.num_free + alloc.num_evictable == alloc.capacity)


def spec_drain(srv, submit, name: str) -> tuple[dict, list]:
    """One drive of ``srv`` (``submit(srv)`` submits, steps as it likes
    and returns the rids it submitted with their token counts) to the
    end of ``run()``, with fresh launch counts: its row (rates, this
    drive's counters, host syncs and seconds and device ms a speculative
    step, captures, launches against ``expected_spec_launches``) and the
    tokens by submitted rid. Gated: completion, quiescence, two host
    reads a speculative step, exact launches on the card."""
    from repro_torch.kernels import ops as kops

    dev = srv.device
    st0 = {k: srv.stats[k] for k in _SPEC_STATS}
    pool0, g0 = _pool_counts(srv), _programs(srv)
    _sync(dev)
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with counted_calls(srv) as calls, spec_probe(srv) as rec:
        gens = submit(srv)
        done = {r.rid: r for r in srv.run()}
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    want = expected_spec_launches(srv, calls, rec)
    st = {k: srv.stats[k] - st0[k] for k in _SPEC_STATS}
    pool = {k: v - pool0[k] for k, v in _pool_counts(srv).items()}
    g = _programs(srv)
    steps = max(st["spec_steps"], 1)
    n_tok = sum(r.generated for r in done.values())
    row = {"phase": 14, "name": name, "requests": len(done),
           "generated": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "ttft_s_median": float(np.median([r.ttft for r in
                                             done.values()])),
           **st, "acceptance": st["spec_accepted"] / max(
               st["spec_drafted"], 1),
           "verify_calls": rec["verify_calls"],
           "draft_calls": rec["draft_calls"],
           "decode_calls": calls["decode"],
           "prefill_calls": calls["prefill"],
           "host_syncs": rec["host_syncs"],
           "host_s_per_spec_step": rec["spec_host_s"] / steps,
           "device_ms_per_spec_step": rec["device_ms"] / steps,
           "pool_counts": pool,
           "captures": g["captures"] - g0["captures"],
           "capture_s": g["capture_s"] - g0["capture_s"],
           "replays": g["replays"] - g0["replays"],
           "launches": {k: v for k, v in counts.items() if v},
           "expected_launches": {k: v for k, v in want.items() if v}}
    check(sorted(done) == sorted(gens)
          and all(done[r].generated == n for r, n in gens.items()),
          f"phase 14 {name}: not every request finished")
    check(_quiescent(srv), f"phase 14 {name}: pool not quiescent")
    if srv._spec_on:
        check(st["spec_steps"] > 0, f"phase 14 {name}: never speculated")
        check(rec["host_syncs"] == 2 * st["spec_steps"],
              f"phase 14 {name}: {rec['host_syncs']} host reads for "
              f"{st['spec_steps']} steps")
    if dev.type == "cuda":
        check(counts == want, f"phase 14 {name}: launches {counts} != "
                              f"expected {want}")
    return row, [done[r].tokens for r in gens]


def submits(reqs):
    """A ``spec_drain`` drive that submits ``(prompt, gen, sample)``s."""
    def submit(srv):
        return {srv.submit(p, g, sample=sp): g for p, g, sp in reqs}
    return submit


def shallow_draft(cfg, params, layers: int = 2):
    """The target's first ``layers`` layers with its embedding, final
    norm and unembedding: a draft that shares the target's weights."""
    return (dataclasses.replace(cfg, num_layers=layers),
            {**params, "layers": params["layers"][:layers]})


def spec_serving(cfg, params, smi: str, prompts=None, device="cuda",
                 **server) -> dict:
    """14(a): phase 2's model and traffic, greedy, on three servers —
    plain, the oracle draft and the 2-layer shallow draft at k = 4 —
    each draining cold, then warm. Gated besides ``spec_drain``'s gates:
    each speculative drain's allocator traffic equals the plain drain's.
    Printed: acceptance and the tokens unequal to the plain drain (bf16
    bits follow row counts: not gated)."""
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.launch.spec import SpecConfig

    if prompts is None:
        prompts = traffic(2, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    reqs = [(p, SPEC_GEN, None) for p in prompts]
    specs = {"plain": None,
             "oracle": SpecConfig(cfg, params, k=SPEC_K),
             "shallow": SpecConfig(*shallow_draft(cfg, params), k=SPEC_K)}
    plain: dict = {}
    oracle: dict = {}
    rows = {}
    for arm, spec in specs.items():
        srv = PagedContinuousBatchingServer(
            cfg, params, spec=spec, **{**FULL_SERVER, "device": device,
                                       **server})
        for drain in ("cold", "warm"):
            name = f"14a {arm} {drain}"
            row, toks = spec_drain(srv, submits(reqs), name)
            row.update(part="14a", arm=arm, drain=drain, arch=cfg.arch_id,
                       layers=cfg.num_layers, k=SPEC_K, nvidia_smi=smi)
            if arm == "plain":
                plain[drain] = (toks, row["pool_counts"])
            else:
                row["tokens_unequal_to_plain"] = int(sum(
                    (a != b).sum() for a, b in zip(toks, plain[drain][0])))
            if arm == "oracle":
                oracle[drain] = toks
            elif arm == "shallow":
                # the emitted tokens are the verifier's: does the draft
                # change their bits?
                row["tokens_unequal_to_oracle"] = int(sum(
                    (a != b).sum() for a, b in zip(toks, oracle[drain])))
            emit(row)
            rows[arm, drain] = row
            if arm != "plain":
                check(row["pool_counts"] == plain[drain][1],
                      f"phase {name}: allocator counters "
                      f"{row['pool_counts']} != plain {plain[drain][1]}")
        del srv
    return rows


def _solo_tokens(cfg, params, prompt, gen, sample, device) -> np.ndarray:
    from repro_torch.launch.serve import generate

    return generate(cfg, params, torch.from_numpy(prompt)[None], gen,
                    max_len=SPEC_SMOKE["max_len"], device=device,
                    sample=sample)[0, prompt.size:].cpu().numpy()


def spec_families(device="cuda") -> None:
    """14(b): the three cache families at fp32 smoke size: the oracle
    draft at k = 3, greedy and half sampled, against the plain server
    and solo ``generate`` — equal tokens, greedy acceptance exactly 1.0
    — then ``tests/test_spec_decode.py``'s tight-pool drain (two lows,
    then a high after one step) on nemotron and deepseek-v3: preemption
    and solo decode's tokens."""
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.launch.spec import SpecConfig

    for arch, int8 in (("nemotron-4-15b", False), ("nemotron-4-15b", True),
                       ("deepseek-v3-671b", False)):
        cfg, params = smoke_model(arch, int8=int8, device=device)
        oracle = SpecConfig(cfg, params, k=3)
        rng = np.random.RandomState(5)
        base = [(rng.randint(0, cfg.vocab_size, rng.randint(2, 14))
                 .astype(np.int32), int(rng.randint(1, 9)))
                for _ in range(6)]
        kv = "int8" if int8 else str(cfg.kv_cache_dtype).replace(
            "torch.", "")
        out = {"phase": 14, "part": "14b", "arch": cfg.arch_id,
               "kv_cache_dtype": kv}
        for mix in ("greedy", "half_sampled"):
            reqs = [(p, g, SamplingParams(temperature=0.9, seed=i)
                     if mix != "greedy" and i % 2 else None)
                    for i, (p, g) in enumerate(base)]
            toks = {}
            for arm, spec in (("plain", None), ("oracle", oracle)):
                srv = PagedContinuousBatchingServer(
                    cfg, params, device=device, spec=spec, **SPEC_SMOKE)
                row, toks[arm] = spec_drain(
                    srv, submits(reqs), f"14b {cfg.arch_id} {kv} {mix} {arm}")
                out[f"{mix}_{arm}"] = {k: row[k] for k in (
                    "spec_steps", "acceptance", "verify_calls",
                    "draft_calls", "spec_commit_copies", "launches")}
            solo = [_solo_tokens(cfg, params, p, g, sp, device)
                    for p, g, sp in reqs]
            same = all(np.array_equal(a, b) and np.array_equal(a, c)
                       for a, b, c in zip(toks["oracle"], toks["plain"],
                                          solo))
            out[f"{mix}_tokens_equal"] = same
            check(same, f"phase 14b {cfg.arch_id} {kv} {mix}: speculative "
                        "!= plain != solo")
        check(out["greedy_oracle"]["acceptance"] == 1.0,
              f"phase 14b {cfg.arch_id} {kv}: greedy oracle acceptance "
              f"{out['greedy_oracle']['acceptance']}")
        if arch == "deepseek-v3-671b" or not int8:
            srv = PagedContinuousBatchingServer(
                cfg, params, device=device, spec=oracle, scheduling="edf",
                **{**SPEC_SMOKE, "num_slots": 2, "num_blocks": 6})
            rng = np.random.RandomState(21)
            lows = [rng.randint(0, cfg.vocab_size, 6).astype(np.int32)
                    for _ in range(2)]
            high = rng.randint(0, cfg.vocab_size, 12).astype(np.int32)

            def tight(s):
                gens = {s.submit(p, 18, priority=0): 18 for p in lows}
                s.step()
                gens[s.submit(high, 6, priority=1, ttft_target=30.0)] = 6
                return gens

            row, toks = spec_drain(srv, tight, f"14b {cfg.arch_id} tight")
            solo = [_solo_tokens(cfg, params, p, g, None, device)
                    for p, g in ((lows[0], 18), (lows[1], 18), (high, 6))]
            same = all(np.array_equal(a, b) for a, b in zip(toks, solo))
            out["tight"] = {k: row[k] for k in (
                "spec_steps", "preemptions", "restores", "acceptance")}
            out["tight"]["tokens_equal_solo"] = same
            check(same and row["preemptions"] > 0 and row["restores"] > 0,
                  f"phase 14b {cfg.arch_id} tight: {out['tight']}")
        emit(out)


def spec_captured_vs_eager(cfg, params, smi: str, device="cuda") -> None:
    """The draft and verify programs replayed against eager on one warm
    server, at 2 layers of phase 2's full widths (the oracle draft of
    that model, k = 4; 4 of phase 2's requests, 16 tokens): a warm-up
    drain (captures), an eager drain, a captured drain — the same
    tokens bit for bit and exact launches each."""
    from repro_torch.launch import graphs
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.launch.spec import SpecConfig

    cfg2, params2 = shallow_draft(cfg, params)
    prompts = traffic(2, 8, cfg.vocab_size, shared=128, lo=32, hi=256)[:4]
    reqs = [(p, 16, None) for p in prompts]
    srv = PagedContinuousBatchingServer(
        cfg2, params2, spec=SpecConfig(cfg2, params2, k=SPEC_K),
        **{**FULL_SERVER, "device": device})
    spec_drain(srv, submits(reqs), "14 capture warm-up")
    out = {}
    for mode in ("eager", "captured"):
        ctx = (graphs.disable_capture() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            row, toks = spec_drain(srv, submits(reqs), f"14 {mode}")
        out[mode] = (row, toks)
    same = all(np.array_equal(a, b) for a, b in zip(out["eager"][1],
                                                    out["captured"][1]))
    progs = {k[0]: p for k, p in srv._exec.items()
             if k[0] in ("draft", "specv")}
    row = {"phase": 14, "part": "captured_vs_eager", "arch": cfg.arch_id,
           "layers": cfg2.num_layers, "captured_equals_eager": same,
           "eager_replays": out["eager"][0]["replays"],
           "captured_replays": out["captured"][0]["replays"],
           "draft_captures": progs["draft"].captures,
           "draft_replays": progs["draft"].replays,
           "verify_keys": sum(k[0] == "specv" for k in srv._exec),
           "launches": out["captured"][0]["launches"],
           "nvidia_smi": smi}
    emit(row)
    check(same, "phase 14: captured draft/verify tokens != eager tokens")
    check(out["eager"][0]["replays"] == 0
          and out["captured"][0]["replays"] > 0
          and progs["draft"].replays > 0,
          f"phase 14: capture {row}")


def rag_setup(vocab: int, *, block: int = RAG_BLOCK, n_docs: int = RAG_DOCS,
              doc_len: int = RAG_DOC_LEN, io_latency_s: float =
              RAG_IO_LATENCY):
    """The corpus, index and pipeline of 14(c), and its queries: the
    leads and the waves (``benchmarks/serving_bench.py``'s drive)."""
    from repro_torch.retrieval import (
        ChunkedCorpus,
        EmbeddingIndex,
        RagPipeline,
        make_toy_corpus,
    )

    docs = make_toy_corpus(vocab, n_docs=n_docs, doc_len=doc_len, seed=0)
    corpus = ChunkedCorpus(docs, chunk_tokens=2 * block)
    index = EmbeddingIndex(corpus, vocab_size=vocab, seed=0,
                           io_latency_s=io_latency_s)
    pipe = RagPipeline(index, system_prefix=list(range(5, 5 + block)),
                       block_size=block, top_k=2)
    rng = np.random.RandomState(7)

    def q(i):
        d = docs[int(rng.randint(RAG_HOT))]
        lo = int(rng.randint(0, d.size - 8))
        return d[lo:lo + 4 + (i % 3)].copy()

    leads = [q(i) for i in range(len(RAG_LEAD_GENS))]
    waves = [[q(w * RAG_PER_WAVE + j) for j in range(RAG_PER_WAVE)]
             for w in range(RAG_WAVES)]
    return pipe, leads, waves


def rag_drive(leads, waves, rids: list):
    """The 14(c) drive for ``spec_drain``: the leads, a step, then each
    wave and a step; the rids submitted land in ``rids``."""
    def submit(srv):
        gens = {srv.submit_query(q, g): g
                for q, g in zip(leads, RAG_LEAD_GENS)}
        srv.step()
        for wave in waves:
            for q in wave:
                gens[srv.submit_query(q, RAG_WAVE_GEN)] = RAG_WAVE_GEN
            srv.step()
        rids.extend(gens)
        return gens
    return submit


def rag_serving(cfg, params, smi: str, device="cuda", **setup) -> dict:
    """14(c): phase 2's model behind the RAG drive on two servers,
    ``rag_overlap`` on and off: each drains cold (its captures), then
    warm in the order overlap, serial, overlap — the rate compared. Gated
    besides ``spec_drain``'s gates: every query retrieved, chunk hits,
    overlapped retrievals in the overlap arms and none in the serial
    ones, and the same assembled prompts in every arm."""
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    pipe, leads, waves = rag_setup(cfg.vocab_size, **setup)
    max_len = pipe.prompt_len_for + 8 + max(RAG_LEAD_GENS)
    max_len = -(-max_len // pipe.block_size) * pipe.block_size
    n_q = len(leads) + sum(len(w) for w in waves)
    servers = {overlap: PagedContinuousBatchingServer(
        cfg, params, device=device, num_slots=4, max_len=max_len,
        block_size=pipe.block_size, prefill_chunk=pipe.block_size,
        segment=8, rag=pipe, rag_overlap=overlap) for overlap in
        (True, False)}
    rows, prompts = {}, {}
    for arm, overlap in (("overlap_cold", True), ("serial_cold", False),
                         ("overlap", True), ("serial", False),
                         ("overlap_again", True)):
        rids: list = []
        row, _ = spec_drain(servers[overlap], rag_drive(leads, waves, rids),
                            f"14c {arm}")
        prompts[arm] = [servers[overlap].rag_results[r].tokens
                        for r in rids]
        row.update(part="14c", arm=arm, arch=cfg.arch_id,
                   layers=cfg.num_layers, queries=n_q, nvidia_smi=smi)
        emit(row)
        rows[arm] = row
        check(row["retrievals"] == n_q,
              f"phase 14c {arm}: {row['retrievals']} retrievals of {n_q}")
        check(row["retrieval_chunk_hits"] > 0,
              f"phase 14c {arm}: no chunk hits")
        check((row["retrieval_overlapped"] > 0) == overlap,
              f"phase 14c {arm}: {row['retrieval_overlapped']} overlapped")
    same = all(len(prompts[a]) == n_q and all(
        np.array_equal(x, y) for x, y in zip(prompts[a], prompts["overlap"]))
        for a in prompts)
    overlap_rate = 0.5 * (rows["overlap"]["tokens_per_s"]
                          + rows["overlap_again"]["tokens_per_s"])
    emit({"phase": 14, "part": "14c", "prompts_equal_across_arms": same,
          "overlap_over_serial": overlap_rate / rows["serial"]["tokens_per_s"],
          "order": "warm: overlap, serial, overlap", "nvidia_smi": smi})
    check(same, "phase 14c: the arms assembled different prompts")
    return rows


def rag_families(device="cuda") -> None:
    """14(c) at fp32 smoke size: ``tests/test_rag.py``'s queries (greedy
    and sampled) on nemotron-4-15b and deepseek-v3 (no-drop), overlap on
    and off, against plain ``submit`` of the same assembled prompts:
    equal tokens."""
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    samples = [None, SamplingParams(temperature=0.8, seed=11), None,
               SamplingParams(temperature=1.1, top_k=20, seed=3), None]
    server = dict(num_slots=2, max_len=96, block_size=8, prefill_chunk=8,
                  segment=4)
    for arch in ("nemotron-4-15b", "deepseek-v3-671b"):
        cfg, params = smoke_model(arch, device=device)
        toks, out = {}, {"phase": 14, "part": "14c_smoke",
                         "arch": cfg.arch_id}
        for overlap in (True, False):
            pipe, _, _ = rag_setup(cfg.vocab_size, block=8, n_docs=4,
                                   doc_len=32, io_latency_s=0.0)
            srv = PagedContinuousBatchingServer(
                cfg, params, device=device, rag=pipe, rag_overlap=overlap,
                **server)
            rng = np.random.RandomState(7)
            docs = [c.tokens for c in pipe.index.corpus.chunks]
            qs = [docs[int(rng.randint(len(docs) // 2))][:3 + i]
                  for i in range(len(samples))]
            rids = [srv.submit_query(q, 5, s) for q, s in zip(qs, samples)]
            done = {r.rid: r.tokens for r in srv.run()}
            plain = PagedContinuousBatchingServer(cfg, params, device=device,
                                                  **server)
            prids = [plain.submit(srv.rag_results[r].tokens, 5, s)
                     for r, s in zip(rids, samples)]
            pdone = {r.rid: r.tokens for r in plain.run()}
            toks[overlap] = [done[r] for r in rids]
            same = all(np.array_equal(done[r], pdone[p])
                       for r, p in zip(rids, prids))
            out[f"overlap_{overlap}"] = {
                "equal_to_plain_submit": same,
                "retrievals": srv.stats.retrievals,
                "overlapped": srv.stats.retrieval_overlapped,
                "chunk_hits": srv.stats.retrieval_chunk_hits}
            check(same and _quiescent(srv),
                  f"phase 14c {cfg.arch_id} overlap={overlap}: RAG drain "
                  "!= plain submit")
        out["overlap_on_equals_off"] = all(
            np.array_equal(a, b) for a, b in zip(toks[True], toks[False]))
        emit(out)
        check(out["overlap_on_equals_off"],
              f"phase 14c {cfg.arch_id}: overlap on != off")


# ---------------------------------------------------------------------------
# Phase 8: the training path
# ---------------------------------------------------------------------------


def expected_first_loss(cfg) -> float:
    """The loss of random weights: the final norm leaves unit-RMS rows,
    the tied embedding's entries have std 0.02, so the logits are about
    normal with variance 0.02^2 * d_model, and the mean NLL of uniform
    labels is ln V + variance / 2."""
    return float(np.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model)


ARGMAX_FLOOR = 0.9


def train_forward_full(cfg, params) -> dict:
    """Phase 8a: ``forward`` and the loss at nemotron-4-15b's full width
    and depth on one TRAIN_4K sequence (4096 tokens, batch 1) under
    ``no_grad``: with the kernels (flash attention + the Sidebar MLP,
    exact launch counts) and without them (the chunked attention route,
    cuBLAS products); the two losses within 1e-2 relative, the argmax
    of at least ``ARGMAX_FLOOR`` of the positions the same."""
    from repro_torch.configs.base import TRAIN_4K
    from repro_torch.data import pipeline
    from repro_torch.kernels import ops as kops
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import next_token_loss

    api = get_model(cfg)
    batch = pipeline.make_batch(cfg, TRAIN_4K, 0, batch_override=1,
                                device="cuda")
    row = {"phase": 8, "part": "8a", "arch": cfg.arch_id,
           "layers": cfg.num_layers, "seq": TRAIN_4K.seq_len, "batch": 1}
    out = {}
    for name, use in (("kernels", True), ("plain", False)):
        c = dataclasses.replace(cfg, use_pallas=use)
        recs: list = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kops.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.no_grad(), kops.record_dispatches(recs):
            logits = api.forward(params, c, batch)
            loss = float(next_token_loss(c, logits, batch["labels"]))
        torch.cuda.synchronize()
        out[name] = {"loss": loss, "s": time.perf_counter() - t0,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": kops.launch_counts(),
                     "argmax": logits[0].argmax(-1)}
        flash = {r.variant for r in recs if r.op == "flash_attention"}
        del logits
        torch.cuda.empty_cache()
        if use:
            want = dict.fromkeys(KERNELS, 0)
            want.update(flash_attention=cfg.num_layers,
                        sidebar_mlp=cfg.num_layers)
            check(out[name]["launches"] == want,
                  f"phase 8a: launches {out[name]['launches']} != {want}")
            check(flash == {"flash"}, f"phase 8a: flash variants {flash}")
        else:
            check(not flash and not any(out[name]["launches"].values()),
                  "phase 8a: the plain forward reached a kernel")
    lk, lp = out["kernels"]["loss"], out["plain"]["loss"]
    rel = abs(lk - lp) / abs(lp)
    agree = (out["kernels"]["argmax"] == out["plain"]["argmax"]
             ).float().mean().item()
    row.update({
        "loss_kernels": lk, "loss_plain": lp, "loss_rel_diff": rel,
        "tol": 1e-2, "argmax_agreement": agree,
        "argmax_floor": ARGMAX_FLOOR,
        "ln_vocab": float(np.log(cfg.vocab_size)),
        "expected_loss": expected_first_loss(cfg),
        "s_kernels": out["kernels"]["s"], "s_plain": out["plain"]["s"],
        "peak_mem_gb_kernels": out["kernels"]["peak_mem_gb"],
        "peak_mem_gb_plain": out["plain"]["peak_mem_gb"],
        "launches": out["kernels"]["launches"]})
    emit(row)
    check(np.isfinite(lk) and np.isfinite(lp) and rel <= 1e-2,
          f"phase 8a: losses {lk} and {lp} differ by {rel}")
    # random weights leave near-ties among 256000 logits, so bf16
    # rounding in the 32 layers flips a few percent of the argmaxes
    # (0.952 agree on the H100): the floor is 0.9
    check(agree >= ARGMAX_FLOOR,
          f"phase 8a: argmax agreement {agree} < {ARGMAX_FLOOR}")
    return row


def train_steps_full(steps: int = 3) -> dict:
    """Phase 8b: three ``make_train_step`` steps at nemotron-4-15b's full
    width, depth cut to 2 layers (2.35 B parameters), bf16 weights from a
    seed, ``use_pallas`` off (as the JAX trainer), remat "full", two
    strided microbatches of one 4096-token sequence (TRAIN_4K's global
    batch cut to 2), fp32 accumulator and moments; then the same forward
    with the kernels under autograd must raise."""
    from repro_torch import configs, tree
    from repro_torch.configs.base import TRAIN_4K, TrainConfig
    from repro_torch.data import pipeline
    from repro_torch.kernels import build
    from repro_torch.launch.train import make_train_step, value_and_grad
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.optim.optimizer import init_state

    full = configs.get_config("nemotron-4-15b")
    cfg = dataclasses.replace(full, num_layers=2, remat="full",
                              use_pallas=False)
    cell = dataclasses.replace(TRAIN_4K, global_batch=2)
    tcfg = TrainConfig(microbatch_per_device=1)
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in tree.leaves(params))
    opt = init_state(params, tcfg)
    step_fn, n_micro, _ = make_train_step(cfg, tcfg, get_model(cfg), cell)
    check(n_micro == 2, f"phase 8b: n_micro {n_micro}")
    rows = []
    for step in range(steps):
        batch = pipeline.make_batch(cfg, cell, step, batch_override=2,
                                    device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _, m = step_fn(params, opt, None, batch)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rows.append({"step": step, "loss": loss,
                     "grad_norm": float(m["grad_norm"]),
                     "lr": float(m["lr"]), "step_s": dt,
                     "tokens_per_s": 2 * cell.seq_len / dt})
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the kernels have no backward: under autograd the first one raises
    kc = dataclasses.replace(cfg, use_pallas=True)
    before = dict(build.launches)
    try:
        value_and_grad(lambda p, b: transformer.loss(p, kc, b), params,
                       {k: x[:1] for k, x in batch.items()})
    except RuntimeError as e:
        refused = "no backward" in str(e)
    else:
        refused = False
    row = {"phase": 8, "part": "8b", "arch": cfg.arch_id, "layers": 2,
           "reduced": {"num_layers": f"{full.num_layers} -> 2",
                       "global_batch": f"{TRAIN_4K.global_batch} -> 2"},
           "params": n_params, "seq": cell.seq_len, "n_micro": n_micro,
           "remat": cfg.remat, "steps": rows, "peak_mem_gb": peak,
           "ln_vocab": float(np.log(cfg.vocab_size)),
           "expected_first_loss": expected_first_loss(cfg),
           "kernels_under_autograd": "refused" if refused else "ran"}
    emit(row)
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              for r in rows), "phase 8b: a loss or grad_norm is not finite")
    check(abs(rows[0]["loss"] - row["expected_first_loss"]) < 1.0,
          f"phase 8b: first loss {rows[0]['loss']} far from "
          f"{row['expected_first_loss']}")
    check(refused and dict(build.launches) == before,
          "phase 8b: a kernel ran under autograd")
    del params, opt
    torch.cuda.empty_cache()
    return row


def trainer_resume() -> dict:
    """Phase 8c: ``Trainer`` at the fp32 nemotron smoke size on the card:
    4 steps with a checkpoint every 2, then a fresh ``Trainer`` resumes
    from step 4 and runs to 6; its losses equal an uninterrupted 6-step
    run's."""
    import tempfile

    from repro_torch import configs
    from repro_torch.configs.base import ShapeCell, TrainConfig
    from repro_torch.launch.train import Trainer

    cfg = configs.get_smoke_config("nemotron-4-15b")
    cell = ShapeCell("smoke", seq_len=128, global_batch=4, kind="train")
    tcfg = TrainConfig(microbatch_per_device=2, warmup_steps=2,
                       learning_rate=1e-3)
    with tempfile.TemporaryDirectory() as d:
        a = Trainer(cfg, tcfg, cell, ckpt_dir=f"{d}/a", ckpt_every=2)
        first = a.run(4)
        b = Trainer(cfg, tcfg, cell, ckpt_dir=f"{d}/a", ckpt_every=2)
        resumed = b.run(6)
        c = Trainer(cfg, tcfg, cell, ckpt_dir=f"{d}/c", ckpt_every=100)
        whole = c.run(6)
    bitwise = resumed.losses == whole.losses[4:]
    err = max(abs(x - y) for x, y in zip(resumed.losses, whole.losses[4:]))
    row = {"phase": 8, "part": "8c", "arch": cfg.arch_id,
           "dtype": "float32", "seq": cell.seq_len,
           "n_micro": a.n_micro, "losses_first_4": first.losses,
           "resumed_from": resumed.resumed_from,
           "losses_resumed": resumed.losses,
           "losses_uninterrupted": whole.losses,
           "bitwise_equal": bitwise, "max_abs_diff": err}
    emit(row)
    check(resumed.resumed_from == 4 and len(resumed.losses) == 2
          and all(np.isfinite(x) for x in whole.losses),
          "phase 8c: the resumed run did not start from step 4")
    check(err <= 1e-6 * max(abs(x) for x in whole.losses),
          f"phase 8c: resumed losses {resumed.losses} != "
          f"{whole.losses[4:]}")
    return row


# ---------------------------------------------------------------------------
# Phase 15: the analytical engine, the paper's LeNet and the planner
# ---------------------------------------------------------------------------

ENGINE_MODES = ("monolithic", "flexible_dma", "sidebar", "sidebar_pipelined")
LENET_BATCH = 256
ENGINE_REPS = 5
# the paper's claims as examples/lenet_paper_workload.py prints them
PAPER_CLAIMS = {"dma_latency_overhead_pct": "8-14",
                "sidebar_latency_overhead_pct": "<=2",
                "dma_edp": "~1.5", "sidebar_edp": "~1.07"}


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _median_s(fn, reps: int) -> float:
    """Median host seconds of ``fn`` (which ends in a synchronize)."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def chip_probe() -> dict:
    """The measured constants of the port's H100 spec
    (``src/repro_torch/core/constants.py``): the idle board draw (the
    least ``power.draw`` of ten reads over ~3 s with the card idle), the
    SM clock's maximum (``nvidia-smi``), the host seconds of one
    ``activation`` launch on one element (1000 back to back, then one
    synchronize), a 4 KiB pinned round trip (device -> pinned host ->
    device, each copy synchronized: FLEXIBLE_DMA's handoff) and half of a
    4-byte pinned round trip (one way of a flag: the engine's sidebar
    handshake across PCIe). Its launches precede the counted runs."""
    from repro_torch.kernels import activations as ak

    torch.cuda.synchronize()
    idle = []
    for _ in range(10):         # the least of 10 reads over ~3 s idle
        time.sleep(0.3)
        idle.append(float(_smi("power.draw")))
    idle_w = min(idle)
    clock_mhz = float(_smi("clocks.max.sm"))
    one = torch.zeros(1, 1, device="cuda")
    for _ in range(20):
        ak.activation_2d(one, "relu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        ak.activation_2d(one, "relu")
    torch.cuda.synchronize()
    launch_s = (time.perf_counter() - t0) / 1000

    def round_trip(n: int) -> float:
        dev = torch.zeros(n, device="cuda")
        host = torch.empty(n, pin_memory=True)

        def trip():
            host.copy_(dev, non_blocking=True)
            torch.cuda.synchronize()
            dev.copy_(host, non_blocking=True)
            torch.cuda.synchronize()

        for _ in range(20):
            trip()
        return _median_s(trip, 200)

    row = {"phase": 15, "part": "chip_probe", "idle_power_w": idle_w,
           "clocks_max_sm_mhz": clock_mhz, "kernel_launch_s": launch_s,
           "dma_flush_s": round_trip(1024),
           "sidebar_handshake_s": round_trip(1) / 2}
    emit(row)
    return row


def _engine_modes(graph, params, x, table, ref, *, tol: float, rel: bool,
                  what: str, cpu_check: bool) -> tuple[dict, dict]:
    """One counted pass of ``graph`` under the four modes on the card,
    each held to ``ref`` (None: the MONOLITHIC output; absolute, or
    relative to max |ref|) and, with ``cpu_check``, its SidebarStats,
    launches and accounting to a CPU run of the same graph; then each
    mode's median wall ms after a warm-up. Returns the rows by mode and
    the pass's launch counts."""
    from repro_torch.core import engine
    from repro_torch.core.modes import ExecutionMode
    from repro_torch.kernels import ops as kops

    cpu_params = ({k: v.cpu() for k, v in params.items()} if cpu_check
                  else None)
    rows, outs = {}, {}
    kops.reset_launch_counts()
    for mode in ENGINE_MODES:
        outs[mode] = engine.run(graph, params, x, ExecutionMode(mode), table)
    torch.cuda.synchronize()
    counts = kops.launch_counts()
    cpu_x = x.cpu() if cpu_check else None
    if ref is None:
        ref = outs["monolithic"].output
    for mode in ENGINE_MODES:
        res = outs[mode]
        err, r = rel_err(res.output, ref)
        check(res.output.is_cuda and res.output.shape == ref.shape
              and bool(torch.isfinite(res.output).all())
              and (r if rel else err) <= tol,
              f"phase 15 {what} {mode}: error {err} (rel {r}) > {tol}")
        stats = (None if res.sidebar is None
                 else dataclasses.asdict(res.sidebar.stats))
        if cpu_check:
            cpu = engine.run(graph, cpu_params, cpu_x, ExecutionMode(mode),
                             table)
            check(stats == (None if cpu.sidebar is None
                            else dataclasses.asdict(cpu.sidebar.stats))
                  and res.launches == cpu.launches
                  and res.accounting == cpu.accounting,
                  f"phase 15 {what} {mode}: protocol counts differ from "
                  "the CPU run's")

        def once(mode=mode):
            engine.run(graph, params, x, ExecutionMode(mode), table)
            torch.cuda.synchronize()

        once()
        rows[mode] = {"wall_ms": _median_s(once, ENGINE_REPS) * 1e3,
                      "max_abs_err": err, "max_rel_err": r,
                      "launches": res.launches, "sidebar_stats": stats}
    return rows, counts


def engine_lenet(smi: str) -> dict:
    """15a: LeNet on CIFAR-10 shapes at batch 256 (weights from seed 0),
    relu and softplus, through ``engine.run`` under the four modes."""
    from repro_torch.core import (ExecutionMode, account_model,
                                  build_monolithic, estimate,
                                  make_default_table, normalized_edp)
    from repro_torch.core.constants import H100
    from repro_torch.launch import graphs
    from repro_torch.models import lenet

    table = make_default_table()
    lenet.register_pooling(table)
    params = lenet.init(torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    x = torch.randn((LENET_BATCH, 3, 32, 32), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    ep = lenet.engine_params(params)
    out = {"launches": 0, "rows": {}}
    for act in ("relu", "softplus"):
        graph, = lenet.to_layer_graphs(LENET_BATCH, act)
        ref = lenet.forward(params, x, table.lookup(act))
        rows, counts = _engine_modes(graph, ep, x, table, ref, tol=1e-4,
                                     rel=False, what=f"15a {act}",
                                     cpu_check=True)
        n_act = sum(op.function == act for _, op, _ in graph.flexible_ops())
        check(counts["activation"] == n_act
              and sum(counts.values()) == n_act,
              f"phase 15a {act}: launches {counts}, want {n_act} "
              "activation launches (the FLEXIBLE_DMA run's ops)")
        out["launches"] += counts["activation"]
        # the fixed-function program: captured == eager bit for bit, and
        # a table hot-swap after build leaves it as it was
        swap = make_default_table()
        lenet.register_pooling(swap)
        mono = build_monolithic(graph, swap)
        with graphs.disable_capture():
            eager = mono(ep, x)
        captured = [mono(ep, x) for _ in range(3)]
        swap.register(act, lambda t: torch.clamp_min(t, 0.0) * 0.5,
                      overwrite=True)
        captured.append(mono(ep, x))
        prog = mono.programs[x.device]
        same = all(torch.equal(c, eager) for c in captured)
        check(same and prog.captures == 1 and prog.replays == 2,
              f"phase 15a {act}: MONOLITHIC captured != eager or moved by "
              f"a hot-swap ({prog.captures} captures, {prog.replays} "
              "replays)")

        def replay():
            mono(ep, x)
            torch.cuda.synchronize()

        replay()
        rows["monolithic"]["captured_replay_ms"] = (
            _median_s(replay, ENGINE_REPS) * 1e3)
        graphs_ = lenet.to_layer_graphs(LENET_BATCH, act)
        ests = {m.value: estimate(account_model(graphs_, m, table), H100)
                for m in ExecutionMode}
        norm = normalized_edp(ests)
        for mode in ENGINE_MODES:
            e = ests[mode]
            rows[mode].update({"model_latency_us": e.latency_s * 1e6,
                               "model_energy_mj": e.energy_j * 1e3,
                               "model_norm_edp": norm[mode]})
        mono_lat = ests["monolithic"].latency_s
        claims = {
            "dma_latency_overhead_pct":
                100 * (ests["flexible_dma"].latency_s / mono_lat - 1),
            "sidebar_latency_overhead_pct":
                100 * (ests["sidebar"].latency_s / mono_lat - 1),
            "dma_edp": norm["flexible_dma"], "sidebar_edp": norm["sidebar"]}
        row = {"phase": 15, "part": "15a", "workload": "lenet",
               "activation": act, "batch": LENET_BATCH, "dtype": "float32",
               "tol": 1e-4, "modes": rows, "launches": counts,
               "monolithic_captured_equals_eager": same,
               "paper_claims_modelled": claims, "paper_claims": PAPER_CLAIMS,
               "spec": "H100 (src/repro_torch/core/constants.py)",
               "nvidia_smi": smi}
        emit(row)
        out["rows"][act] = row
    # the activation kernel at the shape of LeNet's first FLEXIBLE_DMA op
    out["kernel"] = engine_activation_row(
        torch.randn((LENET_BATCH * 6 * 28, 28), device="cuda"), "relu",
        "15a", torch.relu)
    return out


def engine_activation_row(x, act: str, part: str, library) -> dict:
    """The ``activation`` kernel on ``x`` (the rows the engine's
    FLEXIBLE_DMA op hands it) against its plain version, timed with its
    bound and one library call."""
    from repro_torch.kernels import activations as ak

    out = ak.activation_2d(x, act)
    ref = ak.activation_plain(x, act)
    err, r = rel_err(out, ref)
    check(r <= 1e-4, f"phase 15 {part} activation {act}: rel {r}")
    b_ms, b_by = bound(2 * 4 * x.numel(), x.numel(), torch.float32)
    row = {"phase": 15, "part": part, "op": "activation", "activation": act,
           "dtype": "float32", "shape": list(x.shape), "max_abs_err": err,
           "max_rel_err": r, "tol": 1e-4,
           "ms": cuda_ms(lambda: ak.activation_2d(x, act)),
           "plain_ms": cuda_ms(lambda: ak.activation_plain(x, act)),
           "library_ms": cuda_ms(lambda: library(x)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    return row


def mlp_layer_graph(name: str, m: int, d: int, f: int, act: str,
                    itemsize: int = 4):
    """``benchmarks/fusion_bench.py``'s ``_mlp_graph``: x (m, d) @ W1 (d,
    f), f, @ W2 (f, d)."""
    from repro_torch.core.modes import FlexibleOp, LayerGraph, StaticOp
    from repro_torch.kernels.ref import dot

    def mm(w, x):
        return dot(x, w, x.dtype)

    return LayerGraph(name=name, ops=(
        StaticOp("w1", mm, (m, f), flops=2 * m * d * f,
                 weight_bytes=d * f * itemsize),
        FlexibleOp(act, (m, f)),
        StaticOp("w2", mm, (m, d), flops=2 * m * f * d,
                 weight_bytes=f * d * itemsize),
    ), in_shape=(m, d), itemsize=itemsize)


def engine_mlp(smi: str, mlp_row: dict | None) -> dict:
    """15b: the MLP task at nemotron-4-15b's widths (d 6144, f 24576,
    squared_relu, fp32) at 4 and 64 rows through ``engine.run`` under the
    four modes, each within 1e-4 relative of MONOLITHIC, beside phase 1's
    fused ``sidebar_mlp`` (bf16, 4 rows)."""
    from repro_torch.core import (ExecutionMode, account, estimate,
                                  make_default_table, normalized_edp)
    from repro_torch.core.constants import H100

    table = make_default_table()
    g = torch.Generator(device="cuda").manual_seed(15)
    params = {"w1": torch.randn((D_MODEL, D_FF), generator=g,
                                device="cuda") / D_MODEL ** 0.5,
              "w2": torch.randn((D_FF, D_MODEL), generator=g,
                                device="cuda") / D_FF ** 0.5}
    out = {"launches": 0, "rows": {}}
    for m in (4, 64):
        graph = mlp_layer_graph(f"mlp{m}", m, D_MODEL, D_FF, "squared_relu")
        x = torch.randn((m, D_MODEL), generator=g, device="cuda")
        rows, counts = _engine_modes(graph, params, x, table, None,
                                     tol=1e-4, rel=True, what=f"15b m={m}",
                                     cpu_check=False)
        check(counts["activation"] == 1 and sum(counts.values()) == 1,
              f"phase 15b m={m}: launches {counts}, want 1 activation")
        out["launches"] += counts["activation"]
        ests = {md.value: estimate(account(graph, md, table), H100)
                for md in ExecutionMode}
        norm = normalized_edp(ests)
        for mode in ENGINE_MODES:
            rows[mode].update({
                "model_latency_us": ests[mode].latency_s * 1e6,
                "model_norm_edp": norm[mode]})
        slowest = max(ENGINE_MODES, key=lambda k: rows[k]["wall_ms"])
        row = {"phase": 15, "part": "15b", "workload": "nemotron-4-15b mlp",
               "rows": m, "d_model": D_MODEL, "d_ff": D_FF,
               "dtype": "float32", "tol_rel": 1e-4, "modes": rows,
               "slowest_mode": slowest, "launches": counts,
               "phase1_sidebar_mlp_ms_bf16_4_rows":
                   None if mlp_row is None else mlp_row["ms"],
               "nvidia_smi": smi}
        emit(row)
        out["rows"][m] = row
        if m == 64:
            out["kernel"] = engine_activation_row(
                x.new_empty((m, D_FF)).normal_(generator=g), "squared_relu",
                "15b", lambda t: torch.square(torch.relu(t)))
    return out


def planner_serves(cfg, params, arm_tokens: dict, smi: str) -> dict:
    """15c: ``AutoPolicy`` on the H100 spec plans one MLP layer graph a
    layer (named "0".."L-1", decode's 4 rows, bf16); phase 2's traffic is
    served on phase 2's weights with ``plan=`` that plan. Every request
    finishes, exact launch counts (``serve``), every MLP dispatch on its
    layer's planned route, and the tokens equal those of the earlier arm
    that served the same kernels (phase 2's SIDEBAR, or phase 5's)."""
    from repro_torch.core.constants import H100
    from repro_torch.core.modes import ExecutionMode as M
    from repro_torch.core.modes import LayerPlan
    from repro_torch.core.policy import AutoPolicy

    t0 = time.perf_counter()
    graphs_ = [mlp_layer_graph(str(i), 4, cfg.d_model, cfg.d_ff,
                               cfg.activation, itemsize=2)
               for i in range(cfg.num_layers)]
    result = AutoPolicy(chip=H100).plan(graphs_)
    plan_s = time.perf_counter() - t0
    plan, diag = result.plan, result.diagnostics
    by_plan = collections.Counter(
        (lp.mode.value, lp.depth, lp.fuse) for lp in plan.layers.values())
    emit({"phase": 15, "part": "15c_plan", "layers": cfg.num_layers,
          "default": [plan.default.mode.value, plan.default.depth,
                      plan.default.fuse],
          "layer_plans": {f"{k[0]}/d{k[1]}/fuse{k[2]}": v
                          for k, v in by_plan.items()},
          "fallbacks": list(diag.fallbacks),
          "edp_layer0": diag.edp["0"], "edp_sum": sum(diag.edp.values()),
          "depth_sweep_layer0": diag.depth_sweep.get("0", {}),
          "sidebar_capacity": H100.vmem_bytes // 2, "plan_host_s": plan_s})
    prompts = traffic(2, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    recs: list = []
    row, tokens = serve(cfg, params, prompts, 32, phase=15, mode="planned",
                        plan=plan, records=recs, **FULL_SERVER)
    mlp = [r for r in recs if r.op == "sidebar_mlp"]
    off = [(r.layer, r.mode.value, r.depth) for r in mlp
           if r.mode is not plan.for_layer(r.layer).mode
           or (r.mode is M.SIDEBAR_PIPELINED
               and r.depth != plan.for_layer(r.layer).depth)
           or not r.used_kernel]
    check(bool(mlp) and not off,
          f"phase 15c: MLP dispatches off the plan: {off[:4]}")
    # the arm that served the same kernels: any mix of the fused modes
    # gives SIDEBAR's tokens (the ring is the serial kernel's partition at
    # every depth); a uniform plan has its phase 5 arm
    arms = {LayerPlan(M.SIDEBAR_PIPELINED, 2): "sidebar_pipelined_d2",
            LayerPlan(M.FLEXIBLE_DMA, 1): "flexible_dma",
            LayerPlan(M.SIDEBAR, 1): "sidebar"}
    same = {}
    if plan.is_uniform and arms.get(plan.default) in arm_tokens:
        same[arms[plan.default]] = arm_tokens[arms[plan.default]]
    if all(lp.mode is not M.FLEXIBLE_DMA for lp in plan.layers.values()):
        same["sidebar"] = arm_tokens["sidebar"]
    equal = {arm: sum(int((a == b).sum()) for a, b in zip(tokens, want))
             for arm, want in same.items()}
    n = sum(t.size for t in tokens)
    emit({"phase": 15, "part": "15c", "tokens_per_s": row["tokens_per_s"],
          "launches": row["launches"], "mlp_dispatches": len(mlp),
          "greedy_tokens_equal": equal, "of": n, "nvidia_smi": smi})
    check(all(v == n for v in equal.values()),
          f"phase 15c: planned tokens differ from {equal} of {n}")
    return row


def engine_kernel_rows(engine15: dict, planned: dict, rows: dict,
                       sources: dict) -> list:
    """Phase 15's rows of the kernel line: the ``activation`` kernel on
    the engine's FLEXIBLE_DMA path (15a LeNet, 15b the MLP task; launches
    from their counted passes, times at their shapes), and each kernel
    the planner's plan served in 15c (launches from its drain, times
    from phase 1 at the same decode shapes)."""
    out = []
    for part, path in (("15a", "engine FLEXIBLE_DMA, LeNet batch 256"),
                       ("15b", "engine FLEXIBLE_DMA, nemotron MLP task")):
        r = engine15[part]["kernel"]
        out.append({
            "name": "activation", "route": "cuda",
            "source": f"src/repro_torch/csrc/{sources['activation'][0]}",
            "replaces": sources["activation"][1],
            "path": f"phase {part}: {path}",
            "launches": engine15[part]["launches"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, n in planned["launches"].items():
        if not n:
            continue
        r = rows[name]
        src, replaces = sources[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{src}", "replaces": replaces,
            "path": "phase 15c: the planner's plan served", "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases",
                    default="0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15",
                    help="comma-separated subset of phases to run")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth of the full-width phases 2, 5, "
                         "9, 13, 14 and 15")
    ap.add_argument("--stage-capture-after", type=int, default=None,
                    help="the paged servers' stage_capture_after (default: "
                         "the server's own)")
    args = ap.parse_args()
    if args.stage_capture_after is not None:
        FULL_SERVER["stage_capture_after"] = args.stage_capture_after
    phases = {int(p) for p in args.phases.split(",")}
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # every kernel, and a mish variant of each one that takes an
    # activation: one nvcc per library, all at once
    build_s = build.build_all(
        [(n, None) for n in build.SOURCES]
        + [(n, MISH_EXPR) for n in build.ACTIVATION_KERNELS])
    # ptxas: registers, shared memory and spills of every kernel entry
    ptxas = {k: [ln.strip() for ln in v.splitlines()
                 if ("registers" in ln or "spill" in ln)
                 and "(C7519)" not in ln]
             for k, v in build.build_log.items()}
    # ptxas notes where it had to fence registers shared with wgmma, and
    # where it serialised a kernel's wgmma (divergent code around them)
    gmma_fences = {k: v.count("(C7519)") for k, v in build.build_log.items()
                   if "(C7519)" in v}
    gmma_serial = {k: v.count("(C7518)") + v.count("(C7520)")
                   for k, v in build.build_log.items()
                   if "(C7518)" in v or "(C7520)" in v}
    emit({"phase": 0, "nvidia_smi": smi, "build_s": build_s,
          "ptxas": ptxas, "ptxas_gmma_register_fences": gmma_fences,
          "ptxas_gmma_serialized": gmma_serial,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    rows = {}
    if 1 in phases:
        rows["sidebar_mlp"] = mlp_ops()
        rows["paged_gqa"] = paged_ops()
        rows["sidebar_mlp_pipelined"] = pipelined_ops()
        rows["sidebar_matmul"] = matmul_ops()
        rows["activation"] = activation_ops()
        dma_chain_ops()
        rows["sidebar_gated_mlp"] = gated_ops()
        rows["paged_mla"] = mla_ops()
        rows["flash_attention"] = flash_ops()
        rows["moe_grouped_mm"] = moe_ops()
        moe_pass_ops()
        user_activation_ops()
        autograd_refusals()
    served = {}
    params = None
    engine15 = {}
    if phases & {2, 5, 9, 13, 14, 15}:
        cfg, params, init_s = full_width_params(args.layers)
        row, tokens = full_width(2, cfg, params, init_s)
        served["sidebar"] = row
        arm_tokens = {"sidebar": tokens}
        if 5 in phases:
            served.update(plan_modes(cfg, params, tokens, arm_tokens))
        if 9 in phases:
            phase9_server(cfg, params)
            phase9_slots(cfg, params)
            phase9_paged(cfg, params)
        side = shallow_draft(cfg, params, min(SIDE_LAYERS, cfg.num_layers))
        if 13 in phases:
            t13 = time.perf_counter()
            ctx = phase13_server(*side, smi)
            t13a = time.perf_counter()
            overload_fleet(*side, ctx, smi)
            t13c = time.perf_counter()
            overload_families()
            emit({"phase": 13, "host_s": {
                "13a": t13a - t13, "13c": t13c - t13a,
                "13b": time.perf_counter() - t13c}})
            torch.cuda.empty_cache()
        if 14 in phases:
            t14 = time.perf_counter()
            spec_serving(*side, smi)
            t14a = time.perf_counter()
            spec_captured_vs_eager(*side, smi)
            t14e = time.perf_counter()
            spec_families()
            t14b = time.perf_counter()
            rag_serving(*side, smi)
            t14c = time.perf_counter()
            rag_families()
            emit({"phase": 14, "host_s": {
                "14a": t14a - t14, "captured_vs_eager": t14e - t14a,
                "14b": t14b - t14e, "14c": t14c - t14b,
                "14c_smoke": time.perf_counter() - t14c}})
            torch.cuda.empty_cache()
        if 15 in phases:
            t15 = time.perf_counter()
            chip_probe()
            engine15["15a"] = engine_lenet(smi)
            t15a = time.perf_counter()
            engine15["15b"] = engine_mlp(smi, rows.get("sidebar_mlp"))
            t15b = time.perf_counter()
            served["planned"] = planner_serves(cfg, params, arm_tokens, smi)
            emit({"phase": 15, "host_s": {
                "probe_and_15a": t15a - t15, "15b": t15b - t15a,
                "15c": time.perf_counter() - t15b}})
            torch.cuda.empty_cache()
        if 8 not in phases or cfg.num_layers != D_LAYERS:
            params = None
            torch.cuda.empty_cache()
    if 8 in phases:
        # phase 2's 32-layer weights when it ran at full depth
        if params is None:
            cfg, params, _ = full_width_params(None)
        served["train_8a"] = train_forward_full(cfg, params)
        params = None
        torch.cuda.empty_cache()
        train_steps_full()
        trainer_resume()
    if 3 in phases:
        cfg, params, init_s = full_width_params(4, int8=True)
        full_width(3, cfg, params, init_s)
        del params
        torch.cuda.empty_cache()
    if 4 in phases:
        for arch in ("nemotron-4-15b", "deepseek-7b", "deepseek-v3-671b",
                     "qwen3-14b", "llama3-405b", "llama4-scout-17b-a16e"):
            smoke_routes(arch)
    if 6 in phases:
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = full_width_params(None, arch="deepseek-7b")
        served["deepseek_7b"], _ = full_width(6, cfg, params, init_s)
        del params
        torch.cuda.empty_cache()
    if 7 in phases:
        # deepseek-v3-671b at full width, cut to its 3 dense + 2 MoE
        # layers (all 256 experts): FULL's 61 layers do not fit one card
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = full_width_params(5, arch="deepseek-v3-671b")
        served["deepseek_v3"], _ = full_width(7, cfg, params, init_s,
                                              seed=6)
        eager_then_captured(7, cfg, params, seed=6)
        del params
        torch.cuda.empty_cache()
    # the three configs of this slice at full width: qwen3-14b at full
    # depth (40 layers, ~28 GB), llama3-405b with its int8 KV pool cut to
    # 8 of 126 layers (~55 GB: one layer is ~6.4 GB, the table 4.2 GB),
    # llama4-scout cut to 8 of 48 layers (~37 GB), on phase 2's traffic
    # mix drawn from the phase's own seed
    for phase, arch, layers in ((10, "qwen3-14b", None),
                                (11, "llama3-405b", 8),
                                (12, "llama4-scout-17b-a16e", 8)):
        if phase not in phases:
            continue
        torch.cuda.reset_peak_memory_stats()
        cfg, params, init_s = full_width_params(layers, arch=arch)
        served[arch], _ = full_width(phase, cfg, params, init_s)
        if cfg.num_experts:
            eager_then_captured(phase, cfg, params, seed=phase)
        del params
        torch.cuda.empty_cache()
    # launches: the drain of the main path (phase 2), of the mode (phase
    # 5) or of the model (phases 6, 7 and 12) that runs the kernel
    run_of = {"sidebar_mlp": "sidebar", "paged_gqa": "sidebar",
              "sidebar_mlp_pipelined": "sidebar_pipelined_d2",
              "sidebar_matmul": "flexible_dma",
              "activation": "flexible_dma",
              "sidebar_gated_mlp": "deepseek_7b",
              "paged_mla": "deepseek_v3",
              "flash_attention": "train_8a",
              "moe_grouped_mm": "llama4-scout-17b-a16e"}
    if set(run_of.values()) <= set(served) and len(rows) == len(KERNELS):
        sources = {
            "sidebar_mlp": ("sidebar_mlp.cu",
                            "src/repro/kernels/sidebar_mlp.py:171"),
            "paged_gqa": ("paged_gqa.cu",
                          "src/repro/kernels/paged_attention.py:218"),
            "sidebar_mlp_pipelined": (
                "sidebar_mlp_pipelined.cu",
                "src/repro/kernels/sidebar_mlp.py:227"),
            "sidebar_matmul": ("sidebar_matmul.cu",
                               "src/repro/kernels/sidebar_matmul.py:71"),
            "activation": ("activation.cu",
                           "src/repro/kernels/activations.py:127"),
            "sidebar_gated_mlp": (
                "sidebar_gated_mlp.cu",
                "src/repro/kernels/sidebar_gated_mlp.py:87"),
            "paged_mla": ("paged_mla.cu",
                          "src/repro/kernels/paged_attention.py:336"),
            "flash_attention": ("flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:97"),
            "moe_grouped_mm": ("moe_experts.cu",
                               "src/repro/models/moe.py:65"),
        }
        kernels = []
        for name in KERNELS:
            r = rows[name]
            src, replaces = sources[name]
            kernels.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/csrc/{src}",
                "replaces": replaces,
                "launches": served[run_of[name]]["launches"][name],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if engine15:
            kernels += engine_kernel_rows(engine15, served["planned"], rows,
                                          sources)
        emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
