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
     bf16, fp and int8 KV (paged decode at group 6 and at group 1; MLA
     absorbed decode at 128 heads, kvr 512) — with the kernel's time,
     the plain version's time, the bound of the work and the time of one
     PyTorch call of the same function where there is one; the ring MLP
     at depths 1-4, bitwise equal across depths; and the run-time
     activation check: mish registered with a ``device_expr`` on a fresh
     function table, through all five wrappers that take an activation,
     and an entry without one refused;
  2. nemotron-4-15b at full width (bf16 weights from a seed) served by
     ``PagedContinuousBatchingServer(kernel="paged")`` with the kernels
     on under the default SIDEBAR plan: 8 requests, half sharing a
     128-token prefix, 32 greedy tokens each; launch counts are reset
     before and read after the run;
  5. the same weights and traffic under the paper's other execution
     modes — SIDEBAR_PIPELINED at depth 2, a per-layer plan of depths 2
     and 4, and FLEXIBLE_DMA — with exact launch counts per mode and a
     summary line of tokens/s per mode;
  3. the same widths with int8 KV (depth cut to 4 layers);
  4. the fp32 smoke configs of nemotron-4-15b, deepseek-7b and
     deepseek-v3-671b (no-drop capacity) on the card: ``kernel="paged"``
     against ``kernel="slab"``, and the SIDEBAR_PIPELINED, FLEXIBLE_DMA
     and a mixed per-layer plan against SIDEBAR, on the same traffic,
     compared by tokens and logits;
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
     MLP through the gated kernel, exact launch counts, no
     ``gather_blocks``, tokens/s, TTFT and peak memory.

The line before the last holds the kernel table, the last line
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package ``repro``.
"""

from __future__ import annotations

import argparse
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
# (bf16 on the tensor cores; fp32 outside them, for elementwise work)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# torch.cuda._sleep spins for a count of SM clock cycles (H100 SXM:
# 1.98 GHz at most; a lower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 1.98e9
D_MODEL, D_FF = 6144, 24576           # nemotron-4-15b
DS_MODEL, DS_FF = 4096, 11008         # deepseek-7b
V3_MODEL, V3_FF = 7168, 18432         # deepseek-v3-671b's dense layers
KERNELS = ("sidebar_mlp", "paged_gqa", "sidebar_mlp_pipelined",
           "sidebar_matmul", "activation", "sidebar_gated_mlp", "paged_mla")
# the run-time activation of phase 0's variant builds and phase 1's check
MISH_EXPR = "x * tanhf(log1pf(expf(x)))"


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
    # nemotron-4-15b widths in bf16, decode (4 rows) and a staging round
    # (64 rows); against the plain version run in fp32 on the same
    # values: 2e-2 relative covers bf16 rounding of f(h) and the output
    d, f = 6144, 24576
    w1 = (torch.randn(d, f, generator=g, device=dev) / d ** 0.5).bfloat16()
    w2 = (torch.randn(f, d, generator=g, device=dev) / f ** 0.5).bfloat16()
    main = None
    for m in (4, 64):
        x = torch.randn(m, d, generator=g, device=dev).bfloat16()
        out = sm.sidebar_mlp(x, w1, w2, "squared_relu")
        torch.cuda.synchronize()
        ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                                   "squared_relu")
        err, rel = rel_err(out, ref)
        check(rel <= 2e-2, f"sidebar_mlp bf16 m={m}: rel {rel}")
        ms = cuda_ms(lambda: sm.sidebar_mlp(x, w1, w2, "squared_relu"))
        plain_ms = cuda_ms(
            lambda: sm.sidebar_mlp_plain(x, w1, w2, "squared_relu"))
        lib_ms = cuda_ms(
            lambda: (torch.relu(x @ w1) ** 2).to(torch.bfloat16) @ w2)
        nbytes = 2 * (x.numel() + w1.numel() + w2.numel() + m * d)
        b_ms, b_by = bound(nbytes, 2 * 2 * m * d * f, torch.bfloat16)
        row = {"phase": 1, "op": "sidebar_mlp", "dtype": "bfloat16",
               "shape": [m, d, f], "max_abs_err": err, "max_rel_err": rel,
               "tol": 2e-2, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if m == 4:
            main = row
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
    # smoke widths in fp32 (and int8 KV): tolerance 1e-4 relative — the
    # kernel's online softmax against the plain two-pass softmax
    for dh, bs, group in ((16, 8, 4), (8, 8, 4), (16, 8, 1)):
        for kvdt in (torch.float32, torch.int8):
            probs, t, ln, scale = _pool_problem(
                g, b=3, hkv=2, group=group, dh=dh, bs=bs, nb=4,
                lengths=[5, 16, 32], qdtype=torch.float32, kvdtype=kvdt)
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
          "groups": [4, 1], "max_rel_err": worst, "tol": 1e-4})
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
            ("deepseek-7b", 32, 1, torch.int8)):
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
        row = {"phase": 1, "op": "paged_gqa", "arch": arch,
               "heads": [hkv * group, hkv], "group": group,
               "kv_dtype": str(kvdt).replace("torch.", ""),
               "lengths": lengths, "max_abs_err": err, "max_rel_err": rel,
               "tol": 2e-2, "ms": ms, "plain_ms": plain_ms,
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
          "shapes": shapes, "max_rel_err": worst, "tol": 1e-4})
    # the DMA route's two products at full width, bf16, decode (4 rows)
    # and a staging round (64 rows); against the plain version in fp32
    # on the same values (2e-2 relative: bf16 rounding of the output)
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
            k, n = b.shape
            b_ms, b_by = bound(2 * (a.numel() + b.numel() + m * n),
                               2 * m * k * n, torch.bfloat16)
            row = {"phase": 1, "op": "sidebar_matmul", "dtype": "bfloat16",
                   "role": role, "shape": [m, k, n],
                   "k_range": smm.k_range(m, k, n, True),
                   "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
                   "ms": cuda_ms(lambda: smm.sidebar_matmul(a, b)),
                   "plain_ms": cuda_ms(
                       lambda: smm.sidebar_matmul_plain(a, b)),
                   "library_ms": cuda_ms(lambda: torch.matmul(a, b)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            rows.append(row)
        if m == 4:
            # one decode-step MLP's pair of products, summed
            pair = {key: rows[0][key] + rows[1][key]
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
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
               "tol": 2e-2,
               "ms": cuda_ms(lambda: ak.activation_2d(x, "squared_relu")),
               "plain_ms": cuda_ms(
                   lambda: ak.activation_plain(x, "squared_relu")),
               "library_ms": cuda_ms(lambda: torch.square(torch.relu(x))),
               "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if m == 4:
            main = row
    return main


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
    w1, w2 = full_weights(g)
    main = None
    for m in (4, 64):
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
        row = {"phase": 1, "op": "sidebar_mlp_pipelined",
               "dtype": "bfloat16", "shape": [m, D_MODEL, D_FF],
               "f_range": sm.f_range_pipelined(m, D_FF),
               "smem_bytes": {t: sm.pipelined_smem_bytes(
                   m, D_FF, t, torch.bfloat16) for t in depths},
               "bitwise_equal_across_depths": True,
               "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
               "ms_by_depth": per_depth, "ms": per_depth[2],
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
    """sidebar_gated_mlp: every MLP launch of deepseek-7b."""
    from repro_torch.kernels import sidebar_gated_mlp as sg

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
    # deepseek-7b widths in bf16, decode (4 rows) and a staging round (64
    # rows), against the plain version run in fp32 on the same values:
    # 2e-2 relative covers bf16 rounding of h and the output
    # (and deepseek-v3-671b's dense layers, 7168 x 18432)
    silu = torch.nn.functional.silu
    main = None
    for arch, d, f in (("deepseek-7b", DS_MODEL, DS_FF),
                       ("deepseek-v3-671b", V3_MODEL, V3_FF)):
        wg, wu = ((torch.randn(d, f, generator=g, device=dev) / d ** 0.5
                   ).bfloat16() for _ in range(2))
        wd = (torch.randn(f, d, generator=g, device=dev) / f ** 0.5
              ).bfloat16()
        for m in (4, 64):
            x = torch.randn(m, d, generator=g, device=dev).bfloat16()
            out = sg.sidebar_gated_mlp(x, wg, wu, wd, "silu")
            torch.cuda.synchronize()
            ref = sg.sidebar_gated_mlp_plain(x.float(), wg.float(),
                                             wu.float(), wd.float(), "silu")
            err, rel = rel_err(out, ref)
            check(rel <= 2e-2, f"sidebar_gated_mlp bf16 {arch} m={m}: "
                               f"rel {rel}")
            nbytes = 2 * (x.numel() + wg.numel() + wu.numel() + wd.numel()
                          + m * d)
            b_ms, b_by = bound(nbytes, 3 * 2 * m * d * f, torch.bfloat16)
            row = {"phase": 1, "op": "sidebar_gated_mlp", "arch": arch,
                   "dtype": "bfloat16", "shape": [m, d, f],
                   "f_range": sg.f_range(m, f),
                   "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
                   "ms": cuda_ms(lambda: sg.sidebar_gated_mlp(
                       x, wg, wu, wd, "silu")),
                   "plain_ms": cuda_ms(lambda: sg.sidebar_gated_mlp_plain(
                       x, wg, wu, wd, "silu")),
                   "library_ms": cuda_ms(
                       lambda: torch.matmul(silu(torch.matmul(x, wg))
                                            * torch.matmul(x, wu), wd)),
                   "bound_ms": b_ms, "bound_by": b_by}
            emit(row)
            if m == 4 and main is None:
                main = row
        del wg, wu, wd, out, ref
        torch.cuda.empty_cache()
    return main


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
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = 0.0
    # smoke widths in fp32 (H 4, kvr 32, rope 8, block 8): 1e-4 relative,
    # the kernel's online softmax against the plain two-pass one
    for b, nb, lengths in ((3, 4, [5, 16, 32]), (4, 4, [1, 9, 30, 2]),
                           (3, 6, [48, 17, 8])):
        probs, t, ln = _mla_problem(g, b=b, h=4, kvr=32, rope=8, bs=8,
                                    nb=nb, lengths=lengths,
                                    dtype=torch.float32)
        ql, qr, ckv, kr = probs[0]
        scale = (16 + 8) ** -0.5
        out = pa.paged_mla(ql, qr, ckv, kr, t, ln, scale=scale)
        torch.cuda.synchronize()
        ref = pa.paged_mla_reference(ql, qr, ckv, kr, t, ln, scale=scale)
        _, rel = rel_err(out, ref)
        check(out.shape == ref.shape and rel <= 1e-4,
              f"paged_mla fp32 lengths={lengths}: rel {rel}")
        worst = max(worst, rel)
    emit({"phase": 1, "op": "paged_mla", "dtype": "float32",
          "heads": 4, "kv_lora_rank": 32, "rope_head_dim": 8,
          "max_rel_err": worst, "tol": 1e-4})
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
    out = pa.paged_mla(ql, qr, ckv, kr, t, ln, scale=scale)
    torch.cuda.synchronize()
    ref = pa.paged_mla_reference(ql, qr, ckv, kr, t, ln, scale=scale)
    err, rel = rel_err(out, ref)
    check(rel <= 2e-2, f"paged_mla bf16: rel {rel}")
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
    b_ms, b_by = bound(nbytes, ops, torch.float32)
    row = {"phase": 1, "op": "paged_mla", "arch": "deepseek-v3-671b",
           "heads": h, "kv_lora_rank": kvr, "rope_head_dim": rope,
           "block": bs, "pool_dtype": "bfloat16", "lengths": lengths,
           "max_abs_err": err, "max_rel_err": rel, "tol": 2e-2,
           "ms": cuda_ms(run(pa.paged_mla), iters=64),
           "plain_ms": cuda_ms(run(pa.paged_mla_reference), iters=64),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bytes": nbytes, "flops": ops}
    emit(row)
    return row


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
    check(all((n, MISH_EXPR) in build._loaded for n in wrappers),
          "run-time activation: a wrapper did not load its mish library")
    emit({"phase": 1, "op": "run_time_activation", "name": "mish",
          "device_expr": MISH_EXPR, "max_rel_err": worst,
          "tol": {"float32": 1e-4, "bfloat16": 2e-2},
          "libraries": sorted(build._lib_path(n, MISH_EXPR).name
                              for n in wrappers),
          "entry_without_device_expr": "refused by every wrapper"})


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
    route; the gated kernel under every plan for a gated MLP; a MoE
    layer's experts are plain products, no kernel), and per layer and
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
            continue
        if cfg.gated_mlp:
            want["sidebar_gated_mlp"] += calls
        elif lp.mode is M.FLEXIBLE_DMA:
            want["sidebar_matmul"] += 2 * calls
            want["activation"] += calls
        elif lp.mode is M.SIDEBAR_PIPELINED:
            want["sidebar_mlp_pipelined"] += calls
        else:
            want["sidebar_mlp"] += calls
    return want


def serve(cfg, params, prompts, gen: int, *, phase: int, mode: str,
          plan=None, **kw) -> tuple[dict, list]:
    """Drive the paged server once under ``plan`` with fresh launch
    counts; returns its JSON row and the generated tokens by rid."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    srv = PagedContinuousBatchingServer(cfg, params, plan=plan, **kw)
    calls = {"decode": 0, "prefill": 0}
    step, pre = srv._serve_step, srv._prefill_step

    def counted_step(*a, **k):
        calls["decode"] += 1
        return step(*a, **k)

    def counted_prefill(*a, **k):
        calls["prefill"] += 1
        return pre(*a, **k)

    srv._serve_step, srv._prefill_step = counted_step, counted_prefill
    recs: list = []
    torch.cuda.synchronize()
    kops.reset_launch_counts()
    t0 = time.perf_counter()
    with kops.record_dispatches(recs):
        for p in prompts:
            srv.submit(p, gen)
        done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kops.launch_counts()
    ops = {r.op for r in recs}
    n_tok = sum(r.generated for r in done)
    toks = np.concatenate([r.tokens for r in done])
    st = srv.stats
    L = cfg.num_layers
    want = expected_launches(srv.plan, cfg, calls["decode"],
                             calls["prefill"])
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
        "launches": counts, "expected_launches": want,
        "gather_blocks": sum(r.op == "gather_blocks" for r in recs),
        "scatter_blocks": sum(r.op == "scatter_blocks" for r in recs),
    }
    emit(row)
    check(len(done) == len(prompts) and all(r.generated == gen
                                            for r in done),
          f"phase {phase} {mode}: not every request finished")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"phase {phase} {mode}: token out of vocab")
    check(st.prefix_block_hits > 0, f"phase {phase} {mode}: no prefix hits")
    check(counts == want, f"phase {phase} {mode}: launches {counts} != "
                          f"expected {want}")
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


def plan_modes(cfg, params, sidebar_tokens: list) -> dict:
    """Phase 5: phase 2's weights and traffic under the paper's execution
    modes. The drains run in the order S P L D D L P S, so every mode has
    one early and one late run (host-side time drifts between drains);
    each run's exact launch counts are checked. Greedy tokens equal to
    phase 2's SIDEBAR run are counted and reported (bf16 routes round
    differently: not gated)."""
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
        row, tokens = serve(cfg, params, prompts, 32, phase=5, mode=mode,
                            plan=plans[mode], **FULL_SERVER)
        same = sum(int((a == b).sum())
                   for a, b in zip(tokens, sidebar_tokens))
        runs[mode].append((row, same))
    for mode, rr in runs.items():
        tps = [r["tokens_per_s"] for r, _ in rr]
        emit({"phase": 5, "mode": mode, "tokens_per_s": tps,
              "tokens_per_s_mean": sum(tps) / len(tps),
              "ttft_s_median": [r["ttft_s_median"] for r, _ in rr],
              "launches": rr[0][0]["launches"],
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
    # the first run of each mode other than SIDEBAR (phase 2 is its row)
    return {mode: rr[0][0] for mode, rr in runs.items() if mode != "sidebar"}


def _capture(cfg, params, prompts, gen: int, **kw) -> tuple[list, list]:
    """Serve ``prompts`` recording every decode step's logits; returns
    (logits per step, tokens per request)."""
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.models import layers as L

    srv = PagedContinuousBatchingServer(cfg, params, device="cuda",
                                        num_slots=3, max_len=64,
                                        block_size=8, segment=4, **kw)
    seen = []

    def step(p, tok, cache, pos, block_tables=None):
        logits, cache = srv.api.decode_step(p, cfg, tok, cache, pos,
                                            block_tables=block_tables)
        logits = L.mask_pad_logits(logits, cfg.vocab_size)[:, -1]
        seen.append(logits.clone())
        return torch.argmax(logits, -1).to(torch.int32)[:, None], cache

    srv._serve_step = step
    for p in prompts:
        srv.submit(p, gen)
    return seen, [r.tokens for r in srv.run()]


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
    la, ta = _capture(cfg, params, prompts, 12, kernel="paged")
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
        lb, tb = _capture(cfg, params, prompts, 12, **kw)
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
            check(counts["sidebar_gated_mlp"] > 0
                  and (counts[attn] > 0) == (
                      name in ("sidebar_pipelined_d2",
                               "mixed_dma_pipelined_d3")),
                  f"phase 4: {cfg.arch_id} {name} launched {counts}")
        elif name != "slab":
            mlp = ["sidebar_mlp_pipelined", "sidebar_matmul", "activation"]
            check(any(counts[k] for k in mlp),
                  f"phase 4: {name} launched none of {mlp}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4,5,6,7",
                    help="comma-separated subset of phases to run")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth of the full-width phases 2 and 5")
    args = ap.parse_args()
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
                 if "registers" in ln or "spill" in ln]
             for k, v in build.build_log.items()}
    emit({"phase": 0, "nvidia_smi": smi, "build_s": build_s,
          "ptxas": ptxas,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    rows = {}
    if 1 in phases:
        rows["sidebar_mlp"] = mlp_ops()
        rows["paged_gqa"] = paged_ops()
        rows["sidebar_mlp_pipelined"] = pipelined_ops()
        rows["sidebar_matmul"] = matmul_ops()
        rows["activation"] = activation_ops()
        rows["sidebar_gated_mlp"] = gated_ops()
        rows["paged_mla"] = mla_ops()
        user_activation_ops()
    served = {}
    if phases & {2, 5}:
        cfg, params, init_s = full_width_params(args.layers)
        row, tokens = full_width(2, cfg, params, init_s)
        served["sidebar"] = row
        if 5 in phases:
            served.update(plan_modes(cfg, params, tokens))
        del params
        torch.cuda.empty_cache()
    if 3 in phases:
        cfg, params, init_s = full_width_params(4, int8=True)
        full_width(3, cfg, params, init_s)
        del params
        torch.cuda.empty_cache()
    if 4 in phases:
        smoke_routes("nemotron-4-15b")
        smoke_routes("deepseek-7b")
        smoke_routes("deepseek-v3-671b")
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
        del params
        torch.cuda.empty_cache()
    if len(served) == 6 and len(rows) == len(KERNELS):
        # launches: the drain of the main path (phase 2), of the mode
        # (phase 5) or of the model (phase 6) that runs the kernel
        run_of = {"sidebar_mlp": "sidebar", "paged_gqa": "sidebar",
                  "sidebar_mlp_pipelined": "sidebar_pipelined_d2",
                  "sidebar_matmul": "flexible_dma",
                  "activation": "flexible_dma",
                  "sidebar_gated_mlp": "deepseek_7b",
                  "paged_mla": "deepseek_v3"}
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
        emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
