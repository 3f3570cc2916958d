"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints one JSON object on its own line; any failure exits
non-zero):

  0. the card (``nvidia-smi`` name and power limit) and the build of
     every CUDA kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
     source, started together);
  1. op level: each kernel against its plain PyTorch version on the
     card — smoke shapes in fp32 (ragged rows, ragged lengths,
     duplicate table entries, scratch-padded tails, several
     activations) and nemotron-4-15b shapes in bf16, fp and int8 KV —
     with the kernel's time, the plain version's time, the bound of the
     work and, for the MLP, the time of the same function as PyTorch
     calls;
  2. nemotron-4-15b at full width (bf16 weights from a seed) served by
     ``PagedContinuousBatchingServer(kernel="paged")`` with the kernels
     on: 8 requests, half sharing a 128-token prefix, 32 greedy tokens
     each; launch counts are reset before and read after the run;
  3. the same widths with int8 KV (depth cut to 4 layers);
  4. the fp32 smoke config on the card, ``kernel="paged"`` against
     ``kernel="slab"`` on the same traffic, compared by logits.

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
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
    for dh, bs, group in ((16, 8, 4), (8, 8, 4)):
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
            check(rel <= 1e-4, f"paged_gqa fp32 dh={dh} {kvdt}: rel {rel}")
            worst = max(worst, rel)
    emit({"phase": 1, "op": "paged_gqa", "dtype": "float32",
          "max_rel_err": worst, "tol": 1e-4})
    # nemotron-4-15b widths: 4 rows, 48 query / 8 KV heads, head_dim 128,
    # block 16, lengths up to 256; bf16 out against a plain run on the
    # same values (2e-2 relative: bf16 rounding of p and the output).
    # Twelve copies of the problem cycle so the 50 MB L2 starts cold, as
    # it does after a layer's MLP has streamed its weights through.
    main = None
    lengths = [256, 241, 200, 129]
    for kvdt in (torch.bfloat16, torch.int8):
        probs, t, ln, scale = _pool_problem(
            g, b=4, hkv=8, group=6, dh=128, bs=16, nb=16, lengths=lengths,
            qdtype=torch.bfloat16, kvdtype=kvdt, copies=12)
        q, k, v, ks, vs = probs[0]
        out = pa.paged_gqa(q, k, v, t, ln, scale=scale, k_scale=ks,
                           v_scale=vs)
        torch.cuda.synchronize()
        ref = pa.paged_gqa_reference(q, k, v, t, ln, scale=scale,
                                     k_scale=ks, v_scale=vs)
        err, rel = rel_err(out, ref)
        check(rel <= 2e-2, f"paged_gqa bf16 {kvdt}: rel {rel}")
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
        nbytes = (2 * live * 8 * 128 * kv_item          # K and V read once
                  + (2 * live * 8 * 4 if kvdt == torch.int8 else 0)
                  + 2 * 2 * q.numel() + 4 * t.numel() + 4 * 4)
        b_ms, b_by = bound(nbytes, 4 * live * 48 * 128, torch.bfloat16)
        row = {"phase": 1, "op": "paged_gqa",
               "kv_dtype": str(kvdt).replace("torch.", ""),
               "lengths": lengths, "max_abs_err": err, "max_rel_err": rel,
               "tol": 2e-2, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
        emit(row)
        if kvdt == torch.bfloat16:
            main = row
    return main


# ---------------------------------------------------------------------------
# Phases 2-4: serving
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


def serve(cfg, params, prompts, gen: int, *, phase: int, **kw) -> dict:
    """Drive the paged server once with fresh launch counts; returns the
    finished requests, stats and counts."""
    from repro_torch.kernels import ops as kops
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer

    srv = PagedContinuousBatchingServer(cfg, params, **kw)
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
    row = {
        "phase": phase, "arch": cfg.arch_id, "layers": cfg.num_layers,
        "kv_cache_dtype": str(cfg.kv_cache_dtype).replace("torch.", ""),
        "requests": len(prompts), "finished": len(done),
        "generated": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
        "ttft_s_median": float(np.median([r.ttft for r in done])),
        "ttft_s_max": float(np.max([r.ttft for r in done])),
        "prefix_block_hits": st.prefix_block_hits,
        "prefix_prompt_blocks": st.prefix_prompt_blocks,
        "decode_calls": calls["decode"], "prefill_calls": calls["prefill"],
        "launches": counts,
        "gather_blocks": sum(r.op == "gather_blocks" for r in recs),
        "scatter_blocks": sum(r.op == "scatter_blocks" for r in recs),
    }
    emit(row)
    L = cfg.num_layers
    check(len(done) == len(prompts) and all(r.generated == gen
                                            for r in done),
          f"phase {phase}: not every request finished")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"phase {phase}: token out of vocab")
    check(st.prefix_block_hits > 0, f"phase {phase}: no prefix hits")
    check(counts["paged_gqa"] == L * calls["decode"],
          f"phase {phase}: paged_gqa launches {counts['paged_gqa']} != "
          f"{L} x {calls['decode']}")
    check(counts["sidebar_mlp"] == L * (calls["decode"] + calls["prefill"]),
          f"phase {phase}: sidebar_mlp launches {counts['sidebar_mlp']}")
    check("gather_blocks" not in ops and "scatter_blocks" not in ops,
          f"phase {phase}: the paged route gathered or scattered blocks")
    return row


def full_width(phase: int, *, int8: bool, layers: int | None) -> dict:
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_config("nemotron-4-15b"),
                              use_pallas=True)
    if int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype=torch.int8)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    t0 = time.perf_counter()
    params = transformer.init(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = traffic(phase, 8, cfg.vocab_size, shared=128, lo=32, hi=256)
    row = serve(cfg, params, prompts, 32, phase=phase, device="cuda",
                num_slots=4, block_size=16, max_len=1024, segment=8,
                kernel="paged")
    emit({"phase": phase, "init_s": init_s,
          "depth_cut": layers is not None,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del params
    torch.cuda.empty_cache()
    return row


def paged_vs_slab() -> None:
    """fp32 smoke config on the card: the paged route (kernel) and the
    slab route (gather + dense plain attention) on the same traffic,
    compared step by step by their logits while their tokens agree."""
    from repro_torch import configs
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.models import layers as L
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_smoke_config("nemotron-4-15b"),
                              use_pallas=True)
    params = transformer.init(cfg, seed=0, device="cuda")
    prompts = traffic(4, 6, cfg.vocab_size, shared=16, lo=4, hi=30)
    logs = {}
    for kernel in ("paged", "slab"):
        srv = PagedContinuousBatchingServer(
            cfg, params, device="cuda", num_slots=3, max_len=64,
            block_size=8, segment=4, kernel=kernel)
        seen = []

        def step(p, tok, cache, pos, block_tables=None, srv=srv, seen=seen):
            logits, cache = srv.api.decode_step(p, cfg, tok, cache, pos,
                                                block_tables=block_tables)
            logits = L.mask_pad_logits(logits, cfg.vocab_size)[:, -1]
            seen.append(logits.clone())
            return torch.argmax(logits, -1).to(torch.int32)[:, None], cache

        srv._serve_step = step
        for p in prompts:
            srv.submit(p, 12)
        done = srv.run()
        logs[kernel] = (seen, [r.tokens for r in done])
    (la, ta), (lb, tb) = logs["paged"], logs["slab"]
    same = all(np.array_equal(a, b) for a, b in zip(ta, tb))
    err = max((a - b).abs().max().item() for a, b in zip(la, lb)) \
        if same else float("nan")
    emit({"phase": 4, "tokens_equal": same, "steps": len(la),
          "max_abs_logit_err": err, "tol": 1e-4})
    # fp32 end to end: the two routes differ only in summation order
    check(same and len(la) == len(lb) and err <= 1e-4,
          "phase 4: paged route disagrees with the slab route")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="0,1,2,3,4",
                    help="comma-separated subset of phases to run")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth of the full-width phase 2")
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
    build_s = build.build_all()
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
        rows["mlp"] = mlp_ops()
        rows["paged"] = paged_ops()
    served = None
    if 2 in phases:
        served = full_width(2, int8=False, layers=args.layers)
    if 3 in phases:
        full_width(3, int8=True, layers=4)
    if 4 in phases:
        paged_vs_slab()
    if served is not None and rows:
        kernels = []
        for name, key, source, replaces in (
                ("sidebar_mlp", "mlp", "src/repro_torch/csrc/sidebar_mlp.cu",
                 "src/repro/kernels/sidebar_mlp.py:171"),
                ("paged_gqa", "paged", "src/repro_torch/csrc/paged_gqa.cu",
                 "src/repro/kernels/paged_attention.py:218")):
            r = rows[key]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": served["launches"][name],
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
