"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes``. Nothing
here runs at import: the first CUDA launch of a kernel builds (or
finds) its library, so ``import repro_torch`` works on a machine with
no ``nvcc``. Libraries are named by a hash of their source and go to
``build/kernels`` at the repository root (git-ignored), so an edited
source is rebuilt and an unchanged one is reused. ``build_all`` starts
one ``nvcc`` per library at once and waits for all of them.

A function registered at run time with a ``device_expr``
(``core/function_table.py``) gets libraries of its own: the unchanged
sources compiled with ``-DREPRO_USER_ACTIVATION`` and a generated
header (``-include``) that defines ``repro_user_activation(float x)``
from the expression, which ``csrc/activation.cuh`` takes the reserved
id ``USER_ACTIVATION_ID`` to. Such a library is keyed by the hash of
the sources and of the expression, and is built at its first launch.
Before its first launch the expression is held to the entry's torch
callable on the card (``verify_device_expr``): both run on one fixed
fp32 probe, and a disagreement raises, so a wrong expression never
serves.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Callable, Iterable

import torch

from repro_torch.core.function_table import (USER_ACTIVATION_ID,
                                             FunctionEntry, FunctionTable)

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"

SOURCES = {
    "sidebar_mlp": "sidebar_mlp.cu",
    "paged_gqa": "paged_gqa.cu",
    "sidebar_mlp_pipelined": "sidebar_mlp_pipelined.cu",
    "sidebar_matmul": "sidebar_matmul.cu",
    "activation": "activation.cu",
    "sidebar_gated_mlp": "sidebar_gated_mlp.cu",
    "paged_mla": "paged_mla.cu",
    "flash_attention": "flash_attention.cu",
    "moe_grouped_mm": "moe_experts.cu",
}
# the kernels that apply a function-table entry (csrc/activation.cuh)
ACTIVATION_KERNELS = ("sidebar_mlp", "sidebar_mlp_pipelined",
                      "sidebar_matmul", "activation", "sidebar_gated_mlp")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (kernel name, device_expr or None) -> loaded library
_loaded: dict[tuple[str, str | None], ctypes.CDLL] = {}
# library label (``name``, or ``name:user`` for a device_expr build) ->
# nvcc's stderr (ptxas register/shared-memory/spill report)
build_log: dict[str, str] = {}
# kernel name -> CUDA launches so far; each wrapper adds one where it
# launches its kernel and nowhere else (the plain versions never count)
launches: collections.Counter = collections.Counter()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use and "
            "need the CUDA toolkit (on PATH or under /usr/local/cuda)")
    return path


def user_header_source(expr: str) -> str:
    """The header that defines a run-time entry's device function."""
    return ("// generated by repro_torch/kernels/build.py from a "
            "function-table device_expr\n"
            "#pragma once\n#include <cuda_runtime.h>\n"
            "static __device__ __forceinline__ float "
            f"repro_user_activation(float x) {{ return ({expr}); }}\n")


def user_header_path(expr: str) -> pathlib.Path:
    digest = hashlib.sha256(expr.encode()).hexdigest()[:12]
    return BUILD_DIR / f"user_activation-{digest}.cuh"


def _lib_path(name: str, expr: str | None = None) -> pathlib.Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    if expr is None:
        return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"
    digest.update(b"\0device_expr\0" + expr.encode())
    return BUILD_DIR / f"lib{name}-user-{digest.hexdigest()[:12]}.so"


def nvcc_command(nvcc: str, name: str, expr: str | None,
                 out: pathlib.Path) -> list[str]:
    """The ``nvcc`` call that builds kernel ``name`` (for ``expr``, when
    given) into ``out``."""
    user = [] if expr is None else [
        "-DREPRO_USER_ACTIVATION", "-include", str(user_header_path(expr))]
    return [nvcc, *NVCC_FLAGS, *user, "-o", str(out),
            str(CSRC / SOURCES[name])]


def _label(name: str, expr: str | None) -> str:
    return name if expr is None else f"{name}:user"


def build_all(variants: Iterable[tuple[str, str | None]] | None = None
              ) -> float:
    """Compile every stale library of ``variants`` — (kernel name,
    device_expr or None) pairs; default: every kernel, no expression —
    one ``nvcc`` each, all started together. Returns wall seconds.
    Raises with nvcc's output if any build fails."""
    if variants is None:
        variants = [(n, None) for n in SOURCES]
    todo = [(n, e) for n, e in dict.fromkeys(variants)
            if not _lib_path(n, e).exists()]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    for expr in {e for _, e in todo if e is not None}:
        header = user_header_path(expr)
        tmp = header.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(user_header_source(expr))
        os.replace(tmp, header)
    procs = {}
    for n, e in todo:
        out = _lib_path(n, e)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[(n, e)] = (subprocess.Popen(
            nvcc_command(nvcc, n, e, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for (n, e), (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[_label(n, e)] = log
        if proc.returncode != 0:
            failed.append(f"--- {_label(n, e)} (rc {proc.returncode}) "
                          f"---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def entry(name: str, symbol: str, argtypes,
          expr: str | None = None) -> ctypes._CFuncPtr:
    """C entry point ``symbol`` of kernel ``name``'s library — the one
    built for ``expr`` when given — (built and loaded first if needed),
    with its argument types declared and an int (``cudaError_t``)
    result."""
    lib = _loaded.get((name, expr))
    if lib is None:
        build_all([(name, expr)])
        lib = _loaded[(name, expr)] = ctypes.CDLL(str(_lib_path(name, expr)))
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


# element-type codes of the product kernels' C entry points
# (csrc/common.cuh ``DType``)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def refuse_autograd(what: str, *tensors: torch.Tensor | None) -> None:
    """Raise when gradient mode is on and an operand requires grad: a
    kernel launched through ``ctypes`` writes a fresh tensor with no
    ``grad_fn``, so every gradient upstream of it would be silently
    wrong. No kernel of the port has a backward (the JAX package's
    Pallas kernels have none either: ``jax.grad`` through them fails).
    The plain versions, taken for CPU tensors, are differentiable."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: the CUDA kernel has no backward and an operand "
            "requires grad; run it under torch.no_grad(), or train with "
            "cfg.use_pallas=False (as the JAX trainer does)")


def check_operands(what: str, *tensors: torch.Tensor) -> int:
    """The checks a product kernel's wrapper makes on its CUDA operands:
    no operand that requires grad under autograd, one device, one type
    (fp32 or bf16), contiguous. Returns the type code."""
    refuse_autograd(what, *tensors)
    t0 = tensors[0]
    if any(t.device != t0.device for t in tensors):
        raise ValueError(f"{what}: operands on different devices")
    if t0.dtype not in DTYPES or any(t.dtype != t0.dtype for t in tensors):
        raise TypeError(
            f"{what} kernel takes fp32 or bf16 operands of one type, got "
            f"{[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} kernel takes contiguous operands")
    return DTYPES[t0.dtype]


def kernel_form(what: str, activation: str | Callable,
                table: FunctionTable, *, rowwise_ok: bool = False
                ) -> tuple[int, str | None]:
    """The kernel-side form of a function-table entry: (id, None) for an
    entry with a compiled id, (``USER_ACTIVATION_ID``, expression) for
    one registered with a ``device_expr``. Raises for a callable, for a
    rowwise entry unless ``rowwise_ok`` (the fused kernels need the
    whole row), and for an entry with neither. A launch takes it through
    ``kernel_activation``, which also checks the expression."""
    if callable(activation):
        raise TypeError(f"{what} kernel takes a function-table key")
    ent = table[activation]
    if ent.rowwise and not rowwise_ok:
        raise NotImplementedError(
            f"activation {activation!r} has no kernel-side implementation "
            f"in {what}: rowwise entries need the whole row")
    if ent.device_id is not None:
        return ent.device_id, None
    if ent.device_expr is not None:
        return USER_ACTIVATION_ID, ent.device_expr
    raise NotImplementedError(
        f"activation {activation!r} has no kernel-side implementation: "
        "register it with a device_expr (a CUDA C++ expression in float "
        "x) to run it in the kernels")


def kernel_activation(what: str, activation: str | Callable,
                      table: FunctionTable, device: torch.device, *,
                      rowwise_ok: bool = False) -> tuple[int, str | None]:
    """``kernel_form`` for a launch on the CUDA ``device``: an entry's
    expression is first held to its torch callable there
    (``verify_device_expr``, once per process), and a mismatch raises
    ``ValueError``."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"{what}: kernel launch on {device}, not a card")
    form = kernel_form(what, activation, table, rowwise_ok=rowwise_ok)
    if form[1] is not None:
        verify_device_expr(table[activation], device)
    return form


# the check of a device_expr against its torch callable: both fp32 on
# the same values, so only expf/tanhf/... against torch's rounding
# differ
EXPR_RTOL = 1e-5
EXPR_ATOL = 1e-6
# inputs where common activations change branch or saturate
EXPR_BRANCH_POINTS = (0.0, 1e-6, -1e-6, 0.5, -0.5, 1.0, -1.0, 2.0, -2.0,
                      3.0, -3.0, 6.0, -6.0, 20.0, -20.0)
_ACTIVATION_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
# (entry name, device_expr, torch callable) -> None when they agree, or
# the message of the disagreement
_expr_verdicts: dict[tuple[str, str, Callable], str | None] = {}


def expr_probe() -> torch.Tensor:
    """The fixed fp32 probe (on the CPU): a dense grid over [-20, 20] in
    steps of 0.01, then ``EXPR_BRANCH_POINTS``."""
    grid = torch.arange(-2000, 2001, dtype=torch.float64) / 100
    return torch.cat([grid, torch.tensor(EXPR_BRANCH_POINTS,
                                         dtype=torch.float64)]).float()


def check_device_expr(ent: FunctionEntry,
                      run_expr: Callable[[torch.Tensor], torch.Tensor]
                      ) -> None:
    """Hold ``ent.device_expr``, computed by ``run_expr`` on the probe,
    to ``ent.fn`` on the same fp32 values: |kernel - fn| must be within
    ``EXPR_ATOL + EXPR_RTOL * |fn|`` everywhere (NaN where fn gives NaN,
    the same infinities). Raises ``ValueError`` naming the entry, the
    worst input and both values. The verdict is cached by (name,
    expression, callable): each pair runs once per process."""
    key = (ent.name, ent.device_expr, ent.fn)
    if key not in _expr_verdicts:
        x = expr_probe()
        got = run_expr(x)
        # the callable on the same values, where the expression ran
        want = ent.fn(x.to(got.device)).float().cpu()
        got = got.float().cpu()
        ok = torch.isclose(got, want, rtol=EXPR_RTOL, atol=EXPR_ATOL,
                           equal_nan=True)
        verdict = None
        if not bool(ok.all()):
            excess = ((got - want).abs()
                      / (EXPR_ATOL + EXPR_RTOL * want.abs()))
            excess = torch.where(ok, torch.zeros_like(excess),
                                 excess.nan_to_num(nan=float("inf"),
                                                   posinf=float("inf")))
            i = int(excess.argmax())
            verdict = (
                f"device_expr of {ent.name!r} ({ent.device_expr!r}) does "
                f"not compute its torch callable: at x = {x[i].item()!r} "
                f"the expression gives {got[i].item()!r}, the callable "
                f"{want[i].item()!r} (tolerance {EXPR_RTOL} relative, "
                f"{EXPR_ATOL} absolute; {int((~ok).sum())} of {x.numel()} "
                "probe inputs disagree)")
        _expr_verdicts[key] = verdict
    if _expr_verdicts[key] is not None:
        raise ValueError(_expr_verdicts[key])


def verify_device_expr(ent: FunctionEntry, device: torch.device) -> None:
    """``check_device_expr`` on the card: the expression runs in the
    standalone activation kernel built for it (``activation`` library,
    id ``USER_ACTIVATION_ID``), the callable on the same CUDA tensor.
    This launch is a check, not a launch of the path: it is not
    counted."""

    def run_expr(x: torch.Tensor) -> torch.Tensor:
        x = x.to(device)
        y = torch.empty_like(x)
        fn = entry("activation", "activation_launch", _ACTIVATION_ARGTYPES,
                   ent.device_expr)
        stream = torch.cuda.current_stream(device).cuda_stream
        check(fn(x.data_ptr(), y.data_ptr(), 1, x.numel(),
                 USER_ACTIVATION_ID, DTYPES[torch.float32], stream),
              f"device_expr check of {ent.name!r}")
        return y

    with torch.no_grad():
        check_device_expr(ent, run_expr)


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
