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

from repro_torch.core.function_table import USER_ACTIVATION_ID, FunctionTable

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


def check_operands(what: str, *tensors: torch.Tensor) -> int:
    """The checks a product kernel's wrapper makes on its CUDA operands:
    one device, one type (fp32 or bf16), contiguous. Returns the type
    code."""
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


def kernel_activation(what: str, activation: str | Callable,
                      table: FunctionTable, *, rowwise_ok: bool = False
                      ) -> tuple[int, str | None]:
    """The kernel-side form of a function-table entry for a CUDA launch:
    (id, None) for an entry with a compiled id, (``USER_ACTIVATION_ID``,
    expression) for one registered with a ``device_expr``. Raises for a
    callable, for a rowwise entry unless ``rowwise_ok`` (the fused
    kernels need the whole row), and for an entry with neither."""
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


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
