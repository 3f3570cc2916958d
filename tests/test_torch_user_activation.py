"""Activations registered at run time reach the port's kernels.

A function-table entry registered with a ``device_expr`` (a CUDA C++
expression in ``float x``) is compiled into every kernel that applies an
activation: ``kernels/build.py`` builds the unchanged ``csrc/*.cu`` once
more with a generated header that defines it, under the reserved id 15.
These tests run with no ``nvcc``: the table rules, the kernel-side form
each wrapper takes, the library key (source and expression), the
generated header and ``nvcc`` command, a failed build that raises with
the compiler's output, and — on CPU tensors — the plain path, unchanged
by the expression and held to the JAX package's Pallas kernels (interpret
mode) with the same function registered there (3e-5, fp32). The kernels
themselves compute it on the card: ``test_torch_isolation.py`` (marked
``gpu``) and ``chip_smoke.py`` phase 1.
"""

import hashlib
import importlib
import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.function_table import make_default_table as jax_table
from repro.kernels import ops as jops
from repro_torch.core import function_table as ft
from repro_torch.kernels import activations as ak
from repro_torch.kernels import build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import sidebar_gated_mlp as sg
from repro_torch.kernels import sidebar_matmul as smm
from repro_torch.kernels import sidebar_mlp as sm

jmlp = importlib.import_module("repro.kernels.sidebar_mlp")
jmm = importlib.import_module("repro.kernels.sidebar_matmul")
jact = importlib.import_module("repro.kernels.activations")

MISH = "x * tanhf(log1pf(expf(x)))"
SWISH2 = "x / (1.f + expf(-2.f * x))"


def _mish(t):
    return t * torch.tanh(torch.nn.functional.softplus(t))


def _tables():
    """The port's table with mish compiled for the kernels and with mish
    for the plain versions only; the JAX table with mish."""
    with_expr = ft.make_default_table()
    with_expr.register("mish", _mish, device_expr=MISH)
    host_only = ft.make_default_table()
    host_only.register("mish", _mish)
    jt = jax_table()
    jt.register("mish", lambda v: v * jnp.tanh(jnp.logaddexp(v, 0.0)))
    return with_expr, host_only, jt


def test_register_keeps_the_expression_and_no_id():
    table = ft.make_default_table()
    ent = table.register("swish2", lambda t: t * torch.sigmoid(2 * t),
                         device_expr=SWISH2)
    assert ent.device_expr == SWISH2 and ent.device_id is None
    assert table["swish2"] is ent and not ent.rowwise
    assert table["relu"].device_expr is None
    assert ft.USER_ACTIVATION_ID == 15
    assert ft.USER_ACTIVATION_ID not in {
        table[n].device_id for n in table.names()}


@pytest.mark.parametrize("kw", [
    dict(device_expr=MISH, device_id=3),
    dict(device_expr="x", rowwise=True),
    dict(device_expr="x; return 0"),
    dict(device_expr="x\n"),
    dict(device_expr="#include <x>"),
    dict(device_expr="{x}"),
    dict(device_expr="  "),
], ids=["with_id", "rowwise", "statement", "newline", "directive", "brace",
        "empty"])
def test_register_rejects_what_is_not_one_elementwise_expression(kw):
    with pytest.raises(ValueError):
        ft.make_default_table().register("bad", _mish, **kw)


def test_kernel_activation_forms():
    table, host_only, _ = _tables()
    ka = build.kernel_form
    assert ka("k", "silu", table) == (9, None)
    assert ka("k", "mish", table) == (ft.USER_ACTIVATION_ID, MISH)
    assert ka("k", "softmax", table, rowwise_ok=True) == (13, None)
    with pytest.raises(NotImplementedError, match="kernel-side.*rowwise"):
        ka("k", "rmsnorm", table)
    with pytest.raises(NotImplementedError, match="device_expr"):
        ka("k", "mish", host_only)
    with pytest.raises(TypeError, match="function-table key"):
        ka("k", _mish, table)


def test_device_expr_check_probe_and_verdict_cache_without_a_card():
    """The check that holds a device_expr to its torch callable, with the
    expression emulated in torch on the CPU: the probe covers a dense
    grid over [-20, 20] and the branch points; a wrong expression (mish's
    callable against ``x * tanhf(x)``) raises naming the worst input and
    both values, a right one passes, and each (name, expression,
    callable) is run once — a repeated mismatch raises from the cache."""
    probe = build.expr_probe()
    assert probe.dtype == torch.float32 and probe.device.type == "cpu"
    for v in (0.0, 1e-6, -1e-6, 1.0, -1.0, 20.0, -20.0):
        assert (probe == torch.tensor(v)).any()
    grid = probe[:4001]
    assert grid.min() == -20 and grid.max() == 20
    assert float((grid[1:] - grid[:-1]).max()) <= 0.0101
    calls = []

    def runner(fn):
        def run(x):
            calls.append(fn)
            return fn(x)
        return run

    wrong = ft.FunctionEntry("mish_wrong", _mish, device_expr="x * tanhf(x)")
    with pytest.raises(ValueError, match=r"mish_wrong.*x \* tanhf\(x\).*at "
                                         r"x = .*gives .*callable"):
        build.check_device_expr(wrong, runner(lambda t: t * torch.tanh(t)))
    with pytest.raises(ValueError, match="mish_wrong"):
        build.check_device_expr(wrong, runner(lambda t: t * torch.tanh(t)))
    assert len(calls) == 1
    right = ft.FunctionEntry("mish_right", _mish, device_expr=MISH)
    emulated = lambda t: t * torch.tanh(torch.log1p(torch.exp(t)))  # noqa: E731
    build.check_device_expr(right, runner(emulated))
    build.check_device_expr(right, runner(emulated))
    assert len(calls) == 2
    # the worst input is where the two differ most against the tolerance
    try:
        build.check_device_expr(
            ft.FunctionEntry("off_at_3", _mish, device_expr="x"),
            lambda t: torch.where(t == 3.0, t + 1.0, _mish(t)))
    except ValueError as e:
        assert "at x = 3.0 " in str(e) and "2 of 4016" in str(e)  # grid, branch
    else:
        raise AssertionError("a disagreement at one input passed")
    # the kernel-side form alone runs no check; a launch's form takes the
    # card it runs on, so there is no way to ask for it unchecked
    table, _, _ = _tables()
    assert build.kernel_form("k", "mish", table) == (
        ft.USER_ACTIVATION_ID, MISH)
    with pytest.raises(TypeError):
        build.kernel_activation("k", "mish", table)
    with pytest.raises(ValueError, match="not a card"):
        build.kernel_activation("k", "mish", table, torch.device("cpu"))


@pytest.mark.parametrize("name", build.ACTIVATION_KERNELS)
def test_library_is_keyed_by_source_and_expression(name):
    base = build._lib_path(name)
    mish = build._lib_path(name, MISH)
    assert base.name.startswith(f"lib{name}-") and "-user-" not in base.name
    assert mish.name.startswith(f"lib{name}-user-")
    assert len({base, mish, build._lib_path(name, SWISH2)}) == 3
    assert mish == build._lib_path(name, MISH)
    assert base.parent == mish.parent == build.BUILD_DIR


def test_generated_header_and_nvcc_command():
    text = build.user_header_source(MISH)
    assert f"repro_user_activation(float x) {{ return ({MISH}); }}" in text
    assert "#include <cuda_runtime.h>" in text
    header = build.user_header_path(MISH)
    assert header.parent == build.BUILD_DIR
    assert header != build.user_header_path(SWISH2)
    out = build.BUILD_DIR / "lib.so"
    user = build.nvcc_command("nvcc", "sidebar_gated_mlp", MISH, out)
    plain = build.nvcc_command("nvcc", "sidebar_gated_mlp", None, out)
    assert user[user.index("-include") + 1] == str(header)
    assert "-DREPRO_USER_ACTIVATION" in user
    assert "-DREPRO_USER_ACTIVATION" not in plain and "-include" not in plain
    assert user[-1] == plain[-1] == str(build.CSRC / "sidebar_gated_mlp.cu")
    assert set(build.ACTIVATION_KERNELS) <= set(build.SOURCES)
    assert "paged_gqa" not in build.ACTIVATION_KERNELS


def _csrc_digest():
    h = hashlib.sha256()
    for p in sorted(build.CSRC.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    return h.hexdigest()


def test_failed_build_raises_with_nvcc_output_and_edits_no_source(
        tmp_path, monkeypatch):
    """A new activation writes one header into the build directory and
    touches no file under csrc/; a build that fails raises with the
    compiler's output (nothing gives way to the plain version)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"fake nvcc refused: $*\"\nexit 1\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    before = _csrc_digest()
    with pytest.raises(RuntimeError, match="fake nvcc refused") as err:
        build.build_all([("sidebar_mlp", MISH), ("activation", MISH)])
    assert "sidebar_mlp:user" in str(err.value)
    assert "-DREPRO_USER_ACTIVATION" in build.build_log["activation:user"]
    header = build.user_header_path(MISH)
    assert header.read_text() == build.user_header_source(MISH)
    assert not any(p.suffix == ".so" for p in header.parent.iterdir())
    assert _csrc_digest() == before
    assert ("sidebar_mlp", MISH) not in build._loaded


def _problem(seed, m=16, d=128, f=256):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, d).astype(np.float32),
            (rng.randn(d, f) * 0.05).astype(np.float32),
            (rng.randn(d, f) * 0.05).astype(np.float32),
            (rng.randn(f, d) * 0.05).astype(np.float32))


# each wrapper on CPU tensors under a table, and the JAX Pallas kernel
# (interpret mode) under the JAX table
WRAPPERS = {
    "sidebar_mlp": (
        lambda x, wg, wu, wd, t: sm.sidebar_mlp(x, wg, wd, "mish", table=t),
        lambda x, wg, wu, wd, t: jmlp.sidebar_mlp(x, wg, wd, "mish",
                                                  table=t, interpret=True)),
    "sidebar_mlp_pipelined": (
        lambda x, wg, wu, wd, t: sm.sidebar_mlp_pipelined(
            x, wg, wd, "mish", table=t, depth=2),
        lambda x, wg, wu, wd, t: jmlp.sidebar_mlp_pipelined(
            x, wg, wd, "mish", table=t, depth=2, interpret=True)),
    "sidebar_gated_mlp": (
        lambda x, wg, wu, wd, t: sg.sidebar_gated_mlp(x, wg, wu, wd, "mish",
                                                      table=t),
        lambda x, wg, wu, wd, t: jops.sidebar_gated_mlp(
            x, wg, wu, wd, "mish", table=t, interpret=True,
            use_kernel=True)),
    "sidebar_matmul": (
        lambda x, wg, wu, wd, t: smm.sidebar_matmul(x, wg, "mish", table=t),
        lambda x, wg, wu, wd, t: jmm.sidebar_matmul(x, wg, "mish", table=t,
                                                    interpret=True)),
    "activation": (
        lambda x, wg, wu, wd, t: ak.activation_2d(x, "mish", table=t),
        lambda x, wg, wu, wd, t: jact.activation_2d(x, "mish", table=t,
                                                    interpret=True)),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_cpu_plain_path_unchanged_and_matches_jax_pallas(name):
    """On CPU tensors the wrapper takes the plain version whether or not
    the entry carries an expression (bit for bit), launches nothing, and
    agrees with the JAX package's kernel on the same function."""
    port, pallas = WRAPPERS[name]
    table, host_only, jt = _tables()
    ops = _problem(len(name))
    before = dict(build.launches)
    got = port(*(torch.from_numpy(a) for a in ops), table)
    assert torch.equal(got, port(*(torch.from_numpy(a) for a in ops),
                                 host_only))
    assert dict(build.launches) == before
    want = np.asarray(pallas(*(jnp.asarray(a) for a in ops), jt))
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)


def test_user_activation_reaches_the_model_on_cpu():
    """A model config naming the run-time entry runs it through the ops
    (plain versions on the CPU) with the kernel-side form on record."""
    table, _, _ = _tables()
    x, wg, wu, wd = (torch.from_numpy(a) for a in _problem(9))
    recs = []
    with kops.record_dispatches(recs):
        got = kops.sidebar_gated_mlp(x, wg, wu, wd, "mish", table=table)
    assert [r.variant for r in recs] == ["ref"]
    want = sg.sidebar_gated_mlp_plain(x, wg, wu, wd, _mish)
    assert torch.equal(got, want)
    assert os.path.basename(build._lib_path("sidebar_gated_mlp", MISH)) \
        != os.path.basename(build._lib_path("sidebar_gated_mlp"))
