"""The port stands alone: no JAX, no ``repro``, no build at import.

  * no module of ``src/repro_torch`` nor ``chip_smoke.py`` imports
    ``jax`` or any ``repro`` module (AST scan);
  * importing every module of the port needs neither ``nvcc`` nor
    ``triton`` and builds nothing;
  * entry points run on ``cuda`` unless asked for the CPU, and never
    pick the CPU on their own;
  * ``chip_smoke.py`` fails without a card, and fails in a directory
    that holds nothing else of the repository;
  * on the card (tests marked ``gpu``, skipped without one): each CUDA
    kernel against its plain version (the gated MLP at deepseek-7b's
    widths, paged decode at group 1, MLA absorbed decode at deepseek-
    v3's widths with fp32 and bf16 pools, flash attention in fp32 and
    bf16), a run-time activation with a ``device_expr`` through every
    kernel that takes an activation, and the wrappers' refusals —
    among them every wrapper's refusal under autograd. They
    live here because this file imports no JAX, which the card's
    machine does not have. ``chip_smoke.py`` repeats the comparisons at
    full width.
"""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return mods


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_repro_imports(path):
    bad = {m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")}
    assert not bad, f"{path}: imports {sorted(bad)}"


def test_scan_sees_the_whole_port():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"kernels/sidebar_mlp.py", "kernels/paged_attention.py",
            "launch/scheduler.py", "bridge.py", "models/moe.py",
            "models/attention.py", "kernels/flash_attention.py",
            "launch/train.py", "optim/optimizer.py", "optim/compression.py",
            "data/pipeline.py", "checkpoint/manager.py", "ft/watchdog.py",
            "tree.py"} <= names


def test_import_needs_no_nvcc_no_triton_and_builds_nothing(tmp_path):
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from repro_torch.kernels import build\n"
        "assert 'triton' not in sys.modules\n"
        "assert not any(k.startswith(('jax', 'repro.')) or k == 'repro' "
        "for k in sys.modules), 'JAX or repro imported'\n"
        "assert build._loaded == {} and not build.launches\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n")
    env = {**os.environ, "PATH": str(tmp_path),
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda():
    from repro_torch import configs, resolve_device
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.models import transformer as T

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = configs.get_smoke_config("nemotron-4-15b")
    params = T.init(cfg, device="cpu")
    for make in (lambda: resolve_device(),
                 lambda: T.init(cfg),
                 lambda: T.init_cache(cfg, 1, 8),
                 lambda: PagedContinuousBatchingServer(
                     cfg, params, num_slots=1, max_len=16, block_size=8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version. Tolerance 1e-4:
# fp32 on both sides, summed in different orders (and, for paged decode,
# an online softmax against a two-pass one).
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _mlp_problem(seed, m, d=64, f=256):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, d).astype(np.float32),
            (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
            (rng.randn(f, d) / np.sqrt(f)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 4, 64, 130])
@pytest.mark.parametrize("act", ["squared_relu", "relu", "gelu"])
def test_sidebar_mlp_kernel_matches_plain(cuda, m, act):
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sidebar_mlp as sm

    x, w1, w2 = (torch.from_numpy(a).to(cuda) for a in _mlp_problem(7, m))
    before = kops.launch_counts()["sidebar_mlp"]
    out = sm.sidebar_mlp(x, w1, w2, act)
    ref = sm.sidebar_mlp_plain(x, w1, w2, act)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert kops.launch_counts()["sidebar_mlp"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_paged_gqa_kernel_matches_plain(cuda, quantized):
    """Ragged lengths, a duplicated (prefix-shared) block and a
    scratch-padded tail row."""
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.RandomState(8)
    P, Hkv, bs, Dh, B, nb, group = 9, 2, 8, 16, 3, 4, 4
    tables = rng.randint(1, P, size=(B, nb)).astype(np.int32)
    tables[0, 1:] = 0
    tables[1, 2] = tables[1, 1]
    lengths = np.array([5, bs * 2, bs * nb], np.int32)
    q = rng.randn(B, Hkv * group, Dh).astype(np.float32)
    if quantized:
        k, v = (rng.randint(-127, 128, (P, Hkv, bs, Dh)).astype(np.int8)
                for _ in range(2))
        ks, vs = (((rng.rand(P, Hkv, bs) + .5) / 127).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.randn(P, Hkv, bs, Dh).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    q, k, v, ks, vs, tables, lengths = (
        None if a is None else torch.from_numpy(a).to(cuda)
        for a in (q, k, v, ks, vs, tables, lengths))
    out = pa.paged_gqa(q, k, v, tables, lengths, scale=Dh ** -0.5,
                       k_scale=ks, v_scale=vs)
    ref = pa.paged_gqa_reference(q, k, v, tables, lengths, scale=Dh ** -0.5,
                                 k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import sidebar_mlp as sm

    x = torch.zeros(4, 64, device=cuda)
    w1 = torch.zeros(64, 128, device=cuda)
    w2 = torch.zeros(128, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="kernel-side"):
        sm.sidebar_mlp(x, w1, w2, "softmax")
    with pytest.raises(TypeError):
        sm.sidebar_mlp(x.double(), w1.double(), w2.double())
    with pytest.raises(ValueError, match="contiguous"):
        sm.sidebar_mlp(x, torch.zeros(128, 64, device=cuda).t(), w2)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (3, 100, 130),
                                   (4, 4096, 64), (17, 513, 257)])
@pytest.mark.parametrize("act", ["identity", "squared_relu", "gelu"])
def test_sidebar_matmul_kernel_matches_plain(cuda, m, k, n, act):
    """Ragged M, K and N; K split across blocks under the identity."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sidebar_matmul as smm

    rng = np.random.RandomState(9)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    b = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
                         ).to(cuda)
    before = kops.launch_counts()["sidebar_matmul"]
    out = smm.sidebar_matmul(a, b, act)
    ref = smm.sidebar_matmul_plain(a, b, act)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert kops.launch_counts()["sidebar_matmul"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (5, 1001), (2, 3, 4099)])
@pytest.mark.parametrize("act", ["squared_relu", "gelu", "exp_decay",
                                 "softmax", "rmsnorm"])
def test_activation_kernel_matches_plain(cuda, shape, act):
    """Elementwise and rowwise entries, ragged widths, rank 3."""
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import ops as kops

    x = torch.from_numpy(np.random.RandomState(10).randn(*shape).astype(
        np.float32) * 3).to(cuda)
    before = kops.launch_counts()["activation"]
    out = ak.activation(x, act)
    torch.testing.assert_close(out, ak.activation_plain(x, act), rtol=1e-4,
                               atol=1e-4)
    assert kops.launch_counts()["activation"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,f", [(1, 64, 256), (3, 64, 200),
                                   (4, 96, 1000), (130, 64, 2048)])
def test_pipelined_kernel_matches_plain_and_ignores_depth(cuda, m, d, f):
    """Each depth against the plain version, and bitwise equal across
    depths (the F partition does not depend on the depth)."""
    from repro_torch.kernels import sidebar_mlp as sm

    x, w1, w2 = (torch.from_numpy(a).to(cuda)
                 for a in _mlp_problem(11, m, d, f))
    ref = sm.sidebar_mlp_plain(x, w1, w2, "squared_relu")
    outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu", depth=t)
            for t in (1, 2, 3, 4, 7)]
    torch.testing.assert_close(outs[0], ref, rtol=1e-4, atol=1e-4)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("d2", [64, 96])
@pytest.mark.parametrize("f", [200, 1000, 2048])
@pytest.mark.parametrize("m", [1, 3, 12, 16, 17, 64, 130])
def test_pipelined_bf16_kernel_matches_plain_and_ignores_depth(cuda, m, f,
                                                              d2):
    """The tensor-core cluster ring: token panels of each build (8 rows
    at M 1 and 3; 16 at M 12 and 16; 32 rows on clusters of 8 at M 17, 64
    and 130), ragged or full; an F that its sub-tiles do not divide; D2
    tiles that do not fill the cluster's consumers; against the plain
    version in fp32 on the same bf16 values (2e-2 covers the bf16
    rounding of f(h) and of the output), bitwise equal across depths 1-4
    and 7."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sidebar_mlp as sm

    rng = np.random.RandomState(21)
    x, w1, w2 = (torch.from_numpy(a).to(cuda).bfloat16() for a in (
        rng.randn(m, 96).astype(np.float32),
        (rng.randn(96, f) / np.sqrt(96)).astype(np.float32),
        (rng.randn(f, d2) / np.sqrt(f)).astype(np.float32)))
    before = build.launches["sidebar_mlp_pipelined"]
    outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu", depth=t)
            for t in (1, 2, 3, 4, 7)]
    assert build.launches["sidebar_mlp_pipelined"] == before + 5
    ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                               "squared_relu")
    assert outs[0].dtype == torch.bfloat16 and outs[0].shape == (m, d2)
    torch.testing.assert_close(outs[0].float(), ref, rtol=2e-2, atol=2e-2)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("d,f,d2", [(100, 256, 64), (96, 260, 64),
                                    (96, 256, 68)])
def test_pipelined_bf16_rejects_what_it_does_not_take(cuda, d, f, d2):
    """The bf16 ring raises for a D, F or D2 that TMA cannot stride (not
    a multiple of 8), and launches nothing; fp32 takes the same
    shapes."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sidebar_mlp as sm

    x, w1, w2 = (torch.zeros(s, device=cuda) for s in ((4, d), (d, f),
                                                          (f, d2)))
    before = build.launches["sidebar_mlp_pipelined"]
    with pytest.raises(ValueError, match="multiples of 8"):
        sm.sidebar_mlp_pipelined(x.bfloat16(), w1.bfloat16(), w2.bfloat16())
    assert build.launches["sidebar_mlp_pipelined"] == before
    assert sm.sidebar_mlp_pipelined(x, w1, w2).shape == (4, d2)


@pytest.mark.gpu
@pytest.mark.parametrize("d2", [6152, 12352])
@pytest.mark.parametrize("m", [4, 16, 64])
def test_pipelined_bf16_walks_a_wide_d2_in_passes(cuda, m, d2):
    """A D2 wider than the 6144 columns the consumers' registers hold is
    walked in passes (a last pass of 8 or of 64 columns): against the
    plain version at 2e-2, bitwise equal across depths 1, 2 and 9."""
    from repro_torch.kernels import sidebar_mlp as sm

    rng = np.random.RandomState(22)
    x, w1, w2 = (torch.from_numpy(a).to(cuda).bfloat16() for a in (
        rng.randn(m, 64).astype(np.float32),
        (rng.randn(64, 520) / 8).astype(np.float32),
        (rng.randn(520, d2) / np.sqrt(520)).astype(np.float32)))
    outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu", depth=t)
            for t in (1, 2, 9)]
    ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                               "squared_relu")
    assert outs[0].shape == (m, d2)
    torch.testing.assert_close(outs[0].float(), ref, rtol=2e-2, atol=2e-2)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.gpu
def test_new_wrappers_reject_what_they_do_not_take(cuda):
    from repro_torch.core.function_table import make_default_table
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import sidebar_matmul as smm
    from repro_torch.kernels import sidebar_mlp as sm

    x = torch.zeros(4, 64, device=cuda)
    w1 = torch.zeros(64, 128, device=cuda)
    w2 = torch.zeros(128, 64, device=cuda)
    with pytest.raises(NotImplementedError, match="kernel-side"):
        sm.sidebar_mlp_pipelined(x, w1, w2, "softmax")
    with pytest.raises(NotImplementedError, match="kernel-side"):
        smm.sidebar_matmul(x, w1, "rmsnorm")
    # a run-time activation with a device_expr computes on the card; one
    # without it still raises
    table = make_default_table()
    table.register("mish", _mish, device_expr=MISH)
    table.register("mish_host_only", _mish)
    x = torch.randn(4, 64, device=cuda)
    torch.testing.assert_close(ak.activation_2d(x, "mish", table=table),
                               ak.activation_plain(x, "mish", table),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="kernel-side"):
        ak.activation_2d(x, "mish_host_only", table=table)
    with pytest.raises(TypeError):
        smm.sidebar_matmul(x.double(), w1.double())
    with pytest.raises(ValueError, match="contiguous"):
        ak.activation_2d(torch.zeros(64, 4, device=cuda).t())


MISH = "x * tanhf(log1pf(expf(x)))"


def _mish(t):
    return t * torch.tanh(torch.nn.functional.softplus(t))


def _gated_problem(seed, m, d, f, device, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in (
        rng.randn(m, d).astype(np.float32),
        (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
        (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
        (rng.randn(f, d) / np.sqrt(f)).astype(np.float32))]


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,f", [(1, 64, 192), (3, 64, 200),
                                   (4, 96, 1000), (64, 64, 192),
                                   (130, 64, 2048)])
@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_gated_kernel_matches_plain(cuda, m, d, f, act):
    """Ragged rows, an F that 64 does not divide, a ragged last split."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sidebar_gated_mlp as sg

    ops = _gated_problem(12, m, d, f, cuda)
    before = kops.launch_counts()["sidebar_gated_mlp"]
    out = sg.sidebar_gated_mlp(*ops, act)
    ref = sg.sidebar_gated_mlp_plain(*ops, act)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert kops.launch_counts()["sidebar_gated_mlp"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_gated_kernel_at_deepseek_7b_shapes(cuda, m):
    """bf16 at d 4096, d_ff 11008 (decode and a staging round) against
    the plain version in fp32 on the same values: 2e-2 covers the bf16
    rounding of h and of the output."""
    from repro_torch.kernels import sidebar_gated_mlp as sg

    ops = _gated_problem(13, m, 4096, 11008, cuda, torch.bfloat16)
    out = sg.sidebar_gated_mlp(*ops, "silu")
    ref = sg.sidebar_gated_mlp_plain(*(t.float() for t in ops), "silu")
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    assert torch.equal(out, sg.sidebar_gated_mlp(*ops, "silu"))


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_paged_gqa_kernel_at_group_1(cuda, quantized):
    """deepseek-7b's MHA decode: 32 query heads on 32 KV heads, head_dim
    128, block 16, ragged lengths, a shared block; bf16 q against the
    plain version (2e-2: bf16 rounding of p and of the output)."""
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.RandomState(14)
    B, H, Dh, bs, nb = 4, 32, 128, 16, 16
    P = B * nb + 1
    tables = rng.randint(1, P, size=(B, nb)).astype(np.int32)
    lengths = np.array([256, 241, 200, 129], np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0
    tables[1, 2] = tables[1, 1]
    if quantized:
        k, v = (torch.from_numpy(rng.randint(-127, 128, (P, H, bs, Dh)
                                             ).astype(np.int8))
                for _ in range(2))
        ks, vs = (torch.from_numpy(((rng.rand(P, H, bs) + .5) / 127
                                    ).astype(np.float32)).to(cuda)
                  for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.randn(P, H, bs, Dh).astype(np.float32)
                                 ).bfloat16() for _ in range(2))
        ks = vs = None
    q = torch.from_numpy(rng.randn(B, H, Dh).astype(np.float32)).bfloat16()
    q, k, v, t, ln = (a.to(cuda) for a in (q, k, v, torch.from_numpy(tables),
                                           torch.from_numpy(lengths)))
    out = pa.paged_gqa(q, k, v, t, ln, scale=Dh ** -0.5, k_scale=ks,
                       v_scale=vs)
    ref = pa.paged_gqa_reference(q, k, v, t, ln, scale=Dh ** -0.5,
                                 k_scale=ks, v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


def _user_wrappers():
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_matmul as smm
    from repro_torch.kernels import sidebar_mlp as sm

    return {
        "sidebar_mlp": (lambda x, wg, wu, wd, a, t: sm.sidebar_mlp(
            x, wg, wd, a, table=t), lambda x, wg, wu, wd, a, t:
            sm.sidebar_mlp_plain(x, wg, wd, a, t)),
        "sidebar_mlp_pipelined": (lambda x, wg, wu, wd, a, t:
                                  sm.sidebar_mlp_pipelined(
                                      x, wg, wd, a, table=t, depth=3),
                                  lambda x, wg, wu, wd, a, t:
                                  sm.sidebar_mlp_plain(x, wg, wd, a, t)),
        "sidebar_gated_mlp": (lambda x, wg, wu, wd, a, t:
                              sg.sidebar_gated_mlp(x, wg, wu, wd, a,
                                                   table=t),
                              lambda x, wg, wu, wd, a, t:
                              sg.sidebar_gated_mlp_plain(x, wg, wu, wd, a,
                                                         t)),
        "sidebar_matmul": (lambda x, wg, wu, wd, a, t: smm.sidebar_matmul(
            x, wg, a, table=t), lambda x, wg, wu, wd, a, t:
            smm.sidebar_matmul_plain(x, wg, a, t)),
        "activation": (lambda x, wg, wu, wd, a, t: ak.activation_2d(
            x, a, table=t), lambda x, wg, wu, wd, a, t:
            ak.activation_plain(x, a, t)),
    }


WRAPPER_NAMES = ["sidebar_mlp", "sidebar_mlp_pipelined", "sidebar_gated_mlp",
                 "sidebar_matmul", "activation"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_run_time_activation_computes_in_every_kernel(cuda, name):
    """mish, registered with a device_expr on a fresh table, runs in the
    kernel (its own library, built at first use) and matches the plain
    version; no file under csrc/ names it."""
    from repro_torch.core.function_table import make_default_table
    from repro_torch.kernels import build

    table = make_default_table()
    table.register("mish", _mish, device_expr=MISH)
    kernel, plain = _user_wrappers()[name]
    ops = _gated_problem(15, 5, 64, 200, cuda)
    before = build.launches[name]
    out = kernel(*ops, "mish", table)
    torch.testing.assert_close(out, plain(*ops, "mish", table), rtol=1e-4,
                               atol=1e-4)
    assert build.launches[name] == before + 1
    assert (name, MISH) in build._loaded
    assert not any("tanhf(log1pf" in p.read_text()
                   for p in build.CSRC.iterdir())


@pytest.mark.gpu
@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_entry_without_device_expr_raises_on_the_card(cuda, name):
    from repro_torch.core.function_table import make_default_table

    table = make_default_table()
    table.register("mish", _mish)
    kernel, _ = _user_wrappers()[name]
    ops = _gated_problem(16, 4, 64, 128, cuda)
    with pytest.raises(NotImplementedError, match="device_expr"):
        kernel(*ops, "mish", table)


@pytest.mark.gpu
@pytest.mark.parametrize("name", WRAPPER_NAMES)
def test_device_expr_is_held_to_its_callable_on_the_card(cuda, name):
    """An expression that does not compute its callable (torch mish
    against ``x * tanhf(x)``) is refused before the kernel launches,
    naming the worst input and both values; mish's right expression
    launches."""
    from repro_torch.core.function_table import make_default_table
    from repro_torch.kernels import build

    table = make_default_table()
    table.register("mish_wrong", _mish, device_expr="x * tanhf(x)")
    table.register("mish", _mish, device_expr=MISH)
    kernel, plain = _user_wrappers()[name]
    ops = _gated_problem(22, 4, 64, 256, cuda)
    before = build.launches[name]
    with pytest.raises(ValueError, match=r"mish_wrong.*at x = .* gives .* "
                                         r"the callable"):
        kernel(*ops, "mish_wrong", table)
    assert build.launches[name] == before
    out = kernel(*ops, "mish", table)
    assert build.launches[name] == before + 1
    torch.testing.assert_close(out, plain(*ops, "mish", table), rtol=1e-4,
                               atol=1e-4)


def _mla_problem(seed, *, b, h, kvr, rope, bs, nb, lengths, device, dtype):
    """An MLA pool with ragged lengths, a duplicated (prefix-shared)
    block and scratch-padded tails; q_lat fp32, q_rope in ``dtype``."""
    rng = np.random.RandomState(seed)
    P = b * nb + 1
    tables = rng.randint(1, P, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0
    tables[1, 2] = tables[1, 1]
    ql = (rng.randn(b, h, kvr) / np.sqrt(kvr)).astype(np.float32)
    qr, ckv, kr = (rng.randn(*shape).astype(np.float32) for shape in
                   ((b, h, rope), (P, bs, kvr), (P, bs, rope)))
    q_lat = torch.from_numpy(ql).to(device)
    rest = [torch.from_numpy(a).to(device=device, dtype=dtype)
            for a in (qr, ckv, kr)]
    return (q_lat, *rest, torch.from_numpy(tables).to(device),
            torch.from_numpy(np.asarray(lengths, np.int32)).to(device))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["smoke", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_pool", "bf16_pool"])
def test_paged_mla_kernel_matches_plain(cuda, shape, dtype):
    """deepseek-v3's absorbed decode: smoke widths (4 heads, kvr 32,
    rope 8, block 8) and full ones (128 heads, kvr 512, rope 64, block
    16, lengths up to 256). Both sides do fp32 math on the same values
    (the kernel online, the plain version in two passes): 1e-4."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    if shape == "smoke":
        dims = dict(b=3, h=4, kvr=32, rope=8, bs=8, nb=4,
                    lengths=[5, 17, 32])
    else:
        dims = dict(b=4, h=128, kvr=512, rope=64, bs=16, nb=16,
                    lengths=[256, 241, 200, 129])
    ops = _mla_problem(17, device=cuda, dtype=dtype, **dims)
    scale = (dims["rope"] + 128) ** -0.5
    before = build.launches["paged_mla"]
    out = pa.paged_mla(*ops, scale=scale)
    ref = pa.paged_mla_reference(*ops, scale=scale)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert build.launches["paged_mla"] == before + 1
    assert torch.equal(out, pa.paged_mla(*ops, scale=scale))


@pytest.mark.gpu
def test_paged_mla_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import paged_attention as pa

    ql, qr, ckv, kr, t, ln = _mla_problem(
        18, b=3, h=4, kvr=32, rope=8, bs=8, nb=4, lengths=[5, 17, 32],
        device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="q_lat"):
        pa.paged_mla(ql.bfloat16(), qr, ckv, kr, t, ln, scale=1.0)
    with pytest.raises(TypeError):
        pa.paged_mla(ql, qr, ckv, kr.float(), t, ln, scale=1.0)
    with pytest.raises(TypeError):
        pa.paged_mla(ql, qr, ckv.to(torch.int8), kr.to(torch.int8), t, ln,
                     scale=1.0)
    with pytest.raises(ValueError, match="int32"):
        pa.paged_mla(ql, qr, ckv, kr, t.long(), ln, scale=1.0)
    with pytest.raises(ValueError, match="MLA shapes"):
        pa.paged_mla(ql, qr, ckv[..., :16].contiguous(), kr, t, ln,
                     scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_mla(ql.transpose(0, 1).contiguous().transpose(0, 1), qr,
                     ckv, kr, t, ln, scale=1.0)
    with pytest.raises(ValueError, match="different devices"):
        pa.paged_mla(ql, qr, ckv, kr, t, ln.cpu(), scale=1.0)
    # widths outside the kernel's limits: a rope of 4 bf16 values is not
    # a whole 16-byte vector
    with pytest.raises(ValueError, match="kvr <= 512"):
        pa.paged_mla(ql, qr[..., :4].contiguous(), ckv,
                     kr[..., :4].contiguous(), t, ln, scale=1.0)


# (B, Hq, Hkv, S, T, Dh, causal): the JAX package's FLASH_CASES, nemotron's
# smoke head_dim 8, a ragged S and T, head_dim 96 and 256
FLASH_CASES = [(2, 4, 4, 128, 128, 64, True), (1, 8, 2, 128, 128, 64, True),
               (2, 4, 2, 128, 256, 32, True), (1, 4, 4, 128, 128, 128, False),
               (1, 2, 1, 256, 256, 64, True), (2, 8, 2, 128, 128, 8, True),
               (1, 4, 2, 100, 130, 16, True), (1, 4, 2, 128, 192, 96, True),
               (1, 2, 1, 64, 192, 256, True)]


def _row_rel_err(out, ref):
    """The worst row's largest error over that row's largest |ref|."""
    o, r = out.float().flatten(0, -2), ref.float().flatten(0, -2)
    return ((o - r).abs().amax(-1)
            / r.abs().amax(-1).clamp_min(1e-30)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_kernel_matches_plain(cuda, case, dtype):
    """Each output row relative to its own largest value: fp32 on both
    sides (the kernel's online softmax against the plain two-pass one)
    1e-5; bf16 (the tensor-core route at head_dim 16-128, the FMA route
    otherwise; p rounded to bf16 on both sides) 2e-2, which one bf16
    ulp of the output (at most 7.8e-3 of the row's largest value) and
    the p roundings stay under."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, s, t, dh, causal = case
    rng = np.random.RandomState(19)
    q, k, v = (torch.from_numpy((rng.randn(*shape) * 0.3).astype(
        np.float32)).to(cuda, dtype) for shape in (
            (b, hq, s, dh), (b, hkv, t, dh), (b, hkv, t, dh)))
    before = build.launches["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    assert out.shape == ref.shape and out.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert _row_rel_err(out, ref) <= tol
    assert build.launches["flash_attention"] == before + 1


# the wgmma route's 128-row q tiles and 128-key tiles: S not a multiple
# of 128, T > S (queries at offset T - S), GQA group 6, and the
# non-causal case; (B, Hq, Hkv, S, T, causal)
FLASH_TC_SHAPES = [(1, 6, 1, 200, 200, True), (1, 12, 2, 130, 300, True),
                   (2, 6, 1, 256, 256, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [16, 64, 96, 128])
@pytest.mark.parametrize("shape", FLASH_TC_SHAPES, ids=str)
def test_flash_bf16_tensor_core_route_at_its_block_size(cuda, shape, dh):
    """Each output row within 2e-2 of its own largest |ref| (the plain
    version on the same bf16 values), as the other bf16 cases."""
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, s, t, causal = shape
    rng = np.random.RandomState(23)
    q, k, v = (torch.from_numpy(rng.randn(*sh).astype(np.float32)).to(
        cuda).bfloat16() for sh in ((b, hq, s, dh), (b, hkv, t, dh),
                                    (b, hkv, t, dh)))
    before = build.launches["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal)
    ref = fa.flash_attention_plain(q, k, v, causal=causal)
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert _row_rel_err(out, ref) <= 2e-2
    assert build.launches["flash_attention"] == before + 1


@pytest.mark.gpu
def test_flash_kernel_bf16_at_head_dim_128(cuda):
    """nemotron's heads (48 / 8, head_dim 128) at S = T = 512, bf16:
    the plain version on the same values rounds p to bf16 too; 3e-2
    covers the bf16 output and the sums' order, and each row is held to
    2e-2 of its own largest value (late rows average hundreds of keys
    and hold values far below the first rows')."""
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.RandomState(20)
    q, k, v = (torch.from_numpy(rng.randn(1, h, 512, 128).astype(
        np.float32)).to(cuda).bfloat16() for h in (48, 8, 8))
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref.float(), rtol=3e-2,
                               atol=3e-2)
    assert _row_rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
def test_flash_kernel_refusals(cuda):
    from repro_torch.kernels import flash_attention as fa

    q = torch.zeros(1, 4, 128, 12, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros(1, 3, 128, 16, device=cuda)
    k = torch.zeros(1, 2, 128, 16, device=cuda)
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(q, k, k)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())


def _autograd_calls(cuda):
    """One small call of every CUDA kernel wrapper, taking the operand
    that is to require grad."""
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_matmul as smm
    from repro_torch.kernels import sidebar_mlp as sm

    w1, wu, w2 = (torch.randn(*s, device=cuda)
                  for s in ((64, 128), (64, 128), (128, 64)))
    kp = torch.randn(5, 2, 8, 16, device=cuda)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    lengths = torch.tensor([9, 16], dtype=torch.int32, device=cuda)
    ckv, kr = torch.randn(5, 8, 32, device=cuda), torch.randn(5, 8, 8,
                                                              device=cuda)
    fk = torch.randn(1, 2, 128, 16, device=cuda)
    return {
        "sidebar_mlp": (torch.randn(4, 64), lambda x: sm.sidebar_mlp(
            x, w1, w2, "relu")),
        "sidebar_mlp_pipelined": (torch.randn(4, 64), lambda x:
                                  sm.sidebar_mlp_pipelined(x, w1, w2,
                                                           "relu")),
        "sidebar_gated_mlp": (torch.randn(4, 64), lambda x:
                              sg.sidebar_gated_mlp(x, w1, wu, w2)),
        "sidebar_matmul": (torch.randn(4, 64), lambda x:
                           smm.sidebar_matmul(x, w1)),
        "activation": (torch.randn(4, 64), lambda x:
                       ak.activation_2d(x, "relu")),
        "paged_gqa": (torch.randn(2, 8, 16), lambda x: pa.paged_gqa(
            x, kp, kp, tables, lengths, scale=0.25)),
        "paged_mla": (torch.randn(2, 4, 32), lambda x: pa.paged_mla(
            x, torch.randn(2, 4, 8, device=cuda), ckv, kr, tables, lengths,
            scale=0.2)),
        "flash_attention": (torch.randn(1, 4, 128, 16), lambda x:
                            fa.flash_attention(x, fk, fk)),
    }


AUTOGRAD_WRAPPERS = ["sidebar_mlp", "sidebar_mlp_pipelined",
                     "sidebar_gated_mlp", "sidebar_matmul", "activation",
                     "paged_gqa", "paged_mla", "flash_attention"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", AUTOGRAD_WRAPPERS)
def test_kernel_wrappers_refuse_autograd(cuda, name):
    """A kernel launched through ctypes returns a tensor with no
    grad_fn: under autograd with an operand that requires grad every
    wrapper raises (and launches nothing) instead of cutting the graph;
    under no_grad the same call launches."""
    from repro_torch.kernels import build

    x, call = _autograd_calls(cuda)[name]
    x = x.to(cuda).requires_grad_(True)
    before = build.launches[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(x)
    assert build.launches[name] == before
    with torch.no_grad():
        call(x)
    assert build.launches[name] == before + 1


def test_autograd_wrappers_cover_every_kernel():
    from repro_torch.kernels import build

    assert sorted(AUTOGRAD_WRAPPERS) == sorted(build.SOURCES)


@pytest.mark.gpu
def test_unembed_gradient_on_the_card(cuda):
    """bf16 logits through one fp32-output GEMM, and its backward (the
    cotangent rounded to bf16, two bf16 GEMMs), against autograd of the
    same products in fp32: 2e-2 covers the bf16 roundings."""
    from repro_torch.models import layers as L

    g = torch.Generator(device=cuda).manual_seed(21)
    x = torch.randn(2, 64, 256, generator=g, device=cuda).bfloat16()
    table = (torch.randn(1024, 256, generator=g, device=cuda) * 0.02
             ).bfloat16()
    cot = torch.randn(2, 64, 1024, generator=g, device=cuda)
    xs, ts = (t.clone().requires_grad_(True) for t in (x, table))
    out = L.unembed(xs, ts)
    assert out.dtype == torch.float32
    out.backward(cot)
    xr, tr = (t.float().requires_grad_(True) for t in (x, table))
    ref = xr @ tr.t()
    ref.backward(cot)
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    for got, want in ((xs.grad, xr.grad), (ts.grad, tr.grad)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), want, rtol=2e-2,
                                   atol=2e-2 * want.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gradients_on_the_card(cuda, remat):
    """Per-layer remat on the card (the nemotron smoke widths in bf16,
    the plain routes): the loss and every gradient match the run that
    keeps all activations. 1e-2 of each leaf's largest gradient allows
    for the order of atomic sums (the embedding's backward)."""
    import dataclasses

    from repro_torch import configs, tree
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(configs.get_smoke_config("nemotron-4-15b"),
                              dtype=torch.bfloat16, remat="none")
    params = T.init(cfg, seed=0, device=cuda)
    toks = torch.from_numpy(np.random.RandomState(22).randint(
        0, cfg.vocab_size, (2, 64)).astype(np.int32)).to(cuda)
    batch = {"tokens": toks, "labels": toks}
    l0, g0 = value_and_grad(lambda p, b: T.loss(p, cfg, b), params, batch)
    cr = dataclasses.replace(cfg, remat=remat)
    l1, g1 = value_and_grad(lambda p, b: T.loss(p, cr, b), params, batch)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=1e-6)
    for a, b in zip(tree.leaves(g1), tree.leaves(g0)):
        assert a.dtype == b.dtype == torch.bfloat16
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= 1e-2 * scale
