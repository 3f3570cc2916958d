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
    bf16, the MoE grouped expert product on both routes and both tc
    shapes, captured and eager), the paged
    pool's host round trip (bf16, int8 with scales, MLA) in place and a
    preempted drain whose replayed segments read restored blocks, a
    run-time activation with a ``device_expr`` through every
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
            "tree.py", "launch/prng.py", "launch/sampling.py",
            "launch/graphs.py", "launch/serve.py",
            "launch/serve_batch.py", "kernels/moe_experts.py",
            "configs/qwen3_14b.py", "configs/llama3_405b.py",
            "configs/llama4_scout_17b.py", "launch/router.py",
            "launch/faults.py", "core/sidebar.py", "launch/spec.py",
            "retrieval/__init__.py", "retrieval/index.py",
            "retrieval/rag.py", "core/engine.py", "core/energy.py",
            "core/policy.py", "core/constants.py", "models/lenet.py"} <= names


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
    from repro_torch import bridge, configs, resolve_device
    from repro_torch.launch.scheduler import (
        ContinuousBatchingServer,
        PagedContinuousBatchingServer,
    )
    from repro_torch.launch.serve import Server
    from repro_torch.models import transformer as T

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    for arch in ("nemotron-4-15b", "qwen3-14b", "llama3-405b",
                 "llama4-scout-17b-a16e"):
        cfg = configs.get_smoke_config(arch)
        params = T.init(cfg, device="cpu")
        for make in (lambda: T.init(cfg),
                     lambda: T.init_cache(cfg, 1, 8),
                     lambda: PagedContinuousBatchingServer(
                         cfg, params, num_slots=1, max_len=16,
                         block_size=8),
                     lambda: ContinuousBatchingServer(cfg, params,
                                                      num_slots=1,
                                                      max_len=16),
                     lambda: Server(cfg, params, max_len=16)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make()
    for make in (lambda: bridge.params_from_jax({"blocks": {}}),
                 lambda: bridge.cache_from_jax({})):
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
@pytest.mark.parametrize("m,dtype", [
    (1, torch.float32), (3, torch.float32), (4, torch.float32),
    (64, torch.float32), (130, torch.float32), (12, torch.bfloat16),
    (16, torch.bfloat16), (64, torch.bfloat16)], ids=str)
@pytest.mark.parametrize("act", ["squared_relu", "relu", "gelu"])
def test_sidebar_mlp_kernel_matches_plain(cuda, m, dtype, act):
    """The serial kernel against the plain version (fp32: 1e-4, the two
    sum in different orders; bf16 against the plain version in fp32 on
    the same values: 2e-2 covers the bf16 rounding of f(h) and of the
    output), and bit for bit equal to the ring at depths 1-4: it is the
    ring with one f(h) slot on the ring's partition, on both routes."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sidebar_mlp as sm

    x, w1, w2 = (torch.from_numpy(a).to(cuda, dtype)
                 for a in _mlp_problem(7, m, 96, 1000))
    before = kops.launch_counts()["sidebar_mlp"]
    out = sm.sidebar_mlp(x, w1, w2, act)
    assert kops.launch_counts()["sidebar_mlp"] == before + 1
    ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(), act)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and out.shape == (m, 96)
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    for t in (1, 2, 3, 4):
        assert torch.equal(out, sm.sidebar_mlp_pipelined(x, w1, w2, act,
                                                         depth=t))


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
@pytest.mark.parametrize("m,k,n,dtype,route", [
    (1, 64, 128, torch.float32, "fma"), (3, 100, 130, torch.float32, "fma"),
    (4, 4096, 64, torch.float32, "fma"),
    (17, 513, 257, torch.float32, "fma"),
    # the tensor-core route: one panel of 8, 16 and 64 rows, K split
    # several ways under the identity, panels of 64 above 64 rows (a
    # ragged last one) and a column tile past N
    (4, 1024, 512, torch.bfloat16, "tc"),
    (16, 1024, 512, torch.bfloat16, "tc"),
    (64, 4096, 384, torch.bfloat16, "tc"),
    (130, 640, 264, torch.bfloat16, "tc"),
    # bf16 widths TMA cannot stride (K, N not multiples of 8): fma
    (4, 100, 260, torch.bfloat16, "fma")], ids=str)
@pytest.mark.parametrize("act", ["identity", "squared_relu", "gelu"])
def test_sidebar_matmul_kernel_matches_plain(cuda, m, k, n, dtype, route,
                                             act):
    """Ragged M, K and N; K split across blocks under the identity only
    (any other epilogue: one block owns the whole K). fp32 against the
    plain version at 1e-4 (the two sum K in different orders); bf16
    against the plain version in fp32 on the same values at 2e-2 (the
    output's bf16 rounding). A second call gives the same bits."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import sidebar_matmul as smm

    rng = np.random.RandomState(9)
    a = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy((rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
                         ).to(cuda, dtype)
    assert smm.operand_route(a, b) == route
    plan = smm.plan(m, k, n, act == "identity", route)
    assert plan.splits == 1 or act == "identity"
    before = kops.launch_counts()["sidebar_matmul"]
    out = smm.sidebar_matmul(a, b, act)
    assert kops.launch_counts()["sidebar_matmul"] == before + 1
    ref = smm.sidebar_matmul_plain(a.float(), b.float(), act)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert out.dtype == dtype and out.shape == (m, n)
    torch.testing.assert_close(out.float(), ref, rtol=tol, atol=tol)
    assert torch.equal(out, smm.sidebar_matmul(a, b, act))


@pytest.mark.gpu
def test_sidebar_matmul_tc_ring_fits_two_blocks_an_sm(cuda):
    """The library's shared memory for the tc route's panel widths
    leaves room for ``TC_BLOCKS_PER_SM`` blocks on an H100 SM (228 KB,
    1 KB reserved a block), which the K split assumes."""
    from repro_torch.kernels import sidebar_matmul as smm

    for m in (4, 16, 32, 64):
        smem = smm.smem_bytes(m, torch.bfloat16, "tc")
        assert 0 < smem and smm.TC_BLOCKS_PER_SM * (smem + 1024) <= 233472


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_sidebar_matmul_device_expr_on_the_tc_route(cuda, m):
    """A run-time activation (mish, ``device_expr``) as the epilogue of
    the tensor-core route: one block owns the whole K."""
    from repro_torch.core.function_table import make_default_table
    from repro_torch.kernels import sidebar_matmul as smm

    table = make_default_table()
    table.register("mish", _mish, device_expr=MISH)
    rng = np.random.RandomState(23)
    a = torch.from_numpy(rng.randn(m, 512).astype(np.float32)).to(
        cuda, torch.bfloat16)
    b = torch.from_numpy((rng.randn(512, 256) / np.sqrt(512)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    assert smm.operand_route(a, b) == "tc"
    assert smm.plan(m, 512, 256, False, "tc").splits == 1
    out = smm.sidebar_matmul(a, b, "mish", table=table)
    ref = smm.sidebar_matmul_plain(a.float(), b.float(), "mish", table)
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


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
    """bf16 widths that TMA cannot stride (D, F or D2 not a multiple of
    8) are no longer refused: they route to the FMA body and compute,
    within 2e-2 of the plain version in fp32, bitwise equal across
    depths 1-4, and the serial kernel gives the same bits."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sidebar_mlp as sm

    rng = np.random.RandomState(23)
    x, w1, w2 = (torch.from_numpy(a).to(cuda).bfloat16() for a in (
        rng.randn(4, d).astype(np.float32),
        (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
        (rng.randn(f, d2) / np.sqrt(f)).astype(np.float32)))
    assert sm.route(x, w1, w2) == "fma"
    before = build.launches["sidebar_mlp_pipelined"]
    outs = [sm.sidebar_mlp_pipelined(x, w1, w2, "squared_relu", depth=t)
            for t in (1, 2, 3, 4)]
    assert build.launches["sidebar_mlp_pipelined"] == before + 4
    ref = sm.sidebar_mlp_plain(x.float(), w1.float(), w2.float(),
                               "squared_relu")
    assert outs[0].shape == (4, d2) and outs[0].dtype == torch.bfloat16
    torch.testing.assert_close(outs[0].float(), ref, rtol=2e-2, atol=2e-2)
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert torch.equal(outs[0], sm.sidebar_mlp(x, w1, w2, "squared_relu"))


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper", ["sidebar_mlp", "sidebar_mlp_pipelined",
                                     "sidebar_gated_mlp"])
def test_unaligned_bf16_operands_compute_on_the_fma_route(cuda, wrapper):
    """A bf16 operand 2 bytes past a 16-byte boundary (TMA cannot take
    it) computes on the FMA body, against the plain version in fp32 at
    2e-2."""
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_mlp as sm

    rng = np.random.RandomState(24)
    base = torch.zeros(4 * 64 + 8, device=cuda, dtype=torch.bfloat16)
    x = base[1:4 * 64 + 1].view(4, 64)
    x.copy_(torch.from_numpy(rng.randn(4, 64).astype(np.float32)))
    w = [torch.from_numpy((rng.randn(*s) / np.sqrt(s[0])).astype(
        np.float32)).to(cuda).bfloat16() for s in ((64, 256), (64, 256),
                                                   (256, 64))]
    if wrapper == "sidebar_gated_mlp":
        ops = (x, *w)
        out = sg.sidebar_gated_mlp(*ops, "silu")
        ref = sg.sidebar_gated_mlp_plain(*(t.float() for t in ops), "silu")
    else:
        ops = (x, w[0], w[2])
        out = getattr(sm, wrapper)(*ops, "squared_relu")
        ref = sm.sidebar_mlp_plain(*(t.float() for t in ops), "squared_relu")
    assert sm.route(*ops) == "fma"
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d2", [6152, 12352])
@pytest.mark.parametrize("m", [4, 16, 64])
def test_pipelined_bf16_walks_a_wide_d2_in_passes(cuda, m, d2):
    """A D2 wider than the columns the consumers' registers hold in one
    pass (12288 on 8-row panels, 6144 on 16- and 32-row ones) is walked
    in passes (a last pass of 8 or of 64 columns): against the plain
    version at 2e-2, bitwise equal across depths 1, 2 and 9, and the
    serial kernel gives the same bits."""
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
    assert torch.equal(outs[0], sm.sidebar_mlp(x, w1, w2, "squared_relu"))


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
@pytest.mark.parametrize("d,f,m", [(4096, 11008, 4), (4096, 11008, 16),
                                   (4096, 11008, 64), (7168, 18432, 4)],
                         ids=["7b-4", "7b-16", "7b-64", "v3-4"])
def test_gated_kernel_at_deepseek_7b_shapes(cuda, d, f, m):
    """bf16 at deepseek-7b's d 4096, d_ff 11008 (decode, a staging round
    of one request and of four) and deepseek-v3's dense 7168 x 18432 at
    decode, on the tc route, against the plain version in fp32 on the
    same values: 2e-2 covers the bf16 rounding of h and of the output;
    a second run gives the same bits."""
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_mlp as sm

    ops = _gated_problem(13, m, d, f, cuda, torch.bfloat16)
    assert sm.route(*ops) == "tc"
    out = sg.sidebar_gated_mlp(*ops, "silu")
    ref = sg.sidebar_gated_mlp_plain(*(t.float() for t in ops), "silu")
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    assert torch.equal(out, sg.sidebar_gated_mlp(*ops, "silu"))
    if d == 7168 and m <= 16:
        assert sg.gated_passes(m, d) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("d2", [64, 96, 12352])
@pytest.mark.parametrize("f", [200, 1000])
@pytest.mark.parametrize("m", [1, 3, 12, 16, 17, 64, 130])
def test_gated_bf16_tc_route_matches_plain(cuda, m, f, d2):
    """The gated kernel's tensor-core route at smoke widths: each panel
    build (8 rows on clusters of 4; 16 and 32 rows on clusters of 8),
    an F whose shares leave a cluster's last sub-tile partial, D2 tiles
    that leave consumers idle and a D2 walked in two passes; against the
    plain version in fp32 at 2e-2; a second run gives the same bits."""
    from repro_torch.kernels import build
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_mlp as sm

    rng = np.random.RandomState(25)
    x, wg, wu, wd = (torch.from_numpy(a).to(cuda).bfloat16() for a in (
        rng.randn(m, 96).astype(np.float32),
        (rng.randn(96, f) / np.sqrt(96)).astype(np.float32),
        (rng.randn(96, f) / np.sqrt(96)).astype(np.float32),
        (rng.randn(f, d2) / np.sqrt(f)).astype(np.float32)))
    assert sm.route(x, wg, wu, wd) == "tc"
    before = build.launches["sidebar_gated_mlp"]
    out = sg.sidebar_gated_mlp(x, wg, wu, wd, "silu")
    assert build.launches["sidebar_gated_mlp"] == before + 1
    ref = sg.sidebar_gated_mlp_plain(x.float(), wg.float(), wu.float(),
                                     wd.float(), "silu")
    assert out.shape == (m, d2) and out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)
    assert torch.equal(out, sg.sidebar_gated_mlp(x, wg, wu, wd, "silu"))


@pytest.mark.gpu
@pytest.mark.parametrize("d,f,d2", [(100, 256, 64), (96, 260, 64),
                                    (96, 256, 68)])
def test_gated_bf16_ragged_widths_take_the_fma_route(cuda, d, f, d2):
    """bf16 widths TMA cannot stride run the stream kernel (fma route),
    against the plain version in fp32 at 2e-2."""
    from repro_torch.kernels import sidebar_gated_mlp as sg
    from repro_torch.kernels import sidebar_mlp as sm

    rng = np.random.RandomState(26)
    ops = [torch.from_numpy(a).to(cuda).bfloat16() for a in (
        rng.randn(4, d).astype(np.float32),
        (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
        (rng.randn(d, f) / np.sqrt(d)).astype(np.float32),
        (rng.randn(f, d2) / np.sqrt(f)).astype(np.float32))]
    assert sm.route(*ops) == "fma"
    out = sg.sidebar_gated_mlp(*ops, "silu")
    ref = sg.sidebar_gated_mlp_plain(*(t.float() for t in ops), "silu")
    assert out.shape == (4, d2)
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


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


def _gqa_problem(seed, *, hkv, group, dh, bs, nb, lengths, kv_dtype,
                 device):
    """A bf16 q against a pool of ``kv_dtype`` (int8 with fp32 scales),
    ragged lengths, scratch-padded tails and a shared block."""
    rng = np.random.RandomState(seed)
    b = len(lengths)
    P = b * nb + 1
    tables = rng.randint(1, P, size=(b, nb)).astype(np.int32)
    for r, ln in enumerate(lengths):
        tables[r, -(-ln // bs):] = 0
    tables[1, 2] = tables[1, 1]
    ks = vs = None
    if kv_dtype == torch.int8:
        k, v = (torch.from_numpy(rng.randint(-127, 128, (P, hkv, bs, dh)
                                             ).astype(np.int8))
                for _ in range(2))
        ks, vs = (torch.from_numpy(((rng.rand(P, hkv, bs) + .5) / 127
                                    ).astype(np.float32)).to(device)
                  for _ in range(2))
    else:
        k, v = (torch.from_numpy(rng.randn(P, hkv, bs, dh).astype(
            np.float32)).to(kv_dtype) for _ in range(2))
    q = torch.from_numpy(rng.randn(b, hkv * group, dh).astype(np.float32)
                         ).to(torch.bfloat16)
    q, k, v, t, ln = (a.to(device) for a in (
        q, k, v, torch.from_numpy(tables),
        torch.from_numpy(np.asarray(lengths, np.int32))))
    return q, k, v, ks, vs, t, ln, dh ** -0.5


@pytest.mark.gpu
@pytest.mark.parametrize("hkv,group", [(8, 6), (32, 1)],
                         ids=["nemotron-48-8", "deepseek-7b-32-32"])
@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8], ids=str)
def test_paged_gqa_split_kv_at_serving_widths(cuda, hkv, group, kv_dtype):
    """Split-KV decode at the served models' widths (head_dim 128, block
    16, lengths up to 256 on a 64-block table: up to 4 live splits of 16
    a row) against the plain version (2e-2: bf16 q, p and output); a
    second call gives the same bits; one launch counted per call."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    q, k, v, ks, vs, t, ln, scale = _gqa_problem(
        41, hkv=hkv, group=group, dh=128, bs=16, nb=64,
        lengths=[256, 241, 200, 129], kv_dtype=kv_dtype, device=cuda)
    before = build.launches["paged_gqa"]
    out = pa.paged_gqa(q, k, v, t, ln, scale=scale, k_scale=ks, v_scale=vs)
    assert build.launches["paged_gqa"] == before + 1
    ref = pa.paged_gqa_reference(q, k, v, t, ln, scale=scale, k_scale=ks,
                                 v_scale=vs)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(out, pa.paged_gqa(q, k, v, t, ln, scale=scale,
                                         k_scale=ks, v_scale=vs))


@pytest.mark.gpu
@pytest.mark.parametrize("hkv,group", [(8, 6), (32, 1)],
                         ids=["nemotron-48-8", "deepseek-7b-32-32"])
def test_paged_gqa_row_alone_equals_row_in_batch(cuda, hkv, group):
    """A row's output is a function of its own q, blocks and length: each
    row served alone, on a table cut to its own blocks, gives the bits it
    gets inside a batch of four with other lengths."""
    from repro_torch.kernels import paged_attention as pa

    q, k, v, _, _, t, ln, scale = _gqa_problem(
        42, hkv=hkv, group=group, dh=128, bs=16, nb=16,
        lengths=[256, 70, 5, 129], kv_dtype=torch.bfloat16, device=cuda)
    batch = pa.paged_gqa(q, k, v, t, ln, scale=scale)
    for r, length in enumerate((256, 70, 5, 129)):
        nb = -(-length // 16)
        alone = pa.paged_gqa(q[r:r + 1].contiguous(), k, v,
                             t[r:r + 1, :nb].contiguous(),
                             ln[r:r + 1].contiguous(), scale=scale)
        assert torch.equal(alone[0], batch[r]), r


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.int8], ids=str)
@pytest.mark.parametrize("dh,group", [(16, 4), (8, 4), (16, 1)])
def test_paged_gqa_masked_splits_and_empty_rows(cuda, kv_dtype, dh, group):
    """Smoke widths (block 8: splits of 64) with a length-0 row (no
    split: its output is 0, as the Pallas kernel's), a row whose second
    split would be fully masked, one whole split and two splits, fp32 q:
    1e-4 against the plain version on the rows that attend something."""
    from repro_torch.kernels import paged_attention as pa

    lengths = [0, 5, 64, 70, 96]
    q, k, v, ks, vs, t, ln, scale = _gqa_problem(
        43, hkv=2, group=group, dh=dh, bs=8, nb=12, lengths=lengths,
        kv_dtype=kv_dtype, device=cuda)
    q = q.float()
    out = pa.paged_gqa(q, k, v, t, ln, scale=scale, k_scale=ks, v_scale=vs)
    ref = pa.paged_gqa_reference(q, k, v, t, ln, scale=scale, k_scale=ks,
                                 v_scale=vs)
    assert not out[0].any()
    torch.testing.assert_close(out[1:], ref[1:], rtol=1e-4, atol=1e-4)


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
    16, lengths up to 256). Both sides do fp32-grade math on the same
    values (the kernel split-KV, on the tc route in TF32 split into high
    and low parts; the plain version in two passes): 1e-4. The full
    widths take the tensor-core route with a bf16 pool, everything else
    the FMA route."""
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa

    if shape == "smoke":
        dims = dict(b=3, h=4, kvr=32, rope=8, bs=8, nb=4,
                    lengths=[5, 17, 32])
    else:
        dims = dict(b=4, h=128, kvr=512, rope=64, bs=16, nb=16,
                    lengths=[256, 241, 200, 129])
    want = "tc" if shape == "full" and dtype == torch.bfloat16 else "fma"
    assert pa.mla_route(dims["kvr"], dims["rope"], dims["bs"], dtype) == want
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
@pytest.mark.parametrize("shape", ["smoke", "full"])
def test_paged_mla_row_alone_equals_row_in_batch(cuda, shape):
    """A row's output is a function of its own q, blocks and length: each
    row served alone, on a table cut to its own blocks, gives the bits it
    gets inside a batch with other lengths (bf16 pool: the fma route at
    smoke widths, the tc route at full ones)."""
    from repro_torch.kernels import paged_attention as pa

    if shape == "smoke":
        dims = dict(b=4, h=4, kvr=32, rope=8, bs=8, nb=12,
                    lengths=[96, 70, 5, 64])
    else:
        dims = dict(b=4, h=128, kvr=512, rope=64, bs=16, nb=16,
                    lengths=[256, 70, 5, 129])
    ql, qr, ckv, kr, t, ln = _mla_problem(19, device=cuda,
                                          dtype=torch.bfloat16, **dims)
    scale = (dims["rope"] + 128) ** -0.5
    batch = pa.paged_mla(ql, qr, ckv, kr, t, ln, scale=scale)
    for r, length in enumerate(dims["lengths"]):
        nb = -(-length // dims["bs"])
        alone = pa.paged_mla(ql[r:r + 1].contiguous(),
                             qr[r:r + 1].contiguous(), ckv, kr,
                             t[r:r + 1, :nb].contiguous(),
                             ln[r:r + 1].contiguous(), scale=scale)
        assert torch.equal(alone[0], batch[r]), r


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["smoke", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32_pool", "bf16_pool"])
def test_paged_mla_length_0_row_gives_zeros(cuda, shape, dtype):
    """A row of length 0 has no split: its output is 0 (the Pallas
    kernel's l == 0 divides by 1); the other rows, among them one whose
    second split is fully masked, stay within 1e-4 of the plain
    version."""
    from repro_torch.kernels import paged_attention as pa

    if shape == "smoke":
        dims = dict(b=4, h=4, kvr=32, rope=8, bs=8, nb=12,
                    lengths=[0, 5, 64, 70])
    else:
        dims = dict(b=4, h=128, kvr=512, rope=64, bs=16, nb=16,
                    lengths=[0, 5, 64, 200])
    ops = _mla_problem(20, device=cuda, dtype=dtype, **dims)
    scale = (dims["rope"] + 128) ** -0.5
    out = pa.paged_mla(*ops, scale=scale)
    ref = pa.paged_mla_reference(*ops, scale=scale)
    assert not out[0].any()
    torch.testing.assert_close(out[1:], ref[1:], rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64])
def test_flexible_dma_chain_has_no_race(cuda, m):
    """FLEXIBLE_DMA's MLP is five programmatic dependent launches
    (producer, its split reduce, the activation, consumer, its split
    reduce): it gives the same bits with a ``torch.cuda.synchronize()``
    between its wrapper calls as without, at full width (bf16, tc
    route, K split on both products), and within 2e-2 of the plain
    version. The buffers each call frees go straight back to the next
    call, so a kernel that touched memory before its wait would show."""
    from repro_torch.core.modes import ExecutionMode
    from repro_torch.kernels import activations as ak
    from repro_torch.kernels import ops
    from repro_torch.kernels import sidebar_matmul as smm

    g = torch.Generator(device=cuda).manual_seed(m)
    d, f = 6144, 24576
    x = torch.randn(m, d, generator=g, device=cuda).bfloat16()
    w1 = (torch.randn(d, f, generator=g, device=cuda) / d ** 0.5).bfloat16()
    w2 = (torch.randn(f, d, generator=g, device=cuda) / f ** 0.5).bfloat16()
    with ops.execution_plan(ExecutionMode.FLEXIBLE_DMA):
        chained = [ops.sidebar_mlp(x, w1, w2, "squared_relu")
                   for _ in range(3)]
    h = smm.sidebar_matmul(x, w1)
    torch.cuda.synchronize()
    h = ak.activation(h, "squared_relu")
    torch.cuda.synchronize()
    synced = smm.sidebar_matmul(h, w2)
    torch.cuda.synchronize()
    for y in chained:
        assert torch.equal(y, synced)
    ref = smm.sidebar_matmul_plain(
        ak.activation_plain(smm.sidebar_matmul_plain(x, w1), "squared_relu"),
        w2)
    torch.testing.assert_close(synced.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)


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


# MoE grouped expert product: (rows, K, N, experts, rows in groups);
# smoke widths, ragged widths (fma for bf16), llama4-scout's decode gate
# (K 5120, N 8192) and deepseek-v3's down product (K 2048, N 7168) over
# a cut expert stack
GROUPED_CASES = [(12, 64, 128, 4, 9), (40, 60, 36, 5, 31),
                 (8, 5120, 8192, 4, 8), (64, 2048, 7168, 16, 50)]


def _grouped_problem(cuda, rows, k, n, e, grouped, dtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    a = torch.randn(rows, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(e, k, n, generator=g, device=cuda) / k ** 0.5).to(dtype)
    # uneven groups, one expert empty, rows past the groups
    cuts = torch.linspace(0, grouped, e + 1).round().int().tolist()
    cuts[1] = cuts[0]
    return a, w, torch.tensor(cuts, dtype=torch.int32, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=str)
@pytest.mark.parametrize("case", GROUPED_CASES, ids=str)
def test_moe_grouped_mm_kernel_matches_plain(cuda, case, dtype):
    """Each row's expert product against the plain version (the same
    fp32 products of the same values, summed in another order: 1e-4 of
    the row's largest), zero past the groups, bit for bit equal to a
    second run and to each row computed alone; the route as the rule
    says."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_experts as me

    rows, k, n, e, grouped = case
    a, w, off = _grouped_problem(cuda, rows, k, n, e, grouped, dtype)
    before = build.launches["moe_grouped_mm"]
    out = me.grouped_mm(a, w, off)
    assert build.launches["moe_grouped_mm"] == before + 1
    want = me.grouped_mm_plain(a, w, off)
    assert _row_rel_err(out[:grouped], want[:grouped]) <= 1e-4
    assert not out[grouped:].any()
    assert torch.equal(out, me.grouped_mm(a, w, off))
    assert me.route(a, w) == ("tc" if dtype == torch.bfloat16
                              and k % 8 == 0 and n % 8 == 0 else "fma")
    for r in (0, grouped - 1):
        e_r = int(me.group_of_rows(off, rows)[r])
        one = torch.tensor([0] * (e_r + 1) + [1] * (e - e_r),
                           dtype=torch.int32, device=cuda)
        alone = me.grouped_mm(a[r:r + 1].contiguous(), w, one)
        assert torch.equal(alone[0], out[r])


@pytest.mark.gpu
def test_moe_grouped_mm_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels import moe_experts as me

    a, w, off = _grouped_problem(cuda, 8, 64, 32, 2, 8, torch.float32)
    with pytest.raises(TypeError):
        me.grouped_mm(a.half(), w.half(), off)
    with pytest.raises(ValueError, match="int32"):
        me.grouped_mm(a, w, off.long())
    with pytest.raises(ValueError, match="offsets"):
        me.grouped_mm(a, w, off.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        me.grouped_mm(a.t().contiguous().t(), w, off)


# The tc route's two shapes at production widths over cut expert stacks:
# (tokens, top-k, K, N, experts, shape). llama4-scout's decode gate
# (three K ranges), deepseek-v3's decode gate (four) and down product
# (one), and llama4-scout's gate at 128 rows a group (the wide shape)
TC_SHAPE_CASES = [(4, 1, 5120, 8192, 16, "narrow"),
                  (4, 8, 7168, 2048, 64, "narrow"),
                  (4, 8, 2048, 7168, 64, "narrow"),
                  (512, 1, 5120, 8192, 4, "wide")]


def _routed_problem(cuda, t, top, k, n, e, seed=0):
    """t tokens' ``top`` distinct experts each, grouped by expert, the
    last token's pairs dropped (rows past the groups)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    ids = torch.rand(t, e, generator=g, device=cuda).argsort(-1)[:, :top]
    counts = torch.bincount(ids[:-1].reshape(-1), minlength=e)
    off = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    a = torch.randn(t * top, k, generator=g, device=cuda).bfloat16()
    w = (torch.randn(e, k, n, generator=g, device=cuda) / k ** 0.5
         ).bfloat16()
    return a, w, off


def _per_group(a, w, off):
    """Each group's rows times its expert, in fp32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = torch.zeros(a.shape[0], w.shape[2], device=a.device)
    o = off.tolist()
    for e in range(w.shape[0]):
        if o[e + 1] > o[e]:
            out[o[e]:o[e + 1]] = a[o[e]:o[e + 1]].float() @ w[e].float()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_SHAPE_CASES, ids=str)
def test_moe_tc_shapes_at_production_widths(cuda, case):
    """Both tc shapes against per-group fp32 products (1e-4 of each row's
    largest), zeros past the groups, one count a call, a second run's
    bits (through a K split too); on the narrow shape a row alone equals
    its row in the batch, on the wide one a row equals itself whatever
    the other rows of its group and batch hold (the same n and groups)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_experts as me

    t, top, k, n, e, shape = case
    a, w, off = _routed_problem(cuda, t, top, k, n, e)
    rows, grouped = a.shape[0], int(off[-1])
    p = me.plan(rows, e, k, n, me.route(a, w))
    assert p.tiles.shape == shape and grouped < rows
    before = build.launches["moe_grouped_mm"]
    out = me.grouped_mm(a, w, off)
    assert build.launches["moe_grouped_mm"] == before + 1
    assert _row_rel_err(out[:grouped], _per_group(a, w, off)[:grouped]) \
        <= 1e-4
    assert not out[grouped:].any()
    assert torch.equal(out, me.grouped_mm(a, w, off))
    group = me.group_of_rows(off, rows)
    if shape == "narrow":
        for r in (0, grouped - 1):
            e_r = int(group[r])
            one = torch.tensor([0] * (e_r + 1) + [1] * (e - e_r),
                               dtype=torch.int32, device=cuda)
            alone = me.grouped_mm(a[r:r + 1].contiguous(), w, one)
            assert me.tc_tiles(1, e, k, n) == p.tiles
            assert torch.equal(alone[0], out[r])
    else:
        other = torch.randn(a.shape, device=cuda).bfloat16()
        for r in (0, grouped - 1):
            other[r] = a[r]
        again = me.grouped_mm(other, w, off)
        for r in (0, grouped - 1):
            assert torch.equal(again[r], out[r])


@pytest.mark.gpu
@pytest.mark.parametrize("case", [TC_SHAPE_CASES[1], TC_SHAPE_CASES[3]],
                         ids=str)
def test_moe_grouped_mm_captured_equals_eager(cuda, case):
    """A call captured in a CUDA graph replays bit for bit as the eager
    call, and, replayed after its inputs and its groups were rewritten in
    place (the same n), as the eager call on the new ones: the launch
    reads nothing on the host."""
    from repro_torch.kernels import moe_experts as me

    t, top, k, n, e, _ = case
    a, w, off = _routed_problem(cuda, t, top, k, n, e)
    a2, _, off2 = _routed_problem(cuda, t, top, k, n, e, seed=1)
    assert not torch.equal(off, off2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        me.grouped_mm(a, w, off)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = me.grouped_mm(a, w, off)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, me.grouped_mm(a, w, off))
    a.copy_(a2)
    off.copy_(off2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, me.grouped_mm(a2, w, off2))


@pytest.mark.gpu
def test_moe_grouped_mm_refuses_a_tc_shape_it_does_not_have(cuda):
    """A plan of other operands, or a tc plan on the fma route, raises
    before any launch."""
    from repro_torch.kernels import build
    from repro_torch.kernels import moe_experts as me

    a, w, off = _routed_problem(cuda, 4, 2, 256, 128, 4)
    p = me.plan(8, 4, 256, 128, "tc")
    before = build.launches["moe_grouped_mm"]
    with pytest.raises(ValueError, match="not a plan"):
        me.launch(a, w[..., :64].contiguous(), off, p)
    with pytest.raises(ValueError, match="fma route"):
        me.launch(a.float(), w.float(), off, p)
    assert build.launches["moe_grouped_mm"] == before
    assert me.launch(a, w, off, p).shape == (8, 128)
    assert build.launches["moe_grouped_mm"] == before + 1


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
    from repro_torch.kernels import moe_experts as me
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
        "moe_grouped_mm": (torch.randn(4, 64), lambda x: me.grouped_mm(
            x, torch.randn(2, 64, 32, device=cuda), torch.tensor(
                [0, 1, 4], dtype=torch.int32, device=cuda))),
    }


AUTOGRAD_WRAPPERS = ["sidebar_mlp", "sidebar_mlp_pipelined",
                     "sidebar_gated_mlp", "sidebar_matmul", "activation",
                     "paged_gqa", "paged_mla", "flash_attention",
                     "moe_grouped_mm"]


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


# ---------------------------------------------------------------------------
# Preemption on the card: the pool's host round trip, in place
# ---------------------------------------------------------------------------


def _pool_cfg(family):
    import dataclasses

    from repro_torch import configs

    arch = "deepseek-v3-671b" if family == "mla" else "nemotron-4-15b"
    cfg = configs.get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg,
                                  capacity_factor=float(cfg.num_experts))
    kv = {"bf16": torch.bfloat16, "int8": torch.int8,
          "mla": torch.bfloat16}[family]
    return dataclasses.replace(cfg, dtype=torch.bfloat16, kv_cache_dtype=kv)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["bf16", "int8", "mla"])
def test_pool_round_trip_on_the_card(cuda, family):
    """Blocks read to pinned host memory and written back into other
    blocks: bit for bit on every leaf (the int8 pool's scales, MLA's
    latent and rope leaves), every leaf at its address."""
    from repro_torch.launch import kvpool as kvp
    from repro_torch.models.registry import get_model

    cfg = _pool_cfg(family)
    mgr = kvp.PagedKVManager(get_model(cfg), cfg, num_blocks=9,
                             block_size=16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for layer in mgr.pool.cache:
        for leaf in layer.values():
            if leaf.dtype.is_floating_point:
                leaf.copy_(torch.randn(leaf.shape, generator=g,
                                       device=cuda))
            else:
                leaf.copy_(torch.randint(-128, 127, leaf.shape, generator=g,
                                         device=cuda))
    names = {n for layer in mgr.pool.cache for n in layer}
    if family == "int8":
        assert any("scale" in n for n in names), names
    ptrs = [leaf.data_ptr() for layer in mgr.pool.cache
            for leaf in layer.values()]
    before = [{k: v.clone() for k, v in layer.items()}
              for layer in mgr.pool.cache]
    blocks = mgr.pool.read_blocks([3, 1, 7])
    assert all(t.is_pinned() for b in blocks for layer in b
               for t in layer.values())
    mgr.pool.write_blocks([2, 8, 4], blocks)
    torch.cuda.synchronize()
    assert ptrs == [leaf.data_ptr() for layer in mgr.pool.cache
                    for leaf in layer.values()]
    for layer, old in zip(mgr.pool.cache, before):
        for name, leaf in layer.items():
            for dst, src in ((2, 3), (8, 1), (4, 7)):
                assert torch.equal(leaf[dst], old[name][src]), name
            for j in (0, 1, 3, 5, 6, 7, 9):
                assert torch.equal(leaf[j], old[name][j]), name


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["bf16", "int8", "mla"])
def test_replayed_segments_read_restored_blocks(cuda, family):
    """A tight pool (two grown spans do not fit) on the card: a warm-up
    drain captures the programs, then the same traffic again: its
    spills and restores write the pool in place between replayed
    segments, and its tokens equal an eager drain's on the same server
    (``disable_capture``), greedy and sampled, with the pool's leaves at
    their addresses."""
    from repro_torch.launch import graphs
    from repro_torch.launch.sampling import SamplingParams
    from repro_torch.launch.scheduler import PagedContinuousBatchingServer
    from repro_torch.models import transformer as T

    cfg = _pool_cfg(family)
    params = T.init(cfg, seed=0, device=cuda)
    srv = PagedContinuousBatchingServer(
        cfg, params, device=cuda, num_slots=2, max_len=48, block_size=8,
        num_blocks=6, segment=4)
    rng = np.random.RandomState(3)
    reqs = [(rng.randint(0, cfg.vocab_size, size=6).astype(np.int32), 18)
            for _ in range(2)]
    samples = [None, SamplingParams(temperature=0.8, top_k=40, seed=13)]
    ptrs = [leaf.data_ptr() for layer in srv.mgr.pool.cache
            for leaf in layer.values()]

    def drain():
        pre = srv.stats.preemptions
        for (p, gen), sp in zip(reqs, samples):
            srv.submit(p, gen, sample=sp)
        done = srv.run()
        assert srv.stats.preemptions > pre and srv.mgr.alloc.in_use == 0
        return [r.tokens for r in done]

    drain()                             # warm-up: every key captured
    replays = sum(p.replays for p in srv.programs())
    captured = drain()
    assert sum(p.replays for p in srv.programs()) > replays
    with graphs.disable_capture():
        eager = drain()
    assert all(np.array_equal(a, b) for a, b in zip(captured, eager))
    assert ptrs == [leaf.data_ptr() for layer in srv.mgr.pool.cache
                    for leaf in layer.values()]
    assert len(srv.spill) == 0 and srv.spill.in_use_bytes == 0
