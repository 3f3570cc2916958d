"""Training on a mesh: the port's FSDP x TP train step held to the JAX
package's one-device step on the CPU.

  * The description: ``transformer.param_specs(cfg, minfo)`` equals the
    JAX package's ``param_specs(cfg, minfo)`` leaf for leaf (its stacked
    layer axis dropped) on the ("data", "model") and ("pod", "data",
    "model") axes, for the six transformer configs, after
    ``sanitize_pspec`` on a (2, 2) / (1, 2, 2) mesh; ``sanitize_pspec``
    and ``input_specs`` / ``batch_shardings`` equal JAX's.
  * The (1, 1) gloo host mesh: three ``make_jitted_train_step`` steps
    bit for bit equal to the meshless port step (nemotron), 0 bytes.
  * The (2, 2) world (four spawned gloo ranks, one world for every
    case): qwen3-14b, nemotron-4-15b and deepseek-v3-671b smoke (fp32,
    MoE at no-drop capacity), 2 strided microbatches, 3 steps each: loss,
    grad_norm and lr equal JAX's ``make_train_step(..., mesh=None)`` on
    bridged weights to 1e-5; the gathered parameters and moments to 1e-5
    absolute (the bound of ``tests/test_torch_train.py``: AdamW's first
    steps move a parameter by about lr x m / sqrt(v), insensitive to the
    gradients' summation order); each rank's resident parameter bytes
    equal its shards' bytes.
  * A binding clip (``grad_clip`` 0.05 under grad norms near 3) and
    ``int8_ef`` on the mesh equal the meshless port run over 2 steps:
    metrics to 1e-5, the clipped run's parameters to 1e-5 absolute;
    two rounds of the int8 codec on shards equal the meshless codec bit
    for bit.
  * deepseek-v3 at data = 2 with its dropping capacity (1.25): each
    rank's loss equals the port's meshless loss of its own rows (capacity
    from the data-local tokens, the reference's ``shard_map`` rule) to
    1e-5; the "dense" dispatch's mean equals the meshless loss of the
    whole batch (the host rule) to 1e-5; the two differ.
  * Partial gradients: every leaf replicated over "model" (norms, the
    router, MLA's latent projections, qwen3's qk norms) gets the same
    gradient on every rank, equal to the meshless gradient to 1e-4 of the
    leaf's largest (fp32, summed in another order): a missing
    ``copy_to_model`` leaves a partial gradient on each model rank. A
    backward run in another thread than its forward (as autograd's
    device thread runs it on the card) gives the same gradients bit for
    bit: the remat recompute carries the forward's context.
  * ``constrain`` raises on a batch-replicated tensor.
  * ``Trainer(mesh=(2, 2))``: checkpoint at step 2, resume to 4: the
    losses equal the uninterrupted run's bit for bit; the mesh's
    checkpoint resumes on one device and a one-device checkpoint on the
    mesh, their losses equal the other side's to 1e-5.
  * The ZeRO-3 gather's bytes by kind equal the sum computed from the
    shards' shapes.

The spawned children import ``tests/torch_train_ranks.py`` and the port
only; the world has its own deadline (``parallel.ranks``).
"""

import dataclasses
import os
import shutil
import threading
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jdata
from repro.launch import input_specs as jinput
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.configs.base import ShapeCell
from repro_torch.data import pipeline
from repro_torch.launch import input_specs
from repro_torch.launch.mesh import CANONICAL_AXES, Mesh, make_host_mesh
from repro_torch.launch.train import (
    Trainer,
    make_jitted_train_step,
    make_train_step,
    value_and_grad,
)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.optim.optimizer import init_state
from repro_torch.parallel import hints, ranks
from repro_torch.parallel import tp as tplib

import torch_train_ranks as R

SMOKE_ARCHS = ("nemotron-4-15b", "deepseek-7b", "deepseek-v3-671b",
               "qwen3-14b", "llama3-405b", "llama4-scout-17b-a16e")
TIMEOUT = 300        # seconds the spawned world may take (on a loaded host)
GRAD_ARCHS = ("deepseek-v3-671b", "qwen3-14b")
VARIANTS = {"clip": {"grad_clip": 0.05},
            "int8_ef": {"grad_compression": "int8_ef"}}
VARIANT_STEPS = 2


def _jcfg(arch, **kw):
    cfg = jcfg.get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return dataclasses.replace(cfg, **kw)


def _jparams(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jget(cfg).init(jax.random.PRNGKey(seed), cfg))


def _cpu_mesh(shape):
    """A mesh record without groups: enough to sanitize and to cut."""
    return Mesh(shape=shape, axis_names=CANONICAL_AXES[len(shape)],
                device=torch.device("cpu"), group=None, rank=0,
                backend="gloo")


def _jax_mesh(shape):
    return types.SimpleNamespace(axis_names=CANONICAL_AXES[len(shape)],
                                 devices=np.empty(shape))


def _norm(entries) -> tuple:
    """A description leaf as ``PartitionSpec`` prints it: a tuple of one
    axis name is that name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _batch_np(cfg, seed=5):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (R.BATCH, R.SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": toks}


def _close_trees(got, want, atol):
    gl, wl = tree.leaves_with_path(got), tree.leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        err = float(np.abs(g - w).max())
        assert err <= atol, (path, err)


# -- the description ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 2), (1, 2, 2)], ids=["pod1", "pod3"])
@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_description_equals_jax(arch, shape):
    """Both axes, leaf for leaf, after ``sanitize_pspec`` on each side."""
    axes = CANONICAL_AXES[len(shape)]
    cj, ct = _jcfg(arch), tcfg.get_smoke_config(arch)
    jspecs = jget(cj).param_specs(cj, jL.MeshInfo.from_axes(axes))
    port = T.param_specs(ct, L.MeshInfo.from_axes(axes))
    shapes = T.param_shapes(ct)
    pm, jm = _cpu_mesh(shape), _jax_mesh(shape)

    def jsan(spec):
        return _norm(jL.sanitize_pspec(jm, spec.pspec, spec.shape))

    def psan(spec, shp):
        return _norm(L.sanitize_pspec(pm, spec, shp[0]))

    for name in ("embed", "final_norm"):
        assert psan(port[name], shapes[name]) == jsan(jspecs[name]), name
    kinds = T.layer_kinds(ct)
    checked = 0
    for kind in ("dense", "moe"):
        flat, _ = jax.tree_util.tree_flatten_with_path(
            jspecs["blocks"].get(kind, {}), is_leaf=jL.is_spec)
        for path, spec in flat:
            keys = [k.key for k in path]
            want = jsan(spec)[1:]                  # the stacked layer axis
            for i in (i for i, k in enumerate(kinds) if k == kind):
                leaf, shp = port["layers"][i], shapes["layers"][i]
                for k in keys:
                    leaf, shp = leaf[k], shp[k]
                assert psan(leaf, shp) == want, (arch, kind, keys)
                checked += 1
    leaves: list = []
    tree.map_with_spec(lambda a, _: leaves.append(a), shapes["layers"],
                       shapes["layers"])
    assert checked == len(leaves)          # every port leaf was matched


@pytest.mark.parametrize("dims,shape", [
    ((("data",), None), (1, 4)), ((("data",), None), (4, 4)),
    ((("pod", "data"), "model"), (6, 8)), (("model", ("data",)), (3, 8)),
    ((None, ("pod", "data"), None), (2, 7, 3))])
def test_sanitize_pspec_equals_jax(dims, shape):
    pm, jm = _cpu_mesh((1, 2, 2)), _jax_mesh((1, 2, 2))
    assert _norm(L.sanitize_pspec(pm, dims, shape)) == _norm(
        jL.sanitize_pspec(jm, jax.sharding.PartitionSpec(*dims), shape))


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "llama-3.2-vision-90b"])
def test_input_specs_and_batch_rows(arch):
    """``input_specs``' shapes are JAX's; ``batch_shardings`` is the
    sanitized batch spec JAX's builds (its NamedShardings need a device
    mesh: their spec is rebuilt here with JAX's ``sanitize_pspec``)."""
    cj, ct = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
    jcell, cell = (JShapeCell("c", 16, 6, "train"),
                   ShapeCell("c", 16, 6, "train"))
    want = jinput.input_specs(cj, jcell)
    got = input_specs.input_specs(ct, cell)
    assert {k: s.shape for k, s in want.items()} == {
        k: shp for k, (shp, _) in got.items()}
    minfo = L.MeshInfo.from_axes(("data", "model"), {"data": 2, "model": 2})
    for shape in ((2, 2), (4, 1)):
        psh = input_specs.batch_shardings(ct, cell, _cpu_mesh(shape), minfo)
        assert {k: _norm(v) for k, v in psh.items()} == {
            k: _norm(jL.sanitize_pspec(
            _jax_mesh(shape), jax.sharding.PartitionSpec(
                ("data",), *([None] * (len(s.shape) - 1))), s.shape))
            for k, s in want.items()}
    # a rank's rows: a contiguous block of the global batch
    batch = pipeline.make_batch(ct, cell, 0, device="cpu")
    for row in range(2):
        mesh = dataclasses.replace(_cpu_mesh((2, 2)), fsdp_rank=row)
        mine = pipeline.shard_batch(batch, mesh, minfo)
        for k, x in batch.items():
            assert torch.equal(mine[k], x[row * 3:(row + 1) * 3]), k


# -- the (1, 1) host mesh ------------------------------------------------------

def test_host_mesh_steps_bit_exact():
    """Three ``make_jitted_train_step`` steps on a (1, 1) gloo mesh equal
    the meshless port step bit for bit: losses, grad norms, parameters
    and moments; no byte counted."""
    ct = R.port_cfg("nemotron-4-15b")
    api, cell = get_model(ct), R.cell()
    tc = dataclasses.replace(R.train_cfg(), microbatch_per_device=4)
    mesh = make_host_mesh(device="cpu")
    step, specs, p_shard, o_shard, n_micro, use_ef = make_jitted_train_step(
        ct, tc, api, mesh, cell)
    assert n_micro == 2 and not use_ef and o_shard.mu is p_shard
    assert specs == T.param_specs(ct, L.SINGLE_POD)
    solo, solo_n, _ = make_train_step(ct, tc, api, L.HOST, None, cell)
    assert solo_n == n_micro
    full = api.init(ct, seed=3, device="cpu")
    pm = p_shard.place(tree.map_leaves(lambda t: t.clone(), full))
    ps = full
    om, os_ = init_state(pm, tc), init_state(ps, tc)
    tplib.reset_coll_bytes()
    for s in range(R.STEPS):
        batch = pipeline.make_batch(ct, cell, s, device="cpu")
        pm, om, _, mm = step(pm, om, None, pipeline.shard_batch(
            batch, mesh, L.MeshInfo.from_axes(mesh.axis_names)))
        ps, os_, _, ms = solo(ps, os_, None, batch)
        assert all(torch.equal(mm[k], ms[k]) for k in ms), s
    for a, b in zip(tree.leaves((pm, om.mu, om.nu)),
                    tree.leaves((ps, os_.mu, os_.nu))):
        assert torch.equal(a, b)
    assert not any(tplib.collective_bytes().values())


def test_mesh_training_refuses_families_without_description():
    mesh = make_host_mesh(device="cpu")
    for arch in ("rwkv6-7b", "zamba2-7b", "whisper-medium"):
        cfg = tcfg.get_smoke_config(arch)
        with pytest.raises(NotImplementedError, match="item 6"):
            make_jitted_train_step(cfg, R.train_cfg(), get_model(cfg), mesh,
                                   R.cell())


def test_constrain_raises_on_batch_replicated_tensor():
    minfo = L.MeshInfo.from_axes(("data", "model"), {"data": 2, "model": 2})
    x = torch.zeros(8, 16, 4)
    assert hints.constrain(x, ("batch", None, None)) is x     # no hints
    with hints.sharding_hints(object(), minfo, batch=16):
        assert hints.constrain(x, ("batch", None, None)) is x
        with pytest.raises(ValueError, match="batch-replicated"):
            hints.constrain(torch.zeros(16, 16, 4), ("batch", None, None))
        # a dim that is not the batch is not checked
        assert hints.constrain(x, (None, "model", None)) is x


# -- the (2, 2) world ------------------------------------------------------------

def _jax_steps(arch):
    cj = _jcfg(arch)
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=2,
                      microbatch_per_device=R.MICRO)
    jcell = JShapeCell("mesh", R.SEQ, R.BATCH, "train")
    # one device: n_micro = 8 // 2 = 4 there; the mesh's global
    # microbatches are the 2 strided halves, so the reference takes 2
    jstep, n, _ = jmake_train_step(
        cj, dataclasses.replace(jt, microbatch_per_device=R.MICRO * 2),
        jget(cj), jL.HOST, None, jcell)
    assert n == 2
    jstep = jax.jit(jstep)
    from repro.optim import optimizer as jopt

    state = jopt.init_state(pj, jt)
    metrics = []
    for s in range(R.STEPS):
        pj, state, _, m = jstep(pj, state, None,
                                jdata.make_batch(cj, jcell, s))
        metrics.append({k: float(v) for k, v in m.items()})
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return metrics, np_(pj), np_(state.mu), np_(state.nu)


def _port_steps(arch, np_params, tkw, seed_steps=VARIANT_STEPS):
    """The meshless port step with the world's global microbatches."""
    ct = R.port_cfg(arch)
    tc = dataclasses.replace(R.train_cfg(**tkw),
                             microbatch_per_device=R.MICRO * 2)
    step, n, use_ef = make_train_step(ct, tc, get_model(ct), L.HOST, None,
                                      R.cell())
    assert n == 2
    from repro_torch.optim import compression

    params = bridge.params_from_jax(np_params, device="cpu")
    opt = init_state(params, tc)
    ef = compression.init_ef(params) if use_ef else None
    metrics = []
    for s in range(seed_steps):
        params, opt, ef, m = step(params, opt, ef, pipeline.make_batch(
            ct, R.cell(), s, device="cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One spawned (2, 2) world runs every job while this process runs
    the JAX package's steps and the meshless port's references."""
    params = {a: _jparams(_jcfg(a)) for a in R.TRAIN_ARCHS}
    grads_batch = {a: _batch_np(R.port_cfg(a)) for a in GRAD_ARCHS}
    moe_batch = _batch_np(R.port_cfg("deepseek-v3-671b"), seed=7)
    root = tmp_path_factory.mktemp("mesh-train")
    dirs = {k: str(root / k) for k in ("mesh", "whole", "one")}
    trainer_cfg = R.port_cfg("nemotron-4-15b")
    one = Trainer(trainer_cfg, R.train_cfg(), R.cell(), ckpt_dir=dirs["one"],
                  ckpt_every=2, device="cpu")
    one.run(2)
    jobs = {
        "steps": {**{a: (a, {}, {}, params[a], R.STEPS)
                     for a in R.TRAIN_ARCHS},
                  **{v: ("nemotron-4-15b", {}, kw, params["nemotron-4-15b"],
                         VARIANT_STEPS) for v, kw in VARIANTS.items()}},
        "grads": {a: (a, params[a], grads_batch[a]) for a in GRAD_ARCHS},
        "moe": ("deepseek-v3-671b", params["deepseek-v3-671b"], moe_batch),
        "bytes": ("nemotron-4-15b", params["nemotron-4-15b"]),
        "codec": ("deepseek-v3-671b", params["deepseek-v3-671b"]),
        "trainer": ("nemotron-4-15b", dirs),
    }
    box: dict = {}

    def run():
        try:
            box["ranks"] = ranks.run_ranks(
                R.train_world, 4, timeout=TIMEOUT,
                store_dir=str(root), args=(jobs,))
        except BaseException as e:          # reported by the tests
            box["error"] = e

    th = threading.Thread(target=run)
    th.start()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)        # the four ranks share the host
    try:
        ref = _references(params, grads_batch, moe_batch, trainer_cfg, root)
    finally:
        torch.set_num_threads(threads)
    th.join(TIMEOUT + 30)
    assert not th.is_alive(), "the (2, 2) world outlived its deadline"
    if "error" in box:
        raise box["error"]
    return box["ranks"], ref, dirs, root


def _references(params, grads_batch, moe_batch, trainer_cfg, root) -> dict:
    """JAX's steps, the meshless port's variants, gradients and MoE
    losses, and the one-device trainer's uninterrupted losses."""
    ref = {"jax": {a: _jax_steps(a) for a in R.TRAIN_ARCHS},
           "variants": {v: _port_steps("nemotron-4-15b",
                                       params["nemotron-4-15b"], kw)
                        for v, kw in VARIANTS.items()}}
    grads = {}
    for a in GRAD_ARCHS:
        ct = dataclasses.replace(R.port_cfg(a), remat="none")
        pt = bridge.params_from_jax(params[a], device="cpu")
        b = {k: torch.from_numpy(v) for k, v in grads_batch[a].items()}
        _, g = value_and_grad(lambda p, b: T.loss(p, ct, b), pt, b)
        grads[a] = dict(tree.leaves_with_path(g))
    ref["grads"] = grads
    ct = R.port_cfg("deepseek-v3-671b", capacity_factor=1.25)
    pt = bridge.params_from_jax(params["deepseek-v3-671b"], device="cpu")
    b = {k: torch.from_numpy(v) for k, v in moe_batch.items()}
    with torch.no_grad():
        half = R.BATCH // 2
        ref["moe"] = {
            "rows": [float(T.loss(pt, ct, {k: x[i * half:(i + 1) * half]
                                           for k, x in b.items()}))
                     for i in range(2)],
            "whole": float(T.loss(pt, ct, b))}
    ref["one_whole"] = Trainer(trainer_cfg, R.train_cfg(), R.cell(),
                               ckpt_dir=str(root / "one-whole"),
                               ckpt_every=100, device="cpu").run(4).losses
    return ref


def _rank0(results):
    return next(r for r in results if r["coords"] == (0, 0))


@pytest.mark.parametrize("arch", R.TRAIN_ARCHS)
def test_mesh_steps_equal_jax(world, arch):
    results, ref, _, _ = world
    want, jparams, jmu, jnu = ref["jax"][arch]
    for r in results:
        got = r["steps"][arch]
        assert got["n_micro"] == 2
        assert got["resident_bytes"] == got["shard_bytes"]
        for g, w in zip(got["metrics"], want):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{arch} {k}")
    got = _rank0(results)["steps"][arch]
    for name, jtree in (("params", jparams), ("mu", jmu), ("nu", jnu)):
        _close_trees(got[name], bridge.params_from_jax(jtree, device="cpu"),
                     atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_clip_and_int8_equal_meshless(world, variant):
    """Metrics to 1e-5. Parameters to 1e-5 absolute under the binding
    clip. Under ``int8_ef`` a gradient element at a rounding boundary of
    the int8 grid (the fp32 sums' order differs) lands one quantum away,
    and AdamW turns that into up to lr: its codec is held bit for bit
    below instead (``test_int8_codec_uses_the_whole_tensors_amax``)."""
    results, ref, _, _ = world
    want, params = ref["variants"][variant]
    if variant == "clip":
        assert all(m["grad_norm"] > VARIANTS["clip"]["grad_clip"] * 10
                   for m in want), "the clip does not bind"
    for r in results:
        for g, w in zip(r["steps"][variant]["metrics"], want):
            for k in ("loss", "grad_norm", "lr"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-5)
    if variant == "clip":
        _close_trees(_rank0(results)["steps"][variant]["params"], params,
                     atol=1e-5)


def test_int8_codec_uses_the_whole_tensors_amax(world):
    """Two rounds of ``int8_ef`` on shards equal the meshless codec on
    the whole tree bit for bit: decoded values and residual (a shard's
    own amax would put it on another grid)."""
    from repro_torch.optim import compression

    results, _, _, _ = world
    got = _rank0(results)["codec"]
    pj = _jparams(_jcfg("deepseek-v3-671b"))
    grads = bridge.params_from_jax(pj, device="cpu")
    ef = compression.init_ef(grads)
    for i in range(2):
        g = {"embed": grads["embed"] + 0.01 * i,
             "final_norm": grads["final_norm"], "layers": grads["layers"]}
        dec, ef = compression.compress(g, "int8_ef", ef)
    _close_trees(got["dec"], dec, atol=0.0)
    _close_trees(got["residual"], ef.residual, atol=0.0)


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_replicated_params_get_the_full_gradient(world, arch):
    """Every leaf replicated over "model": the same gradient on all four
    ranks, equal to the meshless one (1e-4 of the leaf's largest)."""
    results, ref, _, _ = world
    want = ref["grads"][arch]
    # a backward in another thread (autograd's device thread on the card)
    # re-gathers in its remat recompute: the same gradients
    assert all(r["grads"][arch]["other_thread_equal"] for r in results)
    paths = set(results[0]["grads"][arch]["grads"])
    assert any("router" in p for p in paths) == (arch != "qwen3-14b")
    assert any("norm" in p for p in paths)
    for path in paths:
        w = want[path].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        first = results[0]["grads"][arch]["grads"][path]
        for r in results:
            g = r["grads"][arch]["grads"][path]
            np.testing.assert_array_equal(g, first, err_msg=path)
            assert float(np.abs(g - w).max()) <= 1e-4 * scale, (
                arch, path, float(np.abs(g - w).max()), scale)


def test_moe_capacity_is_data_local(world):
    results, ref, _, _ = world
    for r in results:
        row = r["coords"][0]
        np.testing.assert_allclose(r["moe"]["shard_map"]["local"],
                                   ref["moe"]["rows"][row], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["moe"]["dense"]["mean"],
                                   ref["moe"]["whole"], rtol=1e-5, atol=1e-5)
    # the local-capacity rule drops other tokens than the global one
    assert abs(results[0]["moe"]["shard_map"]["mean"]
               - results[0]["moe"]["dense"]["mean"]) > 1e-4


def test_zero_gather_bytes_from_shard_shapes(world):
    results, _, _, _ = world
    for r in results:
        want = dict.fromkeys(r["bytes"]["counted"], 0.0)
        for shape, size, spec in r["bytes"]["shards"]:
            n = float(np.prod(shape)) * size
            if tplib.fsdp_dim(spec) is None:
                want["all-reduce"] += 2 * n
            else:
                want["all-gather"] += 2 * n          # the gathered buffer
                want["reduce-scatter"] += n          # the shard
        assert r["bytes"]["counted"] == want


def test_trainer_on_mesh_checkpoints_both_ways(world):
    results, ref, dirs, root = world
    for r in results:
        t = r["trainer"]
        assert t["resumed_from"] == 2 and t["resumed"] == t["whole"][2:]
        assert t["first"] == t["whole"][:2]
        assert t["from_one_resumed_from"] == 2
        np.testing.assert_allclose(t["from_one"], ref["one_whole"][2:3],
                                   rtol=1e-5)
        np.testing.assert_allclose(t["whole"], ref["one_whole"], rtol=1e-5)
    # the mesh's step-2 checkpoint resumes on one device
    d = str(root / "mesh-at-2")
    shutil.copytree(dirs["mesh"], d)
    shutil.rmtree(os.path.join(d, f"step_{4:010d}"))
    one = Trainer(R.port_cfg("nemotron-4-15b"), R.train_cfg(), R.cell(),
                  ckpt_dir=d, ckpt_every=100, device="cpu").run(4)
    assert one.resumed_from == 2
    np.testing.assert_allclose(one.losses,
                               _rank0(results)["trainer"]["whole"][2:],
                               rtol=1e-5)
