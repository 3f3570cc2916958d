"""The port's training path held to the JAX package on the CPU.

Across frameworks, on the same weights (``bridge.params_from_jax``) and
tokens made from a seed with numpy, at smoke size (seq 128, batch 2):

  * ``forward`` logits (1e-4) and ``loss`` (1e-5) for the nemotron-4-15b,
    deepseek-7b and deepseek-v3-671b smoke configs, with ``use_pallas``
    on (flash + the Sidebar MLPs; their plain versions on the CPU, the
    Pallas kernels in interpret mode or their references in JAX) and
    off;
  * the gradient of ``loss`` against ``jax.value_and_grad``
    (``use_pallas`` off, as the JAX trainer runs; the three smoke
    configs, deepseek-v3's MoE with its dropping capacity), leaf by leaf
    to 1e-4 of the leaf's largest gradient: fp32 on both sides, summed
    in different orders; and ``remat`` "full" / "dots" equal "none" bit
    for bit on the CPU (nemotron);
  * ``make_batch``'s tokens equal JAX's for steps 0-3;
  * ``adamw_update`` on JAX's own gradients equals JAX's update to 1e-6;
    the schedule, clipping, moment type and the compression codecs'
    properties (``tests/test_optim.py``);
  * one ``make_train_step`` with two microbatches against JAX's: loss and
    grad_norm to 1e-5, parameters after two steps as stated at the test;
  * the port's versions of ``tests/test_checkpoint.py`` (one device, no
    re-sharding) and ``tests/test_ft.py`` (watchdog, trainer resume,
    eviction hook, step-keyed data).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.configs.base import ShapeCell as JShapeCell
from repro.configs.base import TrainConfig as JTrainConfig
from repro.data import pipeline as jdata
from repro.launch.train import make_train_step as jmake_train_step
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro.optim import optimizer as jopt
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch import tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ShapeCell, TrainConfig
from repro_torch.data import pipeline
from repro_torch.ft.watchdog import StragglerWatchdog, Verdict
from repro_torch.launch.train import Trainer, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.layers import HOST
from repro_torch.models.registry import get_model
from repro_torch.optim import compression
from repro_torch.optim.optimizer import (
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_state,
    lr_schedule,
)

ARCHS = ["nemotron-4-15b", "deepseek-7b", "deepseek-v3-671b"]


def _pair(arch, **kw):
    return (dataclasses.replace(jcfg.get_smoke_config(arch), **kw),
            dataclasses.replace(tcfg.get_smoke_config(arch), **kw))


@pytest.fixture(scope="module")
def weights():
    out = {}
    for arch in ARCHS:
        cj, _ = _pair(arch)
        pj = jax.jit(lambda k, cj=cj: jget(cj).init(k, cj))(
            jax.random.PRNGKey(0))
        out[arch] = pj
    return out


def _port(pj):
    return bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                  device="cpu")


def _batch(seed, b, s, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(toks)})


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(weights, arch, use_pallas):
    cj, ct = _pair(arch, use_pallas=use_pallas)
    pj = weights[arch]
    pt = _port(pj)
    bj, bt = _batch(1, 2, 128, ct.vocab_size)
    api = jget(cj)
    want = api.forward(pj, cj, bj)
    got = T.forward(pt, ct, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(T.loss(pt, ct, bt)),
                               float(api.loss(pj, cj, bj)), rtol=1e-5,
                               atol=1e-5)


def _assert_grads_close(got, want, rel=1e-4):
    """Leaf by leaf: |got - want| <= rel x the leaf's largest |want|."""
    for path, g in tree.leaves_with_path(got):
        w = tree.leaves_with_path(want)
        w = dict(w)[path]
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g - w).max() <= rel * scale, (path, np.abs(g - w).max(),
                                                    scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax(weights, arch):
    from repro_torch.launch.train import value_and_grad

    cj, ct = _pair(arch, remat="none")
    pj = weights[arch]
    pt = _port(pj)
    bj, bt = _batch(2, 2, 128, ct.vocab_size)
    lj, gj = jax.jit(lambda p, b: jax.value_and_grad(jget(cj).loss)(
        p, cj, b))(pj, bj)
    lt, gt = value_and_grad(lambda p, b: T.loss(p, ct, b), pt, bt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-5)
    _assert_grads_close(gt, _port(gj))
    if arch != "nemotron-4-15b":
        return
    for remat in ("full", "dots"):
        cr = dataclasses.replace(ct, remat=remat)
        lr_, gr = value_and_grad(lambda p, b: T.loss(p, cr, b), pt, bt)
        assert torch.equal(lr_, lt)
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(gr),
                                                     tree.leaves(gt)))


def test_make_batch_matches_jax():
    cj, ct = _pair("nemotron-4-15b")
    jcell = JShapeCell("smoke", 64, 4, "train")
    cell = ShapeCell("smoke", 64, 4, "train")
    for step in range(4):
        want = jdata.make_batch(cj, jcell, step)
        got = pipeline.make_batch(ct, cell, step, device="cpu")
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(),
                                      np.asarray(want["tokens"]))
        np.testing.assert_array_equal(got["labels"].numpy(),
                                      np.asarray(want["labels"]))
    for want, (step, batch) in zip(range(2, 4), pipeline.stream(
            ct, cell, 2, device="cpu")):
        assert step == want
        assert torch.equal(batch["tokens"], pipeline.make_batch(
            ct, cell, step, device="cpu")["tokens"])
    b1 = pipeline.make_batch(ct, cell, 7, device="cpu")["tokens"]
    assert torch.equal(b1, pipeline.make_batch(ct, cell, 7,
                                               device="cpu")["tokens"])
    assert not torch.equal(b1, pipeline.make_batch(ct, cell, 8,
                                                   device="cpu")["tokens"])


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------


def test_adamw_matches_jax_on_jax_gradients(weights):
    """Three updates fed JAX's own gradients of the nemotron smoke loss
    (scaled up so that clipping acts on the first): parameters and both
    moments to 1e-6 after each."""
    cj, ct = _pair("nemotron-4-15b")
    pj = weights["nemotron-4-15b"]
    pt = _port(pj)
    jt, tt = (JTrainConfig(learning_rate=1e-3, warmup_steps=2),
              TrainConfig(learning_rate=1e-3, warmup_steps=2))
    sj, st = jopt.init_state(pj, jt), init_state(pt, tt)
    grad = jax.jit(lambda p, b: jax.grad(jget(cj).loss)(p, cj, b))
    update = jax.jit(jopt.adamw_update, static_argnums=3)
    for step in range(3):
        bj, _ = _batch(10 + step, 2, 32, ct.vocab_size)
        gj = grad(pj, bj)
        gj = jax.tree.map(lambda g: g * (40.0 if step == 0 else 1.0), gj)
        pj, sj, stats_j = update(pj, gj, sj, jt)
        pt, st, stats_t = adamw_update(pt, _port(gj), st, tt)
        np.testing.assert_allclose(float(stats_t["grad_norm"]),
                                   float(stats_j["grad_norm"]), rtol=1e-6)
        assert float(stats_t["lr"]) == pytest.approx(float(stats_j["lr"]),
                                                     rel=1e-7)
        assert int(st.step) == int(sj.step) == step + 1
        for got, want in ((pt, pj), (st.mu, sj.mu), (st.nu, sj.nu)):
            for a, b in zip(tree.leaves(got), tree.leaves(_port(want))):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-6)


def test_adamw_converges_on_quadratic():
    tcfg_ = TrainConfig(learning_rate=0.1, weight_decay=0.0, warmup_steps=1)
    target = torch.tensor([3.0, -2.0, 0.5])
    params = {"w": torch.zeros(3)}
    state = init_state(params, tcfg_)
    for _ in range(300):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw_update(params, g, state, tcfg_)
    torch.testing.assert_close(params["w"], target, atol=1e-2, rtol=0)


def test_warmup_then_decay():
    tcfg_ = TrainConfig(learning_rate=1e-3, warmup_steps=10)
    lrs = [float(lr_schedule(tcfg_, torch.tensor(s, dtype=torch.int32)))
           for s in (1, 5, 10, 40, 90)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] == pytest.approx(1e-3, rel=1e-5)
    assert lrs[3] == pytest.approx(1e-3 / 2, rel=1e-5)
    assert lrs[4] == pytest.approx(1e-3 / 3, rel=1e-5)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=10)
    for s in (1, 5, 10, 40, 90):
        assert float(lr_schedule(tcfg_, torch.tensor(s))) == float(
            jopt.lr_schedule(jt, jnp.int32(s)))


def test_clip_by_global_norm():
    g = {"a": torch.ones(4) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_moment_dtype_respected():
    st_ = init_state({"w": torch.zeros(4, dtype=torch.bfloat16)},
                     TrainConfig(moment_dtype=torch.bfloat16))
    assert st_.mu["w"].dtype == torch.bfloat16
    assert st_.nu["w"].dtype == torch.bfloat16


def test_bf16_codec_is_near_lossless_for_bf16_scale():
    g = {"w": torch.tensor([0.125, -2.0, 3.5])}
    dec, _ = compression.compress(g, "bf16")
    torch.testing.assert_close(dec["w"], g["w"], rtol=1e-2, atol=0)


def test_int8_ef_error_feedback_property():
    """Cumulative compressed sum tracks the cumulative true sum with
    O(1) error (the EF guarantee), not O(steps)."""
    rng = np.random.default_rng(0)
    ef = compression.init_ef({"w": torch.zeros(64)})
    true_sum = np.zeros(64)
    sent_sum = np.zeros(64)
    for _ in range(100):
        g = {"w": torch.from_numpy((rng.standard_normal(64) * 0.01
                                    ).astype(np.float32))}
        dec, ef = compression.compress(g, "int8_ef", ef)
        true_sum += g["w"].numpy()
        sent_sum += dec["w"].numpy()
    assert np.abs(true_sum - sent_sum).max() < 0.01
    with pytest.raises(ValueError, match="EFState"):
        compression.compress({"w": torch.zeros(4)}, "int8_ef", None)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 1e3])
def test_int8_quantize_bounded_error(scale):
    x = torch.linspace(-scale, scale, 255)
    q, s = compression._quantize_int8(x)
    err = (q.float() * s - x).abs().max()
    assert float(err) <= float(s) * 0.5 + 1e-9


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def test_train_step_with_microbatches_matches_jax(weights):
    """Batch 4 in two strided microbatches of 2 (n_micro = 2), seq 32,
    two steps. Loss and grad_norm to 1e-5. Parameters to 1e-5 absolute
    after two steps: AdamW's first steps move every parameter by about
    lr x m/sqrt(v), a ratio that is insensitive to the gradients'
    summation-order differences (~1e-6 relative), so the two packages'
    parameters differ by far less than lr (1e-3) — unless a gradient's
    sign is itself at the noise level, which 1e-5 (1 % of lr) would
    show."""
    cj, ct = _pair("nemotron-4-15b")
    pj = weights["nemotron-4-15b"]
    pt = _port(pj)
    jt, tt = (JTrainConfig(learning_rate=1e-3, warmup_steps=2,
                           microbatch_per_device=2),
              TrainConfig(learning_rate=1e-3, warmup_steps=2,
                          microbatch_per_device=2))
    jcell, cell = (JShapeCell("smoke", 32, 4, "train"),
                   ShapeCell("smoke", 32, 4, "train"))
    jstep, jn, _ = jmake_train_step(cj, jt, jget(cj), jL.HOST, None, jcell)
    tstep, tn, _ = make_train_step(ct, tt, get_model(ct), HOST, None, cell)
    assert jn == tn == 2
    jstep = jax.jit(jstep)
    sj, st = jopt.init_state(pj, jt), init_state(pt, tt)
    for step in range(2):
        bj = jdata.make_batch(cj, jcell, step)
        bt = pipeline.make_batch(ct, cell, step, device="cpu")
        pj, sj, _, mj = jstep(pj, sj, None, bj)
        pt, st, _, mt = tstep(pt, st, None, bt)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-5)
    for a, b in zip(tree.leaves(pt), tree.leaves(_port(pj))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint.py, one device)
# ---------------------------------------------------------------------------


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(8, 16, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.ones(3, dtype=torch.bfloat16)},
            "layers": [{"w": torch.randn(2, 2, generator=g)}]}


def test_checkpoint_roundtrip(tmp_path):
    m = CheckpointManager(str(tmp_path))
    state = _tree()
    m.save(5, state, meta={"config": "x"})
    restored, manifest = m.restore(5, state)
    assert manifest["step"] == 5
    for a, b in zip(tree.leaves(state), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_and_retention(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree())
    assert m.all_steps() == [3, 4]
    assert m.latest_step() == 4


def test_checkpoint_async_save_then_restore(tmp_path):
    m = CheckpointManager(str(tmp_path))
    state = _tree()
    m.save_async(7, state)
    m.wait()
    restored, _ = m.restore(7, state)
    assert torch.equal(restored["nested"]["b"], state["nested"]["b"])


def test_checkpoint_meta_mismatch_rejected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, _tree(), meta={"config": "A"})
    with pytest.raises(ValueError, match="meta mismatch"):
        m.restore(1, _tree(), expect_meta={"config": "B"})


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"a": torch.ones(4, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        m.restore(1, {"a": torch.ones(8, 4)})


def test_checkpoint_partial_write_is_invisible(tmp_path):
    m = CheckpointManager(str(tmp_path))
    m.save(1, {"a": torch.ones(3)})
    os.makedirs(tmp_path / "step_0000000009")  # no manifest => incomplete
    assert m.all_steps() == [1]
    assert m.latest_step() == 1


# ---------------------------------------------------------------------------
# fault tolerance (tests/test_ft.py)
# ---------------------------------------------------------------------------

CELL = ShapeCell("smoke", seq_len=16, global_batch=4, kind="train")


def test_watchdog_quiet_on_steady_steps():
    wd = StragglerWatchdog(min_samples=4)
    for _ in range(50):
        assert wd.observe(0.10) is Verdict.OK
    assert wd.history == []


def test_watchdog_flags_stragglers_and_escalates():
    wd = StragglerWatchdog(min_samples=4, warn_after=2, evict_after=4)
    for _ in range(16):
        wd.observe(0.10)
    verdicts = [wd.observe(1.0) for _ in range(4)]
    assert verdicts[0] is Verdict.OK
    assert verdicts[1] is Verdict.WARN
    assert verdicts[3] is Verdict.EVICT
    assert len(wd.history) == 4


def test_watchdog_straggler_not_poisoning_baseline():
    wd = StragglerWatchdog(min_samples=4)
    for _ in range(16):
        wd.observe(0.10)
    wd.observe(10.0)
    assert abs(wd.median_step_s - 0.10) < 1e-9


def test_watchdog_tolerates_jitter():
    wd = StragglerWatchdog(min_samples=8)
    rng = np.random.default_rng(0)
    for _ in range(100):
        assert wd.observe(0.1 + rng.normal(0, 0.004)) is Verdict.OK


@pytest.fixture
def tiny():
    cfg = tcfg.get_smoke_config("deepseek-7b")
    return cfg, TrainConfig(microbatch_per_device=4, warmup_steps=2,
                            learning_rate=1e-3)


def test_trainer_runs_and_checkpoints(tmp_path, tiny):
    cfg, tc = tiny
    tr = Trainer(cfg, tc, CELL, ckpt_dir=str(tmp_path), ckpt_every=2,
                 device="cpu")
    rep = tr.run(4)
    assert rep.steps_run == 4
    assert tr.ckpt.latest_step() == 4
    assert np.isfinite(rep.final_loss)


def test_trainer_resume_is_bitwise_deterministic(tmp_path, tiny):
    """Stop after step 3, resume, finish at 6 == an uninterrupted 6-step
    run, bit for bit on the CPU."""
    cfg, tc = tiny
    a = Trainer(cfg, tc, CELL, ckpt_dir=str(tmp_path / "a"), ckpt_every=3,
                device="cpu")
    a.run(3)
    assert a.ckpt.latest_step() == 3
    a2 = Trainer(cfg, tc, CELL, ckpt_dir=str(tmp_path / "a"), ckpt_every=3,
                 device="cpu")
    rep_resumed = a2.run(6)
    assert rep_resumed.resumed_from == 3
    b = Trainer(cfg, tc, CELL, ckpt_dir=str(tmp_path / "b"),
                ckpt_every=100, device="cpu")
    rep_b = b.run(6)
    assert rep_resumed.losses == rep_b.losses[3:]


def test_trainer_eviction_hook_fires(tmp_path, tiny):
    cfg, tc = tiny
    evicted = []
    wd = StragglerWatchdog(min_samples=2, warn_after=1, evict_after=2)
    tr = Trainer(cfg, tc, CELL, ckpt_dir=str(tmp_path), ckpt_every=100,
                 watchdog=wd, on_evict=lambda: evicted.append(True),
                 device="cpu")
    rep = tr.run(9, inject_step_times=lambda step: 0.1 if step < 6 else 5.0)
    assert rep.straggler_events >= 2
    assert rep.evictions >= 1 and evicted
    assert tr.ckpt.latest_step() is not None


def test_trainer_defaults_to_cuda(tmp_path, tiny):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg, tc = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, tc, CELL, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipeline.make_batch(cfg, CELL, 0)
