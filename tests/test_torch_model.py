"""The port's dense GQA model against the JAX package's, on the same
weights (loaded through ``repro_torch.bridge``) and the same tokens
(made from a seed with numpy), at the nemotron-4-15b smoke size.

Tolerance: logits within atol 1e-5 / rtol 1e-4 — fp32 on both sides,
summed in different orders (XLA's CPU dot vs the port's fixed-order
accumulation). Greedy tokens must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.modes import ExecutionMode
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.mlp import mlp, mlp_param_shapes

TOL = dict(rtol=1e-4, atol=1e-5)
VARIANTS = ["fp32", "int8", "kernels"]


def _cfgs(variant):
    cj = jcfg.get_smoke_config("nemotron-4-15b")
    ct = tcfg.get_smoke_config("nemotron-4-15b")
    if variant == "int8":
        cj = dataclasses.replace(cj, kv_cache_dtype=jnp.int8)
        ct = dataclasses.replace(ct, kv_cache_dtype=torch.int8)
    if variant == "kernels":
        # JAX: the Sidebar MLP op (its jnp reference off the TPU); port:
        # kops.sidebar_mlp (the plain version on the CPU)
        cj = dataclasses.replace(cj, use_pallas=True)
        ct = dataclasses.replace(ct, use_pallas=True)
    return cj, ct


@pytest.fixture(scope="module")
def weights():
    cj, _ = _cfgs("fp32")
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    return pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                   device="cpu")


def test_config_mirrors_jax():
    for get in ("get_config", "get_smoke_config"):
        cj = getattr(jcfg, get)("nemotron-4-15b")
        ct = getattr(tcfg, get)("nemotron-4-15b")
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "head_dim", "activation",
                  "gated_mlp", "rope_theta", "norm_eps"):
            assert getattr(ct, f) == getattr(cj, f), (get, f)
        assert str(ct.dtype).split(".")[-1] == jnp.dtype(cj.dtype).name


def test_param_shapes_mirror_jax(weights):
    pj, pt = weights
    assert tuple(pt["embed"].shape) == pj["embed"].shape
    stack = pj["blocks"]["dense"]
    assert len(pt["layers"]) == stack["attn_norm"].shape[0]
    for name in ("wq", "wk", "wv", "wo"):
        assert tuple(pt["layers"][1]["attn"][name].shape) == \
            stack["attn"][name].shape[1:]
    assert tuple(pt["layers"][0]["mlp"]["w_down"].shape) == \
        stack["mlp"]["w_down"].shape[1:]


def test_init_scales_and_seed():
    """materialize's scales: 1/sqrt(fan_in) matrices, 0.02 embedding,
    ones for norms; the same seed gives the same weights."""
    cfg = tcfg.get_smoke_config("nemotron-4-15b")
    a = T.init(cfg, seed=3, device="cpu")
    b = T.init(cfg, seed=3, device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w_up"],
                       b["layers"][1]["mlp"]["w_up"])
    w = a["layers"][0]["mlp"]["w_down"]                  # fan_in d_ff
    assert abs(w.std().item() - cfg.d_ff ** -0.5) < 0.1 * cfg.d_ff ** -0.5
    assert abs(a["embed"].std().item() - 0.02) < 0.002
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))


def test_entry_points_need_a_device_on_a_cpu_only_box():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    cfg = tcfg.get_smoke_config("nemotron-4-15b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 8)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefill_and_decode_match_jax(variant, weights):
    """Prefill logits, N decode-step logits, greedy tokens and the KV
    cache itself agree with the JAX model on the same weights."""
    cj, ct = _cfgs(variant)
    pj, pt = weights
    api = jget(cj)
    cache_j = api.init_cache(cj, jL.HOST, 2, 32)
    cache_t = T.init_cache(ct, 2, 32, device="cpu")
    toks = np.random.RandomState(0).randint(0, 512, (2, 9)).astype(np.int32)
    lj, cache_j = api.prefill(pj, cj, {"tokens": jnp.asarray(toks)},
                              cache_j)
    lt, cache_t = T.prefill(pt, ct, {"tokens": torch.from_numpy(toks)},
                            cache_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    nj = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
    nt = torch.argmax(lt[:, -1], -1)[:, None]
    for step in range(5):
        assert np.array_equal(nt.numpy(), nj), step
        lj, cache_j = api.decode_step(pj, cj, jnp.asarray(nj), cache_j,
                                      jnp.int32(9 + step))
        lt, cache_t = T.decode_step(pt, ct, nt, cache_t, 9 + step)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        nj = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
        nt = torch.argmax(lt[:, -1], -1)[:, None]
    mine = bridge.cache_to_numpy(cache_t)["dense"]
    for name, ref in cache_j["dense"].items():
        np.testing.assert_allclose(mine[name].astype(np.float32),
                                   np.asarray(ref, np.float32), atol=2e-5,
                                   rtol=1e-4, err_msg=name)


def test_rowwise_decode_matches_jax(weights):
    """Per-row (B,) positions: RoPE, masks and KV writes key off each
    row's own position."""
    cj, ct = _cfgs("fp32")
    pj, pt = weights
    api = jget(cj)
    rng = np.random.RandomState(1)
    cache_np = {"dense": {
        k: rng.randn(*s.shape).astype(np.float32) * 0.1
        for k, s in api.cache_specs(cj, jL.HOST, 3, 16)["dense"].items()}}
    pos = np.array([3, 7, 11], np.int32)
    toks = rng.randint(0, 512, (3, 1)).astype(np.int32)
    lj, cj_out = api.decode_step(pj, cj, jnp.asarray(toks),
                                 jax.tree.map(jnp.asarray, cache_np),
                                 jnp.asarray(pos))
    cache_t = bridge.cache_from_jax(cache_np, device="cpu")
    lt, _ = T.decode_step(pt, ct, torch.from_numpy(toks), cache_t,
                          torch.from_numpy(pos))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    np.testing.assert_allclose(bridge.cache_to_numpy(cache_t)["dense"]["k"],
                               np.asarray(cj_out["dense"]["k"]), atol=2e-5)


@pytest.mark.parametrize("positions", ["scalar", "rowwise"])
def test_rope_and_norm_match_jax(positions):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 4, 8).astype(np.float32)
    w = rng.randn(8).astype(np.float32)
    pos = (np.broadcast_to(np.arange(5), (2, 5)) if positions == "scalar"
           else np.stack([np.arange(5) + 3, np.arange(5) + 17]))
    pos = np.ascontiguousarray(pos, np.int32)
    np.testing.assert_allclose(
        L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        L.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jL.rms_norm(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)


def test_mask_pad_logits_and_padded_vocab():
    assert L.padded_vocab(500) == jL.padded_vocab(500) == 512
    logits = torch.zeros(2, 512)
    out = L.mask_pad_logits(logits, 500)
    assert (out[:, 500:] == -1e30).all() and (out[:, :500] == 0).all()
    assert L.mask_pad_logits(logits, 512) is logits


def test_unported_paths_raise():
    """A family not ported yet raises. The gated MLP raised here until
    ``sidebar_gated_mlp`` was ported, and the moe family until MoE and
    MLA were; both compute now."""
    cfg = dataclasses.replace(tcfg.get_smoke_config("nemotron-4-15b"),
                              gated_mlp=True)
    with pytest.raises(NotImplementedError, match="family"):
        T.param_shapes(dataclasses.replace(cfg, family="ssm"))
    assert T.layer_kinds(dataclasses.replace(
        cfg, family="moe", num_experts=4, experts_per_token=2,
        first_dense_layers=1)) == ["dense", "moe"]
    params = {name: torch.zeros(shape) for name, (shape, _)
              in mlp_param_shapes(cfg).items()}
    assert set(params) == {"w_gate", "w_up", "w_down"}
    assert mlp(params, cfg, torch.zeros(1, 1, cfg.d_model)).shape == \
        (1, 1, cfg.d_model)


def test_layer_scope_reaches_per_layer_plans(weights):
    """A layer-indexed ExecutionPlan resolves per layer: layer 0 takes
    the serial route, the pipelined layer 1 the ring route at its depth,
    and the logits equal the SIDEBAR plan's bit for bit on the CPU."""
    from repro_torch.core.modes import ExecutionPlan, LayerPlan

    _, ct = _cfgs("kernels")
    _, pt = weights
    plan = ExecutionPlan(default=LayerPlan(ExecutionMode.SIDEBAR, 1),
                         layers={1: LayerPlan(
                             ExecutionMode.SIDEBAR_PIPELINED, 3)})
    batch = {"tokens": torch.arange(4, dtype=torch.long)[None]}
    recs = []
    with kops.record_dispatches(recs), kops.execution_plan(plan):
        got, _ = T.prefill(pt, ct, batch, T.init_cache(ct, 1, 8,
                                                       device="cpu"))
    want, _ = T.prefill(pt, ct, batch, T.init_cache(ct, 1, 8, device="cpu"))
    assert torch.equal(got, want)
    assert [(r.op, r.layer, r.mode, r.depth) for r in recs] == [
        ("sidebar_mlp", 0, ExecutionMode.SIDEBAR, 1),
        ("sidebar_mlp", 1, ExecutionMode.SIDEBAR_PIPELINED, 3)]
