"""llama4-scout-17b-a16e in the port — GQA attention with a MoE block in
every layer (top-1 routing, one shared expert, no dense layers) — held
to the JAX package on the CPU.

Across frameworks, on the same weights (``bridge.params_from_jax``, the
fp32 smoke config) and inputs made from a seed with numpy:

  * the config mirror and the layer plan (every layer MoE), and the
    bridge over the MoE stack with its shared expert;
  * the MoE block (top-1 routing plus the shared expert) against the
    JAX ``moe``, without drops and at a dropping ``capacity_factor``
    where some expert gets more tokens than its capacity: the same
    tokens dropped, the same outputs to 1e-5;
  * prefill and decode logits on a slab and on the paged pool to 1e-4,
    with the JAX model's greedy tokens (no-drop capacity, as the JAX
    package's own paged gates run MoE);
  * ``forward`` logits (1e-4), ``loss`` (1e-5) and the loss gradients
    leaf by leaf to 1e-4 of the leaf's largest, at the dropping
    default capacity;
  * the static ``Server``, the slot-cache server and the paged server
    (both kernels): greedy and sampled streams equal the JAX servers'.

Inside the port, bit-exact on the CPU: paged == slab == solo, greedy and
sampled.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.function_table import DEFAULT_TABLE as JTABLE
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import ContinuousBatchingServer as JaxSlots
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.launch.serve import Server as JaxServer
from repro.models import layers as jL
from repro.models import moe as jmoe
from repro.models.registry import get_model as jget
from repro_torch import bridge, tree
from repro_torch import configs as tcfg
from repro_torch.core.function_table import DEFAULT_TABLE as TTABLE
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.launch.train import value_and_grad
from repro_torch.models import moe
from repro_torch.models import transformer as T

ARCH = "llama4-scout-17b-a16e"
TOL = dict(rtol=1e-4, atol=1e-4)
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)
SP = SamplingParams(**SP_KW)
PAGED = dict(num_slots=3, max_len=48, block_size=8, segment=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _nodrop(cfg):
    """No-drop capacity: co-batched rows share expert capacity, and
    chunk boundaries must not change routing."""
    return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, JAX params, port params) at the smoke config's
    own (dropping) capacity."""
    cj, ct = jcfg.get_smoke_config(ARCH), tcfg.get_smoke_config(ARCH)
    pj = jax.jit(lambda k: jget(cj).init(k, cj))(jax.random.PRNGKey(0))
    return cj, ct, pj, bridge.params_from_jax(jax.tree.map(np.asarray, pj),
                                              device="cpu")


def test_config_layer_plan_and_bridge(weights):
    cj, ct, pj, pt = weights
    full = tcfg.get_config(ARCH)
    assert (full.num_experts, full.experts_per_token,
            full.num_shared_experts, full.first_dense_layers) == (16, 1, 1, 0)
    assert full.num_heads // full.num_kv_heads == 5 and not full.use_mla
    assert T.layer_kinds(ct) == ["moe"] * ct.num_layers
    assert list(pj["blocks"]) == ["moe"]
    stack = pj["blocks"]["moe"]
    for i, layer in enumerate(pt["layers"]):
        assert "mlp" not in layer and set(layer) == set(stack)
        for path, leaf in tree.leaves_with_path(layer):
            want = stack
            for key in path.strip("[]'").split("']['"):
                want = want[key]
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(want)[i])
    assert pt["layers"][0]["moe"]["shared"]["w_down"].shape == (
        ct.moe_d_ff, ct.d_model)


def _moe_params(cj, seed):
    pj = jL.materialize(jax.random.PRNGKey(seed),
                        jmoe.moe_param_specs(cj, jL.HOST))
    return pj, bridge._layer(jax.tree.map(lambda a: np.asarray(a)[None],
                                          pj), 0, "cpu")


@pytest.mark.parametrize("cf", [1.0, 4.0], ids=["drop", "nodrop"])
def test_top1_routing_with_shared_expert_matches_jax(cf):
    cj = dataclasses.replace(jcfg.get_smoke_config(ARCH), capacity_factor=cf)
    ct = dataclasses.replace(tcfg.get_smoke_config(ARCH), capacity_factor=cf)
    pj, pt = _moe_params(cj, 3)
    x = np.random.RandomState(4).randn(2, 5, ct.d_model).astype(np.float32)
    want = jmoe.moe(pj, cj, jnp.asarray(x), table=JTABLE, minfo=jL.HOST,
                    mesh=None)
    got = moe.moe(pt, ct, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # top-1: the one routed weight renormalizes to 1
    w, ids = moe._route(_t(x.reshape(10, -1)), pt["router"], ct)
    assert ids.shape == (10, 1) and torch.equal(w, torch.ones(10, 1))


def test_capacity_drops_the_same_tokens_as_jax():
    """64 tokens over 4 experts at capacity factor 1.0: capacity 16,
    and the busiest expert gets more, so tokens are dropped — the same
    ones as JAX drops, by routed weight (ties to the lower index)."""
    cj = dataclasses.replace(jcfg.get_smoke_config(ARCH),
                             capacity_factor=1.0)
    ct = dataclasses.replace(tcfg.get_smoke_config(ARCH),
                             capacity_factor=1.0)
    pj, pt = _moe_params(cj, 5)
    x = np.random.RandomState(6).randn(64, ct.d_model).astype(np.float32)
    wj, ij = jmoe._route(jnp.asarray(x), pj["router"], cj)
    wt, it = moe._route(_t(x), pt["router"], ct)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    cap = moe._capacity(64, ct)
    assert cap == jmoe._capacity(64, cj) == 16
    per_expert = np.bincount(it.numpy().reshape(-1), minlength=4)
    assert per_expert.max() > cap
    _, _, kept = moe._pairs(wt, it, cap, ct.num_experts)
    assert int((~kept).sum()) == int(np.maximum(per_expert - cap, 0).sum())
    want = jmoe._local_expert_pass(
        jnp.asarray(x), wj, ij, pj["w_gate"], pj["w_up"], pj["w_down"], 0,
        cj, JTABLE.lookup("silu"))
    got = moe._local_expert_pass(
        _t(x), wt, it, pt["w_gate"], pt["w_up"], pt["w_down"], ct,
        TTABLE.lookup("silu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # a dropped token gets nothing from the routed experts
    dropped = ~kept[:, 0].numpy()
    assert dropped.any() and not got.numpy()[dropped].any()


STEPS = 3


@pytest.mark.parametrize("route", ["slab", "paged"])
def test_prefill_and_decode_match_jax(weights, route):
    cj, ct, pj, pt = weights
    cj = _nodrop(cj)
    ct = dataclasses.replace(_nodrop(ct), use_pallas=True)
    api = jget(cj)
    prefill = jax.jit(lambda p, b, c: api.prefill(p, cj, b, c))
    decode = jax.jit(lambda p, t, c, pos: api.decode_step(p, cj, t, c, pos))
    cache_j = api.init_cache(cj, jL.HOST, 2, 24)
    toks = np.random.RandomState(1).randint(0, ct.vocab_size, (2, 8))
    lj, cache_j = prefill(pj, {"tokens": jnp.asarray(toks)}, cache_j)
    kw = {}
    if route == "paged":
        nb = 3
        cache_t = T.init_cache(ct, 2 * nb + 2, 8, device="cpu")
        kw["block_tables"] = torch.arange(1, 1 + 2 * nb, dtype=torch.int32
                                          ).reshape(2, nb)
    else:
        cache_t = T.init_cache(ct, 2, 24, device="cpu")
    lt, cache_t = T.prefill(pt, ct, {"tokens": _t(toks)}, cache_t, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    for step in range(STEPS):
        nxt = np.asarray(jnp.argmax(lj[:, -1], -1))[:, None]
        assert np.array_equal(torch.argmax(lt[:, -1], -1)[:, None].numpy(),
                              nxt), step
        lj, cache_j = decode(pj, jnp.asarray(nxt), cache_j,
                             jnp.int32(8 + step))
        lt, cache_t = T.decode_step(pt, ct, _t(nxt).long(), cache_t,
                                    8 + step, **kw)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_forward_loss_and_gradients_match_jax(weights):
    cj, ct, pj, pt = weights
    cj = dataclasses.replace(cj, remat="none")
    ct = dataclasses.replace(ct, remat="none")
    toks = np.random.default_rng(2).integers(0, ct.vocab_size, (2, 64)
                                             ).astype(np.int32)
    bj = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    bt = {"tokens": _t(toks), "labels": _t(toks)}
    api = jget(cj)
    np.testing.assert_allclose(
        T.forward(pt, ct, bt).detach().numpy(),
        np.asarray(jax.jit(lambda p, b: api.forward(p, cj, b))(pj, bj)),
        **TOL)
    lj, gj = jax.jit(lambda p, b: jax.value_and_grad(api.loss)(
        p, cj, b))(pj, bj)
    lt, gt = value_and_grad(lambda p, b: T.loss(p, ct, b), pt, bt)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5, atol=1e-5)
    want = dict(tree.leaves_with_path(bridge.params_from_jax(
        jax.tree.map(np.asarray, gj), device="cpu")))
    # top-1 renormalizes the routed weight to exactly 1, so the router's
    # true gradient is 0 and both sides hold rounding noise there: such
    # a leaf is held to 1e-7 of the model's largest gradient instead
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for path, g in tree.leaves_with_path(gt):
        w = want[path].numpy()
        scale = max(np.abs(w).max(), 1e-3 * top)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, path
    router = gt["layers"][0]["moe"]["router"]
    assert router.abs().max() < 1e-6 * top
    assert gt["layers"][0]["moe"]["w_down"].abs().max() > 1e-3 * top


# ---------------------------------------------------------------------------
# Servers (no-drop capacity)
# ---------------------------------------------------------------------------


def _traffic(vocab, seed, n=5):
    """Prompts of 2..13 tokens, every other one opening with one shared
    16-token (two-block) prefix; 1..8 new tokens each."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 16).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.randint(0, vocab, rng.randint(2, 14)).astype(np.int32)
        if i % 2:
            p = np.concatenate([prefix, p[:5]])
        out.append((p, int(rng.randint(1, 9))))
    return out


def _drain(srv, reqs, samples, sp):
    for (p, g), s in zip(reqs, samples):
        srv.submit(p, g, sample=sp if s else None)
    return srv.run()


@pytest.fixture(scope="module")
def served(weights):
    cj, ct, pj, pt = weights
    return _nodrop(cj), _nodrop(ct), pj, pt


def test_server_matches_jax_greedy_and_sampled(served):
    cj, ct, pj, pt = served
    prompts = np.random.RandomState(1).randint(0, ct.vocab_size, (2, 6))
    server = Server(ct, pt, max_len=48, device="cpu")
    jserver = JaxServer(cj, pj, max_len=48)
    for jsp, tsp in ((None, None), (JSP(**SP_KW), SP)):
        want = np.asarray(jserver.generate(jnp.asarray(prompts), 8,
                                           sample=jsp).tokens)
        for decode in ("scan", "loop"):
            got = server.generate(prompts, 8, decode=decode,
                                  sample=tsp).tokens.numpy()
            np.testing.assert_array_equal(got, want, err_msg=decode)


def test_slot_server_matches_jax_greedy_and_sampled(served):
    cj, ct, pj, pt = served
    reqs = _traffic(ct.vocab_size, 3)
    samples = [i % 2 == 0 for i in range(len(reqs))]
    kw = dict(num_slots=2, max_len=48, buckets=(8, 16, 32), segment=4)
    want = _drain(JaxSlots(cj, pj, **kw), reqs, samples, JSP(**SP_KW))
    got = _drain(ContinuousBatchingServer(ct, pt, device="cpu", **kw),
                 reqs, samples, SP)
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


def test_paged_equals_slab_equals_solo_and_jax(served):
    cj, ct, pj, pt = served
    reqs = _traffic(ct.vocab_size, 7, n=6)
    samples = [i % 2 == 0 for i in range(len(reqs))]
    runs = {}
    for kernel in ("paged", "slab"):
        srv = PagedContinuousBatchingServer(ct, pt, device="cpu",
                                            kernel=kernel, **PAGED)
        runs[kernel] = _drain(srv, reqs, samples, SP)
        assert srv.stats.prefix_block_hits > 0
    want = _drain(JaxPaged(cj, pj, **PAGED), reqs, samples, JSP(**SP_KW))
    server = Server(ct, pt, max_len=48, device="cpu")
    for a, b, w in zip(runs["paged"], runs["slab"], want):
        p, g = reqs[a.rid]
        solo = server.generate(p[None], g, decode="loop",
                               sample=SP if samples[a.rid] else None
                               ).tokens[0, p.size:].numpy()
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, solo)
        np.testing.assert_array_equal(a.tokens, np.asarray(w.tokens))
