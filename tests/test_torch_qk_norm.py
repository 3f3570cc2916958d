"""qwen3-14b (qk-RMSNorm, GQA group 2 at smoke width) and llama3-405b in
the port, held to the JAX package on the CPU.

Across frameworks, on the same weights (``bridge.params_from_jax``, fp32
smoke configs) and inputs made from a seed with numpy:

  * the config mirror, and the bridge carrying ``q_norm`` / ``k_norm``
    (shape (head_dim,)) as they are;
  * GQA attention with qk-norm — cache-free and writing a slab cache —
    to 1e-5;
  * prefill and decode logits on a slab and on the paged pool to 1e-4,
    with the JAX model's greedy tokens;
  * ``forward`` logits (1e-4) and ``loss`` (1e-5), and the loss
    gradients leaf by leaf to 1e-4 of the leaf's largest;
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
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import ContinuousBatchingServer as JaxSlots
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.launch.serve import Server as JaxServer
from repro.models import attention as jattn
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro_torch import bridge, tree
from repro_torch import configs as tcfg
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server
from repro_torch.launch.train import value_and_grad
from repro_torch.models import attention as attn
from repro_torch.models import transformer as T

ARCHS = ["qwen3-14b", "llama3-405b"]
TOL = dict(rtol=1e-4, atol=1e-4)
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)
SP = SamplingParams(**SP_KW)
PAGED = dict(num_slots=3, max_len=48, block_size=8, segment=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def weights():
    """arch -> (JAX cfg, port cfg, JAX params, port params)."""
    out = {}
    for arch in ARCHS:
        cj, ct = jcfg.get_smoke_config(arch), tcfg.get_smoke_config(arch)
        pj = jax.jit(lambda k, cj=cj: jget(cj).init(k, cj))(
            jax.random.PRNGKey(0))
        out[arch] = (cj, ct, pj, bridge.params_from_jax(
            jax.tree.map(np.asarray, pj), device="cpu"))
    return out


def test_qk_norm_config_and_bridge(weights):
    cj, ct, pj, pt = weights["qwen3-14b"]
    assert ct.qk_norm and cj.qk_norm
    assert not tcfg.get_config("llama3-405b").qk_norm
    assert tcfg.get_config("llama3-405b").kv_cache_dtype == torch.int8
    shapes = attn.gqa_param_shapes(ct)
    assert shapes["q_norm"] == shapes["k_norm"] == ((ct.head_dim,), "ones")
    assert "q_norm" not in attn.gqa_param_shapes(
        tcfg.get_smoke_config("llama3-405b"))
    for i, layer in enumerate(pt["layers"]):
        for name in ("q_norm", "k_norm"):
            want = np.asarray(pj["blocks"]["dense"]["attn"][name])[i]
            assert layer["attn"][name].shape == (ct.head_dim,)
            np.testing.assert_array_equal(layer["attn"][name].numpy(), want)
    # MLA's own q_norm is (q_lora_rank,): the two never meet in a config
    v3 = tcfg.get_smoke_config("deepseek-v3-671b")
    assert attn.mla_param_shapes(v3)["q_norm"][0] == (v3.q_lora_rank,)


@pytest.mark.parametrize("with_cache", [False, True], ids=["free", "slab"])
def test_qk_norm_attention_matches_jax(with_cache):
    cj = jcfg.get_smoke_config("qwen3-14b")
    ct = tcfg.get_smoke_config("qwen3-14b")
    pj = jL.materialize(jax.random.PRNGKey(4),
                        jattn.gqa_param_specs(cj, jL.HOST))
    rng = np.random.RandomState(5)
    # norms away from 1, so the test sees them
    pj = dict(pj, q_norm=jnp.asarray(rng.uniform(0.5, 1.5, cj.head_dim),
                                     jnp.float32),
              k_norm=jnp.asarray(rng.uniform(0.5, 1.5, cj.head_dim),
                                 jnp.float32))
    pt = {k: _t(np.asarray(v)) for k, v in pj.items()}
    x = rng.randn(2, 7, ct.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    kw_j, kw_t = {}, {}
    if with_cache:
        cache_j = {n: jnp.zeros(s, jnp.float32) for n, (s, _) in
                   attn.kv_cache_shapes(ct, 2, 16).items()}
        kw_j = dict(cache=cache_j, cache_pos=jnp.int32(0))
        kw_t = dict(cache={n: torch.zeros(s) for n, (s, _) in
                           attn.kv_cache_shapes(ct, 2, 16).items()},
                    cache_pos=0)
    want, cj_out = jax.jit(lambda p, v, q, kw: jattn.gqa_attention(
        p, cj, v, q, **kw))(pj, jnp.asarray(x), jnp.asarray(pos), kw_j)
    got, ct_out = attn.gqa_attention(pt, ct, _t(x), _t(pos).long(), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if with_cache:
        # normed (then roped) keys are what the cache holds
        np.testing.assert_allclose(ct_out["k"].numpy(),
                                   np.asarray(cj_out["k"]), rtol=1e-5,
                                   atol=1e-5)


STEPS = 3


@pytest.mark.parametrize("route", ["slab", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(weights, arch, route):
    cj, ct, pj, pt = weights[arch]
    ct = dataclasses.replace(ct, use_pallas=True)
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


def _batch(seed, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (2, 64)).astype(
        np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": _t(toks), "labels": _t(toks)})


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_jax(weights, arch):
    cj, ct, pj, pt = weights[arch]
    cj = dataclasses.replace(cj, remat="none")
    ct = dataclasses.replace(ct, remat="none")
    bj, bt = _batch(2, ct.vocab_size)
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
    for path, g in tree.leaves_with_path(gt):
        w = want[path].numpy()
        scale = max(np.abs(w).max(), 1e-30)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, path
    if ct.qk_norm:
        assert sum(p.endswith(("['q_norm']", "['k_norm']"))
                   for p in want) == 4


# ---------------------------------------------------------------------------
# Servers
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


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax_greedy_and_sampled(weights, arch):
    cj, ct, pj, pt = weights[arch]
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


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_server_matches_jax_greedy_and_sampled(weights, arch):
    cj, ct, pj, pt = weights[arch]
    reqs = _traffic(ct.vocab_size, 3)
    samples = [i % 2 == 0 for i in range(len(reqs))]
    kw = dict(num_slots=2, max_len=48, buckets=(8, 16, 32), segment=4)
    want = _drain(JaxSlots(cj, pj, **kw), reqs, samples, JSP(**SP_KW))
    srv = ContinuousBatchingServer(ct, pt, device="cpu", **kw)
    got = _drain(srv, reqs, samples, SP)
    for a, b in zip(got, want):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_equals_slab_equals_solo_and_jax(weights, arch):
    cj, ct, pj, pt = weights[arch]
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
