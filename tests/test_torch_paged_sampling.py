"""Sampled requests through the port's ``PagedContinuousBatchingServer``
held to the JAX package's on the CPU on the same weights
(``repro_torch.bridge``): mixed greedy and sampled traffic
(``SP = SamplingParams(temperature=0.9, top_k=50, top_p=0.95, seed=11)``
on every other request, half the prompts sharing a two-block prefix) on
nemotron, nemotron with int8 KV and deepseek-v3 (no-drop capacity):
``kernel="paged"`` == ``kernel="slab"`` == solo ``Server.generate`` bit
for bit, and == the JAX paged server's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import Server

ARCHS = ["nemotron-4-15b", "nemotron-int8", "deepseek-v3-671b"]
SP_KW = dict(temperature=0.9, top_k=50, top_p=0.95, seed=11)
SP = SamplingParams(**SP_KW)


def _cfgs(arch):
    base = "nemotron-4-15b" if arch == "nemotron-int8" else arch
    cj, ct = jcfg.get_smoke_config(base), tcfg.get_smoke_config(base)
    if arch == "nemotron-int8":
        cj = dataclasses.replace(cj, kv_cache_dtype=jnp.int8)
        ct = dataclasses.replace(ct, kv_cache_dtype=torch.int8)
    if cj.num_experts:
        # no-drop capacity: co-batched rows share expert capacity
        cj = dataclasses.replace(cj, capacity_factor=float(cj.num_experts))
        ct = dataclasses.replace(ct, capacity_factor=float(ct.num_experts))
    return cj, ct


@pytest.fixture(scope="module")
def served():
    """arch -> (JAX cfg, port cfg, JAX params, port params, port Server)."""
    out = {}
    weights = {}
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        base = "nemotron" if arch.startswith("nemotron") else arch
        if base not in weights:
            pj = jget(cj).init(jax.random.PRNGKey(0), cj)
            weights[base] = (pj, bridge.params_from_jax(
                jax.tree.map(np.asarray, pj), device="cpu"))
        pj, pt = weights[base]
        out[arch] = (cj, ct, pj, pt,
                     Server(ct, pt, max_len=48, device="cpu"))
    return out


def _solo(server, prompt, gen, sample=None) -> np.ndarray:
    return server.generate(prompt[None], gen, decode="loop",
                           sample=sample).tokens[0, prompt.size:].numpy()


def _paged_traffic(vocab, seed, n=6):
    """Prompts of 2..21 tokens, every other one opening with one shared
    16-token prefix."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 16).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.randint(0, vocab, rng.randint(2, 14)).astype(np.int32)
        if i % 2:
            p = np.concatenate([prefix, p[:5]])
        out.append((p, int(rng.randint(1, 9))))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_sampled_equals_slab_equals_solo_and_jax(served, arch):
    cj, ct, pj, pt, server = served[arch]
    reqs = _paged_traffic(ct.vocab_size, 7)
    samples = [SP if i % 2 == 0 else None for i in range(len(reqs))]
    kw = dict(num_slots=3, max_len=48, block_size=8, segment=4)
    runs = {}
    for kernel in ("paged", "slab"):
        srv = PagedContinuousBatchingServer(ct, pt, device="cpu",
                                            kernel=kernel, **kw)
        for (p, g), sp in zip(reqs, samples):
            srv.submit(p, g, sample=sp)
        runs[kernel] = srv.run()
        assert srv.stats.prefix_block_hits > 0
    js = JaxPaged(cj, pj, **kw)
    for (p, g), sp in zip(reqs, samples):
        js.submit(p, g, sample=None if sp is None else JSP(**SP_KW))
    want = js.run()
    for a, b, w in zip(runs["paged"], runs["slab"], want):
        p, g = reqs[a.rid]
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, np.asarray(w.tokens))
        np.testing.assert_array_equal(
            a.tokens, _solo(server, p, g, samples[a.rid]))
