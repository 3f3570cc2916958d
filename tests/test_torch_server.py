"""The port's static-batch ``Server``, and sampled requests through the
schedulers, held to the JAX package on the CPU on the same weights
(``repro_torch.bridge``).

Across frameworks: ``Server.generate`` tokens equal JAX's, greedy and
sampled with ``SP = SamplingParams(temperature=0.9, top_k=50,
top_p=0.95, seed=11)``, on nemotron, nemotron with int8 KV and
deepseek-v3 (no-drop capacity), under scan and loop decode.

Inside the port, the invariants of the JAX package's
``tests/test_serving_scan.py`` (scan == loop, the program cache keyed by
step count, cache pooling, chunked prefill == whole prompt, plan and
family rejections) and ``tests/test_sampling.py`` (temperature 0 and
top-k 1 == greedy, seeds reproduce, batch rows independent, a
scheduler request == solo row 0, a restart mid-stream continues the
stream, on the slot-cache and the paged server).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch.sampling import SamplingParams as JSP
from repro.launch.serve import Server as JaxServer
from repro.models.registry import get_model as jget
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.core.modes import ExecutionMode, ExecutionPlan, LayerPlan
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.sampling import SamplingParams
from repro_torch.launch.scheduler import (
    ContinuousBatchingServer,
    PagedContinuousBatchingServer,
)
from repro_torch.launch.serve import Server, generate

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


def _prompts(vocab, b=2, s=6, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int32)


def _gen(server, prompts, n, **kw) -> np.ndarray:
    return server.generate(prompts, n, **kw).tokens.numpy()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_server_matches_jax_greedy_and_sampled(served, arch):
    cj, ct, pj, _, server = served[arch]
    prompts = _prompts(ct.vocab_size)
    jserver = JaxServer(cj, pj, max_len=48)
    for jsp, tsp in ((None, None), (JSP(**SP_KW), SP)):
        want = np.asarray(jserver.generate(jnp.asarray(prompts), 10,
                                           sample=jsp).tokens)
        for decode in ("scan", "loop"):
            np.testing.assert_array_equal(
                _gen(server, prompts, 10, decode=decode, sample=tsp), want,
                err_msg=f"{arch} {decode} sample={tsp}")


@pytest.mark.parametrize("arch", ARCHS)
def test_temperature_zero_is_greedy(served, arch):
    *_, server = served[arch]
    prompts = _prompts(server.cfg.vocab_size)
    greedy = _gen(server, prompts, 8)
    t0 = SamplingParams(temperature=0.0, seed=3)
    for decode in ("scan", "loop"):
        np.testing.assert_array_equal(
            greedy, _gen(server, prompts, 8, decode=decode, sample=t0))


def test_seed_determinism_and_sampling_samples(served):
    *_, server = served["nemotron-4-15b"]
    prompts = _prompts(server.cfg.vocab_size)
    a = _gen(server, prompts, 10, sample=SP)
    np.testing.assert_array_equal(a, _gen(server, prompts, 10, sample=SP))
    c = _gen(server, prompts, 10, sample=dataclasses.replace(SP, seed=12))
    assert not (a == c).all(), "different seeds gave one stream"
    assert not (a == _gen(server, prompts, 10)).all(), "sampled == greedy"


def test_batch_rows_get_independent_streams(served):
    *_, server = served["nemotron-4-15b"]
    row = _prompts(server.cfg.vocab_size, b=1)
    toks = _gen(server, np.concatenate([row, row]), 12,
                sample=SamplingParams(temperature=1.5, seed=0))
    assert not (toks[0] == toks[1]).all(), "rows shared a PRNG stream"


def test_top_k_one_is_greedy_at_any_temperature(served):
    *_, server = served["nemotron-4-15b"]
    prompts = _prompts(server.cfg.vocab_size)
    np.testing.assert_array_equal(
        _gen(server, prompts, 8),
        _gen(server, prompts, 8,
             sample=SamplingParams(temperature=5.0, top_k=1, seed=9)))


def test_scan_program_cached_by_step_count_and_cache_pooled(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    server = Server(ct, pt, max_len=48, device="cpu")
    prompts = _prompts(ct.vocab_size, s=8)
    server.generate(prompts, 12)
    assert set(server._decode_scans) == {(11, None)}
    pooled = server._cache_pool[2]
    server.generate(prompts, 12)
    assert set(server._decode_scans) == {(11, None)}
    assert server._cache_pool[2] is pooled          # the buffer is reused
    assert server._decode_scans[(11, None)].eager_calls == 2
    out = server.generate(np.zeros((2, 4), np.int32), 1)
    assert out.tokens.shape == (2, 5) and out.generated == 1
    assert set(server._decode_scans) == {(11, None)}   # no decode steps


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b"])
def test_chunked_prefill_matches_whole_prompt(served, arch):
    *_, server = served[arch]
    prompts = _prompts(server.cfg.vocab_size, s=11, seed=2)
    ref = _gen(server, prompts, 6, decode="loop")
    for chunk in (4, 5, 11, 64):
        np.testing.assert_array_equal(
            ref, _gen(server, prompts, 6, decode="loop",
                      prefill_chunk=chunk), err_msg=f"chunk {chunk}")
    np.testing.assert_array_equal(
        ref, _gen(server, prompts, 6, decode="scan", prefill_chunk=4))
    with pytest.raises(ValueError, match="prefill_chunk"):
        server.generate(prompts, 4, prefill_chunk=0)


def test_per_layer_plan_reaches_each_layer_and_keeps_tokens(served):
    _, ct, _, pt, _ = served["nemotron-4-15b"]
    ct = dataclasses.replace(ct, use_pallas=True)
    plan = ExecutionPlan(
        default=LayerPlan(ExecutionMode.SIDEBAR),
        layers={0: LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, depth=2),
                1: LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, depth=3)})
    prompts = _prompts(ct.vocab_size, b=3, s=8)
    rec = []
    with kops.record_dispatches(rec):
        got = _gen(Server(ct, pt, max_len=24, plan=plan, device="cpu"),
                   prompts, 4)
    mlp = {(d.layer, d.mode, d.depth) for d in rec if d.op == "sidebar_mlp"}
    assert mlp == {(0, ExecutionMode.SIDEBAR_PIPELINED, 2),
                   (1, ExecutionMode.SIDEBAR_PIPELINED, 3)}
    uniform = Server(ct, pt, max_len=24, device="cpu")
    np.testing.assert_array_equal(got, _gen(uniform, prompts, 4))


def test_server_rejections(served):
    _, ct, _, pt, server = served["nemotron-4-15b"]
    with pytest.raises(ValueError, match="SIDEBAR"):
        Server(ct, pt, plan=ExecutionMode.MONOLITHIC, device="cpu")
    with pytest.raises(ValueError, match="either plan"):
        Server(ct, pt, plan="sidebar", execution_mode="sidebar",
               device="cpu")
    hetero = ExecutionPlan(
        default=LayerPlan(ExecutionMode.SIDEBAR),
        layers={0: LayerPlan(ExecutionMode.SIDEBAR_PIPELINED, depth=4)})
    with pytest.raises(ValueError, match="heterogeneous"):
        Server(dataclasses.replace(ct, family="rwkv"), pt, plan=hetero,
               device="cpu")
    # tensor parallelism is ported (ROADMAP Queue 1 item 6): an object
    # that is no mesh is refused by mesh_info's check, as in the JAX
    # package; a host mesh serves the meshless tokens
    with pytest.raises(ValueError, match="canonical"):
        Server(ct, pt, mesh=object(), device="cpu")
    meshed = Server(ct, pt, mesh=make_host_mesh(device="cpu"))
    hp = np.random.RandomState(4).randint(0, ct.vocab_size, (2, 6))
    np.testing.assert_array_equal(meshed.generate(hp, 4).tokens.numpy(),
                                  server.generate(hp, 4).tokens.numpy())
    prompts = _prompts(ct.vocab_size)
    # encoder memory is the audio and VLM families': a dense server
    # ignores ``extra``, as the JAX server does
    np.testing.assert_array_equal(
        server.generate(prompts, 4, extra={"frames": None}).tokens,
        server.generate(prompts, 4).tokens)
    with pytest.raises(ValueError, match="decode"):
        server.generate(prompts, 4, decode="unrolled")
    with pytest.raises(ValueError, match="max_len"):
        server.generate(prompts, 60)


# ---------------------------------------------------------------------------
# Sampled requests through the schedulers
# ---------------------------------------------------------------------------


def _slots(ct, pt, **kw):
    return ContinuousBatchingServer(ct, pt, device="cpu", **{
        "num_slots": 2, "max_len": 48, "buckets": (8,), "segment": 4, **kw})


def _solo(server, prompt, gen, sample=None) -> np.ndarray:
    return server.generate(prompt[None], gen, decode="loop",
                           sample=sample).tokens[0, prompt.size:].numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_sampled_matches_solo(served, arch):
    *_, pt, server = served[arch]
    ct = server.cfg
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, ct.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 3)]
    sched = _slots(ct, pt)
    for i, p in enumerate(prompts):
        sched.submit(p, 8, sample=SP if i % 2 == 0 else None)
    for i, (r, p) in enumerate(zip(sched.run(), prompts)):
        np.testing.assert_array_equal(
            r.tokens, _solo(server, p, 8, SP if i % 2 == 0 else None))


def test_scheduler_restart_mid_stream_preserves_stream(served):
    _, ct, _, pt, server = served["nemotron-4-15b"]
    prompt = _prompts(ct.vocab_size, b=1)[0]
    full = server.generate(prompt[None], 10,
                           sample=SP).tokens[0, prompt.size:].numpy()
    for make in (lambda: _slots(ct, pt, num_slots=1, segment=3),
                 lambda: PagedContinuousBatchingServer(
                     ct, pt, device="cpu", num_slots=1, max_len=48,
                     block_size=8, segment=3)):
        s1 = make()
        s1.submit(prompt, 10, sample=SP)
        s1.step()
        part = s1.slot_tokens(0)
        assert 0 < part.size < 10
        np.testing.assert_array_equal(part, full[:part.size])
        s2 = make()
        s2.submit(np.concatenate([prompt, part]), 10 - part.size,
                  sample=SP)
        (rest,) = s2.run()
        np.testing.assert_array_equal(np.concatenate([part, rest.tokens]),
                                      full)


def test_solo_generate_samples_like_the_server(served):
    _, ct, _, pt, server = served["nemotron-4-15b"]
    prompts = _prompts(ct.vocab_size)
    np.testing.assert_array_equal(
        generate(ct, pt, torch.from_numpy(prompts), 9, max_len=48,
                 device="cpu", sample=SP).numpy(),
        _gen(server, prompts, 9, sample=SP, decode="loop"))


def test_serve_batch_driver(capsys):
    """``python -m repro_torch.launch.serve_batch``: the static server
    and the two schedulers on the CPU, sampled; ``--mesh 1x1`` serves in
    one process, a larger mesh wants a world of its ranks."""
    from repro_torch.launch import serve_batch

    common = ["--device", "cpu", "--arch", "nemotron-4-15b",
              "--prompt-len", "8", "--gen", "5", "--temperature", "0.8"]
    serve_batch.main(common + ["--batch", "2"])
    serve_batch.main(common + ["--continuous", "--requests", "3",
                               "--slots", "2"])
    serve_batch.main(common + ["--continuous", "--paged", "--requests", "3",
                               "--slots", "2", "--block-size", "4"])
    out = capsys.readouterr().out
    assert "generated 10 tokens" in out and out.count("drained 3") == 2
    assert "captured=False" in out
    # the overload machinery is ported (ROADMAP Queue 1 item 4): a
    # faulted paged drain, and the overload smoke on a tiny pool
    serve_batch.main(common + ["--continuous", "--paged", "--requests", "3",
                               "--slots", "2", "--block-size", "4",
                               "--faults", "alloc=0.1,evict_storm=0.2"])
    for faults in ([], ["--fault-seed", "5", "--faults",
                        "alloc=0.15,evict_storm=0.15,stage_stall=0.15"]):
        serve_batch.main(["--device", "cpu", "--arch", "nemotron-4-15b",
                          "--overload", "--slots", "2", "--prompt-len", "16",
                          "--gen", "12", "--segment", "4", "--num-blocks",
                          "6"] + faults)
    out = capsys.readouterr().out
    assert "drained 3" in out and "faults injected" in out
    assert out.count("overload [paged, 6 blocks") == 2
    assert out.count("drained 5 requests") == 2
    assert out.count("preemptions") >= 2
    # speculative decoding and RAG are ported (ROADMAP Queue 1 item 5):
    # each drains and passes its end-of-run asserts
    serve_batch.main(common + ["--continuous", "--paged", "--requests", "3",
                               "--slots", "2", "--spec-k", "3"])
    serve_batch.main(common + ["--continuous", "--paged", "--requests", "6",
                               "--slots", "2", "--rag", "--gen", "8",
                               "--prompt-len", "40"])
    out = capsys.readouterr().out
    assert "spec k=3 draft=nemotron-4-15b-smoke (oracle)" in out
    assert "speculative:" in out and "retrieval: 6 queries" in out
    # tensor parallelism is ported (ROADMAP Queue 1 item 6): a 1x1 mesh
    # serves in this process; 1x2 needs a world of two ranks
    serve_batch.main(common + ["--batch", "2", "--mesh", "1x1"])
    assert "generated 10 tokens" in capsys.readouterr().out
    with pytest.raises(ValueError, match="world of 2 ranks"):
        serve_batch.main(common + ["--mesh", "1x2"])
