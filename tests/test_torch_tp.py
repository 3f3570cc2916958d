"""Tensor-parallel serving of the port against the JAX package's.

The counterpart of ``tests/test_mesh_serving.py``'s mesh cases, on the
same bridged weights:

  * meshes: the canonical axes, ``mesh_info``'s refusals, the serving
    mesh's rank and world checks;
  * the sharding description (``transformer.param_pspecs`` /
    ``cache_pspecs``) against ``model_only_pspec`` of JAX's
    ``param_specs(cfg, SINGLE_POD)`` / ``cache_specs``, leaf for leaf,
    and each rank's shard against the matching slice of JAX's params;
  * ``make_tp_spec``: ``cfg_local`` and the divisibility guard;
  * the (1, 1) host mesh over one gloo rank: the paged server's tokens
    bit-equal to the port's solo server and JAX's host-mesh server,
    executable-cache keys ending in the mesh, replicated tables under
    eviction;
  * tp=2: two spawned gloo ranks on the CPU serve nemotron, its int8 KV
    and deepseek-v3 (smoke sizes) with JAX's solo ``Server(decode=
    "loop")`` tokens; the bytes their collectives counted equal
    ``tp_step_collectives`` for a step and a 6-step scan; indivisible
    heads are refused (the reference's slow subprocess test);
  * the comms model equal to JAX's for the six transformer configs.

``tests/test_torch_tp_card.py`` (no JAX) holds the rules that need no
reference and the ``gpu`` case: tp=1 over NCCL, captured == eager at 2
layers of nemotron-4-15b's full width.

Every spawned world has its own deadline (``parallel.ranks``): a hung
rank fails its test in seconds.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.launch import roofline as jroofline
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.launch.scheduler import PagedContinuousBatchingServer as JaxPaged
from repro.launch.serve import Server as JaxServer
from repro.models import layers as jL
from repro.models.registry import get_model as jget
from repro.parallel.tp import model_only_pspec as jax_model_only
from repro_torch import bridge
from repro_torch import configs as tcfg
from repro_torch.launch import roofline
from repro_torch.launch.mesh import (
    CANONICAL_AXES,
    Mesh,
    make_host_mesh,
    make_serving_mesh,
    mesh_info,
    num_chips,
)
from repro_torch.launch.scheduler import PagedContinuousBatchingServer
from repro_torch.launch.serve import Server, make_tp_spec
from repro_torch.models import transformer as T
from repro_torch.models.registry import get_model
from repro_torch.parallel import ranks
from repro_torch.parallel import tp as tplib

import torch_tp_ranks as R

SMOKE_ARCHS = ("nemotron-4-15b", "deepseek-7b", "deepseek-v3-671b",
               "qwen3-14b", "llama3-405b", "llama4-scout-17b-a16e")
TIMEOUT = 120        # seconds a spawned world may take


def _jcfg(arch):
    cfg = jcfg.get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _tcfg(arch):
    cfg = tcfg.get_smoke_config(arch)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _jparams(cfg, seed=0):
    return jax.tree.map(np.asarray,
                        jget(cfg).init(jax.random.PRNGKey(seed), cfg))


def _traffic(vocab, n, seed=0):
    """``tests/test_mesh_serving.py``'s ``_traffic``."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, vocab, size=rng.randint(3, 12)).astype(np.int32),
             int(rng.randint(2, 7))) for _ in range(n)]


def _cpu_mesh(shape, rank=0):
    """A mesh record of one rank, without a group: enough for
    ``make_tp_spec`` and placement, which run no collective."""
    return Mesh(shape=shape, axis_names=CANONICAL_AXES[len(shape)],
                device=torch.device("cpu"), group=None, rank=rank,
                backend="gloo")


@pytest.fixture(scope="module")
def nemotron():
    cj, ct = _jcfg("nemotron-4-15b"), _tcfg("nemotron-4-15b")
    pj = jget(cj).init(jax.random.PRNGKey(0), cj)
    pt = bridge.params_from_jax(jax.tree.map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


# -- meshes -------------------------------------------------------------------

@pytest.mark.parametrize("multi_pod", [False, True])
def test_host_mesh_axes_and_sizes(multi_pod):
    mesh = make_host_mesh(multi_pod=multi_pod, device="cpu")
    assert mesh.axis_names == CANONICAL_AXES[3 if multi_pod else 2]
    assert all(s == 1 for s in mesh.shape)
    assert mesh.devices.shape == mesh.shape and num_chips(mesh) == 1
    assert mesh.device == torch.device("cpu") and mesh.transport == "gloo"
    minfo = mesh_info(mesh)
    assert minfo.size("model") == 1 and minfo.tp == "model"
    assert minfo.fsdp == (("pod", "data") if multi_pod else ("data",))


def test_mesh_info_rejects_divergent_axis_names():
    rogue = dataclasses.replace(_cpu_mesh((1, 1)), axis_names=("rows",
                                                               "cols"))
    with pytest.raises(ValueError, match="canonical"):
        mesh_info(rogue)
    with pytest.raises(ValueError, match="canonical"):
        mesh_info(object())


def test_serving_mesh_rejects_bad_rank_and_missing_world():
    with pytest.raises(ValueError, match="rank"):
        make_serving_mesh((1,))
    with pytest.raises(ValueError, match="rank"):
        make_serving_mesh((1, 1, 1, 1))
    # this process holds no world of two ranks
    with pytest.raises(ValueError, match="world of 2"):
        make_serving_mesh((1, 2), device="cpu")


# -- the sharding description --------------------------------------------------

def _jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=jL.is_spec)
    return [(jax.tree_util.keystr(p), s) for p, s in flat]


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_sharding_description_equals_jax(arch):
    """Each port leaf's description equals ``model_only_pspec`` of JAX's
    spec of the same leaf with its stacked layer axis dropped."""
    cj, ct = _jcfg(arch), _tcfg(arch)
    api = jget(cj)
    jspecs = api.param_specs(cj, jL.SINGLE_POD)
    for name in ("embed", "final_norm"):
        assert T.param_pspecs(ct)[name] == tuple(
            jax_model_only(jspecs[name].pspec)), name
    kinds = T.layer_kinds(ct)
    port = T.param_pspecs(ct)["layers"]
    jcache = api.cache_specs(cj, jL.SINGLE_POD, 2, 16)
    pcache = T.cache_pspecs(ct)
    checked = 0
    for kind in ("dense", "moe"):
        layers = [i for i, k in enumerate(kinds) if k == kind]
        if not layers:
            continue
        for path, spec in _jax_leaves(jspecs["blocks"][kind]):
            want = tuple(jax_model_only(spec.pspec))[1:]   # drop L
            keys = [k.strip("'") for k in path.strip("[]").split("][")]
            for i in layers:
                leaf = port[i]
                for k in keys:
                    leaf = leaf[k]
                assert leaf == want, (arch, kind, path, leaf, want)
                checked += 1
        for path, spec in _jax_leaves(jcache[kind]):
            want = tuple(jax_model_only(spec.pspec))[1:]
            name = path.strip("[]'")
            for i in layers:
                assert pcache[i][name] == want, (arch, path)
                checked += 1
    # every port leaf was matched by a JAX leaf
    n_port = sum(len(jax.tree.leaves(layer, is_leaf=lambda x: isinstance(
        x, tuple))) for layer in port)
    n_cache = sum(len(layer) for layer in pcache)
    assert checked == n_port + n_cache


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "deepseek-v3-671b",
                                  "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("rank", [0, 1])
def test_rank_shard_equals_jax_slice(arch, rank):
    """``TpSpec.place_params`` of the bridged full params equals the
    bridge of JAX's params sliced along each leaf's model dim."""
    cj, ct = _jcfg(arch), _tcfg(arch)
    pj = _jparams(cj)
    spec = make_tp_spec(ct, get_model(ct), _cpu_mesh((1, 2), rank))
    got = spec.place_params(bridge.params_from_jax(pj, device="cpu"))
    jspecs = jget(cj).param_specs(cj, jL.SINGLE_POD)

    def take(a, s):
        entries = tuple(jax_model_only(s.pspec))
        if "model" not in entries:
            return a
        d = entries.index("model")
        n = a.shape[d] // 2
        return np.take(a, np.arange(rank * n, (rank + 1) * n), axis=d)

    sliced = jax.tree.map(take, pj, jspecs, is_leaf=lambda x: isinstance(
        x, np.ndarray))
    want = bridge.params_from_jax(sliced, device="cpu")
    gl = jax.tree_util.tree_leaves_with_path(got)
    wl = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, g), (_, w) in zip(gl, wl):
        assert torch.equal(g, w), jax.tree_util.keystr(path)


# -- make_tp_spec -----------------------------------------------------------------

def test_make_tp_spec_local_config_and_guard(nemotron):
    _, ct, _, _ = nemotron
    api = get_model(ct)
    one = make_tp_spec(ct, api, _cpu_mesh((1, 1)))
    assert one.size == 1 and one.cfg_local == ct
    two = make_tp_spec(ct, api, _cpu_mesh((1, 2), 1))
    assert two.size == 2 and two.rank == 1
    assert two.cfg_local.num_heads == ct.num_heads // 2
    assert two.cfg_local.num_kv_heads == ct.num_kv_heads // 2
    assert two.cfg_local.head_dim == ct.head_dim
    assert dataclasses.replace(two.cfg_local, num_heads=ct.num_heads,
                               num_kv_heads=ct.num_kv_heads) == ct
    v3 = _tcfg("deepseek-v3-671b")
    mla = make_tp_spec(v3, get_model(v3), _cpu_mesh((1, 2)))
    assert mla.cfg_local.num_heads == v3.num_heads // 2
    assert mla.cfg_local.num_kv_heads == v3.num_kv_heads   # MLA: unchanged
    bad = dataclasses.replace(ct, num_heads=3, num_kv_heads=3, head_dim=8)
    with pytest.raises(ValueError, match="num_heads 3 % tp 2"):
        make_tp_spec(bad, get_model(bad), _cpu_mesh((1, 2)))
    odd_ff = dataclasses.replace(ct, d_ff=ct.d_ff + 1)
    with pytest.raises(ValueError, match="model-sharded dim"):
        make_tp_spec(odd_ff, get_model(odd_ff), _cpu_mesh((1, 2)))
    rwkv = tcfg.get_smoke_config("rwkv6-7b")
    with pytest.raises(NotImplementedError, match="item 6"):
        make_tp_spec(rwkv, get_model(rwkv), _cpu_mesh((1, 1)))


# -- the (1, 1) host mesh over one gloo rank --------------------------------------

def test_host_mesh_paged_serving_bit_exact(nemotron):
    """The identity end of the TP bar: the host-mesh paged server's
    tokens equal the port's solo server's and JAX's host-mesh server's
    (``tests/test_mesh_serving.py:93-113``)."""
    cj, ct, pj, pt = nemotron
    reqs = _traffic(ct.vocab_size, 5, seed=11)
    srv = PagedContinuousBatchingServer(
        ct, pt, num_slots=4, max_len=48, block_size=8,
        mesh=make_host_mesh(device="cpu"))
    jsrv = JaxPaged(cj, pj, num_slots=4, max_len=48, block_size=8,
                    mesh=jax_host_mesh())
    for prompt, gen in reqs:
        srv.submit(prompt, gen)
        jsrv.submit(prompt, gen)
    done = {r.rid: r for r in srv.run()}
    jdone = {r.rid: r for r in jsrv.run()}
    solo = Server(ct, pt, max_len=48, device="cpu")
    assert len(done) == len(reqs)
    for rid, (prompt, gen) in enumerate(reqs):
        ref = solo.generate(torch.as_tensor(prompt)[None], gen,
                            decode="loop")
        np.testing.assert_array_equal(
            ref.tokens[0, prompt.size:].numpy(), done[rid].tokens,
            err_msg=f"rid {rid}: host-mesh paged != solo")
        np.testing.assert_array_equal(
            np.asarray(jdone[rid].tokens), done[rid].tokens,
            err_msg=f"rid {rid}: port != JAX host-mesh paged")
    assert tplib.collective_bytes()["all-reduce"] == 0.0


def test_executable_cache_keys_carry_mesh(nemotron):
    _, ct, _, pt = nemotron

    def serve_one(mesh):
        srv = PagedContinuousBatchingServer(
            ct, pt, num_slots=2, max_len=48, block_size=8, device="cpu",
            mesh=mesh)
        srv.submit(np.arange(1, 6, dtype=np.int32), 3)
        srv.run()
        return srv.executable_cache_keys()

    meshless = serve_one(None)
    meshed = serve_one(make_host_mesh(device="cpu"))
    assert meshless and meshed
    assert all(k[-1] is None for k in meshless)
    want = ((1, 1), ("data", "model"))
    assert all(k[-1] == want for k in meshed)
    assert not set(meshless) & set(meshed)


def test_replicated_tables_stay_valid_under_eviction(nemotron):
    """``tests/test_mesh_serving.py:140-202`` on the port: a tiny pool
    under shared-prefix traffic evicts, every dispatch's tables are in
    bounds, the tokens are solo's, and the allocator sums to capacity."""
    _, ct, _, pt = nemotron
    solo = Server(ct, pt, max_len=48, device="cpu")
    srv = PagedContinuousBatchingServer(
        ct, pt, num_slots=2, max_len=48, block_size=8, num_blocks=9,
        mesh=make_host_mesh(device="cpu"))
    rng = np.random.RandomState(5)
    reqs = []
    for _ in range(8):
        prompt = rng.randint(0, ct.vocab_size,
                             size=int(rng.randint(9, 13))).astype(np.int32)
        reqs.append((prompt, 8))
        srv.submit(prompt, 8)
    done = {r.rid: r for r in srv.run()}
    assert len(done) == len(reqs)
    for rid, (prompt, gen) in enumerate(reqs):
        ref = solo.generate(torch.as_tensor(prompt)[None], gen,
                            decode="loop")
        np.testing.assert_array_equal(ref.tokens[0, prompt.size:].numpy(),
                                      done[rid].tokens)
    assert srv.stats.evictions > 0, "pool never came under pressure"
    alloc = srv.mgr.alloc
    assert (alloc.num_free + alloc.num_evictable + alloc.in_use
            == alloc.capacity)
    assert (srv._tables == 0).all()


def test_tp_spec_host_mesh_places_everything(nemotron):
    _, ct, _, pt = nemotron
    mesh = make_host_mesh(device="cpu")
    srv = Server(ct, pt, max_len=32, mesh=mesh)
    assert srv.tp is not None and srv.tp.size == 1
    assert srv.tp.mesh_key == ((1, 1), ("data", "model"))
    assert srv.tp.cfg_local.num_heads == ct.num_heads
    assert srv.device == torch.device("cpu")
    # one rank: placement keeps the very tensors
    assert srv.params["layers"][0]["attn"]["wq"] is pt["layers"][0]["attn"][
        "wq"]
    solo = Server(ct, pt, max_len=32, device="cpu")
    prompts = np.random.RandomState(2).randint(0, ct.vocab_size, (2, 7))
    for decode in ("scan", "loop"):
        np.testing.assert_array_equal(
            srv.generate(prompts, 6, decode=decode).tokens.numpy(),
            solo.generate(prompts, 6, decode=decode).tokens.numpy())
    assert (5, ((1, 1), ("data", "model"))) in srv._decode_scans
    with pytest.raises(ValueError, match="canonical"):
        Server(ct, pt, max_len=32, device="cpu", mesh=object())


# -- tp=2: two gloo ranks on the CPU ----------------------------------------------

@pytest.fixture(scope="module")
def tp2(tmp_path_factory):
    """One spawned (1, 2) world serves the three configs, counts the
    collectives and tries the guard, while this process computes JAX's
    solo tokens on the same weights."""
    params, reqs, jcfgs = {}, {}, {}
    for arch in R.TP_ARCHS:
        if arch == "nemotron-int8":
            cj = dataclasses.replace(_jcfg("nemotron-4-15b"),
                                     kv_cache_dtype=jnp.int8)
        else:
            cj = dataclasses.replace(_jcfg(arch), use_pallas=True)
        jcfgs[arch] = cj
        params[arch] = _jparams(cj)
        reqs[arch] = _traffic(cj.vocab_size, 5, seed=3)
    comms_params = _jparams(_jcfg("nemotron-4-15b"), seed=1)
    box: dict = {}

    def world():
        try:
            box["ranks"] = ranks.run_ranks(
                R.tp_world, 2, timeout=TIMEOUT,
                store_dir=str(tmp_path_factory.mktemp("tp2")),
                args=((1, 2), params, reqs, comms_params))
        except BaseException as e:          # reported by the tests
            box["error"] = e

    th = threading.Thread(target=world)
    th.start()
    want = {}
    for arch, cj in jcfgs.items():
        solo = JaxServer(cj, jax.tree.map(jnp.asarray, params[arch]),
                         max_len=48)
        want[arch] = [np.asarray(solo.generate(
            jnp.asarray(p)[None, :], g, decode="loop").tokens)[0, p.size:]
            .tolist() for p, g in reqs[arch]]
    th.join(TIMEOUT + 30)
    assert not th.is_alive(), "the tp=2 world outlived its deadline"
    if "error" in box:
        raise box["error"]
    return box["ranks"], want, reqs


@pytest.mark.parametrize("arch", R.TP_ARCHS)
def test_tp2_serving_equals_jax_solo(tp2, arch):
    """tp=2 paged serving on two gloo ranks gives JAX's solo
    ``Server(decode="loop")`` tokens on both ranks."""
    results, want, reqs = tp2
    for res in results:
        assert res["transport"] == "gloo"
        got = res["serve"][arch]
        assert got["tp"] == 2
        assert got["local_heads"] == R.port_cfg(arch).num_heads // 2
        assert all(k[-1] == ((1, 2), ("data", "model"))
                   for k in got["keys"])
        for rid in range(len(reqs[arch])):
            assert got["tokens"][rid] == want[arch][rid], (arch, rid)


@pytest.mark.parametrize("steps", R.COMMS_STEPS)
def test_tp2_collective_bytes_equal_the_model(tp2, steps):
    """The bytes the helpers counted in a step and in a 6-step scan
    equal the analytic model, the port's and JAX's."""
    results, _, _ = tp2
    ct, cj = R.port_cfg("nemotron-4-15b"), _jcfg("nemotron-4-15b")
    model = roofline.tp_step_collectives(ct, batch=R.COMMS_BATCH, tp=2,
                                         steps=steps)
    jmodel = jroofline.tp_step_collectives(
        dataclasses.replace(cj, use_pallas=True), batch=R.COMMS_BATCH,
        tp=2, steps=steps)
    assert model == jmodel
    assert model["all-reduce"] > 0 and model["all-gather"] > 0
    for res in results:
        assert res["comms"][steps] == model, (steps, res["comms"][steps])


def test_tp2_refuses_indivisible_heads(tp2):
    results, _, _ = tp2
    for res in results:
        assert "num_heads 3 % tp 2 != 0" in res["guard"]


def test_tp2_solo_tokens_equal_port_solo(tp2):
    """The port's solo decode on the same weights gives the same tokens
    JAX's does (so tp=2 == port solo too)."""
    _, want, reqs = tp2
    arch = "nemotron-4-15b"
    cj = dataclasses.replace(_jcfg(arch), use_pallas=True)
    got = R.solo_tokens(R.port_cfg(arch), _jparams(cj), reqs[arch])
    assert got == want[arch]


# -- the comms model ------------------------------------------------------------

@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_comms_model_equals_jax(arch):
    cj, ct = _jcfg(arch), _tcfg(arch)
    for full in (False, True):
        if full:
            cj, ct = jcfg.get_config(arch), tcfg.get_config(arch)
        for tp in (1, 2, 4):
            for batch, seq, steps in ((1, 1, 1), (4, 1, 6), (3, 17, 2)):
                got = roofline.tp_step_collectives(ct, batch=batch, tp=tp,
                                                   seq=seq, steps=steps)
                want = jroofline.tp_step_collectives(
                    cj, batch=batch, tp=tp, seq=seq, steps=steps)
                assert got == want, (arch, full, tp, batch, seq, steps)
