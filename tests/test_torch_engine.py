"""The port's analytical engine held to the JAX package's (CPU).

The same graphs, parameters and inputs go through ``repro.core.engine``
and ``repro_torch.core.engine``:

  * ``account``, ``pipeline_schedule`` and every ``StageTiming`` field
    equal JAX's exactly, on LeNet (batch 8 and the paper's 256), the
    MLP graph of ``tests/test_core_engine.py`` and seeded random graphs,
    under the four modes, ring depths 1, 2, 3, 4 and 8, fuse on and off;
  * ``run``: outputs within 1e-5 (the MLP and random graphs, fp32) and
    1e-4 (LeNet, the tolerance ``examples/lenet_paper_workload.py``
    holds its modes to) of JAX's, and every ``SidebarStats`` field and
    ``launches`` equal to JAX's, under the same modes and depths;
  * the ring's tile split is lossless: pipelined == serial bit for bit
    on LeNet; where torch's CPU kernels round by element position
    (sigmoid, softplus, gelu) within 2 ulp (ROADMAP Queue 3);
  * MONOLITHIC is frozen at build: a table hot-swap after build leaves
    its output as it was, while SIDEBAR picks the new function up;
  * LeNet's JAX params through ``bridge.lenet_params_from_jax``: the
    port's ``forward`` equals JAX's.

Card cases (the activation kernel under FLEXIBLE_DMA, SIDEBAR on a CUDA
input) live in ``tests/test_torch_engine_card.py``, which imports no
JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jeng
from repro.core import function_table as jft
from repro.core import modes as jm
from repro.models import lenet as jlenet
from repro_torch import bridge
from repro_torch.core import engine as teng
from repro_torch.core import function_table as tft
from repro_torch.core import modes as tm
from repro_torch.kernels.ref import dot
from repro_torch.models import lenet as tlenet

MODES = ("monolithic", "flexible_dma", "sidebar", "sidebar_pipelined")
DEPTHS = (1, 2, 3, 4, 8)
ACTS = ("relu", "tanh", "sigmoid", "softplus", "gelu")


def _jmm(w, x):
    return jnp.dot(x, w, preferred_element_type=jnp.float32).astype(x.dtype)


def _tmm(w, x):
    return dot(x, w, x.dtype)


def _both(name, in_shape, ops):
    """One graph in both IRs from ("s", name, out_shape, flops, wbytes)
    and ("f", function, out_shape) rows (static ops are products)."""
    jops, tops = [], []
    for row in ops:
        if row[0] == "s":
            _, n, shape, flops, wb = row
            jops.append(jm.StaticOp(n, _jmm, shape, flops=flops,
                                    weight_bytes=wb))
            tops.append(tm.StaticOp(n, _tmm, shape, flops=flops,
                                    weight_bytes=wb))
        else:
            _, fn, shape = row
            jops.append(jm.FlexibleOp(fn, shape))
            tops.append(tm.FlexibleOp(fn, shape))
    return (jm.LayerGraph(name, tuple(jops), in_shape),
            tm.LayerGraph(name, tuple(tops), in_shape))


def _mlp_case():
    """The MLP graph, params and input of ``tests/test_core_engine.py``."""
    b, d, f = 8, 64, 256
    graphs = _both("mlp", (b, d), [
        ("s", "w1", (b, f), 2 * b * d * f, d * f * 4),
        ("f", "softplus", (b, f)),
        ("s", "w2", (b, d), 2 * b * f * d, f * d * 4),
    ])
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(size=(d, f)).astype(np.float32) * 0.05,
              "w2": rng.normal(size=(f, d)).astype(np.float32) * 0.05}
    x = rng.normal(size=(b, d)).astype(np.float32)
    return graphs, params, x


def _random_case(seed):
    """A random alternating graph (runs of flexible ops included) with
    its params and input, as ``tests/test_engine_pipeline.py`` draws."""
    rng = np.random.default_rng(seed)
    b = int(rng.integers(1, 5)) * 2
    dims = [int(rng.integers(1, 9)) * 4]
    rows, params = [], {}
    for i in range(int(rng.integers(2, 7))):
        if rng.random() < 0.5:
            d_in, d_out = dims[-1], int(rng.integers(1, 9)) * 4
            rows.append(("s", f"w{i}", (b, d_out), 2 * b * d_in * d_out,
                         d_in * d_out * 4))
            params[f"w{i}"] = np.asarray(rng.normal(size=(d_in, d_out))
                                         * 0.1, np.float32)
            dims.append(d_out)
        else:
            rows.append(("f", ACTS[int(rng.integers(0, len(ACTS)))],
                         (b, dims[-1])))
    x = np.asarray(rng.normal(size=(b, dims[0])) * 0.5, np.float32)
    return _both(f"rand{seed}", (b, dims[0]), rows), params, x


@pytest.fixture(scope="module")
def tables():
    """Fresh tables on both sides, with LeNet's pooling registered."""
    jt, tt = jft.make_default_table(), tft.make_default_table()
    jlenet.register_pooling(jt)
    tlenet.register_pooling(tt)
    return jt, tt


def _lenet_case(batch, act="relu"):
    jp = jlenet.init(jax.random.PRNGKey(0))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                   (batch, 3, 32, 32), jnp.float32))
    graphs = (jlenet.to_layer_graphs(batch, act)[0],
              tlenet.to_layer_graphs(batch, act)[0])
    return graphs, jax.tree.map(np.asarray, jp), x


def _cases():
    return {"mlp": _mlp_case, "lenet": lambda: _lenet_case(8),
            **{f"rand{s}": (lambda s=s: _random_case(s)) for s in range(4)}}


def _params_both(name, params):
    if name == "lenet":
        tp = bridge.lenet_params_from_jax(params, device="cpu")
        return (jlenet.engine_params(jax.tree.map(jnp.asarray, params)),
                tlenet.engine_params(tp))
    return ({k: jnp.asarray(v) for k, v in params.items()},
            {k: torch.from_numpy(v.copy()) for k, v in params.items()})


def _jmode(mode):
    return jm.ExecutionMode(mode)


def _tmode(mode):
    return tm.ExecutionMode(mode)


# ---------------------------------------------------------------------------
# Accounting and the pipeline schedule
# ---------------------------------------------------------------------------


def _account_graphs():
    out = {name: make()[0] for name, make in _cases().items()}
    out["lenet256_softplus"] = (jlenet.to_layer_graphs(256, "softplus")[0],
                                tlenet.to_layer_graphs(256, "softplus")[0])
    return out


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
def test_account_and_schedule_equal_jax(tables, depth, fuse):
    jt, tt = tables
    for name, (jg, tg) in _account_graphs().items():
        js = jeng.pipeline_schedule(jg, jt, depth=depth, fuse=fuse)
        ts = teng.pipeline_schedule(tg, tt, depth=depth, fuse=fuse)
        assert len(js) == len(ts), name
        for a, b in zip(js, ts):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert (a.overlap_cycles, a.stall_cycles) == (
                b.overlap_cycles, b.stall_cycles), name
        for mode in MODES:
            ja = jeng.account(jg, _jmode(mode), jt, depth=depth, fuse=fuse)
            ta = teng.account(tg, _tmode(mode), tt, depth=depth, fuse=fuse)
            assert dataclasses.asdict(ja) == dataclasses.asdict(ta), (
                name, mode)
            # a LayerPlan carries the same three knobs
            lp = tm.LayerPlan(_tmode(mode), depth=depth, fuse=fuse)
            assert teng.account(tg, lp, tt) == ta


def test_account_model_and_host_cycles_equal_jax(tables):
    jt, tt = tables
    jg = jlenet.to_layer_graphs(256, "relu") * 3
    tg = tlenet.to_layer_graphs(256, "relu") * 3
    for mode in MODES:
        ja = jeng.account_model(jg, _jmode(mode), jt)
        ta = teng.account_model(tg, _tmode(mode), tt)
        assert dataclasses.asdict(ja) == dataclasses.asdict(ta), mode
    for (i, jop, shape), (_, top, _) in zip(jg[0].flexible_ops(),
                                            tg[0].flexible_ops()):
        assert (jeng.host_cycles_of(jop, shape, jt)
                == teng.host_cycles_of(top, shape, tt))
    with pytest.raises(ValueError, match="depth"):
        teng.pipeline_schedule(tg[0], tt, depth=0)


def test_ir_bookkeeping_equals_jax(tables):
    for name, (jg, tg) in _account_graphs().items():
        assert jg.shapes() == tg.shapes(), name
        assert (jg.in_bytes, jg.out_bytes, jg.static_flops, jg.weight_bytes,
                jg.max_intermediate_bytes()) == (
            tg.in_bytes, tg.out_bytes, tg.static_flops, tg.weight_bytes,
            tg.max_intermediate_bytes()), name
        for fuse in (True, False):
            assert (jm.flexible_runs(jg, fuse=fuse)
                    == tm.flexible_runs(tg, fuse=fuse)), name
        assert ([[type(op).__name__ for op in c]
                 for c in jm.segment_static_chains(jg)]
                == [[type(op).__name__ for op in c]
                    for c in tm.segment_static_chains(tg)]), name
    with pytest.raises(ValueError, match="no ops"):
        tm.LayerGraph("empty", (), (1,))


# ---------------------------------------------------------------------------
# Numeric execution
# ---------------------------------------------------------------------------


def _run_both(tables, name, mode, depth=2, fuse=True):
    (jg, tg), params, x = _cases()[name]()
    jp, tp = _params_both(name, params)
    jt, tt = tables
    jr = jeng.run(jg, jp, jnp.asarray(x), _jmode(mode), jt, depth=depth,
                  fuse=fuse)
    tr = teng.run(tg, tp, torch.from_numpy(x.copy()), _tmode(mode), tt,
                  depth=depth, fuse=fuse)
    return jr, tr


def _check_run(name, jr, tr):
    tol = 1e-4 if name == "lenet" else 1e-5
    np.testing.assert_allclose(tr.output.numpy(), np.asarray(jr.output),
                               rtol=tol, atol=tol, err_msg=name)
    assert tr.output.dtype == torch.float32
    assert tr.launches == jr.launches, name
    assert dataclasses.asdict(tr.accounting) == dataclasses.asdict(
        jr.accounting), name
    if jr.sidebar is None:
        assert tr.sidebar is None
    else:
        assert dataclasses.asdict(tr.sidebar.stats) == dataclasses.asdict(
            jr.sidebar.stats), name
        assert tr.sidebar.capacity == jr.sidebar.capacity, name


@pytest.mark.parametrize("name", list(_cases()))
@pytest.mark.parametrize("mode", ["monolithic", "flexible_dma", "sidebar"])
def test_run_equals_jax(tables, name, mode):
    jr, tr = _run_both(tables, name, mode)
    _check_run(name, jr, tr)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", ["mlp", "lenet", "rand1", "rand3"])
def test_pipelined_run_equals_jax(tables, name, depth, fuse):
    jr, tr = _run_both(tables, name, "sidebar_pipelined", depth, fuse)
    _check_run(name, jr, tr)
    # the ring's tiles are split and joined losslessly: LeNet (relu and
    # max_pool) gives the serial sidebar's bits at every depth. torch's
    # CPU sigmoid / softplus / gelu round an element by its place in the
    # tensor (vectorized body, scalar tail), so a tile split moves their
    # last bit (ROADMAP Queue 3, divergence 5): within 2 ulp there
    _, serial = _run_both(tables, name, "sidebar")
    if name == "lenet":
        assert torch.equal(tr.output, serial.output)
    else:
        torch.testing.assert_close(tr.output, serial.output, rtol=2.4e-7,
                                   atol=1e-8)


def test_run_takes_a_layer_plan(tables):
    (_, tg), params, x = _mlp_case()
    _, tp = _params_both("mlp", params)
    lp = tm.LayerPlan(tm.ExecutionMode.SIDEBAR_PIPELINED, depth=4,
                      fuse=False)
    a = teng.run(tg, tp, torch.from_numpy(x), lp, tables[1])
    b = teng.run(tg, tp, torch.from_numpy(x),
                 tm.ExecutionMode.SIDEBAR_PIPELINED, tables[1], depth=4,
                 fuse=False)
    assert dataclasses.asdict(a.sidebar.stats) == dataclasses.asdict(
        b.sidebar.stats)
    assert a.sidebar.stats.host_invocations == 4


def test_monolithic_is_frozen_at_build():
    """Changing the algorithm after 'tape-out' does not change the
    monolithic design; the sidebar design picks it up (the JAX engine's
    ``test_monolithic_is_frozen_at_build``)."""
    (_, tg), params, x = _mlp_case()
    _, tp = _params_both("mlp", params)
    x = torch.from_numpy(x)
    table = tft.make_default_table()
    mono = teng.build_monolithic(tg, table)
    before = mono(tp, x)
    version = table.version
    table.register("softplus", lambda v: torch.clamp_min(v, 0.0),
                   overwrite=True)
    assert table.version == version + 1
    assert torch.equal(mono(tp, x), before)           # frozen silicon
    sidebar = teng.run(tg, tp, x, tm.ExecutionMode.SIDEBAR, table).output
    assert not torch.allclose(sidebar, before)        # flexible design
    relu_out = teng.run(tg, tp, x, tm.ExecutionMode.MONOLITHIC,
                        table).output                 # rebuilt by run
    assert torch.equal(relu_out, sidebar)


@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_lenet_params_through_the_bridge(tables, act):
    """JAX LeNet params (numpy) -> the port's: the plain forwards agree,
    and every engine mode on the port's side is within 1e-4 of JAX's
    forward."""
    jt, tt = tables
    (_, tg), params, x = _lenet_case(8, act)
    tp = bridge.lenet_params_from_jax(params, device="cpu")
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in params.items()}
    want = np.asarray(jlenet.forward(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(x), jt.lookup(act)))
    got = tlenet.forward(tp, torch.from_numpy(x), tt.lookup(act))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    for mode in MODES:
        out = teng.run(tg, tlenet.engine_params(tp), torch.from_numpy(x),
                       _tmode(mode), tt).output
        np.testing.assert_allclose(out.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=mode)


def test_lenet_init_is_seeded_and_shaped():
    a = tlenet.init(torch.Generator().manual_seed(0), device="cpu")
    b = tlenet.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    jp = jlenet.init(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: v.shape for k, v in jp.items()}
    # the JAX scales: unit normals over the root of the fan-in
    assert 0.5 < float(a["fc1"].std() * 400 ** 0.5) < 1.5
