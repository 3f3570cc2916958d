"""The port's energy model and planner held to the JAX package's (CPU).

  * ``estimate`` and ``normalized_edp`` with a port ``ChipSpec`` built,
    here, from ``dataclasses.asdict(repro.core.constants.V5E)``: equal to
    JAX's to 1e-12 relative, for every mode of every graph;
  * ``AutoPolicy`` plans and diagnostics on the graphs of
    ``tests/test_execution_plan.py`` (fallback, depth sweep, capacity
    limit, static-only layers, a plain ``Policy``), given the same spec
    and capacity: equal to JAX's;
  * the port's defaults are the H100's: ``estimate``'s chip, the
    planner's chip and a sidebar of half the SMs' shared memory;
  * the function table's host costs, version, membership and removal
    equal the JAX table's.
"""

import dataclasses

import jax.numpy as jnp
import pytest

from repro.core import constants as jc
from repro.core import energy as je
from repro.core import engine as jeng
from repro.core import function_table as jft
from repro.core import modes as jm
from repro.core import policy as jp
from repro.core import sidebar as jsb
from repro.models import lenet as jlenet
from repro_torch.core import constants as tc
from repro_torch.core import energy as te
from repro_torch.core import engine as teng
from repro_torch.core import function_table as tft
from repro_torch.core import modes as tm
from repro_torch.core import policy as tp
from repro_torch.kernels.ref import dot
from repro_torch.models import lenet as tlenet

MODES = ("monolithic", "flexible_dma", "sidebar", "sidebar_pipelined")
REL = 1e-12


def _graph(mods, name="g", b=64, d=512, f=1024, d2=8, act="softplus"):
    """``tests/test_execution_plan.py``'s ``_graph`` in either IR."""
    m, mm = mods
    return m.LayerGraph(name, ops=(
        m.StaticOp("w1", mm, (b, f), flops=2 * b * d * f,
                   weight_bytes=d * f * 4),
        m.FlexibleOp(act, (b, f)),
        m.StaticOp("w2", mm, (b, d2), flops=2 * b * f * d2,
                   weight_bytes=f * d2 * 4),
    ), in_shape=(b, d))


def _static_only(mods, name="s", b=8, d=32):
    m, mm = mods
    return m.LayerGraph(name, ops=(
        m.StaticOp("w", mm, (b, d), flops=2 * b * d * d,
                   weight_bytes=d * d * 4),), in_shape=(b, d))


JAX = (jm, lambda w, x: jnp.dot(x, w))
PORT = (tm, lambda w, x: dot(x, w, x.dtype))


def _graph_sets():
    """name -> (builder, kwargs) of every graph the tests plan."""
    return {
        "a": (_graph, dict(name="a")),
        "b": (_graph, dict(name="b", act="relu")),
        "c": (_static_only, dict(name="c")),
        "uneven": (_graph, dict(name="uneven")),
        "cap": (_graph, dict(name="cap", b=12)),
        "wide": (_graph, dict(name="wide", b=4, d=6144, f=24576, d2=6144,
                              act="squared_relu")),
    }


def _both(names):
    sets = _graph_sets()
    return ([sets[n][0](JAX, **sets[n][1]) for n in names],
            [sets[n][0](PORT, **sets[n][1]) for n in names])


@pytest.fixture(scope="module")
def spec():
    """The JAX chip, as a port ChipSpec built here from its fields."""
    return tc.ChipSpec(**dataclasses.asdict(jc.V5E))


@pytest.fixture(scope="module")
def tables():
    jt, tt = jft.make_default_table(), tft.make_default_table()
    jlenet.register_pooling(jt)
    tlenet.register_pooling(tt)
    return jt, tt


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(a), abs(b))


def _estimates_equal(je_, te_) -> None:
    ja, ta = dataclasses.asdict(je_), dataclasses.asdict(te_)
    assert ja.keys() == ta.keys()
    for k in ja:
        assert _close(ja[k], ta[k]), (k, ja[k], ta[k])
    assert _close(je_.edp, te_.edp)


@pytest.mark.parametrize("depth", (1, 2, 4, 8))
def test_estimate_and_edp_equal_jax_on_the_same_spec(spec, tables, depth):
    jt, tt = tables
    graphs = {
        "lenet_relu": (jlenet.to_layer_graphs(256, "relu"),
                       tlenet.to_layer_graphs(256, "relu")),
        "lenet_softplus": (jlenet.to_layer_graphs(256, "softplus"),
                           tlenet.to_layer_graphs(256, "softplus")),
        "plan_graphs": _both(list(_graph_sets())),
    }
    for name, (jgs, tgs) in graphs.items():
        for jg, tg in zip(jgs, tgs):
            jests, tests = {}, {}
            for mode in MODES:
                ja = jeng.account(jg, jm.ExecutionMode(mode), jt,
                                  depth=depth)
                ta = teng.account(tg, tm.ExecutionMode(mode), tt,
                                  depth=depth)
                jests[mode] = je.estimate(ja, jc.V5E)
                tests[mode] = te.estimate(ta, spec)
                _estimates_equal(jests[mode], tests[mode])
            jn, tn = je.normalized_edp(jests), te.normalized_edp(tests)
            assert jn.keys() == tn.keys()
            assert all(_close(jn[k], tn[k]) for k in jn), (name, jn, tn)


def test_accounting_merge_refuses_two_modes():
    a = te.TaskAccounting("sidebar", launches=1)
    assert a.merge(a).launches == 2
    with pytest.raises(ValueError, match="modes"):
        a.merge(te.TaskAccounting("monolithic"))


def _plan_tuple(lp):
    return (lp.mode.value, lp.depth, lp.fuse)


def _results_equal(jr, tr) -> None:
    assert _plan_tuple(jr.plan.default) == _plan_tuple(tr.plan.default)
    assert ({k: _plan_tuple(v) for k, v in jr.plan.layers.items()}
            == {k: _plan_tuple(v) for k, v in tr.plan.layers.items()})
    jd, td = jr.diagnostics, tr.diagnostics
    assert jd.fallbacks == td.fallbacks
    assert jd.edp.keys() == td.edp.keys()
    assert all(_close(jd.edp[k], td.edp[k]) for k in jd.edp)
    assert jd.depth_sweep.keys() == td.depth_sweep.keys()
    for k, sweep in jd.depth_sweep.items():
        assert sweep.keys() == td.depth_sweep[k].keys()
        assert all(_close(v, td.depth_sweep[k][d]) for d, v in sweep.items())


def _cap_capacity():
    """``test_auto_policy_capacity_limits_depth``'s capacity: depth 4
    fits exactly and depth 8 does not."""
    g = _graph(JAX, "cap", b=12)
    (_, op, shape), = g.flexible_ops()
    return jsb.pipelined_capacity(shape, op.out_shape, g.itemsize, tiles=4)


@pytest.mark.parametrize("names,capacity", [
    (("a", "b", "c"), None),
    (("uneven",), None),
    (("a",), 1024),                # capacity fallback to FLEXIBLE_DMA
    (("cap",), "cap"),             # capacity stops the depth sweep
    (("a", "b", "c", "uneven", "cap", "wide"), None),
    (("wide",), 2 * 1024 * 1024),
])
def test_auto_policy_plans_equal_jax(spec, tables, names, capacity):
    jt, tt = tables
    if capacity is None:
        capacity = jc.VMEM_BYTES_PER_CHIP // 2
    elif capacity == "cap":
        capacity = _cap_capacity()
    jgs, tgs = _both(names)
    jpol = jp.AutoPolicy(table=jt, sidebar_capacity=capacity, chip=jc.V5E)
    tpol = tp.AutoPolicy(table=tt, sidebar_capacity=capacity, chip=spec)
    jr, tr = jpol.plan(jgs), tpol.plan(tgs)
    _results_equal(jr, tr)
    for jg, tg in zip(jgs, tgs):
        assert jpol(jg).value == tpol(tg).value
        assert _plan_tuple(jr.for_layer(jg.name)) == _plan_tuple(
            tr.for_layer(tg.name))


def test_plain_policies_and_empty_plans_equal_jax(spec):
    jgs, tgs = _both(["a", "b"])
    jr = jp.plan(jgs, jp.fixed(jm.ExecutionMode.SIDEBAR))
    tr = tp.plan(tgs, tp.fixed(tm.ExecutionMode.SIDEBAR))
    _results_equal(jr, tr)
    _results_equal(jp.AutoPolicy(chip=jc.V5E).plan([]),
                   tp.AutoPolicy(chip=spec).plan([]))
    # the module-level plan with no policy is an AutoPolicy on the
    # port's own defaults (the H100)
    assert tp.plan(tgs).plan.layers.keys() == {"a", "b"}


def test_the_port_defaults_are_the_h100():
    h = tc.H100
    assert (h.peak_flops, h.hbm_bytes_per_s, h.ici_bytes_per_s,
            h.hbm_bytes) == (989e12, 3.35e12, 900e9, 80 * 10**9)
    assert h.vmem_bytes == 132 * 228 * 1024
    assert h.vpu_bytes_per_s == 132 * 128 * 1.98e9
    assert h.e_mxu_per_flop == 700.0 / 989e12
    assert tp.AutoPolicy().chip == h
    assert tp.AutoPolicy().sidebar_capacity == h.vmem_bytes // 2
    # no field is the JAX package's chip's
    jv = dataclasses.asdict(jc.V5E)
    assert all(v != jv[k] for k, v in dataclasses.asdict(h).items())
    assert set(dataclasses.asdict(h)) == set(jv)
    g = tlenet.to_layer_graphs(8)[0]
    table = tft.make_default_table()
    tlenet.register_pooling(table)
    acct = teng.account(g, tm.ExecutionMode.SIDEBAR, table)
    assert te.estimate(acct) == te.estimate(acct, h)


def test_function_table_interface_equals_jax():
    jt, tt = jft.make_default_table(), tft.make_default_table()
    assert jt.names() == tt.names()
    assert all(jt.cost(n) == tt.cost(n) for n in jt.names())
    assert tc.FLEXIBLE_OP_COST == jc.FLEXIBLE_OP_COST
    assert tc.DEFAULT_FLEXIBLE_OP_COST == jc.DEFAULT_FLEXIBLE_OP_COST
    v = tt.version
    assert "max_pool" not in tt
    tlenet.register_pooling(tt)
    tlenet.register_pooling(tt)          # idempotent
    assert "max_pool" in tt and tt.version == v + 1
    assert tt.cost("max_pool") == 1.0
    tt.register("mine", abs)             # no model cost: the default
    assert tt.cost("mine") == tc.DEFAULT_FLEXIBLE_OP_COST
    tt.register("mine", abs, vpu_ops_per_element=3.0, overwrite=True)
    assert tt.cost("mine") == 3.0 and tt["mine"].device_id is None
    tt.unregister("mine")
    assert "mine" not in tt and tt.version == v + 4
    with pytest.raises(KeyError):
        tt.unregister("mine")
