"""The port's analysis layer (``repro_torch.core``) against the reference.

* every case of ``tests/test_core.py`` run on the port: graph widths,
  training widening, guideline invariants, the sweep's order, the cost
  model's scaling and terms;
* ``test_models_smoke.py::test_param_counts_close_to_nameplates`` on the
  port's ``model_defs``;
* parity with the JAX functions for every arch at ``train_4k``,
  ``prefill_32k`` and ``decode_32k``: ``build_graph``'s widths (training
  and not), exact param and active-param counts, ``model_flops`` and
  ``attention_flops``, and ``compare_settings`` row for row (plan, cost
  terms, ``step_s``, ``fits``).  The port's ``Hardware`` is built from
  the fields of ``repro.core.cost_model.V5E`` there: the port carries
  only the card's figures.
"""

import dataclasses
import functools

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import autotune as jautotune  # noqa: E402
from repro.core import build_graph as jbuild_graph  # noqa: E402
from repro.core import cost_model as jcost_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.core import (autotune, build_graph, cost_model,  # noqa: E402
                              graph, tuner)

PARITY_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
REL = 1e-12


# ------------------------------------------------------------- graph widths
def test_paper_width_definition_example():
    """Paper §8: the Fig. 5b module (7 heavy ops, 3 levels) has avg width 2."""
    b = graph._Builder("fig5b")
    root = b.add("matmul", "in", 1.0)
    b.add("matmul", "b1.c1", 1.0, (root,))
    b.add("matmul", "b2.c1", 1.0, (root,))
    b3a = b.add("matmul", "b3.c1", 1.0, (root,))
    b.add("matmul", "b3.c2", 1.0, (b3a,))
    b4a = b.add("matmul", "b4.c1", 1.0, (root,))
    b4b = b.add("matmul", "b4.c2", 1.0, (b4a,))
    b.add("matmul", "b4.c3", 1.0, (b4b,))
    g = b.graph()
    assert g.depth == 4
    assert g.avg_width == 2
    assert g.max_width == 4


def test_widths_across_archs():
    dense = build_graph(get_config("mistral-large-123b"))
    assert dense.avg_width == 1
    moe = build_graph(get_config("dbrx-132b"))
    assert moe.avg_width >= 4
    assert moe.max_width >= 16
    whisper = build_graph(get_config("whisper-medium"))
    assert whisper.avg_width == 2  # encoder chain runs beside decoder chain


def test_training_widens_graph():
    cfg = get_config("internlm2-1.8b")
    g_inf = build_graph(cfg)
    g_tr = build_graph(cfg, training=True, global_batch=8)
    assert g_tr.num_heavy_ops == 2 * g_inf.num_heavy_ops
    assert g_tr.max_width == 2 * g_inf.max_width
    g_tr_big = build_graph(cfg, training=True, global_batch=256)
    assert g_tr_big.num_heavy_ops == g_inf.num_heavy_ops


@given(st.integers(1, 6), st.integers(1, 8), st.integers(1, 4))
@settings(max_examples=30, deadline=None)
def test_width_invariants_random_graphs(levels, width, fan):
    """avg_width <= max_width; depth == #levels for layered graphs."""
    b = graph._Builder("rand")
    prev_level = [b.add("matmul", "root", 1.0)]
    for li in range(levels):
        cur = []
        for wi in range(width):
            deps = tuple(prev_level[: max(1, min(fan, len(prev_level)))])
            cur.append(b.add("matmul", f"l{li}w{wi}", 1.0, deps))
        prev_level = cur
    g = b.graph()
    assert 1 <= g.avg_width <= g.max_width
    assert g.depth == levels + 1
    assert g.max_width == max(g.level_sizes())


# ------------------------------------------------------------------- tuner
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_guideline_plan_invariants(arch, shape):
    cfg = get_config(arch)
    plan = tuner.guideline_plan(cfg, SHAPES[shape])
    assert plan.pools * plan.intra == 16
    assert plan.pools >= 1
    if cfg.moe is None:
        assert plan.pools == 1
    else:
        assert plan.pools <= cfg.moe.num_experts
    avg_w = int(plan.notes.split("avg_width=")[1].split()[0])
    assert plan.pools <= max(avg_w, 1)


@given(st.sampled_from(ARCH_IDS), st.sampled_from(list(SHAPES)))
@settings(max_examples=20, deadline=None)
def test_enumerated_plans_are_valid(arch, shape_name):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    for plan in tuner.enumerate_plans(cfg, shape):
        assert plan.pools * plan.intra == 16
        if plan.pools > 1:
            assert cfg.moe and plan.pools <= cfg.moe.num_experts
    ranked = autotune.sweep(cfg, shape)
    costs = [r.step_s for r in ranked if r.fits]
    assert costs == sorted(costs)


def test_guideline_close_to_sweep_optimum():
    """Fig. 18 at cost-model level: the guideline within 1.5x of the swept
    optimum for every arch, on the card's figures."""
    for arch in ARCH_IDS:
        rows = autotune.compare_settings(get_config(arch), SHAPES["train_4k"])
        opt = rows["global_optimum"]
        gl = rows["guideline"]
        assert gl.step_s <= 1.5 * opt.step_s, (arch, gl.step_s, opt.step_s)


# -------------------------------------------------------------- cost model
def test_model_flops_scaling():
    cfg = get_config("internlm2-1.8b")
    f_train = cost_model.model_flops(cfg, SHAPES["train_4k"])
    f_pref = cost_model.model_flops(cfg, SHAPES["prefill_32k"])
    assert f_train == pytest.approx(3 * f_pref, rel=1e-6)  # 6ND vs 2ND
    f_dec = cost_model.model_flops(cfg, SHAPES["decode_32k"])
    assert f_dec < f_pref / 1000


def test_moe_active_params():
    cfg = get_config("dbrx-132b")
    total = cost_model.model_param_count(cfg)
    active = cost_model.model_active_param_count(cfg)
    assert active < 0.4 * total  # top-4 of 16 experts


@given(st.integers(1, 16).filter(lambda p: 16 % p == 0), st.booleans())
@settings(max_examples=20, deadline=None)
def test_cost_terms_positive(pools, fsdp):
    cfg = get_config("dbrx-132b")
    c = cost_model.estimate(cfg, SHAPES["train_4k"], data=16, pools=pools,
                            intra=16 // pools, fsdp=fsdp)
    assert c.compute_s > 0 and c.memory_s > 0 and c.collective_s >= 0
    assert c.dominant in ("compute", "memory", "collective")


def test_param_counts_close_to_nameplates():
    expect = {"dbrx-132b": 132e9, "grok-1-314b": 314e9,
              "mistral-large-123b": 123e9, "gemma2-2b": 2.6e9,
              "gemma3-12b": 12e9, "internlm2-1.8b": 1.8e9,
              "pixtral-12b": 12e9, "rwkv6-7b": 7.6e9}
    for arch, n in expect.items():
        got = cost_model.model_param_count(get_config(arch))
        assert abs(got - n) / n < 0.25, (arch, got, n)


def test_shapes_and_live_cells_match_reference():
    from repro.configs import get_shape as jget_shape
    from repro.configs import live_cells as jlive_cells
    from repro_torch.configs import get_shape, live_cells
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    assert dataclasses.asdict(get_shape("decode_32k")) == \
        dataclasses.asdict(jget_shape("decode_32k"))
    assert live_cells() == jlive_cells()


def test_hardware_is_the_card():
    """The default describes the H100 SXM5 80GB (data-sheet figures)."""
    hw = cost_model.Hardware()
    assert hw == cost_model.H100
    assert (hw.name, hw.peak_flops, hw.hbm_bw, hw.ici_bw, hw.dcn_bw,
            hw.hbm_bytes) == ("h100-sxm5-80gb", 989e12, 3.35e12, 450e9,
                              50e9, 80e9)
    assert [f.name for f in dataclasses.fields(cost_model.Hardware)] == \
        [f.name for f in dataclasses.fields(jcost_model.Hardware)]


# ------------------------------------------- parity with the JAX functions
REF_HW = cost_model.Hardware(**dataclasses.asdict(jcost_model.V5E))


@pytest.fixture(scope="module", autouse=True)
def _memoized_reference_param_count():
    """The reference recounts a config's ``ParamDef`` tables on every
    estimate (most of these tests' time); its count is a pure function of
    the frozen config, so it is memoized here, as the port's is."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcost_model, "model_param_count",
                   functools.lru_cache(maxsize=None)(
                       jcost_model.model_param_count))
        yield


def _graph_numbers(g):
    return (g.num_heavy_ops, g.depth, g.avg_width, g.max_width,
            g.level_sizes())


def _row(r):
    return (dataclasses.asdict(r.plan), r.cost.compute_s, r.cost.memory_s,
            r.cost.collective_s, r.step_s, r.fits, r.cost.dominant)


@pytest.mark.parametrize("shape_name", PARITY_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_parity_with_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
    for training in (False, True):
        kw = dict(training=training, global_batch=shape.global_batch)
        g, jg = build_graph(cfg, **kw), jbuild_graph(jcfg, **kw)
        assert _graph_numbers(g) == _graph_numbers(jg)
        assert g.level_flops() == jg.level_flops()
    assert cost_model.model_param_count(cfg) == \
        jcost_model.model_param_count(jcfg)
    assert cost_model.model_active_param_count(cfg) == \
        jcost_model.model_active_param_count(jcfg)
    assert cost_model.model_flops(cfg, shape) == pytest.approx(
        jcost_model.model_flops(jcfg, jshape), rel=REL)
    assert cost_model.attention_flops(cfg, shape) == pytest.approx(
        jcost_model.attention_flops(jcfg, jshape), rel=REL)
    got = autotune.compare_settings(cfg, shape, hw=REF_HW)
    want = jautotune.compare_settings(jcfg, jshape)
    assert list(got) == list(want)
    for name in want:
        g_row, w_row = _row(got[name]), _row(want[name])
        assert g_row[0] == w_row[0], name
        assert g_row[1:5] == pytest.approx(w_row[1:5], rel=REL), name
        assert g_row[5:] == w_row[5:], name
