"""The port's sharding rules and mesh descriptors against the reference
(device-free): ``repro_torch.parallel.sharding``, ``core/tuner.make_rules``,
``launch/mesh`` and ``models/module.axes_tree``.

* the six cases of ``tests/test_sharding_rules.py`` on the port, a spec
  being a plain tuple (``tuple(P(...))``);
* ``spec_for`` and ``fallbacks`` against the JAX ``Rules`` on the same
  table and mesh (hypothesis);
* ``make_rules`` tables equal to the reference's for every plan that
  ``enumerate_plans`` gives dbrx-132b, internlm2-1.8b and zamba2-7b, on
  the single-pod and multi-pod descriptors, production and factored;
* ``axes_tree`` of every arch's ``model_defs`` equal to the reference's,
  and ``param_shardings`` equal to the reference's specs leaf for leaf.
"""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")

import hypothesis.strategies as st  # noqa: E402
import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro.models import model_defs as jmodel_defs  # noqa: E402
from repro.models import module as jmodule  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.core import tuner  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model_defs, module  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

BASE = {"batch": "data", "heads": "model", "mlp": "model",
        "seq": "model", "expert": ("pool",), "wide": ("pool", "intra")}
MESH = mesh_lib.MeshDescriptor(("data", "model", "pool", "intra"),
                               (16, 16, 4, 4))
RULE_ARCHS = ("dbrx-132b", "internlm2-1.8b", "zamba2-7b")


def rules(table, mesh=MESH):
    return sh.Rules(table=dict(table), mesh=mesh)


def reference_rules(table, mesh=MESH):
    """The JAX ``Rules`` on the same table, over the same descriptor (it
    reads only ``.shape``)."""
    r = jsh.Rules(table=dict(table), mesh=None)
    r.mesh = mesh
    return r


# ------------------------------------- the reference's cases, on the port
def test_basic_spec():
    r = rules(BASE)
    assert r.spec_for(("batch", None, "mlp"), (256, 128, 4096)) == \
        ("data", None, "model")


def test_axis_used_once_first_dim_wins():
    r = rules(BASE)
    spec = r.spec_for(("batch", "seq", "heads", None), (256, 4096, 32, 128))
    assert spec == ("data", "model")


def test_partial_tuple_reduction():
    r = rules(BASE)
    spec = r.spec_for(("expert", None, "wide"), (8, 64, 4096))
    assert spec == ("pool", None, "intra")


def test_divisibility_fallback():
    r = rules(BASE)
    spec = r.spec_for(("batch", "heads"), (256, 8))  # 8 % 16 != 0
    assert spec == ("data",)
    assert any("heads" in f for f in r.fallbacks)


def test_tuple_prefix_shrinks_on_divisibility():
    r = rules({"wide": ("pool", "intra")})
    spec = r.spec_for(("wide",), (8,))
    assert spec == ("pool",)


AXES = st.lists(st.sampled_from([None, "batch", "heads", "mlp", "seq",
                                 "expert", "wide"]), min_size=1, max_size=5)
DIMS = st.lists(st.integers(1, 512), min_size=1, max_size=5)


@given(AXES, DIMS)
@settings(max_examples=200, deadline=None)
def test_spec_never_reuses_axis(axes, dims):
    dims = (dims * 5)[: len(axes)]
    r = rules(BASE)
    spec = r.spec_for(tuple(axes), tuple(dims))
    used = []
    for e in spec:
        if e is None:
            continue
        used.extend(e if isinstance(e, tuple) else (e,))
    assert len(used) == len(set(used)), (axes, dims, spec)
    for dim, e in zip(dims, tuple(spec) + (None,) * len(dims)):
        if e is not None:
            assert dim % r.mesh_size(e) == 0


@given(AXES, DIMS, st.booleans())
@settings(max_examples=200, deadline=None)
def test_spec_for_matches_reference(axes, dims, with_dims):
    dims = tuple((dims * 5)[: len(axes)]) if with_dims else None
    got, want = rules(BASE), reference_rules(BASE)
    spec = got.spec_for(tuple(axes), dims)
    assert spec == tuple(want.spec_for(tuple(axes), dims))
    assert got.fallbacks == want.fallbacks
    assert got.mesh_size(spec[0] if spec else None) == \
        want.mesh_size(spec[0] if spec else None)


def test_context_and_unsharded_like():
    r = rules(BASE)
    assert sh.current_rules() is None
    with sh.axis_rules(r):
        assert sh.current_rules() is r
        assert r.sharding_for(("batch",), (16,)) is None   # no DeviceMesh
    assert sh.current_rules() is None
    tree = {"a": [("x", None), 1.0], "b": {"c": 2}}
    assert sh.unsharded_like(tree) == \
        jax.tree.map(lambda _: None, tree)


# ------------------------------------------------------- mesh descriptors
def test_mesh_descriptors():
    prod = mesh_lib.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16}
    assert prod.axis_names == ("data", "model")
    pods = mesh_lib.make_production_mesh(multi_pod=True)
    assert pods.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh_lib.make_tuned_mesh(4).shape == \
        {"data": 16, "pool": 4, "intra": 4}
    assert mesh_lib.make_tuned_mesh(8, multi_pod=True).shape == \
        {"pod": 2, "data": 16, "pool": 8, "intra": 2}
    assert mesh_lib.make_tuned_mesh(1) == prod
    assert mesh_lib.describe(pods) == "pod=2xdata=16xmodel=16"
    with pytest.raises(ValueError):
        mesh_lib.make_tuned_mesh(3)


def _meshes(plan):
    for multi_pod in (False, True):
        for factored in (False, True):
            yield mesh_lib.mesh_for_plan(plan, multi_pod=multi_pod,
                                         factored=factored)


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("arch", RULE_ARCHS)
def test_make_rules_matches_reference(arch, pods):
    for shape_name in ("train_4k", "decode_32k"):
        plans = tuner.enumerate_plans(get_config(arch), SHAPES[shape_name],
                                      pods=pods)
        jplans = jtuner.enumerate_plans(jget_config(arch),
                                        JSHAPES[shape_name], pods=pods)
        assert [dataclasses.asdict(p) for p in plans] == \
            [dataclasses.asdict(p) for p in jplans]
        for plan, jplan in zip(plans, jplans):
            for p, jp in ((plan, jplan),
                          (dataclasses.replace(plan, cp=True),
                           dataclasses.replace(jplan, cp=True))):
                for mesh in _meshes(p):
                    got = tuner.make_rules(p, mesh)
                    want = jtuner.make_rules(jp, mesh)
                    assert got.table == want.table, (p.name, mesh)
                    assert got.context_parallel == want.context_parallel
                    assert got.mesh is mesh


# ----------------------------------------------------- parameter axes
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_tree_and_param_shardings_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    defs, jdefs = model_defs(cfg), jmodel_defs(jcfg)
    axes, jaxes = module.axes_tree(defs), jmodule.axes_tree(jdefs)
    assert axes == jaxes
    shapes = module.shapes_tree(defs)
    assert shapes == jmodule.shapes_tree(jdefs)
    assert module.param_count(defs) == jmodule.param_count(jdefs)
    shape = SHAPES["train_4k"]
    plan = tuner.guideline_plan(cfg, shape)
    mesh = mesh_lib.mesh_for_plan(plan, factored=True)
    got_rules = tuner.make_rules(plan, mesh)
    want_rules = jtuner.make_rules(
        jtuner.Plan(**dataclasses.asdict(plan)), mesh)
    got = sh.param_shardings(axes, shapes, got_rules)
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        e is None or isinstance(e, str) for e in x)
    want = jax.tree.map(lambda ax, shp: tuple(want_rules.spec_for(ax, shp)),
                        jaxes, jmodule.shapes_tree(jdefs), is_leaf=is_axes)
    assert got == want
    assert got_rules.fallbacks == want_rules.fallbacks
