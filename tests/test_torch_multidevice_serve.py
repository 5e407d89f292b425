"""PyTorch port: data-parallel serving, ``Engine(rules=...)`` on SPMD
ranks over a ``DeviceMesh`` (counterpart of tests/test_multidevice_serve.py
and of tests/test_paged_cache.py's ``test_engine_accepts_rules_single_device``
and ``test_cachespec_data_axis_sharding_specs``).

The reference forces two host devices in a subprocess; the port spawns
gloo ranks (``torch.multiprocessing``, a ``file://`` store, no port
opened), each building the same engine on the CPU with the JAX weights
carried over by the bridge.  Every rank's ``{rid: out_tokens}`` must equal
the unsharded engine's: the JAX engine's for the reference test's six
prefix-sharing requests on fp32 pools (and for the one-rank mesh), the
port's own for the int8 and fp8_e4m3 pools, ``slots=3`` (the batch rule
falls back), gemma2's two pool groups, two executables (whole prompts
and segments) and a pool tight enough to preempt.  Each rank holds
``slots / 2`` table rows and its own page range.  The host decisions
that read a rank's own clock are refused across ranks.
Only this module's test process imports JAX; the ranks import torch and
the port alone.
"""

import os
import pickle
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCH = "internlm2-1.8b"
RANKS = 2
SPAWN_TIMEOUT_S = 240
PREFIX = [(3 * j) % 200 + 1 for j in range(10)]


def prompts():
    """The reference test's six requests: a shared 10-token prefix and
    tails of 1-3 tokens, 6 new tokens each."""
    return [PREFIX + [(7 * i + j) % 150 + 1 for j in range(1 + i % 3)]
            for i in range(6)]


def serve(eng, req_cls, max_new=6):
    for i, p in enumerate(prompts()):
        assert eng.submit(req_cls(rid=i, prompt=list(p),
                                  max_new_tokens=max_new)) is None
    return {r.rid: list(r.out_tokens) for r in eng.run(max_steps=50_000)}


# the sharded runs: (name, arch, engine keywords)
SCENARIOS = [
    ("fp32", ARCH, dict(slots=2, max_len=64)),
    ("int8", ARCH, dict(slots=2, max_len=64, kv_dtype="int8")),
    ("fp8", ARCH, dict(slots=2, max_len=64, kv_dtype="fp8_e4m3")),
    ("slots3", ARCH, dict(slots=3, max_len=64)),
    ("gemma2", "gemma2-2b", dict(slots=2, max_len=64)),
    ("legacy", ARCH, dict(slots=2, max_len=64, chunked_prefill=False)),
    # prompts over the largest bucket: prefilled as 8-token segments
    ("segments", ARCH, dict(slots=2, max_len=64, chunked_prefill=False,
                            buckets=[8])),
    ("pressure", ARCH, dict(slots=4, max_len=64, num_pages=8,
                            sync_interval=2)),
]


def _rank_main(rank, world, store, out_dir, weights):
    """One gloo rank: every scenario's engine under a ``("data",)`` mesh
    of ``world`` ranks; what each observed, pickled to ``out_dir``."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.module import params_from_numpy
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.cache import CacheSpec
    from repro_torch.serve.engine import Engine, Request

    torch.set_num_threads(1)
    mesh_lib.join_process_group("gloo", rank=rank, world_size=world,
                                init_method=f"file://{store}")
    try:
        mesh = mesh_lib.device_mesh((world,), ("data",), device_type="cpu")
        params = {a: params_from_numpy(w, device="cpu")
                  for a, w in weights.items()}
        out = {}
        for name, arch, kw in SCENARIOS:
            rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                             mesh=mesh)
            eng = Engine(reduced(get_config(arch)), params[arch],
                         device="cpu", rules=rules, **kw)
            tokens = serve(eng, Request)
            out[name] = {
                "tokens": tokens,
                "shards": eng.shards, "shard": eng.shard,
                "fallbacks": list(rules.fallbacks),
                "tables": {k: tuple(t.shape) for k, t in
                           eng.cache["page_tables"].items()},
                "pools": {k: tuple(eng.cache["layers"][i]["pk"].shape)
                          for i, k in _first_layer_of_group(eng)},
                "prefix": eng.prefix_stats(),
                "memory": eng.memory_stats(),
                "faults": eng.fault_stats(),
                "leaked": eng.leaked_pages(),
                "host_syncs": eng.host_syncs, "chunks": eng.chunks}
        # host decisions that read the rank's own clock: refused
        rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                         mesh=mesh)
        cfg = reduced(get_config(ARCH))
        refused = {}
        for what, kw in (("slo", dict(policy="slo")),
                         ("shed", dict(shed_policy="shed-lowest-class",
                                       queue_limit=2))):
            try:
                Engine(cfg, params[ARCH], device="cpu", rules=rules,
                       slots=2, max_len=64, **kw)
            except NotImplementedError as e:
                refused[what] = str(e)
        eng = Engine(cfg, params[ARCH], device="cpu", rules=rules, slots=2,
                     max_len=64)
        for rid, (what, kw) in enumerate((("ttl", dict(ttl=5.0)),
                                          ("deadline", dict(deadline=1e9)))):
            try:
                eng.submit(Request(rid=rid, prompt=[5, 6, 7],
                                   max_new_tokens=2, **kw))
            except NotImplementedError as e:
                refused[what] = str(e)
        out["refused"] = {"why": refused, "queued": len(eng.queue)}
        # the placements the cache's leaves get on this mesh
        spec = CacheSpec.from_config(reduced(get_config(ARCH)), 2, 64)
        rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                         mesh=mesh)
        placed = spec.shardings(rules)
        out["placements"] = {
            "len": repr(placed["len"]),
            "pk": repr(placed["layers"][0]["pk"]),
            "local_range": rules.local_range(("data",), (4, 7)),
            "coordinate": rules.coordinate("data")}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _example_rank(rank, world, store, out_dir):
    from repro_torch.examples import serve_sharded

    torch.set_num_threads(1)
    done = serve_sharded.main([
        "--device", "cpu", "--init-method", f"file://{store}",
        "--rank", str(rank), "--world-size", str(world)])
    with open(os.path.join(out_dir, f"example{rank}.pkl"), "wb") as f:
        pickle.dump(done, f)


def _first_layer_of_group(eng):
    seen = {}
    for i, ls in enumerate(eng.local_spec.layers):
        key = eng.local_spec.groups[ls.group].key
        seen.setdefault(key, i)
    return [(i, k) for k, i in seen.items()]


def spawn(fn, nprocs, args, timeout=SPAWN_TIMEOUT_S):
    """``fn(rank, *args)`` on ``nprocs`` spawned processes; raises a
    rank's exception, or ``TimeoutError`` (the ranks killed) past
    ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# fixtures: the JAX weights, the reference's tokens, the ranks' runs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    """Reduced internlm2 and gemma2 at ``PRNGKey(0)`` as numpy trees, and
    the unsharded JAX engine's tokens on the six requests."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import model_defs
    from repro.models import module as jm
    from repro.serve.engine import Engine as JEngine, Request as JRequest

    weights, jcfg = {}, {}
    for arch in (ARCH, "gemma2-2b"):
        jcfg[arch] = jreduced(jget(arch))
        jp = jm.init_params(model_defs(jcfg[arch]), jax.random.PRNGKey(0),
                            jnp.float32)
        weights[arch] = jax.tree.map(np.asarray, jp)
    jp = jax.tree.map(jnp.asarray, weights[ARCH])
    want = serve(JEngine(jcfg[ARCH], jp, slots=2, max_len=64), JRequest)
    one = JEngine(jcfg[ARCH], jp, slots=2, max_len=64)
    one.submit(JRequest(rid=0, prompt=[5, 6, 7], max_new_tokens=6))
    (r,) = one.run()
    return {"weights": weights, "want": want, "one": list(r.out_tokens)}


@pytest.fixture(scope="module")
def ranks(jax_side):
    """The scenarios on 2 gloo ranks: each rank's observations."""
    with tempfile.TemporaryDirectory() as d:
        spawn(_rank_main, RANKS,
              (RANKS, os.path.join(d, "store"), d, jax_side["weights"]))
        out = []
        for r in range(RANKS):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def unsharded(jax_side):
    """The port's unsharded engine on each scenario (``rules=None``)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.module import params_from_numpy
    from repro_torch.serve.engine import Engine, Request

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params = {a: params_from_numpy(w, device="cpu")
                  for a, w in jax_side["weights"].items()}
        return {name: serve(Engine(reduced(get_config(arch)), params[arch],
                                   device="cpu", **kw), Request)
                for name, arch, kw in SCENARIOS}
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the mirror of test_sharded_engine_matches_unsharded_tokens
# ---------------------------------------------------------------------------

def test_sharded_engine_matches_unsharded_jax_tokens(ranks, jax_side):
    """Slot state and page pools split over 2 ranks serve the JAX
    unsharded engine's tokens through continuous batching, prefix sharing
    (hits on each rank's own pages) and the fused chunk; each rank holds
    ``slots / 2`` table rows and ``num_pages / 2`` pages plus its trash
    page."""
    for r, out in enumerate(ranks):
        run = out["fp32"]
        assert run["tokens"] == jax_side["want"], (r, run["tokens"])
        assert len(run["tokens"]) == 6
        assert (run["shards"], run["shard"]) == (RANKS, r)
        assert run["prefix"]["prefix_hits"] > 0
        assert run["prefix"]["prefill_tokens_skipped"] > 0
        assert run["tables"] == {"ring8": (1, 8)}
        assert run["pools"] == {"ring8": (8 + 1, 8, 2, 16)}
        assert run["fallbacks"] == []
        assert run["leaked"] == 0
        # one all-gathered drain per chunk, the same count on each rank
        assert run["host_syncs"] == run["chunks"] == ranks[0]["fp32"]["chunks"]


def test_memory_stats_global_with_rank_share(ranks):
    for r, out in enumerate(ranks):
        mem = out["fp32"]["memory"]
        assert mem["num_pages"] == 16 and mem["pages_in_use"] == \
            ranks[0]["fp32"]["memory"]["pages_in_use"]
        share = mem["rank"]
        assert (share["shard"], share["shards"], share["slots"]) == (r, 2, 1)
        assert share["num_pages"] == 8
        assert share["paged_kv_bytes"] * 2 == mem["paged_kv_bytes"]


@pytest.mark.parametrize("name", ["int8", "fp8", "slots3", "gemma2",
                                  "legacy", "segments", "pressure"])
def test_sharded_engine_matches_unsharded_port(ranks, unsharded, name):
    """int8 and fp8_e4m3 pools, ``slots=3`` (the batch rule falls back:
    every rank serves every slot), gemma2's two pool groups each split on its own,
    two executables (with prompts longer than the largest bucket, as
    segments), and pool pressure (preemption decided per shard): every
    rank's tokens are the unsharded port engine's."""
    for out in ranks:
        run = out[name]
        assert run["tokens"] == unsharded[name], (name, run["tokens"])
        assert run["leaked"] == 0
    first = ranks[0][name]
    if name == "slots3":
        assert first["shards"] == 1
        assert any(f.startswith("batch: dim 3") for f in first["fallbacks"])
        assert first["tables"] == {"ring8": (3, 8)}
    elif name == "gemma2":
        # the window-16 ring carries the fused chunk's 31 rows of slack
        assert first["tables"] == {"ring6": (1, 6), "ring8": (1, 8)}
        assert {k: v[0] for k, v in first["pools"].items()} == \
            {"ring6": 6 + 1, "ring8": 8 + 1}
    elif name == "pressure":
        assert first["tables"] == {"ring8": (2, 8)}
        assert first["pools"]["ring8"][0] == 4 + 1
        assert first["faults"]["pressure_preemptions"] > 0
    else:
        assert first["shards"] == RANKS


def test_clock_decisions_refused_across_ranks(ranks):
    """Each rank reads its own clock, so the host decisions that read it
    could part across ranks: ``policy="slo"``,
    ``shed_policy="shed-lowest-class"`` and a request's ``ttl`` or
    ``deadline`` raise on 2 ranks, naming ROADMAP A22, and nothing is
    queued."""
    for out in ranks:
        got = out["refused"]
        assert sorted(got["why"]) == ["deadline", "shed", "slo", "ttl"]
        assert all("A22" in why for why in got["why"].values())
        assert got["queued"] == 0


def test_placements_on_the_device_mesh(ranks):
    """``Rules.sharding_for`` on a ``DeviceMesh``: the slot dim and the
    page dim ``Shard(0)`` on the data axis; a rank's rows and
    coordinate."""
    for r, out in enumerate(ranks):
        pl = out["placements"]
        assert pl["len"] == "(Shard(dim=0),)"
        assert pl["pk"] == "(Shard(dim=0),)"
        assert pl["coordinate"] == r
        assert pl["local_range"] == (2 * r, 2 * r + 2)


# ---------------------------------------------------------------------------
# one rank, and what stays refused
# ---------------------------------------------------------------------------

def test_engine_accepts_rules_single_device(jax_side, tmp_path):
    """A one-rank ``("data",)`` mesh: the rules place everything on that
    rank, and the tokens are the unsharded JAX engine's."""
    import torch.distributed as dist

    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models.module import params_from_numpy
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.engine import Engine, Request

    mesh_lib.join_process_group("gloo", rank=0, world_size=1,
                                init_method=f"file://{tmp_path / 'store'}")
    try:
        mesh = mesh_lib.device_mesh((1,), ("data",), device_type="cpu")
        rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                         mesh=mesh)
        eng = Engine(reduced(get_config(ARCH)),
                     params_from_numpy(jax_side["weights"][ARCH],
                                       device="cpu"),
                     slots=2, max_len=64, device="cpu", rules=rules)
        eng.submit(Request(rid=0, prompt=[5, 6, 7], max_new_tokens=6))
        (r,) = eng.run()
        assert r.out_tokens == jax_side["one"]
        assert (eng.shards, eng.shard) == (1, 0)
        assert eng.memory_stats()["rank"]["num_pages"] == 16
        # one rank takes its clock's decisions alone: allowed
        slo = Engine(reduced(get_config(ARCH)), eng.params, slots=2,
                     max_len=64, device="cpu", rules=rules, policy="slo")
        assert slo.submit(Request(rid=1, prompt=[5, 6, 7],
                                  max_new_tokens=6, ttl=1e9)) is None
        assert [r.out_tokens for r in slo.run()] == [jax_side["one"]]
        # slots on "data" with the pools left whole: refused, since a
        # rank's kernels read only its own pages
        with pytest.raises(ValueError, match="pool shards on"):
            Engine(reduced(get_config(ARCH)), eng.params, slots=2,
                   max_len=64, device="cpu",
                   rules=sh.Rules(table={sh.BATCH: "data"}, mesh=mesh))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,item", [("dbrx-132b", "A19"),
                                       ("zamba2-7b", "A20"),
                                       ("rwkv6-7b", "A20")])
def test_unported_archs_under_rules_raise(arch, item):
    """MoE archs (a rank's dispatch would drop other tokens than the
    reference's global dispatch) and recurrent archs raise, naming their
    ROADMAP item; a mesh-less ``Rules`` never runs unsharded."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import MeshDescriptor
    from repro_torch.models import model_defs
    from repro_torch.models.module import init_params
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.engine import Engine

    cfg = reduced(get_config(arch))
    params = init_params(model_defs(cfg), 0, device="cpu")
    rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"},
                     mesh=MeshDescriptor(("data",), (2,)))
    with pytest.raises(NotImplementedError, match=item):
        Engine(cfg, params, device="cpu", slots=2, max_len=64, rules=rules)


def test_rules_without_a_device_mesh_raise():
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_defs
    from repro_torch.models.module import init_params
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.engine import Engine

    cfg = reduced(get_config(ARCH))
    params = init_params(model_defs(cfg), 0, device="cpu")
    with pytest.raises(ValueError, match="DeviceMesh"):
        Engine(cfg, params, device="cpu", slots=2, max_len=64,
               rules=sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"}))
    with pytest.raises(TypeError, match="Rules"):
        Engine(cfg, params, device="cpu", slots=2, max_len=64,
               rules=object())


# ---------------------------------------------------------------------------
# the mirror of test_cachespec_data_axis_sharding_specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kv_dtype", [(ARCH, "fp32"), (ARCH, "int8"),
                                           ("gemma2-2b", "fp32")])
def test_cachespec_data_axis_sharding_specs(arch, kv_dtype):
    """``spec_for(TABLE_AXES)``, ``spec_for(POOL_AXES)`` and
    ``spec_for(SCALE_AXES)`` and ``structure()`` (shapes and logical
    axes) = the reference's field for field; ``shardings()`` of mesh-less
    rules is all ``None``."""
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jget, reduced as jreduced
    from repro.parallel import sharding as jsh
    from repro.serve.cache import CacheSpec as JSpec
    from repro_torch.configs import get_config, reduced
    from repro_torch.parallel import sharding as sh
    from repro_torch.serve.cache import CacheSpec

    spec = CacheSpec.from_config(reduced(get_config(arch)), slots=4,
                                 max_len=64, page_size=8, kv_dtype=kv_dtype)
    jspec = JSpec.from_config(jreduced(jget(arch)), slots=4, max_len=64,
                              page_size=8, kv_dtype=kv_dtype)
    rules = sh.Rules(table={sh.BATCH: "data", sh.PAGES: "data"})
    jrules = jsh.Rules(table={jsh.BATCH: "data", jsh.PAGES: "data"})
    for axes in ("TABLE_AXES", "POOL_AXES", "SCALE_AXES"):
        got = rules.spec_for(getattr(spec, axes))
        assert got == tuple(jrules.spec_for(getattr(jspec, axes)))
        assert got == tuple(P("data"))
    assert spec.structure() == jspec.structure()
    if arch == ARCH:
        key = spec.widest_group.key
        assert spec.structure()["page_tables"][key][0] == \
            (4, spec.max_blocks)
    else:
        pt = spec.structure()["page_tables"]
        assert pt["ring2"][0] == (4, 2) and pt["ring8"][0] == (4, 8)
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        else:
            leaves.append(node)

    walk(spec.shardings(rules))
    assert leaves and all(leaf is None for leaf in leaves)


def test_rank_spec_splits_slots_and_pages():
    from repro_torch.configs import get_config, reduced
    from repro_torch.serve.cache import CacheSpec

    spec = CacheSpec.from_config(reduced(get_config("gemma2-2b")), slots=4,
                                 max_len=64, page_size=8)
    half = spec.rank_spec(2)
    assert half.slots == 2
    assert [g.num_pages for g in half.groups] == \
        [g.num_pages // 2 for g in spec.groups]
    assert [half.pool_shape_for(g)[0] for g in half.groups] == \
        [g.num_pages // 2 + 1 for g in spec.groups]
    assert spec.rank_spec(1) is spec
    with pytest.raises(ValueError, match="do not divide"):
        spec.rank_spec(3)


def test_example_serve_sharded_on_two_ranks():
    """``examples/serve_sharded`` (what ``torchrun --nproc-per-node 2 -m
    repro_torch.examples.serve_sharded --device cpu`` runs), its
    rendezvous given as a ``file://`` store: both ranks serve every
    request and hold the same tokens."""
    with tempfile.TemporaryDirectory() as d:
        spawn(_example_rank, RANKS, (RANKS, os.path.join(d, "store"), d))
        done = []
        for r in range(RANKS):
            with open(os.path.join(d, f"example{r}.pkl"), "rb") as f:
                done.append(pickle.load(f))
    assert done[0] == done[1]
    assert sorted(done[0]) == list(range(12))
    assert all(len(t) == 16 for t in done[0].values())
