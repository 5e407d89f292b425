"""PyTorch port: sharded training on SPMD ranks of a ``DeviceMesh``
(counterpart of tests/test_distribution.py).

The reference forces 8 host devices and runs ``forward_train`` under
``with mesh, sh.axis_rules(rules)``; GSPMD places the work.  The port
spawns 4 gloo ranks (``torch.multiprocessing``, a ``file://`` store, no
port opened, one thread each), each running every scenario below under
``with sh.axis_rules(make_rules(plan, device_mesh(...)))``: the bridged
JAX weights ``place``d to the rank's shards, ``forward_train`` and its
backward, the gradients completed (``adamw.complete_grad``) and
gathered whole, then two ``Trainer`` steps from the same weights with
their params gathered.  The test process holds them against the JAX
package's unsharded step (``jax.value_and_grad`` of ``forward_train``
on the same weights and batch) and the port's unsharded ``Trainer``.

Sizes: ``reduced()`` internlm2 and gemma2 (d 64, 4:2 heads, dh 16, vocab
256, 2 layers; gemma2's window 16 and ``sliding_window`` 16 in both
packages), B 4, S 64, fp32.

Tolerances: the loss at rtol 1e-5; every gradient leaf at
``tests/test_torch_train.py``'s rtol 1e-4, atol 2e-5 x max|g| of the
leaf (the sums run in another order across ranks).  After two steps the
params at rtol 1e-4 and atol ``4 lr`` of the one step that moves them:
the schedule's first step has lr 0, and Adam's second moves each
element by at most about ``2 lr`` whatever its gradient's size, so a
near-zero gradient whose sign the summation order flips moves an
element by up to twice that.  The losses and gradient norms of both
steps at rtol 1e-5.
"""

import dataclasses
import os
import pickle
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

RANKS = 4
B, S = 4, 64
SPAWN_TIMEOUT_S = 240
ARCH, GEMMA = "internlm2-1.8b", "gemma2-2b"
PEAK_LR = 3e-4

# (name, arch, Plan fields, mesh sizes, mesh axis names)
SCENARIOS = [
    ("tf_d2_m2", ARCH, dict(data=2, intra=2), (2, 2), ("data", "model")),
    ("fsdp_d2_m2", ARCH, dict(data=2, intra=2, fsdp=True), (2, 2),
     ("data", "model")),
    ("sp_d2_m2", ARCH, dict(data=2, intra=2, seq_shard=True), (2, 2),
     ("data", "model")),
    # 2 KV heads on a 4-wide model axis: KV_HEADS falls back
    ("kv_replicated_m4", ARCH, dict(data=1, intra=4), (1, 4),
     ("data", "model")),
    ("cp_gemma2_m4", GEMMA, dict(data=1, intra=4, cp=True), (1, 4),
     ("data", "model")),
    # the tied table vocab-sharded for both of its uses, the softcaps
    ("tf_gemma2_d2_m2", GEMMA, dict(data=2, intra=2), (2, 2),
     ("data", "model")),
    # tuple axes: heads and vocab over (pool, intra), KV heads over pool
    ("factored_p2_i2", ARCH, dict(data=1, pools=2, intra=2), (1, 2, 2),
     ("data", "pool", "intra")),
    # the pod axis rides with data in "dp" mode
    ("pod_dp", ARCH, dict(data=1, intra=2, pods=2, pod_mode="dp"),
     (2, 1, 2), ("pod", "data", "model")),
    # a sequence the 4 model ranks do not divide: context parallelism
    # falls back to whole sequences (the ranks are copies)
    ("cp_fallback_s66", GEMMA, dict(data=1, intra=4, cp=True), (1, 4),
     ("data", "model")),
]
SEQ = {"cp_fallback_s66": 66}     # S of a scenario, if not S
PLAIN = "tf_d2_m2"   # the dry-run comparisons' plan


def configs(pkg_get, pkg_reduced):
    """The two reduced configs of one package, gemma2's window 16."""
    g = pkg_reduced(pkg_get(GEMMA))
    return {ARCH: pkg_reduced(pkg_get(ARCH)),
            GEMMA: dataclasses.replace(g, sliding_window=16)}


def batches(cfg, s=S):
    """The steps' batches (``SyntheticLM`` at steps 0 and 1)."""
    from repro_torch.data.pipeline import SyntheticLM

    data = SyntheticLM(cfg, B, s, seed=3)
    return [data.batch_at(i) for i in range(2)]


def _np(t):
    return t.detach().cpu().numpy()


def _scenario(name, arch, plan_kw, sizes, names, weights, rank):
    """One scenario on this rank -> what rank 0 reports."""
    import torch.distributed as dist

    from repro_torch.analysis.count import StepCounter
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import tuner
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import forward_train, model_defs
    from repro_torch.models.module import params_from_numpy, tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = configs(get_config, reduced)[arch]
    defs = model_defs(cfg)
    plan = tuner.Plan(name=name, **{"pools": 1, "seq_shard": False,
                                    **plan_kw})
    mesh = mesh_lib.device_mesh(sizes, names, device_type="cpu")
    rules = tuner.make_rules(plan, mesh)
    s = SEQ.get(name, S)
    steps = batches(cfg, s)
    batch = to_device(steps[0], torch.device("cpu"))
    out = {"name": name}
    with sh.axis_rules(rules):
        bridged = params_from_numpy(weights[arch], device="cpu",
                                    trainable=True)
        params = sh.place(bridged, defs, rules)
        out["shares_storage"] = any(
            a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
            for a, b in zip(tree_leaves(params), tree_leaves(bridged)))
        loss, _ = forward_train(params, cfg, batch)
        loss.backward()
        leaves = tree_leaves(params)
        grads = [sh.gather_tensor(adamw.complete_grad(p, p.grad),
                                  sh.placement(p)) for p in leaves]
        out["loss"] = float(loss.detach())
        out["grads"] = [_np(g) for g in grads]
        out["param_shapes"] = [tuple(p.shape) for p in leaves]
        tr = Trainer(cfg, TrainerConfig(steps=2, batch=B, seq_len=s,
                                        peak_lr=PEAK_LR),
                     device="cpu", params=params_from_numpy(
                         weights[arch], device="cpu", trainable=True))
        out["moment_shapes"] = [tuple(x.shape)
                                for x in tree_leaves(tr.state["opt"]["m"])]
        if name == PLAIN:
            with StepCounter() as counter:
                tr.train_step(batch)
            out["counted"] = counter.families()
        else:
            tr.train_step(batch)
        met = tr.train_step(to_device(steps[1], torch.device("cpu")))
        out["step1"] = {k: float(v) for k, v in met.items()}
        out["params"] = [_np(p) for p in tree_leaves(
            sh.gather(tr.state["params"]))]
    del mesh
    dist.barrier()
    return out


def _sp_boundary_case(rank):
    """The mirror of test_sp_boundary_grad_correctness: x [2,8,16] split
    over (data 2, model 2) by rows and sequence; after ``sp_boundary``
    each model rank takes its half of the features (the tensor-parallel
    part downstream), so the ranks' losses sum to the plain one."""
    from repro_torch.core import tuner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh

    mesh = mesh_lib.device_mesh((2, 2), ("data", "model"), device_type="cpu")
    plan = tuner.Plan(name="t", data=2, pools=1, intra=2, seq_shard=True)
    rules = tuner.make_rules(plan, mesh)
    x = torch.as_tensor(np.random.RandomState(0).randn(2, 8, 16)
                        .astype(np.float32))
    with sh.axis_rules(rules):
        x_loc = sh.shard(x, sh.BATCH, sh.SEQ, None).requires_grad_()
        y = sh.sp_boundary(x_loc)
        c = rules.coordinate("model") * 8
        torch.sum(torch.sin(y[..., c:c + 8]) ** 2).backward()
        pl = sh.Placement(rules.spec_for((sh.BATCH, sh.SEQ, None), x.shape),
                          tuple(x.shape), (sh.BATCH, sh.SEQ, None), rules)
        g = sh.gather_tensor(x_loc.grad, pl)
    return {"x": _np(x), "grad": _np(g), "gathered_shape": tuple(y.shape)}


def _checkpoint_case(rank, ckpt_dir):
    """The mirror of test_checkpoint_elastic_restore_across_meshes: w
    [8,8] row-sharded over a ("model",) mesh of 4, saved, restored onto
    (data 2, model 2) as P("data", "model")."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh
    from repro_torch.train import checkpoint as ck

    w = torch.arange(64.0).reshape(8, 8)
    mesh1 = mesh_lib.device_mesh((4,), ("model",), device_type="cpu")
    r1 = sh.Rules(table={}, mesh=mesh1)
    w1 = sh.tag(sh.local_part(w, ("model",), r1), ("r", "c"), (8, 8), r1,
                ("model",))
    ck.save(ckpt_dir, {"w": w1}, 1)
    mesh2 = mesh_lib.device_mesh((2, 2), ("data", "model"),
                                 device_type="cpu")
    r2 = sh.Rules(table={}, mesh=mesh2)
    target = sh.tag(torch.zeros(4, 4), ("r", "c"), (8, 8), r2,
                    ("data", "model"))
    restored, step = ck.restore(ckpt_dir, {"w": target})
    got = restored["w"]
    return {"step": step, "local": _np(got),
            "want": _np(sh.local_part(w, ("data", "model"), r2)),
            "spec": sh.placement(got).spec, "whole": _np(
                sh.gather_tensor(got))}


def _refusals(weights):
    """A MoE and a recurrent arch under a plan raise, naming their
    ROADMAP items."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import tuner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import forward_train
    from repro_torch.models.module import init_params
    from repro_torch.models import model_defs
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.trainer import Trainer, TrainerConfig

    mesh = mesh_lib.device_mesh((2, 2), ("data", "model"), device_type="cpu")
    rules = tuner.make_rules(tuner.Plan(name="t", data=2, pools=1,
                                        intra=2), mesh)
    out = {}
    for arch in ("dbrx-132b", "rwkv6-7b", "zamba2-7b", "whisper-medium"):
        cfg = reduced(get_config(arch))
        msgs = []
        with sh.axis_rules(rules):
            try:
                Trainer(cfg, TrainerConfig(steps=1, batch=B, seq_len=8),
                        device="cpu")
            except NotImplementedError as e:
                msgs.append(str(e))
            params = init_params(model_defs(cfg), 0, device="cpu")
            tokens = torch.zeros(B, 8, dtype=torch.int32)
            try:
                forward_train(params, cfg, {"tokens": tokens,
                                            "labels": tokens})
            except NotImplementedError as e:
                msgs.append(str(e))
        out[arch] = msgs
    return out


def _tuple_group():
    """The process group of the (data 2, model 2) mesh's two axes
    together, on a mesh made now."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh

    mesh = mesh_lib.device_mesh((2, 2), ("data", "model"), device_type="cpu")
    return sh.Rules(table={}, mesh=mesh).group(("data", "model"))


def _rank_main(rank, world, store, out_dir, weights):
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib

    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    mesh_lib.join_process_group("gloo", rank=rank, world_size=world,
                                init_method=f"file://{store}")
    try:
        out = {"scenarios": {}}
        for sc in SCENARIOS:
            t0 = time.perf_counter()
            out["scenarios"][sc[0]] = _scenario(*sc, weights, rank)
            out["scenarios"][sc[0]]["seconds"] = time.perf_counter() - t0
        out["sp_boundary"] = _sp_boundary_case(rank)
        out["checkpoint"] = _checkpoint_case(rank, os.path.join(out_dir,
                                                                "ckpt"))
        out["refusals"] = _refusals(weights)
        old = _tuple_group()
    finally:
        dist.destroy_process_group()
    # a mesh made after the process group was destroyed and joined again
    # gets groups of the new world, not the destroyed world's
    mesh_lib.join_process_group("gloo", rank=rank, world_size=world,
                                init_method=f"file://{store}_rejoin")
    try:
        new = _tuple_group()
        ones = torch.ones(1)
        dist.all_reduce(ones, group=new)
        out["rejoin"] = {"fresh": new is not old, "sum": float(ones)}
    finally:
        dist.destroy_process_group()
    from repro_torch.examples import train_sharded

    hist = train_sharded.main([
        "--device", "cpu", "--model", "2", "--setting", "tf",
        "--seq-shard", "--steps", "2", "--init-method",
        f"file://{store}_example", "--rank", str(rank), "--world-size",
        str(world)])
    out["example"] = [(row["loss"], row["grad_norm"]) for row in hist]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


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
# fixtures: the JAX side, the ranks' runs, the port's unsharded steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    """Both reduced archs at ``PRNGKey(0)`` as numpy trees, and the JAX
    package's unsharded loss and gradients on the first batch."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget, reduced as jreduced
    from repro.models import forward_train as jforward_train
    from repro.models import model_defs
    from repro.models import module as jm
    from repro_torch.configs import get_config, reduced

    jcfgs = configs(jget, jreduced)
    cfgs = configs(get_config, reduced)
    out = {"weights": {}, "loss": {}, "grads": {}}
    for arch, jcfg in jcfgs.items():
        jp = jm.init_params(model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        out["weights"][arch] = jax.tree.map(np.asarray, jp)
    for name, arch, *_ in SCENARIOS:
        key = (arch, SEQ.get(name, S))
        if key in out["loss"]:
            continue
        jp = jax.tree.map(jnp.asarray, out["weights"][arch])
        batch = {k: jnp.asarray(v)
                 for k, v in batches(cfgs[arch], key[1])[0].items()}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b, c=jcfgs[arch]: jforward_train(p, c, b),
            has_aux=True))(jp, batch)
        out["loss"][key] = float(loss)
        out["grads"][key] = [np.asarray(g) for g in jax.tree.leaves(grads)]
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Every scenario on 4 gloo ranks: each rank's observations."""
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        spawn(_rank_main, RANKS,
              (RANKS, os.path.join(d, "store"), d, jax_side["weights"]))
        out = []
        for r in range(RANKS):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        out[0]["spawn_seconds"] = time.perf_counter() - t0
    return out


@pytest.fixture(scope="module")
def unsharded(jax_side):
    """The port's unsharded ``Trainer`` on the same weights and batches:
    per arch the metrics of the second step and the params after it."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import to_device
    from repro_torch.models.module import params_from_numpy, tree_leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfgs = configs(get_config, reduced)
    out = {}
    for name, arch, *_ in SCENARIOS:
        key = (arch, SEQ.get(name, S))
        if key in out:
            continue
        tr = Trainer(cfgs[arch], TrainerConfig(
            steps=2, batch=B, seq_len=key[1], peak_lr=PEAK_LR),
            device="cpu", params=params_from_numpy(
                jax_side["weights"][arch], device="cpu", trainable=True))
        for step in batches(cfgs[arch], key[1]):
            met = tr.train_step(to_device(step, torch.device("cpu")))
        out[key] = {"step1": {k: float(v) for k, v in met.items()},
                    "params": [_np(p)
                               for p in tree_leaves(tr.state["params"])],
                    "lr": float(met["lr"])}
    return out


# ---------------------------------------------------------------------------
# the mirror of test_sharded_train_step_matches_single_device
# ---------------------------------------------------------------------------

def _key(scenario):
    """(arch, S) of a scenario: the unsharded runs it is held to."""
    arch = dict((sc[0], sc[1]) for sc in SCENARIOS)[scenario]
    return arch, SEQ.get(scenario, S)


@pytest.mark.parametrize("scenario", [sc[0] for sc in SCENARIOS])
def test_sharded_loss_and_grads_match_unsharded_jax(ranks, jax_side,
                                                    scenario):
    """One rank's loss and every gathered gradient leaf = the JAX
    package's unsharded step on the same weights and batch."""
    key = _key(scenario)
    for r, out in enumerate(ranks):
        run = out["scenarios"][scenario]
        np.testing.assert_allclose(run["loss"], jax_side["loss"][key],
                                   rtol=1e-5, err_msg=f"rank {r}")
    run = ranks[0]["scenarios"][scenario]
    want_all = jax_side["grads"][key]
    assert len(run["grads"]) == len(want_all)
    for i, (got, want) in enumerate(zip(run["grads"], want_all)):
        assert got.shape == want.shape, i
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=2e-5 * float(np.abs(want).max()),
            err_msg=f"{scenario} leaf {i}")


@pytest.mark.parametrize("scenario", [sc[0] for sc in SCENARIOS])
def test_two_sharded_steps_match_unsharded_trainer(ranks, unsharded,
                                                   scenario):
    """Two ``Trainer`` steps under the plan (ZeRO-1 moments, the global
    grad norm) = the port's unsharded trainer: metrics and params."""
    want = unsharded[_key(scenario)]
    for r, out in enumerate(ranks):
        got = out["scenarios"][scenario]["step1"]
        assert set(got) == set(want["step1"])
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(got[key], want["step1"][key],
                                       rtol=1e-5, err_msg=f"{r} {key}")
    run = ranks[0]["scenarios"][scenario]
    for i, (got, w) in enumerate(zip(run["params"], want["params"])):
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=4 * want["lr"],
                                   err_msg=f"{scenario} leaf {i}")


def test_place_copies_every_leaf(ranks):
    """``place`` never hands back a view of the full tree: the step
    updates the shards in place."""
    for out in ranks:
        for name, run in out["scenarios"].items():
            assert not run["shares_storage"], name


def test_zero1_moments_sharded_over_data(ranks):
    """The moments of (data 2, model 2) without FSDP are half the param
    shard along d_model: ZeRO-1 over the data axis."""
    run = ranks[0]["scenarios"][PLAIN]
    halved = [m != p for p, m in zip(run["param_shapes"],
                                     run["moment_shapes"])]
    assert any(halved)
    for p, m in zip(run["param_shapes"], run["moment_shapes"]):
        assert np.prod(m) * (2 if m != p else 1) == np.prod(p)


# ---------------------------------------------------------------------------
# the dry-run of launch/build against the real step
# ---------------------------------------------------------------------------

def _built(scenario):
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tuner
    from repro_torch.launch import build
    from repro_torch.launch.mesh import MeshDescriptor

    name, arch, plan_kw, sizes, names = dict(
        (sc[0], sc) for sc in SCENARIOS)[scenario]
    cfg = configs(get_config, reduced)[arch]
    plan = tuner.Plan(name=name, **{"pools": 1, "seq_shard": False,
                                    **plan_kw})
    mesh = MeshDescriptor(names, sizes)
    return cfg, build.build(cfg, ShapeConfig("t", "train", S, B), plan=plan,
                            mesh=mesh, param_dtype=torch.float32)


@pytest.mark.parametrize("scenario", ["tf_d2_m2", "fsdp_d2_m2",
                                      "kv_replicated_m4"])
def test_rank_shards_equal_dry_run_storage(ranks, scenario):
    """Each real rank's parameter and moment shard shapes are the
    dry-run's per-device storage shapes (``build.storage_shapes``, the
    shapes behind ``Built.argument_bytes``)."""
    from repro_torch.launch import build

    cfg, built = _built(scenario)
    params, moments = build.storage_shapes(cfg, built.rules)
    for out in ranks:
        run = out["scenarios"][scenario]
        assert run["param_shapes"] == params
        assert run["moment_shapes"] == moments


def test_rank_step_counts_dry_run_products(ranks):
    """For the plain (data 2, model 2) plan, ``StepCounter`` around one
    rank's real step counts the matrix-product FLOPs of ``Built.count()``'s
    meta step, collectives aside, exactly: the CPU's plain flash forward
    (``flash_attention_ref``'s two products over every score, 4 B H S S
    dh a layer) is the one difference, where the meta step records the
    kernel's own work instead."""
    cfg, built = _built(PLAIN)
    counter, _ = built.count()
    meta = counter.families()
    real = ranks[0]["scenarios"][PLAIN]["counted"]
    v = built.view
    plain_fwd = 4 * (B // 2) * v["heads"] * S * S \
        * cfg.resolved_head_dim * cfg.num_layers
    assert real["matmul"]["flops"] - plain_fwd == meta["matmul"]["flops"]
    assert real["flash_attention_bwd"]["flops"] \
        == meta["flash_attention_bwd"]["flops"]
    assert meta["flash_attention"]["flops"] > 0


# ---------------------------------------------------------------------------
# the other reference cases
# ---------------------------------------------------------------------------

def test_sp_boundary_grad_correctness(ranks):
    for out in ranks:
        case = out["sp_boundary"]
        x = case["x"]
        assert case["gathered_shape"] == (1, 8, 16)
        np.testing.assert_allclose(case["grad"], 2 * np.sin(x) * np.cos(x),
                                   rtol=1e-5, atol=1e-6)


def test_checkpoint_elastic_restore_across_meshes(ranks):
    for out in ranks:
        case = out["checkpoint"]
        assert case["step"] == 1
        assert case["spec"] == ("data", "model")
        np.testing.assert_array_equal(case["local"], case["want"])
        np.testing.assert_array_equal(case["whole"],
                                      np.arange(64.0).reshape(8, 8))


def test_moe_recurrent_and_encoder_archs_refused_under_a_plan(ranks):
    items = {"dbrx-132b": "A19", "rwkv6-7b": "A20", "zamba2-7b": "A20",
             "whisper-medium": "A23"}
    for out in ranks:
        for arch, item in items.items():
            msgs = out["refusals"][arch]
            assert len(msgs) == 2 and all(item in m for m in msgs), msgs


def test_train_sharded_example(ranks):
    """``examples/train_sharded`` (4 gloo ranks, tf plan on (data 2,
    model 2) with Megatron-SP): each step's global loss and grad norm =
    the unsharded ``Trainer``'s on the same seed and data.  It joins
    after the scenarios' process group was destroyed; the groups of a
    tuple of axes on a mesh made then are the new world's."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.train.trainer import Trainer, TrainerConfig

    for out in ranks:
        assert out["rejoin"] == {"fresh": True, "sum": 4.0}

    tr = Trainer(reduced(get_config(ARCH)), TrainerConfig(
        steps=2, batch=4, seq_len=64, log_every=1), device="cpu")
    want = [(row["loss"], row["grad_norm"])
            for row in tr.run()["history"]]
    for out in ranks:
        np.testing.assert_allclose(out["example"], want, rtol=1e-5)


@pytest.mark.parametrize("case", ["production", "multi_pod", "tuned"])
def test_make_production_mesh_shapes(case):
    """``make_production_mesh`` / ``make_tuned_mesh`` as ``DeviceMesh``es
    of 256, 512 and 8 ranks on the ``fake`` process group (one process,
    no collectives)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.core import tuner
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh

    world, desc, want = {
        "production": (256, mesh_lib.make_production_mesh(),
                       {"data": 16, "model": 16}),
        "multi_pod": (512, mesh_lib.make_production_mesh(multi_pod=True),
                      {"pod": 2, "data": 16, "model": 16}),
        "tuned": (8, mesh_lib.make_tuned_mesh(2, model_axis=4, data_axis=2),
                  {"data": 2, "pool": 2, "intra": 2}),
    }[case]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        mesh = mesh_lib.device_mesh(desc, device_type="cpu")
        assert sh.is_device_mesh(mesh)
        assert sh.axis_sizes(mesh) == want
        plan = tuner.Plan(name="t", data=want["data"], pools=want.get(
            "pool", 1), intra=want.get("intra", want.get("model")),
            pods=want.get("pod", 1))
        rules = tuner.make_rules(plan, mesh)
        # the pod axis rides with data in "dp" mode
        assert rules.table[sh.BATCH] == (("pod", "data") if "pod" in want
                                         else "data")
        assert rules.coordinate(rules.table[sh.BATCH]) == 0
    finally:
        dist.destroy_process_group()
