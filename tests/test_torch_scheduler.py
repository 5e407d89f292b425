"""PyTorch port: the paper's branch schedules (``core/scheduler``) against
the JAX reference (the mirror of tests/test_distribution.py's
``test_scheduler_sync_async_equivalence``).

``run_sync`` = JAX's ``run_sync`` on the same numpy inputs in one
process.  ``run_async`` (2 branches) and ``hybrid_pools`` (4 branches)
run on 4 spawned gloo ranks forming a ``("pool" 2, "x" 2)`` mesh, each
rank's result within 1e-5 of ``run_sync`` and of JAX's, the reference
test's tolerance; the ranks import torch and the port alone.  The mesh
helpers (``launch/mesh.device_mesh`` from a descriptor,
``Rules.coordinate`` and ``sharding_for`` on two axes) are checked on the
same ranks.
"""

import os
import pickle
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_multidevice_serve import spawn  # noqa: E402

TOL = 1e-5


def inputs():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 16, 16)).astype(np.float32)
    x = rng.standard_normal((8, 16)).astype(np.float32)
    return w, x


def branch(p, v):
    return torch.tanh(v @ p["w"])


def _rank_main(rank, world, store, out_dir):
    import torch.distributed as dist

    from repro_torch.core import scheduler
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.parallel import sharding as sh

    torch.set_num_threads(1)
    mesh_lib.join_process_group("gloo", rank=rank, world_size=world,
                                init_method=f"file://{store}")
    try:
        # built from a descriptor, as the tuner's meshes are
        mesh = mesh_lib.device_mesh(
            mesh_lib.MeshDescriptor(("pool", "x"), (2, 2)),
            device_type="cpu")
        w, x = inputs()
        w, x = torch.from_numpy(w), torch.from_numpy(x)
        rules = sh.Rules(table={"exp": "pool", "ff": "x"}, mesh=mesh)
        out = {
            "async": scheduler.run_async(branch, {"w": w[:2]}, x, mesh=mesh,
                                         pool_axis="pool").numpy(),
            "hybrid": scheduler.hybrid_pools(branch, {"w": w}, x, mesh=mesh,
                                             pool_axis="pool").numpy(),
            "describe": mesh_lib.describe(mesh),
            "coordinate": (rules.coordinate("pool"), rules.coordinate("x"),
                           rules.coordinate(("pool", "x"))),
            "placement": repr(rules.sharding_for(("exp", None, "ff"),
                                                 (4, 16, 16)))}
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_sync():
    import jax.numpy as jnp

    from repro.core import scheduler as jsched

    w, x = inputs()
    return {n: np.asarray(jsched.run_sync(
        lambda p, v: jnp.tanh(v @ p["w"]), {"w": jnp.asarray(w[:n])},
        jnp.asarray(x))) for n in (2, 4)}


@pytest.fixture(scope="module")
def ranks():
    with tempfile.TemporaryDirectory() as d:
        spawn(_rank_main, 4, (4, os.path.join(d, "store"), d))
        out = []
        for r in range(4):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out


def test_run_sync_matches_reference(jax_sync):
    from repro_torch.core import scheduler

    w, x = inputs()
    for n in (2, 4):
        got = scheduler.run_sync(branch, {"w": torch.from_numpy(w[:n])},
                                 torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), jax_sync[n], rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("schedule", ["async", "hybrid"])
def test_async_and_hybrid_match_sync(ranks, jax_sync, schedule):
    """Branch ``i`` on pool rank ``i`` (``run_async``, the first two
    branches) and two branches a pool (``hybrid_pools``, all four), summed
    by ``all_reduce`` over ``"pool"``; the ``"x"`` ranks of a pool hold
    the same result."""
    from repro_torch.core import scheduler

    w, x = inputs()
    n = 2 if schedule == "async" else 4
    want = scheduler.run_sync(branch, {"w": torch.from_numpy(w[:n])},
                              torch.from_numpy(x)).numpy()
    for out in ranks:
        np.testing.assert_allclose(out[schedule], want, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(out[schedule], jax_sync[n], rtol=TOL,
                                   atol=TOL)


def test_mesh_helpers_on_the_device_mesh(ranks):
    for r, out in enumerate(ranks):
        assert out["describe"] == "pool=2xx=2"
        assert out["coordinate"] == (r // 2, r % 2, r)
        assert out["placement"] == "(Shard(dim=0), Shard(dim=2))"


def test_schedules_keep_the_reference_asserts():
    """``run_async`` needs as many branches as pools and ``hybrid_pools``
    a multiple of them (the reference's asserts), checked before any
    collective: a one-rank mesh is enough."""
    import torch.distributed as dist

    from repro_torch.core import scheduler
    from repro_torch.launch import mesh as mesh_lib

    with tempfile.TemporaryDirectory() as d:
        mesh_lib.join_process_group("gloo", rank=0, world_size=1,
                                    init_method=f"file://{d}/store")
        try:
            mesh = mesh_lib.device_mesh((1,), ("pool",), device_type="cpu")
            w, x = inputs()
            w, x = torch.from_numpy(w), torch.from_numpy(x)
            with pytest.raises(AssertionError):
                scheduler.run_async(branch, {"w": w[:2]}, x, mesh=mesh)
            y = scheduler.hybrid_pools(branch, {"w": w[:3]}, x, mesh=mesh)
            np.testing.assert_allclose(
                y.numpy(), scheduler.run_sync(branch, {"w": w[:3]}, x).numpy(),
                rtol=TOL, atol=TOL)
            with pytest.raises(ValueError, match="no 'x' axis"):
                scheduler.run_async(branch, {"w": w[:1]}, x, mesh=mesh,
                                    pool_axis="x")
        finally:
            dist.destroy_process_group()
