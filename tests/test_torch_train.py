"""PyTorch port: ``forward_train`` against the JAX reference on the same
weights and batch, for every arch at ``reduced()`` (fp32, TF32 off).

The batch is the reference's ``SyntheticLM.batch_at(0)`` (B 2, S 16:
pixtral's 8-position frontend stub and the loss mask over it, whisper's
8 frames).  The JAX side is ``jax.value_and_grad`` of
``repro.models.forward_train`` under ``jit`` (its dense attention and
einsum MoE); the port runs its ops' plain versions on the CPU and the
explicit-product backwards of ``flash_attention`` and ``moe_gmm``.

Tolerances: the loss at rtol 1e-5; every gradient leaf allclose at rtol
1e-4 with atol 2e-5 x max|g| of the leaf.  rwkv6's fp32 gradients are
ill-conditioned at these weights: both packages land 2e-4 (the port)
and 4e-4 (JAX) x max|g| from a float64 run of the port, so its leaves
are held at atol 1e-3 x max|g|.  A leaf the forward never reads
(zamba2's shared-attention layer's ``ln1``) has no ``.grad`` in torch
and a zero gradient in JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import jax.tree_util as jtu  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.models import forward_train as jax_forward_train  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import forward_train  # noqa: E402
from repro_torch.models.module import (params_from_numpy,  # noqa: E402
                                       tree_leaves)

GRAD_ATOL = {"rwkv6-7b": 1e-3}      # x max|g| of the leaf
DEFAULT_ATOL = 2e-5


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train_loss_and_grads_vs_jax(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    batch = JSyntheticLM(jcfg, 2, 16, seed=1).batch_at(0)

    def loss_fn(p, b):
        return jax_forward_train(p, jcfg, b)

    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()})

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu",
                           trainable=True)
    loss, met = forward_train(tp, cfg, {k: torch.as_tensor(v)
                                        for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert set(met) == set(jmet)
    for key in jmet:
        np.testing.assert_allclose(float(met[key].detach()),
                                   float(jmet[key]), rtol=1e-5, atol=1e-7,
                                   err_msg=key)

    paths = [jtu.keystr(p) for p, _ in
             jtu.tree_flatten_with_path(jgrads)[0]]
    leaves = tree_leaves(tp)
    assert len(leaves) == len(paths)
    atol = GRAD_ATOL.get(arch, DEFAULT_ATOL)
    for path, want, p in zip(paths, jax.tree.leaves(jgrads), leaves):
        want = np.asarray(want)
        got = (np.zeros_like(want) if p.grad is None
               else p.grad.numpy())
        assert got.shape == want.shape, path
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=atol * float(np.abs(want).max()),
            err_msg=f"{arch} {path}")
