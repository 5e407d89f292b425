"""PyTorch port: AdamW, the int8 second moment and the schedules, the
mirror of ``tests/test_optim.py``'s five cases, each held against the
JAX ``repro.optim`` outputs on the same inputs (fp32, on the CPU).

* One step from zero state: the manual step, and the reference's
  params, moments and count (rtol 1e-6).
* Clipping: ``grad_norm`` 400 exactly, as the reference's.
* ``quantize``/``dequantize``: the block-wise int8 bound (error <=
  scale / 127) at lengths and scales across the reference test's
  hypothesis ranges, payload and scales bitwise the reference's.
* Three steps with a quantized ``v`` from the reference's own gradients:
  params, ``m``, ``v``'s payload and scales as the reference's, the
  state carried over through ``state_from_numpy``.
* ``linear_warmup_cosine``'s shape, and its values = the reference's
  over warmup and decay (rtol 1e-6); ``constant``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402


def _jax_params():
    k = jax.random.PRNGKey(0)
    return {"w": jax.random.normal(k, (8, 256)),
            "b": jnp.zeros((256,)),
            "e": jax.random.normal(jax.random.fold_in(k, 1), (32, 128))}


def _to_torch(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _assert_tree(got, want, rtol=1e-6, atol=0.0):
    g = tree_leaves(got)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_adamw_matches_manual_step():
    kw = dict(lr=1e-2, b1=0.9, b2=0.99, weight_decay=0.0, grad_clip=1e9)
    cfg, jcfg = adamw.AdamWConfig(**kw), jadamw.AdamWConfig(**kw)
    jp = _jax_params()
    jgrads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.1, jp)
    jnew, jstate, _ = jadamw.update(jgrads, jadamw.init(jp, jcfg), jp, jcfg)
    params = _to_torch(jp)
    state = adamw.init(params, cfg)
    p0 = {k: v.clone() for k, v in params.items()}
    new_p, new_s, _ = adamw.update(_to_torch(jgrads), state, params, cfg)
    assert new_p is params and new_s is state          # in place
    for k in params:
        step = p0[k].numpy() - 1e-2 * (0.1 / (0.1 + cfg.eps))
        np.testing.assert_allclose(params[k].numpy(), step, rtol=1e-4)
    _assert_tree(params, jnew)
    _assert_tree(state["m"], jstate["m"])
    _assert_tree(state["v"], jstate["v"])
    assert int(state["count"]) == int(jstate["count"]) == 1


def test_grad_clipping():
    cfg = adamw.AdamWConfig(grad_clip=1.0)
    params = {"w": torch.zeros(4, 4)}
    state = adamw.init(params, cfg)
    _, _, metrics = adamw.update({"w": torch.full((4, 4), 100.0)}, state,
                                 params, cfg)
    jcfg = jadamw.AdamWConfig(grad_clip=1.0)
    jp = {"w": jnp.zeros((4, 4))}
    _, _, jm = jadamw.update({"w": jnp.full((4, 4), 100.0)},
                             jadamw.init(jp, jcfg), jp, jcfg)
    assert float(metrics["grad_norm"]) == float(jm["grad_norm"]) == 400.0
    # the clipped step moved every entry by lr (Adam's first step)
    np.testing.assert_allclose(params["w"].numpy(), -cfg.lr, rtol=1e-5)


@pytest.mark.parametrize("n,scale", [(130, 0.01), (255, 1.0), (256, 3.5),
                                     (1000, 100.0), (4096, 0.37),
                                     (2049, 42.0)])
def test_quantize_roundtrip_error_bound(n, scale):
    x = np.linspace(-scale, scale, n).astype(np.float32).reshape(1, n)
    qt = adamw.quantize(torch.tensor(x))
    back = adamw.dequantize(qt, n)
    assert back.shape == (1, n)
    err = np.abs(back.numpy() - x).max()
    assert err <= scale / 127 + 1e-6
    jqt = jadamw.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jqt.q))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jqt.scale))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jadamw.dequantize(jqt, n)))


def test_quantized_state_training_steps():
    jcfg = jadamw.AdamWConfig(lr=1e-2, quantize_v=True)
    cfg = adamw.AdamWConfig(lr=1e-2, quantize_v=True)
    jp = _jax_params()
    jstate = jadamw.init(jp, jcfg)
    assert isinstance(jstate["v"]["w"], jadamw.QTensor)
    params = _to_torch(jp)
    state = adamw.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    assert isinstance(state["v"]["w"], adamw.QTensor)
    assert isinstance(adamw.init(params, cfg)["v"]["w"], adamw.QTensor)
    for i in range(3):
        jgrads = jax.tree.map(
            lambda x: 0.01 * jax.random.normal(jax.random.PRNGKey(i),
                                               x.shape), jp)
        jp, jstate, jm = jadamw.update(jgrads, jstate, jp, jcfg)
        _, _, m = adamw.update(_to_torch(jgrads), state, params, cfg)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    _assert_tree(params, jp, rtol=1e-5, atol=1e-7)
    _assert_tree(state["m"], jstate["m"], rtol=1e-5, atol=1e-9)
    for key in ("w", "b", "e"):
        qt, jqt = state["v"][key], jstate["v"][key]
        # one int8 code may round the other way where v sits on a half
        assert np.abs(qt.q.numpy().astype(int)
                      - np.asarray(jqt.q).astype(int)).max() <= 1
        np.testing.assert_allclose(qt.scale.numpy(), np.asarray(jqt.scale),
                                   rtol=1e-5)
    assert int(state["count"]) == 3


def test_schedule_shape():
    lr0 = float(schedule.linear_warmup_cosine(0, peak_lr=1.0, warmup=10,
                                              total=100))
    lr10 = float(schedule.linear_warmup_cosine(10, peak_lr=1.0, warmup=10,
                                               total=100))
    lr100 = float(schedule.linear_warmup_cosine(100, peak_lr=1.0, warmup=10,
                                                total=100, floor=0.1))
    assert lr0 == 0.0 and abs(lr10 - 1.0) < 1e-6 and abs(lr100 - 0.1) < 1e-6
    for step in range(0, 130, 7):
        kw = dict(peak_lr=3e-4, warmup=10, total=100)
        got = schedule.linear_warmup_cosine(torch.tensor(step), **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(
            float(got), float(jschedule.linear_warmup_cosine(step, **kw)),
            rtol=1e-6)
    assert float(schedule.constant(5, peak_lr=0.5)) == float(
        jschedule.constant(5, peak_lr=0.5))
