"""PyTorch port: the backwards of the differentiable kernels' ops, the
training loop and its launcher, against the JAX reference (fp32, TF32
off, on the CPU).

* ``flash_attention_bwd`` (explicit products) against ``jax.vjp`` of
  ``repro.kernels.flash_attention.ref.flash_attention_ref``: causal, a
  window, a softcap, GQA G = 2 and 12, non-causal Sq != Skv, a window
  with a softcap, bf16, and slabs of (batch, kv head) pairs; dq, dk, dv
  within 1e-5 x max|want| (bf16: 2e-2).  ``flash_attention``'s autograd
  goes through it.
* ``moe_gmm_bwd`` against ``jax.vjp`` of ``repro.kernels.moe_gmm.ref``'s
  oracle, with partial row counts, ungrouped and grouped: dx (exactly 0
  on dead rows) and dw within 1e-5 x max|want|.
* ``grad_fence`` keeps a bf16 cotangent bf16, as the reference's.
* ``remat=True`` gives the same loss and gradients.
* ``Trainer``: 3 steps from the JAX ``Trainer``'s own initial weights
  give its losses (rtol 1e-5), grad norms (rtol 1e-4) and final params
  (rtol 1e-4, atol 1e-6 + 1e-6 x max|p|), for internlm2 and dbrx (MoE:
  the aux loss, the load-balance term).
* ``launch.train``: ``--smoke --steps 2 --device cpu`` prints the
  reference's lines; ``--resume`` picks up the checkpoint; ``--production``
  is refused.
* ``refuse_autograd``'s rule, which only ``paged_attention`` (it never
  trains) still uses.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.kernels.moe_gmm.ref import moe_gmm_ref as jax_gmm_ref  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import refuse_autograd  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import forward_train, model_defs  # noqa: E402
from repro_torch.models.layers import grad_fence, logits  # noqa: E402
from repro_torch.models.module import (init_params,  # noqa: E402
                                       params_from_numpy, tree_leaves)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True)
def _fp32():
    torch.set_float32_matmul_precision("highest")


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# flash_attention's backward
# ---------------------------------------------------------------------------

FLASH_BWD_CASES = [
    ("causal", dict(B=2, H=4, Hkv=4, Sq=33, Skv=33, dh=16), {}),
    ("window", dict(B=1, H=4, Hkv=4, Sq=40, Skv=40, dh=16), dict(window=8)),
    ("softcap", dict(B=1, H=2, Hkv=2, Sq=24, Skv=24, dh=32),
     dict(softcap=2.0)),
    ("gqa2", dict(B=2, H=4, Hkv=2, Sq=19, Skv=19, dh=16), {}),
    ("gqa12", dict(B=1, H=24, Hkv=2, Sq=17, Skv=17, dh=16), {}),
    ("noncausal", dict(B=2, H=4, Hkv=2, Sq=7, Skv=19, dh=16),
     dict(causal=False)),
    ("window_softcap", dict(B=1, H=4, Hkv=2, Sq=37, Skv=37, dh=32),
     dict(window=12, softcap=2.0)),
]


def _flash_inputs(shape, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    B, H, Hkv, Sq, Skv, dh = (shape[k] for k in
                              ("B", "H", "Hkv", "Sq", "Skv", "dh"))
    q = rs.randn(B, H, Sq, dh).astype(np.float32) * scale
    k = rs.randn(B, Hkv, Skv, dh).astype(np.float32) * scale
    v = rs.randn(B, Hkv, Skv, dh).astype(np.float32)
    do = rs.randn(B, H, Sq, dh).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("name,shape,opts", FLASH_BWD_CASES,
                         ids=[c[0] for c in FLASH_BWD_CASES])
def test_flash_bwd_vs_jax_vjp(name, shape, opts):
    # larger scores so that the softcap bends them
    q, k, v, do = _flash_inputs(shape, 11, 3.0 if "softcap" in name
                                else 1.0)
    jout, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_ref(q_, k_, v_, **opts),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **opts)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=1e-5)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    direct = fa.flash_attention_bwd(torch.tensor(q), torch.tensor(k),
                                    torch.tensor(v), out.detach(),
                                    torch.tensor(do), **opts)
    for nm, g, d, w in zip(("dq", "dk", "dv"), got, direct, want):
        assert g.shape == tuple(w.shape) and g.dtype == torch.float32
        assert torch.equal(g, d), nm
        assert _rel(g.numpy(), w) <= 1e-5, (name, nm, _rel(g.numpy(), w))


def test_flash_bwd_slabs_match_one_pass(monkeypatch):
    """A score budget of one (batch, kv head) pair per slab gives the
    one-pass result."""
    shape = dict(B=2, H=6, Hkv=3, Sq=21, Skv=21, dh=16)
    q, k, v, do = (torch.tensor(x) for x in _flash_inputs(shape, 5))
    out = fa.flash_attention_ref(q, k, v, window=9)
    one = fa.flash_attention_bwd(q, k, v, out, do, window=9)
    monkeypatch.setattr(fa, "BWD_SCORE_ELEMS", 2 * 21 * 21)
    sl = fa.flash_attention_bwd(q, k, v, out, do, window=9)
    for a, b in zip(one, sl):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_flash_bwd_bf16_vs_jax_vjp():
    shape = dict(B=1, H=4, Hkv=2, Sq=29, Skv=29, dh=32)
    q, k, v, do = _flash_inputs(shape, 3)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda q_, k_, v_: jax_flash_ref(q_, k_, v_),
                     jnp.asarray(q, bf), jnp.asarray(k, bf),
                     jnp.asarray(v, bf))
    want = vjp(jnp.asarray(do, bf))
    tq, tk, tv = (torch.tensor(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv)
    got = torch.autograd.grad(out, (tq, tk, tv),
                              torch.tensor(do).bfloat16())
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), np.asarray(w, np.float32)) <= 2e-2


# ---------------------------------------------------------------------------
# moe_gmm's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grouped", [False, True])
def test_moe_gmm_bwd_vs_jax_vjp(grouped):
    rs = np.random.RandomState(7)
    G, E, C, D, F = 2, 4, 9, 12, 10
    x = rs.randn(G, E, C, D).astype(np.float32)
    w = (rs.randn(E, D, F) / np.sqrt(D)).astype(np.float32)
    dy = rs.randn(G, E, C, F).astype(np.float32)
    counts = np.array([[9, 4, 0, 1], [3, 9, 7, 0]], np.int32)
    dx_want, dw_want = [], np.zeros_like(w)
    for g in range(G):
        _, vjp = jax.vjp(lambda x_, w_: jax_gmm_ref(
            x_, w_, jnp.asarray(counts[g])), jnp.asarray(x[g]),
            jnp.asarray(w))
        dxg, dwg = vjp(jnp.asarray(dy[g]))
        dx_want.append(np.asarray(dxg))
        dw_want += np.asarray(dwg)
    dx_want = np.stack(dx_want)
    if not grouped:           # the ungrouped [E,C,D] form: group 0 alone
        x, dy, counts = x[0], dy[0], counts[0]
        _, vjp = jax.vjp(lambda x_, w_: jax_gmm_ref(
            x_, w_, jnp.asarray(counts)), jnp.asarray(x), jnp.asarray(w))
        dx_want, dw_want = (np.asarray(t) for t in vjp(jnp.asarray(dy)))
    tx = torch.tensor(x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    out = gmm.moe_gmm(tx, tw, torch.tensor(counts))
    dx, dw = torch.autograd.grad(out, (tx, tw), torch.tensor(dy))
    assert _rel(dx.numpy(), dx_want) <= 1e-5
    assert _rel(dw.numpy(), dw_want) <= 1e-5
    dead = (np.arange(C)[None, :] >= counts[..., None])
    assert not dx.numpy()[dead].any()        # dead rows: exactly 0


# ---------------------------------------------------------------------------
# grad_fence, remat
# ---------------------------------------------------------------------------

def test_grad_fence_keeps_bf16_cotangent():
    x = torch.randn(3, 5).bfloat16().requires_grad_()
    w = torch.randn(5, 7)
    (grad_fence(x).float() @ w).sum().backward()
    assert x.grad.dtype == torch.bfloat16
    jx = jnp.asarray(x.detach().float().numpy(), jnp.bfloat16)
    jg = jax.grad(lambda a: jnp.sum(jax_layers.grad_fence(a).astype(
        jnp.float32) @ jnp.asarray(w.numpy())))(jx)
    assert jg.dtype == jnp.bfloat16
    np.testing.assert_array_equal(x.grad.float().numpy(),
                                  np.asarray(jg, np.float32))
    # through the LM head: a bf16 hidden state gets a bf16 cotangent
    cfg = reduced(get_config("internlm2-1.8b"))
    p = init_params(model_defs(cfg), 0, device="cpu")
    h = torch.randn(2, 3, cfg.d_model).bfloat16().requires_grad_()
    logits(p["embed"], cfg, h).sum().backward()
    assert h.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b"])
def test_remat_same_loss_and_grads(arch):
    cfg = reduced(get_config(arch))
    batch = {k: torch.as_tensor(v)
             for k, v in SyntheticLM(cfg, 2, 16, seed=3).batch_at(0).items()}
    out = []
    for remat in (False, True):
        p = init_params(model_defs(cfg), 0, device="cpu", trainable=True)
        loss, _ = forward_train(p, cfg, batch, remat=remat)
        loss.backward()
        out.append((float(loss.detach()),
                    [x.grad.clone() for x in tree_leaves(p)]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "dbrx-132b"])
def test_trainer_three_steps_vs_jax(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    cfg = reduced(get_config(arch))
    kw = dict(steps=3, batch=2, seq_len=16, log_every=1)
    jt = JTrainer(jcfg, JTrainerConfig(**kw))
    p0 = jax.tree.map(np.asarray, jt.state["params"])
    jt.run()
    tt = Trainer(cfg, TrainerConfig(**kw), device="cpu",
                 params=params_from_numpy(p0, device="cpu",
                                          trainable=True))
    tt.run()
    assert [r["step"] for r in tt.metrics_history] == [0, 1, 2]
    for jr, tr in zip(jt.metrics_history, tt.metrics_history):
        assert set(tr) == set(jr)
        np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-5)
        np.testing.assert_allclose(tr["grad_norm"], jr["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(tr["lr"], jr["lr"], rtol=1e-6)
    jleaves = jax.tree.leaves(jt.state["params"])
    for want, got in zip(jleaves, tree_leaves(tt.state["params"])):
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.detach().numpy(), want, rtol=1e-4,
            atol=1e-6 + 1e-6 * float(np.abs(want).max()))
    assert int(tt.state["step"]) == 3
    assert int(tt.state["opt"]["count"]) == int(jt.state["opt"]["count"])


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

LINE = re.compile(r"^step +(\d+) loss (\d+\.\d{4}) \((\d+) ms\)$")


def test_launch_train_smoke_resume_and_production(tmp_path, capsys):
    def args(steps):
        return ["--arch", "internlm2-1.8b", "--smoke", "--steps", steps,
                "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt", str(tmp_path)]

    assert launch_train.main(args("2")) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [int(LINE.match(ln).group(1)) for ln in lines[:-1]] == [0, 1]
    assert re.match(r"^final loss: \d+\.\d{4}  stragglers flagged: \d+$",
                    lines[-1])
    assert launch_train.main(args("4") + ["--resume"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "resumed from step 2"
    assert [int(LINE.match(ln).group(1)) for ln in lines[1:-1]] == [3]
    assert launch_train.main(["--arch", "dbrx-132b", "--production",
                              "--multi-pod"]) == 2
    assert "A16" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# a kernel with no backward under autograd
# ---------------------------------------------------------------------------

def test_refuse_autograd_rule():
    x = torch.zeros(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="paged_attention has no "
                                           "backward"):
        refuse_autograd("paged_attention", None, x)
    with torch.no_grad():
        refuse_autograd("paged_attention", x)
    refuse_autograd("paged_attention", x.detach(), None)

