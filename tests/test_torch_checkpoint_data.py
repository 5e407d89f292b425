"""PyTorch port: checkpoints and the deterministic data pipeline, the
mirror of ``tests/test_checkpoint_data.py``'s six cases, held against
the JAX ``repro.train.checkpoint`` and ``repro.data.pipeline`` where
they meet (on the CPU).

* A round trip of a state with ``QTensor`` leaves, bitwise; the on-disk
  layout and leaf order the reference's: a port checkpoint restores into
  the reference's state tree and a reference checkpoint into the port's.
* ``latest_step`` skips a stale ``.tmp`` directory (a killed writer).
* ``restore`` casts to the target's dtypes.
* A ``Trainer`` restarted from its step-3 checkpoint replays steps 3..5
  to the uninterrupted run's final loss (rtol 1e-5).
* ``SyntheticLM.batch_at`` is deterministic, learnable, and the
  reference's arrays bit for bit (a frontend arch's stub too).
* ``DevicePrefetcher`` yields steps in order and surfaces a worker error.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data.pipeline import (DevicePrefetcher,  # noqa: E402
                                       SyntheticLM)
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def _jax_state():
    k = jax.random.PRNGKey(3)
    params = {"a": jax.random.normal(k, (16, 130)),
              "nested": {"b": jnp.arange(12).reshape(3, 4)}}
    cfg = jadamw.AdamWConfig(quantize_v=True)
    return {"params": params, "opt": jadamw.init(params, cfg),
            "step": jnp.asarray(7, jnp.int32)}


def _state():
    """The port's counterpart of the reference test's state, with the
    reference's values (a non-zero ``v`` so the scales mean something)."""
    g = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(16, 130, generator=g),
              "nested": {"b": torch.arange(12).reshape(3, 4)}}
    opt = adamw.init(params, adamw.AdamWConfig(quantize_v=True))
    opt["v"]["a"] = adamw.quantize(torch.rand(16, 130, generator=g))
    return {"params": params, "opt": opt,
            "step": torch.tensor(7, dtype=torch.int32)}


def _zeros_like(state):
    from repro_torch.models.module import tree_map
    return tree_map(torch.zeros_like, state)


def test_roundtrip_with_qtensor(tmp_path):
    state = _state()
    ck.save(str(tmp_path), state, 7)
    target = _zeros_like(state)
    restored, step = ck.restore(str(tmp_path), target)
    assert step == 7 and restored is target
    assert isinstance(restored["opt"]["v"]["a"], adamw.QTensor)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_layout_shared_with_reference(tmp_path):
    """Both packages number the leaves alike: each restores the other's
    checkpoint of the reference test's state."""
    jstate = _jax_state()
    jck.save(str(tmp_path / "jax"), jstate, 7)
    names = sorted(os.listdir(tmp_path / "jax" / "step_00000007"))
    target = _zeros_like(_state())
    target["params"]["nested"]["b"] = torch.zeros(3, 4, dtype=torch.int32)
    restored, _ = ck.restore(str(tmp_path / "jax"), target)
    for a, b in zip(jax.tree.leaves(jstate), tree_leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ck.save(str(tmp_path / "port"), restored, 7)
    assert sorted(os.listdir(tmp_path / "port" / "step_00000007")) == names
    back, step = jck.restore(str(tmp_path / "port"), jstate)
    assert step == 7
    for a, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_and_atomicity(tmp_path):
    state = _state()
    ck.save(str(tmp_path), state, 5)
    ck.save(str(tmp_path), state, 9)
    # a stale .tmp dir (simulated crash) must be ignored
    os.makedirs(tmp_path / "step_00000011.tmp")
    assert ck.latest_step(str(tmp_path)) == 9
    assert ck.latest_step(str(tmp_path / "none")) is None


def test_restore_respects_target_dtype(tmp_path):
    ck.save(str(tmp_path), {"w": torch.ones(4, 4)}, 1)
    target = {"w": torch.empty(4, 4, dtype=torch.bfloat16)}
    restored, _ = ck.restore(str(tmp_path), target)
    assert restored["w"].dtype == torch.bfloat16
    assert bool((restored["w"] == 1).all())
    with pytest.raises(ValueError, match="leaf 0"):
        ck.restore(str(tmp_path), {"w": torch.empty(4, 5)})


def test_trainer_resume_replays_deterministically(tmp_path):
    cfg = reduced(get_config("internlm2-1.8b"), layers=1, d_model=32,
                  d_ff=64, vocab=64)
    tc = TrainerConfig(steps=6, batch=2, seq_len=16,
                       ckpt_dir=str(tmp_path), ckpt_every=3, log_every=1)
    t1 = Trainer(cfg, tc, device="cpu")
    t1.run()
    loss_full = t1.metrics_history[-1]["loss"]

    # restart from step 3 and replay 3..5: identical final loss
    t2 = Trainer(cfg, tc, device="cpu")
    start = t2.maybe_restore()
    assert start == 6  # final checkpoint; restore the mid one instead
    t3 = Trainer(cfg, tc, device="cpu")
    t3.state, _ = ck.restore(str(tmp_path), t3.state, step=3)
    assert int(t3.state["step"]) == 3
    t3.run()
    assert [r["step"] for r in t3.metrics_history] == [3, 4, 5]
    np.testing.assert_allclose(t3.metrics_history[-1]["loss"], loss_full,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "pixtral-12b",
                                  "whisper-medium"])
def test_data_determinism_and_structure(arch):
    cfg = reduced(get_config(arch))
    src = SyntheticLM(cfg, batch=4, seq_len=32, seed=11)
    b1 = src.batch_at(5)
    b2 = src.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(b1["tokens"], src.batch_at(6)["tokens"])
    # labels are next-token shifted stream
    assert b1["tokens"].shape == (4, 32) and b1["labels"].shape == (4, 32)
    assert (b1["tokens"] < cfg.vocab_size).all()
    # learnable: majority of transitions follow next = (31x+17) % v
    det = (b1["tokens"] * 31 + 17) % cfg.vocab_size
    assert (det == b1["labels"]).mean() > 0.5
    # the reference's arrays, bit for bit
    jsrc = JSyntheticLM(jax_reduced(jax_get_config(arch)), batch=4,
                        seq_len=32, seed=11)
    for step in (0, 5, 123):
        want, got = jsrc.batch_at(step), src.batch_at(step)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


def test_prefetcher():
    cfg = reduced(get_config("internlm2-1.8b"))
    src = SyntheticLM(cfg, batch=2, seq_len=16, seed=0)
    pf = DevicePrefetcher(src, device="cpu", depth=2, start_step=3)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    np.testing.assert_array_equal(got[1][1]["tokens"].numpy(),
                                  src.batch_at(4)["tokens"])

    class Broken(SyntheticLM):
        def batch_at(self, step):
            raise KeyError("no such step")

    pf = DevicePrefetcher(Broken(cfg, 2, 16), device="cpu")
    with pytest.raises(KeyError, match="no such step"):
        next(pf)
    pf.close()
