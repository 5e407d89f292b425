"""PyTorch port: on-device sampling and slot bookkeeping against the JAX
reference.  Greedy rows must match exactly; sampled rows are held by
distribution (torch's Philox stream is not JAX's threefry)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serve import sampling as jsampling  # noqa: E402
from repro_torch.serve import sampling  # noqa: E402


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_greedy_rows_are_argmax():
    logits = np.random.RandomState(0).randn(6, 50).astype(np.float32)
    got = sampling.sample(torch.as_tensor(logits), _gen(),
                          temperature=torch.zeros(6), top_k=0)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("top_k", [0, 2])
def test_sampled_rows_follow_the_softmax(top_k):
    """20000 draws over 5 tokens at T=0.7: every empirical frequency
    within 5 sigma of softmax(logits / T) (renormalized over the top k)."""
    row = np.array([1.0, 0.5, 0.0, -0.5, 0.2], np.float32)
    n, temp = 20000, 0.7
    logits = torch.as_tensor(np.tile(row, (n, 1)))
    got = sampling.sample(logits, _gen(3), temperature=torch.full((n,), temp),
                          top_k=top_k).numpy()
    p = np.exp(row / temp)
    if top_k:
        p[np.argsort(row)[:-top_k]] = 0.0
    p /= p.sum()
    freq = np.bincount(got, minlength=5) / n
    sigma = np.sqrt(p * (1 - p) / n) + 1e-12
    assert np.all(np.abs(freq - p) <= 5 * sigma + 1e-9), (freq, p)


def test_mixed_batch_keeps_greedy_rows_exact():
    logits = np.random.RandomState(1).randn(4, 30).astype(np.float32)
    temp = torch.tensor([0.0, 1.0, 0.0, 2.0])
    got = sampling.sample(torch.as_tensor(logits), _gen(),
                          temperature=temp, top_k=5).numpy()
    np.testing.assert_array_equal(got[[0, 2]], logits[[0, 2]].argmax(-1))
    assert all(0 <= t < 30 for t in got)


def test_decode_update_matches_reference():
    slots = 5
    tstate = sampling.make_slot_state(slots, torch.device("cpu"), 8)
    jstate = jsampling.make_slot_state(slots, prompt_cap=8)
    vals = {"out_len": [0, 3, 4, 1, 0], "max_new": [4, 4, 5, 9, 2],
            "eos": [-1, 7, 9, -1, 5], "active": [True, True, True, False,
                                                 True]}
    for k, v in vals.items():
        tstate[k] = torch.as_tensor(np.array(v, np.bool_ if k == "active"
                                             else np.int32))
        jstate[k] = jnp.asarray(np.asarray(tstate[k].numpy()))
    nxt = np.array([3, 7, 1, 2, 5], np.int32)
    commit = np.array([True, True, False, True, True])
    tnew, tem = sampling.decode_update(tstate, torch.as_tensor(nxt),
                                       commit=torch.as_tensor(commit))
    jnew, jem = jsampling.decode_update(jstate, jnp.asarray(nxt),
                                        jstate["key"],
                                        commit=jnp.asarray(commit))
    np.testing.assert_array_equal(tem.numpy(), np.asarray(jem))
    for k in ("tokens", "out_len", "active"):
        np.testing.assert_array_equal(tnew[k].numpy(), np.asarray(jnew[k]),
                                      err_msg=k)
