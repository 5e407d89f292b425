"""PyTorch port: fig14's ``quantized_pool_comparison`` on the CPU.

* The chain training it starts with: the port's first 5 steps
  (``train_chain_model``: ``forward_train`` and ``optim/adamw`` at lr
  3e-3 on ``chain_batch``'s 8 chains of 33 tokens), from the JAX
  package's seed-0 weights brought across by the weight bridge, give the
  losses of the JAX ``adamw`` steps on the same batches within 1e-4
  relative.
* The workload itself, on the port's own seed-0 weights, meets the gates
  the JAX package's ``benchmarks/check_serve_regression.py`` puts on it:
  int8 pools, greedy agreement >= 0.99 and a teacher-forced logit error
  <= 0.25 against fp32 pools, an int8 pool of no more bytes serving >=
  1.8x the slots all at once, >= 1 preemption with equal outputs and no
  leaked page, copy-on-write outputs equal with a prefix hit, one decode
  shape and a sync-free decode chunk.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import forward_train as jax_forward_train  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.optim import adamw as jax_adamw  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    fig14_dispatch_overhead as fig14)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402

LOSS_RTOL = 1e-4
STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the reduced model's ops are tiny."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chain_training_losses_match_jax():
    jcfg = jax_reduced(jax_get_config(fig14.ARCH))
    cfg = reduced(get_config(fig14.ARCH))
    vocab = cfg.vocab_size
    params = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, params), device="cpu",
                           trainable=True)
    ocfg = jax_adamw.AdamWConfig(lr=3e-3)
    opt = jax_adamw.init(params, ocfg)

    @jax.jit
    def train_step(p, o, toks):
        def loss_fn(w):
            return jax_forward_train(w, jcfg, {"tokens": toks[:, :-1],
                                               "labels": toks[:, 1:]})
        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        new_p, new_o, _ = jax_adamw.update(grads, o, p, ocfg)
        return new_p, new_o, loss

    want = []
    for it in range(STEPS):
        batch = fig14.chain_batch(it, vocab, torch.device("cpu")).numpy()
        params, opt, loss = train_step(params, opt, jnp.asarray(batch))
        want.append(float(loss))
    got = fig14.train_chain_model(cfg, tp, steps=STEPS)
    assert len(got) == STEPS
    for g, w in zip(got, want):
        assert abs(g - w) <= LOSS_RTOL * abs(w)
    assert got[-1] < got[0]


def test_quantized_pool_comparison_gates():
    rec = fig14.quantized_pool_comparison(device="cpu")
    assert rec["qp_kv_dtype"] == "int8"
    assert rec["qp_fp32_follows_chain"] == 1.0
    assert rec["qp_greedy_match"] >= 0.99
    assert rec["qp_max_logit_err"] <= 0.25
    assert rec["qp_quant_pool_bytes"] <= rec["qp_fp32_pool_bytes"]
    assert rec["qp_equal_bytes_slot_ratio"] >= 1.8
    assert rec["qp_equal_bytes_peak_live_slots"] \
        == rec["qp_equal_bytes_slots"]
    assert rec["qp_preemptions"] >= 1
    assert rec["qp_preempt_outputs_match"] is True
    assert rec["qp_preempt_leaked_pages"] == 0
    assert rec["qp_cow_outputs_match"] is True
    assert rec["qp_prefix_hits"] >= 1
    assert rec["qp_decode_sync_free"] is True
    assert rec["qp_decode_compiles"] == 1
