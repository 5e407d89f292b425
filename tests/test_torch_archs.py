"""PyTorch port: every architecture of the reference, against the JAX
package on the same weights (carried over by ``params_from_numpy``) and
the same numpy-seeded inputs.

* The four configs of the last slice (gemma3-12b, mistral-large-123b,
  pixtral-12b, whisper-medium) field for field, full and ``reduced``;
  ``ARCH_IDS`` equal; the long-context flags of every arch.
* For each of the ten archs, reduced: ``forward_dense_logits`` within
  1e-4 of JAX's, and the mirror of
  ``test_models_smoke.py::test_prefill_decode_matches_dense``: a prefill
  of the first 10 tokens, ``prepare_decode_cache`` and token-by-token
  ``forward_decode`` to 24, each step's logits within 2e-3 of the port's
  own dense logits (the reference test's bound) and within 1e-4 of the
  JAX prefill's and decode's logits.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as JAX_ARCH_IDS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import forward_decode as jax_forward_decode  # noqa: E402
from repro.models import \
    forward_dense_logits as jax_dense_logits  # noqa: E402
from repro.models import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import \
    prepare_decode_cache as jax_prepare_decode_cache  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, reduced  # noqa: E402
from repro_torch.models import (forward_decode,  # noqa: E402
                                forward_dense_logits, forward_prefill,
                                prepare_decode_cache)
from repro_torch.models.module import params_from_numpy  # noqa: E402

NEW_ARCHS = ("gemma3-12b", "mistral-large-123b", "pixtral-12b",
             "whisper-medium")
B, T, T0 = 2, 24, 10
JAX_TOL = 1e-4      # the port against JAX on the same path
DENSE_TOL = 2e-3    # prefill/decode against dense: the reference's bound


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), rtol=0, atol=atol,
                               err_msg=msg)


def _batch(cfg, seed=0):
    """tokens [B,T] and, for a frontend arch, its stub embeddings x 0.1
    (the reference test's scale), from one numpy seed."""
    rs = np.random.RandomState(seed)
    batch = {"tokens": rs.randint(0, cfg.vocab_size, (B, T)).astype(
        np.int32)}
    if cfg.frontend:
        key = "frames" if cfg.family == "audio" else "frontend"
        batch[key] = (rs.randn(B, cfg.frontend_len, cfg.d_model)
                      * 0.1).astype(np.float32)
    return batch


def _models(arch):
    jcfg = jax_reduced(jax_get_config(arch))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config(arch)), tp, jcfg, jp


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("make", ["full", "reduced"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_config_fields_match_reference(arch, make):
    got, want = get_config(arch), jax_get_config(arch)
    if make == "reduced":
        got, want = reduced(got), jax_reduced(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.supports_long_context == want.supports_long_context


def test_frontend_len_reduced_matches_reference():
    """whisper with a frame count that is not a multiple of 16."""
    got = reduced(get_config("whisper-medium"), frontend_len=37)
    want = jax_reduced(jax_get_config("whisper-medium"), frontend_len=37)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_arch_ids_match_reference():
    assert ARCH_IDS == JAX_ARCH_IDS


def test_long_context_flags():
    """The mirror of ``test_models_smoke.py::test_long_context_flags``,
    and every arch's flag equal to the reference's."""
    assert get_config("rwkv6-7b").supports_long_context
    assert get_config("zamba2-7b").supports_long_context
    for arch in ("mistral-large-123b", "gemma2-2b", "gemma3-12b",
                 "dbrx-132b", "whisper-medium"):
        assert not get_config(arch).supports_long_context, arch
    for arch in ARCH_IDS:
        assert get_config(arch).supports_long_context == \
            jax_get_config(arch).supports_long_context, arch


def test_unknown_arch_lists_the_ten():
    with pytest.raises(KeyError, match="whisper-medium"):
        get_config("llama-7b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_matches_dense(arch):
    cfg, tp, jcfg, jp = _models(arch)
    batch = _batch(cfg)
    tb, jb = _t(batch), _j(batch)

    dense = forward_dense_logits(tp, cfg, tb)
    jdense = np.asarray(jax_dense_logits(jp, jcfg, jb))
    assert dense.shape == (B, T, cfg.vocab_size)
    _close(dense, jdense, JAX_TOL, f"{arch}: dense logits")

    pre = dict(tb, tokens=tb["tokens"][:, :T0])
    jpre = dict(jb, tokens=jb["tokens"][:, :T0])
    logits, cache = forward_prefill(tp, cfg, pre)
    jlogits, jcache = jax.jit(
        lambda p, b: jax_forward_prefill(p, jcfg, b))(jp, jpre)
    _close(logits, dense[:, T0 - 1].detach(), DENSE_TOL,
           f"{arch}: prefill vs dense")
    _close(logits, jlogits, JAX_TOL, f"{arch}: prefill vs JAX")
    assert (cache["enc_kv"] is None) == (jcache["enc_kv"] is None)

    cache = prepare_decode_cache(cfg, cache, T)
    jcache = jax_prepare_decode_cache(jcfg, jcache, T)
    jdecode = jax.jit(lambda p, t, c: jax_forward_decode(p, jcfg, t, c))
    for t in range(T0, T):
        logits, cache = forward_decode(tp, cfg, tb["tokens"][:, t:t + 1],
                                       cache)
        jlogits, jcache = jdecode(jp, jb["tokens"][:, t:t + 1], jcache)
        _close(logits, dense[:, t].detach(), DENSE_TOL,
               f"{arch}: decode vs dense at position {t}")
        _close(logits, jlogits, JAX_TOL,
               f"{arch}: decode vs JAX at position {t}")
