"""PyTorch port: gemma2-2b (local/global sliding windows, attention and
final-logit softcaps, tied and scaled embeddings, head_dim 256) against
the JAX reference on the same weights.

* ``get_config("gemma2-2b")`` and its ``reduced()`` field for field, and
  ``alternating_windows`` on gemma2's and gemma3's patterns.
* ``forward_prefill`` over prompts shorter and longer than the reduced
  window of 16 (logits and KV within 1e-5).
* Engine greedy tokens and the per-round ``memory_stats`` equal to the
  JAX engine's while the window-16 ring wraps, fused and two
  executables, with the gather path and pool-direct reads; and a
  two-executable prompt longer than the window, spliced into a ring
  narrower than its bucket.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.configs.base import \
    alternating_windows as jax_alternating_windows  # noqa: E402
from repro.models import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import (alternating_windows, get_config,  # noqa: E402
                                 reduced)
from repro_torch.models import forward_prefill  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCH = "gemma2-2b"


@pytest.fixture(scope="module")
def models():
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config(ARCH)), tp, jcfg, jp


@pytest.mark.parametrize("make", ["full", "reduced"])
def test_config_fields_match_reference(make):
    got, want = get_config(ARCH), jax_get_config(ARCH)
    if make == "reduced":
        got, want = reduced(got), jax_reduced(want)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.supports_long_context == want.supports_long_context
    if make == "full":
        assert got.resolved_head_dim == 256
        assert [b.window for b in got.blocks[:4]] == [4096, None, 4096, None]


@pytest.mark.parametrize("n,pattern", [(26, [4096, None]),
                                       (48, [1024] * 5 + [None]),
                                       (7, [16])])
def test_alternating_windows_match_reference(n, pattern):
    got = alternating_windows(n, pattern)
    want = jax_alternating_windows(n, pattern)
    assert [dataclasses.asdict(b) for b in got] == \
        [dataclasses.asdict(b) for b in want]


@pytest.mark.parametrize("plen", [5, 40])
def test_forward_prefill_matches_reference(models, plen):
    """A prompt inside the window and one 2.5 windows long, bucket-padded:
    the last token's logits (tied head, final softcap 30) and every
    layer's KV (windowed flash attention with softcap 50) within 1e-5."""
    cfg, tp, jcfg, jp = models
    rs = np.random.RandomState(plen)
    bucket = 64
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :plen] = rs.randint(1, cfg.vocab_size, plen)
    length = np.array([plen], np.int32)
    tl, tc = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)},
                             length=torch.as_tensor(length))
    jl, jc = jax_forward_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                 length=jnp.asarray(length))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    assert float(tl.abs().max()) <= 30.0
    for tl_, jl_ in zip(tc["layers"], jc["layers"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tl_[key].numpy()[:, :, :plen],
                np.asarray(jl_[key])[:, :, :plen], rtol=0, atol=1e-5)


def _rounds(eng, prompts, max_new):
    """Serve round by round: tokens, and ``memory_stats`` after each."""
    R = Request if isinstance(eng, Engine) else JRequest
    for i, p in enumerate(prompts):
        eng.submit(R(rid=i, prompt=list(p), max_new_tokens=max_new))
    stats = []
    while eng.queue or eng._live():
        eng.step()
        stats.append(eng.memory_stats())
    return {r.rid: list(r.out_tokens) for r in eng.finished}, stats


@pytest.mark.parametrize("chunked,paged_kernel", [
    (True, False), (False, False), (True, True), (False, True)])
def test_engine_ring_wrap_parity(models, chunked, paged_kernel):
    """Generation runs window + 8 tokens, so each slot's window-16 ring
    wraps mid-serve (three slots, fused neighbours mid-prefill)."""
    cfg, tp, jcfg, jp = models
    w = min(b.window for b in cfg.blocks if b.window is not None)
    assert w == 16
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1, 8], [3, 1, 4, 1, 5, 9]]
    kw = dict(slots=3, max_len=96, sync_interval=4, seed=0,
              chunked_prefill=chunked, prefill_budget=4,
              paged_kernel=paged_kernel)
    want, jstats = _rounds(JEngine(jcfg, jp, **kw), prompts, w + 8)
    eng = Engine(cfg, tp, device="cpu", **kw)
    assert eng.chunked_prefill == chunked
    assert eng.paged_kernel == paged_kernel
    got, tstats = _rounds(eng, prompts, w + 8)
    assert got == want
    assert tstats == jstats
    assert eng.leaked_pages() == 0
    groups = tstats[0]["pool_groups"]
    assert len(groups) == 2 and sum(g["windowed"]
                                    for g in groups.values()) == 1


def test_engine_prompt_longer_than_window(models):
    """Two executables: a 40-token prompt (bucket 64) spliced into the
    window-16 ring, whose later tokens overwrite its earlier ones inside
    one splice, then 12 decode steps; and the fused engine on it."""
    cfg, tp, jcfg, jp = models
    rs = np.random.RandomState(9)
    prompts = [rs.randint(1, cfg.vocab_size, 40).tolist(), [5, 6, 7]]
    for chunked in (False, True):
        kw = dict(slots=2, max_len=96, sync_interval=4, seed=0,
                  chunked_prefill=chunked, prefill_budget=8)
        want, jstats = _rounds(JEngine(jcfg, jp, **kw), prompts, 12)
        got, tstats = _rounds(Engine(cfg, tp, device="cpu", **kw), prompts,
                              12)
        assert got == want
        assert tstats == jstats
