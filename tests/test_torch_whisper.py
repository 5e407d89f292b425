"""PyTorch port: whisper-medium's encoder and cross-attention, and the
dense decode cache of ``prepare_decode_cache``, against the JAX package
on the same weights and numpy-seeded inputs.

* ``_encoder`` (learned positions, roped non-causal self-attention over
  the frames), ``encode_kv`` and ``cross_apply``, at the default reduced
  frame count (8) and at 37 (not a multiple of 16): atol 1e-5.
* ``forward_prefill`` with ``frames`` (its ``enc_kv``), then
  ``prepare_decode_cache`` and ``forward_decode`` reading ``enc_kv``:
  logits within 1e-4, the grown caches equal.
* ``prepare_decode_cache`` on reduced gemma3, whose window-16 ring is
  shorter than a 24-token prompt: the rolled ring equal to JAX's.
* ``Engine``, ``CacheSpec`` and ``ReferenceEngine`` refuse whisper, as
  the reference's do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import forward_decode as jax_forward_decode  # noqa: E402
from repro.models import forward_prefill as jax_forward_prefill  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import \
    prepare_decode_cache as jax_prepare_decode_cache  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro.serve.cache import CacheSpec as JCacheSpec  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.reference import ReferenceEngine as JRef  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402
from repro_torch.models import (forward_decode,  # noqa: E402
                                forward_prefill, prepare_decode_cache)
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve.cache import CacheSpec  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

ARCH = "whisper-medium"
ATOL = 1e-5
B, PLEN, MAX_LEN = 2, 9, 20


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().cpu()),
                               np.asarray(want), rtol=0, atol=atol,
                               err_msg=msg)


def _models(arch, **kw):
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return reduced(get_config(arch), **kw), tp, jcfg, jp


@pytest.fixture(scope="module", params=[8, 37], ids=["frames8", "frames37"])
def whisper(request):
    return _models(ARCH, frontend_len=request.param)


def _frames(cfg, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, cfg.frontend_len, cfg.d_model) * 0.1).astype(
        np.float32)


def test_model_defs_carry_encoder_and_cross(whisper):
    """The bridge carries ``encoder`` and each layer's ``ln_cross`` and
    ``cross`` over key for key."""
    cfg, tp, _jcfg, jp = whisper
    got = dict(tp.named_parameters())
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert sorted(got) == sorted(want)
    assert tuple(tp["encoder"]["pos"].shape) == (cfg.frontend_len,
                                                 cfg.d_model)
    assert "cross" in tp["layers"][0] and "ln_cross" in tp["layers"][0]
    for name, leaf in want.items():
        assert np.array_equal(got[name].numpy(), np.asarray(leaf)), name


def test_encoder_matches_reference(whisper):
    cfg, tp, jcfg, jp = whisper
    frames = _frames(cfg)
    got = ttr._encoder(tp, cfg, torch.as_tensor(frames))
    want = jtr._encoder(jp, jcfg, jnp.asarray(frames), None)
    assert got.shape == (B, cfg.frontend_len, cfg.d_model)
    _close(got, want)


def test_encode_kv_and_cross_apply_match_reference(whisper):
    cfg, tp, jcfg, jp = whisper
    rs = np.random.RandomState(3)
    enc = rs.randn(B, cfg.frontend_len, cfg.d_model).astype(np.float32)
    x = rs.randn(B, 5, cfg.d_model).astype(np.float32)
    tp_c = tp["layers"][1]["cross"]
    jp_c = jp["layers"][1]["cross"]
    kv = tatt.encode_kv(tp_c, torch.as_tensor(enc), cfg=cfg)
    jkv = jatt.encode_kv(jp_c, jnp.asarray(enc), cfg=jcfg)
    for key in ("k", "v"):
        assert kv[key].shape == (B, cfg.num_kv_heads, cfg.frontend_len,
                                 cfg.resolved_head_dim)
        assert kv[key].is_contiguous()
        _close(kv[key], jkv[key])
    for s in (5, 1):          # a prompt's rows; one decode row
        got = tatt.cross_apply(tp_c, torch.as_tensor(x[:, :s]), kv, cfg=cfg)
        want = jatt.cross_apply(jp_c, jnp.asarray(x[:, :s]), jkv, cfg=jcfg)
        _close(got, want, msg=f"cross_apply S={s}")


def test_prefill_then_decode_read_enc_kv(whisper):
    """A bucket-padded prefill with frames, the decode cache grown to
    ``MAX_LEN`` and six decode steps, every one cross-attending."""
    cfg, tp, jcfg, jp = whisper
    rs = np.random.RandomState(5)
    frames = _frames(cfg, 1)
    toks = np.zeros((B, 16), np.int32)
    toks[:, :PLEN] = rs.randint(1, cfg.vocab_size, (B, PLEN))
    length = np.full((B,), PLEN, np.int32)
    logits, cache = forward_prefill(
        tp, cfg, {"tokens": torch.as_tensor(toks),
                  "frames": torch.as_tensor(frames)},
        length=torch.as_tensor(length))
    jlogits, jcache = jax_forward_prefill(
        jp, jcfg, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)},
        length=jnp.asarray(length))
    _close(logits, jlogits, 1e-4)
    assert sorted(cache) == sorted(jcache) == ["enc_kv", "layers", "len"]
    assert len(cache["enc_kv"]) == cfg.num_layers
    for got, want in zip(cache["enc_kv"], jcache["enc_kv"]):
        for key in ("k", "v"):
            _close(got[key], want[key])
    # a bucket-padded prefill keeps its padding: grow from the true length
    cache = dict(cache, layers=[{k: v[:, :, :PLEN] for k, v in e.items()}
                                for e in cache["layers"]])
    jcache = dict(jcache, layers=[{k: v[:, :, :PLEN] for k, v in e.items()}
                                  for e in jcache["layers"]])
    cache = prepare_decode_cache(cfg, cache, MAX_LEN)
    jcache = jax_prepare_decode_cache(jcfg, jcache, MAX_LEN)
    for got, want in zip(cache["layers"], jcache["layers"]):
        for key in ("k", "v"):
            assert got[key].shape[2] == MAX_LEN
            _close(got[key], want[key])
    tok = rs.randint(1, cfg.vocab_size, (B, 6)).astype(np.int32)
    for t in range(6):
        logits, cache = forward_decode(tp, cfg,
                                       torch.as_tensor(tok[:, t:t + 1]),
                                       cache)
        jlogits, jcache = jax_forward_decode(jp, jcfg,
                                             jnp.asarray(tok[:, t:t + 1]),
                                             jcache)
        _close(logits, jlogits, 1e-4, f"decode step {t}")
        assert cache["enc_kv"] is not None
    assert cache["len"].tolist() == [PLEN + 6] * B


def test_prepare_decode_cache_rolls_a_window_ring():
    """reduced gemma3 at 9 layers (every 5th of the 48, so two of them
    global): a 24-token prompt keeps its last 16 tokens in each window-16
    ring, rolled so token t sits at t % 16, the global layers grow to
    ``max_len``; then decode steps on the rings."""
    cfg, tp, jcfg, jp = _models("gemma3-12b", layers=9)
    assert [b.window for b in cfg.blocks] == [16, None, 16, 16, 16, 16,
                                              16, None, 16]
    rs = np.random.RandomState(7)
    toks = rs.randint(1, cfg.vocab_size, (B, 24)).astype(np.int32)
    _, cache = forward_prefill(tp, cfg, {"tokens": torch.as_tensor(toks)})
    _, jcache = jax_forward_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)})
    cache = prepare_decode_cache(cfg, cache, 40)
    jcache = jax_prepare_decode_cache(jcfg, jcache, 40)
    for block, got, want in zip(cfg.blocks, cache["layers"],
                                jcache["layers"]):
        for key in ("k", "v"):
            assert got[key].shape[2] == (16 if block.window else 40)
            _close(got[key], want[key])
    nxt = rs.randint(1, cfg.vocab_size, (B, 4)).astype(np.int32)
    for t in range(4):
        logits, cache = forward_decode(tp, cfg,
                                       torch.as_tensor(nxt[:, t:t + 1]),
                                       cache)
        jlogits, jcache = jax_forward_decode(jp, jcfg,
                                             jnp.asarray(nxt[:, t:t + 1]),
                                             jcache)
        _close(logits, jlogits, 1e-4, f"decode step {t}")


def test_engines_refuse_whisper():
    """Neither engine nor the serving cache takes a cross-attention
    arch, in the port as in the reference."""
    cfg, tp, jcfg, jp = _models(ARCH)
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        JEngine(jcfg, jp, slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        Engine(cfg, tp, slots=2, max_len=32, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        JRef(jcfg, jp, slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match="decoder-only archs"):
        ReferenceEngine(cfg, tp, slots=2, max_len=32, device="cpu")
    with pytest.raises(ValueError, match="cross-attention"):
        JCacheSpec.from_config(jcfg, 2, 32)
    with pytest.raises(ValueError, match="cross-attention"):
        CacheSpec.from_config(cfg, 2, 32)
