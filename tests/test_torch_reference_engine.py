"""PyTorch port: the dense ``ReferenceEngine`` and ``empty_batch_cache``
against the JAX reference on the same weights, and the port's paged
``Engine`` against the port's ``ReferenceEngine``.

* ``empty_batch_cache``: the JAX layout field for field (keys, shapes,
  dtypes) for internlm2, gemma2, rwkv6 and zamba2.
* ``ReferenceEngine``: greedy tokens, ``host_syncs`` and
  ``prefill_compiles`` equal to JAX's on ``tests/test_serving.py``'s
  engine-vs-reference traffic for the same four archs; a gemma2 prompt
  wider than its window of 16, whose splice keeps the last 16 tokens
  rolled by ``plen % 16`` (the ring equal to JAX's after admission).
  ``decode_compiles`` is the one decode shape; JAX's jit cache holds two
  there, because the reference's decode output gains an ``enc_kv: None``
  key and the second step retraces on the new pytree structure.
* The port's ``Engine`` token for token against the port's
  ``ReferenceEngine``: pool-direct and gather decode on internlm2 and
  gemma2 (``tests/test_paged_attention.py``'s case, a window-16 ring
  that wraps), and under prefix sharing with a full-page hit and a
  copy-on-write partial page (``tests/test_prefix_sharing.py``), fused
  and on two executables.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.serve.cache import empty_batch_cache as jax_empty  # noqa: E402
from repro.serve.reference import ReferenceEngine as JRef  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve.cache import empty_batch_cache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

ARCHS = ["internlm2-1.8b", "gemma2-2b", "rwkv6-7b", "zamba2-7b"]
CPU = torch.device("cpu")
PREFIX = [(3 * j) % 200 + 1 for j in range(16)]   # 2 full pages at P=8
_MODELS = {}


def _models(arch):
    """(port cfg, port params, JAX cfg, JAX params), the port's bridged
    from JAX's ``PRNGKey(0)`` init."""
    if arch not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch))
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[arch] = (reduced(get_config(arch)), tp, jcfg, jp)
    return _MODELS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_empty_batch_cache_matches_reference(arch):
    cfg, _, jcfg, _ = _models(arch)
    got = empty_batch_cache(cfg, 3, 64, CPU)
    want = jax_empty(jcfg, 3, 64)
    assert sorted(got) == sorted(want)
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert sorted(g) == sorted(w)
        for key in w:
            assert tuple(g[key].shape) == tuple(w[key].shape), key
            assert str(g[key].dtype).split(".")[-1] == str(w[key].dtype)
            assert not g[key].any()
    assert tuple(got["len"].shape) == (3,)
    assert got["len"].dtype == torch.int32 and not got["len"].any()


def _serving_traffic(vocab):
    """``tests/test_serving.py::test_engine_matches_reference_engine``'s
    five requests: prompts of 2..8 tokens, 5..7 new tokens."""
    out = []
    for i in range(5):
        plen = 2 + (4 * i) % 7
        out.append((i, [(5 * i + j) % vocab for j in range(plen)],
                    5 + i % 3))
    return out


def _run_both(arch, traffic, slots=2, max_len=64):
    cfg, tp, jcfg, jp = _models(arch)
    ref = ReferenceEngine(cfg, tp, slots=slots, max_len=max_len,
                          device="cpu")
    jref = JRef(jcfg, jp, slots=slots, max_len=max_len)
    for rid, prompt, mn in traffic:
        ref.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=mn))
        jref.submit(JRequest(rid=rid, prompt=list(prompt),
                             max_new_tokens=mn))
    got = {r.rid: r.out_tokens for r in ref.run()}
    want = {r.rid: r.out_tokens for r in jref.run()}
    return ref, jref, got, want


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_engine_matches_jax_reference(arch):
    cfg = _models(arch)[0]
    ref, jref, got, want = _run_both(arch, _serving_traffic(cfg.vocab_size))
    assert got == want
    assert ref.host_syncs == jref.host_syncs
    assert ref.prefill_compiles == jref.prefill_compiles == 5
    assert ref.steps == jref.steps
    assert ref.decode_compiles == 1


def test_reference_splice_rolls_a_prompt_wider_than_the_window():
    """A 40-token prompt into gemma2's window-16 ring: the splice keeps
    the last 16 tokens rolled so token t sits at t % 16; the ring's
    contents equal JAX's after admission, and the tokens after it."""
    arch = "gemma2-2b"
    cfg, tp, jcfg, jp = _models(arch)
    window = next(b.window for b in cfg.blocks if b.window)
    assert window == 16
    prompt = [(11 * j + 3) % cfg.vocab_size for j in range(40)]
    ref = ReferenceEngine(cfg, tp, slots=1, max_len=64, device="cpu")
    jref = JRef(jcfg, jp, slots=1, max_len=64)
    ref.submit(Request(rid=0, prompt=prompt, max_new_tokens=20))
    jref.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=20))
    ref._admit()
    jref._admit()
    for block, g, w in zip(cfg.blocks, ref.cache["layers"],
                           jref.cache["layers"]):
        size = 16 if block.window else 64
        assert g["k"].shape[2] == size
        for key in ("k", "v"):
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]),
                                       rtol=1e-5, atol=1e-5)
    assert int(ref.cache["len"][0]) == 40
    got = ref.run()[0].out_tokens
    assert got == jref.run()[0].out_tokens
    assert len(got) == 20


def _load(eng, traffic):
    for rid, prompt, mn in traffic:
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=mn))
    done = eng.run(max_steps=100_000)
    assert len(done) == len(traffic)
    out = {r.rid: r.out_tokens for r in done}
    eng.finished = []
    return out


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma2-2b"])
@pytest.mark.parametrize("paged_kernel", [True, False])
def test_engine_matches_reference_engine_paged_and_gather(arch,
                                                          paged_kernel):
    """``tests/test_paged_attention.py::test_engine_token_parity_paged_
    kernel``'s traffic: six 4-token prompts, 20 new tokens each, so
    gemma2's window-16 ring wraps."""
    cfg, tp, _, _ = _models(arch)
    traffic = [(i, [1 + i, 2, 3 + i % 3, 4], 20) for i in range(6)]
    eng = Engine(cfg, tp, slots=3, max_len=64, sync_interval=8,
                 prefix_sharing=False, paged_kernel=paged_kernel,
                 device="cpu")
    assert eng.paged_kernel is paged_kernel
    ref = ReferenceEngine(cfg, tp, slots=3, max_len=64, device="cpu")
    assert _load(eng, traffic) == _load(ref, traffic)


@pytest.mark.parametrize("chunked", [True, False])
@pytest.mark.parametrize("waves,hits,cow", [
    ([[(0, PREFIX + [7, 7], 6)], [(1, PREFIX + [9, 9, 9], 6)]], 1, 0),
    ([[(0, PREFIX, 6)], [(1, PREFIX[:12] + [9, 9, 9], 6)]], 1, 1),
])
def test_engine_matches_reference_engine_prefix_sharing(chunked, waves,
                                                        hits, cow):
    """``tests/test_prefix_sharing.py``'s parity oracle: request waves
    (each completes before the next submits) with a full-page prefix hit,
    then a partial-page hit that goes copy-on-write."""
    cfg, tp, _, _ = _models("internlm2-1.8b")
    eng = Engine(cfg, tp, slots=2, max_len=64, chunked_prefill=chunked,
                 device="cpu")
    ref = ReferenceEngine(cfg, tp, slots=2, max_len=64, device="cpu")
    got, want = {}, {}
    for wave in waves:
        got.update(_load(eng, wave))
        want.update(_load(ref, wave))
    assert got == want
    ps = eng.prefix_stats()
    assert ps["prefix_hits"] == hits
    assert ps["cow_copies"] == cow
    assert eng.leaked_pages() == 0
