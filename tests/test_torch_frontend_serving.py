"""PyTorch port: the serving engines on the last slice's decoder archs,
against the JAX engines on the same weights (reduced configs).

* pixtral-12b (a patch frontend): ``Engine`` greedy tokens and
  per-round ``memory_stats`` equal to the JAX engine's, on the gather
  path and pool-direct; ``chunked_prefill="auto"`` picks two
  executables and ``True`` is refused with the reference's reason;
  prefix sharing stays off (no prefix hit on a shared prompt head);
  ``ReferenceEngine`` tokens equal to JAX's; a prompt whose bucket is
  shorter than the frontend is refused at ``submit`` (the reference
  fails inside its prefill), a longer one served equal to JAX.
* gemma3-12b (window-16 rings that wrap) and mistral-large-123b
  (prefix hits with copy-on-write): ``Engine`` tokens equal to the JAX
  engine's, fused and two-executable.
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
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.reference import ReferenceEngine as JRef  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.module import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.reference import ReferenceEngine  # noqa: E402

_MODELS = {}
HEAD = [(7 * j) % 200 + 1 for j in range(20)]   # 2.5 pages at P=8


def _models(arch, **kw):
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = jax_reduced(jax_get_config(arch), **kw)
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (reduced(get_config(arch), **kw), tp, jcfg, jp)
    return _MODELS[key]


def _prompts(vocab, seed, lens, head=()):
    """Random prompts of ``lens`` tokens; every other one opens with
    ``head``."""
    rs = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(lens):
        lead = list(head) if i % 2 == 0 else []
        out.append(lead + rs.randint(1, vocab, n - len(lead)).tolist())
    return out


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


def _both(arch, prompts, max_new, **kw):
    cfg, tp, jcfg, jp = _models(arch)
    jeng = JEngine(jcfg, jp, **kw)
    want, jstats = _rounds(jeng, prompts, max_new)
    eng = Engine(cfg, tp, device="cpu", **kw)
    got, tstats = _rounds(eng, prompts, max_new)
    return eng, jeng, got, want, tstats, jstats


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_pixtral_engine_matches_reference(paged_kernel):
    """Prompts of 8..30 tokens (the reduced frontend fills the first 8
    positions of every prefill), half of them behind one 20-token head,
    on 3 slots: the JAX engine's tokens and ``memory_stats`` round by
    round, two executables picked by ``"auto"``, no prefix hit."""
    cfg = _models("pixtral-12b")[0]
    prompts = _prompts(cfg.vocab_size, 1, [24, 8, 30, 12, 28], HEAD)
    kw = dict(slots=3, max_len=64, sync_interval=4, seed=0,
              paged_kernel=paged_kernel)
    eng, jeng, got, want, tstats, jstats = _both("pixtral-12b", prompts, 9,
                                                 **kw)
    assert not eng.chunked_prefill and not jeng.chunked_prefill
    assert eng.paged_kernel == paged_kernel
    assert got == want and len(got) == len(prompts)
    assert tstats == jstats
    assert eng.prefix_stats()["prefix_hits"] == 0
    assert jeng.prefix_stats()["prefix_hits"] == 0
    assert eng.leaked_pages() == 0


def test_pixtral_refuses_the_fused_chunk():
    cfg, tp, jcfg, jp = _models("pixtral-12b")
    with pytest.raises(ValueError, match="modality-frontend"):
        JEngine(jcfg, jp, slots=2, max_len=32, chunked_prefill=True)
    with pytest.raises(ValueError, match="modality-frontend"):
        Engine(cfg, tp, slots=2, max_len=32, chunked_prefill=True,
               device="cpu")


def test_pixtral_reference_engine_matches_jax():
    cfg, tp, jcfg, jp = _models("pixtral-12b")
    prompts = _prompts(cfg.vocab_size, 2, [9, 14, 8, 21])
    ref = ReferenceEngine(cfg, tp, slots=2, max_len=48, device="cpu")
    jref = JRef(jcfg, jp, slots=2, max_len=48)
    for i, p in enumerate(prompts):
        ref.submit(Request(rid=i, prompt=p, max_new_tokens=7))
        jref.submit(JRequest(rid=i, prompt=p, max_new_tokens=7))
    got = {r.rid: r.out_tokens for r in ref.run()}
    want = {r.rid: r.out_tokens for r in jref.run()}
    assert got == want and len(got) == len(prompts)
    assert ref.host_syncs == jref.host_syncs


def test_pixtral_short_bucket_prompt_is_refused():
    """frontend_len 32: a 5-token prompt prefills in the 8 bucket, which
    cannot hold the frontend's 32 positions.  The JAX engine fails inside
    its prefill; the port refuses it at ``submit``.  A 40-token prompt
    (64 bucket) is served equal to JAX."""
    cfg, tp, jcfg, jp = _models("pixtral-12b", frontend_len=32)
    kw = dict(slots=2, max_len=96, sync_interval=4, seed=0)
    jeng = JEngine(jcfg, jp, **kw)
    jeng.submit(JRequest(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    with pytest.raises(ValueError):
        jeng.run(max_steps=10)
    eng = Engine(cfg, tp, device="cpu", **kw)
    with pytest.raises(ValueError, match="shorter than the 32-position"):
        eng.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    ref = ReferenceEngine(cfg, tp, slots=2, max_len=96, device="cpu")
    with pytest.raises(ValueError, match="shorter than the 32-position"):
        ref.submit(Request(rid=0, prompt=[1, 2, 3, 4, 5], max_new_tokens=4))
    prompt = _prompts(cfg.vocab_size, 3, [40])[0]
    jeng = JEngine(jcfg, jp, **kw)
    jeng.submit(JRequest(rid=0, prompt=prompt, max_new_tokens=6))
    want = jeng.run()[0].out_tokens
    eng = Engine(cfg, tp, device="cpu", **kw)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=6))
    assert eng.run()[0].out_tokens == want


@pytest.mark.parametrize("chunked,paged_kernel", [
    (True, False), (False, False), (True, True), (False, True)])
def test_gemma3_engine_matches_reference(chunked, paged_kernel):
    """reduced gemma3's window-16 rings wrap: prompts up to 40 tokens and
    20 new tokens on 3 slots, one prompt wider than the ring."""
    cfg = _models("gemma3-12b")[0]
    assert all(b.window == 16 for b in cfg.blocks)
    prompts = _prompts(cfg.vocab_size, 4, [40, 5, 17, 9])
    kw = dict(slots=3, max_len=96, sync_interval=4, seed=0,
              chunked_prefill=chunked, prefill_budget=8,
              paged_kernel=paged_kernel)
    eng, _j, got, want, tstats, jstats = _both("gemma3-12b", prompts, 20,
                                               **kw)
    assert eng.chunked_prefill == chunked
    assert got == want and len(got) == len(prompts)
    assert tstats == jstats
    assert eng.leaked_pages() == 0


@pytest.mark.parametrize("chunked", [True, False])
def test_mistral_engine_matches_reference(chunked):
    """reduced mistral-large (GQA 4:1 at this width): half the prompts
    share a 20-token head, so the radix index hits and copies the half
    page it matches; tokens, ``memory_stats`` and the prefix counters
    equal to the JAX engine's."""
    cfg = _models("mistral-large-123b")[0]
    prompts = _prompts(cfg.vocab_size, 5, [30, 11, 26, 7, 33], HEAD)
    kw = dict(slots=2, max_len=64, sync_interval=4, seed=0,
              chunked_prefill=chunked, prefill_budget=8)
    eng, jeng, got, want, tstats, jstats = _both("mistral-large-123b",
                                                 prompts, 8, **kw)
    assert got == want and len(got) == len(prompts)
    assert tstats == jstats
    ps, jps = eng.prefix_stats(), jeng.prefix_stats()
    assert ps["prefix_hits"] > 0 and ps["cow_copies"] > 0
    for key in ("prefix_hits", "cow_copies", "prefill_tokens_skipped"):
        assert ps[key] == jps[key], key
    assert eng.leaked_pages() == 0
