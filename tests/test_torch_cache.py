"""PyTorch port: the paged decode cache and the scheduler against the JAX
reference — pool groups, shapes, trash ids and byte accounting for the
reduced and the full internlm2-1.8b at several sizes, the in-place
admission / copy-on-write / eviction updates, and admission decisions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.scheduler import Request as JRequest  # noqa: E402
from repro.serve.scheduler import Scheduler as JScheduler  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.scheduler import Request, Scheduler  # noqa: E402

ARCH = "internlm2-1.8b"
SIZES = [(4, 96, 8, 0), (3, 100, 4, 31), (8, 1024, 16, 31), (2, 64, 16, 0)]


def _cfgs(which):
    if which == "full":
        return get_config(ARCH), jax_get_config(ARCH)
    return reduced(get_config(ARCH)), jax_reduced(jax_get_config(ARCH))


def _specs(which, slots, max_len, page_size, spec_tokens, num_pages=None):
    cfg, jcfg = _cfgs(which)
    kw = dict(page_size=page_size, num_pages=num_pages,
              spec_tokens=spec_tokens)
    return (tcache.CacheSpec.from_config(cfg, slots, max_len, **kw),
            jcache.CacheSpec.from_config(jcfg, slots, max_len, **kw))


@pytest.mark.parametrize("which", ["reduced", "full"])
@pytest.mark.parametrize("slots,max_len,page_size,spec_tokens", SIZES)
def test_cachespec_matches_reference(which, slots, max_len, page_size,
                                     spec_tokens):
    t, j = _specs(which, slots, max_len, page_size, spec_tokens)
    assert [(g.key, g.ring_blocks, g.num_pages, g.windowed, g.trash_page)
            for g in t.groups] == [
        (g.key, g.ring_blocks, g.num_pages, g.windowed, g.trash_page)
        for g in j.groups]
    assert [(ls.kind, ls.ring_blocks, ls.window, ls.group)
            for ls in t.layers] == [
        (ls.kind, ls.ring_blocks, ls.window, ls.group) for ls in j.layers]
    for g_t, g_j in zip(t.groups, j.groups):
        assert t.pool_shape_for(g_t) == j.pool_shape_for(g_j)
        assert t.group_page_bytes(g_t) == j.group_page_bytes(g_j)
    assert (t.max_blocks, t.trash_page, t.share_group_key, t.num_pages) == (
        j.max_blocks, j.trash_page, j.share_group_key, j.num_pages)
    assert t.paged_kv_bytes() == j.paged_kv_bytes()
    assert t.dense_kv_bytes() == j.dense_kv_bytes()
    assert t.total_pages() == j.total_pages()
    for plen, new in [(1, 1), (5, 3), (max_len // 2, max_len // 2),
                      (max_len - 1, 1)]:
        assert t.blocks_needed(plen, new) == j.blocks_needed(plen, new)
    use = {g.key: g.num_pages // 3 for g in t.groups}
    assert t.memory_stats(use, 123) == j.memory_stats(use, 123)
    assert t.memory_stats({}, 0) == j.memory_stats({}, 0)


def test_cachespec_validation_and_unported_dtypes():
    cfg = reduced(get_config(ARCH))
    with pytest.raises(ValueError, match="power of two"):
        tcache.CacheSpec.from_config(cfg, 2, 64, page_size=6)
    with pytest.raises(ValueError, match="exceeds"):
        tcache.CacheSpec.from_config(cfg, 2, 8, page_size=16)
    with pytest.raises(ValueError, match="kv_dtype"):
        tcache.CacheSpec.from_config(cfg, 2, 64, kv_dtype="int4")


def _caches(slots=3, max_len=64, page_size=8):
    t, j = _specs("reduced", slots, max_len, page_size, 0)
    tc = t.init_paged_cache(torch.device("cpu"))
    jc = j.init_paged_cache()
    rs = np.random.RandomState(0)
    for tl, jl in zip(tc["layers"], jc["layers"]):   # same pool contents
        for key in ("pk", "pv"):
            vals = rs.randn(*tl[key].shape).astype(np.float32)
            tl[key].copy_(torch.as_tensor(vals))
            jl[key] = jnp.asarray(vals)
    return t, j, tc, jc


def _assert_same(tc, jc):
    for k in jc["page_tables"]:
        np.testing.assert_array_equal(tc["page_tables"][k].numpy(),
                                      np.asarray(jc["page_tables"][k]))
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for tl, jl in zip(tc["layers"], jc["layers"]):
        for key in ("pk", "pv"):
            np.testing.assert_array_equal(tl[key].numpy(),
                                          np.asarray(jl[key]))


def test_init_paged_cache_matches_reference():
    t, j = _specs("reduced", 3, 64, 8, 0)
    tc = t.init_paged_cache(torch.device("cpu"))
    _assert_same(tc, j.init_paged_cache())
    assert tc["len"].dtype == torch.int32
    assert all(v.dtype == torch.int32 for v in tc["page_tables"].values())


def test_install_copy_free_match_reference():
    t, j, tc, jc = _caches()
    key = t.groups[0].key
    row = np.array([5, 2, 9, t.trash_page, t.trash_page, t.trash_page,
                    t.trash_page, t.trash_page], np.int32)
    out = tcache.install_slot_rows(t, tc, 1, 13, {key: row})
    assert out is tc                                  # in place
    jc = jcache.install_slot_rows(j, jc, jnp.int32(1), jnp.int32(13),
                                  {key: jnp.asarray(row)})
    _assert_same(tc, jc)
    tcache.copy_shared_page(t, tc, key, 2, 7)
    jc = jcache.copy_shared_page(j, jc, key, jnp.int32(2), jnp.int32(7))
    _assert_same(tc, jc)
    tcache.free_slot_cache(t, tc, 1)
    jc = jcache.free_slot_cache(j, jc, jnp.int32(1))
    _assert_same(tc, jc)


def test_scheduler_admissions_match_reference():
    """The copied scheduler, bound to the port's CacheSpec, makes the
    reference's decisions: rows, prefix hits, copy-on-write, leases."""
    t, j = _specs("reduced", 3, 64, 4, 0, num_pages=20)
    ts = Scheduler(t, defer_radix_insert=False)
    js = JScheduler(j, defer_radix_insert=False)
    head = list(range(1, 11))
    prompts = [head + [50], head + [60, 61], list(range(20, 33)),
               head[:6] + [70]]
    for i, p in enumerate(prompts):
        ts.submit(Request(rid=i, prompt=p, max_new_tokens=6))
        js.submit(JRequest(rid=i, prompt=p, max_new_tokens=6))
    for boundary in range(3):
        ta = list(ts.admissions([0, 1, 2] if boundary == 0 else [1]))
        ja = list(js.admissions([0, 1, 2] if boundary == 0 else [1]))
        assert [(a.slot, a.req.rid, a.suffix_start, a.cow,
                 {k: v.tolist() for k, v in a.rows.items()}) for a in ta] \
            == [(a.slot, a.req.rid, a.suffix_start, a.cow,
                 {k: v.tolist() for k, v in a.rows.items()}) for a in ja]
        ts.release(1)
        js.release(1)
    assert ts.prefix_stats() == js.prefix_stats()
    assert ts.pages_in_use_by_group == js.pages_in_use_by_group
