"""PyTorch port: the MoE FFN family against the JAX reference.

Inputs and weights are made once with numpy (or by the reference's
``init_params``) and handed to both packages.  Tolerances:

* configs equal field for field; the router's expert ids and the dispatch
  indices bitwise equal, its probabilities at 1e-6 (the router's fp32
  product sums in another order);
* ``moe_gmm_ref`` against the JAX oracle at atol/rtol 1e-5 in fp32 (only
  the einsum's summation order differs) and one bf16 ulp (2**-7 relative)
  in bf16, where the fp32 sums are rounded to bf16 afterwards, and against
  the Pallas kernel (interpret mode) on its valid rows at the reference's
  own ``tests/test_kernels.py`` tolerances (2e-4 fp32, 2e-2 bf16);
* ``apply`` at atol 1e-5 (fp32 products of width d_ff, then a k-term sum);
* teacher-forced ``forward_verify`` logits at atol 1e-4, as for the dense
  model (``tests/test_torch_engine.py``);
* the fused engine's greedy tokens identical to the JAX ``Engine``'s, with
  and without dropped tokens (pad rows of the chunk take capacity too).

A routing near-tie that flips an expert would show as a large error: the
failing assertion then prints the smallest top-k router margin.
Kernel-vs-plain cases need the card and skip here."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as jax_moe_gmm  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm_ref as jax_moe_gmm_ref  # noqa: E402
from repro.models import forward_verify as jax_forward_verify  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serve import cache as jcache  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.moe_gmm import ops  # noqa: E402
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref  # noqa: E402
from repro_torch.models import forward_verify, model_defs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.module import (params_from_numpy,  # noqa: E402
                                       params_to_numpy)
from repro_torch.serve import cache as tcache  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCHS = ["dbrx-132b", "grok-1-314b"]
PROMPTS = [[(7 * j + i) % 200 + 1 for j in range(3 + 9 * i)]
           for i in range(5)]            # lengths 3, 12, 21, 30, 39
ENGINE_KW = dict(slots=3, max_len=96, sync_interval=4, seed=0)
_jax_verify = jax.jit(jax_forward_verify,
                      static_argnames=("cfg", "paged_kernel", "spec_slack"))


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _with_capacity(cfg, factor):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=factor))


def _router_margin(x2d: np.ndarray, router: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th router probability over
    the tokens: the distance to a flipped expert."""
    lg = x2d.astype(np.float64) @ router.astype(np.float64)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if s.shape[1] > k else 1.0


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_match_reference(arch, make):
    if make == "full":
        got, want = get_config(arch), jax_get_config(arch)
    else:
        got, want = reduced(get_config(arch)), jax_reduced(
            jax_get_config(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim


def _flat_defs(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_defs(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_defs(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tuple(tree.shape)
    return out


def eval_path(tree, dotted):
    for part in dotted.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("make", ["reduced", "full_defs"])
def test_weight_bridge_carries_moe_params(make):
    """``ffn.router``, ``ffn.w_gate``, ``ffn.w_up`` and ``ffn.w_down`` come
    over key for key in the reference's layouts (router [d,E], experts
    [E,d,F] and [E,F,d]); the router stays fp32."""
    if make == "reduced":
        jcfg = jax_reduced(jax_get_config("dbrx-132b"), experts=8)
        jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                            jnp.float32)
        tree = jax.tree.map(np.asarray, jp)
        got = params_to_numpy(params_from_numpy(tree, device="cpu"))
        want = _flat_defs(tree)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(
                got[k], np.asarray(eval_path(tree, k)), err_msg=k)
        assert got["layers.0.ffn.router"].shape == (64, 8)
        assert got["layers.1.ffn.w_down"].shape == (8, 128, 64)
    else:
        cfg = get_config("dbrx-132b")
        want = _flat_defs(jax.tree.map(
            lambda d: d, jax_model_defs(jax_get_config("dbrx-132b")),
            is_leaf=jm.is_def))
        got = _flat_defs(model_defs(cfg))
        assert got == want
        assert got["layers.39.ffn.w_gate"] == (16, 6144, 10752)
        assert got["layers.0.ffn.w_down"] == (16, 10752, 6144)
        assert model_defs(cfg)["layers"][0]["ffn"]["router"].dtype \
            == torch.float32


# ---------------------------------------------------------------------------
# the grouped matmul's plain version
# ---------------------------------------------------------------------------

GMM_SHAPES = [(4, 64, 128, 128), (8, 32, 64, 256), (4, 80, 64, 128)]


def _gmm_inputs(e, c, d, f, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(e, c, d).astype(np.float32)
    w = (rs.randn(e, d, f) / np.sqrt(d)).astype(np.float32)
    counts = np.asarray([c, c // 2, 0, 1] * (e // 4), np.int32)
    return x, w, counts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f", GMM_SHAPES)
def test_moe_gmm_ref_matches_reference(e, c, d, f, dtype):
    x, w, counts = _gmm_inputs(e, c, d, f, seed=c + f)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.as_tensor(x).to(tdt), torch.as_tensor(w).to(tdt)
    # the two casts round the same fp32 values to the same bf16 bits
    np.testing.assert_array_equal(np.asarray(jx, np.float32),
                                  tx.float().numpy())
    tc = torch.as_tensor(counts)
    for rc, jrc in ((None, None), (tc, jnp.asarray(counts))):
        got = moe_gmm_ref(tx, tw, rc)
        assert got.dtype == tdt and got.shape == (e, c, f)
        want = np.asarray(jax_moe_gmm_ref(jx, jw, jrc), np.float32)
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
            else dict(rtol=2 ** -7, atol=2 ** -7)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    # padding rows exactly 0, as the oracle says
    valid = np.arange(c)[None, :, None] < counts[:, None, None]
    assert not got.float().numpy()[~np.broadcast_to(valid, got.shape)].any()
    # the Pallas kernel (interpret mode) on its valid rows
    kern = np.asarray(jax_moe_gmm(jx, jw, jnp.asarray(counts), block_m=32,
                                  block_n=64, block_k=64, interpret=True),
                      np.float32)
    tol = dict(rtol=2e-4, atol=2e-4) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy() * valid, kern * valid,
                               **tol)


def test_moe_gmm_ref_group_dimension():
    """x [G,E,C,D] with counts [G,E] and w shared: each group equals the
    ungrouped call on its own slice."""
    rs = np.random.RandomState(3)
    x = torch.as_tensor(rs.randn(2, 4, 16, 24).astype(np.float32))
    w = torch.as_tensor(rs.randn(4, 24, 40).astype(np.float32))
    counts = torch.as_tensor(np.asarray([[16, 3, 0, 9], [1, 16, 8, 0]],
                                        np.int32))
    got = moe_gmm_ref(x, w, counts)
    assert got.shape == (2, 4, 16, 40)
    for gi in range(2):
        want = jax_moe_gmm_ref(jnp.asarray(x[gi].numpy()),
                               jnp.asarray(w.numpy()),
                               jnp.asarray(counts[gi].numpy()))
        np.testing.assert_allclose(got[gi].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_moe_gmm_wrapper_on_cpu_runs_the_plain_version():
    x, w, counts = _gmm_inputs(4, 8, 16, 8, seed=0)
    tx, tw, tc = _t(x, w, counts)
    before = ops.launches
    torch.testing.assert_close(ops.moe_gmm(tx, tw, tc),
                               moe_gmm_ref(tx, tw, tc), rtol=0, atol=0)
    assert ops.launches == before


def test_moe_gmm_wrapper_checks():
    x, w, counts = _gmm_inputs(4, 8, 16, 8, seed=0)
    tx, tw, tc = _t(x, w, counts)
    x4, c2 = tx[None], tc[None]
    ops._check(x4, tw, c2)
    ops._check(x4, tw, None)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check(x4, tw.double(), c2)
    with pytest.raises(TypeError, match="one dtype"):
        ops._check(x4.half(), tw.half(), c2)
    with pytest.raises(TypeError, match="int32"):
        ops._check(x4, tw, c2.long())
    with pytest.raises(ValueError, match="contiguous"):
        ops._check(x4, tw.transpose(1, 2).contiguous().transpose(1, 2), c2)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops._check(x4, tw[:, :8].contiguous(), c2)
    with pytest.raises(ValueError, match="row_counts must be"):
        ops._check(x4, tw, tc)


def test_ctypes_signature_matches_c_entry_point():
    """The wrapper's argtypes follow the C signature in the CUDA source
    (the compiler is on the card only; a wrong arity would be found there
    at the first launch)."""
    import ctypes
    import re

    src = ops.SOURCE.read_text()
    params = re.search(r"int moe_gmm_fwd\(([^)]*)\)", src).group(1)
    want = []
    for decl in params.split(","):
        decl = " ".join(decl.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    assert ops.FWD_ARGTYPES == want


# ---------------------------------------------------------------------------
# router, dispatch and the MoE layer
# ---------------------------------------------------------------------------

def _moe_case(experts=8, top_k=4, factor=None, b=2, s=24, d=32, f=48,
              seed=0):
    jcfg = jax_reduced(jax_get_config("dbrx-132b"), d_model=d, d_ff=f,
                       experts=experts)
    cfg = reduced(get_config("dbrx-132b"), d_model=d, d_ff=f,
                  experts=experts)
    if top_k != jcfg.moe.top_k or factor is not None:
        moe_kw = dict(top_k=top_k)
        if factor is not None:
            moe_kw["capacity_factor"] = factor
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_kw))
    jp = jm.init_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(seed),
                        jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, device="cpu")
    x = np.random.RandomState(seed).randn(b, s, d).astype(np.float32)
    return cfg, jcfg, tp, jp, tree, x


def test_route_and_dispatch_indices_match():
    cfg, jcfg, tp, jp, tree, x = _moe_case(factor=1.0)
    x2d = x.reshape(-1, x.shape[-1])
    tpb, teb, taux = tmoe.route(tp, torch.as_tensor(x2d), cfg.moe)
    jpb, jeb, jaux = jmoe.route(jp, jnp.asarray(x2d), jcfg.moe)
    margin = _router_margin(x2d, tree["router"], cfg.moe.top_k)
    np.testing.assert_array_equal(
        teb.numpy(), np.asarray(jeb),
        err_msg=f"expert ids differ; smallest router margin {margin:.3g}")
    np.testing.assert_allclose(tpb.numpy(), np.asarray(jpb), rtol=0,
                               atol=1e-6)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    # dispatch: bitwise on the same expert ids, for several capacities
    e = cfg.moe.num_experts
    g = x2d.shape[0]
    for cap in (1, 3, tmoe._capacity(g, cfg.moe), g):
        ts, tk = tmoe._dispatch_indices(teb, e, cap)
        js, jk = jmoe._dispatch_indices(jnp.asarray(jeb), e, cap)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    # with leading group dimensions, as apply calls it
    groups = teb.reshape(2, g // 2, -1)
    ts, tk = tmoe._dispatch_indices(groups, e, 5)
    for gi in range(2):
        js, jk = jmoe._dispatch_indices(jnp.asarray(groups[gi].numpy()),
                                        e, 5)
        np.testing.assert_array_equal(ts[gi].numpy(), np.asarray(js))
        np.testing.assert_array_equal(tk[gi].numpy(), np.asarray(jk))


@pytest.mark.parametrize("setting", ["dropless", "drops", "two_groups",
                                     "sync_schedule"])
def test_apply_matches_reference(setting):
    """dropless: the reduced configs' capacity (e/k + 0.01); drops:
    capacity_factor 1.25 with 8 experts top-4; two_groups: T = 8192 tokens
    at d = 64, so ``_num_groups`` is 2 (4 experts top-2 at capacity_factor
    1.0, so some expert overflows); sync_schedule: the per-expert loop
    against the batched layer and against the reference's loop."""
    kw = {"dropless": {}, "drops": dict(factor=1.25),
          "two_groups": dict(b=2, s=4096, d=64, f=64, experts=4, top_k=2,
                             factor=1.0),
          "sync_schedule": dict(factor=1.25)}[setting]
    cfg, jcfg, tp, jp, tree, x = _moe_case(**kw)
    b, s, d = x.shape
    assert tmoe._num_groups(b * s) == jmoe._num_groups(b * s) \
        == (2 if setting == "two_groups" else 1)
    margin = _router_margin(x.reshape(-1, d), tree["router"],
                            cfg.moe.top_k)
    msg = f"smallest router margin {margin:.3g}"
    ty, taux = tmoe.apply(tp, torch.as_tensor(x), cfg)
    jy, jaux = jmoe.apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5, err_msg=msg)
    for key in jaux:
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    dropped = float(taux["dropped_fraction"])
    if setting == "dropless":
        assert dropped == 0.0
    else:
        assert dropped > 0.0, "the case meant to drop tokens dropped none"
    if setting == "sync_schedule":
        sy, saux = tmoe.apply_sync_schedule(tp, torch.as_tensor(x), cfg)
        np.testing.assert_allclose(sy.numpy(), ty.numpy(), rtol=0,
                                   atol=1e-5, err_msg=msg)
        jsy, _ = jmoe.apply_sync_schedule(jp, jnp.asarray(x), jcfg)
        np.testing.assert_allclose(sy.numpy(), np.asarray(jsy), rtol=0,
                                   atol=1e-5, err_msg=msg)
        assert set(saux) == {"load_balance_loss", "router_entropy"}


# ---------------------------------------------------------------------------
# the model and the fused engine
# ---------------------------------------------------------------------------

def _model(arch, factor=None):
    kw = dict(experts=8) if arch == "dbrx-132b" else {}
    jcfg = jax_reduced(jax_get_config(arch), **kw)
    cfg = reduced(get_config(arch), **kw)
    if factor is not None:
        jcfg, cfg = _with_capacity(jcfg, factor), _with_capacity(cfg, factor)
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, tp, jcfg, jp


@pytest.fixture(scope="module")
def models():
    return {("dbrx-132b", None): _model("dbrx-132b"),
            ("dbrx-132b", 1.25): _model("dbrx-132b", 1.25),
            ("grok-1-314b", None): _model("grok-1-314b")}


@pytest.mark.parametrize("paged_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_verify_teacher_forced(models, arch, paged_kernel):
    """reduced dbrx (8 experts, top-4) and reduced grok (attention
    softcap 30, embed_scale): the same tokens through the same cache, on
    the same attention path in both packages.  Pad rows are compared too:
    their hidden states depend on the path (the kernel path masks them by
    row index, the gather path by clipped position), and in an MoE layer
    with a capacity they take expert capacity from the real rows."""
    cfg, tp, jcfg, jp = models[(arch, None)]
    if arch == "grok-1-314b":
        assert cfg.attn_softcap == 30.0 and cfg.embed_scale
    else:
        assert (cfg.moe.num_experts, cfg.moe.top_k) == (8, 4)
    t = tcache.CacheSpec.from_config(cfg, 3, 64, page_size=8)
    j = jcache.CacheSpec.from_config(jcfg, 3, 64, page_size=8)
    tc, jc = t.init_paged_cache(torch.device("cpu")), j.init_paged_cache()
    key = t.groups[0].key
    rows = np.full((3, t.groups[0].ring_blocks), t.trash_page, np.int32)
    rows[0, :4] = [3, 7, 1, 12]
    rows[1, :3] = [0, 5, 9]
    tc["page_tables"][key].copy_(torch.as_tensor(rows))
    jc["page_tables"] = {key: jnp.asarray(rows)}
    rs = np.random.RandomState(0)
    S = 8
    col = np.arange(S)[None, :]
    for n_rows in ([8, 5, 1], [8, 8, 1], [3, 8, 1]):
        n = np.array(n_rows, np.int32)
        wm = (col >= (S - n)[:, None]) & np.array([1, 1, 0], bool)[:, None]
        toks = rs.randint(1, cfg.vocab_size, size=(3, S)).astype(np.int32)
        jl, jc = _jax_verify(jp, jcfg, jnp.asarray(toks), jc,
                             write_mask=jnp.asarray(wm),
                             paged_kernel=paged_kernel,
                             n_rows=jnp.asarray(n))
        tl, tc = forward_verify(tp, cfg, torch.as_tensor(toks), tc,
                                write_mask=torch.as_tensor(wm),
                                paged_kernel=paged_kernel,
                                n_rows=torch.as_tensor(n))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2],
                                   rtol=0, atol=1e-4)
        jc = dict(jc, len=jc["len"] + jnp.asarray(n * [1, 1, 0]))
        tc = dict(tc, len=tc["len"] + torch.as_tensor(n * [1, 1, 0]))


def _serve(eng, prompts, max_new):
    for i, p in enumerate(prompts):
        eng.submit((Request if isinstance(eng, Engine) else JRequest)(
            rid=i, prompt=list(p), max_new_tokens=max_new))
    done = eng.run(max_steps=50_000)
    return {r.rid: list(r.out_tokens) for r in done}


@pytest.fixture(scope="module")
def jax_runs(models):
    out = {}
    for factor in (None, 1.25):
        _cfg, _tp, jcfg, jp = models[("dbrx-132b", factor)]
        for budget in (3, 8):
            eng = JEngine(jcfg, jp, prefill_budget=budget, **ENGINE_KW)
            assert eng.chunked_prefill
            out[(factor, budget)] = _serve(eng, PROMPTS, 8)
    return out


@pytest.mark.parametrize("factor", [None, 1.25],
                         ids=["dropless", "capacity1.25"])
@pytest.mark.parametrize("budget", [3, 8])
def test_fused_engine_token_parity(models, jax_runs, budget, factor,
                                   monkeypatch):
    """Greedy tokens of the port's fused engine equal the JAX Engine's on
    reduced dbrx.  At capacity_factor 1.25 the chunk's pad rows are routed
    and take capacity, tokens are dropped (checked on the way), and the
    dispatch must match the reference's exactly."""
    cfg, tp, _jcfg, _jp = models[("dbrx-132b", factor)]
    dropped = []
    apply = tmoe.apply

    def spy(p, x, c, act="silu"):
        y, aux = apply(p, x, c, act)
        dropped.append(float(aux["dropped_fraction"]))
        return y, aux

    monkeypatch.setattr(tmoe, "apply", spy)
    eng = Engine(cfg, tp, prefill_budget=budget, device="cpu", **ENGINE_KW)
    assert eng.chunked_prefill and not eng.paged_kernel
    assert _serve(eng, PROMPTS, 8) == jax_runs[(factor, budget)]
    assert eng.leaked_pages() == 0
    assert dropped and (max(dropped) > 0) == (factor is not None), \
        max(dropped)


@pytest.mark.parametrize("arch,factor", [
    ("dbrx-132b", None), ("dbrx-132b", 1.25), ("grok-1-314b", None)],
    ids=["dbrx-dropless", "dbrx-capacity1.25", "grok-dropless"])
def test_legacy_engine_token_parity(models, arch, factor, monkeypatch):
    """Greedy tokens of the port's two-executable engine
    (``chunked_prefill=False``) equal the JAX legacy Engine's on reduced
    dbrx and grok.  A bucketed prefill's pad rows are routed and, at
    capacity_factor 1.25, take capacity from the prompt's rows; so do the
    idle slots' rows of the S = 1 decode chunk."""
    cfg, tp, jcfg, jp = models[(arch, factor)]
    dropped = []
    apply = tmoe.apply

    def spy(p, x, c, act="silu"):
        y, aux = apply(p, x, c, act)
        dropped.append(float(aux["dropped_fraction"]))
        return y, aux

    monkeypatch.setattr(tmoe, "apply", spy)
    eng = Engine(cfg, tp, chunked_prefill=False, device="cpu", **ENGINE_KW)
    jeng = JEngine(jcfg, jp, chunked_prefill=False, **ENGINE_KW)
    assert not eng.chunked_prefill and not jeng.chunked_prefill
    assert eng.paged_kernel == jeng.paged_kernel
    assert _serve(eng, PROMPTS, 8) == _serve(jeng, PROMPTS, 8)
    assert eng.leaked_pages() == 0
    assert dropped and (max(dropped) > 0) == (factor is not None), \
        max(dropped)


# ---------------------------------------------------------------------------
# The Hopper kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_kernel():
    if not ops.supported():
        pytest.skip("needs a CUDA device where the moe_gmm kernel builds "
                    "and launches (ops.supported() is False)")
    return torch.device("cuda")


@pytest.mark.usefixtures("cuda_kernel")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("e,c,d,f,groups", [(4, 64, 128, 128, 1),
                                            (4, 80, 200, 72, 2),
                                            (8, 37, 64, 256, 1)])
def test_cuda_kernel_vs_plain(e, c, d, f, groups, dtype):
    rs = np.random.RandomState(c)
    tdt = getattr(torch, dtype)
    x = torch.as_tensor(rs.randn(groups, e, c, d).astype(np.float32)).to(
        "cuda", tdt)
    w = torch.as_tensor((rs.randn(e, d, f) / np.sqrt(d)).astype(
        np.float32)).to("cuda", tdt)
    counts = torch.as_tensor(np.asarray(
        [[c, c // 2, 0, 1] * (e // 4)] * groups, np.int32)).cuda()
    for rc in (counts, None):
        before = ops.launches
        got = ops.moe_gmm(x, w, rc)
        want = moe_gmm_ref(x, w, rc)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        tol = 1e-4 if dtype == "float32" else 2e-2 * float(
            want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol
    got = ops.moe_gmm(x, w, counts)
    pad = torch.arange(c, device="cuda")[None, None, :] >= counts[..., None]
    assert not bool(got[pad].any())


def test_moe_layer_on_the_card_matches_cpu(cuda_kernel):
    cfg, _jcfg, tp, _jp, tree, x = _moe_case(factor=1.25)
    before = ops.launches
    y, _ = tmoe.apply(params_from_numpy(tree, device="cuda"),
                      torch.as_tensor(x).cuda(), cfg)
    assert ops.launches == before + 3
    want, _ = tmoe.apply(tp, torch.as_tensor(x), cfg)
    torch.testing.assert_close(y.cpu(), want, rtol=0, atol=1e-4)
