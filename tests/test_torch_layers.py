"""PyTorch port: configs, parameter trees and basic layers against the
JAX reference on the same inputs (numpy seeds, fp32, atol 1e-5)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced as jax_reduced  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import model_defs as jax_model_defs  # noqa: E402
from repro.models import module as jm  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import model_defs  # noqa: E402
from repro_torch.models.module import (init_params,  # noqa: E402
                                       params_from_numpy, params_to_numpy)

ATOL = 1e-5
ARCH = "internlm2-1.8b"


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().cpu().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module")
def tiny():
    cfg = reduced(get_config(ARCH))
    jcfg = jax_reduced(jax_get_config(ARCH))
    jp = jm.init_params(jax_model_defs(jcfg), jax.random.PRNGKey(0),
                        jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return cfg, jcfg, jp, tree, params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("make", ["full", "reduced"])
def test_config_fields_match_reference(make):
    if make == "full":
        got, want = get_config(ARCH), jax_get_config(ARCH)
    else:
        got, want = reduced(get_config(ARCH)), jax_reduced(
            jax_get_config(ARCH))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.supports_long_context == want.supports_long_context


def test_unregistered_arch_raises():
    """Every arch of the reference is registered; a name neither package
    knows raises ``KeyError``."""
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-7b")
    with pytest.raises(KeyError, match="unknown arch"):
        jax_get_config("llama-7b")


def test_rmsnorm(tiny):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 5, 64).astype(np.float32) * 3
    p = {"scale": rs.randn(64).astype(np.float32)}
    want = jl.rmsnorm(p, x, 1e-5)
    _close(tl.rmsnorm({"scale": _t(p["scale"])}, _t(x), 1e-5), want)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    """Positions stay below 128: the two frameworks' fp32 ``pow`` differ
    by an ulp in a few frequencies, which grows with the position."""
    rs = np.random.RandomState(1)
    x = rs.randn(2, 5, 4, 16).astype(np.float32)
    pos = rs.randint(0, 128, size=(2, 5)).astype(np.int32)
    _close(tl.rope(_t(x), _t(pos), theta), jl.rope(x, pos, theta))


def test_embed_and_logits(tiny):
    cfg, jcfg, jp, _tree, params = tiny
    rs = np.random.RandomState(2)
    tok = rs.randint(0, cfg.vocab_size, size=(3, 7)).astype(np.int32)
    h = tl.embed(params["embed"], cfg, _t(tok))
    _close(h, jl.embed(jp["embed"], jcfg, tok), atol=0)
    hn = rs.randn(3, 7, cfg.d_model).astype(np.float32)
    lg = tl.logits(params["embed"], cfg, _t(hn))
    assert lg.dtype == torch.float32
    _close(lg, jl.logits(jp["embed"], jcfg, hn))


def test_mlp(tiny):
    cfg, _jcfg, jp, _tree, params = tiny
    x = np.random.RandomState(3).randn(2, 6, cfg.d_model).astype(np.float32)
    lp = params["layers"][0]["ffn"]
    _close(tl.mlp(lp, _t(x)), jl.mlp(jp["layers"][0]["ffn"], x))


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[".".join(parts)] = leaf
    return out


@pytest.mark.parametrize("make", ["reduced", "full_defs"])
def test_weight_bridge_round_trips_every_key(tiny, make):
    if make == "reduced":
        _cfg, _jcfg, _jp, tree, params = tiny
        want = _jax_paths(tree)
        got = params_to_numpy(params)
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
        # full width: same key tree and layouts from the defs alone
        jdefs = jax_model_defs(jax_get_config(ARCH))
        want = {k: tuple(d.shape) for k, d in _jax_paths(
            jax.tree.map(lambda d: d, jdefs, is_leaf=jm.is_def)).items()}
        tdefs = model_defs(get_config(ARCH))
        tflat = {}

        def walk(tree, prefix):
            if isinstance(tree, dict):
                for k, v in tree.items():
                    walk(v, f"{prefix}{k}.")
            elif isinstance(tree, list):
                for i, v in enumerate(tree):
                    walk(v, f"{prefix}{i}.")
            else:
                tflat[prefix[:-1]] = tuple(tree.shape)

        walk(tdefs, "")
        assert tflat == want


def test_init_params_seeded_and_shaped():
    cfg = reduced(get_config(ARCH))
    a = params_to_numpy(init_params(model_defs(cfg), 5, device="cpu"))
    b = params_to_numpy(init_params(model_defs(cfg), 5, device="cpu"))
    c = params_to_numpy(init_params(model_defs(cfg), 6, device="cpu"))
    assert set(a) == set(b) == set(c)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a)
    np.testing.assert_array_equal(a["layers.0.ln1.scale"], 1.0)
    # the reference's fan_in rule: std = 1/sqrt(prod(shape[:-1]))
    std = a["layers.0.mixer.wq"].std()
    assert abs(std * (cfg.d_model * cfg.num_heads) ** 0.5 - 1.0) < 0.1


def test_init_params_needs_a_device_choice_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None means the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(model_defs(reduced(get_config(ARCH))), 0)
