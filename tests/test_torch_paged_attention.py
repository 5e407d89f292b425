"""PyTorch port: paged decode attention against the JAX reference.

The port's plain version (``repro_torch...ref.paged_attention_ref``) is
held against JAX's ``paged_attention_ref`` over page size x GQA x
window x softcap x S = 1..5, with an all-trash tail and a dead slot in
every batch, and against the JAX Pallas kernel in interpret mode (gated
on the JAX capability probe).  ``paged_decode_step`` is held against
JAX's: pool contents after the write and the output, gather and
pool-direct.  ``paged_attention_split_ref`` (the kernel's split-KV
decomposition: per-split partials, then the log-sum-exp combine) is held
against the unsplit plain version and JAX's oracle on fp32, int8 and
fp8_e4m3 pools, for several split sizes.  The Hopper kernel against its
plain version runs only where ``ops.supported()`` passes (a CUDA
device); here it skips.  All at fp32, atol 1e-5: the two sides only sum
in a different order.
"""

import ctypes
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_attention_ref as jax_ref  # noqa: E402,E501
from repro.kernels.paged_attention import \
    paged_decode_attention as jax_kernel  # noqa: E402
from repro.kernels.paged_attention import supported as jax_supported  # noqa: E402,E501
from repro.models import attention as jatt  # noqa: E402
from repro_torch.kernels.paged_attention import ops  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention_ref  # noqa: E402,E501
from repro_torch.kernels.paged_attention import \
    paged_attention_split_ref  # noqa: E402
from repro_torch.models import attention as tatt  # noqa: E402

ATOL = 1e-5
MODES = {"full": {}, "window": {"window": 12}, "softcap": {"softcap": 20.0}}

_jax_ref = jax.jit(jax_ref, static_argnames=("window", "softcap"))
_jax_step = jax.jit(jatt.paged_decode_step,
                    static_argnames=("window", "softcap", "paged_kernel"))


def _case(s, h, hkv, page_size, nb, seed, dh=16, b=4):
    """numpy inputs: distinct non-trash pages per slot; slot 0 ends in an
    all-trash tail, slot 3 is dead (all trash); cache lengths un-aligned,
    one wrapped past the ring."""
    rs = np.random.RandomState(seed)
    npg = 4 * nb
    q = (rs.randn(b, s, h, dh) * 0.5).astype(np.float32)
    pk = (rs.randn(npg + 1, page_size, hkv, dh) * 0.5).astype(np.float32)
    pv = rs.randn(npg + 1, page_size, hkv, dh).astype(np.float32)
    pt = np.stack([rs.permutation(npg)[:nb] for _ in range(b)])
    pt[0, -max(1, nb // 2):] = npg
    pt[3] = npg
    ring = page_size * nb
    cl = np.array([ring - 3, s + page_size + 1, 2 * ring + 5, 7], np.int32)
    return q, pk, pv, pt.astype(np.int32), cl


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


# page size x GQA as a full grid; the mode cycles Latin-square style so
# every mode meets every page size and every GQA ratio once (each JAX
# shape costs a compile, so the full cube would triple the time)
PAGES = [(4, 4), (8, 8), (16, 2)]
GQAS = [(4, 4), (4, 2), (8, 1)]
SWEEP = [(p, nb, h, hkv, list(MODES)[(i + j) % 3])
         for i, (p, nb) in enumerate(PAGES) for j, (h, hkv) in enumerate(GQAS)]


@pytest.mark.parametrize("page_size,nb,h,hkv,mode", SWEEP)
def test_plain_vs_jax_ref_sweep(page_size, nb, h, hkv, mode):
    kw = dict(MODES[mode])
    if "window" in kw:
        kw["window"] = 3 * page_size
    for s in range(1, 6):
        q, pk, pv, pt, cl = _case(s, h, hkv, page_size, nb,
                                  seed=100 * s + nb + h)
        want = np.asarray(_jax_ref(q, pk, pv, pt, cl, **kw))
        got = paged_attention_ref(*_t(q, pk, pv, pt, cl), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                   err_msg=f"S={s}")
        np.testing.assert_array_equal(got[3], 0.0)      # dead slot


def test_plain_squeezed_query_matches_single_row():
    q, pk, pv, pt, cl = _case(1, 4, 2, 4, 4, seed=5)
    got3 = paged_attention_ref(*_t(q[:, 0], pk, pv, pt, cl))
    got4 = paged_attention_ref(*_t(q, pk, pv, pt, cl))
    assert got3.shape == (4, 4, 16)
    np.testing.assert_array_equal(got3.numpy(), got4[:, 0].numpy())


@pytest.fixture(scope="module")
def jax_interpret():
    if not jax_supported():
        pytest.skip("JAX Pallas interpret-mode probe failed")
    return functools.partial(jax_kernel, interpret=True)


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_plain_vs_jax_interpret_kernel(jax_interpret, s, mode):
    q, pk, pv, pt, cl = _case(s, 4, 2, 4, 4, seed=7 + s)
    kw = MODES[mode]
    want = np.asarray(jax_interpret(q, pk, pv, pt, cl, **kw))
    got = paged_attention_ref(*_t(q, pk, pv, pt, cl), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_wrapper_uses_plain_version_on_cpu():
    q, pk, pv, pt, cl = _t(*_case(3, 4, 2, 8, 4, seed=9))
    before = ops.launches
    got = ops.paged_attention(q, pk, pv, pt, cl, window=10)
    assert ops.launches == before       # no kernel launch for CPU tensors
    np.testing.assert_array_equal(
        got.numpy(), paged_attention_ref(q, pk, pv, pt, cl, window=10).numpy())
    assert not ops.supported() or torch.cuda.is_available()


# ---------------------------------------------------------------------------
# The kernel's split-KV decomposition, in plain PyTorch
# ---------------------------------------------------------------------------

JAX_DTYPES = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}


def _pools(rs, shape, kv_dtype):
    """(jax pool, jax scales), (torch pool, torch scales): fp32 as drawn,
    8-bit quantized by JAX's ``quantize_pages`` (fp8 crosses through its
    bytes)."""
    x = rs.randn(*shape).astype(np.float32)
    if kv_dtype == "fp32":
        return (x, None), (torch.as_tensor(x), None)
    jq, js = jatt.quantize_pages(jnp.asarray(x), JAX_DTYPES[kv_dtype])
    codes = np.asarray(jq)
    if kv_dtype == "fp8_e4m3":
        tq = torch.as_tensor(codes.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    else:
        tq = torch.as_tensor(codes.copy())
    return (jq, js), (tq, torch.as_tensor(np.asarray(js).copy()))


# name: (S, H, Hkv, page size, nb, cache lengths, window, trash runs as
# (slot, first page, pages)).  Slot 3 of "dead_slot" is all trash; "wrap"
# rings hold more tokens than they have room for.
SPLIT_CASES = {
    # 7 pages: splits of 3 leave a ragged last split of 1 page
    "nb_not_split_multiple": (3, 4, 2, 4, 7, [27, 11, 20, 5], None, []),
    # pages 3..5 of slot 0 and 0..2 of slot 1 trash: whole splits of 3
    "trash_only_split": (2, 4, 2, 4, 9, [30, 33, 14, 9], None,
                         [(0, 3, 3), (1, 0, 3)]),
    "dead_slot": (4, 4, 2, 4, 6, [20, 9, 17, 12], None, [(3, 0, 6)]),
    "window_wrap": (3, 4, 2, 4, 6, [50, 31, 24, 70], 9, []),
    # S*G = 15 and 16: either side of the kernel's tile-path boundary
    "rows15": (5, 6, 2, 4, 8, [31, 12, 25, 6], None, [(2, 5, 3)]),
    "rows16": (8, 4, 2, 4, 8, [31, 12, 25, 9], None, [(2, 5, 3)]),
}


def _split_case(name, kv_dtype, seed, dh=16, softcap=None):
    s, h, hkv, page_size, nb, lens, window, trash = SPLIT_CASES[name]
    rs = np.random.RandomState(seed)
    b, npg = len(lens), len(lens) * nb
    q = (rs.randn(b, s, h, dh) * 0.5).astype(np.float32)
    (jk, jks), (tk, tks) = _pools(rs, (npg + 1, page_size, hkv, dh),
                                  kv_dtype)
    (jv, jvs), (tv, tvs) = _pools(rs, (npg + 1, page_size, hkv, dh),
                                  kv_dtype)
    pt = rs.permutation(npg).reshape(b, nb)
    for slot, first, n in trash:
        pt[slot, first:first + n] = npg
    pt = pt.astype(np.int32)
    cl = np.asarray(lens, np.int32)
    kw = dict(window=window, softcap=softcap)
    jax_args = ((q, jk, jv, pt, cl), dict(kw, k_scale=jks, v_scale=jvs))
    torch_args = (_t(q, pt, cl), (tk, tv), dict(kw, k_scale=tks,
                                                 v_scale=tvs))
    return jax_args, torch_args


def _split_call(torch_args, **extra):
    (q, pt, cl), (pk, pv), kw = torch_args
    return q, pk, pv, pt, cl, dict(kw, **extra)


@pytest.mark.parametrize("pages_per_split", [1, 3, 8])
@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_ref_vs_plain_and_jax(name, kv_dtype, pages_per_split):
    (jargs, jkw), targs = _split_case(name, kv_dtype,
                                      seed=len(name) + pages_per_split)
    q, pk, pv, pt, cl, kw = _split_call(targs)
    got = paged_attention_split_ref(q, pk, pv, pt, cl,
                                    pages_per_split=pages_per_split, **kw)
    plain = paged_attention_ref(q, pk, pv, pt, cl, **kw)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=ATOL)
    want = np.asarray(_jax_ref(*jargs, **jkw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # rows with no valid position anywhere: exactly 0, as in the oracle
    dead = (want == 0).all(axis=-1)
    np.testing.assert_array_equal(got.numpy()[dead], 0.0)
    if name == "dead_slot":
        assert dead[3].all()


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_split_ref_softcap_and_squeezed_query(softcap):
    """The softcap enters before the per-split max, and a [B,H,dh] query
    comes back squeezed."""
    _j, targs = _split_case("window_wrap", "fp32", seed=3, softcap=softcap)
    q, pk, pv, pt, cl, kw = _split_call(targs)
    q1 = q[:, -1]
    got = paged_attention_split_ref(q1, pk, pv, pt, cl, pages_per_split=2,
                                    **kw)
    assert got.shape == q1.shape
    np.testing.assert_allclose(
        got.numpy(), paged_attention_ref(q1, pk, pv, pt, cl, **kw).numpy(),
        rtol=0, atol=ATOL)


def test_dead_rows_exactly_zero_in_every_split_size():
    """Slot 0 has no token written (cache length 0) and slot 3 a table of
    trash only: every split of theirs is empty, and the combine's
    0 / max(0, 1e-30) is 0, not a NaN."""
    _j, targs = _split_case("dead_slot", "int8", seed=4)
    q, pk, pv, pt, cl, kw = _split_call(targs)
    cl = cl.clone()
    cl[0] = 0
    for pps in (1, 2, 6):
        got = paged_attention_split_ref(q, pk, pv, pt, cl,
                                        pages_per_split=pps, **kw)
        assert torch.isfinite(got).all()
        assert bool((got[0] == 0).all()) and bool((got[3] == 0).all())


@pytest.mark.parametrize("fn,argtypes", [
    ("int paged_attention_fwd", "FWD_ARGTYPES"),
    ("long long paged_attention_scratch_floats", "SCRATCH_ARGTYPES"),
])
def test_ctypes_signature_matches_c_entry_point(fn, argtypes):
    """The wrapper's argtypes follow the C signatures in the CUDA source:
    the launch with its scratch pointer, and the scratch size the wrapper
    allocates from (the compiler is on the card only)."""
    src = ops.SOURCE.read_text()
    params = re.search(re.escape(fn) + r"\(([^)]*)\)", src).group(1)
    want = []
    for decl in params.split(","):
        decl = " ".join(decl.split())
        if "*" in decl:
            want.append(ctypes.c_void_p)
        elif decl.startswith("float "):
            want.append(ctypes.c_float)
        else:
            assert decl.startswith("int "), decl
            want.append(ctypes.c_int)
    assert getattr(ops, argtypes) == want
    if argtypes == "FWD_ARGTYPES":
        assert "float* scratch" in params


# ---------------------------------------------------------------------------
# paged_decode_step: write through the table, then attend
# ---------------------------------------------------------------------------

def _step_inputs(s, seed, window):
    rs = np.random.RandomState(seed)
    b, h, hkv, dh, page_size = 3, 4, 2, 16, 4
    nb = 4 if window is None else 2
    npg = 12
    pk = rs.randn(npg + 1, page_size, hkv, dh).astype(np.float32)
    pv = rs.randn(npg + 1, page_size, hkv, dh).astype(np.float32)
    pt = np.stack([rs.permutation(npg)[:nb] for _ in range(b)])
    pt[2, -1] = npg                          # reservation ran out
    q = rs.randn(b, s, h, dh).astype(np.float32)
    kk = rs.randn(b, s, hkv, dh).astype(np.float32)
    vv = rs.randn(b, s, hkv, dh).astype(np.float32)
    ring = nb * page_size
    cl = np.array([s + 2, ring - 1, ring + 5], np.int32)
    if s == 1:
        wm = np.array([True, True, False])
    else:                                    # right-aligned pad rows
        n = np.array([s, s - 1, 1])
        wm = np.arange(s)[None, :] >= (s - n)[:, None]
    return q, kk, vv, pk, pv, pt.astype(np.int32), cl, wm


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("paged_kernel", [False, True])
def test_paged_decode_step_vs_jax(s, window, paged_kernel):
    q, kk, vv, pk, pv, pt, cl, wm = _step_inputs(s, 20 + s, window)
    jcache = {"pk": pk, "pv": pv, "pt": pt, "wm": wm}
    jout, jnew = _jax_step(q, kk, vv, jcache, cl, window=window,
                           softcap=None, paged_kernel=paged_kernel)
    tq, tkk, tvv, tpk, tpv, tpt, tcl, twm = _t(q, kk, vv, pk.copy(),
                                               pv.copy(), pt, cl, wm)
    tout, tnew = tatt.paged_decode_step(
        tq, tkk, tvv, {"pk": tpk, "pv": tpv, "pt": tpt, "wm": twm}, tcl,
        window=window, softcap=None, paged_kernel=paged_kernel)
    assert tnew["pk"] is tpk                 # written in place
    trash = pk.shape[0] - 1
    for key in ("pk", "pv"):                 # the trash page is scratch
        np.testing.assert_array_equal(tnew[key].numpy()[:trash],
                                      np.asarray(jnew[key])[:trash])
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# The Hopper kernel against its plain version (needs the card)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_kernel():
    if not ops.supported():
        pytest.skip("needs a CUDA device where the paged-attention kernel "
                    "builds and launches (ops.supported() is False)")
    return torch.device("cuda")


@pytest.mark.usefixtures("cuda_kernel")
@pytest.mark.parametrize("s", [1, 5, 32])
@pytest.mark.parametrize("mode", list(MODES))
def test_cuda_kernel_vs_plain(s, mode):
    q, pk, pv, pt, cl = _case(s, 16, 8, 16, 8, seed=s, dh=128)
    args = [x.cuda() for x in _t(q, pk, pv, pt, cl)]
    before = ops.launches
    got = ops.paged_attention(*args, **MODES[mode])
    want = paged_attention_ref(*args, **MODES[mode])
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    assert bool((got[3] == 0).all())
