"""PyTorch port, on the card only: the training path's kernels under
autograd.  Every test skips without a CUDA device where the kernels
build and launch (``ops.supported()``); on the card run

    python -m pytest -q tests/test_torch_train_cuda.py

* ``flash_attention``'s gradients (the kernel's forward, the
  explicit-product backward) against ``torch.autograd.grad`` through
  ``flash_attention_ref`` (fp32, TF32 off, 1e-5 x max|want|), causal
  with GQA, a window with a softcap, non-causal Sq != Skv; one backward
  call counted per ``backward``.
* ``moe_gmm``'s dx, dw likewise with partial row counts; dead rows' dx
  exactly 0.
* ``mamba2_scan`` and ``rwkv6_wkv`` (their forward kernels, their
  backward kernels) in both layouts, with and without ``h0`` and a
  ``dh_final``, at S not a multiple of the chunks: every gradient within
  1e-4 x max|want| of ``*_bwd_ref`` and of ``torch.autograd.grad``
  through the plain per-step version, the same bits from two calls, one
  forward and one backward launch a call.
* ``paged_attention`` still refuses to launch under autograd.
* ``DevicePrefetcher`` on the card: steps in order, each batch on the
  device and equal to ``SyntheticLM.batch_at``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as mops  # noqa: E402
from repro_torch.kernels.mamba2_scan.ref import (  # noqa: E402
    mamba2_scan_bwd_ref)
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ref import (  # noqa: E402
    rwkv6_wkv_bwd_ref)

TOL = 1e-5


def _dev(*mods):
    if not all(m.supported() for m in mods):
        pytest.skip("needs a CUDA device where the kernels build and "
                    "launch (ops.supported() is False)")
    return resolve_device("cuda")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("shape,opts", [
    ((2, 8, 4, 77, 77, 64), {}),
    ((1, 4, 2, 130, 130, 128), dict(window=40, softcap=5.0)),
    ((2, 4, 4, 9, 50, 32), dict(causal=False)),
])
def test_flash_attention_grads_vs_plain(shape, opts):
    dev = _dev(fa)
    B, H, Hkv, Sq, Skv, dh = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(B, H, Sq, dh, generator=gen, device=dev) * 2
    k = torch.randn(B, Hkv, Skv, dh, generator=gen, device=dev) * 2
    v = torch.randn(B, Hkv, Skv, dh, generator=gen, device=dev)
    do = torch.randn(B, H, Sq, dh, generator=gen, device=dev)
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = fa.launches, fa.bwd_launches
    got = torch.autograd.grad(fa.flash_attention(*a, **opts), a, do)
    assert (fa.launches - fwd, fa.bwd_launches - bwd) == (1, 1)
    want = torch.autograd.grad(fa.flash_attention_ref(*b, **opts), b, do)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL


def test_moe_gmm_grads_vs_plain():
    dev = _dev(gmm)
    gen = torch.Generator(device=dev).manual_seed(0)
    E, C, D, F = 4, 37, 96, 80
    x = torch.randn(E, C, D, generator=gen, device=dev)
    w = torch.randn(E, D, F, generator=gen, device=dev) / D ** 0.5
    dy = torch.randn(E, C, F, generator=gen, device=dev)
    counts = torch.tensor([37, 0, 1, 20], dtype=torch.int32, device=dev)
    a = [t.clone().requires_grad_() for t in (x, w)]
    b = [t.clone().requires_grad_() for t in (x, w)]
    got = torch.autograd.grad(gmm.moe_gmm(*a, counts), a, dy)
    want = torch.autograd.grad(gmm.moe_gmm_ref(*b, counts), b, dy)
    for g, w_ in zip(got, want):
        assert _rel(g, w_) <= TOL
    dead = torch.arange(C, device=dev)[None, :] >= counts[:, None]
    assert not bool(got[0][dead].any())


SCAN_TOL = 1e-4   # x max|want|: fp32 sums in another order, over S steps


def _scan_case(dev, layout, h0, seed, B=2, H=3, S=77, P=40, N=24):
    """Inputs of one mamba2 call in ``layout`` and the same inputs in the
    plain version's layout (b/c broadcast to every head, a per stream)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa
    if layout == "kernel":
        x, b, c = rn(B * H, S, P), rn(B * H, S, N) * 0.5, rn(B * H, S, N) * 0.5
        dt = rn(B * H, S).abs() * 0.4 + 0.01
        a = -rn(B * H).abs() - 0.05
        hh = rn(B * H, N, P) if h0 else None
        return (x, dt, b, c, a, hh), lambda t: t
    x, bc = rn(B, S, H, P), rn(B, S, 2 * N) * 0.5
    dt = rn(B, S, H).abs() * 0.4 + 0.01
    a_log = torch.log(1.0 + 15.0 * torch.rand(H, generator=gen, device=dev))
    hh = rn(B, H, N, P) if h0 else None
    return (x, dt, bc[..., :N], bc[..., N:], a_log, hh), None


def _scan_plain(mops, x, dt, b, c, a_log, h0):
    """The model layout through the plain per-step version (the CPU
    adapter's broadcast)."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    y, hf = mops.mamba2_scan_ref(
        x.transpose(1, 2).reshape(B * H, S, P),
        dt.transpose(1, 2).reshape(B * H, S),
        b[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        c[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        (-torch.exp(a_log))[None].expand(B, H).reshape(B * H),
        None if h0 is None else h0.reshape(B * H, N, P))
    return y.reshape(B, H, S, P).transpose(1, 2), hf.reshape(B, H, N, P)


@pytest.mark.parametrize("layout,h0,dh", [
    ("kernel", False, False), ("kernel", True, True), ("model", False, True),
    ("model", True, False)])
def test_mamba2_scan_grads_vs_plain(layout, h0, dh):
    dev = _dev(mops)
    call, _ = _scan_case(dev, layout, h0, seed=3)
    op = mops.mamba2_scan if layout == "kernel" else mops.scan_model_layout
    plain = mops.mamba2_scan_ref if layout == "kernel" \
        else lambda *t: _scan_plain(mops, *t)
    leaves = [t for t in call if t is not None]
    y0, h_0 = plain(*call)
    gen = torch.Generator(device=dev).manual_seed(4)
    dy = torch.randn(y0.shape, generator=gen, device=dev)
    dhf = torch.randn(h_0.shape, generator=gen, device=dev) if dh else None

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in leaves]
        it = iter(ins)
        args = [next(it) if t is not None else None for t in call]
        y, hf = fn(*args)
        outs, cots = [y], [dy]
        if dhf is not None:
            outs.append(hf)
            cots.append(dhf)
        return torch.autograd.grad(outs, ins, cots)
    fwd, bwd = mops.launches, mops.bwd_launches
    got = grads(op)
    assert (mops.launches - fwd, mops.bwd_launches - bwd) == (1, 1)
    again = grads(op)
    want = grads(plain)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert _rel(g, w) <= SCAN_TOL
    if layout == "kernel":
        x, dt, b, c, a, hh = call
        ref = [t for t in mamba2_scan_bwd_ref(x, dt, b, c, a, hh, dy,
                                                   dhf) if t is not None]
        for g, w in zip(got, ref):
            assert _rel(g, w) <= SCAN_TOL


def _wkv_case(dev, layout, h0, seed, B=2, H=3, S=77, K=40):
    gen = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *sh: torch.randn(*sh, generator=gen, device=dev)  # noqa
    shape = (B * H, S, K) if layout == "kernel" else (B, S, H, K)
    r, k, v = rn(*shape) * 0.5, rn(*shape) * 0.5, rn(*shape)
    lw = torch.clamp(-rn(*shape).abs() * 2, -5.0, 0.0)
    u = rn(B * H, K) * 0.3 if layout == "kernel" else rn(H, K) * 0.3
    hh = (rn(B * H, K, K) if layout == "kernel" else rn(B, H, K, K)) \
        if h0 else None
    return (r, k, v, lw, u, hh)


def _wkv_plain(wops, r, k, v, lw, u, h0):
    B, S, H, K = r.shape

    def flat(z):
        return z.transpose(1, 2).reshape(B * H, S, K)
    y, hf = wops.rwkv6_wkv_ref(
        flat(r), flat(k), flat(v), flat(lw),
        u[None].expand(B, H, K).reshape(B * H, K),
        None if h0 is None else h0.reshape(B * H, K, K))
    return y.reshape(B, H, S, K).transpose(1, 2), hf.reshape(B, H, K, K)


@pytest.mark.parametrize("layout,h0,dh", [
    ("kernel", False, False), ("kernel", True, True), ("model", False, True),
    ("model", True, False)])
def test_rwkv6_wkv_grads_vs_plain(layout, h0, dh):
    dev = _dev(wops)
    call = _wkv_case(dev, layout, h0, seed=5)
    op = wops.rwkv6_wkv if layout == "kernel" else wops.wkv_model_layout
    plain = wops.rwkv6_wkv_ref if layout == "kernel" \
        else lambda *t: _wkv_plain(wops, *t)
    leaves = [t for t in call if t is not None]
    y0, h_0 = plain(*call)
    gen = torch.Generator(device=dev).manual_seed(6)
    dy = torch.randn(y0.shape, generator=gen, device=dev)
    dhf = torch.randn(h_0.shape, generator=gen, device=dev) if dh else None

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in leaves]
        it = iter(ins)
        args = [next(it) if t is not None else None for t in call]
        y, hf = fn(*args)
        outs, cots = [y], [dy]
        if dhf is not None:
            outs.append(hf)
            cots.append(dhf)
        return torch.autograd.grad(outs, ins, cots)
    fwd, bwd = wops.launches, wops.bwd_launches
    got = grads(op)
    assert (wops.launches - fwd, wops.bwd_launches - bwd) == (1, 1)
    again = grads(op)
    want = grads(plain)
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert _rel(g, w) <= SCAN_TOL
    if layout == "kernel":
        ref = [t for t in rwkv6_wkv_bwd_ref(*call, dy, dhf)
               if t is not None]
        for g, w in zip(got, ref):
            assert _rel(g, w) <= SCAN_TOL


def test_paged_attention_refuses_autograd():
    from repro_torch.kernels.paged_attention import ops
    dev = _dev(ops)
    q = torch.randn(2, 1, 4, 16, device=dev, requires_grad=True)
    pool = torch.randn(9, 4, 2, 16, device=dev)
    table = torch.arange(1, 9, dtype=torch.int32, device=dev).view(2, 4)
    lens = torch.tensor([5, 9], dtype=torch.int32, device=dev)
    before = ops.launches
    with pytest.raises(RuntimeError, match="paged_attention has no "
                                           "backward"):
        ops.paged_attention(q, pool, pool, table, lens)
    assert ops.launches == before


def test_prefetcher_on_the_card():
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DevicePrefetcher, SyntheticLM
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = resolve_device("cuda")
    src = SyntheticLM(reduced(get_config("pixtral-12b")), 2, 16, seed=4)
    pf = DevicePrefetcher(src, device=dev, depth=2, start_step=5)
    got = [next(pf) for _ in range(3)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7]
    for step, batch in got:
        want = src.batch_at(step)
        assert sorted(batch) == sorted(want)
        for key, t in batch.items():
            assert t.device.type == "cuda"
            assert torch.equal(t.cpu(), torch.from_numpy(want[key]))
