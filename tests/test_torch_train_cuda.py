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
* ``mamba2_scan`` and ``rwkv6_wkv`` refuse to launch under autograd and
  launch under ``torch.no_grad()``.
* ``DevicePrefetcher`` on the card: steps in order, each batch on the
  device and equal to ``SyntheticLM.batch_at``.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as mops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wops  # noqa: E402

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


def test_scans_refuse_autograd():
    dev = _dev(mops, wops)
    x = torch.randn(2, 16, 8, device=dev, requires_grad=True)
    dt = torch.rand(2, 16, device=dev)
    b = torch.randn(2, 16, 4, device=dev)
    a = -torch.rand(2, device=dev)
    before = (mops.launches, wops.launches)
    with pytest.raises(RuntimeError, match="A15"):
        mops.mamba2_scan(x, dt, b, b.clone(), a)
    r = torch.randn(2, 16, 8, device=dev, requires_grad=True)
    lw = -torch.rand(2, 16, 8, device=dev)
    u = torch.randn(2, 8, device=dev)
    with pytest.raises(RuntimeError, match="A15"):
        wops.rwkv6_wkv(r, r.detach(), r.detach(), lw, u)
    assert (mops.launches, wops.launches) == before
    with torch.no_grad():
        mops.mamba2_scan(x, dt, b, b.clone(), a)
        wops.rwkv6_wkv(r, r, r, lw, u)
    assert (mops.launches, wops.launches) == (before[0] + 1, before[1] + 1)


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
