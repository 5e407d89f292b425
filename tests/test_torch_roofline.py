"""The port's roofline (``repro_torch.analysis.roofline``) against the
reference's, and the counter behind it (``analysis/count``):

* ``analyze`` equals ``repro.analysis.roofline.analyze`` field for field
  (rtol 1e-12) on the same cost dict, memory stats and hardware numbers
  (the port's ``Hardware`` built from the reference's ``V5E``), the
  reference parsing an HLO fixture whose collectives are the records
  the port is given;
* ``StepCounter``: a matrix product's FLOPs (torch's formula) and bytes
  (each input read once, the output written once), views and ``empty``
  moving nothing, ``copy_`` not reading its destination, the peak of
  live storages (autograd's saved tensors held until the backward), a
  ``scope`` taking its ops, the reference's dictionaries;
* every kernel wrapper on ``meta`` tensors: outputs of the right shape,
  nothing launched, and its ``work(...)`` recorded once a call (the
  backward kernels of the scans too); each ``work`` equals the bound
  formula ``chip_smoke.py`` times the kernel against.
"""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import roofline as jroofline  # noqa: E402
from repro.analysis import hlo  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro_torch.analysis import collectives as coll  # noqa: E402
from repro_torch.analysis import count, roofline  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa  # noqa: E402
from repro_torch.kernels.fused_matmul import ops as fops  # noqa: E402
from repro_torch.kernels.mamba2_scan import ops as mops  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as gmm  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pops  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import ops as wops  # noqa: E402

META = torch.device("meta")
FIXTURE = """
HloModule jit_step
%x = bf16[16,4096,2048]{2,1,0} all-reduce(%y), replica_groups=[16,16]<=[256]
%g = bf16[2048,5784]{0,1} all-gather(%w), replica_groups=[16,16]<=[256]
%rs = bf16[16,256,2048]{2,1,0} reduce-scatter(%z), replica_groups=[64,4]<=[256]
%a2a = bf16[16,256,128]{2,1,0} all-to-all(%p), replica_groups={{0,1,2,3}}
"""


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_formulas",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ the roofline
@pytest.mark.parametrize("arch,shape,chips", [
    ("internlm2-1.8b", "train_4k", 256), ("dbrx-132b", "decode_32k", 512),
    ("zamba2-7b", "prefill_32k", 256)])
def test_analyze_equals_the_reference(arch, shape, chips):
    cost = {"flops": 5.41e13, "bytes accessed": 1.83e12,
            "transcendentals": 3.2e9}
    mem = {"argument_size_in_bytes": 531862536,
           "output_size_in_bytes": 531338260,
           "alias_size_in_bytes": 531338248,
           "temp_size_in_bytes": 81831206920}
    records = [coll.collective(c.op, c.bytes_payload, c.group_size, c.line)
               for c in hlo.parse_collectives(FIXTURE)]
    hw = cost_model.Hardware(**{f.name: getattr(jcost.V5E, f.name)
                                for f in dataclasses.fields(jcost.V5E)})
    kw = dict(arch=arch, mesh_name="single", setting="guideline",
              chips=chips, cost=cost, memory_stats=mem, note="n")
    got = roofline.analyze(get_config(arch), SHAPES[shape],
                           collectives=records, hw=hw, **kw).row()
    want = jroofline.analyze(jget_config(arch), JSHAPES[shape],
                             hlo_text=FIXTURE, hw=jcost.V5E, **kw).row()
    assert got.keys() == want.keys()
    for key, w in want.items():
        if isinstance(w, float):
            assert got[key] == pytest.approx(w, rel=1e-12, abs=0), key
        else:
            assert got[key] == w, key
    assert roofline.memory_stats_dict(mem) == \
        jroofline.memory_stats_dict(type("MA", (), mem)())


def test_analyze_defaults_to_the_h100(tmp_path):
    roof = roofline.analyze(get_config("internlm2-1.8b"), SHAPES["train_4k"],
                            arch="internlm2-1.8b", mesh_name="single",
                            setting="guideline", chips=256,
                            cost={"flops": 989e12, "bytes accessed": 0.0},
                            collectives=[])
    assert roof.compute_s == pytest.approx(1.0)
    assert roof.dominant == "compute" and roof.collective_s == 0.0
    roofline.save(str(tmp_path / "r.json"), roof)
    assert (tmp_path / "r.json").read_text().startswith("{")


# ------------------------------------------------------------- the counter
def test_counter_matmul_views_and_copies():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with count.StepCounter() as c:
        y = a @ b
        y.t()                        # a view: nothing moves
        torch.empty(1000)            # allocated, not written
        z = torch.zeros(8, 4)
        z.copy_(y)                   # reads y, writes z
    assert c.flops == 2 * 8 * 16 * 4
    assert c.families()["matmul"] == {
        "flops": 2 * 8 * 16 * 4, "bytes": 4 * (8 * 16 + 16 * 4 + 8 * 4),
        "calls": 1}
    assert c.ops()["aten.t"]["bytes"] == 0
    assert c.ops()["aten.empty"]["bytes"] == 0
    assert c.ops()["aten.copy_"]["bytes"] == 2 * 4 * 8 * 4
    assert c.cost() == {"flops": c.flops, "bytes accessed": c.bytes,
                        "transcendentals": 0.0}


def test_counter_live_bytes_hold_saved_tensors():
    w = torch.randn(64, 64, device=META, requires_grad=True)
    x = torch.empty(128, 64, device=META)
    with count.StepCounter() as c:
        h = torch.tanh(x @ w)        # tanh keeps its output for backward
        loss = (h * h).sum()
        del h
        held = c.live_bytes
        loss.backward()
    assert held >= 128 * 64 * 4      # the saved output outlives its name
    assert c.transcendentals >= 128 * 64
    assert c.peak_bytes >= held
    mem = c.memory_stats(argument_bytes=10, output_bytes=4, alias_bytes=2)
    assert mem["temp_size_in_bytes"] == c.peak_bytes
    assert (mem["argument_size_in_bytes"], mem["output_size_in_bytes"],
            mem["alias_size_in_bytes"]) == (10, 4, 2)


def test_scope_takes_its_ops():
    a = torch.empty(4, 4, device=META)
    with count.StepCounter() as c:
        with count.scope("bwd"):
            a @ a
            a + a
        count.record_kernel("k", 10.0, 20.0)
    fam = c.families()
    assert fam["bwd"]["calls"] == 1 and fam["bwd"]["flops"] == 128
    assert fam["k"] == {"flops": 10.0, "bytes": 20.0, "calls": 1}
    assert "matmul" not in fam
    assert count.active() is None
    count.record_kernel("k", 1.0, 1.0)          # no counter: a no-op


# ---------------------------------------------------- the kernels on meta
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_flash_and_moe_gmm_on_meta():
    q, k = _meta(2, 8, 100, 64), _meta(2, 4, 100, 64)
    x, w = _meta(3, 4, 40, 32), _meta(4, 32, 48)
    counts = _meta(3, 4, dtype=torch.int32)
    fl, gl = fa.launches, gmm.launches
    with count.StepCounter() as c:
        out = fa.flash_attention(q, k, k, window=30)
        y = gmm.moe_gmm(x, w, counts)
    assert out.shape == q.shape and out.device == META
    assert y.shape == (3, 4, 40, 48)
    assert (fa.launches, gmm.launches) == (fl, gl)
    fam = c.families()
    assert (fam["flash_attention"]["flops"], fam["flash_attention"]["bytes"]
            ) == fa.work(q.shape, k.shape, 4, True, 30)
    assert fam["moe_gmm"]["calls"] == 1
    assert (fam["moe_gmm"]["flops"], fam["moe_gmm"]["bytes"]) == \
        gmm.work(x.shape, w.shape, 4, True)


def test_flash_backward_runs_its_products_on_meta():
    q = _meta(1, 4, 64, 32).requires_grad_()
    k = _meta(1, 2, 64, 32).requires_grad_()
    bl = fa.bwd_launches
    with count.StepCounter() as c:
        fa.flash_attention(q, k, k).sum().backward()
    assert q.grad.shape == q.shape and fa.bwd_launches == bl
    fam = c.families()
    assert fam["flash_attention_bwd"]["calls"] == 1
    assert fam["flash_attention_bwd"]["flops"] > 0


def test_scans_forward_and_backward_on_meta():
    B, S, H, P, N = 2, 100, 3, 16, 8
    xh = _meta(B, S, H, P).requires_grad_()
    dt, bc = _meta(B, S, H), _meta(B, S, 2 * N)
    a_log = _meta(H).requires_grad_()
    fl, bl = mops.launches, mops.bwd_launches
    with count.StepCounter() as c:
        y, hf = mops.scan_model_layout(xh, dt, bc[..., :N], bc[..., N:],
                                       a_log)
        y.sum().backward()
    assert y.shape == xh.shape and hf.shape == (B, H, N, P)
    assert (mops.launches, mops.bwd_launches) == (fl, bl)
    fam = c.families()
    assert (fam["mamba2_scan"]["flops"], fam["mamba2_scan"]["bytes"]) == \
        mops.work(B, H, S, P, N, "model", False)
    assert (fam["mamba2_scan_bwd"]["flops"],
            fam["mamba2_scan_bwd"]["bytes"]) == \
        mops.work_bwd(B, H, S, P, N, H, False)

    K = 16
    r = _meta(B, S, H, K).requires_grad_()
    u = _meta(H, K)
    fl, bl = wops.launches, wops.bwd_launches
    with count.StepCounter() as c:
        y, hf = wops.wkv_model_layout(r, r, r, r, u)
        y.sum().backward()
    assert y.shape == r.shape and hf.shape == (B, H, K, K)
    assert (wops.launches, wops.bwd_launches) == (fl, bl)
    fam = c.families()
    assert fam["rwkv6_wkv"]["calls"] == fam["rwkv6_wkv_bwd"]["calls"] == 1
    assert (fam["rwkv6_wkv"]["flops"], fam["rwkv6_wkv"]["bytes"]) == \
        wops.work(B, H, S, K, H, False)
    # the forward keeps its scratch for the backward, sized as the library
    assert wops.scratch_floats(B, H, S, K) == B * H * 2 * (K * K + K)


def test_paged_and_fused_matmul_on_meta():
    q = _meta(2, 3, 8, 32)
    pool = _meta(9, 4, 2, 32)
    pt, cl = _meta(2, 4, dtype=torch.int32), _meta(2, dtype=torch.int32)
    x, w = _meta(5, 7, dtype=torch.int8), _meta(7, 9)
    pl, ml = pops.launches, fops.launches
    with count.StepCounter() as c:
        out = pops.paged_attention(q, pool, pool, pt, cl, window=10)
        y = fops.fused_matmul(x, w, _meta(5, 1))
    assert out.shape == q.shape and y.shape == (5, 9)
    assert (pops.launches, fops.launches) == (pl, ml)
    fam = c.families()
    assert (fam["paged_attention"]["flops"],
            fam["paged_attention"]["bytes"]) == \
        pops.work(q.shape, pool.shape, pt.shape, 4, False, 10)
    assert fam["fused_matmul"]["flops"] == 2 * 5 * 7 * 9


def test_work_equals_the_chip_smoke_bounds():
    cs = _chip_smoke()
    for case in (dict(B=4, H=16, Hkv=8, Sq=1024, Skv=1024, dh=128),
                 dict(B=1, H=16, Hkv=8, Sq=2048, Skv=2048, dh=256,
                      window=1024),
                 dict(B=8, H=16, Hkv=16, Sq=16, Skv=1500, dh=64,
                      causal=False)):
        nbytes, flops, _live = cs.flash_need(**case)
        assert fa.work((case["B"], case["H"], case["Sq"], case["dh"]),
                       (case["B"], case["Hkv"], case["Skv"], case["dh"]), 4,
                       case.get("causal", True), case.get("window")) == \
            (flops, nbytes)
    for h0 in (False, True):
        nbytes, flops, _ = cs.mamba_need(4, 112, 1000, 64, 64, "model", h0,
                                         mops.CHUNK_ROWS)
        assert mops.work(4, 112, 1000, 64, 64, "model", h0) == \
            (flops, nbytes)
        nbytes, flops, _ = cs.rwkv_need(4, 64, 1000, 64, "model", h0,
                                        wops.CHUNK_ROWS, wops.SUB_ROWS)
        assert wops.work(4, 64, 1000, 64, 64, h0) == (flops, nbytes)
        nbytes, _, flops = cs.scan_bwd_need("mamba2_scan", 4, 112, 1000, h0,
                                            P=64, N=64)
        assert mops.work_bwd(4, 112, 1000, 64, 64, 112, h0) == \
            (flops, nbytes)
        nbytes, _, flops = cs.scan_bwd_need("rwkv6_wkv", 4, 64, 1000, h0,
                                            K=64)
        assert wops.work_bwd(4, 64, 1000, 64, 64, h0) == (flops, nbytes)
