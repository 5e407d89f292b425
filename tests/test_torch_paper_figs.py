"""The port's paper figures on the CPU (``repro_torch.benchmarks``):

* fig04's cost-model half, fig06 and fig18 emit the reference scripts'
  row names (``benchmarks/fig04_scheduling.py``, ``fig06_heatmap.py``,
  ``fig18_guideline_eval.py``, run here on the CPU), and fig18 reports a
  row for every cell with the guideline fitting wherever the optimum
  fits;
* fig04's MoE half at the reference's reduced shape: ``moe.apply``
  equals ``apply_sync_schedule`` within 1e-5, and a plain run of fig04
  does both halves;
* fig01 at ``reduced(internlm2-1.8b)`` and fig13 at n = 256 emit finite
  rows;
* the aggregator ``repro_torch.benchmarks.run`` runs the selected
  figures (fig16 without dry-run rows: its cost-model half only).
"""

import contextlib
import functools
import io
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import cost_model as jcost_model  # noqa: E402
from repro_torch.benchmarks import fig01_breakdown as fig01  # noqa: E402
from repro_torch.benchmarks import fig04_scheduling as fig04  # noqa: E402
from repro_torch.benchmarks import fig06_heatmap as fig06  # noqa: E402
from repro_torch.benchmarks import fig13_library as fig13  # noqa: E402
from repro_torch.benchmarks import fig16_multipod as fig16  # noqa: E402
from repro_torch.benchmarks import fig18_guideline_eval as fig18  # noqa: E402
from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _rows(text: str) -> dict:
    """CSV rows ``name,us_per_call,derived`` -> {name: (us, derived)}."""
    out = {}
    for line in text.splitlines():
        parts = line.split(",", 2)
        if len(parts) == 3 and parts[0].startswith("fig"):
            out[parts[0]] = (float(parts[1]), parts[2])
    return out


def _captured(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, _rows(buf.getvalue())


@pytest.fixture(scope="module")
def reference_rows():
    """The reference scripts' rows (their ``main()`` on the CPU); its
    param count memoized, as the port's is (a pure function of the
    frozen config)."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import fig04_scheduling as jfig04
    from benchmarks import fig06_heatmap as jfig06
    from benchmarks import fig18_guideline_eval as jfig18
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcost_model, "model_param_count",
                   functools.lru_cache(maxsize=None)(
                       jcost_model.model_param_count))
        return {name: _captured(mod.main)[1] for name, mod in
                (("fig04", jfig04), ("fig06", jfig06), ("fig18", jfig18))}


def test_fig04_plain_run_does_both_halves(reference_rows):
    rec, rows = _captured(fig04.main, ["--device", "cpu"])
    want = reference_rows["fig04"]
    assert sorted(rows) == sorted(want)
    assert rec["moe_layer"]["calls"] == fig04.MOE_WARMUP + fig04.MOE_ITERS
    assert rec["moe_layer"]["x_shape"] == [4, 512, 128]
    assert len(rec["prod"]) == len(ARCH_IDS)
    for us, _ in rows.values():
        assert math.isfinite(us) and us > 0


def test_fig04_moe_half_async_equals_sync():
    cfg, params, x = fig04.moe_layer_inputs("cpu")
    assert (cfg.d_model, cfg.d_ff, cfg.moe.num_experts, cfg.moe.top_k) == \
        (128, 256, 8, 2)
    with torch.no_grad():
        y_async, _ = moe.apply(params, x, cfg)
        y_sync, _ = moe.apply_sync_schedule(params, x, cfg)
    assert y_async.shape == x.shape
    assert float(y_async.abs().max()) > 0
    torch.testing.assert_close(y_async, y_sync, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fig", ["fig06", "fig18"])
def test_analytic_figs_emit_reference_rows(reference_rows, fig):
    mod = {"fig06": fig06, "fig18": fig18}[fig]
    _, rows = _captured(mod.main, [])
    assert sorted(rows) == sorted(reference_rows[fig])


def test_fig18_guideline_fits_where_optimum_fits():
    res, rows = _captured(fig18.main, [])
    assert len(res["rows"]) == len(fig18.FIG18_SHAPES) * len(ARCH_IDS)
    assert res["summary"]["cells"] == len(res["rows"])
    for row in res["rows"]:
        if row["global_optimum"]["fits"]:
            assert row["guideline"]["fits"], row["name"]
        assert row["global_optimum"]["step_s"] <= \
            row["guideline"]["step_s"] or not row["guideline"]["fits"]
    assert "fig18.summary.geomean" in rows


def test_fig01_reduced_emits_finite_rows():
    rec, rows = _captured(fig01.main, ["--device", "cpu"])
    assert sorted(rows) == ["fig01.first_step", "fig01.steady_step"]
    assert rec["loss_finite"] and rec["forwards"] == fig01.ITERS + 2
    assert rec["arch"] == "internlm2-1.8b-smoke"
    for us, derived in rows.values():
        assert math.isfinite(us) and us > 0
    pct = float(rows["fig01.steady_step"][1].split("=")[1])
    assert 0 <= pct <= 100


def test_fig13_emits_finite_rows(monkeypatch):
    monkeypatch.setattr(fig13, "SIZES", (256,))
    res, rows = _captured(fig13.main, ["--device", "cpu"])
    assert sorted(rows) == ["fig13.naive_256", "fig13.numpy_256",
                            "fig13.torch_256"]
    for r in res:
        assert math.isfinite(r["gflops"]) and r["gflops"] > 0


def test_run_selects_one_figure(capsys, tmp_path, monkeypatch):
    monkeypatch.setattr(fig16, "RESULTS", tmp_path)   # no dry-run rows
    assert bench_run.main(["fig06", "fig16"]) == 0
    out, err = capsys.readouterr()
    rows = _rows(out)
    assert out.splitlines()[0] == "name,us_per_call,derived"
    assert rows and all(name.startswith(("fig06.", "fig16.model."))
                        for name in rows)
    assert "fig16.model.dbrx-132b" in rows
    assert "# fig16_multipod done in" in err
