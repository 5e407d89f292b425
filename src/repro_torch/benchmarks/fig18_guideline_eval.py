"""Paper Fig. 18 + Table 2: the guideline vs the TensorFlow and Intel
recommended settings vs the exhaustively swept global optimum, across
every architecture and shape (counterpart of
``benchmarks/fig18_guideline_eval.py``).

    python -m repro_torch.benchmarks.fig18_guideline_eval

Cost-model step times on the production mesh with the port's
``Hardware()`` (the card's data-sheet figures).  Analytic: no device
runs.
"""

from __future__ import annotations

from repro_torch.benchmarks.common import emit
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.core import autotune

FIG18_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _score(r) -> float:
    """A setting that does not fit memory is unusable (the paper's
    baselines never ran out; ours can at 100B+ scale)."""
    return r.step_s if r.fits else float("inf")


def _geomean(xs) -> float:
    p = 1.0
    for x in xs:
        p *= x
    return p ** (1 / len(xs))


def main(argv=None) -> dict:
    """Emits the reference's rows; returns ``{"rows": [...], "summary":
    {...}}``, each row with the four settings' plans, times and fits."""
    del argv
    gaps, tf_sp, intel_sp = [], [], []
    tf_oom = intel_oom = 0
    rows = []
    for shape_name in FIG18_SHAPES:
        shape = SHAPES[shape_name]
        for arch in ARCH_IDS:
            settings = autotune.compare_settings(get_config(arch), shape)
            opt = settings["global_optimum"].step_s
            gl = settings["guideline"].step_s
            gaps.append(gl / opt)
            tf = _score(settings["tf_setting"])
            intel = _score(settings["intel_setting"])
            if tf == float("inf"):
                tf_oom += 1
            else:
                tf_sp.append(tf / gl)
            if intel == float("inf"):
                intel_oom += 1
            else:
                intel_sp.append(intel / gl)
            name = f"fig18.{shape_name}.{arch}"
            emit(name, gl * 1e6,
                 f"vs_tf={'OOM' if tf == float('inf') else f'{tf / gl:.2f}x'},"
                 f"vs_intel={'OOM' if intel == float('inf') else f'{intel / gl:.2f}x'},"
                 f"pct_of_optimum={100 * opt / gl:.0f},"
                 f"pools={settings['guideline'].plan.pools}")
            rows.append(dict(
                name=name, shape=shape_name, arch=arch,
                **{k: dict(plan=r.plan.name, pools=r.plan.pools,
                           fsdp=r.plan.fsdp, step_s=r.step_s, fits=r.fits)
                   for k, r in settings.items()}))
    summary = dict(speedup_vs_tf=_geomean(tf_sp),
                   speedup_vs_intel=_geomean(intel_sp),
                   tf_oom_cells=tf_oom, intel_oom_cells=intel_oom,
                   worst_pct_of_optimum=100 / max(gaps), cells=len(gaps))
    emit("fig18.summary.geomean", 0.0,
         f"speedup_vs_tf={summary['speedup_vs_tf']:.2f}x,"
         f"speedup_vs_intel={summary['speedup_vs_intel']:.2f}x,"
         f"tf_oom_cells={tf_oom},intel_oom_cells={intel_oom},"
         f"worst_pct_of_optimum={summary['worst_pct_of_optimum']:.0f},"
         f"cells={len(gaps)}")
    return dict(rows=rows, summary=summary)


if __name__ == "__main__":
    main()
