"""Roofline report: the port's dry-run rows (``results/dryrun_torch/``)
as the per-(arch x shape x mesh) three-term table (counterpart of
``benchmarks/roofline_report.py``).

    python -m repro_torch.benchmarks.roofline_report [--results DIR]
        [--out FILE] [--markdown]

Prints one ``roofline.<arch>.<shape>.<mesh>.<setting>`` line a row and
writes the table (single-pod and multi-pod guideline cells) to
``results/roofline_table_torch.md``.  The reference's ``adj_coll``
column is left out: it halves f32 collective payloads to undo an
XLA:CPU artifact (float normalization upcasting bf16 collectives), and
the port's collectives are enumerated at their own dtype
(``analysis/collectives``), so there is nothing to undo.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional, Sequence

from repro_torch.launch.dryrun import RESULTS

HDR = ("| arch | shape | plan | compute_s | memory_s | collective_s | "
       "dominant | useful | frac | mem/dev GiB |")


def load_rows(results: Path = RESULTS) -> List[dict]:
    rows = []
    for f in sorted(Path(results).glob("*.json")):
        try:
            rows.append(json.loads(f.read_text()))
        except (OSError, ValueError) as e:
            print(f"# skipped {f.name}: {e}")
    return rows


def _plan(r: dict) -> str:
    p = r["plan"]
    return f"p{p['pools']}i{p['intra']}" + ("f" if p["fsdp"] else "")


def fmt_table(rows: List[dict], mesh: str = "single") -> str:
    out = [HDR, "|" + "---|" * 10]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != mesh or r["setting"] != "guideline":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {_plan(r)} "
            f"| {r['compute_s']:.3f} | {r['memory_s']:.3f} "
            f"| {r['collective_s']:.3f} | {r['dominant']} "
            f"| {r['useful_ratio']:.2f} | {r['roofline_frac']:.3f} "
            f"| {r['memory_per_device_bytes'] / 2**30:.0f} |")
    return "\n".join(out)


def write_table(rows: List[dict], out: Path) -> None:
    lines = ["# Roofline: per-cell three-term table of the port's dry-run",
             "", "terms in seconds/step on the H100's data sheet; frac = "
             "ideal-compute / step estimate.", "",
             "## single-pod (16x16), guideline plan", "",
             fmt_table(rows, "single"), "",
             "## multi-pod (2x16x16), guideline plan", "",
             fmt_table(rows, "multi")]
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"# wrote {out}")


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--device", default=None, help="ignored: analytic")
    args = ap.parse_args(argv)
    results = Path(args.results) if args.results else RESULTS
    rows = load_rows(results)
    print(f"# roofline rows: {len(rows)}")
    for r in sorted(rows, key=lambda r: (r["shape"], r["arch"], r["mesh"])):
        print(f"roofline.{r['arch']}.{r['shape']}.{r['mesh']}."
              f"{r['setting']},{r['step_s'] * 1e6:.1f},"
              f"dom={r['dominant']},frac={r['roofline_frac']:.3f},"
              f"useful={r['useful_ratio']:.2f},"
              f"mem_gib={r['memory_per_device_bytes'] / 2**30:.1f}")
    out = Path(args.out) if args.out else \
        results.parent / "roofline_table_torch.md"
    write_table(rows, out)
    if args.markdown:
        print()
        print(fmt_table(rows, "single"))
    return rows


if __name__ == "__main__":
    main()
