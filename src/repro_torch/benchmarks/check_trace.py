"""Validate an ``Engine.export_trace`` JSON file against the Chrome
trace-event / Perfetto schema subset the serving tracer emits.

Checks (CI runs this on the ``launch/serve.py --trace`` smoke output,
and ``fig14`` runs :func:`validate` in-process on the traced baseline
workload):

* top-level shape: ``{"traceEvents": [...]}``;
* every event has a known ``ph``, integer ``pid``/``tid``, and a
  finite non-negative ``ts`` (metadata ``M`` events excepted);
* ``X`` complete events carry ``dur >= 0``;
* async ``b``/``e`` pairs (queue wait spans) are keyed by
  ``(cat, id)``, never close an unopened span, and all close by EOF;
* flow chains (``s``/``t``/``f`` keyed by ``(cat, id)``) start with
  exactly one ``s``, end with exactly one ``f`` (binding ``bp: "e"``),
  and run in non-decreasing ``ts`` order;
* request-lifecycle completeness: every rid with a terminal instant
  (``finish`` / ``reject``) also has a ``submit`` instant and a flow
  chain — the submit->terminal span chain the acceptance criteria
  gate.

Exit code 0 when the file passes, 1 with one line per failure when it
does not.

A copy of the repository's ``benchmarks/check_trace.py``, which the
port's launcher, fig14 and ``chip_smoke.py`` run on the port's traces.
"""

import json
import math
import sys

#: Phases the serving exporter emits (trace.to_chrome_trace).
KNOWN_PH = frozenset("MXbeistfCi")

TERMINAL_NAMES = frozenset({"finish", "reject"})


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and math.isfinite(v)


def validate(obj) -> list:
    """All schema violations in ``obj`` (an ``export_trace`` result),
    as human-readable strings; empty means the trace is valid."""
    failures = []
    if not isinstance(obj, dict) \
            or not isinstance(obj.get("traceEvents"), list):
        return ["top level must be an object with a traceEvents list"]
    evs = obj["traceEvents"]
    if not evs:
        return ["traceEvents is empty"]

    async_depth = {}          # (cat, id) -> open b spans
    flows = {}                # (cat, id) -> [(ph, ts)] in file order
    submits, terminals = set(), {}

    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            failures.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in KNOWN_PH:
            failures.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            failures.append(f"{where}: ph={ph} needs integer pid and tid")
        if ph == "M":
            continue                      # metadata carries no ts
        if not _num(e.get("ts")) or e["ts"] < 0:
            failures.append(f"{where}: ph={ph} needs finite ts >= 0")
            continue
        if ph == "X" and (not _num(e.get("dur")) or e["dur"] < 0):
            failures.append(f"{where}: X event needs dur >= 0")
        if ph == "C" and not isinstance(e.get("args"), dict):
            failures.append(f"{where}: C event needs an args dict")
        if ph == "i" and e.get("s") not in ("g", "p", "t"):
            failures.append(f"{where}: i event needs scope s in g/p/t")
        if ph in "bestf":
            key = (e.get("cat"), e.get("id"))
            if key[0] is None or not isinstance(key[1], str):
                failures.append(
                    f"{where}: ph={ph} needs cat and string id")
                continue
            if ph == "b":
                async_depth[key] = async_depth.get(key, 0) + 1
            elif ph == "e":
                depth = async_depth.get(key, 0) - 1
                if depth < 0:
                    failures.append(
                        f"{where}: e closes unopened span {key}")
                async_depth[key] = max(depth, 0)
            else:                         # flow point
                if ph == "f" and e.get("bp") != "e":
                    failures.append(f"{where}: f event must bind bp='e'")
                flows.setdefault(key, []).append((ph, e["ts"]))
        if ph == "i":
            rid = (e.get("args") or {}).get("rid")
            if rid is not None:
                if e.get("name") == "submit":
                    submits.add(rid)
                elif e.get("name") in TERMINAL_NAMES:
                    terminals[rid] = e["name"]

    for key, depth in async_depth.items():
        if depth:
            failures.append(f"async span {key}: {depth} b without e")
    for key, points in flows.items():
        phs = [p for p, _ in points]
        if phs[0] != "s" or phs.count("s") != 1:
            failures.append(f"flow {key}: needs exactly one leading s")
        if phs[-1] != "f" or phs.count("f") != 1:
            failures.append(f"flow {key}: needs exactly one trailing f")
        ts = [t for _, t in points]
        if ts != sorted(ts):
            failures.append(f"flow {key}: ts not non-decreasing: {ts}")

    # flow ids are str(rid), or "rid#gen" when a benchmark harness
    # reused the rid across runs inside one tracer
    flow_rids = {fid.split("#", 1)[0]
                 for cat, fid in flows if cat == "lifecycle"}
    for rid, kind in sorted(terminals.items()):
        if rid not in submits:
            failures.append(
                f"rid {rid}: terminal {kind} without a submit instant")
        if str(rid) not in flow_rids:
            failures.append(
                f"rid {rid}: terminal {kind} without a lifecycle flow "
                "chain")
    return failures


def main(argv) -> int:
    if len(argv) != 2:
        print("usage: python -m repro_torch.benchmarks.check_trace "
              "TRACE.json")
        return 2
    try:
        obj = json.loads(open(argv[1]).read())
    except (OSError, ValueError) as exc:
        print(f"FAIL: cannot read {argv[1]}: {exc}")
        return 1
    failures = validate(obj)
    for f in failures:
        print(f"FAIL: {f}")
    if failures:
        return 1
    evs = obj["traceEvents"]
    n_flow = sum(1 for e in evs if e.get("ph") == "f")
    print(f"check_trace: OK — {len(evs)} events, {n_flow} complete "
          "request flow chains")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
