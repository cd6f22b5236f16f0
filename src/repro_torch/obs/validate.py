"""Structural checks of a Chrome trace-event JSON file (the checks of
the reference's ``scripts/validate_trace.py``, as functions of the port,
which imports nothing of the reference's scripts).

The contract Perfetto / chrome://tracing rely on:

  * top level is ``{"traceEvents": [...]}``;
  * every event has a ``ph`` from the emitted set {X, i, M, s, f, C},
    integer ``pid``/``tid``, and a non-empty ``name``;
  * non-metadata events carry a numeric ``ts >= 0``;
  * ``X`` spans carry a numeric ``dur >= 0``;
  * ``M`` rows are known metadata (process_name / thread_name /
    process_sort_index) with the matching ``args`` payload;
  * ``s``/``f`` flow arrows pair up by ``id`` — every ``f`` has a prior
    ``s`` with the same id, no id is opened twice, none is left open,
    and the ``f`` end does not precede its ``s`` start;
  * ``C`` counter samples carry numeric-valued ``args``.

``validate(events)`` returns every violation (empty list = valid);
``validate_file(path)`` loads a file first. As a script::

    python -m repro_torch.obs.validate TRACE.json [TRACE2.json ...]

exits non-zero, listing the violations, if any file fails.
"""
from __future__ import annotations

import json
import sys
from typing import Dict, List

ALLOWED_PH = {"X", "i", "M", "s", "f", "C"}
ALLOWED_META = {"process_name", "thread_name", "process_sort_index"}
META_ARG = {"process_name": "name", "thread_name": "name",
            "process_sort_index": "sort_index"}


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def validate(events: List[Dict]) -> List[str]:
    """All structural violations in one pass (empty list = valid)."""
    errors: List[str] = []
    open_flows: Dict[object, float] = {}
    closed: set = set()
    for n, ev in enumerate(events):
        where = f"event[{n}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ALLOWED_PH:
            errors.append(f"{where}: unknown ph {ph!r}")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errors.append(f"{where} ({ph}): missing/empty name")
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), int):
                errors.append(f"{where} ({ph} {name!r}): non-integer {k}")
        if ph == "M":
            if name not in ALLOWED_META:
                errors.append(f"{where}: unknown metadata row {name!r}")
            elif META_ARG[name] not in ev.get("args", {}):
                errors.append(f"{where} (M {name!r}): args missing "
                              f"{META_ARG[name]!r}")
            continue
        ts = ev.get("ts")
        if not _num(ts) or ts < 0:
            errors.append(f"{where} ({ph} {name!r}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not _num(dur) or dur < 0:
                errors.append(f"{where} (X {name!r}): bad dur {dur!r}")
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                errors.append(f"{where} (C {name!r}): missing args")
            else:
                for k, v in args.items():
                    if not _num(v):
                        errors.append(f"{where} (C {name!r}): "
                                      f"non-numeric series {k}={v!r}")
        elif ph == "s":
            fid = ev.get("id")
            if fid is None:
                errors.append(f"{where} (s {name!r}): missing flow id")
            elif fid in open_flows or fid in closed:
                errors.append(f"{where} (s {name!r}): flow id {fid!r} "
                              f"reused")
            else:
                open_flows[fid] = ts
        elif ph == "f":
            fid = ev.get("id")
            if fid not in open_flows:
                errors.append(f"{where} (f {name!r}): flow id {fid!r} "
                              f"has no prior s")
            else:
                if ts < open_flows[fid]:
                    errors.append(f"{where} (f {name!r}): flow id "
                                  f"{fid!r} ends before its start")
                if ev.get("bp") != "e":
                    errors.append(f"{where} (f {name!r}): missing "
                                  f"bp='e' (Perfetto needs it to bind "
                                  f"the arrow to the enclosing slice)")
                del open_flows[fid]
                closed.add(fid)
    for fid, ts in sorted(open_flows.items(), key=lambda kv: str(kv[0])):
        errors.append(f"flow id {fid!r} (s at ts={ts}) never finished")
    return errors


def validate_file(path: str) -> List[str]:
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"cannot load: {e}"]
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with 'traceEvents'"]
    if not isinstance(doc["traceEvents"], list):
        return ["'traceEvents' must be a list"]
    return validate(doc["traceEvents"])


def main(argv: List[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    bad = 0
    for path in argv:
        errors = validate_file(path)
        if errors:
            bad += 1
            print(f"[validate] FAIL {path}: {len(errors)} "
                  f"violation(s)")
            for e in errors[:50]:
                print(f"  - {e}")
            if len(errors) > 50:
                print(f"  ... and {len(errors) - 50} more")
        else:
            with open(path) as f:
                n = len(json.load(f)["traceEvents"])
            print(f"[validate] OK   {path}: {n} events")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
