"""Span tracer: Chrome trace-event / Perfetto JSON on the simulated clock
(a copy of ``repro/obs/trace.py``: the standard library and numpy only,
so the port's traces are byte for byte the reference's).

The emitted file is the `trace-event format
<https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU>`_
(JSON object form, ``{"traceEvents": [...]}``): ``X`` complete spans
with microsecond ``ts``/``dur``, ``i`` instants, ``C`` counter samples,
``s``/``f`` flow arrows, and ``M`` metadata rows naming processes and
threads. Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``
both load it directly.

Timestamps are the **simulated** clock — the same numbers that appear in
the event engine's event log and the loadgen's report — converted to
microseconds. A traced run therefore shows communication/computation
overlap, straggler gaps, and TTFT exactly as the timing models scored
them, independent of host wall time.

Determinism: events are appended in the (deterministic) order the
loops process them and serialized with sorted keys, so the same seed
produces byte-identical trace files (mirroring the event-log replay
guarantee of :mod:`repro_torch.comm.events`; enforced by
``tests/test_torch_obs.py``).

Track conventions (pid groups tracks; tid orders them):

  * ``FL_PID``     — the FL fabric: one track per vehicle
    (``vehicle_tid``), one per edge pod (``edge_tid``), one for the
    cloud (``CLOUD_TID``).
  * ``SERVE_PID``  — the serving tier: a queue track (``QUEUE_TID``)
    for admission waits, a speculative-decode track (``SPEC_TID``) for
    the per-step draft/verify spans, plus one track per scheduler lane
    (``lane_tid``).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Union

TRACE_SCHEMA = "chrome-trace-event/1"

#: process ids for the two instrumented subsystems
FL_PID = 1
SERVE_PID = 2

#: tid layout inside FL_PID
CLOUD_TID = 1
_EDGE_TID0 = 100
_VEHICLE_TID0 = 1000
#: tid layout inside SERVE_PID
QUEUE_TID = 1
#: draft/verify spans of the speculative decoder (batched across lanes,
#: so they live on their own track rather than any one lane's)
SPEC_TID = 2
_LANE_TID0 = 10


def vehicle_tid(i: int) -> int:
    return _VEHICLE_TID0 + i


def edge_tid(e: int) -> int:
    return _EDGE_TID0 + e


def lane_tid(slot: int) -> int:
    return _LANE_TID0 + slot


class Tracer:
    """Collects trace events in memory; ``save``/``to_bytes`` serialize.

    All ``t``/``t0``/``t1`` arguments are simulated seconds; they are
    stored as microseconds (the trace-event unit). The tracer never
    touches tensors or PRNG state — attaching one cannot perturb a run.
    """

    def __init__(self):
        self.events: List[Dict] = []
        self._named: set = set()
        self._flow_seq = 0

    # ---- metadata -----------------------------------------------------
    def process(self, pid: int, name: str, sort_index: int = 0) -> None:
        key = ("p", pid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})
        if sort_index:
            self.events.append({"ph": "M", "name": "process_sort_index",
                                "pid": pid, "tid": 0,
                                "args": {"sort_index": sort_index}})

    def track(self, pid: int, tid: int, name: str) -> None:
        key = ("t", pid, tid)
        if key in self._named:
            return
        self._named.add(key)
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # ---- spans / marks ------------------------------------------------
    def complete(self, name: str, t0: float, t1: float, *, pid: int,
                 tid: int, cat: str = "", args: Optional[Dict] = None
                 ) -> None:
        """One ``X`` complete span covering simulated ``[t0, t1]``."""
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": t0 * 1e6, "dur": max(0.0, (t1 - t0) * 1e6)}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, t: float, *, pid: int, tid: int,
                cat: str = "", args: Optional[Dict] = None,
                scope: str = "t") -> None:
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": t * 1e6, "s": scope}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, t: float, values: Dict[str, float], *,
                pid: int, tid: int = 0) -> None:
        """One ``C`` counter sample (rendered as a counter track)."""
        self.events.append({"ph": "C", "name": name, "pid": pid,
                            "tid": tid, "ts": t * 1e6,
                            "args": {k: float(v)
                                     for k, v in values.items()}})

    def flow(self, name: str, t0: float, pid0: int, tid0: int,
             t1: float, pid1: int, tid1: int, cat: str = "flow") -> int:
        """A flow arrow (``s`` -> ``f`` pair) between two tracks; the
        endpoints must lie inside enclosing slices on their tracks.
        Returns the flow id."""
        fid = self._flow_seq
        self._flow_seq += 1
        self.events.append({"ph": "s", "name": name, "cat": cat,
                            "id": fid, "pid": pid0, "tid": tid0,
                            "ts": t0 * 1e6})
        self.events.append({"ph": "f", "name": name, "cat": cat,
                            "id": fid, "pid": pid1, "tid": tid1,
                            "ts": t1 * 1e6, "bp": "e"})
        return fid

    # ---- serialization ------------------------------------------------
    def to_dict(self) -> Dict:
        return {"traceEvents": self.events,
                "displayTimeUnit": "ms",
                "otherData": {"schema": TRACE_SCHEMA,
                              "clock": "simulated-seconds->us"}}

    def to_bytes(self) -> bytes:
        """Canonical serialization: sorted keys, fixed separators — the
        byte-determinism contract the trace tests pin. Numpy scalars in
        span args collapse to plain ints/floats (same rendered bytes)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"),
                          default=_np_default).encode()

    def save(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.to_bytes())
        return path

    def __len__(self) -> int:
        return len(self.events)


def _np_default(o):
    import numpy as np
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"Object of type {type(o).__name__} "
                    f"is not JSON serializable")


def resolve_tracer(trace: Union[None, str, Tracer]
                   ) -> tuple:
    """Normalize a ``trace=`` option: None -> (None, None), a path ->
    (fresh Tracer, path to save at the end), a Tracer -> (it, None)."""
    if trace is None:
        return None, None
    if isinstance(trace, Tracer):
        return trace, None
    return Tracer(), str(trace)
