"""repro_torch.obs — observability for the FL engine and the serving tier
(port of ``repro/obs``), all host-side and all zero-cost when off:

  * :mod:`~repro_torch.obs.trace` — a span tracer emitting Chrome
    trace-event / Perfetto JSON on the **simulated** clock, one track per
    vehicle / edge / cloud (the FL fabric) and per serving lane (the
    continuous scheduler). ``tracer=None`` everywhere means no callback
    fires: event logs, params and greedy streams are bitwise those of an
    untraced run;
  * :mod:`~repro_torch.obs.metrics` — labeled counters / gauges /
    histograms that the train loops, the event engine and the continuous
    scheduler publish into, snapshotting to JSON;
  * :mod:`~repro_torch.obs.profile` — an optional ``torch.profiler``
    capture (host and device activity, a Chrome trace) around a run, and
    static per-kernel cost annotations for spans;
  * :mod:`~repro_torch.obs.validate` — the structural checks of a trace
    file.

Capture points: ``Session.run(trace=..., profile=...)``,
``Session.serve(trace=...)`` and the ``--trace PATH`` flags of
``launch/train.py`` and ``launch/serve.py``.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)
from repro_torch.obs.profile import (ProfileOptions, kernel_cost_args,
                                     profiled)
from repro_torch.obs.trace import (FL_PID, SERVE_PID, TRACE_SCHEMA, Tracer,
                                   resolve_tracer)

__all__ = ["Counter", "FL_PID", "Gauge", "Histogram", "MetricsRegistry",
           "ProfileOptions", "SERVE_PID", "TRACE_SCHEMA", "Tracer",
           "kernel_cost_args", "profiled", "resolve_tracer"]
