"""repro_torch.obs — the metrics registry the serving scheduler publishes
into (tracing and profiling are not ported yet)."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
