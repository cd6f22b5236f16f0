"""Metrics registry: labeled counters / gauges / histograms -> JSON
(a copy of ``repro/obs/metrics.py``; the port imports nothing of the
reference).

Every subsystem keeps private accounting (wire bytes in the comm
fabric, TTFT fields in the loadgen, block churn in the allocator); this
registry is the shared layer they publish into so one snapshot can
correlate them:

  * the train loops publish every round's scalar metrics
    (``LoopHooks.metrics``): ``comm_bytes_*`` accumulate as counters,
    everything else samples a gauge;
  * the event engine publishes per-edge uplink/backhaul byte counters,
    the observed-staleness histogram, and the migration counter;
  * the continuous scheduler publishes block-pool occupancy (+ its
    high-watermark, via ``BlockAllocator.free_blocks``), prefix
    hits/misses, decode tokens, and padded-token waste.

Instruments are host-side and allocation-light: a dict update per
publish, no tensors, no PRNG — publishing cannot perturb a run.
``snapshot()`` is JSON-serializable with deterministic key order.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

METRICS_SCHEMA = "repro.obs.metrics/1"

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Instrument:
    kind = ""

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def _series(self) -> List[Dict]:  # pragma: no cover - abstract
        raise NotImplementedError

    def snapshot(self) -> Dict:
        return {"type": self.kind, "help": self.help,
                "series": self._series()}


class Counter(_Instrument):
    """Monotone accumulator, one cell per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._cells: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {value})")
        k = _label_key(labels)
        self._cells[k] = self._cells.get(k, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self._cells.get(_label_key(labels), 0.0)

    def _series(self) -> List[Dict]:
        return [{"labels": dict(k), "value": v}
                for k, v in sorted(self._cells.items())]


class Gauge(_Instrument):
    """Last-value instrument that also tracks mean / peak / min / count,
    so a per-step sample stream (e.g. block-pool occupancy) can report
    its high-watermark without storing every sample."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        # label key -> [last, sum, count, peak, trough]
        self._cells: Dict[LabelKey, List[float]] = {}

    def set(self, value: float, **labels) -> None:
        v = float(value)
        cell = self._cells.get(_label_key(labels))
        if cell is None:
            self._cells[_label_key(labels)] = [v, v, 1, v, v]
        else:
            cell[0] = v
            cell[1] += v
            cell[2] += 1
            cell[3] = max(cell[3], v)
            cell[4] = min(cell[4], v)

    def value(self, **labels) -> Optional[float]:
        cell = self._cells.get(_label_key(labels))
        return None if cell is None else cell[0]

    def stats(self, **labels) -> Optional[Dict]:
        cell = self._cells.get(_label_key(labels))
        if cell is None:
            return None
        last, total, count, peak, trough = cell
        return {"last": last, "mean": total / count, "count": int(count),
                "peak": peak, "min": trough}

    def _series(self) -> List[Dict]:
        return [{"labels": dict(k), **self.stats(**dict(k))}
                for k in sorted(self._cells)]


DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                   2.5, 5.0, 10.0)


class Histogram(_Instrument):
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # label key -> [bucket counts..., +inf count, sum]
        self._cells: Dict[LabelKey, List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = _label_key(labels)
        cell = self._cells.setdefault(
            k, [0.0] * (len(self.buckets) + 1) + [0.0])
        for i, b in enumerate(self.buckets):
            if v <= b:
                cell[i] += 1
                break
        else:
            cell[len(self.buckets)] += 1
        cell[-1] += v

    def stats(self, **labels) -> Optional[Dict]:
        cell = self._cells.get(_label_key(labels))
        if cell is None:
            return None
        counts = cell[:-1]
        n = int(sum(counts))
        return {"count": n, "sum": cell[-1],
                "mean": (cell[-1] / n) if n else 0.0,
                "buckets": [{"le": b, "count": int(c)}
                            for b, c in zip(self.buckets, counts)]
                + [{"le": "inf", "count": int(counts[-1])}]}

    def _series(self) -> List[Dict]:
        return [{"labels": dict(k), **self.stats(**dict(k))}
                for k in sorted(self._cells)]


class MetricsRegistry:
    """Get-or-create registry of instruments, snapshotting to JSON."""

    def __init__(self):
        self._metrics: Dict[str, _Instrument] = {}

    def _get(self, cls, name: str, help: str, **kw):
        inst = self._metrics.get(name)
        if inst is None:
            inst = cls(name, help, **kw)
            self._metrics[name] = inst
        elif not isinstance(inst, cls):
            raise ValueError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        return self._metrics.get(name)

    def publish_scalars(self, metrics: Dict, *, prefix: str = "",
                        **labels) -> None:
        """Publish one round/step's scalar metrics dict: ``comm_bytes*``
        keys accumulate as counters (they are per-round byte totals),
        everything else samples a gauge. Non-scalars are skipped — the
        loops record those whole in history instead."""
        import numpy as np
        for k, v in metrics.items():
            if np.ndim(v) != 0:
                continue
            v = float(v)
            name = prefix + k
            if k.startswith("comm_bytes"):
                self.counter(name).inc(v, **labels)
            else:
                self.gauge(name).set(v, **labels)

    def snapshot(self) -> Dict:
        return {"schema": METRICS_SCHEMA,
                "metrics": {name: inst.snapshot()
                            for name, inst in sorted(self._metrics.items())}}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, sort_keys=True, indent=1)
        return path

    def __len__(self) -> int:
        return len(self._metrics)
