"""Discrete-event queue (copy of ``EventQueue`` from
``repro/comm/events.py``; the asynchronous FL engine around it is not
ported yet)."""
from __future__ import annotations

import heapq
import math
from typing import List, Tuple


class EventQueue:
    """Min-heap of events keyed ``(timestamp, sequence-id)`` — identical
    timestamps pop in push order, so runs replay identically across
    platforms (heapq never compares the event payloads themselves)."""

    def __init__(self):
        self._heap: List[Tuple[float, int, object]] = []
        self._seq = 0

    def push(self, ev) -> None:
        heapq.heappush(self._heap, (ev.t, self._seq, ev))
        self._seq += 1

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def peek_t(self) -> float:
        return self._heap[0][0] if self._heap else math.inf

    def __len__(self) -> int:
        return len(self._heap)
