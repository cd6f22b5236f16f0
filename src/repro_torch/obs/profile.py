"""Profiling hooks (port of ``repro/obs/profile.py``): an optional
``torch.profiler`` capture and static kernel cost annotations.

  * :func:`profiled` — a context manager wrapping a block (a whole
    ``Session.run``) in a ``torch.profiler`` capture when a trace
    directory is set, exported as a Chrome trace (Perfetto and
    ``chrome://tracing`` load it; kernels appear by name on the device's
    stream). With no directory it is a no-op, so an unprofiled run does
    no extra work. Where torch sees a CUDA device the capture records
    the device's activity as well as the host's, and a torch without
    CUDA profiling there raises instead of recording host time alone.
  * :func:`kernel_cost_args` — static cost annotations for span
    ``args``: padded tokens and attention MACs priced through the
    serving tier's :class:`repro_torch.serve.loadgen.PrefillCostModel`
    (anything with ``step_cost``), or the FL compute model's FLOPs. A
    host clock says nothing about device cost, so sim-time traces carry
    the modeled cost on every compute span.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional


#: the file a capture is exported to, inside ``ProfileOptions.trace_dir``
TRACE_FILE = "torch_trace.json"


@dataclasses.dataclass(frozen=True)
class ProfileOptions:
    """Where (and whether) to capture a ``torch.profiler`` trace:
    ``trace_dir=None`` disables capture, and the run is then untouched;
    otherwise the capture is written to ``trace_dir/torch_trace.json``."""

    trace_dir: Optional[str] = None

    @property
    def path(self) -> Optional[str]:
        if self.trace_dir is None:
            return None
        return os.path.join(self.trace_dir, TRACE_FILE)


@contextlib.contextmanager
def profiled(options: Optional[ProfileOptions] = None):
    """Wrap a block in a ``torch.profiler`` capture when enabled; yields
    the profiler (None when disabled)::

        with profiled(ProfileOptions(trace_dir="prof")):
            out = session.run(steps)

    The capture ends with a device synchronize, so every kernel the
    block launched is in the exported trace."""
    if options is None or options.trace_dir is None:
        yield None
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                supported_activities)
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError(
                "torch sees a CUDA device but its profiler cannot record "
                "CUDA activity; a host-only capture would hide the "
                "kernels")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(options.trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(options.path)


def kernel_cost_args(*, padded_tokens: int = 0, attn_mac: int = 0,
                     flops: float = 0.0, cost_model=None) -> Dict:
    """Static cost annotation dict for a span's ``args``.

    ``padded_tokens`` / ``attn_mac`` follow the scheduler's
    ``last_stats`` accounting (linear work per padded token + attention
    score MACs); ``flops`` is the FL compute model's per-round estimate.
    When a cost model (anything with ``step_cost``) is given, the modeled
    seconds ride along as ``est_cost_s`` — the surcharge the sim clock
    charged."""
    args: Dict = {}
    if padded_tokens:
        args["padded_tokens"] = int(padded_tokens)
    if attn_mac:
        args["attn_mac"] = int(attn_mac)
    if flops:
        args["flops"] = float(flops)
    if cost_model is not None and (padded_tokens or attn_mac):
        args["est_cost_s"] = float(cost_model.step_cost(
            {"prefill_padded_tokens": padded_tokens,
             "prefill_attn_mac": attn_mac}))
    return args
