"""Tracing / profiling (port of `rankfm_tpu/utils/observe.py`).

* every fit records a structured per-epoch log (epoch, eta, log-likelihood,
  wall seconds, interactions/s) on ``model.training_log_`` and the host
  phases of the last call on ``model.last_fit_timing_``,
* `trace(log_dir)` wraps a block in a `torch.profiler` trace and writes it
  into ``log_dir`` as a Chrome trace (open in ``chrome://tracing`` or
  Perfetto),
* `device_memory_stats()` snapshots the CUDA allocator's counters.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir):
    """Profile a block: ``with observe.trace('/tmp/trace'): model.fit(...)``.
    CPU activities always, CUDA activities where there is a card; the trace
    lands in ``log_dir/trace_<ms since the epoch>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            str(log_dir), f"trace_{int(time.time() * 1e3)}.json"))


def device_memory_stats(device=None):
    """`torch.cuda.memory_stats` of ``device`` (the current CUDA device when
    None); ``{}`` for the CPU or without a card."""
    if device is not None and torch.device(device).type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))
