"""Tracing / profiling (port of `rankfm_tpu/utils/observe.py`).

* every fit records a structured per-epoch log (epoch, eta, log-likelihood,
  wall seconds, interactions/s) on ``model.training_log_`` and the host
  phases of the last call on ``model.last_fit_timing_``,
* `trace(log_dir)` wraps a block in a `torch.profiler` trace and writes it
  into ``log_dir`` as a Chrome trace (open in ``chrome://tracing`` or
  Perfetto),
* `span(name)` marks a phase of the program as a named range of that
  trace, on the profiler's clock, beside the card's kernels,
* `device_memory_stats()` snapshots the CUDA allocator's counters.

The phases of a fit or a request show in any trace taken while they run:
``with observe.trace('/tmp/trace'): model.fit(...)``, then open the file in
Perfetto (ui.perfetto.dev). Each ``rankfm.fit`` or ``rankfm.recommend``
range holds the ranges of its phases, and those the kernels they launched:

* ``rankfm.fit``: ``.ingest`` (id maps, interactions, history, weight
  init, the copies to the device; inside it ``.hist``, the device copy of
  the history CSR), ``.plan`` (the planner), ``.prep``
  (everything before the first epoch of a fused fit: ``.hist_pack``, and a
  ``.layout`` for each record layout built, not found in the cache),
  ``.epochs.<engine>`` for each engine's run of epochs (``fused``,
  ``chunk_tail``, ``wide_tail``, ``candidate``, ``window``, ``tp``; an
  XLA engine's first opens ``.hist``, where it builds the bitmap or the
  packed history its sampler reads),
  ``.pull`` (the trained tables back into the model) and ``.finish``
  (reading every epoch's log-likelihood and the closing synchronisation);
* inside an engine's epochs on the card, ``rankfm.graph.capture`` (one per
  layout; its ``.drain``, ``.release`` and ``.record``) and one
  ``rankfm.graph.replay`` an epoch;
* ``rankfm.recommend``: ``.ids``, then per chunk of users ``.score`` (the
  work enqueued on the device) and ``.sync`` (the wait for it and the copy
  back), then ``.frame`` (the DataFrame).

The ranges of `last_fit_timing_`'s phases start and end at the statements
that stamp them. A span records only while a profiler records (this
module's `trace`, or any ``torch.profiler.profile``); otherwise it costs one
flag check.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# the context every span returns while no profiler records
_OFF = contextlib.nullcontext()


def span(name):
    """``with observe.span('rankfm.fit'):``: a `record_function` range named
    ``name`` while a profiler records, which nests in the range open
    around it on the thread; else a shared no-op context (no allocation,
    no call into torch's dispatcher)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
