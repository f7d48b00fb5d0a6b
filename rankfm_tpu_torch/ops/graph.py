"""One training epoch as a CUDA graph: the counterpart of the JAX package's
jitted epoch.

The JAX package compiles each epoch into one device program (the fused
engine's `_epoch_body`, `rankfm_tpu/ops/fused.py:1273-1342`, jitted at
`:1520`; the XLA engines' `make_epoch_body`, `rankfm_tpu/ops/training.py:
556-591`) and keeps the executable (`aotcache.wrap`). The port's epochs
(`fused.dp_fused_epoch`, `training.epoch_body`) read nothing back on the
host, draw everything on the device from ``(seed, epoch)`` (`_philox`) and
take ``epoch`` and ``eta`` as 0-dim device tensors, so one epoch can be
captured with `torch.cuda.graph` and replayed for every epoch of a fit:
`EpochGraph` writes the epoch's number and learning rate into the two
buffers the graph was captured with and replays it; the host enqueues one
graph an epoch instead of hundreds to thousands of launches.

Capture records work and runs none, so every epoch, the first included,
runs by a replay, and the capture trains nothing. Nothing runs before it
but a small matrix product on the capture's stream, once per device, so
that cuBLAS sets up its handle outside the graph; the kernels' libraries
load, their modules load and their persistent scratch is allocated (in the
graph's pool, zeroed by the graph) while the capture records. A capture
that fails raises with the CUDA error: nothing falls back to the eager
epoch.

An epoch of the XLA steps, hundreds of batches of a few hundred launches
each, is captured as one batch instead (`BatchGraph`): the epoch's rows are
made eagerly into buffers the graph reads at a device batch counter, and
the batch's graph is replayed once per batch. Its capture records one batch
where `EpochGraph` would record them all, which at ~500 batches took
seconds of the host a fit.

`epoch_runner` applies the graph to CUDA tables of a single device only;
the CPU and the mesh (whose collectives cannot be captured over gloo) run
the same epoch function eagerly. Given a ``cache`` and a ``key``, a graph
outlives its fit: a later fit whose key is equal (same data, layout,
hyperparameters and table shapes) replays it with its own tables copied in
before each replay and back after.
"""

from __future__ import annotations

import gc
import time
from collections import Counter

import torch

from rankfm_tpu_torch.utils import observe

# graphs captured and replays run, by "capture" / "replay"
RUNS = Counter()

# the side stream of every capture on a device: the kernels' persistent
# scratch is kept per stream (`fused.scratch`, `scatter.scratch`), so the
# graphs share one set, which is safe because replays run one at a time
_streams = {}


def _capture_stream(device):
    """The stream every capture on ``device`` runs on; the first call on a
    device also runs one small matrix product on it, which sets up the
    cuBLAS handle and workspace of that stream outside any capture."""
    if device.index not in _streams:
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            a = torch.ones((2, 8, 8), device=device)
            torch.bmm(a, a) @ a[0]
        stream.synchronize()
        _streams[device.index] = stream
    return _streams[device.index]


def _counters():
    from rankfm_tpu_torch.ops import fused, scatter, training
    return fused.LAUNCHES, scatter.LAUNCHES, training.STEPS


def _scratch_of(stream):
    """The kernels' persistent scratch tensors kept for ``stream``: a graph
    holds them, so that no eviction from the wrappers' caches frees memory
    its kernels write."""
    from rankfm_tpu_torch.ops import fused, scatter
    return [v for cache in (fused._scratch, scatter._scratch)
            for k, v in cache.items() if k[1] == stream.cuda_stream]


class GraphCaptureError(RuntimeError):
    """The capture of an epoch failed (the message holds the CUDA error)."""


class EpochGraph:
    """``fn(tables, epoch, eta) -> ll`` captured once, replayed per epoch.

    ``tables`` is a dict of the tensors the epoch trains in place (None
    for an absent one); ``fn`` must update them in place, read ``epoch``
    (int64) and ``eta`` (f32), two 0-dim device tensors, and return the
    epoch's log-likelihood as a 0-dim tensor. The tables, and whatever
    ``fn`` reads besides, are the graph's static buffers: they keep their
    addresses for the life of the graph.

    ``keep_graph`` keeps the captured ``cudaGraph_t`` beside its
    executable (`raw_cuda_graph`, for inspection) and instantiates it
    apart from the capture.

    ``stats``: ``capture_s`` (the recording; without ``keep_graph`` the
    instantiation too), ``instantiate_s`` (None without ``keep_graph``),
    ``pool_bytes`` (device memory the capture reserved: the graph's
    private pool) and ``launches`` (the kernel launches of one replay, by
    wrapper and key, and its batch steps, `training.STEPS`)."""

    def __init__(self, fn, tables, device, name="epoch", keep_graph=False):
        self.fn, self.tables, self.name = fn, tables, name
        self.device = torch.device(device)
        self.keep_graph = keep_graph
        self.epoch = torch.zeros((), dtype=torch.int64, device=self.device)
        self.eta = torch.zeros((), dtype=torch.float32, device=self.device)
        self.graph = self.ll = None
        self.scratch = []
        self.launches = (Counter(), Counter(), Counter())
        self.stats = {}

    def _set(self, epoch, eta):
        self.epoch.fill_(int(epoch))
        self.eta.fill_(float(eta))

    def capture(self):
        """Record one epoch (the epoch and eta buffers as they are when it
        replays)."""
        with observe.span("rankfm.graph.capture"):
            dev = self.device
            stream = _capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            graph = (torch.cuda.CUDAGraph(keep_graph=True) if self.keep_graph
                     else torch.cuda.CUDAGraph())
            counters = _counters()
            before = [Counter(c) for c in counters]
            with observe.span("rankfm.graph.drain"):
                torch.cuda.synchronize(dev)
            with observe.span("rankfm.graph.release"):
                torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            with observe.span("rankfm.graph.record"):
                t0 = time.perf_counter()
                # no garbage collection while recording: an unreachable
                # graph it destroyed would free device memory, which ends
                # the capture
                gc_on = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(graph, stream=stream,
                                          capture_error_mode="thread_local"):
                        ll = self.fn(self.tables, self.epoch, self.eta)
                except Exception as e:
                    raise GraphCaptureError(
                        f"capturing the epoch ({self.name}) as a CUDA graph "
                        f"failed: {e}") from e
                finally:
                    if gc_on:
                        gc.enable()
                t1 = time.perf_counter()
                if self.keep_graph:
                    graph.instantiate()
                t2 = time.perf_counter()
            # the wrappers counted what they recorded; the replays count it
            self.launches = tuple(c - b for c, b in zip(counters, before))
            for c, d in zip(counters, self.launches):
                c.subtract(d)
            self.graph, self.ll = graph, ll
            self.scratch = _scratch_of(stream)
            RUNS["capture"] += 1
            pool = torch.cuda.memory_reserved(dev) - reserved
            self.stats = {
                "capture_s": t1 - t0,
                "instantiate_s": t2 - t1 if self.keep_graph else None,
                "pool_bytes": pool,
                "launches": {"fused": dict(self.launches[0]),
                             "scatter": dict(self.launches[1]),
                             "steps": dict(self.launches[2])}}

    def __call__(self, epoch, eta, tables=None):
        """Epoch ``epoch`` at learning rate ``eta`` (captured at the first
        call); returns its log-likelihood (a 0-dim tensor of its own).
        ``tables``: the caller's tables when they are not the graph's own
        (a graph kept from an earlier fit), copied in before the replay
        and back after."""
        if self.graph is None:
            self.capture()
        with observe.span("rankfm.graph.replay"):
            other = tables is not None and tables is not self.tables
            if other:
                for k, t in tables.items():
                    if t is not None:
                        self.tables[k].copy_(t)
            self._set(epoch, eta)
            self.graph.replay()
            RUNS["replay"] += 1
            for c, d in zip(_counters(), self.launches):
                c.update(d)
            if other:
                for k, t in tables.items():
                    if t is not None:
                        t.copy_(self.tables[k])
            return self.ll.clone()


class BatchGraph(EpochGraph):
    """An epoch of ``count`` batches, one batch captured and replayed per
    batch: ``rows(epoch) -> [tensor [count, ...], ...]`` makes the epoch's
    batches eagerly (the first call's tensors become the graph's static
    buffers, later calls are copied into them), and ``step(tables, rows,
    eta) -> ll`` trains one batch, ``rows`` holding each buffer's entry at
    the graph's batch counter. The capture, the spans, `RUNS` (one
    replay an epoch) and the copies of a caller's tables are as in
    `EpochGraph`; an epoch's replay counts its capture's launches
    ``count`` times."""

    def __init__(self, rows, step, count, tables, device, name="epoch"):
        super().__init__(self._batch, tables, device, name)
        self.rows_fn, self.step, self.count = rows, step, count
        self.rows = None
        self.t = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.ll_sum = torch.zeros((), dtype=torch.float32,
                                  device=self.device)

    def _batch(self, tables, epoch, eta):
        ll = self.step(tables, [r.index_select(0, self.t)[0]
                                for r in self.rows], eta)
        self.ll_sum.add_(ll)
        self.t.add_(1)
        return self.ll_sum

    def __call__(self, epoch, eta, tables=None):
        self._set(epoch, eta)
        fresh = self.graph is None
        if fresh:
            self.rows = list(self.rows_fn(self.epoch))
            self.capture()
        with observe.span("rankfm.graph.replay"):
            other = tables is not None and tables is not self.tables
            if other:
                for k, t in tables.items():
                    if t is not None:
                        self.tables[k].copy_(t)
            if not fresh:
                for r, new in zip(self.rows, self.rows_fn(self.epoch)):
                    r.copy_(new)
            self.t.zero_()
            self.ll_sum.zero_()
            for _ in range(self.count):
                self.graph.replay()
            RUNS["replay"] += 1
            for c, d in zip(_counters(), self.launches):
                c.update({k: v * self.count for k, v in d.items()})
            if other:
                for k, t in tables.items():
                    if t is not None:
                        t.copy_(self.tables[k])
            return self.ll_sum.clone()


def epoch_runner(fn, tables, device, mesh=None, name="epoch", cache=None,
                 key=None, deps=(), batches=None):
    """``run(epoch, eta) -> ll``: an `EpochGraph` of ``fn`` when the tables
    are CUDA tensors of a single device (``mesh`` None), else ``fn``
    called eagerly with the same arguments (``epoch`` and ``eta`` as
    numbers). ``batches``: ``(rows, step, count)`` of the same epoch, for
    a `BatchGraph` in place of the `EpochGraph`.

    ``cache`` (a dict) and ``key`` (hashable; None for no reuse) keep the
    graph for a later call, which replays it with its own tables. ``key``
    must name everything the graph holds besides the tables: the values it
    was captured with (data and layouts by content, hyperparameters,
    shapes) and the device tensors ``fn`` reads (``deps``, by identity);
    the graph holds ``deps``, so that no other tensor takes their ids."""
    device = torch.device(device)
    if device.type != "cuda" or mesh is not None:
        return lambda epoch, eta: fn(tables, epoch, eta)

    def make():
        if batches is None:
            return EpochGraph(fn, tables, device, name)
        return BatchGraph(*batches, tables, device, name)

    if cache is None or key is None:
        return make()
    g = cache.get(key)
    if g is None:
        g = cache[key] = make()
        g.deps = tuple(deps)
    return lambda epoch, eta: g(epoch, eta, tables)
