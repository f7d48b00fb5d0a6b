"""Process groups and the ``(data, model)`` mesh on ``torch.distributed``
(port of `rankfm_tpu/parallel/mesh.py`).

The JAX package is single-controller: one `Mesh` of devices, `shard_map`
and `psum`. The port is SPMD, as PyTorch is: one process per device, as
``torchrun`` launches them, and every rank calls the same `RankFM.fit` on
the same frame (a JAX pod works the same way: each host runs the same
program on the same global data).

* axes ``("data", "model")``: interaction batches split over ``data``;
  the embedding tables (``v_u``, ``v_i``, ``w_i`` and the feature matrices
  ``x_uf``, ``x_if``) are row-sharded over ``model`` on the table-parallel
  path; the small dense feature weights replicate;
* rank ``r`` sits at ``(r // model, r % model)``, the JAX package's
  ``devices.reshape(data, model)``;
* the collectives are NCCL's on CUDA tensors and gloo's on CPU tensors,
  over the ``data`` group, the ``model`` group or the world group. A group
  of one rank runs no collective.

``mesh.trace`` set to a list records every collective the port runs (its
tag, axis, bytes and time: CUDA events on the card, host seconds on the
CPU); `Mesh.collective_stats` sums it. Off (``None``), it costs nothing.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

def _env_int(name, default):
    v = os.environ.get(name)
    return int(v) if v else default


def init_distributed(init_method=None, world_size=None, rank=None,
                     backend=None):
    """Start the process group (idempotent).

    ``torchrun`` sets ``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``, so the
    zero-argument call is enough there; elsewhere pass ``init_method``
    (``tcp://host:port`` or ``file:///path``), ``world_size`` and ``rank``.
    The backend is ``nccl`` when the machine has a CUDA device, else
    ``gloo``; ``backend='gloo'`` for CUDA tensors is an explicit choice
    (several ranks on one card).

    The JAX package's policy, mapped to torch's environment: a failure
    raises when ``init_method`` was given, and when the environment
    expects a cluster (``MASTER_ADDR`` set or ``WORLD_SIZE`` above 1), so
    that no rank goes on as a silently diverged single-process run. The
    zero-argument call with none of them set is a single-process run and
    does nothing."""
    if dist.is_initialized():
        return
    expects_cluster = (bool(os.environ.get("MASTER_ADDR"))
                       or _env_int("WORLD_SIZE", 1) > 1)
    if init_method is None and not expects_cluster:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if init_method is not None:
        kwargs = dict(init_method=init_method, world_size=world_size,
                      rank=rank)
    dist.init_process_group(backend, **kwargs)


class Mesh:
    """This rank's place on a ``(data, model)`` mesh and its groups.

    ``shape`` is ``{"data": d, "model": m}`` (the JAX ``mesh.shape`` that
    the planner reads), ``rank`` the world rank, ``data_rank`` /
    ``model_rank`` its coordinates, ``device`` where its tensors live."""

    def __init__(self, data, model, rank, device, groups):
        self.shape = {"data": data, "model": model}
        self.size = data * model
        self.rank = rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.device = device
        self._groups = groups       # axis -> process group (None: default)
        self.trace = None

    def axis_size(self, axis=None):
        return self.size if axis is None else self.shape[axis]

    def _run(self, tag, axis, nbytes, fn):
        if self.trace is None:
            return fn()
        if self.device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn()
            end.record()
            self.trace.append((tag, axis or "world", nbytes, (start, end)))
        else:
            t0 = time.perf_counter()
            out = fn()
            self.trace.append((tag, axis or "world", nbytes,
                               time.perf_counter() - t0))
        return out

    def all_reduce(self, t, axis=None, tag="all_reduce"):
        """Sum ``t`` in place over ``axis`` ('data', 'model', or None for
        every rank) and return it; ``tag`` names it in ``trace``."""
        if self.axis_size(axis) > 1:
            g = self._groups[axis or "world"]
            self._run(tag, axis, t.numel() * t.element_size(),
                      lambda: dist.all_reduce(t, group=g))
        return t

    def all_gather(self, t, axis=None, tag="all_gather"):
        """``[t of rank 0 of the group, t of rank 1, ...]`` over ``axis``,
        in the order of the axis's index."""
        if self.axis_size(axis) == 1:
            return [t]
        g = self._groups[axis or "world"]
        out = [torch.empty_like(t) for _ in range(self.axis_size(axis))]
        self._run(tag, axis,
                  t.numel() * t.element_size() * self.axis_size(axis),
                  lambda: dist.all_gather(out, t.contiguous(), group=g))
        return out

    def merge_deltas(self, tables, snaps, axis=None):
        """``tables[k] <- snaps[k] + sum over the ranks of (tables[k] -
        snaps[k])``, in place: ONE all-reduce of every table's f32 delta
        against its snapshot (the JAX package's delta ``psum``)."""
        flat = torch.cat([(t - s).reshape(-1) for t, s in zip(tables, snaps)])
        self.all_reduce(flat, axis, tag="delta_merge")
        off = 0
        for t, s in zip(tables, snaps):
            n = t.numel()
            torch.add(s, flat[off:off + n].view_as(t), out=t)
            off += n

    def collective_stats(self):
        """``{(tag, axis): (calls, bytes, ms)}`` of the recorded
        collectives (synchronizes the card)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out = {}
        for tag, axis, nbytes, t in self.trace or ():
            ms = (t[0].elapsed_time(t[1]) if isinstance(t, tuple)
                  else 1e3 * t)
            n, b, tot = out.get((tag, axis), (0, 0, 0.0))
            out[(tag, axis)] = (n + 1, b + nbytes, tot + ms)
        return out


def make_mesh(data=None, model=None, device=None, backend=None):
    """Create this rank's ``(data, model)`` mesh over the process group of
    `init_distributed` (or of one process, when none was started).

    With no arguments, every rank is on the data axis (pure DP); ``data *
    model`` must equal the world size. ``device`` defaults to
    ``cuda:<LOCAL_RANK>`` (the rank when ``LOCAL_RANK`` is unset); pass
    ``'cpu'`` for the CPU, or one ``cuda:k`` for several ranks on one card
    (with ``backend='gloo'``: NCCL refuses two ranks on one device). The
    groups take ``backend`` (default: the process group's); NCCL needs
    CUDA tensors. Every rank must call this, in the same order as any
    other group it creates."""
    initialized = dist.is_initialized()
    n = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if data is None and model is None:
        data, model = n, 1
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    assert data * model == n, f"mesh {data}x{model} != {n} devices"

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device (pass device='cpu' "
                               "for a mesh on the CPU)")
        local = _env_int("LOCAL_RANK", rank)
        if local >= torch.cuda.device_count():
            raise ValueError(
                f"make_mesh: rank {rank} wants cuda:{local}, the machine has "
                f"{torch.cuda.device_count()} card(s); several ranks on one "
                "card take device='cuda:0' and backend='gloo'")
        device = f"cuda:{local}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if backend is None and initialized:
        backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"make_mesh: the nccl backend needs a CUDA device, "
                         f"not {device}")

    groups = {"world": None}
    if initialized:
        # every rank creates every group, in one order
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)],
                               backend=backend)
            if m == rank % model:
                groups["data"] = g
        for d in range(data):
            g = dist.new_group([d * model + m for m in range(model)],
                               backend=backend)
            if d == rank // model:
                groups["model"] = g
        if backend != dist.get_backend():
            groups["world"] = dist.new_group(list(range(n)), backend=backend)
    return Mesh(data, model, rank, device, groups)


def weight_shardings(mesh):
    """How each weight is laid out on the table-parallel path: the mesh axis
    each dimension is split over (``None``: whole), as the JAX package's
    ``PartitionSpec``s. The big tables row-shard over ``model``; the small
    dense feature weights replicate (``()``)."""
    del mesh  # the layout is the same on every mesh
    return {"w_i": ("model",), "v_u": ("model", None),
            "v_i": ("model", None), "w_if": (), "v_uf": (), "v_if": ()}


def feature_shardings(mesh):
    """``x_uf [U, P]`` / ``x_if [I, Q]`` row-shard like their tables."""
    del mesh
    return {"x_uf": ("model", None), "x_if": ("model", None)}


def batch_sharding(mesh):
    """Per-interaction arrays split over the ``data`` axis."""
    del mesh
    return ("data",)
