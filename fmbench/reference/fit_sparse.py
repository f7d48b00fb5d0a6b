"""Plain PyTorch WARP/BPR fit with a sparse membership: `fmbench.reference.fit`
at catalogs whose ``[users, items]`` membership matrix does not fit.

The model, the loss, the update rule and the random draws are those of
`fmbench.reference.fit` (read its docstring): the same utility, chunks of
`CHUNK_ROWS` rows scored against the chunk-start tables, WARP's negative in
closed form over a window of `WINDOW_ITEMS` uniform items a chunk, the
multiplier, and per-touch decay with the geometric correction. Two things
differ, and neither changes a number:

- membership comes from each user's sorted row of distinct training items
  (a ``[U, longest row]`` table, padded), where `fit.py` indexes a dense
  ``[U, I]`` bool matrix (85 GB at 100,000 users by 910,000 items): a
  chunk's rows are searched for in its sorted window, and each item found
  marks the window's slots that hold it;
- a chunk's decayed update is applied to the rows it touches only: their
  gradients are summed into persistent accumulators, the rows are read
  back, decayed and written, and the accumulators' touched rows are set to
  zero again. `fit.py` rebuilds and decays both whole tables every chunk,
  where an untouched row keeps its value (``c^0 w + 0``), so both give the
  same tables.

Its draws come in `fit.py`'s order (the user table, the item table, the
token fault's permutation, each epoch's visit order, then per chunk the
window, the uniforms and the count draw), so on the same seed the two give
the same tables. Item features are not supported: the configurations that
this reference serves have none.

``init`` starts from given tables instead of drawn ones (a warm model's
refresh; its epochs are numbered from 0 for the learning-rate schedule, as
a ``fit_partial`` call's are). Matrix products run with TF32 off unless
``tf32``.
On a card each chunk size's step is one CUDA graph, replayed per chunk, as
in `fit.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from fmbench.reference.fit import (CHUNK_ROWS, FAULTS, WINDOW_ITEMS,
                                   decay_rows, select)
from fmbench.reference.fitstats import no_tf32


def fit(train, sw, num_users, num_items, model, epochs, *, seed, device,
        dtype=torch.float32, tf32=False, fault=None, init=None):
    """Fit ``epochs`` epochs. ``train [n, 2]`` int64 indices into
    ``num_users`` / ``num_items``, ``sw [n]`` or None, ``model`` the
    configuration's hyperparameters. ``init``: None to draw the tables as
    `fmbench.reference.fit.fit` draws them, else a dict of float32 arrays
    ``v_u``, ``v_i``, ``w_i`` to start from. Returns ``(tables, lls)`` as
    `fmbench.reference.fit.fit` does (without item-feature tables).
    ``fault`` is one of `fmbench.reference.fit.FAULTS`."""
    assert fault in FAULTS, fault
    with no_tf32(tf32):
        return _Fit(train, sw, num_users, num_items, model, WINDOW_ITEMS,
                    seed, device, dtype, fault, init).run(
                        [CHUNK_ROWS] * epochs)


class _Fit:
    def __init__(self, train, sw, U, I, model, window, seed, device, dtype,
                 fault, init):
        dev = self.dev = torch.device(device)
        if dev.type == "cuda":
            # the default generator: graph replays advance its offset
            torch.cuda.manual_seed(int(seed) % (1 << 63))
            self.gen = None
        else:
            self.gen = torch.Generator().manual_seed(int(seed) % (1 << 63))
        self.dtype, self.fault = dtype, fault
        F = self.F = model["factors"]
        self.M = 1 if model["loss"] == "bpr" else model["max_samples"]
        self.alpha = model.get("alpha", 0.01)
        sigma = model.get("sigma", 0.1)
        self.lr = model.get("learning_rate", 0.1)
        self.expo = model.get("learning_exponent", 0.25)
        self.invscaling = model.get("learning_schedule",
                                    "constant") == "invscaling"
        self.U, self.I, self.n = U, I, len(train)
        self.W = window if window < I else None
        g = self.gen
        # tables: users [U, F]; items [I, F+1] (factors | bias)
        self.tab_i = torch.zeros(I, F + 1, device=dev, dtype=dtype)
        if init is None:
            self.tab_u = (torch.randn(U, F, generator=g, device=dev)
                          * sigma).to(dtype)
            self.tab_i[:, :F] = (torch.randn(I, F, generator=g, device=dev)
                                 * sigma).to(dtype)
        else:
            # a copy: the tables are trained in place
            self.tab_u = torch.tensor(init["v_u"], device=dev, dtype=dtype)
            self.tab_i[:, :F] = torch.as_tensor(init["v_i"], device=dev)
            self.tab_i[:, F] = torch.as_tensor(init["w_i"], device=dev)
        self.u_all = torch.as_tensor(train[:, 0], device=dev)
        self.i_all = torch.as_tensor(train[:, 1], device=dev)
        # each user's distinct training items, ascending, padded with -1
        keys = torch.unique(self.u_all * I + self.i_all)        # sorted
        ku = keys // I
        counts = torch.bincount(ku, minlength=U)
        first = torch.cumsum(counts, 0) - counts
        self.rows = torch.full((U, max(int(counts.max()), 1)), -1,
                               dtype=torch.long, device=dev)
        self.rows[ku, torch.arange(len(keys), device=dev) - first[ku]] = (
            keys % I)
        if fault == "token":
            remap = torch.randperm(I, generator=g, device=dev)
            self.i_all = remap[self.i_all]
        self.w_all = (torch.ones(self.n, device=dev) if sw is None
                      else torch.as_tensor(sw, device=dev)).to(dtype)
        # the chunk's summed gradients and touches, zero outside a step
        self.acc_u = torch.zeros(U, F + 1, device=dev, dtype=dtype)
        self.acc_i = torch.zeros(I, F + 2, device=dev, dtype=dtype)
        self.eta = torch.zeros((), device=dev, dtype=dtype)
        self.c = torch.zeros((), device=dev, dtype=dtype)
        self.ll = torch.zeros((), device=dev, dtype=torch.float64)
        self.bufs = {}

    def member(self, u, win=None):
        """``[C, W]`` bool: is window slot ``w`` of ``win [W]`` a training
        item of user ``u[c]`` (``win`` None: the whole catalog, ``[C, I]``).
        Each item of a user's row marks the run of slots that hold it in
        the sorted window: +1 where the run starts, -1 past its end, and a
        running sum."""
        r = self.rows[u]                                         # [C, L]
        ok = r >= 0
        if win is None:
            pad = torch.where(ok, r, self.I)
            hit = torch.zeros(len(u), self.I + 1, dtype=torch.bool,
                              device=self.dev)
            return hit.scatter_(1, pad, True)[:, :self.I]
        ws, order = torch.sort(win)
        lo = torch.searchsorted(ws, r)
        hi = torch.searchsorted(ws, r, right=True)
        one = ok.to(torch.int32)
        d = torch.zeros(len(u), len(win) + 1, dtype=torch.int32,
                        device=self.dev)
        d.scatter_add_(1, lo, one).scatter_add_(1, hi, -one)
        in_sorted = torch.cumsum(d[:, :-1], 1) > 0
        return torch.empty_like(in_sorted).scatter_(
            1, order.expand(len(u), -1), in_sorted)

    def _buffers(self, C):
        """The static rows of one chunk size: ``perm [chunks, C]`` (an
        epoch's visit order, padded), ``valid [chunks, C]`` and the chunk
        counter ``t``; and the step that runs the counter's chunk."""
        if C not in self.bufs:
            nch = -(-self.n // C)
            valid = torch.zeros(nch * C, device=self.dev, dtype=self.dtype)
            valid[:self.n] = 1
            b = {"perm": torch.zeros(nch, C, dtype=torch.long,
                                     device=self.dev),
                 "valid": valid.view(nch, C), "chunks": nch,
                 "t": torch.zeros(1, dtype=torch.long, device=self.dev)}
            b["run"] = self._record(b) if self.dev.type == "cuda" else (
                lambda b=b: self._step(b))
            self.bufs[C] = b
        return self.bufs[C]

    def _record(self, b):
        """Capture the step of ``b`` as a CUDA graph, after one warm-up
        step on copies of the state."""
        state = [self.tab_u, self.tab_i, self.ll, b["t"]]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            saved = [x.clone() for x in state]
            self._step(b)
            for x, y in zip(state, saved):
                x.copy_(y)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._step(b)
        b["graph"] = graph
        return graph.replay

    def _step(self, b):
        F, I, dt, dev = self.F, self.I, self.dtype, self.dev
        rows = b["perm"].index_select(0, b["t"]).view(-1)
        vr = b["valid"].index_select(0, b["t"]).view(-1)
        C = rows.shape[0]
        if self.fault == "half":
            vr = vr * (torch.arange(C, device=dev) % 2 == 0).to(dt)
        u, i, w = self.u_all[rows], self.i_all[rows], self.w_all[rows]
        rep = self.tab_i
        ir, ib = rep[:, :F], rep[:, F]
        ur = self.tab_u[u]
        s_pos = (ur * ir[i]).sum(1) + ib[i]
        if self.W is None:
            nonmem = ~self.member(u)
            scores = torch.addmm(ib[None, :], ur, ir.T)           # [C, I]
        else:
            win = torch.randint(0, I, (self.W,), generator=self.gen,
                                device=dev)
            nonmem = ~self.member(u, win)
            scores = torch.addmm(ib[win][None, :], ur, ir[win].T)  # [C, W]
        pw = s_pos[:, None] - scores
        u01 = torch.rand(pw.shape, generator=self.gen, device=dev, dtype=dt)
        r1 = torch.rand(C, generator=self.gen, device=dev)
        slot, has_j, mult = select(pw, nonmem, u01, r1, self.M, I)
        j = slot if self.W is None else win[slot]
        keep = has_j & (vr > 0)
        gate = keep.to(dt)
        pw_sel = pw.gather(1, slot[:, None])[:, 0]
        d = gate * w * mult * torch.sigmoid(-pw_sel)
        ll_rows = torch.where(keep, torch.nn.functional.logsigmoid(pw_sel),
                              torch.zeros_like(pw_sel))
        self.ll += ll_rows.double().sum() * (
            2.0 if self.fault == "half" else 1.0)
        if self.fault != "unchanged":
            self._update(u, i, j, d, ur, rep, vr, gate)
        b["t"] += 1

    def _update(self, u, i, j, d, ur, rep, vr, gate):
        """Per-touch decayed updates of the rows one chunk touches, all
        gradients read from the chunk-start tables."""
        F = self.F
        dc = d[:, None]
        # users: gradient (F columns) and touches (a last column)
        g_u = torch.cat([dc * (rep[i, :F] - rep[j, :F]), vr[:, None]], 1)
        self.acc_u.index_add_(0, u, g_u)
        # items: the positive's row then the negative's, bias in column F
        g_it = torch.cat([dc * ur, dc], 1)
        ij = torch.cat([i, j])
        self.acc_i.index_add_(
            0, ij, torch.cat([torch.cat([g_it, vr[:, None]], 1),
                              torch.cat([-g_it, gate[:, None]], 1)]))
        for tab, acc, idx in ((self.tab_u, self.acc_u, u),
                              (self.tab_i, self.acc_i, ij)):
            a = acc[idx]
            # a row listed twice is written twice with the same value
            tab.index_copy_(0, idx, decay_rows(tab[idx], a[:, :-1], a[:, -1],
                                               self.eta, self.c))
            acc.index_fill_(0, idx, 0)

    def run(self, chunks):
        lls = []
        for epoch, C in enumerate(chunks):
            eta = (self.lr / (epoch + 1) ** self.expo if self.invscaling
                   else self.lr)
            self.eta.fill_(eta)
            self.c.fill_(max(1.0 - 2.0 * eta * self.alpha, 1e-8))
            b = self._buffers(C)
            perm = torch.randperm(self.n, generator=self.gen,
                                  device=self.dev)
            b["perm"].view(-1)[:self.n] = perm
            b["t"].zero_()
            self.ll.zero_()
            for _ in range(b["chunks"]):
                b["run"]()
            lls.append(float(self.ll))
        F = self.F
        t = {"v_u": self.tab_u, "v_i": self.tab_i[:, :F],
             "w_i": self.tab_i[:, F]}
        out = {k: v.float().cpu().numpy() for k, v in t.items()}
        self.bufs.clear()
        return out, np.array(lls)
