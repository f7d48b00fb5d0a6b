"""Plain PyTorch WARP/BPR fit of the reduced factorization machine.

The reference that the fit cells hold the program's fits against. It runs
the model, the loss and the update rule that the configuration states, from
its own draws, in the precision it is given:

- utility ``s(u, i) = w_i[i] + x_if[i]·w_if + v_u[u]·(v_i[i] + v_ifᵀ x_if[i])``
  (no user features, no uf x if term);
- chunk-synchronous SGD: each epoch visits the training rows in a random
  order, `CHUNK_ROWS` rows at a time, every row of a chunk scored against
  the tables as they were at the chunk's start;
- WARP's negative in closed form over a window of `WINDOW_ITEMS` items
  that each chunk draws uniformly from the catalog (the whole catalog when
  it is no larger): the draw count is ``min(M, 1 + Geometric(violators /
  non-members))`` over the window; a uniform violator (``pw < 1``) when one
  is found within ``M`` draws, else the hardest non-violating non-member
  of a Bernoulli(``M / non-members``) subset (the ``M`` draws that found no
  violator held none); the multiplier is
  ``log(max((I - 1) // sampled, 1)) / log(I)``;
- the step ``d = sw * mult * sigmoid(-pw)`` and the log-likelihood term
  ``log sigmoid(pw)`` of each row with a negative;
- per-touch L2 decay with the geometric correction: a row touched ``k``
  times in a chunk becomes ``c^k w + eta (1 - c^k) / (k (1 - c)) sum(g)``,
  ``c = 1 - 2 eta alpha`` for user and item rows, ``1 - 2 eta beta`` for the
  item-feature rows (each touched by the rows whose positive and negative
  differ in it; its bias column by every row with a negative);
- ``eta = learning_rate / (epoch + 1) ** learning_exponent`` under
  ``invscaling``.

`CHUNK_ROWS` and `WINDOW_ITEMS` are the reference's own choices, the same
for every configuration and whatever the program plans: the published
reference updates after every row, which a plain fit of some 10^7
row-epochs cannot afford, so the reference updates per chunk of 128 rows
(as near to one row as its time allows; the size the program's planner
calls its oracle-parity chunk), and scores each chunk's negatives among
4,096 uniform items (the whole catalog of ML-1M). The unit of synchronous
update is part of what a fit computes (a row of the item-feature weights,
touched by every row of a chunk, settles where its decay over a chunk
balances the chunk's mean gradient), so a program that plans other chunks
reads a little farther from the reference; the limits are set from runs of
the program as it plans.

Nothing here imports the program. Matrix products run with TF32 off
(the float32 that the configurations state).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fmbench.reference.fitstats import no_tf32

MARGIN = 1.0
CHUNK_ROWS = 128
WINDOW_ITEMS = 4096
FAULTS = (None, "unchanged", "half", "token")


def decay_rows(wt, grad, counts, eta, c):
    """``c^k wt + eta (1 - c^k) / (k (1 - c)) grad`` row by row, ``k`` the
    row's touches; rows with ``k = 0`` keep their value."""
    if wt.dim() > counts.dim():
        counts = counts[..., None]
    ck = torch.pow(c, counts)
    denom = counts * (1.0 - c)
    f = torch.where(denom > 0, (1.0 - ck) / torch.clamp(denom, min=1e-30),
                    torch.ones_like(denom))
    return ck * wt + eta * f * grad


def select(pw, nonmem, u01, r1, M, num_items):
    """``(chosen [C], has_neg [C], mult [C])``: each row's negative by the
    closed-form WARP rule (BPR: ``M = 1``, a uniform non-member)."""
    neg_inf = float("-inf")
    log_I = math.log(num_items) if num_items > 1 else 1.0
    if M == 1:
        key = torch.where(nonmem, u01, neg_inf)
        mult = torch.full_like(r1, math.log(max(num_items - 1, 1)) / log_I)
    else:
        viol = (pw < MARGIN) & nonmem
        nv = viol.sum(1).to(torch.float32)
        n_non = nonmem.sum(1).to(torch.float32)
        p = torch.clamp(nv / torch.clamp(n_non, min=1.0), 1e-9, 1.0 - 1e-7)
        geo = torch.floor(torch.log(torch.clamp(1.0 - r1.float(), min=1e-30))
                          / torch.log(1.0 - p)) + 1.0
        geo = torch.where(nv > 0, geo, torch.full_like(geo, float(M)))
        found = (nv > 0) & (geo <= M)
        sampled = torch.clamp(geo, max=float(M))
        in_subset = u01 < (M / torch.clamp(n_non, min=1.0))[:, None].to(
            u01.dtype)
        key = torch.where(
            found[:, None], torch.where(viol, u01, neg_inf),
            torch.where(nonmem & ~viol & in_subset, -pw, neg_inf))
        ratio = torch.clamp(torch.floor((num_items - 1) / sampled), min=1.0)
        mult = (torch.log(ratio) / log_I).to(pw.dtype)
    best = key.max(1)
    return best.indices, best.values > float("-inf"), mult


def fit(train, sw, x_if, num_users, num_items, model, epochs, *, seed,
        device, dtype=torch.float32, tf32=False, fault=None):
    """Fit from scratch. ``train [n, 2]`` int64 indices into ``num_users`` /
    ``num_items``, ``sw [n]`` or None, ``x_if [num_items, Q]`` or None,
    ``model`` the configuration's hyperparameters, ``epochs`` its epochs.
    Returns ``(tables, lls)``: the
    tables as float32 numpy arrays keyed ``v_u``, ``v_i``, ``w_i`` (and
    ``v_if``, ``w_if`` with item features), and each epoch's
    log-likelihood.

    On a card each chunk size's step is recorded once as a CUDA graph and
    replayed chunk after chunk (the step reads its rows through a chunk
    counter on the device), so the fit costs its device time and not the
    launches of some sixty small operations a chunk.

    ``fault`` plants one of the faults a fit can have, to show that the
    comparison catches it: ``"unchanged"`` (no update is applied),
    ``"half"`` (half of each chunk is left out and the log-likelihood is
    the rest's, scaled to the whole) or ``"token"`` (every positive item
    id is altered by a fixed permutation of the catalog where the rows are
    read, as a broken id map would). ``dtype`` and ``tf32`` (matrix products
    in TF32) give the control's lower precisions."""
    assert fault in FAULTS, fault
    with no_tf32(tf32):
        return _Fit(train, sw, x_if, num_users, num_items, model,
                    WINDOW_ITEMS, seed, device, dtype, fault).run(
                        [CHUNK_ROWS] * epochs)


class _Fit:
    def __init__(self, train, sw, x_if, U, I, model, window, seed, device,
                 dtype, fault):
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
        self.beta = model.get("beta", 0.1)
        sigma = model.get("sigma", 0.1)
        self.lr = model.get("learning_rate", 0.1)
        self.expo = model.get("learning_exponent", 0.25)
        self.invscaling = model.get("learning_schedule",
                                    "constant") == "invscaling"
        self.U, self.I, self.n = U, I, len(train)
        self.W = window if window < I else None
        g = self.gen
        # tables: users [U, F]; items [I, F+1] and item features [Q, F+1]
        # (factors | bias)
        self.tab_u = (torch.randn(U, F, generator=g, device=dev)
                      * sigma).to(dtype)
        self.tab_i = torch.zeros(I, F + 1, device=dev, dtype=dtype)
        self.tab_i[:, :F] = (torch.randn(I, F, generator=g, device=dev)
                             * sigma).to(dtype)
        self.has_if = x_if is not None
        if self.has_if:
            Q = self.Q = x_if.shape[1]
            self.xf = torch.as_tensor(x_if, device=dev).to(dtype)
            self.tab_f = torch.zeros(Q, F + 1, device=dev, dtype=dtype)
            self.tab_f[:, :F] = (torch.randn(Q, F, generator=g, device=dev)
                                 * (self.alpha / self.beta) * sigma).to(dtype)
        self.u_all = torch.as_tensor(train[:, 0], device=dev)
        self.i_all = torch.as_tensor(train[:, 1], device=dev)
        self.member = torch.zeros(U, I, dtype=torch.bool, device=dev)
        self.member[self.u_all, self.i_all] = True
        if fault == "token":
            remap = torch.randperm(I, generator=g, device=dev)
            self.i_all = remap[self.i_all]
        self.w_all = (torch.ones(self.n, device=dev) if sw is None
                      else torch.as_tensor(sw, device=dev)).to(dtype)
        self.eta = torch.zeros((), device=dev, dtype=dtype)
        self.c = torch.zeros((), device=dev, dtype=dtype)
        self.cf = torch.zeros((), device=dev, dtype=dtype)
        self.ll = torch.zeros((), device=dev, dtype=torch.float64)
        self.bufs = {}

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
        state = [self.tab_u, self.tab_i, self.ll, b["t"]] + (
            [self.tab_f] if self.has_if else [])
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
        if self.has_if:
            rep = self.tab_i + self.xf @ self.tab_f       # [I, F+1]
        else:
            rep = self.tab_i
        ir, ib = rep[:, :F], rep[:, F]
        ur = self.tab_u[u]
        s_pos = (ur * ir[i]).sum(1) + ib[i]
        if self.W is None:
            nonmem = ~self.member[u]
            scores = torch.addmm(ib[None, :], ur, ir.T)           # [C, I]
        else:
            win = torch.randint(0, I, (self.W,), generator=self.gen,
                                device=dev)
            nonmem = ~self.member[u[:, None], win[None, :]]
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
        """Per-touch decayed updates of every table from one chunk's
        gradients, all read from the chunk-start tables."""
        F, dt, dev = self.F, self.dtype, self.dev
        dc = d[:, None]
        # users: gradient (F columns) and touches (a last column)
        g_u = torch.cat([dc * (rep[i, :F] - rep[j, :F]), vr[:, None]], 1)
        acc_u = torch.zeros(self.U, F + 1, device=dev, dtype=dt).index_add_(
            0, u, g_u)
        # items: the positive's row then the negative's, bias in column F
        g_it = torch.cat([dc * ur, dc], 1)
        acc_i = torch.zeros(self.I, F + 2, device=dev, dtype=dt).index_add_(
            0, torch.cat([i, j]),
            torch.cat([torch.cat([g_it, vr[:, None]], 1),
                       torch.cat([-g_it, gate[:, None]], 1)]))
        if self.has_if:
            diff = self.xf[i] - self.xf[j]                        # [C, Q]
            g_f = diff.T @ g_it                                   # [Q, F+1]
            cnt_f = ((diff != 0).to(dt) * gate[:, None]).sum(0)
            n_ok = gate.sum().expand(self.Q)
            self.tab_f.copy_(torch.cat([
                decay_rows(self.tab_f[:, :F], g_f[:, :F], cnt_f, self.eta,
                           self.cf),
                decay_rows(self.tab_f[:, F], g_f[:, F], n_ok, self.eta,
                           self.cf)[:, None]], 1))
        self.tab_u.copy_(decay_rows(self.tab_u, acc_u[:, :F], acc_u[:, F],
                                    self.eta, self.c))
        self.tab_i.copy_(decay_rows(self.tab_i, acc_i[:, :F + 1],
                                    acc_i[:, F + 1], self.eta, self.c))

    def run(self, chunks):
        lls = []
        for epoch, C in enumerate(chunks):
            eta = (self.lr / (epoch + 1) ** self.expo if self.invscaling
                   else self.lr)
            self.eta.fill_(eta)
            self.c.fill_(max(1.0 - 2.0 * eta * self.alpha, 1e-8))
            self.cf.fill_(max(1.0 - 2.0 * eta * self.beta, 1e-8))
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
        if self.has_if:
            t.update(v_if=self.tab_f[:, :F], w_if=self.tab_f[:, F])
        out = {k: v.float().cpu().numpy() for k, v in t.items()}
        self.bufs.clear()
        return out, np.array(lls)
