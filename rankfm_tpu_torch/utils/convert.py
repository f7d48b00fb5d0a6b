"""Moving parameters between `rankfm_tpu` (numpy / JAX arrays) and the port.

* `weights_from_numpy` / `weights_to_numpy`: the weight dict
  ``{w_i, w_if, v_u, v_i, v_uf, v_if}`` as tensors on a device, and back;
* `tables_from_jax` / `tables_to_jax`: the JAX fused kernel's ``[rows, 128]``
  tables (factors in cols ``0..F-1``, col F = 1 or the item bias, col F+1
  the kernel's zeroed count lane) and the port's ``[rows, F+2]`` tables,
  which hold the same first F+2 columns;
* `feature_tables_from_jax` / `feature_tables_to_jax`: the JAX fused
  kernel's ``[128, 128]`` feature tables (``v_uf``; ``v_if`` with ``w_if``
  in col F) and the port's ``[P, F+2]`` / ``[Q, F+2]`` tables.
"""

from __future__ import annotations

import numpy as np
import torch

JAX_LANES = 128


def weights_from_numpy(w, device):
    """``{name: array}`` -> ``{name: f32 tensor on device}`` (copies)."""
    return {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
            for k, v in w.items()}


def weights_to_numpy(w):
    """``{name: tensor}`` -> ``{name: f32 numpy array}`` (copies: on the CPU
    ``.numpy()`` alone would be a view of the live tensor)."""
    return {k: v.detach().cpu().numpy().astype(np.float32, copy=not v.is_cuda)
            for k, v in w.items()}


def tables_from_jax(tab, factors, device):
    """A JAX fused table ``[rows, 128]`` -> the port's ``[rows, F+2]``."""
    return torch.tensor(np.asarray(tab, dtype=np.float32)[:, :factors + 2],
                        device=device)


def tables_to_jax(tab):
    """The port's ``[rows, F+2]`` table -> a JAX-layout ``[rows, 128]``
    numpy array (zero lanes beyond F+1)."""
    t = tab.detach().cpu().numpy()
    out = np.zeros((t.shape[0], JAX_LANES), dtype=np.float32)
    out[:, :t.shape[1]] = t
    return out


def feature_tables_from_jax(tab_uf, tab_if, num_uf, num_if, factors, device):
    """The JAX fused kernel's ``[128, 128]`` feature tables -> the port's
    ``tab_uf [num_uf, F+2]`` and ``tab_if [num_if, F+2]``."""
    def cut(tab, rows):
        return torch.tensor(
            np.asarray(tab, dtype=np.float32)[:rows, :factors + 2],
            device=device)
    return cut(tab_uf, num_uf), cut(tab_if, num_if)


def feature_tables_to_jax(tab_uf, tab_if):
    """The port's feature tables -> JAX-layout ``[128, 128]`` numpy arrays
    (zero rows and lanes beyond the port's)."""
    out = []
    for tab in (tab_uf, tab_if):
        t = tab.detach().cpu().numpy()
        o = np.zeros((JAX_LANES, JAX_LANES), dtype=np.float32)
        o[:t.shape[0], :t.shape[1]] = t
        out.append(o)
    return tuple(out)
