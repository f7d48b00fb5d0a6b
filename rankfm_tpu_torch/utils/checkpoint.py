"""Model checkpointing (port of `rankfm_tpu/utils/checkpoint.py`): the weight
dict, feature matrices, id maps, interaction history CSR and hyperparameters
in a single ``.npz``, so a fitted model can be restored (and `fit_partial`
resumed) in a fresh process.

The file is the JAX package's, key for key: a model saved by either package
loads in the other and serves the same lists. ``device`` is therefore not
among the saved hyperparameters (`rankfm_tpu.RankFM` has no such argument);
`load_model` takes it as a keyword.

The payload is pickle-free by construction: numeric arrays, fixed-width
unicode arrays (string ids, JSON blobs) — nothing with object dtype — so
``load_model`` reads with ``allow_pickle=False`` and an untrusted checkpoint
cannot execute code. Old checkpoints that stored string ids as object arrays
load with the explicit ``allow_pickle=True`` opt-in.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pandas as pd
import torch

_WEIGHT_KEYS = ("w_i", "w_if", "v_u", "v_i", "v_uf", "v_if")
# every constructor argument except `mesh` and `device` (where the model
# runs: the caller says so again at load)
_HYPERS = ("factors", "loss", "max_samples", "alpha", "beta", "sigma",
           "learning_rate", "learning_schedule", "learning_exponent",
           "batch_size", "seed", "sample_rounds", "neg_sampler", "use_fused",
           "train_step", "n_windows", "tail_windows", "shuffle_layouts",
           "dp_sync_every")


def _id_array(vals, kind):
    """Coerce an id vocabulary to a pickle-free dtype. Integer/float/unicode
    arrays pass through; object arrays of str (what pandas produces for
    string id columns) become fixed-width unicode. Anything else cannot
    round-trip without pickle — refuse loudly rather than write a
    pickle-bearing payload."""
    arr = np.asarray(vals)
    if arr.dtype.kind != "O":
        return arr
    if all(isinstance(v, str) for v in arr.tolist()):
        return arr.astype(str)
    raise TypeError(
        f"[{kind}] ids must be int or str to checkpoint without pickle "
        f"(got object values like {arr[:1].tolist()!r})")


def save_model(model, path):
    assert model.is_fit, "you must fit the model prior to saving it"
    weights = model._weights
    payload = {f"weights/{k}": weights[k] for k in _WEIGHT_KEYS}
    payload["x_uf"] = model.x_uf
    payload["x_if"] = model.x_if
    payload["user_id"] = _id_array(model.user_id.values, "user")
    payload["item_id"] = _id_array(model.item_id.values, "item")
    payload["ui_offsets"] = model._ui_offsets
    payload["ui_items"] = model._ui_items
    payload["interactions"] = model.interactions
    payload["sample_weight"] = model.sample_weight
    # JSON blobs ride as 0-d unicode arrays ('<U*' dtype — no pickle needed)
    payload["hyper_json"] = np.array(
        json.dumps({k: getattr(model, k) for k in _HYPERS})
    )
    payload["training_log_json"] = np.array(json.dumps(model.training_log_))
    # epoch stream position: a restored model's fit_partial must continue
    # with FRESH shuffle/negative streams, not replay epochs 0..N again
    payload["epoch_offset"] = np.int64(model._epoch_offset)
    np.savez(path, **payload)


def load_model(cls, path, allow_pickle=False, device="cuda"):
    # np.savez appends ".npz" to extension-less paths; accept either spelling
    if not os.path.exists(path) and os.path.exists(str(path) + ".npz"):
        path = str(path) + ".npz"
    data = np.load(path, allow_pickle=allow_pickle)
    hyper = json.loads(str(data["hyper_json"]))
    positional = ("factors", "loss", "max_samples", "alpha", "beta", "sigma",
                  "learning_rate", "learning_schedule", "learning_exponent")
    extras = {k: v for k, v in hyper.items() if k not in positional}
    model = cls(**{k: hyper[k] for k in positional}, **extras, device=device)
    if "training_log_json" in data:
        model.training_log_ = json.loads(str(data["training_log_json"]))

    model.user_id = pd.Series(data["user_id"])
    model.item_id = pd.Series(data["item_id"])
    model.index_to_user = model.user_id
    model.index_to_item = model.item_id
    model.user_to_index = pd.Series(data=model.user_id.index, index=model.user_id.values)
    model.item_to_index = pd.Series(data=model.item_id.index, index=model.item_id.values)
    model.user_idx = np.arange(len(model.user_id), dtype=np.int32)
    model.item_idx = np.arange(len(model.item_id), dtype=np.int32)

    model.interactions = data["interactions"]
    model.sample_weight = data["sample_weight"]
    model._ui_offsets = data["ui_offsets"]
    model._ui_items = data["ui_items"]
    dev = model.device
    model._offsets_dev = torch.from_numpy(model._ui_offsets).to(dev)
    model._flat_items_dev = torch.from_numpy(model._ui_items).to(dev)

    model.x_uf = data["x_uf"]
    model.x_if = data["x_if"]
    model._x_uf_dev = torch.from_numpy(model.x_uf).to(dev)
    model._x_if_dev = torch.from_numpy(model.x_if).to(dev)

    model._weights = {k: data[f"weights/{k}"] for k in _WEIGHT_KEYS}
    if "epoch_offset" in data:
        model._epoch_offset = int(data["epoch_offset"])
    # `_sampler` stays None, as in the JAX package: `recommend` filters seen
    # items by scattering the history until the next `fit_partial` picks the
    # sampler again; the lists are the same either way
    model.is_fit = True
    return model
