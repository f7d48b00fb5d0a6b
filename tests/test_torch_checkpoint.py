"""Checkpoints of the port (`rankfm_tpu_torch.utils.checkpoint`): the JAX
package's ``.npz``, written and read by either package.
"""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu.utils import checkpoint as jckpt
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch.utils import checkpoint as tckpt
from rankfm_tpu_torch.utils.convert import weights_to_numpy

from torch_common import one_torch_thread  # noqa: F401

CFG = dict(factors=4, loss="warp", max_samples=3, seed=9,
           neg_sampler="bsearch", train_step="candidate", n_windows=2)


def _data(seed=11, strings=False):
    rng = np.random.default_rng(seed)
    inter = pd.DataFrame({"user_id": rng.integers(100, 140, 500),
                          "item_id": rng.integers(1000, 1080, 500)})
    items = np.unique(inter["item_id"])
    itemf = pd.DataFrame({
        "item_id": items,
        "f0": rng.uniform(size=len(items)).astype(np.float32),
        "f1": (rng.uniform(size=len(items)) < 0.5).astype(np.float32)})
    if strings:
        inter = pd.DataFrame({"user_id": [f"u{k}" for k in inter["user_id"]],
                              "item_id": [f"it{k}" for k in inter["item_id"]]})
        itemf["item_id"] = [f"it{k}" for k in itemf["item_id"]]
    return inter, itemf


def _assert_serve_equal(a, b, inter):
    pairs = np.concatenate([inter.values[:60],
                            np.array([[inter.values[0, 0], inter.values[1, 1]]],
                                     dtype=inter.values.dtype)])
    np.testing.assert_allclose(a.predict(pairs), b.predict(pairs), atol=1e-5)
    users = list(inter["user_id"].unique()[:25])
    for fp in (False, True):
        pd.testing.assert_frame_equal(
            a.recommend(users, n_items=10, filter_previous=fp),
            b.recommend(users, n_items=10, filter_previous=fp))


@pytest.mark.parametrize("strings", [False, True], ids=["int-ids", "str-ids"])
@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port",
                                       "port-to-port"])
def test_checkpoint_crosses_packages(tmp_path, direction, strings):
    """A model saved by one package loads in the other with
    ``allow_pickle=False`` (string ids included) and serves the same
    lists; the payload has no object array."""
    inter, itemf = _data(strings=strings)
    sw = np.linspace(0.5, 2.0, len(inter)).astype(np.float32)
    src, dst = direction.split("-to-")
    make = {"port": lambda: TorchRankFM(**CFG, device="cpu"),
            "jax": lambda: JaxRankFM(**CFG)}
    m = make[src]().fit(inter, item_features=itemf, sample_weight=sw, epochs=2)
    path = str(tmp_path / "model")                    # np.savez appends .npz
    m.save(path)
    raw = np.load(path + ".npz", allow_pickle=False)
    assert all(raw[k].dtype.kind != "O" for k in raw.files)
    if dst == "port":
        m2 = TorchRankFM.load(path, device="cpu")     # without the extension
        m3 = TorchRankFM.load(path + ".npz", allow_pickle=False, device="cpu")
        assert m2.device == torch.device("cpu")
        _assert_serve_equal(m2, m3, inter)
    else:
        m2 = JaxRankFM.load(path)
    assert m2.neg_sampler == "bsearch" and m2.train_step == "candidate"
    assert m2.n_windows == 2 and m2.seed == 9
    assert len(m2.training_log_) == 2 and m2._epoch_offset == 2
    _assert_serve_equal(m, m2, inter)
    for k, v in m._weights.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(m2._weights[k]), err_msg=k)
    for name in ("interactions", "sample_weight", "_ui_offsets", "_ui_items",
                 "x_uf", "x_if"):
        np.testing.assert_array_equal(getattr(m, name), getattr(m2, name))
    np.testing.assert_array_equal(m.user_id.values, m2.user_id.values)
    # resume: histories and maps survived, training continues finite
    m2.fit_partial(inter, item_features=itemf, epochs=1)
    assert len(m2.training_log_) == 3
    assert np.isfinite(np.asarray(m2._weights["v_u"])).all()


def test_payload_has_the_reference_keys_and_no_device(tmp_path):
    inter, _ = _data()
    assert tckpt._HYPERS == jckpt._HYPERS and "device" not in tckpt._HYPERS
    assert tckpt._WEIGHT_KEYS == jckpt._WEIGHT_KEYS
    paths = {}
    for name, m in (("port", TorchRankFM(**CFG, device="cpu")),
                    ("jax", JaxRankFM(**CFG))):
        paths[name] = str(tmp_path / f"{name}.npz")
        m.fit(inter, epochs=1).save(paths[name])
    port, ref = (np.load(paths[k], allow_pickle=False) for k in ("port", "jax"))
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        assert port[k].dtype.kind == ref[k].dtype.kind, k
        assert port[k].shape == ref[k].shape, k
        if port[k].dtype.kind != "U":                 # text: the length varies
            assert port[k].dtype == ref[k].dtype, k
        if not k.startswith("weights/") and k != "training_log_json":
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    hyper = json.loads(str(port["hyper_json"]))
    assert list(hyper) == list(jckpt._HYPERS) and "device" not in hyper


def test_object_ids_that_are_not_str_raise(tmp_path):
    inter = pd.DataFrame({"user_id": np.array([1, "a", 2, "a", 1, 2],
                                              dtype=object),
                          "item_id": [5, 6, 7, 5, 6, 7]})
    m = TorchRankFM(factors=2, device="cpu").fit(
        inter.astype({"user_id": str}), epochs=1)
    m.user_id = pd.Series(np.array([1, "a", 2], dtype=object))
    with pytest.raises(TypeError, match="ids must be int or str"):
        m.save(str(tmp_path / "bad.npz"))
    with pytest.raises(AssertionError, match="fit the model"):
        TorchRankFM(factors=2, device="cpu").save(str(tmp_path / "unfit.npz"))


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_fit_partial_after_load_continues_the_epoch_stream(tmp_path, engine):
    """fit + save + load + fit_partial equals fit + fit_partial on the model
    that was never saved, bit for bit on the CPU."""
    inter, _ = _data()
    cfg = dict(factors=4, loss="warp", max_samples=3, seed=9, batch_size=256,
               use_fused=(engine == "fused"))
    a = TorchRankFM(**cfg, device="cpu").fit(inter, epochs=2)
    assert a.last_fit_plan_.fused == (engine == "fused")
    path = str(tmp_path / "resume.npz")
    a.save(path)
    b = TorchRankFM.load(path, device="cpu")
    assert b._rec_cache is None and b._ingest_hash is None  # nothing carried
    for m in (a, b):
        m.fit_partial(inter, epochs=2)
    assert a._epoch_offset == b._epoch_offset == 4
    for k, v in a._weights.items():
        np.testing.assert_array_equal(v, b._weights[k], err_msg=k)
    # and not the stream of epochs 0..1 again
    c = TorchRankFM.load(path, device="cpu")
    c._epoch_offset = 0
    c.fit_partial(inter, epochs=2)
    assert not np.array_equal(a._weights["v_u"], c._weights["v_u"])


def test_weights_setter_copies_and_converts():
    inter, _ = _data()
    m = TorchRankFM(factors=4, device="cpu").fit(inter, epochs=1)
    users = list(inter["user_id"].unique()[:10])
    rng = np.random.default_rng(0)
    w = {k: rng.normal(0, 0.3, v.shape) for k, v in m._weights.items()}  # f64
    m._weights = w
    for k, v in m._w.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        assert v.device == m.device
        np.testing.assert_array_equal(v.numpy(), w[k].astype(np.float32))
    before = m.recommend(users, n_items=5)
    for v in w.values():
        v += 1.0                                      # the caller's arrays
    pd.testing.assert_frame_equal(m.recommend(users, n_items=5), before)
    # tensors are taken too, and copied
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in w.items()}
    m._weights = t
    t["v_i"].zero_()
    assert float(m._w["v_i"].abs().sum()) > 0
    m._weights = None
    assert m._w is None and m._weights is None


def test_weights_to_numpy_returns_copies():
    inter, _ = _data()
    m = TorchRankFM(factors=4, device="cpu").fit(inter, epochs=1)
    users = list(inter["user_id"].unique()[:10])
    before = m.recommend(users, n_items=5, filter_previous=True)
    scores = m.predict(inter.values[:30])
    for arrays in (m._weights, weights_to_numpy(m._w)):
        for v in arrays.values():
            assert v.dtype == np.float32
            v[...] = 123.0
    pd.testing.assert_frame_equal(
        m.recommend(users, n_items=5, filter_previous=True), before)
    np.testing.assert_array_equal(m.predict(inter.values[:30]), scores)
