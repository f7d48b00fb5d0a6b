"""`rankfm_tpu_torch.utils.observe` on the CPU."""

import json

import numpy as np
import torch

from rankfm_tpu_torch import RankFM
from rankfm_tpu_torch.utils import observe

from torch_common import one_torch_thread  # noqa: F401


def test_device_memory_stats_on_the_cpu_is_empty():
    assert observe.device_memory_stats("cpu") == {}
    assert observe.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert observe.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    rng = np.random.default_rng(0)
    train = np.stack([rng.integers(0, 30, 400), rng.integers(0, 50, 400)], 1)
    log_dir = tmp_path / "traces" / "fit"             # created on demand
    with observe.trace(log_dir):
        model = RankFM(factors=4, device="cpu").fit(train, epochs=1)
    assert model.is_fit
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    try:
        with observe.trace(tmp_path):
            torch.ones(4).sum()
            raise KeyError("boom")
    except KeyError:
        pass
    assert len(list(tmp_path.glob("trace_*.json"))) == 1
