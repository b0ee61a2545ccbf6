"""On a card: one traced run of each tiny cell through the card's path
(the profiler, the per-layer readers, the device line)."""

import time

import pytest
import torch

from bench import harness


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["deepseek-v2-236b-l8.tiny",
                                  "mixtral-8x7b-l16.tiny"])
def test_traced_run_on_the_card(tiny, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = harness.run(cell, 2**31 + 3, 3.0, True, time.monotonic(), bench=tiny)
    dev = r["device"]
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] < dev["window_s"]
    assert {"tick_ms", "mfu", "device_idle_share"} <= set(r["metrics"])
    assert r["breakdown"]["device_ops"]
