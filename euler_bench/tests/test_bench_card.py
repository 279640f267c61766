"""The harness on the card at a tiny cell: traced and untraced runs are
correct, and the trace yields the per-layer metrics within their range."""

import time

import pytest

from euler_bench import run
from euler_bench.tests.conftest import TINY, TINY_CLEAN


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, tiny_root, trace):
    out = run.run_cell(TINY, 2**31 + 3, 1.0, trace, device="cuda", root=tiny_root, t_start=time.perf_counter())
    assert out["correct"] and out["device"]["platform"] == "gpu"
    if trace:
        m = out["metrics"]
        assert 0.0 < m["extract_roofline_pct"]["value"] <= 105.0
        assert 0.0 <= m["device_idle_pct"]["value"] < 100.0
        assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]
    else:
        assert out["metrics"]["peak_device_gib"]["value"] > 0
        assert out["metrics"]["device_busy_s"]["value"] > 0  # the untraced window under the device's activity


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cleaning_cell_on_the_card(card, tiny_root, trace):
    out = run.run_cell(TINY_CLEAN, 2**31 + 5, 1.0, trace, device="cuda", root=tiny_root, t_start=time.perf_counter())
    assert out["correct"] and out["device"]["platform"] == "gpu"
    if trace:
        assert out["metrics"]["clean_s"]["value"] > 0
