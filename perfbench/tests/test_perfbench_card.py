"""A short run of a real cell on the card: the result line of a traced run
carries the device's busy and window seconds and the breakdown, every
per-layer metric the cell reports, and ``correct``; the BP kernel's
roofline share lies in (0, 100], with its bound and summed time noted."""
import time

import pytest

from perfbench import harness


@pytest.mark.card
@pytest.mark.parametrize("workload, roofline", [
    ("bb144-p0.004", "k1_roofline"),
    ("bb144-p0.004-layered", "k3_roofline")])
def test_traced_run_on_the_card(card, workload, roofline):
    man = harness.manifest()
    lines = []
    result = harness.run_cell(workload, 2**31 + 99, 2.0, True, card,
                              time.time(), man,
                              log=lambda *a, **k: lines.append(a[0]))
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    dev = result["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    for key in ("device_ops", "idle_gaps"):
        assert 0 < len(result["breakdown"][key]) <= 10
    cell = {"name": workload}
    assert {m["name"] for m in harness.metrics_of(man, cell, True)} == \
        set(result["metrics"])
    assert 0 < result["metrics"][roofline]["value"] <= 100
    assert any(line.startswith(f"{roofline}: compute bound")
               for line in lines)
