"""The run's contract on the CPU: without a card it exits non-zero and
prints no result; the result line's keys, the numbers compared last, and
no number under a device metric."""
import json
import os
import subprocess
import sys
from pathlib import Path

from perfbench import harness

from helpers import run

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
DEVICE_METRICS = {m["name"] for m in harness.manifest()["per_layer"]
                  + harness.manifest()["end_to_end"]
                  if m["source"] == "device_trace"} | {"peak_mem_gib"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "bb144-p0.004",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_result_keys_untraced():
    result = run()
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"conv_mismatch", "decode_mismatch"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert not DEVICE_METRICS & set(result["metrics"])
    json.dumps(result)


def test_result_keys_traced():
    result = run(traced=True)
    assert all(k in result for k in KEYS)
    assert list(result)[-1] == "checks"
    # no device on the CPU: no trace of it, no device metric, no breakdown
    assert not DEVICE_METRICS & set(result["metrics"])
    assert "breakdown" not in result
    assert "issue_ms" in result["metrics"]
