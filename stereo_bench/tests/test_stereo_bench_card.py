"""A short run of each cell on the card (skips without one)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from stereo_bench import spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode on this path")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_a_short_run_is_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "-m", "stereo_bench.run", "--workload", cell,
                          "--seed", str(2**31 + 11), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["device"]["busy_s"] > 0 and list(res)[-1] == "checks"
    assert set(res["metrics"]) <= {m["name"] for m in spec.metrics_for(cell, "per_layer")}
