"""``correct`` on a whole run, driven on the CPU at a tiny size (the look
for a card skipped): true for the port as it is; false with the timed path
broken underneath (an answer altered where it is produced; half of each
batch left out); and the control (the reference in bfloat16) fails the
limits."""

import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
from stereo_bench import control, run, spec

SHAPE = (80, 160)


def _cell(traffic="replay-b8"):
    """A cell of the block-matching configuration, from its data files."""
    return {"name": f"euroc-bm.{traffic}", "config": "euroc-bm", "traffic": traffic, "chips": 1,
            "config_data": dict(spec.load_json("configs", "euroc-bm"), check={"sample_pairs": 16}),
            "traffic_data": dict(spec.load_json("traffic", traffic), pool_pairs=8, warmup_s=0.3)}


def _run(traffic="replay-b8", seconds=2.5):
    return run.execute(_cell(traffic), 2**31 + 3, seconds, False, torch.device("cpu"),
                       shape=SHAPE)


@pytest.mark.parametrize("traffic", ["replay-b8", "perpair"])
def test_sound_run_is_correct(traffic):
    out = _run(traffic)
    assert out["correct"], out["checks"]
    assert out["checks"]["pairs_compared"]["value"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"pairs_per_s", "latency_ms_p95", "setup_s"}
    assert list(out)[-1] == "checks"


def _altered(fn):
    def process_batch(self, lefts, rights, outputs, encoding="mono8"):
        return fn(StereoPipeline.__dict__["_orig_process_batch"](
            self, lefts, rights, outputs, encoding))
    return process_batch


def _one_answer_altered(out):
    out = dict(out)
    d = out["disparity"].clone()
    d[:, SHAPE[0] // 2, SHAPE[1] // 2] += 1.0
    out["disparity"] = d
    return out


def _half_batch_left_out(out):
    B = next(iter(out.values())).shape[0]
    return {k: torch.cat([v[: B // 2], v[: B // 2]]) for k, v in out.items()}


@pytest.mark.parametrize("fault", [_one_answer_altered, _half_batch_left_out])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(StereoPipeline, "_orig_process_batch", StereoPipeline.process_batch,
                        raising=False)
    monkeypatch.setattr(StereoPipeline, "process_batch", _altered(fault))
    out = _run()
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name,shape", [("euroc-bm", (80, 160)), ("kitti-sgm8", (40, 320))])
def test_control_in_bfloat16_fails_the_limits(name, shape):
    cfg = spec.load_json("configs", name)
    nums = control.control_numbers(cfg, 2**31 + 9, 1, torch.device("cpu"), shape=shape)
    assert any(nums[k] > cfg["limits"][k] for k in nums), nums
