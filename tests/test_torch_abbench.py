"""The interleaved A/B harness: ``utils/graphs.py::ab`` and
``scripts/torch_abbench.py``, on the CPU (no graphs: each batch runner is
its function).

  * ``ab`` calls each candidate's runner twice, then takes the candidates
    round-robin, ``reps`` calls each per round, and returns each one's
    minimum over the rounds as ms a frame and fps;
  * the script's candidates (``scripts/abbench.py``'s: the pipeline with
    the speckle filter on the kernel and on the plain route, without it,
    and K1 ×2, K2 and the prefilter ×2 on rectified frames) run through
    ``ab`` on a 96×64 model; the two speckle routes give the same batch
    checksums (on the CPU both are the plain labels; on the card K3 is held
    to them exactly);
  * ``load_tree`` imports a checkout's package apart from the one in
    ``sys.modules`` and leaves that one in place; ``in_tree`` runs a
    function with its checkout's modules.

The script itself runs on the card:

    python3 scripts/torch_abbench.py [--batch 8] [--root DIR]
"""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.utils import graphs
from ros_gpu_stereo_processor_tpu_torch.utils.calib import euroc_like_model

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "ros_gpu_stereo_processor_tpu_torch"


@pytest.fixture(scope="module")
def abbench():
    spec = importlib.util.spec_from_file_location(
        "torch_abbench", os.path.join(ROOT, "scripts", "torch_abbench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ab_round_robin_and_minimum(monkeypatch, capsys):
    """Calls: each runner twice (B frames a call), then per round a's
    ``reps`` calls, then b's.  The host clock, read before and after each
    candidate's calls in a round, is scripted: a's round means 30, 10, 20
    ms a call and b's 8, 9, 7, so the minima are 10 and 7 ms a call."""
    calls = []

    def cand(name):
        def fn(left, right):
            calls.append(name)
            return left + right
        return fn

    spans = iter([0.09, 0.024, 0.03, 0.027, 0.06, 0.021])    # (a, b) per round, reps 3
    now = [0.0]

    def clock():
        now[0] += next(spans) if clock.start else 0.0
        clock.start = not clock.start
        return now[0]
    clock.start = False
    monkeypatch.setattr(graphs, "time", types.SimpleNamespace(perf_counter=clock))
    lefts = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    out = graphs.ab({"a": cand("a"), "b": cand("b")}, lefts, lefts + 1, trials=3, reps=3)
    B, reps = 2, 3
    warm = ["a"] * 2 * B + ["b"] * 2 * B
    rounds = (["a"] * reps * B + ["b"] * reps * B) * 3
    assert calls == warm + rounds
    assert list(out) == ["a", "b"]
    assert out["a"]["ms_per_frame"] == pytest.approx(10.0 / B)
    assert out["b"]["ms_per_frame"] == pytest.approx(7.0 / B)
    assert out["a"]["fps"] == pytest.approx(B / 0.010)
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("a ") and "5.000 ms/frame" in printed[0]


def test_script_candidates_on_the_cpu(abbench):
    model = euroc_like_model(96, 64)
    dev = torch.device("cpu")
    frames, stages = abbench.candidates(
        lambda name: importlib.import_module(f"{PACKAGE}.{name}"), model, dev)
    assert list(frames) == ["pipeline+speckle:kernel", "pipeline+speckle:plain",
                            "pipeline (no speckle)"]
    assert list(stages) == ["rectify K1 x2", "stereobm fused K2", "prefilter x2"]
    pairs = [T.synthetic_stereo_pair(64, 96, 24, seed=s)[:2] for s in (0, 1)]
    lefts, rights = (torch.from_numpy(np.stack(side)) for side in zip(*pairs))
    sums = {k: graphs.batch_runner(fn, dev)(lefts, rights) for k, fn in frames.items()}
    assert torch.equal(sums["pipeline+speckle:kernel"], sums["pipeline+speckle:plain"])
    assert not torch.equal(sums["pipeline+speckle:kernel"], sums["pipeline (no speckle)"])
    res = graphs.ab(frames, lefts, rights, trials=1, reps=1)
    rect = stages["rectify K1 x2"](lefts[0].float(), rights[0].float())
    rl, rr = rect[0].expand(2, -1, -1), rect[1].expand(2, -1, -1)
    res.update(graphs.ab(stages, rl, rr, trials=1, reps=1))
    assert list(res) == list(frames) + list(stages)
    assert all(r["ms_per_frame"] > 0 and r["fps"] > 0 for r in res.values())


def test_load_tree_imports_apart(abbench):
    """A second import of this checkout's package: other module objects,
    ``sys.modules`` unchanged after the load and after a call in the tree."""
    ours = {k: v for k, v in sys.modules.items() if k == PACKAGE or k.startswith(PACKAGE + ".")}
    mods = abbench.load_tree(ROOT)
    assert mods[PACKAGE] is not ours[PACKAGE]
    assert f"{PACKAGE}.utils.graphs" in mods and f"{PACKAGE}.parallel.scaling" in mods
    assert all(sys.modules[k] is v for k, v in ours.items())
    seen = abbench.in_tree(mods, lambda: sys.modules[f"{PACKAGE}.ops.speckle"])()
    assert seen is mods[f"{PACKAGE}.ops.speckle"]
    assert sys.modules[f"{PACKAGE}.ops.speckle"] is ours[f"{PACKAGE}.ops.speckle"]
