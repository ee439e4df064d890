"""The Middlebury 2014 cell, ``middlebury-sgm8.replay-b2``: found by name
from its data files, reported by every per-layer metric whose reader
reads it, its own reader declared as its entry says and reading what it
should from a device trace, and a whole run on the CPU at a cut shape that
reads ``correct``."""

import pytest
import torch

from stereo_bench import costmodel, run, spec, trace

CELL = "middlebury-sgm8.replay-b2"
READER = "dg_two_pass_roofline"


def test_the_cell_loads_from_its_files():
    cell = spec.cell(CELL)
    cfg, mix = cell["config_data"], cell["traffic_data"]
    assert cell["chips"] == 1 and cfg["name"] == "middlebury-sgm8" and mix["name"] == "replay-b2"
    assert (cfg["image"]["height"], cfg["image"]["width"]) == (1988, 2880)
    assert cfg["matcher"]["num_disparities"] == 304 and cfg["matcher"]["sgm_paths"] == 8
    entry = next(c for c in spec.benchmark()["configs"] if c["name"] == "middlebury-sgm8")
    assert entry["reduced"] == cfg["reduced"] == [] and entry["source"] == cfg["source"]
    assert (mix["batch"], mix["max_in_flight"], mix["ring_capacity"], mix["staged_depth"],
            mix["pool_pairs"]) == (2, 8, 8, 4, 16)
    names = {m["name"] for m in spec.metrics_for(CELL, "per_layer")}
    readers = {m["name"] for m in spec.benchmark()["per_layer"]
               if spec.reader(m["name"]).reads(cfg, mix)}
    assert names == readers and READER in names and "match_roofline.sgm" in names
    assert len(names) == 11


def test_the_new_reader_declares_its_keys():
    mod = spec.reader(READER)
    entry = next(m for m in spec.benchmark()["per_layer"] if m["name"] == READER)
    assert all(hasattr(mod, k) for k in spec.READER_KEYS)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.BETTER) == \
        (entry["layer"], entry["unit"], entry["source"], entry["moves"], entry["better"])
    assert entry["workloads"] == [CELL]
    kitti = spec.cell("kitti-sgm8.replay-b8")
    assert not mod.reads(kitti["config_data"], kitti["traffic_data"])


class _Run:
    trace = None


def test_the_readers_read_their_kernels_and_nothing_without_a_trace():
    """The two-pass roofline reads ``sgm_diagonal_kernel`` alone (not the
    pair walk's kernel), the matcher's roofline every ``sgm_`` kernel; no
    trace, or no such kernel, reads None."""
    cell = spec.cell(CELL)
    dg, sgm = spec.reader(READER), spec.reader("match_roofline.sgm")
    run_ = _Run()
    assert dg.read(run_, cell) is None and sgm.read(run_, cell) is None
    ops = {"void (anonymous namespace)::sgm_diagonal_kernel<16, unsigned short>": 0.060,
           "void (anonymous namespace)::sgm_diagonal_pair_kernel<16, unsigned short>": 0.5,
           "void (anonymous namespace)::sgm_walk_kernel<16, unsigned short>": 0.040,
           "remap_bilinear_kernel": 0.001}
    run_.trace = trace.Summary(busy_s=0.6, window_s=0.6, pairs=10.0, op_s=ops, kernel_s=0.601,
                               d2d_memset_s=0.0, copy_s=0.0, idle_gaps=[])
    c = cell["config_data"]
    V = 1988 * 2880 * 304
    bound_ms = 2 * 3 * V / 3.35e9          # DG's bytes bound, two calls
    assert dg.read(run_, cell) == pytest.approx(100 * bound_ms / 6.0)
    matcher_ms = costmodel.model_ms(costmodel.matcher_model(c["matcher"], 1988, 2880))
    assert sgm.read(run_, cell) == pytest.approx(100 * matcher_ms / 60.0)
    assert c["matcher"]["num_disparities"] == 304
    run_.trace.op_s = {"void sgm_diagonal_pair_kernel<16>": 0.5}
    assert dg.read(run_, cell) is None
    assert sgm.read(run_, cell) == pytest.approx(100 * matcher_ms / 50.0)


def test_a_cpu_run_of_the_cell_at_a_cut_shape_is_correct():
    cell = spec.cell(CELL)
    cell["traffic_data"] = dict(cell["traffic_data"], pool_pairs=4, warmup_s=0.3)
    out = run.execute(cell, 2**33 + 7, 1.0, False, torch.device("cpu"), shape=(48, 416))
    assert out["correct"], out["checks"]
    assert out["checks"]["pairs_compared"]["value"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"pairs_per_s", "latency_ms_p95", "setup_s"}
