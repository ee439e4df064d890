"""The benchmark's pieces, found by name from the data files."""

import json
import re
import shutil

import pytest

from stereo_bench import costmodel, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def test_every_cell_metric_and_unit_from_the_data_files():
    bench = spec.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        data = spec.load_json("configs", c["name"])
        assert c["file"] == f"stereo_bench/configs/{c['name']}.json"
        assert data["reduced"] == c["reduced"] == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in names and w["chips"] == 1
        cell = spec.cell(w["name"])
        assert cell["traffic_data"]["name"] == w["traffic"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert {m["name"] for m in bench["end_to_end"]} == {"pairs_per_s", "latency_ms_p95", "setup_s"}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert (mod.UNIT, mod.SOURCE, mod.MOVES, mod.LAYER, mod.BETTER) == \
            (m["unit"], m["source"], m["moves"], m["layer"], m["better"])
        reads = {w["name"] for w in bench["workloads"]
                 if mod.reads(spec.load_json("configs", w["config"]),
                              spec.load_json("traffic", w["traffic"]))}
        assert set(m["workloads"]) == reads <= cells
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_dropped_in_files_are_found_without_an_edit(tmp_path):
    """A configuration, a mix and a metric a later change adds are files and
    entries only."""
    here = tmp_path / "stereo_bench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.benchmark()
    cfg = spec.load_json("configs", "euroc-bm")
    cfg["name"] = "euroc-bm-lr"
    cfg["matcher"]["lr_check"] = True
    (here / "configs" / "euroc-bm-lr.json").write_text(json.dumps(cfg))
    mix = dict(spec.load_json("traffic", "replay-b8"), name="replay-b4", batch=4)
    (here / "traffic" / "replay-b4.json").write_text(json.dumps(mix))
    (here / "metrics" / "ring_depth.py").write_text(
        'LAYER = "ingest (runtime/ingest.py)"\nUNIT = "pairs"\nSOURCE = "program_counter"\n'
        'MOVES = "latency_ms_p95"\nBETTER = "lower"\n\n\ndef reads(config, traffic):\n'
        '    return True\n\n\ndef read(run, cell):\n    return None\n')
    bench["workloads"].append({"name": "euroc-bm-lr.replay-b4", "config": "euroc-bm-lr",
                               "traffic": "replay-b4", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.cell("euroc-bm-lr.replay-b4", root=tmp_path, here=here)
    assert cell["config_data"]["matcher"]["lr_check"] and cell["traffic_data"]["batch"] == 4
    assert spec.reader("ring_depth", here=here).UNIT == "pairs"
    with pytest.raises(KeyError):
        spec.cell("no-such.cell", root=tmp_path, here=here)


def test_the_frozen_cost_model_gives_the_recorded_bounds():
    """PERF.md's bounds at 752×480: K2 (64 disparities) 0.00276 ms, K6 over
    4 paths at 128 disparities 0.0565 ms."""
    k2 = costmodel.model_ms(costmodel.stereobm_fused_model(480, 752, 64))
    sgm = costmodel.sgm_fused_model(480, 752, 128, 2, 1, paths=4)
    k6 = costmodel.model_ms(sgm["K6"])
    assert round(k2, 5) == 0.00276 and round(k6, 4) == 0.0565
    kitti = spec.load_json("configs", "kitti-sgm8")
    assert costmodel.sgm_storage_bytes(kitti["matcher"]) == (2, 1)
    step = costmodel.model_ms(costmodel.step_model(kitti, 12))
    match = costmodel.model_ms(costmodel.matcher_model(kitti["matcher"], 375, 1242))
    assert 0 < match < step
