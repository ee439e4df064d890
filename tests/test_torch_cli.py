"""The port's command line, ``tpu-stereo-torch`` (``cli.py``), on
``--device cpu``: ``info``, ``run`` (a pair, an EuRoC sequence, a CPU band
mesh), ``compare``, ``serve`` with ``--idle-timeout``, ``slam`` on a tiny
synthetic EuRoC sequence, and ``bench`` at a small size.  ``run``'s outputs equal the JAX
CLI's (``--no-pallas``) on the same files, exactly."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch import cli
from ros_gpu_stereo_processor_tpu_torch.utils import synth
from ros_gpu_stereo_processor_tpu_torch.utils.io import (
    load_image, synthetic_stereo_pair, write_image,
)

from tests.test_torch_serve import H, W, write_calib

try:
    import jax

    from ros_gpu_stereo_processor_tpu import cli as jcli
except ImportError:   # a machine without the JAX reference
    jax = None

ROOT = Path(__file__).resolve().parent.parent
BM = ["--ndisp", "16", "--block", "5", "--texture-threshold", "5"]


def _make_euroc(root, n_frames=3):
    """A tiny EuRoC-layout dataset of synthetic pairs."""
    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    rows = []
    for i in range(n_frames):
        left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=i)
        ts = int((1.0 + 0.05 * i) * 1e9)
        for cam, img in (("cam0", left), ("cam1", right)):
            write_image(os.path.join(root, "mav0", cam, "data", f"{ts}.png"), img)
        rows.append(f"{ts},{ts}.png")
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")


@pytest.fixture()
def calib(tmp_path):
    cl, cr = str(tmp_path / "l.yaml"), str(tmp_path / "r.yaml")
    write_calib(cl, "left")
    write_calib(cr, "right", tx=-8.0)
    return ["--calib-left", cl, "--calib-right", cr]


@pytest.fixture()
def pair(tmp_path):
    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=0)
    lp, rp = str(tmp_path / "l.png"), str(tmp_path / "r.png")
    write_image(lp, left)
    write_image(rp, right)
    return ["--left", lp, "--right", rp]


def test_info(calib, capsys):
    assert cli.main(["info", *calib]) == 0
    out = capsys.readouterr().out
    assert "96x64" in out and "baseline=0.1000" in out and "Q =" in out


@pytest.mark.skipif(jax is None, reason="needs the JAX reference package")
def test_run_pair_matches_jax_cli(tmp_path, calib, pair):
    """Every artifact of ``run`` on a pair — disparity ``.npy``, the PNGs and
    the PLY cloud — equal to the JAX CLI's."""
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    common = ["run", *calib, *pair, "--outputs",
              "disparity,disparity_vis,rect_mono_left,pointcloud", *BM]
    assert jcli.main([*common, "--out-dir", out_j, "--no-pallas"]) == 0
    assert cli.main([*common, "--out-dir", out_t, "--device", "cpu"]) == 0
    files = sorted(os.listdir(out_j))
    assert files == sorted(os.listdir(out_t)) and "disparity_0000.npy" in files
    for f in files:
        a, b = os.path.join(out_t, f), os.path.join(out_j, f)
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        elif f.endswith(".png"):
            np.testing.assert_array_equal(load_image(a), load_image(b))
        else:
            assert Path(a).read_text() == Path(b).read_text(), f


@pytest.mark.skipif(jax is None, reason="needs the JAX reference package")
def test_run_euroc_matches_jax_cli(tmp_path, calib, capsys):
    """``run --euroc`` equals the JAX CLI frame by frame, and reports its
    kernel launches: none on the CPU, where each op runs its plain version."""
    root = str(tmp_path / "euroc")
    _make_euroc(root, n_frames=3)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    common = ["run", *calib, "--euroc", root, "--save-frames", "3",
              "--outputs", "disparity,disparity_vis", *BM]
    assert jcli.main([*common, "--out-dir", out_j, "--no-pallas"]) == 0
    capsys.readouterr()
    assert cli.main([*common, "--out-dir", out_t, "--device", "cpu"]) == 0
    report = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("kernel launches: ")]
    assert len(report) == 1
    counts = json.loads(report[0][len("kernel launches: "):])
    assert "bm_fused" in counts and set(counts.values()) == {0}
    for i in range(3):
        f = f"disparity_{i:04d}.npy"
        np.testing.assert_array_equal(np.load(os.path.join(out_t, f)),
                                      np.load(os.path.join(out_j, f)))


def test_run_band_mesh_and_unported_options(tmp_path, calib, monkeypatch, capsys):
    """``--devices 4 --device cpu`` runs the row-band pipeline on a CPU band
    mesh, and ``--shard-mode disp`` the slab matcher on it; both equal one
    device (speckle off); ``bench --device cpu`` runs the port's bench (on
    tests/test_torch_bench.py's small model, compute and SGM sections) and
    ends with its headline."""
    root = str(tmp_path / "euroc")
    _make_euroc(root, n_frames=1)
    common = ["run", *calib, "--euroc", root, "--outputs", "disparity", *BM,
              "--speckle-size", "0", "--device", "cpu"]
    assert cli.main([*common, "--out-dir", str(tmp_path / "one")]) == 0
    assert cli.main([*common, "--out-dir", str(tmp_path / "mesh"), "--devices", "4"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "mesh" / "disparity_0000.npy"),
                                  np.load(tmp_path / "one" / "disparity_0000.npy"))
    assert cli.main([*common, "--out-dir", str(tmp_path / "slab"), "--devices", "4",
                     "--shard-mode", "disp"]) == 0
    np.testing.assert_array_equal(np.load(tmp_path / "slab" / "disparity_0000.npy"),
                                  np.load(tmp_path / "one" / "disparity_0000.npy"))
    from tests.test_torch_bench import use_small_bench   # imports jax

    use_small_bench(monkeypatch, BENCH_E2E="0", BENCH_STAGES="0", BENCH_ROOFLINE="0",
                    BENCH_SLAM="0")
    capsys.readouterr()
    assert cli.main(["bench", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    head = json.loads(last)
    assert len(last) <= 1800 and head["kernels"] == "plain"
    assert head["value"] > 0 and head["sgm_ms_64d"] > 0 and head["sgm_ms_128d"] > 0


def test_run_requires_input_and_defaults_to_the_card(tmp_path, calib, pair):
    with pytest.raises(SystemExit):
        cli.main(["compare", *calib])
    if torch.cuda.is_available():
        return
    with pytest.raises((RuntimeError, AssertionError)):
        cli.main(["run", *calib, *pair, "--out-dir", str(tmp_path / "o")])


def test_compare_single_pair_and_euroc(tmp_path, calib, pair, capsys):
    """``compare`` against the OpenCV oracle: one pair with its artifact
    set, and a sequence's aggregate report."""
    pytest.importorskip("cv2")
    dump = str(tmp_path / "dump")
    rc = cli.main(["compare", *calib, *pair, "--ndisp", "16", "--block", "9",
                   "--texture-threshold", "5", "--speckle-size", "0",
                   "--device", "cpu", "--dump-dir", dump])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert json.loads(out[: out.rindex("}") + 1])["within_1px"] > 0.85
    assert {"disparity_tpu.csv", "disparity_diff.png", "epipolar.png"} <= set(os.listdir(dump))

    root = str(tmp_path / "euroc")
    _make_euroc(root, n_frames=2)
    rc = cli.main(["compare", *calib, "--euroc", root, "--dump-dir", dump, "--ndisp", "16",
                   "--block", "9", "--texture-threshold", "5", "--speckle-size", "0",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert json.loads(out[: out.rindex("}") + 1])["frames"] == 2
    with open(os.path.join(dump, "compare_report.json")) as f:
        assert len(json.load(f)["per_frame"]) == 2


def test_compare_without_cv2_says_so(calib, pair, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 raises
    assert cli.main(["compare", *calib, *pair, "--device", "cpu"]) == 2
    assert "cv2" in capsys.readouterr().err


def test_serve_idle_timeout(tmp_path, calib):
    """``serve`` in a subprocess, as a user starts it: serves the drops
    already in the watch dir and exits after ``--idle-timeout``."""
    watch = tmp_path / "watch"
    for i in range(2):
        left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=i)
        for side, img in (("left", left), ("right", right)):
            (watch / side).mkdir(parents=True, exist_ok=True)
            write_image(str(watch / side / f"{1.0 + i:.6f}.png"), img)
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-m", "ros_gpu_stereo_processor_tpu_torch.cli", "serve", *calib,
         "--watch-dir", str(watch), "--out-dir", str(out), "--idle-timeout", "0.5",
         "--device", "cpu", *BM],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert "served 2 frames" in proc.stdout
    assert sorted(f for f in os.listdir(out) if f.endswith(".npy")) == [
        "disparity_1.000000.npy", "disparity_2.000000.npy"]


def test_slam_on_synthetic_euroc(tmp_path):
    """``slam`` over 6 frames of the planar EuRoC sequence: a trajectory,
    the ATE line from the ground truth, and a torch.save checkpoint the
    engine loads back."""
    root = str(tmp_path / "euroc")
    cl, cr = synth.make_planar_euroc(root, n_frames=6, width=160, height=120, fx=140.0,
                                     baseline=0.1, Z0=2.0)
    ckpt = str(tmp_path / "slam.pt")
    out_dir = str(tmp_path / "out")
    rc = cli.main(["slam", "--calib-left", cl, "--calib-right", cr, "--euroc", root,
                   "--out-dir", out_dir, "--features", "128", "--keyframe-every", "2",
                   "--window", "3", "--ndisp", "16", "--block", "9",
                   "--texture-threshold", "5", "--speckle-size", "0",
                   "--checkpoint", ckpt, "--device", "cpu"])
    assert rc == 0
    traj = np.loadtxt(os.path.join(out_dir, "trajectory.txt"))
    assert traj.shape == (6, 4) and np.isfinite(traj).all()
    state = torch.load(ckpt, map_location="cpu", weights_only=True)
    assert "traj_t" in state and len(state["traj_t"]) == 6
