"""The port's serve daemon (``runtime/serve.py``): live frame intake, live
CameraInfo model init (the reference's imageAndInfoCb,
src/StereoProcessor.cpp:144-155) and live reconfigure
(src/StereoProcessor.cpp:307-336), on ``device="cpu"``; mirrors
tests/test_serve.py's cases.  Then the served disparities against the JAX
``ServeDaemon(use_pallas=False)`` on the same drops (exact), and, on a card,
the daemon on the card against the CPU.

The JAX package is imported inside a ``try``, so the card test runs on a
machine without it."""

import json
import os
import time

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.config import (
    Outputs, PipelineConfig, SpeckleConfig, StereoBMConfig,
)
from ros_gpu_stereo_processor_tpu_torch.runtime.serve import ServeDaemon
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair, write_image

try:
    import jax

    from ros_gpu_stereo_processor_tpu import config as jconfig
    from ros_gpu_stereo_processor_tpu.runtime.serve import ServeDaemon as JServeDaemon
except ImportError:   # a machine without the JAX reference runs the card test only
    jax = None

torch.set_num_threads(1)

H, W = 64, 96


def write_calib(path: str, name: str, tx: float = 0.0, width: int = W,
                height: int = H, fx: float = 80.0) -> None:
    """A camera_calibration_parsers YAML file (tests/test_serve.py's layout)."""
    doc = f"""
image_width: {width}
image_height: {height}
camera_name: {name}
camera_matrix:
  rows: 3
  cols: 3
  data: [{fx}, 0, {width/2}, 0, {fx}, {height/2}, 0, 0, 1]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [0, 0, 0, 0, 0]
rectification_matrix:
  rows: 3
  cols: 3
  data: [1, 0, 0, 0, 1, 0, 0, 0, 1]
projection_matrix:
  rows: 3
  cols: 4
  data: [{fx}, 0, {width/2}, {tx}, 0, {fx}, {height/2}, 0, 0, 0, 1, 0]
"""
    with open(path, "w") as f:
        f.write(doc)


def _drop_frame(watch, stamp: float, seed: int = 0):
    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=seed)
    for side, img in (("left", left), ("right", right)):
        d = os.path.join(watch, side)
        os.makedirs(d, exist_ok=True)
        write_image(os.path.join(d, f"{stamp:.6f}.png"), img)


def _cfg():
    return PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5),
        speckle=SpeckleConfig(max_speckle_size=0),
    )


def _calibs(tmp_path):
    cl, cr = str(tmp_path / "l.yaml"), str(tmp_path / "r.yaml")
    write_calib(cl, "left")
    write_calib(cr, "right", tx=-8.0)
    return dict(calib_left=cl, calib_right=cr)


def _mk(tmp_path, **kw):
    watch = str(tmp_path / "watch")
    out = str(tmp_path / "out")
    os.makedirs(watch, exist_ok=True)
    kw.setdefault("device", "cpu")
    return watch, out, ServeDaemon(watch_dir=watch, out_dir=out,
                                   outputs=Outputs.of("disparity"), config=_cfg(), **kw)


def _drain(daemon, rounds=20):
    for _ in range(rounds):
        if daemon.poll_once() == 0:
            break
    daemon.drain()   # publishes are async: join before looking at files


def test_serve_with_upfront_calib(tmp_path):
    watch, out, daemon = _mk(tmp_path, **_calibs(tmp_path))
    _drop_frame(watch, 1.0)
    _drop_frame(watch, 2.0)
    _drain(daemon)
    assert daemon.n_frames == 2
    npys = sorted(f for f in os.listdir(out) if f.endswith(".npy"))
    assert len(npys) == 2
    assert np.load(os.path.join(out, npys[0])).shape == (H, W)
    daemon.close()


def test_serve_live_camera_info_init(tmp_path):
    """No calibration at startup: frames wait, the model initialises when
    the camera-info files drop, then frames flow."""
    watch, out, daemon = _mk(tmp_path)
    _drop_frame(watch, 1.0)
    daemon.poll_once()
    assert daemon.pipe is None and daemon.n_frames == 0
    write_calib(os.path.join(watch, "camera_info_left.yaml"), "left")
    write_calib(os.path.join(watch, "camera_info_right.yaml"), "right", tx=-8.0)
    _drain(daemon)
    assert daemon.pipe is not None and daemon.pipe.device.type == "cpu"
    assert daemon.n_frames == 1   # the pre-init frame is picked up
    daemon.close()


def test_serve_live_reconfigure(tmp_path):
    """reconfigure.json mid-serve swaps matcher parameters by the reference's
    dynamic_reconfigure names; later frames use them."""
    watch, out, daemon = _mk(tmp_path, **_calibs(tmp_path))
    _drop_frame(watch, 1.0)
    _drain(daemon)
    assert daemon.pipe.config.stereobm.num_disparities == 16
    with open(os.path.join(watch, "reconfigure.json"), "w") as f:
        json.dump({"disparity_range": 37,          # sanitised to 32 (×16)
                   "correlation_window_size": 6,   # sanitised to 7 (odd)
                   "texture_threshold": 3}, f)
    _drop_frame(watch, 2.0, seed=1)
    _drain(daemon)
    bm = daemon.pipe.config.stereobm
    assert (bm.num_disparities, bm.block_size, bm.texture_threshold) == (32, 7, 3)
    assert daemon.n_frames == 2
    assert daemon._check_reconfigure() is False   # unchanged: nothing applied
    daemon.close()


def test_serve_rejects_bad_reconfigure(tmp_path):
    watch, out, daemon = _mk(tmp_path, **_calibs(tmp_path))
    with open(os.path.join(watch, "reconfigure.json"), "w") as f:
        json.dump({"no_such_param": 1}, f)
    assert daemon._check_reconfigure() is False   # rejected, daemon alive
    _drop_frame(watch, 1.0)
    _drain(daemon)
    assert daemon.n_frames == 1
    daemon.close()


def test_serve_live_output_switch(tmp_path):
    """The demand flag-set switches live through reconfigure.json (the
    subscriber-driven connectCb role, src/StereoProcessor.cpp:104-142)."""
    watch, out, daemon = _mk(tmp_path, **_calibs(tmp_path))
    _drop_frame(watch, 1.0)
    _drain(daemon)
    files = os.listdir(out)
    assert any(f.startswith("disparity_1.0") for f in files)
    assert not any(f.startswith("rect_mono_left_1.0") for f in files)
    with open(os.path.join(watch, "reconfigure.json"), "w") as f:
        json.dump({"outputs": "disparity,rect_mono_left"}, f)
    _drop_frame(watch, 2.0, seed=1)
    _drain(daemon)
    assert any(f.startswith("rect_mono_left_2.0") for f in os.listdir(out))
    assert daemon.outputs.flags == frozenset({"disparity", "rect_mono_left"})
    daemon.close()


def test_serve_overlapped_throughput(tmp_path):
    """The overlapped path (uploader thread + sender workers) sustains about
    the synchronous process-then-fetch loop on the same ring: the overlap
    machinery may not cost throughput (a loose 2× bound, as
    tests/test_serve.py, against thread-scheduling noise)."""
    N = 30
    watch, out, daemon = _mk(tmp_path, save_outputs=False, queue_size=N + 2,
                             **_calibs(tmp_path))
    left, right, _ = synthetic_stereo_pair(H, W, max_disparity=12, seed=3)

    def feed(base):
        for i in range(N):
            daemon.ingest.feed("left", left, base + i * 0.05)
            daemon.ingest.feed("right", right, base + i * 0.05)

    feed(0.0)                 # warm-up
    daemon._process_ready()
    daemon.drain()
    t0 = time.perf_counter()
    feed(100.0)
    daemon._process_ready()
    daemon.drain()
    dt_serve = time.perf_counter() - t0
    assert daemon.n_frames >= 2 * N
    feed(200.0)
    t0 = time.perf_counter()
    for l_d, r_d, stamp, seq in daemon.ingest.frames(timeout=0):
        daemon.pipe.process(l_d, r_d, daemon.outputs, encoding=daemon.encoding).fetch()
    dt_sync = time.perf_counter() - t0
    assert dt_serve < 2.0 * dt_sync, (dt_serve, dt_sync)
    line = daemon._timing_line()
    assert "fps=" in line and "p50=" in line
    t = daemon.timing()
    assert t["frames"] > 0 and t["p50_ms"] <= t["p95_ms"]
    daemon.close()


def test_serve_prune_survives_unparsable_names(tmp_path):
    """A stray non-timestamp .png in the watch dir does not kill the daemon
    when the seen-set prune runs (unparsable names are remembered forever)."""
    watch, out, daemon = _mk(tmp_path, **_calibs(tmp_path))
    os.makedirs(os.path.join(watch, "left"), exist_ok=True)
    with open(os.path.join(watch, "left", "preview.png"), "wb") as f:
        f.write(b"not an image")
    _drop_frame(watch, 1.0)
    _drain(daemon)
    daemon._seen["left"].update(f"{t:.6f}.png" for t in np.arange(300) * 0.001)
    daemon._watermark["left"] = 5.0
    _drop_frame(watch, 6.0, seed=1)
    _drain(daemon)   # must not raise
    assert daemon.n_frames == 2
    assert "preview.png" in daemon._seen["left"]
    daemon.close()


def test_serve_default_device_is_the_card(tmp_path):
    if torch.cuda.is_available():
        assert ServeDaemon(str(tmp_path), str(tmp_path / "o"), Outputs.of("disparity")
                           ).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeDaemon(str(tmp_path), str(tmp_path / "o"), Outputs.of("disparity"))


def _serve_drops(tmp_path, daemon_cls, reconf_at, n, **kw):
    """Drop the camera info and n pairs (a reconfigure.json after frame
    ``reconf_at``) into a fresh watch dir and serve them; returns the
    disparity of each stamp."""
    watch = str(tmp_path / "watch")
    out = str(tmp_path / "out")
    os.makedirs(watch, exist_ok=True)
    daemon = daemon_cls(watch_dir=watch, out_dir=out, **kw)
    write_calib(os.path.join(watch, "camera_info_left.yaml"), "left")
    write_calib(os.path.join(watch, "camera_info_right.yaml"), "right", tx=-8.0)
    for i in range(n):
        _drop_frame(watch, 1.0 + i, seed=20 + i)
        if i == reconf_at:
            _drain(daemon)
            with open(os.path.join(watch, "reconfigure.json"), "w") as f:
                json.dump({"disparity_range": 32, "uniqueness_ratio": 5}, f)
    _drain(daemon)
    assert daemon.n_frames == n
    return {f: np.load(os.path.join(out, f)) for f in sorted(os.listdir(out))
            if f.endswith(".npy")}


@pytest.mark.skipif(jax is None, reason="needs the JAX reference package")
def test_served_disparity_matches_jax_daemon(tmp_path):
    """The same drops, camera-info files and mid-stream reconfigure through
    the JAX daemon (use_pallas=False) and the port's (CPU): every served
    disparity file equal."""
    jcfg = jconfig.PipelineConfig(
        stereobm=jconfig.StereoBMConfig(num_disparities=16, block_size=5,
                                        texture_threshold=5),
        speckle=jconfig.SpeckleConfig(max_speckle_size=30, max_diff=2.0))
    want = _serve_drops(tmp_path / "jax", JServeDaemon, 1, 4,
                        outputs=jconfig.Outputs.of("disparity", "disparity_vis"),
                        config=jcfg, use_pallas=False)
    from ros_gpu_stereo_processor_tpu_torch.config import from_jax_config

    got = _serve_drops(tmp_path / "port", ServeDaemon, 1, 4,
                       outputs=Outputs.of("disparity", "disparity_vis"),
                       config=from_jax_config(jcfg), device="cpu")
    assert sorted(got) == sorted(want) and len(got) == 4
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_serve_on_card_matches_cpu(tmp_path):
    """The daemon on the card (native ring, stacked pinned uploads, the
    fixed8 wire) serves what the daemon on the CPU serves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = _cfg().replace(disparity_wire="fixed8")
    kw = dict(outputs=Outputs.of("disparity", "disparity_vis"), config=cfg)
    want = _serve_drops(tmp_path / "cpu", ServeDaemon, 2, 6, device="cpu", **kw)
    got = _serve_drops(tmp_path / "card", ServeDaemon, 2, 6, **kw)
    assert sorted(got) == sorted(want) and len(got) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
