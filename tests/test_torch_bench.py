"""The port's streaming benchmark (``ros_gpu_stereo_processor_tpu_torch/bench.py``)
and its cost model (``utils/roofline.py``) on the CPU.

The bench's units of work against the JAX bench's on the same seeded
frames, through the JAX package's jnp path (``use_pallas=False``), on a
96×128 distorted toy calibration built by both packages'
``StereoCameraModel.from_calibs``:

  * each frame's checksum of the compute section (BM defaults, disparity
    and point cloud) within rtol 1e-5 (the sums run in another order);
  * each frame's SGM checksum at 64 disparities, rtol 1e-5;
  * the SLAM-compute chain over 3 frames: match counts exact, R and t
    within 1e-5, its checksum within rtol 1e-5.

``utils/roofline.py`` gives PERF.md's bound column at the table's shapes
(752×480; K4–K6 at 128 disparities, uint16 cost and uint8 excess; K7 and
BL on a 120×752 band) within rel 1e-3 of the byte and operation formulas,
and equal to the column at its significant figures.  ``bench.main``
runs every section on the CPU at the small size and prints a last line of
at most 1,800 characters; a section that raises makes it exit 1.  Also
the two public functions ported beside the bench: ``is_valid_point`` and
``StereoVisualOdometry.fetch_frame_host``, exact against JAX.  On a card,
the compute section's timed window makes no synchronizing call."""

import json

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch import bench
from ros_gpu_stereo_processor_tpu_torch.models import vo as TVO
from ros_gpu_stereo_processor_tpu_torch.ops import reproject as treproject
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import roofline as rl
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

try:
    import jax
    import jax.numpy as jnp

    import ros_gpu_stereo_processor_tpu as J
    from ros_gpu_stereo_processor_tpu.models import vo as JVO
    from ros_gpu_stereo_processor_tpu.models.pipeline import _pipeline_step as j_step
    from ros_gpu_stereo_processor_tpu.ops import reproject as jreproject
    from ros_gpu_stereo_processor_tpu.ops import sgm as jsgm
    from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib

    from tests.test_torch_vo import _models as vo_models
    from tests.test_torch_vo import _plane_sequence
except ImportError:   # a machine without the JAX reference runs the card test only
    jax = None

needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference package")

torch.set_num_threads(1)

H, W = 96, 128
_K = np.array([[110.0, 0, 64], [0, 110.0, 48], [0, 0, 1.0]])
_P = np.hstack([np.array([[105.0, 0, 62], [0, 105.0, 47], [0, 0, 1.0]]), np.zeros((3, 1))])
_PR = _P.copy()
_PR[0, 3] = -10.5
_D = np.array([-0.37, 0.11, 0.0, 0.0, 0.0])
CPU = torch.device("cpu")
RTOL = 1e-5
POSE_ATOL = 1e-5
# the bench's sizes cut for the CPU: B = 2, one repeat, a few frames a section
SMALL_ENV = {"BENCH_REPEATS": "1", "BENCH_BATCH": "2", "BENCH_ITERS": "1",
             "BENCH_E2E_BATCH": "2", "BENCH_E2E_FRAMES": "4", "BENCH_PF_FRAMES": "4",
             "BENCH_SGM_ITERS": "1", "BENCH_ROOF_ITERS": "1",
             "BENCH_SLAM_COMPUTE_ITERS": "1", "BENCH_SLAM_FRAMES": "6",
             "BENCH_STAGE_ITERS": "1"}


def small_model():
    return tcal.StereoCameraModel.from_calibs(
        tcal.CameraCalib(W, H, _K, _D, np.eye(3), _P, "left"),
        tcal.CameraCalib(W, H, _K, _D, np.eye(3), _PR, "right"))


def small_jax_model():
    return J.StereoCameraModel.from_calibs(JCalib(W, H, _K, _D, np.eye(3), _P, "left"),
                                           JCalib(W, H, _K, _D, np.eye(3), _PR, "right"))


def small_frames(n):
    """n seeded (left, right) pairs at the small size, disparities up to 24."""
    return [synthetic_stereo_pair(H, W, 24, seed=40 + i)[:2] for i in range(n)]


def use_small_bench(monkeypatch, **env):
    """Run ``bench.main`` on the small model and frame, at the small sizes,
    with ``env`` on top (e.g. a section set to "0")."""
    left, right = small_frames(1)[0]
    monkeypatch.setattr(bench, "_model_and_frame", lambda: (small_model(), left, right))
    for k, v in {**SMALL_ENV, **env}.items():
        monkeypatch.setenv(k, v)


def _jax_config():
    return J.PipelineConfig(
        stereobm=J.StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10),
        speckle=J.SpeckleConfig(max_speckle_size=800, max_diff=5.0, propagation_iters=16))


def _jax_dense(jm, outputs):
    """The JAX bench's frame step on the jnp path, jitted as the bench
    compiles it: (left, right) → outputs."""
    cfg = _jax_config()
    maps = jnp.asarray(jm.rect_maps_stacked())
    Q = jnp.asarray(jm.Q.astype(np.float32))
    return jax.jit(lambda l, r: j_step(l, r, maps, Q, encoding="mono8", outputs=outputs,
                                       bm=cfg.stereobm, speckle=cfg.speckle,
                                       use_pallas=False))


def _stacks(frames, shift=0):
    return (torch.from_numpy(np.stack([f[0] + np.uint8(shift) for f in frames])),
            torch.from_numpy(np.stack([f[1] + np.uint8(shift) for f in frames])))


@needs_jax
def test_compute_checksums_match_jax():
    frames = small_frames(2)
    run = bench._frame_runner(small_model(), bench._bench_config(),
                              bench.Outputs.of("disparity", "pointcloud"), CPU)
    got = run(*_stacks(frames)).numpy()
    step = _jax_dense(small_jax_model(), J.Outputs.of("disparity", "pointcloud"))
    want = [float(sum(jnp.sum(jnp.nan_to_num(v.astype(jnp.float32)))
                      for v in step(jnp.asarray(l), jnp.asarray(r)).values()))
            for l, r in frames]
    assert got.shape == (2,) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert len(set(got.tolist())) == 2           # the two frames differ


@needs_jax
def test_sgm_checksums_match_jax():
    frames = small_frames(2)
    cfg = bench.StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10)
    got = bench._sgm_runner(cfg)(*_stacks(frames)).numpy()
    jcfg = J.StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10)
    sgm = jax.jit(lambda l, r: jsgm.compute_disparity_sgm(l, r, jcfg))
    want = []
    for l, r in frames:
        d, v = sgm(jnp.asarray(l), jnp.asarray(r))
        want.append(float(jnp.sum(d) + jnp.sum(v)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


@needs_jax
def test_slam_chain_matches_jax():
    """Three frames (the second and third brighter by 1 and 2), the frame
    step then ``_vo_first`` / ``_vo_core``, as both benches chain them."""
    tm, jm = small_model(), small_jax_model()
    left, right = small_frames(1)[0]
    ls = [left + np.uint8(i) for i in range(3)]
    rs = [right + np.uint8(i) for i in range(3)]
    steps = bench._slam_chain(tm, bench._bench_config(), CPU)(
        torch.from_numpy(np.stack(ls)), torch.from_numpy(np.stack(rs)))

    dense = _jax_dense(jm, J.Outputs.of("disparity", "rect_mono_left"))
    cam = dict(k=512, threshold=20.0, fx=jm.fx, cx=jm.left.calib.cx, cy=jm.left.calib.cy,
               baseline=jm.baseline, disparity_offset=jm.disparity_offset)

    def jframe(i):
        out = dense(jnp.asarray(ls[i]), jnp.asarray(rs[i]))
        return out["rect_mono_left"], out["disparity"]

    kp, pts, pv = JVO._vo_first(*jframe(0), **cam)
    want = []
    for i in (1, 2):
        kp, pts, pv, n, R, t, rms = JVO._vo_core(kp, pts, pv, *jframe(i), **cam)
        want.append((n, R, t, rms))
    assert len(steps) == 2
    for (n, R, t, _), (jn, jR, jt, _) in zip(steps, want):
        assert int(n) == int(jn) > 0
        np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=POSE_ATOL)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=POSE_ATOL)
    jsum = sum(float(n) + float(jnp.sum(R)) + float(jnp.sum(t)) + float(rms)
               for n, R, t, rms in want)
    np.testing.assert_allclose(float(bench._slam_checksum(steps)), jsum, rtol=RTOL)


_VOL = 480 * 752 * 128
# PERF.md §6's bound column: (model, formula ms, the column's value)
BOUNDS = {
    "K1": (rl.remap_model(480, 752), 2 * 480 * 752 * 10 / 3.35e9, "0.00215"),
    "K2": (rl.stereobm_fused_model(480, 752, 64), 8 * 480 * 752 * 64 / 67e9, "0.00276"),
    "K3": (rl.speckle_model(480, 752, 12), 480 * 752 * 9 / 3.35e9, "0.00097"),
    "SZ": (rl.sizing_model(480, 752), 480 * 752 * 14 / 3.35e9, "0.00151"),
    "K4": (rl.sgm_fused_model(480, 752, 128, 2, 1)["K4"],
           (2 * 480 * 752 * 4 + 3 * _VOL) / 3.35e9, "0.0422"),
    "K5": (rl.sgm_fused_model(480, 752, 128, 2, 1)["K5"], _VOL * (2 + 5 / 3) / 3.35e9,
           "0.0506"),
    "K6": (rl.sgm_fused_model(480, 752, 128, 2, 1)["K6"],
           (4 * _VOL + 12 * 480 * 752) / 3.35e9, "0.0565"),
    "DG": (rl.sgm_fused_model(480, 752, 128, 2, 1, paths=8)["DG"], 3 * _VOL / 3.35e9,
           "0.0414"),
    "K7": (rl.maxprop_model(120, 752, 9), 120 * 752 * 10 / 3.35e9, "0.00027"),
    "BL": (rl.maxprop_model(120, 752, 2), 120 * 752 * 10 / 3.35e9, "0.00027"),
}


@pytest.mark.parametrize("kernel", sorted(BOUNDS))
def test_roofline_gives_the_perf_bounds(kernel):
    model, formula_ms, column = BOUNDS[kernel]
    ms, by = rl.model_bound(model)
    assert ms == pytest.approx(formula_ms, rel=1e-3)
    digits = len(column.lstrip("0."))             # the column's significant figures
    assert float(f"{ms:.{digits}g}") == float(column)
    assert by == ("operations" if kernel == "K2" else "bytes")
    r = rl.roofline(model, 2 * ms)
    assert r["bound_ms"] == ms and r["pct_of_bound"] == pytest.approx(50.0)


def test_sgm_model_sums_the_frames_kernels():
    m = rl.sgm_fused_model(480, 752, 64)
    assert m["bytes"] == m["K4"]["bytes"] + 3 * m["K5"]["bytes"] + m["K6"]["bytes"]
    assert m["ops"] == m["K4"]["ops"] + 3 * m["K5"]["ops"] + m["K6"]["ops"]


@pytest.mark.parametrize("paths,calls", [(2, {"K4 cost": 1, "K5": 2, "K6": 1}),
                                         (8, {"K4": 1, "K5": 3, "DG": 2, "K6": 1})])
@pytest.mark.parametrize("cost_bytes,exc_bytes", [(2, 1), (4, 4)])
def test_sgm_model_by_paths(paths, calls, cost_bytes, exc_bytes):
    """The 2- and 8-path frames' sums over their calls; the walks' operations
    are int32 on integer storage (2-byte cost) and float32 otherwise; K6
    reads one pair volume per two paths."""
    m = rl.sgm_fused_model(480, 752, 64, cost_bytes, exc_bytes, paths=paths)
    assert m["calls"] == calls
    for key in ("bytes", "ops", "int_ops"):
        assert m[key] == sum(n * m[k][key] for k, n in calls.items())
    V = 480 * 752 * 64
    walk = "int_ops" if cost_bytes == 2 else "ops"
    assert m["K5"][walk] == 10 * V and m["DG"][walk] == 20 * V
    assert m["K6"]["ops"] == (5 + paths // 2) * V and m["K6"]["int_ops"] == 0
    assert m["K6"]["bytes"] == V * (cost_bytes + paths // 2 * exc_bytes) + 12 * 480 * 752
    ms, by = rl.model_bound(m["DG"])
    assert ms == max(m["DG"]["bytes"] / 3.35e9, m["DG"]["ops"] / 67e9,
                     m["DG"]["int_ops"] / rl.H100_SXM["int32_ops_per_ms"])


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-2]), out[-1]


def test_main_runs_every_section_on_the_cpu(monkeypatch, capsys):
    use_small_bench(monkeypatch)
    assert bench.main(["--device", "cpu"]) == 0
    record, last = _lines(capsys)
    assert len(last) <= bench.HEADLINE_MAX_CHARS
    head = json.loads(last)
    assert head["kernels"] == record["kernels"] == "plain" and head["device"] == "cpu"
    assert not [k for k in record if k.endswith("_error")]
    for k in bench.HEADLINE_METRICS:
        if k == "link_d2h_MBps":         # a device link: not measured on the CPU
            assert record[k] is None
            continue
        assert np.isfinite(head[k]) and head[k] > 0, k
        if k in bench.SPREADS:
            s = head[bench.SPREADS[k]]
            assert 0 < s["min"] <= s["max"], k
    assert "roofline" not in head and "stage_ms" not in head
    assert set(record["stage_ms"]) == {"upload", "rectify", "disparity", "disparity_vis",
                                       "pointcloud", "total"}
    for key in ("remap", "stereobm", "speckle", "sgm_64d", "sgm_128d"):
        assert record["roofline"][key]["bound_ms"] > 0, key
    assert record["roofline"]["speckle"]["rounds_needed"] >= 1
    assert set(record["kernel_launches"].values()) == {0}      # plain versions only
    assert record["latency_ms_p50"] <= record["latency_ms_p95"]
    assert record["slam_stage_ms"]


def test_main_exits_1_when_a_section_raises(monkeypatch, capsys):
    use_small_bench(monkeypatch, BENCH_E2E="0", BENCH_STAGES="0", BENCH_ROOFLINE="0",
                    BENCH_SLAM="0")

    def broken(*a, **k):
        raise RuntimeError("made to fail")

    monkeypatch.setattr(bench, "_sgm_metric", broken)
    assert bench.main(["--device", "cpu"]) == 1
    record, last = _lines(capsys)
    head = json.loads(last)
    assert head["sgm_error"] == record["sgm_error"] == "RuntimeError: made to fail"
    assert head["value"] > 0


def test_headline_fits_with_long_errors():
    record = {"metric": "m", "device": {"platform": "cpu"}, "value": 1.0,
              **{f"s{i}_error": "x" * 300 for i in range(8)}}
    assert len(json.dumps(bench._headline(record))) <= bench.HEADLINE_MAX_CHARS


def test_main_defaults_to_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA"):
        bench.main([])


@needs_jax
def test_is_valid_point_matches_jax():
    rng = np.random.default_rng(5)
    xyz = rng.normal(size=(6, 7, 3)).astype(np.float32)
    xyz[0, 0, 2] = np.nan
    xyz[1, 2] = np.nan
    xyz[2, 3, 0] = np.inf
    xyz[3, 4, 1] = -np.inf
    got = treproject.is_valid_point(xyz)
    np.testing.assert_array_equal(got, jreproject.is_valid_point(xyz))
    assert got.dtype == bool and got.shape == (6, 7) and 0 < got.sum() < 42


@needs_jax
def test_fetch_frame_host_matches_jax():
    jm, tm = vo_models()
    frame = _plane_sequence(1)[0]
    disp = np.full((240, 320), 15.0, np.float32)
    jodo = JVO.StereoVisualOdometry(jm, num_features=256)
    todo = TVO.StereoVisualOdometry(tm, num_features=256, device="cpu")
    want = jodo.fetch_frame_host(jodo.dispatch(jnp.asarray(frame), jnp.asarray(disp))[0])
    got = todo.fetch_frame_host(todo.dispatch(torch.from_numpy(frame),
                                              torch.from_numpy(disp))[0])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["valid"].sum() > 100


@pytest.mark.cuda
def test_compute_window_has_no_host_sync():
    """On a card: the compute section's timed window at 752×480 (2 batches of
    2 frames) makes no synchronizing call (``set_sync_debug_mode("error")``
    raises on one) and gives the checksum of a plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mode watches CUDA synchronizations")
    model, left, right = bench._model_and_frame()
    dev = torch.device("cuda", 0)
    run = bench._frame_runner(model, bench._bench_config(),
                              bench.Outputs.of("disparity", "pointcloud"), dev)
    ls = torch.from_numpy(np.stack([left] * 2)).to(dev)
    rs = torch.from_numpy(np.stack([right] * 2)).to(dev)
    want = run(ls, rs).sum()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = bench._enqueue_batches(run, ls, rs, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool(torch.isfinite(got))
