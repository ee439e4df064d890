"""The port's SLAM engine (``models/slam.py``) against the JAX package's
``StereoSlam(use_pallas=False)`` on the CPU, on the toy sequence of
tests/test_slam.py (a textured plane at 2 m, the camera translating +x,
320×240, 16 disparities, block 9, texture 5, speckle off; here with a
blank frame that drops tracking, so the next frame relocalizes), and the port's
numpy copies (``utils/evaluate.py``, ``utils/io.py``, ``utils/synth.py``)
against the JAX package's modules.  Every port engine asks for
``device="cpu"`` (the default is the card).

Tolerances: keyframe decisions, match counts, tracked/lost/relocalized
flags and track ids exact; trajectories and keyframe poses atol 1e-5 m
(float32 solves reduced in another order); loop closures: the same pairs,
relative poses atol 1e-4; the copies of ``evaluate`` and ``io`` exact; the
numpy renderer within a mean |Δ| of 1 grey level of the cv2 one, with
identical poses and identical ground-truth files."""

import os

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import evaluate as tev
from ros_gpu_stereo_processor_tpu_torch.utils import io as tio
from ros_gpu_stereo_processor_tpu_torch.utils import synth as tsynth

try:
    import jax

    from ros_gpu_stereo_processor_tpu.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig)
    from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig as JSlamConfig
    from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam as JSlam
    from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
    from ros_gpu_stereo_processor_tpu.utils import evaluate as jev
    from ros_gpu_stereo_processor_tpu.utils import io as jio
    from ros_gpu_stereo_processor_tpu.utils import synth as jsynth
    from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
    from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel as JModel
except ImportError:   # a machine without the JAX reference runs the card test only
    jax = None
    PipelineConfig, SpeckleConfig, StereoBMConfig = (
        T.PipelineConfig, T.SpeckleConfig, T.StereoBMConfig)

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference package")

ATOL = 1e-5
KF_MESH_ATOL = 1e-4   # the sharded BA sums its blocks in another order than JAX's psum
PCFG = PipelineConfig(
    stereobm=StereoBMConfig(num_disparities=16, block_size=9, texture_threshold=5),
    speckle=SpeckleConfig(max_speckle_size=0),
)
TOY = dict(num_features=256, keyframe_every=2, window_size=3, ba_landmarks=64)


def _calib_args(width=320, height=240, fx=300.0, baseline=0.1):
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -fx * baseline
    return [(width, height, K, np.zeros(5), np.eye(3), PP, nm)
            for PP, nm in ((P, "left"), (Pr, "right"))]


def jax_model():
    return JModel.from_calibs(*(JCalib(*a) for a in _calib_args()))


def port_model():
    return tcal.StereoCameraModel.from_calibs(*(tcal.CameraCalib(*a) for a in _calib_args()))


def make_sequence(n_frames=8, shift_px=5, seed=0, W=320, H=240, fx=300.0, baseline=0.1):
    """tests/test_slam.py's sequence: (lefts, rights, true positions)."""
    rng = np.random.default_rng(seed)
    Z = 2.0
    d = fx * baseline / Z
    pad = int(shift_px * n_frames + np.ceil(d) + 8)
    tex = rng.integers(0, 255, (H, W + pad), np.uint8)
    lefts, rights, pos = [], [], []
    for i in range(n_frames):
        off = i * shift_px
        lefts.append(tex[:, off: off + W])
        rights.append(tex[:, off + int(round(d)): off + int(round(d)) + W])
        pos.append([i * shift_px * Z / fx, 0.0, 0.0])
    return lefts, rights, np.asarray(pos)


def jax_slam(mesh=None, **kw):
    return JSlam(jax_model(), JSlamConfig(use_pallas=False, **{**TOY, **kw}), PCFG, mesh=mesh)


def port_slam(mesh=None, **kw):
    return T.StereoSlam(port_model(), T.SlamConfig(**{**TOY, **kw}), T.from_jax_config(PCFG),
                        mesh=mesh, device=None if mesh is not None else "cpu")


def _step_all(slam, frames):
    return [slam.step(l, r, stamp=t) for l, r, t in frames]


def _frames(n=8, **kw):
    lefts, rights, pos = make_sequence(n, **kw)
    return [(l, r, 0.1 * i) for i, (l, r) in enumerate(zip(lefts, rights))], pos


FLAGS = ("is_keyframe", "tracked", "lost", "relocalized", "n_matches")


def assert_same_run(jinfos, tinfos, js, ts, atol=ATOL):
    """Per-frame flags exact, poses within ``atol``, the same keyframes with
    the same track ids, the same alive tracks."""
    assert len(jinfos) == len(tinfos)
    for i, (a, b) in enumerate(zip(jinfos, tinfos)):
        assert tuple(a[f] for f in FLAGS) == tuple(b[f] for f in FLAGS), f"frame {i}"
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], rtol=0, atol=atol)
        np.testing.assert_allclose(b["R_wc"], a["R_wc"], rtol=0, atol=atol)
    assert len(js.store) == len(ts.store)
    for k, (a, b) in enumerate(zip(js.store.frames, ts.store.frames)):
        np.testing.assert_array_equal(b.track_ids, a.track_ids, err_msg=f"keyframe {k}")
        np.testing.assert_allclose(b.t_wc, a.t_wc, rtol=0, atol=atol)
    np.testing.assert_array_equal(ts.tracks.alive, js.tracks.alive)
    np.testing.assert_allclose(np.stack(ts.traj_t), np.stack(js.traj_t), rtol=0, atol=atol)


def _toy_sequence():
    """The toy sequence with a blank frame after frame 4: tracking drops on
    the blank frame (no features), and the next frame, which matches
    nothing in the blank one, relocalizes against the track store.  Returns
    (the 10 frames stepped, 2 further frames, true positions)."""
    frames, pos = _frames(11)
    blank = np.full_like(frames[0][0], 128)
    return frames[:5] + [(blank, blank, 0.45)] + frames[5:9], frames[9:], pos


@pytest.fixture(scope="module")
def toy():
    seq, rest, pos = _toy_sequence()
    js, ts = jax_slam(), port_slam()
    return seq, rest, pos, js, _step_all(js, seq), ts, _step_all(ts, seq)


@needs_jax
def test_toy_sequence_matches_jax(toy):
    seq, _, pos, js, jinfos, ts, tinfos = toy
    assert_same_run(jinfos, tinfos, js, ts)
    assert 2 <= len(ts.store) <= 8
    assert tinfos[5]["lost"] and not tinfos[5]["relocalized"]
    assert tinfos[6]["lost"] and tinfos[6]["relocalized"]
    assert all(b["tracked"] for i, b in enumerate(tinfos[1:], 1) if i not in (5, 6))
    assert np.linalg.norm(tinfos[-1]["t_wc"] - pos[8]) < 0.05


@needs_jax
def test_run_stream_sync_equals_step(toy):
    seq, _, _, _, _, ts, tinfos = toy
    s2 = port_slam()
    infos = list(s2.run_stream(iter(seq), depth=2))
    for f in FLAGS:
        assert [i[f] for i in infos] == [i[f] for i in tinfos], f
    np.testing.assert_array_equal(np.stack(s2.traj_t), np.stack(ts.traj_t))
    for a, b in zip(s2.store.frames, ts.store.frames):
        np.testing.assert_array_equal(a.track_ids, b.track_ids)


def test_run_stream_async_mapping_matches_sync():
    """tests/test_slam.py::test_run_stream_async_mapping_matches_sync on the
    port: same frame count, keyframes within 1, final pose within 0.05 m."""
    frames, _ = _frames(10)
    s_sync = port_slam()
    _step_all(s_sync, frames)
    s_async = port_slam()
    infos = list(s_async.run_stream(iter(frames), async_mapping=True))
    assert len(infos) == len(frames)
    assert abs(len(s_async.store) - len(s_sync.store)) <= 1
    assert len(s_async.store) == s_async._kf_count
    assert np.linalg.norm(s_async.vo.state.t_wc - s_sync.vo.state.t_wc) < 0.05


@needs_jax
def test_loop_closure_matches_jax():
    """tests/test_slam.py::test_loop_closure_detection_and_correction on both
    engines: out and back over the toy sequence, closures between the
    revisits and the first visits, optimize_global pulls injected drift
    back."""
    lefts, rights, _ = make_sequence(5, shift_px=4)
    kw = dict(keyframe_every=1, window_size=2, keyframe_min_translation=1e9,
              keyframe_min_rotation=1e9)
    js, ts = jax_slam(**kw), port_slam(**kw)
    for k, idx in enumerate([0, 1, 2, 3, 4, 3, 2, 1, 0]):
        js.step(lefts[idx], rights[idx], stamp=0.1 * k)
        ts.step(lefts[idx], rights[idx], stamp=0.1 * k)
    jc = js.detect_loop_closures(min_separation=4, min_matches=15)
    tc = ts.detect_loop_closures(min_separation=4, min_matches=15)
    assert [(i, j) for i, j, _, _ in tc] == [(i, j) for i, j, _, _ in jc]
    assert len(tc) >= 1
    for (_, _, Ra, ta), (_, _, Rb, tb) in zip(jc, tc):
        np.testing.assert_allclose(Rb, Ra, atol=1e-4)
        np.testing.assert_allclose(tb, ta, atol=1e-4)
    best = min(tc, key=lambda c: np.linalg.norm(c[3]))
    assert np.linalg.norm(best[3]) < 0.02

    for s in (js, ts):
        s.store.frames[-1].t_wc = s.store.frames[-1].t_wc + np.array([0.05, 0, 0])
    before = ts.store.frames[-1].t_wc.copy()
    assert js.optimize_global(iters=10) == ts.optimize_global(iters=10) >= 1
    after, target = ts.store.frames[-1].t_wc, ts.store.frames[0].t_wc
    assert np.linalg.norm(after - target) < np.linalg.norm(before - target)
    np.testing.assert_allclose(np.stack([k.t_wc for k in ts.store.frames]),
                               np.stack([k.t_wc for k in js.store.frames]), atol=1e-4)


@needs_jax
def test_checkpoint_roundtrip(tmp_path, toy):
    ts = toy[5]
    path = str(tmp_path / "ckpt.pt")
    ts.save_checkpoint(path)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"store", "tracks", "traj_stamps", "traj_R", "traj_t", "vo_R", "vo_t"}
    assert raw["store"]["kp_desc"].dtype == torch.uint32
    s2 = T.StereoSlam(port_model(), T.SlamConfig(), device="cpu")
    s2.load_checkpoint(path)
    assert len(s2.store) == len(ts.store) == s2._kf_count
    for a, b in zip(s2.store.frames, ts.store.frames):
        np.testing.assert_array_equal(a.t_wc, b.t_wc)
        np.testing.assert_array_equal(a.track_ids, b.track_ids)
        for f in ("xy", "score", "angle", "desc", "valid"):
            assert torch.equal(getattr(a.kp, f), getattr(b.kp, f)), f
    np.testing.assert_array_equal(s2.tracks.pos_w, ts.tracks.pos_w)
    np.testing.assert_array_equal(s2.tracks.desc, ts.tracks.desc)
    np.testing.assert_array_equal(s2.vo.state.t_wc, ts.vo.state.t_wc)
    np.testing.assert_array_equal(s2.trajectory().t, ts.trajectory().t)


@needs_jax
def test_load_state_from_a_jax_run_then_optimize_global(tmp_path, toy):
    """The JAX engine's state after the toy sequence carries into the port
    (``load_state``) as into a fresh JAX engine (``load_checkpoint``); both
    step 2 more frames, then ``optimize_global`` (odometry edges only)."""
    import orbax.checkpoint as ocp

    _, rest, _, j0, _, _, _ = toy
    path = str(tmp_path / "jax_ckpt")
    j0.save_checkpoint(path)
    js = jax_slam()
    js.load_checkpoint(path)
    state = jax.tree.map(np.asarray, ocp.PyTreeCheckpointer().restore(os.path.abspath(path)))
    ts = port_slam()
    ts.load_state(state)
    assert len(ts.store) == len(j0.store) == ts._kf_count
    np.testing.assert_array_equal(ts.store.frames[-1].kp.desc.numpy().view(np.uint32),
                                  np.asarray(j0.store.frames[-1].kp.desc))
    np.testing.assert_array_equal(ts.tracks.pos_w, j0.tracks.pos_w)
    jinfos, tinfos = _step_all(js, rest), _step_all(ts, rest)
    assert_same_run(jinfos, tinfos, js, ts)

    before = np.stack([k.t_wc for k in ts.store.frames])
    assert js.optimize_global(iters=5) == ts.optimize_global(iters=5)
    after = np.stack([k.t_wc for k in ts.store.frames])
    assert np.isfinite(after).all() and np.linalg.norm(after - before) < 0.5
    np.testing.assert_allclose(after, np.stack([k.t_wc for k in js.store.frames]), atol=ATOL)
    np.testing.assert_allclose(np.stack(ts.traj_t), np.stack(js.traj_t), atol=ATOL)
    np.testing.assert_allclose(ts.tracks.pos_w, js.tracks.pos_w, atol=1e-4)
    np.testing.assert_allclose(ts.vo.state.t_wc, js.vo.state.t_wc, atol=ATOL)


def test_band_mesh_frontend_equals_unsharded():
    """A 2-band CPU mesh runs the dense frontend by row bands (speckle off):
    the same dense outputs, so the same run."""
    frames, _ = _frames(6)
    s_mesh = port_slam(mesh=make_mesh(2, devices=["cpu"] * 2))
    assert s_mesh.pipeline.mesh is not None and s_mesh.device == torch.device("cpu")
    s_ref = port_slam()
    a, b = _step_all(s_mesh, frames), _step_all(s_ref, frames)
    assert [i["is_keyframe"] for i in a] == [i["is_keyframe"] for i in b]
    np.testing.assert_array_equal(np.stack(s_mesh.traj_t), np.stack(s_ref.traj_t))
    for x, y in zip(s_mesh.store.frames, s_ref.store.frames):
        np.testing.assert_array_equal(x.track_ids, y.track_ids)


@needs_jax
def test_kf_mesh_axis_and_missing_cuda_raise():
    """A ``kf`` mesh of 2 CPU entries runs the windowed BA landmark-sharded
    (the pipeline on one device), as the JAX engine on a 2-device ``kf``
    mesh does: the same keyframes and track ids, poses within
    KF_MESH_ATOL.  Without CUDA the default device raises."""
    frames, _ = _frames(8)
    ts = port_slam(mesh=make_mesh(2, ("kf",), devices=["cpu"] * 2))
    assert ts.pipeline.mesh is None and ts._ba_mesh.size == 2
    js = jax_slam(mesh=jax_mesh(2, ("kf",)))
    assert_same_run(_step_all(js, frames), _step_all(ts, frames), js, ts, atol=KF_MESH_ATOL)
    assert len(ts.store) >= 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.StereoSlam(port_model(), T.SlamConfig())


@needs_jax
def test_kf_rows_mesh_matches_jax_and_runs_async():
    """BASELINE config 5 as one engine: a (kf, rows) 2 × 4 mesh runs the
    pipeline by row bands on ``along("rows")`` and the BA on
    ``along("kf")``; synchronous, it equals the JAX engine on its (kf, rows)
    mesh within KF_MESH_ATOL.  The JAX engine under async mapping crashes
    now and then (R1), so it is no oracle there: the port's async run is
    held to its synchronous one (tests/test_slam.py's bar)."""
    frames, _ = _frames(10)
    mesh = make_mesh(8, ("kf", "rows"), shape=(2, 4), devices=["cpu"] * 8)
    ts = port_slam(mesh=mesh)
    assert ts.pipeline.mesh is mesh.along("rows") and ts.pipeline.mesh.size == 4
    assert ts._ba_mesh.size == 2
    js = jax_slam(mesh=jax_mesh(8, ("kf", "rows"), shape=(2, 4)))
    assert_same_run(_step_all(js, frames), _step_all(ts, frames), js, ts, atol=KF_MESH_ATOL)
    s_async = port_slam(mesh=mesh)
    infos = list(s_async.run_stream(iter(frames), async_mapping=True))
    assert len(infos) == len(frames)
    assert len(s_async.store) == s_async._kf_count >= 2
    assert abs(len(s_async.store) - len(ts.store)) <= 1
    assert np.isfinite(np.stack(s_async.traj_t)).all()
    assert np.linalg.norm(s_async.vo.state.t_wc - ts.vo.state.t_wc) < 0.05


# ---------------------------------------------------------------------------
# the numpy copies: evaluate, io, synth
# ---------------------------------------------------------------------------


@needs_jax
def test_evaluate_copy_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(20, 4))
    np.testing.assert_array_equal(tev.quat_to_rot(q), jev.quat_to_rot(q))
    src = rng.normal(0, 1, (50, 3))
    dst = src @ jev.quat_to_rot(q[0]).T * 1.3 + np.array([1.0, -2.0, 0.5])
    for scale in (False, True):
        for a, b in zip(tev.umeyama(src, dst, scale), jev.umeyama(src, dst, scale)):
            np.testing.assert_array_equal(a, b)
    stamps = np.arange(30) * 0.1
    t = np.cumsum(rng.normal(0, 0.1, (30, 3)), axis=0)
    gt_t, gt_j = tev.Trajectory(stamps, t), jev.Trajectory(stamps, t)
    est = t + rng.normal(0, 0.02, t.shape)
    est_t = tev.Trajectory(stamps[::2] + 0.004, est[::2])
    est_j = jev.Trajectory(stamps[::2] + 0.004, est[::2])
    for a, b in zip(tev.associate(est_t, gt_t, 0.01), jev.associate(est_j, gt_j, 0.01)):
        np.testing.assert_array_equal(a, b)
    assert tev.ate_rmse(est_t, gt_t) == jev.ate_rmse(est_j, gt_j)
    assert tev.ate_rmse(est_t, gt_t, with_scale=True) == jev.ate_rmse(est_j, gt_j, with_scale=True)
    assert tev.rpe_rmse(est_t, gt_t, 2) == jev.rpe_rmse(est_j, gt_j, 2)


@needs_jax
def test_timestamp_pairing_copy_matches_jax():
    rng = np.random.default_rng(2)
    left = list(np.cumsum(rng.uniform(0.04, 0.06, 40)))
    right = sorted(x + rng.normal(0, 0.004) for x in left[3:])
    right[5] = left[8]
    assert tio.pair_timestamps_exact(left, right) == jio.pair_timestamps_exact(left, right)
    for slop in (0.001, 0.005, 0.02):
        assert (tio.pair_timestamps_approx(left, right, slop)
                == jio.pair_timestamps_approx(left, right, slop))


@pytest.fixture(scope="module")
def planar_dirs(tmp_path_factory):
    """The same small planar sequence written by the JAX module (cv2) and by
    the port's (numpy renderer, imageio)."""
    kw = dict(n_frames=6, width=160, height=120, fx=150.0, Z0=3.0, radius=0.25, seed=1)
    jroot = str(tmp_path_factory.mktemp("jax_planar"))
    troot = str(tmp_path_factory.mktemp("port_planar"))
    return jroot, jsynth.make_planar_euroc(jroot, **kw), troot, tsynth.make_planar_euroc(troot, **kw)


@needs_jax
def test_euroc_reader_copy_matches_jax(planar_dirs):
    jroot = planar_dirs[0]
    jf, tf = list(jio.EurocReader(jroot)), list(tio.EurocReader(jroot))
    assert len(tf) == len(jf) == len(tio.EurocReader(jroot)) == 6
    for a, b in zip(jf, tf):
        assert (a.stamp, a.encoding, a.seq) == (b.stamp, b.encoding, b.seq)
        np.testing.assert_array_equal(b.left, a.left)
        np.testing.assert_array_equal(b.right, a.right)
    ga, gb = jev.load_euroc_groundtruth(jroot), tev.load_euroc_groundtruth(jroot)
    for f in ("stamps", "t", "R"):
        np.testing.assert_array_equal(getattr(gb, f), getattr(ga, f))
    src = tio.ImagePairSource(tf)
    assert len(src) == 6 and next(iter(src)) is tf[0]


@needs_jax
def test_numpy_renderer_against_cv2(planar_dirs):
    jroot, jcal, troot, tcal_paths = planar_dirs
    # identical poses, ground-truth files and calibrations, byte for byte
    for rel in ("mav0/state_groundtruth_estimate0/data.csv", "mav0/cam0/data.csv",
                "mav0/cam1/data.csv"):
        with open(os.path.join(jroot, rel)) as a, open(os.path.join(troot, rel)) as b:
            assert a.read() == b.read(), rel
    for a, b in zip(jcal, tcal_paths):
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()
    for (Ra, ta), (Rb, tb) in zip(jsynth.loop_trajectory(12), tsynth.loop_trajectory(12)):
        np.testing.assert_array_equal(Rb, Ra)
        np.testing.assert_array_equal(tb, ta)
        np.testing.assert_array_equal(tsynth.rot_to_quat(Rb), jsynth.rot_to_quat(Ra))
    for a, b in zip(jio.EurocReader(jroot), tio.EurocReader(troot)):
        for x, y in ((a.left, b.left), (a.right, b.right)):
            assert y.dtype == np.uint8 and y.shape == x.shape
            assert np.abs(y.astype(np.int32) - x).mean() <= 1.0
    # the in-memory frames are the written ones
    lefts, _, gt = tsynth.render_planar(6, 160, 120, 150.0, 0.1, 3.0, 10.0, 1, 0.25)
    np.testing.assert_array_equal(lefts[2], list(tio.EurocReader(troot))[2].left)
    np.testing.assert_allclose(gt.t, tev.load_euroc_groundtruth(troot).t, atol=1e-9)


@needs_jax
def test_layered_renderer_against_cv2(tmp_path):
    kw = dict(n_frames=3, width=160, height=120, fx=100.0, degraded_frames=(1,),
              dynamic_occluders=1, exposure_banding=0.1)
    jsynth.make_layered_euroc(str(tmp_path), **kw)
    lefts, rights, _ = tsynth.render_layered(**kw)
    for fr, l, r in zip(jio.EurocReader(str(tmp_path)), lefts, rights):
        assert np.abs(l.astype(np.int32) - fr.left).mean() <= 1.0
        assert np.abs(r.astype(np.int32) - fr.right).mean() <= 1.0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_slam_on_cuda_matches_cpu():
    """The toy sequence on the card against the port's CPU run: the same
    keyframe decisions, match counts and track ids, keypoints exact (the
    dense pipeline is exact on the card), poses within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, _ = _frames(8)
    cpu = port_slam()
    gpu = T.StereoSlam(port_model(), T.SlamConfig(**TOY), T.from_jax_config(PCFG))
    for l, r, t in frames:
        a, b = cpu.step(l, r, t), gpu.step(l, r, t)
        assert tuple(a[f] for f in FLAGS) == tuple(b[f] for f in FLAGS)
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], atol=1e-4)
        for f in ("xy", "valid"):
            assert torch.equal(getattr(gpu.vo.state.prev.kp, f).cpu(),
                               getattr(cpu.vo.state.prev.kp, f))
    for x, y in zip(gpu.store.frames, cpu.store.frames):
        np.testing.assert_array_equal(x.track_ids, y.track_ids)
