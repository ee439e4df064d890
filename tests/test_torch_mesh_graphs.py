"""The mesh step and the windowed BA solve as compiled dispatches: the
row-band speckle filter's merge loop on the device, the gated band label
rounds, the mesh variant captured on one card, and the BA solve captured
per window shape.

On the CPU (no graphs: the captured functions are called as they are):

  * the port's ``filter_speckles_row_sharded`` against the JAX one (run as
    tests/test_parallel.py runs it, on the conftest's virtual CPU mesh) for
    n ∈ {1, 2, 4} bands and ``merge_rounds`` ∈ {0, 1, 2}: the labels the
    merge loop leaves against a reference loop written here with the JAX
    package's scans and JAX's exit (``i < max_merge & changed``, read on
    the host), the band-local sizes against counts of those labels, and
    the filtered disparity and keep mask against JAX's, all exact; the loop
    runs exactly ``max_merge`` rounds, each one ``psum``, and never calls
    ``Mesh.any``;
  * the gated label rounds: equal to the ungated ones when ``done`` is 0, a
    copy of the field when it is 1;
  * the BA entry of ``StereoSlam._ba_solve`` against eager
    ``BA.bundle_adjust`` (exact) and the JAX ``bundle_adjust`` (atol 1e-4 +
    rtol 1e-4, tests/test_torch_ba.py's tolerance) for windows of 2–5
    keyframes, one cache entry per window shape, reused;
  * the landmark-sharded BA entry of ``StereoSlam._ba_solve`` on a CPU
    ``kf`` line of 2 against eager ``bundle_adjust_sharded`` (exact)
    and the JAX ``bundle_adjust_sharded`` on the conftest's virtual mesh
    (t and R atol 1e-3, points 5e-3: JAX's own bars, tests/test_dist_ba.py),
    one cache entry per window shape, reused.

On the card (marked ``cuda``; they skip elsewhere and import no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_graphs.py

  * the gated band label kernel against its ungated launch and a copy;
  * a 4-band mesh frame on ``["cuda:0"] * 4`` (BM, BM ``lr_check``, SGM,
    slabs) captured and replayed, bit for bit against the eager step, with
    no host sync in the eager frame (``set_sync_debug_mode("error")``);
  * the BA solve captured per window shape, bit for bit against eager;
  * the landmark-sharded BA captured on a ``["cuda:0"] * 2`` ``kf`` line,
    bit for bit against eager, one graph replay per call after the first
    of each window shape.
"""

import functools

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.models import ba as TBA
from ros_gpu_stereo_processor_tpu_torch.models import slam as tslam
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as tspeckle
from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as tpar
from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import bundle_adjust_sharded
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import Mesh, make_mesh
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import graphs

try:
    import jax.numpy as jnp

    from ros_gpu_stereo_processor_tpu.models import ba as JBA
    from ros_gpu_stereo_processor_tpu.parallel.dist_ba import (
        bundle_adjust_sharded as jax_sharded)
    from ros_gpu_stereo_processor_tpu.ops import speckle as jspeckle
    from ros_gpu_stereo_processor_tpu.parallel import frontend as jpar
    from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
except ImportError:   # a machine without the JAX reference runs the card tests only
    jnp = None

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jnp is None, reason="needs the JAX reference package")

SPECKLE = dict(max_speckle_size=20, max_diff=1.0)


def _field(H=96, W=128, seed=11):
    """tests/test_torch_parallel.py's random field: many components that
    cross the band edges, so the loop needs several merge rounds."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, (H, W)).astype(np.float32), rng.random((H, W)) > 0.2)


def _reference_labels(disp, valid, n, max_diff, max_merge):
    """The merge loop's labels, from the JAX package's scans with JAX's
    exit (``i < max_merge & changed``) read on the host: (H, W) int32."""
    H, W = disp.shape
    hb, sentinel = H // n, H * W
    d = [jnp.asarray(disp[i * hb:(i + 1) * hb]) for i in range(n)]
    v = [jnp.asarray(valid[i * hb:(i + 1) * hb]) for i in range(n)]
    conn = [jspeckle._connectivity(a, b, max_diff) for a, b in zip(d, v)]
    link_top = [jnp.zeros(W, bool)] + [v[i][0] & v[i - 1][-1] & (
        jnp.abs(d[i][0] - d[i - 1][-1]) <= max_diff) for i in range(1, n)]
    link_bot = link_top[1:] + [jnp.zeros(W, bool)]
    pix = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    lab = [jnp.where(v[i], pix[i * hb:(i + 1) * hb], sentinel) for i in range(n)]
    i, changed = 0, True
    while i < max_merge and changed:
        new = []
        for x, (cx, cy) in zip(lab, conn):
            for _ in range(2):
                x = jspeckle._segmented_min_scan(x, cx, axis=1)
                x = jspeckle._segmented_min_scan(x, cy, axis=0)
            new.append(x)
        if n > 1:
            top = [jnp.where(link_top[b], jnp.minimum(new[b][0], new[b - 1][-1] if b else 0),
                             new[b][0]) for b in range(n)]
            bot = [jnp.where(link_bot[b], jnp.minimum(new[b][-1], new[b + 1][0] if b < n - 1
                                                      else 0), new[b][-1]) for b in range(n)]
            new = [x.at[0].set(t).at[-1].set(u) for x, t, u in zip(new, top, bot)]
        changed = any(bool(jnp.any(a != b)) for a, b in zip(new, lab))
        lab, i = new, i + 1
    return np.concatenate([np.where(np.asarray(b), np.asarray(x), sentinel)
                           for b, x in zip(v, lab)])


@needs_jax
@pytest.mark.parametrize("merge_rounds", [0, 1, 2])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_device_merge_loop_matches_jax(n, merge_rounds, monkeypatch):
    """The port's fixed-round merge loop (gated label rounds, a ``psum`` a
    round, no host read) gives JAX's labels, band-local sizes and filtered
    output bit for bit, converged and capped."""
    disp, valid = _field()
    H, W = disp.shape
    hb, cap = H // n, SPECKLE["max_speckle_size"] + 1
    max_merge = merge_rounds if merge_rounds > 0 else 4 * n + 8

    def no_host_read(*_):
        raise AssertionError("the merge loop read its flag on the host")

    monkeypatch.setattr(Mesh, "any", no_host_read, raising=False)
    calls = {"psum": 0, "band_labels": 0}
    labels = []

    def counted(name, fn):
        @functools.wraps(fn)
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(Mesh, "psum", counted("psum", Mesh.psum))
    monkeypatch.setattr(speckle_kernel, "band_labels",
                        counted("band_labels", speckle_kernel.band_labels))
    band_counts = tpar._band_counts
    monkeypatch.setattr(tpar, "_band_counts",
                        lambda lab, *a: labels.append(lab) or band_counts(lab, *a))

    mesh = make_mesh(n, devices=["cpu"] * n)
    d, v = tpar.filter_speckles_row_sharded(torch.from_numpy(disp), torch.from_numpy(valid),
                                            mesh, iters=16, fill_value=-1.0,
                                            merge_rounds=merge_rounds, **SPECKLE)
    assert calls == {"psum": max_merge, "band_labels": n * max_merge}
    want_lab = _reference_labels(disp, valid, n, SPECKLE["max_diff"], max_merge)
    np.testing.assert_array_equal(torch.cat(labels).numpy(), want_lab)

    fields = tpar.speckle_size_fields([torch.from_numpy(disp[i * hb:(i + 1) * hb])
                                       for i in range(n)],
                                      [torch.from_numpy(valid[i * hb:(i + 1) * hb])
                                       for i in range(n)], mesh, merge_rounds=merge_rounds,
                                      **SPECKLE)
    for b, (field, _, _) in enumerate(fields):
        lb = want_lab[b * hb:(b + 1) * hb]
        _, inv, counts = np.unique(lb, return_inverse=True, return_counts=True)
        cnt = np.minimum(counts[inv.reshape(-1)].reshape(lb.shape), cap)
        # the boundary rows carry the reconciled totals of crossing components
        inner = slice(None) if n == 1 else slice(1, -1)
        np.testing.assert_array_equal(field.numpy()[inner], cnt[inner])

    jd, jv = jpar.filter_speckles_row_sharded(jnp.asarray(disp), jnp.asarray(valid),
                                              jax_mesh(n), iters=16, fill_value=-1.0,
                                              merge_rounds=merge_rounds, **SPECKLE)
    np.testing.assert_array_equal(torch.cat(v).numpy(), np.asarray(jv))
    np.testing.assert_array_equal(torch.cat(d).numpy(), np.asarray(jd))


@needs_jax
def test_capped_merge_stops_before_convergence():
    """The capped cases above are real caps: one merge round on 4 bands
    leaves other labels than the converged loop."""
    disp, valid = _field()
    assert not np.array_equal(_reference_labels(disp, valid, 4, 1.0, 1),
                              _reference_labels(disp, valid, 4, 1.0, 24))


@pytest.mark.parametrize("rounds", [1, 2, 5])
def test_gated_label_rounds(rounds):
    """``done`` 0: the ungated rounds; ``done`` 1: a copy of the field, for
    the plain version and the wrapper on a CPU tensor."""
    disp, valid = _field(48, 80, seed=5)
    d, v = torch.from_numpy(disp), torch.from_numpy(valid)
    cx, cy = tspeckle._connectivity(d, v, 1.0)
    lab = torch.where(v, torch.arange(48 * 80, dtype=torch.int32).reshape(48, 80),
                      torch.full((), 48 * 80, dtype=torch.int32))
    ungated = tspeckle._label_rounds(lab, cx, cy, rounds)
    assert not torch.equal(ungated, lab)
    off, on = (torch.tensor(f, dtype=torch.int32) for f in (0, 1))
    for fn in (tspeckle._label_rounds, speckle_kernel.band_labels):
        assert torch.equal(fn(lab, cx, cy, rounds, off), ungated)
        got = fn(lab, cx, cy, rounds, on)
        assert torch.equal(got, lab) and got.data_ptr() != lab.data_ptr()
    with pytest.raises(ValueError, match="done"):
        speckle_kernel.band_labels(lab, cx, cy, rounds, on.to(torch.int64))


def _model(width=128, height=96):
    K = np.array([[110.0, 0, width / 2], [0, 110.0, height / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -11.0
    return tcal.StereoCameraModel.from_calibs(*(
        tcal.CameraCalib(width, height, K, np.zeros(5), np.eye(3), PP, nm)
        for PP, nm in ((P, "left"), (Pr, "right"))))


def _window(M, N=256, seed=0, n_eff=200):
    """A padded BA window as ``_local_ba`` builds it (numpy float32): M
    world→camera poses, N landmark slots (the last N − n_eff padding at
    depth 1), noisy observations of a partial mask, and the stereo point
    prior on the real slots."""
    rng = np.random.default_rng(seed + M)
    fx, cx, cy = 110.0, 64.0, 48.0
    pts = rng.uniform([-1.5, -1.0, 2.5], [1.5, 1.0, 5.0], (N, 3))
    ang = 0.02 * np.arange(M)
    R = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
                  for a in ang])
    t = np.stack([[-0.1 * m, 0.01 * m, 0.0] for m in range(M)])
    pc = np.einsum("mij,nj->mni", R, pts) + t[:, None]
    obs = np.stack([fx * pc[..., 0] / pc[..., 2] + cx, fx * pc[..., 1] / pc[..., 2] + cy], -1)
    obs += rng.normal(0, 0.4, obs.shape)
    mask = (rng.random((M, N)) < 0.8).astype(np.float32)
    mask[:, n_eff:] = 0.0
    pts0 = pts + rng.normal(0, 0.02, pts.shape)
    pts0[n_eff:] = [0.0, 0.0, 1.0]
    t0 = t + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.01, (M - 1, 3))])
    prior = np.where(np.arange(N) < n_eff, 10.0, 0.0)
    return [np.asarray(a, np.float32) for a in (R, t0, pts0, obs, mask, prior)]


@pytest.fixture(scope="module")
def cpu_slam():
    return tslam.StereoSlam(_model(), tslam.SlamConfig(),
                            T.PipelineConfig(speckle=T.SpeckleConfig(max_speckle_size=0)),
                            device="cpu")


def _eager_ba(arrays, cam, iters, device="cpu", kf=None):
    """The window's solve run eagerly: ``BA.bundle_adjust``, or with ``kf``
    (a ``kf`` line) ``bundle_adjust_sharded``; and each landmark's rms."""
    R, t, pts, obs, mask, prior = (torch.from_numpy(a).to(device) for a in arrays)
    p = TBA.BAProblem(R, t, pts, obs, mask, *cam)
    if kf is None:
        pf, _ = TBA.bundle_adjust(p, iters=iters, point_prior=prior)
    else:
        pf, _ = bundle_adjust_sharded(p, kf, iters=iters, point_prior=prior)
    r, _ = TBA.reprojection_residuals(pf)
    rn2 = torch.sum(r * r, -1)
    rms = torch.sqrt(torch.sum(rn2 * mask, 0) / torch.clamp(torch.sum(mask, 0), min=1.0))
    return pf.R, pf.t, pf.points, rms


@needs_jax
@pytest.mark.parametrize("M", [2, 3, 4, 5])
def test_ba_entry_matches_eager_and_jax(cpu_slam, M):
    """The BA entry for an M-keyframe window equals eager
    ``BA.bundle_adjust`` (and the per-landmark rms beside it) exactly, and
    the JAX ``bundle_adjust`` within atol 1e-4 + rtol 1e-4."""
    arrays = _window(M)
    cfg = cpu_slam.config
    got = cpu_slam._ba_solve(M)(*arrays)
    want = _eager_ba(arrays, cpu_slam._cam(), cfg.ba_iters)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    R, t, pts, obs, mask, prior = (jnp.asarray(a) for a in arrays)
    jp = JBA.BAProblem(R=R, t=t, points=pts, obs=obs, mask=mask, fx=110.0, cx=64.0, cy=48.0)
    jf, _ = JBA.bundle_adjust(jp, iters=cfg.ba_iters, point_prior=prior)
    for g, w in zip(got[:3], (jf.R, jf.t, jf.points)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_ba_solves_cached_per_window_shape(cpu_slam):
    """Windows of 2–5 keyframes make 4 cache entries, each reused."""
    cpu_slam._ba_solves.clear()
    first = {M: cpu_slam._ba_solve(M) for M in (2, 3, 4, 5)}
    assert len(cpu_slam._ba_solves) == 4
    assert all(cpu_slam._ba_solve(M) is fn for M, fn in first.items())
    assert all(isinstance(fn, graphs.Captured) for fn in first.values())


@pytest.fixture(scope="module")
def cpu_kf_slam():
    return tslam.StereoSlam(_model(), tslam.SlamConfig(),
                            T.PipelineConfig(speckle=T.SpeckleConfig(max_speckle_size=0)),
                            mesh=make_mesh(2, ("kf",), devices=["cpu"] * 2))


@needs_jax
@pytest.mark.parametrize("M", [2, 5])
def test_sharded_ba_entry_matches_eager_and_jax(cpu_kf_slam, M):
    """The sharded BA entry for an M-keyframe window on a CPU ``kf`` line
    of 2 equals eager ``bundle_adjust_sharded`` (and the per-landmark rms
    beside it) exactly, and the JAX ``bundle_adjust_sharded`` on a 2-device
    ``kf`` mesh within JAX's bars: t and R atol 1e-3, points 5e-3."""
    slam, arrays = cpu_kf_slam, _window(M)
    iters = slam.config.ba_iters
    got = slam._ba_solve(M)(*arrays)
    want = _eager_ba(arrays, slam._cam(), iters, kf=slam._ba_mesh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    R, t, pts, obs, mask, prior = (jnp.asarray(a) for a in arrays)
    jp = JBA.BAProblem(R=R, t=t, points=pts, obs=obs, mask=mask, fx=110.0, cx=64.0, cy=48.0)
    jf, _ = jax_sharded(jp, jax_mesh(2, ("kf",)), iters=iters, point_prior=prior)
    for g, w, atol in zip(got[:3], (jf.R, jf.t, jf.points), (1e-3, 1e-3, 5e-3)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


def test_sharded_ba_solves_cached_per_window_shape(cpu_kf_slam):
    """Windows of 2–5 keyframes make 4 sharded entries, each reused, keyed
    by the line's size beside the single-device solves' None, and each
    solving over the line."""
    slam = cpu_kf_slam
    slam._ba_solves.clear()
    first = {M: slam._ba_solve(M) for M in (2, 3, 4, 5)}
    assert len(slam._ba_solves) == 4
    assert all(slam._ba_solve(M) is fn for M, fn in first.items())
    assert all(isinstance(fn, graphs.Captured) for fn in first.values())
    assert all(fn.fn.keywords["mesh"] is slam._ba_mesh for fn in first.values())
    cfg = slam.config
    assert (5, cfg.ba_landmarks, 2, cfg.ba_iters, *slam._cam()) in slam._ba_solves
    plain = tslam.StereoSlam(_model(), cfg, T.PipelineConfig(
        speckle=T.SpeckleConfig(max_speckle_size=0)), device="cpu")
    assert plain._ba_solve(5).fn.keywords["mesh"] is None
    assert list(plain._ba_solves) == [(5, cfg.ba_landmarks, None, cfg.ba_iters,
                                       *plain._cam())]


@pytest.mark.parametrize("devices, one", [(["cpu"] * 4, True), (["cpu:0", "cpu:1"] * 2, False),
                                          (["cpu:0", "cpu:0", "cpu:1", "cpu:1"], False)])
def test_on_one_device_decides_capture(devices, one):
    """A mesh whose entries are one device in this process may be captured:
    the pipeline's mesh step is a :class:`graphs.Captured` exactly then, and
    the ``kf`` and ``rows`` lines of a 2 × 2 mesh follow their own entries."""
    mesh = make_mesh(4, ("kf", "rows"), shape=(2, 2), devices=devices)
    assert mesh.on_one_device() == one
    assert mesh.along("rows").on_one_device() == (len(set(devices[:2])) == 1)
    assert mesh.along("kf").on_one_device() == (devices[0] == devices[2])
    rows = make_mesh(4, ("rows",), devices=devices)
    pipe = T.StereoPipeline(_model(), T.PipelineConfig(
        speckle=T.SpeckleConfig(max_speckle_size=0)), mesh=rows)
    step = pipe._get_variant(T.Outputs.of("disparity"), "mono8")
    assert isinstance(step, graphs.Captured) == one
    pipe.senders.shutdown()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CH, CW = 480, 752


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
def test_gated_band_labels_kernel(dev):
    """The gated kernel: ``done`` 0 equals the ungated launch, ``done`` 1 a
    copy of the field; each call one launch of the band label rounds."""
    disp, valid = _field(120, CW, seed=3)
    d, v = torch.from_numpy(disp).to(dev), torch.from_numpy(valid).to(dev)
    cx, cy = tspeckle._connectivity(d, v, 1.0)
    lab = torch.where(v, torch.arange(120 * CW, dtype=torch.int32, device=dev).reshape(120, CW),
                      torch.full((), 120 * CW, dtype=torch.int32, device=dev))
    off, on = (torch.full((), f, dtype=torch.int32, device=dev) for f in (0, 1))
    for rounds in (1, 2, 64):
        want = speckle_kernel.band_labels(lab, cx, cy, rounds)
        before = speckle_kernel.BAND_LABELS.launches
        got_off = speckle_kernel.band_labels(lab, cx, cy, rounds, off)
        got_on = speckle_kernel.band_labels(lab, cx, cy, rounds, on)
        torch.cuda.synchronize()
        assert speckle_kernel.BAND_LABELS.launches - before == 2
        assert torch.equal(got_off, want) and torch.equal(got_on, lab)
        assert torch.equal(want, tspeckle._label_rounds(lab, cx, cy, rounds))


@pytest.mark.cuda
@pytest.mark.parametrize("bm,mode", [
    ({}, "rows"), ({"lr_check": True}, "rows"),
    ({"algorithm": "sgm", "sgm_paths": 4, "num_disparities": 128}, "rows"),
    ({}, "disp"),
], ids=["bm", "bm_lr_check", "sgm", "slab"])
def test_mesh_frame_captured_on_one_card(dev, bm, mode):
    """A 4-band mesh on one card: the eager frame makes no host sync; frame
    0 runs eagerly and captures, frames 1-2 replay; every frame equals the
    eager step bit for bit, one graph."""
    cfg = T.PipelineConfig()
    cfg = cfg.replace(stereobm=cfg.stereobm.replace(**bm))
    pipe = T.StereoPipeline(tcal.euroc_like_model(), cfg,
                            mesh=make_mesh(4, devices=[dev] * 4), shard_mode=mode)
    frames = [T.synthetic_stereo_pair(CH, CW, 48, seed=60 + i)[:2] for i in range(3)]
    outputs = T.Outputs.all()
    imgs = [tuple(torch.from_numpy(x).to(dev) for x in f) for f in frames]
    pipe._eager(*imgs[0], outputs, "mono8")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe._eager(*imgs[0], outputs, "mono8")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for i, (left, right) in enumerate(imgs):
        got = pipe.process(left, right, outputs).outputs
        want = pipe._eager(left, right, outputs, "mono8")
        for k in want:
            assert torch.equal(_bits(got[k]), _bits(want[k])), (i, k)
    (fn,) = pipe._variants.values()
    assert fn.graph_count() == 1


@pytest.mark.cuda
def test_ba_solve_captured_per_window(dev):
    """``StereoSlam._ba_solve`` on the card: the first call per window shape
    captures, the second replays; both equal eager ``bundle_adjust`` bit
    for bit."""
    slam = tslam.StereoSlam(_model(), tslam.SlamConfig(), device=dev)
    for M in (2, 3, 4, 5):
        arrays = _window(M)
        want = _eager_ba(arrays, slam._cam(), slam.config.ba_iters, dev)
        for _ in range(2):
            got = slam._ba_solve(M)(*arrays)
            for g, w in zip(got, want):
                assert torch.equal(_bits(g), _bits(w))
        assert slam._ba_solve(M).graph_count() == 1
    assert len(slam._ba_solves) == 4


@pytest.mark.cuda
def test_sharded_ba_captured_on_one_card(dev, monkeypatch):
    """The landmark-sharded solve on a ``kf`` line of ``["cuda:0"] * 2``:
    the first call per window shape runs eagerly and captures, each later
    call is one graph replay; every result equals eager
    ``bundle_adjust_sharded`` bit for bit."""
    replays = []
    real = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda self: (replays.append(1), real(self))[1])
    slam = tslam.StereoSlam(_model(), tslam.SlamConfig(),
                            mesh=make_mesh(2, ("kf",), devices=[dev] * 2))
    for M in (2, 3, 4, 5):
        arrays = _window(M)
        want = _eager_ba(arrays, slam._cam(), slam.config.ba_iters, dev, kf=slam._ba_mesh)
        before = len(replays)
        for _ in range(3):
            got = slam._ba_solve(M)(*arrays)
            for g, w in zip(got, want):
                assert torch.equal(_bits(g), _bits(w))
        assert len(replays) - before == 2
        assert slam._ba_solve(M).graph_count() == 1
    assert len(slam._ba_solves) == 4 and all(k[2] == 2 for k in slam._ba_solves)
