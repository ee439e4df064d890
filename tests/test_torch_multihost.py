"""Multi-axis meshes and the multi-process layer of the port
(``parallel/mesh.py``, ``parallel/multihost.py``): the 2-D mesh, the
frontend on the ``rows`` line of a (kf, rows) mesh and the BA on its ``kf``
line against the JAX package on the conftest's virtual CPU mesh, the
host-local feed in one process, and one real 2-process gloo run of the
worker at 64×96 on the CPU (2 bands per process) against the same checks
on a 4-entry CPU mesh in this process.

Tolerances: the frontend exact; the BA JAX's sharded bars (t atol 1e-3);
the workers' ``DENSE`` and ``PIPE`` digests (sum, count and a hash of the
whole disparity and validity) equal across ranks and to one process; the
``BA`` rms equal across ranks (every rank solves the system the same
``all_reduce`` gave it) and within rtol 1e-3 of one process (another order
of the sums).  A 4-process run of a (kf, rows) 2 × 2 process mesh, whose
lines are process groups of two ranks, is held to the same bars."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ros_gpu_stereo_processor_tpu as J
from ros_gpu_stereo_processor_tpu.parallel import frontend as jpar
from ros_gpu_stereo_processor_tpu.parallel.dist_ba import bundle_adjust_sharded as jax_ba
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as tpar
from ros_gpu_stereo_processor_tpu_torch.parallel import multihost
from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import bundle_adjust_sharded
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
from tests.test_ba import _anchor, make_problem
from tests.test_torch_dist_ba import to_port

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT_S = 240


def mesh_2d(shape=(2, 4)):
    return make_mesh(8, ("kf", "rows"), shape=shape, devices=["cpu"] * 8)


def test_2d_mesh_construction():
    mesh = mesh_2d()
    assert mesh.shape == {"kf": 2, "rows": 4} and mesh.size == 8
    assert mesh.along("rows").axis_names == ("rows",) and mesh.along("rows").size == 4
    assert mesh.along("kf").size == 2 and mesh.along("kf").along("kf") is mesh.along("kf")
    grid = make_mesh(6, ("kf", "rows"), shape=(2, 3),
                     devices=[f"cpu:{i}" for i in range(6)]).grid
    assert [str(d) for d in grid[:, 0]] == ["cpu:0", "cpu:3"]
    flat = make_mesh(2, ("kf", "rows"), devices=["cpu"] * 2)      # no shape: the first axis
    assert flat.shape == {"kf": 2, "rows": 1}
    with pytest.raises(ValueError, match="shape"):
        make_mesh(8, ("kf", "rows"), shape=(3, 3), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="axis"):
        mesh.along("disp")
    # the collectives on a line, in one process
    line = make_mesh(3, devices=["cpu"] * 3)
    parts = [torch.tensor([1.0, 5.0]), torch.tensor([4.0, 2.0]), torch.tensor([3.0, 9.0])]
    assert [p.tolist() for p in line.psum(parts)] == [[8.0, 16.0]] * 3
    assert [p.tolist() for p in line.pmin(parts)] == [[1.0, 2.0]] * 3
    assert [p.tolist() for p in line.shift_down(parts)] == [[0, 0], [1, 5], [4, 2]]
    assert [p.tolist() for p in line.shift_up(parts)] == [[4, 2], [3, 9], [0, 0]]
    assert line.all_gather(parts).shape == (3, 2)
    assert line.any([torch.tensor(False), torch.tensor(True), torch.tensor(False)])


def test_frontend_on_rows_line_of_2d_mesh():
    """The row-band matcher and the speckle filter on the ``rows`` axis of a
    (kf, rows) mesh, as JAX runs them on its 2-D mesh."""
    left, right, _ = T.synthetic_stereo_pair(64, 256, 24, seed=0)
    jcfg = J.StereoBMConfig(num_disparities=32, block_size=9, texture_threshold=10)
    jm = jax_mesh(8, ("kf", "rows"), shape=(2, 4))
    jd, jv = jpar.disparity_row_sharded(jnp.asarray(left), jnp.asarray(right), jcfg, jm,
                                        axis="rows")
    jd, jv = jpar.filter_speckles_row_sharded(jd, jv, jm, axis="rows", max_speckle_size=30,
                                              max_diff=2.0)
    mesh = mesh_2d()
    d, v = tpar.disparity_row_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                      T.from_jax_config(jcfg), mesh, axis="rows")
    assert len(d) == 4
    d, v = tpar.filter_speckles_row_sharded(d, v, mesh, axis="rows", max_speckle_size=30,
                                            max_diff=2.0)
    np.testing.assert_array_equal(torch.cat(v).numpy(), np.asarray(jv))
    np.testing.assert_array_equal(torch.cat(d).numpy(), np.asarray(jd))


def test_ba_on_kf_line_of_2d_mesh():
    jp, _ = make_problem(M=4, N=64, point_noise=0.0)
    prior = _anchor(jp)
    jf, _ = jax_ba(jp, jax_mesh(8, ("kf", "rows"), shape=(4, 2)), axis="kf", iters=10,
                   point_prior=prior)
    pf, hist = bundle_adjust_sharded(to_port(jp), mesh_2d((4, 2)), axis="kf", iters=10,
                                     point_prior=torch.from_numpy(np.array(prior, np.float32)))
    np.testing.assert_allclose(pf.t.numpy(), np.asarray(jf.t), rtol=0, atol=1e-3)
    assert hist[-1] < 1e-2


def test_host_local_rows_single_process():
    mesh = make_mesh(8, devices=["cpu"] * 8)
    lo, hi = multihost.host_local_rows(mesh, "rows", 64)
    assert (lo, hi) == (0, 64)          # one process owns every band
    x = np.arange(64 * 8, dtype=np.float32).reshape(64, 8)
    bands = multihost.put_row_sharded(x[lo:hi], mesh, "rows", 64)
    assert [tuple(b.shape) for b in bands] == [(8, 8)] * 8
    np.testing.assert_array_equal(mesh.gather(bands).numpy(), x)
    x[0, 0] = -1.0                      # the bands are a copy of the staging rows
    assert float(bands[0][0, 0]) == 0.0
    with pytest.raises(ValueError):
        multihost.host_local_rows(mesh, "rows", 60)
    with pytest.raises(ValueError, match="local rows"):
        multihost.put_row_sharded(x[:32], mesh, "rows", 64)


def _run_processes(cmds, env):
    """Start every command, wait for all (each within WORKER_TIMEOUT_S) and
    return their outputs; on any failure or timeout kill every one left."""
    procs = [subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _env():
    return dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _lines(out: str, tag: str):
    return [ln for ln in out.splitlines() if ln.startswith(tag + " ")]


def test_two_process_gloo_worker():
    """Two worker processes, 2 bands each, over gloo on the CPU: the
    sharded dense step, the whole pipeline and the distributed BA agree
    across ranks and with one process holding all 4 entries."""
    cmd = [sys.executable, "-m", "ros_gpu_stereo_processor_tpu_torch.parallel.multihost",
           "--init-method", f"tcp://127.0.0.1:{_free_port()}", "--world-size", "2",
           "--backend", "gloo", "--bands-per-process", "2", "--device", "cpu",
           "--timeout", "60", "--fps-iters", "2"]
    outs = _run_processes([cmd + ["--rank", str(r)] for r in range(2)], _env())
    ref = list(multihost.worker_lines(make_mesh(4, devices=["cpu"] * 4),
                                      make_mesh(4, ("kf",), devices=["cpu"] * 4),
                                      fps_iters=1))
    for tag in ("BACKEND", "DENSE", "PIPE", "BA"):
        got = [_lines(o, tag) for o in outs]
        assert all(len(g) == 1 for g in got), (tag, outs)
        assert got[0] == got[1], (tag, got)
    assert _lines(outs[0], "BACKEND")[0] == "BACKEND gloo cpu"
    for tag in ("DENSE", "PIPE"):
        assert _lines(outs[0], tag) == _lines("\n".join(ref), tag)
    assert int(_lines(outs[0], "DENSE")[0].split()[2]) > 0
    ba = [float(x) for x in _lines(outs[0], "BA")[0].split()[1:]]
    ba_ref = [float(x) for x in _lines("\n".join(ref), "BA")[0].split()[1:]]
    np.testing.assert_allclose(ba, ba_ref, rtol=1e-3)
    assert ba[1] < 0.1 * ba[0]
    assert float(_lines(outs[0], "FPS")[0].split()[1]) > 0



GRID_SCRIPT = """
import sys
import numpy as np, torch
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend, multihost as mh
from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import (
    bundle_adjust_sharded, synthetic_problem)


def report(mesh, tag):
    left, right, _ = T.synthetic_stereo_pair(64, 96, 16, seed=0)
    cfg = T.StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5)
    d, v = frontend.disparity_row_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                          cfg, mesh, "rows")
    d, v = frontend.filter_speckles_row_sharded(d, v, mesh, "rows", max_speckle_size=30,
                                                max_diff=2.0)
    rows = mesh.along("rows")
    print(tag, "ROWS", mh.digest(rows.gather(d), rows.gather(v)), flush=True)
    prob = synthetic_problem(np.random.default_rng(1), 3, 16, "cpu")
    _, hist = bundle_adjust_sharded(prob, mesh, "kf", iters=3)
    print(tag, "BA", f"{float(hist[0]):.6e}", f"{float(hist[-1]):.6e}", flush=True)


mh.initialize(sys.argv[2], 4, int(sys.argv[1]), "gloo", "cpu", 60)
mesh = mh.global_mesh(("kf", "rows"), shape=(2, 2), local_devices=["cpu"])
print("LINES", mesh.along("rows").ranks, mesh.along("kf").ranks, flush=True)
report(mesh, "MESH")
mh.shutdown()
report(T.make_mesh(4, ("kf", "rows"), shape=(2, 2), devices=["cpu"] * 4), "ONE")
"""


def test_four_process_2d_mesh():
    """Four processes, one CPU entry each, on a (kf, rows) 2 × 2 process
    mesh: every ``rows`` line and every ``kf`` line spans two of the ranks
    (a process group of its own).  The row-band matcher and speckle filter
    on the ``rows`` lines and the sharded BA on the ``kf`` lines agree
    across the ranks and with the one-process 2 × 2 mesh (each process
    prints both)."""
    init = f"tcp://127.0.0.1:{_free_port()}"
    outs = _run_processes([[sys.executable, "-c", GRID_SCRIPT, str(r), init]
                           for r in range(4)], _env())
    assert [_lines(o, "LINES") for o in outs] == [
        ["LINES [0, 1] [0, 2]"], ["LINES [0, 1] [1, 3]"],
        ["LINES [2, 3] [0, 2]"], ["LINES [2, 3] [1, 3]"]]
    for tag in ("MESH ROWS", "MESH BA", "ONE ROWS", "ONE BA"):
        got = [_lines(o, tag) for o in outs]
        assert len(got[0]) == 1 and all(g == got[0] for g in got), (tag, got)
    assert _lines(outs[0], "MESH ROWS")[0].split()[2:] == _lines(outs[0], "ONE ROWS")[0].split()[2:]
    ba, ba_one = ([float(x) for x in _lines(outs[0], tag)[0].split()[2:]]
                  for tag in ("MESH BA", "ONE BA"))
    np.testing.assert_allclose(ba, ba_one, rtol=1e-3)
    assert ba[1] < 0.1 * ba[0]
