"""Multi-device parallelism of the port: meshes (parallel/mesh.py), the
sharded frontend by row band and by disparity slab (parallel/frontend.py),
the landmark-sharded BA (parallel/dist_ba.py), process-spanning meshes on
``torch.distributed`` (parallel/multihost.py) and the scaling harness and
dry run (parallel/scaling.py).

The names below are imported on first use, so that
``python -m ros_gpu_stereo_processor_tpu_torch.parallel.multihost`` runs the
worker module once."""

from importlib import import_module

_EXPORTS = {
    "Mesh": "mesh", "make_mesh": "mesh",
    "disparity_row_sharded": "frontend", "disparity_sgm_row_sharded": "frontend",
    "disparity_slab_sharded": "frontend", "filter_speckles_row_sharded": "frontend",
    "bilateral_row_sharded": "frontend", "remap_row_sharded": "frontend",
    "bundle_adjust_sharded": "dist_ba",
    "ProcessMesh": "multihost", "initialize": "multihost", "shutdown": "multihost",
    "global_mesh": "multihost", "host_local_rows": "multihost",
    "put_row_sharded": "multihost",
    "measure_scaling": "scaling", "dryrun_multichip": "scaling",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    return getattr(import_module(f"{__name__}.{_EXPORTS[name]}"), name)
