"""PyTorch + CUDA port of the stereo vision engine, for NVIDIA Hopper.

The dense stereo frame pipeline of ``ros_gpu_stereo_processor_tpu`` (the JAX
package, which stays the reference) on torch tensors: encoding conversion
(Bayer debayer included), bilinear rectification, X-Sobel prefilter and SAD
block matching or semi-global matching (SGM), the left-right check, the
speckle filter, the optional bilateral post-filter, ``disparity_vis`` and
the organised point cloud, on one device or by row bands over a band mesh
(``parallel/``); the SLAM engine on top of it (``models/slam.py``: features,
visual odometry, keyframes, windowed bundle adjustment, loop closure and the
pose graph); and the serving shape: the native ingest ring and its device
double buffer (``runtime/ingest.py``), the watch-dir serve daemon
(``runtime/serve.py``) and the ``tpu-stereo-torch`` command line
(``cli.py``).  Seven kernels run as hand-written
CUDA on a CUDA device (``csrc/``, built with nvcc at first use) and as
their plain PyTorch versions on the CPU.  A pipeline runs on the card
(and so do ``StereoSlam`` and ``StereoVisualOdometry``) unless the caller
asks for ``device="cpu"`` (and so do ``StreamingIngest``, ``ServeDaemon``
and the command line, ``--device cpu``).

This package imports torch and numpy only; never jax and never the JAX
package.
"""

from ros_gpu_stereo_processor_tpu_torch.config import (
    BilateralConfig,
    Outputs,
    PipelineConfig,
    SpeckleConfig,
    StereoBMConfig,
    from_jax_config,
)
from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
from ros_gpu_stereo_processor_tpu_torch.models.slam import SlamConfig, StereoSlam
from ros_gpu_stereo_processor_tpu_torch.models.vo import StereoVisualOdometry
from ros_gpu_stereo_processor_tpu_torch.utils.calib import (
    CameraCalib,
    StereoCameraModel,
)
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

__version__ = "0.1.0"

__all__ = [
    "BilateralConfig",
    "CameraCalib",
    "Outputs",
    "PipelineConfig",
    "SlamConfig",
    "SpeckleConfig",
    "StereoBMConfig",
    "StereoCameraModel",
    "StereoPipeline",
    "StereoSlam",
    "StereoVisualOdometry",
    "from_jax_config",
    "synthetic_stereo_pair",
]
