"""Native host runtime: the C++ frame-ingest ring and timestamp pairing (with
a pure-Python stand-in where no compiler is available), and the serve
daemon (``runtime.serve``)."""

from ros_gpu_stereo_processor_tpu_torch.runtime.ingest import (
    FrameRing,
    StereoPairer,
    StreamingIngest,
    native_available,
)

__all__ = ["FrameRing", "StereoPairer", "StreamingIngest", "native_available"]
