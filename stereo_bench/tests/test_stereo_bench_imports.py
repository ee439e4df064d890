"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "ros_gpu_stereo_processor_tpu"}


def _top_level_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_no_module_the_benchmark_imports_is_jax_or_the_jax_package():
    mods = _top_level_after(
        "import stereo_bench.run, stereo_bench.control, stereo_bench.check, stereo_bench.loop, "
        "stereo_bench.trace\nfrom stereo_bench import spec\n"
        "[spec.reader(m['name']) for m in spec.benchmark()['per_layer']]\n"
        "import ros_gpu_stereo_processor_tpu_torch.runtime, "
        "ros_gpu_stereo_processor_tpu_torch.models.pipeline")
    assert "ros_gpu_stereo_processor_tpu_torch" in mods     # the port's name is whole
    assert not mods & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    mods = _top_level_after("import stereo_bench.reference, stereo_bench.control")
    assert "ros_gpu_stereo_processor_tpu_torch" not in mods and not mods & FORBIDDEN
