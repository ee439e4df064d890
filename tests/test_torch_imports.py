"""The PyTorch port stands alone: no module of it imports jax or the JAX
package, and ``yaml`` is imported only inside a function.  An AST scan (a
``sys.modules`` check cannot tell who imported jax when a test process holds
both frameworks), plus one import in a fresh interpreter where jax, the JAX
package and yaml cannot be imported at all."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "ros_gpu_stereo_processor_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "ros_gpu_stereo_processor_tpu")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                       ROOT / "scripts" / "torch_remap_blocks.py",
                                       ROOT / "scripts" / "torch_speckle_rounds.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node, node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(n.lineno, name) for n, name in _imports(tree) if _forbidden(name)]
    assert not bad, f"{path}: imports {bad}"


def test_yaml_only_inside_functions():
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] if isinstance(node, ast.Import) \
                    else [node.module or ""]
                assert "yaml" not in names, f"{path}:{node.lineno} imports yaml at top level"


def test_port_imports_without_jax_or_yaml():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top in ('jax', 'jaxlib', 'yaml', 'ros_gpu_stereo_processor_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "for k in [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'yaml')]:\n"
        "    del sys.modules[k]\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ros_gpu_stereo_processor_tpu_torch as p\n"
        "from ros_gpu_stereo_processor_tpu_torch.ops import (\n"
        "    remap_kernel, sgm, sgm_kernel, speckle_kernel, stereobm_kernel)\n"
        "from ros_gpu_stereo_processor_tpu_torch.parallel import frontend, mesh\n"
        "from ros_gpu_stereo_processor_tpu_torch.ops import features\n"
        "from ros_gpu_stereo_processor_tpu_torch.models import ba, posegraph, slam, vo\n"
        "from ros_gpu_stereo_processor_tpu_torch.utils import division, evaluate, io, lie, synth\n"
        "from ros_gpu_stereo_processor_tpu_torch.utils import debug\n"
        "from ros_gpu_stereo_processor_tpu_torch.ops import bilateral, color\n"
        "from ros_gpu_stereo_processor_tpu_torch.runtime import ingest, serve\n"
        "from ros_gpu_stereo_processor_tpu_torch import cli\n"
        "print(p.StereoPipeline.__name__, p.StereoSlam.__name__, p.StereoVisualOdometry.__name__)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "StereoPipeline StereoSlam StereoVisualOdometry"
