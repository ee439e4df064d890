#!/usr/bin/env python3
"""The card's int32 add and min rates, beside its float32 add rate measured
the same way, for the roofline's integer peak (``utils/roofline.py``).

    python3 scripts/torch_int_peak.py

Run from the root of a checkout on a machine with an H100, ``nvcc`` and
PyTorch built for CUDA.  It builds a small probe library with the port's
nvcc flags (``ops/_build.py``) in a temporary directory under the port's
``build/``: one kernel per operation, each thread running 8 independent
chains of 16 × 8 operations an iteration (inline PTX ``add.s32``,
``min.s32``, ``add.f32``, so nothing is folded away), over enough blocks to
fill every SM many times.  The operations per ms are the chains' operations
over the device time (CUDA events around 5 launches, the best of 3 such
windows, after a warm-up); ``cuobjdump -sass`` of the probe gives the SASS instructions the
loop issues per operation, so a rate is read per instruction too.  The
float32 add rate against half the data sheet's 67 TFLOP/s (which counts a
fused multiply-add as two operations) says how close the method comes to a
published peak.  One JSON line per operation, the SM clock during the run,
then the card's name and power limit.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = 8          # independent chains a thread
ROUNDS = 16         # operations of each chain an iteration, unrolled
OPS = {"int32_add": "add.s32", "int32_min": "min.s32", "fp32_add": "add.f32"}

SRC = r"""
#include <cuda_runtime.h>

template <int KIND>
__global__ void __launch_bounds__(256) chains(int* out, int iters, int seed) {
  unsigned a[8], b[8];
  float f[8], g[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    a[i] = seed * (threadIdx.x + 3 * i + 1);
    b[i] = seed ^ (blockIdx.x + 7 * i);
    f[i] = 1.0f + a[i];
    g[i] = 1e-30f * b[i];
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < 16; ++u) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (KIND == 0) asm volatile("add.s32 %0, %0, %1;" : "+r"(a[i]) : "r"(b[(i + u) & 7]));
        if constexpr (KIND == 1) asm volatile("min.s32 %0, %0, %1;" : "+r"(a[i]) : "r"(b[(i + u) & 7]));
        if constexpr (KIND == 2) asm volatile("add.f32 %0, %0, %1;" : "+f"(f[i]) : "f"(g[(i + u) & 7]));
      }
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) s ^= a[i] ^ __float_as_uint(f[i]);
  if (s == 0x12345678u) out[0] = static_cast<int>(s);   // keeps the chains live
}

extern "C" int probe(int kind, int* out, int blocks, int iters, int seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) chains<0><<<blocks, 256, 0, s>>>(out, iters, seed);
  else if (kind == 1) chains<1><<<blocks, 256, 0, s>>>(out, iters, seed);
  else if (kind == 2) chains<2><<<blocks, 256, 0, s>>>(out, iters, seed);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
"""


def build(work: str, _build) -> str:
    """Compile the probe with the port's nvcc flags into ``work``."""
    src = os.path.join(work, "int_peak.cu")
    lib = os.path.join(work, "libint_peak.so")
    with open(src, "w") as f:
        f.write(SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src], check=True,
                   capture_output=True, text=True, timeout=300)
    return lib


def sass_per_op(lib: str, nvcc: str) -> dict:
    """{kind: (SASS instructions of the operation's kind in the kernel / the
    operations the loop body writes, {opcode: count} of the kernel's five
    most frequent opcodes)}, from ``cuobjdump -sass``: ptxas may pack two
    dependent operations into one three-input instruction (IADD3)."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        cuobjdump = shutil.which("cuobjdump")
    if not cuobjdump:
        return {}
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    out = {}
    opcodes = {0: r"IADD\w*", 1: r"V?IMNMX\w*", 2: r"FADD\w*"}
    for kind, body in re.findall(r"Function : \S*chainsILi(\d)\S*\n(.*?)(?=Function :|\Z)",
                                 text, re.S):
        ops = collections.Counter(m.group(1) for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body))
        n = sum(c for op, c in ops.items() if re.fullmatch(opcodes[int(kind)], op))
        out[int(kind)] = (n / (CHAINS * ROUNDS), dict(ops.most_common(5)))
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_int_peak: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ros_gpu_stereo_processor_tpu_torch.ops import _build
    from ros_gpu_stereo_processor_tpu_torch.utils import roofline
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        lib_path = build(work, _build)
        per_op = sass_per_op(lib_path, _build._nvcc())
        lib = ctypes.CDLL(lib_path)
        lib.probe.argtypes = [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.probe.restype = ctypes.c_int
        out = torch.zeros(1, dtype=torch.int32, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        blocks, iters, reps = sms * 8 * 4, 2048, 5

        def launch(kind):
            err = lib.probe(kind, out.data_ptr(), blocks, iters, 7,
                            torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe {kind}: CUDA error {err}")

        for kind, (name, ptx) in enumerate(OPS.items()):
            launch(kind)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(reps):
                    launch(kind)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / reps)
            ms = min(times)
            ops = blocks * 256 * iters * CHAINS * ROUNDS
            line = {"op": name, "ptx": ptx, "ops_per_launch": ops, "ms": ms,
                    "ms_runs": times, "ops_per_ms": ops / ms}
            if kind in per_op:
                line["sass_per_op"], line["sass_opcodes"] = per_op[kind]
                line["sass_per_ms"] = ops * per_op[kind][0] / ms
            if name == "fp32_add":
                half = roofline.H100_SXM["fp32_ops_per_ms"] / 2
                line["share_of_data_sheet_fp32_add"] = ops / ms / half
            print(json.dumps(line), flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    print(f"sm clock, max (after the runs): {clocks}")
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
