#!/usr/bin/env python3
"""Interleaved A/B timing of the port's pipeline and its stages on a CUDA
card: the counterpart of ``scripts/abbench.py``.

    python3 scripts/torch_abbench.py [--batch 8] [--root DIR]

Run from the root of a checkout on a machine with an H100, ``nvcc`` and
PyTorch built for CUDA.  Each candidate is a function of one frame pair;
``utils/graphs.py::ab`` makes each a batch of ``--batch`` frames captured
as one CUDA graph (``batch_runner``: the frames' checksums), calls each
twice, then takes the minimum over 6 rounds of 3 calls, the candidates
round-robin, so that a slow phase of the host or the card hits every
candidate alike; it prints ms a frame and frames/s.  The candidates are
``scripts/abbench.py``'s at 752×480 (the bench's EuRoC-like calibration and
synthetic pair, repeated B times; the reference's BM defaults: 64
disparities, block 15, texture 10; speckle 800 px, Δ5, 16 rounds):

  * the pipeline (``disparity`` and ``pointcloud``) and the speckle filter
    on the kernel route (K1, K2, K3), the same with the filter's labels on
    the plain route (``ops/speckle.py::_labels_scan``: JAX's ``"scan"``
    method), and without the filter;
  * on the rectified float32 pair: rectification alone (K1 ×2, one launch a
    side), K2 fused (prefilter, match, gates) and the X-Sobel prefilter ×2.

``--root DIR`` adds the candidates of another checkout (e.g. the parent
unpacked with ``git archive``), named ``<DIR's name>/<candidate>``, to the
same round-robin, on the same frames: each checkout's package is imported
apart from the other's (its modules swapped into ``sys.modules`` while its
code runs) and builds its own kernels.  Prints the card's name and power
limit first, then each group's table and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "ros_gpu_stereo_processor_tpu_torch"


def _ours(name: str) -> bool:
    return name == PACKAGE or name.startswith(PACKAGE + ".")


def load_tree(root: str) -> dict:
    """Every module of the package in the checkout ``root``, imported apart
    from whatever copy ``sys.modules`` holds (which is left as it was):
    {module name: module}."""
    saved = {k: v for k, v in sys.modules.items() if _ours(k)}
    for k in saved:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        pkg = importlib.import_module(PACKAGE)
        if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root) + os.sep):
            raise AssertionError(f"imported {pkg.__file__}, not the package under {root}")
        for info in pkgutil.walk_packages(pkg.__path__, PACKAGE + "."):
            importlib.import_module(info.name)
        return {k: v for k, v in sys.modules.items() if _ours(k)}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


@contextlib.contextmanager
def tree(modules: dict):
    """``modules`` (from :func:`load_tree`) in ``sys.modules`` while the
    block runs, so that the imports inside its functions find their own
    checkout."""
    saved = {k: v for k, v in sys.modules.items() if _ours(k)}
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k in [k for k in sys.modules if _ours(k)]:
            del sys.modules[k]
        sys.modules.update(saved)


def in_tree(modules: dict, fn):
    """``fn`` run with ``modules`` in ``sys.modules`` (a graph's replays
    run none of it: this holds for the eager run and the capture)."""
    def call(*args):
        with tree(modules):
            return fn(*args)
    return call


def candidates(mod, model, dev):
    """JAX's candidates over one checkout's package: ``mod(name)`` gives its
    module ``ros_gpu_stereo_processor_tpu_torch.<name>``.  Returns
    ({name: fn(left, right)} on raw frames, {name: fn} on rectified
    float32 frames)."""
    import torch

    config, pipeline = mod("config"), mod("models.pipeline")
    speckle, remap_kernel = mod("ops.speckle"), mod("ops.remap_kernel")
    stereobm, stereobm_kernel = mod("ops.stereobm"), mod("ops.stereobm_kernel")
    maps, Q = mod("bench")._model_tensors(model, dev)
    bm = config.StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10)
    sp0 = config.SpeckleConfig(max_speckle_size=0, max_diff=5.0, propagation_iters=16)
    outputs = config.Outputs.of("disparity", "pointcloud")

    def plain_filter(d, v):
        lab = speckle._labels_scan(d, v, 5.0, 16)
        keep = speckle._keep_large_components(lab, 800) & v
        return torch.where(keep, d, torch.full((), -1.0, device=d.device)), keep

    def base(left, right, route=None):
        out = pipeline._pipeline_step(left, right, maps, Q, encoding="mono8", outputs=outputs,
                                      bm=bm, speckle=sp0)
        if route is not None:
            d, v = out["disparity"], out["disparity_valid"]
            out["disparity"], out["disparity_valid"] = (
                speckle.filter_speckles(d, v, 800, 5.0, 16) if route == "kernel"
                else plain_filter(d, v))
        return out

    frames = {
        "pipeline+speckle:kernel": lambda left, right: base(left, right, "kernel"),
        "pipeline+speckle:plain": lambda left, right: base(left, right, "plain"),
        "pipeline (no speckle)": lambda left, right: base(left, right),
    }
    stages = {
        "rectify K1 x2": lambda left, right: (remap_kernel.rectify(left[None], maps[:1]),
                                              remap_kernel.rectify(right[None], maps[1:])),
        "stereobm fused K2": lambda left, right: stereobm_kernel.compute_disparity_fused(
            left, right, bm),
        "prefilter x2": lambda left, right: (stereobm.prefilter(left, bm),
                                             stereobm.prefilter(right, bm)),
    }
    return frames, stages


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8, help="frames a batch (JAX's AB_BATCH)")
    ap.add_argument("--root", help="another checkout whose candidates join the round-robin")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_abbench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    roots = {"tree": ROOT}
    if args.root:
        roots[os.path.basename(os.path.abspath(args.root).rstrip("/"))] = os.path.abspath(
            args.root)
    trees = {label: load_tree(root) for label, root in roots.items()}
    ours = trees["tree"]

    def mod_of(label):
        return lambda name: trees[label][f"{PACKAGE}.{name}"]

    print(f"card: {ours[PACKAGE + '.utils.device'].card_line()}", flush=True)
    with tree(ours):
        model, left, right = ours[PACKAGE + ".bench"]._model_and_frame()
    B = args.batch
    lefts = torch.from_numpy(np.stack([left] * B)).to(dev)
    rights = torch.from_numpy(np.stack([right] * B)).to(dev)
    groups = {"full pipeline variants": ({}, lefts, rights), "stages (isolated)": ({}, None, None)}
    for label, mods in trees.items():
        with tree(mods):
            mods[PACKAGE + ".ops._build"].build()
            frames, stages = candidates(mod_of(label), model, dev)
            if groups["stages (isolated)"][1] is None:
                maps, _ = mods[PACKAGE + ".bench"]._model_tensors(model, dev)
                rect = mods[PACKAGE + ".ops.remap_kernel"].rectify(
                    torch.stack([lefts[0], rights[0]]).float(), maps)
                groups["stages (isolated)"] = ({}, torch.stack([rect[0]] * B),
                                               torch.stack([rect[1]] * B))
        prefix = "" if len(trees) == 1 else f"{label}/"
        for group, cands in (("full pipeline variants", frames), ("stages (isolated)", stages)):
            groups[group][0].update({prefix + k: in_tree(mods, fn) for k, fn in cands.items()})
    ab = ours[PACKAGE + ".utils.graphs"].ab
    record = {"batch": B, "roots": {k: v for k, v in roots.items()}}
    for group, (cands, ls, rs) in groups.items():
        print(f"== {group} ==", flush=True)
        record[group] = ab(cands, ls, rs)
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
