"""The control of ``correct``, and the readings its limits were set from.

    python3 -m stereo_bench.control --config <name> --seeds 1,2,3 [--pairs N] [--device cuda]

For each seed, the reference of ``reference.py`` computed in bfloat16 (the
precision below the float32 the configurations state) stands in the
program's place: its outputs, in the form the messages carry them
(float32 disparity and xyz, packed rgb), are compared with the float32
reference by ``check.compare`` over ``N`` pairs of the seed's pool (the
configuration's ``check.sample_pairs`` by default, the first of a pool of
32 as the cells replay), at the configuration's own size.  Prints one JSON
line a seed with each number beside its limit; the control has to fail at
least one.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from stereo_bench import check, inputs, reference, spec

POOL_PAIRS = 32


def published_form(out: Dict) -> Dict[str, tuple]:
    """A reference step's outputs as the node's messages carry them."""
    xyz = out["xyz"].to(torch.float32).cpu().numpy()
    rgb = out["rgb"].to(torch.int32).cpu().numpy().view(np.float32)
    return {"disparity": (out["disparity"].cpu().numpy(),), "pointcloud": (xyz, rgb)}


def control_numbers(config: Dict, seed: int, pairs: int, device, shape=None,
                    dtype=torch.bfloat16) -> Dict[str, float]:
    """The compared numbers of ``dtype``'s reference against float32's over
    ``pairs`` pairs of the seed's pool."""
    H, W = shape or (config["image"]["height"], config["image"]["width"])
    lefts, rights = inputs.pool(config, seed, max(pairs, POOL_PAIRS), shape)
    maps, Q = reference.camera(config["calibration"], W, H)
    maps = torch.as_tensor(maps, device=device)
    totals = {k: 0.0 for k in check.NUMBERS}
    for j in range(pairs):
        ref = reference.step(lefts[j], rights[j], config, maps, Q, torch.float32, device)
        low = reference.step(lefts[j], rights[j], config, maps, Q, dtype, device)
        for k, v in check.compare(published_form(low), ref).items():
            totals[k] = max(totals[k], v) if k == "xyz_max_rel_err" else totals[k] + v
    return totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--pairs", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config = spec.load_json("configs", args.config)
    pairs = args.pairs or int(config["check"]["sample_pairs"])
    limits = config["limits"]
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        nums = control_numbers(config, seed, pairs, torch.device(args.device))
        fails = [k for k in check.NUMBERS if nums[k] > limits[k]]
        failed_all &= bool(fails)
        print(json.dumps({"config": args.config, "seed": seed, "pairs": pairs,
                          "numbers": {k: {"value": nums[k], "limit": limits[k]}
                                      for k in check.NUMBERS},
                          "control_fails": fails}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
