#!/usr/bin/env python3
"""Where a full-size step's time goes, on one NVIDIA GPU.

    python3 profile_glue.py [--root DIR] [--config gyre|ggl90]

Runs the 1024x1024x32 float32 gyre or ggl90-gyre (deltaT = 600 s) of the
PyTorch port found under DIR (default: this script's directory; give an
unpacked earlier tree to compare two versions on one card, in turns):
one warm-up step, 5 timed steps (host clock around synchronised steps),
then chip_smoke.py's profile of 2 steps (torch.profiler): the device's
busy time and idle share, and the time and launches a step of PyTorch's
own kernels and copies (the plain glue: everything that is not a kernel
of kernels/csrc, whose symbols live in namespace mitgcm). Prints, last,
one JSON line of those numbers with the card's name and power limit.
Exits nonzero without CUDA.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 5    # timed, as chip_smoke.py's full-size phases time them


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--config", choices=("gyre", "ggl90"), default="gyre")
    args = ap.parse_args()
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smi = smoke.device_phase()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    kernels.library()
    kw = dict(nx=1024, ny=1024, nr=32, deltaT=600.0)
    if args.config == "gyre":
        cfg = synthetic.gyre_config(**kw)
        exp = Experiment(cfg, *synthetic.gyre_setup(
            cfg, dtype=torch.float32, device="cuda"))
    else:
        cfg = synthetic.ggl90_gyre_config(**kw)
        grid, state, forcing, op, ggl90 = synthetic.ggl90_gyre_setup(
            cfg, dtype=torch.float32, device="cuda")
        exp = Experiment(cfg, grid, state, forcing, op, ggl90=ggl90)
    exp.run(n_steps=1, collect_monitor=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    exp.run(n_steps=STEPS, collect_monitor=False)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / STEPS
    stats = smoke.profile_steps(exp, exp.state, exp.cur_iter, 2, wall)
    print(json.dumps({"root": args.root, "config": args.config,
                      "card": smi, "ms_per_step": wall, **stats}),
          flush=True)


if __name__ == "__main__":
    main()
