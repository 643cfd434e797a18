#!/usr/bin/env python3
"""Where a full-size step's time goes, on one NVIDIA GPU.

    python3 profile_glue.py [--root DIR] [--config gyre|ggl90] [--n N]
                            [--kernels]

Runs the 1024x1024x32 (N x N x 32 with --n) float32 gyre or ggl90-gyre
(deltaT = 600 s) of the PyTorch port found under DIR (default: this
script's directory; give an unpacked earlier tree to compare two versions
on one card, in turns):
one warm-up step, 5 timed steps (host clock around synchronised steps),
then chip_smoke.py's profile of 2 steps (torch.profiler): the device's
busy time and idle share, and the time and launches a step of PyTorch's
own kernels and copies (the plain glue: everything that is not a kernel
of kernels/csrc, whose symbols live in namespace mitgcm). Prints, last,
one JSON line of those numbers with the card's name and power limit.
With --kernels, instead: the device ms of one launch of kernels B and C
and of the step glue's D-G launches (the gyre's variants, on
chip_smoke.py's seeded inputs: Case, GlueCase) at each shape of
KERNEL_SHAPES, and of the nh-convection box's mom_correction at
1024x1024x50, 20 launches captured in a CUDA graph and replayed
(chip_smoke.py:graph_ms), so that a small grid's time is the card's and
not the host's enqueue; each with its bound (chip_smoke.py:bound) and the
share of the bound it reaches. Exits nonzero without CUDA.
"""

import argparse
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 5    # timed, as chip_smoke.py's full-size phases time them
# (n, nr, dtype) of --kernels: chip_smoke.py phase 3's small case, small
# and middling grids of 32 levels, and the full size
KERNEL_SHAPES = ((64, 4, "float64"), (64, 32, "float32"),
                 (128, 32, "float32"), (256, 32, "float32"),
                 (1024, 32, "float32"))
BOX_SHAPE = (1024, 50)   # the nh-convection box's, float32


def glue_calls(case):
    """{kernel: one wrapper call} of the step glue's D-G launches on a
    chip_smoke.GlueCase: the gyre's variants (AB-2 after the cold start, a
    3-D fill), or on the box's grid its mom_correction with phi_nh."""
    from mitgcm_tpu_torch.model import step, thermodynamics as th
    from mitgcm_tpu_torch.model.mom_fluxform import MomTend
    from mitgcm_tpu_torch.model.phihyd import calc_phi_hyd
    from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo

    cfg, g, t = case.cfg, case.grid, case.t3
    if cfg.nonHydrostatic:
        return {"mom_correction": lambda: step.momentum_correction_step(
            cfg, g, case.eta, case.u, case.v, case.phi_nh)}
    tend = MomTend(t["gU"], t["gV"], t["guDiss"], t["gvDiss"])
    return {
        "phihyd": lambda: calc_phi_hyd(cfg, g, case.rho),
        "cg2d_rhs": lambda: step.cg2d_rhs(cfg, g, case.u, case.v, case.eta),
        "continuity": lambda: step.integr_continuity(cfg, g, case.u, case.v,
                                                     case.emp),
        "mom_ab_step": lambda: step.mom_ab_step(
            cfg, g, case.state(), tend, t["dPhiHydX"], t["dPhiHydY"],
            t["guExt"], t["gvExt"], 1),
        "mom_correction": lambda: step.momentum_correction_step(
            cfg, g, case.eta, case.u, case.v),
        "tracer_step": lambda: th.tracer_step(
            cfg, g, t["gTr"], case.theta, t["gtNm1"], t["gtNm2"], case.sfc,
            1, True),
        "halo_fill": lambda: cyclic_fill_halo(case.theta, cfg.olx, cfg.olx)}


def time_launches(smoke, calls, label, rows):
    """Append {kernel, shape, ms, bound_ms, share} of each call's launch."""
    from mitgcm_tpu_torch import kernels

    for name, call in calls.items():
        args, out = smoke.captured_launch(call, name)
        ms = smoke.graph_ms(lambda: kernels.launch(*args), reps=10)
        del out
        bound_ms = smoke.bound(name, call)[0]
        rows.append({"kernel": name, "shape": label, "ms": ms,
                     "bound_ms": bound_ms, "share": bound_ms / ms})
        print(f"{name:16s} {label:20s} {ms:.5f} ms a launch, bound "
              f"{bound_ms:.5f} ({bound_ms / ms:.2f})", flush=True)


def kernel_times(smoke):
    """--kernels: [{kernel, shape, ms, bound_ms, share}] of B, C and D-G at
    KERNEL_SHAPES, then the box's mom_correction."""
    import torch
    from mitgcm_tpu_torch.model.gad import calc_rhs
    from mitgcm_tpu_torch.model.mom_fluxform import mom_fluxform

    rows = []
    for n, nr, dtype in KERNEL_SHAPES:
        case = smoke.Case(n, nr, getattr(torch, dtype))
        cfg, g = case.cfg, case.grid
        time_launches(smoke, {
            "mom_fluxform": lambda: mom_fluxform(
                cfg, g, case.u, case.v, case.w, case.kappaRU,
                case.kappaRV),
            "gad_calc_rhs_c2": lambda: calc_rhs(
                cfg, g, case.flow, case.theta, case.kappaR,
                cfg.diffKhT)}, case.label, rows)
        glue = smoke.GlueCase(n, nr, getattr(torch, dtype))
        time_launches(smoke, glue_calls(glue), case.label, rows)
        del case, glue
        smoke.GRIDS.clear()
        torch.cuda.empty_cache()
    box = smoke.GlueCase(*BOX_SHAPE, torch.float32, nh=True)
    time_launches(smoke, glue_calls(box), "box " + box.label, rows)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--config", choices=("gyre", "ggl90"), default="gyre")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--kernels", action="store_true")
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
    if args.kernels:
        print(json.dumps({"root": args.root, "card": smi,
                          "kernels": kernel_times(smoke)}), flush=True)
        return
    kw = dict(nx=args.n, ny=args.n, nr=32, deltaT=600.0)
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
                      "n": args.n, "card": smi, "ms_per_step": wall, **stats}),
          flush=True)


if __name__ == "__main__":
    main()
