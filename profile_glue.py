#!/usr/bin/env python3
"""Where a full-size step's time goes, on one NVIDIA GPU.

    python3 profile_glue.py [--root DIR] [--config CONFIG] [--n N]
                            [--glue-sources] [--kernels [GROUP ...]]
                            [--ptxas]

Runs the 1024x1024x32 (N x N x 32 with --n) float32 gyre, vi-gyre,
kpp-gyre, ggl90-gyre, os7mp-gyre, pqm-gyre, som-gyre, idemix-gyre,
gm-gyre, gm-bolus-gyre, ice-gyre, evp-ice-gyre, visc-gyre, visc-vi-gyre,
st-vi-gyre (--config visc, visc-vi, st-vi), pp81-, my82- or opps-gyre
(--config pp81, my82, opps; deltaT = 600 s), or the
N x N x 50 nh-convection box (--config box, deltaT = 60 s), of the
PyTorch port found under DIR (default: this script's directory; give an
unpacked earlier tree to compare two versions on one card, in turns):
one warm-up step, 5 timed steps (host clock around synchronised steps),
then chip_smoke.py's profile of 2 steps (torch.profiler): the device's
busy time and idle share, the device ms and calls a step of each of the
port's kernels, and the time and launches a step of PyTorch's own kernels
and copies (the plain glue: everything that is not a kernel of
kernels/csrc, whose symbols live in namespace mitgcm). With
--glue-sources, a second profile of 2 steps splits the plain glue by
where it comes from: every function of the port is wrapped in a
torch.profiler.record_function of its name (annotate_port), and each of
PyTorch's own kernels and copies goes to the two innermost functions of
the port above the op that launched it (autograd's backward, which runs
outside them, to a group of its own), with its device ms and launches a
step (the wrappers' host cost falls outside the device times). Prints, last, one JSON line of
those numbers with the card's name and power limit.
With --kernels, instead: the device ms of one launch of kernels B and C
and of the step glue's D-G launches (the gyre's variants, on
chip_smoke.py's seeded inputs: Case, GlueCase) at each shape of
KERNEL_SHAPES, and of the nh-convection box's mom_correction at
1024x1024x50, 20 launches captured in a CUDA graph and replayed
(chip_smoke.py:graph_ms), so that a small grid's time is the card's and
not the host's enqueue; each with its bound (chip_smoke.py:bound) and the
share of the bound it reaches (group "glue"). Group "cg3d": on
chip_smoke.py's seeded 1024x1024x50 float32 box (NhCase), whole
`cg3d.cg3d` solves with a tolerance of 0, so that each runs to its cap:
ms an iteration as (a solve of 100 iterations - a solve of 20) / 80,
CUDA events around the whole solves, with the bound of an iteration (the
sum of its launches' bounds); then each launch of an iteration as a
CUDA graph of 20, with its bound. Group "evp": seaice_evp_stress and
seaice_evp_uv (adaptive EVP, the first launch of a 2-subcycle loop) at
1024x1024 float32 on chip_smoke.py's EvpCase, as a CUDA graph of 20
launches, each with its bound. Group "os7mp": each sweep of kernel O
(scheme 7) and, on the same inputs, of M (scheme 33) and P (41 and 51),
each on the previous sweep's output, on chip_smoke.py's seeded
1024x1024x32 float32 os7mp-gyre (G9Case), as CUDA graphs of 20, with
their bounds. Group "som": H-SOM's three passes of schemes 81 and 80 on
chip_smoke.py's 1024x1024x32 float32 IsmCase, the same way. Group "ppm":
each sweep of kernel P for each of its six schemes (40-42, 50-52) on
chip_smoke.py's seeded 1024x1024x32 float32 pqm-gyre (G9Case), as CUDA
graphs of 20, with the bounds of its footprints. Group "vecinv": one
launch of kernel V on chip_smoke.py's seeded vi-gyre (Case) at
1024x1024x32 and 64x64x32 float32, for each of chip_smoke.py's
VI_VARIANTS (the vi-gyre's first), as CUDA graphs of 20, with their
bounds (chip_smoke.py:vecinv_footprint). Group "multidim": M's three
sweeps for each pair of MD_SCHEMES on chip_smoke.py's seeded
1024x1024x32 float32 ggl90-gyre (G9Case), each on the previous sweep's
output, the same way. The sweep groups print a sha256 digest of each
sweep's output, "vecinv" of each launch's four outputs, so that two
trees' bits can be compared. Group "adjoint": one
launch of B' (mom_fluxform_adj) and of C' (gad_calc_rhs_c2_adj) on
chip_smoke.py's seeded 1024x1024x32 float32 gyre (Case) with phase 6's
seeded cotangents, as CUDA graphs of 20, with their bounds, and a sha256
digest of each launch's output bytes, so that two trees' bits can be
compared. Group "calc_gw": one launch of kernel W in each variant (with
and without the 3-D Coriolis term) on chip_smoke.py's seeded
1024x1024x50 float32 box (NhCase), as CUDA graphs of 20, with their
bounds (chip_smoke.py:gw_footprint) and a digest of the two outputs.
Group "ggl90": one launch of G9's ggl90_col at 1024x1024x32 and
64x64x32 float32, the ggl90-gyre's variant on chip_smoke.py's G9Case and
the idemix-gyre's (IDEMIX's source and Langmuir) on its IsmCase, the
same way (chip_smoke.py:ggl90_col_footprint), with a digest of tke',
diffKr and visctmp. Group "last": chip_smoke.py phase 18's holds of N1,
N2, Q, S1, S2 and the `+ gTr` addend at full size float32, each with its
device ms, bound, wrapper call's and twin's ms. No group named: all
twelve. --config adjoint instead
times the gradient of phase 6's box cost through 6 checkpointed steps of
the N x N x 32 float32 gyre (3 runs, ms/step), prints its cost and a
sha256 digest of the gradient's bytes (so that two trees' values can be
compared), its peak device memory, 3 forward-only runs beside it and
the ratio of the medians, and profiles one (device busy ms/step and idle
share, as a step's); with --glue-sources also a second profiled gradient
whose plain glue is split by source, the backward of each
torch.autograd.Function of the port (kernels.TwinVJP by the twin it
re-runs, the halo fill's fold) named apart from the checkpoints'
recomputation of the forward step, the forward's own glue and autograd's
backward of PyTorch's ops. --ptxas instead compiles the
tree's PTXAS_SOURCES with the port's nvcc flags and prints ptxas's
registers and spills of each of their kernels (float and double). Exits
nonzero without CUDA.
"""

import argparse
import dataclasses
import hashlib
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
EVP_SHAPE = (1024, 32)   # the evp-ice-gyre's, float32 (EVP is 2-D)
# the cg3d solves of group "cg3d": their caps of iterations
CG3D_CAPS = (20, 100)
KERNEL_GROUPS = ("glue", "cg3d", "evp", "os7mp", "som", "ppm", "vecinv",
                 "multidim", "adjoint", "calc_gw", "ggl90", "last")
# group "os7mp": the (scheme, vertical scheme) pairs whose sweeps it times,
# O's first; group "som": H-SOM's schemes
HO_SCHEMES = ((7, 7), (33, 33), (41, 41), (51, 51))
SOM_SCHEMES = (81, 80)
# group "ppm": kernel P's schemes
PPM_SCHEMES = (40, 41, 42, 50, 51, 52)
# group "multidim": kernel M's (scheme, vertical scheme) pairs, the
# ggl90-gyre's first; each sweep is timed once
MD_SCHEMES = ((33, 33), (30, 30), (77, 77), (1, 1), (20, 20), (30, 2),
              (30, 3), (30, 4))
# group "vecinv": V's sizes (n, levels)
VECINV_SHAPES = ((1024, 32), (64, 32))
# group "ggl90": G9's sizes (n, levels)
GGL90_SHAPES = ((1024, 32), (64, 32))
# the sources whose kernels --ptxas reports, under kernels/csrc (a tree
# from before V's float64 entry points had a source of their own has no
# mom_vecinv_f64.cu: its mom_vecinv.cu holds both)
PTXAS_SOURCES = ("gad_os7mp.cu", "som.cu", "gad_ppm.cu",
                 "mom_fluxform_adj.cu", "mom_vecinv.cu", "mom_vecinv_f64.cu",
                 "gad_multidim.cu", "calc_gw.cu", "ggl90.cu")
# --config adjoint: the steps of the gradient (phase 6's)
ADJ_STEPS = 6
# the launches of a tree from before the cg3d iteration became two passes
# (three an iteration), for their bounds through chip_smoke.bound: the
# operations a cell and the fields updated in place
PARENT_OPS = {"cg3d_precond_dot": 10, "cg3d_xr_update": 8}
PARENT_IN_PLACE = {"cg3d_xr_update": ("x", "r")}


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
            t["guExt"][0], t["gvExt"][0], 1),
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


def cg3d_calls(case):
    """{kernel: one wrapper call} of the launches of one cg3d iteration on
    a chip_smoke.NhCase, with a `ctrl` that is never done (a tolerance of
    0, no cap within reach), so that every replay of a launch runs: two
    passes (s_stencil_dot, xr_precond), or on an older tree three
    launches."""
    import torch
    from mitgcm_tpu_torch.solver import cg3d

    g, op3, ws, ol = case.grid, case.op3, case.ws, case.cfg.olx
    eta_n, eta_nm1, den = (case.r.new_tensor(v) for v in (0.7, 1.3, 1.1))
    never = case.r.new_tensor(0.0)
    ctrl = torch.zeros(2, dtype=torch.int32, device="cuda")
    x, r = case.x.clone(), case.r.clone()
    s_out, qa, q = (torch.zeros_like(r) for _ in range(3))
    dots = r.new_zeros(2)
    calls = {"cg3d_s_stencil_dot": lambda: cg3d.s_stencil_dot(
        op3, g.maskC, case.q, case.s, s_out, qa, eta_n, eta_nm1, dots[0],
        ctrl, ol, ol, ws=ws)}
    if hasattr(cg3d, "xr_precond"):
        calls["cg3d_xr_precond"] = lambda: cg3d.xr_precond(
            op3, g.maskC, x, r, case.s, case.q, q, eta_n, den, dots[0],
            dots[1], ctrl, never, 1 << 30, True, ol, ol, ws=ws)
    else:
        calls["cg3d_precond_dot"] = lambda: cg3d.precond_dot(
            op3, g.maskC, case.r, q, dots[0], ctrl, ol, ol, ws=ws)
        calls["cg3d_xr_update"] = lambda: cg3d.xr_update(
            x, r, case.s, case.q, eta_n, den, g.maskC, dots[1], ctrl, never,
            1 << 30, True, ol, ol, ws=ws)
    return calls


def cg3d_times(smoke, rows):
    """Group "cg3d": the iteration's ms from whole solves, then each of
    its launches (cg3d_calls) with its bound."""
    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.solver import cg3d

    case = smoke.NhCase(*BOX_SHAPE, torch.float32)
    op = dataclasses.replace(case.op3, tolerance_sq=case.r.new_tensor(0.0))
    x0 = 0.01 * case.x
    ms, iters, launches = {}, {}, {}
    for cap in CG3D_CAPS:
        cfg = dataclasses.replace(case.cfg, cg3dMaxIters=cap)
        res = []

        def solve():
            res.append(cg3d.cg3d(cfg, case.grid, op, case.b, x0))
        kernels.launches.clear()
        solve()
        launches[cap] = dict(kernels.launches)
        ms[cap] = smoke.cuda_time_ms(solve, 3)
        iters[cap] = {r.n_iters for r in res}
        if iters[cap] != {cap}:
            raise AssertionError(f"cg3d ran {iters[cap]} iterations, not "
                                 f"its cap {cap}")
    lo, hi = CG3D_CAPS
    per_it = (ms[hi] - ms[lo]) / (hi - lo)
    calls = cg3d_calls(case)
    bounds = {name: smoke.bound(name, call)[0] for name, call in calls.items()}
    bound_it = sum(bounds.values())
    label = "box " + case.label
    rows.append({"kernel": "cg3d iteration", "shape": label, "ms": per_it,
                 "bound_ms": bound_it, "share": bound_it / per_it,
                 "solve_ms": ms, "launches": launches})
    print(f"{'cg3d iteration':16s} {label:20s} {per_it:.5f} ms an iteration "
          f"((solve of {hi} {ms[hi]:.3f} - solve of {lo} {ms[lo]:.3f}) / "
          f"{hi - lo}), bound {bound_it:.5f} ({bound_it / per_it:.2f}); "
          f"launches of a {hi}-iteration solve {launches[hi]}", flush=True)
    time_launches(smoke, calls, label, rows)
    del case


def evp_times(smoke, rows):
    """Group "evp": seaice_evp_stress and seaice_evp_uv (adaptive EVP) at
    EVP_SHAPE, the first launch of each in a 2-subcycle loop (the loop's
    launches but its last, whose `last` flag also writes dwatn and the
    divergence), as CUDA graphs of 20, with the bounds of chip_smoke.py's
    phase 15 (what one launch reads, each input once, and writes)."""
    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model import seaice_kernels as sk
    from mitgcm_tpu_torch.utils import synthetic

    case = smoke.EvpCase(*EVP_SHAPE, torch.float32)
    si, ice, d = case.si["aEVP"], case.ice, case.dyn
    fixed = dict(uNm1=case.uvNm1[0], vNm1=case.uvNm1[1],
                 **{k: d[k] for k in ("uVel0", "vVel0", "forcex0", "forcey0",
                                      "massC", "massU", "massV")})
    u, v, (s1, s2, s12) = ice.uIce, ice.vIce, ice.sigma
    setup = synthetic.evp_setup(si, ice.AREA, d["massU"], d["massV"])
    args = (u, v, s1, s2, s12, d["press0"], fixed, setup)
    sa = (u, v, s1, s2, d["press0"], d["massC"])
    st = si._evp_stress_plain(*sa)
    touched = {
        "seaice_evp_stress": list(sk._stress_ins(si, *sa).values())
        + [torch.empty_like(u) for _ in range(4)],
        "seaice_evp_uv": list(sk._uv_ins(si, u, v, s12, *st, fixed,
                                         setup).values())
        + [torch.empty_like(u) for _ in range(3)]}
    label = f"{EVP_SHAPE[0]}x{EVP_SHAPE[0]} float32"
    for name, tensors in touched.items():
        launch, outs = smoke.captured_launch(lambda: sk.evp_loop(si, *args, 2),
                                             name)
        ms = smoke.graph_ms(lambda: kernels.launch(*launch), reps=10)
        del outs
        bound_ms = smoke.bound(name, None, tensors)[0]
        rows.append({"kernel": name, "shape": label, "ms": ms,
                     "bound_ms": bound_ms, "share": bound_ms / ms})
        print(f"{name:16s} {label:20s} {ms:.5f} ms a launch, bound "
              f"{bound_ms:.5f} ({bound_ms / ms:.2f})", flush=True)
    del case


def graph_row(smoke, name, run, label, rows, call=None, tensors=None):
    """Append {kernel, shape, ms, bound_ms, share} of one launch: `run`
    (one launch) as a CUDA graph of 20, its bound from `call` (a wrapper
    call that makes it) or from `tensors` (those it reads and writes)."""
    ms = smoke.graph_ms(run, reps=10)
    bound_ms = smoke.bound(name, call, tensors)[0]
    rows.append({"kernel": name, "shape": label, "ms": ms,
                 "bound_ms": bound_ms, "share": bound_ms / ms})
    print(f"{name:16s} {label:20s} {ms:.5f} ms a launch, bound "
          f"{bound_ms:.5f} ({bound_ms / ms:.2f})", flush=True)


def digest_row(rows, outs):
    """Add the sha256 of the tensors' bytes to the last row, and print
    it."""
    import hashlib

    import torch

    torch.cuda.synchronize()
    digest = hashlib.sha256()
    for t in outs:
        digest.update(t.detach().cpu().numpy().tobytes())
    rows[-1]["sha256"] = digest.hexdigest()
    print(f"{rows[-1]['kernel']:16s} outputs' sha256 {rows[-1]['sha256']}",
          flush=True)


def sweep_times(smoke, case, pairs, label, rows):
    """The sweeps of each (scheme, vertical scheme) of `pairs` on a
    G9Case, each on the previous sweep's output, with the bounds of their
    footprints and the digest of each sweep's output (a sweep that an
    earlier pair timed with the same scheme is not timed again)."""
    import torch
    from mitgcm_tpu_torch.model import gad

    cfg, g, dt = case.cfg, case.grid, case.cfg.deltaTTracer
    done = set()
    for scheme, vert in pairs:
        args = (cfg, g, case.flow, case.u, case.v, case.w, case.tracer,
                scheme, vert, dt)
        sweeps = gad.multidim_sweeps(*args)
        for _, run, _, _ in sweeps:
            run()
        for name, run, _, dst in sweeps:
            sch = vert if name.endswith("_r") else scheme
            if (name, sch) in done:
                continue
            done.add((name, sch))
            graph_row(smoke, name, run, f"{label} {case.label} scheme {sch}",
                      rows, call=lambda: gad.multidim_advection(*args))
            digest_row(rows, [dst])
        del sweeps
        torch.cuda.empty_cache()


def os7mp_times(smoke, rows):
    """Group "os7mp": the sweeps of HO_SCHEMES on the seeded os7mp-gyre."""
    import torch

    sweep_times(smoke, smoke.G9Case(1024, 32, torch.float32, "os7mp"),
                HO_SCHEMES, "os7mp-gyre", rows)


def som_times(smoke, rows):
    """Group "som": H-SOM's passes of SOM_SCHEMES on the seeded IsmCase."""
    import torch
    from mitgcm_tpu_torch.model import som

    case = smoke.IsmCase(1024, 32, torch.float32)
    cfg, g, dt = case.cfg, case.grid, case.cfg.deltaTTracer
    for scheme in SOM_SCHEMES:
        args = (cfg, g, case.u, case.v, case.w, case.tracer, case.sm, scheme,
                dt)
        sweeps = som.som_sweeps(*args)
        for _, run, _ in sweeps:
            run()
        for name, run, _ in sweeps:
            graph_row(smoke, name, run,
                      f"som-gyre {case.label} scheme {scheme}", rows,
                      call=lambda: som.som_advect(*args))
        del sweeps
        torch.cuda.empty_cache()
    del case


def ppm_times(smoke, rows):
    """Group "ppm": the sweeps of PPM_SCHEMES on the seeded pqm-gyre."""
    import torch

    sweep_times(smoke, smoke.G9Case(1024, 32, torch.float32, "pqm"),
                [(s, s) for s in PPM_SCHEMES], "pqm-gyre", rows)


def multidim_times(smoke, rows):
    """Group "multidim": M's sweeps of MD_SCHEMES on the seeded
    ggl90-gyre."""
    import torch

    sweep_times(smoke, smoke.G9Case(1024, 32, torch.float32), MD_SCHEMES,
                "ggl90-gyre", rows)


def vecinv_times(smoke, rows):
    """Group "vecinv": one launch of V for each of chip_smoke.py's
    VI_VARIANTS on the seeded vi-gyre at VECINV_SHAPES, with the digest of
    its outputs."""
    import dataclasses

    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model.mom_vecinv import mom_vecinv

    for n, nr in VECINV_SHAPES:
        case = smoke.Case(n, nr, torch.float32, vi=True)
        for label, settings in smoke.VI_VARIANTS.items():
            cfg = dataclasses.replace(case.cfg, **settings)

            def call(cfg=cfg):
                return mom_vecinv(cfg, case.grid, case.u, case.v, case.w,
                                  case.kappaRU, case.kappaRV)
            args, outs = smoke.captured_launch(call, "mom_vecinv")
            graph_row(smoke, "mom_vecinv", lambda: kernels.launch(*args),
                      f"vi-gyre {case.label} {label or 'vi-gyre variant'}",
                      rows, call=call)
            digest_row(rows, outs)
            del outs
        del case
        smoke.GRIDS.clear()
        torch.cuda.empty_cache()


def calc_gw_times(smoke, rows):
    """Group "calc_gw": one launch of W in each variant, the box's (with
    the 3-D Coriolis term) first, on chip_smoke.py's seeded 1024x1024x50
    float32 box (NhCase), with the digest of its two outputs."""
    import dataclasses

    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model.calc_gw import calc_gw

    case = smoke.NhCase(*BOX_SHAPE, torch.float32)
    for cori in (1, 0):
        cfg = dataclasses.replace(case.cfg, select3dCoriScheme=cori)

        def call(cfg=cfg):
            return calc_gw(cfg, case.grid, case.u, case.v, case.w,
                           case.kappaRU, case.kappaRV)
        args, outs = smoke.captured_launch(call, "calc_gw")
        variant = "3-D Coriolis" if cori else "no 3-D Coriolis"
        graph_row(smoke, "calc_gw", lambda: kernels.launch(*args),
                  f"box {case.label} {variant}", rows, call=call)
        digest_row(rows, outs)
        del outs
    del case


def ggl90_times(smoke, rows):
    """Group "ggl90": one launch of G9's ggl90_col at GGL90_SHAPES float32
    on chip_smoke.py's seeded inputs, the ggl90-gyre's variant (G9Case)
    and the idemix-gyre's with IDEMIX's source and Langmuir (IsmCase, its
    gTKE from one GGL90.idemix), with the digest of its three outputs."""
    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model import ggl90 as g9

    for n, nr in GGL90_SHAPES:
        for config, make in (("ggl90-gyre", smoke.G9Case),
                             ("idemix-gyre", smoke.IsmCase)):
            case = make(n, nr, torch.float32)
            gTKE = None
            if case.ggl90.p["useIDEMIX"]:
                _, gTKE = case.ggl90.idemix(case.E, case.Nsq)

            def call(case=case, gTKE=gTKE):
                return g9.ggl90_col(case.ggl90, case.u, case.v, case.tke,
                                    case.sigmaR, case.sfU, case.sfV, gTKE)
            args, outs = smoke.captured_launch(call, "ggl90_col")
            graph_row(smoke, "ggl90_col", lambda: kernels.launch(*args),
                      f"{config} {case.label}", rows, call=call)
            digest_row(rows, [outs[k] for k in ("tke", "diffKr",
                                                "visctmp")])
            del outs, case, gTKE
            smoke.GRIDS.clear()
            torch.cuda.empty_cache()


def adjoint_times(smoke, rows):
    """Group "adjoint": one launch of B' and of C' on the seeded gyre, as
    phase 6 drives them (chip_smoke.py:vjp_phase), with the sha256 of the
    launch's outputs."""
    import numpy as np
    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model import gad
    from mitgcm_tpu_torch.model import mom_fluxform as mom

    case = smoke.Case(1024, 32, torch.float32)
    cfg, g = case.cfg, case.grid
    rng = np.random.default_rng(smoke.SEED + 1)
    shape = tuple(g.hFacC.shape)
    inner = torch.zeros(shape, dtype=case.dtype, device="cuda")
    inner[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx] = 1.0

    def backward(fwd, ins, bars):
        xs = [t.clone().requires_grad_(True) for t in ins]
        outs = fwd(*xs)
        return lambda: torch.autograd.grad(outs, xs, bars,
                                           retain_graph=True)

    bars = [case.field(rng, shape, 1.0) * inner for _ in range(4)]
    calls = {"mom_fluxform_adj": backward(
        lambda u, v, w: mom.mom_fluxform(cfg, g, u, v, w, case.kappaRU,
                                         case.kappaRV),
        (case.u, case.v, case.w), bars)}

    def rhs_fwd(t, uT, vT, rT):
        flow = case.flow._replace(uTrans=uT, vTrans=vT, rTrans=rT,
                                  rTransKp=torch.cat(
                                      [rT[1:], torch.zeros_like(rT[:1])]))
        return gad.calc_rhs(cfg, g, flow, t, case.kappaR, cfg.diffKhT)
    bar = case.field(rng, shape, 1.0) * inner
    calls["gad_calc_rhs_c2_adj"] = backward(
        rhs_fwd, (case.theta, case.flow.uTrans, case.flow.vTrans,
                  case.flow.rTrans), bar)
    label = f"gyre {case.label}"
    for name, call in calls.items():
        args, outs = smoke.captured_launch(call, name)
        graph_row(smoke, name, lambda: kernels.launch(*args), label, rows,
                  call=call)
        digest_row(rows, outs)
        del outs
    del case


def adjoint_config(smoke, n, glue=False):
    """--config adjoint: the gradient of phase 6's box cost through
    ADJ_STEPS checkpointed steps of the n x n x 32 float32 gyre: the cost
    and a sha256 digest of the gradient's bytes (two trees' values
    compared), its peak device memory, ms/step of 3 runs (after one to
    warm up) beside 3 forward-only runs and their ratio, and a profile of
    one; with glue, glue_sources' split of a second profiled gradient."""
    import numpy as np
    import torch
    from mitgcm_tpu_torch.ad.adjoint import adjoint_gradient

    box = (n // 2, 3 * n // 4, n // 2, 3 * n // 4)
    _, control, J = smoke.adjoint_objective(n, 32, torch.float32, ADJ_STEPS,
                                            box, (0, 2), deltaT=600.0)
    xx = control.zero()

    def run():
        return adjoint_gradient(J[None], xx)

    def timed(fn):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3 / ADJ_STEPS)
        return walls

    with torch.no_grad():
        J[None](xx)
        fwd = timed(lambda: J[None](xx))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cost, grad = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    digest = hashlib.sha256(grad.cpu().numpy().tobytes()).hexdigest()
    print(f"gradient: cost {float(cost)!r}, max |grad| "
          f"{float(grad.abs().max())!r}, sha256 {digest}; peak device "
          f"memory {peak:.3f} GiB", flush=True)
    walls = timed(run)
    wall, fwd_ms = float(np.median(walls)), float(np.median(fwd))
    print(f"value_and_grad {wall:.2f} ms/step (runs "
          f"{', '.join(f'{x:.2f}' for x in walls)}); forward only "
          f"{fwd_ms:.2f} (runs {', '.join(f'{x:.2f}' for x in fwd)}); "
          f"ratio {wall / fwd_ms:.2f}", flush=True)
    stats = smoke.profile_run(run, ADJ_STEPS, wall)
    if glue:
        stats["glue_sources"] = glue_sources(run, ADJ_STEPS)
    return {"ms_per_step": wall, "runs_ms_per_step": walls,
            "forward_ms_per_step": fwd_ms, "forward_runs_ms_per_step": fwd,
            "ratio": wall / fwd_ms, "peak_gib": peak,
            "cost": float(cost), "grad_sha256": digest, **stats}


def ptxas(root):
    """--ptxas: compile the tree's PTXAS_SOURCES with the port's nvcc
    flags and print ptxas's line of registers and spills for each kernel,
    its name demangled."""
    import shutil
    import subprocess
    import tempfile

    from mitgcm_tpu_torch import kernels

    csrc = os.path.join(root, "mitgcm_tpu_torch", "kernels", "csrc")
    filt = shutil.which("c++filt")
    with tempfile.TemporaryDirectory() as tmp:
        for source in PTXAS_SOURCES:
            if not os.path.exists(os.path.join(csrc, source)):
                continue
            out = subprocess.run(
                [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, "k.o"), os.path.join(csrc, source)],
                capture_output=True, text=True, check=True)
            log = out.stdout + out.stderr
            if filt:
                log = subprocess.run([filt], input=log, capture_output=True,
                                     text=True).stdout
            name = None
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    name = line.split("'")[1] if "'" in line else line
                elif name and ("registers" in line or "spill" in line):
                    print(f"{source}: {name}: {line.split(':', 1)[-1]}",
                          flush=True)


def last_glue_times(smoke, rows):
    """Group "last": chip_smoke.py phase 18's holds at full size float32
    (N1 and N2 on the box's 1024x1024x50, Q, S1, S2 and the `+ gTr`
    addend on the gyres' 1024x1024x32), each launch's device ms (a CUDA
    graph of 20), its bound, its wrapper call's and its twin's ms."""
    import torch

    results = {}
    smoke.nh_last_glue(smoke.GlueCase(*BOX_SHAPE, torch.float32, nh=True),
                       results, 10)
    smoke.GRIDS.clear()
    torch.cuda.empty_cache()
    n, nr = EVP_SHAPE
    smoke.forcing_last_glue(smoke.GlueCase(n, nr, torch.float32), results,
                            10)
    smoke.seaice_last_glue(smoke.EvpCase(n, nr, torch.float32), results, 10)
    smoke.GRIDS.clear()
    torch.cuda.empty_cache()
    smoke.addend_last_glue(smoke.G9Case(n, nr, torch.float32, "os7mp"),
                           results, 10)
    for name, r in results.items():
        rows.append({"kernel": name, "ms": r["ms"],
                     "bound_ms": r["bound_ms"],
                     "share": r["bound_ms"] / r["ms"],
                     "wrapper_ms": r["extra"]["wrapper_ms"],
                     "plain_ms": r["plain_ms"]})


def kernel_times(smoke, groups):
    """--kernels: [{kernel, shape, ms, bound_ms, share}] of the groups
    named: "glue", B, C and D-G at KERNEL_SHAPES, then the box's
    mom_correction; "cg3d"; "evp"; "os7mp"; "som"; "ppm"; "vecinv";
    "multidim"; "adjoint"; "calc_gw"; "ggl90"; "last"."""
    import torch

    rows = []
    for group, times in (("os7mp", os7mp_times), ("som", som_times),
                         ("ppm", ppm_times), ("vecinv", vecinv_times),
                         ("multidim", multidim_times),
                         ("adjoint", adjoint_times),
                         ("calc_gw", calc_gw_times),
                         ("ggl90", ggl90_times),
                         ("last", last_glue_times)):
        if group in groups:
            times(smoke, rows)
            smoke.GRIDS.clear()
            torch.cuda.empty_cache()
    if "cg3d" in groups:
        cg3d_times(smoke, rows)
        smoke.GRIDS.clear()
        torch.cuda.empty_cache()
    if "evp" in groups:
        evp_times(smoke, rows)
        smoke.GRIDS.clear()
        torch.cuda.empty_cache()
    if "glue" in groups:
        glue_times(smoke, rows)
    return rows


def glue_times(smoke, rows):
    """Group "glue": B, C and D-G at KERNEL_SHAPES, then the box's
    mom_correction."""
    import torch
    from mitgcm_tpu_torch.model.gad import calc_rhs
    from mitgcm_tpu_torch.model.mom_fluxform import mom_fluxform

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


def annotate_port():
    """Wrap every function of the port's modules (and every method of
    their classes but torch.autograd.Function's and the kernels package's)
    in a torch.profiler.record_function named after it, "model.step.
    dynamics", so that a profile can give each PyTorch op the port's
    functions that ran it; returns the names. The profiler on the card
    records no Python stacks (torch 2.11 with CUDA activity)."""
    import functools
    import inspect

    import torch

    def wrap(fn, label):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapped

    def port(obj):
        mod = getattr(obj, "__module__", None) or ""
        return (mod.startswith("mitgcm_tpu_torch.")
                and not mod.startswith("mitgcm_tpu_torch.kernels"))

    labels = set()
    for name, mod in list(sys.modules.items()):
        if (mod is None or not name.startswith("mitgcm_tpu_torch.")
                or name.startswith("mitgcm_tpu_torch.kernels")):
            continue
        for attr, obj in list(vars(mod).items()):
            if inspect.isfunction(obj) and port(obj):
                # imported names too, so that a call from another module
                # is annotated
                label = f"{obj.__module__.split('.', 1)[1]}.{obj.__name__}"
                labels.add(label)
                setattr(mod, attr, wrap(obj, label))
            elif (inspect.isclass(obj) and obj.__module__ == name
                  and not issubclass(obj, torch.autograd.Function)):
                for meth, fn in list(vars(obj).items()):
                    if inspect.isfunction(fn) and not meth.startswith("__"):
                        label = (f"{name.split('.', 1)[1]}.{obj.__name__}."
                                 f"{meth}")
                        labels.add(label)
                        setattr(obj, meth, wrap(fn, label))
    return labels


def annotate_backward():
    """Wrap the backward of every torch.autograd.Function of the port (the
    kernels package's too) in a torch.profiler.record_function named
    "backward:<class>", kernels.TwinVJP's "backward:TwinVJP(<twin>)" after
    the plain twin it re-runs (the name ending in _plain that its closure
    calls), so that autograd's launches can be split by the row or the
    fold that issued them; returns the names' prefix."""
    import functools
    import inspect

    import torch

    # kernels.twin_name's rule, kept here for the trees that predate it
    # (--root)
    def twin_name(ctx):
        twin = getattr(ctx, "twin", None)
        code = getattr(twin, "__code__", None)
        names = [n for n in (code.co_names if code else ())
                 if n.endswith("_plain")]
        return names[0] if names else getattr(twin, "__qualname__", "?")

    def wrap(cls, fn):
        @functools.wraps(fn)
        def wrapped(ctx, *grads):
            label = f"backward:{cls.__name__}"
            if cls.__name__ == "TwinVJP":
                label += f"({twin_name(ctx)})"
            with torch.profiler.record_function(label):
                return fn(ctx, *grads)
        return wrapped

    for name, mod in list(sys.modules.items()):
        if mod is None or not name.startswith("mitgcm_tpu_torch"):
            continue
        for obj in list(vars(mod).values()):
            if (inspect.isclass(obj) and obj.__module__ == name
                    and issubclass(obj, torch.autograd.Function)
                    and "backward" in vars(obj)
                    and not getattr(obj.backward, "_annotated", False)):
                fn = wrap(obj, vars(obj)["backward"].__func__)
                fn._annotated = True
                obj.backward = staticmethod(fn)
    return "backward:"


def port_frames(evt, labels, n=2):
    """The n innermost functions of the port (annotate_port's labels)
    among a profiled op's ancestors, innermost first."""
    frames = []
    while evt is not None and len(frames) < n:
        if evt.name in labels:
            frames.append(evt.name)
        evt = evt.cpu_parent
    return frames


def glue_source(evt, labels, backward, main=None):
    """The source of a profiled op for glue_sources: the backward of a
    Function of the port that ran it ("backward:..."), unless a
    checkpoint's recomputation of the forward step ran it inside that
    backward ("recomputation: <frames>", also where autograd's engine, on
    a thread other than `main`'s, runs the port's functions); else the two
    innermost functions of the port above it; else autograd's own backward
    of PyTorch's ops."""
    frames, e = [], evt
    while e is not None:
        if e.name in labels or e.name.startswith(backward):
            frames.append(e.name)
        e = e.cpu_parent
    inner = [f for f in frames if not f.startswith(backward)][:2]
    bw = next((i for i, f in enumerate(frames) if f.startswith(backward)),
              None)
    if bw is None:
        if inner and main is not None and evt.thread != main:
            return "recomputation: " + " < ".join(inner)
        return (" < ".join(inner)
                or "(no function of the port: autograd's backward)")
    if "model.step.forward_step" in frames[:bw]:
        return "recomputation: " + " < ".join(inner)
    return frames[bw]


def glue_sources(run, steps):
    """--glue-sources: {source: {"ms", "launches"}} a step of the plain glue
    of run() (which takes `steps` steps), by the two innermost functions of
    the port (annotate_port) above the PyTorch op that launched each
    kernel or copy, or the backward of the Function of the port that
    launched it (annotate_backward; glue_source), largest first; printed
    too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    labels = annotate_port()
    backward = annotate_backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    # the thread that runs the steps: the forward's (autograd's engine
    # runs a CUDA backward on a thread of its own)
    main = next((e.thread for e in prof.events()
                 if e.name in ("model.experiment.Experiment.run",
                               "ad.adjoint.run_steps")), None)
    groups = {}
    for evt in prof.events():
        glue = [k for k in evt.kernels if "mitgcm::" not in k.name]
        if not glue:
            continue
        group = groups.setdefault(glue_source(evt, labels, backward, main),
                                  {"ms": 0.0, "launches": 0.0})
        group["ms"] += sum(k.duration for k in glue) / 1e3 / steps
        group["launches"] += len(glue) / steps
    groups = dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"]))
    print(f"plain glue by source, {steps} steps: "
          f"{sum(g['ms'] for g in groups.values()):.3f} ms/step in "
          f"{sum(g['launches'] for g in groups.values()):.1f} "
          f"launches/step", flush=True)
    for key, g in groups.items():
        print(f"  {g['ms']:8.3f} ms/step {g['launches']:6.1f} launches/step"
              f"  {key}", flush=True)
    return groups


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--config", choices=("gyre", "vi", "kpp", "ggl90",
                                         "os7mp", "pqm", "som", "idemix",
                                         "gm", "gm-bolus", "ice", "box",
                                         "evp-ice", "visc", "visc-vi",
                                         "st-vi", "pp81", "my82", "opps",
                                         "adjoint"),
                    default="gyre")
    ap.add_argument("--glue-sources", action="store_true")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--kernels", nargs="*", choices=KERNEL_GROUPS)
    ap.add_argument("--ptxas", action="store_true")
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

    if args.ptxas:
        ptxas(os.path.abspath(args.root))
        return
    kernels.library()
    for name, ops in PARENT_OPS.items():
        smoke.OPS_PER_CELL.setdefault(name, ops)
    for name, fields in PARENT_IN_PLACE.items():
        smoke.IN_PLACE.setdefault(name, fields)
    if args.kernels is not None:
        groups = args.kernels or KERNEL_GROUPS
        print(json.dumps({"root": args.root, "card": smi,
                          "kernels": kernel_times(smoke, groups)}),
              flush=True)
        return
    if args.config == "adjoint":
        print(json.dumps({"root": args.root, "config": args.config,
                          "n": args.n, "card": smi,
                          **adjoint_config(smoke, args.n,
                                           args.glue_sources)}), flush=True)
        return
    kw = dict(nx=args.n, ny=args.n, nr=32, deltaT=600.0)
    if args.config == "box":
        exp = smoke.nh_experiment(args.n, BOX_SHAPE[1], torch.float32,
                                  deltaT=60.0)
    elif args.config == "evp-ice":
        exp = smoke.evp_experiment(args.n, 32, torch.float32, deltaT=600.0)
    elif args.config == "vi":
        exp = smoke.vi_experiment(args.n, 32, torch.float32, deltaT=600.0)
    elif args.config == "kpp":
        exp = smoke.kpp_experiment(args.n, 32, torch.float32, deltaT=600.0)
    elif args.config in ("gm", "gm-bolus"):
        exp = smoke.gm_experiment(args.config, args.n, 32, torch.float32,
                                  deltaT=600.0)
    elif args.config == "ice":
        exp = smoke.ice_experiment(args.n, 32, torch.float32, deltaT=600.0)
    elif args.config in smoke.VISC_CONFIGS:
        exp = smoke.visc_experiment(args.config, args.n, 32, torch.float32,
                                    deltaT=600.0)
    elif args.config in ("pp81", "my82", "opps"):
        exp = smoke.rimix_experiment(args.config, args.n, 32, torch.float32,
                                     deltaT=600.0)
    elif args.config in ("os7mp", "pqm", "som", "idemix"):
        exp = smoke.g9_experiment(args.n, 32, torch.float32,
                                  config=args.config, deltaT=600.0)
    elif args.config == "gyre":
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
    if args.glue_sources:
        stats["glue_sources"] = glue_sources(
            lambda: exp.run(n_steps=2, collect_monitor=False), 2)
    print(json.dumps({"root": args.root, "config": args.config,
                      "n": args.n, "card": smi, "ms_per_step": wall, **stats}),
          flush=True)


if __name__ == "__main__":
    main()
