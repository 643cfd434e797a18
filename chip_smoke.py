#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mitgcm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero without the final line:
  1. device    : refuse to run without CUDA; print the card's name and
                 power limit (nvidia-smi) and the torch / CUDA versions
  2. build     : compile the kernels of kernels/csrc with nvcc
  3. kernels   : each CUDA kernel against its plain PyTorch twin on the same
                 seeded inputs, at 64x64x4 float64 and 1024x1024x32 float32
                 (the main path's shapes), with error and times
  4. parity    : 10 steps of the 64x64x4 gyre in float64, kernel path
                 against plain path
  5. full size : the 1024x1024x32 gyre in float32 (deltaT=600): one warm-up
                 step and 5 timed steps through the kernels, with every
                 kernel's launch count, then 2 steps of the plain path
The last two lines are the per-kernel JSON summary and the device line.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234

# kernel -> (source, the fused JAX computation it replaces)
KERNELS = {
    "cg2d_stencil_dot": ("mitgcm_tpu_torch/kernels/csrc/cg2d.cu",
                         "mitgcm_tpu/solver/cg2d.py:252"),
    "cg2d_s_update": ("mitgcm_tpu_torch/kernels/csrc/cg2d.cu",
                      "mitgcm_tpu/solver/cg2d.py:255"),
    "cg2d_xr_update": ("mitgcm_tpu_torch/kernels/csrc/cg2d.cu",
                       "mitgcm_tpu/solver/cg2d.py:259"),
    "mom_fluxform": ("mitgcm_tpu_torch/kernels/csrc/mom_fluxform.cu",
                     "mitgcm_tpu/model/mom_fluxform.py:122"),
    "gad_calc_rhs_c2": ("mitgcm_tpu_torch/kernels/csrc/gad_calc_rhs.cu",
                        "mitgcm_tpu/model/gad.py:1038"),
}
# largest relative interior error a kernel may show against its twin
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
CG2D_X_TOL_F64 = 1e-10
PARITY_DIGITS = 10.0


def phase(title):
    print(f"== {title}", flush=True)


def cuda_time_ms(fn, reps):
    """Median over reps of fn's device time (CUDA events), after a
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_phase():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU and has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return smi


def build_phase(kernels):
    phase("2 build")
    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    kernels.library()
    print(f"built {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")


class Case:
    """A gyre grid plus seeded random fields on the card."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.model import gad
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.gyre_config(nx=n, ny=n, nr=nr)
        self.grid, _, _, self.op = synthetic.gyre_setup(
            self.cfg, dtype=dtype, device="cuda")
        rng = np.random.default_rng(SEED)
        g = self.grid
        shape = tuple(g.hFacC.shape)
        self.u = self.field(rng, shape, 0.1) * g.maskW
        self.v = self.field(rng, shape, 0.1) * g.maskS
        self.w = self.field(rng, shape, 1e-4) * g.maskC
        self.theta = (15.0 + self.field(rng, shape, 2.0)) * g.maskC
        kshape = (nr + 1,) + shape[1:]
        self.kappaRU = self.field(rng, kshape, 1e-3).abs()
        self.kappaRV = self.field(rng, kshape, 1e-3).abs()
        self.kappaR = self.field(rng, shape, 1e-4).abs()
        self.flow = gad.calc_adv_flow(g, self.u, self.v, self.w)
        self.y2 = self.field(rng, shape[1:], 1.0)   # 2-D cg2d fields
        self.z2 = self.field(rng, shape[1:], 1.0)

    def field(self, rng, shape, scale):
        a = rng.standard_normal(shape) * scale
        return torch.as_tensor(a, dtype=self.dtype, device="cuda")

    @property
    def label(self):
        c = self.cfg
        return f"{c.nx}x{c.ny}x{c.nr} {str(self.dtype).split('.')[-1]}"


def compare(name, case, outs_k, outs_p, ms, plain_ms, results):
    from mitgcm_tpu_torch.utils.compare import interior, rel_err

    def cells(t):   # interior of a field; a 0-d dot product as it is
        return interior(t, case.cfg.olx) if t.dim() else t.cpu().numpy()

    rel = max(rel_err(cells(k), cells(p)) for k, p in zip(outs_k, outs_p))
    abs_err = max(float(np.max(np.abs(cells(k) - cells(p))))
                  for k, p in zip(outs_k, outs_p))
    tol = TOL[case.dtype]
    print(f"{name:18s} {case.label:18s} max rel err {rel:.3e} "
          f"(tol {tol:g}), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{name} disagrees with its plain twin at "
                             f"{case.label}: {rel:.3e} > {tol:g}")
    results[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def kernel_phase(case, results, reps):
    from mitgcm_tpu_torch.model.gad import calc_rhs
    from mitgcm_tpu_torch.model.mom_fluxform import mom_fluxform
    from mitgcm_tpu_torch.solver import cg2d as cg
    from mitgcm_tpu_torch.utils.compare import interior, rel_err

    cfg, g, op = case.cfg, case.grid, case.op
    ol = cfg.olx

    def mom(impl):
        return mom_fluxform(cfg, g, case.u, case.v, case.w, case.kappaRU,
                            case.kappaRV, impl=impl)

    compare("mom_fluxform", case, mom(None), mom("plain"),
            cuda_time_ms(lambda: mom(None), reps),
            cuda_time_ms(lambda: mom("plain"), reps), results)

    def rhs(impl):
        return calc_rhs(cfg, g, case.flow, case.theta, case.kappaR,
                        cfg.diffKhT, impl=impl)

    compare("gad_calc_rhs_c2", case, [rhs(None)], [rhs("plain")],
            cuda_time_ms(lambda: rhs(None), reps),
            cuda_time_ms(lambda: rhs("plain"), reps), results)

    # kernel A, one call at a time, on the same inputs for both paths:
    # (make the output buffers, make one call on them)
    y2, z2 = case.y2, case.z2
    ws = cg.Workspace(y2.shape, ol, ol, case.dtype, "cuda")
    eta, den = y2.new_tensor(0.7), y2.new_tensor(1.3)
    calls = {
        "cg2d_stencil_dot": (
            lambda: [torch.zeros_like(y2), y2.new_zeros(())],
            lambda o, impl: cg.stencil_dot(op.pW, op.pS, op.pC, y2, o[0],
                                           o[1], True, ol, ol, ws=ws,
                                           impl=impl)),
        "cg2d_s_update": (
            lambda: [z2.clone()],
            lambda o, impl: cg.s_update(y2, o[0], eta, den, ol, ol,
                                        impl=impl)),
        "cg2d_xr_update": (
            lambda: [y2.clone(), z2.clone(), y2.new_zeros(())],
            lambda o, impl: cg.xr_update(o[0], o[1], z2, y2, eta, den, o[2],
                                         ol, ol, ws=ws, impl=impl)),
    }
    for name, (make, call) in calls.items():
        outs, ms = {}, {}
        for impl in (None, "plain"):
            bufs = make()
            call(bufs, impl)
            outs[impl] = [t.clone() for t in bufs]
            ms[impl] = cuda_time_ms(lambda: call(bufs, impl), reps * 5)
        compare(name, case, outs[None], outs["plain"], ms[None],
                ms["plain"], results)

    # the whole solve, kernel path against plain path
    b = case.y2 * g.maskInC
    x0 = torch.zeros_like(b)
    res_k = cg.cg2d(cfg, op, b, x0)
    res_p = cg.cg2d(cfg, op, b, x0, impl="plain")
    xerr = rel_err(interior(res_k.x, ol), interior(res_p.x, ol))
    print(f"cg2d solve          {case.label:18s} x rel err {xerr:.3e}, "
          f"iterations {res_k.n_iters} / {res_p.n_iters} (kernel / plain), "
          f"residual {float(res_k.first_residual):.6e} -> "
          f"{float(res_k.last_residual):.6e}, host syncs {res_k.host_syncs}",
          flush=True)
    if case.dtype == torch.float64:
        if not (xerr <= CG2D_X_TOL_F64 and res_k.n_iters == res_p.n_iters):
            raise AssertionError("cg2d kernel path disagrees with the plain "
                                 "path in float64")


def parity_phase():
    phase("4 parity: 64x64x4 gyre, float64, 10 steps, kernel vs plain")
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic
    from mitgcm_tpu_torch.utils.compare import record_digits

    runs = {}
    for impl in (None, "plain"):
        cfg = synthetic.gyre_config(nx=64, ny=64, nr=4)
        grid, state, forcing, op = synthetic.gyre_setup(
            cfg, dtype=torch.float64, device="cuda")
        runs[impl] = Experiment(cfg, grid, state, forcing, op,
                                impl=impl).run(n_steps=10)
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, init res {rk['cg2d_init_res']:.10e}, "
              f"fewest digits {dig[key]:.2f} ({key})", flush=True)
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError("cg2d iteration counts differ")
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"slice parity {worst:.2f} < {PARITY_DIGITS} "
                             "digits")
    print(f"slice parity: fewest matching digits {worst:.2f}")


def full_phase(kernels):
    phase("5 full size: 1024x1024x32 gyre, float32, deltaT=600")
    from mitgcm_tpu_torch.model.step import forward_step
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.gyre_config(nx=1024, ny=1024, nr=32, deltaT=600.0)
    t0 = time.perf_counter()
    grid, state0, forcing, op = synthetic.gyre_setup(
        cfg, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    points = cfg.nx * cfg.ny * cfg.nr

    def run(state, it0, n, impl):
        iters = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for it in range(it0, it0 + n):
            state, diag = forward_step(cfg, grid, op, state, forcing, it,
                                       impl=impl)
            iters.append(diag.cg2d_iters)
        torch.cuda.synchronize()
        return state, iters, time.perf_counter() - t, diag

    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    state1, iters_w, sec_w, _ = run(state0, 0, 1, None)
    state, iters, sec, diag = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"kernel path: 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations "
          f"{iters}, host syncs in the last solve {diag.cg2d_host_syncs}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    shape3 = (cfg.nr, cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        field = getattr(state, name)
        want = shape3[1:] if name == "etaN" else shape3
        if tuple(field.shape) != want:
            raise AssertionError(f"{name} has shape {tuple(field.shape)}")
        if not bool(torch.isfinite(field).all()):
            raise AssertionError(f"{name} is not finite after 6 steps")
    missing = [k for k in KERNELS if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    _, iters_p, sec_p, _ = run(state1, 1, 2, "plain")
    print(f"plain path: 2 steps, {sec_p * 1e3 / 2:.2f} ms/step, "
          f"{points * 2 / sec_p:.4e} points*steps/s, cg2d iterations "
          f"{iters_p}", flush=True)
    return launches


def main():
    smi = device_phase()
    sys.path.insert(0, ROOT)
    from mitgcm_tpu_torch import kernels

    build_phase(kernels)
    phase("3 kernels vs plain twins")
    # the JSON summary reports the main path's shapes (the second case)
    results = {}
    kernel_phase(Case(64, 4, torch.float64), results, reps=20)
    kernel_phase(Case(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
    parity_phase()
    launches = full_phase(kernels)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    summary = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **results[name]}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
