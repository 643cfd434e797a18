#!/usr/bin/env python3
"""Timing probe of G9's ggl90_col on one NVIDIA GPU: variants of its
kernel (kernels/csrc/ggl90_col.cuh), each built from a patched copy of
the sources into a library of its own, timed on the same launch as the
kernel of this tree.

    python3 probe_ggl90_col.py

The launch is the wrapper's (model/ggl90.py:ggl90_col) on chip_smoke.py's
seeded 1024x1024x32 float32 inputs: the ggl90-gyre's variant (G9Case,
mxlMaxFlag 2), the same with mxlMaxFlag 0 (which skips the sweep from the
bottom) and the idemix-gyre's (IsmCase: IDEMIX's source from one
GGL90.idemix, and Langmuir). Each line is a variant's device ms a launch
(chip_smoke.py:graph_ms: 20 launches in a CUDA graph) and whether its
outputs' bits are the tree's kernel's; every variant runs twice, in turns.
The variants (VARIANTS): 64, 128 or 256 columns a block (the tree's: 32),
128 with a cap of 64 registers, the columns a block read from blockDim at
run time (the tree's: a constant), the up passes' loads a level ahead or
in groups of 1, 2 and 8 levels (the tree's: 4), the kernel's first version
(128 columns at run time, a level ahead), and the down pass's loads two
levels ahead. Exits nonzero without CUDA.
"""

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
HEADER = "ggl90_col.cuh"

# the up passes as a level a load: the sweep from the bottom one level
# ahead, the back substitution's maskC loaded where it is used
LEVEL_UP = """  // ---- 1. up: the sweep from the bottom (flags 2 and 3) ----
  if (flag >= 2) {
    size_t p = (nr - 1) * P + col;
    T mk = a.maskC[p];
    T tk = a.tke[p], sk = a.sigmaR[p], mkm = a.maskC[p - P];
    T up = T(0);
    for (int k = nr - 1; k >= 1; --k) {
      T tn = T(0), sn = T(0), mn = T(0);
      if (k > 1) {
        tn = a.tke[p - P], sn = a.sigmaR[p - P];
        mn = a.maskC[p - 2 * P];
      }
      const T mlr = raw(sqrt(tk), sk, mk * mkm);
      up = k == nr - 1 ? g9min(mlr, mlMin + a.drF[nr - 1])
                       : g9min(mlr, up + a.drF[k]);
      A[static_cast<size_t>(k) * C] = up;
      mk = mkm, tk = tn, sk = sn, mkm = mn;
      p -= P;
    }
  }

"""
LEVEL_BACK = """  // ---- 3. up: back substitution and the TKE floor below the surface ----
  T x = ypm1, mk = mCm;
  for (int k = nr - 1; k >= 0; --k) {
    const size_t p = static_cast<size_t>(k) * P + col;
    if (k == 0) {
      a.tkeNew[p] = A[0] - B[0] * x;
      break;
    }
    const T mkm = a.maskC[p - P];
    if (k < nr - 1)
      x = A[static_cast<size_t>(k) * C] - B[static_cast<size_t>(k) * C] * x;
    a.tkeNew[p] = mk * mkm * g9max(x, T(q.tkeMin));
    mk = mkm;
  }
}

"""
# the down pass's loads two levels ahead
DOWN2 = [("""  G9Level<T> cur = load(0);
  for (int k = 0; k < nr; ++k) {
    G9Level<T> nxt;
    if (k + 1 < nr) nxt = load(k + 1);""", """  G9Level<T> cur = load(0), nx1;
  if (nr > 1) nx1 = load(1);
  for (int k = 0; k < nr; ++k) {
    G9Level<T> nxt;
    if (k + 2 < nr) nxt = load(k + 2);"""),
         ("""    cur = nxt;
  }
  // the bottom row""", """    cur = nx1;
    nx1 = nxt;
  }
  // the bottom row""")]


def group(n):
    return [("kG9Group = 4", f"kG9Group = {n}")]


def columns(n):
    return [("kG9Columns = 32", f"kG9Columns = {n}")]


LEVEL = [("  // ---- 1. up:", "  // ---- 2. down:", LEVEL_UP),
         ("  // ---- 3. up:", "// G9's ggl90_col launch", LEVEL_BACK)]
# the block's columns read from blockDim at run time, not a constant
RUNTIME_C = [("""  constexpr int C = kG9Columns;
  const int c = threadIdx.x, col = blockIdx.x * C + c;""",
              """  const int C = blockDim.x, c = threadIdx.x;
  const int col = blockIdx.x * C + c;""")]


# variant -> its patches: (old, new) text, or (start, end, new) to replace
# the text from start up to end
VARIANTS = {
    "tree": [],
    "a level a load": LEVEL,
    "a level a load, 128": LEVEL + columns(128),
    "first version": LEVEL + columns(128) + RUNTIME_C,
    "columns at run time": RUNTIME_C,
    "64 columns a block": columns(64),
    "128 columns a block": columns(128),
    "256 columns a block": columns(256),
    "64 registers": columns(128) + [
        ("__global__ void ggl90_col_kernel(",
         "__global__ void __launch_bounds__(128, 8) ggl90_col_kernel(")],
    "groups of 1": group(1),
    "groups of 2": group(2),
    "groups of 8": group(8),
    "down 2 ahead": DOWN2,
}


def patched(source, patches):
    for patch in patches:
        if len(patch) == 2:
            old, new = patch
            assert old in source, old
            source = source.replace(old, new)
        else:
            start, end, new = patch
            i, j = source.index(start), source.index(end)
            source = source[:i] + new + source[j:]
    return source


def build(kernels, csrc, tmp):
    """{variant: its ggl90_col entry point (float32)}, each built from a
    patched copy of csrc."""
    procs = {}
    for name, patches in VARIANTS.items():
        d = os.path.join(tmp, f"v{len(procs)}")
        shutil.copytree(csrc, d)
        path = os.path.join(d, HEADER)
        with open(path) as f:
            source = patched(f.read(), patches)
        with open(path, "w") as f:
            f.write(source)
        so = os.path.join(d, "lib.so")
        procs[name] = (so, subprocess.Popen(
            [kernels.nvcc_path(), *kernels.ARCH, "-std=c++17", "-O3",
             "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC", "-shared",
             "-o", so, os.path.join(d, "ggl90.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        if shutil.which("c++filt"):
            log = subprocess.run(["c++filt"], input=log, capture_output=True,
                                 text=True).stdout
        kernel = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                kernel = (line[line.index("ggl90_col_kernel<"):
                               line.index(">(") + 1]
                          if "ggl90_col_kernel<float" in line else None)
            elif kernel and ("stack frame" in line or "registers" in line):
                print(f"{name}: {kernel}: {line.split(':')[-1].strip()}",
                      flush=True)
        fn = ctypes.CDLL(so).mitgcm_ggl90_col_f32
        fn.argtypes = kernels.SIGNATURES["ggl90_col"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(smoke.device_phase(), flush=True)
    sys.path.insert(0, HERE)
    import torch
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model import ggl90 as g9

    kernels.library()
    csrc = os.path.join(HERE, "mitgcm_tpu_torch", "kernels", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(kernels, csrc, tmp)
        for label, make, flag in (("ggl90-gyre", smoke.G9Case, None),
                                  ("ggl90-gyre flag 0", smoke.G9Case, 0),
                                  ("idemix-gyre", smoke.IsmCase, None)):
            case = make(1024, 32, torch.float32)
            gTKE = None
            if case.ggl90.p["useIDEMIX"]:
                _, gTKE = case.ggl90.idemix(case.E, case.Nsq)
            if flag is not None:
                case.ggl90.p = dict(case.ggl90.p, mxlMaxFlag=flag)
            args, outs = smoke.captured_launch(
                lambda: g9.ggl90_col(case.ggl90, case.u, case.v, case.tke,
                                     case.sigmaR, case.sfU, case.sfV, gTKE),
                "ggl90_col")
            names = ("tke", "diffKr", "visctmp")

            def digest():
                torch.cuda.synchronize()
                return hashlib.sha256(b"".join(
                    outs[n].cpu().numpy().tobytes() for n in names)
                ).hexdigest()
            want = digest()
            for _ in range(2):
                for name, fn in fns.items():
                    def run(fn=fn):
                        err = fn(*args[2:],
                                 torch.cuda.current_stream().cuda_stream)
                        if err != 0:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                    run()
                    same = digest() == want
                    ms = smoke.graph_ms(run, reps=10)
                    print(f"{label:18s} {name:20s} {ms:.5f} ms a launch, "
                          f"the tree's bits {same}", flush=True)
            del case, outs, args, gTKE
            smoke.GRIDS.clear()
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
