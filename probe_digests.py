#!/usr/bin/env python3
"""Bit-for-bit digests of the port's gyre and vi-gyre on one NVIDIA GPU.

    python3 probe_digests.py ROOT

For the package under ROOT (this repository, or an unpacked earlier tree
to compare with): the cg2d iterations, the first residuals and a sha256
of the state after 4 steps of the 1024x1024x32 float32 gyre and vi-gyre
(deltaT = 600 s), then a sha256 of kernel B's four tendencies in each of
its first four variants (no-slip or free-slip sides, with or without the
3-D Coriolis term) and of kernel V's in each of its 24 first variants
(vorticity and Coriolis schemes, implicit viscosity, no-slip or linear
bottom drag), on seeded inputs on the gyre's grid. Two trees' equal
lines mean equal bits. Run both in one call, in turns (parent, change,
change, parent).
"""
import hashlib
import itertools
import sys

import numpy as np
import torch

sys.path.insert(0, sys.argv[1])
from mitgcm_tpu_torch.model import mom_fluxform as mom  # noqa: E402
from mitgcm_tpu_torch.model import mom_vecinv as vi  # noqa: E402
from mitgcm_tpu_torch.model.experiment import Experiment  # noqa: E402
from mitgcm_tpu_torch.utils import synthetic  # noqa: E402


def h(ts):
    d = hashlib.sha256()
    for t in ts:
        d.update(t.detach().cpu().numpy().tobytes())
    return d.hexdigest()[:16]


for name, config in (("gyre", synthetic.gyre_config),
                     ("vi-gyre", synthetic.vi_gyre_config)):
    cfg = config(nx=1024, ny=1024, nr=32, deltaT=600.0)
    exp = Experiment(cfg, *synthetic.gyre_setup(cfg, dtype=torch.float32,
                                                device="cuda"))
    recs = exp.run(n_steps=4)[1:]
    print(name, "steps", [r["cg2d_iters"] for r in recs],
          [f"{r['cg2d_init_res']:.10e}" for r in recs],
          h([getattr(exp.state, f) for f in ("uVel", "vVel", "wVel", "theta",
                                              "salt", "etaN")]), flush=True)
    g = exp.grid
    rng = np.random.default_rng(5)
    shape = tuple(g.hFacC.shape)

    def field(s, shp=shape):
        return torch.as_tensor(rng.standard_normal(shp) * s,
                               dtype=torch.float32, device="cuda")

    u, v, w = field(0.1) * g.maskW, field(0.1) * g.maskS, field(1e-4) * g.maskC
    kU = field(1e-3, (33,) + shape[1:]).abs()
    kV = field(1e-3, (33,) + shape[1:]).abs()
    if name == "gyre":
        for ns, c3 in itertools.product((True, False), (False, True)):
            c = synthetic.gyre_config(nx=1024, ny=1024, nr=32, deltaT=600.0,
                                      no_slip_sides=ns,
                                      select3dCoriScheme=int(c3))
            print("B", ns, c3, h(mom.mom_fluxform(c, g, u, v, w, kU, kV)),
                  flush=True)
    else:
        for vs, cs, imp, drag in itertools.product(
                (0, 1, 2), (0, 1), (True, False),
                ((True, 0.0), (False, 2e-4))):
            c = synthetic.vi_gyre_config(
                nx=1024, ny=1024, nr=32, deltaT=600.0, selectVortScheme=vs,
                selectCoriScheme=cs, implicitViscosity=imp,
                no_slip_bottom=drag[0], bottomDragLinear=drag[1])
            print("V", vs, cs, imp, drag, h(vi.mom_vecinv(c, g, u, v, w, kU,
                                                          kV)), flush=True)
