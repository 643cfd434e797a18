"""Second-order-moment (Prather 1986) tracer advection, schemes 80 and 81:
the port of mitgcm_tpu/model/som.py (Cartesian grid, linear free surface).

Reference: pkg/generic_advdiff/gad_som_advect.F (the top-level routine),
gad_som_adv_x.F / gad_som_adv_y.F / gad_som_adv_r.F (the directional
passes) and gad_som_lim_r.F (the vertical limiter). Besides the cell's
tracer content each tracer carries nine sub-grid moments [9, nr, nyp, nxp]
in the slot order (x, y, z, xx, yy, zz, xy, xz, yz); each directional pass
is an exact finite-volume remap of the piecewise-parabolic distribution,
after Prather's positive-definite limiter on that direction's moments with
scheme 81.

`som_advect` runs kernel H-SOM (kernels/csrc/som.cu, som_tile.cuh) for
CUDA tensors: the X, Y and R passes, one launch each, each loading and
limiting every cell of the padded array once and forming the fluxes of
each face once (X a warp's cells side by side, Y and R walks down rows and
columns), and writing the volume, the content and the nine moments out of
place; the R pass folds in the vertical limiter and ends with gTracer. For
CPU tensors, or with impl="plain", it runs the plain twins `_som_x_plain`,
`_som_y_plain` and `_som_r_plain`, which replay the JAX code's operation
order on whole arrays (`_limit_1d`, `_face_fluxes`, `_apply_updates`,
`_som_adv_horiz`). Both compute every cell of the padded arrays with the
JAX code's zero-filled shifts, so, as in the JAX code, the first padded
column and row come out non-finite (the upwind volume read there is 0, and
0/0 or x/0 passes through the update blend); the end-of-step halo fill
overwrites them, and nothing reads them before it.

Left out: the noFlow branch of the vertical pass (som.py:229-240), which
serves the rigid lid, the nonlinear free surface and r*, all of which
step.check_supported refuses; and the cubed sphere, as in JAX. No
gradient: the adjoint refuses every scheme but 2.
"""

from __future__ import annotations

import torch

from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.model.gad_ho import _div
from mitgcm_tpu_torch.ops.stencil import shift as sh

SOM_SCHEMES = (80, 81)
NSOM = 9
# slot indices within the 9-moment state
IX, IY, IZ, IXX, IYY, IZZ, IXY, IXZ, IYZ = range(9)

# per-direction roles: (along, alongSq, [(m, cross)...], [passive...])
_ROLES = {
    "x": (IX, IXX, [(IY, IXY), (IZ, IXZ)], [IYY, IZZ, IYZ]),
    "y": (IY, IYY, [(IX, IXY), (IZ, IYZ)], [IXX, IZZ, IXZ]),
    "r": (IZ, IZZ, [(IX, IXZ), (IY, IYZ)], [IXX, IYY, IXY]),
}
# calls of som_advect that ran the plain twins (a run on the card reads it
# to show that its kernel path never did)
plain_calls = 0


def _limit_1d(o, A, AA, c1, c2):
    """Prather's positive-definite limiter on one direction's moments
    (som.py:38-48): clamp the slope A, the curvature AA and the two cross
    moments c1, c2 against the cell content o."""
    slpmax = torch.clamp(o, min=0.0)
    s1max = slpmax * 1.5
    s1new = torch.clamp(A, min=-s1max, max=s1max)
    s2new = torch.clamp(AA, min=s1new.abs() - slpmax,
                        max=2.0 * slpmax - _div(s1new.abs(), 3.0))
    return (s1new, s2new, torch.clamp(c1, min=-slpmax, max=slpmax),
            torch.clamp(c2, min=-slpmax, max=slpmax))


def _face_fluxes(direction, trans_dt, v_up, o_up, sm_up, v_dn, o_dn, sm_dn):
    """One-sided Prather face fluxes (som.py:51-90): trans_dt the transport
    times deltaT through the face (positive from the 'up' cell, index - 1,
    into the 'dn' cell); returns (fp, fn, alp, aln), fp the fluxes leaving
    the 'up' cell and fn those leaving the 'dn' cell, keyed 'v', 'o' and the
    moment slots."""
    A, AA, semis, passives = _ROLES[direction]
    fp, fn = {}, {}
    fp["v"] = torch.clamp(trans_dt, min=0.0)
    alp = fp["v"] / v_up
    alpq = alp * alp
    alp1 = 1.0 - alp
    fp["o"] = alp * (o_up + alp1 * sm_up[A]
                     + alp1 * (alp1 - alp) * sm_up[AA])
    fp[A] = alpq * (sm_up[A] + 3.0 * alp1 * sm_up[AA])
    fp[AA] = alp * alpq * sm_up[AA]
    for m, c in semis:
        fp[m] = alp * (sm_up[m] + alp1 * sm_up[c])
        fp[c] = alpq * sm_up[c]
    for p in passives:
        fp[p] = alp * sm_up[p]

    fn["v"] = torch.clamp(-trans_dt, min=0.0)
    aln = fn["v"] / v_dn
    alnq = aln * aln
    aln1 = 1.0 - aln
    fn["o"] = aln * (o_dn - aln1 * sm_dn[A]
                     + aln1 * (aln1 - aln) * sm_dn[AA])
    fn[A] = alnq * (sm_dn[A] - 3.0 * aln1 * sm_dn[AA])
    fn[AA] = aln * alnq * sm_dn[AA]
    for m, c in semis:
        fn[m] = aln * (sm_dn[m] - aln1 * sm_dn[c])
        fn[c] = alnq * sm_dn[c]
    for p in passives:
        fn[p] = aln * sm_dn[p]
    return fp, fn, alp, aln


def _apply_updates(direction, v, o, sm, fp, fn, alp, aln, shp, upd):
    """The two update sweeps of a directional pass (som.py:93-150): shp(f)
    is f at the cell's high-side face, upd the 0/1 update-range mask."""
    A, AA, semis, passives = _ROLES[direction]

    # sweep 1: remove outgoing
    alf1 = 1.0 - aln - shp(alp)
    alf1q = alf1 * alf1
    alpmn = shp(alp) - aln
    v1 = v - fn["v"] - shp(fp["v"])
    o1 = o - fn["o"] - shp(fp["o"])
    sm1 = {}
    sm1[A] = alf1q * (sm[A] - 3.0 * alpmn * sm[AA])
    sm1[AA] = alf1 * alf1q * sm[AA]
    for _, c in semis:
        sm1[c] = alf1q * sm[c]
    for m, _ in semis:
        sm1[m] = sm[m] - fn[m] - shp(fp[m])
    for p in passives:
        sm1[p] = sm[p] - fn[p] - shp(fp[p])

    # sweep 2: add incoming
    v2 = v1 + fp["v"] + shp(fn["v"])
    alfp = fp["v"] / v2
    alfn = shp(fn["v"]) / v2
    alf1 = 1.0 - alfp - alfn
    alp1 = 1.0 - alfp
    aln1 = 1.0 - alfn
    alpmn = alfp - alfn
    locTp = alfp * o1 - alp1 * fp["o"]
    locTn = alfn * o1 - aln1 * shp(fn["o"])
    sm2 = {}
    sm2[AA] = (alf1 * alf1 * sm1[AA] + alfp * alfp * fp[AA]
               + alfn * alfn * shp(fn[AA])
               - 5.0 * (-alpmn * alf1 * sm1[A] + alfp * alp1 * fp[A]
                        - alfn * aln1 * shp(fn[A])
                        + 2.0 * alfp * alfn * o1 + (alp1 - alfp) * locTp
                        + (aln1 - alfn) * locTn))
    for m, c in semis:
        sm2[c] = (alf1 * sm1[c] + alfp * fp[c] + alfn * shp(fn[c])
                  + 3.0 * (alpmn * sm1[m] - alp1 * fp[m]
                           + aln1 * shp(fn[m])))
    sm2[A] = (alf1 * sm1[A] + alfp * fp[A] + alfn * shp(fn[A])
              + 3.0 * (locTp - locTn))
    o2 = o1 + fp["o"] + shp(fn["o"])
    for m, _ in semis:
        sm2[m] = sm1[m] + fp[m] + shp(fn[m])
    for p in passives:
        sm2[p] = sm1[p] + fp[p] + shp(fn[p])

    # blend with the update mask
    v_new = upd * v2 + (1.0 - upd) * v
    o_new = upd * o2 + (1.0 - upd) * o
    out = [upd * sm2[s] + (1.0 - upd) * sm[s] for s in range(NSOM)]
    return v_new, o_new, torch.stack(out)


def _som_adv_horiz(direction, limiter, trans, dt, v, o, sm, upd, lim_mask):
    """One horizontal pass (som.py:153-175); trans is the transport through
    the low-side face of each cell, sm the [9, ...] moments."""
    if direction == "x":
        def shm(f):
            return sh(f, di=-1)

        def shp(f):
            return sh(f, di=1)
    else:
        def shm(f):
            return sh(f, dj=-1)

        def shp(f):
            return sh(f, dj=1)

    if limiter == 1:
        A, AA, semis, _ = _ROLES[direction]
        c1, c2 = semis[0][1], semis[1][1]
        new = _limit_1d(o, sm[A], sm[AA], sm[c1], sm[c2])
        sm = sm.clone()
        for s, n in zip((A, AA, c1, c2), new):
            sm[s] = lim_mask * n + (1 - lim_mask) * sm[s]

    fp, fn, alp, aln = _face_fluxes(direction, trans * dt, shm(v), shm(o),
                                    shm(sm), v, o, sm)
    return _apply_updates(direction, v, o, sm, fp, fn, alp, aln, shp, upd)


def _cart_masks(cfg: Config, like: torch.Tensor):
    """The Cartesian update ranges (som.py:178-185, gad_som_adv_x.F:86-113
    with no edges): X i in [1, nxp-1), every j; Y j in [1, nyp-1), every
    i."""
    nyp = cfg.ny * cfg.nFaces + 2 * cfg.oly
    nxp = cfg.nx + 2 * cfg.olx
    xm = like.new_zeros((nyp, nxp))
    xm[:, 1:nxp - 1] = 1.0
    ym = like.new_zeros((nyp, nxp))
    ym[1:nyp - 1, :] = 1.0
    return xm, ym


def _som_x_plain(cfg: Config, grid: Grid, u, tracer, smTr, scheme: int,
                 deltaT: float):
    """som_x's twin: the pass's start state from the tracer
    (som.py:199-209) and the X pass (:211-215); returns (v, o, sm)."""
    drF = grid.drF[:, None, None]
    uT = u * (grid.dyG * drF * grid.hFacW)
    smVol0 = grid.rA * drF * grid.hFacC
    smV = smVol0 + (1.0 - grid.maskC)
    smO = tracer * smVol0
    xm, _ = _cart_masks(cfg, tracer)
    return _som_adv_horiz("x", scheme % 10, uT, deltaT, smV, smO, smTr, xm,
                          torch.ones_like(xm))


def _som_y_plain(cfg: Config, grid: Grid, v, vol, o, sm, scheme: int,
                 deltaT: float):
    """som_y's twin: the Y pass (som.py:216-217) on the X pass's state."""
    vT = v * (grid.dxG * grid.drF[:, None, None] * grid.hFacS)
    _, ym = _cart_masks(cfg, o)
    return _som_adv_horiz("y", scheme % 10, vT, deltaT, vol, o, sm, ym,
                          torch.ones_like(ym))


def _som_r_plain(cfg: Config, grid: Grid, w, tracer, vol, o, sm,
                 scheme: int, deltaT: float):
    """som_r's twin: the vertical limiter (som.py:222-226) and the vertical
    pass of the linear free surface (:228-347) on the Y pass's state, and
    gTracer (:349-351); returns (gTr, sm)."""
    if scheme % 10 == 1:
        new = _limit_1d(o, sm[IZ], sm[IZZ], sm[IXZ], sm[IYZ])
        sm = sm.clone()
        for s, n in zip((IZ, IZZ, IXZ, IYZ), new):
            sm[s] = n
    mC = grid.maskC
    mkm1 = torch.cat([mC[:1], mC[:-1]])
    rT = w * grid.rA
    maskUp = mkm1 * mC

    def shk(a):      # value at k-1
        return torch.cat([a[:1], a[:-1]])

    # fp from cell k through interface k (upward), not maskUp-masked
    wdt = rT * deltaT
    fp, _, alp, _ = _face_fluxes("r", wdt, vol, o, sm, vol, o, sm)

    # fn into cell k from cell k-1 through interface k: the transport masked
    # by maskUp below the surface
    wdt_n = torch.cat([wdt[:1], (maskUp * rT * deltaT)[1:]])
    fnv = torch.clamp(-wdt_n, min=0.0)
    v_km1, o_km1 = shk(vol), shk(o)
    sm_km1 = torch.cat([sm[:, :1], sm[:, :-1]], dim=1)
    aln = fnv / v_km1
    alnq = aln * aln
    aln1 = 1.0 - aln
    fn = {"v": fnv}
    fn["o"] = aln * (o_km1 - aln1 * sm_km1[IZ]
                     + aln1 * (aln1 - aln) * sm_km1[IZZ])
    fn[IZ] = alnq * (sm_km1[IZ] - 3.0 * aln1 * sm_km1[IZZ])
    fn[IZZ] = aln * alnq * sm_km1[IZZ]
    fn[IX] = aln * (sm_km1[IX] - aln1 * sm_km1[IXZ])
    fn[IY] = aln * (sm_km1[IY] - aln1 * sm_km1[IYZ])
    fn[IXZ] = alnq * sm_km1[IXZ]
    fn[IYZ] = alnq * sm_km1[IYZ]
    fn[IXX] = aln * sm_km1[IXX]
    fn[IYY] = aln * sm_km1[IYY]
    fn[IXY] = aln * sm_km1[IXY]
    # the surface (k = 0, linear free surface): cell 0 itself, no
    # z-structure
    aln0 = fnv[0] / vol[0]
    surface = {"o": aln0 * o[0], IZ: 0.0, IZZ: 0.0, IXZ: 0.0, IYZ: 0.0,
               **{s: aln0 * sm[s][0] for s in (IX, IY, IXX, IYY, IXY)}}
    for key, val in surface.items():
        fn[key] = fn[key].clone()
        fn[key][0] = val
    aln = aln.clone()
    aln[0] = aln0

    def shkp(a):     # value at interface k+1, 0 past the bottom
        return torch.cat([a[1:], torch.zeros_like(a[:1])])

    # update only the interior columns (GAD.h:108 iMinAdvR=1..sNx)
    upd = grid.maskInC
    A, AA, semis, passives = _ROLES["r"]
    # sweep 1
    alf1 = 1.0 - shkp(aln) - alp
    alf1q = alf1 * alf1
    alpmn = alp - shkp(aln)
    v1 = vol - shkp(fn["v"]) - fp["v"]
    o1 = o - shkp(fn["o"]) - fp["o"]
    sm1 = {}
    sm1[A] = alf1q * (sm[A] - 3.0 * alpmn * sm[AA])
    sm1[AA] = alf1 * alf1q * sm[AA]
    for _, c in semis:
        sm1[c] = alf1q * sm[c]
    for m, _ in semis:
        sm1[m] = sm[m] - shkp(fn[m]) - fp[m]
    for p in passives:
        sm1[p] = sm[p] - shkp(fn[p]) - fp[p]
    # sweep 2
    v2 = v1 + shkp(fp["v"]) + fn["v"]
    alfp = shkp(fp["v"]) / v2
    alfn = fn["v"] / v2
    alf1 = 1.0 - alfp - alfn
    alp1 = 1.0 - alfp
    aln1 = 1.0 - alfn
    alpmn = alfp - alfn
    locTp = alfp * o1 - alp1 * shkp(fp["o"])
    locTn = alfn * o1 - aln1 * fn["o"]
    sm2 = {}
    sm2[AA] = (alf1 * alf1 * sm1[AA] + alfp * alfp * shkp(fp[AA])
               + alfn * alfn * fn[AA]
               - 5.0 * (-alpmn * alf1 * sm1[A] + alfp * alp1 * shkp(fp[A])
                        - alfn * aln1 * fn[A]
                        + 2.0 * alfp * alfn * o1 + (alp1 - alfp) * locTp
                        + (aln1 - alfn) * locTn))
    for m, c in semis:
        sm2[c] = (alf1 * sm1[c] + alfp * shkp(fp[c]) + alfn * fn[c]
                  + 3.0 * (alpmn * sm1[m] - alp1 * shkp(fp[m])
                           + aln1 * fn[m]))
    sm2[A] = (alf1 * sm1[A] + alfp * shkp(fp[A]) + alfn * fn[A]
              + 3.0 * (locTp - locTn))
    o2 = o1 + shkp(fp["o"]) + fn["o"]
    for m, _ in semis:
        sm2[m] = sm1[m] + shkp(fp[m]) + fn[m]
    for p in passives:
        sm2[p] = sm1[p] + shkp(fp[p]) + fn[p]

    vol = upd * v2 + (1.0 - upd) * vol
    o = upd * o2 + (1.0 - upd) * o
    sm = torch.stack([upd * sm2[s] + (1.0 - upd) * sm[s]
                      for s in range(NSOM)])
    gTr = _div((o - tracer * vol) * grid.recip_rA
               * grid.recip_drF[:, None, None] * grid.recip_hFacC, deltaT)
    return gTr, sm


def _som_plain(cfg: Config, grid: Grid, u, v, w, tracer, smTr, scheme: int,
               deltaT: float):
    """The kernel's twin, pass by pass: (gTr, sm')."""
    global plain_calls
    plain_calls += 1
    vol, o, sm = _som_x_plain(cfg, grid, u, tracer, smTr, scheme, deltaT)
    vol, o, sm = _som_y_plain(cfg, grid, v, vol, o, sm, scheme, deltaT)
    return _som_r_plain(cfg, grid, w, tracer, vol, o, sm, scheme, deltaT)


# the fields of som.cu:SomArgs, in its order
_GRID3 = ("hFacW", "hFacS", "hFacC", "maskC", "recip_hFacC")
_GRID2 = ("dyG", "dxG", "rA", "recip_rA", "maskInC")
_GRID1 = ("drF", "recip_drF")


def som_sweeps(cfg: Config, grid: Grid, u, v, w, tracer, smTr, scheme: int,
               deltaT: float, add=None):
    """The three passes on the card: a list of (name, launch, the pass's
    outputs), in the order they must run. som_x writes (vol, o, sm) from
    the tracer and smTr, som_y the same from som_x's, som_r (gTr, sm')
    from som_y's, gTr + add with add."""
    nr, nyp, nxp = tracer.shape
    ins3 = dict(uVel=u, vVel=v, wVel=w, tracer=tracer,
                **{n: getattr(grid, n) for n in _GRID3})
    ins2 = {n: getattr(grid, n) for n in _GRID2}
    ins1 = {n: getattr(grid, n) for n in _GRID1}
    x = [torch.empty_like(tracer), torch.empty_like(tracer),
         torch.empty_like(smTr)]
    y = [torch.empty_like(t) for t in x]
    r = [torch.empty_like(tracer), torch.empty_like(smTr)]
    kernels.check_tensors(tracer.dtype, **ins3, **ins2, **ins1, smTr=smTr,
                          volX=x[0], oX=x[1], smX=x[2], volY=y[0], oY=y[1],
                          smY=y[2], gTr=r[0], smNew=r[1],
                          **({} if add is None else {"add": add}))
    for name, t in ins3.items():
        kernels.check_shape(name, t, (nr, nyp, nxp))
    if add is not None:
        kernels.check_shape("add", add, (nr, nyp, nxp))
    for name, t in ins2.items():
        kernels.check_shape(name, t, (nyp, nxp))
    for name, t in ins1.items():
        kernels.check_shape(name, t, (nr,))
    kernels.check_shape("smTr", smTr, (NSOM, nr, nyp, nxp))
    named = {**ins3, **ins2, **ins1}
    table = kernels.pointer_table(list(named.values()))

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    def sweep(name, state_in, sm_in, outs):
        vol_in, o_in = state_in
        if name == "som_r":
            vol_out = o_out = None
            (gTr, sm_out), addend = outs, add
        else:
            (vol_out, o_out, sm_out), gTr, addend = outs, None, None

        def run():
            kernels.launch(name, tracer.dtype, table, len(table),
                           ptr(vol_in), ptr(o_in), ptr(sm_in), ptr(vol_out),
                           ptr(o_out), ptr(sm_out), ptr(gTr), ptr(addend),
                           nr, nyp, nxp, scheme % 10, float(deltaT))
        return name, run, outs

    return [sweep("som_x", (None, None), smTr, x),
            sweep("som_y", x[:2], x[2], y),
            sweep("som_r", y[:2], y[2], r)]


def som_advect(cfg: Config, grid: Grid, u, v, w, tracer, smTr, scheme: int,
               deltaT: float, impl: str = None, add=None):
    """gad_som_advect.F (som.py:188-352): (gTracer, smTr') for a tracer
    [nr, nyp, nxp] and its moments smTr [9, nr, nyp, nxp], every cell of
    the padded arrays, gTracer + add with add (the tracer's other
    tendency: som_r adds it as it writes, the twin after); the caller
    stores smTr' and fills its halos at the end of the step."""
    if scheme not in SOM_SCHEMES:
        raise ValueError(f"som_advect: scheme {scheme} is not SOM (80, 81)")
    if any(t is not None and t.requires_grad
           for t in (u, v, w, tracer, smTr, add)):
        raise ValueError("som_advect: an input requires grad; kernel H-SOM "
                         "has no backward kernel")
    if not kernels.use_kernel(tracer, impl):
        gSom, sm = _som_plain(cfg, grid, u, v, w, tracer, smTr, scheme,
                              deltaT)
        return (gSom if add is None else gSom + add), sm
    sweeps = som_sweeps(cfg, grid, u, v, w, tracer, smTr, scheme, deltaT,
                        add)
    for _, run, _ in sweeps:
        run()
    return tuple(sweeps[-1][2])
