"""PyTorch port: the twins of the mixing glue and the flow set-up against
the JAX package's code, in float64 on the CPU.

Kernel J-uv's twin (model/step.py:kappa_uv: KappaRU/RV on nr + 1 levels,
viscAr alone, with KPP's viscosity blended in, or with GGL90's added)
against JAX's step.py:198-210 with kpp.visc_uv; kernel J-ts's twin
(model/thermodynamics.py:kappa_ts: the tracers' diffusivities with GM's
Kwz and GGL90's diffKr, or KPP's with its nonlocal fluxes) against JAX's
thermodynamics.py:470-540 with tracer_kappa and kpp.ghat_flux; kernel R's
eos_sigma_r twin (thermodynamics.calc_sigmaR) against JAX's calc_sigmaR
for LINEAR, JMD95Z and MDJWF on the static profile and on totPhiHyd;
kernel L's twin (gad.calc_adv_flow) against JAX's; and kernel R's LINEAR
kind (ops/eos.py:find_rho with and without maskC, its tRef and sRef made
from the configuration or held by the port's grid) against JAX's
find_rho(...) * maskC. The same numpy inputs, made from a seed, go
through both, on the ggl90-gyre's stretched levels cut to 12 x 20 x 4 and
10 x 40 x 12 cells, with a shelf, a bank and partial bottom cells. Each
twin keeps JAX's operation order: every output is bit-equal to JAX's (the
nonlinear equations of state, whose square roots may round apart, to 12
digits or more). Also: viscAr alone and the background diffusivity alone
are fills that run no twin in place of a kernel; find_rho and calc_sigmaR
refuse grad for the nonlinear kinds alike and differentiate the LINEAR
kind; kernels.TwinVJP passes an input through and a None output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from mitgcm_tpu.core.grid import build_grid as jbuild_grid
from mitgcm_tpu.model import gad as jgad
from mitgcm_tpu.model import kpp as jkpp
from mitgcm_tpu.model import thermodynamics as jth
from mitgcm_tpu.ops import eos as jeos
from mitgcm_tpu_torch import kernels
from mitgcm_tpu_torch.core.grid import Grid, build_grid as tbuild_grid
from mitgcm_tpu_torch.model import gad as tgad
from mitgcm_tpu_torch.model import step as tstep
from mitgcm_tpu_torch.model import thermodynamics as tth
from mitgcm_tpu_torch.ops import eos as teos
from mitgcm_tpu_torch.utils import convert
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config

torch.set_num_threads(1)

# (ny, nx, nr)
SHAPES = ((12, 20, 4), (10, 40, 12))
KAPPA_TS_VARIANTS = ("background", "GM", "GGL90", "GGL90+GM", "KPP",
                     "KPP+GM")


def _case(ny, nx, nr, built=False, **kw):
    """(cfg, jcfg, JAX grid, port grid, rng) of the ggl90-gyre's basin cut
    to ny x nx x nr (hFacMin 0.1), with a 120 m shelf along the west, a
    200 m bank and a partial bottom cell in one row; the port's grid
    carried from the JAX package's or, when built, its own build_grid's
    (which also holds tRef and sRef)."""
    cfg = tsyn.ggl90_gyre_config(nx=nx, ny=ny, nr=nr, depth=300.0,
                                 hFacMin=0.1, **kw)
    bathy = np.full((ny, nx), -sum(cfg.delR))
    bathy[:, :3] = -120.0
    bathy[2:5, nx // 2:nx // 2 + 4] = -200.0
    bathy[ny // 2, 4:nx - 4] = -sum(cfg.delR) + 0.4 * cfg.delR[-1]
    bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
    jgrid = jbuild_grid(jax_config(cfg), bathy=bathy, dtype=jnp.float64)
    tgrid = convert.from_arrays(Grid, convert.arrays_of(jgrid), device="cpu")
    if built:
        tgrid = tbuild_grid(cfg, bathy=bathy, device="cpu")
        assert torch.equal(tgrid.tRef, torch.tensor(cfg.tRef,
                                                    dtype=torch.float64))
    hfac = tgrid.hFacC.numpy()
    assert ((hfac > 0) & (hfac < 1)).any() and (hfac == 0).any()
    return cfg, jax_config(cfg), jgrid, tgrid, np.random.default_rng(
        ny * 100 + nx + nr)


def _same(got, want, label):
    """Bit-equal, None where JAX has none."""
    if want is None:
        assert got is None, label
        return
    got, want = got.numpy(), np.asarray(want)
    assert digits(got, want) >= 12, label
    assert np.array_equal(got, want), f"{label}: not bit-equal"


@pytest.mark.parametrize("ny,nx,nr", SHAPES)
@pytest.mark.parametrize("mode", ("viscAr", "KPP", "GGL90"))
def test_kappa_uv(ny, nx, nr, mode):
    cfg, jcfg, jgrid, tgrid, rng = _case(ny, nx, nr)
    shape = tgrid.hFacC.shape
    kshape = (nr + 1,) + tuple(shape[1:])
    az = np.abs(rng.standard_normal(shape)) * 2e-3
    visc = [np.abs(rng.standard_normal(shape)) * 1e-2 for _ in range(2)]
    kU = jnp.full(kshape, cfg.viscAr, jnp.float64)
    kV = jnp.full(kshape, cfg.viscAr, jnp.float64)
    kpp_fields = ggl90_fields = None
    if mode == "KPP":
        nkU, nkV = jkpp.visc_uv(jcfg, jgrid, {"viscAz": jnp.asarray(az)},
                                kU[:nr], kV[:nr])
        kU, kV = kU.at[:nr].set(nkU), kV.at[:nr].set(nkV)
        kpp_fields = {"viscAz": torch.from_numpy(az)}
    elif mode == "GGL90":
        kU = kU.at[:nr].add(jnp.asarray(visc[0]) - cfg.viscAr)
        kV = kV.at[:nr].add(jnp.asarray(visc[1]) - cfg.viscAr)
        ggl90_fields = {"viscArU": torch.from_numpy(visc[0]),
                        "viscArV": torch.from_numpy(visc[1])}
    got = tstep.kappa_uv(cfg, tgrid, kpp_fields, ggl90_fields)
    for name, g, w in zip(("KappaRU", "KappaRV"), got, (kU, kV)):
        _same(g, w, name)
    if mode == "KPP":     # both sides of the max occur
        assert (np.asarray(kU)[:nr] > cfg.viscAr).any()
        assert (np.asarray(kU)[:nr] == cfg.viscAr).any()


@pytest.mark.parametrize("ny,nx,nr", SHAPES)
@pytest.mark.parametrize("variant", KAPPA_TS_VARIANTS)
def test_kappa_ts(ny, nx, nr, variant):
    cfg, jcfg, jgrid, tgrid, rng = _case(ny, nx, nr)
    shape = tgrid.hFacC.shape
    s2 = shape[1:]
    kpp, gm, g9 = (variant.startswith("KPP"), variant.endswith("GM"),
                   variant.startswith("GGL90"))
    m = tgrid.maskC.numpy()
    Kwz = np.abs(rng.standard_normal(shape)) * 1e-3 * m
    diffKr = np.abs(rng.standard_normal(shape)) * 1e-3
    diffKzT, diffKzS = (np.abs(rng.standard_normal(shape)) * 1e-2
                        for _ in range(2))
    ghat = rng.standard_normal(shape) * 10.0
    frac = rng.random(s2)
    sfT, sfS = (rng.standard_normal(s2) * 1e-4 * m[0] for _ in range(2))
    Qsw = -100.0 * (1.0 + rng.random(s2)) * m[0]
    maskUp = tgad.calc_adv_flow(tgrid, *[torch.zeros(
        shape, dtype=torch.float64)] * 3).maskUp
    jgm = SimpleNamespace(Kwz=jnp.asarray(Kwz)) if gm else None
    dfT = dfS = None
    if kpp:
        # thermodynamics.py:470-496, 524-533 of the JAX package
        recip_Cp = 1.0 / cfg.HeatCapacity_Cp
        qswT = (-jnp.asarray(Qsw) * recip_Cp * (1.0 / cfg.rhoConst)
                * (1.0 - jnp.asarray(frac)))
        jmaskUp = jnp.asarray(maskUp.numpy())
        dfT = jkpp.ghat_flux(jcfg, jgrid, jnp.asarray(diffKzT),
                             jnp.asarray(ghat), jnp.asarray(sfT), qswT,
                             jmaskUp)
        dfS = jkpp.ghat_flux(jcfg, jgrid, jnp.asarray(diffKzS),
                             jnp.asarray(ghat), jnp.asarray(sfS),
                             0.0 * jnp.asarray(sfS), jmaskUp)
        kapT, kapS = jnp.asarray(diffKzT), jnp.asarray(diffKzS)
        if gm:
            kapT = kapT + jgm.Kwz * jgrid.maskInC
            kapS = kapS + jgm.Kwz * jgrid.maskInC
    else:
        kapT = jth.tracer_kappa(jcfg, jgrid, None, cfg.diffKrT, jnp.float64,
                                gm_tensor=jgm)
        kapS = jth.tracer_kappa(jcfg, jgrid, None, cfg.diffKrS, jnp.float64,
                                gm_tensor=jgm)
        if g9:
            kapT = kapT + (jnp.asarray(diffKr) - cfg.diffKrS)
            kapS = kapS + (jnp.asarray(diffKr) - cfg.diffKrS)
    t = torch.from_numpy
    kpp_fields = (dict(diffKzT=t(diffKzT), diffKzS=t(diffKzS), ghat=t(ghat),
                       frac=t(frac)) if kpp else None)
    got = tth.kappa_ts(
        cfg, tgrid, SimpleNamespace(Qsw=t(Qsw)), t(sfT), t(sfS), maskUp,
        kpp_fields=kpp_fields,
        ggl90_fields={"diffKr": t(diffKr)} if g9 else None,
        gm=SimpleNamespace(Kwz=t(Kwz)) if gm else None)
    for name, g, w in zip(("kapT", "kapS", "dfT", "dfS"), got,
                          (kapT, kapS, dfT, dfS)):
        _same(g, w, f"{variant} {name}")
    if kpp and not gm:    # KPP's own diffusivities, passed through
        assert got[0] is kpp_fields["diffKzT"]


@pytest.mark.parametrize("ny,nx,nr", SHAPES)
@pytest.mark.parametrize("eos,select_p", [("LINEAR", 0), ("JMD95Z", 0),
                                          ("JMD95Z", 2), ("MDJWF", 0),
                                          ("MDJWF", 2)])
def test_sigma_r(ny, nx, nr, eos, select_p):
    cfg, jcfg, jgrid, tgrid, rng = _case(ny, nx, nr, eosType=eos,
                                         selectP_inEOS_Zc=select_p)
    shape = tgrid.hFacC.shape
    m = tgrid.maskC.numpy()
    theta = (np.asarray(cfg.tRef)[:, None, None]
             + 0.5 * rng.standard_normal(shape)) * m
    salt = (np.asarray(cfg.sRef)[:, None, None]
            + 0.05 * rng.standard_normal(shape)) * m
    phi = 2.0 * rng.standard_normal(shape)
    jt, js, jp = map(jnp.asarray, (theta, salt, phi))
    jrho = jeos.find_rho(jcfg, jgrid, jt, js, totPhiHyd=jp) * jgrid.maskC
    want = np.asarray(jth.calc_sigmaR(jcfg, jgrid, jrho, jt, js,
                                      totPhiHyd=jp))
    tt, ts, tp = map(torch.from_numpy, (theta, salt, phi))
    trho = teos.find_rho(cfg, tgrid, tt, ts, totPhiHyd=tp,
                         mask=tgrid.maskC)
    got = tth.calc_sigmaR(cfg, tgrid, trho, tt, ts, totPhiHyd=tp).numpy()
    assert digits(got, want) >= 12
    if eos == "LINEAR":
        assert np.array_equal(got, want)
    assert (want[1:][m[1:] > 0] != 0).any()


@pytest.mark.parametrize("ny,nx,nr", SHAPES)
def test_adv_flow(ny, nx, nr):
    cfg, jcfg, jgrid, tgrid, rng = _case(ny, nx, nr)
    shape = tgrid.hFacC.shape
    u, v = (0.1 * rng.standard_normal(shape) for _ in range(2))
    w = 1e-4 * rng.standard_normal(shape)
    want = jgad.calc_adv_flow(jcfg, jgrid, *map(jnp.asarray, (u, v, w)))
    got = tgad.calc_adv_flow(tgrid, *map(torch.from_numpy, (u, v, w)))
    for name in tgad.AdvFlow._fields:
        _same(getattr(got, name), getattr(want, name), name)


@pytest.mark.parametrize("ny,nx,nr", SHAPES)
@pytest.mark.parametrize("masked", (True, False))
@pytest.mark.parametrize("grid", ("carried", "built"))
def test_find_rho_linear(ny, nx, nr, masked, grid):
    cfg, jcfg, jgrid, tgrid, rng = _case(ny, nx, nr, built=grid == "built",
                                         eosType="LINEAR")
    shape = tgrid.hFacC.shape
    theta = np.asarray(cfg.tRef)[:, None, None] + rng.standard_normal(shape)
    salt = np.asarray(cfg.sRef)[:, None, None] + rng.standard_normal(shape)
    want = jeos.find_rho(jcfg, jgrid, jnp.asarray(theta), jnp.asarray(salt))
    if masked:
        want = want * jgrid.maskC
    got = teos.find_rho(cfg, tgrid, torch.from_numpy(theta),
                        torch.from_numpy(salt),
                        mask=tgrid.maskC if masked else None)
    _same(got, want, "rho")


def test_fills_run_no_twin():
    """viscAr alone and the background diffusivity alone are torch.full
    fills on any device: no kernel replaces them, so no twin runs in place
    of one (chip_smoke.py's launch checks count the twins' calls)."""
    cfg, _, _, tgrid, _ = _case(*SHAPES[0])
    calls = tstep.plain_calls, tth.plain_calls
    kU, kV = tstep.kappa_uv(cfg, tgrid)
    z = torch.zeros_like(tgrid.rA)
    kapT, kapS, dfT, dfS = tth.kappa_ts(cfg, tgrid, SimpleNamespace(Qsw=z),
                                        z, z, None)
    assert (tstep.plain_calls, tth.plain_calls) == calls
    assert bool((kU == cfg.viscAr).all()) and bool((kV == cfg.viscAr).all())
    assert bool((kapT == cfg.diffKrT).all())
    assert bool((kapS == cfg.diffKrS).all())
    assert dfT is None and dfS is None


@pytest.mark.parametrize("fn", ("find_rho", "calc_sigmaR"))
@pytest.mark.parametrize("eos", ("LINEAR", "JMD95Z", "MDJWF"))
def test_eos_grad_rule(fn, eos):
    """find_rho and calc_sigmaR refuse theta that requires grad for the
    nonlinear kinds (kernel R has no backward kernel), and differentiate
    the LINEAR kind (under kernels.TwinVJP on the card)."""
    cfg, _, _, tgrid, rng = _case(*SHAPES[0], eosType=eos)
    shape = tgrid.hFacC.shape
    theta = torch.from_numpy(np.asarray(cfg.tRef)[:, None, None]
                             + rng.standard_normal(shape))
    theta.requires_grad_(True)
    salt = torch.from_numpy(np.asarray(cfg.sRef)[:, None, None]
                            + 0.1 * rng.standard_normal(shape))
    rho = torch.zeros(shape, dtype=torch.float64)

    def call():
        if fn == "find_rho":
            return teos.find_rho(cfg, tgrid, theta, salt, mask=tgrid.maskC)
        return tth.calc_sigmaR(cfg, tgrid, rho, theta, salt)

    if eos != "LINEAR":
        with pytest.raises(ValueError, match="require grad"):
            call()
        return
    (grad,) = torch.autograd.grad(call().sum(), theta)
    mC = tgrid.maskC
    if fn == "find_rho":
        want = -cfg.rhoNil * cfg.tAlpha * mC
    else:   # sigmaR[k] = ... * (rho[k] - rho(theta[k-1])): theta's last
        # level reaches no interface below it
        m_k1 = torch.cat([mC[1:] * mC[:-1], torch.zeros_like(mC[:1])])
        want = (m_k1 * tgrid.recip_drC[1:cfg.nr + 1, None, None]
                * cfg.rkSign * cfg.rhoNil * cfg.tAlpha)
    assert torch.allclose(grad, want, rtol=1e-14, atol=0.0)


def test_twin_vjp_pass_through():
    """kernels.TwinVJP with an input returned as it is and a None output
    (kernel J-ts with KPP and no GM): the forward's values are the
    launch's, the gradient the twin's."""
    a = torch.linspace(-1.0, 1.0, 6, dtype=torch.float64,
                       requires_grad=True)
    b = torch.linspace(0.5, 2.0, 6, dtype=torch.float64, requires_grad=True)

    def twin(x, y):
        return x, x * y, None

    def launch(x, y):
        return x, (x * y).detach().clone(), None

    pa, prod, none = kernels.TwinVJP.apply(launch, twin, a, b)
    assert none is None and torch.equal(pa, a)
    assert pa.data_ptr() == a.data_ptr()
    ga, gb = torch.autograd.grad((2.0 * pa).sum() + (3.0 * prod).sum(),
                                 (a, b))
    assert torch.equal(ga, 2.0 + 3.0 * b) and torch.equal(gb, 3.0 * a)
