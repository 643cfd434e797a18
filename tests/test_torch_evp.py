"""PyTorch port: the EVP sea-ice solver and free drift (model/seaice.py:
SeaIce.evp with the twins of kernel seaice_evp, SeaIce.freedrift with the
twin of kernel seaice_freedrift) against the JAX package's SeaIce.evp and
SeaIce.freedrift on the same seeded ice fields, float64 on the CPU, on the
16x16 ice-gyre grid, on whole padded arrays:
  - the derived EVP parameters of params_from_namelists (alpha, beta,
    nEVPstarSteps, evpTauRelax, deltaTevp) equal JAX's for the four variants;
  - evp for each variant: adaptive EVP (SEAICEaEVPcoeff 0.5), revised EVP
    with alpha = beta = 500, classic EVP (useEVPrev = useEVPstar = F,
    SEAICE_deltaTevp 60 s) and EVP* without revised EVP, plus adaptive EVP
    with a water turning angle and unscaled surface stress: u, v, sigma,
    dwatn and the stress divergence to 12 digits (measured 15.1 or more);
  - freedrift to 12 digits.
JAX is evaluated op by op (jax.disable_jit), as tests/test_torch_ice_gyre.py
does. The subcycles are cut to 30 (classic: the 20 of deltaTdyn /
deltaTevp) here to keep the op-by-op JAX run short; the evp-ice-gyre's 500
are held in tests/test_torch_evp_gyre.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import seaice as jseaice
from mitgcm_tpu_torch.model import seaice as tseaice
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits
from test_torch_config import jax_config
from test_torch_seaice import make

torch.set_num_threads(1)

# SEAICE_PARM01 settings of each EVP variant
VARIANTS = {
    "aEVP": {"SEAICEaEVPcoeff": 0.5, "SEAICEnEVPstarSteps": 30},
    "revised": {"SEAICE_evpAlpha": 500.0, "SEAICEnEVPstarSteps": 30},
    "classic": {"SEAICEuseEVPrev": False, "SEAICEuseEVPstar": False,
                "SEAICE_deltaTevp": 60.0},
    "EVP*": {"SEAICEuseEVPrev": False, "SEAICE_deltaTevp": 60.0,
             "SEAICEnEVPstarSteps": 30},
    "aEVP-turned": {"SEAICEaEVPcoeff": 0.5, "SEAICEnEVPstarSteps": 30,
                    "SEAICE_waterTurnAngle": 25.0,
                    "SEAICEscaleSurfStress": False},
}
EVP_PARAMS = ("useEVP", "evpAlpha", "evpBeta", "nEVPstarSteps",
              "evpTauRelax", "deltaTevp", "useEVPrev", "useEVPstar",
              "aEVPcoeff")
DYN_ARGS = ("uVel0", "vVel0", "press0", "massC", "massU", "massV", "forcex0",
            "forcey0")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_evp_parameters(name):
    cfg = tsyn.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    nml = {**tsyn.ICE_GYRE_SEAICE, **VARIANTS[name]}
    p = tseaice.params_from_namelists(cfg, nml)
    jcfg = jax_config(cfg)
    jp = jseaice.params_from_namelists(jcfg, nml, {})
    assert p.useEVP
    for key in EVP_PARAMS:
        assert getattr(p, key) == getattr(jp, key), key


def _inputs(ts, field):
    mU, mV, hm = ts.seaiceMaskU, ts.seaiceMaskV, ts.HEFFM
    ice = {"uIce": field(-0.2, 0.2, mU), "vIce": field(-0.2, 0.2, mV),
           "AREA": field(0.0, 1.0, hm), "HEFF": field(0.0, 3.0, hm),
           "HSNOW": field(0.0, 0.5, hm)}
    sigma = np.stack([field(-1e3, 1e3, hm), field(-1e3, 1e3, hm),
                      field(-1e3, 1e3)])
    massU = field(0.0, 3e3, mU)
    massU[::3, ::2] = 0.0       # cells without ice mass: locMaskU = 0
    args = {"uVel0": field(-0.3, 0.3), "vVel0": field(-0.3, 0.3),
            "press0": field(0.0, 4e4, hm), "massC": field(1e3, 3e3, hm),
            "massU": massU, "massV": field(0.0, 3e3, mV),
            "forcex0": field(-1.0, 1.0), "forcey0": field(-1.0, 1.0)}
    return ice, sigma, args


@pytest.mark.parametrize("name", list(VARIANTS))
def test_evp_against_jax(name):
    ts, js, field = make(**VARIANTS[name])
    ice, sigma, args = _inputs(ts, field)
    tice = ts.init_state()._replace(
        **{k: torch.as_tensor(v) for k, v in ice.items()},
        sigma=torch.as_tensor(sigma))
    jice = js.init_state()._replace(
        **{k: jnp.asarray(v) for k, v in ice.items()},
        sigma=jnp.asarray(sigma))
    got = ts.evp(tice, *[torch.as_tensor(args[k]) for k in DYN_ARGS])
    with jax.disable_jit():
        want = js.evp(jice, None, *[jnp.asarray(args[k]) for k in DYN_ARGS])
    assert got[3].shape == (3,) + tuple(tice.uIce.shape)
    for out, a, b in zip(("uIce", "vIce", "dwatn", "sigma", "divX", "divY"),
                         got, want):
        assert digits(a.numpy(), np.asarray(b)) >= 12, out
    # the stresses moved, and the variant's branches ran
    assert not np.array_equal(got[3].numpy(), sigma)


def test_freedrift_against_jax():
    ts, js, field = make(SEAICEuseFREEDRIFT=True)
    assert ts.p.useFreeDrift and not ts.p.useEVP
    heff = field(0.0, 3.0, ts.HEFFM)
    heff[::4, ::3] = 0.0        # no ice: the solve's zero branches
    args = {"uVel0": field(-0.3, 0.3), "vVel0": field(-0.3, 0.3),
            "forcex0": field(-1.0, 1.0), "forcey0": field(-1.0, 1.0)}
    args["forcex0"][1::5, ::2] = 0.0
    tice = ts.init_state()._replace(HEFF=torch.as_tensor(heff))
    jice = js.init_state()._replace(HEFF=jnp.asarray(heff))
    keys = ("uVel0", "vVel0", "forcex0", "forcey0")
    got = ts.freedrift(tice, *[torch.as_tensor(args[k]) for k in keys])
    with jax.disable_jit():
        want = js.freedrift(jice, *[jnp.asarray(args[k]) for k in keys])
    for out, a, b in zip(("uIce", "vIce"), got, want):
        assert digits(a.numpy(), np.asarray(b)) >= 12, out
    assert float(got[0].abs().max()) > 0.0
