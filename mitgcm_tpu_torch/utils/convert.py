"""Carry the JAX package's objects across: the Grid, State, Forcing and
CG2DOperator of mitgcm_tpu, given as dicts of numpy arrays (one entry per
field, `np.asarray(leaf)`), become the port's objects on a given device and
dtype. Fields the port does not hold are ignored, so both packages can step
from identical inputs; an optional field of the port (State.GGL90TKE,
IDEMIX_E, somT, somS, the non-hydrostatic phi_nh, gwNm1 and gwNm2, the CD
scheme's uVelD, vVelD, uNM1, vNM1 and etaNm1, the
sea ice's uIce, vIce, siAREA, siHEFF, siHSNOW, siHSALT, siTICES, SItracer
and siSigma, thsice's thIceMask, thIceH, thSnowH, thSnowAge, thTsrf,
thTice1, thTice2, thQice1 and thQice2, and Forcing's atmospheric state atemp, aqh, precip, swdown,
lwdown, runoff, wspeed and evap) is carried when the arrays hold it and
left None otherwise. `arrays_of` takes
the port's objects too, so the same fields cross back to the JAX package
(a State's None fields are left out, a zero-size one crosses as it is). A
control vector
or a gradient crosses as one array (`to_tensor`, `to_numpy`); the Shapiro
filter's parameters (Config.shap) as `shap_params`, thsice's
(ThsiceParams) as `thsice_params`."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def arrays_of(obj) -> dict:
    """Dict of numpy arrays from a dataclass or NamedTuple of array leaves
    (the JAX package's Grid, State, Forcing, CG2DOperator, or the port's);
    leaves that are None or not arrays are left out."""
    items = (obj._asdict().items() if hasattr(obj, "_asdict")
             else ((f.name, getattr(obj, f.name))
                   for f in dataclasses.fields(obj)))
    return {name: (to_numpy(leaf) if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf))
            for name, leaf in items
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype")}


def to_tensor(a, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """A numpy (or JAX) array as a C-contiguous tensor of dtype on
    device."""
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype,
                           device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor (a control, a gradient) as a numpy array on the host."""
    return t.detach().cpu().numpy()


def shap_params(p):
    """The port's model/shap_filt.py:ShapParams holding the values of `p`,
    the JAX package's ShapParams (or any object with its fields)."""
    from mitgcm_tpu_torch.model.shap_filt import ShapParams

    return ShapParams(**{f.name: getattr(p, f.name)
                         for f in dataclasses.fields(ShapParams)})


def thsice_params(p):
    """The port's model/thsice.py:ThsiceParams holding the values of `p`,
    the JAX package's ThsiceParams (or any object with its fields)."""
    from mitgcm_tpu_torch.model.thsice import ThsiceParams

    return ThsiceParams(**{f.name: getattr(p, f.name)
                           for f in dataclasses.fields(ThsiceParams)})


def from_arrays(cls, arrays: Mapping[str, np.ndarray],
                dtype=torch.float64, device="cuda"):
    """The port's `cls` (Grid, State, Forcing or CG2DOperator) from a dict
    of numpy arrays holding at least its required fields."""
    fields = dataclasses.fields(cls)
    missing = [f.name for f in fields if f.name not in arrays
               and f.default is dataclasses.MISSING]
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {missing}")
    return cls(**{f.name: to_tensor(arrays[f.name], dtype, device)
                  for f in fields if f.name in arrays})
