"""Carry the JAX package's objects across: the Grid, State, Forcing and
CG2DOperator of mitgcm_tpu, given as dicts of numpy arrays (one entry per
field, `np.asarray(leaf)`), become the port's objects on a given device and
dtype. Fields the port does not hold are ignored, so both packages can step
from identical inputs."""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch


def arrays_of(obj) -> dict:
    """Dict of numpy arrays from a dataclass or NamedTuple of array leaves
    (the JAX package's Grid, State, Forcing, CG2DOperator); leaves that
    are None or not arrays are left out."""
    items = (obj._asdict().items() if hasattr(obj, "_asdict")
             else ((f.name, getattr(obj, f.name))
                   for f in dataclasses.fields(obj)))
    return {name: np.asarray(leaf) for name, leaf in items
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype")}


def from_arrays(cls, arrays: Mapping[str, np.ndarray],
                dtype=torch.float64, device="cpu"):
    """The port's `cls` (Grid, State, Forcing or CG2DOperator) from a dict
    of numpy arrays holding at least its fields."""
    missing = [f.name for f in dataclasses.fields(cls)
               if f.name not in arrays]
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {missing}")
    return cls(**{f.name: torch.as_tensor(
        np.array(arrays[f.name], order="C"), dtype=dtype, device=device)
                  for f in dataclasses.fields(cls)})
