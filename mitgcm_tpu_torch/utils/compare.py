"""Agreement measures shared by the parity tests and the card smoke run.

Fields are compared on interior cells by max|a-b| / max|b| (the relative
error) and its -log10 (matching digits, 16 when equal). A monitor
statistic is judged against the amplitude of its field: the mean of a
velocity or of eta is a cancellation-prone sum near zero, and an sd of a
constant field is rounding noise, so their errors are taken relative to
max(|stat|, |field max|, |field min|) of the reference record.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np

EQUAL_DIGITS = 16.0


def rel_err(a, b) -> float:
    """max|a-b| / max|b| (0 when equal, inf when b is 0 and a is not)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    diff = float(np.max(np.abs(a - b))) if a.size else 0.0
    if diff == 0.0:
        return 0.0
    scale = float(np.max(np.abs(b)))
    return diff / scale if scale > 0.0 else math.inf


def digits(a, b) -> float:
    """Matching digits -log10(max|a-b| / max|b|), capped at 16."""
    err = rel_err(a, b)
    return EQUAL_DIGITS if err == 0.0 else min(EQUAL_DIGITS,
                                               -math.log10(err))


def interior(a, ol: int) -> np.ndarray:
    """Interior cells of a halo-padded field (numpy or torch)."""
    a = np.asarray(a.cpu() if hasattr(a, "cpu") else a)
    return a[..., ol:a.shape[-2] - ol, ol:a.shape[-1] - ol]


def record_digits(rec: Mapping[str, float], ref: Mapping[str, float]
                  ) -> Dict[str, float]:
    """Matching digits of every float entry of a monitor record against the
    reference record (cg2d_iters and iter are compared for equality by
    the caller, and so are lists such as the LSR's iteration counts); a
    monitor statistic is scaled by its field's largest |max| and |min|."""
    out = {}
    for key, want in ref.items():
        if (key in ("iter", "cg2d_iters") or key not in rec
                or isinstance(want, (list, tuple))):
            continue
        scale = abs(want)
        if key.startswith(("dynstat_", "seaice_")):
            field = key.rsplit("_", 1)[0]
            for ext in ("max", "min"):
                scale = max(scale, abs(ref.get(f"{field}_{ext}", 0.0)))
        diff = abs(rec[key] - want)
        if diff == 0.0:
            out[key] = EQUAL_DIGITS
        elif scale == 0.0:
            out[key] = 0.0
        else:
            out[key] = min(EQUAL_DIGITS, -math.log10(diff / scale))
    return out
