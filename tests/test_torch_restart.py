"""PyTorch port: checkpoint/restart, the twin of tests/test_restart.py. 4
steps == 2 + pickup + 2 bit for bit, for the gyre (AB-2), the vi-gyre
(AB-3, whose pickup carries the *Nm2 records), the kpp-gyre (KPP keeps no
state from step to step, so its pickup is the vi-gyre's, at 16x16x12) and
the ggl90-gyre (whose TKE goes through the companion pickup_ggl90, at
16x16x12) and the os7mp-gyre (the ggl90-gyre with OS7MP tracers on halos
of 4, through pickup and pickup_ggl90) and the ice-gyre (the sea ice
through the companion pickup_seaice, at 16x16x12); the pickup round trip,
in float64 and float32 (pickups are float64); and pickups crossing between
the packages: a pickup written by the JAX package after 2 steps, read by
the port and stepped 2 more, matches JAX's 4 straight steps to 10 digits,
and so does the other way round, for the gyre, the vi-gyre and the
ggl90-gyre (GGL90TKE included); the JAX package's read_pickup takes every
record of the port's pickup_seaice as written. The JAX runs of the vi-gyre
and the ggl90-gyre are evaluated op by op (jax.disable_jit), as in
tests/test_torch_vi_gyre.py, which says why.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mitgcm_tpu.model import experiment as jexp
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.model.experiment import (Experiment, read_pickup,
                                               write_pickup)
from mitgcm_tpu_torch.utils import synthetic as tsyn
from mitgcm_tpu_torch.utils.compare import digits, interior
from test_torch_config import jax_config
from test_torch_ggl90_gyre import jax_experiment, port_experiment

torch.set_num_threads(1)

SIZE = dict(nx=16, ny=16, nr=3)
CONFIGS = {"gyre": tsyn.gyre_config, "vi-gyre": tsyn.vi_gyre_config}
GGL90_SIZE = dict(nx=16, ny=16, nr=12, depth=300.0)
FIELDS = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1", "gvNm1",
          "gtNm1", "gsNm1", "guNm2", "gvNm2", "gtNm2", "gsNm2", "PmEpR",
          "etaH", "dEtaHdt")


def _port(kind, dtype=torch.float64):
    if kind == "ggl90-gyre":
        return port_experiment(tsyn.ggl90_gyre_config(**GGL90_SIZE), dtype)
    if kind == "os7mp-gyre":
        return port_experiment(tsyn.os7mp_gyre_config(**GGL90_SIZE), dtype)
    if kind == "ice-gyre":
        cfg = tsyn.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
        grid, state, forcing, op, kpp, seaice = tsyn.ice_gyre_setup(
            cfg, dtype=dtype, device="cpu")
        return Experiment(cfg, grid, state, forcing, op, kpp=kpp,
                          seaice=seaice)
    if kind == "kpp-gyre":
        cfg = tsyn.kpp_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
        return Experiment(cfg, *tsyn.kpp_gyre_setup(cfg, dtype=dtype,
                                                    device="cpu"))
    cfg = CONFIGS[kind](**SIZE)
    return Experiment(cfg, *tsyn.gyre_setup(cfg, dtype=dtype, device="cpu"))


def _jax(kind):
    if kind == "ggl90-gyre":
        e = _port(kind)
        return jax_experiment(e.cfg, (e.grid, e.state, e.forcing, e.op,
                                      e.ggl90))
    cfg = jax_config(CONFIGS[kind](**SIZE))
    grid, state, forcing, op = jsyn.gyre_setup(cfg, dtype=jnp.float64)
    return jexp.Experiment(cfg=cfg, grid=grid, state=state, forcing=forcing,
                           op=op)


def _jax_mode(kind):
    return (jax.disable_jit() if kind in ("vi-gyre", "ggl90-gyre")
            else contextlib.nullcontext())


ICE_FIELDS = ("uIce", "vIce", "siAREA", "siHEFF", "siHSNOW", "siTICES")


def _fields(kind):
    if kind == "ice-gyre":
        return FIELDS + ICE_FIELDS
    return FIELDS + (("GGL90TKE",) if kind in ("ggl90-gyre", "os7mp-gyre")
                     else ())


def _same(a, b, names, ol=2):
    differ = [n for n in names
              if not torch.equal(getattr(a, n)[..., ol:-ol, ol:-ol],
                                 getattr(b, n)[..., ol:-ol, ol:-ol])]
    assert not differ, f"differ after restart: {differ}"


@pytest.mark.parametrize("kind", ["gyre", "vi-gyre", "kpp-gyre",
                                  "ggl90-gyre", "os7mp-gyre", "ice-gyre"])
def test_2plus2(kind, tmp_path):
    e4 = _port(kind)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = _port(kind)
    e2.run(n_steps=2, collect_monitor=False)
    write_pickup(e2, str(tmp_path), myIter=2)
    e22 = _port(kind)
    read_pickup(e22, str(tmp_path), myIter=2)
    assert e22.cfg.startFromPickup and e22.cfg.nIter0 == 2
    recs = e22.run(n_steps=2, collect_monitor=False)
    assert [r["iter"] for r in recs] == [3, 4]
    _same(e4.state, e22.state, _fields(kind), ol=e4.cfg.olx)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pickup_roundtrip(dtype, tmp_path):
    e = _port("vi-gyre", dtype)
    e.run(n_steps=3, collect_monitor=False)
    froot = write_pickup(e, str(tmp_path), myIter=3)
    with open(f"{froot}.0000000003.meta") as f:
        meta = f.read()
    assert "'float64'" in meta and "GuNm2" in meta and "Wvel" in meta
    e2 = _port("vi-gyre", dtype)
    read_pickup(e2, str(tmp_path), myIter=3)
    _same(e.state, e2.state, FIELDS)


def test_ggl90_restart_needs_its_pickup(tmp_path):
    """A GGL90 restart without pickup_ggl90 is refused, not reset."""
    e = _port("ggl90-gyre")
    e.run(n_steps=1, collect_monitor=False)
    write_pickup(e, str(tmp_path), myIter=1)
    (tmp_path / "pickup_ggl90.0000000001.meta").unlink()
    with pytest.raises(FileNotFoundError, match="pickup_ggl90"):
        read_pickup(_port("ggl90-gyre"), str(tmp_path), myIter=1)


@pytest.fixture(scope="module", params=["gyre", "vi-gyre", "ggl90-gyre"])
def jax_reference(request, tmp_path_factory):
    """JAX's 4 straight steps, with its pickup written after step 2."""
    kind = request.param
    pickup_dir = str(tmp_path_factory.mktemp(f"jax_pickup_{kind}"))
    e = _jax(kind)
    with _jax_mode(kind):
        e.run(n_steps=2, collect_monitor=False)
        jexp.write_pickup(e, pickup_dir, myIter=2)
        e.run(n_steps=2, collect_monitor=False)
    return kind, pickup_dir, e.state


def _close(got_state, want_state, to_numpy, kind):
    names = ("uVel", "vVel", "theta", "salt", "etaN")
    for name in names + _fields(kind)[len(FIELDS):]:
        d = digits(interior(to_numpy(getattr(got_state, name)), 2),
                   interior(np.asarray(getattr(want_state, name)), 2))
        assert d >= 10, (name, d)


def test_jax_pickup_read_by_port(jax_reference):
    kind, pickup_dir, want = jax_reference
    e = _port(kind)
    read_pickup(e, pickup_dir, myIter=2)
    e.run(n_steps=2, collect_monitor=False)
    _close(e.state, want, lambda t: t.numpy(), kind)


def test_port_pickup_read_by_jax(jax_reference, tmp_path):
    kind, _, want = jax_reference
    e = _port(kind)
    e.run(n_steps=2, collect_monitor=False)
    write_pickup(e, str(tmp_path), myIter=2)
    j = _jax(kind)
    jexp.read_pickup(j, str(tmp_path), myIter=2)
    # the JAX reader takes every record as the port wrote it
    for name in _fields(kind):
        assert np.array_equal(
            np.asarray(getattr(j.state, name))[..., 2:-2, 2:-2],
            getattr(e.state, name)[..., 2:-2, 2:-2].numpy()), name
    with _jax_mode(kind):
        j.run(n_steps=2, collect_monitor=False)
    _close(j.state, want, np.asarray, kind)


def test_port_seaice_pickup_read_by_jax(tmp_path):
    """The JAX package's read_pickup takes the port's pickup_seaice: every
    ice field (the 7 categories' TICES included) as the port wrote it."""
    from test_torch_ice_gyre import jax_objects

    e = _port("ice-gyre")
    e.run(n_steps=2, collect_monitor=False)
    write_pickup(e, str(tmp_path), myIter=2)
    cfg = tsyn.ice_gyre_config(nx=16, ny=16, nr=12, depth=300.0)
    j = jax_objects(cfg, tsyn.ice_gyre_setup(cfg, dtype=torch.float64,
                                             device="cpu"))
    jexp.read_pickup(j, str(tmp_path), myIter=2)
    assert e.state.siTICES.shape[0] == 7
    for name in _fields("ice-gyre"):
        assert np.array_equal(
            np.asarray(getattr(j.state, name))[..., 2:-2, 2:-2],
            getattr(e.state, name)[..., 2:-2, 2:-2].numpy()), name
