"""PyTorch port: its own copies of the JAX package's JAX-free host modules
(core/config.py, core/nml.py, io/mds.py) against the originals, and
`jax_config`, which the other test files use to hand a configuration built
by the port to the JAX package (with its GMParams and ShapParams)."""

import dataclasses

import numpy as np
import pytest

from mitgcm_tpu.core import config as jconfig
from mitgcm_tpu.core import nml as jnml
from mitgcm_tpu.io import mds as jmds
from mitgcm_tpu.model import gmredi as jgmredi
from mitgcm_tpu.model import shap_filt as jshap
from mitgcm_tpu.utils import synthetic as jsyn
from mitgcm_tpu_torch.core import config as tconfig
from mitgcm_tpu_torch.core import nml as tnml
from mitgcm_tpu_torch.io import mds as tmds
from mitgcm_tpu_torch.model import gmredi as tgmredi
from mitgcm_tpu_torch.model import shap_filt as tshap
from mitgcm_tpu_torch.utils import synthetic as tsyn


def jax_config(cfg: tconfig.Config) -> jconfig.Config:
    """The JAX package's Config holding the field values of the port's
    `cfg` (already finalized, so finalize() is not run again); the port's
    GMParams becomes the JAX package's, field by field."""
    values = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    values["extra"] = dict(cfg.extra)
    if isinstance(cfg.gmredi, tgmredi.GMParams):
        values["gmredi"] = jgmredi.GMParams(**_values(cfg.gmredi))
    if isinstance(cfg.shap, tshap.ShapParams):
        values["shap"] = jshap.ShapParams(**_values(cfg.shap))
    return jconfig.Config(**values)


def _values(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_config_fields_and_defaults_match():
    want = [(f.name, f.default) for f in dataclasses.fields(jconfig.Config)]
    got = [(f.name, f.default) for f in dataclasses.fields(tconfig.Config)]
    assert got == want


@pytest.mark.parametrize("extra", [
    {}, dict(eosType="MDJWF", alph_AB=0.5), dict(eosType="JMD95P"),
    dict(deltaTClock=600.0, viscAz=1e-3, rigidLid=True)])
def test_config_finalize_matches(extra):
    """Each package's finalize() derives the same values from the same
    settings; jax_config carries them across unchanged."""
    settings = dict(nx=12, ny=10, nr=3, viscAh=4e2,
                    delR=(100.0, 200.0, 300.0), tRef=(20.0, 15.0, 10.0),
                    usingCartesianGrid=True, **extra)
    settings.setdefault("deltaT", 1200.0)
    want = jconfig.Config(**settings).finalize()
    got = tconfig.Config(**settings).finalize()
    assert _values(got) == _values(want)
    assert _values(jax_config(tsyn.gyre_config(nx=12, ny=10, nr=3))) == \
        _values(jsyn.gyre_config(nx=12, ny=10, nr=3))


NAMELIST = """
# a comment
 &PARM01
 tRef= 3*20., 2*10.,
 viscAr=1.E-4, implicitDiffusion=.TRUE.,
 eosType='JMD95Z',
 &
 &KPP_PARM01
 LimitHblStable=.FALSE.,
 Ricr = 0.25,
 /
"""


GM_PARM01 = {"GM_background_K": 1000.0, "GM_taper_scheme": "dm95",
             "GM_maxSlope": 4e-3, "GM_Kmin_horiz": 100.0, "GM_Scrit": 5e-3,
             "GM_Sd": 5e-4, "GM_AdvForm": True, "GM_isopycK": 500.0}


@pytest.mark.parametrize("group", [GM_PARM01, {}, {"gm_taper_scheme": "ac02"}])
def test_gm_from_namelist_matches(group):
    """Both packages' from_namelist give equal GMParams fields, and
    jax_config hands JAX its own GMParams with them."""
    got = tgmredi.from_namelist(group)
    assert _values(got) == _values(jgmredi.from_namelist(group))
    cfg = tsyn.gyre_config(nx=12, ny=10, nr=3, useGMRedi=True, gmredi=got)
    jgm = jax_config(cfg).gmredi
    assert isinstance(jgm, jgmredi.GMParams)
    assert _values(jgm) == _values(got)
    assert jgm.resolved_isopycK() == got.resolved_isopycK()


def test_gm_from_namelist_refuses_visbeck():
    with pytest.raises(NotImplementedError, match="GM_Visbeck_alpha"):
        tgmredi.from_namelist({"GM_Visbeck_alpha": 0.015})


def test_nml_copy_reads_as_the_original():
    got = tnml.parse_namelist(NAMELIST)
    assert got == jnml.parse_namelist(NAMELIST)
    assert got["KPP_PARM01"]["limithblstable"] is False


@pytest.mark.parametrize("writer,reader", [(tmds, jmds), (jmds, tmds)])
def test_mds_copy_round_trip(writer, reader, tmp_path):
    """A multi-record file written by one package reads back bit for bit
    with the other's reader."""
    rng = np.random.default_rng(3)
    recs = rng.standard_normal((5, 6, 7))
    froot = str(tmp_path / "pickup")
    writer.wrmds(froot, recs, itr=4, dataprec="float64", nrecords=5,
                 fldlist=["A", "B", "C", "D", "E"], timestep_number=4)
    fields, meta = reader.read_mflds(froot, itr=4)
    assert np.array_equal(np.asarray(fields["__records__"]), recs)
    names = [n.strip() for n in meta["fldList"] if n.strip()]
    assert names == ["A", "B", "C", "D", "E"]
