"""A small runner for synthetic experiments (mitgcm_tpu/model/
experiment.py:Experiment.run): steps the model and records, per step, the
cg2d diagnostics and the monitor statistics under the JAX runner's keys;
and the restart files (`write_pickup`, `read_pickup`) in the JAX
package's format, so that either package reads the other's pickups."""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.io import mds
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.diag import monitor
from mitgcm_tpu_torch.model import som
from mitgcm_tpu_torch.model import step as step_mod
from mitgcm_tpu_torch.model.ggl90 import GGL90
from mitgcm_tpu_torch.model.kpp import KPP
from mitgcm_tpu_torch.model.seaice import SeaIce
from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo
from mitgcm_tpu_torch.solver.cg2d import CG2DOperator
from mitgcm_tpu_torch.solver.cg3d import CG3DOperator


@dataclass
class Experiment:
    cfg: Config
    grid: Grid
    state: State
    forcing: Forcing
    op: CG2DOperator
    kpp: Optional[KPP] = None      # model/kpp.py:KPP when useKPP
    ggl90: Optional[GGL90] = None  # model/ggl90.py:GGL90 when useGGL90
    impl: Optional[str] = None     # "plain": kernel twins on any device
    cur_iter: Optional[int] = None
    op3: Optional[CG3DOperator] = None   # when nonHydrostatic
    seaice: Optional[SeaIce] = None      # model/seaice.py when useSEAICE

    def monitor_stats(self) -> Dict[str, float]:
        stats = monitor.dynstat(self.cfg, self.grid, self.state)
        if self.seaice is not None:
            stats.update(monitor.seaice_stats(self.cfg, self.grid,
                                              self.state))
        return {k: float(v) for k, v in stats.items()}

    def run(self, n_steps: Optional[int] = None,
            collect_monitor: bool = True) -> List[Dict[str, float]]:
        """Python-loop runner; one record per step, plus iteration 0 when
        collecting monitor statistics; with nonHydrostatic each step's
        record holds the cg3d solve's residuals and iterations too, with
        sea ice the LSR's (ICOUNT1, ICOUNT2) and host reads per Picard
        pass."""
        cfg = self.cfg
        n = cfg.nTimeSteps if n_steps is None else n_steps
        if self.cur_iter is None:
            self.cur_iter = cfg.nIter0
        records = []
        if collect_monitor:
            records.append({"iter": self.cur_iter, **self.monitor_stats()})
        for _ in range(n):
            self.state, diag = step_mod.forward_step(
                cfg, self.grid, self.op, self.state, self.forcing,
                self.cur_iter, impl=self.impl, kpp=self.kpp,
                ggl90=self.ggl90, op3=self.op3, seaice=self.seaice)
            self.cur_iter += 1
            rec = {"iter": self.cur_iter,
                   "cg2d_init_res": float(diag.cg2d_init_res),
                   "cg2d_iters": diag.cg2d_iters,
                   "cg2d_last_res": float(diag.cg2d_last_res)}
            if diag.cg3d_iters is not None:
                rec.update(cg3d_init_res=float(diag.cg3d_init_res),
                           cg3d_iters=diag.cg3d_iters,
                           cg3d_last_res=float(diag.cg3d_last_res),
                           cg3d_host_syncs=diag.cg3d_host_syncs)
            if diag.lsr_iters is not None:
                rec.update(lsr_iters=diag.lsr_iters,
                           lsr_host_syncs=diag.lsr_host_syncs)
            if collect_monitor:
                rec.update(self.monitor_stats())
            records.append(rec)
        return records


# ----------------------------------------------------------------------
# pickup (checkpoint) I/O: mitgcm_tpu/model/experiment.py:write_pickup /
# read_pickup (:1038-1238), reference write_pickup.F / read_pickup.F. One
# MDS multi-record float64 file with a .meta fldList; the JAX package's
# extra Wvel and PmEpR records make a restart bit-exact without
# recomputing w. GGL90's TKE goes into the companion pickup_ggl90
# (ggl90_write_pickup.F), the sea ice into pickup_seaice
# (seaice_write_pickup.F's per-field format, as the JAX package writes it:
# experiment.py:1096-1123, read back as :1314-1360); every other package that has a companion pickup
# is refused by step.check_supported (KPP keeps no state from step to step,
# so it has none). The JAX package's pickups hold neither IDEMIX's energy,
# nor the SOM moments, nor the non-hydrostatic phi_nh and w-tendency
# history, so a restart there resets them to zero; the port refuses
# pickups of those runs instead (`_check_pickup`).
# ----------------------------------------------------------------------

_PICKUP_3D = ["Uvel", "Vvel", "Theta", "Salt",
              "GuNm1", "GvNm1", "GtNm1", "GsNm1"]
_PICKUP_AB3 = ["GuNm2", "GvNm2", "GtNm2", "GsNm2"]
_PICKUP_2D = ["EtaN", "dEtaHdt", "EtaH"]
_TWO_D = {"EtaN", "dEtaHdt", "EtaH", "EtaHnm1", "PmEpR", "Phi_rLow"}
# record name -> State field. 'EtaH' is etaHnm1 in the reference
# (write_pickup.F:360); on the ported paths (linear free surface, no
# exactConserv, no r*) neither etaH nor etaHnm1 ever changes, so the port
# keeps the one field etaH for both.
_FIELD = {"Uvel": "uVel", "Vvel": "vVel", "Theta": "theta", "Salt": "salt",
          "GuNm1": "guNm1", "GvNm1": "gvNm1", "GtNm1": "gtNm1",
          "GsNm1": "gsNm1", "GuNm2": "guNm2", "GvNm2": "gvNm2",
          "GtNm2": "gtNm2", "GsNm2": "gsNm2", "Wvel": "wVel",
          "EtaN": "etaN", "dEtaHdt": "dEtaHdt", "EtaH": "etaH",
          "PmEpR": "PmEpR", "PhiHyd": "totPhiHyd"}


# the EVP stresses' records of pickup_seaice (State.siSigma[0..2])
_SIGMA = ("siSigm1", "siSigm2", "siSigm12")


def _check_pickup(exp: Experiment) -> None:
    """Raise NotImplementedError, naming each, for the state a pickup in
    the JAX package's format would drop: IDEMIX_E, the SOM moments and the
    non-hydrostatic phi_nh, gwNm1 and gwNm2."""
    cfg = exp.cfg
    step_mod.check_supported(cfg, exp.kpp, exp.ggl90, exp.impl, exp.op3,
                             exp.seaice)
    bad = [f"{tr}AdvScheme={s} (the SOM moments)"
           for tr, s in (("temp", cfg.tempAdvScheme),
                         ("salt", cfg.saltAdvScheme))
           if s in som.SOM_SCHEMES]
    if exp.ggl90 is not None and exp.ggl90.p["useIDEMIX"]:
        bad.insert(0, "useIDEMIX (IDEMIX_E)")
    if cfg.nonHydrostatic:
        bad.append("nonHydrostatic (phi_nh, gwNm1, gwNm2)")
    if bad:
        raise NotImplementedError(
            f"pickups: not written or read for {', '.join(bad)}: the JAX "
            "package's pickup format holds no record for them")


def _interior(cfg: Config, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy().astype(np.float64)
    return a[..., cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]


def write_pickup(exp: Experiment, out_dir: str, myIter: int) -> str:
    """Write pickup.<iter10>.data/.meta with the JAX package's field set
    and order (float64 at any working precision, so a float32 round trip
    is exact), pickup_ggl90.<iter10> with GGL90TKE when useGGL90 and
    pickup_seaice.<iter10> when useSEAICE; returns the file root."""
    cfg, st = exp.cfg, exp.state
    _check_pickup(exp)
    flds3d = _PICKUP_3D + (_PICKUP_AB3 if cfg.useAB3 else []) + ["Wvel"]
    flds2d = _PICKUP_2D + ["PmEpR"]
    recs = [_interior(cfg, getattr(st, _FIELD[n])) for n in flds3d]
    recs.append(np.stack([_interior(cfg, getattr(st, _FIELD[n]))
                          for n in flds2d]))
    stack = np.concatenate(recs, axis=0)
    froot = os.path.join(out_dir, "pickup")
    mds.wrmds(froot, stack, itr=myIter, dataprec="float64",
              nrecords=stack.shape[0], fldlist=flds3d + flds2d,
              timestep_number=myIter)
    if cfg.useGGL90:
        tke = _interior(cfg, st.GGL90TKE)
        mds.wrmds(os.path.join(out_dir, "pickup_ggl90"), tke, itr=myIter,
                  dataprec="float64", nrecords=tke.shape[0],
                  fldlist=["GGL90TKE"], timestep_number=myIter)
    if cfg.useSEAICE:
        _write_pickup_seaice(cfg, st, out_dir, myIter)
    return froot


def _write_pickup_seaice(cfg: Config, st: State, out_dir: str,
                         myIter: int) -> None:
    """pickup_seaice.<iter10>: siTICES (one record per category; siTICE
    with one), siAREA, siHEFF, siHSNOW, siUICE and siVICE, then under EVP
    siSigm1, siSigm2 and siSigm12, in the JAX package's order
    (experiment.py:1096-1123; the port holds no ice tracers)."""
    md = st.siTICES.shape[0]
    names = ["siTICES"] if md > 1 else ["siTICE"]
    recs = [_interior(cfg, st.siTICES[i]) for i in range(md)]
    flds = [("siAREA", st.siAREA), ("siHEFF", st.siHEFF),
            ("siHSNOW", st.siHSNOW), ("siUICE", st.uIce),
            ("siVICE", st.vIce)]
    if st.siSigma is not None and st.siSigma.shape[0] == 3:
        flds += list(zip(_SIGMA, st.siSigma))
    for name, fld in flds:
        names.append(name)
        recs.append(_interior(cfg, fld))
    stack = np.stack(recs, axis=0)
    mds.wrmds(os.path.join(out_dir, "pickup_seaice"), stack, itr=myIter,
              dataprec="float64", nrecords=stack.shape[0], fldlist=names,
              timestep_number=myIter)


def read_pickup(exp: Experiment, in_dir: str, myIter: int) -> None:
    """Restore the state from pickup.<iter10> (read_pickup.F), in the
    experiment's dtype and device, and set startFromPickup, nIter0 and
    startTime as the JAX package does. A pickup without Wvel (the
    reference's own) gets w recomputed from the restored velocities
    (initialise_varia.F); one without the *Nm2 records leaves them zero,
    as the reference does after its warning. With useGGL90 the TKE comes
    from pickup_ggl90.<iter10>, which must exist (ggl90_read_pickup.F);
    with useSEAICE the ice from pickup_seaice.<iter10> when it exists
    (seaice_read_pickup.F: siTICE is broadcast to every category; the EVP
    stresses when siSigm1, siSigm2 and siSigm12 are all there), as the JAX
    package reads it."""
    cfg = exp.cfg
    _check_pickup(exp)
    fields, meta = mds.read_mflds(os.path.join(in_dir, "pickup"),
                                  itr=myIter)
    stack = fields["__records__"]
    like = exp.state.etaN

    def pad(a):
        out = np.zeros(a.shape[:-2] + (cfg.ny + 2 * cfg.oly,
                                       cfg.nx + 2 * cfg.olx))
        out[..., cfg.oly:cfg.oly + cfg.ny, cfg.olx:cfg.olx + cfg.nx] = a
        return cyclic_fill_halo(torch.as_tensor(out, dtype=like.dtype,
                                                device=like.device),
                                cfg.oly, cfg.olx)

    vals, off = {}, 0
    for name in meta.get("fldList", _PICKUP_3D + _PICKUP_2D):
        name = name.strip()
        if not name:
            continue
        n = 1 if name in _TWO_D else cfg.nr
        vals[name] = pad(stack[off] if n == 1 else stack[off:off + n])
        off += n
    updates = {_FIELD[n]: vals[n] for n in _PICKUP_3D + ["EtaN"]}
    updates["etaH"] = vals.get("EtaH", vals["EtaN"])
    for name in _PICKUP_AB3 + ["dEtaHdt", "PhiHyd"]:
        if name in vals:
            updates[_FIELD[name]] = vals[name]
    if "Wvel" in vals:
        # the JAX package's own pickups: w and PmEpR as they were
        updates["wVel"] = vals["Wvel"]
        if "PmEpR" in vals:
            updates["PmEpR"] = vals["PmEpR"]
    else:
        w, _ = step_mod.integr_continuity(
            cfg, exp.grid, updates["uVel"], updates["vVel"],
            torch.zeros_like(like))
        updates["wVel"] = cyclic_fill_halo(w, cfg.oly, cfg.olx)
    if cfg.useGGL90:
        gg_root = os.path.join(in_dir, "pickup_ggl90")
        if not os.path.exists(f"{gg_root}.{myIter:010d}.meta"):
            raise FileNotFoundError(
                f"useGGL90 restart needs {gg_root}.{myIter:010d} (refusing "
                "to silently reset GGL90TKE)")
        gfields, _ = mds.read_mflds(gg_root, itr=myIter)
        updates["GGL90TKE"] = pad(gfields["__records__"][:cfg.nr])
    si_root = os.path.join(in_dir, "pickup_seaice")
    if cfg.useSEAICE and os.path.exists(f"{si_root}.{myIter:010d}.meta"):
        sfields, smeta = mds.read_mflds(si_root, itr=myIter)
        sstack = sfields["__records__"]
        md = exp.state.siTICES.shape[0]
        svals, rec = {}, 0
        for name in (n.strip() for n in smeta.get("fldList", [])):
            if not name:
                continue
            n = md if name == "siTICES" else 1
            svals[name] = pad(sstack[rec] if n == 1
                              else sstack[rec:rec + n])
            rec += n
        if "siTICE" in svals:
            updates["siTICES"] = svals["siTICE"].expand(
                (md,) + tuple(svals["siTICE"].shape)).contiguous()
        if "siTICES" in svals:
            updates["siTICES"] = svals["siTICES"]
        for pk, sk in (("siAREA", "siAREA"), ("siHEFF", "siHEFF"),
                       ("siHSNOW", "siHSNOW"), ("siHSALT", "siHSALT"),
                       ("siUICE", "uIce"), ("siVICE", "vIce")):
            if pk in svals:
                updates[sk] = svals[pk]
        if all(k in svals for k in _SIGMA):
            updates["siSigma"] = torch.stack([svals[k] for k in _SIGMA])
    exp.state = dataclasses.replace(exp.state, **updates)
    cfg.startFromPickup = True
    cfg.startTime = cfg.baseTime + myIter * cfg.deltaTClock
    cfg.nIter0 = myIter
    exp.cur_iter = None
