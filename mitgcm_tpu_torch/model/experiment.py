"""A small runner for synthetic experiments (mitgcm_tpu/model/
experiment.py:Experiment.run): steps the model and records, per step, the
cg2d diagnostics and the monitor statistics under the JAX runner's keys."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from mitgcm_tpu.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.diag import monitor
from mitgcm_tpu_torch.model import step as step_mod
from mitgcm_tpu_torch.solver.cg2d import CG2DOperator


@dataclass
class Experiment:
    cfg: Config
    grid: Grid
    state: State
    forcing: Forcing
    op: CG2DOperator
    impl: Optional[str] = None     # "plain": kernel twins on any device
    cur_iter: Optional[int] = None

    def monitor_stats(self) -> Dict[str, float]:
        stats = monitor.dynstat(self.cfg, self.grid, self.state)
        return {k: float(v) for k, v in stats.items()}

    def run(self, n_steps: Optional[int] = None,
            collect_monitor: bool = True) -> List[Dict[str, float]]:
        """Python-loop runner; one record per step, plus iteration 0 when
        collecting monitor statistics."""
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
                self.cur_iter, impl=self.impl)
            self.cur_iter += 1
            rec = {"iter": self.cur_iter,
                   "cg2d_init_res": float(diag.cg2d_init_res),
                   "cg2d_iters": diag.cg2d_iters,
                   "cg2d_last_res": float(diag.cg2d_last_res)}
            if collect_monitor:
                rec.update(self.monitor_stats())
            records.append(rec)
        return records
