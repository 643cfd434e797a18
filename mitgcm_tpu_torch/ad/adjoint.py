"""Adjoint of the stepping loop (mitgcm_tpu/ad/adjoint.py): reverse-mode
autograd through `forward_step` takes the place of jax.grad.

  - taping           -> autograd's saved tensors, shaped by checkpointing
  - nchklev_1/2      -> nested torch.utils.checkpoint over chunks of steps
  - adjoint of cg2d  -> solver/cg2d.py:CG2DSolve (a second solve)
  - adjoint of B, C  -> the backward kernels of model/mom_fluxform.py and
                        model/gad.py on the card, autograd on the CPU

`myIter` stays a Python int: adams_bashforth2 tests it on the host.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from mitgcm_tpu_torch.core.config import Config
from mitgcm_tpu_torch.core.grid import Grid
from mitgcm_tpu_torch.core.state import Forcing, State
from mitgcm_tpu_torch.model import mom_visc
from mitgcm_tpu_torch.model import step as step_mod


def check_adjoint_supported(cfg: Config) -> None:
    """Raise NotImplementedError for the options whose kernels have no
    backward kernel yet (V: vector-invariant momentum, T: implicit
    vertical mixing, R: the nonlinear EOS, K: KPP, G9: GGL90, M, O and P:
    the multi-dimensional advection, W and H-cg3d: the non-hydrostatic
    path, B's free-slip and 3-D Coriolis flags, H-seaice: the sea ice, TH:
    thsice,
    gm_tensor, gm_psi_b, gm_residual_flow and C's GM branch: GM-Redi;
    U: PP81 and MY82, Z: OPPS; CD and G's and B's CD variants: the CD
    scheme, SH-uv and SH-ts: the Shapiro filter; X, Y and B's dissipation
    variant: variable
    and biharmonic viscosity,
    linear and quadratic bottom drag, a bottom without no-slip drag),
    and for AB-3,
    whose gradient is not yet held against the JAX adjoint: the adjoint runs
    the gyre of the forward path's first slice only."""
    off = {
        "vectorInvariantMomentum": cfg.vectorInvariantMomentum,
        "implicitDiffusion": cfg.implicitDiffusion,
        "implicitViscosity": cfg.implicitViscosity,
        f"eosType={cfg.eosType}": cfg.eosType.upper() != "LINEAR",
        "useAB3": cfg.useAB3,
        "useKPP": cfg.useKPP,
        "useGGL90": cfg.useGGL90,
        "useSEAICE": cfg.useSEAICE,
        "useThSIce": cfg.useThSIce,
        "useGMRedi": cfg.useGMRedi,
        "usePP81": cfg.usePP81,
        "useMY82": cfg.useMY82,
        "useOPPS": cfg.useOPPS,
        "useCDscheme": cfg.useCDscheme,
        "useSHAP_FILT": cfg.useSHAP_FILT,
        "nonHydrostatic": cfg.nonHydrostatic,
        "no_slip_sides=F": not cfg.no_slip_sides,
        f"select3dCoriScheme={cfg.select3dCoriScheme}":
            cfg.select3dCoriScheme >= 1,
        "variable viscosity": mom_visc.use_variable_visc(cfg),
        "biharmonic viscosity": mom_visc.use_biharmonic_visc(cfg),
        "useStrainTensionVisc": cfg.useStrainTensionVisc,
        "bottomDragLinear": cfg.bottomDragLinear != 0.0,
        f"selectBotDragQuadr={cfg.selectBotDragQuadr}":
            cfg.selectBotDragQuadr >= 0,
        "no_slip_bottom=F": not cfg.no_slip_bottom,
        # A-exact has no adjoint solve held against JAX yet
        "cg2dExactSums": cfg.cg2dExactSums,
    }
    for tr in ("temp", "salt"):
        for d in ("", "Vert"):
            scheme = getattr(cfg, f"{tr}{d}AdvScheme")
            off[f"{tr}{d}AdvScheme={scheme}"] = scheme not in (None, 2)
    bad = [name for name, is_off in off.items() if is_off]
    if bad:
        raise NotImplementedError(
            f"the adjoint is not ported for: {', '.join(bad)}")


def run_steps(cfg: Config, grid: Grid, op, state: State, forcing: Forcing,
              n_steps: int, checkpoint_chunks: Optional[int] = None,
              step_cost: Optional[Callable] = None, impl: str = None):
    """Run n_steps with adjoint-friendly checkpointing.

    n_steps <= 4: plain steps, every intermediate kept for the backward
    pass. Otherwise the steps are cut into `checkpoint_chunks` chunks
    (default int(sqrt(n))) of ceil(n / chunks) steps: each chunk is a
    checkpoint that keeps only its input state, and each step inside it is
    one again, so peak memory is O(chunk + n/chunk) states plus one step's
    intermediates (adjoint.py:84-93). The last chunk may be shorter: the
    JAX package pads its scan with no-op steps instead.

    step_cost: optional f(state_after_step, myIter) -> 0-d tensor summed
    over the steps (forward_step.F's COST_TILE hook); when given, returns
    (final_state, cost_sum), else the final state.
    """
    check_adjoint_supported(cfg)

    def step(s: State, acc, my_iter: int):
        s = step_mod.forward_step(cfg, grid, op, s, forcing, my_iter,
                                  impl=impl)[0]
        if step_cost is not None:
            acc = acc + step_cost(s, my_iter)
        return s, acc

    acc = torch.zeros((), dtype=state.theta.dtype, device=state.theta.device)
    if n_steps <= 4:
        for i in range(n_steps):
            state, acc = step(state, acc, cfg.nIter0 + i)
        return (state, acc) if step_cost is not None else state

    def chunk(s: State, a, iters):
        for my_iter in iters:
            s, a = checkpoint(step, s, a, my_iter, use_reentrant=False)
        return s, a

    chunks = checkpoint_chunks or max(1, int(math.sqrt(n_steps)))
    chunk_len = -(-n_steps // chunks)
    for c0 in range(0, n_steps, chunk_len):
        iters = range(cfg.nIter0 + c0,
                      cfg.nIter0 + min(c0 + chunk_len, n_steps))
        state, acc = checkpoint(chunk, state, acc, iters,
                                use_reentrant=False)
    return (state, acc) if step_cost is not None else state


# ----------------------------------------------------------------------
# control vector (pkg/ctrl analog)
# ----------------------------------------------------------------------

class Control:
    """A generic 3-D initial-condition control (xx_genarr3d analog): an
    additive perturbation on one state field, masked to wet points."""

    def __init__(self, cfg: Config, grid: Grid, field: str = "theta"):
        self.cfg, self.grid, self.field = cfg, grid, field

    def zero(self, dtype=None, device=None) -> torch.Tensor:
        like = self.grid.maskC
        return torch.zeros(like.shape, dtype=dtype or like.dtype,
                           device=device or like.device)

    def apply(self, state: State, xx) -> State:
        new = getattr(state, self.field) + xx * self.grid.maskC
        return State(**{**state.__dict__, self.field: new})

    def pack(self, xx) -> torch.Tensor:
        """Flat wet-point vector (ctrl_pack.F)."""
        return xx[self.grid.maskC > 0]

    def unpack(self, vec) -> torch.Tensor:
        xx = self.zero(vec.dtype, vec.device)
        xx[self.grid.maskC > 0] = vec
        return xx


# ----------------------------------------------------------------------
# cost functions (pkg/cost analog)
# ----------------------------------------------------------------------

def cost_boxmean_tracer(cfg: Config, grid: Grid, field: str = "theta",
                        box=None, k_range=None) -> Callable:
    """Volume integral of a tracer over a box of the final state
    (tutorial_tracer_adjsens's cost_tracer.F)."""
    oly, olx = cfg.oly, cfg.olx
    vol = grid.rA * grid.drF[:, None, None] * grid.hFacC
    w = torch.zeros_like(vol)
    j0, j1, i0, i1 = box if box else (0, cfg.ny, 0, cfg.nx)
    k0, k1 = k_range if k_range else (0, cfg.nr)
    w[k0:k1, oly + j0:oly + j1, olx + i0:olx + i1] = 1.0
    w = w * (grid.maskC > 0)

    def fc(state: State):
        return torch.sum(getattr(state, field) * vol * w)

    return fc


def make_objective(cfg: Config, grid: Grid, op, forcing: Forcing,
                   state0: State, control: Control, cost_fn: Callable,
                   n_steps: int, checkpoint_chunks: Optional[int] = None,
                   impl: str = None) -> Callable:
    """J(xx): apply the control, run n_steps, evaluate the cost. Its
    gradient is the adjoint model (ADTHE_MAIN_LOOP analog)."""

    def J(xx):
        s = control.apply(state0, xx)
        s = run_steps(cfg, grid, op, s, forcing, n_steps,
                      checkpoint_chunks=checkpoint_chunks, impl=impl)
        return cost_fn(s)

    return J


def adjoint_gradient(objective: Callable, xx):
    """(cost, dJ/dxx): one forward pass and one backward pass."""
    xx = xx.detach().requires_grad_(True)
    with torch.enable_grad():
        fc = objective(xx)
        grad, = torch.autograd.grad(fc, xx)
    return fc.detach(), grad
