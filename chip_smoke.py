#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mitgcm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [PHASE ...]

With no argument every phase runs; names of PHASES (`gyre` for 3-5,
`adjoint`, `vi`, ..., `thsice` for 22, `exact-ice` for 23) run those alone
after the device and build phases, and the JSON line then lists only
their kernels. Each phase prints its seconds when it ends. Phases, each
printing its own lines; any failure raises and the script exits nonzero
without the final line:
  1. device    : refuse to run without CUDA; print the card's name and
                 power limit (nvidia-smi) and the torch / CUDA versions
  2. build     : compile the kernels of kernels/csrc with nvcc
  3. kernels   : each CUDA kernel against its plain PyTorch twin on the same
                 seeded inputs, at 64x64x4 float64 and 1024x1024x32 float32
                 (the main path's shapes), with error and times; kernel A
                 (cg2d_solve, one cooperative launch a solve) as whole
                 solves against the plain path's host loop, bit for bit (x,
                 the first and last residual, the iterations): from a zero
                 and a nonzero first guess, the min-residual selection on
                 and off, at a cap of 5 iterations, a zero right-hand side;
                 every kernel-path solve runs under
                 torch.cuda.set_sync_debug_mode("error") but for its one
                 read of the iteration count (count_cg2d_reads), so any
                 other host sync inside it fails the run
  4. parity    : 10 steps of the 64x64x4 gyre in float64, kernel path
                 against plain path
  5. full size : the 1024x1024x32 gyre in float32 (deltaT=600): one warm-up
                 step and 5 timed steps through the kernels, with every
                 kernel's launch count (one cg2d_solve launch and one host
                 read a solve), then 2 steps of the plain path
  6. adjoint   : the backward kernels B' and C' against autograd through
                 their plain twins (64x64x4 float64, 1024x1024x32 float32);
                 the glue's backward kernels F', D', E', G', L' and R'
                 against their plain VJPs, bit for bit on every padded cell
                 (64x64x4 float64 with AB-2's and AB-3's cold-start, second
                 and later steps, tracer_step without AB and R' without
                 maskC; 1024x1024x32 float32), each with its device time
                 (20 launches in a CUDA graph), bound and share;
                 grdchk of the 16x16x4 float64 gyre on the kernel path
                 (the set-up of tests/test_adjoint.py), its gradient against
                 the plain path's and against a second kernel-path run; then
                 the gradient of a box cost through 6 checkpointed steps of
                 the 1024x1024x32 float32 gyre, timed against the forward
                 steps alone (medians of 3 runs each), with peak memory and
                 every kernel's launches (those of the first gradient: each
                 backward kernel's exact count, no kernels.TwinVJP backward
                 and no plain fold of a halo fill)
  7. vi-gyre   : the vi-gyre (vector-invariant momentum, implicit vertical
                 viscosity and diffusion, JMD95Z EOS with salt, AB-3):
                 kernels V, T and R against their twins at 64x64x4 float64
                 and 1024x1024x32 float32; 10 float64 steps at 64x64x4,
                 kernel path against plain path; a 2+2 restart through a
                 pickup on the kernel path, bit-equal to 4 straight steps;
                 then the 1024x1024x32 float32 vi-gyre (deltaT=600): one
                 warm-up step and 5 timed steps with the launch counts of V
                 (5), T (20), R (5) and B (0), then 2 plain steps
  8. kpp-gyre  : the vi-gyre with KPP boundary-layer mixing, stretched
                 levels, a mixed layer and a north-south heat flux: kernel
                 K (kpp_pre, kpp_smooth, kpp_col) against its twins at
                 64x64x12 float64 and 1024x1024x32 float32, with kbl
                 identical, and C with KPP's nonlocal flux df; 10 float64
                 steps at 64x64x12, kernel path against plain path; a 2+2
                 restart on the kernel path; then the 1024x1024x32 float32
                 kpp-gyre (deltaT=600): one warm-up step and 5 timed steps
                 with every kernel's launch count (K each step, the plain
                 KPP never), then 2 plain steps
  9. ggl90-gyre: the kpp-gyre's set-up with GGL90 TKE mixing in place of
                 KPP and DST-3 flux-limited tracers (scheme 33) under the
                 multi-dimensional advection: kernel G9 (ggl90_col,
                 ggl90_visc) and kernel M (the X, Y and R sweeps, schemes
                 30, 33 and 77) against their twins at 64x64x12 float64 and
                 1024x1024x32 float32, and C without its advective part; 10
                 float64 steps at 64x64x12, kernel path against plain path;
                 a 2+2 restart through pickup and pickup_ggl90 on the
                 kernel path; then the 1024x1024x32 float32 ggl90-gyre
                 (deltaT=600): one warm-up step and 5 timed steps with every
                 kernel's launch count (G9 and M each step, the plain GGL90
                 and multidim twins never), a profile, then 2 plain steps
 10. high-order advection: the ggl90-gyre's set-up on halos of 4 with the
                 high-order schemes of the multi-dimensional advection:
                 every sweep of kernel O (OS7MP), kernel P (PPM/PQM with
                 the null, monotone and WENO limiters) and kernel M's
                 schemes 1 and 20 and vertical schemes 2, 3 and 4 against
                 its twin sweep on whole arrays at 64x64x12 float64 and
                 1024x1024x32 float32 (bit-equal, NaNs of float32 WENO in
                 the same cells), and at 1024x1024x32 float32 the `+ gTr`
                 addend of the last sweep of M, O, P and H-SOM on the same
                 case, untimed; 10 float64 steps at 64x64x12 of the
                 os7mp-gyre (scheme 7) and of the pqm-gyre (PPM-mono theta,
                 PQM-mono salt), kernel path against plain path, and a 2+2
                 restart of each on the kernel path; then each at
                 1024x1024x32 float32 (deltaT=600): one warm-up step and 5
                 timed steps with every kernel's launch count (O or P each
                 step, M never, the plain twins never), a profile, then 2
                 plain steps
 11. IDEMIX, Langmuir and SOM: kernel H-IDEMIX (idemix_prep, idemix_hdiff,
                 idemix_col), G9's ggl90_col with the IDEMIX and Langmuir
                 flags, and kernel H-SOM (som_x, som_y, som_r, schemes 80
                 and 81) against their twins on whole arrays at 64x64x12
                 float64 with a shelf, a bank and a partial cell, and at
                 1024x1024x32 float32 (bit-equal, SOM's non-finite first
                 padded row and column in the same cells); 10 float64 steps
                 at 64x64x12 of the idemix-gyre (IDEMIX and Langmuir) and of
                 the som-gyre (theta 81, salt 80), kernel path against plain
                 path, and the refusal of their pickups; then each at
                 1024x1024x32 float32 (deltaT=600): one warm-up step and 5
                 timed steps with every kernel's launch count (H-IDEMIX or
                 H-SOM each step, the plain twins never), a profile, then 2
                 plain steps
 12. non-hydrostatic: the nh-convection box (flux-form momentum with
                 free-slip sides and the 3-D Coriolis term, calc_gw and the
                 cg3d solve): kernel W (calc_gw), B's flagged variant and
                 H-cg3d's two passes (cg3d_s_stencil_dot and
                 cg3d_xr_precond, with its `done` word, frozen launches
                 included) against their twins bit
                 for bit at 64x64x12 float64 on a grid with walls, a bank
                 and partial cells and at 1024x1024x50 float32, and the
                 whole cg3d solve kernel path against plain path; 10
                 float64 steps of the 64x64x12 box, kernel path against
                 plain path (16 digits, equal cg2d and cg3d iterations);
                 the refusal of its pickup; then the 1024x1024x50 float32
                 box (deltaT=60): one warm-up step and 5 timed steps with
                 every kernel's launch count (W and B each step, each pass
                 of H-cg3d 8 per batch of iterations and once for the first
                 residual, the plain twins never) and the
                 cg3d host syncs per solve, a profile, then 2 plain steps
 13. sea ice: the ice-gyre (the kpp-gyre made polar under a cold
                 atmosphere with a dynamic-thermodynamic ice cover): each
                 launch of the four sea-ice kernels (seaice_lsr_visc and
                 seaice_lsr_coeffs, the LSR pass's assembly; the half-sweeps
                 of seaice_lsr_tridiag_u/_v and seaice_lsr_check, with their
                 control words, frozen launches included;
                 seaice_advect_x/_y; seaice_thermo) against its twin on
                 whole arrays at 64x64 float64 on 2 x 2 tiles and at
                 1024x1024 float32 on 64 x 64 tiles (bit-equal), a whole LSR
                 loop kernel path against plain path (equal ICOUNTs); 10
                 float64 steps of the 64x64x12 ice-gyre, kernel path against
                 plain path (16 digits, equal cg2d and LSR iterations), a
                 2+2 restart through pickup and pickup_seaice; then the
                 1024x1024x32 float32 ice-gyre (deltaT=600): one warm-up
                 step and 5 timed steps with every kernel's launch count,
                 the LSR iterations and host syncs per Picard pass, the
                 peak memory and the mean AREA after the run, a profile,
                 then 1 plain step
 14. step glue: kernels D (phihyd), E (cg2d_rhs, continuity), F
                 (halo_fill) and G (mom_ab_step, mom_correction,
                 tracer_step) against their twins on whole padded arrays,
                 bit for bit, at 64x64x4 float64 (with AB-2 and AB-3 on the
                 cold-start, second and later steps, and the
                 non-hydrostatic flags on a 64x64x12 box; F also on a halo
                 wider than the interior) and at 1024x1024x32 float32 (the
                 box's E and G at x50), with each kernel's time, its
                 twin's and its bound; a kernel's time is its launch's
                 device time, 20 launches captured in a CUDA graph and
                 replayed, beside a wrapper call's CUDA-event time; F's
                 beside F.pad(mode="circular"), which computes the same
                 fill, timed the same way, and beside both as CUDA-event
                 times
                 (F a launch replayed back to back, F.pad a batch of 20
                 calls); F's device time must not be below its bound, nor
                 slower than F.pad's in 3-D at full size by either
                 timing. F also on an input view whose offset is not a
                 multiple of 16 bytes (every row in scalar cells), bit for
                 bit.
                 Every full-size phase (5, 6, 7-13, 15, 16) asserts the
                 launches of A and D-G on its path (one cg2d_solve launch
                 and one host read a cg2d solve, forward and adjoint) and
                 that no twin of theirs ran
 15. sea ice EVP: the evp-ice-gyre (the ice-gyre under lab_sea/input.hb87's
                 dynamics: adaptive EVP with 500 subcycles, Hibler-Bryan
                 stress coupling): H-seaice EVP's loop (evp_loop: its
                 launches seaice_evp_stress and seaice_evp_uv, the last
                 with the drag and divergence) for the adaptive, revised
                 (alpha = beta = 500), classic and EVP* variants, one
                 subcycle and the whole loop, and seaice_freedrift,
                 against their twins on whole arrays at 64x64 float64 and
                 1024x1024 float32 (bit-equal); 3 float64 steps of the
                 64x64x12 evp-ice-gyre kernel path against plain path
                 (every field bit-equal), a 2+2 restart through
                 pickup_seaice with the EVP stresses, 2 steps of the
                 free-drift ice-gyre kernel path against plain path (every
                 field bit-equal); then the 1024x1024x32
                 float32 evp-ice-gyre (deltaT=600): one warm-up step and 5
                 timed steps with every launch count (500 of each EVP
                 launch a step, no LSR launch, no twin, no host read in
                 the loop), |uIce| and the mean AREA, a profile, then 1
                 plain step held against 1 kernel step from the same state
                 (every ice field, uVel and theta bit-equal)
 16. GM-Redi: the gm-gyre (the kpp-gyre with GM-Redi's skew-flux form,
                 gkw91, GM_NON_UNITY_DIAGONAL, and a temperature front) and
                 the gm-bolus-gyre (the advective form, dm95, GM_ExtraDiag):
                 gm_tensor for every taper, form and nonUnityDiagonal,
                 gm_psi_b for every taper of the bolus form,
                 gm_residual_flow and kernel C's GM branch (scheme 2 and no
                 advection, with and without df, a 3-D and a constant
                 Kux/Kvy, with and without Kuz/Kvz) against their twins at
                 64x64x12 float64 and 1024x1024x32 float32 (bit-equal); 3
                 float64 steps of each 64x64x12 gyre kernel path against
                 plain path (every field bit-equal on the interior), a 2+2
                 restart of the gm-gyre; then each at 1024x1024x32 float32
                 (deltaT=600): one warm-up step and 5 timed steps with
                 every launch count and no twin, the cg2d host syncs, a
                 profile, then 1 plain step held against 1 kernel step
                 from the same state (bit-equal)
 17. mixing glue and flow set-up: kernels J-uv (kappa_uv: with KPP's
                 viscosity, with GGL90's), J-ts (kappa_ts: KPP's nonlocal
                 fluxes, KPP with GM, the background diffusivities with
                 GM's Kwz, GGL90's diffKr or both), L (adv_flow)
                 and R's eos_sigma_r (LINEAR, JMD95Z and MDJWF, on the
                 static profile and on totPhiHyd) and eos_find_rho (LINEAR
                 with and without maskC, JMD95Z and MDJWF with maskC)
                 against their twins on whole padded arrays, bit for bit,
                 at 64x64x12 float64 and 1024x1024x32 float32 on the
                 kpp-gyre's grid, each with its launch's device time (20
                 launches in a CUDA graph), its wrapper call's, its twin's
                 and its bound; every full-size phase (5-13, 15, 16)
                 asserts L's launch once a step, J-uv's and J-ts's once a
                 step on the KPP, GGL90 and GM paths and never on the
                 others (viscAr alone and the background diffusivity are
                 torch.full fills), R's (find_rho and sigmaR) on its
                 path, and that no twin of theirs ran
 18. the last glue: kernels N1 (pre_cg3d, the box's cg3d right-hand
                 side), N2 (cg3d_setup_scale and cg3d_setup_fill, the
                 cg3d solve's set-up, normalised, not normalised and with
                 a right-hand side of zeros), Q
                 (surface_forcing: the gyres' fluxes, and every term with
                 the relaxation under sea ice), S1 (seaice_dynforcing:
                 the ice-gyre's and the evp-ice-gyre's flags) and S2
                 (seaice_ocean_stress: the LSR's, the no-dynamics drag,
                 HB87 with the clip) and the `+ gTr` addend of the last
                 sweep of M, O, P and H-SOM against their twins on whole
                 padded arrays, bit for bit, at 64x64x12 float64 and at
                 full size float32 (the box's 1024x1024x50, the gyres'
                 1024x1024x32; the addend's in phase 10), each row of the
                 JSON line with its launch's device time (20
                 launches in a CUDA graph), its wrapper call's, its
                 twin's and its bound; phases 5-16 assert Q's launch once
                 a step on every path, N1's and N2's once a step (a
                 solve) on the box, S1's and S2's once a step on the ice
                 paths, and that no twin of theirs ran (E's surface term
                 and G's 2-D forcing are held in phase 14)
 19. variable viscosity: the visc-gyre (flux form, Smagorinsky, Leith and
                 biharmonic Leith viscosities under the grid and Reynolds
                 limits, quadratic bottom drag), the visc-vi-gyre (the
                 vi-gyre with them under full Leith) and the st-vi-gyre
                 (the strain-tension form, Smagorinsky): kernels X
                 (mom_calc_visc) and Y (mom_del2uv, both forms) against
                 their twins on whole padded arrays, and B's and V's
                 dissipation variants (mom_fluxform_visc,
                 mom_vecinv_visc, fed X's and Y's twins' fields; every
                 halo output 0) on the interior, bit for bit, at 64x64x4
                 float64 (with further variants: free slip and the 3-D
                 Coriolis term, no biharmonic, constant biharmonic with
                 linear drag, no drag; Leith with quadratic drag, explicit
                 viscosity, the other schemes) and 1024x1024x32 float32,
                 each with its launch's device time (20 launches in a
                 CUDA graph), its wrapper call's, its twin's and its
                 bound; 5 float64 steps of each at 64x64x4, kernel path
                 against plain path; then each at 1024x1024x32 float32
                 (deltaT=600): one warm-up step and 5 timed steps with
                 every launch count (X each step, Y with biharmonic
                 viscosity, B's or V's variant in place of their first
                 ones) and no twin of X, Y or the glue
 20. Richardson-number mixing and OPPS: the pp81-, my82- and opps-gyre
                 (the kpp-gyre with PP81, MY82 or OPPS in place of KPP):
                 kernels U (vertmix_calc, PP81 and MY82) and Z (opps_col)
                 and J-uv's and J-ts's vertmix variants against their
                 twins on whole padded arrays, bit for bit, at 64x64x4
                 float64 (each scheme and Z variant under LINEAR, JMD95Z
                 on the static profile and on totPhiHyd, and MDJWF) and
                 1024x1024x32 float32, each with its launch's device time
                 (20 launches in a CUDA graph), its wrapper call's, its
                 twin's and its bound (Z's the larger of its bytes and
                 the operations of its inputs' live iterations); 5
                 float64 steps of each path at 64x64x12, kernel path
                 against plain path; then each at 1024x1024x32 float32
                 (deltaT=600): one warm-up step and 5 timed steps with
                 every launch count (U, J-uv and J-ts, or Z, once a step)
                 and no twin of U, Z or the glue, and on the opps-gyre Z's
                 plume launches in the cooled north
 21. CD scheme and Shapiro filter: the cd-gyre and cd-vi-gyre (the gyre
                 and the vi-gyre under the CD scheme's Coriolis, tauCD =
                 321428 s) and the shap-gyre (the gyre with the Shapiro
                 filter, 4 index-space passes on u, v, theta and salt):
                 kernels CD (cd_scheme, iteration 0 and later), SH-uv
                 (shap_uv: index space, physical with Shap_uvLength < 0,
                 0, > 0) and SH-ts (shap_ts: index, physical with and
                 without Shap_TrLength, mixed) against their twins on
                 whole padded arrays, and G's, B's and V's CD variants
                 (no 2-D or planetary Coriolis term; B and V on the
                 interior, halo outputs 0), bit for bit, at 64x64x4
                 float64 and float32 and 1024x1024x32 float32, each with
                 its device time (CD and the variants: a launch, 20 in a
                 CUDA graph; SH-uv and SH-ts: a whole filter, all its
                 passes, 5 in a CUDA graph), its wrapper call's, its
                 twin's and its bound; 5 float64 steps of each path at
                 64x64x4, kernel path against plain path; then each at
                 1024x1024x32 float32 (deltaT=600): one warm-up step and 5
                 timed steps with every launch count (CD once a step,
                 SH-uv 4 and SH-ts 8 launches a step) and no twin, and a
                 profile of 2 steps (device busy and idle share)
 22. thsice: the thsice-gyre (the ice-gyre's ocean and atmosphere under
                 Winton's thermodynamic sea ice in place of pkg/seaice):
                 kernel TH (thsice_step) against its twin on every padded
                 cell of its 13 outputs, bit for bit, at 64x64 float64 and
                 1024x1024 float32 on seeded inputs that take every branch
                 of the step (asserted, over the defaults, a daily step and
                 two surface iterations), with its device time (20
                 launches in a CUDA graph, and a launch replayed between
                 CUDA events), its wrapper call's, its twin's and its
                 bound (the larger of its bytes and the operations of its
                 inputs' live surface iterations); 5 float64 steps of the
                 64x64x12 thsice-gyre, kernel path against plain path (15
                 digits, equal cg2d iterations); then the 1024x1024x32
                 float32 thsice-gyre (deltaT=600): one warm-up step and 5
                 timed steps with every launch count (TH once a step, no
                 halo fill of its own) and no twin, the host's load
                 average, new ice in the open south, and a profile of 2
                 steps (TH's device ms, busy and idle share)
 23. exact-ice: the exact-gyre (the gyre with cg2dExactSums on MITgcm
                 tiles of 64 x 64), the sitr-ice-gyre (the ice-gyre with an
                 'age' tracer on HEFF and a 'one' on AREA) and the
                 legacy-ice-gyre (SEAICEadvScheme 2, DIFF1): kernel A-exact
                 (cg2d_solve_exact) as whole solves against its twin at
                 64x64 float64 on 16 x 16 tiles and as two solves capped at
                 3 iterations at 1024x1024 float32 (the twin's ordered dot
                 is sNx*sNy tensor ops a dot), its bound the serial chains'
                 latency and torch.sum's time of one dot beside it;
                 seaice_advect_x/_y with the two tracers, TP
                 (seaice_thermo_tr) and LA (seaice_advect_legacy, with and
                 without diffKh) against their twins on whole arrays, bit
                 for bit, at 64x64 float64 and 1024x1024 float32; 2 or 3
                 float64 steps of each path at 64x64, kernel path against
                 plain path (15 digits, equal iterations, fields bit for
                 bit); then each path at 1024x1024x32 float32
                 (deltaT=600): one warm-up step and 5 timed steps with
                 every launch count and no twin, the host's load average,
                 and a profile of 2 steps (the new kernels' device ms,
                 busy and idle share)
Phases 14 and 18 time only their kernels' JSON rows, at full size; every
other variant there is held bit for bit untimed (PERF.md keeps their
times).
The full-size grids are built once per distinct geometry and shared by
the phases that run it (`shared_grid`); each build and each set-up
prints its seconds.
It prints, last, one line of JSON per kernel (the launches are those of
the main path that runs it: phase 5 for the gyre's forward kernels, phase
6's full-size gradient for B' and C', phase 7's full-size run for V, T
and R, phase 8's for K, J-uv and J-ts, phase 9's for G9 and M, phase
10's os7mp-gyre for O and pqm-gyre for P, phase 11's idemix-gyre for
H-IDEMIX and som-gyre for H-SOM, phase 12's box for W and H-cg3d, phase
13's ice-gyre for the sea ice's, phase 15's evp-ice-gyre for EVP's and
its free-drift run for seaice_freedrift, phase 16's gm-gyre for
gm_tensor and C's GM branch and its gm-bolus-gyre for gm_psi_b and
gm_residual_flow, phase 5's gyre for A, D-G, L and Q, phase 9's
ggl90-gyre for R's sigmaR, phase 12's box for N1 and N2, phase 13's
ice-gyre for S1 and S2, phase 19's paths for X, Y and the dissipation
variants, phase 20's pp81-gyre for U and opps-gyre for Z, phase 21's
cd-gyre for CD and G's and B's CD variants, cd-vi-gyre for V's and
shap-gyre for SH-uv and SH-ts, phase 22's thsice-gyre for TH, phase 23's
exact-gyre for A-exact, sitr-ice-gyre for TP and legacy-ice-gyre for LA),
with the
kernel's time (D-G's from phase 14, J-uv's, J-ts's, L's and sigmaR's
from phase 17 and N1's, N2's, Q's, S1's and S2's from phase 18: a
launch's device time, 20 launches in a CUDA graph, with
the wrapper call's time beside it, and F.pad's beside F's;
A's the launch of a whole solve, with its iterations and its time and
bound an iteration), its plain twin's, and its
bound (the larger of the bytes it must move over 3.35 TB/s and its
estimated operations over 67 TFLOP/s, the H100's float32 peaks; A's
operations are this run's iterations') at the full-size float32 shapes
of its path (1024x1024x32, the box's 1024x1024x50), the card's name and
power limit, and the device line.
"""

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 1234

# kernel -> (source, the fused JAX computation it replaces)
KERNELS = {
    "cg2d_solve": ("mitgcm_tpu_torch/kernels/csrc/cg2d.cu",
                   "mitgcm_tpu/solver/cg2d.py:203"),
    "mom_fluxform": ("mitgcm_tpu_torch/kernels/csrc/mom_fluxform.cu",
                     "mitgcm_tpu/model/mom_fluxform.py:122"),
    "gad_calc_rhs_c2": ("mitgcm_tpu_torch/kernels/csrc/gad_calc_rhs.cu",
                        "mitgcm_tpu/model/gad.py:1038"),
    # the VJPs that jax.grad took of the two fused computations above
    "mom_fluxform_adj": ("mitgcm_tpu_torch/kernels/csrc/mom_fluxform_adj.cu",
                         "mitgcm_tpu/model/mom_fluxform.py:122"),
    "gad_calc_rhs_c2_adj": (
        "mitgcm_tpu_torch/kernels/csrc/gad_calc_rhs_adj.cu",
        "mitgcm_tpu/model/gad.py:1038"),
    # the vi-gyre's kernels
    "mom_vecinv": ("mitgcm_tpu_torch/kernels/csrc/mom_vecinv.cu",
                   "mitgcm_tpu/model/mom_vecinv.py:210"),
    "impldiff": ("mitgcm_tpu_torch/kernels/csrc/impldiff.cu",
                 "mitgcm_tpu/model/thermodynamics.py:24"),
    "eos_find_rho": ("mitgcm_tpu_torch/kernels/csrc/eos.cu",
                     "mitgcm_tpu/ops/eos.py:218"),
    # the kpp-gyre's kernel K
    "kpp_pre": ("mitgcm_tpu_torch/kernels/csrc/kpp.cu",
                "mitgcm_tpu/model/kpp.py:654"),
    "kpp_smooth": ("mitgcm_tpu_torch/kernels/csrc/kpp.cu",
                   "mitgcm_tpu/model/kpp.py:636"),
    "kpp_col": ("mitgcm_tpu_torch/kernels/csrc/kpp.cu",
                "mitgcm_tpu/model/kpp.py:555"),
    # the ggl90-gyre's kernels G9 and M
    "ggl90_col": ("mitgcm_tpu_torch/kernels/csrc/ggl90.cu",
                  "mitgcm_tpu/model/ggl90.py:358"),
    "ggl90_visc": ("mitgcm_tpu_torch/kernels/csrc/ggl90.cu",
                   "mitgcm_tpu/model/ggl90.py:564"),
    "gad_multidim_x": ("mitgcm_tpu_torch/kernels/csrc/gad_multidim.cu",
                       "mitgcm_tpu/model/gad.py:839"),
    "gad_multidim_y": ("mitgcm_tpu_torch/kernels/csrc/gad_multidim.cu",
                       "mitgcm_tpu/model/gad.py:877"),
    "gad_multidim_r": ("mitgcm_tpu_torch/kernels/csrc/gad_multidim.cu",
                       "mitgcm_tpu/model/gad.py:911"),
    # the high-order advection's kernels O and P
    "gad_os7mp_x": ("mitgcm_tpu_torch/kernels/csrc/gad_os7mp.cu",
                    "mitgcm_tpu/model/gad.py:181"),
    "gad_os7mp_y": ("mitgcm_tpu_torch/kernels/csrc/gad_os7mp.cu",
                    "mitgcm_tpu/model/gad.py:195"),
    "gad_os7mp_r": ("mitgcm_tpu_torch/kernels/csrc/gad_os7mp.cu",
                    "mitgcm_tpu/model/gad.py:221"),
    "gad_ppm_x": ("mitgcm_tpu_torch/kernels/csrc/gad_ppm.cu",
                  "mitgcm_tpu/model/gad.py:565"),
    "gad_ppm_y": ("mitgcm_tpu_torch/kernels/csrc/gad_ppm.cu",
                  "mitgcm_tpu/model/gad.py:565"),
    "gad_ppm_r": ("mitgcm_tpu_torch/kernels/csrc/gad_ppm.cu",
                  "mitgcm_tpu/model/gad.py:630"),
    # the idemix-gyre's kernel H-IDEMIX and the som-gyre's H-SOM
    "idemix_prep": ("mitgcm_tpu_torch/kernels/csrc/idemix.cu",
                    "mitgcm_tpu/model/ggl90.py:224"),
    "idemix_hdiff": ("mitgcm_tpu_torch/kernels/csrc/idemix.cu",
                     "mitgcm_tpu/model/ggl90.py:253"),
    "idemix_col": ("mitgcm_tpu_torch/kernels/csrc/idemix.cu",
                   "mitgcm_tpu/model/ggl90.py:287"),
    "som_x": ("mitgcm_tpu_torch/kernels/csrc/som.cu",
              "mitgcm_tpu/model/som.py:214"),
    "som_y": ("mitgcm_tpu_torch/kernels/csrc/som.cu",
              "mitgcm_tpu/model/som.py:216"),
    "som_r": ("mitgcm_tpu_torch/kernels/csrc/som.cu",
              "mitgcm_tpu/model/som.py:222"),
    # the nh-convection box's kernels H-cg3d (two passes an iteration) and
    # W
    "cg3d_s_stencil_dot": ("mitgcm_tpu_torch/kernels/csrc/cg3d.cu",
                           "mitgcm_tpu/solver/cg3d.py:231"),
    "cg3d_xr_precond": ("mitgcm_tpu_torch/kernels/csrc/cg3d.cu",
                        "mitgcm_tpu/solver/cg3d.py:234"),
    "calc_gw": ("mitgcm_tpu_torch/kernels/csrc/calc_gw.cu",
                "mitgcm_tpu/model/calc_gw.py:29"),
    # the ice-gyre's sea-ice kernels: seaice_lsr_prep (two launches),
    # seaice_lsr_tridiag (the half-sweeps and the loop's check),
    # seaice_advect and seaice_thermo
    "seaice_lsr_visc": ("mitgcm_tpu_torch/kernels/csrc/seaice_lsr.cu",
                        "mitgcm_tpu/model/seaice.py:912"),
    "seaice_lsr_coeffs": ("mitgcm_tpu_torch/kernels/csrc/seaice_lsr.cu",
                          "mitgcm_tpu/model/seaice.py:915"),
    "seaice_lsr_tridiag_u": ("mitgcm_tpu_torch/kernels/csrc/seaice_lsr.cu",
                             "mitgcm_tpu/model/seaice.py:806"),
    "seaice_lsr_tridiag_v": ("mitgcm_tpu_torch/kernels/csrc/seaice_lsr.cu",
                             "mitgcm_tpu/model/seaice.py:843"),
    "seaice_lsr_check": ("mitgcm_tpu_torch/kernels/csrc/seaice_lsr.cu",
                         "mitgcm_tpu/model/seaice.py:1020"),
    "seaice_advect_x": ("mitgcm_tpu_torch/kernels/csrc/seaice_advect.cu",
                        "mitgcm_tpu/model/seaice.py:1341"),
    "seaice_advect_y": ("mitgcm_tpu_torch/kernels/csrc/seaice_advect.cu",
                        "mitgcm_tpu/model/seaice.py:1345"),
    "seaice_thermo": ("mitgcm_tpu_torch/kernels/csrc/seaice_thermo.cu",
                      "mitgcm_tpu/model/seaice.py:1681"),
    # the evp-ice-gyre's H-seaice EVP (two launches a subcycle) and the
    # free-drift path's kernel
    "seaice_evp_stress": ("mitgcm_tpu_torch/kernels/csrc/seaice_evp.cu",
                          "mitgcm_tpu/model/seaice.py:1116"),
    "seaice_evp_uv": ("mitgcm_tpu_torch/kernels/csrc/seaice_evp.cu",
                      "mitgcm_tpu/model/seaice.py:1160"),
    "seaice_freedrift": ("mitgcm_tpu_torch/kernels/csrc/seaice_freedrift.cu",
                         "mitgcm_tpu/model/seaice.py:1246"),
    # the step's glue on every path: F, D, E (two scans) and G (three
    # passes)
    "halo_fill": ("mitgcm_tpu_torch/kernels/csrc/halo.cu",
                  "mitgcm_tpu/ops/stencil.py:54"),
    "phihyd": ("mitgcm_tpu_torch/kernels/csrc/phihyd.cu",
               "mitgcm_tpu/model/phihyd.py:211"),
    "cg2d_rhs": ("mitgcm_tpu_torch/kernels/csrc/step_scans.cu",
                 "mitgcm_tpu/model/step.py:400"),
    "continuity": ("mitgcm_tpu_torch/kernels/csrc/step_scans.cu",
                   "mitgcm_tpu/model/step.py:633"),
    "mom_ab_step": ("mitgcm_tpu_torch/kernels/csrc/step_glue.cu",
                    "mitgcm_tpu/model/step.py:54"),
    "mom_correction": ("mitgcm_tpu_torch/kernels/csrc/step_glue.cu",
                       "mitgcm_tpu/model/step.py:509"),
    "tracer_step": ("mitgcm_tpu_torch/kernels/csrc/step_glue.cu",
                    "mitgcm_tpu/model/thermodynamics.py:329"),
    # the gm-gyres' GM-Redi kernels and kernel C's GM branch
    "gm_tensor": ("mitgcm_tpu_torch/kernels/csrc/gmredi.cu",
                  "mitgcm_tpu/model/gmredi.py:192"),
    "gm_psi_b": ("mitgcm_tpu_torch/kernels/csrc/gmredi.cu",
                 "mitgcm_tpu/model/gmredi.py:396"),
    "gm_residual_flow": ("mitgcm_tpu_torch/kernels/csrc/gmredi.cu",
                         "mitgcm_tpu/model/gmredi.py:424"),
    "gad_calc_rhs_c2_gm": ("mitgcm_tpu_torch/kernels/csrc/gad_calc_rhs.cu",
                           "mitgcm_tpu/model/gmredi.py:288"),
    # the mixing glue and the flow set-up: J-uv and J-ts on the KPP, GGL90
    # and GM paths, L on every path, R's sigmaR on the GGL90 and GM paths
    "kappa_uv": ("mitgcm_tpu_torch/kernels/csrc/mix_glue.cu",
                 "mitgcm_tpu/model/step.py:198"),
    "kappa_ts": ("mitgcm_tpu_torch/kernels/csrc/mix_glue.cu",
                 "mitgcm_tpu/model/thermodynamics.py:470"),
    "adv_flow": ("mitgcm_tpu_torch/kernels/csrc/adv_flow.cu",
                 "mitgcm_tpu/model/gad.py:64"),
    "eos_sigma_r": ("mitgcm_tpu_torch/kernels/csrc/eos.cu",
                    "mitgcm_tpu/model/thermodynamics.py:154"),
    # the VJPs that jax.grad took of F, D, E, G, L and R's LINEAR kind, the
    # gyre's gradient's backward glue
    "halo_fold": ("mitgcm_tpu_torch/kernels/csrc/halo_adj.cu",
                  "mitgcm_tpu/ops/stencil.py:54"),
    "phihyd_adj": ("mitgcm_tpu_torch/kernels/csrc/phihyd_adj.cu",
                   "mitgcm_tpu/model/phihyd.py:171"),
    "cg2d_rhs_adj": ("mitgcm_tpu_torch/kernels/csrc/step_scans_adj.cu",
                     "mitgcm_tpu/model/step.py:400"),
    "continuity_adj": ("mitgcm_tpu_torch/kernels/csrc/step_scans_adj.cu",
                       "mitgcm_tpu/model/step.py:557"),
    "mom_ab_step_adj": ("mitgcm_tpu_torch/kernels/csrc/step_glue_adj.cu",
                        "mitgcm_tpu/model/step.py:54"),
    "mom_correction_adj": ("mitgcm_tpu_torch/kernels/csrc/step_glue_adj.cu",
                           "mitgcm_tpu/model/step.py:509"),
    "tracer_step_adj": ("mitgcm_tpu_torch/kernels/csrc/step_glue_adj.cu",
                        "mitgcm_tpu/model/thermodynamics.py:329"),
    "adv_flow_adj": ("mitgcm_tpu_torch/kernels/csrc/adv_flow.cu",
                     "mitgcm_tpu/model/gad.py:64"),
    "eos_linear_adj": ("mitgcm_tpu_torch/kernels/csrc/eos.cu",
                       "mitgcm_tpu/ops/eos.py:226"),
    # the last glue: the box's cg3d right-hand side (N1) and solve set-up
    # (N2), the surface forcing on every path (Q), the sea ice's
    # set-up (S1) and ocean stress (S2)
    "pre_cg3d": ("mitgcm_tpu_torch/kernels/csrc/pre_cg3d.cu",
                 "mitgcm_tpu/model/step.py:448"),
    "cg3d_setup_scale": ("mitgcm_tpu_torch/kernels/csrc/cg3d_setup.cu",
                         "mitgcm_tpu/solver/cg3d.py:205"),
    "cg3d_setup_fill": ("mitgcm_tpu_torch/kernels/csrc/cg3d_setup.cu",
                        "mitgcm_tpu/solver/cg3d.py:208"),
    "surface_forcing": ("mitgcm_tpu_torch/kernels/csrc/forcing.cu",
                        "mitgcm_tpu/model/thermodynamics.py:76"),
    "seaice_dynforcing": ("mitgcm_tpu_torch/kernels/csrc/seaice_glue.cu",
                          "mitgcm_tpu/model/seaice.py:1991"),
    "seaice_ocean_stress": ("mitgcm_tpu_torch/kernels/csrc/seaice_glue.cu",
                            "mitgcm_tpu/model/seaice.py:1301"),
    # the variable and biharmonic viscosity: X, Y, and B's and V's
    # dissipation variants
    "mom_calc_visc": ("mitgcm_tpu_torch/kernels/csrc/mom_visc.cu",
                      "mitgcm_tpu/model/mom_visc.py:90"),
    "mom_del2uv": ("mitgcm_tpu_torch/kernels/csrc/mom_visc.cu",
                   "mitgcm_tpu/model/mom_fluxform.py:67"),
    "mom_fluxform_visc": ("mitgcm_tpu_torch/kernels/csrc/mom_fluxform.cu",
                          "mitgcm_tpu/model/mom_fluxform.py:232"),
    "mom_vecinv_visc": ("mitgcm_tpu_torch/kernels/csrc/mom_vecinv.cu",
                        "mitgcm_tpu/model/mom_vecinv.py:227"),
    # the Richardson-number mixing (U) and the plume convection (Z)
    "vertmix_calc": ("mitgcm_tpu_torch/kernels/csrc/vertmix.cu",
                     "mitgcm_tpu/model/vertmix.py:80"),
    "opps_col": ("mitgcm_tpu_torch/kernels/csrc/opps.cu",
                 "mitgcm_tpu/model/opps.py:86"),
    # the CD scheme (CD, and the CD variants of G, B and V) and the Shapiro
    # filter (SH-uv, SH-ts)
    "cd_scheme": ("mitgcm_tpu_torch/kernels/csrc/cd_code.cu",
                  "mitgcm_tpu/model/cd_code.py:30"),
    "mom_ab_step(CD)": ("mitgcm_tpu_torch/kernels/csrc/step_glue.cu",
                        "mitgcm_tpu/model/step.py:256"),
    "mom_fluxform(CD)": ("mitgcm_tpu_torch/kernels/csrc/mom_fluxform.cu",
                         "mitgcm_tpu/model/mom_fluxform.py:410"),
    "mom_vecinv(CD)": ("mitgcm_tpu_torch/kernels/csrc/mom_vecinv.cu",
                       "mitgcm_tpu/model/mom_vecinv.py:405"),
    "shap_uv": ("mitgcm_tpu_torch/kernels/csrc/shap_filt.cu",
                "mitgcm_tpu/model/shap_filt.py:150"),
    "shap_ts": ("mitgcm_tpu_torch/kernels/csrc/shap_filt.cu",
                "mitgcm_tpu/model/shap_filt.py:224"),
    # Winton's thermodynamic sea ice (TH)
    "thsice_step": ("mitgcm_tpu_torch/kernels/csrc/thsice.cu",
                    "mitgcm_tpu/model/thsice.py:779"),
    # cg2dExactSums' ordered dot (A-exact), the ice tracers' physics (TP;
    # seaice_advect_x/_y carry their advection) and the legacy ice
    # advection (LA)
    "cg2d_solve_exact": ("mitgcm_tpu_torch/kernels/csrc/cg2d.cu",
                         "mitgcm_tpu/solver/cg2d.py:137"),
    "seaice_thermo_tr": ("mitgcm_tpu_torch/kernels/csrc/seaice_thermo.cu",
                         "mitgcm_tpu/model/seaice.py:1948"),
    "seaice_advect_legacy": (
        "mitgcm_tpu_torch/kernels/csrc/seaice_advect_legacy.cu",
        "mitgcm_tpu/model/seaice.py:1449"),
}
CG2D_KERNELS = ("cg2d_solve",)
# the key under which each kernel-path cg2d solve's host reads are counted
# beside the launches (count_cg2d_reads)
CG2D_READS = "cg2d host reads"
# the backward kernels of the step glue (F', D', E', G'), of L and of R's
# LINEAR kind, which the gyre's gradient runs in place of autograd through
# the twins
GLUE_ADJ_KERNELS = ("halo_fold", "phihyd_adj", "cg2d_rhs_adj",
                    "continuity_adj", "mom_ab_step_adj", "mom_correction_adj",
                    "tracer_step_adj", "adv_flow_adj", "eos_linear_adj")
BACKWARD_KERNELS = ("mom_fluxform_adj", "gad_calc_rhs_c2_adj",
                    *GLUE_ADJ_KERNELS)
GLUE_KERNELS = ("halo_fill", "phihyd", "cg2d_rhs", "continuity",
                "mom_ab_step", "mom_correction", "tracer_step")
# the box's and the sea ice's last glue: N1 and N2, S1 and S2
NH_GLUE_KERNELS = ("pre_cg3d", "cg3d_setup_scale", "cg3d_setup_fill")
SEAICE_GLUE_KERNELS = ("seaice_dynforcing", "seaice_ocean_stress")
VISC_KERNELS = ("mom_calc_visc", "mom_del2uv", "mom_fluxform_visc",
                "mom_vecinv_visc")


def glue_launches(tracers, fills, steps=5, mixing=False):
    """The launches of A, D-G, J-uv, J-ts, L and Q in `steps` steps of a
    path that steps `tracers` tracers and makes `fills` halo fills a step
    (u*, v*, the cg2d and cg3d results, u, v and the new state's fields,
    the sea ice's): one cg2d solve a step, one launch and one host read
    each; the flow and the surface forcing once a step; the kappas once a
    step on a mixing path (KPP, GGL90, GM) and never on another; R's
    sigmaR none (the GGL90 and GM paths add theirs); N1, N2, S1 and S2
    none (the box and the ice paths add theirs)."""
    return {"cg2d_solve": steps, CG2D_READS: steps, "phihyd": steps,
            "cg2d_rhs": steps, "continuity": steps,
            "mom_ab_step": steps, "mom_correction": steps,
            "tracer_step": tracers * steps, "halo_fill": fills * steps,
            "kappa_uv": steps * mixing, "kappa_ts": steps * mixing,
            "adv_flow": steps, "eos_sigma_r": 0, "surface_forcing": steps,
            **{k: 0 for k in NH_GLUE_KERNELS + SEAICE_GLUE_KERNELS}}


# launches in phase 5's 5 timed full-size gyre steps (A's follow its
# iterations)
GYRE_LAUNCHES = {"mom_fluxform": 5, "gad_calc_rhs_c2": 5, "eos_find_rho": 5,
                 **glue_launches(1, 12)}
# launches in phase 6's first full-size gradient (6 steps in 2
# checkpointed chunks of 3): the forward kernels of 6 steps and of their
# recomputation (16 step bodies a gradient), and the fill of each of the
# 5 adjoint cg2d solves (the last step's eta does not reach the cost),
# each one cg2d_solve launch and one host read; R's LINEAR kind once a
# step body. A recomputation stops once the tensors that the backward
# reads are back (torch.utils.checkpoint's early stop): the momentum
# correction and continuity, which save none, run in 4 of the 10
# recomputed step bodies, and 143 fills in all (155 while their twins'
# inputs were saved). The backward kernels of the glue run once a step
# (the tracer's)
# or once a step but the last (whose flow, pressure and free surface reach
# no later theta), F' once a fill whose result reaches the cost, as
# tests/test_torch_host_kernels.py:ADJ_GLUE_LAUNCHES counts them on the
# host; no kernels.TwinVJP backward
ADJ_LAUNCHES = {**glue_launches(1, 0, 16), "halo_fill": 143,
                "continuity": 10, "mom_correction": 10, "eos_find_rho": 16,
                "halo_fill:adjoint": 5, "cg2d_solve": 21, CG2D_READS: 21,
                "cg2d_solve:adjoint": 5, "halo_fold": 35,
                "tracer_step_adj": 6,
                **{k: 5 for k in GLUE_ADJ_KERNELS[1:] if k not in (
                    "tracer_step_adj",)}, "twin_vjp": 0}
VI_KERNELS = ("mom_vecinv", "impldiff", "eos_find_rho")
# launches of each kernel in phase 7's 5 timed full-size vi-gyre steps
VI_LAUNCHES = {"mom_vecinv": 5, "impldiff": 20, "eos_find_rho": 5,
               "mom_fluxform": 0, **glue_launches(2, 12)}
KPP_KERNELS = ("kpp_pre", "kpp_smooth", "kpp_col")
# launches in phase 8's 5 timed full-size kpp-gyre steps
KPP_LAUNCHES = {"kpp_pre": 5, "kpp_smooth": 5, "kpp_col": 5,
                "mom_vecinv": 5, "impldiff": 20, "eos_find_rho": 5,
                "gad_calc_rhs_c2": 10, "mom_fluxform": 0,
                **glue_launches(2, 12, mixing=True)}
G9_KERNELS = ("ggl90_col", "ggl90_visc")
MD_KERNELS = ("gad_multidim_x", "gad_multidim_y", "gad_multidim_r")
# launches in phase 9's 5 timed full-size ggl90-gyre steps: M three per
# tracer, R for find_rho and for calc_sigmaR
G9_LAUNCHES = {"ggl90_col": 5, "ggl90_visc": 5, "gad_multidim_x": 10,
               "gad_multidim_y": 10, "gad_multidim_r": 10,
               "gad_calc_rhs_c2": 10, "impldiff": 20, "eos_find_rho": 5,
               "mom_vecinv": 5, "kpp_pre": 0, "mom_fluxform": 0,
               **glue_launches(2, 13, mixing=True), "eos_sigma_r": 5}
O_KERNELS = ("gad_os7mp_x", "gad_os7mp_y", "gad_os7mp_r")
P_KERNELS = ("gad_ppm_x", "gad_ppm_y", "gad_ppm_r")
# launches in phase 10's 5 timed full-size steps: the ggl90-gyre's with the
# sweeps of O (os7mp-gyre) or P (pqm-gyre) in place of M's
_HO_LAUNCHES = {k: n for k, n in G9_LAUNCHES.items() if k not in MD_KERNELS}
HO_LAUNCHES = {
    "os7mp": {**_HO_LAUNCHES, **{k: 0 for k in MD_KERNELS + P_KERNELS},
              **{k: 10 for k in O_KERNELS}},
    "pqm": {**_HO_LAUNCHES, **{k: 0 for k in MD_KERNELS + O_KERNELS},
            **{k: 10 for k in P_KERNELS}},
}
IDEMIX_KERNELS = ("idemix_prep", "idemix_hdiff", "idemix_col")
SOM_KERNELS = ("som_x", "som_y", "som_r")
# launches in phase 11's 5 timed full-size steps: the ggl90-gyre's with
# H-IDEMIX's three (idemix-gyre), or H-SOM's three per tracer in place of
# M's (som-gyre), and the fills of IDEMIX_E or of the two tracers' moments
ISM_LAUNCHES = {
    "idemix": {**G9_LAUNCHES, **{k: 5 for k in IDEMIX_KERNELS},
               **{k: 0 for k in SOM_KERNELS}, "halo_fill": 70},
    "som": {**G9_LAUNCHES, **{k: 0 for k in MD_KERNELS + IDEMIX_KERNELS},
            **{k: 10 for k in SOM_KERNELS}, "halo_fill": 75},
}
GM_KERNELS = ("gm_tensor", "gm_psi_b", "gm_residual_flow",
              "gad_calc_rhs_c2_gm")
# launches in phase 16's 5 timed full-size steps: the kpp-gyre's with C's
# GM branch in place of C, gm_tensor once a step and R also for sigmaR;
# on the gm-bolus-gyre gm_psi_b and gm_residual_flow once a step and the
# fills of psiX and psiY
GM_LAUNCHES = {**KPP_LAUNCHES, "gad_calc_rhs_c2": 0, "gad_calc_rhs_c2_gm": 10,
               "eos_sigma_r": 5, "gm_tensor": 5, "gm_psi_b": 0,
               "gm_residual_flow": 0}
GM_BOLUS_LAUNCHES = {**GM_LAUNCHES, "gm_psi_b": 5, "gm_residual_flow": 5,
                     "halo_fill": 70}
CG3D_KERNELS = ("cg3d_s_stencil_dot", "cg3d_xr_precond")
NH_KERNELS = CG3D_KERNELS + ("calc_gw",) + NH_GLUE_KERNELS
ICE_KERNELS = ("seaice_lsr_visc", "seaice_lsr_coeffs", "seaice_lsr_tridiag_u",
               "seaice_lsr_tridiag_v", "seaice_lsr_check", "seaice_advect_x",
               "seaice_advect_y", "seaice_thermo")
EVP_KERNELS = ("seaice_evp_stress", "seaice_evp_uv", "seaice_freedrift")
# the EVP variants phase 15 holds against the twins: SEAICE_PARM01 settings
# on top of the ice-gyre's; the evp-ice-gyre's adaptive EVP (its JSON row)
# last
EVP_VARIANTS = {
    "revised": {"SEAICE_evpAlpha": 500.0, "SEAICEnEVPstarSteps": 500},
    "classic": {"SEAICEuseEVPrev": False, "SEAICEuseEVPstar": False,
                "SEAICE_deltaTevp": 60.0},
    "EVP*": {"SEAICEuseEVPrev": False, "SEAICE_deltaTevp": 60.0},
    "aEVP": {"SEAICEaEVPcoeff": 0.5, "SEAICEnEVPstarSteps": 500},
}
# launches in phase 12's 5 timed full-size steps besides H-cg3d's (whose
# count follows from each solve's batches, nh_full_phase): W and B once a
# step, C for theta alone, R's LINEAR kind, no other kernel of the gyres,
# D-G with the fills of phi_nh and of the cg3d result, and N1 and N2's
# three launches (a normalised solve) once a step
NH_LAUNCHES = {"calc_gw": 5, "mom_fluxform": 5, "gad_calc_rhs_c2": 5,
               "mom_vecinv": 0, "impldiff": 0, "eos_find_rho": 5,
               "kpp_pre": 0, "ggl90_col": 0, "gad_multidim_x": 0,
               **glue_launches(1, 14), **{k: 5 for k in NH_GLUE_KERNELS}}
# the (scheme, vertical scheme) pairs whose sweeps phase 10 holds against
# their twins: every scheme of O and P, and M's schemes 1 and 20 and
# vertical 2, 3 and 4; the main paths' 7 and 51 (salt) last, so that the
# JSON line reports them
HO_PAIRS = ((40, 40), (42, 42), (50, 50), (52, 52), (1, 1), (20, 20),
            (30, 2), (30, 3), (30, 4), (41, 41), (51, 51), (7, 7))
# largest relative interior error a kernel may show against its twin
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
# the H100 SXM's published peaks (NVIDIA's datasheet): HBM bytes/s
# and float32 operations/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_OPS_S = 3.35e12, 67e12
# estimated operations per cell of each kernel's largest field (its source
# notes), for the operations side of the bound; every kernel here but
# cg2d_solve (whose count is a cell's an iteration) is bounded by bytes by a
# wide margin
OPS_PER_CELL = {"cg2d_solve": 30, "mom_fluxform": 300,
                # B': each level's staging (transports, the four masked
                # cotangents, the Coriolis products, w rA) ~40 a staged
                # cell, 1.6 staged cells a column; hFacZ, the faces and
                # viscous products ~55; interface k+1's terms ~40; the sums
                # of u_bar, v_bar, the drag and w_bar ~210
                "gad_calc_rhs_c2": 60, "mom_fluxform_adj": 370,
                "gad_calc_rhs_c2_adj": 120,
                # V's tile: the staging's nine products ~15 a staged cell,
                # 1.6 staged cells a column; hFacZ, the vorticity, zeta and
                # 1 / hFacZ ~25 (a division under schemes 0 and 2); the
                # divergence and KE ~12; the Coriolis, vorticity advection
                # (a division), shear, dissipation, side and bottom drag
                # terms ~140
                "mom_vecinv": 200,
                "impldiff": 15, "eos_find_rho": 60, "kpp_pre": 400,
                "kpp_smooth": 40, "kpp_col": 250,
                # G9's column passes: the sweep from the bottom (the raw
                # length's two square roots and division, ~30 with
                # flags 2 and 3), the down pass's raw length again, the
                # limiter and 1 / MLtmp, the shear (~15), the Richardson
                # and Prandtl numbers and diffKr (three divisions), the
                # sources, the row's coefficients and its elimination (a
                # division, ~35), the back substitution (~5); divisions and
                # square roots ~8 instructions each; Langmuir's exp ~20
                "ggl90_col": 180, "ggl90_visc": 10,
                # M: one flux a face (scheme 33: its Courant weights ~10,
                # two psi of ~12 flops and two divisions each, ~8
                # instructions a division, and the blend ~8) and the update
                # ~10
                "gad_multidim_x": 90, "gad_multidim_y": 90,
                "gad_multidim_r": 90,
                # O: one flux a face (~90 flops and 9 divisions) and the
                # update; H-SOM: the limiter, the two fluxes leaving a cell
                # and the two-sweep update (4 divisions)
                "gad_os7mp_x": 130, "gad_os7mp_y": 130, "gad_os7mp_r": 130,
                # P, scheme 51 (the pqm-gyre's salt), each value once: the
                # edge and its slope ~47, the polynomial ~181 (the slope
                # limiter's division, QUADROOT's square root and two
                # divisions, ~8 instructions each), the flux ~52 (a
                # division), the update ~10; PPM-mono (41) ~163, WENO adds
                # ~140
                "gad_ppm_x": 290, "gad_ppm_y": 290, "gad_ppm_r": 290,
                "idemix_prep": 150, "idemix_hdiff": 60, "idemix_col": 40,
                "som_x": 200, "som_y": 200, "som_r": 200,
                # H-cg3d's passes: s' and the 7-point product; the x and r
                # updates with P's two column sweeps and two dot products
                "cg3d_s_stencil_dot": 40, "cg3d_xr_precond": 18,
                # W's tile: each face's harmonic (~11) and advective (~8)
                # flux once, for the tile's W and S faces and 28 % more on
                # the ring's; 1 / the open thickness (~14), the viscosity's
                # eight-term sum, the two interfaces' fluxes and the two
                # outputs (~30), the 3-D Coriolis term (~12)
                "calc_gw": 110,
                # the sea ice's, per 2-D cell (seaice_thermo's per cell of
                # its largest field, TICES, one category of one column: 11
                # flux evaluations of ~30 flops and 2 exp, counted as 20
                # flops each, and the category's share of the budget); a
                # half-sweep's line solve is ~12 a cell on half the cells
                "seaice_lsr_visc": 60, "seaice_lsr_coeffs": 200,
                "seaice_lsr_tridiag_u": 6, "seaice_lsr_tridiag_v": 6,
                "seaice_lsr_check": 4, "seaice_advect_x": 120,
                "seaice_advect_y": 150, "seaice_thermo": 800,
                # EVP's launches (seaice_evp_uv's tile forms sigma12 and
                # the drag once a cell and a ring of 16 %, then the
                # divergence, forcing and update) and free drift's (3
                # C-point solves a thread, atan2, sin, cos and sqrt counted
                # as 20 flops each)
                "seaice_evp_stress": 120, "seaice_evp_uv": 150,
                "seaice_freedrift": 450,
                # the step's glue, per cell of its largest field (D and E
                # recompute the west/south or east/north neighbour
                # column; mom_ab_step's two components)
                "halo_fill": 0, "phihyd": 20, "cg2d_rhs": 20,
                "continuity": 16, "mom_ab_step": 20, "mom_correction": 12,
                "tracer_step": 8,
                # GM-Redi's: three slope limits a cell of ~40 flops with
                # two sqrt and, for dm95/ldd97, tanh and sin (20 each), and
                # the recomputed density gradients; C's GM branch adds the
                # xy and r fluxes to C's 60
                "gm_tensor": 250, "gm_psi_b": 60, "gm_residual_flow": 20,
                "gad_calc_rhs_c2_gm": 130,
                # the mixing glue and the flow set-up, per cell of their
                # largest field: J-uv's KPP blend (two sums, two products
                # and a max a component), J-ts's nonlocal fluxes (~8 each)
                # and GM's terms, L's seven fields, R's sigmaR (the JMD95
                # polynomials, a division, the masks)
                "kappa_uv": 10, "kappa_ts": 20, "adv_flow": 10,
                "eos_sigma_r": 70,
                # the glue's backward kernels, per cell of their largest
                # field: F''s block sums (up to 9 terms), D''s five-term
                # cotangent and the suffix sum, continuity_adj's three
                # recomputed scans, mom_correction_adj's four level sums
                "halo_fold": 4, "phihyd_adj": 14, "cg2d_rhs_adj": 12,
                "continuity_adj": 20, "mom_ab_step_adj": 10,
                "mom_correction_adj": 16, "tracer_step_adj": 6,
                "adv_flow_adj": 8, "eos_linear_adj": 4,
                # the last glue, per cell of their largest field: N1's two
                # fluxes recomputed and w*'s term (~35 with two
                # divisions), N2's products and the maximum, Q's terms
                # (~20 a 2-D cell), S1's exp (~20) and ~40 products, S2's
                # turned drag at the u and v points (~60; the no-dynamics
                # drag adds three square roots)
                "pre_cg3d": 35, "cg3d_setup_scale": 4, "cg3d_setup_fill": 3,
                "surface_forcing": 20,
                "seaice_dynforcing": 60, "seaice_ocean_stress": 60,
                # X, one thread a cell: the vorticity and divergence at six
                # points and the strain and tension at four (~15 flops
                # each), Leith's gradients, the Smagorinsky and full Leith
                # square roots and the limits at two points (~8 a square
                # root), ~300; Y's two stencils with hFacZ at three points
                # ~60; B's and V's variants add the viscosity products and
                # the biharmonic fluxes (~60) to B's and V's
                "mom_calc_visc": 300, "mom_del2uv": 60,
                "mom_fluxform_visc": 360, "mom_vecinv_visc": 260,
                # U, one thread a column, per cell: two equations of state
                # at the level's pressure (~70 each for JMD95Z), the
                # centred velocities and shear (~12), PP81's closure
                # (~8, two divisions) or MY82's (~30, a square root and
                # four divisions, and its second pass's ~8)
                "vertmix_calc": 200,
                # Z's operations depend on the data: opps_ops counts the
                # live iterations of its inputs (rimix_ops)
                "opps_col": 0,
                # TH's too (hold_thsice: its cells and their live surface
                # iterations)
                "thsice_step": 0,
                # CD, one thread a cell: pf at eight points, afV and afU at
                # four points each (~6 flops), the averages and the
                # relaxation (~40), the predictors (~6); a call of SH-uv
                # and SH-ts is the whole filter of the shap-gyre: SH-uv's 4
                # index passes of two divergences and three vorticities
                # (~40 a pass), SH-ts's 4 passes of four fluxes (~20) on
                # each of two tracers
                "cd_scheme": 120, "shap_uv": 160, "shap_ts": 160}
# the outputs of kernels J-ts (those its variant writes) and L
KAPPA_TS_OUTS = ("kapT", "kapS", "dfT", "dfS")
ADV_FLOW_OUTS = ("uTrans", "vTrans", "rTrans", "rTransKp", "maskUp", "xA",
                 "yA")
# tensors that a wrapper checks but that are its kernel's scratch, and
# those it updates in place (read and written)
SCRATCH = ("gam", "cuu")
IN_PLACE = {"cg3d_xr_precond": ("x", "r"), "seaice_lsr_tridiag_u": ("u",),
            "seaice_lsr_tridiag_v": ("u",),
            "seaice_lsr_check": ("uTmp", "vTmp")}
# the prognostic fields of GGL90, IDEMIX and SOM that a gyre may carry
PROGNOSTIC_EXTRA = ("GGL90TKE", "IDEMIX_E", "somT", "somS")
PARITY_DIGITS = 10.0
GRDCHK_TOL = 1e-5


def phase(title):
    print(f"== {title}", flush=True)


# the full-size grids, one per distinct geometry, built once and shared by
# every phase that runs it (the gyre and vi-gyre; the kpp-, ggl90-,
# idemix- and som-gyre; the os7mp- and pqm-gyre on halos of 4)
GRIDS = {}


def shared_grid(cfg, dtype, flat=False):
    """The gyres' walled grid of cfg on the card (with flat, the
    nh-convection box's, flat-bottomed and without walls), from GRIDS at
    full size (built there on first use, with its seconds printed); None
    below full size, where each set-up builds its own."""
    from mitgcm_tpu_torch.core.grid import build_grid
    from mitgcm_tpu_torch.utils import synthetic

    if cfg.nx < 1024:
        return None
    key = (cfg.nx, cfg.ny, cfg.nr, cfg.olx, cfg.oly, tuple(cfg.delX),
           tuple(cfg.delY), tuple(cfg.delR), cfg.hFacMin, cfg.hFacMinDr,
           cfg.seaLev_Z, cfg.ygOrigin, cfg.f0, cfg.beta, cfg.fPrime,
           cfg.gBaro, dtype, flat)
    if key not in GRIDS:
        t0 = time.perf_counter()
        build = build_grid if flat else synthetic.gyre_grid
        GRIDS[key] = build(cfg, dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        print(f"grid {cfg.nx}x{cfg.ny}x{cfg.nr}, halos of {cfg.olx}, "
              f"{len(set(cfg.delR))} distinct level thicknesses: built in "
              f"{time.perf_counter() - t0:.1f} s (shared by the later "
              f"set-ups of the same geometry)", flush=True)
    return GRIDS[key]


def cuda_time_ms(fn, reps):
    """Median over reps of fn's device time (CUDA events), after a
    warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def launch_ms(call, name, reps, batch=20):
    """Device ms of one launch of kernel `name`: the first launch of it
    that `call` (a wrapper call) makes is captured and replayed `batch`
    times back to back between two CUDA events, the median over reps
    divided by batch, as a loop that enqueues its launches ahead of the
    card runs them (the wrapper's host work, which a single call's events
    hold, left out)."""
    from mitgcm_tpu_torch import kernels

    args, outs = captured_launch(call, name)

    def replay():
        for _ in range(batch):
            kernels.launch(*args)

    ms = cuda_time_ms(replay, reps) / batch
    del outs
    return ms


def captured_launch(call, name):
    """(the arguments of the first launch of kernel `name` that `call`
    makes, call's result, which keeps that launch's tensors alive): a
    launch to replay through kernels.launch."""
    from mitgcm_tpu_torch import kernels

    captured = []
    saved = kernels.launch

    def capture(*args):
        if args[0] == name and not captured:
            captured.append(args)
        saved(*args)

    kernels.launch = capture
    try:
        outs = call()
    finally:
        kernels.launch = saved
    (args,) = captured
    return args, outs


def batch_ms(fn, reps, batch=20):
    """Device ms of one call of fn: `batch` calls back to back between two
    CUDA events, the median over reps divided by batch (a PyTorch call,
    whose launches are not ours to replay)."""
    def run():
        for _ in range(batch):
            fn()
    return cuda_time_ms(run, reps) / batch


def graph_ms(fn, reps, calls=20, replays=5):
    """Device ms of one call of fn: `calls` calls captured in a CUDA graph,
    the graph replayed `replays` times back to back between two CUDA
    events, the median over reps over calls x replays. The card runs the
    calls back to back however slowly the host enqueues them one by one
    (a 2-D fill is shorter than a launch's enqueue)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()

    def replay():
        for _ in range(replays):
            graph.replay()

    return cuda_time_ms(replay, reps) / (calls * replays)


def count_cg2d_reads():
    """Witness the host syncs of every kernel-path cg2d solve, counted
    under CG2D_READS in kernels.launches: the solve runs under
    torch.cuda.set_sync_debug_mode("error"), so any synchronising CUDA
    operation in it (.item(), float(t), .cpu(), a tensor read as a bool,
    ...) raises, but for its one read of the iteration count
    (cg2d._iterations), which runs with the mode off and is counted. The
    mode is global, so the adjoint's solve, which autograd runs on a
    thread of its own, is held too. Plain-path solves are not held."""
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.solver import cg2d

    solve, read = cg2d._solve, cg2d._iterations

    def sync_mode(mode, fn, *args):
        saved = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(mode)
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(saved)

    def counted_read(ctrl):
        kernels.launches[CG2D_READS] += 1
        return sync_mode(0, read, ctrl)

    def witnessed(cfg, op, b, x0, impl=None):
        if not kernels.use_kernel(b, impl):
            return solve(cfg, op, b, x0, impl)
        return sync_mode("error", solve, cfg, op, b, x0, impl)

    cg2d._solve, cg2d._iterations = witnessed, counted_read


def glue_plain_calls():
    """Calls so far of the twins of D-G, J-uv, J-ts, L, R, N1, N2, Q, S1,
    S2, X and Y and of the fill's plain fold (ops/stencil.py,
    model/phihyd.py, model/step.py, model/thermodynamics.py, model/gad.py's
    calc_adv_flow, ops/eos.py's find_rho, solver/cg3d.py, model/seaice.py,
    the last two with H-cg3d's and the sea ice's other twins,
    model/mom_visc.py); a kernel-path run adds none."""
    from mitgcm_tpu_torch.model import gad, mom_visc, phihyd, seaice, step
    from mitgcm_tpu_torch.model import thermodynamics
    from mitgcm_tpu_torch.ops import eos, stencil
    from mitgcm_tpu_torch.solver import cg3d

    return (stencil.plain_calls + stencil.plain_folds + phihyd.plain_calls
            + step.plain_calls + thermodynamics.plain_calls
            + gad.flow_plain_calls + eos.plain_calls + cg3d.plain_calls
            + seaice.plain_calls + mom_visc.plain_calls)


def check_launches(label, launches, want, plain=0):
    """Raise unless every kernel of `want` was launched exactly as often as
    it says and no plain twin ran (plain: the twins' calls in the run)."""
    wrong = {k: launches.get(k, 0) for k, count in want.items()
             if launches.get(k, 0) != count}
    if wrong or plain:
        raise AssertionError(f"{label} launch counts {wrong} (want {want}),"
                             f" plain twin calls {plain}")


def device_phase():
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this run needs an NVIDIA GPU and has no CPU path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")
    return smi


def build_phase(kernels):
    phase("2 build")
    t0 = time.perf_counter()
    so = kernels.build(verbose=True)
    kernels.library()
    print(f"built {os.path.relpath(so, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")


class Case:
    """A gyre grid plus seeded random fields on the card (the vi-gyre's
    configuration when vi)."""

    def __init__(self, n, nr, dtype, vi=False):
        from mitgcm_tpu_torch.model import gad
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        config = synthetic.vi_gyre_config if vi else synthetic.gyre_config
        self.cfg = config(nx=n, ny=n, nr=nr)
        self.grid, _, _, self.op = synthetic.gyre_setup(
            self.cfg, dtype=dtype, device="cuda",
            grid=shared_grid(self.cfg, dtype))
        rng = np.random.default_rng(SEED)
        g = self.grid
        shape = tuple(g.hFacC.shape)
        self.u = self.field(rng, shape, 0.1) * g.maskW
        self.v = self.field(rng, shape, 0.1) * g.maskS
        self.w = self.field(rng, shape, 1e-4) * g.maskC
        self.theta = (15.0 + self.field(rng, shape, 2.0)) * g.maskC
        self.salt = (35.0 + self.field(rng, shape, 0.5)) * g.maskC
        self.phi = self.field(rng, shape, 10.0)     # a totPhiHyd
        kshape = (nr + 1,) + shape[1:]
        self.kappaRU = self.field(rng, kshape, 1e-3).abs()
        self.kappaRV = self.field(rng, kshape, 1e-3).abs()
        self.kappaR = self.field(rng, shape, 1e-4).abs()
        self.flow = gad.calc_adv_flow(g, self.u, self.v, self.w)
        self.y2 = self.field(rng, shape[1:], 1.0)   # 2-D cg2d fields
        self.z2 = self.field(rng, shape[1:], 1.0)
        self.df = self.field(rng, shape, 1e-3) * g.maskC   # C's df

    def field(self, rng, shape, scale):
        a = rng.standard_normal(shape) * scale
        return torch.as_tensor(a, dtype=self.dtype, device="cuda")

    @property
    def label(self):
        c = self.cfg
        return f"{c.nx}x{c.ny}x{c.nr} {str(self.dtype).split('.')[-1]}"


def cells_of(t):
    """The grid cells a tensor covers: its last three dimensions (a stack of
    fields, as SOM's nine moments, counts each cell once)."""
    return math.prod(t.shape[-3:])


# Kernels B and C: the cells of each input that the function reads beyond
# the interior, as the one-cell ring sides (south, north, west, east) that
# its stencils reach (an input not named: the interior only); a ring side
# counts whole, so at most 3 corner cells a plane are counted that the
# stencils skip.
RING4, SW, S, N, W, E = (1, 1, 1, 1), (1, 0, 1, 0), (1, 0, 0, 0), \
    (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)
MOM_RINGS = {
    "u": RING4, "v": RING4, "hFacW": RING4, "hFacS": RING4,
    "maskW": (1, 1, 0, 1), "maskS": (0, 1, 1, 1), "w": SW, "maskC": SW,
    "hFacC": SW, "rA": SW, "fCori": SW, "fCoriCos": W, "angleCosC": W,
    "dyG": (1, 0, 1, 1), "dxG": (1, 1, 1, 0), "dxF": S, "recip_dyF": S,
    "dyF": W, "recip_dxF": W, "cosFacU": W, "dxV": N, "recip_dyU": N,
    "dyU": E, "recip_dxV": E, "cosFacV": E}
GAD_RINGS = {
    "tracer": RING4, "uTrans": E, "xA": E, "recip_dxC": E, "cosFacU": E,
    "vTrans": N, "yA": N, "recip_dyC": N, "Kux": E, "Kuz": E, "maskW": E,
    "Kvy": N, "Kvz": N, "maskS": N}


# Kernel V, the same way: its vorticity points reach north and east, its
# divergence and KE and the shear's w rA south and west, the planetary and
# vorticity averages the corners (j+1, i-1) and (j-1, i+1)
VECINV_RINGS = {
    "u": RING4, "v": RING4, "hFacW": RING4, "hFacS": RING4,
    "maskW": (1, 1, 0, 1), "maskS": (0, 1, 1, 1), "w": SW, "maskC": SW,
    "recip_hFacC": SW, "rA": SW, "recip_rA": SW, "dxC": (1, 1, 0, 1),
    "dyC": (0, 1, 1, 1), "dyG": (1, 0, 1, 1), "dxG": (1, 1, 1, 0),
    "dxV": N, "recip_dyU": N, "dyU": E, "recip_dxV": E,
    "recip_rAz": (0, 1, 0, 1), "fCoriG": (0, 1, 0, 1)}


def mom_footprint(named, args):
    """Kernel B's inputs as the views that its launch reads (args: the
    launch's arguments after the pointer table and its length): the
    kappas below the surface interface, recip_drC between the levels, the
    3-D Coriolis term's two fields only under its flag (bit 0 of the
    Coriolis flags), fCori not under the CD variant's (bit 1)."""
    nr, _, _, oly, olx, _, coriolis = args[:7]
    levels = {"kappaRU": slice(1, None), "kappaRV": slice(1, None),
              "recip_drC": slice(1, nr)}
    skip = (() if coriolis & 1 else ("fCoriCos", "angleCosC")) + (
        ("fCori",) if coriolis & 2 else ())
    return {n: footprint_view(t, oly, olx, MOM_RINGS.get(n),
                              levels.get(n))
            for n, t in named.items() if n not in skip}


def vecinv_footprint(named, args):
    """Kernel V's inputs as the views that its launch reads (args: nr, ny,
    nx, oly, olx, vortScheme, coriScheme, implicitViscosity, noSlipBottom,
    ...): maskC above the bottom level (w rA's mask of the level below);
    the kappas at the interfaces below the surface that the explicit
    viscous flux (1 .. nr-1) or the no-slip bottom drag (1 .. nr) reads,
    with recip_drC between the levels, none of them under implicit
    viscosity without the no-slip drag; rAw and rAs only under explicit
    viscosity; fCoriG not under the CD variant (Coriolis 2)."""
    nr, _, _, oly, olx, _, cori, implicit, no_slip = args[:9]
    kappa = slice(1, None) if no_slip else slice(1, nr)
    levels = {"maskC": slice(0, nr - 1), "kappaRU": kappa,
              "kappaRV": kappa, "recip_drC": slice(1, nr)}
    skip = ("fCoriG",) if cori == 2 else ()
    if implicit:
        skip += ("rAw", "rAs")
        if not no_slip:
            skip += ("kappaRU", "kappaRV", "recip_drC")
    return {n: footprint_view(t, oly, olx, VECINV_RINGS.get(n),
                              levels.get(n))
            for n, t in named.items() if n not in skip}


def mom_adj_footprint(named, args):
    """Kernel B''s inputs as the views that its launch reads (args: nr, ny,
    nx, oly, olx, ...): B's reach under the gyre's flags (mom_footprint),
    the cotangents of the four tendencies on the interior."""
    nr, _, _, oly, olx = args[:5]
    return mom_footprint(named, (nr, 0, 0, oly, olx, 1, 0))


def gad_footprint(named, args):
    """Kernel C's inputs (and its GM branch's: Kwx, Kwy, maskW, maskS and
    the 3-D Kux ... Kvz) as the views that its launch reads: the
    interfaces' fields below the surface, kappaR and recip_drC only with
    explicit diffusion (recip_drC whole and maskC on the ring under
    GM_ExtraDiag's dT/dz), maskUp and rA only where a vertical flux reads
    them, maskC above the bottom level and only with advection otherwise.
    Without advection the transports still count: the function multiplies
    them by 0, which keeps a NaN."""
    nr, _, _, oly, olx, _, _, implicit, advection = args[:9]
    gm, extra = "Kwx" in named, "Kuz" in named
    below = slice(1, None)
    levels = {"kappaR": below, "maskUp": below, "Kwx": below, "Kwy": below,
              "recip_drC": slice(None) if extra else slice(1, nr),
              "maskC": slice(None) if extra else slice(0, nr - 1)}
    rings = dict(GAD_RINGS, maskC=RING4 if extra else None)
    skip = []
    if implicit:
        skip.append("kappaR")
        if not extra:
            skip.append("recip_drC")
        if not gm:
            skip += ["maskUp", "rA"]
    if not (advection or extra):
        skip.append("maskC")
    return {n: footprint_view(t, oly, olx, rings.get(n), levels.get(n))
            for n, t in named.items() if n not in skip}


def phihyd_footprint(named, args):
    """Kernel D's inputs as the views that its launch reads: every padded
    cell of rho and of the metrics (D writes every padded cell), drC
    between the surface and the bottom, rF and rC at the two ends."""
    nr = named["rC"].numel()
    levels = {"drC": slice(1, nr), "rF": slice(0, nr + 1, nr),
              "rC": slice(0, nr, max(nr - 1, 1))}
    return {n: footprint_view(t, 0, 0, None, levels.get(n))
            for n, t in named.items()}


def mom_correction_footprint(named, args):
    """G's mom_correction's inputs as the views that its launch reads:
    every padded cell (it writes every padded cell), phi_nh only under its
    flag (args: nr, nyp, nxp, nh, ...)."""
    return {n: t for n, t in named.items() if args[3] or n != "phi_nh"}


# H-cg3d's passes read the interior of each field (s' on the ring wraps
# into it), the operator's aW with its eastern and aS with its northern
# ring side (pass A's A s' takes its neighbours' coefficients)
CG3D_RINGS = {"aW": E, "aS": N}


def cg3d_footprint(named, ints):
    """H-cg3d's inputs as the views that a pass reads (ints: its launch's
    nr, ny, nx, oly, olx): every level of the interior, aW and aS with
    their rings; the 0-d scalars whole."""
    _, _, _, oly, olx = ints
    return {n: footprint_view(t, oly, olx, CG3D_RINGS.get(n), None)
            for n, t in named.items()}


# The fields that each sweep of kernel O and each pass of H-SOM reads, by
# the names their wrappers check (model/gad.py:multidim_sweeps,
# model/som.py:som_sweeps): each writes every padded cell, so each reads
# every padded cell of these, but O's R sweep, which forms no flux at the
# surface, reads wVel and recip_drC below it only
O_VOLUME = ("recip_hFacC", "recip_rA", "maskInC", "recip_drF")
O_READS = {
    "gad_os7mp_x": ("tracer", "uTrans", "uVel", "maskW", "maskInW",
                    "recip_dxC") + O_VOLUME,
    "gad_os7mp_y": ("localX", "tracer", "vTrans", "vVel", "maskS",
                    "maskInS", "recip_dyC") + O_VOLUME,
    "gad_os7mp_r": ("localY", "tracer", "rTrans", "wVel", "maskC",
                    "recip_drC") + O_VOLUME}
SOM_READS = {
    "som_x": (("smTr", "uVel", "tracer", "hFacW", "dyG", "drF", "rA",
               "hFacC", "maskC"), ("volX", "oX", "smX")),
    "som_y": (("volX", "oX", "smX", "vVel", "hFacS", "dxG", "drF"),
              ("volY", "oY", "smY")),
    "som_r": (("volY", "oY", "smY", "wVel", "tracer", "rA", "maskC",
               "maskInC", "recip_rA", "recip_drF", "recip_hFacC"),
              ("gTr", "smNew"))}


# the fields that each sweep of kernel P reads, the same way; PQM also
# reads the spacings of its edge slopes, and R reads wVel where it forms a
# flux, below the surface
P_READS = {
    "gad_ppm_x": ("tracer", "uTrans", "uVel", "maskC", "recip_dxF")
    + O_VOLUME,
    "gad_ppm_y": ("localX", "tracer", "vTrans", "vVel", "maskC",
                  "recip_dyF") + O_VOLUME,
    "gad_ppm_r": ("localY", "tracer", "rTrans", "wVel", "maskC") + O_VOLUME}
PQM_READS = {"gad_ppm_x": ("recip_dxC", "dxF"),
             "gad_ppm_y": ("recip_dyC", "dyF"),
             "gad_ppm_r": ("recip_drC", "drF")}


# the fields that each sweep of kernel M reads, the same way: O's, but the
# face masks only for schemes 30, 33 and 77 and the velocity not for
# scheme 1 in X and Y; in R wVel (at the interfaces below the surface) not
# for schemes 1, 2, 3 and 4, maskC above the bottom level only for 1, 2
# and 20
MD_READS = {f"gad_multidim_{d}": O_READS[f"gad_os7mp_{d}"] for d in "xyr"}


def md_footprint(name, named, args):
    """The inputs of M's sweep `name` as the views that its launch reads
    (args: the launch's source, destination and addend, nr, nyp, nxp,
    scheme, ...): every padded cell of MD_READS[name]'s fields that its
    scheme reads."""
    nr, scheme = args[3], args[6]
    drop, levels = set(), {}
    if name.endswith("_r"):
        levels = {"wVel": slice(1, None), "recip_drC": slice(1, nr)}
        if scheme in (1, 2, 3, 4):
            drop |= {"wVel", "recip_drC"}
        if scheme in (1, 2, 20):
            levels["maskC"] = slice(0, nr - 1)
    else:
        if scheme in (1, 20):
            drop |= {n for n in MD_READS[name] if n.startswith("mask")
                     and n != "maskInC"}
        if scheme == 1:
            drop |= {"uVel", "vVel", "recip_dxC", "recip_dyC"}
    return {n: footprint_view(named[n], 0, 0, None, levels.get(n))
            for n in MD_READS[name] + addend(named) if n not in drop}


def addend(named):
    """("add",) when the wrapper checks a field that the last sweep adds
    to its output (the R sweep's `+ gTr`), else ()."""
    return ("add",) if "add" in named else ()


def ppm_footprint(name, named, args):
    """The inputs of P's sweep `name` as the views that its launch reads
    (args: the launch's source, destination and addend, nr, nyp, nxp,
    scheme, ...): every padded cell of P_READS[name]'s fields (and
    PQM_READS[name]'s for schemes 50-52), in R wVel at the interfaces
    1 .. nr - 1."""
    nr, scheme = args[3], args[6]
    reads = (P_READS[name] + (PQM_READS[name] if scheme >= 50 else ())
             + addend(named))
    levels = {"wVel": slice(1, None)} if name.endswith("_r") else {}
    return {n: footprint_view(named[n], 0, 0, None, levels.get(n))
            for n in reads}


def os7mp_footprint(name, named, args):
    """The inputs of O's sweep `name` as the views that its launch reads
    (args: the launch's source, destination and addend, nr, ...): every
    padded cell of O_READS[name]'s fields, in R wVel and recip_drC at the
    interfaces 1 .. nr - 1."""
    nr = args[3]
    levels = ({"wVel": slice(1, None), "recip_drC": slice(1, nr)}
              if name.endswith("_r") else {})
    return {n: footprint_view(named[n], 0, 0, None, levels.get(n))
            for n in O_READS[name] + addend(named)}


def som_footprint(name, named, args):
    """The inputs of H-SOM's pass `name` as the views that its launch
    reads: every padded cell of SOM_READS[name]'s fields, and of the
    field som_r adds to gTr when it adds one."""
    return {n: named[n] for n in SOM_READS[name][0] + addend(named)}


def gw_footprint(named, args):
    """Kernel W's inputs as the views that its launch reads (args: nr, nyp,
    nxp, coriolis_3d, ...): every padded cell (W writes every padded cell),
    the kappas at the interfaces below the surface, the 3-D Coriolis term's
    three fields only under its flag."""
    skip = () if args[3] else ("fCoriCos", "angleCosC", "angleSinC")
    levels = {"kappaRU": slice(1, None), "kappaRV": slice(1, None)}
    return {n: footprint_view(t, 0, 0, None, levels.get(n))
            for n, t in named.items() if n not in skip}


def ggl90_col_footprint(named, args):
    """G9's ggl90_col's inputs as the views that its launch reads (args:
    params, their count, nr, nyp, nxp, mxlMaxFlag, calcMeanVertShear,
    dirichlet, IDEMIX, Langmuir): every padded cell (it writes every padded
    cell); sigmaR and IDEMIX's gTKE below the surface, recip_drC between
    the levels; Ro_surf and R_low for the limiters of flags 0 and 1, drF
    for the sweeps of flags 2 and 3, rF between the levels for flag 1's
    limiter and Langmuir's Stokes drift; hFacC and gTKE only with IDEMIX."""
    nr, flag, idemix, langmuir = args[2], args[5], args[8], args[9]
    skip = {"drF"} if flag < 2 else {"Ro_surf", "R_low"}
    if not (flag == 1 or langmuir):
        skip.add("rF")
    if not idemix:
        skip |= {"hFacC", "gTKE"}
    levels = {"sigmaR": slice(1, None), "gTKE": slice(1, None),
              "recip_drC": slice(1, nr), "rF": slice(1, nr)}
    return {n: footprint_view(t, 0, 0, None, levels.get(n))
            for n, t in named.items() if n not in skip}


def kappa_uv_footprint(named, args):
    """Kernel J-uv's inputs as the views that its launch reads (args: nr,
    nyp, nxp, mode, viscAr): KPP's viscAz and the masks in mode 1, GGL90's
    viscArU and viscArV in mode 2, every padded cell (it writes every
    padded cell)."""
    reads = {1: ("maskW", "maskS", "viscAz"),
             2: ("viscArU", "viscArV")}[args[3]]
    return {n: named[n] for n in reads}


def kappa_ts_footprint(named, args):
    """Kernel J-ts's inputs as the views that its launch reads (args:
    params, their count, nr, nyp, nxp, KPP, GM, GGL90): every padded cell
    of GM's Kwz and maskInC and of GGL90's diffKr; with KPP its nonlocal
    flux's fields below the surface (ghat above the bottom), its 2-D
    forcing whole, and diffKzT and diffKzS at every level under GM."""
    gm, below = args[6], slice(1, None)
    levels = {"diffKzT": None if gm else below,
              "diffKzS": None if gm else below, "maskUp": below,
              "ghat": slice(0, args[2] - 1)}
    return {n: footprint_view(t, 0, 0, None, levels.get(n))
            for n, t in named.items() if n not in KAPPA_TS_OUTS}


def adv_flow_footprint(named, args):
    """Kernel L's inputs: every padded cell (it writes every padded cell;
    the surface's maskUp of 0 still multiplies w rA, which keeps a NaN)."""
    return {n: t for n, t in named.items() if n not in ADV_FLOW_OUTS}


def find_rho_footprint(named, args):
    """Kernel R's eos_find_rho's inputs: every cell of what its wrapper
    checks for the kind (the tracers, totPhiHyd under use_phi, maskC when
    given; the pressure profile, or tRef and sRef, at every level)."""
    return {n: t for n, t in named.items() if n != "rho"}


def sigma_r_footprint(named, args):
    """Kernel R's eos_sigma_r's inputs (args: params, their count, nr, nyp,
    nxp, kind, use_phi): the tracers above the bottom level (the k-1
    water), totPhiHyd, rhoInSitu and the profiles below the surface,
    recip_drC between the levels, maskC whole; the surface reads none."""
    nr = args[2]
    below, above = slice(1, None), slice(0, nr - 1)
    levels = {"theta": above, "salt": above, "recip_drC": slice(1, nr)}
    return {n: footprint_view(t, 0, 0, None, levels.get(
        n, None if n == "maskC" else below))
        for n, t in named.items() if n != "sigmaR"}


def footprint_view(t, oly, olx, ring, levels):
    """The cells of t that a kernel reads: for a field of the padded grid
    its interior and the ring sides named (ring None: the interior only),
    at the levels given (None: all); a 1-D field's levels; a 0-d tensor
    whole."""
    if t.dim() == 0:
        return t
    if t.dim() == 1:
        return t if levels is None else t[levels]
    s, n, w, e = ring or (0, 0, 0, 0)
    ny, nx = t.shape[-2] - 2 * oly, t.shape[-1] - 2 * olx
    view = t[..., oly - s:oly + ny + n, olx - w:olx + nx + e]
    if levels is not None and t.dim() == 3:
        view = view[levels]
    return view


FOOTPRINTS = {"mom_fluxform": (mom_footprint, ("gU", "gV", "guDiss",
                                               "gvDiss")),
              "mom_vecinv": (vecinv_footprint, ("gU", "gV", "guDiss",
                                                "gvDiss")),
              "mom_fluxform_adj": (mom_adj_footprint, ("u_bar", "v_bar",
                                                       "w_bar")),
              "gad_calc_rhs_c2": (gad_footprint, ("last",)),
              "gad_calc_rhs_c2_gm": (gad_footprint, ("last",)),
              "phihyd": (phihyd_footprint, ("phiHydC", "dPhiHydX",
                                            "dPhiHydY")),
              "mom_correction": (mom_correction_footprint, ("u", "v")),
              "calc_gw": (gw_footprint, ("gW", "gwDiss")),
              "ggl90_col": (ggl90_col_footprint, ("tkeNew", "diffKr",
                                                  "visctmp")),
              "kappa_uv": (kappa_uv_footprint, ("kappaRU", "kappaRV")),
              "kappa_ts": (kappa_ts_footprint, KAPPA_TS_OUTS),
              "adv_flow": (adv_flow_footprint, ADV_FLOW_OUTS),
              "eos_find_rho": (find_rho_footprint, ("rho",)),
              "eos_sigma_r": (sigma_r_footprint, ("sigmaR",)),
              # the launches' integers follow their pointers
              "cg3d_s_stencil_dot": (
                  lambda named, args: cg3d_footprint(named, args[-5:]),
                  ("s_out", "qa", "dot_out")),
              "cg3d_xr_precond": (
                  lambda named, args: cg3d_footprint(named, args[-7:-2]),
                  ("x", "r", "q", "err_out", "eta_out")),
              **{name: (lambda named, args, name=name: os7mp_footprint(
                  name, named, args), (out,))
                 for name, out in zip(O_READS, ("localX", "localY", "gTr"))},
              **{name: (lambda named, args, name=name: ppm_footprint(
                  name, named, args), (out,))
                 for name, out in zip(P_READS, ("localX", "localY", "gTr"))},
              **{name: (lambda named, args, name=name: md_footprint(
                  name, named, args), (out,))
                 for name, out in zip(MD_READS, ("localX", "localY", "gTr"))},
              **{name: (lambda named, args, name=name: som_footprint(
                  name, named, args), outs)
                 for name, (_, outs) in SOM_READS.items()}}


def moved_bytes(name, call):
    """(bytes, cells): the bytes of the distinct tensors that the kernel's
    wrapper checks in one call (each input read once, each output written
    once, an in-place one both), and the most cells any of them covers.
    For a kernel of FOOTPRINTS, each input counts only the cells and levels
    that its launch reads (its flags taken from the launch), each output
    whole, an in-place one both."""
    from mitgcm_tpu_torch import kernels

    named, args = {}, []

    def spy(check):
        def wrapped(first, *rest, **tensors):
            if isinstance(first, str):     # check_int32(name, t, shape)
                tensors = {first: rest[0]}
            for n, t in tensors.items():
                if n not in SCRATCH:
                    named[n] = t
            return check(first, *rest, **({} if isinstance(first, str)
                                           else tensors))
        return wrapped

    def spy_launch(kernel, dtype, *rest):
        if kernel == name:
            args.append(rest[2:])
        return saved[2](kernel, dtype, *rest)

    saved = kernels.check_tensors, kernels.check_int32, kernels.launch
    kernels.check_tensors = spy(saved[0])
    kernels.check_int32 = spy(saved[1])
    kernels.launch = spy_launch
    try:
        call()
    finally:
        kernels.check_tensors, kernels.check_int32, kernels.launch = saved
    if name in FOOTPRINTS:
        footprint, outs = FOOTPRINTS[name]
        if len(args) != 1:
            raise AssertionError(f"{name}: {len(args)} launches in a call")
        both = IN_PLACE.get(name, ())
        ins = {n: t for n, t in named.items() if n not in outs or n in both}
        seen = {}
        for side, views in (("read", footprint(ins, args[0])),
                            ("written", {n: named[n] for n in outs
                                         if n in named})):
            for n, v in views.items():   # a tensor passed twice counts once
                key = (named[n].data_ptr(), side)
                nbytes = max(v.numel() * v.element_size(),
                             seen.get(key, (0,))[0])
                seen[key] = (nbytes, cells_of(v))
    else:
        seen = {}
        for n, t in named.items():
            times = 2 if n in IN_PLACE.get(name, ()) else 1
            seen[t.data_ptr()] = (times * t.numel() * t.element_size(),
                                  cells_of(t))
    return (sum(b for b, _ in seen.values()),
            max(n for _, n in seen.values()))


def bound(name, call, tensors=None):
    """(bound_ms, bound_by) of one call of the kernel at these shapes, from
    the tensors its wrapper checks in the call, or from `tensors` when
    given (the distinct tensors that the launch reads and writes)."""
    if tensors is None:
        nbytes, cells = moved_bytes(name, call)
    else:
        distinct = {t.data_ptr(): t for t in tensors}.values()
        nbytes = sum(t.numel() * t.element_size() for t in distinct)
        cells = max(cells_of(t) for t in distinct)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = OPS_PER_CELL[name] * cells / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name, case, outs_k, outs_p, ms, plain_ms, results,
            whole=False, call=None, tensors=None):
    """Hold a kernel's outputs against its twin's: on the interior, or on
    every cell when whole (a VJP's halo cells carry cotangents too). call
    (the kernel path once) gives the kernel's bound, or tensors (what one
    launch reads and writes)."""
    from mitgcm_tpu_torch.utils.compare import interior, rel_err

    def cells(t):   # interior of a field; a 0-d dot product as it is
        if whole or not t.dim():
            return t.cpu().numpy()
        return interior(t, case.cfg.olx)

    rel = max(rel_err(cells(k), cells(p)) for k, p in zip(outs_k, outs_p))
    abs_err = max(float(np.max(np.abs(cells(k) - cells(p))))
                  for k, p in zip(outs_k, outs_p))
    tol = TOL[case.dtype]
    print(f"{name:18s} {case.label:18s} max rel err {rel:.3e} "
          f"(tol {tol:g}), max abs err {abs_err:.3e}, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{name} disagrees with its plain twin at "
                             f"{case.label}: {rel:.3e} > {tol:g}")
    results[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None}
    if call is not None or tensors is not None:
        results[name]["bound_ms"], results[name]["bound_by"] = bound(
            name.split("(")[0], call, tensors)
        print(f"{'':18s} bound {results[name]['bound_ms']:.4f} ms "
              f"({results[name]['bound_by']})", flush=True)


# B's template flags (no-slip sides, the 3-D Coriolis term): the gyres run
# the first pair, the nh-convection box the last
MOM_VARIANTS = ((True, False), (True, True), (False, False), (False, True))
# C's flags (implicit diffusion, advection, df): the gyre runs the first
CALC_RHS_VARIANTS = tuple((imp, adv, df) for imp in (False, True)
                          for adv in (True, False) for df in (False, True))


def kernel_phase(case, results, reps):
    """B in each of its four flag variants and C with each combination of
    its flags against their twins on the interior (their halo outputs are
    zeros by design), bit for bit; the gyre's variants are timed and give
    the JSON rows. Then kernel A."""
    import dataclasses

    from mitgcm_tpu_torch.model.gad import calc_rhs
    from mitgcm_tpu_torch.model.mom_fluxform import mom_fluxform

    cfg, g = case.cfg, case.grid
    ol = cfg.olx

    for no_slip, cori3d in MOM_VARIANTS:
        vcfg = dataclasses.replace(cfg, no_slip_sides=no_slip,
                                   select3dCoriScheme=int(cori3d))

        def mom(impl, vcfg=vcfg):
            t = mom_fluxform(vcfg, g, case.u, case.v, case.w, case.kappaRU,
                             case.kappaRV, impl=impl)
            return [f[:, ol:-ol, ol:-ol] for f in t]

        main = (no_slip, cori3d) == MOM_VARIANTS[0]
        name = "mom_fluxform" + ("" if main else (
            f"({'no-slip' if no_slip else 'free-slip'}"
            f"{', 3-D Coriolis' if cori3d else ''})"))
        exact_compare(name, case, mom(None), mom("plain"),
                      cuda_time_ms(lambda: mom(None), reps) if main else None,
                      cuda_time_ms(lambda: mom("plain"), reps)
                      if main else None, results, call=lambda: mom(None))

    for implicit, adv, with_df in CALC_RHS_VARIANTS:
        def rhs(impl, implicit=implicit, adv=adv, with_df=with_df):
            return calc_rhs(cfg, g, case.flow, case.theta, case.kappaR,
                            cfg.diffKhT, implicit_diffusion=implicit,
                            impl=impl, df=case.df if with_df else None,
                            calc_advection=adv)[:, ol:-ol, ol:-ol]

        main = (implicit, adv, with_df) == CALC_RHS_VARIANTS[0]
        flags = [f for f, on in (("implicit", implicit), ("no adv", not adv),
                                 ("df", with_df)) if on]
        name = "gad_calc_rhs_c2" + ("" if main else f"({', '.join(flags)})")
        exact_compare(name, case, [rhs(None)], [rhs("plain")],
                      cuda_time_ms(lambda: rhs(None), reps) if main else None,
                      cuda_time_ms(lambda: rhs("plain"), reps)
                      if main else None, results, call=lambda: rhs(None))

    cg2d_phase(case, results, reps)


def cg2d_cases(case):
    """(label, cfg, b, x0) of the whole cg2d solves phase 3 holds: the
    gyre's operator with a seeded right-hand side, from a zero first guess
    (the JSON row's case) and from a nonzero one with the min-residual
    selection on and off, at a cap of 5 iterations with it on and off, and
    a zero right-hand side (rhsMax = 0, no iteration)."""
    import dataclasses

    cfg, g = case.cfg, case.grid
    b = case.y2 * g.maskInC
    warm = 0.1 * case.z2 * g.maskInC
    zero = torch.zeros_like(b)
    return [("zero first guess", cfg, b, zero)] + [
        (f"warm start, min-res {m}{', cap 5' if cap else ''}",
         dataclasses.replace(cfg, cg2dUseMinResSol=m,
                             cg2dMaxIters=cap or cfg.cg2dMaxIters), b, warm)
        for cap in (None, 5) for m in (1, 0)] + [
        ("zero right-hand side", cfg, zero, zero)]


def launch_event_ms(call, name, reps):
    """Device ms of the launch of kernel `name` that each call of `call`
    makes: CUDA events recorded just before and just after that launch,
    the median over reps calls after a warm-up call. For a launch that a
    replay would not repeat (cg2d_solve updates its first guess in
    place)."""
    from mitgcm_tpu_torch import kernels

    saved, events = kernels.launch, []

    def timed(*args):
        if args[0] != name:
            return saved(*args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        saved(*args)
        ev[1].record()
        events.append(ev)

    kernels.launch = timed
    try:
        call()
        events.clear()
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    finally:
        kernels.launch = saved
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def cg2d_bound(b, n_iters, oly, olx):
    """(bound_ms, bound_by, per-iteration ms) of a cg2d solve on the
    interior cells, where it computes: the bytes of the function (the six
    operator fields, b and x0 read once, x written once) over 3.35 TB/s
    against its operations (~30 a cell an iteration: two 5-point
    stencils, three dot products, the s, x and r updates) over 67
    TFLOP/s; and, per iteration, the ~17 fields its two phases read and
    write if each streamed from HBM."""
    cells = (b.shape[-2] - 2 * oly) * (b.shape[-1] - 2 * olx)
    field = cells * b.element_size()
    t_bytes = 9 * field / PEAK_BYTES_S * 1e3
    t_ops = OPS_PER_CELL["cg2d_solve"] * cells * n_iters \
        / PEAK_F32_OPS_S * 1e3
    per_it = 17 * field / PEAK_BYTES_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", per_it
    return t_ops, "operations", per_it


def cg2d_phase(case, results, reps):
    """Kernel A: every case of cg2d_cases, the kernel path (one
    cg2d_solve launch, one host read: count_cg2d_reads witnesses it)
    against the plain path's host loop, bit for bit: x on the whole
    padded array, the first and last residual, the iterations."""
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.solver import cg2d as cg

    op = case.op
    for k, (label, cfg, b, x0) in enumerate(cg2d_cases(case)):
        n0 = kernels.launches["cg2d_solve"]
        r0 = kernels.launches[CG2D_READS]
        res_k = cg.cg2d(cfg, op, b, x0)
        n_launch = kernels.launches["cg2d_solve"] - n0
        n_read = kernels.launches[CG2D_READS] - r0
        res_p = cg.cg2d(cfg, op, b, x0, impl="plain")
        same = (torch.equal(res_k.x, res_p.x)
                and torch.equal(res_k.first_residual, res_p.first_residual)
                and torch.equal(res_k.last_residual, res_p.last_residual)
                and res_k.n_iters == res_p.n_iters)
        err = float((res_k.x - res_p.x).abs().max())
        print(f"cg2d_solve {case.label:18s} {label}: iterations "
              f"{res_k.n_iters} / {res_p.n_iters} (kernel / plain), "
              f"residual {float(res_k.first_residual):.6e} -> "
              f"{float(res_k.last_residual):.6e}, max abs err of x {err:.3e}"
              f", bit-equal {same}; launches {n_launch}, host syncs "
              f"{n_read} (witnessed) / {res_p.host_syncs}", flush=True)
        if not (same and n_launch == 1 and n_read == 1):
            raise AssertionError(f"cg2d_solve disagrees with the plain path "
                                 f"at {case.label}, {label}")
        if k:
            continue
        ms = launch_event_ms(lambda: cg.cg2d(cfg, op, b, x0), "cg2d_solve",
                             reps)
        call_ms = cuda_time_ms(lambda: cg.cg2d(cfg, op, b, x0), reps)
        plain_ms = cuda_time_ms(lambda: cg.cg2d(cfg, op, b, x0,
                                                impl="plain"), 3)
        bound_ms, by, per_it = cg2d_bound(b, res_k.n_iters, cfg.oly,
                                          cfg.olx)
        it = max(res_k.n_iters, 1)
        results["cg2d_solve"] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": by, "library_ms": None,
                                 "extra": {"iterations": res_k.n_iters,
                                           "ms_per_iteration": ms / it,
                                           "bound_ms_per_iteration":
                                               bound_ms / it}}
        print(f"{'':18s} the launch {ms:.4f} ms ({ms / it:.5f} an "
              f"iteration), the wrapper call with its glue and host read "
              f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({by}); the phases' fields streamed from "
              f"HBM {per_it:.5f} ms an iteration", flush=True)


def parity_phase():
    phase("4 parity: 64x64x4 gyre, float64, 10 steps, kernel vs plain")
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic
    from mitgcm_tpu_torch.utils.compare import record_digits

    runs = {}
    for impl in (None, "plain"):
        cfg = synthetic.gyre_config(nx=64, ny=64, nr=4)
        grid, state, forcing, op = synthetic.gyre_setup(
            cfg, dtype=torch.float64, device="cuda")
        runs[impl] = Experiment(cfg, grid, state, forcing, op,
                                impl=impl).run(n_steps=10)
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, init res {rk['cg2d_init_res']:.10e}, "
              f"fewest digits {dig[key]:.2f} ({key})", flush=True)
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError("cg2d iteration counts differ")
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"slice parity {worst:.2f} < {PARITY_DIGITS} "
                             "digits")
    print(f"slice parity: fewest matching digits {worst:.2f}")


def full_phase(kernels):
    phase("5 full size: 1024x1024x32 gyre, float32, deltaT=600")
    from mitgcm_tpu_torch.model.step import forward_step
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.gyre_config(nx=1024, ny=1024, nr=32, deltaT=600.0)
    t0 = time.perf_counter()
    grid, state0, forcing, op = synthetic.gyre_setup(
        cfg, dtype=torch.float32, device="cuda",
        grid=shared_grid(cfg, torch.float32))
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    points = cfg.nx * cfg.ny * cfg.nr

    def run(state, it0, n, impl):
        iters = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for it in range(it0, it0 + n):
            state, diag = forward_step(cfg, grid, op, state, forcing, it,
                                       impl=impl)
            iters.append(diag.cg2d_iters)
        torch.cuda.synchronize()
        return state, iters, time.perf_counter() - t, diag

    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    state1, iters_w, sec_w, _ = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = glue_plain_calls()
    state, iters, sec, diag = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = glue_plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"kernel path: 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations "
          f"{iters}, host syncs in the last solve {diag.cg2d_host_syncs}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    shape3 = (cfg.nr, cfg.ny + 2 * cfg.oly, cfg.nx + 2 * cfg.olx)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        field = getattr(state, name)
        want = shape3[1:] if name == "etaN" else shape3
        if tuple(field.shape) != want:
            raise AssertionError(f"{name} has shape {tuple(field.shape)}")
        if not bool(torch.isfinite(field).all()):
            raise AssertionError(f"{name} is not finite after 6 steps")
    missing = [k for k in KERNELS
               if k not in BACKWARD_KERNELS + VI_KERNELS + KPP_KERNELS
               + G9_KERNELS + MD_KERNELS + O_KERNELS + P_KERNELS
               + IDEMIX_KERNELS + SOM_KERNELS + NH_KERNELS + ICE_KERNELS
               + SEAICE_GLUE_KERNELS + EVP_KERNELS + GM_KERNELS
               + VISC_KERNELS + RIMIX_KERNELS + CD_SHAP_ROWS
               + THSICE_KERNELS + EXACT_ICE_KERNELS
               + ("eos_sigma_r", "kappa_uv", "kappa_ts")
               and launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    check_launches("gyre", launches, GYRE_LAUNCHES, plain)
    _, iters_p, sec_p, _ = run(state1, 1, 2, "plain")
    print(f"plain path: 2 steps, {sec_p * 1e3 / 2:.2f} ms/step, "
          f"{points * 2 / sec_p:.4e} points*steps/s, cg2d iterations "
          f"{iters_p}", flush=True)
    return launches


def vjp_phase(case, results, reps):
    """B' and C' against autograd through their plain twins, on the same
    seeded inputs and cotangents seeded on interior cells only (kernel
    B's and C's halo outputs are constant zeros); each timed as the
    backward pass of its module on a retained graph."""
    from mitgcm_tpu_torch.model import gad
    from mitgcm_tpu_torch.model import mom_fluxform as mom

    cfg, g = case.cfg, case.grid
    rng = np.random.default_rng(SEED + 1)
    shape = tuple(g.hFacC.shape)
    inner = torch.zeros(shape, dtype=case.dtype, device="cuda")
    inner[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx] = 1.0

    def timed_backward(fwd, ins, bars):
        """Closures (kernel path, plain path) that return the cotangents
        of ins from fwd(impl, *ins), on a graph recorded once."""
        def run(impl):
            xs = [t.clone().requires_grad_(True) for t in ins]
            outs = fwd(impl, *xs)
            return lambda: torch.autograd.grad(outs, xs, bars,
                                               retain_graph=True)
        return run(None), run("plain")

    def mom_fwd(impl, u, v, w):
        return mom.mom_fluxform(cfg, g, u, v, w, case.kappaRU, case.kappaRV,
                                impl=impl)
    bars = [case.field(rng, shape, 1.0) * inner for _ in range(4)]
    k, p = timed_backward(mom_fwd, (case.u, case.v, case.w), bars)
    compare("mom_fluxform_adj", case, k(), p(), cuda_time_ms(k, reps),
            cuda_time_ms(p, reps), results, whole=True, call=k)

    def rhs_fwd(impl, t, uT, vT, rT):
        flow = case.flow._replace(uTrans=uT, vTrans=vT, rTrans=rT,
                                  rTransKp=torch.cat(
                                      [rT[1:], torch.zeros_like(rT[:1])]))
        return gad.calc_rhs(cfg, g, flow, t, case.kappaR, cfg.diffKhT,
                            impl=impl)
    bar = case.field(rng, shape, 1.0) * inner
    k, p = timed_backward(rhs_fwd, (case.theta, case.flow.uTrans,
                                    case.flow.vTrans, case.flow.rTrans), bar)
    compare("gad_calc_rhs_c2_adj", case, k(), p(), cuda_time_ms(k, reps),
            cuda_time_ms(p, reps), results, whole=True, call=k)


def pick(outs, need):
    """The outputs that `need` asks for, those that are not None."""
    return [t for t, n in zip(outs, need) if n and t is not None]


def glue_vjp_phase(case, results, reps, variants):
    """F', D', E', G', L' and R' against their plain VJPs (ops/stencil.py,
    model/phihyd.py, model/step.py, model/thermodynamics.py, model/gad.py,
    ops/eos.py: *_vjp_plain) on the same seeded cotangents, bit for bit on
    every padded cell, each with its device time (20 launches in a CUDA
    graph), bound and share (hold_launch). Each asks for the cotangents
    that the gyre's gradient asks for (none of guExt, EmPmR or salt, whose
    forcing and field are constants there). variants: the gyre's
    (AB-2 on its second step), "every" (its cold start too, tracer_step
    without AB, R' without maskC) or "AB-3" (a vi-gyre case: mom_ab_step's
    and tracer_step's AB-3 on the cold-start, second and a later step)."""
    from mitgcm_tpu_torch.model import gad, phihyd, step, thermodynamics as th
    from mitgcm_tpu_torch.ops import eos, stencil

    cfg, g = case.cfg, case.grid
    rng = np.random.default_rng(SEED + 23)
    s3 = tuple(g.hFacC.shape)
    ol = cfg.olx

    def bar(shape=s3):
        return case.field(rng, shape, 1.0)

    def hold(name, kernel, plain):
        hold_launch(name, case, lambda impl: list(
            plain() if impl == "plain" else kernel()), results, reps)

    order = "AB-3" if cfg.useAB3 else "AB-2"
    its = (0, 1, 2) if variants == "AB-3" else (
        (1, 0) if variants == "every" else (1,))
    for it in its:
        label = "" if it == 1 and order == "AB-2" else f"({order}, step {it})"
        need = (True, True, True, False, True, order == "AB-3", True) * 2
        b4 = [bar() for _ in range(4)]     # gu, uStar, gv, vStar
        hold("mom_ab_step_adj" + label, lambda b4=b4, it=it, need=need: pick(
            step._mom_ab_step_adj_kernel(cfg, g, it, need, *b4),
            (1, 1, 0, 0, 1, 1, 0) * 2), lambda b4=b4, it=it: [
                t for t in step.mom_ab_step_vjp_plain(cfg, g, it, *b4)
                if t is not None])
        tb = [bar(), bar()]
        hold("tracer_step_adj" + label, lambda tb=tb, it=it: pick(
            th._tracer_step_adj_kernel(cfg, g, it, True, (True,) * 5, *tb),
            (1, 0, 1, 1, 1)), lambda tb=tb, it=it: pick(
                th.tracer_step_vjp_plain(cfg, g, it, True, *tb),
                (1, 0, 1, 1, 1)))
    if variants == "AB-3":
        return
    if variants == "every":
        tb = bar()
        hold("tracer_step_adj(no AB)", lambda: pick(
            th._tracer_step_adj_kernel(cfg, g, 1, False, (True,) * 5, tb),
            (1, 0, 1, 1, 1)), lambda: pick(
                th.tracer_step_vjp_plain(cfg, g, 1, False, tb),
                (1, 0, 1, 1, 1)))
    for label, shape in (("", s3), ("(2-D)", s3[1:])):
        gb = bar(shape)
        hold("halo_fold" + label, lambda gb=gb: [stencil._halo_fold(gb, ol,
                                                                    ol)],
             lambda gb=gb: [stencil.halo_fold_vjp_plain(gb, ol, ol)])
    b3 = [bar() for _ in range(3)]
    hold("phihyd_adj", lambda: [phihyd._phi_hyd_adj_kernel(cfg, g, *b3)],
         lambda: [phihyd.phihyd_vjp_plain(cfg, g, *b3)])
    b2 = bar(s3[1:])
    hold("cg2d_rhs_adj", lambda: step._cg2d_rhs_adj_kernel(
        cfg, g, (True,) * 3, b2), lambda: step.cg2d_rhs_vjp_plain(cfg, g, b2))
    wb, pb = bar(), bar(s3[1:])
    need = (True, True, False)
    hold("continuity_adj", lambda: pick(step._continuity_adj_kernel(
        cfg, g, need, wb, pb), need), lambda: pick(
            step.continuity_vjp_plain(cfg, g, wb, pb), need))
    ub, vb = bar(), bar()
    hold("mom_correction_adj", lambda: step._mom_correction_adj_kernel(
        cfg, g, (True,) * 3, ub, vb), lambda: step.mom_correction_vjp_plain(
            cfg, g, ub, vb))
    b4 = [bar() for _ in range(4)]
    hold("adv_flow_adj", lambda: gad._adv_flow_adj_kernel(
        g, (True,) * 3, *b4), lambda: gad.adv_flow_vjp_plain(g, *b4))
    rb = bar()
    need = (True, False)
    for label, mask in (("", g.maskC), ("(no mask)", None))[
            :2 if variants == "every" else 1]:
        hold("eos_linear_adj" + label, lambda mask=mask: pick(
            eos._eos_linear_adj_kernel(cfg, need, rb, mask), need),
            lambda mask=mask: pick(eos.eos_linear_vjp_plain(cfg, rb, mask),
                                   need))


def adjoint_objective(n, nr, dtype, n_steps, box, k_range, deltaT=1200.0,
                      impl=None):
    """(cfg, control, J) of a box-mean theta cost after n_steps of the
    gyre on the card, with a 3-D theta control."""
    from mitgcm_tpu_torch.ad import adjoint
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.gyre_config(nx=n, ny=n, nr=nr, n_steps=n_steps,
                                deltaT=deltaT)
    grid, state, forcing, op = synthetic.gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    control = adjoint.Control(cfg, grid, field="theta")
    cost = adjoint.cost_boxmean_tracer(cfg, grid, "theta", box=box,
                                       k_range=k_range)
    return cfg, control, {impl: adjoint.make_objective(
        cfg, grid, op, forcing, state, control, cost, n_steps, impl=impl)
        for impl in (None, "plain")}


def grdchk_phase():
    """tests/test_adjoint.py's set-up on the card, on the kernel path."""
    from mitgcm_tpu_torch.ad import grdchk
    from mitgcm_tpu_torch.ad.adjoint import adjoint_gradient
    from mitgcm_tpu_torch.utils.compare import digits

    cfg, control, J = adjoint_objective(16, 4, torch.float64, 6,
                                        (8, 12, 8, 12), (0, 2))
    positions = [(1, cfg.oly + 9, cfg.olx + 9), (0, cfg.oly + 10, cfg.olx + 8),
                 (2, cfg.oly + 6, cfg.olx + 11)]
    for r in grdchk.grdchk(J[None], control.zero(), positions, eps=1.0e-4):
        print(f"grdchk {r['pos']}: adjoint {r['adj_grad']:.10e}, finite "
              f"difference {r['fd_grad']:.10e}, 1 - fd/adj "
              f"{r['rel_err']:.3e}", flush=True)
        if r["adj_grad"] == 0.0 or not abs(r["rel_err"]) < GRDCHK_TOL:
            raise AssertionError(f"grdchk fails at {r['pos']}")
    _, g1 = adjoint_gradient(J[None], control.zero())
    _, g2 = adjoint_gradient(J[None], control.zero())
    _, gp = adjoint_gradient(J["plain"], control.zero())
    dig = digits(g1.cpu().numpy(), gp.cpu().numpy())
    same = torch.equal(g1, g2)
    print(f"gradient: kernel path vs plain path {dig:.2f} digits; two "
          f"kernel-path runs bit-equal: {same}", flush=True)
    if not (dig >= PARITY_DIGITS and same):
        raise AssertionError("the kernel-path gradient disagrees")


def adjoint_full_phase(kernels):
    """Gradient of a box cost through 6 checkpointed steps (2 chunks of 3)
    of the 1024x1024x32 float32 gyre."""
    from mitgcm_tpu_torch.ad.adjoint import adjoint_gradient

    n, nr, n_steps = 1024, 32, 6
    box, k_range = (512, 768, 512, 768), (0, 2)
    cfg, control, J = adjoint_objective(n, nr, torch.float32, n_steps, box,
                                        k_range, deltaT=600.0)
    xx = control.zero()

    def ms_per_step(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3 / n_steps

    # three runs of each, the host's load moves single readings a lot
    with torch.no_grad():
        fwd = [ms_per_step(lambda: J[None](xx))[1] for _ in range(3)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    plain0 = glue_plain_calls()
    (fc, grad), ms = ms_per_step(lambda: adjoint_gradient(J[None], xx))
    plain = glue_plain_calls() - plain0
    launches = dict(kernels.launches)
    adj = [ms] + [ms_per_step(lambda: adjoint_gradient(J[None], xx))[1]
                  for _ in range(2)]
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd_ms, adj_ms = float(np.median(fwd)), float(np.median(adj))
    print(f"forward only: {fwd_ms:.2f} ms/step (runs "
          f"{', '.join(f'{x:.2f}' for x in fwd)}); value_and_grad: "
          f"{adj_ms:.2f} ms/step (runs {', '.join(f'{x:.2f}' for x in adj)});"
          f" ratio of the medians {adj_ms / fwd_ms:.2f}; peak device memory "
          f"{peak:.2f} GiB; cost {float(fc):.6e}", flush=True)
    for name in CG2D_KERNELS:
        n_adj = launches.get(f"{name}:adjoint", 0)
        print(f"{name}: {launches.get(name, 0) - n_adj} forward launches "
              f"(recomputation included), {n_adj} in the adjoint solves")
    print(f"launches {launches}", flush=True)
    inner = grad[:, cfg.oly:-cfg.oly, cfg.olx:-cfg.olx]
    nonzero = int((inner != 0).sum())
    in_box = (box[1] - box[0]) * (box[3] - box[2]) * (k_range[1] - k_range[0])
    print(f"gradient: {nonzero} nonzero interior cells (the box holds "
          f"{in_box}), max |grad| {float(grad.abs().max()):.6e}", flush=True)
    if not bool(torch.isfinite(grad).all()):
        raise AssertionError("the full-size gradient is not finite")
    if not nonzero > in_box:
        raise AssertionError("the sensitivity did not leave the cost box")
    missing = [k for k in BACKWARD_KERNELS + tuple(
        f"{c}:adjoint" for c in CG2D_KERNELS) if launches.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"never launched in the adjoint: {missing}")
    print(f"forward step bodies run (B's launches): "
          f"{launches.get('mom_fluxform', 0)}", flush=True)
    check_launches("adjoint", launches, ADJ_LAUNCHES, plain)
    return launches


# V's template variants beside the vi-gyre's (vorticity scheme 1, Coriolis
# scheme 0, implicit viscosity, no-slip bottom drag): the settings each
# changes in the configuration; phase 7 holds the others at its small size
VI_VARIANTS = {
    "": {}, "vort 0": {"selectVortScheme": 0},
    "vort 2": {"selectVortScheme": 2}, "Coriolis 1": {"selectCoriScheme": 1},
    "explicit": {"implicitViscosity": False},
    "explicit, vort 0, Coriolis 1": {"implicitViscosity": False,
                                     "selectVortScheme": 0,
                                     "selectCoriScheme": 1},
    "no-slip and linear drag": {"bottomDragLinear": 2e-4},
    "linear drag": {"no_slip_bottom": False, "bottomDragLinear": 2e-4},
    "no drag": {"no_slip_bottom": False}}


def vi_kernel_phase(case, results, reps):
    """Kernels V, T and R against their twins on the same seeded inputs: V
    bit for bit on the interior, its halo outputs zeros (the vi-gyre's
    variant, and at the small size each of VI_VARIANTS), T and R on whole
    arrays (a column solve and a pointwise pass compute their halos as the
    twins do). R on the vi-gyre's JMD95Z (the main path's, in the summary)
    and on MDJWF with the pressure from totPhiHyd."""
    import dataclasses

    from mitgcm_tpu_torch.model.mom_vecinv import mom_vecinv
    from mitgcm_tpu_torch.model.thermodynamics import impldiff
    from mitgcm_tpu_torch.ops.eos import find_rho

    cfg, g = case.cfg, case.grid
    ol = cfg.olx
    variants = VI_VARIANTS if case.dtype == torch.float64 else {"": {}}
    for label, settings in variants.items():
        vcfg = dataclasses.replace(cfg, **settings)

        def mom(impl, vcfg=vcfg):
            return mom_vecinv(vcfg, g, case.u, case.v, case.w, case.kappaRU,
                              case.kappaRV, impl=impl)

        outs = mom(None)
        halo = [t.clone() for t in outs]
        for t in halo:
            t[:, ol:-ol, ol:-ol] = 0.0
        if not all(float(t.abs().max()) == 0.0 for t in halo):
            raise AssertionError(f"mom_vecinv({label}): a halo output is "
                                 "not 0")
        main = not label
        name = "mom_vecinv" + ("" if main else f"({label})")
        exact_compare(name, case, [f[:, ol:-ol, ol:-ol] for f in outs],
                      [f[:, ol:-ol, ol:-ol] for f in mom("plain")],
                      cuda_time_ms(lambda: mom(None), reps) if main else None,
                      cuda_time_ms(lambda: mom("plain"), reps)
                      if main else None, results, call=lambda: mom(None))

    # T as the step runs it: a tracer at C points with its [nr] kappa, and
    # uStar at W points with kappaRU [nr+1]; the times are the tracer's
    def solve(impl, field, kappa, recip_hFac):
        return impldiff(cfg, g, field, kappa, recip_hFac, cfg.deltaTTracer,
                        impl=impl)

    for name, args in (("impldiff", (case.theta, case.kappaR,
                                     g.recip_hFacC)),
                       ("impldiff(W)", (case.u, case.kappaRU,
                                        g.recip_hFacW))):
        compare(name, case, [solve(None, *args)], [solve("plain", *args)],
                cuda_time_ms(lambda: solve(None, *args), reps),
                cuda_time_ms(lambda: solve("plain", *args), reps), results,
                whole=True, call=lambda: solve(None, *args))

    mdjwf = dataclasses.replace(cfg, eosType="MDJWF", selectP_inEOS_Zc=2)
    for name, c in (("eos_find_rho", cfg), ("eos_find_rho(MDJWF)", mdjwf)):
        def rho(impl):
            return find_rho(c, g, case.theta, case.salt, totPhiHyd=case.phi,
                            impl=impl)
        compare(name, case, [rho(None)], [rho("plain")],
                cuda_time_ms(lambda: rho(None), reps),
                cuda_time_ms(lambda: rho("plain"), reps), results,
                whole=True, call=lambda: rho(None))


def vi_experiment(n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.vi_gyre_config(nx=n, ny=n, nr=nr, **kw)
    return Experiment(cfg, *synthetic.gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype)),
        impl=impl)


def vi_parity_phase():
    from mitgcm_tpu_torch.utils.compare import record_digits

    runs = {impl: vi_experiment(64, 4, torch.float64, impl).run(n_steps=10)
            for impl in (None, "plain")}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"vi step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, init res {rk['cg2d_init_res']:.10e}, "
              f"fewest digits {dig[key]:.2f} ({key})", flush=True)
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError("vi-gyre cg2d iteration counts differ")
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"vi-gyre parity {worst:.2f} < {PARITY_DIGITS} "
                             "digits")
    print(f"vi-gyre parity: fewest matching digits {worst:.2f}")


def vi_restart_phase():
    """tools/do_tst_2+2 on the card: 4 steps against 2 + pickup + 2."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import read_pickup, write_pickup

    e4 = vi_experiment(64, 4, torch.float64)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = vi_experiment(64, 4, torch.float64)
    e2.run(n_steps=2, collect_monitor=False)
    e22 = vi_experiment(64, 4, torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        write_pickup(e2, tmp, 2)
        read_pickup(e22, tmp, 2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    names = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1",
             "guNm2", "gtNm1", "gtNm2", "gsNm2")
    differ = [n for n in names
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    print(f"2+2 restart on the kernel path, 64x64x4 float64: "
          f"{len(names) - len(differ)} of {len(names)} fields bit-equal",
          flush=True)
    if differ:
        raise AssertionError(f"restart differs in {differ}")


def vi_full_phase(kernels):
    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = vi_experiment(n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    state0 = exp.state
    points = n * n * nr

    def run(state, it0, steps, impl):
        exp.state, exp.cur_iter, exp.impl = state, it0, impl
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, sec_w = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = glue_plain_calls()
    state, iters, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = glue_plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"kernel path: 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations {iters}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"vi-gyre {name} is not finite")
    check_launches("vi-gyre", launches, VI_LAUNCHES, plain)
    _, iters_p, sec_p = run(state1, 1, 2, "plain")
    print(f"plain path: 2 steps, {sec_p * 1e3 / 2:.2f} ms/step, "
          f"{points * 2 / sec_p:.4e} points*steps/s, cg2d iterations "
          f"{iters_p}", flush=True)
    return launches


def vi_phase(kernels, results):
    phase("7 vi-gyre")
    vi_kernel_phase(Case(64, 4, torch.float64, vi=True), results, reps=20)
    vi_kernel_phase(Case(1024, 32, torch.float32, vi=True), results, reps=10)
    torch.cuda.empty_cache()
    vi_parity_phase()
    vi_restart_phase()
    launches = vi_full_phase(kernels)
    torch.cuda.empty_cache()
    return launches


class KppCase:
    """The kpp-gyre's grid and KPP on the card, with seeded KPP.calc
    arguments: its profiles with noise, random shear and totPhiHyd, the
    wind stress and the heat fluxes of kpp_gyre_setup."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.model import thermodynamics as th
        from mitgcm_tpu_torch.model.step import load_fields
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.kpp_gyre_config(nx=n, ny=n, nr=nr,
                                             deltaT=600.0)
        (self.grid, state, forcing, _,
         self.kpp) = synthetic.kpp_gyre_setup(
            self.cfg, dtype=dtype, device="cuda",
            grid=shared_grid(self.cfg, dtype))
        cfg, g = self.cfg, self.grid
        rng = np.random.default_rng(SEED + 2)
        shape = tuple(g.hFacC.shape)
        prof = dict(dtype=dtype, device="cuda")
        tref = torch.tensor(cfg.tRef, **prof)[:, None, None]
        sref = torch.tensor(cfg.sRef, **prof)[:, None, None]
        forc = load_fields(forcing)
        sf = th.surface_forcing(cfg, g, state, forc)
        self.args = (
            self.field(rng, shape, 0.1) * g.maskW,
            self.field(rng, shape, 0.1) * g.maskS,
            (tref + self.field(rng, shape, 0.3)) * g.maskC,
            (sref + self.field(rng, shape, 0.02)) * g.maskC,
            self.field(rng, shape, 2.0),
            forc.fu * cfg.mass2rUnit + self.field(rng, shape[1:], 1e-5),
            self.field(rng, shape[1:], 1e-5), sf.sfT, sf.sfS, forc.Qsw)
        self.kappa = th.tracer_kappa(cfg, g, cfg.diffKrT)
        self.w = self.field(rng, shape, 1e-4) * g.maskC
        self.df = self.field(rng, shape, 1e-3) * g.maskC

    field = Case.field
    label = Case.label


def kpp_kernel_phase(case, results, reps):
    """K-pre (kpp_pre, kpp_smooth) and K-col against their twins on whole
    arrays (K computes its halo cells as the twins do), kbl identical; and
    C with the nonlocal flux df, as the kpp-gyre runs it (implicit
    vertical diffusion)."""
    from mitgcm_tpu_torch.model import gad
    from mitgcm_tpu_torch.model import kpp as kpp_mod

    kpp, args = case.kpp, case.args
    pre_names = ("dbraw", "dbloc", "ritop", "shsq", "dvsq", "ustar", "bo",
                 "bosol")
    col_names = ("viscAz", "diffKzT", "diffKzS", "ghat", "hbl", "frac")

    def pre(kernel):
        f = kpp_mod.kpp_pre if kernel else kpp_mod._kpp_pre_plain
        return f(kpp, *args)

    pk, pp = pre(True), pre(False)
    compare("kpp_pre", case, [pk[n] for n in pre_names],
            [pp[n] for n in pre_names],
            cuda_time_ms(lambda: pre(True), reps),
            cuda_time_ms(lambda: pre(False), reps), results, whole=True,
            call=lambda: pre(True))

    def smooth(kernel):
        f = kpp_mod.kpp_smooth if kernel else kpp_mod._kpp_smooth_plain
        return f(kpp, pp["dbraw"])

    compare("kpp_smooth", case, [smooth(True)], [smooth(False)],
            cuda_time_ms(lambda: smooth(True), reps),
            cuda_time_ms(lambda: smooth(False), reps), results, whole=True,
            call=lambda: smooth(True))
    pp["dblocSm"] = smooth(False)

    def col(kernel):
        f = kpp_mod.kpp_col if kernel else kpp_mod._kpp_col_plain
        return f(kpp, pp, case.kappa, case.kappa)

    ck, cp = col(True), col(False)
    compare("kpp_col", case, [ck[n] for n in col_names],
            [cp[n] for n in col_names],
            cuda_time_ms(lambda: col(True), reps),
            cuda_time_ms(lambda: col(False), reps), results, whole=True,
            call=lambda: col(True))
    wet = case.grid.maskC[0] > 0
    hbl = cp["hbl"][wet]
    print(f"{'kpp_col':18s} {case.label:18s} kbl identical in "
          f"{int((ck['kbl'] == cp['kbl']).sum())} of {ck['kbl'].numel()} "
          f"columns; hbl {float(hbl.min()):.2f}-{float(hbl.max()):.2f} m, "
          f"nonlocal flux in {int((cp['ghat'].abs().sum(0) > 0).sum())} "
          f"columns", flush=True)
    if not torch.equal(ck["kbl"], cp["kbl"]):
        raise AssertionError("kpp_col: kbl differs from its twin's")

    cfg, g = case.cfg, case.grid
    ol = cfg.olx
    flow = gad.calc_adv_flow(g, args[0], args[1], case.w)

    def rhs(impl):
        return gad.calc_rhs(cfg, g, flow, args[2], case.kappa, cfg.diffKhT,
                            implicit_diffusion=True, impl=impl,
                            df=case.df)[:, ol:-ol, ol:-ol]

    exact_compare("gad_calc_rhs_c2(df)", case, [rhs(None)], [rhs("plain")],
                  cuda_time_ms(lambda: rhs(None), reps),
                  cuda_time_ms(lambda: rhs("plain"), reps), results,
                  call=lambda: rhs(None))


def kpp_experiment(n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.kpp_gyre_config(nx=n, ny=n, nr=nr, **kw)
    return Experiment(cfg, *synthetic.kpp_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype)),
        impl=impl)


def kpp_parity_phase():
    from mitgcm_tpu_torch.utils.compare import record_digits

    runs = {impl: kpp_experiment(64, 12, torch.float64, impl).run(
        n_steps=10) for impl in (None, "plain")}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"kpp step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, init res {rk['cg2d_init_res']:.10e}, "
              f"fewest digits {dig[key]:.2f} ({key})", flush=True)
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError("kpp-gyre cg2d iteration counts differ")
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"kpp-gyre parity {worst:.2f} < "
                             f"{PARITY_DIGITS} digits")
    print(f"kpp-gyre parity: fewest matching digits {worst:.2f}")


def kpp_restart_phase():
    """tools/do_tst_2+2 on the card: 4 steps against 2 + pickup + 2."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import read_pickup, write_pickup

    e4 = kpp_experiment(64, 12, torch.float64)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = kpp_experiment(64, 12, torch.float64)
    e2.run(n_steps=2, collect_monitor=False)
    e22 = kpp_experiment(64, 12, torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        write_pickup(e2, tmp, 2)
        read_pickup(e22, tmp, 2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    names = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1",
             "guNm2", "gtNm1", "gtNm2", "gsNm2")
    differ = [n for n in names
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    print(f"2+2 restart of the kpp-gyre on the kernel path, 64x64x12 "
          f"float64: {len(names) - len(differ)} of {len(names)} fields "
          f"bit-equal", flush=True)
    if differ:
        raise AssertionError(f"kpp-gyre restart differs in {differ}")


def kpp_full_phase(kernels, smi):
    from mitgcm_tpu_torch.model import kpp as kpp_mod

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = kpp_experiment(n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    state0 = exp.state
    points = n * n * nr

    def run(state, it0, steps, impl):
        exp.state, exp.cur_iter, exp.impl = state, it0, impl
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, sec_w = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = kpp_mod.plain_calls + glue_plain_calls()
    state, iters, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = kpp_mod.plain_calls + glue_plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations {iters}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain KPP and D-G calls {plain}; launches {launches}",
          flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"kpp-gyre {name} is not finite")
    check_launches("kpp-gyre", launches, KPP_LAUNCHES, plain)
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    _, iters_p, sec_p = run(state1, 1, 2, "plain")
    print(f"plain path: 2 steps, {sec_p * 1e3 / 2:.2f} ms/step, "
          f"{points * 2 / sec_p:.4e} points*steps/s, cg2d iterations "
          f"{iters_p}", flush=True)
    return launches


def profile_steps(exp, state, it0, steps, wall_ms):
    """Where the kernel path's device time goes: torch.profiler over
    `steps` steps, the device time and calls per step of the 16 largest
    kernels and of every kernel of the port (namespace mitgcm), the
    device's busy time per step, and its idle share against
    wall_ms, the unprofiled ms/step. Returns those figures a step: busy
    ms, idle share, each of the port's kernels' ms and calls, and the ms
    and launches of the plain glue (PyTorch's own kernels and copies) and
    of the port's kernels."""
    exp.state, exp.cur_iter, exp.impl = state, it0, None
    return profile_run(lambda: exp.run(n_steps=steps, collect_monitor=False),
                       steps, wall_ms)


def profile_run(run, steps, wall_ms):
    """profile_steps' figures a step of run(), which takes `steps` steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():   # the kernels, not the ops launching them
        if e.device_type != DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / steps
        if ms > 0.0:
            rows.append((ms, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    glue = [r for r in rows if "mitgcm::" not in r[2]]
    print(f"profile, {steps} steps: device busy {busy:.2f} ms/step; idle "
          f"share {1.0 - busy / wall_ms:.3f} of the unprofiled "
          f"{wall_ms:.2f} ms/step; PyTorch's own kernels and copies (the "
          f"plain glue) {sum(r[0] for r in glue):.2f} ms/step in "
          f"{sum(r[1] for r in glue):.1f} launches/step", flush=True)
    for i, (ms, count, key) in enumerate(rows):
        if i < 16 or "mitgcm::" in key:
            print(f"  {ms:8.3f} ms/step {count:6.1f} calls/step  {key[:70]}")
    return {"device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "port_kernels": {key: {"ms": ms, "calls": count}
                             for ms, count, key in rows
                             if "mitgcm::" in key},
            "glue_ms": sum(r[0] for r in glue),
            "glue_launches_per_step": sum(r[1] for r in glue),
            "kernel_ms": busy - sum(r[0] for r in glue),
            "kernel_launches_per_step": sum(r[1] for r in rows) - sum(
                r[1] for r in glue)}


def kpp_phase(kernels, results, smi):
    phase("8 kpp-gyre")
    kpp_kernel_phase(KppCase(64, 12, torch.float64), results, reps=20)
    kpp_kernel_phase(KppCase(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
    kpp_parity_phase()
    kpp_restart_phase()
    launches = kpp_full_phase(kernels, smi)
    torch.cuda.empty_cache()
    return launches


class G9Case:
    """The ggl90-gyre's grid and GGL90 on the card (or those of its
    variant `config`), with seeded inputs: velocities with some zero-shear
    columns, a TKE with noise, the profiles with noise (statically unstable
    in places) and sigmaR from them, a wind stress, a vertical velocity and
    a tracer with fronts."""

    def __init__(self, n, nr, dtype, config="ggl90", **kw):
        from mitgcm_tpu_torch.model import gad
        from mitgcm_tpu_torch.model import thermodynamics as th
        from mitgcm_tpu_torch.ops.eos import find_rho
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = getattr(synthetic, f"{config}_gyre_config")(
            nx=n, ny=n, nr=nr, deltaT=600.0, **kw)
        self.grid, self.ggl90 = self.setup()
        cfg, g = self.cfg, self.grid
        rng = np.random.default_rng(SEED + 3)
        shape = tuple(g.hFacC.shape)
        prof = dict(dtype=dtype, device="cuda")
        tref = torch.tensor(cfg.tRef, **prof)[:, None, None]
        sref = torch.tensor(cfg.sRef, **prof)[:, None, None]
        self.u = self.field(rng, shape, 0.1)
        self.v = self.field(rng, shape, 0.1)
        for a in (self.u, self.v):      # no vertical shear in columns 8, 9
            a[:, :, 8:10] = a[:1, :, 8:10]
        self.u, self.v = self.u * g.maskW, self.v * g.maskS
        self.w = self.field(rng, shape, 1e-3) * g.maskC
        self.tke = self.field(rng, shape, 1e-4).abs() * g.maskC
        theta = (tref + self.field(rng, shape, 0.5)) * g.maskC
        salt = (sref + self.field(rng, shape, 0.05)) * g.maskC
        rho = find_rho(cfg, g, theta, salt) * g.maskC
        self.sigmaR = th.calc_sigmaR(cfg, g, rho, theta, salt)
        self.sfU = self.field(rng, shape[1:], 1e-4)
        self.sfV = self.field(rng, shape[1:], 1e-4)
        self.tracer = theta.clone()        # with fronts in x, y and r
        self.tracer[:, :, 2 * n // 3:] += 3.0
        self.tracer[nr // 3:, n // 2:, :] -= 2.0
        self.tracer = self.tracer * g.maskC
        self.flow = gad.calc_adv_flow(g, self.u, self.v, self.w)
        self.kappa = self.field(rng, shape, 1e-3).abs()

    def setup(self):
        """(grid, GGL90) of the configuration on the card."""
        from mitgcm_tpu_torch.utils import synthetic

        objs = synthetic.ggl90_gyre_setup(
            self.cfg, dtype=self.dtype, device="cuda",
            grid=shared_grid(self.cfg, self.dtype))
        return objs[0], objs[4]

    field = Case.field
    label = Case.label


def g9_kernel_phase(case, results, reps):
    """G9 (ggl90_col, then ggl90_visc on its visctmp) and M (each sweep on
    the previous sweep's output, schemes 30, 33 and 77; 33, the main
    path's, last; bit for bit, with the bounds of M's footprints) against
    their twins on whole arrays, halos included; and C without its
    advective part, as the ggl90-gyre runs it."""
    from mitgcm_tpu_torch.model import gad
    from mitgcm_tpu_torch.model import ggl90 as g9

    ggl90, cfg, g = case.ggl90, case.cfg, case.grid
    args = (case.u, case.v, case.tke, case.sigmaR, case.sfU, case.sfV)

    def col(kernel):
        f = g9.ggl90_col if kernel else g9._ggl90_col_plain
        return f(ggl90, *args)

    ck, cp = col(True), col(False)
    names = ("tke", "diffKr", "visctmp")
    compare("ggl90_col", case, [ck[n] for n in names],
            [cp[n] for n in names], cuda_time_ms(lambda: col(True), reps),
            cuda_time_ms(lambda: col(False), reps), results, whole=True,
            call=lambda: col(True))

    def visc(kernel):
        f = g9.ggl90_visc if kernel else g9._ggl90_visc_plain
        return f(ggl90, cp["visctmp"])

    compare("ggl90_visc", case, visc(True), visc(False),
            cuda_time_ms(lambda: visc(True), reps),
            cuda_time_ms(lambda: visc(False), reps), results, whole=True,
            call=lambda: visc(True))
    wet = g.maskC > 0
    tke = ck["tke"][1:][wet[1:]]
    print(f"{'ggl90_col':18s} {case.label:18s} unstable interfaces "
          f"{int((case.sigmaR < 0).sum())}, Prandtl number above 1 in "
          f"{int(cp['prandtl'].sum())} cells, tke' "
          f"{float(tke.min()):.3e}-{float(tke.max()):.3e}, diffKr max "
          f"{float(ck['diffKr'].max()):.3e}", flush=True)

    for scheme in (30, 77, 33):
        args = (cfg, g, case.flow, case.u, case.v, case.w, case.tracer,
                scheme, scheme, cfg.deltaTTracer)
        for name, run, src, dst in gad.multidim_sweeps(*args):
            twin = gad.MD_PLAIN[name]

            def plain(twin=twin, src=src):
                return twin(*args[:7], src, *args[7:])
            run()
            label = name if scheme == 33 else f"{name}({scheme})"
            exact_compare(label, case, [dst], [plain()],
                          cuda_time_ms(run, reps), cuda_time_ms(plain, reps),
                          results,
                          call=lambda: gad.multidim_advection(*args))

    ol = cfg.olx

    def rhs(impl):
        return gad.calc_rhs(cfg, g, case.flow, case.tracer, case.kappa,
                            cfg.diffKhT, implicit_diffusion=True,
                            calc_advection=False,
                            impl=impl)[:, ol:-ol, ol:-ol]

    exact_compare("gad_calc_rhs_c2(noadv)", case, [rhs(None)], [rhs("plain")],
                  cuda_time_ms(lambda: rhs(None), reps),
                  cuda_time_ms(lambda: rhs("plain"), reps), results,
                  call=lambda: rhs(None))


# G9's variants of phase 9's table: (mxlMaxFlag, calcMeanVertShear,
# GGL90_dirichlet), the ggl90-gyre's (2, False, True) among them
G9_VARIANTS = tuple((flag, shear, dirichlet) for flag in range(4)
                    for shear in (False, True) for dirichlet in (True, False))
# the levels of phase 9's deep ggl90-gyre, above the 64 that G9 took before
# its columns left per-thread arrays, and their stretch (a 16 m top and a
# 161 m bottom layer over 5000 m)
G9_DEEP_NR, G9_DEEP_STRETCH = 80, 1.03


def g9_variant_phase(case, results):
    """ggl90_col in each of G9_VARIANTS against its twin on whole arrays,
    bit for bit, on the case's inputs (not timed)."""
    import copy

    from mitgcm_tpu_torch.model import ggl90 as g9

    args = (case.u, case.v, case.tke, case.sigmaR, case.sfU, case.sfV)
    names = ("tke", "diffKr", "visctmp")
    for flag, shear, dirichlet in G9_VARIANTS:
        gg = copy.copy(case.ggl90)
        gg.p = dict(gg.p, mxlMaxFlag=flag, calcMeanVertShear=shear,
                    GGL90_dirichlet=dirichlet)
        k, p = g9.ggl90_col(gg, *args), g9._ggl90_col_plain(gg, *args)
        label = (f"ggl90_col(f{flag}{' mean' if shear else ''}"
                 f"{' neumann' if not dirichlet else ''})")
        exact_compare(label, case, [k[n] for n in names],
                      [p[n] for n in names], None, None, results,
                      call=lambda gg=gg: g9.ggl90_col(gg, *args))


def g9_deep_phase(results):
    """Above 64 levels, the most ggl90_col took while it kept per-thread
    level arrays: ggl90_col at 64x64xG9_DEEP_NR
    float64 against its twin on whole arrays, then 3 float64 steps of the
    64x64xG9_DEEP_NR ggl90-gyre, kernel path against plain path."""
    from mitgcm_tpu_torch.model import ggl90 as g9

    case = G9Case(64, G9_DEEP_NR, torch.float64, stretch=G9_DEEP_STRETCH)
    args = (case.u, case.v, case.tke, case.sigmaR, case.sfU, case.sfV)
    k = g9.ggl90_col(case.ggl90, *args)
    p = g9._ggl90_col_plain(case.ggl90, *args)
    names = ("tke", "diffKr", "visctmp")
    exact_compare("ggl90_col(deep)", case, [k[n] for n in names],
                  [p[n] for n in names], None, None, results,
                  call=lambda: g9.ggl90_col(case.ggl90, *args))
    del case
    g9_parity_phase(nr=G9_DEEP_NR, steps=3, stretch=G9_DEEP_STRETCH)


def g9_experiment(n, nr, dtype, impl=None, config="ggl90", **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = getattr(synthetic, f"{config}_gyre_config")(nx=n, ny=n, nr=nr, **kw)
    grid, state, forcing, op, ggl90 = synthetic.ggl90_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, ggl90=ggl90, impl=impl)


def g9_parity_phase(config="ggl90", nr=12, steps=10, **kw):
    """steps float64 steps of the 64x64xnr gyre `config` (kw: its
    config's keywords), kernel path against plain path: equal cg2d
    iterations, PARITY_DIGITS or more on every statistic and field."""
    from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits

    exps = {impl: g9_experiment(64, nr, torch.float64, impl, config, **kw)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=steps) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"{config} step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, init res {rk['cg2d_init_res']:.10e}, "
              f"fewest digits {dig[key]:.2f} ({key})", flush=True)
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError(f"{config}-gyre cg2d iteration counts "
                                 "differ")
    ol = exps[None].cfg.olx
    fields = {}
    for name in PROGNOSTIC_EXTRA:
        field = getattr(exps[None].state, name)
        if field is not None and field.numel():
            fields[name] = digits(interior(field, ol), interior(
                getattr(exps["plain"].state, name), ol))
    worst = min(worst, *fields.values())
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"{config}-gyre parity {worst:.2f} < "
                             f"{PARITY_DIGITS} digits")
    print(f"{config}-gyre parity, 64x64x{nr}, {steps} steps: fewest "
          f"matching digits {worst:.2f} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in fields.items()) + ")",
          flush=True)


def g9_restart_phase(config="ggl90"):
    """tools/do_tst_2+2 on the card: 4 steps against 2 + pickup and
    pickup_ggl90 + 2."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import read_pickup, write_pickup

    e4 = g9_experiment(64, 12, torch.float64, config=config)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = g9_experiment(64, 12, torch.float64, config=config)
    e2.run(n_steps=2, collect_monitor=False)
    e22 = g9_experiment(64, 12, torch.float64, config=config)
    with tempfile.TemporaryDirectory() as tmp:
        write_pickup(e2, tmp, 2)
        read_pickup(e22, tmp, 2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    names = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1",
             "guNm2", "gtNm1", "gsNm2", "GGL90TKE")
    differ = [n for n in names
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    print(f"2+2 restart of the {config}-gyre on the kernel path, 64x64x12 "
          f"float64: {len(names) - len(differ)} of {len(names)} fields "
          f"bit-equal", flush=True)
    if differ:
        raise AssertionError(f"{config}-gyre restart differs in {differ}")


def g9_full_phase(kernels, smi, config="ggl90", want=G9_LAUNCHES):
    from mitgcm_tpu_torch.model import gad, som
    from mitgcm_tpu_torch.model import ggl90 as g9

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = g9_experiment(n, nr, torch.float32, config=config, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    state0 = exp.state
    points = n * n * nr

    def run(state, it0, steps, impl):
        exp.state, exp.cur_iter, exp.impl = state, it0, impl
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, sec_w = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = (g9.plain_calls + gad.plain_calls + som.plain_calls
              + glue_plain_calls())
    state, iters, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = (g9.plain_calls + gad.plain_calls + som.plain_calls
             + glue_plain_calls() - plain0)
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations {iters}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain GGL90, multidim, SOM and D-G calls {plain}; launches "
          f"{launches}", flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"
                 ) + PROGNOSTIC_EXTRA:
        field = getattr(state, name)
        if field is not None and not bool(torch.isfinite(field).all()):
            raise AssertionError(f"{config}-gyre {name} is not finite")
    tke = state.GGL90TKE[1:][exp.grid.maskC[1:] > 0]
    print(f"GGL90TKE after 6 steps: {float(tke.min()):.3e}-"
          f"{float(tke.max()):.3e}, above 1e-6 in {int((tke > 1e-6).sum())}"
          f" of {tke.numel()} wet interfaces", flush=True)
    if state.IDEMIX_E is not None:
        E = state.IDEMIX_E[1:][exp.grid.maskC[1:] > 0]
        print(f"IDEMIX_E after 6 steps: max {float(E.max()):.3e}, above 0 "
              f"in {int((E > 0).sum())} of {E.numel()} wet interfaces",
              flush=True)
    check_launches(f"{config}-gyre", launches, want, plain)
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    _, iters_p, sec_p = run(state1, 1, 2, "plain")
    print(f"plain path: 2 steps, {sec_p * 1e3 / 2:.2f} ms/step, "
          f"{points * 2 / sec_p:.4e} points*steps/s, cg2d iterations "
          f"{iters_p}", flush=True)
    return launches


def g9_phase(kernels, results, smi):
    phase("9 ggl90-gyre")
    small = G9Case(64, 12, torch.float64)
    g9_kernel_phase(small, results, reps=20)
    g9_variant_phase(small, results)
    del small
    g9_kernel_phase(G9Case(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
    g9_deep_phase(results)
    g9_parity_phase()
    g9_restart_phase()
    launches = g9_full_phase(kernels, smi)
    torch.cuda.empty_cache()
    return launches


def exact_compare(name, case, outs, wants, ms, plain_ms, results, call=None,
                  touched=None):
    """Hold a kernel's outputs against its twin's on whole arrays: equal
    bits, and non-finite values (float32 WENO's overflow and SOM's first
    padded row and column, faults of the reference) in the same cells;
    record the times (ms None: a variant not timed) and the bound as
    compare does, from the tensors the wrapper checks in `call` or from
    `touched`."""
    abs_err, same, bad = 0.0, True, [0, 0]
    for out, want in zip(outs, wants):
        for test in (torch.isnan, torch.isposinf, torch.isneginf):
            same = same and torch.equal(test(out), test(want))
        bad_k, bad_p = ~torch.isfinite(out), ~torch.isfinite(want)
        diff = (out - want).abs().masked_fill(bad_k | bad_p, 0.0)
        abs_err = max(abs_err, float(diff.max()))
        bad = [bad[0] + int(bad_k.sum()), bad[1] + int(bad_p.sum())]
    times = ("not timed" if ms is None else
             f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(f"{name:18s} {case.label:18s} max abs err {abs_err:.3e} (tol 0), "
          f"non-finite cells {bad[0]} / {bad[1]} (kernel / plain), {times}",
          flush=True)
    if not (abs_err == 0.0 and same):
        raise AssertionError(f"{name} disagrees with its twin at "
                             f"{case.label}")
    results[name] = {"max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None}
    results[name]["bound_ms"], results[name]["bound_by"] = bound(
        name.split("(")[0], call, touched)
    print(f"{'':18s} bound {results[name]['bound_ms']:.4f} ms "
          f"({results[name]['bound_by']})", flush=True)


def ho_kernel_phase(case, results, reps, plain_reps):
    """Every sweep of O, P and M's new schemes (HO_PAIRS) against its twin
    sweep, each on the previous sweep's twin output, bit for bit."""
    from mitgcm_tpu_torch.model import gad

    cfg, g = case.cfg, case.grid
    done = set()
    for scheme, vert in HO_PAIRS:
        sweeps = gad.multidim_sweeps(cfg, g, case.flow, case.u, case.v,
                                     case.w, case.tracer, scheme, vert,
                                     cfg.deltaTTracer)
        for name, run, src, dst in sweeps:
            sch = vert if name.endswith("_r") else scheme
            if (name, sch) in done:
                continue
            done.add((name, sch))
            twin = gad.MD_PLAIN[name]

            def plain(twin=twin, src=src):
                return twin(cfg, g, case.flow, case.u, case.v, case.w,
                            case.tracer, src, scheme, vert, cfg.deltaTTracer)
            run()
            label = name if sch in (7, 51) else f"{name}({sch})"

            # each sweep's bound counts what its launch reads (FOOTPRINTS),
            # from a call of the whole advection
            def call(scheme=scheme, vert=vert):
                return gad.multidim_advection(
                    cfg, g, case.flow, case.u, case.v, case.w,
                    case.tracer, scheme, vert, cfg.deltaTTracer)
            exact_compare(label, case, [dst], [plain()],
                          cuda_time_ms(run, reps),
                          cuda_time_ms(plain, plain_reps), results,
                          call=call)


def ho_phase(kernels, results, smi):
    phase("10 high-order advection: os7mp-gyre and pqm-gyre, halos of 4")
    ho_kernel_phase(G9Case(64, 12, torch.float64, "os7mp"), results, 20, 20)
    case = G9Case(1024, 32, torch.float32, "os7mp")
    ho_kernel_phase(case, results, 10, 3)
    # the `+ gTr` addend of the last sweep at the main paths' size, held
    # untimed on the same case (phase 18 holds it at 64x64 float64)
    addend_last_glue(case, results, 0)
    del case
    torch.cuda.empty_cache()
    launches = {}
    for config, names in (("os7mp", O_KERNELS), ("pqm", P_KERNELS)):
        g9_parity_phase(config)
        g9_restart_phase(config)
        run = g9_full_phase(kernels, smi, config, HO_LAUNCHES[config])
        launches.update({k: run[k] for k in names})
        torch.cuda.empty_cache()
    return launches


class IsmCase(G9Case):
    """G9Case of the idemix-gyre on a grid with a shelf, a bank and a
    partial bottom cell (so that klowC and hFacI take several values), with
    its GGL90's IDEMIX and Langmuir and flux maps, and besides G9Case's
    inputs the buoyancy frequency, a random internal-wave energy, and SOM
    moments of up to about twice a cell's content (so that the limiter
    clips)."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.model import ggl90 as g9

        super().__init__(n, nr, dtype, config="idemix")
        g = self.grid
        rng = np.random.default_rng(SEED + 4)
        shape = tuple(g.hFacC.shape)
        self.Nsq = g9.nsq(self.cfg, self.sigmaR.clone())
        self.E = self.field(rng, shape, 1e-4).abs() * g.maskC
        vol = g.rA * g.drF[:, None, None] * g.hFacC
        self.sm = (self.field(rng, (9,) + shape, 2.0)
                   * (self.tracer * vol)[None])

    def setup(self):
        from mitgcm_tpu_torch.core.grid import build_grid
        from mitgcm_tpu_torch.model import ggl90 as g9
        from mitgcm_tpu_torch.utils import synthetic

        cfg, n = self.cfg, self.cfg.nx
        depth = sum(cfg.delR)
        bathy = np.full((n, n), -depth)
        bathy[:, :5 * n // 16] = -0.4 * depth                 # a shelf
        bathy[3 * n // 16:7 * n // 16, 10 * n // 16:14 * n // 16] = (
            -2.0 / 3.0 * depth)                                # a bank
        bathy[9 * n // 16, 6 * n // 16:12 * n // 16] = (
            -depth + 0.4 * cfg.delR[-1])                       # partial cells
        bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
        g = build_grid(cfg, bathy=bathy, dtype=self.dtype, device="cuda")
        ggl90 = g9.GGL90(cfg, g, {"mxlMaxFlag": 2, **cfg.extra["ggl90"]})
        ol = cfg.olx
        wet = g.maskC[0, ol:-ol, ol:-ol].cpu().numpy()
        ggl90.init_idemix_forc(synthetic.idemix_maps(
            cfg, wet, self.dtype, "cuda").__getitem__)
        return g, ggl90


def ism_kernel_phase(case, results, reps, plain_reps):
    """H-IDEMIX's three launches, each on its predecessor's twin output,
    G9's ggl90_col with IDEMIX's source and Langmuir, and H-SOM's three
    passes of schemes 80 and 81 (81, theta's on the main path, last), each
    on the kernel's previous pass, against their twins on whole arrays."""
    from mitgcm_tpu_torch.model import ggl90 as g9
    from mitgcm_tpu_torch.model import som

    gg, cfg, g = case.ggl90, case.cfg, case.grid
    dt = cfg.deltaTTracer

    def prep(kernel):
        f = g9.idemix_prep if kernel else g9._idemix_prep_plain
        return f(gg, case.Nsq)

    pk, pp = prep(True), g9._idemix_prep_plain(gg, case.Nsq, branches=True)
    names = ("c0", "v0", "tau_d")
    exact_compare("idemix_prep", case, [pk[n] for n in names],
                  [pp[n] for n in names],
                  cuda_time_ms(lambda: prep(True), reps),
                  cuda_time_ms(lambda: prep(False), plain_reps), results,
                  call=lambda: prep(True))

    def hdiff(kernel):
        f = g9.idemix_hdiff if kernel else g9._idemix_hdiff_plain
        return f(gg, case.E, pp["v0"])

    E_d = hdiff(False)
    exact_compare("idemix_hdiff", case, [hdiff(True)], [E_d],
                  cuda_time_ms(lambda: hdiff(True), reps),
                  cuda_time_ms(lambda: hdiff(False), plain_reps), results,
                  call=lambda: hdiff(True))

    def col(kernel):
        f = g9.idemix_col if kernel else g9._idemix_col_plain
        return f(gg, E_d, pp["c0"], pp["tau_d"])

    ck, cp = col(True), col(False)
    exact_compare("idemix_col", case, list(ck), list(cp),
                  cuda_time_ms(lambda: col(True), reps),
                  cuda_time_ms(lambda: col(False), plain_reps), results,
                  call=lambda: col(True))
    wet = g.maskC[1:] > 0
    print(f"{'idemix_col':18s} {case.label:18s} E' > 0 in "
          f"{int((cp[0][1:][wet] > 0).sum())} of {int(wet.sum())} wet "
          f"interfaces; cells with hofx1 < 0 "
          f"{int(pp['hofx1_neg'][wet].sum())}, v0 capped "
          f"{int(pp['cfl_cap'][wet].sum())}, tau_d floored "
          f"{int(pp['tau_floor'][wet].sum())}; columns with cstar floored "
          f"{int(pp['cstar_floor'][g.maskC[0] > 0].sum())}", flush=True)

    args = (case.u, case.v, case.tke, case.sigmaR, case.sfU, case.sfV, cp[1])

    def g9col(kernel):
        f = g9.ggl90_col if kernel else g9._ggl90_col_plain
        return f(gg, *args)

    a, b = g9col(True), g9col(False)
    names = ("tke", "diffKr", "visctmp")
    exact_compare("ggl90_col(idemix)", case, [a[n] for n in names],
                  [b[n] for n in names],
                  cuda_time_ms(lambda: g9col(True), reps),
                  cuda_time_ms(lambda: g9col(False), plain_reps), results,
                  call=lambda: g9col(True))
    pr = b["prandtl"][1:][wet]
    print(f"{'ggl90_col(idemix)':18s} {case.label:18s} IDEMIX Prandtl "
          f"number below 1 in {int((pr < 1).sum())}, above 10 in "
          f"{int((pr > 10).sum())} wet interfaces", flush=True)

    for scheme in (80, 81):
        sweeps = som.som_sweeps(cfg, g, case.u, case.v, case.w, case.tracer,
                                case.sm, scheme, dt)
        xk, yk, _ = (sw[2] for sw in sweeps)
        twins = (
            lambda: som._som_x_plain(cfg, g, case.u, case.tracer, case.sm,
                                     scheme, dt),
            lambda: som._som_y_plain(cfg, g, case.v, *xk, scheme, dt),
            lambda: som._som_r_plain(cfg, g, case.w, case.tracer, *yk,
                                     scheme, dt))
        for (name, run, outs), twin in zip(sweeps, twins):
            run()
            label = name if scheme == 81 else f"{name}({scheme})"
            # the bound counts what the pass reads (FOOTPRINTS), from a
            # call of the whole advection
            exact_compare(label, case, list(outs), list(twin()),
                          cuda_time_ms(run, reps),
                          cuda_time_ms(twin, plain_reps), results,
                          call=lambda scheme=scheme: som.som_advect(
                              cfg, g, case.u, case.v, case.w, case.tracer,
                              case.sm, scheme, dt))
            torch.cuda.empty_cache()


def ism_pickup_refusal(config):
    """write_pickup refuses the idemix- and som-gyre by name (the JAX
    package's format has no record for IDEMIX_E or the SOM moments)."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import write_pickup

    exp = g9_experiment(16, 12, torch.float64, config=config)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            write_pickup(exp, tmp, 0)
        except NotImplementedError as err:
            print(f"write_pickup of the {config}-gyre refused: {err}",
                  flush=True)
        else:
            raise AssertionError(f"write_pickup wrote the {config}-gyre")


def ism_phase(kernels, results, smi):
    phase("11 IDEMIX, Langmuir and SOM: idemix-gyre and som-gyre")
    ism_kernel_phase(IsmCase(64, 12, torch.float64), results, 20, 20)
    ism_kernel_phase(IsmCase(1024, 32, torch.float32), results, 10, 3)
    torch.cuda.empty_cache()
    launches = {}
    for config, names in (("idemix", IDEMIX_KERNELS), ("som", SOM_KERNELS)):
        g9_parity_phase(config)
        ism_pickup_refusal(config)
        run = g9_full_phase(kernels, smi, config, ISM_LAUNCHES[config])
        launches.update({k: run[k] for k in names})
        torch.cuda.empty_cache()
    return launches


class NhCase:
    """The nh-convection box's grid and cg3d operator on the card, with
    seeded inputs: velocities on wet faces, random interface viscosities,
    and the cg3d work fields on the wet interior. Below full size the grid
    has walls, a bank and a row of partial bottom cells (hFacMin 0.2), so
    that W's free-slip walls and the preconditioner's dry pivots are
    exercised; at full size it is the box's own (shared with the run)."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.core.grid import build_grid
        from mitgcm_tpu_torch.ops.stencil import interior_mask
        from mitgcm_tpu_torch.solver import cg3d
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.nh_convection_config(
            nx=n, ny=n, nr=nr, **({} if n >= 1024 else {"hFacMin": 0.2}))
        cfg = self.cfg
        self.grid = shared_grid(cfg, dtype, flat=True)
        if self.grid is None:
            depth, dz = sum(cfg.delR), cfg.delR[-1]
            bathy = np.full((n, n), -depth)
            bathy[3 * n // 16:7 * n // 16, 10 * n // 16:14 * n // 16] = (
                -0.5 * depth - 0.5 * dz)                       # a bank
            bathy[9 * n // 16, 6 * n // 16:12 * n // 16] = (
                -depth + 0.4 * dz)                             # partial cells
            bathy[0, :] = bathy[-1, :] = bathy[:, 0] = bathy[:, -1] = 0.0
            self.grid = build_grid(cfg, bathy=bathy, dtype=dtype,
                                   device="cuda")
        g = self.grid
        self.op3 = cg3d.build_cg3d(cfg, g)
        rng = np.random.default_rng(SEED + 5)
        shape = tuple(g.hFacC.shape)
        self.u = self.field(rng, shape, 0.1) * g.maskW
        self.v = self.field(rng, shape, 0.1) * g.maskS
        self.w = self.field(rng, shape, 1e-2) * g.maskC
        kshape = (nr + 1,) + shape[1:]
        self.kappaRU = self.field(rng, kshape, 0.1).abs()
        self.kappaRV = self.field(rng, kshape, 0.1).abs()
        imask = interior_mask(shape, cfg.oly, cfg.olx, dtype, "cuda") * g.maskC
        self.r, self.x, self.s, self.q = (self.field(rng, shape, 1.0) * imask
                                          for _ in range(4))
        self.b = self.field(rng, shape, 1.0) * imask
        self.ws = cg3d.Workspace(shape, cfg.oly, cfg.olx, dtype, "cuda")

    field = Case.field
    label = Case.label


def nh_kernel_phase(case, results, reps, plain_reps):
    """W and B's flagged variant (free-slip sides, the 3-D Coriolis term)
    against their twins, W on whole arrays, B on the interior (its halo
    outputs are zeros by design, as in phase 3); H-cg3d's two passes, one
    call each on the same inputs, on whole arrays with their dot products
    and `ctrl` (the stops at the cap and at the tolerance too), their
    frozen launches, and the whole solve kernel path against plain path.
    Every comparison is bit for bit."""
    from mitgcm_tpu_torch.model.calc_gw import calc_gw
    from mitgcm_tpu_torch.model.mom_fluxform import mom_fluxform
    from mitgcm_tpu_torch.solver import cg3d

    cfg, g, op3, ws = case.cfg, case.grid, case.op3, case.ws
    ol = cfg.olx

    def gw(impl):
        return calc_gw(cfg, g, case.u, case.v, case.w, case.kappaRU,
                       case.kappaRV, impl=impl)

    exact_compare("calc_gw", case, list(gw(None)), list(gw("plain")),
                  cuda_time_ms(lambda: gw(None), reps),
                  cuda_time_ms(lambda: gw("plain"), plain_reps), results,
                  call=lambda: gw(None))
    if case.dtype == torch.float64:
        # W's other variant, without the 3-D Coriolis term (not timed)
        flat = dataclasses.replace(cfg, select3dCoriScheme=0)

        def gw0(impl):
            return calc_gw(flat, g, case.u, case.v, case.w, case.kappaRU,
                           case.kappaRV, impl=impl)

        exact_compare("calc_gw(no 3-D Cor)", case, list(gw0(None)),
                      list(gw0("plain")), None, None, results,
                      call=lambda: gw0(None))

    def mom(impl):
        t = mom_fluxform(cfg, g, case.u, case.v, case.w, case.kappaRU,
                         case.kappaRV, impl=impl)
        return [f[:, ol:-ol, ol:-ol] for f in t]

    exact_compare("mom_fluxform(nh)", case, mom(None), mom("plain"),
                  cuda_time_ms(lambda: mom(None), reps),
                  cuda_time_ms(lambda: mom("plain"), plain_reps), results,
                  call=lambda: mom(None))

    dt = case.dtype
    eta_n, eta_nm1, den = (case.r.new_tensor(v) for v in (0.7, 1.3, 1.1))
    never = case.r.new_tensor(0.0)       # a tolerance no residual is under

    def ctrl_of(done, it):
        return torch.tensor([done, it], dtype=torch.int32, device="cuda")

    def sst(impl, ctrl):
        s_out, qa = torch.zeros_like(case.r), torch.zeros_like(case.r)
        dot = case.r.new_zeros(())
        cg3d.s_stencil_dot(op3, g.maskC, case.q, case.s, s_out, qa, eta_n,
                           eta_nm1, dot, ctrl, ol, ol, ws=ws, impl=impl)
        return [s_out, qa, dot]

    def xrp(impl, ctrl, tol=never, max_iters=2 ** 30):
        x, r, q = case.x.clone(), case.r.clone(), torch.zeros_like(case.r)
        err, eta = case.r.new_zeros(()), case.r.new_zeros(())
        cg3d.xr_precond(op3, g.maskC, x, r, case.s, case.q, q, eta_n, den,
                        err, eta, ctrl, tol, max_iters, True, ol, ol, ws=ws,
                        impl=impl)
        return [x, r, q, err, eta] + ([ctrl.to(dt)] if ctrl is not None
                                      else [])

    go = ctrl_of(0, 0)     # never done in the timed calls
    for name, call in (("cg3d_s_stencil_dot", sst), ("cg3d_xr_precond", xrp)):
        exact_compare(name, case, call(None, ctrl_of(0, 5)),
                      call("plain", ctrl_of(0, 5)),
                      cuda_time_ms(lambda: call(None, go), reps),
                      cuda_time_ms(lambda: call("plain", None), plain_reps),
                      results, call=lambda: call(None, ctrl_of(0, 5)))
    for label, ctrl, kw in (("stops at the cap", ctrl_of(0, 6),
                             dict(max_iters=7)),
                            ("stops at the tolerance", ctrl_of(0, 2),
                             dict(tol=case.r.new_tensor(1e30)))):
        k = xrp(None, ctrl.clone(), **kw)
        p = xrp("plain", ctrl.clone(), **kw)
        done = [int(v) for v in k[-1].tolist()]
        print(f"{'cg3d_xr_precond':18s} {case.label:18s} {label}: ctrl "
              f"{done} / {[int(v) for v in p[-1].tolist()]} (kernel / plain)",
              flush=True)
        if not (done[0] == 1 and all(torch.equal(a, b) for a, b in zip(k, p))):
            raise AssertionError(f"cg3d_xr_precond: {label} differs")
    # frozen launches: with `done` set every launch returns at once
    frozen = ctrl_of(1, 3)
    outs = sst(None, frozen) + xrp(None, frozen)
    untouched = (all(float(t.abs().max()) == 0.0 for t in outs[:3])
                 and torch.equal(outs[3], case.x)
                 and torch.equal(outs[4], case.r)
                 and all(float(t.abs().max()) == 0.0 for t in outs[5:8])
                 and frozen.tolist() == [1, 3])
    print(f"{'cg3d (frozen)':18s} {case.label:18s} launches with done set "
          f"leave every output as it was: {untouched}", flush=True)
    if not untouched:
        raise AssertionError("a frozen cg3d launch wrote its outputs")

    # the whole solve, kernel path against plain path
    x0 = 0.01 * case.x
    res = {impl: cg3d.cg3d(cfg, g, op3, case.b, x0, impl=impl)
           for impl in (None, "plain")}
    k, p = res[None], res["plain"]
    same = torch.equal(k.x, p.x)
    cap = math.ceil(k.n_iters / cg3d.BATCH) + 2
    print(f"cg3d solve          {case.label:18s} x bit-equal {same}, "
          f"iterations {k.n_iters} / {p.n_iters} (kernel / plain), residual "
          f"{float(k.first_residual):.6e} -> {float(k.last_residual):.6e}, "
          f"host syncs {k.host_syncs} (at most {cap}) / {p.host_syncs}",
          flush=True)
    if not (same and k.n_iters == p.n_iters and k.host_syncs <= cap):
        raise AssertionError("the cg3d kernel path disagrees with the plain "
                             "path")
    per_it = sum(results[n]["ms"] for n in CG3D_KERNELS)
    bound_it = sum(results[n]["bound_ms"] for n in CG3D_KERNELS)
    print(f"cg3d per iteration  {case.label:18s} {per_it:.4f} ms, bound "
          f"{bound_it:.4f} ms", flush=True)


def nh_experiment(n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.nh_convection_config(nx=n, ny=n, nr=nr, **kw)
    grid, state, forcing, op, op3 = synthetic.nh_convection_setup(
        cfg, dtype=dtype, device="cuda", seed=SEED,
        grid=shared_grid(cfg, dtype, flat=True))
    return Experiment(cfg, grid, state, forcing, op, impl=impl, op3=op3)


def nh_parity_phase():
    """10 float64 steps of the 64x64x12 box, kernel path against plain
    path: every record and phi_nh, w, u and theta bit for bit, equal cg2d
    and cg3d iterations."""
    from mitgcm_tpu_torch.utils.compare import EQUAL_DIGITS, record_digits

    exps = {impl: nh_experiment(64, 12, torch.float64, impl)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=10) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        # the plain path reads its residual every iteration, the kernel
        # path once a batch: their host syncs differ by design
        dig = record_digits({k: v for k, v in rk.items()
                             if k != "cg3d_host_syncs"}, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"nh step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, cg3d iters {rk['cg3d_iters']} / "
              f"{rp['cg3d_iters']}, cg3d host syncs {rk['cg3d_host_syncs']},"
              f" cg3d init res {rk['cg3d_init_res']:.10e}, fewest digits "
              f"{dig[key]:.2f} ({key})", flush=True)
        if (rk["cg2d_iters"], rk["cg3d_iters"]) != (rp["cg2d_iters"],
                                                   rp["cg3d_iters"]):
            raise AssertionError("nh-convection iteration counts differ")
    same = [n for n in ("phi_nh", "wVel", "uVel", "theta", "gwNm1")
            if torch.equal(getattr(exps[None].state, n),
                           getattr(exps["plain"].state, n))]
    print(f"nh-convection parity: fewest matching digits {worst:.2f}; "
          f"bit-equal fields {same}", flush=True)
    if not (worst >= EQUAL_DIGITS and len(same) == 5):
        raise AssertionError("nh-convection kernel path differs from the "
                             "plain path")


def nh_pickup_refusal():
    import tempfile

    from mitgcm_tpu_torch.model.experiment import write_pickup

    exp = nh_experiment(16, 12, torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        try:
            write_pickup(exp, tmp, 0)
        except NotImplementedError as err:
            print(f"write_pickup of the nh-convection box refused: {err}",
                  flush=True)
        else:
            raise AssertionError("write_pickup wrote the nh-convection box")


def nh_full_phase(kernels, smi):
    """The 1024x1024x50 float32 box (deltaT = 60): a warm-up step, 5 timed
    steps with every launch count, a profile and 1 plain step."""
    from mitgcm_tpu_torch.model import calc_gw, gad
    from mitgcm_tpu_torch.solver import cg3d

    n, nr = 1024, 50
    t0 = time.perf_counter()
    exp = nh_experiment(n, nr, torch.float32, deltaT=60.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    state0 = exp.state
    points = n * n * nr

    def run(state, it0, steps, impl):
        exp.state, exp.cur_iter, exp.impl = state, it0, impl
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, recs, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, recs_w, sec_w = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = calc_gw.plain_calls + gad.plain_calls + glue_plain_calls()
    state, recs, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = (calc_gw.plain_calls + gad.plain_calls + glue_plain_calls()
             - plain0)
    it2 = [r["cg2d_iters"] for r in recs]
    it3 = [r["cg3d_iters"] for r in recs]
    syncs = [r["cg3d_host_syncs"] for r in recs]
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations "
          f"{recs_w[0]['cg2d_iters']}, cg3d iterations "
          f"{recs_w[0]['cg3d_iters']}")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations {it2}, "
          f"cg3d iterations {it3}, cg3d host syncs per solve {syncs}, "
          f"cg3d residual {recs[-1]['cg3d_init_res']:.4e} -> "
          f"{recs[-1]['cg3d_last_res']:.4e}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain W, H-cg3d, C, D-G, N1 and N2 calls {plain}; launches "
          f"{launches}",
          flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "etaN", "phi_nh"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"nh-convection {name} is not finite")
    w = state.wVel[:, 2:-2, 2:-2]
    print(f"after 6 steps: |w| max {float(w.abs().max()):.4e} m/s, |phi_nh| "
          f"max {float(state.phi_nh.abs().max()):.4e}, theta "
          f"{float(state.theta.min()):.5f}-{float(state.theta.max()):.5f}",
          flush=True)
    batches = sum(syncs) * cg3d.BATCH
    want = {**NH_LAUNCHES, "cg3d_s_stencil_dot": batches + 5,
            "cg3d_xr_precond": batches + 5}
    wrong = {k: launches.get(k, 0) for k, count in want.items()
             if launches.get(k, 0) != count}
    late = [(i, s) for i, s in zip(it3, syncs)
            if s > math.ceil(i / cg3d.BATCH) + 2]
    if wrong or plain or late:
        raise AssertionError(f"nh-convection launch counts {wrong} (want "
                             f"{want}), plain calls {plain}, host syncs "
                             f"over ceil(iters/8)+2 {late}")
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    _, recs_p, sec_p = run(state1, 1, 1, "plain")
    print(f"plain path: 1 step, {sec_p * 1e3:.2f} ms/step, "
          f"{points / sec_p:.4e} points*steps/s, cg3d iterations "
          f"{[r['cg3d_iters'] for r in recs_p]}", flush=True)
    return launches


def nh_phase(kernels, results, smi):
    phase("12 non-hydrostatic: the nh-convection box")
    nh_kernel_phase(NhCase(64, 12, torch.float64), results, 20, 20)
    nh_kernel_phase(NhCase(1024, 50, torch.float32), results, 10, 3)
    torch.cuda.empty_cache()
    nh_parity_phase()
    nh_pickup_refusal()
    run = nh_full_phase(kernels, smi)
    torch.cuda.empty_cache()
    return {k: run[k] for k in NH_KERNELS}


class IceCase:
    """The ice-gyre's grid and SeaIce (2 x 2 tiles at 64x64, 64 x 64 tiles
    at full size) with seeded ice, ocean and atmosphere on the card."""

    def __init__(self, n, nr, dtype, config=None):
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        config = config or synthetic.ice_gyre_config
        self.cfg = config(nx=n, ny=n, nr=nr, deltaT=600.0)
        (self.grid, _, _, _, _, self.si) = synthetic.ice_gyre_setup(
            self.cfg, dtype=dtype, device="cuda",
            grid=shared_grid(self.cfg, dtype))
        si = self.si
        rng = np.random.default_rng(SEED + 13)
        shape = tuple(self.grid.rA.shape)

        def fld(lo, hi, mask=None):
            a = torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                                device="cuda")
            return a * mask if mask is not None else a

        mU, mV, hm = si.seaiceMaskU, si.seaiceMaskV, si.HEFFM
        self.prep = dict(
            uIce=si.fill(fld(-0.2, 0.2, mU)), vIce=si.fill(fld(-0.2, 0.2, mV)),
            uVel0=fld(-0.3, 0.3), vVel0=fld(-0.3, 0.3),
            press0=fld(0.0, 4e4, hm), fxTmp=fld(-1.0, 1.0),
            fyTmp=fld(-1.0, 1.0), areaW=fld(0.5, 1.0), areaS=fld(0.5, 1.0),
            massC=fld(1e3, 3e3), massU=fld(1e3, 3e3), massV=fld(1e3, 3e3))
        self.prep["uIceC"] = self.prep["uIce"]
        self.prep["vIceC"] = self.prep["vIce"]
        self.prep["zMax"] = si.p.zetaMaxFac * self.prep["press0"]
        self.ice = si.init_state()._replace(
            uIce=self.prep["uIce"], vIce=self.prep["vIce"],
            AREA=fld(0.0, 1.0, hm), HEFF=fld(0.0, 3.0, hm),
            HSNOW=fld(0.0, 0.5, hm))
        heff = fld(-0.2, 3.0, hm)
        heff[::3, ::2] = 0.0
        heff[1::4, ::3] = 5e-6
        hsnow = fld(-0.05, 0.4, hm)
        hsnow[::2, 1::3] = 0.0
        self.ice2 = self.ice._replace(
            HEFF=heff, HSNOW=hsnow, AREA=fld(-0.1, 1.1, hm),
            TICES=torch.stack([fld(240.0, 274.0)
                               for _ in range(si.p.multDim)]))
        self.forc = types.SimpleNamespace(
            atemp=fld(240.0, 275.0), aqh=fld(1e-4, 3e-3),
            precip=fld(0.0, 1e-7), swdown=fld(0.0, 300.0),
            lwdown=fld(150.0, 320.0), runoff=fld(0.0, 1e-8),
            wspeed=fld(0.0, 12.0), evap=fld(-1e-8, 1e-8),
            Qnet=fld(-200.0, 300.0) * hm, Qsw=fld(-200.0, 0.0) * hm,
            EmPmR=fld(-1e-5, 1e-5), saltFlux=fld(-1e-3, 1e-3))
        self.theta0, self.salt0 = fld(-2.2, 1.0), fld(30.0, 35.0)

    label = Case.label


def ice_kernel_phase(case, results, reps, plain_reps, whole_loop):
    """Each launch of the four sea-ice kernels against its twin, one call
    each on the same inputs, on whole arrays, bit for bit: seaice_lsr_visc
    and _coeffs, each half-sweep of seaice_lsr_tridiag_u/_v and
    seaice_lsr_check (with their control words, and frozen), seaice_advect_x
    and _y, seaice_thermo; then a whole LSR loop kernel path against plain
    path (equal ICOUNTs, u and v bit-equal) when whole_loop (at 64x64: the
    full-size loop is held against the plain path in ice_full_phase's plain
    step)."""
    from mitgcm_tpu_torch.model import seaice_kernels as sk

    si, dtype = case.si, case.dtype
    pr = case.prep
    vin = (pr["uIceC"], pr["vIceC"], pr["press0"], pr["zMax"])
    exact_compare("seaice_lsr_visc", case, list(sk.lsr_visc(si, *vin)),
                  list(si._visc_plain(*vin)),
                  cuda_time_ms(lambda: sk.lsr_visc(si, *vin), reps),
                  cuda_time_ms(lambda: si._visc_plain(*vin), plain_reps),
                  results, call=lambda: sk.lsr_visc(si, *vin))
    visc = si._visc_plain(*vin)
    rest = [pr[k] for k in ("uIce", "vIce", "uIceC", "vIceC", "uVel0",
                            "vVel0", "fxTmp", "fyTmp", "areaW", "areaS",
                            "massC", "massU", "massV")]
    ck = sk.lsr_coeffs(si, *visc, *rest)
    c = si._coeffs_plain(*visc, *rest)
    exact_compare("seaice_lsr_coeffs", case, list(ck.values()),
                  [c[k] for k in ck],
                  cuda_time_ms(lambda: sk.lsr_coeffs(si, *visc, *rest), reps),
                  cuda_time_ms(lambda: si._coeffs_plain(*visc, *rest),
                               plain_reps),
                  results, call=lambda: sk.lsr_coeffs(si, *visc, *rest))
    ws = sk.Workspace(si, pr["uIce"])
    p = si.p

    def ctrl_of(done=0, m=0, it4u=1, it4v=1):
        return (torch.tensor([done, m, it4u, it4v, p.linearIterMax,
                              p.linearIterMax], dtype=torch.int32,
                             device="cuda"),
                torch.tensor([p.LSRrelaxU, p.LSRrelaxV, 0.8, 0.8],
                             dtype=dtype, device="cuda"))

    # the half-sweeps, k = 0 on the entry values and k = 1 after it
    uTmp = {True: pr["uIce"], False: pr["vIce"]}
    after = {}
    for along_x, name in ((True, "seaice_lsr_tridiag_u"),
                          (False, "seaice_lsr_tridiag_v")):
        outs, wants, ms, plain_ms = [], [], [], []
        u_k, u_p = uTmp[along_x].clone(), uTmp[along_x].clone()
        for k in (0, 1):
            ctrl, wf = ctrl_of()
            si.lsr_sweep(along_x, k, c, u_k, uTmp[along_x], ctrl, wf, ws)
            si.lsr_sweep(along_x, k, c, u_p, uTmp[along_x], ctrl, wf, None,
                         impl="plain")
            outs.append(u_k.clone())
            wants.append(u_p.clone())
            scratch = u_k.clone()
            ms.append(cuda_time_ms(lambda: si.lsr_sweep(
                along_x, k, c, scratch, uTmp[along_x], ctrl, wf, ws), reps))
            plain_ms.append(cuda_time_ms(lambda: si.lsr_sweep(
                along_x, k, c, scratch, uTmp[along_x], ctrl, wf, None,
                impl="plain"), plain_reps))
        after[along_x] = outs[-1]
        exact_compare(name, case, outs, wants, float(np.mean(ms)),
                      float(np.mean(plain_ms)), results,
                      call=lambda: si.lsr_sweep(along_x, 0, c, u_k.clone(),
                                                uTmp[along_x], ctrl, wf, ws))
        # a half-sweep solves the lines of one parity: half the cells of
        # the six coefficient fields and the mask, u written, uTmp and the
        # lines beside it read
        half = pr["uIce"].numel() // 2 * pr["uIce"].element_size()
        results[name]["bound_ms"] = 10 * half / PEAK_BYTES_S * 1e3
        results[name]["bound_by"] = "bytes"
        print(f"{'':18s} bound per half-sweep (half the cells) "
              f"{results[name]['bound_ms']:.4f} ms", flush=True)
    # the check, at a plain iteration (m = 0 -> 1) and at a check one
    # (m = 1 -> 2), on the half-sweeps' output against the entry values
    for m in (0, 1):
        res = {}
        for impl in (None, "plain"):
            bufs = [after[True].clone(), after[False].clone(),
                    pr["uIce"].clone(), pr["vIce"].clone()]
            ctrl, wf = ctrl_of(m=m)
            si.lsr_check(*bufs, ctrl, wf, ws, impl=impl)
            res[impl] = bufs + [wf, ctrl.to(dtype)]
        ctrl0, wf0 = ctrl_of(m=m)
        ctrl, wf = ctrl0.clone(), wf0.clone()

        def check(impl):
            ctrl.copy_(ctrl0)
            wf.copy_(wf0)
            si.lsr_check(*bufs, ctrl, wf, ws, impl=impl)

        exact_compare("seaice_lsr_check", case, res[None], res["plain"],
                      cuda_time_ms(lambda: check(None), reps),
                      cuda_time_ms(lambda: check("plain"), plain_reps),
                      results, call=lambda: check(None))
        print(f"{'':18s} m {m} -> ctrl {res[None][-1].tolist()} / "
              f"{res['plain'][-1].tolist()}, WFAU, WFAV, S1A, S2A "
              f"{res[None][4].tolist()}", flush=True)
    # frozen launches leave everything as it was
    u, v = pr["uIce"].clone(), pr["vIce"].clone()
    ut, vt = u.clone(), v.clone()
    ctrl, wf = ctrl_of(done=1, m=3)
    for along_x, x, xt in ((True, u, ut), (False, v, vt)):
        si.lsr_sweep(along_x, 0, c, x, xt, ctrl, wf, ws)
    si.lsr_check(u, v, ut, vt, ctrl, wf, ws)
    ctrl2, wf2 = ctrl_of(it4u=0)
    si.lsr_sweep(True, 1, c, u, ut, ctrl2, wf2, ws)
    untouched = (torch.equal(u, pr["uIce"]) and torch.equal(v, pr["vIce"])
                 and ctrl.tolist()[:2] == [1, 3])
    print(f"{'seaice_lsr (frozen)':18s} {case.label:18s} launches with done "
          f"set or the component stopped leave u, v as they were: "
          f"{untouched}", flush=True)
    if not untouched:
        raise AssertionError("a frozen sea-ice LSR launch wrote its outputs")
    # the whole linear loop
    if whole_loop:
        rk = si.lsr_iterate(c, pr["uIce"], pr["vIce"])
        rp = si.lsr_iterate(c, pr["uIce"], pr["vIce"], impl="plain")
        same = torch.equal(rk[0], rp[0]) and torch.equal(rk[1], rp[1])
        print(f"LSR loop            {case.label:18s} u, v bit-equal {same}, "
              f"ICOUNT1/2 {rk[2]} / {rp[2]} (kernel / plain), host syncs "
              f"{rk[3]} / {rp[3]}", flush=True)
        if not (same and rk[2] == rp[2]
                and rk[3] <= math.ceil(max(rk[2]) / 8) + 1):
            raise AssertionError("the LSR loop's kernel path disagrees with "
                                 "the plain path")
    # seaice_advect: the X launch, then the Y launch on the twin's X output
    ice = case.ice
    flds = torch.stack([ice.HEFF, ice.AREA, ice.HSNOW])
    lt_p = torch.stack(si._advect_x_plain(ice, flds.unbind(0)))
    lt_k = torch.empty_like(flds)
    sk.advect_x(si, ice, flds, lt_k)
    exact_compare("seaice_advect_x", case, [lt_k], [lt_p],
                  cuda_time_ms(lambda: sk.advect_x(si, ice, flds, lt_k),
                               reps),
                  cuda_time_ms(lambda: si._advect_x_plain(
                      ice, flds.unbind(0)), plain_reps), results,
                  call=lambda: sk.advect_x(si, ice, flds, lt_k))
    out_k = torch.empty_like(flds)
    sk.advect_y(si, ice, flds, lt_p, out_k)
    out_p = torch.stack(si._advect_y_plain(ice, flds.unbind(0),
                                           lt_p.unbind(0)))
    exact_compare("seaice_advect_y", case, [out_k], [out_p],
                  cuda_time_ms(lambda: sk.advect_y(si, ice, flds, lt_p,
                                                   out_k), reps),
                  cuda_time_ms(lambda: si._advect_y_plain(
                      ice, flds.unbind(0), lt_p.unbind(0)), plain_reps),
                  results,
                  call=lambda: sk.advect_y(si, ice, flds, lt_p, out_k))

    def thermo(impl):
        ice2, f = si.thermo(case.ice2, case.forc, case.theta0, case.salt0,
                            impl=impl)
        return [ice2.HEFF, ice2.HSNOW, ice2.AREA, ice2.TICES] + list(
            f.values())

    exact_compare("seaice_thermo", case, thermo(None), thermo("plain"),
                  cuda_time_ms(lambda: thermo(None), reps),
                  cuda_time_ms(lambda: thermo("plain"), plain_reps), results,
                  call=lambda: thermo(None))


def ice_experiment(n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.ice_gyre_config(nx=n, ny=n, nr=nr, **kw)
    grid, state, forcing, op, kpp, si = synthetic.ice_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, kpp=kpp, impl=impl,
                      seaice=si)


ICE_STATE = ("uIce", "vIce", "siAREA", "siHEFF", "siHSNOW", "siTICES")


def ice_parity_phase():
    """10 float64 steps of the 64x64x12 ice-gyre, kernel path against plain
    path: every record to 16 digits, equal cg2d and LSR iteration counts,
    the ice and ocean fields bit for bit."""
    from mitgcm_tpu_torch.utils.compare import EQUAL_DIGITS, record_digits

    exps = {impl: ice_experiment(64, 12, torch.float64, impl)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=10) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        print(f"ice step {rk['iter']:2d}: cg2d iters {rk['cg2d_iters']} / "
              f"{rp['cg2d_iters']}, LSR ICOUNTs {rk['lsr_iters']} / "
              f"{rp['lsr_iters']}, host syncs {rk['lsr_host_syncs']}, mean "
              f"AREA {rk['seaice_area_mean']:.10f}, fewest digits "
              f"{dig[key]:.2f} ({key})", flush=True)
        if (rk["cg2d_iters"], rk["lsr_iters"]) != (rp["cg2d_iters"],
                                                  rp["lsr_iters"]):
            raise AssertionError("ice-gyre iteration counts differ")
    names = ICE_STATE + ("uVel", "theta", "salt", "etaN")
    same = [n for n in names if torch.equal(getattr(exps[None].state, n),
                                            getattr(exps["plain"].state, n))]
    print(f"ice-gyre parity: fewest matching digits {worst:.2f}; bit-equal "
          f"fields {len(same)} of {len(names)}", flush=True)
    if not (worst >= EQUAL_DIGITS and len(same) == len(names)):
        raise AssertionError("ice-gyre kernel path differs from the plain "
                             "path")


def ice_restart_phase():
    """A 2+2 restart of the 64x64x12 float64 ice-gyre through pickup and
    pickup_seaice on the kernel path, against 4 straight steps."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import read_pickup, write_pickup

    e4 = ice_experiment(64, 12, torch.float64)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = ice_experiment(64, 12, torch.float64)
    e2.run(n_steps=2, collect_monitor=False)
    e22 = ice_experiment(64, 12, torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        write_pickup(e2, tmp, 2)
        read_pickup(e22, tmp, 2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    names = ("uVel", "vVel", "theta", "salt", "etaN", "guNm1", "gtNm2") \
        + ICE_STATE
    differ = [n for n in names
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    print(f"2+2 restart of the ice-gyre on the kernel path, 64x64x12 "
          f"float64: {len(names) - len(differ)} of {len(names)} fields "
          f"bit-equal", flush=True)
    if differ:
        raise AssertionError(f"ice-gyre restart differs in {differ}")


def ice_full_phase(kernels, smi):
    """The 1024x1024x32 float32 ice-gyre (deltaT = 600): a warm-up step, 5
    timed steps with every launch count and the LSR's iterations and host
    syncs per Picard pass, a profile and 1 plain step."""
    from mitgcm_tpu_torch.model import kpp as kpp_mod
    from mitgcm_tpu_torch.model import seaice as seaice_mod

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = ice_experiment(n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    state0 = exp.state
    points = n * n * nr

    def run(state, it0, steps, impl):
        exp.state, exp.cur_iter, exp.impl = state, it0, impl
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, recs, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, recs_w, sec_w = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = kpp_mod.plain_calls + glue_plain_calls()
    state, recs, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = kpp_mod.plain_calls + glue_plain_calls() - plain0
    icounts = [r["lsr_iters"] for r in recs]
    syncs = [r["lsr_host_syncs"] for r in recs]
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations "
          f"{recs_w[0]['cg2d_iters']}, LSR ICOUNT1/2 per pass "
          f"{recs_w[0]['lsr_iters']}")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations "
          f"{[r['cg2d_iters'] for r in recs]}, LSR ICOUNT1/2 per Picard "
          f"pass {icounts}, LSR host syncs per pass {syncs}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain KPP, sea-ice, D-G and Q calls {plain}; launches "
          f"{launches}",
          flush=True)
    for name in ("uVel", "vVel", "theta", "salt", "etaN") + ICE_STATE:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"ice-gyre {name} is not finite")
    ol = exp.cfg.olx
    area = state.siAREA[ol:-ol, ol:-ol]
    wet = exp.grid.maskC[0, ol:-ol, ol:-ol] > 0
    heff = state.siHEFF[ol:-ol, ol:-ol]
    mean_area = float(area[wet].mean())
    print(f"after 6 steps: mean AREA {mean_area:.6f} over the wet cells "
          f"(ice-covered cells {int((area[wet] > 0).sum())} of "
          f"{int(wet.sum())}), mean HEFF {float(heff[wet].mean()):.6f} m, "
          f"|uIce| max {float(state.uIce.abs().max()):.4e} m/s", flush=True)
    batches = seaice_mod.BATCH * sum(s for per_step in syncs
                                     for s in per_step)
    want = {**KPP_LAUNCHES, "seaice_lsr_visc": 10, "seaice_lsr_coeffs": 10,
            "seaice_lsr_tridiag_u": 2 * batches,
            "seaice_lsr_tridiag_v": 2 * batches, "seaice_lsr_check": batches,
            "seaice_advect_x": 5, "seaice_advect_y": 5, "seaice_thermo": 5,
            **{k: 5 for k in SEAICE_GLUE_KERNELS},
            **{k: 0 for k in EVP_KERNELS},
            # the sea ice's fills: the ocean stress, the ice velocity after
            # the LSR, the four ice fields and the updated forcing
            "halo_fill": 120}
    wrong = {k: launches.get(k, 0) for k, count in want.items()
             if launches.get(k, 0) != count}
    late = [(c, s) for cs, ss in zip(icounts, syncs) for c, s in zip(cs, ss)
            if s > math.ceil(max(c) / seaice_mod.BATCH) + 1]
    if wrong or plain or late or not mean_area > 0.0:
        raise AssertionError(f"ice-gyre launch counts {wrong} (want {want}),"
                             f" plain calls {plain}, host syncs over "
                             f"ceil(iters/{seaice_mod.BATCH})+1 {late}, "
                             f"mean AREA {mean_area}")
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    _, recs_p, sec_p = run(state1, 1, 1, "plain")
    print(f"plain path: 1 step, {sec_p * 1e3:.2f} ms/step, "
          f"{points / sec_p:.4e} points*steps/s, LSR ICOUNT1/2 "
          f"{recs_p[0]['lsr_iters']} (kernel path's first timed step "
          f"{icounts[0]})", flush=True)
    if recs_p[0]["lsr_iters"] != icounts[0]:
        raise AssertionError("the plain path's LSR iterations differ")
    return launches


def ice_phase(kernels, results, smi):
    phase("13 sea ice: the ice-gyre")
    ice_kernel_phase(IceCase(64, 12, torch.float64), results, 20, 20, True)
    ice_kernel_phase(IceCase(1024, 32, torch.float32), results, 10, 3, False)
    torch.cuda.empty_cache()
    ice_parity_phase()
    ice_restart_phase()
    run = ice_full_phase(kernels, smi)
    torch.cuda.empty_cache()
    return {k: run[k] for k in ICE_KERNELS + SEAICE_GLUE_KERNELS}


class EvpCase:
    """The evp-ice-gyre's grid with seeded ice, EVP stresses, ocean and
    forcing on the card, and a SeaIce for each of EVP_VARIANTS."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.model.seaice import (SeaIce,
                                                   params_from_namelists)
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.evp_ice_gyre_config(nx=n, ny=n, nr=nr,
                                                 deltaT=600.0)
        self.grid = (shared_grid(self.cfg, dtype)
                     or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                            device="cuda"))
        self.si = {name: SeaIce(self.cfg, self.grid, params_from_namelists(
            self.cfg, {**synthetic.ICE_GYRE_SEAICE, **nml}))
            for name, nml in EVP_VARIANTS.items()}
        si = self.si["aEVP"]
        rng = np.random.default_rng(SEED + 15)
        shape = tuple(self.grid.rA.shape)

        def fld(lo, hi, mask=None):
            a = torch.as_tensor(rng.uniform(lo, hi, shape), dtype=dtype,
                                device="cuda")
            return a * mask if mask is not None else a

        mU, mV, hm = si.seaiceMaskU, si.seaiceMaskV, si.HEFFM
        self.ice = si.init_state()._replace(
            uIce=si.fill(fld(-0.2, 0.2, mU)), vIce=si.fill(fld(-0.2, 0.2, mV)),
            AREA=fld(0.0, 1.0, hm), HEFF=fld(0.0, 3.0, hm),
            HSNOW=fld(0.0, 0.5, hm),
            sigma=torch.stack([fld(-1e3, 1e3, hm), fld(-1e3, 1e3, hm),
                               fld(-1e3, 1e3)]))
        massU = fld(0.0, 3e3, mU)
        massU[::3, ::2] = 0.0        # cells without ice mass
        self.dyn = dict(uVel0=fld(-0.3, 0.3), vVel0=fld(-0.3, 0.3),
                        press0=fld(0.0, 4e4, hm), massC=fld(1e3, 3e3, hm),
                        massU=massU, massV=fld(0.0, 3e3, mV),
                        forcex0=fld(-1.0, 1.0), forcey0=fld(-1.0, 1.0))
        # the step's initial ice velocity, seeded apart from the
        # subcycle's u and v (a later subcycle's, as they differ there)
        self.uvNm1 = (si.fill(fld(-0.2, 0.2, mU)),
                      si.fill(fld(-0.2, 0.2, mV)))

    field = Case.field
    label = Case.label


def evp_kernel_phase(case, results, reps, plain_reps):
    """For each EVP variant, the main path's loop seaice_kernels.evp_loop
    against its twin SeaIce._evp_loop_plain on the same inputs, on whole
    arrays, bit for bit: one subcycle, whose sigma1 and sigma2 are
    seaice_evp_stress's and whose u, v, sigma12, dwatn and divergence are
    seaice_evp_uv's (last launch), with the step's initial velocity seeded
    apart from u and v; then the variant's whole loop through SeaIce.evp,
    kernel path against plain path. Each kernel is timed a launch back to
    back (launch_ms, the first launch of each in a 2-subcycle loop: the
    loop enqueues its 1000 launches a step so) and each twin a call; then
    seaice_freedrift against its twin."""
    from mitgcm_tpu_torch.model import seaice_kernels as sk
    from mitgcm_tpu_torch.utils import synthetic

    ice, d = case.ice, case.dyn
    dyn = [d[k] for k in ("uVel0", "vVel0", "press0", "massC", "massU",
                          "massV", "forcex0", "forcey0")]
    fixed = dict(uNm1=case.uvNm1[0], vNm1=case.uvNm1[1],
                 **{k: d[k] for k in ("uVel0", "vVel0", "forcex0", "forcey0",
                                      "massC", "massU", "massV")})
    u, v, (s1, s2, s12) = ice.uIce, ice.vIce, ice.sigma
    for name, si in case.si.items():
        label = "" if name == "aEVP" else f"({name})"
        setup = synthetic.evp_setup(si, ice.AREA, d["massU"], d["massV"])
        args = (u, v, s1, s2, s12, d["press0"], fixed, setup)
        uk, vk, dwk, sigk, dxk, dyk = sk.evp_loop(si, *args, 1)
        up, vp, dwp, sigp, dxp, dyp = si._evp_loop_plain(*args, 1)
        sa = (u, v, s1, s2, d["press0"], d["massC"])
        st = si._evp_stress_plain(*sa)
        ub = (u, v, s12, *st, *fixed.values())
        # what one launch reads (each input once) and writes: stress 13
        # fields and sigma1, sigma2, zeta, alpha; uv 36 fields and u, v,
        # sigma12 (the last launch also dwatn and the divergence)
        touched_a = (list(sk._stress_ins(si, *sa).values())
                     + [torch.empty_like(u) for _ in range(4)])
        touched_b = (list(sk._uv_ins(si, u, v, s12, *st, fixed,
                                     setup).values())
                     + [torch.empty_like(u) for _ in range(3)])

        def loop2():
            return sk.evp_loop(si, *args, 2)
        exact_compare(
            "seaice_evp_stress" + label, case, [sigk[0], sigk[1]],
            [sigp[0], sigp[1]], launch_ms(loop2, "seaice_evp_stress", reps),
            cuda_time_ms(lambda: si._evp_stress_plain(*sa), plain_reps),
            results, touched=touched_a)
        exact_compare(
            "seaice_evp_uv" + label, case, [uk, vk, sigk[2], dwk, dxk, dyk],
            [up, vp, sigp[2], dwp, dxp, dyp],
            launch_ms(loop2, "seaice_evp_uv", reps),
            cuda_time_ms(lambda: si._evp_uv_plain(*ub, setup), plain_reps),
            results, touched=touched_b)
        rk = si.evp(ice, *dyn, setup)
        rp = si.evp(ice, *dyn, setup, impl="plain")
        same = all(torch.equal(a, b) for a, b in zip(rk, rp))
        print(f"EVP loop {name:10s} {case.label:18s} "
              f"{si.p.nEVPstarSteps} subcycles: u, v, dwatn, sigma, "
              f"divX, divY bit-equal {same}, |uIce| max "
              f"{float(rk[0].abs().max()):.4e}", flush=True)
        if not same:
            raise AssertionError(f"the EVP loop ({name}) disagrees with its "
                                 f"twins at {case.label}")
    si = case.si["aEVP"]
    fd = (ice.HEFF, d["uVel0"], d["vVel0"], d["forcex0"], d["forcey0"])
    exact_compare("seaice_freedrift", case, list(sk.freedrift(si, *fd)),
                  list(si._freedrift_plain(*fd)),
                  launch_ms(lambda: sk.freedrift(si, *fd),
                            "seaice_freedrift", reps),
                  cuda_time_ms(lambda: si._freedrift_plain(*fd), plain_reps),
                  results, call=lambda: sk.freedrift(si, *fd))


def evp_experiment(n, nr, dtype, impl=None, free_drift=False, **kw):
    """The evp-ice-gyre (or, with free_drift, the ice-gyre under free
    drift) on the card."""
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    if free_drift:
        cfg = synthetic.ice_gyre_config(nx=n, ny=n, nr=nr, **kw)
        cfg.seaice.useFreeDrift = True
    else:
        cfg = synthetic.evp_ice_gyre_config(nx=n, ny=n, nr=nr, **kw)
    grid, state, forcing, op, kpp, si = synthetic.ice_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, kpp=kpp, impl=impl,
                      seaice=si)


EVP_STATE = ICE_STATE + ("siSigma",)


def evp_parity_phase(free_drift=False, steps=3):
    """Float64 steps of the 64x64x12 evp-ice-gyre (or free-drift ice-gyre),
    kernel path against plain path: every record to PARITY_DIGITS, equal
    cg2d iterations, and the ice and ocean fields, sigma included, bit for
    bit; returns the kernel path's launches."""
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.utils.compare import record_digits

    exps = {impl: evp_experiment(64, 12, torch.float64, impl, free_drift)
            for impl in (None, "plain")}
    kernels.launches.clear()
    runs = {None: exps[None].run(n_steps=steps)}
    launches = dict(kernels.launches)
    runs["plain"] = exps["plain"].run(n_steps=steps)
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        key = min(dig, key=dig.get)
        worst = min(worst, dig[key])
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError("evp-ice-gyre cg2d iterations differ")
    names = (ICE_STATE if free_drift else EVP_STATE) + (
        "uVel", "theta", "salt", "etaN")
    same = [n for n in names if torch.equal(getattr(exps[None].state, n),
                                            getattr(exps["plain"].state, n))]
    label = "free-drift ice-gyre" if free_drift else "evp-ice-gyre"
    print(f"{label} parity, 64x64x12 float64, {steps} steps: fewest "
          f"matching digits {worst:.2f} ({key}); bit-equal fields "
          f"{len(same)} of {len(names)}; mean AREA "
          f"{runs[None][-1]['seaice_area_mean']:.10f}, |uIce| max "
          f"{float(exps[None].state.uIce.abs().max()):.4e}; launches "
          f"{ {k: launches.get(k, 0) for k in EVP_KERNELS} }", flush=True)
    if not worst >= PARITY_DIGITS or len(same) != len(names):
        raise AssertionError(f"{label} kernel path differs from the plain "
                             f"path (bit-equal: {same} of {names})")
    return launches


def evp_restart_phase():
    """A 2+2 restart of the 64x64x12 float64 evp-ice-gyre through pickup
    and pickup_seaice (the EVP stresses included) on the kernel path,
    against 4 straight steps."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import read_pickup, write_pickup

    e4 = evp_experiment(64, 12, torch.float64)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = evp_experiment(64, 12, torch.float64)
    e2.run(n_steps=2, collect_monitor=False)
    e22 = evp_experiment(64, 12, torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        write_pickup(e2, tmp, 2)
        read_pickup(e22, tmp, 2)
    e22.run(n_steps=2, collect_monitor=False)
    ol = e4.cfg.olx
    names = ("uVel", "vVel", "theta", "salt", "etaN", "guNm1") + EVP_STATE
    differ = [n for n in names
              if not torch.equal(getattr(e4.state, n)[..., ol:-ol, ol:-ol],
                                 getattr(e22.state, n)[..., ol:-ol, ol:-ol])]
    print(f"2+2 restart of the evp-ice-gyre on the kernel path, 64x64x12 "
          f"float64: {len(names) - len(differ)} of {len(names)} fields "
          f"bit-equal (sigma through siSigm1/2/12)", flush=True)
    if differ:
        raise AssertionError(f"evp-ice-gyre restart differs in {differ}")


def evp_full_phase(kernels, smi):
    """The 1024x1024x32 float32 evp-ice-gyre (deltaT = 600): a warm-up
    step, 5 timed steps with every launch count (500 subcycles a step, two
    launches each, no LSR launch, no twin), the peak memory, |uIce| and the
    mean AREA, a profile, then 1 plain step, held against 1 kernel step
    from the same state (the ice fields, uVel and theta bit-equal)."""
    from mitgcm_tpu_torch.model import kpp as kpp_mod
    from mitgcm_tpu_torch.model import seaice as seaice_mod

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = evp_experiment(n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    state0 = exp.state
    points = n * n * nr
    nsub = exp.seaice.p.nEVPstarSteps

    def run(state, it0, steps, impl):
        exp.state, exp.cur_iter, exp.impl = state, it0, impl
        torch.cuda.synchronize()
        t = time.perf_counter()
        exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, sec_w = run(state0, 0, 1, None)
    kernels.launches.clear()
    plain0 = kpp_mod.plain_calls + glue_plain_calls()
    state, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = kpp_mod.plain_calls + glue_plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, {nsub} EVP subcycles "
          f"a step, no host read inside the loop")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain KPP, sea-ice, D-G and Q calls {plain}; launches "
          f"{launches}", flush=True)
    for name in ("uVel", "vVel", "theta", "salt", "etaN") + EVP_STATE:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"evp-ice-gyre {name} is not finite")
    ol = exp.cfg.olx
    area = state.siAREA[ol:-ol, ol:-ol]
    wet = exp.grid.maskC[0, ol:-ol, ol:-ol] > 0
    mean_area = float(area[wet].mean())
    umax = float(state.uIce.abs().max())
    print(f"after 6 steps: mean AREA {mean_area:.6f} over the wet cells, "
          f"|uIce| max {umax:.4e} m/s, |vIce| max "
          f"{float(state.vIce.abs().max()):.4e} m/s, |sigma| max "
          f"{float(state.siSigma.abs().max()):.4e}", flush=True)
    want = {**KPP_LAUNCHES, "seaice_evp_stress": 5 * nsub,
            "seaice_evp_uv": 5 * nsub, "seaice_freedrift": 0,
            **{k: 0 for k in ICE_KERNELS[:5]},
            "seaice_advect_x": 5, "seaice_advect_y": 5, "seaice_thermo": 5,
            **{k: 5 for k in SEAICE_GLUE_KERNELS},
            # the sea ice's fills: the ocean stress, the four ice fields and
            # the updated forcing (EVP fills u and v inside seaice_evp_uv)
            "halo_fill": 110}
    check_launches("evp-ice-gyre", launches, want, plain)
    clip = exp.seaice.p.clipVelocities
    if not mean_area > 0.0 or (clip and umax > 0.40):
        raise AssertionError(f"evp-ice-gyre mean AREA {mean_area}, |uIce| "
                             f"max {umax} (clipVelocities {clip})")
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    state_k, _ = run(state1, 1, 1, None)
    state_p, sec_p = run(state1, 1, 1, "plain")
    names = EVP_STATE + ("uVel", "theta")
    same = [k for k in names
            if torch.equal(getattr(state_k, k), getattr(state_p, k))]
    print(f"plain path: 1 step, {sec_p * 1e3:.2f} ms/step, "
          f"{points / sec_p:.4e} points*steps/s; against the kernel path's "
          f"step from the same state, bit-equal fields {same}", flush=True)
    if len(same) != len(names):
        raise AssertionError(f"evp-ice-gyre plain step differs from the "
                             f"kernel step: bit-equal {same} of {names}")
    return launches


def evp_phase(kernels, results, smi):
    phase("15 sea ice EVP: the evp-ice-gyre")
    evp_kernel_phase(EvpCase(64, 12, torch.float64), results, 20, 5)
    evp_kernel_phase(EvpCase(1024, 32, torch.float32), results, 10, 2)
    torch.cuda.empty_cache()
    evp_parity_phase()
    evp_restart_phase()
    fd = evp_parity_phase(free_drift=True, steps=2)
    if fd.get("seaice_freedrift", 0) != 2 or fd.get("seaice_evp_uv", 0):
        raise AssertionError(f"free-drift launches {fd}")
    run = evp_full_phase(kernels, smi)
    GRIDS.clear()
    torch.cuda.empty_cache()
    return {"seaice_evp_stress": run["seaice_evp_stress"],
            "seaice_evp_uv": run["seaice_evp_uv"],
            "seaice_freedrift": fd["seaice_freedrift"]}


# the GM-Redi tapers phase 16 holds gm_tensor against its twin with, in
# both forms and with and without GM_NON_UNITY_DIAGONAL (ldd97 in the
# skew-flux form only, as check_gmredi allows), and gm_psi_b's; the main
# paths' (the gm-gyre's gkw91 and the gm-bolus-gyre's dm95) report the
# JSON rows
GM_TAPERS = ("", "linear", "ldd97", "ac02", "dm95", "gkw91")
GM_PSI_TAPERS = ("", "gkw91", "ac02", "linear", "dm95")


class GmCase:
    """The gm-gyre's grid on the card with a seeded state: the front of
    gm_gyre_setup with noise on theta and salt (statically unstable in
    places), its density and sigmaR, random velocities, diffusivities and
    a KPP-like nonlocal flux."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.model import thermodynamics as th
        from mitgcm_tpu_torch.model import gad
        from mitgcm_tpu_torch.ops import eos
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.gm_gyre_config(nx=n, ny=n, nr=nr, deltaT=600.0)
        (self.grid, state, _, _, _) = synthetic.gm_gyre_setup(
            self.cfg, dtype=dtype, device="cuda",
            grid=shared_grid(self.cfg, dtype))
        cfg, g = self.cfg, self.grid
        rng = np.random.default_rng(SEED + 16)
        shape = tuple(g.hFacC.shape)
        theta = (state.theta + self.field(rng, shape, 0.05)) * g.maskC
        salt = (state.salt + self.field(rng, shape, 0.01)) * g.maskC
        self.rho = eos.find_rho(cfg, g, theta, salt,
                                totPhiHyd=state.totPhiHyd) * g.maskC
        self.sigmaR = th.calc_sigmaR(cfg, g, self.rho, theta, salt,
                                     totPhiHyd=state.totPhiHyd)
        self.theta = theta
        self.u = self.field(rng, shape, 0.1) * g.maskW
        self.v = self.field(rng, shape, 0.1) * g.maskS
        self.w = self.field(rng, shape, 1e-4) * g.maskC
        self.flow = gad.calc_adv_flow(g, self.u, self.v, self.w)
        self.kappaR = self.field(rng, shape, 1e-4).abs()
        self.df = self.field(rng, shape, 1e-3) * g.maskC

    def gm(self, **settings):
        import dataclasses

        return dataclasses.replace(self.cfg.gmredi, **settings)

    field = Case.field
    label = Case.label


def gm_kernel_phase(case, results, reps, plain_reps):
    """gm_tensor for every taper, form and nonUnityDiagonal, gm_psi_b for
    every taper of the bolus form and gm_residual_flow against their twins
    on whole arrays; C's GM branch (scheme 2 and no advection, with and
    without df, a 3-D and a constant Kux/Kvy, with and without Kuz/Kvz)
    against its twin on the interior (C writes zero halos): all bit for
    bit. Each main-path kernel is timed a launch back to back."""
    from mitgcm_tpu_torch.model import gad, gmredi
    from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo

    cfg, g = case.cfg, case.grid
    rho, sigmaR = case.rho, case.sigmaR
    fields = ("Kwx", "Kwy", "Kwz", "Kux", "Kvy", "Kuz", "Kvz")
    tensors = {}
    for taper in GM_TAPERS:
        for adv in (False, True):
            if adv and taper == "ldd97":
                continue
            for nu in (False, True):
                gm = case.gm(taper_scheme=taper, advForm=adv,
                             nonUnityDiagonal=nu)

                def call(gm=gm, impl=None):
                    return gmredi.gm_tensor(cfg, g, gm, rho, sigmaR,
                                            impl=impl)
                k, p = call(), call(impl="plain")
                outs = [getattr(k, f) for f in fields
                        if getattr(p, f) is not None]
                wants = [getattr(p, f) for f in fields
                         if getattr(p, f) is not None]
                main = (taper, adv, nu) in (("gkw91", False, True),
                                            ("dm95", True, True))
                name = "gm_tensor" if main and not adv else (
                    f"gm_tensor({taper or 'clip'}"
                    f"{',bolus' if adv else ''}{'' if nu else ',unity'})")
                exact_compare(
                    name, case, outs, wants,
                    launch_ms(call, "gm_tensor", reps) if main else None,
                    cuda_time_ms(lambda: call(impl="plain"), plain_reps)
                    if main else None, results, call=call)
                if (taper, adv, nu) in (("gkw91", False, True),
                                        ("dm95", True, True),
                                        ("gkw91", False, False)):
                    tensors[taper, adv, nu] = p
    psi = None
    for taper in GM_PSI_TAPERS:
        gm = case.gm(taper_scheme=taper, advForm=True)

        def call(gm=gm, impl=None):
            return gmredi.gm_psi_b(cfg, g, gm, rho, sigmaR, impl=impl)
        main = taper == "dm95"
        psi = call(impl="plain")
        exact_compare(
            "gm_psi_b" if main else f"gm_psi_b({taper or 'clip'})", case,
            list(call()), list(psi),
            launch_ms(call, "gm_psi_b", reps) if main else None,
            cuda_time_ms(lambda: call(impl="plain"), plain_reps)
            if main else None, results, call=call)
    filled = [cyclic_fill_halo(p, cfg.oly, cfg.olx) for p in psi]

    def flow(impl=None):
        return gmredi.gm_residual_flow(cfg, g, *filled, case.u, case.v,
                                       case.w, impl=impl)
    exact_compare("gm_residual_flow", case, list(flow()),
                  list(flow("plain")),
                  launch_ms(flow, "gm_residual_flow", reps),
                  cuda_time_ms(lambda: flow("plain"), plain_reps), results,
                  call=flow)
    # C's GM branch; the gm-gyre's (scheme 2, implicit diffusion, KPP's df,
    # a 3-D Kux/Kvy, no Kuz/Kvz) reports the JSON row
    variants = {"": (tensors["gkw91", False, True], True, case.df),
                "no df": (tensors["gkw91", False, True], True, None),
                "no adv": (tensors["gkw91", False, True], False, case.df),
                "no adv, no df": (tensors["gkw91", False, True], False, None),
                "bolus": (tensors["dm95", True, True], True, case.df),
                "bolus, no adv": (tensors["dm95", True, True], False, None),
                "unity": (tensors["gkw91", False, False], True, case.df),
                "unity, no adv": (tensors["gkw91", False, False], False,
                                  None)}
    ol = cfg.olx
    for label, (ten, adv, df) in variants.items():
        def rhs(impl=None, ten=ten, adv=adv, df=df):
            return gad.calc_rhs(cfg, g, case.flow, case.theta, case.kappaR,
                                cfg.diffKhT, implicit_diffusion=True,
                                impl=impl, df=df, calc_advection=adv, gm=ten)
        name = "gad_calc_rhs_c2_gm" + (f"({label})" if label else "")
        exact_compare(name, case, [rhs()[..., ol:-ol, ol:-ol]],
                      [rhs("plain")[..., ol:-ol, ol:-ol]],
                      launch_ms(rhs, "gad_calc_rhs_c2_gm", reps)
                      if not label else None,
                      cuda_time_ms(lambda: rhs("plain"), plain_reps)
                      if not label else None, results, call=rhs)


def gm_experiment(kind, n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    config = {"gm": synthetic.gm_gyre_config,
              "gm-bolus": synthetic.gm_bolus_gyre_config}[kind]
    cfg = config(nx=n, ny=n, nr=nr, **kw)
    return Experiment(cfg, *synthetic.gm_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype)),
        impl=impl)


GM_FIELDS = ("uVel", "vVel", "wVel", "theta", "salt", "etaN", "guNm1",
             "gvNm1", "guNm2", "gvNm2", "gtNm1", "gsNm1", "gtNm2", "gsNm2",
             "totPhiHyd", "PmEpR")


def interior_equal(a, b, names, ol):
    """The names of `names` whose interior cells are bit-equal in states a
    and b."""
    return [n for n in names
            if torch.equal(getattr(a, n)[..., ol:-ol, ol:-ol],
                           getattr(b, n)[..., ol:-ol, ol:-ol])]


def gm_parity_phase(kind, steps=3):
    """Float64 steps of the 64x64x12 gm- or gm-bolus-gyre, kernel path
    against plain path: equal cg2d iterations and every field of GM_FIELDS
    bit-equal on the interior; returns the kernel path's launches."""
    from mitgcm_tpu_torch import kernels

    exps = {impl: gm_experiment(kind, 64, 12, torch.float64, impl)
            for impl in (None, "plain")}
    kernels.launches.clear()
    runs = {None: exps[None].run(n_steps=steps, collect_monitor=False)}
    launches = dict(kernels.launches)
    runs["plain"] = exps["plain"].run(n_steps=steps, collect_monitor=False)
    iters = [[r["cg2d_iters"] for r in runs[i]] for i in (None, "plain")]
    same = interior_equal(exps[None].state, exps["plain"].state, GM_FIELDS,
                          exps[None].cfg.olx)
    print(f"{kind}-gyre parity, 64x64x12 float64, {steps} steps: cg2d "
          f"iterations {iters[0]} / {iters[1]}; bit-equal fields "
          f"{len(same)} of {len(GM_FIELDS)} (interior); launches "
          f"{ {k: launches.get(k, 0) for k in GM_KERNELS} }", flush=True)
    if iters[0] != iters[1] or len(same) != len(GM_FIELDS):
        raise AssertionError(f"{kind}-gyre kernel path differs from the "
                             f"plain path (bit-equal: {same})")
    return launches


def gm_restart_phase():
    """A 2+2 restart of the 64x64x12 float64 gm-gyre on the kernel path
    against 4 straight steps: GM-Redi carries no state, so the pickup is
    the kpp-gyre's."""
    import tempfile

    from mitgcm_tpu_torch.model.experiment import read_pickup, write_pickup

    e4 = gm_experiment("gm", 64, 12, torch.float64)
    e4.run(n_steps=4, collect_monitor=False)
    e2 = gm_experiment("gm", 64, 12, torch.float64)
    e2.run(n_steps=2, collect_monitor=False)
    e22 = gm_experiment("gm", 64, 12, torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        write_pickup(e2, tmp, 2)
        read_pickup(e22, tmp, 2)
    e22.run(n_steps=2, collect_monitor=False)
    names = GM_FIELDS[:11]
    same = interior_equal(e4.state, e22.state, names, e4.cfg.olx)
    print(f"2+2 restart of the gm-gyre on the kernel path, 64x64x12 "
          f"float64: {len(same)} of {len(names)} fields bit-equal",
          flush=True)
    if len(same) != len(names):
        raise AssertionError(f"gm-gyre restart differs (bit-equal {same})")


def gm_full_phase(kind, kernels, smi, want):
    """The 1024x1024x32 float32 gm- or gm-bolus-gyre (deltaT = 600): a
    warm-up step, 5 timed steps with every launch count (`want`) and no
    twin, the cg2d host syncs, peak memory, a profile, then 1 plain step
    held against 1 kernel step from the same state (GM_FIELDS bit-equal on
    the interior)."""
    from mitgcm_tpu_torch.model import gmredi
    from mitgcm_tpu_torch.model import kpp as kpp_mod
    from mitgcm_tpu_torch.model.step import forward_step

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = gm_experiment(kind, n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    cfg, points = exp.cfg, n * n * nr

    def run(state, it0, steps, impl):
        iters, syncs = [], []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for it in range(it0, it0 + steps):
            state, diag = forward_step(cfg, exp.grid, exp.op, state,
                                       exp.forcing, it, impl=impl,
                                       kpp=exp.kpp)
            iters.append(diag.cg2d_iters)
            syncs.append(diag.cg2d_host_syncs)
        torch.cuda.synchronize()
        return state, iters, syncs, time.perf_counter() - t

    def plain_calls():
        return gmredi.plain_calls + kpp_mod.plain_calls + glue_plain_calls()

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, _, sec_w = run(exp.state, 0, 1, None)
    kernels.launches.clear()
    plain0 = plain_calls()
    state, iters, syncs, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, cg2d iterations {iters},"
          f" host syncs {syncs}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain GM, KPP and D-G calls {plain}; launches {launches}",
          flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{kind}-gyre {name} is not finite")
    check_launches(f"{kind}-gyre", launches, want, plain)
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    state_k = run(state1, 1, 1, None)[0]
    state_p, _, _, sec_p = run(state1, 1, 1, "plain")
    same = interior_equal(state_k, state_p, GM_FIELDS, cfg.olx)
    print(f"plain path: 1 step, {sec_p * 1e3:.2f} ms/step, "
          f"{points / sec_p:.4e} points*steps/s; against the kernel path's "
          f"step from the same state, bit-equal fields (interior) "
          f"{len(same)} of {len(GM_FIELDS)}", flush=True)
    if len(same) != len(GM_FIELDS):
        raise AssertionError(f"{kind}-gyre plain step differs from the "
                             f"kernel step: bit-equal {same}")
    return launches


def gm_phase(kernels, results, smi):
    phase("16 GM-Redi: the gm-gyre and the gm-bolus-gyre")
    gm_kernel_phase(GmCase(64, 12, torch.float64), results, 20, 5)
    gm_kernel_phase(GmCase(1024, 32, torch.float32), results, 10, 2)
    torch.cuda.empty_cache()
    for kind in ("gm", "gm-bolus"):
        got = gm_parity_phase(kind)
        want = {"gm_tensor": 3, "gad_calc_rhs_c2_gm": 6,
                "gad_calc_rhs_c2": 0,
                "gm_psi_b": 3 if kind == "gm-bolus" else 0,
                "gm_residual_flow": 3 if kind == "gm-bolus" else 0}
        check_launches(f"{kind}-gyre parity", got, want)
    gm_restart_phase()
    run = gm_full_phase("gm", kernels, smi, GM_LAUNCHES)
    run_b = gm_full_phase("gm-bolus", kernels, smi, GM_BOLUS_LAUNCHES)
    GRIDS.clear()
    torch.cuda.empty_cache()
    return {"gm_tensor": run["gm_tensor"],
            "gad_calc_rhs_c2_gm": run["gad_calc_rhs_c2_gm"],
            "gm_psi_b": run_b["gm_psi_b"],
            "gm_residual_flow": run_b["gm_residual_flow"]}


class GlueCase:
    """Seeded inputs of the step's glue kernels D-G on the gyre's grid (the
    vi-gyre's options with vi, for AB-3) or, with nh, on the nh-convection
    box's (the box shared with phase 12 at full size)."""

    def __init__(self, n, nr, dtype, vi=False, nh=False):
        from mitgcm_tpu_torch.core.grid import build_grid
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        if nh:
            self.cfg = synthetic.nh_convection_config(nx=n, ny=n, nr=nr)
            self.grid = (shared_grid(self.cfg, dtype, flat=True)
                         or build_grid(self.cfg, dtype=dtype, device="cuda"))
        else:
            config = synthetic.vi_gyre_config if vi else synthetic.gyre_config
            self.cfg = config(nx=n, ny=n, nr=nr)
            self.grid = (shared_grid(self.cfg, dtype)
                         or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                                device="cuda"))
        g = self.grid
        rng = np.random.default_rng(SEED + 7)
        shape = tuple(g.hFacC.shape)
        self.rho = self.field(rng, shape, 0.5) * g.maskC
        self.u = self.field(rng, shape, 0.1) * g.maskW
        self.v = self.field(rng, shape, 0.1) * g.maskS
        self.w = self.field(rng, shape, 1e-3) * g.maskC
        self.eta = self.field(rng, shape[1:], 0.1)
        self.emp = self.field(rng, shape[1:], 1e-6)
        self.sfc = self.field(rng, shape[1:], 1e-3)
        self.theta = 15.0 + self.field(rng, shape, 2.0)
        self.phi_nh = self.field(rng, shape, 1.0)
        self.t3 = {k: self.field(rng, shape, 1e-4) for k in (
            "gU", "gV", "guDiss", "gvDiss", "guExt", "gvExt", "dPhiHydX",
            "dPhiHydY", "guNm1", "gvNm1", "guNm2", "gvNm2", "gW", "gwDiss",
            "gwNm1", "gwNm2", "gTr", "gtNm1", "gtNm2")}

    field = Case.field
    label = Case.label

    def state(self):
        t = self.t3
        return types.SimpleNamespace(
            uVel=self.u, vVel=self.v, wVel=self.w, guNm1=t["guNm1"],
            gvNm1=t["gvNm1"], guNm2=t["guNm2"], gvNm2=t["gvNm2"],
            gwNm1=t["gwNm1"], gwNm2=t["gwNm2"])


def halo_bound(a, oly, olx):
    """F's bound: each interior cell read once, each padded cell written
    once, over the H100's bytes/s."""
    nyp, nxp = a.shape[-2:]
    planes = a.numel() // (nyp * nxp)
    cells = planes * ((nyp - 2 * oly) * (nxp - 2 * olx) + nyp * nxp)
    return cells * a.element_size() / PEAK_BYTES_S * 1e3


def glue_kernel_phase(case, results, reps, kernels_only=None):
    """Each launch of D, E, F and G against its twin on whole padded
    arrays, bit for bit (tol 0), with bounds; every variant of the main
    paths (AB-2 cold start and later, AB-3, with and without the tracer's
    AB, the non-hydrostatic flags on the box), the JSON line's rows timed
    unless reps is 0 (the variants' times stand in PERF.md). kernels_only:
    the kernels to hold (the box runs E and G alone)."""
    import torch.nn.functional as F

    from mitgcm_tpu_torch.model import step, thermodynamics as th
    from mitgcm_tpu_torch.model.mom_fluxform import MomTend
    from mitgcm_tpu_torch.model.phihyd import calc_phi_hyd
    from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo

    cfg, g, t = case.cfg, case.grid, case.t3
    want = set(kernels_only or GLUE_KERNELS)
    nh = cfg.nonHydrostatic

    def hold(name, fn):
        hold_launch(name, case, fn, results,
                    reps if name in KERNELS else 0)

    if "halo_fill" in want:
        ol = cfg.olx
        # theta again, in a view one cell past a 16-byte boundary: no row
        # of it shares its alignment with the fresh output's rows
        spare = case.theta.new_empty(case.theta.numel() + 1)
        offset = spare[1:].view(case.theta.shape)
        offset.copy_(case.theta)
        for label, a in (("halo_fill", case.theta),
                         ("halo_fill(2-D)", case.eta),
                         ("halo_fill(offset)", offset)):
            def fill(impl, a=a):
                return [cyclic_fill_halo(a, ol, ol, impl=impl)]

            # circular padding takes a 3-D or 4-D input for two dimensions
            inner = a[None, ..., ol:-ol, ol:-ol] if a.dim() == 2 else \
                a[..., ol:-ol, ol:-ol]

            def pad(inner=inner):
                return F.pad(inner, (ol, ol, ol, ol), mode="circular")

            hold(label, fill)
            if not torch.equal(pad().reshape(a.shape),
                               cyclic_fill_halo(a, ol, ol)):
                raise AssertionError("F.pad(mode='circular') differs")
            if reps == 0 or label not in KERNELS:
                continue
            # F.pad on the device as F (20 calls in a CUDA graph, the JSON
            # line's), and CUDA events around F's launch replayed back to
            # back and around a batch of F.pad calls, which hold the host's
            # enqueue where the card is the faster (a 2-D fill)
            r = results[label]
            wrapper_ms = r["extra"]["wrapper_ms"]
            events_ms = launch_ms(lambda: fill(None), "halo_fill", reps)
            pad_events_ms = batch_ms(pad, reps)
            r["library_ms"] = graph_ms(pad, reps)
            r["bound_ms"] = halo_bound(a, ol, ol)
            print(f"{'':18s} device time (a CUDA graph of 20 calls) "
                  f"{r['ms']:.4f} ms, F.pad(mode='circular') "
                  f"{r['library_ms']:.4f} ms (same bits); CUDA events: a "
                  f"launch {events_ms:.4f} ms, F.pad {pad_events_ms:.4f} ms,"
                  f" a wrapper call {wrapper_ms:.4f} ms; exact bound "
                  f"{r['bound_ms']:.4f} ms (bytes, "
                  f"{r['bound_ms'] / r['ms']:.2f} of the device time)",
                  flush=True)
            if r["ms"] < r["bound_ms"]:
                raise AssertionError(f"{label}'s device time is below its "
                                     f"bound: the timing is at fault")
            if a is case.theta and cfg.nx >= 1024 and not (
                    r["ms"] <= r["library_ms"]
                    and events_ms <= pad_events_ms):
                raise AssertionError("halo_fill is slower than F.pad in 3-D")
        # halos of 4 around a 3 x 5 interior: wider than the interior
        rng = np.random.default_rng(SEED + 8)
        a = case.field(rng, (2, 3 + 8, 5 + 8), 1.0)
        k, p = (cyclic_fill_halo(a, 4, 4, impl=i) for i in (None, "plain"))
        print(f"halo_fill, halo 4 around 3 x 5: bit-equal "
              f"{torch.equal(k, p)}", flush=True)
        if not torch.equal(k, p):
            raise AssertionError("halo_fill disagrees on a wide halo")
    if "phihyd" in want:
        hold("phihyd", lambda impl: calc_phi_hyd(cfg, g, case.rho,
                                                 impl=impl)[:3])
    if "cg2d_rhs" in want:
        phi = case.phi_nh if nh else None
        # the non-hydrostatic launch reads one level of phi_nh a column
        # (kSurfC - 1), and writes the right-hand side and div
        touched = [case.u, case.v, g.hFacW, g.hFacS, g.dyG, g.dxG, g.rA,
                   case.eta, g.drF, torch.empty_like(case.eta),
                   torch.empty_like(case.u), case.phi_nh[0], g.kSurfC,
                   g.recip_Bo] if nh else None
        hold_launch("cg2d_rhs" + ("(non-hydrostatic)" if nh else ""), case,
                    lambda impl: list(step.cg2d_rhs(
                        cfg, g, case.u, case.v, case.eta,
                        hydrostatic=not nh, impl=impl, phi_nh=phi)),
                    results, 0 if nh else reps, touched=touched)
    if "continuity" in want:
        hold("continuity", lambda impl: step.integr_continuity(
            cfg, g, case.u, case.v, case.emp, impl=impl))
    if "mom_ab_step" in want:
        tend = MomTend(t["gU"], t["gV"], t["guDiss"], t["gvDiss"])
        gw = (t["gW"], t["gwDiss"]) if nh else None
        # the cold start, the second step and a later one
        for it in (2, 1, 0) if cfg.useAB3 else (1, 0):
            def ab(impl, it=it):
                out = step.mom_ab_step(cfg, g, case.state(), tend,
                                       t["dPhiHydX"], t["dPhiHydY"],
                                       t["guExt"][0], t["gvExt"][0], it,
                                       impl=impl,
                                       gw=gw)
                return list(out[:4]) + (
                    [out[6]["wStar"], out[6]["gwNm1"]] if nh else [])
            order = "AB-3" if cfg.useAB3 else "AB-2"
            hold("mom_ab_step" + ("" if it == 1 and not cfg.useAB3
                                  and not nh else f"({order}, step {it})"),
                 ab)
    if "mom_correction" in want:
        hold("mom_correction" + ("(non-hydrostatic)" if nh else ""),
             lambda impl: step.momentum_correction_step(
                 cfg, g, case.eta, case.u, case.v,
                 case.phi_nh if nh else None, impl=impl))
    if "tracer_step" in want:
        for use_ab in (True, False):
            for it in (2, 1, 0) if use_ab else (1,):
                label = ("tracer_step" if use_ab and it == 1
                         and not cfg.useAB3 else
                         f"tracer_step(AB {use_ab}, step {it})")
                hold(label, lambda impl, it=it, use_ab=use_ab: list(
                    th.tracer_step(cfg, g, t["gTr"], case.theta, t["gtNm1"],
                                   t["gtNm2"], case.sfc, it, use_ab,
                                   impl=impl)[:2]))


def glue_phase(results):
    phase("14 step glue kernels D-G")
    # every variant held bit for bit; only the JSON line's rows timed, at
    # the main path's shapes, last
    glue_kernel_phase(GlueCase(64, 4, torch.float64), results, 0)
    glue_kernel_phase(GlueCase(64, 4, torch.float64, vi=True), results, 0,
                      ("mom_ab_step", "tracer_step"))
    glue_kernel_phase(GlueCase(64, 12, torch.float64, nh=True), results, 0,
                      ("cg2d_rhs", "mom_ab_step", "mom_correction"))
    # the box's E and G at 1024x1024x50 (its grid is phase 12's), then the
    # gyre's at the main path's shapes
    glue_kernel_phase(GlueCase(1024, 50, torch.float32, nh=True), results,
                      0, ("cg2d_rhs", "continuity", "mom_ab_step",
                          "mom_correction"))
    GRIDS.clear()
    torch.cuda.empty_cache()
    glue_kernel_phase(GlueCase(1024, 32, torch.float32, vi=True), results,
                      0, ("mom_ab_step", "tracer_step"))
    glue_kernel_phase(GlueCase(1024, 32, torch.float32), results, 10)
    GRIDS.clear()
    torch.cuda.empty_cache()


class MixCase:
    """Seeded inputs of kernels J-uv, J-ts, L and R (eos_find_rho's kinds
    with and without maskC, eos_sigma_r) on the kpp-gyre's grid (its
    stretched levels), the gyres' fields and KPP's, GGL90's and GM's
    outputs as random fields of their scale."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.kpp_gyre_config(nx=n, ny=n, nr=nr, deltaT=600.0)
        self.grid = (shared_grid(self.cfg, dtype)
                     or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                            device="cuda"))
        g = self.grid
        rng = np.random.default_rng(SEED + 17)
        shape = tuple(g.hFacC.shape)
        s2 = shape[1:]
        self.u = self.field(rng, shape, 0.1) * g.maskW
        self.v = self.field(rng, shape, 0.1) * g.maskS
        self.w = self.field(rng, shape, 1e-4) * g.maskC
        self.theta = (15.0 + self.field(rng, shape, 2.0)) * g.maskC
        self.salt = (35.0 + self.field(rng, shape, 0.5)) * g.maskC
        self.phi = self.field(rng, shape, 10.0)     # a totPhiHyd
        self.rho = self.field(rng, shape, 0.5) * g.maskC
        self.viscAz = self.field(rng, shape, 2e-3).abs()
        self.viscArU = self.field(rng, shape, 1e-2).abs()
        self.viscArV = self.field(rng, shape, 1e-2).abs()
        self.Kwz = self.field(rng, shape, 1e-3).abs() * g.maskC
        self.diffKr = self.field(rng, shape, 1e-3).abs()
        self.diffKzT = self.field(rng, shape, 1e-2).abs()
        self.diffKzS = self.field(rng, shape, 1e-2).abs()
        self.ghat = self.field(rng, shape, 10.0)
        self.frac = self.field(rng, s2, 0.5).abs().clamp(max=1.0)
        self.sfT = self.field(rng, s2, 1e-4)
        self.sfS = self.field(rng, s2, 1e-4)
        self.Qsw = -100.0 - self.field(rng, s2, 50.0).abs()
        mC = g.maskC
        self.maskUp = torch.cat([torch.zeros_like(mC[:1]), mC[1:] * mC[:-1]])

    field = Case.field
    label = Case.label


# J-ts's variants: (KPP, GM, GGL90), the kpp-gyre's (KPP) first
KAPPA_TS_VARIANTS = {"": (True, False, False), "KPP+GM": (True, True, False),
                     "GM": (False, True, False),
                     "GGL90": (False, False, True),
                     "GGL90+GM": (False, True, True)}
# R's eos_sigma_r variants (eosType, selectP_inEOS_Zc), and eos_find_rho's
# beside the vi-gyre's (eosType, selectP_inEOS_Zc, maskC)
SIGMA_VARIANTS = (("JMD95Z", 0), ("JMD95Z", 2), ("MDJWF", 0), ("MDJWF", 2),
                  ("LINEAR", 0))
EOS_VARIANTS = (("LINEAR", 0, True), ("LINEAR", 0, False),
                ("JMD95Z", 0, True), ("JMD95Z", 2, True), ("MDJWF", 0, True),
                ("MDJWF", 2, True))


def hold_launch(name, case, fn, results, reps, touched=None):
    """A kernel's wrapper call fn(None) against its twin's fn("plain") on
    whole arrays, bit for bit (exact_compare), with the bound (from the
    tensors the wrapper checks, or from `touched`: those one launch reads
    and writes, when a wrapper's checks are not its launch's); the line's
    time is the launch's device time, 20 launches in a CUDA graph replayed
    (graph_ms), the wrapper call's CUDA-event time, which holds the
    host's work before the launch, beside it. reps 0: held and bound,
    not timed."""
    from mitgcm_tpu_torch import kernels

    outs, wants = fn(None), fn("plain")
    timed = reps > 0
    exact_compare(name, case, outs, wants,
                  cuda_time_ms(lambda: fn(None), reps) if timed else None,
                  cuda_time_ms(lambda: fn("plain"), reps) if timed
                  else None, results,
                  call=None if touched else lambda: fn(None),
                  touched=touched)
    if not timed:
        return
    r = results[name]
    args, keep = captured_launch(lambda: fn(None), name.split("(")[0])
    r["extra"] = {"wrapper_ms": r["ms"]}
    r["ms"] = graph_ms(lambda: kernels.launch(*args), reps)
    del keep
    print(f"{'':18s} device time (20 launches in a CUDA graph) "
          f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.2f} of the bound; "
          f"a wrapper call {r['extra']['wrapper_ms']:.4f} ms", flush=True)


def mix_kernel_phase(case, results, reps):
    """J-uv (KPP, GGL90), J-ts (each of KAPPA_TS_VARIANTS), L, R's
    eos_sigma_r (LINEAR, JMD95Z and MDJWF, on the static profile and on
    totPhiHyd) and eos_find_rho (EOS_VARIANTS) against their twins, bit
    for bit on every padded cell. The variants of the paths whose launches
    the JSON line reports carry the kernels' names (J-uv and J-ts the
    kpp-gyre's KPP, sigmaR the ggl90-gyre's JMD95Z on the static profile);
    R's find_rho keeps phase 7's row."""
    from mitgcm_tpu_torch.model import gad, step, thermodynamics as th
    from mitgcm_tpu_torch.ops import eos

    cfg, g = case.cfg, case.grid
    kpp_fields = {"viscAz": case.viscAz}
    g9_fields = {"viscArU": case.viscArU, "viscArV": case.viscArV}
    for label, kw in (("", {"kpp_fields": kpp_fields}),
                      ("(GGL90)", {"ggl90_fields": g9_fields})):
        hold_launch("kappa_uv" + label, case, lambda impl, kw=kw: list(
            step.kappa_uv(cfg, g, impl=impl, **kw)), results, reps)
    forcing = types.SimpleNamespace(Qsw=case.Qsw)
    for label, (kpp, gm, g9) in KAPPA_TS_VARIANTS.items():
        kw = dict(
            kpp_fields=dict(diffKzT=case.diffKzT, diffKzS=case.diffKzS,
                            ghat=case.ghat, frac=case.frac) if kpp else None,
            ggl90_fields={"diffKr": case.diffKr} if g9 else None,
            gm=types.SimpleNamespace(Kwz=case.Kwz) if gm else None)

        def kappa(impl, kw=kw):
            outs = th.kappa_ts(cfg, g, forcing, case.sfT, case.sfS,
                               case.maskUp, impl=impl, **kw)
            return [t for t in outs if t is not None]

        hold_launch("kappa_ts" + (f"({label})" if label else ""), case,
                    kappa, results, reps)
    hold_launch("adv_flow", case, lambda impl: list(gad.calc_adv_flow(
        g, case.u, case.v, case.w, impl=impl)), results, reps)
    for kind, select_p in SIGMA_VARIANTS:
        c = dataclasses.replace(cfg, eosType=kind, selectP_inEOS_Zc=select_p)
        label = ("" if (kind, select_p) == ("JMD95Z", 0) else
                 f"({kind}{', totPhiHyd' if select_p else ''})")
        hold_launch("eos_sigma_r" + label, case, lambda impl, c=c: [
            th.calc_sigmaR(c, g, case.rho, case.theta, case.salt,
                           totPhiHyd=case.phi, impl=impl)], results, reps)
    for kind, select_p, masked in EOS_VARIANTS:
        c = dataclasses.replace(cfg, eosType=kind, selectP_inEOS_Zc=select_p)
        label = (f"(LINEAR{', maskC' if masked else ''})"
                 if kind == "LINEAR" else
                 f"({kind}{', totPhiHyd' if select_p else ''}, maskC)")
        hold_launch("eos_find_rho" + label, case, lambda impl, c=c,
                    masked=masked: [eos.find_rho(
                        c, g, case.theta, case.salt, totPhiHyd=case.phi,
                        impl=impl, mask=g.maskC if masked else None)],
                    results, reps)


def mix_phase(results):
    phase("17 mixing glue and flow set-up: J-uv, J-ts, L and R's sigmaR and "
          "LINEAR kind")
    mix_kernel_phase(MixCase(64, 12, torch.float64), results, 20)
    mix_kernel_phase(MixCase(1024, 32, torch.float32), results, 10)
    GRIDS.clear()
    torch.cuda.empty_cache()


def nh_last_glue(case, results, reps):
    """N1 and N2 on the box's grid (GlueCase with nh): pre_cg3d, then the
    cg3d set-up's two launches normalised (the box's), not normalised and
    on a right-hand side of zeros."""
    from mitgcm_tpu_torch.model import step
    from mitgcm_tpu_torch.ops.stencil import interior_mask
    from mitgcm_tpu_torch.solver import cg3d

    cfg, g = case.cfg, case.grid
    rng = np.random.default_rng(SEED + 31)
    s3, s2 = tuple(g.hFacC.shape), tuple(g.rA.shape)
    x2 = case.field(rng, s2, 10.0)
    eta, div = g.recip_Bo * x2, case.field(rng, s3, 1e-2)
    hold_launch("pre_cg3d", case, lambda impl: [step.pre_cg3d(
        cfg, g, x2, eta, case.w, div, impl=impl)], results, reps)
    op = types.SimpleNamespace(
        cg3dNorm=torch.tensor(3.7e-3, dtype=case.dtype, device="cuda"),
        imask3=interior_mask(s3, cfg.oly, cfg.olx, case.dtype, "cuda")
        * g.maskC)
    ws = cg3d.Workspace(s3, cfg.oly, cfg.olx, case.dtype, "cuda")
    x0 = case.field(rng, s3, 1.0)

    def like():      # a stand-in for a field the launch writes (or reads)
        return torch.empty_like(x0)

    for label, b, norm in (("", case.field(rng, s3, 50.0), True),
                           ("(not normalised)", div, False),
                           ("(rhsMax 0)", torch.zeros_like(div), True)):
        def setup(impl, b=b, norm=norm):
            outs = (cg3d._setup_plain(op, b, x0, norm) if impl else
                    cg3d._setup_kernel(op, b, x0, norm, ws))
            return list(outs[:6]) + ([outs[6].reshape(())] if norm else [])
        # scale reads b and the mask and writes r; fill reads x0 and the
        # mask and writes x and the four work fields, and normalised reads
        # and writes r too
        timed = 0 if label else reps
        hold_launch("cg3d_setup_scale" + label, case, setup, results, timed,
                    touched=[b, op.imask3, like()])
        hold_launch("cg3d_setup_fill" + label, case, setup, results, timed,
                    touched=[x0, op.imask3] + [like() for _ in range(
                        7 if norm else 5)])


def forcing_last_glue(case, results, reps):
    """Q on the gyre's grid (GlueCase): the gyres' fluxes (the main path's
    variant, no surface stress written), and every term with the
    relaxation under sea ice and KPP's surface stress."""
    from mitgcm_tpu_torch.model import thermodynamics as th

    g = case.grid
    rng = np.random.default_rng(SEED + 32)
    s3, s2 = tuple(g.hFacC.shape), tuple(g.rA.shape)
    forcing = [10.0 + case.field(rng, s2, 1.0),
               34.0 + case.field(rng, s2, 1.0),
               case.field(rng, s2, 100.0), case.field(rng, s2, 1e-4),
               case.field(rng, s2, 1e-5), case.field(rng, s2, 0.1),
               case.field(rng, s2, 0.1)]
    salt = 35.0 + case.field(rng, s3, 0.5)
    area = case.field(rng, s2, 0.5).abs().clamp(max=1.0)
    every = dataclasses.replace(
        case.cfg, tauThetaClimRelax=86400.0 * 30,
        tauSaltClimRelax=86400.0 * 60, temp_EvPrRn=0.5, salt_EvPrRn=0.0,
        useKPP=True)
    for label, cfg, AREA in (("", case.cfg, None),
                             ("(every term, under ice)", every, area)):
        args = (case.theta, salt, AREA, *forcing)
        hold_launch("surface_forcing" + label, case, lambda impl, cfg=cfg,
                    args=args: [t for t in (
                        th._surface_forcing_plain if impl else
                        th._surface_forcing_kernel)(cfg, g, *args)
                        if t is not None], results, 0 if label else reps)


def seaice_last_glue(case, results, reps):
    """S1 and S2 on the evp-ice-gyre's grid (EvpCase): the set-up with the
    ice-gyre's flags and with EVP's masks; the LSR's ocean stress, the
    no-dynamics drag, and HB87 with EVP's clip."""
    from mitgcm_tpu_torch.model.seaice import DYNFORCING_OUT

    si, ice = case.si["aEVP"], case.ice
    rng = np.random.default_rng(SEED + 33)
    s2 = tuple(case.grid.rA.shape)
    fu, fv = case.field(rng, s2, 0.1), case.field(rng, s2, 0.1)
    eta = case.field(rng, s2, 0.3)
    for label, evp in (("", False), ("(EVP)", True)):
        hold_launch("seaice_dynforcing" + label, case, lambda impl, evp=evp: [
            d[k] for d in [si.dynforcing(ice, fu, fv, eta, evp, impl=impl)]
            for k in DYNFORCING_OUT[:11 + 2 * evp]], results,
            0 if label else reps)
    dwatn = case.field(rng, s2, 2.0).abs() * si.HEFFM
    uv0 = case.dyn["uVel0"], case.dyn["vVel0"]
    extra = dict(windTau=(case.field(rng, s2, 0.1), case.field(rng, s2, 0.1)),
                 stressDiv=(case.field(rng, s2, 0.05),
                            case.field(rng, s2, 0.05)))
    for label, mode, drag, clip in (("", 1, False, False),
                                    ("(no dynamics)", 1, True, False),
                                    ("(HB87, clip)", 2, False, True)):
        hold_launch("seaice_ocean_stress" + label, case, lambda impl, m=mode,
                    d=drag, c=clip: [t for t in si.ocean_stress(
                        ice, None if d else dwatn, *uv0, fu, fv, mode=m,
                        drag=d, clip=c, impl=impl, **extra)
                        if t is not None], results, 0 if label else reps)


def addend_last_glue(case, results, reps):
    """The `+ gTr` addend of the last sweep (kernels M, O and P, scheme 33,
    7 and 51) and of H-SOM's som_r (scheme 81) on the os7mp-gyre's grid
    (G9Case, halos of 4): the advection's gTracer + gTr against the twin's
    sum, bit for bit; unless reps is 0, the R launch's device time (20 in
    a CUDA graph, the sweeps' fields kept alive) with the addend and,
    beside it, without (the same inputs, the same call), the whole
    advection's wrapper time, the bound from what the R launch reads and
    writes."""
    from mitgcm_tpu_torch.model import gad, som

    cfg, g = case.cfg, case.grid
    rng = np.random.default_rng(SEED + 34)
    s3 = tuple(g.hFacC.shape)
    dt = cfg.deltaTTracer
    gTr = case.field(rng, s3, 1e-5)
    vol = g.rA * g.drF[:, None, None] * g.hFacC
    sm = case.field(rng, (9,) + s3, 2.0) * (case.tracer * vol)[None]
    uvw = (case.u, case.v, case.w)
    for scheme in (33, 7, 51, 81):
        if scheme == 81:
            name = "som_r"
            sweeps, bare = (som.som_sweeps(cfg, g, *uvw, case.tracer, sm,
                                           scheme, dt, add=add)
                            for add in (gTr, None))
            outs = list(sweeps[-1][2])

            def call(impl=None):
                return list(som.som_advect(cfg, g, *uvw, case.tracer, sm,
                                           scheme, dt, impl=impl, add=gTr))
        else:
            name = gad.sweep_name(scheme, "r")
            sweeps, bare = (gad.multidim_sweeps(cfg, g, case.flow, *uvw,
                                                case.tracer, scheme, scheme,
                                                dt, add=add)
                            for add in (gTr, None))
            outs = [sweeps[-1][3]]

            def call(impl=None, s=scheme):
                return [gad.multidim_advection(cfg, g, case.flow, *uvw,
                                               case.tracer, s, s, dt,
                                               impl=impl, add=gTr)]
        for sweep in sweeps + bare:
            sweep[1]()
        label = f"{name}(+gTr)"
        timed = reps > 0
        exact_compare(label, case, outs, call("plain"),
                      cuda_time_ms(call, reps) if timed else None,
                      cuda_time_ms(lambda: call("plain"), 2) if timed
                      else None, results, call=call)
        if not timed:
            del sweeps, bare, outs
            continue
        r = results[label]
        r["extra"] = {"wrapper_ms": r["ms"],
                      "without_addend_ms": graph_ms(bare[-1][1], reps)}
        r["ms"] = graph_ms(sweeps[-1][1], reps)
        print(f"{'':18s} device time (20 launches in a CUDA graph) "
              f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.2f} of the "
              f"bound, without the addend "
              f"{r['extra']['without_addend_ms']:.4f} ms; the whole "
              f"advection's wrapper call {r['extra']['wrapper_ms']:.4f} ms",
              flush=True)
        del sweeps, bare, outs


def last_glue_phase(results):
    phase("18 the last glue: N1, N2, Q, S1, S2 and the + gTr addend")
    # every variant held bit for bit; the JSON line's rows timed at full
    # size only (the variants' times stand in PERF.md); the addend of the
    # last sweep held here at 64x64 float64 and, at full size, by phase 10
    # on its own case (a set-up of its own took the most of this phase)
    for n, dtype, reps in ((64, torch.float64, 0),
                           (1024, torch.float32, 10)):
        t0 = time.perf_counter()
        nr = 12 if n == 64 else 50
        nh_last_glue(GlueCase(n, nr, dtype, nh=True), results, reps)
        GRIDS.clear()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        nr = 12 if n == 64 else 32
        forcing_last_glue(GlueCase(n, nr, dtype), results, reps)
        seaice_last_glue(EvpCase(n, nr, dtype), results, reps)
        GRIDS.clear()
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        if n == 64:
            addend_last_glue(G9Case(n, nr, dtype, "os7mp"), results, reps)
        print(f"last glue at {n}x{n}: N1 and N2 {t1 - t0:.1f} s, Q, S1 and "
              f"S2 {t2 - t1:.1f} s, the addend {time.perf_counter() - t2:.1f}"
              f" s", flush=True)


# Phase 19: the variable and biharmonic viscosity. The three
# configurations (synthetic.visc_gyre_config, visc_vi_gyre_config,
# st_vi_gyre_config) by their short names
VISC_CONFIGS = {"visc": "visc_gyre_config", "visc-vi": "visc_vi_gyre_config",
                "st-vi": "st_vi_gyre_config"}
# launches in each configuration's 5 timed full-size steps: X each step,
# Y with biharmonic viscosity, B's or V's dissipation variant in place of
# B's or V's first variants
VISC_LAUNCHES = {
    "visc": {**GYRE_LAUNCHES, "mom_fluxform": 0, "mom_fluxform_visc": 5,
             "mom_calc_visc": 5, "mom_del2uv": 5, "mom_vecinv_visc": 0},
    "visc-vi": {**VI_LAUNCHES, "mom_vecinv": 0, "mom_vecinv_visc": 5,
                "mom_calc_visc": 5, "mom_del2uv": 5,
                "mom_fluxform_visc": 0},
    "st-vi": {**VI_LAUNCHES, "mom_vecinv": 0, "mom_vecinv_visc": 5,
              "mom_calc_visc": 5, "mom_del2uv": 0, "mom_fluxform_visc": 0}}
# further variants of B's and V's dissipation variants held at 64x64x4
# float64 (settings over the visc-gyre's or the visc-vi-gyre's)
_VISC_OFF = dict(viscC2smag=0.0, viscC2leith=0.0, viscC2leithD=0.0,
                 viscC4leith=0.0, viscC4leithD=0.0, viscAhGridMax=1.0e21,
                 viscA4GridMax=1.0e21, viscAhReMax=0.0, viscA4ReMax=0.0)
VISC_VARIANTS = {
    "visc": {"free slip, 3-D Coriolis": dict(no_slip_sides=False,
                                             select3dCoriScheme=1),
             "variable, no biharmonic": dict(viscC4leith=0.0,
                                             viscC4leithD=0.0),
             "constant biharmonic, linear drag": {
                 **_VISC_OFF, "viscA4": 1e9, "viscA4D": 2e9,
                 "viscA4Z": 5e8, "bottomDragLinear": 2e-4},
             "no drag": {**_VISC_OFF, "no_slip_bottom": False,
                         "selectBotDragQuadr": -1}},
    "visc-vi": {"leith, quadratic drag, vort 0": dict(
        useFullLeith=False, bottomDragQuadratic=2.5e-3, selectVortScheme=0),
        "variable, no biharmonic, explicit, Coriolis 1": dict(
            viscC4leith=0.0, viscC4leithD=0.0, implicitViscosity=False,
            selectCoriScheme=1),
        "constant biharmonic": {**_VISC_OFF, "viscA4": 1e9, "viscA4D": 1e9,
                                "viscA4Z": 1e9}},
    "st-vi": {"constant, linear and quadratic drag": {
        **_VISC_OFF, "viscAhD": 300.0, "viscAhZ": 500.0,
        "bottomDragLinear": 2e-4, "bottomDragQuadratic": 2.5e-3}}}


class ViscCase:
    """Seeded velocities on one of VISC_CONFIGS' grids, their amplitude
    spread over three decades so that each viscosity limit binds
    somewhere."""

    def __init__(self, n, nr, dtype, kind):
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype, self.kind = dtype, kind
        self.cfg = getattr(synthetic, VISC_CONFIGS[kind])(
            nx=n, ny=n, nr=nr, deltaT=600.0)
        self.grid = (shared_grid(self.cfg, dtype)
                     or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                            device="cuda"))
        g = self.grid
        rng = np.random.default_rng(SEED + 41)
        shape = tuple(g.hFacC.shape)
        amp = torch.as_tensor(10.0 ** rng.uniform(-3.0, 0.0, shape),
                              dtype=dtype, device="cuda")
        self.u = self.field(rng, shape, 1.0) * amp * g.maskW
        self.v = self.field(rng, shape, 1.0) * amp * g.maskS
        self.w = self.field(rng, shape, 1e-4) * g.maskC
        kshape = (nr + 1,) + shape[1:]
        self.kappaRU = self.field(rng, kshape, 1e-3).abs()
        self.kappaRV = self.field(rng, kshape, 1e-3).abs()

    field = Case.field
    label = Case.label


def hold_interior(name, case, fn, results, reps, timed=True):
    """As hold_launch, for a tile kernel that writes zero halo cells
    (B's and V's variants): every halo output 0, the interior bit for bit
    against the twin's; the launch's device time (20 in a CUDA graph)
    beside a wrapper call's when timed."""
    from mitgcm_tpu_torch import kernels

    ol = case.cfg.olx
    outs, wants = fn(None), fn("plain")
    for t in outs:
        halo = t.clone()
        halo[:, ol:-ol, ol:-ol] = 0.0
        if float(halo.abs().max()) != 0.0:
            raise AssertionError(f"{name}: a halo output is not 0")
    exact_compare(name, case, [t[:, ol:-ol, ol:-ol] for t in outs],
                  [t[:, ol:-ol, ol:-ol] for t in wants],
                  cuda_time_ms(lambda: fn(None), reps) if timed else None,
                  cuda_time_ms(lambda: fn("plain"), reps) if timed
                  else None, results, call=lambda: fn(None))
    if not timed:
        return
    r = results[name]
    args, keep = captured_launch(lambda: fn(None), name.split("(")[0])
    r["extra"] = {"wrapper_ms": r["ms"]}
    r["ms"] = graph_ms(lambda: kernels.launch(*args), reps)
    del keep
    print(f"{'':18s} device time (20 launches in a CUDA graph) "
          f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.2f} of the bound; "
          f"a wrapper call {r['extra']['wrapper_ms']:.4f} ms", flush=True)


def visc_kernel_phase(case, results, reps, variants):
    """X and Y (whole arrays) and the configuration's dissipation variant
    of B or V (the interior, halo outputs 0) against their twins, bit for
    bit, the variant fed X's and Y's twins' fields; with `variants`, each
    of VISC_VARIANTS' too (not timed). The rows of the JSON line are the
    visc-gyre's X, Y and B, the visc-vi-gyre's V."""
    import dataclasses

    from mitgcm_tpu_torch.model import mom_fluxform, mom_vecinv, mom_visc

    g, kind = case.grid, case.kind
    vi = kind != "visc"
    tag = {"visc": "", "visc-vi": "(full Leith)",
           "st-vi": "(Smagorinsky)"}[kind]
    fn = mom_vecinv.mom_vecinv_visc if vi else mom_fluxform.mom_fluxform_visc
    name = "mom_vecinv_visc" if vi else "mom_fluxform_visc"
    name += "(strain-tension)" if kind == "st-vi" else ""
    todo = {"": {}, **(VISC_VARIANTS[kind] if variants else {})}
    for label, settings in todo.items():
        cfg = dataclasses.replace(case.cfg, **settings)
        main = not label
        ins = (case.u, case.v, case.w, case.kappaRU, case.kappaRV)
        def x_outs(impl, c=cfg):
            return [t for t in mom_visc.calc_visc(c, g, case.u, case.v,
                                                  impl=impl)
                    if t is not None]

        if mom_visc.use_variable_visc(cfg) and main:
            hold_launch("mom_calc_visc" + tag, case, x_outs, results, reps)
        elif mom_visc.use_variable_visc(cfg):
            exact_compare(f"mom_calc_visc({label})", case, x_outs(None),
                          x_outs("plain"), None, None, results,
                          call=lambda: x_outs(None))
        if mom_visc.use_biharmonic_visc(cfg) and main:
            y_name = "mom_del2uv" + ("(vector invariant)" if vi else "")
            hold_launch(y_name, case, lambda impl, c=cfg: list(
                mom_visc.del2uv(c, g, case.u, case.v, impl=impl)),
                results, reps)
        visc, del2 = mom_visc.fields(cfg, g, case.u, case.v, impl="plain")
        hold_interior(name if main else f"{name.split('(')[0]}({label})",
                      case, lambda impl, c=cfg, vs=visc, d2=del2: list(fn(
                          c, g, *ins, vs, d2, impl=impl)), results, reps,
                      timed=main)


def visc_experiment(kind, n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = getattr(synthetic, VISC_CONFIGS[kind])(nx=n, ny=n, nr=nr, **kw)
    return Experiment(cfg, *synthetic.gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype)),
        impl=impl)


def visc_parity_phase(kind, steps=5):
    """`steps` float64 steps of the 64x64x4 configuration, kernel path
    against plain path: equal cg2d iterations, PARITY_DIGITS or more on
    every statistic."""
    from mitgcm_tpu_torch.utils.compare import record_digits

    runs = {impl: visc_experiment(kind, 64, 4, torch.float64, impl).run(
        n_steps=steps) for impl in (None, "plain")}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        worst = min(worst, min(dig.values()))
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError(f"{kind}-gyre cg2d iteration counts differ")
    print(f"{kind}-gyre parity, 64x64x4 float64, {steps} steps kernel "
          f"against plain: fewest matching digits {worst:.2f}, equal cg2d "
          f"iterations", flush=True)
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"{kind}-gyre parity {worst:.2f} < "
                             f"{PARITY_DIGITS} digits")


def visc_full_phase(kind, kernels, smi):
    """The 1024x1024x32 float32 configuration (deltaT = 600): a warm-up
    step, then 5 timed steps with every launch count (VISC_LAUNCHES) and
    no twin of X, Y or the glue."""
    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = visc_experiment(kind, n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    points = n * n * nr

    def run(state, it0, steps):
        exp.state, exp.cur_iter = state, it0
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, sec_w = run(exp.state, 0, 1)
    kernels.launches.clear()
    plain0 = glue_plain_calls()
    state, iters, sec = run(state1, 1, 5)
    launches = dict(kernels.launches)
    plain = glue_plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"{kind}-gyre kernel path ({smi}): 5 steps, "
          f"{sec * 1e3 / 5:.2f} ms/step, {points * 5 / sec:.4e} "
          f"points*steps/s, cg2d iterations {iters}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{kind}-gyre {name} is not finite")
    check_launches(f"{kind}-gyre", launches, VISC_LAUNCHES[kind], plain)
    return launches


def visc_phase(kernels, results, smi):
    phase("19 variable viscosity: the visc-gyre, visc-vi-gyre and "
          "st-vi-gyre")
    for n, nr, dtype, reps in ((64, 4, torch.float64, 20),
                               (1024, 32, torch.float32, 10)):
        for kind in VISC_CONFIGS:
            visc_kernel_phase(ViscCase(n, nr, dtype, kind), results, reps,
                              variants=n == 64)
        torch.cuda.empty_cache()
    print(smi)
    for kind in VISC_CONFIGS:
        visc_parity_phase(kind)
    launches = {}
    for kind in VISC_CONFIGS:
        got = visc_full_phase(kind, kernels, smi)
        if kind == "visc":
            launches.update({k: got[k] for k in (
                "mom_calc_visc", "mom_del2uv", "mom_fluxform_visc")})
        elif kind == "visc-vi":
            launches["mom_vecinv_visc"] = got["mom_vecinv_visc"]
    GRIDS.clear()
    torch.cuda.empty_cache()
    return launches


# The Richardson-number mixing and the plume convection (phase 20): the
# pp81-, my82- and opps-gyre, the kpp-gyre's set-up with PP81, MY82 or
# OPPS in place of KPP
RIMIX_CONFIGS = {"pp81": "pp81_gyre_config", "my82": "my82_gyre_config",
                 "opps": "opps_gyre_config"}
RIMIX_KERNELS = ("vertmix_calc", "opps_col")
# launches in each configuration's 5 timed full-size steps: the kpp-gyre's
# without K; U, J-uv and J-ts once a step on the pp81- and my82-gyre; Z
# once a step on the opps-gyre, whose background diffusivity and viscosity
# are constant fills (no J)
_RIMIX_BASE = {**{k: n for k, n in KPP_LAUNCHES.items()
                  if k not in KPP_KERNELS}, **{k: 0 for k in KPP_KERNELS}}
RIMIX_LAUNCHES = {
    "pp81": {**_RIMIX_BASE, "vertmix_calc": 5, "opps_col": 0},
    "my82": {**_RIMIX_BASE, "vertmix_calc": 5, "opps_col": 0},
    "opps": {**_RIMIX_BASE, **glue_launches(2, 12), "vertmix_calc": 0,
             "opps_col": 5}}
# (eosType, selectP_inEOS_Zc) of the variants held at 64x64x4 float64: the
# paths' JMD95Z on the static profile first
RIMIX_EOS = (("JMD95Z", 0), ("JMD95Z", 2), ("MDJWF", 2), ("LINEAR", 0))
Z_VARIANTS = {"": {}, "useGCMwVel": {"useGCMwVel": True},
              "two adjustments": {"MAX_ABE_ITERATIONS": 2}}
# Z's operations a live iteration (model/opps.py:_opps_plain's stats): an
# equation of state by kind (JMD95Z's rho_p0 and bulkmod polynomials ~60,
# its square root, a division and the pressure ~12; MDJWF's numerator and
# denominator ~45, a square root, a division; LINEAR ~7) and STATE1's
# pressure (3); a launch (one STATE1, the flux and square ~8), a descent
# step (three STATE1, the flux, entrainment, two mixed tracers, the plume's
# velocity and radius with two square roots and eight divisions, the time
# step and the mass flux ~60), a level of an adjustment sub-step (the two
# tracers' fluxes and updates, ~10)
Z_EOS_OPS = {"JMD95Z": 72, "MDJWF": 55, "LINEAR": 7}


def opps_ops(kind, stats):
    """Z's operations on inputs whose live iterations are `stats`."""
    eos = Z_EOS_OPS[kind] + 3
    return (stats["launch"] * (eos + 8) + stats["descent"] * (3 * eos + 60)
            + stats["adjust"] * 10)


class RimixCase:
    """The kpp-gyre's grid (the pp81-gyre's configuration) and seeded
    fields on the card: velocities over three decades, theta the tRef
    profile with noise that makes some of the interfaces statically
    unstable (at 32 levels), turned upside down (cold over warm: every
    level unstable) in the northern eighth of the rows, salt, w and a
    totPhiHyd. depth: the basin's (OPPS's plumes entrain too much to
    descend through the 1000 m layers of 4 levels over 5000 m)."""

    def __init__(self, n, nr, dtype, depth=5000.0):
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.pp81_gyre_config(nx=n, ny=n, nr=nr,
                                              depth=depth, deltaT=600.0)
        self.grid = (shared_grid(self.cfg, dtype)
                     or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                            device="cuda"))
        g = self.grid
        rng = np.random.default_rng(SEED + 43)
        shape = tuple(g.hFacC.shape)
        amp = torch.as_tensor(10.0 ** rng.uniform(-3.0, 0.0, shape),
                              dtype=dtype, device="cuda")
        self.u = self.field(rng, shape, 0.1) * amp * g.maskW
        self.v = self.field(rng, shape, 0.1) * amp * g.maskS
        tref = torch.as_tensor(self.cfg.tRef, dtype=dtype, device="cuda")
        profile = tref[:, None, None].expand(shape).clone()
        profile[:, -shape[1] // 8:] = tref.flip(0)[:, None, None]
        self.theta = (profile + self.field(rng, shape, 0.3)) * g.maskC
        self.salt = (35.0 + self.field(rng, shape, 0.05)) * g.maskC
        self.w = self.field(rng, shape, 1e-2) * g.maskC
        self.phi = self.field(rng, shape, 10.0)

    field = Case.field
    label = Case.label

    def config(self, name, kind, select_p, **settings):
        return dataclasses.replace(
            self.cfg, eosType=kind, selectP_inEOS_Zc=select_p,
            usePP81=name == "pp81", useMY82=name == "my82",
            useOPPS=name == "opps", **settings)


def hold_opps(name, case, op, results, reps, plain_reps, kind):
    """Z against its twin on whole arrays, bit for bit (exact_compare),
    timed as hold_launch times a kernel (plain_reps of the twin); its bound
    the larger of its bytes and its operations on these inputs (the
    twin's live iterations, opps_ops)."""
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model import opps

    ins = (case.theta, case.salt, case.w, case.phi)
    stats = {}
    outs = op.apply(*ins)
    wants = opps._opps_plain(op, case.theta, case.salt,
                             *op.inputs(case.w, case.phi), stats)
    timed = plain_reps > 0
    exact_compare(name, case, outs, wants,
                  cuda_time_ms(lambda: op.apply(*ins), reps)
                  if timed else None,
                  cuda_time_ms(lambda: op.apply(*ins, impl="plain"),
                               plain_reps) if timed else None, results,
                  call=lambda: op.apply(*ins))
    r = results[name]
    t_ops = opps_ops(kind, stats) / PEAK_F32_OPS_S * 1e3
    print(f"{'':18s} live iterations {stats}: {opps_ops(kind, stats):.4e} "
          f"operations, {t_ops:.4f} ms at the peak; launches in "
          f"{int(outs[2].sum())} of {int((case.grid.maskC[1:] > 0).sum())} "
          f"wet levels below the top", flush=True)
    if t_ops > r["bound_ms"]:
        r["bound_ms"], r["bound_by"] = t_ops, "operations"
    if not timed:
        return
    args, keep = captured_launch(lambda: op.apply(*ins), "opps_col")
    r["extra"] = {"wrapper_ms": r["ms"]}
    r["ms"] = graph_ms(lambda: kernels.launch(*args), reps)
    del keep
    print(f"{'':18s} device time (20 launches in a CUDA graph) "
          f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.2f} of the bound "
          f"({r['bound_by']}); a wrapper call "
          f"{r['extra']['wrapper_ms']:.4f} ms", flush=True)


def rimix_kernel_phase(case, results, reps, plain_reps, variants):
    """U (both schemes), Z and J-uv's and J-ts's vertmix variants against
    their twins, bit for bit on every padded cell; with `variants`, every
    EOS kind of RIMIX_EOS and each of Z_VARIANTS (the first of each
    timed), else the paths' own (JMD95Z on the static profile). The rows
    of the JSON line are the pp81-gyre's U and the opps-gyre's Z."""
    from mitgcm_tpu_torch.model import opps, step, thermodynamics as th
    from mitgcm_tpu_torch.model import vertmix

    g = case.grid
    ins = (case.u, case.v, case.theta, case.salt, case.phi)
    for kind, select_p in (RIMIX_EOS if variants else RIMIX_EOS[:1]):
        main = (kind, select_p) == RIMIX_EOS[0]
        tag = "" if main else f", {kind}{', totPhiHyd' if select_p else ''}"
        for name in ("pp81", "my82"):
            cfg = case.config(name, kind, select_p)
            vm = getattr(vertmix, name.upper())(cfg, g, {})
            label = "" if name == "pp81" and main else f"({name}{tag})"
            if main:
                hold_launch("vertmix_calc" + label, case,
                            lambda impl, vm=vm: list(vm.calc(*ins,
                                                             impl=impl)),
                            results, reps)
            else:
                exact_compare("vertmix_calc" + label, case,
                              list(vm.calc(*ins)),
                              list(vm.calc(*ins, impl="plain")), None, None,
                              results, call=lambda vm=vm: vm.calc(*ins))
            if not main:
                continue
            visc, diff = vm.calc(*ins, impl="plain")
            fields = {"viscAr": visc, "diffKr": diff}
            hold_launch(f"kappa_uv({name})", case, lambda impl, c=cfg, f=(
                fields): list(step.kappa_uv(c, g, impl=impl,
                                            vmix_fields=f)), results, reps)
            hold_launch(f"kappa_ts({name})", case, lambda impl, c=cfg, f=(
                fields): [t for t in th.kappa_ts(
                    c, g, None, None, None, None, impl=impl,
                    vmix_fields=f) if t is not None], results, reps)
        for label, settings in Z_VARIANTS.items():
            if label and not variants:
                continue
            cfg = case.config("opps", kind, select_p)
            op = opps.OPPS(cfg, g, settings)
            zlabel = ", ".join(x for x in (label, tag[2:]) if x)
            hold_opps("opps_col" + (f"({zlabel})" if zlabel else ""), case,
                      op, results, reps,
                      plain_reps if main and not label else 0, kind)


def rimix_experiment(kind, n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = getattr(synthetic, RIMIX_CONFIGS[kind])(nx=n, ny=n, nr=nr, **kw)
    setup = (synthetic.opps_gyre_setup if kind == "opps"
             else synthetic.vertmix_gyre_setup)
    grid, state, forcing, op, obj = setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, impl=impl,
                      **({"opps": obj} if kind == "opps" else
                         {"vmix": obj}))


def rimix_parity_phase(kind, steps=5):
    """`steps` float64 steps of the 64x64x12 configuration 300 m deep (the
    CPU tests' levels), kernel path against plain path: equal cg2d
    iterations, PARITY_DIGITS or more on every statistic; on the
    opps-gyre, Z's launches on the end state."""
    from mitgcm_tpu_torch.utils.compare import record_digits

    exps = {impl: rimix_experiment(kind, 64, 12, torch.float64, impl,
                                   depth=300.0) for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=steps) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        worst = min(worst, min(dig.values()))
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError(f"{kind}-gyre cg2d iteration counts differ")
    print(f"{kind}-gyre parity, 64x64x12 float64, {steps} steps kernel "
          f"against plain: fewest matching digits {worst:.2f}, equal cg2d "
          f"iterations {[r['cg2d_iters'] for r in runs[None][1:]]}",
          flush=True)
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"{kind}-gyre parity {worst:.2f} < "
                             f"{PARITY_DIGITS} digits")
    if kind == "opps":
        st = exps[None].state
        count = exps[None].opps.apply(st.theta, st.salt, st.wVel,
                                      st.totPhiHyd)[2]
        print(f"opps-gyre at 64x64x12 after {steps} steps: {int(count.sum())}"
              f" plume launches", flush=True)


def rimix_plain_calls():
    """Calls so far of U's and Z's twins and of the glue's."""
    from mitgcm_tpu_torch.model import opps, vertmix

    return vertmix.plain_calls + opps.plain_calls + glue_plain_calls()


def rimix_full_phase(kind, kernels, smi):
    """The 1024x1024x32 float32 configuration (deltaT = 600): a warm-up
    step, then 5 timed steps with every launch count (RIMIX_LAUNCHES), no
    twin of U, Z or the glue, finite fields; on the opps-gyre, Z on the
    end state counts its launches in the cooled north and the heated
    south."""
    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = rimix_experiment(kind, n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    points = n * n * nr

    def run(state, it0, steps):
        exp.state, exp.cur_iter = state, it0
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, sec_w = run(exp.state, 0, 1)
    kernels.launches.clear()
    plain0 = rimix_plain_calls()
    state, iters, sec = run(state1, 1, 5)
    launches = dict(kernels.launches)
    plain = rimix_plain_calls() - plain0
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"{kind}-gyre kernel path ({smi}): 5 steps, "
          f"{sec * 1e3 / 5:.2f} ms/step, {points * 5 / sec:.4e} "
          f"points*steps/s, cg2d iterations {iters}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN"):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{kind}-gyre {name} is not finite")
    check_launches(f"{kind}-gyre", launches, RIMIX_LAUNCHES[kind], plain)
    if kind == "opps":
        _, _, cnt = exp.opps.apply(state.theta, state.salt, state.wVel,
                                   state.totPhiHyd)
        ol, ny = exp.cfg.oly, exp.cfg.ny
        north = int(cnt[:, ol + ny // 2:ol + ny].sum())
        south = int(cnt[:, ol:ol + ny // 2].sum())
        print(f"opps-gyre after 6 steps: plume launches {north} in the "
              f"cooled north, {south} in the heated south", flush=True)
        if not north > 0:
            raise AssertionError("OPPS launched no plume in the north")
    return launches


def rimix_phase(kernels, results, smi):
    phase("20 Richardson-number mixing and OPPS: the pp81-, my82- and "
          "opps-gyre")
    for n, nr, depth, dtype, reps, plain_reps in (
            (64, 4, 300.0, torch.float64, 20, 3),
            (1024, 32, 5000.0, torch.float32, 10, 2)):
        rimix_kernel_phase(RimixCase(n, nr, dtype, depth), results, reps,
                           plain_reps, variants=n == 64)
        torch.cuda.empty_cache()
    print(smi)
    for kind in RIMIX_CONFIGS:
        rimix_parity_phase(kind)
    launches = {}
    for kind in RIMIX_CONFIGS:
        got = rimix_full_phase(kind, kernels, smi)
        if kind == "pp81":
            launches["vertmix_calc"] = got["vertmix_calc"]
        elif kind == "opps":
            launches["opps_col"] = got["opps_col"]
    GRIDS.clear()
    torch.cuda.empty_cache()
    return launches


# The CD scheme and the Shapiro filter (phase 21): the cd-gyre and the
# cd-vi-gyre (the gyre and the vi-gyre under the CD scheme's Coriolis) and
# the shap-gyre (the gyre with the Shapiro filter)
CD_SHAP_CONFIGS = {"cd": "cd_gyre_config", "cd-vi": "cd_vi_gyre_config",
                   "shap": "shap_gyre_config"}
CD_SHAP_KERNELS = ("cd_scheme", "shap_uv", "shap_ts")
# the rows of the JSON line that phase 21's paths launch (the gyre's, phase
# 5, launches none of them)
CD_SHAP_ROWS = CD_SHAP_KERNELS + ("mom_ab_step(CD)", "mom_fluxform(CD)",
                                  "mom_vecinv(CD)")
_NO_CD_SHAP = {k: 0 for k in CD_SHAP_KERNELS}
# launches in each configuration's 5 timed full-size steps: CD once a
# step and the D-grid pair's two fills (under implicit viscosity T on the
# pair too), or SH-uv's 4 passes, SH-ts's 4 on each tracer and the
# tracers' two fills before them
CD_SHAP_LAUNCHES = {
    "cd": {**GYRE_LAUNCHES, **glue_launches(1, 14), **_NO_CD_SHAP,
           "cd_scheme": 5},
    "cd-vi": {**VI_LAUNCHES, **glue_launches(2, 14), **_NO_CD_SHAP,
              "cd_scheme": 5, "impldiff": 30},
    "shap": {**GYRE_LAUNCHES, **glue_launches(1, 14), **_NO_CD_SHAP,
             "shap_uv": 20, "shap_ts": 40}}
# SH-uv's and SH-ts's further branches held at 64x64x4 (ShapParams
# settings over the shap-gyre's index-space filter)
SH_UV_VARIANTS = {"physical, length < 0": {"nShapUVPhys": 4,
                                           "Shap_uvLength": -1.0},
                  "physical, length 0": {"nShapUVPhys": 4},
                  "physical, length > 0": {"nShapUVPhys": 4,
                                           "Shap_uvLength": 3.0e4}}
SH_TS_VARIANTS = {"physical": {"nShapTrPhys": 4},
                  "physical, length": {"nShapTrPhys": 4,
                                       "Shap_TrLength": 3.0e4},
                  "mixed": {"nShapTrPhys": 2}}


class CdShapCase:
    """The gyre's grid (the cd-gyre's configuration) and seeded fields on
    the card: velocities, the last step's, the D-grid pair, the
    AB-extrapolated tendencies, w and the kappas, the free surface now and
    before the last solve, filled theta and salt, and kernel G's
    inputs."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.model.mom_fluxform import MomTend
        from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.cd_gyre_config(nx=n, ny=n, nr=nr, deltaT=600.0)
        self.grid = (shared_grid(self.cfg, dtype)
                     or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                            device="cuda"))
        g = self.grid
        rng = np.random.default_rng(SEED + 47)
        s3, s2 = tuple(g.hFacC.shape), tuple(g.hFacC.shape[1:])
        self.u = self.field(rng, s3, 0.1) * g.maskW
        self.v = self.field(rng, s3, 0.1) * g.maskS
        self.uNM1 = self.field(rng, s3, 0.1) * g.maskW
        self.vNM1 = self.field(rng, s3, 0.1) * g.maskS
        self.uVelD = self.field(rng, s3, 0.1) * g.maskS
        self.vVelD = self.field(rng, s3, 0.1) * g.maskW
        self.gU = self.field(rng, s3, 1e-5) * g.maskW
        self.gV = self.field(rng, s3, 1e-5) * g.maskS
        self.w = self.field(rng, s3, 1e-4) * g.maskC
        kshape = (nr + 1,) + s2
        self.kappaRU = self.field(rng, kshape, 1e-3).abs()
        self.kappaRV = self.field(rng, kshape, 1e-3).abs()
        self.eta = self.field(rng, s2, 0.2)
        self.etaNm1 = self.field(rng, s2, 0.2)
        tref = torch.as_tensor(self.cfg.tRef, dtype=dtype, device="cuda")
        ol = self.cfg.olx
        self.theta = cyclic_fill_halo(
            (tref[:, None, None] + self.field(rng, s3, 1.0)) * g.maskC, ol,
            ol)
        self.salt = cyclic_fill_halo(
            (35.0 + self.field(rng, s3, 0.1)) * g.maskC, ol, ol)
        t = {k: self.field(rng, s3, 1e-5) for k in (
            "gU", "gV", "guDiss", "gvDiss", "dPhiX", "dPhiY", "guNm1",
            "gvNm1", "guNm2", "gvNm2")}
        self.tend = MomTend(t["gU"], t["gV"], t["guDiss"], t["gvDiss"])
        self.dPhi = (t["dPhiX"], t["dPhiY"])
        self.ext = (self.field(rng, s2, 1e-5), self.field(rng, s2, 1e-5))
        self.state = types.SimpleNamespace(
            uVel=self.u, vVel=self.v, gwNm1=None, gwNm2=None,
            **{k: t[k] for k in ("guNm1", "gvNm1", "guNm2", "gvNm2")})

    field = Case.field
    label = Case.label

    def config(self, kind, **shap):
        from mitgcm_tpu_torch.utils import synthetic

        c = self.cfg
        extra = {"shap": shap} if kind == "shap" else {}
        return getattr(synthetic, CD_SHAP_CONFIGS[kind])(
            nx=c.nx, ny=c.ny, nr=c.nr, deltaT=600.0, **extra)


def hold_filter(name, case, fn, ins, results, reps):
    """A Shapiro filter's wrapper call fn(None), all its passes, against
    its twin's fn("plain") on whole arrays, bit for bit (exact_compare);
    the time (reps > 0) the call's device time, 5 calls captured in a CUDA
    graph (graph_ms), its CUDA-event time beside it; the bound the
    function's: `ins` read once and the outputs written once."""
    outs, wants = fn(None), fn("plain")
    timed = reps > 0
    exact_compare(name, case, outs, wants,
                  graph_ms(lambda: fn(None), reps, calls=5)
                  if timed else None,
                  cuda_time_ms(lambda: fn("plain"), reps) if timed else None,
                  results, touched=[*ins, *outs])
    if not timed:
        return
    r = results[name]
    r["extra"] = {"wrapper_ms": cuda_time_ms(lambda: fn(None), reps)}
    print(f"{'':18s} device time of the whole filter (5 calls in a CUDA "
          f"graph) {r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.2f} of the "
          f"bound; a wrapper call {r['extra']['wrapper_ms']:.4f} ms",
          flush=True)


def cd_shap_kernel_phase(case, results, reps, variants):
    """CD (iterations 5 and 0), G's CD variant (AB-2, and AB-3 with
    variants), B's and V's CD variants (the interior, halo outputs 0), and
    SH-uv and SH-ts on the shap-gyre's filter (with variants, each other
    branch) against their twins, bit for bit; timed unless reps is 0."""
    from mitgcm_tpu_torch.model import cd_code, mom_fluxform, mom_vecinv
    from mitgcm_tpu_torch.model import shap_filt, step

    g, timed = case.grid, reps > 0
    cd_cfg, vi_cfg = case.cfg, case.config("cd-vi")
    cd = cd_code.CDState(case.uVelD, case.vVelD, case.uNM1, case.vNM1,
                         case.etaNm1)

    def cd_fn(it):
        return lambda impl: list(cd_code.cd_scheme(
            cd_cfg, g, it, case.gU, case.gV, case.u, case.v, case.eta, cd,
            impl=impl))

    def hold(name, fn, main=True):
        if main and timed:
            hold_launch(name, case, fn, results, reps)
        else:
            exact_compare(name, case, fn(None), fn("plain"), None, None,
                          results, call=lambda: fn(None))

    hold("cd_scheme", cd_fn(5))
    hold("cd_scheme(iteration 0)", cd_fn(0), main=False)
    for name, cfg, it, main in (("mom_ab_step(CD)", cd_cfg, 1, True),
                                ("mom_ab_step(CD, AB-3)", vi_cfg, 2, False)):
        if main or variants:
            hold(name, lambda impl, c=cfg, it=it: list(step.mom_ab_step(
                c, g, case.state, case.tend, *case.dPhi, *case.ext, it,
                impl=impl)[:4]), main)
    mom_ins = (case.u, case.v, case.w, case.kappaRU, case.kappaRV)
    hold_interior("mom_fluxform(CD)", case, lambda impl: list(
        mom_fluxform.mom_fluxform(cd_cfg, g, *mom_ins, impl=impl)), results,
        reps, timed=timed)
    hold_interior("mom_vecinv(CD)", case, lambda impl: list(
        mom_vecinv.mom_vecinv(vi_cfg, g, *mom_ins, impl=impl)), results,
        reps, timed=timed)
    for label, settings in {"": {}, **(SH_UV_VARIANTS if variants
                                       else {})}.items():
        c = case.config("shap", **settings)
        hold_filter("shap_uv" + (f"({label})" if label else ""), case,
                    lambda impl, c=c: list(shap_filt.apply_uv(
                        c, g, c.shap, case.u, case.v, impl=impl)),
                    (case.u, case.v, g.maskW, g.maskS), results,
                    0 if label else reps)
    for label, settings in {"": {}, **(SH_TS_VARIANTS if variants
                                       else {})}.items():
        c = case.config("shap", **settings)
        hold_filter("shap_ts" + (f"({label})" if label else ""), case,
                    lambda impl, c=c: list(shap_filt.apply_ts(
                        c, g, c.shap, case.theta, case.salt, impl=impl)),
                    (case.theta, case.salt, g.maskW, g.maskS), results,
                    0 if label else reps)


def cd_shap_experiment(kind, n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = getattr(synthetic, CD_SHAP_CONFIGS[kind])(nx=n, ny=n, nr=nr, **kw)
    return Experiment(cfg, *synthetic.gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype)),
        impl=impl)


def cd_shap_parity_phase(kind, steps=5):
    """`steps` float64 steps of the 64x64x4 configuration, kernel path
    against plain path: equal cg2d iterations, PARITY_DIGITS or more on
    every statistic (and, on the CD paths, the D-grid pair's)."""
    from mitgcm_tpu_torch.utils.compare import digits, record_digits

    exps = {impl: cd_shap_experiment(kind, 64, 4, torch.float64, impl)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=steps) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        dig = record_digits(rk, rp)
        worst = min(worst, min(dig.values()))
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError(f"{kind}-gyre cg2d iteration counts differ")
    if exps[None].cfg.useCDscheme:
        for name in ("uVelD", "vVelD"):
            worst = min(worst, digits(
                getattr(exps[None].state, name).cpu().numpy(),
                getattr(exps["plain"].state, name).cpu().numpy()))
    print(f"{kind}-gyre parity, 64x64x4 float64, {steps} steps kernel "
          f"against plain: fewest matching digits {worst:.2f}, equal cg2d "
          f"iterations {[r['cg2d_iters'] for r in runs[None][1:]]}",
          flush=True)
    if not worst >= PARITY_DIGITS:
        raise AssertionError(f"{kind}-gyre parity {worst:.2f} < "
                             f"{PARITY_DIGITS} digits")


def cd_shap_plain_calls():
    """Calls so far of CD's, SH-uv's and SH-ts's twins and of the glue's."""
    from mitgcm_tpu_torch.model import cd_code, shap_filt

    return cd_code.plain_calls + shap_filt.plain_calls + glue_plain_calls()


def cd_shap_full_phase(kind, kernels, smi):
    """The 1024x1024x32 float32 configuration (deltaT = 600): a warm-up
    step, then 5 timed steps with every launch count (CD_SHAP_LAUNCHES),
    no twin of CD, SH-uv, SH-ts or the glue, finite fields (and a nonzero
    D-grid pair), then a profile of 2 steps."""
    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = cd_shap_experiment(kind, n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    points = n * n * nr

    def run(state, it0, steps):
        exp.state, exp.cur_iter = state, it0
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    state1, iters_w, sec_w = run(exp.state, 0, 1)
    kernels.launches.clear()
    plain0 = cd_shap_plain_calls()
    state, iters, sec = run(state1, 1, 5)
    launches = dict(kernels.launches)
    plain = cd_shap_plain_calls() - plain0
    wall_ms = sec * 1e3 / 5
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"{kind}-gyre kernel path ({smi}): 5 steps, {wall_ms:.2f} "
          f"ms/step, {points * 5 / sec:.4e} points*steps/s, cg2d "
          f"iterations {iters}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    names = ("uVel", "vVel", "wVel", "theta", "salt", "etaN") + (
        ("uVelD", "vVelD") if exp.cfg.useCDscheme else ())
    for name in names:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{kind}-gyre {name} is not finite")
    if exp.cfg.useCDscheme and not float(state.uVelD.abs().max()) > 0.0:
        raise AssertionError(f"{kind}-gyre: the D-grid pair stayed 0")
    check_launches(f"{kind}-gyre", launches, CD_SHAP_LAUNCHES[kind], plain)
    profile_steps(exp, state, 6, 2, wall_ms)
    return launches


def cd_shap_phase(kernels, results, smi):
    phase("21 CD scheme and Shapiro filter: the cd-gyre, cd-vi-gyre and "
          "shap-gyre")
    for n, nr, dtype, reps, variants in ((64, 4, torch.float64, 20, True),
                                         (64, 4, torch.float32, 0, True),
                                         (1024, 32, torch.float32, 10,
                                          False)):
        cd_shap_kernel_phase(CdShapCase(n, nr, dtype), results, reps,
                             variants)
        torch.cuda.empty_cache()
    print(smi)
    for kind in CD_SHAP_CONFIGS:
        cd_shap_parity_phase(kind)
    launches = {}
    for kind in CD_SHAP_CONFIGS:
        got = cd_shap_full_phase(kind, kernels, smi)
        if kind == "cd":
            launches.update({"cd_scheme": got["cd_scheme"],
                             "mom_ab_step(CD)": got["mom_ab_step"],
                             "mom_fluxform(CD)": got["mom_fluxform"]})
        elif kind == "cd-vi":
            launches["mom_vecinv(CD)"] = got["mom_vecinv"]
        else:
            launches.update({k: got[k] for k in ("shap_uv", "shap_ts")})
    GRIDS.clear()
    torch.cuda.empty_cache()
    return launches

# Phase 22: Winton's thermodynamic sea ice on the thsice-gyre (the
# ice-gyre's ocean and atmosphere with thsice in place of pkg/seaice)
THSICE_KERNELS = ("thsice_step",)
# launches in the 5 timed full-size thsice-gyre steps: the kpp-gyre's and
# one TH a step (its 13 outputs' halo fills folded into its writes)
THSICE_LAUNCHES = {**KPP_LAUNCHES, "thsice_step": 5}
# TH's operations (model/thsice.py:ThSIce.step, exp and a square root or
# division counted as 20 and 8): a cell outside the surface loop ~450 (the
# albedo's 3 exp, the shortwave's, the snow age's and the fluxes at 0 degC
# ~130, the solve's set-up ~80 with its square root and divisions,
# calc_thickn ~200, extend and the bookkeeping ~40); a live iteration of
# the loop ~90 (get_exf's exp and ~30 flops, the quadratic's two square
# roots and four divisions)
TH_OPS_CELL, TH_OPS_ITERATION = 450, 90


class ThsiceCase:
    """The thsice-gyre's grid and utils/synthetic.py:thsice_inputs's
    seeded fields on the card (every branch of the step somewhere)."""

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.thsice_gyre_config(nx=n, ny=n, nr=nr,
                                                deltaT=600.0)
        self.grid = (shared_grid(self.cfg, dtype)
                     or synthetic.gyre_grid(self.cfg, dtype=dtype,
                                            device="cuda"))
        self.args = synthetic.thsice_inputs(self.cfg, self.grid,
                                            seed=SEED + 53)

    label = Case.label


def hold_thsice(case, results, reps):
    """TH against its twin under each of synthetic.THSICE_VARIANTS, every
    padded cell of its 13 outputs bit for bit (exact_compare); the
    defaults timed as hold_opps times Z, the bound the larger of the bytes
    the launch moves and its operations on these inputs (the twin's live
    surface iterations); every branch of thsice.BRANCHES taken somewhere,
    under the defaults every ice cell out of the Terrmax loop before its
    last iteration, with nitMaxTsf = 2 some cell through both."""
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.model import thsice
    from mitgcm_tpu_torch.utils import synthetic

    ol, taken = case.cfg.olx, dict.fromkeys(thsice.BRANCHES, 0)
    base = thsice.params_from_namelists(case.cfg, {}, {})
    for variant, settings in synthetic.THSICE_VARIANTS.items():
        ts = thsice.ThSIce(case.cfg, case.grid,
                           dataclasses.replace(base, **settings))

        def fn(impl, ts=ts):
            th, upd = ts.advance(*case.args, impl=impl)
            return ([th[k] for k in thsice.TH_FIELDS]
                    + [upd[k] for k in thsice.TH_FLUXES])

        br = {}
        ts.step(*case.args, branches=br)
        for name in thsice.BRANCHES:
            taken[name] += int(br[name][ol:-ol, ol:-ol].sum())
        on = case.args[0]["thIceMask"][ol:-ol, ol:-ol] > 0.0
        its = br["iterations"][ol:-ol, ol:-ol][on]
        first, last = int(its.min()), int(its.max())
        if variant == "" and not (first == 1 and 1 < last
                                  < base.nitMaxTsf):
            raise AssertionError(f"TH's surface iterations {first}-{last}")
        if variant == "nitMaxTsf=2" and last != 2:
            raise AssertionError("no cell ran both surface iterations")
        name = "thsice_step" + (f"({variant})" if variant else "")
        timed = reps > 0 and not variant
        exact_compare(name, case, fn(None), fn("plain"),
                      cuda_time_ms(lambda: fn(None), reps) if timed
                      else None,
                      cuda_time_ms(lambda: fn("plain"), reps) if timed
                      else None, results, call=lambda: fn(None))
        r = results[name]
        live = int(br["iterations"].sum())
        ops = (TH_OPS_CELL * case.args[0]["thIceMask"].numel()
               + TH_OPS_ITERATION * live)
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        print(f"{'':18s} live surface iterations {live} ({first}-{last} a "
              f"cell of ice): {ops:.4e} operations, {t_ops:.4f} ms at the "
              f"peak", flush=True)
        if t_ops > r["bound_ms"]:
            r["bound_ms"], r["bound_by"] = t_ops, "operations"
        if not timed:
            continue
        args, keep = captured_launch(lambda: fn(None), "thsice_step")
        r["extra"] = {"wrapper_ms": r["ms"],
                      "events_ms": launch_ms(lambda: fn(None),
                                             "thsice_step", reps)}
        r["ms"] = graph_ms(lambda: kernels.launch(*args), reps)
        del keep
        print(f"{'':18s} device time (20 launches in a CUDA graph) "
              f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.2f} of the bound "
              f"({r['bound_by']}); CUDA events around a launch replayed "
              f"{r['extra']['events_ms']:.4f} ms; a wrapper call "
              f"{r['extra']['wrapper_ms']:.4f} ms", flush=True)
    print(f"TH's branches taken at {case.label} (cells, over the variants): "
          f"{taken}", flush=True)
    missed = [k for k, n in taken.items() if n == 0]
    if missed:
        raise AssertionError(f"TH's branches never taken: {missed}")


def thsice_experiment(n, nr, dtype, impl=None, **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.thsice_gyre_config(nx=n, ny=n, nr=nr, **kw)
    grid, state, forcing, op, kpp, th = synthetic.thsice_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, kpp=kpp, thsice=th,
                      impl=impl)


def thsice_parity_phase(steps=5):
    """`steps` float64 steps of the 64x64x12 thsice-gyre, kernel path
    against plain path: equal cg2d iterations, 15 digits or more on every
    statistic (the thSI_* ones too) and on the nine th* fields."""
    from mitgcm_tpu_torch.model import thsice
    from mitgcm_tpu_torch.utils.compare import digits, record_digits

    exps = {impl: thsice_experiment(64, 12, torch.float64, impl)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=steps) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        worst = min(worst, min(record_digits(rk, rp).values()))
        if rk["cg2d_iters"] != rp["cg2d_iters"]:
            raise AssertionError("thsice-gyre cg2d iteration counts differ")
    for name in thsice.TH_FIELDS:
        worst = min(worst, digits(
            getattr(exps[None].state, name).cpu().numpy(),
            getattr(exps["plain"].state, name).cpu().numpy()))
    print(f"thsice-gyre parity, 64x64x12 float64, {steps} steps kernel "
          f"against plain: fewest matching digits {worst:.2f} (statistics "
          f"and the th* fields), equal cg2d iterations "
          f"{[r['cg2d_iters'] for r in runs[None][1:]]}", flush=True)
    if not worst >= 15.0:
        raise AssertionError(f"thsice-gyre parity {worst:.2f} < 15 digits")


def thsice_full_phase(kernels, smi):
    """The 1024x1024x32 float32 thsice-gyre (deltaT = 600): a warm-up
    step, then 5 timed steps with every launch count (THSICE_LAUNCHES), no
    twin of TH, KPP or the glue, finite fields and ice, with the host's
    load average, then a profile of 2 steps (TH's device ms a step, the
    busy and idle share)."""
    from mitgcm_tpu_torch.model import kpp as kpp_mod, thsice

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = thsice_experiment(n, nr, torch.float32, deltaT=600.0)
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - t0:.1f} s")
    points = n * n * nr

    def plain_calls():
        return thsice.plain_calls + kpp_mod.plain_calls + glue_plain_calls()

    def run(state, it0, steps):
        exp.state, exp.cur_iter = state, it0
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, [r["cg2d_iters"] for r in recs], \
            time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    area0 = float(exp.state.thIceMask.sum())
    state1, iters_w, sec_w = run(exp.state, 0, 1)
    kernels.launches.clear()
    plain0 = plain_calls()
    load = os.getloadavg()
    state, iters, sec = run(state1, 1, 5)
    launches = dict(kernels.launches)
    plain = plain_calls() - plain0
    wall_ms = sec * 1e3 / 5
    print(f"warm-up step: {sec_w * 1e3:.1f} ms, cg2d iterations {iters_w}")
    print(f"thsice-gyre kernel path ({smi}): 5 steps, {wall_ms:.2f} "
          f"ms/step, {points * 5 / sec:.4e} points*steps/s, cg2d "
          f"iterations {iters}; the host's load average "
          f"{load[0]:.2f} {load[1]:.2f} {load[2]:.2f} before the steps, "
          f"{os.cpu_count()} cores")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; launches {launches}", flush=True)
    for name in ("uVel", "vVel", "wVel", "theta", "salt", "etaN",
                 *thsice.TH_FIELDS):
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"thsice-gyre {name} is not finite")
    area = float(state.thIceMask.sum())
    print(f"sum of the ice fraction {area0:.6e} at the start, {area:.6e} "
          f"after 6 steps", flush=True)
    if not area > area0:
        raise AssertionError("thsice-gyre: no new ice in the open south")
    check_launches("thsice-gyre", launches, THSICE_LAUNCHES, plain)
    prof = profile_steps(exp, state, 6, 2, wall_ms)
    th_ms = sum(v["ms"] for k, v in prof["port_kernels"].items()
                if "thsice" in k)
    print(f"TH in the profile: {th_ms:.4f} device ms a step; the step "
          f"{wall_ms:.2f} ms, busy {prof['device_busy_ms']:.2f} ms, idle "
          f"share {prof['idle_share']:.3f} ({smi})", flush=True)
    return launches


def thsice_phase(kernels, results, smi):
    phase("22 thsice: Winton's thermodynamic sea ice on the thsice-gyre")
    for n, nr, dtype, reps in ((64, 12, torch.float64, 0),
                               (1024, 32, torch.float32, 10)):
        hold_thsice(ThsiceCase(n, nr, dtype), results, reps)
        torch.cuda.empty_cache()
    print(smi)
    thsice_parity_phase()
    got = thsice_full_phase(kernels, smi)
    GRIDS.clear()
    torch.cuda.empty_cache()
    return {"thsice_step": got["thsice_step"]}


# phase 23: cg2dExactSums' ordered dot (A-exact) on the exact-gyre, the ice
# tracers (seaice_advect's X and Y with them, TP) on the sitr-ice-gyre
# and the legacy ice advection (LA) on the legacy-ice-gyre
EXACT_ICE_KERNELS = ("cg2d_solve_exact", "seaice_thermo_tr",
                     "seaice_advect_legacy")
# the latency of a dependent add (FADD 4 cycles, DADD 8) at the H100 SXM's
# 1980 MHz boost clock: A-exact's bound is its serial chains'
ADD_LATENCY_S = {torch.float32: 4 / 1.98e9, torch.float64: 8 / 1.98e9}
# the operations a cell of TP's and LA's launches, as OPS_PER_CELL counts
# seaice_thermo's: TP's tracer_phys ~25 a tracer with its four divisions on
# top of seaice_thermo's 800, LA's three passes ~20 a field each.
# seaice_advect's X and Y with two tracers keep their count without them:
# their bound is their bytes either way
OPS_PER_CELL.update({"seaice_thermo_tr": 850, "seaice_advect_legacy": 180})


def hold_exact_cg2d(n, nr, tile, dtype, results, reps, cap=None):
    """A-exact against its twin (the host loop with the ordered dot,
    solver/cg2d.py:_pcg_plain with tiles) on the exact-gyre's operator with
    a seeded right-hand side, from a zero first guess and from a warm one
    with the min-residual selection, bit for bit: x on the whole array, the
    residuals and the iterations (whole solves, or capped at `cap`
    iterations: the twin takes tile * tile dependent tensor adds a dot).
    With reps, the launch's device ms over whole solves, its bound (the
    serial chains' latency: 2 tile^2 + 2 (n / tile)^2 dependent adds an
    iteration), and torch.sum's ms for one of its dots (tree order: not
    the same function)."""
    from mitgcm_tpu_torch import kernels
    from mitgcm_tpu_torch.solver import cg2d as cg
    from mitgcm_tpu_torch.utils import synthetic

    cfg = synthetic.exact_gyre_config(nx=n, ny=n, nr=nr, tile=tile,
                                      deltaT=600.0)
    g, _, _, op = synthetic.gyre_setup(cfg, dtype=dtype, device="cuda",
                                       grid=shared_grid(cfg, dtype))
    rng = np.random.default_rng(SEED + 61)
    shape = tuple(g.rA.shape)
    b = torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                        device="cuda") * g.maskInC
    warm = 0.1 * torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                                 device="cuda") * g.maskInC
    label = f"{n}x{n} tiles {tile}x{tile} {str(dtype).split('.')[-1]}"
    cases = [("zero first guess", cfg, torch.zeros_like(b)),
             ("warm start, min-res 1",
              dataclasses.replace(cfg, cg2dUseMinResSol=1), warm)]
    for name, c, x0 in cases:
        if cap:
            c = dataclasses.replace(c, cg2dMaxIters=cap)
        n0 = kernels.launches["cg2d_solve_exact"]
        rk = cg.cg2d(c, op, b, x0)
        launched = kernels.launches["cg2d_solve_exact"] - n0
        rp = cg.cg2d(c, op, b, x0, impl="plain")
        same = (torch.equal(rk.x, rp.x)
                and torch.equal(rk.first_residual, rp.first_residual)
                and torch.equal(rk.last_residual, rp.last_residual)
                and rk.n_iters == rp.n_iters)
        err = float((rk.x - rp.x).abs().max())
        print(f"cg2d_solve_exact {label:26s} {name}"
              f"{f', cap {cap}' if cap else ''}: iterations {rk.n_iters} / "
              f"{rp.n_iters} (kernel / plain), residual "
              f"{float(rk.first_residual):.6e} -> "
              f"{float(rk.last_residual):.6e}, bit-equal {same}, launches "
              f"{launched}", flush=True)
        if not (same and launched == 1):
            raise AssertionError(f"cg2d_solve_exact disagrees with its twin "
                                 f"at {label}, {name}")
    if not reps:
        return
    c0, x0 = cases[0][1], cases[0][2]
    ms = launch_event_ms(lambda: cg.cg2d(c0, op, b, x0), "cg2d_solve_exact",
                         reps)
    full = cg.cg2d(c0, op, b, x0)
    # the twin over 3 iterations only (its dots are tile^2 launches each)
    plain_ms = cuda_time_ms(lambda: cg.cg2d(
        dataclasses.replace(c0, cg2dMaxIters=3), op, b, x0, impl="plain"),
        1)
    ol = cfg.olx
    inner = (b * b)[ol:-ol, ol:-ol]
    sum_ms = cuda_time_ms(lambda: torch.sum(inner), 20)
    it = max(full.n_iters, 1)
    adds = 2 * tile * tile + 2 * (n // tile) ** 2
    bound_ms = it * adds * ADD_LATENCY_S[dtype] * 1e3
    results["cg2d_solve_exact"] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "operations", "library_ms": None,
        "extra": {"iterations": full.n_iters, "ms_per_iteration": ms / it,
                  "plain_iterations": 3,
                  "torch_sum_ms_per_dot": sum_ms,
                  "tile": [tile, tile]}}
    print(f"{'':18s} {full.n_iters} iterations: the launch {ms:.4f} ms "
          f"({ms / it:.5f} an iteration); the twin {plain_ms:.1f} ms "
          f"over 3 iterations; bound {bound_ms:.4f} ms "
          f"({adds} dependent adds an iteration at "
          f"{ADD_LATENCY_S[dtype] * 1e9:.2f} ns); torch.sum of one dot's "
          f"products (tree order) {sum_ms:.4f} ms", flush=True)


def hold_ice_tracers(case, results, reps, plain_reps):
    """seaice_advect's X and Y launches with two tracers, and TP, against
    their twins on the
    sitr-ice-gyre's SeaIce ('age' with HEFF, 'one' with AREA) with seeded
    tracers of a wide spread, on whole arrays, bit for bit (exact_compare):
    X's localT and the extensive forms it writes; Y on the twin's X output
    (the fields, then each tracer over its new mate, ADVCAP, the
    negativity fix); TP's ice, forcing and tracers from reg_ridge, growth
    and tracer_phys."""
    from mitgcm_tpu_torch.model import seaice_kernels as sk

    si = case.si
    rng = np.random.default_rng(SEED + 67)
    shape = tuple(case.grid.rA.shape)
    tr = torch.as_tensor(rng.uniform(-1.0, 5.0, (2,) + shape),
                         dtype=case.dtype, device="cuda")
    ice = case.ice._replace(SItracer=tr)
    exts, khs = si._tracer_ext(ice)
    flds = [ice.HEFF, ice.AREA, ice.HSNOW] + exts
    khs = [si.p.diffKhHeff, si.p.diffKhArea, si.p.diffKhSnow] + khs
    fld = torch.empty((5,) + shape, dtype=case.dtype, device="cuda")
    fld[:3] = torch.stack(flds[:3])
    lt_k = torch.empty_like(fld)

    def x_kernel():
        sk.advect_x(si, ice, fld, lt_k)
        return [lt_k, fld[3:]]

    lt_p = torch.stack(si._advect_x_plain(ice, flds))
    exact_compare("seaice_advect_x(tracers)", case, x_kernel(),
                  [lt_p, torch.stack(exts)],
                  cuda_time_ms(x_kernel, reps),
                  cuda_time_ms(lambda: si._advect_x_plain(ice, flds),
                               plain_reps), results, call=x_kernel)
    out_k = torch.empty_like(fld)

    def y_kernel():
        sk.advect_y(si, ice, fld, lt_p, out_k)
        return [out_k]

    def y_plain():
        h, a, sn, *e = si._advect_y_plain(ice, flds, lt_p.unbind(0), khs)
        return [torch.cat([torch.stack([h, a, sn]),
                           si._tracer_cap(ice, h, a, e)])]

    exact_compare("seaice_advect_y(tracers)", case, y_kernel(), y_plain(),
                  cuda_time_ms(y_kernel, reps),
                  cuda_time_ms(y_plain, plain_reps), results, call=y_kernel)
    ice2 = case.ice2._replace(SItracer=torch.as_tensor(
        rng.uniform(0.0, 1e5, (2,) + shape), dtype=case.dtype,
        device="cuda"))

    def thermo(impl):
        i2, f = si.thermo(ice2, case.forc, case.theta0, case.salt0,
                          impl=impl)
        return [i2.HEFF, i2.HSNOW, i2.AREA, i2.TICES, i2.SItracer] + list(
            f.values())

    exact_compare("seaice_thermo_tr", case, thermo(None), thermo("plain"),
                  cuda_time_ms(lambda: thermo(None), reps),
                  cuda_time_ms(lambda: thermo("plain"), plain_reps), results,
                  call=lambda: thermo(None))


def hold_legacy(case, results, reps, plain_reps):
    """LA (three launches) against its twin on the legacy-ice-gyre's SeaIce
    (scheme 2, DIFF1 4e-3) and with diffKh besides, on seeded moving ice,
    every padded cell bit for bit (exact_compare)."""
    from mitgcm_tpu_torch.model import seaice_kernels as sk

    for variant, extra in (("", {}), ("diffKh", {"diffKhHeff": 300.0,
                                                 "diffKhArea": 200.0,
                                                 "diffKhSnow": 100.0})):
        si = case.si
        if extra:
            si = copy.copy(si)
            si.p = dataclasses.replace(si.p, **extra)
        name = "seaice_advect_legacy" + (f"({variant})" if variant else "")
        timed = not variant
        exact_compare(name, case, list(sk.advect_legacy(si, case.ice)),
                      si._advdiff_legacy_plain(case.ice),
                      cuda_time_ms(lambda: sk.advect_legacy(si, case.ice),
                                   reps) if timed else None,
                      cuda_time_ms(lambda: si._advdiff_legacy_plain(
                          case.ice), plain_reps) if timed else None,
                      results, call=lambda: sk.advect_legacy(si, case.ice))


def exact_ice_experiment(kind, config, n, nr, dtype, impl=None, **kw):
    """An Experiment of `config`: the exact-gyre (kind "exact", a gyre
    Experiment; tile=16 gives 16 x 16 tiles), the sitr- or the
    legacy-ice-gyre."""
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = config(nx=n, ny=n, nr=nr, **kw)
    if kind == "exact":
        objs = synthetic.gyre_setup(cfg, dtype=dtype, device="cuda",
                                    grid=shared_grid(cfg, dtype))
        return Experiment(cfg, *objs, impl=impl)
    grid, state, forcing, op, kpp, si = synthetic.ice_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, kpp=kpp, impl=impl,
                      seaice=si)


def exact_ice_parity(kind, config, n, nr, steps):
    """`steps` float64 steps kernel path against plain path (the exact-gyre
    on 16 x 16 tiles): equal cg2d (and LSR) iterations, every statistic
    (the seaice_* and sitracer rows too) to 15 digits or more, the state's
    fields bit for bit."""
    from mitgcm_tpu_torch.utils.compare import record_digits

    tile = {"tile": 16} if kind == "exact" else {}
    exps = {impl: exact_ice_experiment(kind, config, n, nr, torch.float64,
                                       impl, **tile)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=steps) for impl, e in exps.items()}
    worst = math.inf
    for rk, rp in zip(runs[None][1:], runs["plain"][1:]):
        worst = min(worst, min(record_digits(rk, rp).values()))
        if (rk["cg2d_iters"], rk.get("lsr_iters")) != (rp["cg2d_iters"],
                                                      rp.get("lsr_iters")):
            raise AssertionError(f"{kind}: iteration counts differ")
    names = ("uVel", "vVel", "theta", "etaN") + (
        () if kind == "exact" else ICE_STATE + ("SItracer",))
    differ = [m for m in names if not torch.equal(
        getattr(exps[None].state, m), getattr(exps["plain"].state, m))]
    print(f"{kind} parity, {n}x{n}x{nr} float64, {steps} steps kernel "
          f"against plain: fewest matching digits {worst:.2f}, cg2d "
          f"iterations {[r['cg2d_iters'] for r in runs[None][1:]]}, fields "
          f"that differ {differ}", flush=True)
    if not (worst >= 15.0 and not differ):
        raise AssertionError(f"{kind} parity {worst:.2f} < 15 or {differ}")


def exact_ice_full(kind, config, kernels, smi):
    """The 1024x1024x32 float32 path (deltaT = 600): a warm-up step, then 5
    timed steps with every launch count (its path's, no twin of the glue,
    KPP or the sea ice), finite fields, the host's load average, then a
    profile of 2 steps (each kernel's device ms a step, the busy and idle
    share). Returns the launches."""
    from mitgcm_tpu_torch.model import kpp as kpp_mod

    n, nr = 1024, 32
    t0 = time.perf_counter()
    exp = exact_ice_experiment(kind, config, n, nr, torch.float32,
                               deltaT=600.0)
    torch.cuda.synchronize()
    print(f"{kind}: set-up {time.perf_counter() - t0:.1f} s")
    points = n * n * nr

    def run(state, it0, steps):
        exp.state, exp.cur_iter = state, it0
        torch.cuda.synchronize()
        t = time.perf_counter()
        recs = exp.run(n_steps=steps, collect_monitor=False)
        torch.cuda.synchronize()
        return exp.state, recs, time.perf_counter() - t

    state1, recs_w, sec_w = run(exp.state, 0, 1)
    kernels.launches.clear()
    plain0 = kpp_mod.plain_calls + glue_plain_calls()
    load = os.getloadavg()
    state, recs, sec = run(state1, 1, 5)
    launches = dict(kernels.launches)
    plain = kpp_mod.plain_calls + glue_plain_calls() - plain0
    wall_ms = sec * 1e3 / 5
    print(f"{kind}: warm-up step {sec_w * 1e3:.1f} ms; kernel path ({smi}): "
          f"5 steps, {wall_ms:.2f} ms/step, {points * 5 / sec:.4e} "
          f"points*steps/s, cg2d iterations "
          f"{[r['cg2d_iters'] for r in recs]}"
          + (f", LSR ICOUNT1/2 per pass {[r['lsr_iters'] for r in recs]}"
             if kind != "exact" else "")
          + f"; the host's load average {load[0]:.2f} {load[1]:.2f} "
          f"{load[2]:.2f} before the steps", flush=True)
    print(f"launches {launches}", flush=True)
    names = ("uVel", "vVel", "theta", "etaN") + (
        () if kind == "exact" else ICE_STATE + ("SItracer",))
    for name in names:
        if not bool(torch.isfinite(getattr(state, name)).all()):
            raise AssertionError(f"{kind}-gyre {name} is not finite")
    if kind == "exact":
        want = {**GYRE_LAUNCHES, "cg2d_solve": 0, "cg2d_solve_exact": 5}
    else:
        from mitgcm_tpu_torch.model import seaice as seaice_mod

        syncs = [r["lsr_host_syncs"] for r in recs]
        batches = seaice_mod.BATCH * sum(s for ss in syncs for s in ss)
        tr = kind == "sitr"
        want = {**KPP_LAUNCHES, "seaice_lsr_visc": 10,
                "seaice_lsr_coeffs": 10,
                "seaice_lsr_tridiag_u": 2 * batches,
                "seaice_lsr_tridiag_v": 2 * batches,
                "seaice_lsr_check": batches,
                "seaice_advect_x": 5 * tr, "seaice_advect_y": 5 * tr,
                "seaice_thermo": 5 * (not tr), "seaice_thermo_tr": 5 * tr,
                "seaice_advect_legacy": 15 * (kind == "legacy"),
                **{k: 5 for k in SEAICE_GLUE_KERNELS},
                **{k: 0 for k in EVP_KERNELS},
                # the ice-gyre's 120 fills, and the tracers' end-of-step one
                "halo_fill": 120 + 5 * tr}
    check_launches(f"{kind}-gyre", launches, want, plain)
    prof = profile_steps(exp, state, 6, 2, wall_ms)
    mine = {k: v["ms"] for k, v in prof["port_kernels"].items()
            if any(m in k for m in ("cg2d_solve", "seaice_advect",
                                    "seaice_thermo"))}
    print(f"{kind}: device ms a step in the profile "
          + ", ".join(f"{k.split('(')[0][8:]} {v:.4f}"
                      for k, v in mine.items())
          + f"; the step {wall_ms:.2f} ms, busy "
          f"{prof['device_busy_ms']:.2f} ms, idle share "
          f"{prof['idle_share']:.3f} ({smi})", flush=True)
    return launches


def exact_ice_phase(kernels, results, smi):
    from mitgcm_tpu_torch.utils import synthetic

    phase("23 exact-ice: cg2dExactSums (A-exact), the ice tracers "
          "(seaice_advect with tracers, TP) and the legacy ice advection "
          "(LA)")
    hold_exact_cg2d(64, 4, 16, torch.float64, results, 0)
    hold_exact_cg2d(1024, 32, 64, torch.float32, results, 5, cap=3)
    for n, nr, dtype, reps, plain_reps in ((64, 12, torch.float64, 0, 0),
                                           (1024, 32, torch.float32, 10, 3)):
        hold_ice_tracers(IceCase(n, nr, dtype,
                                 synthetic.sitr_ice_gyre_config),
                         results, reps or 1, plain_reps or 1)
        hold_legacy(IceCase(n, nr, dtype, synthetic.legacy_ice_gyre_config),
                    results, reps or 1, plain_reps or 1)
        torch.cuda.empty_cache()
    print(smi)
    paths = {"exact": synthetic.exact_gyre_config,
             "sitr": synthetic.sitr_ice_gyre_config,
             "legacy": synthetic.legacy_ice_gyre_config}
    for kind, nr, steps in (("exact", 4, 2), ("sitr", 12, 3),
                            ("legacy", 12, 3)):
        exact_ice_parity(kind, paths[kind], 64, nr, steps)
    launches = {}
    for kind in ("exact", "sitr", "legacy"):
        got = exact_ice_full(kind, paths[kind], kernels, smi)
        for k in EXACT_ICE_KERNELS:
            if got.get(k):
                launches[k] = got[k]
        torch.cuda.empty_cache()
    GRIDS.clear()
    return launches


def gyre_phases(kernels, results, smi):
    """Phases 3-5: the gyre's kernels against their twins, its parity and
    its full-size run, whose launches are the JSON line's base."""
    phase("3 kernels vs plain twins")
    # the JSON summary reports the main path's shapes (the second case)
    kernel_phase(Case(64, 4, torch.float64), results, reps=20)
    kernel_phase(Case(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
    parity_phase()
    launches = full_phase(kernels)
    torch.cuda.empty_cache()
    return launches


def adjoint_phases(kernels, results, smi):
    phase("6 adjoint")
    t0 = time.perf_counter()
    vjp_phase(Case(64, 4, torch.float64), results, reps=20)
    vjp_phase(Case(1024, 32, torch.float32), results, reps=10)
    t1 = time.perf_counter()
    glue_vjp_phase(GlueCase(64, 4, torch.float64), results, 20, "every")
    glue_vjp_phase(GlueCase(64, 4, torch.float64, vi=True), results, 20,
                   "AB-3")
    glue_vjp_phase(GlueCase(1024, 32, torch.float32), results, 10, "gyre")
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    grdchk_phase()
    t3 = time.perf_counter()
    got = adjoint_full_phase(kernels)
    print(f"adjoint: B' and C' {t1 - t0:.1f} s, the glue's backward kernels "
          f"{t2 - t1:.1f} s, grdchk {t3 - t2:.1f} s, the full-size gradient "
          f"{time.perf_counter() - t3:.1f} s", flush=True)
    return {name: got[name] for name in BACKWARD_KERNELS}


def vi_phases(kernels, results, smi):
    got = vi_phase(kernels, results)
    # no later phase but 21 runs the uniform levels: free their grid, so
    # that each phase's peak memory holds no other configuration's grid
    GRIDS.clear()
    return {name: got[name] for name in VI_KERNELS}


def kpp_phases(kernels, results, smi):
    got = kpp_phase(kernels, results, smi)
    return {name: got[name] for name in KPP_KERNELS + ("kappa_uv",
                                                       "kappa_ts")}


def g9_phases(kernels, results, smi):
    got = g9_phase(kernels, results, smi)
    return {name: got[name]
            for name in G9_KERNELS + MD_KERNELS + ("eos_sigma_r",)}


def ism_phases(kernels, results, smi):
    got = ism_phase(kernels, results, smi)
    GRIDS.clear()
    return got


def no_launches(fn):
    """A phase that holds kernels against their twins and runs no path of
    its own: the JSON line takes its kernels' launches from the paths."""
    def run(kernels, results, smi):
        fn(results)
        return {}
    return run


# the phases after the device and the build, by name, in their order
PHASES = {"gyre": gyre_phases, "adjoint": adjoint_phases, "vi": vi_phases,
          "kpp": kpp_phases, "ggl90": g9_phases, "ho": ho_phase,
          "ism": ism_phases, "nh": nh_phase, "ice": ice_phase,
          "glue": no_launches(glue_phase), "evp": evp_phase, "gm": gm_phase,
          "mix": no_launches(mix_phase),
          "last-glue": no_launches(last_glue_phase), "visc": visc_phase,
          "rimix": rimix_phase, "cd-shap": cd_shap_phase,
          "thsice": thsice_phase, "exact-ice": exact_ice_phase}


def main(argv=()):
    names = list(argv) or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; the "
                         f"phases are {list(PHASES)}")
    smi = device_phase()
    sys.path.insert(0, ROOT)
    from mitgcm_tpu_torch import kernels

    t0 = time.perf_counter()
    build_phase(kernels)
    print(f"phase build took {time.perf_counter() - t0:.1f} s", flush=True)
    count_cg2d_reads()
    results, launches = {}, {}
    for name in PHASES:
        if name not in names:
            continue
        t0 = time.perf_counter()
        launches.update(PHASES[name](kernels, results, smi))
        print(f"phase {name} took {time.perf_counter() - t0:.1f} s",
              flush=True)
    jax_pkg = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "mitgcm_tpu" or m.startswith("mitgcm_tpu.")]
    if jax_pkg:
        raise AssertionError(f"the port imported {jax_pkg}")

    # every kernel with no argument; those of the phases run otherwise
    rows = [(name, src, rep) for name, (src, rep) in KERNELS.items()
            if not argv or (name in launches and name in results)]
    summary = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **{k: results[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                **results[name].get("extra", {})}
               for name, src, rep in rows]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
