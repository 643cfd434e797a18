#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mitgcm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero without the final line:
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
                 grdchk of the 16x16x4 float64 gyre on the kernel path
                 (the set-up of tests/test_adjoint.py), its gradient against
                 the plain path's and against a second kernel-path run; then
                 the gradient of a box cost through 6 checkpointed steps of
                 the 1024x1024x32 float32 gyre, timed against the forward
                 steps alone (medians of 3 runs each), with peak memory and
                 every kernel's launches (those of the first gradient)
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
                 the same cells); 10 float64 steps at 64x64x12 of the
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
                 H-cg3d's three launches (cg3d_precond_dot,
                 cg3d_s_stencil_dot, cg3d_xr_update, each with its `done`
                 word, frozen launches included) against their twins bit
                 for bit at 64x64x12 float64 on a grid with walls, a bank
                 and partial cells and at 1024x1024x50 float32, and the
                 whole cg3d solve kernel path against plain path; 10
                 float64 steps of the 64x64x12 box, kernel path against
                 plain path (16 digits, equal cg2d and cg3d iterations);
                 the refusal of its pickup; then the 1024x1024x50 float32
                 box (deltaT=60): one warm-up step and 5 timed steps with
                 every kernel's launch count (W and B each step, H-cg3d 8
                 per batch of iterations, the plain twins never) and the
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
                 twin's and its bound; F's time is its device time, 20
                 calls captured in a CUDA graph and replayed, beside
                 F.pad(mode="circular"), which computes the same fill,
                 timed the same way, and beside both as CUDA-event times
                 (F a launch replayed back to back, F.pad a batch of 20
                 calls); F's device time must not be below its bound, nor
                 slower than F.pad's in 3-D at full size by either
                 timing. F also on an input view whose offset is not a
                 multiple of 16 bytes (every row in scalar cells), bit for
                 bit and timed beside F.pad.
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
The full-size grids are built once per distinct geometry and shared by
the phases that run it (`shared_grid`); each build and each set-up
prints its seconds.
It prints, last, one line of JSON per kernel (the launches are those of
the main path that runs it: phase 5 for the gyre's forward kernels, phase
6's full-size gradient for B' and C', phase 7's full-size run for V, T
and R, phase 8's for K, phase 9's for G9 and M, phase 10's os7mp-gyre for
O and pqm-gyre for P, phase 11's idemix-gyre for H-IDEMIX and som-gyre for
H-SOM, phase 12's box for W and H-cg3d, phase 13's ice-gyre for the sea
ice's, phase 15's evp-ice-gyre for EVP's and its free-drift run for
seaice_freedrift, phase 16's gm-gyre for gm_tensor and C's GM branch and
its gm-bolus-gyre for gm_psi_b and gm_residual_flow, phase 5's gyre for
A and D-G), with the kernel's time (D-G's
from phase 14, F's its device time in a CUDA graph beside F.pad's;
A's the launch of a whole solve, with its iterations and its time and
bound an iteration), its plain twin's, and its
bound (the larger of the bytes it must move over 3.35 TB/s and its
estimated operations over 67 TFLOP/s, the H100's float32 peaks; A's
operations are this run's iterations') at the full-size float32 shapes
of its path (1024x1024x32, the box's 1024x1024x50), the card's name and
power limit, and the device line.
"""

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
    # the nh-convection box's kernels H-cg3d and W
    "cg3d_precond_dot": ("mitgcm_tpu_torch/kernels/csrc/cg3d.cu",
                         "mitgcm_tpu/solver/cg3d.py:228"),
    "cg3d_s_stencil_dot": ("mitgcm_tpu_torch/kernels/csrc/cg3d.cu",
                           "mitgcm_tpu/solver/cg3d.py:231"),
    "cg3d_xr_update": ("mitgcm_tpu_torch/kernels/csrc/cg3d.cu",
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
}
CG2D_KERNELS = ("cg2d_solve",)
# the key under which each kernel-path cg2d solve's host reads are counted
# beside the launches (count_cg2d_reads)
CG2D_READS = "cg2d host reads"
BACKWARD_KERNELS = ("mom_fluxform_adj", "gad_calc_rhs_c2_adj")
GLUE_KERNELS = ("halo_fill", "phihyd", "cg2d_rhs", "continuity",
                "mom_ab_step", "mom_correction", "tracer_step")


def glue_launches(tracers, fills, steps=5):
    """The launches of A and D-G in `steps` steps of a path that steps
    `tracers` tracers and makes `fills` halo fills a step (u*, v*, the cg2d
    and cg3d results, u, v and the new state's fields, the sea ice's): one
    cg2d solve a step, one launch and one host read each."""
    return {"cg2d_solve": steps, CG2D_READS: steps, "phihyd": steps,
            "cg2d_rhs": steps, "continuity": steps,
            "mom_ab_step": steps, "mom_correction": steps,
            "tracer_step": tracers * steps, "halo_fill": fills * steps}


# launches in phase 5's 5 timed full-size gyre steps (A's follow its
# iterations)
GYRE_LAUNCHES = {"mom_fluxform": 5, "gad_calc_rhs_c2": 5,
                 **glue_launches(1, 12)}
# launches in phase 6's first full-size gradient (6 steps in 2
# checkpointed chunks of 3): the forward kernels of 6 steps and of their
# recomputation (16 step bodies a gradient, of which the recomputation's
# last fills are cut short: 150 fills in all), and the fill of each of the
# 5 adjoint cg2d solves (the last step's eta does not reach the cost),
# each one cg2d_solve launch and one host read
ADJ_LAUNCHES = {**glue_launches(1, 0, 16), "halo_fill": 155,
                "halo_fill:adjoint": 5, "cg2d_solve": 21, CG2D_READS: 21,
                "cg2d_solve:adjoint": 5}
VI_KERNELS = ("mom_vecinv", "impldiff", "eos_find_rho")
# launches of each kernel in phase 7's 5 timed full-size vi-gyre steps
VI_LAUNCHES = {"mom_vecinv": 5, "impldiff": 20, "eos_find_rho": 5,
               "mom_fluxform": 0, **glue_launches(2, 12)}
KPP_KERNELS = ("kpp_pre", "kpp_smooth", "kpp_col")
# launches in phase 8's 5 timed full-size kpp-gyre steps
KPP_LAUNCHES = {"kpp_pre": 5, "kpp_smooth": 5, "kpp_col": 5,
                "mom_vecinv": 5, "impldiff": 20, "eos_find_rho": 5,
                "gad_calc_rhs_c2": 10, "mom_fluxform": 0,
                **glue_launches(2, 12)}
G9_KERNELS = ("ggl90_col", "ggl90_visc")
MD_KERNELS = ("gad_multidim_x", "gad_multidim_y", "gad_multidim_r")
# launches in phase 9's 5 timed full-size ggl90-gyre steps: M three per
# tracer, R for find_rho and calc_sigmaR
G9_LAUNCHES = {"ggl90_col": 5, "ggl90_visc": 5, "gad_multidim_x": 10,
               "gad_multidim_y": 10, "gad_multidim_r": 10,
               "gad_calc_rhs_c2": 10, "impldiff": 20, "eos_find_rho": 10,
               "mom_vecinv": 5, "kpp_pre": 0, "mom_fluxform": 0,
               **glue_launches(2, 13)}
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
               "eos_find_rho": 10, "gm_tensor": 5, "gm_psi_b": 0,
               "gm_residual_flow": 0}
GM_BOLUS_LAUNCHES = {**GM_LAUNCHES, "gm_psi_b": 5, "gm_residual_flow": 5,
                     "halo_fill": 70}
CG3D_KERNELS = ("cg3d_precond_dot", "cg3d_s_stencil_dot", "cg3d_xr_update")
NH_KERNELS = CG3D_KERNELS + ("calc_gw",)
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
# step, C for theta alone, no other kernel of the gyres, and D-G with the
# fills of phi_nh and of the cg3d result
NH_LAUNCHES = {"calc_gw": 5, "mom_fluxform": 5, "gad_calc_rhs_c2": 5,
               "mom_vecinv": 0, "impldiff": 0, "eos_find_rho": 0,
               "kpp_pre": 0, "ggl90_col": 0, "gad_multidim_x": 0,
               **glue_launches(1, 14)}
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
                "gad_calc_rhs_c2": 60, "mom_fluxform_adj": 600,
                "gad_calc_rhs_c2_adj": 120, "mom_vecinv": 300,
                "impldiff": 15, "eos_find_rho": 60, "kpp_pre": 400,
                "kpp_smooth": 40, "kpp_col": 250, "ggl90_col": 120,
                "ggl90_visc": 10, "gad_multidim_x": 80,
                "gad_multidim_y": 80, "gad_multidim_r": 80,
                "gad_os7mp_x": 200, "gad_os7mp_y": 200, "gad_os7mp_r": 200,
                "gad_ppm_x": 350, "gad_ppm_y": 350, "gad_ppm_r": 350,
                "idemix_prep": 150, "idemix_hdiff": 60, "idemix_col": 40,
                "som_x": 400, "som_y": 400, "som_r": 400,
                "cg3d_precond_dot": 10, "cg3d_s_stencil_dot": 40,
                "cg3d_xr_update": 8, "calc_gw": 200,
                # the sea ice's, per 2-D cell (seaice_thermo's per cell of
                # its largest field, TICES, one category of one column: 11
                # flux evaluations of ~30 flops and 2 exp, counted as 20
                # flops each, and the category's share of the budget); a
                # half-sweep's line solve is ~12 a cell on half the cells
                "seaice_lsr_visc": 60, "seaice_lsr_coeffs": 200,
                "seaice_lsr_tridiag_u": 6, "seaice_lsr_tridiag_v": 6,
                "seaice_lsr_check": 4, "seaice_advect_x": 120,
                "seaice_advect_y": 150, "seaice_thermo": 800,
                # EVP's launches (sigma12 recomputed at 3 Z points and the
                # drag at 3 C points a thread in seaice_evp_uv) and free
                # drift's (3 C-point solves a thread, atan2, sin, cos and
                # sqrt counted as 20 flops each)
                "seaice_evp_stress": 120, "seaice_evp_uv": 250,
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
                "gad_calc_rhs_c2_gm": 130}
# tensors that a wrapper checks but that are its kernel's scratch, and
# those it updates in place (read and written)
SCRATCH = ("gam", "cuu")
IN_PLACE = {"cg3d_xr_update": ("x", "r"), "seaice_lsr_tridiag_u": ("u",),
            "seaice_lsr_tridiag_v": ("u",),
            "seaice_lsr_check": ("uTmp", "vTmp")}
# the plain glue that is not a row of the kernel table, and row H, still
# to port: the distinct float32 fields each must move once per call at
# 1024x1024x32 (3-D, 2-D), each input read once and each output written
# once, for their bound
GLUE_FIELDS = {
    "KPP glue visc_uv and ghat_flux of theta and salt": (15, 4),
    "GGL90 glue: kappaRU/RV and kapT/kapS sums, sigmaR": (20, 0),
    "seaice glue get_dynforcing (fu, fv, yC, SIMaskU/V in; taux, tauy out)":
        (0, 7),
    "seaice glue ocean_stress (uIce, vIce, uVel0, vVel0, dwatn, fCori, AREA,"
    " fu, fv in; fu, fv out)": (0, 11),
    "seaice glue ocean_stress_hb87 (AREA, windTauX/Y, stressDivX/Y, fu, fv "
    "in; fu, fv out)": (0, 9),
    "seaice glue clipVelocities (uIce, vIce in and out)": (0, 4),
    "seaice glue no-dynamics oceandrag (uIce, vIce, uVel0, vVel0, maskInW/S,"
    " yC, HEFFM in; dwatn out)": (0, 9),
    "seaice glue EVP set-up (HEFFM, AREA, massU, massV in; sumNorm, areaW, "
    "areaS, locMaskU/V out)": (0, 9),
}
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
    """Calls so far of the twins of D-G (ops/stencil.py, model/phihyd.py,
    model/step.py, model/thermodynamics.py); a kernel-path run adds none."""
    from mitgcm_tpu_torch.model import phihyd, step, thermodynamics
    from mitgcm_tpu_torch.ops import stencil

    return (stencil.plain_calls + phihyd.plain_calls + step.plain_calls
            + thermodynamics.plain_calls)


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


def mom_footprint(named, args):
    """Kernel B's inputs as the views that its launch reads (args: the
    launch's arguments after the pointer table and its length): the
    kappas below the surface interface, recip_drC between the levels, the
    3-D Coriolis term's two fields only under its flag."""
    nr, _, _, oly, olx, _, cori3d = args[:7]
    levels = {"kappaRU": slice(1, None), "kappaRV": slice(1, None),
              "recip_drC": slice(1, nr)}
    skip = () if cori3d else ("fCoriCos", "angleCosC")
    return {n: footprint_view(t, oly, olx, MOM_RINGS.get(n),
                              levels.get(n))
            for n, t in named.items() if n not in skip}


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


def footprint_view(t, oly, olx, ring, levels):
    """The cells of t that a kernel reads: for a field of the padded grid
    its interior and the ring sides named (ring None: the interior only),
    at the levels given (None: all); a 1-D field's levels."""
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
              "gad_calc_rhs_c2": (gad_footprint, ("last",)),
              "gad_calc_rhs_c2_gm": (gad_footprint, ("last",))}


def moved_bytes(name, call):
    """(bytes, cells): the bytes of the distinct tensors that the kernel's
    wrapper checks in one call (each input read once, each output written
    once, an in-place one both), and the most cells any of them covers.
    For a kernel of FOOTPRINTS, each input counts only the cells and levels
    that its launch reads (its flags taken from the launch), each output
    whole."""
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
        ins = {n: t for n, t in named.items() if n not in outs}
        views = {**footprint(ins, args[0]), **{n: named[n] for n in outs}}
        seen = {}
        for n, v in views.items():   # a tensor passed twice counts once
            key = named[n].data_ptr()
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
               + EVP_KERNELS + GM_KERNELS and launches.get(k, 0) == 0]
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


def vi_kernel_phase(case, results, reps):
    """Kernels V, T and R against their twins on the same seeded inputs: V
    on the interior (its halo outputs are zeros), T and R on whole arrays
    (a column solve and a pointwise pass compute their halos as the twins
    do). R on the vi-gyre's JMD95Z (the main path's, in the summary) and
    on MDJWF with the pressure from totPhiHyd."""
    import dataclasses

    from mitgcm_tpu_torch.model.mom_vecinv import mom_vecinv
    from mitgcm_tpu_torch.model.thermodynamics import impldiff
    from mitgcm_tpu_torch.ops.eos import find_rho

    cfg, g = case.cfg, case.grid

    def mom(impl):
        return mom_vecinv(cfg, g, case.u, case.v, case.w, case.kappaRU,
                          case.kappaRV, impl=impl)

    compare("mom_vecinv", case, mom(None), mom("plain"),
            cuda_time_ms(lambda: mom(None), reps),
            cuda_time_ms(lambda: mom("plain"), reps), results,
            call=lambda: mom(None))

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
        sfT, sfS = th.surface_forcing_ts(cfg, g, state, forc)
        self.args = (
            self.field(rng, shape, 0.1) * g.maskW,
            self.field(rng, shape, 0.1) * g.maskS,
            (tref + self.field(rng, shape, 0.3)) * g.maskC,
            (sref + self.field(rng, shape, 0.02)) * g.maskC,
            self.field(rng, shape, 2.0),
            forc.fu * cfg.mass2rUnit + self.field(rng, shape[1:], 1e-5),
            self.field(rng, shape[1:], 1e-5), sfT, sfS, forc.Qsw)
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
    ms, idle share, and the ms and launches of the plain glue (PyTorch's
    own kernels and copies) and of the port's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    exp.state, exp.cur_iter, exp.impl = state, it0, None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        exp.run(n_steps=steps, collect_monitor=False)
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

    def __init__(self, n, nr, dtype, config="ggl90"):
        from mitgcm_tpu_torch.model import gad
        from mitgcm_tpu_torch.model import thermodynamics as th
        from mitgcm_tpu_torch.ops.eos import find_rho
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = getattr(synthetic, f"{config}_gyre_config")(
            nx=n, ny=n, nr=nr, deltaT=600.0)
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
    path's, last) against their twins on whole arrays, halos included;
    and C without its advective part, as the ggl90-gyre runs it."""
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
        sweeps = gad.multidim_sweeps(cfg, g, case.flow, case.u, case.v,
                                     case.w, case.tracer, scheme, scheme,
                                     cfg.deltaTTracer)
        for name, run, src, dst, touched in sweeps:
            twin = gad.MD_PLAIN[name]

            def plain(twin=twin, src=src):
                return twin(cfg, g, case.flow, case.u, case.v, case.w,
                            case.tracer, src, scheme, scheme,
                            cfg.deltaTTracer)
            run()
            label = name if scheme == 33 else f"{name}({scheme})"
            compare(label, case, [dst], [plain()],
                    cuda_time_ms(run, reps), cuda_time_ms(plain, reps),
                    results, whole=True, tensors=touched)

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


def g9_experiment(n, nr, dtype, impl=None, config="ggl90", **kw):
    from mitgcm_tpu_torch.model.experiment import Experiment
    from mitgcm_tpu_torch.utils import synthetic

    cfg = getattr(synthetic, f"{config}_gyre_config")(nx=n, ny=n, nr=nr, **kw)
    grid, state, forcing, op, ggl90 = synthetic.ggl90_gyre_setup(
        cfg, dtype=dtype, device="cuda", grid=shared_grid(cfg, dtype))
    return Experiment(cfg, grid, state, forcing, op, ggl90=ggl90, impl=impl)


def g9_parity_phase(config="ggl90"):
    from mitgcm_tpu_torch.utils.compare import digits, interior, record_digits

    exps = {impl: g9_experiment(64, 12, torch.float64, impl, config)
            for impl in (None, "plain")}
    runs = {impl: e.run(n_steps=10) for impl, e in exps.items()}
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
    print(f"{config}-gyre parity: fewest matching digits {worst:.2f} ("
          + ", ".join(f"{k} {v:.2f}" for k, v in fields.items()) + ")")


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
    g9_kernel_phase(G9Case(64, 12, torch.float64), results, reps=20)
    g9_kernel_phase(G9Case(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
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
        for name, run, src, dst, touched in sweeps:
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
            exact_compare(label, case, [dst], [plain()],
                          cuda_time_ms(run, reps),
                          cuda_time_ms(plain, plain_reps), results,
                          touched=touched)


def ho_phase(kernels, results, smi):
    phase("10 high-order advection: os7mp-gyre and pqm-gyre, halos of 4")
    ho_kernel_phase(G9Case(64, 12, torch.float64, "os7mp"), results, 20, 20)
    ho_kernel_phase(G9Case(1024, 32, torch.float32, "os7mp"), results, 10, 3)
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
        for (name, run, outs, touched), twin in zip(sweeps, twins):
            run()
            label = name if scheme == 81 else f"{name}({scheme})"
            exact_compare(label, case, list(outs), list(twin()),
                          cuda_time_ms(run, reps),
                          cuda_time_ms(twin, plain_reps), results,
                          touched=touched)
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
    outputs are zeros by design, as in phase 3); H-cg3d's three launches,
    one call each on the same inputs, on whole arrays with their dot
    products and `ctrl`, their frozen launches, and the whole solve kernel
    path against plain path. Every comparison is bit for bit."""
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

    def pre(impl, ctrl):
        q, dot = torch.zeros_like(case.r), case.r.new_zeros(())
        cg3d.precond_dot(op3, g.maskC, case.r, q, dot, ctrl, ol, ol, ws=ws,
                         impl=impl)
        return [q, dot]

    def sst(impl, ctrl):
        s_out, qa = torch.zeros_like(case.r), torch.zeros_like(case.r)
        dot = case.r.new_zeros(())
        cg3d.s_stencil_dot(op3, g.maskC, case.q, case.s, s_out, qa, eta_n,
                           eta_nm1, dot, ctrl, ol, ol, ws=ws, impl=impl)
        return [s_out, qa, dot]

    def xr(impl, ctrl, tol=never, max_iters=2 ** 30):
        x, r, dot = case.x.clone(), case.r.clone(), case.r.new_zeros(())
        cg3d.xr_update(x, r, case.s, case.q, eta_n, den, g.maskC, dot, ctrl,
                       tol, max_iters, True, ol, ol, ws=ws, impl=impl)
        return [x, r, dot] + ([ctrl.to(dt)] if ctrl is not None else [])

    go = ctrl_of(0, 0)     # never done in the timed calls
    for name, call in (("cg3d_precond_dot", pre), ("cg3d_s_stencil_dot", sst),
                       ("cg3d_xr_update", xr)):
        exact_compare(name, case, call(None, ctrl_of(0, 5)),
                      call("plain", ctrl_of(0, 5)),
                      cuda_time_ms(lambda: call(None, go), reps),
                      cuda_time_ms(lambda: call("plain", None), plain_reps),
                      results, call=lambda: call(None, ctrl_of(0, 5)))
    for label, ctrl, kw in (("stops at the cap", ctrl_of(0, 6),
                             dict(max_iters=7)),
                            ("stops at the tolerance", ctrl_of(0, 2),
                             dict(tol=case.r.new_tensor(1e30)))):
        k = xr(None, ctrl.clone(), **kw)
        p = xr("plain", ctrl.clone(), **kw)
        done = [int(v) for v in k[-1].tolist()]
        print(f"{'cg3d_xr_update':18s} {case.label:18s} {label}: ctrl "
              f"{done} / {[int(v) for v in p[-1].tolist()]} (kernel / plain)",
              flush=True)
        if not (done[0] == 1 and all(torch.equal(a, b) for a, b in zip(k, p))):
            raise AssertionError(f"cg3d_xr_update: {label} differs")
    # frozen launches: with `done` set every launch returns at once
    frozen = ctrl_of(1, 3)
    before = [case.x.clone(), case.r.clone()]
    outs = pre(None, frozen) + sst(None, frozen) + xr(None, frozen)
    untouched = (all(float(t.abs().max()) == 0.0 for t in outs[:5])
                 and torch.equal(outs[5], before[0])
                 and torch.equal(outs[6], before[1])
                 and float(outs[7]) == 0.0
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
    steps with every launch count, a profile and 2 plain steps."""
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
    plain0 = (calc_gw.plain_calls + cg3d.plain_calls + gad.plain_calls
              + glue_plain_calls())
    state, recs, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = (calc_gw.plain_calls + cg3d.plain_calls + gad.plain_calls
             + glue_plain_calls() - plain0)
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
          f" GiB; plain W, H-cg3d, C and D-G calls {plain}; launches "
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
    want = {**NH_LAUNCHES, "cg3d_precond_dot": batches,
            "cg3d_s_stencil_dot": batches + 5, "cg3d_xr_update": batches + 5}
    wrong = {k: launches.get(k, 0) for k, count in want.items()
             if launches.get(k, 0) != count}
    late = [(i, s) for i, s in zip(it3, syncs)
            if s > math.ceil(i / cg3d.BATCH) + 2]
    if wrong or plain or late:
        raise AssertionError(f"nh-convection launch counts {wrong} (want "
                             f"{want}), plain calls {plain}, host syncs "
                             f"over ceil(iters/8)+2 {late}")
    profile_steps(exp, state1, 1, 2, sec * 1e3 / 5)
    _, recs_p, sec_p = run(state1, 1, 2, "plain")
    print(f"plain path: 2 steps, {sec_p * 1e3 / 2:.2f} ms/step, "
          f"{points * 2 / sec_p:.4e} points*steps/s, cg3d iterations "
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

    def __init__(self, n, nr, dtype):
        from mitgcm_tpu_torch.utils import synthetic

        self.dtype = dtype
        self.cfg = synthetic.ice_gyre_config(nx=n, ny=n, nr=nr,
                                             deltaT=600.0)
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
    plain0 = (kpp_mod.plain_calls + seaice_mod.plain_calls
              + glue_plain_calls())
    state, recs, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = (kpp_mod.plain_calls + seaice_mod.plain_calls
             + glue_plain_calls() - plain0)
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
          f" GiB; plain KPP, sea-ice and D-G calls {plain}; launches "
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
    return {k: run[k] for k in ICE_KERNELS}


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

    ice, d = case.ice, case.dyn
    dyn = [d[k] for k in ("uVel0", "vVel0", "press0", "massC", "massU",
                          "massV", "forcex0", "forcey0")]
    fixed = dict(uNm1=case.uvNm1[0], vNm1=case.uvNm1[1],
                 **{k: d[k] for k in ("uVel0", "vVel0", "forcex0", "forcey0",
                                      "massC", "massU", "massV")})
    u, v, (s1, s2, s12) = ice.uIce, ice.vIce, ice.sigma
    for name, si in case.si.items():
        label = "" if name == "aEVP" else f"({name})"
        setup = si.evp_setup(ice, d["massU"], d["massV"])
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
        rk = si.evp(ice, *dyn)
        rp = si.evp(ice, *dyn, impl="plain")
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
    plain0 = (kpp_mod.plain_calls + seaice_mod.plain_calls
              + glue_plain_calls())
    state, sec = run(state1, 1, 5, None)
    launches = dict(kernels.launches)
    plain = (kpp_mod.plain_calls + seaice_mod.plain_calls
             + glue_plain_calls() - plain0)
    print(f"warm-up step: {sec_w * 1e3:.1f} ms")
    print(f"kernel path ({smi}): 5 steps, {sec * 1e3 / 5:.2f} ms/step, "
          f"{points * 5 / sec:.4e} points*steps/s, {nsub} EVP subcycles "
          f"a step, no host read inside the loop")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB; plain KPP, sea-ice and D-G calls {plain}; launches "
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
    arrays, bit for bit (tol 0), with times and bounds; every variant of
    the main paths (AB-2 cold start and later, AB-3, with and without the
    tracer's AB, the non-hydrostatic flags on the box). kernels_only: the
    kernels to hold (the box runs E and G alone)."""
    import torch.nn.functional as F

    from mitgcm_tpu_torch.model import step, thermodynamics as th
    from mitgcm_tpu_torch.model.mom_fluxform import MomTend
    from mitgcm_tpu_torch.model.phihyd import calc_phi_hyd
    from mitgcm_tpu_torch.ops.stencil import cyclic_fill_halo

    cfg, g, t = case.cfg, case.grid, case.t3
    want = set(kernels_only or GLUE_KERNELS)
    nh = cfg.nonHydrostatic

    def hold(name, fn, call=True):
        outs, wants = fn(None), fn("plain")
        exact_compare(name, case, outs, wants,
                      cuda_time_ms(lambda: fn(None), reps),
                      cuda_time_ms(lambda: fn("plain"), reps), results,
                      call=(lambda: fn(None)) if call else None,
                      touched=None if call else outs)

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
            # hold timed a wrapper call. F and F.pad on the device: 20
            # calls in a CUDA graph, replayed (the JSON line's), and CUDA
            # events around F's launch replayed back to back and around a
            # batch of F.pad calls, which hold the host's enqueue where the
            # card is the faster (a 2-D fill)
            r = results[label]
            wrapper_ms = r["ms"]
            events_ms = launch_ms(lambda: fill(None), "halo_fill", reps)
            pad_events_ms = batch_ms(pad, reps)
            r["ms"] = graph_ms(lambda: fill(None), reps)
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
        hold("cg2d_rhs" + ("(non-hydrostatic)" if nh else ""),
             lambda impl: list(step.cg2d_rhs(cfg, g, case.u, case.v,
                                             case.eta, hydrostatic=not nh,
                                             impl=impl)))
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
                                       t["guExt"], t["gvExt"], it, impl=impl,
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
    glue_kernel_phase(GlueCase(64, 4, torch.float64), results, 20)
    glue_kernel_phase(GlueCase(64, 4, torch.float64, vi=True), results, 20,
                      ("mom_ab_step", "tracer_step"))
    glue_kernel_phase(GlueCase(64, 12, torch.float64, nh=True), results, 20,
                      ("cg2d_rhs", "mom_ab_step", "mom_correction"))
    # the box's E and G at 1024x1024x50 (its grid is phase 12's), then the
    # gyre's at the main path's shapes, last, for the JSON line
    glue_kernel_phase(GlueCase(1024, 50, torch.float32, nh=True), results,
                      10, ("cg2d_rhs", "continuity", "mom_ab_step",
                           "mom_correction"))
    GRIDS.clear()
    torch.cuda.empty_cache()
    glue_kernel_phase(GlueCase(1024, 32, torch.float32, vi=True), results,
                      10, ("mom_ab_step", "tracer_step"))
    glue_kernel_phase(GlueCase(1024, 32, torch.float32), results, 10)
    GRIDS.clear()
    torch.cuda.empty_cache()


def glue_bounds(smi):
    """The bytes-over-bandwidth bound of each row of GLUE_FIELDS at
    1024x1024x32 float32 (padded by 2 halo cells)."""
    phase("plain glue and row H: bounds at 1024x1024x32 float32")
    n2 = (1024 + 4) ** 2 * 4
    for row, (f3, f2) in GLUE_FIELDS.items():
        nbytes = (f3 * 32 + f2) * n2
        print(f"{row}: {f3} 3-D + {f2} 2-D fields, {nbytes / 1e9:.3f} GB, "
              f"bound {nbytes / PEAK_BYTES_S * 1e3:.4f} ms ({smi})")


def main():
    smi = device_phase()
    sys.path.insert(0, ROOT)
    from mitgcm_tpu_torch import kernels

    build_phase(kernels)
    count_cg2d_reads()
    phase("3 kernels vs plain twins")
    # the JSON summary reports the main path's shapes (the second case)
    results = {}
    kernel_phase(Case(64, 4, torch.float64), results, reps=20)
    kernel_phase(Case(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
    parity_phase()
    launches = full_phase(kernels)
    torch.cuda.empty_cache()
    phase("6 adjoint")
    vjp_phase(Case(64, 4, torch.float64), results, reps=20)
    vjp_phase(Case(1024, 32, torch.float32), results, reps=10)
    torch.cuda.empty_cache()
    grdchk_phase()
    adj_launches = adjoint_full_phase(kernels)
    for name in BACKWARD_KERNELS:
        launches[name] = adj_launches[name]
    vi_launches = vi_phase(kernels, results)
    for name in VI_KERNELS:
        launches[name] = vi_launches[name]
    # no later phase runs the uniform levels: free their grid, so that
    # each phase's peak memory holds no other configuration's grid
    GRIDS.clear()
    kpp_launches = kpp_phase(kernels, results, smi)
    for name in KPP_KERNELS:
        launches[name] = kpp_launches[name]
    g9_launches = g9_phase(kernels, results, smi)
    for name in G9_KERNELS + MD_KERNELS:
        launches[name] = g9_launches[name]
    launches.update(ho_phase(kernels, results, smi))
    launches.update(ism_phase(kernels, results, smi))
    GRIDS.clear()
    launches.update(nh_phase(kernels, results, smi))
    launches.update(ice_phase(kernels, results, smi))
    glue_phase(results)
    launches.update(evp_phase(kernels, results, smi))
    launches.update(gm_phase(kernels, results, smi))
    glue_bounds(smi)
    jax_pkg = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "mitgcm_tpu" or m.startswith("mitgcm_tpu.")]
    if jax_pkg:
        raise AssertionError(f"the port imported {jax_pkg}")

    summary = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name],
                **{k: results[name][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")},
                **results[name].get("extra", {})}
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
