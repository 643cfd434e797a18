"""mitgcm_tpu_torch — the PyTorch + CUDA port of mitgcm_tpu.

The port runs the model's main path (the synthetic wind-driven gyre of
`utils/synthetic.py` stepped by `model/step.py:forward_step`) on an NVIDIA
GPU. Layout, public names and the halo-padded [nr, ny+2*oly, nx+2*olx]
field layout mirror the JAX package, which stays in the repository as the
reference the port is tested against.

Plain tensor code is PyTorch. The heaviest computations of the step (the
cg2d PCG iteration, the flux-form and vector-invariant momentum
tendencies, the tracer tendency, the implicit vertical column solve and
the nonlinear equation of state) and the adjoint's backward kernels are
hand-written CUDA kernels under `kernels/csrc/`, each with a plain
PyTorch twin beside its wrapper. A wrapper runs the twin for CPU tensors
and the kernel for CUDA tensors; it never falls back.

The package imports neither jax nor anything of the JAX package: it keeps
its own copies of the JAX-free host modules it needs (`core/config.py`,
`core/nml.py`, `io/mds.py`). Its entry points (`utils/synthetic.py`'s
set-ups, `core/grid.py:build_grid`, `utils/convert.py`) put their tensors on
the CUDA device unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
