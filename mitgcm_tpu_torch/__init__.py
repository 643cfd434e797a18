"""mitgcm_tpu_torch — the PyTorch + CUDA port of mitgcm_tpu.

The port runs the model's main path (the synthetic wind-driven gyre of
`utils/synthetic.py` stepped by `model/step.py:forward_step`) on an NVIDIA
GPU. Layout, public names and the halo-padded [nr, ny+2*oly, nx+2*olx]
field layout mirror the JAX package, which stays in the repository as the
reference the port is tested against.

Plain tensor code is PyTorch. The three heaviest computations of the step
(the cg2d PCG iteration, the flux-form momentum tendency and the tracer
tendency) are hand-written CUDA kernels under `kernels/csrc/`, each with a
plain PyTorch twin beside its wrapper. A wrapper runs the twin for CPU
tensors and the kernel for CUDA tensors; it never falls back.

The only thing taken from the JAX package is its JAX-free host config
(`mitgcm_tpu.core.config.Config`). This package never imports jax.
"""

__version__ = "0.1.0"
