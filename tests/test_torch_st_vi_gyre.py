"""PyTorch port: 10 steps of the st-vi-gyre (the vi-gyre with the strain-tension form of the
harmonic dissipation and a Smagorinsky viscosity), 16x16x4 on halos of 4,
against the JAX package in float64 on the CPU, to the bars of
tests/test_torch_visc_gyre.py."""

from test_torch_visc_gyre import ten_steps


def test_ten_steps():
    ten_steps("st-vi-gyre")
