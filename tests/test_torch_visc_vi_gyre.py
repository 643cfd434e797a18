"""PyTorch port: 10 steps of the visc-vi-gyre (the vi-gyre with the visc-gyre's variable and
biharmonic viscosities under full Leith), 16x16x4 on halos of 4,
against the JAX package in float64 on the CPU, to the bars of
tests/test_torch_visc_gyre.py."""

from test_torch_visc_gyre import ten_steps


def test_ten_steps():
    ten_steps("visc-vi-gyre")
