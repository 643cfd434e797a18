"""PyTorch port: the pqm-gyre (the ggl90-gyre with theta advected by
monotone PPM, scheme 41, and salt by monotone PQM, scheme 51, in all three
directions, on halos of 4) against the JAX package, 10 steps at 16x16x12
(depth 300 m) in float64 on the CPU, JAX evaluated op by op, with the bars
of tests/test_torch_os7mp_gyre.py (measured here: statistics 13.2 digits
or more, cg2d_init_res 11.4, cg2d_last_res 15.9 against the first
residual and 9.2 as a value, fields 11.7, GGL90TKE 11.35).
"""

import torch

from mitgcm_tpu_torch.utils import synthetic as tsyn
from test_torch_os7mp_gyre import SIZE, check_high_order_gyre, run_both

torch.set_num_threads(1)


def test_pqm_gyre_ten_steps():
    cfg = tsyn.pqm_gyre_config(**SIZE)
    assert (cfg.olx, cfg.tempAdvScheme, cfg.saltAdvScheme) == (4, 41, 51)
    check_high_order_gyre(*run_both(cfg))
