"""The port's receding-horizon MPC (``baselines/mpc_jellyfish.py``,
Adam) against the JAX package on the CPU through tiny surrogates (UNet2Dv2
simulator and bd-updater, ForceUNet; dim 8, mults (1,), 8x8 frames), JAX's
initial plan fed in. Apart from test_torch_port_mpc.py because JAX's
compile of the whole receding-horizon program takes ~20 s.

Tolerance (max |port - jax| <= rtol * max(1, max |jax|)): 1e-4 on thetas,
states and forces; each replanning iteration differentiates through up to
num_t steps of three nets (float32 sums in another order, ~1e-6 a
forward), and Adam moves a theta by ~lr = 5e-2 a step, so a wrong term is
~500 times the limit.
"""

import jax.numpy as jnp
import torch

from diffphycon_tpu.baselines import mpc_jellyfish as jmpc
from diffphycon_tpu_torch.baselines import mpc_jellyfish as tmpc
from test_torch_port_mpc import _t, _theta_plan0, surrogate_pipelines
from torch_port_helpers import assert_close


def test_port_mpc_receding_horizon_matches_jax_on_surrogates():
    """frames 4, 2 iterations per replan."""
    jppl, tppl, s0, b0, th0 = surrogate_pipelines()
    ref = jmpc.mpc_receding_horizon(jppl, jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(th0),
                                    frames=4, num_iters=2, lr=0.05, lamda=1.0)
    out = tmpc.mpc_receding_horizon(tppl, _t(s0), _t(b0), _t(th0), frames=4, num_iters=2,
                                    lr=0.05, lamda=1.0, theta_plan0=_t(_theta_plan0(2, 3)))
    for o, r in zip(out, ref):
        assert torch.isfinite(o).all()
        assert_close(o, r, 1e-4)
