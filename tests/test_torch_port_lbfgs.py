"""The port's L-BFGS (``baselines/lbfgs.py``) against ``optax.lbfgs`` and
receding-horizon MPC with it against the JAX package, on the CPU.

- ``lbfgs`` on a seeded nonconvex function (a Rosenbrock chain plus
  sin(A x), 12 parameters) for 10 iterations at learning rates that make
  the zoom line search accept its first trial, grow the interval for 8
  trials, and zoom back from an overshoot: the same line-search step count
  at every iteration, and the iterates within 1e-4 * max(1, max |x|)
  (float32 sums in another order move an iterate by ~1e-7 a step; the
  quasi-Newton memory carries that through the 10 iterations, ~1e-5 at
  most here). A wrong branch of the line search changes its step count or
  moves the iterate by the step size itself.
- ``mpc_receding_horizon(optimizer="lbfgs")`` on the stub pipelines of
  test_torch_port_mpc.py, JAX's initial plan fed in: thetas, states and
  forces within 1e-5 (a few elementwise ops a step, as for Adam there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffphycon_tpu.baselines import mpc_jellyfish as jmpc
from diffphycon_tpu_torch.baselines import lbfgs
from diffphycon_tpu_torch.baselines import mpc_jellyfish as tmpc
from test_torch_port_mpc import H, _inputs, _stub_pipelines, _t, _theta_plan0
from torch_port_helpers import assert_close

N = 12
_rng = np.random.default_rng(0)
A = (_rng.normal(size=(N, N)) / 3).astype(np.float32)
X0 = _rng.normal(size=N).astype(np.float32)


def _f_jax(x):
    return (jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
            + jnp.sum(jnp.sin(jnp.asarray(A) @ x)))


def _f_torch(x):
    return ((100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2).sum()
            + torch.sin(torch.from_numpy(A) @ x).sum())


@pytest.mark.parametrize("lr,trials", [(1.0, 1), (1e-3, 8), (30.0, 6)])
def test_port_lbfgs_matches_optax(lr, trials):
    """``trials``: the most line-search trials an iteration takes at this
    learning rate (1: the first step is accepted; 8: the interval grows 2^7
    fold; 6: cubic and quadratic zoom steps back from an overshoot)."""
    tx = optax.lbfgs(lr)

    @jax.jit
    def step(x, s):
        v, g = jax.value_and_grad(_f_jax)(x)
        u, s = tx.update(g, s, x, value=v, grad=g, value_fn=_f_jax)
        return optax.apply_updates(x, u), s, v

    xj = jnp.asarray(X0)
    sj = tx.init(xj)
    xt = torch.from_numpy(X0.copy())
    st = lbfgs.init(xt)
    steps = []
    for _ in range(10):
        xj, sj, vj = step(xj, sj)
        vt, gt = lbfgs.value_and_grad(_f_torch, xt)
        np.testing.assert_allclose(vt, float(vj), rtol=1e-5)
        ut, st = lbfgs.update(gt, st, xt, vt, _f_torch, learning_rate=lr)
        xt = xt + ut
        steps.append(st.num_linesearch_steps)
        assert st.num_linesearch_steps == int(sj[2].info.num_linesearch_steps)
        assert_close(xt, np.asarray(xj), 1e-4)
    assert st.count == 10
    assert _f_torch(xt) < 0.5 * _f_torch(torch.from_numpy(X0))
    assert max(steps) == trials


@pytest.mark.parametrize("coefs", [dict(lamda=0.0), dict(lamda=10.0, coef_endcondition=0.5,
                                                         coef_clip=2.0)])
def test_port_mpc_lbfgs_matches_jax_on_stubs(coefs):
    jppl, tppl = _stub_pipelines()
    s0, b0 = _inputs(5)
    th0 = np.full(2, 0.5, np.float32)
    ref = jmpc.mpc_receding_horizon(jppl, jnp.asarray(s0), jnp.asarray(b0), jnp.asarray(th0),
                                    frames=5, num_iters=4, lr=0.1, optimizer="lbfgs", **coefs)
    out = tmpc.mpc_receding_horizon(tppl, _t(s0), _t(b0), _t(th0), frames=5, num_iters=4,
                                    lr=0.1, optimizer="lbfgs",
                                    theta_plan0=_t(_theta_plan0(2, 4)), **coefs)
    assert out[0].shape == (2, 5) and out[1].shape == (2, 5, H, H, 3) and out[2].shape == (2, 5)
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-5)
    assert float(out[0][:, 1:].min()) >= 0.2 - 1e-6 and float(out[0][:, 1:].max()) <= 1.1 + 1e-6
