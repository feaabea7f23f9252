"""The port's differentiable Burgers solver and the SL and PID baselines
against the JAX package on the CPU (the latent operator and SL through it:
test_torch_port_burgers_operator.py).

Sizes: Nx = 32 and dt = 1e-2 (100 explicit steps; the diffusion number
visc dt / dx^2 = 0.11 keeps them stable), batch 2-3.

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)):
- solver trajectory and gradients: 1e-5, float32 stencils in another
  fusion order over 100 steps (seen: ~1e-7);
- SL and PID over 3 Adam steps: 1e-5 on the J history and the result.
  Adam's first update is lr * g / (|g| + eps), so a wrong gradient term
  moves an entry by ~lr = 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.baselines.pid_burgers import pid_control as jax_pid_control
from diffphycon_tpu.baselines.sl_burgers import sl_optimize_control as jax_sl
from diffphycon_tpu.physics import burgers as jburgers
from diffphycon_tpu_torch.baselines.pid_burgers import pid_control
from diffphycon_tpu_torch.baselines.sl_burgers import sl_optimize_control
from diffphycon_tpu_torch.physics import burgers as tburgers
from torch_port_helpers import assert_close

NX, DT = 32, 1e-2


def _t(a):
    return torch.from_numpy(np.array(a))


def _problem(b=2, seed=0, num_t=10):
    u0, f = jburgers.make_burgers_data(b, s=NX, t=num_t, seed=seed)
    return u0, f


@pytest.mark.parametrize("num_t", [10, 3])  # 3: 33 steps a frame and one remainder step
def test_port_solver_forward_and_gradients_match_jax(num_t):
    u0, f = _problem(num_t=num_t)
    w = np.random.default_rng(1).normal(size=(2, num_t + 1, NX)).astype(np.float32)

    def jloss(u0, f):
        return (jburgers.burgers_solve(u0, f, T=1.0, dt=DT, num_t=num_t) * w).sum()

    ref = jburgers.burgers_solve(jnp.asarray(u0), jnp.asarray(f), T=1.0, dt=DT, num_t=num_t)
    gu_ref, gf_ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(u0), jnp.asarray(f))
    out = tburgers.burgers_solve(_t(u0), _t(f), T=1.0, dt=DT, num_t=num_t)
    assert_close(out, ref, 1e-5)
    grads = {}
    for ckpt in (True, False):
        tu, tf = _t(u0).requires_grad_(True), _t(f).requires_grad_(True)
        (tburgers.burgers_solve(tu, tf, T=1.0, dt=DT, num_t=num_t, checkpoint=ckpt)
         * _t(w)).sum().backward()
        assert_close(tu.grad, gu_ref, 1e-5)
        assert_close(tf.grad, gf_ref, 1e-5)
        grads[ckpt] = (tu.grad, tf.grad)
    # the checkpointed frames recompute the same ops: bit-equal gradients
    assert all(torch.equal(a, b) for a, b in zip(grads[True], grads[False]))
    # without grad the plain loop gives the same trajectory
    with torch.no_grad():
        assert torch.equal(tburgers.burgers_solve(_t(u0), _t(f), T=1.0, dt=DT, num_t=num_t),
                           out.detach())


def test_port_solver_paired_matches_jax():
    u0, _ = _problem(b=3, seed=2)
    _, f = _problem(b=2, seed=3)
    ref = jburgers.burgers_solve_paired(jnp.asarray(u0), jnp.asarray(f), T=1.0, dt=DT,
                                        num_t=10)
    out = tburgers.burgers_solve_paired(_t(u0), _t(f), T=1.0, dt=DT, num_t=10)
    assert out.shape == (3, 2, 11, NX)
    assert_close(out, ref, 1e-5)


def _targets(seed=4):
    u0, f = _problem(seed=seed)
    traj = np.asarray(jburgers.burgers_solve(jnp.asarray(u0), jnp.asarray(f), T=1.0, dt=DT))
    return u0, traj


@pytest.mark.parametrize("partial_control", [None, "front_rear_quarter"])
def test_port_sl_through_solver_matches_jax(partial_control):
    u0, traj = _targets()
    f_ref, hist_ref = jax_sl(jnp.asarray(u0), jnp.asarray(traj[:, -1]), lamb=1e-3, lr=5e-2,
                             steps=3, solver_dt=DT, partial_control=partial_control)
    f, hist = sl_optimize_control(_t(u0), _t(traj[:, -1]), lamb=1e-3, lr=5e-2, steps=3,
                                  solver_dt=DT, partial_control=partial_control)
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-5)
    assert hist[-1] < hist[0]
    assert_close(f, f_ref, 1e-5)
    if partial_control:
        assert float(f[:, :, NX // 4 : 3 * NX // 4].abs().max()) == 0.0


@pytest.mark.parametrize("masked", [False, True])
def test_port_pid_matches_jax(masked):
    u0, traj = _targets(seed=6)
    mask = np.zeros(NX, np.float32)
    mask[: NX // 4] = mask[3 * NX // 4 :] = 1.0
    # JAX's initial gains (pid_control's jax.random draws) fed to the port
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    gains = {k: _t(0.1 * jax.random.normal(key, (NX,)))
             for k, key in (("kp", k1), ("ki", k2), ("kd", k3))}
    ctrl_r, f_r, traj_r, hist_r = jax_pid_control(
        jnp.asarray(u0), jnp.asarray(traj), lr=5e-2, steps=3, dt=DT, seed=0, lamb=1e-3,
        control_mask=jnp.asarray(mask) if masked else None)
    ctrl, f, out, hist = pid_control(_t(u0), _t(traj), lr=5e-2, steps=3, dt=DT, lamb=1e-3,
                                     control_mask=_t(mask) if masked else None, gains=gains)
    np.testing.assert_allclose(hist, hist_r, rtol=1e-5)
    for name in ("kp", "ki", "kd"):
        assert_close(getattr(ctrl, name), getattr(ctrl_r, name), 1e-5)
    assert_close(f, f_r, 1e-5)
    assert_close(out, traj_r, 1e-5)
    if masked:
        assert float(f[:, :, NX // 4 : 3 * NX // 4].abs().max()) == 0.0
