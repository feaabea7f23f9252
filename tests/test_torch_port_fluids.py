"""The port's fluid solver against the JAX package: staggered-grid ops, the
masked Laplacian, the CG pressure solve (plain version of K4) and its
gradient, the projection, and the smoke rollouts (``smoke_solver``,
``generator_rollout`` with JAX's draws fed in).

Tolerances (max |port - jax| <= rtol * max(1, max |jax|)), with reasons:
- grid ops, Laplacian: 1e-5, the same float32 arithmetic in the same order;
- CG: 1e-4. Both solve to max|r| < accuracy, so the solutions differ by
  the residual left over, amplified by A^-1; the two JAX routes themselves
  (while_loop vs the Pallas kernel) differ by 7.4e-6 at |p| <= 4.2 on the
  smoke domain at accuracy 1e-6. Iteration counts agree within 2%;
- rollouts: see each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.physics.fluids import grids as jgrids
from diffphycon_tpu.physics.fluids import pressure as jpressure
from diffphycon_tpu.physics.fluids import smoke_env as jsmoke
from diffphycon_tpu.physics.fluids.pallas_cg import pallas_solve_pressure
from diffphycon_tpu_torch.kernels import cg_pressure as kcg
from diffphycon_tpu_torch.physics.fluids import grids, pressure, smoke_env
from torch_port_helpers import assert_close, rand

# the obstacle list of tests/test_fluids_golden.py (64x64 open domain)
OBSTACLES = [(10, 12, 3, 20), (34, 40, 12, 2), (50, 5, 2, 30)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _stag(b=2, n=32, seed=0):
    return 0.5 * rand(b, n + 1, n + 1, 2, seed=seed)


@pytest.mark.parametrize("op", ["divergence", "gradient", "centers", "faces_x",
                                "faces_y", "resample", "advect"])
def test_port_grid_ops(op):
    s = _stag()
    f = rand(2, 32, 32, 3, seed=1)
    if op == "divergence":
        ref, out = jgrids.staggered_divergence(jnp.asarray(s)), grids.staggered_divergence(_t(s))
    elif op == "gradient":
        ref = jgrids.staggered_gradient(jnp.asarray(f[..., :1]))
        out = grids.staggered_gradient(_t(f[..., :1]))
    elif op == "centers":
        ref, out = jgrids.staggered_at_centers(jnp.asarray(s)), grids.staggered_at_centers(_t(s))
    elif op.startswith("faces"):
        d = 0 if op == "faces_x" else 1
        ref = jgrids.staggered_at_faces(jnp.asarray(s), d)
        out = grids.staggered_at_faces(_t(s), d)
    elif op == "resample":
        # coordinates beyond both ends exercise the clamp and the zero fill
        coords = rand(2, 20, 24, 2, seed=2) * 14 + 16
        ref = jgrids.resample_linear(jnp.asarray(f), jnp.asarray(coords))
        out = grids.resample_linear(_t(f), _t(coords))
    else:
        ref = jgrids.advect_centered(jnp.asarray(4 * s), jnp.asarray(f), dt=1.0)
        out = grids.advect_centered(_t(4 * s), _t(f), dt=1.0)
    assert_close(out, ref, 1e-5)


def test_port_domain_coeffs_mask_and_laplacian():
    jdom = jsmoke.smoke_domain_128()
    dom = smoke_env.smoke_domain_128()
    coeffs = dom.laplacian_coeffs("cpu")
    for out, ref in zip(coeffs, jdom.laplacian_coeffs()):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(dom.velocity_mask("cpu").numpy(),
                                  np.asarray(jdom.velocity_mask()))
    p = rand(2, 127, 127, seed=3)
    assert_close(kcg.masked_laplacian(_t(p), coeffs),
                 jpressure.masked_laplacian(jnp.asarray(p), jdom.laplacian_coeffs()), 1e-5)


def test_port_pack_coeffs_codes_and_refusals():
    coeffs = smoke_env.smoke_domain_64().laplacian_coeffs("cpu")
    code = coeffs.packed.long()
    center, up_y, lo_y, up_x, lo_x = coeffs
    np.testing.assert_array_equal((-(code >> 4)).float().numpy(), center.numpy())
    for bit, field in enumerate((up_y, lo_y, up_x, lo_x)):
        np.testing.assert_array_equal(((code >> bit) & 1).float().numpy(), field.numpy())
    bad = [c.clone() for c in coeffs]
    bad[0][3, 3] = -2.5
    with pytest.raises(ValueError, match="centre"):
        kcg.pack_coeffs(bad)
    bad = [c.clone() for c in coeffs]
    bad[1][3, 3] = 0.5
    with pytest.raises(ValueError, match="neighbour"):
        kcg.pack_coeffs(bad)
    with pytest.raises(ValueError, match="no kernel or plain path"):
        kcg.cg_pressure(torch.zeros(1, 63, 63, device="meta"), coeffs)


@pytest.fixture(scope="module")
def smoke_coeffs():
    return jsmoke.smoke_domain_128().laplacian_coeffs(), \
        smoke_env.smoke_domain_128().laplacian_coeffs("cpu")


def test_port_cg_matches_pallas_kernel_interpret(smoke_coeffs):
    jc, tc = smoke_coeffs
    div = rand(2, 127, 127, seed=4)
    ref = pallas_solve_pressure(jnp.asarray(div), jc, accuracy=1e-6, max_iterations=500,
                                interpret=True)
    out, iters = kcg.cg_pressure(_t(div), tc, 1e-6, 500)
    assert_close(out, ref, 1e-4)
    assert (iters > 0).all() and (iters < 500).all()


def test_port_cg_matches_while_loop_at_batch_one(smoke_coeffs):
    jc, tc = smoke_coeffs
    div = rand(1, 127, 127, seed=5)
    ref, ref_iters = jpressure._cg(jnp.asarray(div), jc, 1e-6, 500)
    out, iters = kcg.cg_pressure(_t(div), tc, 1e-6, 500)
    assert_close(out, ref, 1e-4)
    assert abs(int(iters[0]) - int(ref_iters)) <= 0.02 * int(ref_iters), (iters, ref_iters)


def test_port_cg_terminates_per_element(smoke_coeffs):
    """An element that starts converged runs no iteration while the other
    one iterates (the Pallas kernel's per-program termination)."""
    _, tc = smoke_coeffs
    div = np.stack([rand(127, 127, seed=6), np.zeros((127, 127), np.float32)])
    out, iters = kcg.cg_pressure(_t(div), tc, 1e-6, 500)
    assert int(iters[1]) == 0 and int(iters[0]) > 0
    assert float(out[1].abs().max()) == 0.0


def test_port_pressure_gradient_matches_jax_grad():
    dom_j = jpressure.FluidDomain.from_obstacles((64, 64), OBSTACLES)
    dom_t = pressure.FluidDomain.from_obstacles((64, 64), OBSTACLES)
    jc, tc = dom_j.laplacian_coeffs(), dom_t.laplacian_coeffs("cpu")
    div, w = rand(1, 64, 64, seed=7), rand(1, 64, 64, seed=8)

    def loss(d):
        return jnp.sum(jnp.sin(jpressure.solve_pressure_cg(d, jc, 1e-7, 1000, False)) * w)

    ref = jax.grad(loss)(jnp.asarray(div))
    d = _t(div).requires_grad_(True)
    (torch.sin(pressure.solve_pressure_cg(d, tc, 1e-7, 1000)) * _t(w)).sum().backward()
    assert_close(d.grad, ref, 1e-4)


def test_port_divergence_free_with_obstacles():
    s = 0.5 * rand(2, 65, 65, 2, seed=9)
    dom_j = jpressure.FluidDomain.from_obstacles((64, 64), OBSTACLES)
    dom_t = pressure.FluidDomain.from_obstacles((64, 64), OBSTACLES)
    ref = jpressure.divergence_free(jnp.asarray(s), dom_j, accuracy=1e-7,
                                    max_iterations=1000, use_pallas=False)
    out = pressure.divergence_free(_t(s), dom_t, accuracy=1e-7, max_iterations=1000)
    assert_close(out, ref, 1e-4)
    # divergence vanishes in the interior active cells (at the open boundary
    # the symmetric-padded gradient keeps some, as in the JAX package)
    div = grids.staggered_divergence(out)[..., 0] * _t(dom_t.active)
    assert float(div[:, 1:-1, 1:-1].abs().max()) < 1e-5


def _smoke_inputs(b=2, nt=4, seed=10):
    d0 = np.zeros((b, 64, 64), np.float32)
    d0[:, 10:16, 28:36] = 1.0
    c1 = 0.5 * rand(b, nt, 64, 64, seed=seed)
    c2 = 2.0 + 0.5 * rand(b, nt, 64, 64, seed=seed + 1)
    v0 = np.zeros((b, 128, 128, 2), np.float32)
    v0[..., 1] = 0.8
    return v0, d0, c1, c2


@pytest.mark.parametrize("accuracy,max_iterations,rtol", [
    # every solve stops at the 20-iteration cap on both sides: same
    # arithmetic, float32 rounding only
    (1e-8, 20, 1e-5),
    # converged solves: the JAX while_loop stops on the batch-wide max|r|,
    # the port per element, so each element's pressure differs by up to the
    # 1e-6 residual times A^-1 (observed 1.1e-5 relative in the velocity,
    # 2.2e-5 in the density); advection carries that into the densities
    (1e-6, 500, 5e-5),
])
def test_port_smoke_solver(accuracy, max_iterations, rtol):
    v0, d0, c1, c2 = _smoke_inputs()
    jsim = jsmoke.SmokeSim.create(accuracy=accuracy, max_iterations=max_iterations)
    tsim = smoke_env.SmokeSim.create(accuracy=accuracy, max_iterations=max_iterations,
                                     device="cpu")
    ref = jsmoke.smoke_solver(jsim, jnp.asarray(v0), jnp.asarray(d0), jnp.asarray(c1),
                              jnp.asarray(c2), num_t=4)
    out = smoke_env.smoke_solver(tsim, _t(v0), _t(d0), _t(c1), _t(c2), num_t=4)
    assert set(out) == set(ref)
    for k in ref:
        assert_close(out[k], ref[k], rtol)


def test_port_generator_rollout_with_jax_draws():
    b, steps = 2, 4
    d0 = np.zeros((b, 128, 128), np.float32)
    d0[:, 26:36, 60:70] = 1.0
    seg_v = np.tile(np.array([[1.5, 3.0], [0.5, 2.0], [-0.5, 2.5], [0.1, 1.0]],
                             np.float32), (b, 1, 1))
    seg_starts = np.tile(np.array([0, 2, 3, 7], np.int32), (b, 1))
    key = jax.random.PRNGKey(0)
    jsim = jsmoke.SmokeSim.create(accuracy=1e-8, max_iterations=20)
    ref = jsmoke.generator_rollout(jsim, key, jnp.asarray(d0), jnp.asarray(seg_v),
                                   jnp.asarray(seg_starts), initial_vy=0.8,
                                   num_steps=steps)

    def noise(t):
        kt = jax.random.fold_in(key, t)
        shape = (b, 128, 128, 2)
        return (_t(jax.random.normal(kt, shape)),
                _t(jax.random.normal(jax.random.fold_in(kt, 1), shape)))

    tsim = smoke_env.SmokeSim.create(accuracy=1e-8, max_iterations=20, device="cpu")
    out = smoke_env.generator_rollout(tsim, _t(d0), _t(seg_v), _t(seg_starts),
                                      initial_vy=0.8, num_steps=steps, noise=noise)
    assert set(out) == set(ref)
    # every solve stops at the 20-iteration cap on both sides (see
    # test_port_smoke_solver); the controls are the same draws, exactly
    for k in ref:
        assert_close(out[k], ref[k], 1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        smoke_env.generator_rollout(tsim, _t(d0), _t(seg_v), _t(seg_starts), num_steps=1)
