"""The KS solver, the Burgers graph data and staggered advection against
the JAX package.

Tolerances:
- ``ks_solve``: 10 frames x 40 ETDRK4 sub-steps at batch 2 from
  ``make_ks_data``: 1e-4 of max(1, max |jax|). Both run complex64 FFTs
  (pocketfft in JAX, torch's on the CPU) with the same float32
  coefficients; rounding differs by summation order and grows mildly over
  400 steps of a chaotic system (measured ~1e-6 here). A gradient through
  u0 and f is checked finite;
- ``make_ks_data``, ``burgers_graph_edges``, ``BurgersGraphDataset``: exact
  (the same numpy code);
- ``advect_staggered``: 1e-5, bilinear float32 arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.physics import ks as jks
from diffphycon_tpu.physics.fluids import grids as jgrids
from diffphycon_tpu.training import data as jdata
from diffphycon_tpu_torch.physics import ks
from diffphycon_tpu_torch.physics.fluids import grids
from diffphycon_tpu_torch.training import data
from torch_port_helpers import assert_close, rand


def test_port_make_ks_data_exact():
    for a, b in zip(ks.make_ks_data(3, seed=4), jks.make_ks_data(3, seed=4)):
        np.testing.assert_array_equal(a, b)


def test_port_ks_solve_against_jax():
    u0, f = ks.make_ks_data(2, seed=1)
    f = 0.1 * f
    ref = np.asarray(jks.ks_solve(jnp.asarray(u0), jnp.asarray(f)))
    out = ks.ks_solve(torch.from_numpy(u0), torch.from_numpy(f))
    assert out.shape == (2, 11, 128) and out.dtype == torch.float32
    np.testing.assert_array_equal(out[:, 0].numpy(), u0)
    assert_close(out, ref, 1e-4)
    tu0, tf = (torch.from_numpy(a).requires_grad_(True) for a in (u0, f[:, :2]))
    ks.ks_solve(tu0, tf, num_t=2, substeps=5)[:, -1].square().sum().backward()
    assert torch.isfinite(tu0.grad).all() and torch.isfinite(tf.grad).all()
    with pytest.raises(ValueError, match="do not fit"):
        ks.ks_solve(torch.from_numpy(u0), torch.from_numpy(f), num_t=3)


def test_port_etdrk4_coeffs_match_jax_casts():
    ours = ks.etdrk4_coeffs(128, 22.0, 0.025)
    ref = jks._etdrk4_coeffs(128, 22.0, 0.025)
    for a, b in zip(ours, ref):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n_nodes", [5, 128])
def test_port_burgers_graph_edges(n_nodes):
    for a, b in zip(data.burgers_graph_edges(n_nodes), jdata.burgers_graph_edges(n_nodes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("per_step_force,input_steps,output_steps,interval",
                         [(False, 1, 10, 1), (True, 2, 3, 1), (True, 1, 2, 2)])
def test_port_burgers_graph_dataset_items(per_step_force, input_steps, output_steps,
                                          interval):
    rng = np.random.default_rng(0)
    u = rng.normal(size=(3, 11, 16)).astype(np.float32)
    f = rng.normal(size=(3, 10, 16) if per_step_force else (3, 16)).astype(np.float32)
    kw = dict(input_steps=input_steps, output_steps=output_steps, time_interval=interval)
    ours, ref = data.BurgersGraphDataset(u, f, **kw), jdata.BurgersGraphDataset(u, f, **kw)
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        a, b = ours.get(i), ref.get(i)
        assert a.keys() == b.keys()
        for k in b:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"item {i} {k}")


@pytest.mark.parametrize("dt", [1.0, 0.5])
def test_port_advect_staggered(dt):
    stag = 3 * rand(2, 9, 13, 2, seed=1)
    field = rand(2, 9, 13, 2, seed=2)
    ref = jgrids.advect_staggered(jnp.asarray(stag), jnp.asarray(field), dt=dt)
    out = grids.advect_staggered(torch.from_numpy(stag), torch.from_numpy(field), dt=dt)
    assert_close(out, ref, 1e-5)
