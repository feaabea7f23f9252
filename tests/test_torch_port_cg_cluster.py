"""What the host code of K4 (the CG pressure solve, one thread-block
cluster per batch element) decides, and the arithmetic of its split
reductions, on the CPU:

- ``cg_cluster_plan``: S CTAs per element and their row bands, for given
  numbers of resident clusters (on the card they come from
  ``cudaOccupancyMaxActiveClusters``);
- ``cg_pressure_cluster_emulated`` (each element's rows cut into the plan's
  bands, every dot product and max|r| taken per band and the band partials
  summed in rank order) against ``cg_pressure_plain`` and the Pallas
  ``pallas_solve_pressure`` in interpret mode, on the 127x127 smoke domain.

Tolerances: max |port - ref| <= 1e-4 * max(1, max |ref|), as
test_torch_port_fluids.py holds the plain CG (float32 sums in another
order over ~450 dependent iterations); iteration counts within 2% (the
order of the sums can move the step where max|r| drops below the accuracy).
The kernel itself runs on the card (test_torch_port_cuda.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.physics.fluids import smoke_env as jsmoke
from diffphycon_tpu.physics.fluids.pallas_cg import pallas_solve_pressure
from diffphycon_tpu_torch.kernels import cg_pressure as kcg
from diffphycon_tpu_torch.physics.fluids import smoke_env
from torch_port_helpers import assert_close, rand

RTOL = 1e-4
ITER_RTOL = 0.02
# clusters of S CTAs resident at once: as an H100 reported them for the
# 127x127 solve, and cards that hold 7 or 8 clusters of 16
RESIDENT = {"h100": {16: 21, 8: 30, 4: 30}, "seven": {16: 7, 8: 15, 4: 30},
            "eight": {16: 8, 8: 16, 4: 33}}


@pytest.fixture(scope="module")
def smoke_solve():
    """The smoke domain's coefficients, a batch of 2 divergences (the second
    zero: it starts converged) and the Pallas solution of the first."""
    div = np.stack([rand(127, 127, seed=11), np.zeros((127, 127), np.float32)])
    jc = jsmoke.smoke_domain_128().laplacian_coeffs()
    ref = pallas_solve_pressure(jnp.asarray(div), jc, accuracy=1e-6, max_iterations=500,
                                interpret=True)
    tc = smoke_env.smoke_domain_128().laplacian_coeffs("cpu")
    plain, plain_iters = kcg.cg_pressure_plain(torch.from_numpy(div), tc, 1e-6, 500)
    return tc, torch.from_numpy(div), np.asarray(ref), plain, plain_iters


@pytest.mark.parametrize("ranks", [1, 4, 8, 16])
def test_port_cg_cluster_emulation_matches_plain_and_pallas(smoke_solve, ranks):
    coeffs, div, ref, plain, plain_iters = smoke_solve
    out, iters = kcg.cg_pressure_cluster_emulated(div, coeffs, 1e-6, 500, ranks)
    assert_close(out, plain, RTOL)
    assert_close(out, ref, RTOL)
    gap = abs(int(iters[0]) - int(plain_iters[0]))
    assert 0 < int(iters[0]) < 500 and gap <= ITER_RTOL * int(plain_iters[0]), (iters, plain_iters)


def test_port_cg_cluster_element_that_starts_converged_runs_no_iteration(smoke_solve):
    """Termination is per element: the zero divergence beside an iterating
    one runs 0 iterations and stays 0, in the emulation and the plain CG."""
    coeffs, div, _, plain, plain_iters = smoke_solve
    out, iters = kcg.cg_pressure_cluster_emulated(div, coeffs, 1e-6, 500, 8)
    assert int(iters[1]) == 0 and int(plain_iters[1]) == 0
    assert int(iters[0]) > 0
    assert torch.equal(out[1], torch.zeros_like(out[1])) and torch.equal(plain[1], out[1])


def _check_plan(plan, B, H, W, resident):
    S = plan.cluster
    assert S in kcg.CG_CLUSTERS and S <= H
    rows = [r for r0, r1 in plan.bands for r in range(r0, r1)]
    assert rows == list(range(H)), "the bands cover every row exactly once, in rank order"
    assert len(plan.bands) == S
    assert all(1 <= r1 - r0 <= math.ceil(H / S) for r0, r1 in plan.bands)
    assert max(r1 - r0 for r0, r1 in plan.bands) * W <= kcg.CG_BAND_CELLS
    assert plan.waves == math.ceil(B / resident[S])
    fits = [s for s in kcg.CG_CLUSTERS if s <= H and math.ceil(H / s) * W <= kcg.CG_BAND_CELLS]
    one_wave = [s for s in fits if B <= resident[s]]
    if one_wave:  # the largest S whose B clusters are all resident
        assert S == max(one_wave) and plan.waves == 1
    else:  # the most clusters per wave
        assert S == min(fits) and plan.waves > 1


@pytest.mark.parametrize("card", sorted(RESIDENT))
@pytest.mark.parametrize("B", [1, 8, 20])
def test_port_cg_cluster_plan_bands_and_one_wave(card, B):
    resident = RESIDENT[card]
    for H, W in [(127, 127), (63, 63), (128, 128), (16, 1024), (5, 3276), (4, 4096)]:
        _check_plan(kcg.cg_cluster_plan(B, H, W, resident.__getitem__), B, H, W, resident)
    plan = kcg.cg_cluster_plan(B, 127, 127, resident.__getitem__)
    want = {("h100", 1): 16, ("h100", 8): 16, ("h100", 20): 16, ("seven", 1): 16,
            ("seven", 8): 8, ("seven", 20): 4, ("eight", 1): 16, ("eight", 8): 16,
            ("eight", 20): 4}
    assert plan.cluster == want[card, B]
    assert plan.waves == 1


def test_port_cg_cluster_plan_waves_and_refusals():
    """Batches above one wave run in more waves of the smallest cluster; a
    size the card cannot hold at all is never chosen; domains the bands
    cannot take are refused (the wrapper raises before any launch)."""
    resident = RESIDENT["h100"].__getitem__
    plan = kcg.cg_cluster_plan(100, 127, 127, resident)
    assert plan.cluster == 4 and plan.waves == 4
    no16 = {16: 0, 8: 16, 4: 30}.__getitem__
    assert kcg.cg_cluster_plan(1, 127, 127, no16).cluster == 8
    # every domain of up to 16384 cells with at least 4 rows fits
    for H, W in [(4, 4096), (5, 3276), (7, 2340), (64, 256), (128, 128)]:
        kcg.cg_cluster_plan(1, H, W, resident)
    assert kcg.cg_cluster_plan(1, 256, 512, resident).cluster == 16  # 131072 cells
    for H, W in [(3, 100), (8, 8193), (256, 520)]:
        with pytest.raises(ValueError, match="does not fit the kernel"):
            kcg.cg_cluster_plan(1, H, W, resident)
    with pytest.raises(ValueError, match="holds no cluster"):
        kcg.cg_cluster_plan(1, 127, 127, lambda S: 0)
