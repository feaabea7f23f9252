from diffphycon_tpu_torch.physics.fluids.grids import (
    advect_centered,
    resample_linear,
    staggered_at_centers,
    staggered_at_faces,
    staggered_divergence,
    staggered_gradient,
)
from diffphycon_tpu_torch.physics.fluids.pressure import (
    FluidDomain,
    divergence_free,
    masked_laplacian,
    solve_pressure_cg,
)

__all__ = [
    "FluidDomain", "advect_centered", "divergence_free", "masked_laplacian",
    "resample_linear", "solve_pressure_cg", "staggered_at_centers",
    "staggered_at_faces", "staggered_divergence", "staggered_gradient",
]
