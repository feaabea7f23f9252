from diffphycon_tpu_torch.diffusion.conditioning import (
    burgers_cond_spec,
    get_proj_ep_orthogonal,
    smoke_cond_spec,
    smoke_derive_cond,
)
from diffphycon_tpu_torch.diffusion.core import (
    CondSpec,
    DiffusionConstants,
    GaussianDiffusion,
    GuidanceSpec,
)
from diffphycon_tpu_torch.diffusion.schedules import make_guidance_schedule

__all__ = [
    "CondSpec", "DiffusionConstants", "GaussianDiffusion", "GuidanceSpec",
    "burgers_cond_spec", "get_proj_ep_orthogonal",
    "make_guidance_schedule", "smoke_cond_spec", "smoke_derive_cond",
]
