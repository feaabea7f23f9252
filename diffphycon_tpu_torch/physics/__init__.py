from diffphycon_tpu_torch.physics.burgers import (
    burgers_solve,
    burgers_solve_paired,
    make_burgers_data,
)

__all__ = ["burgers_solve", "burgers_solve_paired", "make_burgers_data"]
