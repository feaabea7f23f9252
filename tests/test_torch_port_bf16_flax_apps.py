"""``infer_burgers --bf16 True`` (default ``--impl xla``: the flax
``dtype=bfloat16`` UNet2D) in the port and in the JAX package on the same
tiny weights (dim 8, mults (1, 2), two models, u0/uT, wu 1000), 3 DDIM
steps at eta 0 from JAX's x_T (fed to the port's sampler).

The grid: full or partial observation (``--partially_observed
front_rear_quarter``) by full or partial control (``--partial_control
front_rear_quarter``): FOFC, FOPC, POFC, POPC, each under ``--bf16 True``
and in float32.

Tolerance: APP_RTOL 5e-2 on J and the control energy under bf16 (measured
2.2e-3 to 4.7e-3), the whole-net bound of
``tests/test_torch_port_bf16_flax_unet2d.py`` (the nets' rounding flips,
then three DDIM steps from x_T); FP32_APP_RTOL 1e-5 in float32 (measured
7e-8 to 5.3e-7: the same sums in another order, through three guided steps
and the solver).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from torch_port_helpers import flax_tree

APP_RTOL = 5e-2
FP32_APP_RTOL = 1e-5
SHAPE = (2, 16, 32, 2)
QUARTER = "front_rear_quarter"
CELLS = {"FOFC": [], "FOPC": ["--partial_control", QUARTER],
         "POFC": ["--partially_observed", QUARTER],
         "POPC": ["--partially_observed", QUARTER, "--partial_control", QUARTER]}


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_flax_bf16_infer_app_matches_jax(tmp_path, monkeypatch, cell, dtype):
    """``infer_burgers --bf16 True`` (default ``--impl xla``), and the
    float32 app, in both packages on the same tiny weights (two models,
    u0/uT, wu 1000), 3 DDIM steps at eta 0 from JAX's x_T (fed to the port's
    sampler), under full or partial observation and control: J and the
    energy within APP_RTOL (bf16) or FP32_APP_RTOL. In the FOFC cell,
    ``--impl pallas --bf16 True`` (the weight-only packs) gives other rows,
    and in float32 the two impls are one path, bit for bit."""
    import apps.infer_burgers as japp
    from diffphycon_tpu.training import Trainer as JaxTrainer
    from diffphycon_tpu_torch.apps import infer_burgers
    from diffphycon_tpu_torch.diffusion import core
    from diffphycon_tpu_torch.utils.convert import save_flax_npz

    jnet = JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2, resnet_block_groups=1,
                     dtype=jnp.bfloat16)
    trees = [flax_tree(jnet, jnp.zeros(SHAPE), jnp.zeros((2,)), seed=s) for s in (11, 12)]
    monkeypatch.setattr(JaxTrainer, "load_params", staticmethod(
        lambda folder, step, use_ema=True: trees["burgers_w" in str(folder)]))
    npz = [str(tmp_path / f"m{i}.npz") for i in range(2)]
    for path, tree in zip(npz, trees):
        save_flax_npz(path, tree)
    common = ["--dim", "8", "--dim_mults", "1", "2", "--synthetic_data", "2",
              "--n_test_samples", "2", "--batch_size", "2", "--eval_two_models", "True",
              "--wus", "1000", "--is_condition_u0", "True", "--is_condition_uT", "True",
              "--using_ddim", "True", "--ddim_sampling_steps", "3", "--ddim_eta", "0",
              "--exp_id__model_w", "w", "--data_root", str(tmp_path / "data")]
    mode = (["--bf16", "True"] if dtype == "bf16" else []) + CELLS[cell]
    ref = japp.main(japp.build_parser().parse_args(
        common + mode + ["--save_file", str(tmp_path / "jax.json")]))

    def jax_x_t(self, batch_size, generator):  # JAX's draw for batch i (the seed)
        k0 = jax.random.split(jax.random.PRNGKey(generator.initial_seed()))[1]
        return torch.from_numpy(np.array(jax.random.normal(
            k0, (batch_size,) + tuple(self.sample_shape), jnp.float32)))

    monkeypatch.setattr(core.GaussianDiffusion, "sample_init", jax_x_t)

    def port(*extra):
        rows = infer_burgers.main(infer_burgers.build_parser().parse_args(
            common + ["--device", "cpu", "--params_npz", npz[0], "--params_npz__model_w",
                      npz[1], "--save_file", str(tmp_path / "port.json"), *extra]))
        row = rows["wu=1000.0,wf=0.0"]
        row.pop("walltime_s")
        return row

    flax_row = port(*mode)
    want = ref["wu=1000.0,wf=0.0"]
    rtol = APP_RTOL if dtype == "bf16" else FP32_APP_RTOL
    for k in ("J_actual_mse", "control_energy"):
        assert flax_row[k] == pytest.approx(want[k], rel=rtol), (k, flax_row[k], want[k])
    if cell == "FOFC" and dtype == "bf16":
        assert port("--bf16", "True", "--impl", "pallas") != flax_row
        assert port("--impl", "pallas") == port()
