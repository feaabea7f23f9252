"""Reference-checkpoint ingestion (``utils/convert.py``): a reference
Trainer file ({step, model, opt, ema, scaler, loss}; the UNet under
``model.``, its EMA under ``ema_model.model.``, the diffusion's schedule
buffers beside them) written with ``torch.save`` from seeded port weights,
then loaded through the port and through the JAX package's
``load_reference_checkpoint_unet2d`` / ``_unet3d``.

Tolerances: the loaded weights are bit-equal to the written ones; the
port's forward and the JAX forward on the loaded weights agree to 1e-5 of
max(1, max |jax|) (float32 sums in another order, ~1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffphycon_tpu.nets.unet2d import UNet2D as JaxUNet2D
from diffphycon_tpu.nets.unet3d import UNet3D as JaxUNet3D
from diffphycon_tpu.utils import torch_convert as jconv
from diffphycon_tpu_torch.nets import UNet2D
from diffphycon_tpu_torch.nets.init import seeded_init_
from diffphycon_tpu_torch.nets.unet3d import UNet3D
from diffphycon_tpu_torch.utils.convert import (
    extract_unet_state_dict,
    load_reference_checkpoint_unet2d,
    load_reference_checkpoint_unet3d,
)
from torch_port_helpers import assert_close, rand


def _seeded(make, seed):
    return seeded_init_(make(), torch.Generator().manual_seed(seed)).eval()


def _write_reference(path, online, ema, with_ema=True):
    model = {f"model.{k}": v for k, v in online.state_dict().items()}
    model.update({"betas": torch.linspace(1e-4, 0.02, 10), "alphas_cumprod": torch.ones(10)})
    ema_sd = {}
    if with_ema:
        ema_sd = {"initted": torch.tensor(True), "step": torch.tensor(3)}
        ema_sd.update({f"online_model.model.{k}": v for k, v in online.state_dict().items()})
        ema_sd.update({f"ema_model.model.{k}": v for k, v in ema.state_dict().items()})
    torch.save({"step": 3, "model": model, "opt": {}, "ema": ema_sd, "scaler": None,
                "loss": 0.1}, path)


def _equal(module, ref):
    sd = module.state_dict()
    return all(torch.equal(v, sd[k]) for k, v in ref.state_dict().items())


CASES = {
    "unet2d": dict(
        make=lambda: UNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2),
        jax_net=lambda: JaxUNet2D(dim=8, dim_mults=(1, 2), channels=2, out_dim=2),
        port_load=load_reference_checkpoint_unet2d,
        jax_load=lambda p, ema: jconv.load_reference_checkpoint_unet2d(p, 2, ema),
        x=(2, 16, 128, 2)),
    "unet3d": dict(
        make=lambda: UNet3D(dim=8, dim_mults=(1, 2), channels=6, out_dim=6),
        jax_net=lambda: JaxUNet3D(dim=8, dim_mults=(1, 2), channels=6, out_dim=6,
                                  resnet_groups=8),
        port_load=load_reference_checkpoint_unet3d,
        jax_load=lambda p, ema: jconv.load_reference_checkpoint_unet3d(p, 2, ema),
        x=(2, 4, 16, 16, 6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("use_ema", [True, False])
def test_port_reference_checkpoint_against_jax(tmp_path, name, use_ema):
    case = CASES[name]
    online, ema = _seeded(case["make"], 0), _seeded(case["make"], 1)
    path = tmp_path / "model-3.pt"
    _write_reference(path, online, ema)
    port = case["port_load"](case["make"](), path, use_ema=use_ema).eval()
    assert _equal(port, ema if use_ema else online)
    x = rand(*case["x"], seed=2)
    t = np.array([5.0, 640.0], np.float32)
    ref = case["jax_net"]().apply(case["jax_load"](str(path), use_ema), jnp.asarray(x),
                                  jnp.asarray(t))
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(t))
    assert_close(out, ref, 1e-5)


def test_port_reference_checkpoint_without_ema(tmp_path):
    make = CASES["unet2d"]["make"]
    online, ema = _seeded(make, 0), _seeded(make, 1)
    path = tmp_path / "no-ema.pt"
    _write_reference(path, online, ema, with_ema=False)
    assert _equal(load_reference_checkpoint_unet2d(make(), path), online)
    ckpt = torch.load(path, weights_only=False)
    sd = extract_unet_state_dict(ckpt)
    assert "betas" not in sd and set(sd) == set(online.state_dict())
    # a strict load: a net of another width raises
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_reference_checkpoint_unet2d(UNet2D(dim=16, dim_mults=(1, 2)), path)
