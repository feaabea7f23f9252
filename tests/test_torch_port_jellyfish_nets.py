"""The port's jellyfish surrogate nets against the JAX package on the CPU,
at a small size (dim 8, mults (1, 2), 16x16 frames): ``WSConv2d``,
``UNet2Dv2`` and ``ForceUNet`` with weights carried from flax trees (and
back through the JAX converter), and the surrogate files (torch, the
flax-npz route, an orbax directory). Every net of the port runs its conv
backward, and a checkpointed block's recompute, with cuDNN's TF32 off.

Tolerance: one net forward 1e-5 (max |port - jax| <= rtol * max(1, max
|jax|)), float32 sums in another order (conv, GroupNorm, LayerNorm and
attention reductions; the weight standardisation).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from diffphycon_tpu.nets import unet2dv2 as jnets
from diffphycon_tpu_torch.nets.unet2d import UNet2D
from diffphycon_tpu_torch.nets.unet2dv2 import ForceUNet, UNet2Dv2, WSConv2d
from diffphycon_tpu_torch.nets.unet3d import UNet3D
from diffphycon_tpu_torch.training import surrogates as tsur
from diffphycon_tpu_torch.utils import convert
from torch_port_helpers import assert_close, flax_tree, rand

SMALL = dict(dim=8, dim_mults=(1, 2))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_port_wsconv_matches_jax():
    x = rand(2, 16, 16, 5, seed=0)
    conv = jnets.WSConv(12)
    params = flax_tree(conv, jnp.zeros((1, 16, 16, 5)), seed=1)
    ref = conv.apply(params, jnp.asarray(x))
    port = WSConv2d(5, 12, 3, padding=1)
    sd = {}
    convert._conv(params["params"], "c", sd)
    port.weight.data = _t(sd["c.weight"])
    port.bias.data = _t(sd["c.bias"])
    with torch.no_grad():
        out = port(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert_close(out, ref, 1e-5)


@pytest.mark.parametrize("channels,out_dim", [(3, 3), (6, 3)])
def test_port_unet2dv2_matches_jax(channels, out_dim):
    """The bd-updater (3 -> 3) and simulator (6 -> 3) shapes, with a float
    theta-delta as the time input."""
    net = jnets.UNet2Dv2(out_dim=out_dim, channels=channels, **SMALL)
    params = flax_tree(net, jnp.zeros((1, 16, 16, channels)), jnp.zeros((1,)), seed=channels)
    x = rand(3, 16, 16, channels, seed=channels)
    delta = np.array([0.3, -0.7, 0.05], np.float32)
    ref = net.apply(params, jnp.asarray(x), jnp.asarray(delta))
    port = convert.load_flax_unet2dv2(
        UNet2Dv2(out_dim=out_dim, channels=channels, **SMALL), params).eval()
    with torch.no_grad():
        out = port(_t(x), _t(delta))
    assert_close(out, ref, 1e-5)
    # and back through the JAX package's converter of the reference keys: the
    # same values (XLA's CPU sums of the transposed copies differ by ~1 ulp)
    from diffphycon_tpu.utils.torch_convert import convert_unet2dv2

    back = convert_unet2dv2(port.state_dict(), num_levels=2)
    assert_close(_t(net.apply({"params": back}, jnp.asarray(x), jnp.asarray(delta))), ref, 1e-6)


def test_port_force_unet_matches_jax():
    net = jnets.ForceUNet(channels=4, **SMALL)
    params = flax_tree(net, jnp.zeros((1, 16, 16, 4)), seed=5)
    x = rand(3, 16, 16, 4, seed=6)
    ref = net.apply(params, jnp.asarray(x))
    port = convert.load_flax_force_unet(ForceUNet(channels=4, **SMALL), params).eval()
    with torch.no_grad():
        out = port(_t(x))
    assert out.shape == (3, 1)
    assert_close(out, ref, 1e-5)


def test_port_surrogate_files(tmp_path):
    """params.pt round trip; a flax-path npz of a JAX tree loads; an orbax
    directory raises and names the npz route."""
    net = jnets.ForceUNet(channels=4, **SMALL)
    params = flax_tree(net, jnp.zeros((1, 16, 16, 4)), seed=21)
    port = convert.load_flax_force_unet(ForceUNet(channels=4, **SMALL), params)
    x = rand(2, 16, 16, 4, seed=22)
    state = tsur.SurrogateState(port, [p.detach().clone() for p in port.parameters()], None)
    tsur.save_surrogate(state, str(tmp_path), "force")
    with torch.no_grad():
        ref = port(_t(x))
        again = tsur.load_surrogate(str(tmp_path), "force", ForceUNet(channels=4, **SMALL),
                                    device="cpu")
        assert torch.equal(again(_t(x)), ref)
        (tmp_path / "npz").mkdir()
        convert.save_flax_npz(tmp_path / "npz" / "force.npz", params)
        from_npz = tsur.load_surrogate(str(tmp_path / "npz"), "force",
                                       ForceUNet(channels=4, **SMALL), device="cpu")
        assert torch.equal(from_npz(_t(x)), ref)
    (tmp_path / "orbax" / "force" / "_CHECKPOINT_METADATA").parent.mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="save_flax_npz"):
        tsur.load_surrogate(str(tmp_path / "orbax"), "force", ForceUNet(channels=4, **SMALL),
                            device="cpu")


_TF32_CASES = {
    "unet3d_remat_all": lambda: (UNet3D(dim=8, dim_mults=(1, 2), channels=3, remat_all=True),
                                 (rand(1, 4, 8, 8, 3), np.array([3.0]))),
    "unet2dv2": lambda: (UNet2Dv2(channels=3, out_dim=3, **SMALL),
                         (rand(2, 16, 16, 3), np.array([0.1, -0.2]))),
    "force_unet": lambda: (ForceUNet(channels=4, **SMALL), (rand(2, 16, 16, 4),)),
    "unet2d": lambda: (UNet2D(dim=8, dim_mults=(1, 2)), (rand(1, 16, 32, 2), np.array([5.0]))),
}


@pytest.mark.parametrize("name", sorted(_TF32_CASES))
def test_port_conv_backward_runs_without_tf32(name):
    """cuDNN's TF32 switch is process-wide, and autograd reads it when it runs
    a conv's backward or a checkpointed block's recompute, after the forward
    has returned. Each net clears it in its forward, so with the caller's
    switch at PyTorch's default (on) every conv, recomputes included, and
    every conv weight gradient still sees it off."""
    net, inputs = _TF32_CASES[name]()
    convs = [m for m in net.modules()
             if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d))]
    runs, grads = [], []
    for m in convs:
        m.register_forward_pre_hook(lambda *_: runs.append(torch.backends.cudnn.allow_tf32))
        m.weight.register_hook(lambda g: grads.append(torch.backends.cudnn.allow_tf32))
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        net(*(torch.from_numpy(a) for a in inputs)).square().sum().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert len(grads) == len(convs)
    assert not any(runs) and not any(grads)
    if name == "unet3d_remat_all":  # the ResnetBlocks' convs ran again in the backward
        assert len(runs) > len(convs)
