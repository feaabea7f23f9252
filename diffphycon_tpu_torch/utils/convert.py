"""Carry UNet2D, UNet3D, UNet2Dv2, ForceUNet, Burgers operator and RL net
weights from the JAX package's parameter trees to the port.

The inverse of ``diffphycon_tpu/utils/torch_convert.py:21-253`` and
``:262-365``, and the same layouts for the baselines' nets:

- flax conv kernel (kh, kw, in, out) -> torch weight (out, in, kh, kw);
  1D (k, in, out) -> (out, in, k);
- flax ``ConvTranspose`` kernel (kh, kw, in, out), which flax correlates
  unflipped with the dilated input -> ``ConvTranspose2d`` weight (in, out,
  kh, kw), flipped in both spatial dims (torch flips it back);
- Dense kernel (in, out) -> Linear weight (out, in);
- GroupNorm scale/bias -> weight/bias;
- ChanLayerNorm g (C,) -> (1, C, 1, 1).

The tree is nested dicts of numpy arrays (``{'params': ...}`` or the inner
dict). ``save_flax_npz`` / ``load_flax_npz`` store the same tree flat, one
array per '/'-joined flax path; that file is what the port's
``apps/infer_burgers.py --params_npz`` reads.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _conv(tree, name: str, sd: Dict[str, np.ndarray]) -> None:
    sd[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1))
    if "bias" in tree:
        sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _linear(tree, name, sd):
    sd[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"]))
    sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _groupnorm(tree, name, sd):
    sd[f"{name}.weight"] = np.asarray(tree["scale"])
    sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _gain(tree, name, sd):
    sd[f"{name}.g"] = np.asarray(tree["g"]).reshape(1, -1, 1, 1)


def _n_levels(p) -> int:
    n = 0
    while f"down_{n}_block1" in p:
        n += 1
    return n


def _resnet_block(tree, prefix, sd):
    if "mlp" in tree:
        _linear(tree["mlp"], f"{prefix}.mlp.1", sd)
    for blk in ("block1", "block2"):
        _conv(tree[blk]["proj"], f"{prefix}.{blk}.proj", sd)
        _groupnorm(tree[blk]["norm"], f"{prefix}.{blk}.norm", sd)
    if "res_conv" in tree:
        _conv(tree["res_conv"], f"{prefix}.res_conv", sd)


def _attention(tree, prefix, sd, linear: bool):
    _gain(tree["norm"], f"{prefix}.norm", sd)
    _conv(tree["attn"]["to_qkv"], f"{prefix}.fn.to_qkv", sd)
    if linear:
        _conv(tree["attn"]["to_out"], f"{prefix}.fn.to_out.0", sd)
        _gain(tree["attn"]["out_norm"], f"{prefix}.fn.to_out.1", sd)
    else:
        _conv(tree["attn"]["to_out"], f"{prefix}.fn.to_out", sd)


def flax_unet2d_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``UNet2D`` param tree -> port/reference ``Unet2D`` state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    _conv(p["init_conv"], "init_conv", sd)
    _linear(p["time_mlp"]["fc1"], "time_mlp.1", sd)
    _linear(p["time_mlp"]["fc2"], "time_mlp.3", sd)
    for i in range(_n_levels(p)):
        for side, key in (("down", "downs"), ("up", "ups")):
            _resnet_block(p[f"{side}_{i}_block1"], f"{key}.{i}.0", sd)
            _resnet_block(p[f"{side}_{i}_block2"], f"{key}.{i}.1", sd)
            _attention(p[f"{side}_{i}_attn"], f"{key}.{i}.2.fn", sd, linear=True)
            rs = p[f"{side}_{i}_{'downsample' if side == 'down' else 'upsample'}"]
            if "conv" in rs:
                _conv(rs["conv"], f"{key}.{i}.3.1", sd)
            else:
                _conv(rs, f"{key}.{i}.3", sd)
    _resnet_block(p["mid_block1"], "mid_block1", sd)
    _attention(p["mid_attn"], "mid_attn.fn", sd, linear=False)
    _resnet_block(p["mid_block2"], "mid_block2", sd)
    _resnet_block(p["final_res_block"], "final_res_block", sd)
    _conv(p["final_conv"], "final_conv", sd)
    return sd


def load_flax_unet2d(module: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``UNet2D`` tree into the port's ``UNet2D`` (strict: every
    key and shape must match). Returns the module."""
    return _load_strict(module, flax_unet2d_to_state_dict(flax_params))


# ---------------------------------------------------------------------------
# UNet3D: the inverse of torch_convert.py:132-253 (convert_unet3d)
# ---------------------------------------------------------------------------


def _conv3d(tree, name, sd):
    """flax (kd, kh, kw, in, out) -> torch Conv3d (out, in, kd, kh, kw)."""
    sd[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"]), (4, 3, 0, 1, 2))
    if "bias" in tree:
        sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _conv2d_from_3d(tree, name, sd):
    """flax 1x1x1 kernel (1, 1, 1, in, out) -> torch Conv2d (out, in, 1, 1)."""
    sd[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"])[0], (3, 2, 0, 1))
    if "bias" in tree:
        sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _gamma(tree, name, sd):
    sd[f"{name}.gamma"] = np.asarray(tree["gamma"]).reshape(1, -1, 1, 1, 1)


def _resnet_block3d(tree, prefix, sd):
    if "mlp" in tree:
        _linear(tree["mlp"], f"{prefix}.mlp.1", sd)
    for blk in ("block1", "block2"):
        _conv3d(tree[blk]["proj"], f"{prefix}.{blk}.proj", sd)
        _groupnorm(tree[blk]["norm"], f"{prefix}.{blk}.norm", sd)
    if "res_conv" in tree:
        _conv3d(tree["res_conv"], f"{prefix}.res_conv", sd)


def _token_attention(norm, attn, prefix, sd):
    """Residual(PreNorm(tokens(Attention))): gamma + bias-free linears."""
    _gamma(norm, f"{prefix}.fn.norm", sd)
    for lin in ("to_qkv", "to_out"):
        sd[f"{prefix}.fn.fn.fn.{lin}.weight"] = np.transpose(np.asarray(attn[lin]["kernel"]))


def flax_unet3d_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``UNet3D`` param tree -> port/reference ``Unet3D_with_Conv3D``
    state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {
        "time_rel_pos_bias.relative_attention_bias.weight": np.asarray(p["time_rel_pos_bias"]),
    }
    _conv3d(p["init_conv"], "init_conv", sd)
    _token_attention(p["init_attn_norm"], p["init_temporal_attn"], "init_temporal_attn", sd)
    _linear(p["time_mlp"]["fc1"], "time_mlp.1", sd)
    _linear(p["time_mlp"]["fc2"], "time_mlp.3", sd)
    for i in range(_n_levels(p)):
        for side, key in (("down", "downs"), ("up", "ups")):
            _resnet_block3d(p[f"{side}_{i}_block1"], f"{key}.{i}.0", sd)
            _resnet_block3d(p[f"{side}_{i}_block2"], f"{key}.{i}.1", sd)
            if f"{side}_{i}_sattn" in p:
                _gamma(p[f"{side}_{i}_sattn_norm"], f"{key}.{i}.2.fn.norm", sd)
                _conv2d_from_3d(p[f"{side}_{i}_sattn"]["to_qkv"], f"{key}.{i}.2.fn.fn.to_qkv", sd)
                _conv2d_from_3d(p[f"{side}_{i}_sattn"]["to_out"], f"{key}.{i}.2.fn.fn.to_out", sd)
            _token_attention(p[f"{side}_{i}_tattn_norm"], p[f"{side}_{i}_tattn"],
                             f"{key}.{i}.3", sd)
        if f"down_{i}_downsample" in p:
            _conv3d(p[f"down_{i}_downsample"]["conv"], f"downs.{i}.4", sd)
        if f"up_{i}_upsample" in p:
            # flax (kd, kh, kw, out, in) -> ConvTranspose3d (in, out, kd, kh, kw)
            up = p[f"up_{i}_upsample"]
            sd[f"ups.{i}.4.weight"] = np.transpose(np.asarray(up["kernel"]), (4, 3, 0, 1, 2))
            sd[f"ups.{i}.4.bias"] = np.asarray(up["bias"])
    _resnet_block3d(p["mid_block1"], "mid_block1", sd)
    _token_attention(p["mid_sattn_norm"], p["mid_sattn"], "mid_spatial_attn", sd)
    _token_attention(p["mid_tattn_norm"], p["mid_tattn"], "mid_temporal_attn", sd)
    _resnet_block3d(p["mid_block2"], "mid_block2", sd)
    _resnet_block3d(p["final_block"], "final_conv.0", sd)
    _conv3d(p["final_conv"], "final_conv.1", sd)
    return sd


def load_flax_unet3d(module: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``UNet3D`` tree into the port's ``UNet3D`` (strict)."""
    return _load_strict(module, flax_unet3d_to_state_dict(flax_params))


# ---------------------------------------------------------------------------
# UNet2Dv2 / ForceUNet: the inverse of torch_convert.py:262-365
# (convert_unet2dv2, convert_force_unet)
# ---------------------------------------------------------------------------


def _v2_level(p, side, i, key, sd):
    _resnet_block(p[f"{side}_{i}_block1"], f"{key}.{i}.0", sd)
    _resnet_block(p[f"{side}_{i}_block2"], f"{key}.{i}.1", sd)
    _gain(p[f"{side}_{i}_attn_norm"], f"{key}.{i}.2.fn.norm", sd)
    attn = p[f"{side}_{i}_attn"]
    _conv(attn["to_qkv"], f"{key}.{i}.2.fn.fn.to_qkv", sd)
    _conv(attn["to_out"], f"{key}.{i}.2.fn.fn.to_out.0", sd)
    _gain(attn["out_norm"], f"{key}.{i}.2.fn.fn.to_out.1", sd)
    rs = p[f"{side}_{i}_{'downsample' if side == 'down' else 'upsample'}"]
    if "conv" in rs:
        _conv(rs["conv"], f"{key}.{i}.3.1", sd)
    else:
        _conv(rs, f"{key}.{i}.3", sd)


def _v2_mid(p, sd):
    _resnet_block(p["mid_block1"], "mid_block1", sd)
    _gain(p["mid_attn_norm"], "mid_attn.fn.norm", sd)
    _conv(p["mid_attn"]["to_qkv"], "mid_attn.fn.fn.to_qkv", sd)
    _conv(p["mid_attn"]["to_out"], "mid_attn.fn.fn.to_out", sd)
    _resnet_block(p["mid_block2"], "mid_block2", sd)


def flax_unet2dv2_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``UNet2Dv2`` param tree -> port/reference 2D ``Unet`` state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    _conv(p["init_conv"], "init_conv", sd)
    _linear(p["time_mlp"]["fc1"], "time_mlp.1", sd)
    _linear(p["time_mlp"]["fc2"], "time_mlp.3", sd)
    for i in range(_n_levels(p)):
        _v2_level(p, "down", i, "downs", sd)
        _v2_level(p, "up", i, "ups", sd)
    _v2_mid(p, sd)
    _resnet_block(p["final_res_block"], "final_res_block", sd)
    _conv(p["final_conv"], "final_conv", sd)
    return sd


def flax_force_unet_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``ForceUNet`` param tree -> port/reference ``ForceUnet``
    state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    _conv(p["init_conv"], "init_conv", sd)
    for i in range(_n_levels(p)):
        _v2_level(p, "down", i, "downs", sd)
    _v2_mid(p, sd)
    _linear(p["final"], "final", sd)
    return sd


def _load_strict(module: torch.nn.Module, sd: Mapping) -> torch.nn.Module:
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    module.load_state_dict(tensors, strict=True)
    return module


def load_flax_unet2dv2(module: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``UNet2Dv2`` tree into the port's ``UNet2Dv2`` (strict)."""
    return _load_strict(module, flax_unet2dv2_to_state_dict(flax_params))


def load_flax_force_unet(module: torch.nn.Module, flax_params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``ForceUNet`` tree into the port's ``ForceUNet`` (strict)."""
    return _load_strict(module, flax_force_unet_to_state_dict(flax_params))


# ---------------------------------------------------------------------------
# the Burgers latent operator and the RL nets (baselines)
# ---------------------------------------------------------------------------


def _conv1d(tree, name, sd):
    sd[f"{name}.weight"] = np.transpose(np.asarray(tree["kernel"]), (2, 1, 0))
    sd[f"{name}.bias"] = np.asarray(tree["bias"])


def _conv_transpose2d(tree, name, sd):
    k = np.asarray(tree["kernel"])[::-1, ::-1]
    sd[f"{name}.weight"] = np.ascontiguousarray(np.transpose(k, (2, 3, 0, 1)))
    sd[f"{name}.bias"] = np.asarray(tree["bias"])


_CODER_CONVS = ("down0", "down1", "down2", "down3", "up0", "up1", "up2", "up3")


def flax_burgers_operator_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``SurrogateOperator`` params {"f", "u", "trans"} -> the port's
    ``SurrogateOperator`` state_dict."""
    sd: Dict[str, np.ndarray] = {}
    for key, name in (("f", "net_f"), ("u", "net_u")):
        p = params[key]["params"]
        for layer in _CODER_CONVS:
            _conv1d(p[layer], f"{name}.{layer}", sd)
        _linear(p["down_fc"], f"{name}.down_fc", sd)
    _conv1d(params["trans"]["params"]["transition1"], "net_trans.transition1", sd)
    return sd


def load_flax_burgers_operator(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``SurrogateOperator`` tree into the port's (strict)."""
    return _load_strict(module, flax_burgers_operator_to_state_dict(params))


def flax_mlp_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``GaussPolicyMLP`` / ``ValueMLP`` / ``QMLP`` tree (one ``MLP_0``
    of ``Dense_i``) -> the port's state_dict (``mlp.layers.i``)."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    for i in range(len(p["MLP_0"])):
        _linear(p["MLP_0"][f"Dense_{i}"], f"mlp.layers.{i}", sd)
    return sd


def load_flax_mlp(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``GaussPolicyMLP`` / ``ValueMLP`` / ``QMLP`` tree into the
    port's module of the same name (strict)."""
    return _load_strict(module, flax_mlp_to_state_dict(params))


def _conv_encoder(p, sd):
    for i in range(3):
        _conv(p["_ConvEncoder_0"][f"Conv_{i}"], f"encoder.convs.{i}", sd)


def flax_conv_gauss_policy_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``ConvGaussPolicy`` tree -> the port's state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    _conv_encoder(p, sd)
    for i in range(3):
        _conv_transpose2d(p[f"ConvTranspose_{i}"], f"ups.{i}", sd)
    _conv(p["Conv_0"], "head", sd)
    return sd


def load_flax_conv_gauss_policy(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``ConvGaussPolicy`` tree into the port's (strict)."""
    return _load_strict(module, flax_conv_gauss_policy_to_state_dict(params))


def flax_conv_q_to_state_dict(params: Mapping) -> Dict[str, np.ndarray]:
    """JAX ``ConvQ`` tree -> the port's state_dict."""
    p = params["params"] if "params" in params else params
    sd: Dict[str, np.ndarray] = {}
    _conv_encoder(p, sd)
    _linear(p["Dense_0"], "fc", sd)
    _linear(p["Dense_1"], "out", sd)
    return sd


def load_flax_conv_q(module: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Copy a JAX ``ConvQ`` tree into the port's (strict)."""
    return _load_strict(module, flax_conv_q_to_state_dict(params))


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v)


def save_flax_npz(path, tree: Mapping) -> None:
    """Write a nested numpy tree as one flat npz keyed by '/'-joined paths."""
    np.savez(path, **dict(_flatten(tree)))


def load_flax_npz(path) -> Dict:
    """Inverse of :func:`save_flax_npz`: the nested tree of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = z[key]
    return tree


# ---------------------------------------------------------------------------
# reference Trainer checkpoint files: {step, model, opt, ema, scaler, loss},
# 'model' the GaussianDiffusion state_dict with the UNet under 'model.',
# 'ema' the EMA state_dict with the averaged UNet under 'ema_model.model.'.
# The port's nets carry the reference's state_dict names, so reading one is
# a prefix strip and a strict load_state_dict.
# ---------------------------------------------------------------------------


def _strip_prefix(sd: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in sd.items()
            if k.startswith(prefix)}


def extract_unet_state_dict(ckpt: Mapping, use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """The UNet's state_dict in a loaded reference Trainer checkpoint: the
    EMA copy (``ema_model.model.``) when ``use_ema`` and the checkpoint has
    a non-empty ``ema`` entry holding it, else the online weights
    (``model.``); the diffusion's schedule buffers are dropped."""
    if use_ema and ckpt.get("ema"):
        sub = _strip_prefix(ckpt["ema"], "ema_model.model.")
        if sub:
            return sub
    return _strip_prefix(ckpt["model"], "model.")


def _load_reference(module: torch.nn.Module, path, use_ema: bool) -> torch.nn.Module:
    # weights_only=False: a reference Trainer file pickles more than tensors,
    # so this runs the pickle's code; read only files from a trusted source
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    module.load_state_dict(extract_unet_state_dict(ckpt, use_ema), strict=True)
    return module


def load_reference_checkpoint_unet2d(module: torch.nn.Module, path,
                                     use_ema: bool = True) -> torch.nn.Module:
    """Load a reference Burgers Trainer file (``cos10000-model-{k}.pt``)
    into the port's ``UNet2D`` (strict: every key and shape must match);
    returns the module. The file is unpickled with ``weights_only=False``,
    which runs code stored in it: load only trusted files."""
    return _load_reference(module, path, use_ema)


def load_reference_checkpoint_unet3d(module: torch.nn.Module, path,
                                     use_ema: bool = True) -> torch.nn.Module:
    """Load a reference smoke / jellyfish Trainer file (the same dict
    layout) into the port's ``UNet3D`` (strict); returns the module. The
    file is unpickled with ``weights_only=False``, which runs code stored in
    it: load only trusted files."""
    return _load_reference(module, path, use_ema)
