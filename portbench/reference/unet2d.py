"""Plain float32 reference of the DiffPhyCon Burgers UNet2D.

The denoiser of denoising-diffusion-pytorch's ``Unet`` as DiffPhyCon's 1D
Burgers model uses it (dim 64, mults (1, 2, 4, 8), one GroupNorm group),
written as functions of a parameter dict keyed by that ``Unet``'s
state_dict names. Plain torch operations on NCHW tensors, no kernels, no
cache, float32 with TF32 off (the caller clears the switches).

The configuration's constants are its own: ``chan_layer_norm_eps`` is 1e-3
where the configuration computes in bfloat16 (flax's ``ChanLayerNorm``
takes 1e-3 for a non-float32 input), 1e-5 otherwise.

``rnd``, when given, rounds every operand of a convolution, a linear map and
an attention product to a lower precision (the control of the correctness
check); ``None`` computes in float32 throughout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _levels(cfg):
    dims = [cfg["dim"]] + [cfg["dim"] * m for m in cfg["dim_mults"]]
    return list(zip(dims[:-1], dims[1:]))


def param_shapes(cfg) -> dict:
    """{state_dict name: shape} of one UNet2D of configuration ``cfg``."""
    dim, ch = cfg["dim"], cfg["channels"]
    hid = cfg["attn_heads"] * cfg["attn_dim_head"]
    tdim = 4 * dim
    out = {}

    def conv(pre, ci, co, k):
        out[pre + ".weight"] = (co, ci, k, k)
        out[pre + ".bias"] = (co,)

    def res(pre, ci, co):
        out[pre + ".mlp.1.weight"] = (2 * co, tdim)
        out[pre + ".mlp.1.bias"] = (2 * co,)
        for b, c_in in (("block1", ci), ("block2", co)):
            conv(f"{pre}.{b}.proj", c_in, co, 3)
            out[f"{pre}.{b}.norm.weight"] = (co,)
            out[f"{pre}.{b}.norm.bias"] = (co,)
        if ci != co:
            conv(pre + ".res_conv", ci, co, 1)

    def attn(pre, c, linear):
        out[pre + ".fn.norm.g"] = (1, c, 1, 1)
        out[pre + ".fn.fn.to_qkv.weight"] = (3 * hid, c, 1, 1)
        if linear:
            conv(pre + ".fn.fn.to_out.0", hid, c, 1)
            out[pre + ".fn.fn.to_out.1.g"] = (1, c, 1, 1)
        else:
            conv(pre + ".fn.fn.to_out", hid, c, 1)

    conv("init_conv", ch, dim, 7)
    out["time_mlp.1.weight"], out["time_mlp.1.bias"] = (tdim, dim), (tdim,)
    out["time_mlp.3.weight"], out["time_mlp.3.bias"] = (tdim, tdim), (tdim,)
    lv = _levels(cfg)
    for i, (di, do) in enumerate(lv):
        res(f"downs.{i}.0", di, di)
        res(f"downs.{i}.1", di, di)
        attn(f"downs.{i}.2", di, True)
        if i == len(lv) - 1:
            conv(f"downs.{i}.3", di, do, 3)
        else:
            conv(f"downs.{i}.3.1", 4 * di, do, 1)
    mid = lv[-1][1]
    res("mid_block1", mid, mid)
    attn("mid_attn", mid, False)
    res("mid_block2", mid, mid)
    for i, (di, do) in enumerate(reversed(lv)):
        res(f"ups.{i}.0", do + di, do)
        res(f"ups.{i}.1", do + di, do)
        attn(f"ups.{i}.2", do, True)
        conv(f"ups.{i}.3" if i == len(lv) - 1 else f"ups.{i}.3.1", do, di, 3)
    res("final_res_block", 2 * dim, dim)
    conv("final_conv", dim, cfg["out_dim"], 1)
    return out


def _id(t):
    return t


def sinusoidal(t, dim, theta):
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(theta) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def chan_ln(x, g, eps):
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g


def forward(P: dict, x, time, cfg, rnd=None):
    """The UNet2D on x (B, T, X, C) channels-last at time (B,); returns
    (B, T, X, out_dim) float32."""
    r = rnd or _id
    heads, dh = cfg["attn_heads"], cfg["attn_dim_head"]
    groups, gn_eps, ln_eps = cfg["resnet_block_groups"], cfg["group_norm_eps"], \
        cfg["chan_layer_norm_eps"]

    def lin(v, pre):
        return F.linear(r(v), r(P[pre + ".weight"]), P[pre + ".bias"])

    def conv(v, pre, pad=0, stride=1, weight=None):
        w = P[pre + ".weight"] if weight is None else weight
        return F.conv2d(r(v), r(w), P[pre + ".bias"], stride=stride, padding=pad)

    def gn(v, pre):
        return F.group_norm(v, groups, P[pre + ".weight"], P[pre + ".bias"], gn_eps)

    temb = lin(F.gelu(lin(sinusoidal(time, cfg["dim"], cfg["sinusoidal_pos_emb_theta"]),
                          "time_mlp.1")), "time_mlp.3")
    temb_act = F.silu(temb)

    def res(v, pre):
        scale, shift = lin(temb_act, pre + ".mlp.1").chunk(2, dim=1)
        h = gn(conv(v, pre + ".block1.proj", 1), pre + ".block1.norm")
        h = F.silu(h * (scale[:, :, None, None] + 1.0) + shift[:, :, None, None])
        h = F.silu(gn(conv(h, pre + ".block2.proj", 1), pre + ".block2.norm"))
        return h + (conv(v, pre + ".res_conv") if pre + ".res_conv.weight" in P else v)

    def qkv(v, pre):
        b, c, hh, ww = v.shape
        hn = chan_ln(v, P[pre + ".fn.norm.g"], ln_eps)
        q = F.conv2d(r(hn), r(P[pre + ".fn.fn.to_qkv.weight"]))
        return q.reshape(b, 3, heads, dh, hh * ww).unbind(1)

    def lin_attn(v, pre):
        b, c, hh, ww = v.shape
        q, k, vv = qkv(v, pre)  # (b, heads, d, n)
        q = torch.softmax(q, dim=-2) * dh ** -0.5
        k = torch.softmax(k, dim=-1)
        ctx = torch.einsum("bhdn,bhen->bhde", r(k), r(vv))
        o = torch.einsum("bhde,bhdn->bhen", r(ctx), r(q)).reshape(b, heads * dh, hh, ww)
        o = conv(o, pre + ".fn.fn.to_out.0")
        return v + chan_ln(o, P[pre + ".fn.fn.to_out.1.g"], ln_eps)

    def full_attn(v, pre):
        b, c, hh, ww = v.shape
        q, k, vv = qkv(v, pre)
        sim = torch.einsum("bhdi,bhdj->bhij", r(q * dh ** -0.5), r(k))
        a = torch.softmax(sim, dim=-1)
        o = torch.einsum("bhij,bhdj->bhdi", r(a), r(vv)).reshape(b, heads * dh, hh, ww)
        return v + conv(o, pre + ".fn.fn.to_out")

    h = conv(x.permute(0, 3, 1, 2), "init_conv", 3)
    first = h
    skips = []
    lv = _levels(cfg)
    n = len(lv)
    for i, (di, do) in enumerate(lv):
        h = res(h, f"downs.{i}.0")
        skips.append(h)
        h = lin_attn(res(h, f"downs.{i}.1"), f"downs.{i}.2")
        skips.append(h)
        if i == n - 1:
            h = conv(h, f"downs.{i}.3", 1)
        else:  # space-to-depth in (c p1 p2) order + 1x1 == a 2x2 stride-2 conv
            w = P[f"downs.{i}.3.1.weight"].reshape(do, di, 2, 2)
            h = conv(h, f"downs.{i}.3.1", stride=2, weight=w)
    h = res(full_attn(res(h, "mid_block1"), "mid_attn"), "mid_block2")
    for i, (di, do) in enumerate(reversed(lv)):
        h = res(torch.cat([h, skips.pop()], dim=1), f"ups.{i}.0")
        h = res(torch.cat([h, skips.pop()], dim=1), f"ups.{i}.1")
        h = lin_attn(h, f"ups.{i}.2")
        if i == n - 1:
            h = conv(h, f"ups.{i}.3", 1)
        else:
            h = conv(F.interpolate(h, scale_factor=2, mode="nearest"), f"ups.{i}.3.1", 1)
    h = res(torch.cat([h, first], dim=1), "final_res_block")
    return conv(h, "final_conv").permute(0, 2, 3, 1)
