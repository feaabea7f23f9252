"""Plain float32 reference of the DiffPhyCon smoke UNet3D (``Unet3D_with_Conv3D``).

The video U-Net of the 2D smoke model as functions of a parameter dict keyed
by its state_dict names: a 7^3 init conv and temporal attention; per level
two FiLM ResnetBlocks (3^3 convs, GroupNorm of 8 groups, SiLU), per-frame
spatial linear attention and temporal attention over frames (rotary
embedding on q and k, a T5 relative position bias); (1, 4, 4) stride (1, 2,
2) down- and transposed upsampling; a bottleneck with per-frame full spatial
attention; a final ResnetBlock over the concatenated init features and a
1^3 conv. Plain torch on (B, C, F, H, W), float32, TF32 off (the caller
clears the switches). Channel LayerNorm eps is 1e-5 (every dtype).

``rnd``, when given, rounds every operand of a convolution, a linear map and
an attention product (the control of the correctness check).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.unet2d import sinusoidal


def _id(t):
    return t


def _levels(cfg):
    dims = [cfg["dim"]] + [cfg["dim"] * m for m in cfg["dim_mults"]]
    return list(zip(dims[:-1], dims[1:]))


def param_shapes(cfg, channels: int) -> dict:
    """{state_dict name: shape} of one UNet3D with ``channels`` in and out."""
    dim, heads, dh = cfg["dim"], cfg["attn_heads"], cfg["attn_dim_head"]
    hid, tdim, k0 = heads * dh, 4 * dim, cfg["init_kernel_size"]
    out = {"time_rel_pos_bias.relative_attention_bias.weight": (32, heads)}

    def conv(pre, ci, co, k, bias=True):
        out[pre + ".weight"] = (co, ci) + tuple(k)
        if bias:
            out[pre + ".bias"] = (co,)

    def res(pre, ci, co, film=True):
        if film:
            out[pre + ".mlp.1.weight"] = (2 * co, tdim)
            out[pre + ".mlp.1.bias"] = (2 * co,)
        for b, c_in in (("block1", ci), ("block2", co)):
            conv(f"{pre}.{b}.proj", c_in, co, (3, 3, 3))
            out[f"{pre}.{b}.norm.weight"] = (co,)
            out[f"{pre}.{b}.norm.bias"] = (co,)
        if ci != co:
            conv(pre + ".res_conv", ci, co, (1, 1, 1))

    def tokens_attn(pre, c):  # Residual(PreNorm(Tokens(Attention)))
        out[pre + ".fn.norm.gamma"] = (1, c, 1, 1, 1)
        out[pre + ".fn.fn.fn.to_qkv.weight"] = (3 * hid, c)
        out[pre + ".fn.fn.fn.to_out.weight"] = (c, hid)

    def spatial_linear(pre, c):
        out[pre + ".fn.norm.gamma"] = (1, c, 1, 1, 1)
        conv(pre + ".fn.fn.to_qkv", c, 3 * hid, (1, 1), bias=False)
        conv(pre + ".fn.fn.to_out", hid, c, (1, 1))

    conv("init_conv", channels, dim, (k0, k0, k0))
    tokens_attn("init_temporal_attn", dim)
    out["time_mlp.1.weight"], out["time_mlp.1.bias"] = (tdim, dim), (tdim,)
    out["time_mlp.3.weight"], out["time_mlp.3.bias"] = (tdim, tdim), (tdim,)
    lv = _levels(cfg)
    for i, (di, do) in enumerate(lv):
        res(f"downs.{i}.0", di, do)
        res(f"downs.{i}.1", do, do)
        spatial_linear(f"downs.{i}.2", do)
        tokens_attn(f"downs.{i}.3", do)
        if i < len(lv) - 1:
            conv(f"downs.{i}.4", do, do, (1, 4, 4))
    mid = lv[-1][1]
    res("mid_block1", mid, mid)
    tokens_attn("mid_spatial_attn", mid)
    tokens_attn("mid_temporal_attn", mid)
    res("mid_block2", mid, mid)
    for i, (di, do) in enumerate(reversed(lv)):
        res(f"ups.{i}.0", 2 * do, di)
        res(f"ups.{i}.1", di, di)
        spatial_linear(f"ups.{i}.2", di)
        tokens_attn(f"ups.{i}.3", di)
        if i < len(lv) - 1:  # ConvTranspose3d: (in, out, kf, kh, kw)
            out[f"ups.{i}.4.weight"] = (di, di, 1, 4, 4)
            out[f"ups.{i}.4.bias"] = (di,)
    res("final_conv.0", 2 * dim, dim, film=False)
    conv("final_conv.1", dim, channels, (1, 1, 1))
    return out


def t5_buckets(n: int, num_buckets: int = 32, max_distance: int = 32) -> np.ndarray:
    """T5 relative position buckets (bidirectional), (n, n)."""
    rel = np.arange(n)[None, :] - np.arange(n)[:, None]  # key - query
    neg = -rel
    nb = num_buckets // 2
    ret = (neg < 0).astype(np.int64) * nb
    a = np.abs(neg)
    exact = nb // 2
    with np.errstate(divide="ignore"):
        large = exact + (np.log(np.maximum(a, 1) / exact) / math.log(max_distance / exact)
                         * (nb - exact)).astype(np.int64)
    return ret + np.where(a < exact, a, np.minimum(large, nb - 1))


def rotate(x, n: int):
    """Rotary embedding (interleaved pairs) on the first min(32, d) features
    of x (..., n, d), positions 0..n-1."""
    rot = min(32, x.shape[-1])
    freqs = 1.0 / (10000 ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    ang = np.repeat(np.arange(n)[:, None] * freqs[None, :], 2, axis=-1)
    ang = torch.as_tensor(ang, dtype=torch.float32, device=x.device)
    head = x[..., :rot]
    pairs = head.reshape(*head.shape[:-1], rot // 2, 2)
    turned = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(head.shape)
    head = head * torch.cos(ang) + turned * torch.sin(ang)
    return torch.cat([head, x[..., rot:]], dim=-1)


def forward(P: dict, x, time, cfg, rnd=None):
    """The UNet3D on x (B, F, H, W, C) at time (B,); returns (B, F, H, W, C)
    float32."""
    r = rnd or _id
    heads, dh, groups = cfg["attn_heads"], cfg["attn_dim_head"], cfg["resnet_groups"]
    gn_eps = cfg["group_norm_eps"]
    ln_eps = cfg["chan_layer_norm_eps"]

    def lin(v, pre, bias=True):
        return F.linear(r(v), r(P[pre + ".weight"]), P[pre + ".bias"] if bias else None)

    def conv(v, pre, pad=0, stride=1, bias=True):
        w = P[pre + ".weight"]
        fn = F.conv3d if w.dim() == 5 else F.conv2d
        return fn(r(v), r(w), P[pre + ".bias"] if bias else None, stride=stride, padding=pad)

    def ln(v, pre):
        mean = v.mean(dim=1, keepdim=True)
        var = ((v - mean) ** 2).mean(dim=1, keepdim=True)
        return (v - mean) * torch.rsqrt(var + ln_eps) * P[pre + ".fn.norm.gamma"]

    def block(v, pre, ss):
        h = F.group_norm(conv(v, pre + ".proj", 1), groups, P[pre + ".norm.weight"],
                         P[pre + ".norm.bias"], gn_eps)
        if ss is not None:
            h = h * (ss[0] + 1.0) + ss[1]
        return F.silu(h)

    def res(v, pre, temb=None):
        ss = None
        if temb is not None:
            scale, shift = lin(F.silu(temb), pre + ".mlp.1").chunk(2, dim=1)
            ss = (scale[:, :, None, None, None], shift[:, :, None, None, None])
        h = block(block(v, pre + ".block1", ss), pre + ".block2", None)
        return h + (conv(v, pre + ".res_conv") if pre + ".res_conv.weight" in P else v)

    def attention(tok, pre, rotary, bias=None):
        n_seq, n, _ = tok.shape
        q, k, v = lin(tok, pre + ".to_qkv", bias=False).reshape(
            n_seq, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        q = q * dh ** -0.5
        if rotary:
            q, k = rotate(q, n), rotate(k, n)
        sim = r(q) @ r(k).transpose(-1, -2)
        if bias is not None:
            sim = sim + bias
        o = r(torch.softmax(sim, dim=-1)) @ r(v)
        return lin(o.transpose(1, 2).reshape(n_seq, n, heads * dh), pre + ".to_out",
                   bias=False)

    def temporal(v, pre, bias):
        b, c, f, hh, ww = v.shape
        tok = ln(v, pre).permute(0, 3, 4, 2, 1).reshape(b * hh * ww, f, c)
        o = attention(tok, pre + ".fn.fn.fn", True, bias)
        return v + o.reshape(b, hh, ww, f, c).permute(0, 4, 3, 1, 2)

    def spatial_full(v, pre):
        b, c, f, hh, ww = v.shape
        tok = ln(v, pre).permute(0, 2, 3, 4, 1).reshape(b * f, hh * ww, c)
        o = attention(tok, pre + ".fn.fn.fn", False)
        return v + o.reshape(b, f, hh, ww, c).permute(0, 4, 1, 2, 3)

    def spatial_linear(v, pre):
        b, c, f, hh, ww = v.shape
        frames = ln(v, pre).transpose(1, 2).reshape(b * f, c, hh, ww)
        q, k, vv = conv(frames, pre + ".fn.fn.to_qkv", bias=False).reshape(
            b * f, 3, heads, dh, hh * ww).unbind(1)
        q = torch.softmax(q, dim=-2) * dh ** -0.5
        k = torch.softmax(k, dim=-1)
        ctx = torch.einsum("bhdn,bhen->bhde", r(k), r(vv))
        o = torch.einsum("bhde,bhdn->bhen", r(ctx), r(q)).reshape(b * f, heads * dh, hh, ww)
        o = conv(o, pre + ".fn.fn.to_out")
        return v + o.reshape(b, f, c, hh, ww).transpose(1, 2)

    h = x.permute(0, 4, 1, 2, 3)
    n_frames = h.shape[2]
    buckets = torch.as_tensor(t5_buckets(n_frames), device=x.device)
    bias = P["time_rel_pos_bias.relative_attention_bias.weight"][buckets].permute(2, 0, 1)
    h = conv(h, "init_conv", cfg["init_kernel_size"] // 2)
    h = temporal(h, "init_temporal_attn", bias)
    first = h
    temb = lin(F.gelu(lin(sinusoidal(time, cfg["dim"], 10000.0), "time_mlp.1")),
               "time_mlp.3")
    skips = []
    lv = _levels(cfg)
    for i in range(len(lv)):
        h = res(res(h, f"downs.{i}.0", temb), f"downs.{i}.1", temb)
        h = temporal(spatial_linear(h, f"downs.{i}.2"), f"downs.{i}.3", bias)
        skips.append(h)
        if i < len(lv) - 1:
            h = conv(h, f"downs.{i}.4", pad=(0, 1, 1), stride=(1, 2, 2))
    h = res(h, "mid_block1", temb)
    h = spatial_full(h, "mid_spatial_attn")
    h = temporal(h, "mid_temporal_attn", bias)
    h = res(h, "mid_block2", temb)
    for i in range(len(lv)):
        h = res(torch.cat([h, skips.pop()], dim=1), f"ups.{i}.0", temb)
        h = res(h, f"ups.{i}.1", temb)
        h = temporal(spatial_linear(h, f"ups.{i}.2"), f"ups.{i}.3", bias)
        if i < len(lv) - 1:
            h = F.conv_transpose3d(r(h), r(P[f"ups.{i}.4.weight"]), P[f"ups.{i}.4.bias"],
                                   stride=(1, 2, 2), padding=(0, 1, 1))
    h = res(torch.cat([h, first], dim=1), "final_conv.0")
    return conv(h, "final_conv.1").permute(0, 2, 3, 4, 1)
