"""Operations and bytes of one net forward, counted from the configuration's
layer shapes (the yardstick of the MFU and roofline metrics).

Each layer is ``(name, flops, bytes, peak)``: flops are 2 x the
multiply-adds of its convolutions and matrix products (elementwise work,
norms and softmaxes count 0); bytes are its inputs read once, its weights
read once and its outputs written once at the precision the configuration
computes in; ``peak`` names the rate of the layer's products in
:data:`PEAKS` ("bf16" for bfloat16 tensor-core products, "fp32" for float32
products outside the tensor cores, as TF32 is off). Norm and activation
layers are listed with their bytes and no flops.
"""

from __future__ import annotations

# Published dense peaks of one NVIDIA H100 SXM (data sheet, at 700 W)
PEAKS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def _act_bytes(cfg) -> int:
    return 2 if cfg["dtype"] == "bfloat16" else 4


def unet2d_layers(cfg, batch: int, h: int, w: int) -> list:
    """The layers of one UNet2D forward on (batch, h, w, channels)."""
    dim, ch, out_dim = cfg["dim"], cfg["channels"], cfg["out_dim"]
    heads, dh = cfg["attn_heads"], cfg["attn_dim_head"]
    hid, tdim = heads * dh, 4 * dim
    a = _act_bytes(cfg)
    peak = "bf16" if a == 2 else "fp32"
    dims = [dim] + [dim * m for m in cfg["dim_mults"]]
    lv = list(zip(dims[:-1], dims[1:]))
    layers = []

    def conv(name, hh, ww, ci, co, k):
        macs = batch * hh * ww * co * ci * k * k
        nbytes = a * (batch * hh * ww * (ci + co) + k * k * ci * co)
        layers.append((name, 2 * macs, nbytes, peak))

    def elementwise(name, n_in, n_out):
        layers.append((name, 0, a * (n_in + n_out), peak))

    def res(name, hh, ww, ci, co):
        conv(name + ".conv1", hh, ww, ci, co, 3)
        elementwise(name + ".norm1", batch * hh * ww * co, batch * hh * ww * co)
        conv(name + ".conv2", hh, ww, co, co, 3)
        if ci != co:
            conv(name + ".res_conv", hh, ww, ci, co, 1)
        elementwise(name + ".norm2", 2 * batch * hh * ww * co, batch * hh * ww * co)

    def attention(name, hh, ww, c, linear):
        n = hh * ww
        core = hid * dh * n * 2 if linear else hid * n * n * 2
        macs = batch * (n * c * 3 * hid + core + n * hid * c)
        nbytes = a * (2 * batch * n * c + 3 * hid * c + hid * c)
        layers.append((name, 2 * macs, nbytes, peak))

    hh, ww = h, w
    conv("init_conv", hh, ww, ch, dim, 7)
    layers.append(("time_mlp", 2 * batch * (dim * tdim + tdim * tdim), a * (dim + tdim) * tdim,
                   peak))
    film = sum(2 * co for co in _res_widths(lv, dim))
    layers.append(("film", 2 * batch * tdim * film, a * tdim * film, peak))
    for i, (di, do) in enumerate(lv):
        res(f"downs.{i}.0", hh, ww, di, di)
        res(f"downs.{i}.1", hh, ww, di, di)
        attention(f"downs.{i}.2", hh, ww, di, True)
        if i == len(lv) - 1:
            conv(f"downs.{i}.3", hh, ww, di, do, 3)
        else:
            hh, ww = hh // 2, ww // 2  # space-to-depth + 1x1: a 2x2 stride-2 conv
            conv(f"downs.{i}.3", hh, ww, 4 * di, do, 1)
    mid = lv[-1][1]
    res("mid_block1", hh, ww, mid, mid)
    attention("mid_attn", hh, ww, mid, False)
    res("mid_block2", hh, ww, mid, mid)
    for i, (di, do) in enumerate(reversed(lv)):
        res(f"ups.{i}.0", hh, ww, do + di, do)
        res(f"ups.{i}.1", hh, ww, do + di, do)
        attention(f"ups.{i}.2", hh, ww, do, True)
        if i == len(lv) - 1:
            conv(f"ups.{i}.3", hh, ww, do, di, 3)
        else:  # nearest 2x, then the 3x3 conv at the new size
            hh, ww = 2 * hh, 2 * ww
            conv(f"ups.{i}.3", hh, ww, do, di, 3)
    res("final_res_block", hh, ww, 2 * dim, dim)
    conv("final_conv", hh, ww, dim, out_dim, 1)
    return layers


def _res_widths(lv, dim):
    widths = [di for di, _ in lv for _ in range(2)] + [lv[-1][1]] * 2
    widths += [do for _, do in reversed(lv) for _ in range(2)]
    return widths + [dim]


def unet3d_layers(cfg, batch: int, channels: int) -> list:
    """The layers of one UNet3D forward on (batch, frames, size, size,
    channels). Its temporal attention computes in float32 (the rotary
    angles are float32), so its products take the "fp32" peak."""
    dim, heads, dh = cfg["dim"], cfg["attn_heads"], cfg["attn_dim_head"]
    hid, tdim, k0 = heads * dh, 4 * dim, cfg["init_kernel_size"]
    f, s = cfg["frames"], cfg["image_size"]
    a = _act_bytes(cfg)
    peak = "bf16" if a == 2 else "fp32"
    dims = [dim] + [dim * m for m in cfg["dim_mults"]]
    lv = list(zip(dims[:-1], dims[1:]))
    layers = []

    def conv(name, vox_in, vox_out, ci, co, taps):
        macs = batch * vox_out * co * ci * taps
        nbytes = a * (batch * vox_in * ci + taps * ci * co + batch * vox_out * co)
        layers.append((name, 2 * macs, nbytes, peak))

    def elementwise(name, n_in, n_out):
        layers.append((name, 0, a * (n_in + n_out), peak))

    def res(name, vox, ci, co):
        conv(name + ".conv1", vox, vox, ci, co, 27)
        elementwise(name + ".norm1", batch * vox * co, batch * vox * co)
        conv(name + ".conv2", vox, vox, co, co, 27)
        elementwise(name + ".norm2", batch * vox * co, batch * vox * co)
        if ci != co:
            conv(name + ".res_conv", vox, vox, ci, co, 1)

    def attention(name, seqs, n, c, core_peak, linear=False):
        proj = seqs * (n * c * 3 * hid + n * hid * c)
        core = seqs * (hid * dh * n * 2 if linear else hid * n * n * 2)
        nbytes = a * (2 * seqs * n * c + 4 * hid * c)
        layers.append((name + ".proj", 2 * proj, nbytes, peak))
        layers.append((name + ".core", 2 * core, 0, core_peak))

    def temporal(name, hw, c):
        attention(name, batch * hw, f, c, "fp32")

    vox = f * s * s
    conv("init_conv", vox, vox, channels, dim, k0 ** 3)
    temporal("init_temporal_attn", s * s, dim)
    layers.append(("time_mlp", 2 * batch * (dim * tdim + tdim * tdim), a * (dim + tdim) * tdim,
                   peak))
    film = sum(2 * co for co in [do for _, do in lv for _ in range(2)] + [lv[-1][1]] * 2
               + [di for di, _ in reversed(lv) for _ in range(2)])
    layers.append(("film", 2 * batch * tdim * film, a * tdim * film, peak))
    size = s
    for i, (di, do) in enumerate(lv):
        v = f * size * size
        res(f"downs.{i}.0", v, di, do)
        res(f"downs.{i}.1", v, do, do)
        attention(f"downs.{i}.2", batch * f, size * size, do, peak, linear=True)
        temporal(f"downs.{i}.3", size * size, do)
        if i < len(lv) - 1:
            conv(f"downs.{i}.4", v, v // 4, do, do, 16)
            size //= 2
    mid = lv[-1][1]
    v = f * size * size
    res("mid_block1", v, mid, mid)
    attention("mid_spatial_attn", batch * f, size * size, mid, peak)
    temporal("mid_temporal_attn", size * size, mid)
    res("mid_block2", v, mid, mid)
    for i, (di, do) in enumerate(reversed(lv)):
        v = f * size * size
        res(f"ups.{i}.0", v, 2 * do, di)
        res(f"ups.{i}.1", v, di, di)
        attention(f"ups.{i}.2", batch * f, size * size, di, peak, linear=True)
        temporal(f"ups.{i}.3", size * size, di)
        if i < len(lv) - 1:  # transposed: each input voxel feeds 16 outputs
            conv(f"ups.{i}.4", v, 4 * v, di, di, 4)
            size *= 2
    v = f * size * size
    res("final_conv.0", v, 2 * dim, dim)
    conv("final_conv.1", v, v, dim, channels, 1)
    return layers


def totals(layers) -> tuple:
    """(flops, bound seconds): the summed flops, and the sum over layers of
    max(flops / the layer's peak, bytes / HBM bandwidth)."""
    flops = sum(fl for _, fl, _, _ in layers)
    bound = sum(max(fl / PEAKS[pk], nb / HBM_BYTES_PER_S) for _, fl, nb, pk in layers)
    return flops, bound
