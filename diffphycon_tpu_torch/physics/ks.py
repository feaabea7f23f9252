"""1D Kuramoto-Sivashinsky equation: spectral ETDRK4 integrator.

Port of ``diffphycon_tpu/physics/ks.py``:

  u_t = -u u_x - u_xx - u_xxxx + f

on a periodic domain of length L, integrated with exponential time
differencing (ETDRK4, Kassam & Trefethen) on ``torch.fft`` in complex64.
The phi-function coefficients come from the same numpy contour quadrature
as JAX's and are cast to float32 / complex64 as JAX casts them. Batched
and differentiable with respect to u0 and f.
"""

from __future__ import annotations

import numpy as np
import torch

from diffphycon_tpu_torch.physics.burgers import make_burgers_data


def etdrk4_coeffs(s: int, L: float, dt: float, n_quad: int = 32):
    """(E, E2, Q, f1, f2, f3) float32 and g complex64 numpy arrays of shape
    (s,): the ETDRK4 coefficients, phi functions by contour quadrature over
    n_quad points."""
    k = 2 * np.pi * np.fft.fftfreq(s, d=L / s)
    lin = k**2 - k**4  # -u_xx - u_xxxx in Fourier space
    r = np.exp(1j * np.pi * (np.arange(1, n_quad + 1) - 0.5) / n_quad)
    lr = dt * lin[:, None] + r[None, :]

    def quad(a):
        return dt * np.real(np.mean(a, axis=1))

    q = quad((np.exp(lr / 2) - 1) / lr)
    f1 = quad((-4 - lr + np.exp(lr) * (4 - 3 * lr + lr**2)) / lr**3)
    f2 = quad((2 + lr + np.exp(lr) * (-2 + lr)) / lr**3)
    f3 = quad((-4 - 3 * lr - lr**2 + np.exp(lr) * (4 - lr)) / lr**3)
    real = [np.asarray(a, np.float32) for a in
            (np.exp(dt * lin), np.exp(dt * lin / 2), q, f1, f2, f3)]
    return (*real, (-0.5j * k).astype(np.complex64))  # g: nonlinear -(u^2/2)_x


def ks_solve(u0: torch.Tensor, f: torch.Tensor, L: float = 22.0, dt: float = 0.025,
             num_t: int = 10, substeps: int = 40, s: int = 128) -> torch.Tensor:
    """Integrate KS with piecewise-constant forcing.

    u0: (B, s); f: (B, num_t, s) forcing frames, each applied for
    ``substeps`` ETDRK4 steps. Returns (B, num_t + 1, s) float32 on u0's
    device."""
    if u0.shape[-1] != s or f.shape[1:] != (num_t, s):
        raise ValueError(f"ks_solve: u0 {tuple(u0.shape)} / f {tuple(f.shape)} do not "
                         f"fit s={s}, num_t={num_t}")
    dev = u0.device
    E, E2, Q, f1, f2, f3, g = (torch.from_numpy(a).to(dev)
                               for a in etdrk4_coeffs(s, L, dt))

    def nonlin(v_hat, f_hat):
        u = torch.fft.ifft(v_hat, dim=-1).real
        return g * torch.fft.fft(u * u, dim=-1) + f_hat

    def step(v, f_hat):
        nv = nonlin(v, f_hat)
        a = E2 * v + Q * nv
        na = nonlin(a, f_hat)
        b = E2 * v + Q * na
        nb = nonlin(b, f_hat)
        c = E2 * a + Q * (2 * nb - nv)
        nc = nonlin(c, f_hat)
        return E * v + nv * f1 + 2 * (na + nb) * f2 + nc * f3

    u0 = u0.to(torch.float32)
    v = torch.fft.fft(u0, dim=-1)
    frames = [u0]
    for i in range(num_t):
        f_hat = torch.fft.fft(f[:, i].to(torch.float32), dim=-1)
        for _ in range(substeps):
            v = step(v, f_hat)
        frames.append(torch.fft.ifft(v, dim=-1).real)
    return torch.stack(frames, dim=1)


def make_ks_data(n: int, s: int = 128, t: int = 10, seed: int = 0, L: float = 22.0):
    """Random smooth initial states (n, s) and Gaussian-bump forcings (n, t,
    s), float32 numpy: the Burgers bump generator's draws for the seed."""
    del L  # the domain length does not enter the bump construction, as in JAX
    return make_burgers_data(n, s=s, t=t, seed=seed)
