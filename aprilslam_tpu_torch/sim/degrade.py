"""Image degradations for sensor-realistic rendering and robustness tests
(port of ``aprilslam_tpu/sim/degrade.py``).

They warp or degrade a clean render the way a real sensor would (lens
distortion, shot noise, defocus blur, exposure gradients, gamma,
vignetting), after the rasterizer and with independent math (inverse-map
resampling, separable convolution), so detect and render conventions cannot
cancel.

All functions take (B, H, W) float32 frames in [0, 1] and return the same,
on the frames' device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..geometry.camera import undistort_pixels


def _bilinear_sample(frames: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W) frames at pixel coords uv (H, W, 2), clamp-to-edge."""
    B, H, W = frames.shape
    u = torch.clamp(uv[..., 0], 0.0, W - 1.0)
    v = torch.clamp(uv[..., 1], 0.0, H - 1.0)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.long()
    v0i = v0.long()
    u1i = torch.clamp(u0i + 1, max=W - 1)
    v1i = torch.clamp(v0i + 1, max=H - 1)
    f00 = frames[:, v0i, u0i]
    f01 = frames[:, v0i, u1i]
    f10 = frames[:, v1i, u0i]
    f11 = frames[:, v1i, u1i]
    top = f00 * (1 - du) + f01 * du
    bot = f10 * (1 - du) + f11 * du
    return top * (1 - dv) + bot * dv


def apply_lens_distortion(frames: torch.Tensor, K, dist) -> torch.Tensor:
    """Warp pinhole renders into what a distorting lens would capture.

    A scene point lands at ideal pixel u_i in the render and at
    u_d = distort(u_i) on the real sensor, so the distorted image is
    I_d(u_d) = I_ideal(undistort(u_d)), an inverse-map bilinear resample."""
    B, H, W = frames.shape
    v, u = torch.meshgrid(
        torch.arange(H, dtype=frames.dtype, device=frames.device),
        torch.arange(W, dtype=frames.dtype, device=frames.device),
        indexing="ij",
    )
    grid = torch.stack([u, v], dim=-1)  # (H, W, 2) distorted pixel coords
    K = torch.as_tensor(K, dtype=frames.dtype).to(frames.device)
    src = undistort_pixels(grid, K, dist)
    return _bilinear_sample(frames, src)


def gaussian_noise(frames: torch.Tensor, sigma: float, generator: torch.Generator | None = None) -> torch.Tensor:
    """Additive sensor noise, clipped back to [0, 1].

    The draws come from ``generator`` (a ``torch.Generator`` on the frames'
    device) where the JAX version takes a ``jax.random`` key, so the values
    cannot match the JAX package's bits; the distribution is the same."""
    n = sigma * torch.randn(frames.shape, generator=generator, dtype=frames.dtype, device=frames.device)
    return torch.clamp(frames + n, 0.0, 1.0)


def _gauss_kernel1d(sigma: float, dtype, device) -> torch.Tensor:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def gaussian_blur(frames: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian defocus blur, zero-padded to the input's size (the
    JAX version's "SAME" convolution; the kernel length is odd)."""
    if sigma <= 0:
        return frames
    k = _gauss_kernel1d(float(sigma), frames.dtype, frames.device)
    n = k.shape[0]
    x = frames[:, None]  # (B, 1, H, W)
    x = F.conv2d(x, k.reshape(1, 1, n, 1), padding=(n // 2, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, n), padding=(0, n // 2))
    return x[:, 0]


def brightness_gradient(frames: torch.Tensor, strength: float, horizontal: bool = True) -> torch.Tensor:
    """Multiplicative exposure ramp from (1-strength) to (1+strength)."""
    B, H, W = frames.shape
    n = W if horizontal else H
    ramp = 1.0 + strength * (2.0 * torch.arange(n, dtype=frames.dtype, device=frames.device) / (n - 1) - 1.0)
    ramp = ramp[None, None, :] if horizontal else ramp[None, :, None]
    return torch.clamp(frames * ramp, 0.0, 1.0)


def gamma_correct(frames: torch.Tensor, gamma: float) -> torch.Tensor:
    """Nonlinear sensor response: out = in ** gamma."""
    return torch.clamp(frames, 1e-6, 1.0) ** gamma


def vignette(frames: torch.Tensor, strength: float) -> torch.Tensor:
    """Radial falloff: corners darkened by `strength` (cos^4-style profile)."""
    B, H, W = frames.shape
    v, u = torch.meshgrid(
        torch.linspace(-1.0, 1.0, H, dtype=frames.dtype, device=frames.device),
        torch.linspace(-1.0, 1.0, W, dtype=frames.dtype, device=frames.device),
        indexing="ij",
    )
    r2 = (u * u + v * v) / 2.0  # 1.0 at the corners
    fall = 1.0 - strength * r2
    return torch.clamp(frames * fall[None], 0.0, 1.0)
