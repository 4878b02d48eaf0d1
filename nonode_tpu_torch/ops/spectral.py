"""Temporal spectral (Fourier neural operator) ops over the leading T axis
(counterpart of nonode_tpu/ops/spectral.py:28-109).

- timestep_embedding: sinusoidal embedding of [B, T] timesteps.
- SpectralConv: rfft over time, the first ``modes`` frequencies times learned
  complex weights stored as ``[in, out, modes, 2]`` floats, irfft back to T.
- TimeConv: x + LeakyReLU(spectral(x)); TimeConvX: x + spectral(x) over the
  stacked equivariant pair (x - x_mean, v), scale-0.1 init.

The FFT runs in fp32 (cuFFT on the card), as XLA ran it outside any kernel.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn import leaky_relu, uniform


def timestep_embedding(timesteps, embedding_dim: int, max_positions: int = 10000):
    """Sinusoidal embedding. timesteps: [B, T] -> [B, T, embedding_dim]."""
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    freqs = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                   device=timesteps.device) * -emb)
    args = timesteps.to(torch.float32)[..., None] * freqs
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class SpectralConv(nn.Module):
    """1D Fourier layer over the leading time axis of [T, ..., C] tensors."""

    def __init__(self, in_ch: int, out_ch: int, modes: int,
                 scale: float | None = None, *, device=None, generator=None):
        super().__init__()
        self.modes = modes
        scale = 1.0 / (in_ch * out_ch) if scale is None else scale
        self.weights1 = nn.Parameter(
            uniform((in_ch, out_ch, modes, 2), 0.0, 1.0, generator, device)
            * scale)

    def forward(self, x):
        t = x.shape[0]
        x_ft = torch.fft.rfft(x.to(torch.float32), dim=0)[: self.modes]
        w = torch.complex(self.weights1[..., 0].float(),
                          self.weights1[..., 1].float())      # [in, out, modes]
        out_ft = torch.einsum("m...i,iom->m...o", x_ft, w)
        # A real signal has a real zero-frequency term and, for even T, a
        # real Nyquist term (index T/2, kept when modes > T/2): irfft drops
        # their imaginary parts on the CPU, and they are dropped here
        # explicitly so that cuFFT's c2r transform cannot read them either.
        imag = out_ft.imag.clone()
        imag[0] = 0.0
        if t % 2 == 0 and out_ft.shape[0] > t // 2:
            imag[t // 2] = 0.0
        out_ft = torch.complex(out_ft.real, imag)
        # irfft zero-pads the missing high frequencies, as irfftn(s=[T]).
        return torch.fft.irfft(out_ft, n=t, dim=0)


class TimeConv(nn.Module):
    """h-channel time conv: x + LeakyReLU(spectral(x))."""

    def __init__(self, ch: int, modes: int, *, device=None, generator=None):
        super().__init__()
        self.t_conv = SpectralConv(ch, ch, modes, device=device,
                                   generator=generator)

    def forward(self, x):
        return x + leaky_relu(self.t_conv(x), 0.01).to(x.dtype)


class TimeConvX(nn.Module):
    """Equivariant-pair time conv: x + spectral(x), no nonlinearity.
    Operates on [T, ..., 3, 2] stacks of (x - x_mean, v)."""

    def __init__(self, ch: int, modes: int, *, device=None, generator=None):
        super().__init__()
        self.t_conv = SpectralConv(ch, ch, modes, scale=0.1, device=device,
                                   generator=generator)

    def forward(self, x):
        return x + self.t_conv(x).to(x.dtype)
