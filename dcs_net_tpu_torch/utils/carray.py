"""Complex tensors as (real, imag) pairs of real tensors.

The port keeps the JAX package's split representation rather than
``torch.complex64``: the packed block-kernel convolutions read re and im as
channel halves, and the CUDA kernels take plain float32 buffers.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

Tensor = torch.Tensor


class CArray(NamedTuple):
    """A complex tensor stored as two real tensors of the same shape."""

    re: Tensor
    im: Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.re.shape)

    @property
    def device(self) -> torch.device:
        return self.re.device

    def reshape(self, *shape) -> "CArray":
        return CArray(self.re.reshape(*shape), self.im.reshape(*shape))

    def __getitem__(self, idx) -> "CArray":
        return CArray(self.re[idx], self.im[idx])

    def __add__(self, other: "CArray") -> "CArray":
        return CArray(self.re + other.re, self.im + other.im)

    def __sub__(self, other: "CArray") -> "CArray":
        return CArray(self.re - other.re, self.im - other.im)

    def __mul__(self, other: Union["CArray", Tensor, float]) -> "CArray":
        if isinstance(other, CArray):
            # (a+bi)(c+di) = (ac - bd) + (ad + bc)i
            return CArray(
                self.re * other.re - self.im * other.im,
                self.re * other.im + self.im * other.re,
            )
        return CArray(self.re * other, self.im * other)

    __rmul__ = __mul__

    def abs(self) -> Tensor:
        """|z| with torch's complex subgradient abs'(0) = 0.

        A plain sqrt(re^2 + im^2) has a NaN gradient at exactly (0, 0), which
        complex dropout produces; the double where keeps the forward value and
        pins that gradient to 0."""
        h2 = self.re * self.re + self.im * self.im
        nz = h2 > 0
        return torch.where(nz, torch.sqrt(torch.where(nz, h2, torch.ones_like(h2))),
                           torch.zeros_like(h2))

    def angle(self, eps: float = 0.0) -> Tensor:
        """atan2(im, re + eps): the eps-shifted phase of the original code."""
        return torch.atan2(self.im, self.re + eps)

    @staticmethod
    def from_polar(mag: Tensor, phase: Tensor) -> "CArray":
        return CArray(mag * torch.cos(phase), mag * torch.sin(phase))

    @staticmethod
    def unpack_channels(x: Tensor, dim: int = -1) -> "CArray":
        """Split [re | im] packed along ``dim``."""
        re, im = torch.chunk(x, 2, dim=dim)
        return CArray(re, im)
