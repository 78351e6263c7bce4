"""Mask math: the complex ratio mask on (re, im) pairs and its bound, and the
real family's subtractive target."""

from __future__ import annotations

import torch

from dcs_net_tpu_torch.utils.carray import CArray


def crm(S: CArray, Y: CArray, eps: float = 1e-8) -> CArray:
    """Complex ratio mask M = (conj(Y) S) / (|Y|^2 + eps) of the target S
    over the noisy Y, componentwise."""
    denom = Y.re * Y.re + Y.im * Y.im + eps
    return CArray((Y.re * S.re + Y.im * S.im) / denom,
                  (Y.re * S.im - Y.im * S.re) / denom)


def real_subtractive_target(noise_mag: torch.Tensor,
                            noisy_mag: torch.Tensor) -> torch.Tensor:
    """sigmoid(|N| / |Y|), the DRS target mask. The division is unguarded,
    as in the JAX package: |Y| > 0 almost everywhere for real audio, and
    sigmoid(inf) saturates to 1."""
    return torch.sigmoid(noise_mag / noisy_mag)


def bound_crm(M: CArray, atan2_eps: float) -> CArray:
    """tanh-compress the magnitude and keep the eps-shifted phase, with the
    original code's double atan2 round trip: the phase is
    atan2(tanh|M| sin(th), tanh|M| cos(th) + eps) with th =
    atan2(M.im, M.re + eps), so bounding twice is not idempotent.

    cos(atan2(b, a)) = a / hypot(a, b) and sin(atan2(b, a)) = b / hypot(a, b)
    replace the transcendentals; at (a, b) == (0, 0) the guarded form gives
    (0, 0) where atan2 gives angle 0, a measure-zero difference."""
    mag_t = torch.tanh(M.abs())

    def unit(a, b):  # (cos, sin) of atan2(b, a), rational
        h2 = a * a + b * b
        pos = h2 > 0
        inv = torch.where(pos, torch.rsqrt(torch.where(pos, h2, torch.ones_like(h2))),
                          torch.zeros_like(h2))
        return a * inv, b * inv

    c1, s1 = unit(M.re + atan2_eps, M.im)
    c2, s2 = unit(mag_t * c1 + atan2_eps, mag_t * s1)
    return CArray(mag_t * c2, mag_t * s2)

