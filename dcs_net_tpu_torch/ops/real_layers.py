"""Real-valued layers of the DR / DRS U-Net, torch semantics on NHWC
activations; the port's copy of the JAX package's ``ops/real_layers.py``.

Weights are stored in torch layouts (conv (Cout, Cin, kh, kw), convT
(Cin, Cout, kh, kw), linear (out, in)); ``convert.py`` maps the JAX tree.
The convolutions go through ``ops/conv_engine.py``: a stride-1 "same" conv
with a small output count (the spatial attention's) is kernel 2, the
decoder's fused skip-concat + upsample + convT is kernel 3, every other conv
(the strided encoder convs, the 1x1 channel-attention FCs) is ``F.conv2d``.
The JAX package's ``ops/widen.py`` is a TPU lane-layout device with no
numerical effect; its ``mul_bcast`` is the broadcast product ``x * a``.

``dtype`` (None, or bf16: ``ops/precision.py``) is the JAX layers' operand
type: at bf16 the conv, convT and linear layers round their inputs and their
float32 weights to bf16, sum in float32 and give bf16 outputs, the bias
rounded to bf16 and added in bf16 (``y + bias.astype(y.dtype)``); the
dropout divides a bf16 activation by the keep rate rounded to bf16, as JAX's
``x / keep`` does, and rounds once. The BN computes in float32 and returns
its input's type.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from dcs_net_tpu_torch.ops import conv_engine as ce
from dcs_net_tpu_torch.ops import initializers as init
from dcs_net_tpu_torch.ops import precision as P

Pair = Tuple[int, int]


def _pair(k) -> Pair:
    return (k, k) if isinstance(k, int) else tuple(k)


def dropout_mask(shape: Sequence[int], like: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """An inverted-dropout mask of ``shape``, ``like``'s dtype and device:
    1 / (1 - rate) where a Bernoulli draw from ``generator`` (the global
    generator where it is None; it must live on that device) keeps the
    value, 0 elsewhere."""
    keep = 1.0 - rate
    return like.new_empty(shape).bernoulli_(keep, generator=generator).div_(keep)


def _bias(module: nn.Module, use_bias: bool, fan_in: int, features: int,
          generator: Optional[torch.Generator]) -> None:
    if use_bias:
        module.bias = nn.Parameter(
            init.torch_bias_uniform(fan_in)((features,), generator))
    else:
        module.register_parameter("bias", None)


class Conv2d(nn.Module):
    """torch.nn.Conv2d: symmetric zero padding, cross-correlation."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride=(1, 1), padding: int = 0, use_bias: bool = True,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        fan_in, fan_out = in_features * kh * kw, features * kh * kw
        self.weight = nn.Parameter(init.weight_init(weight_init, fan_in, fan_out)(
            (features, in_features, kh, kw), generator))
        _bias(self, use_bias, fan_in, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        y = ce.conv2d(P.cast(x, dt), P.cast(self.weight.permute(2, 3, 1, 0), dt),
                      self.stride, self.padding)
        return y if self.bias is None else y + P.cast(self.bias, dt)


class ConvTranspose2d(nn.Module):
    """torch.nn.ConvTranspose2d at stride 1 with 'same' padding, taking
    several inputs treated as channel-concatenated (the decoder's skip
    concat) and fusing the preceding nearest upsample: the conv with the
    spatially flipped kernel, ``conv_engine.upsampled_conv2d_multi`` (at
    upsample (1, 1) that is the plain stride-1 conv)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride=(1, 1), padding: int = 0, use_bias: bool = True,
                 weight_init: str = "xavier_uniform", upsample=(1, 1),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        kh, kw = _pair(kernel_size)
        if _pair(stride) != (1, 1) or kh != kw or padding != kh // 2:
            raise NotImplementedError(
                "ConvTranspose2d supports stride 1 with 'same' padding (the "
                "DCS-Net family's only form)")
        self.upsample = _pair(upsample)
        fan_in, fan_out = features * kh * kw, in_features * kh * kw
        self.weight = nn.Parameter(init.weight_init(weight_init, fan_in, fan_out)(
            (in_features, features, kh, kw), generator))
        _bias(self, use_bias, fan_in, features, generator)

    def forward(self, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
        xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
        cins = [xi.shape[-1] for xi in xs]
        if sum(cins) != self.weight.shape[0]:
            raise ValueError(f"inputs carry {sum(cins)} channels, the layer "
                             f"expects {self.weight.shape[0]}")
        dt = self.dtype
        flipped = P.cast(torch.flip(self.weight.permute(2, 3, 0, 1), dims=(0, 1)), dt)
        y = ce.upsampled_conv2d_multi([P.cast(xi, dt) for xi in xs],
                                      torch.split(flipped, cins, dim=2), self.upsample)
        return y if self.bias is None else y + P.cast(self.bias, dt)


class Linear(nn.Module):
    """torch.nn.Linear: y = x W^T + b."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(init.weight_init(weight_init, in_features, features)(
            (features, in_features), generator))
        _bias(self, use_bias, in_features, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return F.linear(x, self.weight, self.bias)
        y = P.matmul(P.cast(x, self.dtype), P.cast(self.weight.t(), self.dtype))
        return y if self.bias is None else y + P.cast(self.bias, self.dtype)


class BatchNorm2d(nn.Module):
    """torch.nn.BatchNorm2d over NHWC. Train: normalise with the biased batch
    variance; the running statistics move with momentum 0.1 and the UNBIASED
    variance. Eval: the running statistics. Statistics in float32 (float64
    for a float64 input) over every axis but the last (channels)."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = tuple(range(x32.dim() - 1))
            var, mean = torch.var_mean(x32, dim=dims, correction=0)
            with torch.no_grad():
                n = x32.numel() // x32.shape[-1]
                m = self.momentum
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.mean, self.var
        # one scale and shift a channel
        scale = torch.rsqrt(var + self.eps) * self.scale
        shift = self.bias - mean * scale
        return (x32 * scale + shift).to(x.dtype)


class Dropout(nn.Module):
    """torch inverted dropout; the identity in eval. The mask comes from
    ``generator`` (the global generator where it is None), drawn in float32
    (at least) whatever x's type, so that a bf16 run draws the float32 run's
    masks. A float32 x is multiplied by the mask; a bf16 x divided by the
    keep rate rounded to bf16 where the mask keeps it, rounded once (the JAX
    ``jnp.where(mask, x / keep, 0)``, whose Python ``keep`` takes x's
    type)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        acc = torch.promote_types(x.dtype, torch.float32)
        mask = dropout_mask(x.shape, x.new_empty((), dtype=acc), self.rate, self.generator)
        if x.dtype == acc:
            return x * mask
        keep = float(torch.tensor(1.0 - self.rate, dtype=x.dtype))
        return torch.where(mask != 0, x.to(acc) / keep, 0.0).to(x.dtype)


def adaptive_avg_pool_1(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d(1) over NHWC -> (B, 1, 1, C)."""
    return x.mean(dim=(-3, -2), keepdim=True)


def adaptive_max_pool_1(x: torch.Tensor) -> torch.Tensor:
    return x.amax(dim=(-3, -2), keepdim=True)
