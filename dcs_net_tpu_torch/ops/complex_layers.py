"""Complex-valued layers (complexPyTorch semantics) on (re, im) pairs.

Each complex op is a pair of real sub-ops (f_r, f_i) combined as
``out = (f_r(x_r) - f_i(x_i)) + i (f_r(x_i) + f_i(x_r))``. As in the JAX
package the pair runs as ONE real conv or matmul: re and im are packed on the
channel axis and the weight becomes the block kernel [[Wr, Wi], [-Wi, Wr]].
Biases keep the torch pairing (b_r, b_i) -> (b_r - b_i, b_r + b_i).

Weights are stored in torch layouts (conv (Cout, Cin, kh, kw), convT
(Cin, Cout, kh, kw), linear (out, in)); ``convert.py`` maps the JAX tree.

``dtype`` (None, or bf16: ``ops/precision.py``) is the JAX layers' operand
type: at bf16 the conv, convT and linear layers round their inputs and their
float32 weights to bf16, sum in float32 and give bf16 outputs (the bias added
in bf16); the BN computes in float32 and returns its input's type.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from dcs_net_tpu_torch.ops import conv_engine as ce
from dcs_net_tpu_torch.ops import initializers as init
from dcs_net_tpu_torch.ops import precision as P
from dcs_net_tpu_torch.ops.real_layers import _pair, dropout_mask
from dcs_net_tpu_torch.utils.carray import CArray


def _block_kernel(wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """(kh, kw, cin, cout) pair -> (kh, kw, 2cin, 2cout) block kernel: a
    packed conv([x_r | x_i]) yields [x_r*Wr - x_i*Wi | x_r*Wi + x_i*Wr]."""
    top = torch.cat([wr, wi], dim=-1)
    bot = torch.cat([-wi, wr], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _combined_bias(br: torch.Tensor, bi: torch.Tensor) -> torch.Tensor:
    return torch.cat([br - bi, br + bi])


def _bias_pair(module: nn.Module, use_bias: bool, fan_in: int, features: int,
               generator: Optional[torch.Generator]) -> None:
    if use_bias:
        b_init = init.torch_bias_uniform(fan_in)
        module.bias_r = nn.Parameter(b_init((features,), generator))
        module.bias_i = nn.Parameter(b_init((features,), generator))
    else:
        module.register_parameter("bias_r", None)
        module.register_parameter("bias_i", None)


class ComplexConv2d(nn.Module):
    """complexPyTorch ComplexConv2d as one packed real conv."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride: Pair = (1, 1), padding: int = 0, use_bias: bool = True,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        fan_in, fan_out = in_features * kh * kw, features * kh * kw
        w_init = init.weight_init(weight_init, fan_in, fan_out)
        shape = (features, in_features, kh, kw)
        self.weight_r = nn.Parameter(w_init(shape, generator))
        self.weight_i = nn.Parameter(w_init(shape, generator))
        _bias_pair(self, use_bias, fan_in, features, generator)

    def block_kernel(self) -> torch.Tensor:
        """The packed real conv's kernel, HWIO (kh, kw, 2 cin, 2 cout)."""
        wr = self.weight_r.permute(2, 3, 1, 0)
        wi = self.weight_i.permute(2, 3, 1, 0)
        return _block_kernel(wr, wi)

    def forward(self, x: CArray) -> CArray:
        packed = P.cast(torch.cat([x.re, x.im], dim=-1), self.dtype)
        y = ce.conv2d(packed, P.cast(self.block_kernel(), self.dtype), self.stride,
                      self.padding)
        if self.bias_r is not None:
            y = y + P.cast(_combined_bias(self.bias_r, self.bias_i), self.dtype)
        return CArray.unpack_channels(y, dim=-1)


class ComplexConvTranspose2d(nn.Module):
    """complexPyTorch ComplexConvTranspose2d at stride 1 with 'same' padding,
    taking several inputs treated as channel-concatenated (the decoder's skip
    concat) and fusing the preceding nearest upsample
    (``conv_engine.upsampled_conv2d_multi``)."""

    def __init__(self, in_features: int, features: int, kernel_size,
                 stride: Pair = (1, 1), padding: int = 0, use_bias: bool = True,
                 weight_init: str = "xavier_uniform", upsample: Pair = (1, 1),
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        kh, kw = _pair(kernel_size)
        if _pair(stride) != (1, 1) or kh != kw or padding != kh // 2:
            raise NotImplementedError(
                "ComplexConvTranspose2d supports stride 1 with 'same' padding "
                "(the DCS-Net family's only form)")
        self.features = features
        self.upsample = _pair(upsample)
        fan_in, fan_out = features * kh * kw, in_features * kh * kw
        w_init = init.weight_init(weight_init, fan_in, fan_out)
        shape = (in_features, features, kh, kw)
        self.weight_r = nn.Parameter(w_init(shape, generator))
        self.weight_i = nn.Parameter(w_init(shape, generator))
        _bias_pair(self, use_bias, fan_in, features, generator)

    def forward(self, x: Union[CArray, Sequence[CArray]]) -> CArray:
        # CArray is itself a tuple: test for it before the sequence case
        xs = (x,) if isinstance(x, CArray) else tuple(x)
        cins = [xc.shape[-1] for xc in xs]
        if sum(cins) != self.weight_r.shape[0]:
            raise ValueError(f"inputs carry {sum(cins)} channels, the layer "
                             f"expects {self.weight_r.shape[0]}")
        # stride-1 convT == conv with the spatially flipped kernel
        dt = self.dtype
        fr = P.cast(torch.flip(self.weight_r.permute(2, 3, 0, 1), dims=(0, 1)), dt)
        fi = P.cast(torch.flip(self.weight_i.permute(2, 3, 0, 1), dims=(0, 1)), dt)
        fr_parts = torch.split(fr, cins, dim=2)
        fi_parts = torch.split(fi, cins, dim=2)
        ins = [P.cast(xc.re, dt) for xc in xs] + [P.cast(xc.im, dt) for xc in xs]
        w_cols = ([torch.cat([r, i], dim=-1) for r, i in zip(fr_parts, fi_parts)]
                  + [torch.cat([-i, r], dim=-1)
                     for r, i in zip(fr_parts, fi_parts)])
        y = ce.upsampled_conv2d_multi(ins, w_cols, self.upsample)
        y_re, y_im = y[..., :self.features], y[..., self.features:]
        if self.bias_r is not None:
            y_re = y_re + P.cast(self.bias_r - self.bias_i, dt)
            y_im = y_im + P.cast(self.bias_r + self.bias_i, dt)
        return CArray(y_re, y_im)


class ComplexLinear(nn.Module):
    """complexPyTorch ComplexLinear as one packed matmul."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 weight_init: str = "xavier_uniform",
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        w_init = init.weight_init(weight_init, in_features, features)
        self.weight_r = nn.Parameter(w_init((features, in_features), generator))
        self.weight_i = nn.Parameter(w_init((features, in_features), generator))
        _bias_pair(self, use_bias, in_features, features, generator)

    def forward(self, x: CArray) -> CArray:
        packed = torch.cat([x.re, x.im], dim=-1)
        wr, wi = self.weight_r.t(), self.weight_i.t()
        block = torch.cat([torch.cat([wr, wi], dim=-1),
                           torch.cat([-wi, wr], dim=-1)], dim=-2)
        if self.dtype is None:
            y = packed @ block
        else:
            y = P.matmul(P.cast(packed, self.dtype), P.cast(block, self.dtype))
        if self.bias_r is not None:
            y = y + P.cast(_combined_bias(self.bias_r, self.bias_i), self.dtype)
        return CArray.unpack_channels(y, dim=-1)


class ComplexBatchNorm2d(nn.Module):
    """Trabelsi whitening complex BN (complexPyTorch ComplexBatchNorm2d).

    Per channel: centre by the complex mean, whiten by the inverse square root
    of the 2x2 (re, im) covariance, then apply a learnable 2x2 Gamma and a
    complex beta. Gamma_rr = Gamma_ii = 1/sqrt(2) and running V_rr = V_ii =
    1/sqrt(2) at init. The covariance diagonal gets +eps, Cri does not.
    Running stats follow torch momentum semantics with the unbiased variance.
    Statistics run in float32 over every axis but the last (channels).
    """

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        s = 0.7071067811865476
        self.eps = eps
        self.momentum = momentum
        self.gamma_rr = nn.Parameter(torch.full((features,), s))
        self.gamma_ii = nn.Parameter(torch.full((features,), s))
        self.gamma_ri = nn.Parameter(torch.zeros(features))
        self.beta_r = nn.Parameter(torch.zeros(features))
        self.beta_i = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean_r", torch.zeros(features))
        self.register_buffer("mean_i", torch.zeros(features))
        self.register_buffer("vrr", torch.full((features,), s))
        self.register_buffer("vii", torch.full((features,), s))
        self.register_buffer("vri", torch.zeros(features))

    def forward(self, x: CArray) -> CArray:
        xr, xi = x.re.float(), x.im.float()
        if self.training:
            dims = tuple(range(xr.dim() - 1))
            mean_r, mean_i = xr.mean(dims), xi.mean(dims)
            cr_, ci_ = xr - mean_r, xi - mean_i
            vrr = (cr_ * cr_).mean(dims) + self.eps
            vii = (ci_ * ci_).mean(dims) + self.eps
            vri = (cr_ * ci_).mean(dims)
            with torch.no_grad():
                n = xr.numel() // xr.shape[-1]
                unb = n / max(n - 1, 1)
                m = self.momentum
                self.mean_r.mul_(1 - m).add_(m * mean_r)
                self.mean_i.mul_(1 - m).add_(m * mean_i)
                self.vrr.mul_(1 - m).add_(m * (vrr - self.eps) * unb)
                self.vii.mul_(1 - m).add_(m * (vii - self.eps) * unb)
                self.vri.mul_(1 - m).add_(m * vri * unb)
        else:
            mean_r, mean_i = self.mean_r, self.mean_i
            vrr = self.vrr + self.eps
            vii = self.vii + self.eps
            vri = self.vri
        # inverse square root of [[vrr, vri], [vri, vii]]
        det = vrr * vii - vri * vri
        s = torch.sqrt(det)
        t = torch.sqrt(vrr + vii + 2.0 * s)
        inv_st = 1.0 / (s * t)
        rrr = (vii + s) * inv_st
        rii = (vrr + s) * inv_st
        rri = -vri * inv_st
        # whitening + Gamma + centring folded into one per-channel 2x2 affine
        grr, gii, gri = self.gamma_rr, self.gamma_ii, self.gamma_ri
        a = grr * rrr + gri * rri
        b = grr * rri + gri * rii
        c = gri * rrr + gii * rri
        d = gri * rri + gii * rii
        cr = self.beta_r - a * mean_r - b * mean_i
        ci = self.beta_i - c * mean_r - d * mean_i
        out_r = xr * a + xi * b + cr
        out_i = xr * c + xi * d + ci
        return CArray(out_r.to(x.re.dtype), out_i.to(x.im.dtype))


class ComplexDropout(nn.Module):
    """Dropout with independent masks for re and im; the identity in eval.
    The masks come from ``generator`` (the global generator where it is
    None): ``DCSNet.set_dropout_generator`` sets it, so that a trainer can
    key each epoch's masks. The masks and the product are float32 at least
    (a bf16 activation widened, scaled by 1 / keep and rounded once), so
    that a bf16 run draws the float32 run's masks."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: CArray) -> CArray:
        if not self.training or self.rate == 0.0:
            return x
        acc = torch.promote_types(x.re.dtype, torch.float32)
        mask = dropout_mask((2,) + tuple(x.shape), x.re.new_empty((), dtype=acc),
                            self.rate, self.generator)
        return CArray((x.re * mask[0]).to(x.re.dtype), (x.im * mask[1]).to(x.im.dtype))


def complex_mul_bcast(x: CArray, a: CArray) -> CArray:
    """x * a (complex product) with a broadcast CBAM attention factor
    ((B, 1, 1, C) or (B, H, W, 1))."""
    return x * a


def complex_relu(x: CArray) -> CArray:
    return CArray(torch.relu(x.re), torch.relu(x.im))


def complex_leaky_relu(x: CArray, negative_slope: float = 0.01) -> CArray:
    return CArray(F.leaky_relu(x.re, negative_slope),
                  F.leaky_relu(x.im, negative_slope))


def complex_sigmoid(x: CArray) -> CArray:
    return CArray(torch.sigmoid(x.re), torch.sigmoid(x.im))


def complex_adaptive_avg_pool_1(x: CArray) -> CArray:
    """(B, H, W, C) -> (B, 1, 1, C) complex mean, summed in float32 (at
    least) and returned in x's type."""
    acc = torch.promote_types(x.re.dtype, torch.float32)
    return CArray(*(p.mean(dim=(-3, -2), keepdim=True, dtype=acc).to(p.dtype)
                    for p in x))


def complex_adaptive_max_pool_1(x: CArray, *, faithful_avg: bool) -> CArray:
    """The original code's complex 'max' pool is an average pool
    (``faithful_avg``); otherwise a componentwise max."""
    if faithful_avg:
        return complex_adaptive_avg_pool_1(x)
    return CArray(x.re.amax(dim=(-3, -2), keepdim=True),
                  x.im.amax(dim=(-3, -2), keepdim=True))
