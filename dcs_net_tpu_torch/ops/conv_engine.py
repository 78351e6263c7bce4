"""Convolution math of the DCS U-Net on NHWC activations and HWIO weights.

Three classes, as in the JAX package's ``ops/conv_engine.py``, without its
TPU-only reformulations (tap-fold, space-to-depth, row-dot, phase folds):

* :func:`conv2d` -- a stride-1 "same" conv with a small output count
  (``use_tuned``: odd K <= 7, Cout <= 16) is kernel 2
  (``ops/cuda_conv.py``); every other conv (the strided encoder convs, the
  1x1 channel-attention FCs) is ``F.conv2d``, as the JAX package leaves those
  to XLA.
* :func:`upsampled_conv2d_multi` -- the decoder's fused skip-concat +
  nearest-upsample + "same" conv in its unified form: the upsampled conv's
  output phases all read one D x D window of the small-resolution input, so
  the kernel folds into ``kbig`` (Dh*Dw, Cin, s_h*s_w*Cout), one VALID tap
  correlation runs as kernel 3 (``ops/cuda_tapconv.py``), and the phases
  interleave back.

At bf16 operands (the JAX package's ``compute_dtype="bfloat16"``) both take
bf16 inputs and weights and give bf16 outputs from float32 sums: kernel 3's
bf16 class; ``F.conv2d`` in bf16 on the card (cuDNN sums bf16 products in
float32), and on the CPU in float32 on the bf16 values, rounded once, since
a CPU bf16 convolution leaves its accumulation unspecified. Kernel 2's conv
entry takes its bf16 class at the spatial attention's (7, 4, 2) and the real
one's (7, 2, 1). Under
autograd (training at bf16) each input gradient is bf16 and each weight
gradient in the weight's type, as the JAX package's rules give them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.ops import cuda_conv
from dcs_net_tpu_torch.ops.cuda_tapconv import tapconv_valid
from dcs_net_tpu_torch.utils.device import device_cache


def use_tuned(kernel_size: int, stride: Tuple[int, int], padding: int,
              cout: int) -> bool:
    """Stride-1 'same' conv that kernel 2 takes (odd K > 1, see
    ``cuda_conv.applicable``)."""
    return (tuple(stride) == (1, 1) and kernel_size > 1
            and padding == kernel_size // 2
            and cuda_conv.applicable(kernel_size, cout))


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: Tuple[int, int],
           padding: int) -> torch.Tensor:
    """Cross-correlation without bias: x (B, H, W, Cin), w (K, K, Cin, Cout)
    -> (B, HO, WO, Cout), torch Conv2d semantics, in x's type (bf16: bf16
    operands, float32 sums)."""
    K, _, _, cout = w.shape
    if use_tuned(K, stride, padding, cout):
        return cuda_conv.conv2d_same_small_cout(
            x.contiguous(), w.contiguous(), cuda_conv.zero_bias(cout, x.device))
    xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        y = F.conv2d(xn.float(), wn.float(), stride=tuple(stride),
                     padding=padding).to(torch.bfloat16)
    else:
        y = F.conv2d(xn, wn, stride=tuple(stride), padding=padding)
    return y.permute(0, 2, 3, 1)


@device_cache(32)
def _unified_fold(K: int, p: int, s: int, device: torch.device
                  ) -> Tuple[int, torch.Tensor]:
    """(d_min, Fold (s, D, K)) on ``device``: Fold[r, d, t] == 1 iff tap t of
    output phase r reads input offset d_min + d, i.e. floor((r + t - p) / s)
    == d_min + d. D is 3 for the family's k=3 stages whatever s in {1, 2}.
    Cached per device: a host-to-device copy on every call would stall the
    host until the card drains its queue."""
    ds = [(r + t - p) // s for r in range(s) for t in range(K)]
    d_min, d_max = min(ds), max(ds)
    fold = np.zeros((s, d_max - d_min + 1, K), np.float32)
    for r in range(s):
        for t in range(K):
            fold[r, (r + t - p) // s - d_min, t] = 1.0
    return d_min, torch.from_numpy(fold).to(device)


def _interleave_phases(yp: torch.Tensor, s_h: int, s_w: int,
                       cout: int) -> torch.Tensor:
    """(B, H, W, (r_h, r_w, co)) -> (B, s_h*H, s_w*W, co): output pixel
    (h*s_h + r_h, w*s_w + r_w) is phase (r_h, r_w) of input pixel (h, w)."""
    B, H, W, _ = yp.shape
    y = yp.reshape(B, H, W, s_h, s_w, cout).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, s_h * H, s_w * W, cout)


def upsampled_conv2d_multi(xs: Sequence[torch.Tensor],
                           ws: Sequence[torch.Tensor],
                           scale: Tuple[int, int]) -> torch.Tensor:
    """conv2d_same(nearest_upsample(concat(xs, -1), scale), concat(ws, 2)).

    xs: inputs (B, H, W, Cin_j); ws: (K, K, Cin_j, Cout), K odd, padding K//2.
    Returns (B, s_h*H, s_w*W, Cout). The fold sums the weights in float32
    (at least), then rounds ``kbig`` to their type once, as the JAX
    package's per-phase fold does."""
    K = ws[0].shape[0]
    p = K // 2
    s_h, s_w = scale
    cout = ws[0].shape[-1]
    dh_min, fh = _unified_fold(K, p, s_h, xs[0].device)
    dw_min, fw = _unified_fold(K, p, s_w, xs[0].device)
    Dh, Dw = fh.shape[1], fw.shape[1]
    w = torch.cat(list(ws), dim=2) if len(ws) > 1 else ws[0]
    # kbig[(dh, dw), ci, (r_h, r_w, co)]
    #   = sum_{t, v} Fold_h[r_h, dh, t] * Fold_w[r_w, dw, v] * w[t, v, ci, co]
    acc = torch.promote_types(w.dtype, torch.float32)
    kbig = torch.einsum("adt,bev,tvio->deiabo", fh.to(acc), fw.to(acc), w.to(acc)).to(
        w.dtype).reshape(Dh * Dw, w.shape[2], s_h * s_w * cout).contiguous()
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    # the window's zero padding goes to the tap conv, whose input gradient
    # then writes x's own pixels only
    pad = (-dh_min, dh_min + Dh - 1, -dw_min, dw_min + Dw - 1)
    yp = tapconv_valid(x.contiguous(), kbig, Dh, Dw, pad)
    return _interleave_phases(yp, s_h, s_w, cout)
