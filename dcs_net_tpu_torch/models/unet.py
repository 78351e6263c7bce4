"""The DCS-Net U-Net family (DR / DC / DRS / DCS) as one ``nn.Module``.

Topology: BN of the input; 7 strided conv encoders (conv -> BN -> ReLU ->
dropout); a bidirectional LSTM + linear bottleneck over the flattened latent;
7 decoder stages of [skip CBAM -> fused skip-concat + nearest upsample +
convT -> BN -> LeakyReLU -> CBAM -> dropout] (no BN/activation/CBAM after the
last). The complex variants (DC, DCS) run every op as its complex counterpart
on (re, im) pairs with half the channels, take the spectrogram and end in the
``bound_crm`` bound; the real variants (DR, DRS) take its magnitude and end
in a sigmoid. Activations are NHWC (channels last) like the JAX package; the
input and the mask are (B, F, T). ``subtractive`` does not change the module,
only how the mask is used (``models/enhance.py``, ``train/steps.py``).

Kernels on this path: kernel 2 runs the 13 CBAM spatial-attention convs
(``ops/attention.py``; in eval, complex and real, as the fused gate: pool,
then conv + sigmoid + product) and kernel 3 the 7 decoder convs (see
``ops/conv_engine.py``).

``compute_dtype="bfloat16"`` (the JAX package's mixed precision) runs every
variant's convs, linear layer and LSTM products on bf16 operands with
float32 sums and bf16 activations (BN in float32), the parameters float32,
the output bound (complex) or sigmoid (real) in float32; kernels 2 and 3
then take their bf16 classes, in both directions under autograd (training
at bf16: the train-mode BN in float32 on the widened values, the gradients
that reach the parameters float32, each cast's own backward; the complex
dropout in float32 on the widened values, the real one the JAX ``x / keep``
in bf16).
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from dcs_net_tpu_torch.core.config import ModelConfig, Quirks
from dcs_net_tpu_torch.ops import attention as att
from dcs_net_tpu_torch.ops import complex_layers as cl
from dcs_net_tpu_torch.ops import masks
from dcs_net_tpu_torch.ops import precision as P
from dcs_net_tpu_torch.ops import real_layers as rl
from dcs_net_tpu_torch.ops.lstm import LSTM, ComplexLSTM
from dcs_net_tpu_torch.utils.carray import CArray
from dcs_net_tpu_torch.utils.device import DeviceLike, resolve_device

SpecLike = Union[torch.Tensor, CArray]


class DCSNet(nn.Module):
    """``DCSNet(cfg, quirks, device=..., seed=...)``: weights drawn from
    ``torch.Generator().manual_seed(seed)`` on the CPU, then moved to
    ``device`` (CUDA unless ``device="cpu"``), so one seed gives the same
    weights on every device."""

    def __init__(self, cfg: ModelConfig, quirks: Quirks = Quirks(), *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        m = cfg
        if m.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={m.param_dtype!r}: the port keeps its parameters "
                "in float32")
        dt = P.operand_dtype(m.compute_dtype)
        if m.fc_features != m.latent_channels:
            raise ValueError(
                f"fc_features ({m.fc_features}) must equal the latent channel "
                f"count ({m.latent_channels}) for the latent reshape")
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.cfg = m
        self.quirks = quirks
        cx = m.complex_valued
        Conv, BN = (cl.ComplexConv2d, cl.ComplexBatchNorm2d) if cx else (
            rl.Conv2d, rl.BatchNorm2d)
        Drop = cl.ComplexDropout if cx else rl.Dropout

        def attention(channels: int):
            if cx:
                return (att.ComplexChannelAttention(
                            channels, m.ca_reduction,
                            maxpool_is_avg=quirks.complex_maxpool_is_avg,
                            weight_init=m.init, generator=g, dtype=dt),
                        att.ComplexSpatialAttention(
                            m.sa_kernel, weight_init=m.init, generator=g, dtype=dt))
            return (att.RealChannelAttention(
                        channels, m.ca_reduction, max_only=quirks.real_ca_max_only,
                        weight_init=m.init, generator=g, dtype=dt),
                    att.RealSpatialAttention(m.sa_kernel, weight_init=m.init,
                                             generator=g, dtype=dt))

        self.initial_bn = BN(1)
        for i in range(m.n_layers):
            cin, cout = m.enc_channels(i)
            self.add_module(f"enc{i}_conv", Conv(
                cin, cout, m.kernel_e[i], stride=m.stride_e[i],
                padding=m.kernel_e[i] // 2, weight_init=m.init, generator=g, dtype=dt))
            self.add_module(f"enc{i}_bn", BN(cout))
        self.dropout_conv = Drop(m.dropout_conv)
        self.dropout_fc = Drop(m.dropout_fc)

        d = 2 if m.lstm_bidir else 1
        Lstm, Lin = (ComplexLSTM, cl.ComplexLinear) if cx else (LSTM, rl.Linear)
        self.lstm = Lstm(m.latent_channels, m.lstm_hidden, m.lstm_layers,
                         m.lstm_bidir, generator=g, dtype=dt)
        self.fc = Lin(m.lstm_hidden * d, m.fc_features, weight_init=m.init,
                      generator=g, dtype=dt)

        ConvT = cl.ComplexConvTranspose2d if cx else rl.ConvTranspose2d
        for i in range(m.n_layers):
            skip_c = m._ch(m.channels[m.n_layers - i])
            cin, cout = m.dec_channels(i)
            last = i == m.n_layers - 1
            if m.attention:
                ca, sa = attention(skip_c)
                self.add_module(f"skip{i}_ca", ca)
                self.add_module(f"skip{i}_sa", sa)
            self.add_module(f"dec{i}_convt", ConvT(
                cin, cout, m.kernel_d[i], padding=m.kernel_d[i] // 2,
                weight_init=m.init, upsample=m.upsample[i], generator=g, dtype=dt))
            if not last:
                self.add_module(f"dec{i}_bn", BN(cout))
                if m.attention:
                    ca, sa = attention(cout)
                    self.add_module(f"dec{i}_ca", ca)
                    self.add_module(f"dec{i}_sa", sa)
        self.to(dev)

    def set_dropout_generator(self, generator: Optional[torch.Generator]) -> None:
        """Draw the dropout masks from ``generator`` (on the model's device),
        or from the global generator where it is None."""
        self.dropout_conv.generator = generator
        self.dropout_fc.generator = generator

    @property
    def dropout_generator(self) -> Optional[torch.Generator]:
        """The generator the dropout masks are drawn from (None: the global
        one)."""
        return self.dropout_conv.generator

    def _attend(self, name: str, x):
        """x with the CBAM pair ``<name>_ca`` and ``<name>_sa`` applied."""
        ca, sa = getattr(self, f"{name}_ca"), getattr(self, f"{name}_sa")
        if self.cfg.complex_valued:
            return sa.gate(cl.complex_mul_bcast(x, ca(x)))
        return sa.gate(x * ca(x))

    def forward(self, x: SpecLike, lstm_state=None, return_lstm_state: bool = False):
        """x: CArray spectrogram (B, F, T) for the complex variants, its
        magnitude (B, F, T) for the real ones. Returns the bounded mask of
        the same kind in float32; with ``return_lstm_state=True`` returns
        ``(mask, lstm_state)`` for the streaming path."""
        m = self.cfg
        cx = m.complex_valued
        if cx != isinstance(x, CArray):
            raise TypeError("the complex variants take a CArray, the real ones "
                            "a magnitude tensor")
        if cx:
            e = self.initial_bn(CArray(x.re[..., None], x.im[..., None]))
            relu = cl.complex_relu
        else:
            e = self.initial_bn(x[..., None])
            relu = torch.relu
        enc_out = [e]
        for i in range(m.n_layers):
            e = getattr(self, f"enc{i}_conv")(e)
            e = getattr(self, f"enc{i}_bn")(e)
            e = self.dropout_conv(relu(e))
            enc_out.append(e)

        parts = (e.re, e.im) if cx else (e,)
        B, Fp, Tp, C = parts[0].shape
        if m.lstm_time_major:
            # streaming order: sequence over (t, f), so chunks concatenated
            # along time form one continuous sequence
            seq = [p.transpose(1, 2).reshape(B, Tp * Fp, C) for p in parts]
        else:
            # f-major, as torch.flatten(e, 2, 3).permute(0, 2, 1) on NCHW
            seq = [p.reshape(B, Fp * Tp, C) for p in parts]
        lstm_out, new_state = self.lstm(CArray(*seq) if cx else seq[0], lstm_state)
        fc_out = self.fc(lstm_out)
        if cx or m.dropout:     # the real net gates its FC dropout, the complex not
            fc_out = self.dropout_fc(fc_out)
        outs = (fc_out.re, fc_out.im) if cx else (fc_out,)
        if m.lstm_time_major:
            outs = [p.reshape(B, Tp, Fp, C).transpose(1, 2) for p in outs]
        else:
            outs = [p.reshape(B, Fp, Tp, C) for p in outs]
        d = CArray(*outs) if cx else outs[0]

        for i in range(m.n_layers):
            skip = enc_out[m.n_layers - i]
            if m.attention:
                skip = self._attend(f"skip{i}", skip)
            d = getattr(self, f"dec{i}_convt")((d, skip))
            if i != m.n_layers - 1:
                d = getattr(self, f"dec{i}_bn")(d)
                d = cl.complex_leaky_relu(d) if cx else F.leaky_relu(d)
                if m.attention:
                    d = self._attend(f"dec{i}", d)
            d = self.dropout_conv(d)

        # output bound in float32 (atan2/tanh of the bound are precision-sensitive)
        if cx:
            out = masks.bound_crm(CArray(d.re[..., 0].float(), d.im[..., 0].float()),
                                  m.atan2_eps)
        else:
            out = torch.sigmoid(d[..., 0].to(torch.promote_types(d.dtype, torch.float32)))
        if return_lstm_state:
            return out, new_state
        return out
