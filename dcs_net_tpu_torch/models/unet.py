"""The DCS-Net U-Net, complex branch (DC / DCS), as one ``nn.Module``.

Topology: complex whitening BN; 7 strided complex conv encoders (conv -> BN ->
ReLU -> dropout); a bidirectional complex LSTM + complex linear bottleneck over
the f-major flattened latent; 7 decoder stages of [skip CBAM -> fused
skip-concat + nearest upsample + convT -> BN -> LeakyReLU -> CBAM -> dropout]
(no BN/activation/CBAM after the last); the ``bound_crm`` output bound in
float32. Activations are NHWC (channels last) like the JAX package; the input
and the mask are (B, F, T) re/im pairs.

Kernels on this path: kernel 2 runs the 13 CBAM spatial-attention gates
(``ops/attention.py``: pool, then conv + sigmoid + product) and kernel 3 the 7
decoder convs (see ``ops/conv_engine.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from dcs_net_tpu_torch.core.config import ModelConfig, Quirks
from dcs_net_tpu_torch.ops import attention as att
from dcs_net_tpu_torch.ops import complex_layers as cl
from dcs_net_tpu_torch.ops import masks
from dcs_net_tpu_torch.ops.lstm import ComplexLSTM
from dcs_net_tpu_torch.utils.carray import CArray
from dcs_net_tpu_torch.utils.device import DeviceLike, resolve_device


class DCSNet(nn.Module):
    """``DCSNet(cfg, quirks, device=..., seed=...)``: weights drawn from
    ``torch.Generator().manual_seed(seed)`` on the CPU, then moved to
    ``device`` (CUDA unless ``device="cpu"``), so one seed gives the same
    weights on every device."""

    def __init__(self, cfg: ModelConfig, quirks: Quirks = Quirks(), *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        m = cfg
        if not m.complex_valued:
            raise NotImplementedError(
                "the real family (DR/DRS) is not yet ported to "
                "dcs_net_tpu_torch: ROADMAP Queue 1 item 3")
        if m.compute_dtype != "float32" or m.param_dtype != "float32":
            raise NotImplementedError(
                "the port runs float32 only; reduced-precision compute is "
                "ROADMAP Queue 1 item 4")
        if m.fc_features != m.latent_channels:
            raise ValueError(
                f"fc_features ({m.fc_features}) must equal the latent channel "
                f"count ({m.latent_channels}) for the latent reshape")
        dev = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.cfg = m
        self.quirks = quirks

        self.initial_bn = cl.ComplexBatchNorm2d(1)
        for i in range(m.n_layers):
            cin, cout = m.enc_channels(i)
            self.add_module(f"enc{i}_conv", cl.ComplexConv2d(
                cin, cout, m.kernel_e[i], stride=m.stride_e[i],
                padding=m.kernel_e[i] // 2, weight_init=m.init, generator=g))
            self.add_module(f"enc{i}_bn", cl.ComplexBatchNorm2d(cout))
        self.dropout_conv = cl.ComplexDropout(m.dropout_conv)
        self.dropout_fc = cl.ComplexDropout(m.dropout_fc)

        d = 2 if m.lstm_bidir else 1
        self.lstm = ComplexLSTM(m.latent_channels, m.lstm_hidden,
                                m.lstm_layers, m.lstm_bidir, generator=g)
        self.fc = cl.ComplexLinear(m.lstm_hidden * d, m.fc_features,
                                   weight_init=m.init, generator=g)

        for i in range(m.n_layers):
            skip_c = m._ch(m.channels[m.n_layers - i])
            cin, cout = m.dec_channels(i)
            last = i == m.n_layers - 1
            if m.attention:
                self.add_module(f"skip{i}_ca", att.ComplexChannelAttention(
                    skip_c, m.ca_reduction,
                    maxpool_is_avg=quirks.complex_maxpool_is_avg,
                    weight_init=m.init, generator=g))
                self.add_module(f"skip{i}_sa", att.ComplexSpatialAttention(
                    m.sa_kernel, weight_init=m.init, generator=g))
            self.add_module(f"dec{i}_convt", cl.ComplexConvTranspose2d(
                cin, cout, m.kernel_d[i], padding=m.kernel_d[i] // 2,
                weight_init=m.init, upsample=m.upsample[i], generator=g))
            if not last:
                self.add_module(f"dec{i}_bn", cl.ComplexBatchNorm2d(cout))
                if m.attention:
                    self.add_module(f"dec{i}_ca", att.ComplexChannelAttention(
                        cout, m.ca_reduction,
                        maxpool_is_avg=quirks.complex_maxpool_is_avg,
                        weight_init=m.init, generator=g))
                    self.add_module(f"dec{i}_sa", att.ComplexSpatialAttention(
                        m.sa_kernel, weight_init=m.init, generator=g))
        self.to(dev)

    def forward(self, x: CArray, lstm_state=None, return_lstm_state: bool = False):
        """x: CArray spectrogram (B, F, T). Returns the bounded mask, a CArray
        (B, F, T) in float32; with ``return_lstm_state=True`` returns
        ``(mask, lstm_state)`` for the streaming path."""
        if not isinstance(x, CArray):
            raise TypeError("the complex variant expects a CArray input")
        m = self.cfg
        e = self.initial_bn(CArray(x.re[..., None], x.im[..., None]))
        enc_out = [e]
        for i in range(m.n_layers):
            e = getattr(self, f"enc{i}_conv")(e)
            e = getattr(self, f"enc{i}_bn")(e)
            e = self.dropout_conv(cl.complex_relu(e))
            enc_out.append(e)

        B, Fp, Tp, C = e.shape
        if m.lstm_time_major:
            # streaming order: sequence over (t, f), so chunks concatenated
            # along time form one continuous sequence
            seq = CArray(e.re.transpose(1, 2).reshape(B, Tp * Fp, C),
                         e.im.transpose(1, 2).reshape(B, Tp * Fp, C))
        else:
            # f-major, as torch.flatten(e, 2, 3).permute(0, 2, 1) on NCHW
            seq = e.reshape(B, Fp * Tp, C)
        lstm_out, new_state = self.lstm(seq, lstm_state)
        fc_out = self.dropout_fc(self.fc(lstm_out))
        if m.lstm_time_major:
            d = CArray(fc_out.re.reshape(B, Tp, Fp, C).transpose(1, 2),
                       fc_out.im.reshape(B, Tp, Fp, C).transpose(1, 2))
        else:
            d = fc_out.reshape(B, Fp, Tp, C)

        for i in range(m.n_layers):
            skip = enc_out[m.n_layers - i]
            if m.attention:
                skip = cl.complex_mul_bcast(skip, getattr(self, f"skip{i}_ca")(skip))
                skip = getattr(self, f"skip{i}_sa").gate(skip)
            d = getattr(self, f"dec{i}_convt")((d, skip))
            if i != m.n_layers - 1:
                d = getattr(self, f"dec{i}_bn")(d)
                d = cl.complex_leaky_relu(d)
                if m.attention:
                    d = cl.complex_mul_bcast(d, getattr(self, f"dec{i}_ca")(d))
                    d = getattr(self, f"dec{i}_sa").gate(d)
            d = self.dropout_conv(d)

        # output bound in float32 (atan2/tanh of the bound are precision-sensitive)
        out = masks.bound_crm(CArray(d.re[..., 0].float(), d.im[..., 0].float()),
                              m.atan2_eps)
        if return_lstm_state:
            return out, new_state
        return out
