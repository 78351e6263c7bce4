"""Time-domain and mask-domain losses and the variant-aware combination, the
port's copy of the JAX package's ``train/losses.py``. Signals are (..., n);
each loss is a batch mean."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.utils.carray import CArray

Tensor = torch.Tensor


def sisnr(clean: Tensor, estimate: Tensor, eps: float = 1e-8) -> Tensor:
    """Scale-invariant SNR in the dot-projection form, batch mean."""
    dot = torch.sum(estimate * clean, dim=-1, keepdim=True)
    norm = torch.sum(clean * clean, dim=-1, keepdim=True)
    s_target = dot * clean / (norm + eps)
    e_noise = estimate - s_target
    t = torch.sum(s_target * s_target, dim=-1, keepdim=True)
    n = torch.sum(e_noise * e_noise, dim=-1, keepdim=True)
    return torch.mean(10.0 * torch.log10(t / (n + eps) + eps))


def wsdr(mixed: Tensor, clean: Tensor, clean_est: Tensor,
         eps: float = 2e-8) -> Tensor:
    """Weighted SDR with the energy-ratio weight alpha, batch mean."""

    def msdr(orig, est):
        corr = torch.sum(orig * est, dim=-1)
        energies = torch.linalg.norm(orig, dim=-1) * torch.linalg.norm(est, dim=-1)
        return -(corr / (energies + eps))

    noise = mixed - clean
    noise_est = mixed - clean_est
    ce = torch.sum(clean ** 2, dim=-1)
    ne = torch.sum(noise ** 2, dim=-1)
    a = ce / (ce + ne + eps)
    return torch.mean(a * msdr(clean, clean_est) + (1 - a) * msdr(noise, noise_est))


def l1(a, b) -> Tensor:
    """L1 loss of real tensors, or of CArray masks with the complex modulus
    as |.|: mean(|a - b|)."""
    if isinstance(a, CArray):
        return torch.mean((a - b).abs())
    return torch.mean(torch.abs(a - b))


def mse_split(a, b) -> Tensor:
    """MSE; for complex masks mse(re) + mse(im)."""
    if isinstance(a, CArray):
        return torch.mean((a.re - b.re) ** 2) + torch.mean((a.im - b.im) ** 2)
    return torch.mean((a - b) ** 2)


def noise_loss_menu(loss_type: int, *, target_mask, predict_mask,
                    noise_audio: Tensor, noisy_audio: Tensor,
                    predict_noise_audio: Tensor, cfg: Config) -> Tensor:
    """The 7 selectable noise losses (``LossConfig.noise_loss_type``)."""
    c = cfg.loss

    def w():
        return wsdr(noisy_audio, noise_audio, predict_noise_audio, c.wsdr_eps)

    if loss_type == 0:
        return l1(target_mask, predict_mask)
    if loss_type == 1:
        return w()
    if loss_type == 2:
        return l1(target_mask, predict_mask) + l1(noise_audio, predict_noise_audio)
    if loss_type == 3:
        return w() + l1(noise_audio, predict_noise_audio)
    if loss_type == 4:
        return w() + l1(target_mask, predict_mask)
    if loss_type == 5:
        return w() + mse_split(target_mask, predict_mask)
    if loss_type == 6:
        return -sisnr(noise_audio, predict_noise_audio, c.sisnr_eps)
    raise ValueError(f"unknown noise_loss_type {loss_type}")


def calc_loss(cfg: Config, *, clean_audio: Tensor, predict_clean_audio: Tensor,
              target_mask=None, predict_mask=None,
              noise_audio: Optional[Tensor] = None,
              noisy_audio: Optional[Tensor] = None,
              predict_noise_audio: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Subtractive variants return {noise_loss, speech_loss, loss}; plain
    ones {speech_loss, loss} with loss == speech_loss. With the quirk
    ``loss_one_minus_alpha`` the noise loss is the literal ``1 - alpha * L``,
    else ``(1 - alpha) * L``."""
    alpha = cfg.loss.speech_alpha
    if cfg.loss.speech_loss_type != 0:
        raise ValueError(f"unknown speech_loss_type {cfg.loss.speech_loss_type}")
    speech_loss = alpha * -sisnr(clean_audio, predict_clean_audio,
                                 cfg.loss.sisnr_eps)
    if not cfg.model.subtractive:
        return {"speech_loss": speech_loss, "loss": speech_loss}
    noise_orig = noise_loss_menu(
        cfg.loss.noise_loss_type, target_mask=target_mask,
        predict_mask=predict_mask, noise_audio=noise_audio,
        noisy_audio=noisy_audio, predict_noise_audio=predict_noise_audio,
        cfg=cfg)
    if cfg.quirks.loss_one_minus_alpha:
        noise_loss = 1.0 - alpha * noise_orig
    else:
        noise_loss = (1.0 - alpha) * noise_orig
    return {"noise_loss": noise_loss, "speech_loss": speech_loss,
            "loss": noise_loss + speech_loss}
