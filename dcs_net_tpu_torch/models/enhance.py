"""Full-utterance enhancement: STFT -> U-Net mask -> masked spectrogram ->
polar resynthesis. Frames are padded to the model's stride granularity (8)
and the mask is trimmed back before it is applied.

The streaming (chunked) path is ROADMAP Queue 1 item 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.dsp import stft as dsp
from dcs_net_tpu_torch.ops import masks as M
from dcs_net_tpu_torch.utils.carray import CArray


def _apply_mask_pipeline(spec: CArray, mask: CArray, cfg: Config) -> CArray:
    """Masked clean-spectrogram estimate of the complex variants: with
    ``double_bound_mask`` the mask is bounded a second time; the subtractive
    variant removes the masked (noise) estimate from the input."""
    if not cfg.model.complex_valued:
        raise NotImplementedError(
            "the real family (DR/DRS) is not yet ported: ROADMAP Queue 1 item 3")
    if cfg.quirks.double_bound_mask:
        mask = M.bound_crm(mask, cfg.model.atan2_eps)
    if cfg.model.subtractive:
        return spec - spec * mask
    return spec * mask


def enhance_full(model: torch.nn.Module, wave: torch.Tensor, cfg: Config
                 ) -> torch.Tensor:
    """(B, n) noisy -> (B, n) enhanced, one forward over the whole
    spectrogram in eval mode. ``wave`` moves to the model's device."""
    dev = next(model.parameters()).device
    wave = wave.to(dev, torch.float32)
    n = wave.shape[-1]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            spec = dsp.stft(wave, cfg.stft)  # (B, F, T)
            T = spec.shape[-1]
            pad = (-T) % 8
            spec_p = CArray(F.pad(spec.re, (0, pad)),
                            F.pad(spec.im, (0, pad))) if pad else spec
            mask = model(spec_p)
            if pad:
                mask = mask[..., :T]
            clean = _apply_mask_pipeline(spec, mask, cfg)
            return dsp.spec_to_wave(
                clean, cfg.stft, atan2_eps=cfg.model.atan2_eps,
                pad_top=cfg.quirks.istft_pad_top_bin, length=n)
    finally:
        model.train(was_training)
