"""Utterance enhancement: STFT -> U-Net mask -> masked spectrogram -> polar
resynthesis, over the whole utterance (:func:`enhance_full`) or streamed
through fixed-size chunks (:func:`enhance_streaming`).

Full: frames are padded to the model's stride granularity (8) and the mask is
trimmed back before it is applied.

Streaming: the spectrogram is cut into ``chunk_frames`` windows that overlap
by ``overlap`` frames; each chunk runs the full U-Net; the predicted masks
are blended with a linear crossfade over the overlap, then applied. Without
the LSTM carry the chunks are independent in eval mode and run batched in
groups of one shape (the last padded as the JAX package pads it); with it
they run in order, each continuing the previous one's LSTM state.

Graphs: given a ``models/graphed.py`` ``GraphCache`` (``graphs=``), each
path runs its fixed-shape part through it, the port's ``jax.jit`` and
``lax.scan``: the whole of :func:`enhance_full` is one graph a (B, n); a
stream's group forward one graph a (G * B) whatever the length; a carried
stream's chunk forward, its LSTM state in and out, one graph a B. Without a
cache the same functions run eagerly, the plain path the graphs are held to.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.dsp import stft as dsp
from dcs_net_tpu_torch.models.graphed import GraphCache, call
from dcs_net_tpu_torch.ops import masks as M
from dcs_net_tpu_torch.utils.carray import CArray
from dcs_net_tpu_torch.utils.device import device_cache


def _apply_mask_pipeline(spec: CArray, mask, cfg: Config) -> CArray:
    """Masked clean-spectrogram estimate per variant. Complex: with
    ``double_bound_mask`` the mask is bounded a second time, and the
    subtractive variant removes the masked (noise) estimate from the input.
    Real: the mask scales (or, subtractive, removes a share of) the
    magnitude under the noisy phase."""
    if cfg.model.complex_valued:
        if cfg.quirks.double_bound_mask:
            mask = M.bound_crm(mask, cfg.model.atan2_eps)
        if cfg.model.subtractive:
            return spec - spec * mask
        return spec * mask
    mag = spec.abs()
    phase = spec.angle(cfg.model.atan2_eps)
    clean_mag = mag - mag * mask if cfg.model.subtractive else mag * mask
    return CArray.from_polar(clean_mag, phase)


def _model_input(spec: CArray, cfg: Config):
    """The spectrogram for the complex variants, its magnitude for the real."""
    return spec if cfg.model.complex_valued else spec.abs()


def _planes(mask) -> Tuple[torch.Tensor, ...]:
    """A mask's real planes: (re, im) of a complex mask, (mask,) of a real."""
    return tuple(mask) if isinstance(mask, CArray) else (mask,)


def _enhance_full(wave: torch.Tensor, model: torch.nn.Module, cfg: Config
                  ) -> torch.Tensor:
    """The whole of :func:`enhance_full` on the model's device, in eval mode
    and without autograd: STFT, frame padding, the net, the mask pipeline,
    the iSTFT."""
    n = wave.shape[-1]
    spec = dsp.stft(wave, cfg.stft)  # (B, F, T)
    T = spec.shape[-1]
    pad = (-T) % 8
    spec_p = CArray(F.pad(spec.re, (0, pad)), F.pad(spec.im, (0, pad))) if pad else spec
    mask = model(_model_input(spec_p, cfg))
    if pad:
        mask = mask[..., :T]
    clean = _apply_mask_pipeline(spec, mask, cfg)
    return dsp.spec_to_wave(clean, cfg.stft, atan2_eps=cfg.model.atan2_eps,
                            pad_top=cfg.quirks.istft_pad_top_bin, length=n)


def enhance_full(model: torch.nn.Module, wave: torch.Tensor, cfg: Config,
                 graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """(B, n) noisy -> (B, n) enhanced, one forward over the whole
    spectrogram in eval mode. ``wave`` moves to the model's device. With
    ``graphs`` the call is one CUDA graph a (B, n) on the card."""
    dev = next(model.parameters()).device
    wave = wave.to(dev, torch.float32)
    was_training = model.training
    model.eval()
    try:
        return call(graphs, _enhance_full, wave, model=model, cfg=cfg)
    finally:
        model.train(was_training)


def zero_lstm_state(cfg: Config, batch: int, device=None):
    """The streaming LSTM carry at sequence start: (h, c), each zeros
    (layers * directions, batch, hidden), for the real variants; for the
    complex ones a pair (real LSTM's, imag LSTM's) of such states on the
    (re, im)-stacked batch 2 * ``batch`` of ``ops/lstm.py:ComplexLSTM``."""
    m = cfg.model
    d = 2 if m.lstm_bidir else 1

    def one(b):
        z = torch.zeros(m.lstm_layers * d, b, m.lstm_hidden,
                        dtype=torch.float32, device=device)
        return z, torch.zeros_like(z)

    return (one(2 * batch), one(2 * batch)) if m.complex_valued else one(batch)


@device_cache(16)
def _crossfade(n_chunks: int, chunk_frames: int, overlap: int,
               device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w (chunk_frames,), overlap-added w (total,)) on ``device``, made
    once. w ramps up over the first ``overlap`` frames and down over the last;
    the sum of the chunks' weights at each frame (floored at 1e-8)
    normalises the blend."""
    hop = chunk_frames - overlap
    w = np.ones(chunk_frames, np.float32)
    if overlap > 0:
        ramp = ((np.arange(overlap) + 1.0) / (overlap + 1.0)).astype(np.float32)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    wacc = np.zeros(overlap + n_chunks * hop, np.float32)
    for c in range(n_chunks):
        wacc[c * hop:c * hop + chunk_frames] += w
    wacc = np.maximum(wacc, 1e-8)
    return torch.from_numpy(w).to(device), torch.from_numpy(wacc).to(device)


def _group_masks(re: torch.Tensor, im: torch.Tensor, model: torch.nn.Module,
                 cfg: Config) -> torch.Tensor:
    """One group of chunk spectrograms (N, F, chunk) -> its mask planes
    (P, N, F, chunk), P = 2 of a complex mask or 1 of a real one."""
    return torch.stack(_planes(model(_model_input(CArray(re, im), cfg))))


def _flat_state(state, cfg: Config) -> List[torch.Tensor]:
    """``zero_lstm_state``'s layout as a flat list: (h, c), or the complex
    net's (h, c) of its real LSTM then of its imaginary one."""
    return [t for s in state for t in s] if cfg.model.complex_valued else list(state)


def _carried_chunk(re: torch.Tensor, im: torch.Tensor, *state: torch.Tensor,
                   model: torch.nn.Module, cfg: Config) -> Tuple[torch.Tensor, ...]:
    """One chunk (B, F, chunk) and the LSTM state as flat tensors -> its mask
    planes (P, B, F, chunk) and the next state, flat."""
    state = ((state[:2], state[2:]) if cfg.model.complex_valued else state)
    mask, state = model(_model_input(CArray(re, im), cfg), lstm_state=state,
                        return_lstm_state=True)
    return (torch.stack(_planes(mask)), *_flat_state(state, cfg))


def enhance_streaming(model: torch.nn.Module, wave: torch.Tensor, cfg: Config,
                      chunk_frames: int = 256, overlap: int = 64,
                      carry_lstm_state: bool = False, chunk_batch: int = 8,
                      graphs: Optional[GraphCache] = None) -> torch.Tensor:
    """(B, n) noisy -> (B, n) enhanced through fixed-shape chunks, in eval
    mode. ``chunk_frames`` must be a multiple of 8. ``wave`` moves to the
    model's device.

    ``carry_lstm_state=True`` threads the LSTM (h, c) through the chunks:
    each chunk's latent sequence continues the previous chunk's instead of
    restarting from zeros. It needs a unidirectional LSTM
    (``lstm_bidir=False``: a backward pass cannot stream) and is exact
    (chunked == full pass) when the latent is flattened time-major
    (``lstm_time_major=True``), the chunks tile without overlap and every
    other op is chunk-local. Every request starts from zeros.

    Without the carry the chunks are independent (eval-mode BN uses running
    statistics, attention pools per chunk), so they run batched in groups of
    ``G = min(chunk_batch, n_chunks)``, chunk-major within a group. Every
    group has G chunks: as in the JAX package, the last group's windows past
    the end clip to the last frame, and their masks are dropped.

    With ``graphs`` the group forward (or, with the carry, the chunk
    forward) is a CUDA graph on the card; the STFT, the windows, the
    crossfade and the iSTFT run eagerly."""
    if chunk_frames % 8 != 0 or not 0 <= overlap < chunk_frames:
        raise ValueError(
            f"chunk_frames must be a multiple of 8 and overlap in "
            f"[0, chunk_frames): got chunk_frames={chunk_frames}, "
            f"overlap={overlap}")
    if carry_lstm_state and cfg.model.lstm_bidir:
        raise ValueError(
            "LSTM state carry requires a unidirectional (streaming) model")
    dev = next(model.parameters()).device
    wave = wave.to(dev, torch.float32)
    n = wave.shape[-1]
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            spec = dsp.stft(wave, cfg.stft)  # (B, F, T)
            B, n_bins, T = spec.shape
            hop = chunk_frames - overlap
            n_chunks = max(1, math.ceil(max(T - overlap, 1) / hop))
            total = overlap + n_chunks * hop
            G = 1 if carry_lstm_state else max(min(chunk_batch, n_chunks), 1)
            n_pad = -(-n_chunks // G) * G
            # every chunk window as a view: (n_pad, B, F, chunk_frames); past
            # ``total`` the last frame repeats, where the JAX package clips
            # the padding chunks' windows to it
            wins = []
            for p in spec:
                p = F.pad(p, (0, total - T))
                if n_pad > n_chunks:
                    p = torch.cat([p, p[..., -1:].expand(
                        B, n_bins, (n_pad - n_chunks) * hop)], dim=-1)
                wins.append(p.unfold(-1, chunk_frames, hop).permute(2, 0, 1, 3))
            masks = []  # per model call (P, chunks of the call * B, F, chunk)
            if carry_lstm_state:
                state = _flat_state(zero_lstm_state(cfg, B, dev), cfg)
                for c in range(n_chunks):
                    mask, *state = call(graphs, _carried_chunk, wins[0][c].contiguous(),
                                        wins[1][c].contiguous(), *state,
                                        model=model, cfg=cfg)
                    masks.append(mask)
            else:
                for c in range(0, n_pad, G):
                    masks.append(call(
                        graphs, _group_masks,
                        wins[0][c:c + G].reshape(-1, n_bins, chunk_frames),
                        wins[1][c:c + G].reshape(-1, n_bins, chunk_frames),
                        model=model, cfg=cfg))
            # (P, n_chunks, B, F, chunk), P = 2 planes of a complex mask or 1
            # of a real one: a call's batch is chunk-major; the padding
            # chunks' masks dropped
            P = masks[0].shape[0]
            chunk_masks = torch.cat(masks, dim=1).reshape(
                P, n_pad, B, n_bins, chunk_frames)[:, :n_chunks]
            # crossfade: weight each chunk, overlap-add at stride hop in one
            # fold, divide by the overlap-added weights
            w, wacc = _crossfade(n_chunks, chunk_frames, overlap, dev)
            cols = (chunk_masks * w).permute(0, 2, 3, 4, 1).reshape(
                1, P * B * n_bins * chunk_frames, n_chunks)
            blended = F.fold(cols, (1, total), (1, chunk_frames),
                             stride=(1, hop)).reshape(P, B, n_bins, total)
            blended = (blended / wacc)[..., :T]
            mask = CArray(blended[0], blended[1]) if P == 2 else blended[0]
            clean = _apply_mask_pipeline(spec, mask, cfg)
            return dsp.spec_to_wave(
                clean, cfg.stft, atan2_eps=cfg.model.atan2_eps,
                pad_top=cfg.quirks.istft_pad_top_bin, length=n)
    finally:
        model.train(was_training)
