"""The forward + mask + loss pipeline of the four variants and the train
step, the port's copy of the JAX package's ``train/steps.py``.

``batch_from_waves`` runs the STFT on the device (kernel 1, one launch for
the noise, noisy and clean streams stacked). ``train_step`` is forward ->
losses -> backward (kernels 2 and 3 carry the gradients on the card) ->
clip -> Adam, with the NaN gate of the JAX step: where the loss, or unless
``Quirks.nan_gate_loss_only`` the gradient norm, is not finite, the step
leaves parameters, optimizer state (step counts included) and the BN running
statistics exactly as they were. The gate keeps a flat copy of that state
and selects with ``torch.where`` on the device, as the JAX step's branchless
``where`` does: no host sync.

``eval_waves`` is the eval step from the waves, STFT included, through a
``models/graphed.py`` ``GraphCache`` where one is given (on the card one
CUDA graph a batch shape, the JAX package's jitted eval step).

``make_scanned_train_step`` is the JAX scanned step (K steps a dispatch) in
the port: on the card one CUDA graph of K train steps, STFT included,
replayed once a dispatch; on the CPU the same K steps run eagerly.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.dsp import stft as dsp
from dcs_net_tpu_torch.models.graphed import GraphCache, call
from dcs_net_tpu_torch.ops import masks as M
from dcs_net_tpu_torch.train import losses as L
from dcs_net_tpu_torch.train.optim import optimizer_tensors
from dcs_net_tpu_torch.utils.carray import CArray
from dcs_net_tpu_torch.utils.device import holding

Tensor = torch.Tensor


class Batch(NamedTuple):
    """STFT-domain batch: CArray spectrograms (B, F, T), DC bin dropped."""

    noise: CArray
    noisy: CArray
    clean: CArray


def batch_from_waves(noisy: Tensor, clean: Tensor, cfg: Config) -> Batch:
    """Waveforms (B, n) on the device -> STFT Batch; noise = noisy - clean
    before the transform."""
    spec = dsp.stft(torch.stack([noisy - clean, noisy, clean]), cfg.stft)
    return Batch(noise=spec[0], noisy=spec[1], clean=spec[2])


def _stack(*xs: CArray) -> CArray:
    return CArray(torch.stack([x.re for x in xs]), torch.stack([x.im for x in xs]))


def run_model_and_masks(apply_mask_net: Callable[[object], object],
                        batch: Batch, cfg: Config) -> Dict[str, object]:
    """Mask prediction and application, shared by train and eval: the audio
    streams (the three references through one iSTFT, the predictions
    through another) and the masks. ``apply_mask_net`` maps the network
    input (the noisy spectrogram, or for the real variants its magnitude)
    to the bounded mask."""
    q = cfg.quirks
    eps = cfg.model.atan2_eps
    refs = dsp.spec_to_wave(_stack(batch.noise, batch.noisy, batch.clean),
                            cfg.stft, atan2_eps=eps, pad_top=q.istft_pad_top_bin,
                            polar=q.polar_resynthesis)
    out: Dict[str, object] = {"noise_audio": refs[0], "noisy_audio": refs[1],
                              "clean_audio": refs[2]}
    if not cfg.model.complex_valued:
        # the magnitude is the network's input, the noisy phase resynthesizes
        # the predictions
        noisy_mag, noisy_phase = batch.noisy.abs(), batch.noisy.angle(eps)
        pred_mask = apply_mask_net(noisy_mag)

        def to_wave(mag, phase):
            return dsp.polar_to_wave(mag, phase, cfg.stft, pad_top=q.istft_pad_top_bin)

        if cfg.model.subtractive:   # DRS
            pred_noise_mag = noisy_mag * pred_mask
            pred_clean_mag = noisy_mag - pred_noise_mag
            waves = to_wave(torch.stack([pred_noise_mag, pred_clean_mag]),
                            torch.stack([noisy_phase, noisy_phase]))
            out.update(target_mask=M.real_subtractive_target(batch.noise.abs(), noisy_mag),
                       pred_mask=pred_mask, predict_noise_audio=waves[0],
                       predict_clean_audio=waves[1])
        else:                       # DR
            out.update(pred_mask=pred_mask,
                       predict_clean_audio=to_wave(noisy_mag * pred_mask, noisy_phase))
        return out
    pred_out = apply_mask_net(batch.noisy)
    pred_mask = M.bound_crm(pred_out, eps) if q.double_bound_mask else pred_out
    if cfg.model.subtractive:   # DCS
        target_mask = M.bound_crm(M.crm(batch.noise, batch.noisy,
                                        cfg.loss.crm_eps), eps)
        pred_noise = batch.noisy * pred_mask
        pred_clean = batch.noisy - pred_noise
        waves = dsp.spec_to_wave(_stack(pred_noise, pred_clean), cfg.stft,
                                 atan2_eps=eps, pad_top=q.istft_pad_top_bin,
                                 polar=q.polar_resynthesis)
        out.update(target_mask=target_mask, pred_mask=pred_mask,
                   predict_noise_audio=waves[0], predict_clean_audio=waves[1])
    else:                       # DC
        out.update(pred_mask=pred_mask, predict_clean_audio=dsp.spec_to_wave(
            batch.noisy * pred_mask, cfg.stft, atan2_eps=eps,
            pad_top=q.istft_pad_top_bin, polar=q.polar_resynthesis))
    return out


def pipeline_losses(out: Dict[str, object], cfg: Config) -> Dict[str, Tensor]:
    return L.calc_loss(
        cfg, clean_audio=out["clean_audio"],
        predict_clean_audio=out["predict_clean_audio"],
        target_mask=out.get("target_mask"), predict_mask=out.get("pred_mask"),
        noise_audio=out.get("noise_audio"), noisy_audio=out.get("noisy_audio"),
        predict_noise_audio=out.get("predict_noise_audio"))


def loss_and_grads(model: torch.nn.Module, batch: Batch, cfg: Config
                   ) -> Tuple[Tensor, List[Tensor]]:
    """(loss, gradient of every parameter) in train mode, without the
    optimizer update. The BN running statistics move, as in any train-mode
    forward."""
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    loss = pipeline_losses(run_model_and_masks(model, batch, cfg), cfg)["loss"]
    return loss.detach(), list(torch.autograd.grad(loss, params))


class _Snapshot:
    """A flat copy of a list of tensors of one device and dtype, and the
    branchless restore: ``t = where(bad, saved, t)`` for every tensor."""

    def __init__(self, tensors: List[Tensor]):
        self.tensors = tensors
        self.saved = self._flat()

    def _flat(self) -> Tensor:
        return torch.cat([t.detach().reshape(-1) for t in self.tensors])

    def restore_where(self, bad: Tensor) -> None:
        now = self._flat()
        torch.where(bad, self.saved, now, out=now)
        views = now.split([t.numel() for t in self.tensors])
        with torch.no_grad():
            torch._foreach_copy_(self.tensors,
                                 [v.view_as(t) for v, t in zip(views, self.tensors)])


def train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
               batch: Batch, cfg: Config) -> Dict[str, Tensor]:
    """One step in train mode: forward, losses, backward, clip, Adam, NaN
    gate. Returns the losses, ``grad_norm`` (before clipping) and, with the
    gate on, ``skipped`` (1.0 where the step was undone), all as device
    scalars."""
    model.train()
    params = [p for p in model.parameters() if p.requires_grad]
    gated = cfg.optim.nan_skip
    if gated:
        snap = _Snapshot(params + list(model.buffers()) + optimizer_tensors(opt))
    opt.zero_grad(set_to_none=True)
    losses = pipeline_losses(run_model_and_masks(model, batch, cfg), cfg)
    loss = losses["loss"]
    loss.backward()
    gnorm = torch.nn.utils.clip_grad_norm_(params, cfg.optim.clip_norm)
    opt.step()
    out = {k: v.detach() for k, v in losses.items()}
    if gated:
        bad = ~torch.isfinite(loss.detach())
        if not cfg.quirks.nan_gate_loss_only:
            bad = bad | ~torch.isfinite(gnorm)
        snap.restore_where(bad)
        out["skipped"] = bad.float()
    out["grad_norm"] = gnorm.detach()
    return out


def eval_step(model: torch.nn.Module, batch: Batch, cfg: Config
              ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """Eval-mode forward without autograd: losses and the audio streams
    (keys without the ``_audio`` suffix)."""
    model.eval()
    with torch.no_grad():
        out = run_model_and_masks(model, batch, cfg)
        losses = pipeline_losses(out, cfg)
    audio = {k[:-len("_audio")]: v for k, v in out.items() if k.endswith("_audio")}
    return losses, audio


def _eval_from_waves(noisy: Tensor, clean: Tensor, model: torch.nn.Module, cfg: Config
                     ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    return eval_step(model, batch_from_waves(noisy, clean, cfg), cfg)


def eval_waves(model: torch.nn.Module, noisy: Tensor, clean: Tensor, cfg: Config,
               graphs: Optional[GraphCache] = None
               ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
    """:func:`eval_step` on waves (B, n) on the model's device, the STFT
    included; with ``graphs`` one CUDA graph a batch shape on the card, the
    JAX package's jitted eval step."""
    model.eval()
    return call(graphs, _eval_from_waves, noisy, clean, model=model, cfg=cfg)


def make_scanned_train_step(model: torch.nn.Module, opt: torch.optim.Optimizer,
                            cfg: Config, k: int) -> "ScannedTrainStep":
    """K train steps per dispatch, the JAX ``make_scanned_train_step``
    (``lax.scan`` over stacked waves, the STFT inside the body): a callable
    that takes noisy and clean waves (K, B, crop) on the host and returns
    every inner step's metrics as (K,) tensors."""
    return ScannedTrainStep(model, opt, cfg, k)


class ScannedTrainStep:
    """K train steps (STFT -> forward -> losses -> backward -> clip -> Adam
    -> NaN gate, each) per call, in order.

    On the CPU the K steps run eagerly: the plain version. On the card the
    first call runs them eagerly too, reading the waves from static device
    buffers (K, B, crop): real training that also warms up every lazily made
    constant and library plan. The second call captures the K steps into one
    ``torch.cuda.CUDAGraph`` (capture executes nothing), and every call from
    then on replays it. The waves come in through one pinned host stack,
    copied with ``non_blocking=True``; before the host overwrites that stack
    it waits for the last copy out of it, so the host runs at most one
    dispatch ahead. The metrics are written into static (K,) device tensors,
    which the next call overwrites: read or copy them before. A capture or
    replay error raises; nothing falls back to eager steps.

    What the graph holds: the parameters, BN buffers, Adam state and its
    learning-rate tensor, all updated in place, and the model's dropout
    generator, registered with the graph, which replays draw from where it
    stands (reseed it in place, ``manual_seed``, never swap it: a call with
    another generator on the model raises). After a replay the parameters'
    ``.grad`` are stale; the graph's own gradient buffers hold the last
    inner step's. ``capture_s`` and ``pool_bytes`` (device memory the
    capture reserved for its private pool) are set by the capture. The
    device constants the steps read (``utils/device.py:device_cache``) are
    held from the warm-up on, as a ``models/graphed.py`` entry holds its
    own."""

    def __init__(self, model: torch.nn.Module, opt: torch.optim.Optimizer,
                 cfg: Config, k: int):
        if k < 1:
            raise ValueError(f"k must be at least 1, got {k}")
        self.model, self.opt, self.cfg, self.k = model, opt, cfg, k
        self.device = next(model.parameters()).device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self._generator = None
        # the device constants the graph reads, held while it lives
        self._constants: Dict = {}
        self._waves = self._pinned = self._copied = None
        self._out: Optional[Dict[str, Tensor]] = None

    def _steps(self, noisy: Tensor, clean: Tensor, out: Dict[str, Tensor]
               ) -> Dict[str, Tensor]:
        for i in range(self.k):
            m = train_step(self.model, self.opt,
                           batch_from_waves(noisy[i], clean[i], self.cfg), self.cfg)
            for key, v in m.items():
                if key not in out:
                    out[key] = v.new_empty(self.k)
                out[key][i] = v
        return out

    def _stage(self, noisy: Tensor, clean: Tensor) -> None:
        """The host waves into the static device buffers, through the
        pinned stack."""
        shape = (2, self.k) + tuple(noisy.shape[1:])
        if noisy.shape != clean.shape or tuple(noisy.shape[:1]) != (self.k,):
            raise ValueError(f"noisy {tuple(noisy.shape)} and clean "
                             f"{tuple(clean.shape)} are not both (K={self.k}, B, n)")
        if self._waves is None:
            self._pinned = torch.empty(shape, dtype=torch.float32, pin_memory=True)
            self._waves = torch.empty(shape, dtype=torch.float32, device=self.device)
            self._copied = torch.cuda.Event()
        elif tuple(self._waves.shape) != shape:
            raise ValueError(f"waves {shape[1:]} after {tuple(self._waves.shape[1:])}: "
                             "a captured step takes one shape")
        else:
            self._copied.synchronize()
        self._pinned[0].copy_(noisy)
        self._pinned[1].copy_(clean)
        self._waves.copy_(self._pinned, non_blocking=True)
        self._copied.record()

    def _capture(self) -> None:
        gen = self.model.dropout_generator
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()    # as the capture does first: reserved is then in use
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph):
            self._steps(self._waves[0], self._waves[1], self._out)
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        self.graph, self._generator = graph, gen

    def __call__(self, noisy: Tensor, clean: Tensor) -> Dict[str, Tensor]:
        if self.device.type == "cpu":
            return self._steps(noisy, clean, {})
        self._stage(noisy, clean)
        if self._out is None:       # the first call: eager, the warm-up
            self._out = {}
            with holding(self._constants):
                return self._steps(self._waves[0], self._waves[1], self._out)
        if self.graph is None:
            with holding(self._constants):
                self._capture()
        if self.model.dropout_generator is not self._generator:
            raise RuntimeError("the model's dropout generator is not the one the "
                               "graph was captured with; reseed that one in place")
        self.graph.replay()
        self.replays += 1
        return self._out
