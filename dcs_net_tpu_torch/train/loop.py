"""The training loop, the port's copy of the JAX package's ``train/loop.py``:
per epoch the train steps (NaN gate, throughput), a validation pass (losses),
ReduceLROnPlateau on the monitored metric and a checkpoint.

Faithful details kept: the plateau monitors ``val_loss`` for subtractive
variants but the TRAIN ``speech_loss`` for plain ones. The device is told
nothing per step: metrics stay device scalars and are fetched every
``log_every_n_steps`` steps and at the end of the epoch.

Not yet ported (ROADMAP Queue 1 item 5): the sanity-val pass, SWA with its
BN refresh, PESQ and STOI in validation, audio and histogram logging.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.obs.logging import ThroughputMeter, Writer
from dcs_net_tpu_torch.train import steps as S
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
from dcs_net_tpu_torch.train.optim import (get_lr, make_optimizer, make_plateau,
                                           step_count)
from dcs_net_tpu_torch.utils.device import DeviceLike, resolve_device

HostBatch = Dict[str, np.ndarray]


class Trainer:
    """``Trainer(cfg, device=...)`` (CUDA unless ``device="cpu"``). Turns
    TF32 off for cuDNN and matmuls: the model trains in full float32, as the
    JAX reference does (cuDNN would otherwise run the encoder convs and the
    LSTM in TF32)."""

    def __init__(self, cfg: Config, device: DeviceLike = None):
        if cfg.run.steps_per_dispatch > 1:
            raise NotImplementedError(
                "steps_per_dispatch > 1 is not yet ported: one train step a "
                "dispatch (a CUDA graph of the step is later work)")
        self.cfg = cfg
        self.device = resolve_device(device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        self.writer = Writer(cfg.run.log_dir)
        self.model: Optional[DCSNet] = None
        self.opt: Optional[torch.optim.Adam] = None
        self.plateau: Optional[torch.optim.lr_scheduler.ReduceLROnPlateau] = None
        self.epoch = 0
        self._last_train_metrics: Dict[str, float] = {}

    # -- state --------------------------------------------------------------
    def init_state(self) -> None:
        """Weights from ``cfg.run.seed``, fresh Adam and plateau state;
        torch's generators (dropout) seeded from the same seed."""
        seed = self.cfg.run.seed
        torch.manual_seed(seed)
        self.model = DCSNet(self.cfg.model, self.cfg.quirks, device=self.device,
                            seed=seed)
        self.opt = make_optimizer(self.model.parameters(), self.cfg.optim)
        self.plateau = make_plateau(self.opt, self.cfg.optim)

    @property
    def step(self) -> int:
        """Applied steps (a step the NaN gate undid does not count)."""
        return step_count(self.opt)

    def _device_batch(self, host_batch: HostBatch) -> S.Batch:
        noisy = torch.from_numpy(np.ascontiguousarray(host_batch["noisy"])).to(self.device)
        clean = torch.from_numpy(np.ascontiguousarray(host_batch["clean"])).to(self.device)
        return S.batch_from_waves(noisy, clean, self.cfg)

    # -- epochs -------------------------------------------------------------
    def train_epoch(self, batches: Iterable[HostBatch], epoch: int) -> Dict[str, float]:
        """One pass of train steps. Returns the metric means over the epoch,
        ``steps`` and ``nonfinite_loss_steps`` (steps whose loss was not
        finite), ``audio_seconds_per_s`` (per GPU, host clock, the epoch
        ended by fetching its metrics) and ``steady_audio_seconds_per_s``,
        the same after the first step (its warm-up left out: the first
        batch's load, the device's first-use initialisation)."""
        if self.model is None:
            raise RuntimeError("call init_state() first")
        cfg = self.cfg
        meter = ThroughputMeter(cfg.data.batch_size * cfg.data.crop_samples / cfg.data.sr)
        t0 = time.perf_counter()
        agg: Dict[str, List[torch.Tensor]] = {}
        gstep = self.step
        t_first = None
        for host_batch in batches:
            metrics = S.train_step(self.model, self.opt,
                                   self._device_batch(host_batch), cfg)
            meter.tick()
            if t_first is None:     # the first step's end: one sync an epoch
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_first = time.perf_counter()
            gstep += 1
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
            if gstep % cfg.run.log_every_n_steps == 0:
                self.writer.scalars({k: float(v) for k, v in metrics.items()},
                                    gstep, prefix="train/")
                self.writer.scalar("train/lr", get_lr(self.opt), gstep)
                if meter.audio_seconds_per_sec:
                    self.writer.scalar("perf/audio_seconds_per_s",
                                       meter.audio_seconds_per_sec, gstep)
        if not agg:
            return {"epoch": epoch, "steps": 0}
        # one fetch per key: the fence that makes the epoch's wall time true
        stacked = {k: torch.stack(v).double().cpu().numpy() for k, v in agg.items()}
        t_end = time.perf_counter()
        dt = t_end - t0
        out: Dict[str, float] = {k: float(v.mean()) for k, v in stacked.items()}
        n = len(stacked["loss"])
        out.update(epoch=epoch, steps=n,
                   nonfinite_loss_steps=int((~np.isfinite(stacked["loss"])).sum()))
        if dt > 0:
            out["audio_seconds_per_s"] = n * meter.aps / dt
        if n > 1:
            out["steady_audio_seconds_per_s"] = (
                (n - 1) * meter.aps / (t_end - t_first))
        self._last_train_metrics = out
        return out

    def eval_epoch(self, batches: Iterable[HostBatch], epoch: int) -> Dict[str, float]:
        """Eval-mode losses averaged over the batches, as ``val_<loss>`` (a
        batch with a non-finite loss is reported and left out)."""
        agg: Dict[str, List[float]] = {}
        for i, host_batch in enumerate(batches):
            losses, _ = S.eval_step(self.model, self._device_batch(host_batch), self.cfg)
            if not np.isfinite(float(losses["loss"])):
                print(f"found a NaN in val loss! (epoch {epoch}, batch {i}, skipped)")
                continue
            for k, v in losses.items():
                agg.setdefault(k, []).append(float(v))
        out = {f"val_{k}": float(np.mean(v)) for k, v in agg.items() if v}
        self.writer.scalars(out, self.step)
        return out

    # -- schedule -------------------------------------------------------------
    def monitored_metric(self, val_metrics: Dict[str, float]) -> float:
        if self.cfg.model.subtractive:
            return val_metrics.get("val_loss", float("inf"))
        return self._last_train_metrics.get(
            "speech_loss", val_metrics.get("val_speech_loss", float("inf")))

    def end_of_epoch(self, epoch: int, val_metrics: Dict[str, float]) -> None:
        lr = get_lr(self.opt)
        self.plateau.step(self.monitored_metric(val_metrics))
        if get_lr(self.opt) != lr:
            print(f"epoch {epoch}: reducing lr {lr:.3e} -> {get_lr(self.opt):.3e}")
        self.epoch = epoch + 1

    # -- checkpoints ----------------------------------------------------------
    def save(self, ckpt: CheckpointManager, epoch: int) -> str:
        return ckpt.save(self.step, self.model, self.opt, config=self.cfg, extra={
            "epoch": epoch, "plateau": self.plateau.state_dict()})

    def restore(self, ckpt: CheckpointManager) -> int:
        """Load the latest checkpoint into the model and optimizer and move
        the loop past its epoch; returns the restored step."""
        extra = ckpt.restore(self.model, self.opt)
        self.epoch = int(extra["epoch"]) + 1
        self.plateau.load_state_dict(extra["plateau"])
        return self.step

    # -- fit ----------------------------------------------------------------
    def fit(self, train_loader, val_loader, ckpt: Optional[CheckpointManager] = None
            ) -> Dict[str, float]:
        """Epochs from ``self.epoch`` to ``cfg.run.max_epochs``; returns the
        last epoch's train and validation metrics."""
        if self.model is None:
            self.init_state()
        metrics: Dict[str, float] = {}
        for epoch in range(self.epoch, self.cfg.run.max_epochs):
            t0 = time.perf_counter()
            train_metrics = self.train_epoch(train_loader.epoch(epoch), epoch)
            val_metrics = self.eval_epoch(val_loader.epoch(epoch), epoch)
            self.end_of_epoch(epoch, val_metrics)
            metrics = {**train_metrics, **val_metrics}
            print(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" for k, v in metrics.items() if isinstance(v, float))
                + f" ({time.perf_counter() - t0:.1f}s)", flush=True)
            if ckpt is not None:
                self.save(ckpt, epoch)
        self.writer.flush()
        return metrics
