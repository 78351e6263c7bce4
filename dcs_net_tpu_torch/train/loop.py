"""The training loop, the port's copy of the JAX package's ``train/loop.py``:
a sanity-validation pass of ``num_sanity_val_steps`` batches (losses only),
then per epoch the train steps (NaN gate, throughput), a validation pass
(losses, STOI and PESQ on the host, one batch's audio written as WAVs),
ReduceLROnPlateau on the monitored metric, SWA parameter averaging, a
checkpoint and the ``on_validation_end`` callback; at the end the SWA
average is swapped in and the BN statistics are refreshed for it.
``test`` is the evaluation pass of ``cli/test.py``.

Faithful details kept: the plateau monitors ``val_loss`` for subtractive
variants but the TRAIN ``speech_loss`` for plain ones, and stops acting (the
learning rate is held) from the SWA start epoch on. The device is told
nothing per step: metrics stay on the device and are fetched when a log is
due and at the end of the epoch. With ``steps_per_dispatch`` K > 1 the
steps go K to a dispatch, through ``train/steps.py``'s scanned step (on the
card one CUDA graph replay), as the JAX trainer groups them. Each epoch's
dropout masks come from the trainer's one generator, reseeded in place from
``(seed, epoch)``, so a run resumed from a checkpoint draws the masks the
uninterrupted run draws, and a captured graph keeps drawing from it. The
eval-mode forward of validation and the test pass goes through the trainer's
``GraphCache`` (one CUDA graph a batch shape on the card), dropped with the
train graph at a restore or a new model.

Not yet ported (ROADMAP Queue 1 item 4): TensorBoard and histogram logging.
"""

from __future__ import annotations

import itertools
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from dcs_net_tpu_torch.core.config import Config
from dcs_net_tpu_torch.metrics import composite as C
from dcs_net_tpu_torch.metrics import harness as H
from dcs_net_tpu_torch.metrics import pesq as P
from dcs_net_tpu_torch.models.graphed import GraphCache
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.obs.logging import ThroughputMeter, Writer, log_epoch_audio
from dcs_net_tpu_torch.train import steps as S
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
from dcs_net_tpu_torch.train.optim import (SWA, get_lr, make_optimizer,
                                           make_plateau, step_count)
from dcs_net_tpu_torch.utils.device import DeviceLike, resolve_device

HostBatch = Dict[str, np.ndarray]
COMPOSITE_KEYS = ("segsnr", "llr", "wss", "csig", "cbak", "covl")


def epoch_seed(seed: int, epoch: int) -> int:
    """The seed of epoch ``epoch``'s dropout generator: a fixed integer mix
    of (seed, epoch), the same under every Python version."""
    return (seed * 1_000_003 + epoch) & 0x7FFFFFFF


@dataclass
class TrainerCallbacks:
    """Hook points (HPO pruning, early stop): ``on_validation_end(epoch,
    val_metrics)`` returning True stops training."""

    on_validation_end: Optional[Callable[[int, Dict[str, float]], bool]] = None


class Trainer:
    """``Trainer(cfg, device=...)`` (CUDA unless ``device="cpu"``). Turns
    TF32 off for cuDNN and matmuls: the model trains in full float32, as the
    JAX reference does (cuDNN would otherwise run the encoder convs and the
    LSTM in TF32); and cuBLAS's reduced-precision bf16 reduction off, so that
    at ``compute_dtype="bfloat16"`` (every variant) every bf16 product, forward and
    backward, sums in float32. At bf16 the parameters, BN, Adam, SWA and the
    checkpoints stay float32: a bf16-trained checkpoint serves at either
    type.

    SWA starts at epoch ``int(swa_start_frac * max_epochs)``. A checkpoint
    holds the model, Adam, the plateau and the epoch but not the SWA average,
    as in the JAX package, so a run resumed after the SWA start begins its
    average anew at the resumed epoch.

    ``pesq_fn(clean, predicted, sr)`` scores validation; by default the
    native estimator (``metrics/pesq.py``, built here if it is not yet),
    and none, with a printed warning, if its library fails to build or
    load. Its key is ``pesq_est`` unless a ``pypesq``/``pesq`` wheel scores
    (``pesq``). Scalars and audio go under ``log_dir`` (default
    ``cfg.run.log_dir``). ``use_tensorboard`` is the JAX ``Trainer``'s
    parameter, kept for its callers; the port writes no TensorBoard yet."""

    def __init__(self, cfg: Config, device: DeviceLike = None,
                 log_dir: Optional[str] = None, use_tensorboard: bool = True,
                 pesq_fn=None):
        self.cfg = cfg
        self.use_tensorboard = use_tensorboard
        self.device = resolve_device(device)
        self._dropout = torch.Generator(device=self.device)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        self.writer = Writer(log_dir or cfg.run.log_dir)
        if pesq_fn is None:
            try:
                P._load()
                pesq_fn = H.pesq_metric
            except (OSError, RuntimeError) as e:
                print(f"WARNING: PESQ is off, its library did not load: {e}", flush=True)
        self.pesq_fn = pesq_fn
        self.pesq_key = "pesq_est" if P.is_estimate() else "pesq"
        self.model: Optional[DCSNet] = None
        self.opt: Optional[torch.optim.Adam] = None
        self.plateau: Optional[torch.optim.lr_scheduler.ReduceLROnPlateau] = None
        self.swa = (SWA(start_epoch=int(cfg.optim.swa_start_frac * cfg.run.max_epochs))
                    if cfg.optim.swa else None)
        self.epoch = 0
        self._last_train_metrics: Dict[str, float] = {}
        self._scanned: Optional[S.ScannedTrainStep] = None
        self._eval_graphs = GraphCache()

    # -- state --------------------------------------------------------------
    def init_state(self) -> None:
        """Weights from ``cfg.run.seed``, fresh Adam and plateau state."""
        self.model = DCSNet(self.cfg.model, self.cfg.quirks, device=self.device,
                            seed=self.cfg.run.seed)
        self.opt = make_optimizer(self.model.parameters(), self.cfg.optim)
        self.plateau = make_plateau(self.opt, self.cfg.optim)
        self._scanned = None
        self._eval_graphs.clear()

    @property
    def step(self) -> int:
        """Applied steps (a step the NaN gate undid does not count)."""
        return step_count(self.opt)

    def _device_waves(self, host_batch: HostBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        return tuple(torch.from_numpy(np.ascontiguousarray(host_batch[k])).to(self.device)
                     for k in ("noisy", "clean"))

    def _device_batch(self, host_batch: HostBatch) -> S.Batch:
        return S.batch_from_waves(*self._device_waves(host_batch), self.cfg)

    # -- epochs -------------------------------------------------------------
    def train_epoch(self, batches: Iterable[HostBatch], epoch: int) -> Dict[str, float]:
        """One pass of train steps, ``cfg.run.steps_per_dispatch`` (K) to a
        dispatch: K host batches stacked into one call of the scanned step
        (captured at its second call on the card, replayed from then on),
        the epoch's last ``len % K`` batches as single steps, as the JAX
        trainer groups them. Logs the dispatch's last step when a multiple
        of ``log_every_n_steps`` falls within it. Returns the metric means
        over the dispatches, each its last step's metrics (a single step is
        its own dispatch), as the JAX trainer averages them; ``steps``
        (every step) and ``nonfinite_loss_steps`` (steps whose loss was not
        finite, every inner step counted); ``audio_seconds_per_s`` (per GPU,
        host clock, the epoch ended by fetching its metrics) and
        ``steady_audio_seconds_per_s``, the same after the first dispatch
        and after the one that captured the graph (their warm-up left out:
        the first batch's load, the device's first-use initialisation, the
        capture)."""
        if self.model is None:
            raise RuntimeError("call init_state() first")
        cfg = self.cfg
        k = max(cfg.run.steps_per_dispatch, 1)
        if k > 1 and self._scanned is None:
            self._scanned = S.make_scanned_train_step(self.model, self.opt, cfg, k)
        # this epoch's dropout masks, keyed as the JAX trainer keys its rng
        self._dropout.manual_seed(epoch_seed(cfg.run.seed, epoch))
        self.model.set_dropout_generator(self._dropout)
        meter = ThroughputMeter(cfg.data.batch_size * cfg.data.crop_samples / cfg.data.sr)
        t0 = time.perf_counter()
        keys: List[str] = []
        rows: List[torch.Tensor] = []   # a dispatch's metrics, (keys, its steps)
        gstep = self.step
        n = n_first = 0
        t_first = None

        def record(metrics: Dict[str, torch.Tensor], restart: bool) -> None:
            """Keep a dispatch's metrics on the device; with ``restart`` (or
            at the first dispatch) wait for the device and restart the
            steady clock after it."""
            nonlocal gstep, n, n_first, t_first
            if not keys:
                keys.extend(metrics)
            block = torch.stack([metrics[key].reshape(-1) for key in keys])
            rows.append(block)
            ticks = block.shape[1]
            for _ in range(ticks):
                meter.tick()
            gstep += ticks
            n += ticks
            if t_first is None or restart:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_first, n_first = time.perf_counter(), n
            if gstep % cfg.run.log_every_n_steps < ticks:
                self.writer.scalars(dict(zip(keys, block[:, -1].tolist())), gstep,
                                    prefix="train/")
                self.writer.scalar("train/lr", get_lr(self.opt), gstep)
                if meter.audio_seconds_per_sec:
                    self.writer.scalar("perf/audio_seconds_per_s",
                                       meter.audio_seconds_per_sec, gstep)

        def single(host_batch: HostBatch) -> None:
            record(S.train_step(self.model, self.opt, self._device_batch(host_batch),
                                cfg), False)

        pending: List[HostBatch] = []
        for host_batch in batches:
            if k == 1:
                single(host_batch)
                continue
            pending.append(host_batch)
            if len(pending) == k:
                record(*self._dispatch(pending))
                pending = []
        for host_batch in pending:      # the ragged tail: single steps
            single(host_batch)
        if not rows:
            return {"epoch": epoch, "steps": 0}
        # one fetch: the fence that makes the epoch's wall time true
        host = torch.cat(rows, dim=1).double().cpu().numpy()
        t_end = time.perf_counter()
        dt = t_end - t0
        last = np.cumsum([r.shape[1] for r in rows]) - 1
        out: Dict[str, float] = {key: float(host[i, last].mean())
                                 for i, key in enumerate(keys)}
        out.update(epoch=epoch, steps=n, nonfinite_loss_steps=int(
            (~np.isfinite(host[keys.index("loss")])).sum()))
        if dt > 0:
            out["audio_seconds_per_s"] = n * meter.aps / dt
        if n > n_first:
            out["steady_audio_seconds_per_s"] = (
                (n - n_first) * meter.aps / (t_end - t_first))
        self._last_train_metrics = out
        return out

    def _dispatch(self, host_batches: List[HostBatch]
                  ) -> Tuple[Dict[str, torch.Tensor], bool]:
        """K host batches through the scanned step: (its metrics, whether
        this call captured the graph). Prints a line at the capture."""
        scanned = self._scanned
        uncaptured = scanned.graph is None
        metrics = scanned(torch.from_numpy(np.stack([b["noisy"] for b in host_batches])),
                          torch.from_numpy(np.stack([b["clean"] for b in host_batches])))
        captured = uncaptured and scanned.graph is not None
        if captured:
            print(f"graph: captured {scanned.k} train steps in {scanned.capture_s:.2f} s, "
                  f"private pool {scanned.pool_bytes / 2**20:.1f} MiB", flush=True)
        return metrics, captured

    def eval_epoch(self, batches: Iterable[HostBatch], epoch: int,
                   phase: str = "val", compute_metrics: bool = True,
                   max_batches: Optional[int] = None,
                   per_utterance_csv: Optional[str] = None,
                   composite: bool = False) -> Dict[str, float]:
        """Eval-mode passes over the batches (the first ``max_batches``),
        as the JAX trainer's ``eval_epoch``: the losses and, with
        ``compute_metrics``, STOI and PESQ of each batch, averaged over the
        batches as ``<phase>_<key>``; a batch with a non-finite loss is
        reported and left out. A batch's losses and audio come to the host
        in one copy; the metrics run there.

        A batch's metric is the mean over its utterances with NaNs and
        failures left out (0.0 if none is left). Per utterance
        (``cfg.run.per_utterance_eval_metrics``, ``composite`` or a CSV),
        each metric runs once an utterance, and ``per_utterance_csv`` gets a
        row ``id,start,stoi,<pesq_key>,si_sdr`` for each, with
        ``composite`` also SegSNR, LLR, WSS and CSIG/CBAK/COVL, whose finite
        values are averaged over the utterances. One batch, drawn by
        reservoir sampling from a generator keyed by (seed, epoch), has its
        audio written (``cfg.run.val_log_sample_size`` utterances)."""
        cfg = self.cfg
        sr = cfg.data.sr
        agg: Dict[str, List[float]] = {}
        sampled_audio: Dict[str, np.ndarray] = {}
        # the sanity pass's epoch is -1; numpy seeds are non-negative
        rng = np.random.default_rng((cfg.run.seed, epoch & 0x7FFFFFFF))
        n_seen = 0
        per_utt = cfg.run.per_utterance_eval_metrics or composite or bool(per_utterance_csv)
        csv_f = None
        if per_utterance_csv:
            os.makedirs(os.path.dirname(per_utterance_csv) or ".", exist_ok=True)
            csv_f = open(per_utterance_csv, "w")
            csv_f.write(f"id,start,stoi,{self.pesq_key},si_sdr"
                        + ("," + ",".join(COMPOSITE_KEYS) if composite else "") + "\n")
        try:
            for i, host_batch in enumerate(itertools.islice(batches, max_batches)):
                losses, audio = self._eval_batch(host_batch)
                if not np.isfinite(losses["loss"]):
                    print(f"found a NaN in {phase} loss! (epoch {epoch}, batch {i}, skipped)")
                    continue
                for k, v in losses.items():
                    agg.setdefault(k, []).append(v)
                if compute_metrics:
                    clean, pred = audio["clean"], audio["predict_clean"]
                    if not per_utt:
                        agg.setdefault("stoi", []).append(
                            H.calc_metric(clean, pred, sr, H.stoi_metric))
                        if self.pesq_fn is not None:
                            agg.setdefault(self.pesq_key, []).append(
                                H.calc_metric(clean, pred, sr, self.pesq_fn))
                    else:
                        self._per_utterance(host_batch, clean, pred, agg, csv_f, composite)
                n_seen += 1
                if rng.integers(n_seen) == 0:   # reservoir: kept with probability 1/n
                    sampled_audio = audio
        finally:
            if csv_f is not None:
                csv_f.close()
        out = {f"{phase}_{k}": float(np.sum(v)) / len(v) for k, v in agg.items() if v}
        if sampled_audio:
            log_epoch_audio(self.writer, sampled_audio, self.step, sr, phase, rng,
                            cfg.run.val_log_sample_size)
        self.writer.scalars(out, self.step)
        return out

    def _eval_batch(self, host_batch: HostBatch
                    ) -> Tuple[Dict[str, float], Dict[str, np.ndarray]]:
        """``S.eval_step`` on one batch, through the trainer's graph cache
        (on the card one CUDA graph a batch shape, captured at its second
        batch); its losses as floats and its audio streams as (B, n) arrays,
        fetched from the device in one copy."""
        losses, audio = S.eval_waves(self.model, *self._device_waves(host_batch), self.cfg,
                                     self._eval_graphs)
        flat = torch.cat([torch.stack(list(losses.values())).reshape(-1)]
                         + [v.reshape(-1) for v in audio.values()]).cpu().numpy()
        host_losses = {k: float(v) for k, v in zip(losses, flat)}
        host_audio, at = {}, len(losses)
        for k, v in audio.items():
            host_audio[k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
            at += v.numel()
        return host_losses, host_audio

    def _per_utterance(self, host_batch: HostBatch, clean: np.ndarray, pred: np.ndarray,
                       agg: Dict[str, List[float]], csv_f, composite: bool) -> None:
        """Each metric once an utterance: the batch's NaN-dropped STOI and
        PESQ means into ``agg``, the finite composite measures one by one,
        and a CSV row per utterance."""
        sr = self.cfg.data.sr
        n = clean.shape[0]
        ids = host_batch.get("id", [str(j) for j in range(n)])
        starts = np.asarray(host_batch.get("start", np.zeros(n, np.int64)))
        b_stoi, b_pesq = [], []
        for j, utt_id in enumerate(ids):
            try:
                s = H.stoi_metric(clean[j], pred[j], sr)
            except Exception:   # as calc_metric: a failure scores NaN
                s = float("nan")
            pq = self.pesq_fn(clean[j], pred[j], sr) if self.pesq_fn else float("nan")
            b_stoi.append(s)
            b_pesq.append(pq)
            row = (f"{utt_id},{int(starts[j])},{s:.4f},{pq:.4f},"
                   f"{H.si_sdr(clean[j], pred[j]):.4f}")
            if composite:
                c = C.composite(clean[j], pred[j], sr, pesq_mos=pq)
                for k in COMPOSITE_KEYS:
                    if np.isfinite(c[k]):
                        agg.setdefault(k, []).append(c[k])
                row += "," + ",".join(f"{c[k]:.4f}" for k in COMPOSITE_KEYS)
            if csv_f is not None:
                csv_f.write(row + "\n")
        agg.setdefault("stoi", []).append(_nan_drop_mean(b_stoi))
        if self.pesq_fn is not None:
            agg.setdefault(self.pesq_key, []).append(_nan_drop_mean(b_pesq))

    # -- schedule -------------------------------------------------------------
    def monitored_metric(self, val_metrics: Dict[str, float]) -> float:
        if self.cfg.model.subtractive:
            return val_metrics.get("val_loss", float("inf"))
        return self._last_train_metrics.get(
            "speech_loss", val_metrics.get("val_speech_loss", float("inf")))

    def end_of_epoch(self, epoch: int, val_metrics: Dict[str, float]) -> None:
        """The plateau until the SWA start epoch, then the learning rate held
        and the parameters averaged."""
        if self.swa is None or epoch < self.swa.start_epoch:
            lr = get_lr(self.opt)
            self.plateau.step(self.monitored_metric(val_metrics))
            if get_lr(self.opt) != lr:
                print(f"epoch {epoch}: reducing lr {lr:.3e} -> {get_lr(self.opt):.3e}")
        if self.swa is not None:
            self.swa.update(epoch, self.model.parameters())
        self.epoch = epoch + 1

    def finalize_swa(self, train_batches: Optional[Iterable[HostBatch]] = None,
                     max_batches: Optional[int] = None) -> int:
        """Copy the SWA average into the parameters and, when train data is
        given, refresh the BN running statistics for it. Returns the number
        of batches the refresh ran."""
        if self.swa is None or not self.swa.active:
            return 0
        with torch.no_grad():
            torch._foreach_copy_(list(self.model.parameters()), self.swa.avg_params)
        if train_batches is None:
            return 0
        return self.recompute_batch_stats(train_batches, max_batches)

    def recompute_batch_stats(self, batches: Iterable[HostBatch],
                              max_batches: Optional[int] = None) -> int:
        """The BN refresh: train-mode forwards over the batches (the first
        ``max_batches``) with the parameters and Adam untouched, under
        ``no_grad``; the running statistics become the cumulative average of
        the batches' own statistics (torch ``update_bn`` semantics). As in
        the JAX package, a batch's statistic is recovered from one
        momentum-0.1 update of the statistics the pass started from, as
        (new - 0.9 old) / 0.1, for the complex and the real BN alike.
        Returns the number of batches."""
        m = 0.1
        bufs = dict(self.model.named_buffers())
        old = {k: v.clone() for k, v in bufs.items()}
        avg: Optional[Dict[str, torch.Tensor]] = None
        n = 0
        was_training = self.model.training
        self.model.train()
        self._dropout.manual_seed(self.cfg.run.seed ^ 0x5A5A5A)
        self.model.set_dropout_generator(self._dropout)
        try:
            with torch.no_grad():
                for n, host_batch in enumerate(itertools.islice(batches, max_batches), 1):
                    noisy = self._device_batch(host_batch).noisy
                    for k, v in bufs.items():
                        v.copy_(old[k])
                    self.model(noisy if self.cfg.model.complex_valued else noisy.abs())
                    bs = {k: (v - (1 - m) * old[k]) / m for k, v in bufs.items()}
                    avg = bs if avg is None else {
                        k: a + (bs[k] - a) / n for k, a in avg.items()}
                for k, v in bufs.items():
                    v.copy_(old[k] if avg is None else avg[k])
        finally:
            self.model.train(was_training)
        return n

    # -- checkpoints ----------------------------------------------------------
    def save(self, ckpt: CheckpointManager, epoch: int) -> str:
        return ckpt.save(self.step, self.model, self.opt, config=self.cfg, extra={
            "epoch": epoch, "plateau": self.plateau.state_dict()})

    def restore(self, ckpt: CheckpointManager) -> int:
        """Load the latest checkpoint into the model and optimizer and move
        the loop past its epoch; returns the restored step. A captured graph
        is thrown away (the optimizer's state tensors are new): the next
        epoch warms up and captures anew. So are the eval graphs."""
        extra = ckpt.restore(self.model, self.opt)
        self._scanned = None
        self._eval_graphs.clear()
        self.epoch = int(extra["epoch"]) + 1
        self.plateau.load_state_dict(extra["plateau"])
        return self.step

    # -- fit ----------------------------------------------------------------
    def fit(self, train_loader, val_loader,
            callbacks: Optional[TrainerCallbacks] = None,
            ckpt: Optional[CheckpointManager] = None,
            max_epochs: Optional[int] = None) -> Dict[str, float]:
        """The sanity-validation pass, then epochs from ``self.epoch`` to
        ``max_epochs`` (default ``cfg.run.max_epochs``) or until
        ``callbacks.on_validation_end`` returns True, then ``finalize_swa``
        over the next epoch's train batches. Returns the last epoch's train
        and validation metrics, with SWA on also ``swa_n_averaged`` and
        ``bn_refresh_batches``, and where a CUDA graph of the steps was
        captured, ``graph_replays`` (since the last capture)."""
        cfg = self.cfg
        if self.model is None:
            self.init_state()
        if cfg.run.num_sanity_val_steps:
            self.eval_epoch(val_loader.epoch(0), -1, phase="sanity",
                            compute_metrics=False,
                            max_batches=cfg.run.num_sanity_val_steps)
        metrics: Dict[str, float] = {}
        for epoch in range(self.epoch, max_epochs or cfg.run.max_epochs):
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
            if callbacks and callbacks.on_validation_end and \
                    callbacks.on_validation_end(epoch, val_metrics):
                break
        refreshed = self.finalize_swa(train_loader.epoch(self.epoch))
        if self.swa is not None:
            metrics.update(swa_n_averaged=self.swa.n_averaged,
                           bn_refresh_batches=refreshed)
        if self._scanned is not None and self._scanned.graph is not None:
            metrics["graph_replays"] = self._scanned.replays
        self.writer.flush()
        return metrics

    def test(self, test_loader) -> Dict[str, float]:
        """The test pass: ``eval_epoch`` over epoch 0 of ``test_loader``."""
        return self.eval_epoch(test_loader.epoch(0), 0, phase="test")


def _nan_drop_mean(vals: List[float]) -> float:
    """The mean of the finite values, 0.0 if there is none (``calc_metric``'s
    rule)."""
    a = np.asarray(vals, np.float64)
    ok = np.isfinite(a)
    return float(a[ok].sum() / max(ok.sum(), 1))
