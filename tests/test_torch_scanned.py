"""The port's K-steps-per-dispatch training (``steps_per_dispatch``, the JAX
scanned step; on the card a CUDA graph of K train steps) against the JAX
package and against itself, on a narrow three-layer DRS net and synthetic
data: the scanned step at K = 2 against the JAX ``make_scanned_train_step``
from the same weights (dropout off), ``Trainer.train_epoch`` at K = 2 over
an epoch of 3 batches (a dispatch and a single-step tail) against the JAX
trainer's, K = 2 against K = 1 with dropout on and a resumed K = 2 run
against an uninterrupted one, both bit for bit, the learning-rate tensor
that a captured step reads through the plateau and a restore, and the
trainer's grouping and log cadence. The port runs on the CPU here: the K
steps eagerly, its kernels' plain versions.

Two JAX compiles of a train step: the JAX trainer's scanned step and its
single step, which the tail runs.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.data import dataset as jdataset
from dcs_net_tpu.data import partition as jpartition
from dcs_net_tpu.parallel import mesh as jmesh
from dcs_net_tpu.train import loop as jloop

from dcs_net_tpu_torch.cli import train as cli_train
from dcs_net_tpu_torch.cli.common import make_loaders
from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.data import synthetic
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.train import loop as tloop
from dcs_net_tpu_torch.train import steps as TS
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
from dcs_net_tpu_torch.train.optim import (get_lr, load_optimizer_state, make_optimizer,
                                           make_plateau, optimizer_tensors, step_count)

from test_torch_real import NARROW, _perturb
from test_torch_train import _band, _one_torch_thread  # noqa: F401

CROP, BATCH, K = 2016, 2, 2
LR = 1e-4


def _cfg(make, root, log_dir="", *, k=K, dropout=False, epochs=1):
    """Narrow DRS on the synthetic tree at ``root``, K steps a dispatch, no
    sanity pass."""
    cfg = make("drs")
    model = dataclasses.replace(cfg.model, **NARROW)
    if not dropout:
        model = dataclasses.replace(model, dropout_conv=0.0, dropout_fc=0.0)
    return cfg.replace(
        model=model,
        data=dataclasses.replace(cfg.data, root=root, crop_samples=CROP,
                                 batch_size=BATCH, num_workers=1),
        run=dataclasses.replace(cfg.run, max_epochs=epochs, num_sanity_val_steps=0,
                                steps_per_dispatch=k, log_dir=log_dir))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """8 synthetic pairs: 6 train (3 batches of 2 an epoch), 2 val."""
    root = str(tmp_path_factory.mktemp("vb"))
    synthetic.generate(root, n_train=8, n_test=2, seconds=0.6)
    return root


def _train_loader(cfg):
    loaders = make_loaders(cfg)
    loaders[1].close()
    return loaders[0]


@pytest.fixture(scope="module")
def weights():
    return _perturb(DCSNet(_cfg(config_for_variant, "").model,
                           _cfg(config_for_variant, "").quirks,
                           device="cpu", seed=21).state_dict(), 22)


@pytest.fixture(scope="module")
def jax_trainer(data_root, tmp_path_factory):
    """The JAX trainer at K = 2 on one device (no cross-device collectives,
    whose rendezvous stalls when other test workers hold the CPU's cores),
    PESQ off, its state not donated (the tests start it anew from weights,
    and a donated state takes the optimizer's learning-rate array with
    it)."""
    cfg = _cfg(jax_config_for_variant, data_root, str(tmp_path_factory.mktemp("jlogs")))
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, donate_state=False))
    with mock.patch.object(jmesh, "dp_devices", lambda *a, **k: jax.devices()[:1]):
        trainer = jloop.Trainer(cfg, use_tensorboard=False, pesq_fn=lambda *a: 0.0)
    trainer.pesq_fn = None
    trainer.init_state()
    return trainer


def _jax_state_from(trainer, weights):
    """A fresh JAX train state (replicated) holding the port's ``weights``."""
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    state = trainer.state.replace(step=jnp.zeros((), jnp.int32),
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=trainer.tx.init(variables["params"]))
    return jax.device_put(state, jmesh.replicated(trainer.mesh))


def _port_model(cfg, weights):
    model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _held_in_train_step_band(got, want_state, k):
    """Parameters within K times the train step's sensitivity bound for a
    leaf in any direction (one Adam step moves a parameter by at most about
    lr: 3e-5 + 2 lr a step between two runs); BN statistics within the
    oracle band. ``got`` is the port's state dict, ``want_state`` the JAX
    state in the port's names."""
    params = dict(got)
    assert set(params) == set(want_state)
    allowed = k * (3e-5 + 2 * LR)
    for name, want in want_state.items():
        g, w = params[name].numpy(), want.numpy()
        if name.rsplit(".", 1)[-1] in ("mean", "var"):
            _band(g, w, name)
        else:
            worst = float(np.abs(g - w).max())
            assert worst <= allowed, f"{name}: {worst} beyond {allowed}"


def _host_waves(cfg, n):
    """The first ``n`` train batches of epoch 0 as (n, B, crop) waves."""
    loader = _train_loader(cfg)
    try:
        batches = list(loader.epoch(0))[:n]
    finally:
        loader.close()
    return (np.stack([b["noisy"] for b in batches]),
            np.stack([b["clean"] for b in batches]))


def test_scanned_step_matches_jax(data_root, weights, jax_trainer):
    """K = 2 steps from the same converted weights, dropout off: the last
    inner step's losses within rtol 1e-3 of the JAX scanned step's (which
    returns only that step's), every step's count; the parameters and BN
    statistics after them in the train step's band."""
    tcfg = _cfg(config_for_variant, data_root)
    noisy, clean = _host_waves(tcfg, K)
    state, jmetrics = jax_trainer._scanned_step(
        _jax_state_from(jax_trainer, weights), jnp.asarray(noisy), jnp.asarray(clean),
        jax.random.PRNGKey(3))
    model = _port_model(tcfg, weights)
    opt = make_optimizer(model.parameters(), tcfg.optim)
    out = TS.make_scanned_train_step(model, opt, tcfg, K)(torch.from_numpy(noisy),
                                                          torch.from_numpy(clean))
    assert all(tuple(v.shape) == (K,) for v in out.values())
    for key in ("loss", "noise_loss", "speech_loss", "grad_norm"):
        np.testing.assert_allclose(float(out[key][-1]), float(jmetrics[key]), rtol=1e-3,
                                   err_msg=key)
    assert out["skipped"].tolist() == [0.0] * K
    assert step_count(opt) == int(state.step) == K
    _held_in_train_step_band(model.state_dict(), params_from_jax(jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})), K)


def test_trainer_epoch_with_a_tail_matches_jax(data_root, weights, jax_trainer, tmp_path):
    """``train_epoch`` at K = 2 over 3 batches, a dispatch and a single
    step, in each package from the same weights, dropout off: the same step
    count, the epoch means (each dispatch's last step and the tail step,
    averaged) within rtol 1e-3, the parameters in the train step's band."""
    tcfg = _cfg(config_for_variant, data_root, str(tmp_path / "logs"))
    jcfg = jax_trainer.cfg
    jax_trainer.state = _jax_state_from(jax_trainer, weights)
    part = jpartition.make_partition(jcfg.data, seed=jcfg.run.seed)
    jloader = jdataset.Loader(jdataset.VoiceBankDataset(part["train"], jcfg.data, "train"),
                              batch_size=BATCH, drop_last=True, num_workers=1,
                              seed=jcfg.run.seed, use_native=False)
    try:
        jm = jax_trainer.train_epoch(jloader.epoch(0), 0)
    finally:
        jloader.close()
    trainer = tloop.Trainer(tcfg, device="cpu", pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    trainer.model.load_state_dict(weights, strict=True)
    loader = _train_loader(tcfg)
    try:
        tm = trainer.train_epoch(loader.epoch(0), 0)
    finally:
        loader.close()
        trainer.writer.close()
    assert tm["steps"] == trainer.step == int(jax_trainer.state.step) == 3
    assert tm["nonfinite_loss_steps"] == 0
    for key in ("loss", "noise_loss", "speech_loss", "grad_norm"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-3, err_msg=key)
    _held_in_train_step_band(trainer.model.state_dict(), params_from_jax(jax.tree.map(
        np.asarray, {"params": jax_trainer.state.params,
                     "batch_stats": jax_trainer.state.batch_stats})), 3)


def _epoch(cfg, weights, k, root_log):
    """One port ``train_epoch`` at ``k`` steps a dispatch, dropout on; the
    trainer and its metrics."""
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, steps_per_dispatch=k,
                                              log_dir=root_log))
    trainer = tloop.Trainer(cfg, device="cpu", pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    trainer.model.load_state_dict(weights, strict=True)
    loader = _train_loader(cfg)
    try:
        metrics = trainer.train_epoch(loader.epoch(0), 0)
    finally:
        loader.close()
        trainer.writer.close()
    return trainer, metrics


def test_k2_equals_k1_bit_for_bit_with_dropout(data_root, weights, tmp_path):
    """Grouping steps into dispatches changes nothing the steps compute:
    with dropout on, parameters, BN statistics and every Adam tensor after
    an epoch at K = 2 (a dispatch and a tail) equal K = 1's bit for bit, the
    masks drawn from the trainer's one generator in the same order."""
    cfg = _cfg(config_for_variant, data_root, dropout=True)
    assert cfg.model.dropout_conv > 0
    one, m1 = _epoch(cfg, weights, 1, str(tmp_path / "k1"))
    two, m2 = _epoch(cfg, weights, 2, str(tmp_path / "k2"))
    assert m1["steps"] == m2["steps"] == 3
    for (name, a), b in zip(one.model.state_dict().items(), two.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(optimizer_tensors(one.opt), optimizer_tensors(two.opt)):
        assert torch.equal(a, b)
    # K = 1 averages all 3 steps; K = 2 the dispatch's last step and the tail
    assert m1["loss"] != m2["loss"]


def _cli(tmp_path, name, cfg, epochs, *flags):
    cfg = cfg.replace(run=dataclasses.replace(
        cfg.run, max_epochs=epochs, ckpt_dir=str(tmp_path / name / "ckpt"),
        log_dir=str(tmp_path / name / "logs")))
    path = tmp_path / f"{name}_{epochs}.json"
    path.write_text(cfg.to_json())
    metrics = cli_train.main(["drs", "--config-json", str(path), "--device", "cpu",
                              "--steps-per-dispatch", str(K), *flags])
    return CheckpointManager(cfg.run.ckpt_dir), metrics


def test_resumed_k2_run_equals_the_uninterrupted_one_bit_for_bit(data_root, tmp_path):
    """``cli.train --steps-per-dispatch 2``, dropout on: 2 epochs straight
    and 1 epoch then ``--resume``; the last checkpoints' parameters, BN
    statistics and Adam state are equal bit for bit."""
    cfg = _cfg(config_for_variant, data_root, dropout=True)
    straight, m = _cli(tmp_path, "straight", cfg, 2)
    _cli(tmp_path, "split", cfg, 1)
    split, _ = _cli(tmp_path, "split", cfg, 2, "--resume")
    assert m["steps"] == 3 and straight.latest_step() == split.latest_step() == 6
    a = torch.load(os.path.join(straight.directory, "step_6.pt"), weights_only=True)
    b = torch.load(os.path.join(split.directory, "step_6.pt"), weights_only=True)
    for key in a["model"]:
        assert torch.equal(a["model"][key], b["model"][key]), key
    for pa, pb in zip(a["optim"]["state"].values(), b["optim"]["state"].values()):
        for key in pa:
            assert torch.equal(pa[key], pb[key]), key
    with open(os.path.join(straight.directory, "config.json")) as f:
        assert json.load(f)["run"]["steps_per_dispatch"] == K


def test_plateau_and_restore_keep_the_learning_rate_tensor(tmp_path):
    """On the card the learning rate is a 0-d tensor that a captured step
    reads at every replay: a plateau reduction fills that tensor in place,
    a restore writes the saved value into it, and a float learning rate
    (the CPU's) stays a float through a restore."""
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = torch.optim.Adam(params, lr=torch.tensor(LR), amsgrad=True)
    lr = opt.param_groups[0]["lr"]
    cfg = config_for_variant("drs").optim
    plateau = make_plateau(opt, cfg)
    for metric in [1.0] + [2.0] * (cfg.plateau_patience + 1):
        plateau.step(metric)
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == pytest.approx(LR * cfg.plateau_factor, rel=1e-6)
    saved = copy.deepcopy(opt.state_dict())
    lr.fill_(LR)
    load_optimizer_state(opt, saved)
    assert opt.param_groups[0]["lr"] is lr and get_lr(opt) == float(saved["param_groups"][0]["lr"])
    float_opt = make_optimizer(params, cfg)
    assert isinstance(float_opt.param_groups[0]["lr"], float)
    load_optimizer_state(float_opt, saved)
    assert isinstance(float_opt.param_groups[0]["lr"], float)
    assert get_lr(float_opt) == get_lr(opt)


class _FakeSteps:
    """``train_step`` and ``batch_from_waves`` stand-ins that count the
    steps and return step i's loss as i + 1 (no model runs)."""

    def __init__(self):
        self.calls = 0

    def batch(self, noisy, clean, cfg):
        return noisy

    def step(self, model, opt, batch, cfg):
        self.calls += 1
        return {"loss": torch.tensor(float(self.calls)), "skipped": torch.tensor(0.0)}


@pytest.mark.parametrize("k,n,dispatches,logged", [
    (3, 7, 2, [6]),         # two dispatches (gsteps 3, 6), one single step (7)
    (1, 7, 0, [4]),
    (4, 3, 0, []),          # fewer batches than K: the whole epoch is the tail
    (2, 8, 4, [4, 8]),
])
def test_trainer_groups_k_batches_a_dispatch(k, n, dispatches, logged, tmp_path,
                                             monkeypatch):
    """``n`` batches at K = ``k``: ``n // k`` calls of the scanned step,
    the rest single steps, in order; a log when a multiple of
    ``log_every_n_steps`` (4) falls within a dispatch, of its last step; the
    epoch means over the dispatches' last steps and the single steps, as
    the JAX trainer averages them; every step counted."""
    fake = _FakeSteps()
    monkeypatch.setattr(TS, "train_step", fake.step)
    monkeypatch.setattr(TS, "batch_from_waves", fake.batch)
    cfg = _cfg(config_for_variant, "", str(tmp_path), k=k)
    cfg = cfg.replace(run=dataclasses.replace(cfg.run, log_every_n_steps=4))
    trainer = tloop.Trainer(cfg, device="cpu", pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    calls = []
    real_call = TS.ScannedTrainStep.__call__

    def spy(self, noisy, clean):
        calls.append(tuple(noisy.shape))
        return real_call(self, noisy, clean)

    monkeypatch.setattr(TS.ScannedTrainStep, "__call__", spy)
    batches = [{"noisy": np.zeros((BATCH, 4), np.float32),
                "clean": np.zeros((BATCH, 4), np.float32)} for _ in range(n)]
    metrics = trainer.train_epoch(batches, 0)
    trainer.writer.close()
    assert calls == [(k, BATCH, 4)] * dispatches and fake.calls == n
    assert metrics["steps"] == n and metrics["nonfinite_loss_steps"] == 0
    kept = [k * (i + 1) for i in range(dispatches)] + list(range(dispatches * k + 1, n + 1))
    assert metrics["loss"] == pytest.approx(np.mean(kept))
    with open(os.path.join(str(tmp_path), "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    assert [(e["step"], e["value"]) for e in events if e["tag"] == "train/loss"] == [
        (s, float(s)) for s in logged]


def test_the_loader_makes_no_cuda_call():
    """The loader's threads prefetch while the trainer captures a CUDA graph,
    which forbids CUDA calls from any thread: the loader and its wav I/O
    import no torch at all."""
    code = ("import sys, dcs_net_tpu_torch.data.dataset; "
            "sys.exit(int('torch' in sys.modules))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=120,
                       env=dict(os.environ, PYTHONPATH=root))
    assert r.returncode == 0
