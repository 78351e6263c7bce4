"""The port's trainer against the JAX package's, on a narrow three-layer
config and synthetic data: ``Trainer.fit`` over 2 epochs with SWA from epoch
1 (final parameters and BN statistics after the SWA swap and the BN refresh),
the BN refresh alone on the complex and the real BN, ``SWA.update``; and the
port on its own: the sanity-validation pass, a callback that stops training,
a run resumed after its first epoch equal bit for bit to the uninterrupted
one with dropout on, and ``cli.enhance --ckpt-dir`` serving what
``cli.train`` wrote. The port runs on the CPU here: its kernels' plain
versions. PESQ is off in the JAX trainer here: these tests compare training,
and ``tests/test_torch_eval.py`` compares the validation metrics.
"""

import dataclasses
import json
import os
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
from dcs_net_tpu.train.optim import SWA as JaxSWA

from dcs_net_tpu_torch.cli import enhance as cli_enhance
from dcs_net_tpu_torch.cli import train as cli_train
from dcs_net_tpu_torch.cli.common import make_loaders
from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import Config, config_for_variant
from dcs_net_tpu_torch.data import synthetic
from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
from dcs_net_tpu_torch.models.enhance import enhance_full
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.train import loop as tloop
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager, load_model
from dcs_net_tpu_torch.train.optim import SWA

from test_torch_real import NARROW, _perturb
from test_torch_train import _band, _one_torch_thread  # noqa: F401

CROP, BATCH = 2016, 2


def _cfg(make, variant, root, log_dir, *, epochs=2, swa_from=1, dropout=False,
         sanity=1):
    """Narrow ``variant`` on the synthetic tree at ``root``: SWA from epoch
    ``swa_from`` of ``epochs`` (``swa_start_frac`` = swa_from / epochs)."""
    cfg = make(variant)
    model = dataclasses.replace(cfg.model, **NARROW)
    if not dropout:
        model = dataclasses.replace(model, dropout_conv=0.0, dropout_fc=0.0)
    return cfg.replace(
        model=model,
        data=dataclasses.replace(cfg.data, root=root, crop_samples=CROP,
                                 batch_size=BATCH, num_workers=1),
        optim=dataclasses.replace(cfg.optim, swa=True, swa_start_frac=swa_from / epochs),
        run=dataclasses.replace(cfg.run, max_epochs=epochs, num_sanity_val_steps=sanity,
                                log_dir=log_dir))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """6 synthetic pairs: 5 train (2 steps an epoch at batch 2), 1 val."""
    root = str(tmp_path_factory.mktemp("vb"))
    synthetic.generate(root, n_train=6, n_test=2, seconds=0.6)
    return root


def _jax_loaders(cfg):
    part = jpartition.make_partition(cfg.data, seed=cfg.run.seed)
    return tuple(jdataset.Loader(
        jdataset.VoiceBankDataset(part[name], cfg.data, name), batch_size=BATCH,
        drop_last=(name == "train"), num_workers=1, seed=cfg.run.seed,
        use_native=False) for name in ("train", "val"))


def _jax_trainer(cfg, weights):
    """The JAX trainer on one device (no cross-device collectives, whose
    rendezvous stalls when other test workers hold the CPU's cores), with
    PESQ off, its state the port's ``weights`` and a fresh optimizer."""
    with mock.patch.object(jmesh, "dp_devices", lambda *a, **k: jax.devices()[:1]):
        trainer = jloop.Trainer(cfg, use_tensorboard=False, pesq_fn=lambda *a: 0.0)
    trainer.pesq_fn = None
    trainer.init_state()
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    state = trainer.state.replace(params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=trainer.tx.init(variables["params"]))
    trainer.state = jax.device_put(state, jmesh.replicated(trainer.mesh))
    return trainer


def _port_trainer(cfg, weights):
    trainer = tloop.Trainer(cfg, device="cpu")
    trainer.init_state()
    trainer.model.load_state_dict(weights, strict=True)
    return trainer


def _jax_state(trainer):
    return params_from_jax(jax.tree.map(np.asarray, {
        "params": trainer.state.params, "batch_stats": trainer.state.batch_stats}))


@pytest.fixture(scope="module")
def fit_pair(data_root, tmp_path_factory):
    """``fit`` of each package over 2 epochs from the same weights, dropout
    off, SWA from epoch 1, on the same batches."""
    logs = tmp_path_factory.mktemp("logs")
    jcfg = _cfg(jax_config_for_variant, "drs", data_root, str(logs / "jax"))
    tcfg = _cfg(config_for_variant, "drs", data_root, str(logs / "port"))
    weights = _perturb(DCSNet(tcfg.model, tcfg.quirks, device="cpu", seed=7).state_dict(), 8)
    jtrainer = _jax_trainer(jcfg, weights)
    jtrain, jval = _jax_loaders(jcfg)
    jtrainer.fit(jtrain, jval)
    ttrainer = _port_trainer(tcfg, weights)
    ttrain, tval = make_loaders(tcfg)
    try:
        metrics = ttrainer.fit(ttrain, tval)
    finally:
        for loader in (jtrain, jval, ttrain, tval):
            loader.close()
        ttrainer.writer.close()
    return dict(jax=jtrainer, port=ttrainer, metrics=metrics, weights=weights,
                logs=logs)


def test_fit_with_swa_matches_jax_in_parameters_and_bn_statistics(fit_pair):
    """After 2 epochs (4 steps), the SWA swap and the BN refresh over the
    next epoch's 2 train batches: every parameter and BN statistic in the
    JAX oracle test's band."""
    want, got = _jax_state(fit_pair["jax"]), fit_pair["port"].model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        _band(got[name].numpy(), w.numpy(), name)
    m = fit_pair["metrics"]
    assert m["epoch"] == 1 and m["steps"] == 2
    assert m["swa_n_averaged"] == 1 and m["bn_refresh_batches"] == 2


def test_fit_ran_swa_and_held_the_learning_rate_as_jax(fit_pair):
    """Both averaged once (epoch 1) and swapped the average in; the plateau
    stepped at epoch 0 only."""
    j, t = fit_pair["jax"], fit_pair["port"]
    assert t.swa.start_epoch == j.swa.start_epoch == 1
    assert t.swa.n_averaged == j.swa.n_averaged == 1
    for p, a in zip(t.model.parameters(), t.swa.avg_params):
        assert torch.equal(p.detach(), a)
    assert t.plateau.best == pytest.approx(j.plateau.best, rel=1e-3)
    assert t.plateau.num_bad_epochs == j.plateau.num_bad == 0
    assert t.epoch == j.epoch == 2 and t.step == int(j.state.step) == 4


def _zero_stats(weights):
    """``weights`` with every BN running statistic 0. A train-mode forward
    does not read them; the refresh recovers a batch statistic from one
    momentum update of them, as (new - 0.9 old) / 0.1, whose rounding then
    stays at the statistic's own scale."""
    stats = {k for k in weights if k.rsplit(".", 1)[-1] in
             ("mean", "var", "mean_r", "mean_i", "vrr", "vii", "vri")}
    return {k: torch.zeros_like(v) if k in stats else v for k, v in weights.items()}


def test_recompute_batch_stats_is_the_mean_of_the_batch_statistics(data_root, tmp_path):
    """With one batch the refresh gives that batch's own statistics: at the
    input BN, the mean and the unbiased variance of the magnitude."""
    cfg = _cfg(config_for_variant, "drs", data_root, str(tmp_path / "logs"))
    trainer = _port_trainer(cfg, _zero_stats(
        DCSNet(cfg.model, cfg.quirks, device="cpu", seed=9).state_dict()))
    train, val = make_loaders(cfg)
    try:
        batch = next(iter(train.epoch(5)))
    finally:
        train.close()
        val.close()
    trainer.recompute_batch_stats([batch])
    x = trainer._device_batch(batch).noisy.abs()
    bn = trainer.model.initial_bn
    torch.testing.assert_close(bn.mean, x.mean().reshape(1), rtol=1e-5, atol=0.0)
    torch.testing.assert_close(bn.var, x.var(correction=1).reshape(1), rtol=1e-5, atol=0.0)
    assert all(p.grad is None for p in trainer.model.parameters())


@pytest.mark.parametrize("variant", ["drs", "dcs"])
def test_recompute_batch_stats_matches_jax(data_root, tmp_path, variant):
    """The BN refresh alone, on the same parameters and 2 batches, for the
    real BN (mean, var) and the complex one (mean_r, mean_i, vrr, vii, vri):
    within 1e-5 of each statistic's largest value; the parameters and the
    optimizer do not move."""
    jcfg = _cfg(jax_config_for_variant, variant, data_root, str(tmp_path / "j"))
    tcfg = _cfg(config_for_variant, variant, data_root, str(tmp_path / "t"))
    weights = _zero_stats(DCSNet(tcfg.model, tcfg.quirks, device="cpu", seed=11).state_dict())
    jtrainer, ttrainer = _jax_trainer(jcfg, weights), _port_trainer(tcfg, weights)
    (jtrain, jval), (ttrain, tval) = _jax_loaders(jcfg), make_loaders(tcfg)
    try:
        jtrainer.recompute_batch_stats(jtrain.epoch(3), max_batches=2)
        ttrainer.recompute_batch_stats(ttrain.epoch(3), max_batches=2)
    finally:
        for loader in (jtrain, jval, ttrain, tval):
            loader.close()
    want, got = _jax_state(jtrainer), ttrainer.model.state_dict()
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)
        if name.endswith(("mean", "mean_r", "var", "vrr")):
            assert float(got[name].abs().max()) > 0, f"{name} was not refreshed"
        elif name not in dict(ttrainer.model.named_buffers()):
            assert torch.equal(got[name], weights[name]), f"{name} moved"
    assert ttrainer.step == 0 and int(jtrainer.state.step) == 0


def test_swa_update_matches_jax():
    """Three epochs of parameters averaged from epoch 1: the average of the
    last two, as the JAX ``SWA`` computes it."""
    rng = np.random.default_rng(12)
    snaps = [[rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
             for _ in range(3)]
    ours, theirs = SWA(start_epoch=1), JaxSWA(start_epoch=1)
    for epoch, snap in enumerate(snaps):
        ours.update(epoch, [torch.from_numpy(a) for a in snap])
        theirs.update(epoch, {"a": jnp.asarray(snap[0]), "b": jnp.asarray(snap[1])})
        assert ours.active == theirs.active == (epoch >= 1)
    assert ours.n_averaged == theirs.n_averaged == 2
    for a, key in zip(ours.avg_params, ("a", "b")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(theirs.avg_params[key]))
    np.testing.assert_allclose(ours.avg_params[0].numpy(), (snaps[1][0] + snaps[2][0]) / 2,
                               rtol=1e-6)


def test_fit_runs_the_sanity_pass_and_a_callback_stops_it(data_root, tmp_path,
                                                          monkeypatch):
    """``num_sanity_val_steps`` validation batches before epoch 0, without
    metrics (``compute_metrics=False``, as the JAX ``fit`` calls it), logged
    as ``sanity_*``; the epoch's validation with metrics yields the keys
    the JAX trainer yields with PESQ on (the losses, ``val_stoi``,
    ``val_pesq_est``); ``on_validation_end`` returning True after epoch 0
    ends the fit there (of 3 epochs), and the SWA finalisation still runs."""
    cfg = _cfg(config_for_variant, "drs", data_root, str(tmp_path / "logs"),
               epochs=3, swa_from=0)
    trainer = tloop.Trainer(cfg, device="cpu")
    calls = []
    real_eval = trainer.eval_epoch

    def eval_epoch(batches, epoch, phase="val", compute_metrics=True, max_batches=None,
                   **kwargs):
        calls.append((epoch, phase, compute_metrics, max_batches))
        return real_eval(batches, epoch, phase, compute_metrics, max_batches, **kwargs)

    monkeypatch.setattr(trainer, "eval_epoch", eval_epoch)
    seen = []

    def stop(epoch, val_metrics):
        seen.append((epoch, sorted(val_metrics)))
        return True

    loaders = make_loaders(cfg)
    try:
        trainer.fit(*loaders, callbacks=tloop.TrainerCallbacks(on_validation_end=stop))
    finally:
        for loader in loaders:
            loader.close()
        trainer.writer.close()
    assert calls == [(-1, "sanity", False, 1), (0, "val", True, None)]
    assert seen == [(0, ["val_loss", "val_noise_loss", "val_pesq_est", "val_speech_loss",
                         "val_stoi"])]
    assert trainer.epoch == 1 and trainer.step == 2 and trainer.swa.n_averaged == 1
    with open(os.path.join(cfg.run.log_dir, "events.jsonl")) as f:
        tags = {json.loads(line).get("tag") for line in f}
    assert "sanity_loss" in tags
    assert "sanity_stoi" not in tags and "sanity_pesq_est" not in tags
    assert {"val_stoi", "val_pesq_est"} <= tags


def test_fit_max_epochs_overrides_the_config(data_root, tmp_path):
    cfg = _cfg(config_for_variant, "drs", data_root, str(tmp_path / "logs"),
               epochs=5, sanity=0)
    trainer = tloop.Trainer(cfg, device="cpu")
    loaders = make_loaders(cfg)
    try:
        metrics = trainer.fit(*loaders, max_epochs=1)
    finally:
        for loader in loaders:
            loader.close()
        trainer.writer.close()
    assert metrics["epoch"] == 0 and trainer.epoch == 1 and not trainer.swa.active


def _cli_run(tmp_path, name, cfg, epochs, *flags):
    cfg = cfg.replace(run=dataclasses.replace(
        cfg.run, max_epochs=epochs, ckpt_dir=str(tmp_path / name / "ckpt"),
        log_dir=str(tmp_path / name / "logs")))
    path = tmp_path / f"{name}_{epochs}.json"
    path.write_text(cfg.to_json())
    cli_train.main([cfg.variant, "--config-json", str(path), "--device", "cpu", *flags])
    return CheckpointManager(cfg.run.ckpt_dir)


@pytest.fixture(scope="module")
def resumed(data_root, tmp_path_factory):
    """``cli.train drs`` with dropout on: 2 epochs straight, and 1 epoch then
    ``--resume`` for the second."""
    tmp = tmp_path_factory.mktemp("resume")
    cfg = _cfg(config_for_variant, "drs", data_root, "", dropout=True)
    straight = _cli_run(tmp, "straight", cfg, 2)
    _cli_run(tmp, "split", cfg, 1)
    split = _cli_run(tmp, "split", cfg, 2, "--resume")
    return straight, split


def test_resumed_run_equals_the_uninterrupted_one_bit_for_bit(resumed):
    """Parameters, BN statistics and Adam state of the last checkpoint are
    equal bit for bit: each epoch's dropout masks are keyed by (seed, epoch),
    not drawn from where the process's generator stands. (The plateau's
    state differs: a 1-epoch run starts SWA at epoch 0 and never steps it,
    as in the JAX package.)"""
    straight, split = resumed
    assert straight.latest_step() == split.latest_step() == 4
    a = torch.load(os.path.join(straight.directory, "step_4.pt"), weights_only=True)
    b = torch.load(os.path.join(split.directory, "step_4.pt"), weights_only=True)
    assert a["model"].keys() == b["model"].keys()
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for pa, pb in zip(a["optim"]["state"].values(), b["optim"]["state"].values()):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert a["extra"]["epoch"] == b["extra"]["epoch"] == 1


def test_dropout_is_on_in_the_resumed_runs(resumed, data_root):
    """The runs above train with dropout: a model in train mode gives
    different outputs under two epochs' generators."""
    straight, _ = resumed
    with open(os.path.join(straight.directory, "config.json")) as f:
        cfg = Config.from_json(f.read())
    assert cfg.model.dropout_conv > 0 and cfg.model.dropout_fc > 0
    model = DCSNet(cfg.model, cfg.quirks, device="cpu").train()
    x = torch.rand(1, 256, 64)
    outs = []
    for epoch in (0, 1):
        model.set_dropout_generator(torch.Generator().manual_seed(tloop.epoch_seed(0, epoch)))
        with torch.no_grad():
            outs.append(model(x))
    assert not torch.equal(*outs)


def test_enhance_cli_serves_the_trainers_checkpoint(resumed, tmp_path, capsys):
    """``cli.enhance --ckpt-dir`` on what ``cli.train`` wrote: the config
    saved beside the checkpoint, its weights and BN statistics; the wav it
    writes equals ``enhance_full`` of the restored model, written the same
    way."""
    straight, _ = resumed
    rng = np.random.default_rng(13)
    wav, out, ref = tmp_path / "noisy.wav", tmp_path / "clean.wav", tmp_path / "ref.wav"
    write_wav(str(wav), (0.3 * rng.standard_normal(4000)).astype(np.float32), 16000)
    cli_enhance.main(["dcs", "--in", str(wav), "--out", str(out), "--ckpt-dir",
                      straight.directory, "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "using config saved with checkpoint (drs)" in printed
    assert "restored checkpoint step 4" in printed and "WARNING" not in printed
    with open(os.path.join(straight.directory, "config.json")) as f:
        cfg = Config.from_json(f.read())
    model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    assert load_model(straight.directory, model) == 4
    x, _ = read_wav(str(wav))
    write_wav(str(ref), enhance_full(model, torch.from_numpy(x)[None], cfg)[0].numpy(), 16000)
    got, want = read_wav(str(out))[0], read_wav(str(ref))[0]
    assert got.shape == (4000,) and np.abs(got).max() > 0
    np.testing.assert_array_equal(got, want)


def test_enhance_cli_keeps_the_carry_check_against_the_checkpoints_config(
        resumed, tmp_path, capsys):
    """A checkpoint of the bidirectional config cannot stream with the LSTM
    carry; without ``--ckpt-dir`` the CLI warns that the weights are
    untrained."""
    straight, _ = resumed
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros(4000, np.float32), 16000)
    with pytest.raises(SystemExit):
        cli_enhance.main(["drs", "--in", str(wav), "--out", str(tmp_path / "o.wav"),
                          "--carry", "--ckpt-dir", straight.directory, "--device", "cpu"])
    assert "bidirectional" in capsys.readouterr().err
    cfg_path = tmp_path / "narrow.json"
    with open(os.path.join(straight.directory, "config.json")) as f:
        cfg_path.write_text(f.read())
    cli_enhance.main(["drs", "--in", str(wav), "--out", str(tmp_path / "o.wav"),
                      "--config-json", str(cfg_path), "--device", "cpu"])
    assert "WARNING: no --ckpt-dir" in capsys.readouterr().out
