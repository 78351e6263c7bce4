"""The port's evaluation path against the JAX package's on a narrow DCS net
over synthetic data, from the same weights: ``Trainer.eval_epoch`` in
validation (the losses, the batch means of STOI and PESQ) and as a test pass
with a per-utterance CSV and the composite measures, and the audio samples it
writes; then the port on its own: ``cli.test`` on a ``cli.train``
checkpoint, ``cli.tune``'s median pruning against the JAX CLI's on a fixed
history of trial values, two trials of one epoch, and both CLIs refusing to
run on the CPU unasked. The port runs on the CPU here: its kernels' plain
versions. The JAX trainer's PESQ loads the library that
``test_torch_metrics.py``'s fixture builds under a temporary directory.

Tolerances: the losses within rtol 1e-3, as the train-step tests hold
them. The two packages' audio agrees to about 1e-4 of its peak (the
sampled WAVs differ by at most one PCM16 step), and the metrics follow it:
STOI, a mean of envelope correlations, within 1e-4; SI-SDR within 1e-3 dB;
the composite means within 1e-3 of their value; PESQ within 2e-3 MOS (its
time alignment and frame-activity choices are discrete, so it is held with
a margin, not by the audio's band). CSV cells, printed to 4 decimals, get
one unit of the last place more.
"""

import csv
import dataclasses
import json
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.cli import tune as jtune
from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.data import dataset as jdataset
from dcs_net_tpu.data import partition as jpartition
from dcs_net_tpu.metrics import harness as jharness
from dcs_net_tpu.parallel import mesh as jmesh
from dcs_net_tpu.train import loop as jloop
from dcs_net_tpu.train import steps as JS

from dcs_net_tpu_torch.cli import test as cli_test
from dcs_net_tpu_torch.cli import train as cli_train
from dcs_net_tpu_torch.cli import tune as cli_tune
from dcs_net_tpu_torch.cli.common import make_loaders, make_test_loader
from dcs_net_tpu_torch.convert import jax_from_params
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.data import synthetic
from dcs_net_tpu_torch.data.audio_io import read_wav
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.train import loop as tloop

from test_torch_metrics import jax_pesq_library  # noqa: F401
from test_torch_real import NARROW, _perturb
from test_torch_train import _one_torch_thread  # noqa: F401

BATCH = 2
LOSS_RTOL, STOI_TOL, SI_SDR_TOL, PESQ_TOL, COMPOSITE_RTOL = 1e-3, 1e-4, 1e-3, 2e-3, 1e-3
COMPOSITE = ("segsnr", "llr", "wss", "csig", "cbak", "covl")


def _cfg(make, root, log_dir, **run):
    """Narrow DCS on the synthetic tree at ``root``, dropout off, the
    dataset's own crop (8160 samples: long enough for STOI's 30 frames and
    PESQ's quarter second)."""
    cfg = make("dcs")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, **NARROW, dropout_conv=0.0, dropout_fc=0.0),
        data=dataclasses.replace(cfg.data, root=root, batch_size=BATCH, num_workers=1),
        run=dataclasses.replace(cfg.run, log_dir=log_dir, **run))


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """10 training pairs (8 train, 2 val: one batch) and 4 test pairs (two
    batches), 0.6 s each."""
    root = str(tmp_path_factory.mktemp("vb"))
    synthetic.generate(root, n_train=10, n_test=4, seconds=0.6)
    return root


def _jax_trainer(cfg, weights):
    """The JAX trainer on one device with the JAX PESQ, its state the port's
    ``weights`` (no JAX init)."""
    with mock.patch.object(jmesh, "dp_devices", lambda *a, **k: jax.devices()[:1]):
        trainer = jloop.Trainer(cfg, use_tensorboard=False, pesq_fn=jharness.pesq_metric)
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    trainer.state = jax.device_put(JS.TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=trainer.tx.init(variables["params"])), jmesh.replicated(trainer.mesh))
    return trainer


def _jax_loader(cfg, split):
    part = jpartition.make_partition(cfg.data, seed=cfg.run.seed)
    return jdataset.Loader(jdataset.VoiceBankDataset(part[split], cfg.data, split),
                           batch_size=BATCH, drop_last=False, num_workers=1,
                           seed=cfg.run.seed, use_native=False)


@pytest.fixture(scope="module")
def evals(data_root, tmp_path_factory, jax_pesq_library):  # noqa: F811
    """Each package's validation pass and test pass (per-utterance CSV,
    composite) from the same weights on the same batches."""
    logs = tmp_path_factory.mktemp("logs")
    jcfg = _cfg(jax_config_for_variant, data_root, str(logs / "jax"))
    tcfg = _cfg(config_for_variant, data_root, str(logs / "port"))
    weights = _perturb(DCSNet(tcfg.model, tcfg.quirks, device="cpu", seed=21).state_dict(), 22)
    jtrainer = _jax_trainer(jcfg, weights)
    ttrainer = tloop.Trainer(tcfg, device="cpu")
    ttrainer.init_state()
    ttrainer.model.load_state_dict(weights, strict=True)
    out = {"logs": logs}
    jval, jtest = _jax_loader(jcfg, "val"), _jax_loader(jcfg, "test")
    (ttrain, tval), ttest = make_loaders(tcfg), make_test_loader(tcfg, batch_size=BATCH)
    try:
        for name, trainer, val, test in (("jax", jtrainer, jval, jtest),
                                         ("port", ttrainer, tval, ttest)):
            csv_path = str(logs / name / "per_utterance.csv")
            out[name] = {
                "val": trainer.eval_epoch(val.epoch(0), 0),
                "test": trainer.eval_epoch(test.epoch(0), 0, phase="test",
                                           per_utterance_csv=csv_path, composite=True),
                "csv": csv_path, "pesq_key": trainer.pesq_key}
    finally:
        for loader in (jval, jtest, ttrain, tval, ttest):
            loader.close()
        ttrainer.writer.close()
        jtrainer.writer.close()
    return out


def _assert_metrics_match(got, want, phase):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        key = k[len(phase) + 1:]
        if key.endswith("loss"):
            np.testing.assert_allclose(got[k], w, rtol=LOSS_RTOL, err_msg=k)
        elif key == "stoi":
            assert abs(got[k] - w) <= STOI_TOL, (k, got[k], w)
        elif key.startswith("pesq"):
            assert abs(got[k] - w) <= PESQ_TOL, (k, got[k], w)
        else:
            assert abs(got[k] - w) <= COMPOSITE_RTOL * abs(w), (k, got[k], w)


def test_validation_matches_jax(evals):
    """The batch-mean path: the losses, ``val_stoi`` and ``val_pesq_est``
    (real numbers here, not the 0.0 of an all-NaN batch)."""
    want, got = evals["jax"]["val"], evals["port"]["val"]
    assert sorted(want) == ["val_loss", "val_noise_loss", "val_pesq_est",
                            "val_speech_loss", "val_stoi"]
    assert evals["port"]["pesq_key"] == evals["jax"]["pesq_key"] == "pesq_est"
    assert 0.1 < want["val_stoi"] < 1.0 and 0.0 < want["val_pesq_est"] < 4.5
    _assert_metrics_match(got, want, "val")


def test_test_pass_with_composite_matches_jax(evals):
    """The per-utterance path with ``composite=True``: the means of STOI,
    PESQ and the six composite measures, and the losses."""
    want, got = evals["jax"]["test"], evals["port"]["test"]
    assert {f"test_{k}" for k in COMPOSITE + ("stoi", "pesq_est", "loss")} <= set(want)
    _assert_metrics_match(got, want, "test")


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_per_utterance_csv_matches_jax(evals):
    """The same header, ids and crop starts, one row per test utterance, and
    the same values within the tolerances."""
    want, got = _rows(evals["jax"]["csv"]), _rows(evals["port"]["csv"])
    assert got[0] == want[0] == ["id", "start", "stoi", "pesq_est", "si_sdr", *COMPOSITE]
    assert len(got) == len(want) == 5
    assert sorted(r[0] for r in got[1:]) == [f"t{i:03d}_{i:03d}" for i in range(4)]
    tol = {"stoi": STOI_TOL, "si_sdr": SI_SDR_TOL, "pesq_est": PESQ_TOL}
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2]
        for col, a, b in zip(want[0][2:], g[2:], w[2:]):
            limit = tol.get(col, COMPOSITE_RTOL * abs(float(b))) + 1e-4
            assert abs(float(a) - float(b)) <= limit, (col, a, b)


def test_sampled_audio_wavs_match_jax(evals):
    """Each pass writes one utterance's streams as WAVs, the utterance drawn
    by the same reservoir and generator: the same files, the same samples
    up to one PCM16 step."""
    jdir, tdir = evals["logs"] / "jax" / "audio", evals["logs"] / "port" / "audio"
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert len(names) == 10      # 5 streams, val and test
    assert "predict_clean_test__0_step0.wav" in names
    for name in names:
        (a, sr_a), (b, sr_b) = read_wav(str(tdir / name)), read_wav(str(jdir / name))
        assert sr_a == sr_b == 16000 and a.shape == b.shape == (8160,)
        assert np.abs(a - b).max() <= 1.0 / 2 ** 15 + 1e-9, name


def _write_json(tmp_path, cfg, name):
    path = tmp_path / name
    path.write_text(cfg.to_json())
    return str(path)


def test_test_cli_evaluates_a_train_cli_checkpoint(data_root, tmp_path, capsys):
    """``cli.train`` for 1 epoch, then ``cli.test --composite`` on its
    checkpoint on the CPU: one CSV row per test utterance at batch 1, the
    restored step, finite means; ``--limit-batches`` caps the utterances."""
    cfg = _cfg(config_for_variant, data_root, str(tmp_path / "logs"), max_epochs=1,
               ckpt_dir=str(tmp_path / "ckpt"))
    cfg_json = _write_json(tmp_path, cfg, "cfg.json")
    cli_train.main(["dcs", "--config-json", cfg_json, "--device", "cpu",
                    "--limit-train-batches", "2"])
    capsys.readouterr()
    metrics = cli_test.main(["dcs", "--config-json", cfg_json, "--device", "cpu",
                             "--composite", "--no-tensorboard"])
    printed = capsys.readouterr().out
    assert f"restored step 2 from {cfg.run.ckpt_dir}" in printed
    rows = _rows(os.path.join(cfg.run.log_dir + "-test", "per_utterance.csv"))
    assert rows[0] == ["id", "start", "stoi", "pesq_est", "si_sdr", *COMPOSITE]
    assert len(rows) == 5
    keys = {f"test_{k}" for k in COMPOSITE + ("stoi", "pesq_est", "loss")}
    assert keys <= set(metrics) and all(np.isfinite(metrics[k]) for k in keys)
    cli_test.main(["dcs", "--config-json", cfg_json, "--device", "cpu",
                   "--limit-batches", "1"])
    rows = _rows(os.path.join(cfg.run.log_dir + "-test", "per_utterance.csv"))
    assert rows[0] == ["id", "start", "stoi", "pesq_est", "si_sdr"] and len(rows) == 2


def test_test_cli_without_a_checkpoint_exits(data_root, tmp_path):
    cfg = _cfg(config_for_variant, data_root, str(tmp_path / "logs"),
               ckpt_dir=str(tmp_path / "none"))
    with pytest.raises(SystemExit, match="no checkpoint found"):
        cli_test.main(["dcs", "--config-json", _write_json(tmp_path, cfg, "c.json"),
                       "--device", "cpu"])


@pytest.mark.parametrize("cli", [cli_test, cli_tune])
def test_cli_raises_without_cuda_unless_asked_for_the_cpu(cli, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["dcs", "--ckpt-dir", str(tmp_path), "--log-dir", str(tmp_path)])


def _fake_trials(values, decisions):
    """A ``run_trial`` that reports trial t's fixed values epoch by epoch,
    stops where ``report`` prunes, records ``report``'s answers and returns
    the best value reported."""
    def run_trial(cfg, epochs, report=None, *device):
        t = len(decisions)
        answers, best = [], float("-inf")
        for epoch in range(epochs):
            v = float(values[t][epoch])
            best = max(best, v)
            answers.append(report(epoch, v))
            if answers[-1]:
                break
        decisions.append(answers)
        return best
    return run_trial


def test_tune_prunes_as_the_jax_cli(monkeypatch, capsys, tmp_path):
    """Both CLIs' random search over 9 trials of 3 epochs on one fixed table
    of values: the same prune decisions at every report (some trials pruned,
    none before four peers), the same best trial and sampled parameters."""
    values = np.random.default_rng(23).uniform(1.0, 3.0, size=(9, 3))
    runs = {}
    for name, mod, extra in (("jax", jtune, []), ("port", cli_tune, ["--device", "cpu"])):
        decisions = []
        monkeypatch.setattr(mod, "run_trial", _fake_trials(values, decisions))
        capsys.readouterr()
        mod.main(["dcs", "--trials", "9", "--trial-epochs", "3",
                  "--log-dir", str(tmp_path / name), *extra])
        best = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("best:")]
        runs[name] = (decisions, json.loads(best[-1][len("best:"):]))
    assert runs["port"] == runs["jax"]
    decisions = runs["port"][0]
    assert not any(any(d) for d in decisions[:4])
    assert any(d[-1] for d in decisions[4:])
    for t, d in enumerate(decisions):
        for epoch, pruned in enumerate(d):
            history = [values[s][:len(decisions[s])].tolist() for s in range(t)]
            assert pruned == cli_tune.below_median(history, epoch, values[t][epoch])


def test_tune_runs_two_trials_of_one_epoch(data_root, tmp_path, capsys):
    """The built-in search on the CPU: two short trials, each a ``fit`` with
    validation metrics, and a finite best value (the best ``val_pesq_est``)."""
    cfg = _cfg(config_for_variant, data_root, str(tmp_path / "logs"),
               ckpt_dir=str(tmp_path / "ckpt"))
    best = cli_tune.main(["dcs", "--config-json", _write_json(tmp_path, cfg, "c.json"),
                          "--trials", "2", "--trial-epochs", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("trial ") == 2 and "best:" in out
    assert np.isfinite(best["value"]) and best["trial"] in (0, 1)
    with open(os.path.join(cfg.run.log_dir, "tune", "events.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("val_pesq_est") == 2 and tags.count("val_stoi") == 2
