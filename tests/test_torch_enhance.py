"""The port's whole slice against the JAX package: ``enhance_full`` on a narrow
DCS config with the same weights (moved by ``convert.py``) and the same noisy
wave, the weight round trip, the import boundary, the device rule of the
entry points and the CLI end to end on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.dsp import stft as jdsp
from dcs_net_tpu.models.enhance import enhance_full as jax_enhance_full
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.utils.carray import CArray as JaxCArray

from dcs_net_tpu_torch.cli import enhance as cli_enhance
from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import Config, config_for_variant
from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
from dcs_net_tpu_torch.models.enhance import enhance_full
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_train import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# narrow DCS: channels[5] == channels[n_layers] for the latent reshape
NARROW = (1, 4, 8, 8, 8, 16, 8, 16)


def _narrow(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, channels=NARROW,
                                                 ca_reduction=4))


def _perturb(variables, seed):
    """Move BN gammas, betas and running stats off their init values (so BN
    is not the identity), keeping the covariances positive definite."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            a = np.asarray(v, np.float32)
            if k in ("gamma_rr", "gamma_ii", "gamma_ri", "beta_r", "beta_i",
                     "mean_r", "mean_i", "vri"):
                a = a + rng.uniform(-0.1, 0.1, a.shape).astype(np.float32)
            elif k in ("vrr", "vii"):
                a = a * rng.uniform(0.8, 1.6, a.shape).astype(np.float32)
            out[k] = a
        return out

    return walk(jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def slice_pair():
    jcfg = _narrow(jax_config_for_variant("dcs"))
    tcfg = _narrow(config_for_variant("dcs"))
    model = JaxDCSNet(jcfg.model, jcfg.quirks)
    dummy = jax.jit(lambda w: jdsp.stft(w, jcfg.stft))(jnp.zeros((1, 2016)))
    variables = jax.jit(lambda k, s: model.init(k, s, train=False))(
        jax.random.PRNGKey(0), dummy)
    variables = _perturb(variables, 1)
    port = DCSNet(tcfg.model, tcfg.quirks, device="cpu")
    port.load_state_dict(params_from_jax(variables), strict=True)
    return jcfg, tcfg, model, variables, port


def test_enhance_full_matches_jax(slice_pair):
    jcfg, tcfg, model, variables, port = slice_pair
    rng = np.random.default_rng(2)
    t = np.arange(2016) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220.0 * t)[None]
            + 0.05 * rng.standard_normal((2, 2016))).astype(np.float32)
    want = jax.jit(lambda v, w: jax_enhance_full(model, v, w, jcfg))(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(wave))
    got = enhance_full(port, torch.from_numpy(wave), tcfg)
    assert got.shape == (2, 2016)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=3e-4)


def test_streaming_preset_forward_and_lstm_state_match_jax():
    """The streaming preset (unidirectional LSTM, time-major latent) with a
    carried LSTM state: mask and returned state against the JAX model."""
    jcfg = _narrow(jax_config_for_variant("dcs", streaming=True))
    tcfg = _narrow(config_for_variant("dcs", streaming=True))
    rng = np.random.default_rng(5)
    re, im = (rng.standard_normal((1, 256, 16)).astype(np.float32) for _ in range(2))
    H, D = jcfg.model.lstm_hidden, 1
    state = tuple(tuple(0.1 * rng.standard_normal((2 * D, 2, H)).astype(np.float32)
                        for _ in range(2)) for _ in range(2))
    model = JaxDCSNet(jcfg.model, jcfg.quirks)
    x = JaxCArray(jnp.asarray(re), jnp.asarray(im))
    jstate = jax.tree.map(jnp.asarray, state)
    variables = jax.jit(lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(1))
    want, want_state = jax.jit(lambda v: model.apply(
        v, x, train=False, lstm_state=jstate, return_lstm_state=True))(variables)
    port = DCSNet(tcfg.model, tcfg.quirks, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables), strict=True)
    tstate = tuple(tuple(torch.from_numpy(a) for a in s) for s in state)
    with torch.no_grad():
        got, got_state = port(CArray(torch.from_numpy(re), torch.from_numpy(im)),
                              lstm_state=tstate, return_lstm_state=True)
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), rtol=1e-3, atol=3e-4)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), rtol=1e-3, atol=3e-4)
    for g, w in zip([t for s in got_state for t in s], jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_params_round_trip(slice_pair):
    _, _, _, variables, port = slice_pair
    back = jax_from_params(port.state_dict())
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]), np.asarray(a),
                                      err_msg=jax.tree_util.keystr(path))


def test_config_json_round_trip():
    cfg = _narrow(config_for_variant("dcs", faithful=False))
    assert Config.from_json(cfg.to_json()) == cfg
    # the two packages read each other's config.json
    jcfg = _narrow(jax_config_for_variant("dcs", faithful=False))
    assert json.loads(cfg.to_json()) == json.loads(jcfg.to_json())


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, imports without pulling
    in jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import dcs_net_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'dcs_net_tpu' or k.startswith('dcs_net_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('dcs_net_tpu_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _narrow(config_for_variant("dcs"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DCSNet(cfg.model, cfg.quirks)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DCSNet(cfg.model, cfg.quirks, device="cuda")
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros(4000, np.float32), 16000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_enhance.main(["dcs", "--in", str(wav), "--out", str(tmp_path / "o.wav")])
    DCSNet(cfg.model, cfg.quirks, device="cpu")  # explicit CPU is fine


def test_real_variant_builds_and_gives_a_sigmoid_mask():
    """The real family is built like the complex one: a DRS net at full
    width on the CPU takes a magnitude and gives a sigmoid mask of its
    shape."""
    cfg = config_for_variant("drs")
    model = DCSNet(cfg.model, cfg.quirks, device="cpu").eval()
    with torch.no_grad():
        mask = model(torch.rand(1, 256, 16))
    assert mask.shape == (1, 256, 16)
    assert float(mask.min()) > 0.0 and float(mask.max()) < 1.0


def test_cli_end_to_end_cpu(tmp_path):
    """A 48 kHz wav is resampled to 16 kHz, enhanced and written back."""
    rng = np.random.default_rng(3)
    t = np.arange(12000) / 48000.0
    x = 0.3 * np.sin(2 * np.pi * 440.0 * t) + 0.05 * rng.standard_normal(12000)
    wav, out = tmp_path / "noisy.wav", tmp_path / "clean.wav"
    write_wav(str(wav), x.astype(np.float32), 48000)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(_narrow(config_for_variant("dcs")).to_json())
    cli_enhance.main(["dcs", "--in", str(wav), "--out", str(out),
                      "--config-json", str(cfg_path), "--device", "cpu"])
    audio, sr = read_wav(str(out))
    assert sr == 16000 and audio.shape == (4000,)
    assert np.all(np.isfinite(audio)) and np.abs(audio).max() > 0


@pytest.mark.parametrize("flag,message", [
    (["--stream", "--overlap", "256"], "--overlap must be in"),
    (["--carry", "--overlap", "8"], "--carry requires --overlap 0"),
    (["--ckpt-dir", "x"], "no checkpoint"),
], ids=["flag0", "flag1", "flag2"])
def test_cli_rejects_unported_flags(tmp_path, flag, message, capsys):
    """Streaming's argument rules, as the JAX CLI's; a checkpoint directory
    that holds no checkpoint is an error."""
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros(4000, np.float32), 16000)
    with pytest.raises(SystemExit):
        cli_enhance.main(["dcs", "--in", str(wav), "--out",
                          str(tmp_path / "o.wav"), "--device", "cpu", *flag])
    assert message in capsys.readouterr().err
