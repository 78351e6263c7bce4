"""Streaming enhancement of the port: the LSTM carry contract (chunked == full
pass), grouped == serial chunks, the wave-level path against the JAX
package's ``enhance_streaming`` on the same weights (moved by ``convert.py``)
and the same wave, and the CLI's argument rules. The port runs on the CPU.

The carry contract, as in ``tests/test_streaming.py``: with a unidirectional
LSTM and a time-major latent, chunks that thread (h, c) equal one continuous
pass when every other op is chunk-local, so the exact test uses 1x1 convs and
no attention (CBAM pools over the whole time axis of what it is given).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.dsp import stft as jdsp
from dcs_net_tpu.models.enhance import enhance_streaming as jax_enhance_streaming
from dcs_net_tpu.models.enhance import zero_lstm_state as jax_zero_lstm_state
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet

from dcs_net_tpu_torch.cli import enhance as cli_enhance
from dcs_net_tpu_torch.convert import params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.data.audio_io import write_wav
from dcs_net_tpu_torch.models import enhance as tenh
from dcs_net_tpu_torch.models.enhance import (enhance_full, enhance_streaming,
                                              zero_lstm_state)
from dcs_net_tpu_torch.models.graphed import GraphCache
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_train import _one_torch_thread  # noqa: F401

TINY = (1, 2, 2, 4, 4, 8, 8, 8)


def _tiny(cfg, streaming, exact=False):
    kw = dict(channels=TINY, ca_reduction=2)
    if streaming:
        kw.update(lstm_bidir=False, lstm_time_major=True)
    if exact:   # chunk-local everything except the LSTM itself
        kw.update(kernel_e=(1,) * 7, kernel_d=(1,) * 7, sa_kernel=1,
                  attention=False)
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def _wave(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("streaming", [False, True])
def test_zero_lstm_state_shapes(streaming):
    cfg = _tiny(config_for_variant("dcs"), streaming)
    jcfg = _tiny(jax_config_for_variant("dcs"), streaming)
    got, want = zero_lstm_state(cfg, 3, "cpu"), jax_zero_lstm_state(jcfg, 3)
    d = 1 if streaming else 2
    assert got[0][0].shape == (cfg.model.lstm_layers * d, 6, cfg.model.lstm_hidden)
    for g, w in zip([t for s in got for t in s], jax.tree.leaves(want)):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.float32
        assert float(g.abs().max()) == 0.0


def test_chunked_with_carry_equals_full_pass():
    cfg = _tiny(config_for_variant("dcs"), streaming=True, exact=True)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).eval()
    B, n_bins, T, chunk = 2, 256, 64, 32
    rng = np.random.default_rng(3)
    spec = CArray(*(torch.from_numpy(rng.standard_normal((B, n_bins, T))
                                     .astype(np.float32)) for _ in range(2)))
    lstm_out = []
    model.lstm.register_forward_hook(
        lambda mod, args, out: lstm_out.append(torch.stack(list(out[0]))))

    def chunks(state):
        outs = []
        for c in range(T // chunk):
            xc = spec[..., c * chunk:(c + 1) * chunk]
            if state is None:
                outs.append(model(xc))
            else:
                mask, state = model(xc, lstm_state=state, return_lstm_state=True)
                outs.append(mask)
        return CArray(torch.cat([o.re for o in outs], -1),
                      torch.cat([o.im for o in outs], -1))

    with torch.no_grad():
        full = model(spec)
        full_lstm = lstm_out.pop()
        carried = chunks(zero_lstm_state(cfg, B, "cpu"))
        carried_lstm = torch.cat(lstm_out, dim=-2)   # sequence axis
        lstm_out.clear()
        chunks(None)
        restarted_lstm = torch.cat(lstm_out, dim=-2)
    # the final mask and the latent LSTM sequence both continue seamlessly
    # across the chunk boundary
    torch.testing.assert_close(carried_lstm, full_lstm, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(carried.re, full.re, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(carried.im, full.im, rtol=1e-5, atol=1e-5)
    # restarting from zeros per chunk must not: asserted at the LSTM output,
    # where the effect is material (the decoder attenuates it)
    assert float((restarted_lstm - full_lstm).abs().max()) > 1e-3


def test_enhance_streaming_carry_is_the_full_pass_when_chunk_local():
    """The wave-level path with the carry, overlap 0 and chunk-local ops
    reproduces ``enhance_full``, ragged last chunk included."""
    cfg = _tiny(config_for_variant("dcs"), streaming=True, exact=True)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=1)
    wave = torch.from_numpy(_wave((2, 5000), 7))      # T = 157: 5 chunks of 32
    full = enhance_full(model, wave, cfg)
    stream = enhance_streaming(model, wave, cfg, chunk_frames=32, overlap=0,
                               carry_lstm_state=True)
    torch.testing.assert_close(stream, full, rtol=1e-4, atol=1e-5)


def test_enhance_streaming_carry_end_to_end():
    """With conv halos and attention the carried stream stays close to the
    full pass (tolerance-based: chunk borders)."""
    cfg = _tiny(config_for_variant("dcs"), streaming=True)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0)
    wave = torch.from_numpy(_wave((1, 4000), 0))
    full = enhance_full(model, wave, cfg)
    stream = enhance_streaming(model, wave, cfg, chunk_frames=64, overlap=16,
                               carry_lstm_state=True)
    assert stream.shape == (1, 4000) and bool(torch.isfinite(stream).all())
    corr = np.corrcoef(full[0].numpy(), stream[0].numpy())[0, 1]
    assert corr > 0.95, f"stream/full correlation {corr}"
    assert model.training       # the caller's mode is restored


def test_carry_requires_unidirectional():
    cfg = _tiny(config_for_variant("dcs"), streaming=False)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    with pytest.raises(ValueError, match="unidirectional"):
        enhance_streaming(model, torch.zeros(1, 2016), cfg, chunk_frames=32,
                          overlap=0, carry_lstm_state=True)


@pytest.mark.parametrize("kw", [dict(chunk_frames=60, overlap=0),
                                dict(chunk_frames=64, overlap=64),
                                dict(chunk_frames=64, overlap=-1)])
def test_enhance_streaming_rejects_bad_chunking(kw):
    cfg = _tiny(config_for_variant("dcs"), streaming=False)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    with pytest.raises(ValueError, match="chunk_frames"):
        enhance_streaming(model, torch.zeros(1, 2016), cfg, **kw)


@pytest.mark.parametrize("group", [3, 8])
def test_streaming_batched_groups_match_serial(group):
    """Chunks are independent in eval mode, so groups of any size, the short
    last group included, give what one chunk at a time gives."""
    cfg = _tiny(config_for_variant("dcs"), streaming=False)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=2)
    wave = torch.from_numpy(_wave((2, 6400), 5))       # 4 chunks of 64 / 16
    serial = enhance_streaming(model, wave, cfg, chunk_frames=64, overlap=16,
                               chunk_batch=1)
    batched = enhance_streaming(model, wave, cfg, chunk_frames=64, overlap=16,
                                chunk_batch=group)
    torch.testing.assert_close(batched, serial, rtol=1e-5, atol=1e-5)


def test_crossfade_weights_normalise_to_one():
    """Constant masks blend to the same constant: the ramps of neighbouring
    chunks and the lone ramp at the start are divided out."""
    w, wacc = tenh._crossfade(4, 64, 16, torch.device("cpu"))
    assert w.shape == (64,) and wacc.shape == (16 + 4 * 48,)
    np.testing.assert_allclose(w[:16].numpy(), (np.arange(16) + 1.0) / 17.0, rtol=1e-6)
    np.testing.assert_allclose(w[-16:].numpy(), w[:16].numpy()[::-1], rtol=1e-6)
    acc = torch.zeros_like(wacc)
    for c in range(4):
        acc[c * 48:c * 48 + 64] += w
    torch.testing.assert_close(acc / wacc, torch.ones_like(acc))


@pytest.mark.parametrize("carry,overlap,chunk_batch,n", [
    (False, 16, 3, 6400), (True, 0, 8, 6400), (False, 16, 2, 8000)])
def test_enhance_streaming_matches_jax(carry, overlap, chunk_batch, n):
    """Same wave and weights through both packages: 4 chunks of 64 frames
    (6400 samples), which groups of 3 do not divide, or 5 (8000) in groups
    of 2: both packages pad the last group. Band of
    ``test_torch_enhance.py``."""
    jcfg = _tiny(jax_config_for_variant("dcs"), streaming=carry)
    tcfg = _tiny(config_for_variant("dcs"), streaming=carry)
    model = JaxDCSNet(jcfg.model, jcfg.quirks)
    dummy = jax.jit(lambda w: jdsp.stft(w, jcfg.stft))(jnp.zeros((1, 2016)))
    variables = jax.jit(lambda k, s: model.init(k, s, train=False))(
        jax.random.PRNGKey(0), dummy)
    wave = _wave((2, n), 11)
    want = jax.jit(lambda v, w: jax_enhance_streaming(
        model, v, w, jcfg, chunk_frames=64, overlap=overlap,
        carry_lstm_state=carry, chunk_batch=chunk_batch))(variables, jnp.asarray(wave))
    port = DCSNet(tcfg.model, tcfg.quirks, device="cpu")
    port.load_state_dict(params_from_jax(jax.tree.map(np.asarray, variables)),
                         strict=True)
    got = enhance_streaming(port, torch.from_numpy(wave), tcfg, chunk_frames=64,
                            overlap=overlap, carry_lstm_state=carry,
                            chunk_batch=chunk_batch)
    assert got.shape == (2, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=3e-4)


def test_padded_last_group_matches_ragged_grouping(monkeypatch):
    """5 chunks in groups of 2: the padded last group (its second chunk's
    windows clip to the last frame, its masks dropped) against the last
    group run ragged, on its one real chunk, as the port grouped before."""
    cfg = _tiny(config_for_variant("dcs"), streaming=False)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=4)
    wave = torch.from_numpy(_wave((2, 8000), 12))     # T = 251: 5 chunks of 64 / 16
    kw = dict(chunk_frames=64, overlap=16, chunk_batch=2)
    padded_groups = []
    group_masks = tenh._group_masks

    def ragged(re, im, model, cfg):
        padded_groups.append(re.shape[0])
        if len(padded_groups) < 3:
            return group_masks(re, im, model=model, cfg=cfg)
        real = group_masks(re[:2], im[:2], model=model, cfg=cfg)   # one chunk of B = 2
        return torch.cat([real, torch.zeros_like(real)], dim=1)

    padded = enhance_streaming(model, wave, cfg, **kw)
    monkeypatch.setattr(tenh, "_group_masks", ragged)
    got = enhance_streaming(model, wave, cfg, **kw)
    assert padded_groups == [4, 4, 4]
    torch.testing.assert_close(padded, got, rtol=0, atol=1e-6)


def _cli(tmp_path, monkeypatch, flags, config=None):
    """Run the CLI on the CPU with ``enhance_streaming`` and ``enhance_full``
    replaced by recorders; return what was called with which arguments."""
    calls = []

    def record(name):
        def fn(model, x, cfg, **kw):
            calls.append((name, cfg, kw))
            return x
        return fn

    monkeypatch.setattr(tenh, "enhance_streaming", record("stream"))
    monkeypatch.setattr(tenh, "enhance_full", record("full"))
    wav = tmp_path / "in.wav"
    write_wav(str(wav), np.zeros(4000, np.float32), 16000)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text((config or _tiny(config_for_variant(
        "dcs", streaming="--carry" in flags), "--carry" in flags)).to_json())
    cli_enhance.main(["dcs", "--in", str(wav), "--out", str(tmp_path / "o.wav"),
                      "--device", "cpu", "--config-json", str(cfg_path), *flags])
    return calls


@pytest.mark.parametrize("flags,want", [
    ([], ("full", {})),
    (["--stream"], ("stream", dict(chunk_frames=256, overlap=64,
                                   carry_lstm_state=False, chunk_batch=8))),
    (["--stream", "--chunk-frames", "64", "--chunk-batch", "3"],
     ("stream", dict(chunk_frames=64, overlap=16, carry_lstm_state=False,
                     chunk_batch=3))),
    (["--stream", "--overlap", "8"],
     ("stream", dict(chunk_frames=256, overlap=8, carry_lstm_state=False,
                     chunk_batch=8))),
    (["--carry"], ("stream", dict(chunk_frames=256, overlap=0,
                                  carry_lstm_state=True, chunk_batch=8))),
    (["--carry", "--overlap", "0"],
     ("stream", dict(chunk_frames=256, overlap=0, carry_lstm_state=True,
                     chunk_batch=8))),
])
def test_cli_streaming_argument_rules(tmp_path, monkeypatch, flags, want):
    (name, cfg, kw), = _cli(tmp_path, monkeypatch, flags)
    assert isinstance(kw.pop("graphs"), GraphCache)
    assert (name, kw) == want
    assert cfg.model.lstm_bidir == ("--carry" not in flags)


@pytest.mark.parametrize("flags,message", [
    (["--carry", "--overlap", "8"], "--carry requires --overlap 0"),
    (["--stream", "--overlap", "256"], "--overlap must be in"),
    (["--stream", "--chunk-frames", "64", "--overlap", "64"], "--overlap must be in"),
])
def test_cli_streaming_argument_errors(tmp_path, monkeypatch, capsys, flags, message):
    with pytest.raises(SystemExit):
        _cli(tmp_path, monkeypatch, flags)
    assert message in capsys.readouterr().err


def test_cli_carry_on_a_bidirectional_config_is_an_error(tmp_path, monkeypatch, capsys):
    bidir = _tiny(config_for_variant("dcs"), streaming=False)
    with pytest.raises(SystemExit):
        _cli(tmp_path, monkeypatch, ["--carry"], config=bidir)
    assert "bidirectional" in capsys.readouterr().err


def test_cli_stream_end_to_end_cpu(tmp_path):
    """``--carry`` on a wav: the streaming preset is built, run and written."""
    wav, out = tmp_path / "noisy.wav", tmp_path / "clean.wav"
    write_wav(str(wav), _wave((9600,), 13), 16000)
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(_tiny(config_for_variant("dcs", streaming=True), True).to_json())
    cli_enhance.main(["dcs", "--in", str(wav), "--out", str(out), "--carry",
                      "--chunk-frames", "64", "--config-json", str(cfg_path),
                      "--device", "cpu"])
    from dcs_net_tpu_torch.data.audio_io import read_wav
    audio, sr = read_wav(str(out))
    assert sr == 16000 and audio.shape == (9600,) and np.all(np.isfinite(audio))
