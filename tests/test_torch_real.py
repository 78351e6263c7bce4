"""The real family (DR, DRS) of the port against the JAX package on a narrow
three-layer config: the U-Net forward in eval and train mode, ``enhance_full``,
``enhance_streaming`` (streaming preset, with and without the LSTM carry),
one DRS train step (loss, every gradient leaf, the post-Adam parameters and
BN statistics), the DRS target mask, the weight round trip, and kernels 2
and 3 at the real family's classes: kernel 2's plain version at (K, Cin,
Cout) = (7, 2, 1) and (7, 1, 2) and kernel 3's at dec6's N = 4 against the
Pallas kernels in interpret mode, and the launches the real modules make on
meta tensors. The port runs on the CPU here: its kernels' plain versions.

Two JAX compiles: one function holding every forward and enhance call, and
the train step.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.models.enhance import enhance_full as jax_enhance_full
from dcs_net_tpu.models.enhance import enhance_streaming as jax_enhance_streaming
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.ops import masks as jmasks
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_pallas
from dcs_net_tpu.ops.pallas_tapconv import tapconv_valid as jax_tapconv
from dcs_net_tpu.train import steps as JS
from dcs_net_tpu.train.optim import make_optimizer as jax_make_optimizer

from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.models.enhance import (enhance_full, enhance_streaming,
                                              zero_lstm_state)
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import attention, cuda_conv, cuda_tapconv, masks
from dcs_net_tpu_torch.ops import real_layers as rl
from dcs_net_tpu_torch.train import steps as TS
from dcs_net_tpu_torch.train.optim import make_optimizer, step_count
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_conv import _Recorder
from test_torch_train import (_band, _jax_grads_from_adam, _one_torch_thread,  # noqa: F401
                              _residue_floor)

# three layers: the encoder strides (2, 2), (2, 1), (2, 1) undone by the
# decoder's upsamples in reverse; channels[5] == channels[n_layers] for the
# latent reshape. dec2 ends at Cout 1 with upsample (2, 2): N = 4 phases.
NARROW = dict(n_layers=3, channels=(1, 4, 8, 16, 8, 16),
              stride_e=((2, 2), (2, 1), (2, 1)),
              upsample=((2, 1), (2, 1), (2, 2)), ca_reduction=4)
CROP, BATCH = 2016, 2
FRAMES = 64           # of a CROP-sample wave at hop 32


def _narrow(cfg, dropout=False, streaming=False):
    model = dataclasses.replace(cfg.model, **NARROW)
    if streaming:
        model = dataclasses.replace(model, lstm_bidir=False, lstm_time_major=True)
    if not dropout:
        model = dataclasses.replace(model, dropout_conv=0.0, dropout_fc=0.0)
    return cfg.replace(model=model, data=dataclasses.replace(
        cfg.data, crop_samples=CROP, batch_size=BATCH))


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220.0 * t)[None]
            + 0.05 * rng.standard_normal((BATCH, n))).astype(np.float32)


def _perturb(state, seed):
    """Move the real BN's scale, bias and running statistics off their init
    values (so BN is not the identity); variances stay positive."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in state.items():
        v = v.clone()
        leaf = k.rsplit(".", 1)[-1]
        if "_bn" in k or k.startswith("initial_bn"):
            if leaf == "var":
                v *= torch.from_numpy(rng.uniform(0.8, 1.6, v.shape).astype(np.float32))
            else:
                v += torch.from_numpy(rng.uniform(-0.1, 0.1, v.shape).astype(np.float32))
        out[k] = v
    return out


def _port(cfg, weights):
    model = DCSNet(cfg.model, cfg.quirks, device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


@pytest.fixture(scope="module")
def pair():
    """The port's seeded DRS weights (BN moved off its init), carried to the
    JAX tree by ``convert.py``, and one JAX compile of every forward and
    enhance call the tests compare: the mask in eval and in train mode
    (with the train-mode BN statistics), ``enhance_full`` of DRS and DR,
    ``enhance_streaming`` of the streaming preset with and without the
    LSTM carry."""
    cfgs = {v: (_narrow(jax_config_for_variant(v)), _narrow(config_for_variant(v)))
            for v in ("dr", "drs")}
    scfgs = (_narrow(jax_config_for_variant("drs", streaming=True), streaming=True),
             _narrow(config_for_variant("drs", streaming=True), streaming=True))
    weights = _perturb(DCSNet(cfgs["drs"][1].model, cfgs["drs"][1].quirks,
                              device="cpu", seed=0).state_dict(), 1)
    sweights = _perturb(DCSNet(scfgs[1].model, scfgs[1].quirks, device="cpu",
                               seed=2).state_dict(), 3)
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    svariables = jax.tree.map(jnp.asarray, jax_from_params(sweights))
    models = {v: JaxDCSNet(c[0].model, c[0].quirks) for v, c in cfgs.items()}
    smodel = JaxDCSNet(scfgs[0].model, scfgs[0].quirks)
    mag = np.abs(_np((BATCH, 256, FRAMES), 4)) + 0.01
    wave, long_wave = _wave(3008, 5), _wave(6400, 6)

    def run(v, sv, mag, wave, long_wave):
        m = models["drs"]
        out = {"eval": m.apply(v, mag, train=False)}
        out["train"], mut = m.apply(v, mag, train=True, mutable=["batch_stats"])
        out["train_stats"] = mut["batch_stats"]
        for name in ("dr", "drs"):
            out[f"full_{name}"] = jax_enhance_full(models[name], v, wave, cfgs[name][0])
        for carry in (False, True):
            out[f"stream_{carry}"] = jax_enhance_streaming(
                smodel, sv, long_wave, scfgs[0], chunk_frames=64,
                overlap=0 if carry else 16, carry_lstm_state=carry, chunk_batch=3)
        return out

    want = jax.jit(run)(variables, svariables, jnp.asarray(mag), jnp.asarray(wave),
                        jnp.asarray(long_wave))
    want = jax.tree.map(np.asarray, want)
    return dict(cfgs=cfgs, scfgs=scfgs, weights=weights, sweights=sweights,
                variables=jax.tree.map(np.asarray, variables), mag=mag, wave=wave,
                long_wave=long_wave, want=want)


@pytest.mark.parametrize("variant", ["dr", "drs"])
def test_forward_eval_mode_matches_jax(pair, variant):
    """DR and DRS share the module (``subtractive`` only changes how the
    mask is used): the sigmoid mask in eval mode."""
    port = _port(pair["cfgs"][variant][1], pair["weights"]).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(pair["mag"]))
    assert got.shape == (BATCH, 256, FRAMES)
    np.testing.assert_allclose(got.numpy(), pair["want"]["eval"], rtol=1e-4, atol=1e-5)


def test_forward_train_mode_and_bn_statistics_match_jax(pair):
    """Train mode, dropout off: the mask from batch statistics, and the
    running statistics after one momentum update (the unbiased variance)."""
    port = _port(pair["cfgs"]["drs"][1], pair["weights"]).train()
    with torch.no_grad():
        got = port(torch.from_numpy(pair["mag"]))
    np.testing.assert_allclose(got.numpy(), pair["want"]["train"], rtol=1e-4, atol=1e-5)
    stats = params_from_jax({"batch_stats": pair["want"]["train_stats"]})
    state = port.state_dict()
    assert set(stats) == {k for k, _ in port.named_buffers()}
    for name, want in stats.items():
        np.testing.assert_allclose(state[name].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_the_real_model_takes_a_magnitude_and_no_carray(pair):
    port = _port(pair["cfgs"]["drs"][1], pair["weights"])
    x = torch.from_numpy(pair["mag"])
    with pytest.raises(TypeError, match="magnitude"):
        port(CArray(x, x))


@pytest.mark.parametrize("variant", ["dr", "drs"])
def test_enhance_full_matches_jax(pair, variant):
    """A 3008-sample wave (T = 95 frames, padded to 96 inside): the
    magnitude in, the mask on the magnitude under the noisy phase. Band of
    ``test_torch_enhance.py``."""
    port = _port(pair["cfgs"][variant][1], pair["weights"])
    got = enhance_full(port, torch.from_numpy(pair["wave"]), pair["cfgs"][variant][1])
    assert got.shape == (BATCH, 3008)
    np.testing.assert_allclose(got.numpy(), pair["want"][f"full_{variant}"],
                               rtol=1e-3, atol=3e-4)


@pytest.mark.parametrize("carry", [False, True], ids=["crossfade", "carry"])
def test_enhance_streaming_matches_jax(pair, carry):
    """The streaming preset (unidirectional LSTM, time-major latent): 4
    chunks of 64 frames, crossfaded over 16 frames in groups of 3, or
    threading the LSTM state without overlap."""
    port = _port(pair["scfgs"][1], pair["sweights"])
    got = enhance_streaming(port, torch.from_numpy(pair["long_wave"]), pair["scfgs"][1],
                            chunk_frames=64, overlap=0 if carry else 16,
                            carry_lstm_state=carry, chunk_batch=3)
    assert got.shape == (BATCH, 6400)
    np.testing.assert_allclose(got.numpy(), pair["want"][f"stream_{carry}"],
                               rtol=1e-3, atol=3e-4)


def test_zero_lstm_state_of_the_real_family_is_one_h_c_pair(pair):
    cfg = pair["scfgs"][1]
    h, c = zero_lstm_state(cfg, 3, "cpu")
    assert h.shape == c.shape == (cfg.model.lstm_layers, 3, cfg.model.lstm_hidden)
    assert float(h.abs().max()) == float(c.abs().max()) == 0.0


def test_convert_round_trips_the_real_tree(pair):
    """Port -> JAX -> port is the identity; the JAX tree has the JAX model's
    own structure and shapes (real ``kernel`` leaves, BN ``scale``/``bias``
    and ``mean``/``var``, the LSTM's ``w_ih``/``w_hh``/``b_*`` with
    ``_reverse``)."""
    cfg = pair["cfgs"]["drs"][0]
    shapes = jax.eval_shape(
        lambda: JaxDCSNet(cfg.model, cfg.quirks).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 256, FRAMES)), train=False))
    tree = pair["variables"]
    assert jax.tree.structure(tree) == jax.tree.structure(
        {k: shapes[k] for k in ("params", "batch_stats")})
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == b.shape
    assert "w_ih_l0_reverse" in tree["params"]["lstm"]
    assert set(tree["batch_stats"]["enc0_bn"]) == {"mean", "var"}
    assert set(tree["params"]["enc0_bn"]) == {"scale", "bias"}
    back = params_from_jax(tree)
    assert set(back) == set(pair["weights"])
    for k, v in pair["weights"].items():
        assert torch.equal(back[k], v), k


def test_real_subtractive_target_matches_jax():
    noise, noisy = np.abs(_np((2, 8, 5), 7)), np.abs(_np((2, 8, 5), 8)) + 1e-3
    got = masks.real_subtractive_target(torch.from_numpy(noise), torch.from_numpy(noisy))
    want = jmasks.real_subtractive_target(jnp.asarray(noise), jnp.asarray(noisy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    # unguarded, as in the JAX package: |Y| = 0 saturates (or is NaN at 0 / 0)
    edge = masks.real_subtractive_target(torch.tensor([1.0, 0.0]), torch.zeros(2))
    assert float(edge[0]) == 1.0 and bool(torch.isnan(edge[1]))


@pytest.fixture(scope="module")
def step_pair(pair):
    """One DRS train step of each package from the same weights (BN at its
    init, dropout off) and waves; each package's raw gradients (the port's
    from ``loss_and_grads``, the JAX step's from its Adam state)."""
    jcfg, tcfg = pair["cfgs"]["drs"]
    weights = DCSNet(tcfg.model, tcfg.quirks, device="cpu", seed=4).state_dict()
    rng = np.random.default_rng(9)
    clean = (0.1 * rng.standard_normal((BATCH, CROP))).astype(np.float32)
    noisy = clean + (0.05 * rng.standard_normal((BATCH, CROP))).astype(np.float32)
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    tx = jax_make_optimizer(jcfg.optim)
    state = JS.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    step_fn = JS.make_train_step(JaxDCSNet(jcfg.model, jcfg.quirks), jcfg, tx)
    jstate, jmetrics = jax.jit(lambda s, n, c, r: step_fn(
        s, JS.batch_from_waves(n, c, jcfg), r))(state, jnp.asarray(noisy),
                                                jnp.asarray(clean), jax.random.PRNGKey(0))
    jgrads = _jax_grads_from_adam(state, jstate, jmetrics, jcfg)
    tbatch = TS.batch_from_waves(torch.from_numpy(noisy), torch.from_numpy(clean), tcfg)
    graded = _port(tcfg, weights)
    tloss, tgrads = TS.loss_and_grads(graded, tbatch, tcfg)
    names = [n for n, p in graded.named_parameters() if p.requires_grad]
    stepped = _port(tcfg, weights)
    opt = make_optimizer(stepped.parameters(), tcfg.optim)
    tmetrics = TS.train_step(stepped, opt, tbatch, tcfg)
    return dict(
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        jgrads=params_from_jax({"params": jgrads}),
        jstate=params_from_jax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats}),
        tloss=float(tloss), tmetrics={k: float(v) for k, v in tmetrics.items()},
        tgrads=dict(zip(names, tgrads)), stepped=stepped, opt=opt)


def test_drs_train_step_loss_matches_jax(step_pair):
    s = step_pair
    np.testing.assert_allclose(s["tloss"], s["jmetrics"]["loss"], rtol=1e-3)
    for k in ("loss", "noise_loss", "speech_loss", "grad_norm"):
        np.testing.assert_allclose(s["tmetrics"][k], s["jmetrics"][k], rtol=1e-3,
                                   err_msg=k)
    assert s["tmetrics"]["skipped"] == s["jmetrics"]["skipped"] == 0.0
    assert step_count(s["opt"]) == 1


def test_drs_train_step_every_gradient_leaf_matches_jax(step_pair):
    """In the band of ``test_torch_train.py``: rtol 5e-3 / atol 2.5e-3 of
    the leaf max, mean drift under 3e-4; rounding residue of an exact zero
    (a conv bias before a train-mode BN) under 1e-5 of the largest
    gradient on both sides."""
    s = step_pair
    assert set(s["tgrads"]) == set(s["jgrads"])
    floor = _residue_floor(s["jgrads"])
    for name, g in s["tgrads"].items():
        _band(g.numpy(), s["jgrads"][name].numpy(), name, floor)


def test_drs_train_step_post_step_params_and_batch_stats_match_jax(step_pair):
    """Parameters after Adam within the sensitivity bound of
    ``test_torch_train.py``; the BN running statistics within the band."""
    s = step_pair
    state = s["stepped"].state_dict()
    assert set(state) == set(s["jstate"])
    lr, eps = 1e-4, 1e-6
    floor = _residue_floor(s["jgrads"])
    for name, want in s["jstate"].items():
        got, want = state[name].numpy(), want.numpy()
        if name in s["jgrads"]:
            g = np.abs(s["jgrads"][name].numpy())
            if float(g.max()) < floor:
                allowed = 3e-5 + 2 * lr
            else:
                delta = 5e-3 * g + 2.5e-3 * float(g.max())
                allowed = 3e-5 + lr * np.minimum(2.0, delta / (g + eps))
            worst = float((np.abs(got - want) - allowed).max())
            assert worst <= 0.0, f"{name}: exceeds the sensitivity bound by {worst}"
        else:
            _band(got, want, name)


@pytest.mark.parametrize("cin,cout", [(2, 1), (1, 2)], ids=["forward", "input-gradient"])
@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 8, 16)])
def test_conv_same_plain_at_the_real_classes_matches_pallas(shape, cin, cout):
    """Kernel 2's plain version at the real spatial attention's class (7, 2,
    1) and at its input gradient's (7, 1, 2), against the Pallas kernel in
    interpret mode."""
    x = _np(shape + (cin,), 11)
    w, b = _np((7, 7, cin, cout), 12, 0.1), _np((cout,), 13)
    got = cuda_conv.conv2d_same_small_cout(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    want = _conv_fwd_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", [(4, 6), (3, 9)])
def test_tapconv_plain_at_dec6_n4_matches_pallas(hw):
    """Kernel 3's plain version at the real decoder's last stage: the
    skip-concat of 2 x 16 channels, 3 x 3 window, N = 4 phase outputs."""
    x = _np((2, hw[0] + 2, hw[1] + 2, 32), 14)
    w = _np((9, 32, 4), 15, 0.1)
    got = cuda_tapconv.tapconv_valid(torch.from_numpy(x), torch.from_numpy(w), 3, 3)
    want = jax_tapconv(jnp.asarray(x), jnp.asarray(w), 3, 3, interpret=True)
    assert got.shape == (2,) + hw + (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_real_spatial_attention_off_the_cpu_runs_the_tiled_body(monkeypatch):
    """Meta tensors stand in for the card's: the real spatial attention's
    conv is kernel 2's conv entry at (7, 2, 1) on the register-tiled body,
    and its input gradient the conv entry at (7, 1, 2), tiled too, counted
    as DGRAD; nothing takes the plain version."""
    fwd, dgrad = _Recorder(), _Recorder()
    monkeypatch.setattr(cuda_conv, "KERNEL", fwd)
    monkeypatch.setattr(cuda_conv, "DGRAD", dgrad)
    sa = attention.RealSpatialAttention(7).to("meta")
    x = torch.empty((4, 64, 34, 16), device="meta", requires_grad=True)
    a = sa(x)
    assert a.shape == (4, 64, 34, 1)
    (args,) = fwd.calls
    assert args[4:] == (4, 64, 34, 2, 7, 1) + cuda_conv.choose_tile(4, 64, 34, 2, 1)
    a.backward(torch.empty_like(a))
    (args,) = dgrad.calls
    assert args[4:] == (4, 64, 34, 1, 7, 2) + cuda_conv.choose_tile(4, 64, 34, 1, 2)
    assert sa.conv.weight.grad.shape == (1, 2, 7, 7)


def test_real_decoder_last_stage_off_the_cpu_runs_kernel_3_at_n4(monkeypatch):
    """dec6 of DR/DRS: the convT from 2 x 16 channels to 1 with upsample
    (2, 2) is kernel 3 at N = 4, packed into an 8-wide N tile, reading the
    concatenation unpadded; its input gradient reduces over those 4 channels
    in the 8-channel-chunk class."""
    recs = {name: _Recorder() for name in ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK")}
    for name, rec in recs.items():
        monkeypatch.setattr(cuda_tapconv, name, rec)
    convt = rl.ConvTranspose2d(32, 1, 3, padding=1, upsample=(2, 2)).to("meta")
    d = torch.empty((2, 64, 64, 16), device="meta", requires_grad=True)
    skip = torch.empty((2, 64, 64, 16), device="meta", requires_grad=True)
    y = convt((d, skip))
    assert y.shape == (2, 128, 128, 1)
    assert recs["PACK"].calls[0][2:] == (9, 32, 4, 8)
    bn, flat, wgs, split = cuda_tapconv.forward_plan(2, 64, 64, 32, 4, 3, 3, (1, 1, 1, 1))
    assert recs["KERNEL"].calls[0][3:] == (2, 64, 64, 32, 64, 64, 4, 3, 3, 1, 1,
                                           flat, wgs, bn, split)
    assert bn == cuda_tapconv.tile_n(4) == 8
    y.backward(torch.empty_like(y))
    kb, bn, flat, wgs = cuda_tapconv.dgrad_plan(2, 64, 64, 4, 32, 3, 3)
    assert (kb, bn, flat) == (8, 32, 1)
    assert recs["DGRAD_PACK"].calls[0][2:] == (9, 32, 4, kb, bn)
    assert recs["DGRAD"].calls[0][3:] == (2, 64, 64, 4, 64, 64, 32, 3, 3, 1, 1,
                                          flat, wgs, kb, bn)
    assert d.grad.shape == d.shape and skip.grad.shape == skip.shape


def test_real_dropout_draws_from_the_models_generator():
    """The real net's dropout (and the complex one's) draw their masks from
    the generator the model is given: the same seed, the same masks."""
    cfg = _narrow(config_for_variant("drs"), dropout=True)
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).train()
    x = torch.from_numpy(np.abs(_np((1, 256, FRAMES), 16)))

    def run(seed):
        model.set_dropout_generator(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            return model(x)

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    drop = rl.Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(torch.ones(4000))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert abs(float((y == 0).float().mean()) - 0.5) < 0.05
