"""The port's train step at ``compute_dtype = dft_dtype = "bfloat16"``
against the JAX package's at the same setting, on the CPU (the kernels'
plain versions under plain autograd), for narrow DCS (DC's in
``test_torch_bf16_train_dc.py``, with these tests) from the same weights and
waves with dropout off; the bf16 classes of the training path
against the JAX rules they stand for; the scanned step at bf16; and the
training CLI at ``--dtype bfloat16``, whose checkpoint the enhance CLI
serves.

Bands:
* the train step: the loss, and the whole gradient as one vector (relative
  L2), within twice JAX's own bf16 -> float32 distance (the triangle's
  bound for two roundings of one step, each about that far from float32);
  every leaf above 1e-5 of the largest gradient within four times its own
  leaf's distance. Each distance is taken over the steps of ``BATCHES``
  batches from the same weights (the losses as one vector, each gradient
  and leaf concatenated over them): a single step's distances are single
  draws of a rounding walk, and their ratio has a long tail (one batch's
  JAX bf16 loss fell 1.7e-5 from its float32 loss, where the others fell
  3e-3 to 8e-3 from theirs). The JAX step runs its decoder in the unified
  form (``conv_engine.UNIFIED_UPDOT``), whose tap conv is the Pallas kernel
  kernel 3 ports and whose backward is ``_updot_bwd``: the JAX default at
  bf16, the tap-fold, rounds each phase's and input's product where kernel 3
  rounds once (ROADMAP Queue 3, the bf16 trap), and against it two leaves
  of DCS's decoder channel attention sat at 5.2-5.5 times their distance
  (PERF.md). The ratios measured print with ``-s``; PERF.md records them;
* each new class's plain version against its JAX rule: 2^-7 of the largest
  value (the same exact bf16 products summed in float32 in another order,
  a bf16 unit apart at most).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.ops import conv_engine as jax_conv_engine
from dcs_net_tpu.ops.conv_engine import _updot_bwd
from dcs_net_tpu.ops.pallas_conv import _bwd as jax_conv_bwd
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_xla
from dcs_net_tpu.train import steps as JS
from dcs_net_tpu.train.optim import make_optimizer as jax_make_optimizer

from dcs_net_tpu_torch.cli import common as cli_common
from dcs_net_tpu_torch.cli import enhance as cli_enhance
from dcs_net_tpu_torch.cli import train as cli_train
from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
from dcs_net_tpu_torch.models.enhance import enhance_full
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv
from dcs_net_tpu_torch.train import steps as TS
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager, load_model
from dcs_net_tpu_torch.train.optim import make_optimizer, optimizer_tensors

from test_torch_train import KEY, _jax_grads_from_adam, _one_torch_thread  # noqa: F401
from test_torch_train import _tiny, _waves

B16 = torch.bfloat16
BF16_OUT = 2.0 ** -7
# a three-layer narrow net: the two packages' train steps at both types in
# two JAX compiles (the seven-layer one takes 30-40 s a step to compile)
SMALL = dict(n_layers=3, channels=(1, 4, 8, 16, 8, 16),
             stride_e=((2, 2), (2, 1), (2, 1)), upsample=((2, 1), (2, 1), (2, 2)))
BATCHES = 4     # steps from the same weights, each on its own batch


def _cfg16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                       stft=dataclasses.replace(cfg.stft, dft_dtype="bfloat16"))


def _small(cfg, dropout=False):
    cfg = _tiny(cfg, dropout)
    return cfg.replace(model=dataclasses.replace(cfg.model, **SMALL))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _flat(grads, names):
    return np.concatenate([np.asarray(grads[n], np.float64).ravel() for n in names])


def _steps(variant):
    """One variant's train steps in both packages on ``BATCHES`` batches from
    the port's seeded weights: JAX at float32 and bf16 in one compile, its
    decoder unified (its raw gradients read back from Adam, as
    ``test_torch_train.step_pair`` reads them), the port at bf16 through
    ``loss_and_grads``. Losses (BATCHES,); gradients name -> (BATCHES,
    *leaf)."""
    jcfg32 = _small(jax_config_for_variant(variant))
    tcfg16 = _cfg16(_small(config_for_variant(variant)))
    jcfgs = (jcfg32, _cfg16(jcfg32))
    weights = DCSNet(tcfg16.model, tcfg16.quirks, device="cpu", seed=0).state_dict()
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    tx = jax_make_optimizer(jcfg32.optim)
    state = JS.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    fns = [JS.make_train_step(JaxDCSNet(c.model, c.quirks), c, tx) for c in jcfgs]

    def both(s, n, c, r):
        return [fn(s, JS.batch_from_waves(n, c, cfg), r) for fn, cfg in zip(fns, jcfgs)]

    res = {k: [] for k in ("loss", "grads", "loss16", "grads16", "loss32", "grads32")}
    dtypes = set()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_conv_engine, "UNIFIED_UPDOT", True)
        step = jax.jit(both)
        for b in range(BATCHES):
            noisy, clean = _waves(1 + b)
            out = step(state, jnp.asarray(noisy), jnp.asarray(clean), KEY)
            for name, (jstate, jm) in zip(("32", "16"), out):
                res["loss" + name].append(float(jm["loss"]))
                grads = params_from_jax({"params": _jax_grads_from_adam(state, jstate, jm,
                                                                        jcfg32)})
                res["grads" + name].append({k: v.numpy() for k, v in grads.items()})
            model = DCSNet(tcfg16.model, tcfg16.quirks, device="cpu")
            model.load_state_dict(weights, strict=True)
            batch = TS.batch_from_waves(torch.from_numpy(noisy), torch.from_numpy(clean),
                                        tcfg16)
            loss, grads = TS.loss_and_grads(model, batch, tcfg16)
            names = [n for n, p in model.named_parameters() if p.requires_grad]
            res["loss"].append(float(loss))
            res["grads"].append({n: g.numpy() for n, g in zip(names, grads)})
            dtypes |= {str(g.dtype) for g in grads}
    out = dict(variant=variant, names=names, dtypes=dtypes)
    for k, v in res.items():
        out[k] = (np.array(v) if k.startswith("loss")
                  else {n: np.stack([g[n] for g in v]) for n in v[0]})
    return out


@pytest.fixture(scope="module")
def bf16_step():
    """DCS's steps; DC's are ``test_torch_bf16_train_dc.py``'s (one JAX
    compile a file keeps each under a minute)."""
    return _steps("dcs")


def test_bf16_train_step_loss_and_gradient_in_band_of_jax(bf16_step):
    """The loss and the whole gradient within twice JAX's own bf16 ->
    float32 distance; the gradients that reach the float32 parameters are
    float32."""
    s = bf16_step
    assert s["dtypes"] == {"torch.float32"}
    assert set(s["grads"]) == set(s["grads16"])
    d_loss_jax = float(np.linalg.norm(s["loss16"] - s["loss32"]))
    d_loss = float(np.linalg.norm(s["loss"] - s["loss16"]))
    names = s["names"]
    g, g16, g32 = (_flat(x, names) for x in (s["grads"], s["grads16"], s["grads32"]))
    d_grad_jax, d_grad = _rel(g16, g32), _rel(g, g16)
    print(f"\n{s['variant']} bf16 step: loss {d_loss / d_loss_jax:.3f} of JAX's own "
          f"distance ({d_loss:.3e} / {d_loss_jax:.3e}); gradient {d_grad / d_grad_jax:.3f}"
          f" ({d_grad:.3e} / {d_grad_jax:.3e})")
    assert np.all(np.isfinite(s["loss"])) and np.all(np.isfinite(g))
    assert d_loss_jax > 0 and d_grad_jax > 0
    assert d_loss <= 2 * d_loss_jax, (d_loss, d_loss_jax)
    assert d_grad <= 2 * d_grad_jax, (d_grad, d_grad_jax)


def test_bf16_train_step_every_gradient_leaf_in_band_of_jax(bf16_step):
    """Every leaf above 1e-5 of the largest gradient within four times its
    own bf16 -> float32 distance in JAX."""
    s = bf16_step
    top = max(float(np.abs(v).max()) for v in s["grads32"].values())
    worst = []
    for name in s["names"]:
        want32, want16 = s["grads32"][name], s["grads16"][name]
        if float(np.abs(want32).max()) < 1e-5 * top:
            continue
        d_jax, d = _rel(want16, want32), _rel(s["grads"][name], want16)
        worst.append((d / max(d_jax, 1e-30), name))
        assert d <= 4 * d_jax, (name, d, d_jax)
    print(f"\n{s['variant']} leaves: largest ratio {max(worst)[0]:.3f} at {max(worst)[1]}")


def test_conv_entry_bf16_plain_matches_the_pallas_conv():
    """Class 1's plain version against the Pallas conv's XLA formulation at
    bf16 operands (a zero bias, as the spatial attention's): its interpret
    mode does not run at bf16 on the CPU (XLA's CPU dot takes no bf16 x bf16
    = float32), as ``test_torch_bf16.py`` found for the gate's conv."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 20, 4)).astype(np.float32)
    w = (0.2 * rng.standard_normal((7, 7, 4, 2))).astype(np.float32)
    want = _conv_fwd_xla(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                         jnp.zeros(2, jnp.float32))
    got = cuda_conv.conv2d_same_small_cout_bf16_plain(
        torch.from_numpy(x).to(B16), torch.from_numpy(w).to(B16), torch.zeros(2))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == B16
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_OUT, err


def test_conv_entry_input_gradient_bf16_plain_matches_jax_bwd():
    """Class 2's plain version against the dx of the JAX ``_bwd`` at bf16
    (class (7, 2, 4): g of the spatial attention's two outputs)."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((2, 12, 20, 4)), jnp.bfloat16)
    w = jnp.asarray(0.2 * rng.standard_normal((7, 7, 4, 2)), jnp.bfloat16)
    g = rng.standard_normal((2, 12, 20, 2)).astype(np.float32)
    dx = jax_conv_bwd((x, w), jnp.asarray(g))[0]
    assert dx.dtype == jnp.bfloat16
    got = cuda_conv.conv2d_same_small_cout_dgrad_bf16_plain(
        torch.from_numpy(g), torch.from_numpy(np.array(jnp.asarray(w, jnp.float32))))
    want = np.asarray(jnp.asarray(dx, jnp.float32))
    assert got.dtype == B16 and got.shape == (2, 12, 20, 4)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_OUT, err


@pytest.mark.parametrize("H,W,cin,n", [(4, 6, 16, 24), (8, 5, 32, 8)])
def test_tapconv_input_gradient_bf16_plain_matches_jax_updot_bwd(H, W, cin, n):
    """Class 3's plain version against the dx of the JAX ``_updot_bwd`` at
    bf16 (its gradient of the padded x, whose interior is x's), at a 3 x 3
    window on x padded by one pixel on every side, as the decoder's."""
    rng = np.random.default_rng(5 + cin)
    x = rng.standard_normal((2, H, W, cin)).astype(np.float32)
    w = (0.2 * rng.standard_normal((9, cin, n))).astype(np.float32)
    g = rng.standard_normal((2, H, W, n)).astype(np.float32)
    pad = (1, 1, 1, 1)
    xp = jnp.asarray(np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))), jnp.bfloat16)
    dxp, dk = _updot_bwd((3, 3), (xp, jnp.asarray(w, jnp.bfloat16)), jnp.asarray(g))
    assert dxp.dtype == jnp.bfloat16 and dk.dtype == jnp.bfloat16
    want = np.asarray(jnp.asarray(dxp, jnp.float32))[:, 1:1 + H, 1:1 + W]
    got = cuda_tapconv.tapconv_dgrad_bf16_plain(torch.from_numpy(g), torch.from_numpy(w),
                                                3, 3, pad, (H, W))
    assert got.dtype == B16 and got.shape == (2, H, W, cin)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= BF16_OUT, err
    # the weight gradient: float32 sums, w's type
    xt = cuda_tapconv._pad(torch.from_numpy(x).to(B16), pad)
    dw = cuda_tapconv.weight_grad(xt, torch.from_numpy(g).to(B16), 3, 3)
    want_dk = np.asarray(jnp.asarray(dk, jnp.float32))
    assert dw.dtype == B16
    assert np.abs(dw.float().numpy() - want_dk).max() / np.abs(want_dk).max() <= BF16_OUT


def test_tapconv_autograd_at_bf16_gives_the_input_gradient_class():
    """On the CPU ``tapconv_valid`` at bf16 under autograd is the plain
    version under plain autograd: its dx is the class's plain version (float32
    sums over every tap and channel in another order, one rounding: within
    2^-7 of the largest value), and its dw is bf16."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 5, 7, 16)).astype(np.float32)).to(B16)
    w = torch.from_numpy((0.2 * rng.standard_normal((9, 16, 24))).astype(np.float32)).to(B16)
    g = torch.from_numpy(rng.standard_normal((2, 5, 7, 24)).astype(np.float32)).to(B16)
    x.requires_grad_(True)
    w.requires_grad_(True)
    y = cuda_tapconv.tapconv_valid(x, w, 3, 3, (1, 1, 1, 1))
    assert y.dtype == B16
    dx, dw = torch.autograd.grad(y, (x, w), g)
    assert dx.dtype == dw.dtype == B16
    want = cuda_tapconv.tapconv_dgrad_bf16_plain(g, w.detach(), 3, 3, (1, 1, 1, 1), (5, 7))
    err = (dx.float() - want.float()).abs().max() / want.float().abs().max()
    assert float(err) <= BF16_OUT, float(err)


def test_scanned_bf16_step_equals_two_single_steps_bit_for_bit():
    """K = 2 steps a dispatch at bf16 on the CPU, dropout on: parameters,
    BN statistics and every Adam tensor equal two single steps' bit for
    bit, the masks drawn from one generator in the same order."""
    cfg = _cfg16(_small(config_for_variant("dcs"), dropout=True))
    assert cfg.model.dropout_conv > 0
    waves = [_waves(s) for s in (7, 8)]
    noisy = torch.from_numpy(np.stack([w[0] for w in waves]))
    clean = torch.from_numpy(np.stack([w[1] for w in waves]))
    runs = []
    for scanned in (False, True):
        model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=1)
        opt = make_optimizer(model.parameters(), cfg.optim)
        gen = torch.Generator().manual_seed(11)
        model.set_dropout_generator(gen)
        if scanned:
            out = TS.make_scanned_train_step(model, opt, cfg, 2)(noisy, clean)
            losses = out["loss"].tolist()
        else:
            losses = [float(TS.train_step(model, opt, TS.batch_from_waves(
                noisy[i], clean[i], cfg), cfg)["loss"]) for i in range(2)]
        runs.append((model, opt, losses))
    (m1, o1, l1), (m2, o2, l2) = runs
    assert l1 == l2 and all(np.isfinite(l1))
    for (name, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        assert a.dtype == torch.float32 or name.endswith("num_batches_tracked")
        assert torch.equal(a, b), name
    for a, b in zip(optimizer_tensors(o1), optimizer_tensors(o2)):
        assert torch.equal(a, b)


def test_train_cli_at_bf16_trains_an_epoch_whose_checkpoint_serves(tmp_path, monkeypatch,
                                                                   capsys):
    """``cli.train dcs --dtype bfloat16 --device cpu --synthetic`` (the
    variant's config narrowed) trains one epoch to a finite loss; the
    checkpoint holds float32 parameters and the bf16 config, and
    ``cli.enhance`` serves it as saved (bf16) and at ``--dtype float32``."""
    monkeypatch.setattr(cli_common, "config_for_variant",
                        lambda variant, **kw: _small(config_for_variant(variant, **kw),
                                                     dropout=True))
    log = str(tmp_path / "runs")
    metrics = cli_train.main(["dcs", "--synthetic", "--synthetic-n", "8", "--log-dir", log,
                              "--device", "cpu", "--dtype", "bfloat16", "--epochs", "1",
                              "--limit-train-batches", "2"])
    assert metrics["steps"] == 2 and metrics["nonfinite_loss_steps"] == 0
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_loss"])
    ckpt = str(tmp_path / "runs" / "dcs" / "checkpoints")
    assert CheckpointManager(ckpt).latest_step() == 2
    src = str(tmp_path / "in.wav")
    wave = (0.1 * np.random.default_rng(9).standard_normal(4000)).astype(np.float32)
    write_wav(src, wave, 16000)
    served = {}
    for dtype in ("bfloat16", "float32"):
        dst = str(tmp_path / f"out_{dtype}.wav")
        flags = [] if dtype == "bfloat16" else ["--dtype", "float32"]
        cli_enhance.main(["dcs", "--in", src, "--out", dst, "--ckpt-dir", ckpt,
                          "--device", "cpu", *flags])
        served[dtype] = read_wav(dst)[0]
    assert "using config saved with checkpoint (dcs)" in capsys.readouterr().out
    cfg16 = _cfg16(_small(config_for_variant("dcs"), dropout=True))
    model = DCSNet(cfg16.model, cfg16.quirks, device="cpu")
    load_model(ckpt, model)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values()
               if t.is_floating_point())
    want = enhance_full(model, torch.from_numpy(read_wav(src)[0])[None], cfg16)[0].numpy()
    np.testing.assert_allclose(served["bfloat16"], want, atol=1.0 / 2 ** 15 + 1e-9)
    assert np.all(np.isfinite(served["float32"]))
    assert np.abs(served["float32"] - served["bfloat16"]).max() > 0
