"""The port's training slice against the JAX package on narrow configs: one
train step from the same weights and waves (loss, every gradient leaf, the
post-step parameters and BN statistics) of DCS, DC and DR, the NaN gate, the
loss menu,
the abs guard under dropout, the data pipeline and the trainer CLI with
``--resume``. The port runs on the CPU here: its kernels' plain versions."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.data import dataset as jdataset
from dcs_net_tpu.data import partition as jpartition
from dcs_net_tpu.data import synthetic as jsynthetic
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.train import losses as JL
from dcs_net_tpu.train import steps as JS
from dcs_net_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
from dcs_net_tpu.train.optim import make_optimizer as jax_make_optimizer
from dcs_net_tpu.utils.carray import CArray as JaxCArray

from dcs_net_tpu_torch.cli import common as cli_common
from dcs_net_tpu_torch.cli import train as cli_train
from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.data import dataset, partition, synthetic
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.train import losses as TL
from dcs_net_tpu_torch.train import steps as TS
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
from dcs_net_tpu_torch.train.optim import (get_lr, global_grad_norm, make_optimizer,
                                           make_plateau, optimizer_tensors, step_count)
from dcs_net_tpu_torch.utils.carray import CArray

# narrow DCS (channels[5] == channels[n_layers] for the latent reshape);
# crop 2016 samples -> 64 frames, F = 256
NARROW = (1, 4, 8, 8, 8, 16, 8, 16)
# DC and DR at three layers (``test_torch_real.py``'s narrow net): the
# encoder strides undone by the decoder's upsamples in reverse; a JAX
# compile of their step takes 7-13 s, the seven-layer one's 30 s
THREE_LAYERS = dict(n_layers=3, channels=(1, 4, 8, 16, 8, 16),
                    stride_e=((2, 2), (2, 1), (2, 1)), upsample=((2, 1), (2, 1), (2, 2)))
# the leaves of each variant held to the JAX step's in units of their terms'
# magnitudes, and to the port's float64 step, instead of the oracle band:
# the real input BN's (a one-channel BN over the whole magnitude
# spectrogram)
REAL_INPUT_BN_WITNESS = {"dr": ("initial_bn.scale", "initial_bn.bias")}
CROP, BATCH = 2016, 2
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """A test module's torch work on one CPU thread, restored after it: the
    tier-1 command runs test files in parallel processes, and torch's OpenMP
    threads, spinning at each parallel region's barrier, slow every process
    many times over when their threads outnumber the cores. Imported by the
    other port test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _tiny(cfg, dropout=False):
    model = dataclasses.replace(cfg.model, channels=NARROW, ca_reduction=4)
    if not dropout:
        model = dataclasses.replace(model, dropout_conv=0.0, dropout_fc=0.0)
    return cfg.replace(model=model, data=dataclasses.replace(
        cfg.data, crop_samples=CROP, batch_size=BATCH))


def _waves(seed):
    rng = np.random.default_rng(seed)
    clean = (0.1 * rng.standard_normal((BATCH, CROP))).astype(np.float32)
    noise = (0.05 * rng.standard_normal((BATCH, CROP))).astype(np.float32)
    return clean + noise, clean


def _band(got, want, name, floor=0.0):
    """The JAX package's torch-oracle band (tests/test_model_oracle_complex.py):
    rtol 5e-3 / atol 2.5e-3 of the leaf max, mean drift under 3e-4. A leaf
    whose largest value is under ``floor`` is rounding residue of a value
    that is zero in exact arithmetic (a conv bias that a train-mode BN
    centres away, a channel attention whose ReLU is dead): both packages
    must then be under ``floor``."""
    scale = float(np.abs(want).max())
    if scale < floor:
        assert float(np.abs(got).max()) < floor, f"{name}: not zero up to rounding"
        return
    scale = max(scale, 1e-12)
    a, b = np.asarray(got) / scale, np.asarray(want) / scale
    np.testing.assert_allclose(a, b, rtol=5e-3, atol=2.5e-3, err_msg=name)
    drift = float(np.abs(a - b).mean())
    assert drift < 3e-4, f"systematic drift at {name}: mean |delta| = {drift}"


def _jax_grads_from_adam(state, new_state, metrics, cfg):
    """The gradients of the JAX step, read back from its Adam state: after
    one step the first moment is (1 - beta1) (clip(g) + wd p), on the
    parameter vector that ``optax.flatten`` ravels (``ravel_pytree``)."""
    adam = next(s for s in new_state.opt_state.inner_state
                if isinstance(s, dict) and "m" in s)
    flat_p, unravel = ravel_pytree(state.params)
    o = cfg.optim
    g = adam["m"] / (1.0 - o.beta1) - o.weight_decay * flat_p
    gnorm = float(metrics["grad_norm"])
    if gnorm > o.clip_norm:                 # undo clip_by_global_norm
        g = g * (gnorm / o.clip_norm)
    return unravel(g)


def _narrow_variant(cfg, variant):
    """The narrow config of ``variant``: DCS seven layers, DC and DR three."""
    cfg = _tiny(cfg)
    if variant == "dcs":
        return cfg
    return cfg.replace(model=dataclasses.replace(cfg.model, **THREE_LAYERS))


@pytest.fixture(scope="module", params=["dcs", "dc", "dr"])
def step_pair(request):
    """One train step of each package from the same weights (the port's
    seeded init, moved by ``convert.py``) and waves, and each package's raw
    gradients: the port's from ``loss_and_grads``, the JAX step's from its
    Adam state (one JAX compile a variant: the step with its STFT front
    end). A case a variant: the float32 baseline of the bf16 step's band
    (``test_torch_bf16_train.py``)."""
    v = request.param
    jcfg = _narrow_variant(jax_config_for_variant(v), v)
    tcfg = _narrow_variant(config_for_variant(v), v)
    noisy, clean = _waves(1)
    weights = DCSNet(tcfg.model, tcfg.quirks, device="cpu", seed=0).state_dict()
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    model = JaxDCSNet(jcfg.model, jcfg.quirks)
    tx = jax_make_optimizer(jcfg.optim)
    state = JS.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx.init(variables["params"]))
    step_fn = JS.make_train_step(model, jcfg, tx)
    jstate, jmetrics = jax.jit(lambda s, n, c, r: step_fn(
        s, JS.batch_from_waves(n, c, jcfg), r))(state, jnp.asarray(noisy),
                                                jnp.asarray(clean), KEY)
    jgrads = _jax_grads_from_adam(state, jstate, jmetrics, jcfg)

    def port_model():
        m = DCSNet(tcfg.model, tcfg.quirks, device="cpu")
        m.load_state_dict(weights, strict=True)
        return m

    tbatch = TS.batch_from_waves(torch.from_numpy(noisy), torch.from_numpy(clean), tcfg)
    graded = port_model()
    tloss, tgrads = TS.loss_and_grads(graded, tbatch, tcfg)
    names = [n for n, p in graded.named_parameters() if p.requires_grad]
    stepped = port_model()
    opt = make_optimizer(stepped.parameters(), tcfg.optim)
    tmetrics = TS.train_step(stepped, opt, tbatch, tcfg)
    witness = {}
    if v in REAL_INPUT_BN_WITNESS:
        # the same step in float64 on the CPU, for the leaves float32 does
        # not resolve to the band: each leaf's float64 value and the sum of
        # the magnitudes of its terms (bias: dy; scale: dy x-hat, x-hat the
        # BN's normalised input)
        m64 = port_model().double()
        seen = {}

        def hook(mod, inputs, out):
            seen["x"] = inputs[0].detach()
            out.register_hook(lambda g: seen.__setitem__("dy", g.detach()))

        m64.initial_bn.register_forward_hook(hook)
        g64 = TS.loss_and_grads(m64, TS.batch_from_waves(
            torch.from_numpy(noisy).double(), torch.from_numpy(clean).double(), tcfg),
            tcfg)[1]
        x, dy = seen["x"], seen["dy"]
        var, mean = torch.var_mean(x, dim=tuple(range(x.dim() - 1)), correction=0)
        xhat = (x - mean) * torch.rsqrt(var + m64.initial_bn.eps)
        mags = {"initial_bn.scale": (dy * xhat).abs().sum(dim=(0, 1, 2)),
                "initial_bn.bias": dy.abs().sum(dim=(0, 1, 2))}
        witness = {n: (g, mags[n]) for n, g in zip(names, g64)
                   if n in REAL_INPUT_BN_WITNESS[v]}
    return dict(
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        jgrads=params_from_jax({"params": jgrads}),
        jstate=params_from_jax({"params": jstate.params,
                                "batch_stats": jstate.batch_stats}),
        tloss=float(tloss), tmetrics={k: float(v) for k, v in tmetrics.items()},
        tgrads=dict(zip(names, tgrads)), stepped=stepped, opt=opt, witness=witness)


def test_train_step_loss_matches_jax(step_pair):
    s = step_pair
    np.testing.assert_allclose(s["tloss"], s["jmetrics"]["loss"], rtol=1e-3)
    assert set(s["tmetrics"]) == set(s["jmetrics"])
    for k in set(s["jmetrics"]) - {"skipped"}:
        np.testing.assert_allclose(s["tmetrics"][k], s["jmetrics"][k], rtol=1e-3,
                                   err_msg=k)
    assert s["tmetrics"]["skipped"] == s["jmetrics"]["skipped"] == 0.0
    assert step_count(s["opt"]) == 1


def _residue_floor(grads):
    """1e-5 of the largest gradient anywhere: float32 rounding residue of a
    gradient that is zero in exact arithmetic stays below it."""
    return 1e-5 * max(float(np.abs(g.numpy()).max()) for g in grads.values())


def test_train_step_every_gradient_leaf_matches_jax(step_pair):
    """Every leaf in the oracle band of the JAX step's, but the real input
    BN's scale and bias (DR): sums over every pixel of the spectrogram whose
    terms cancel to ~1e-4 of their magnitudes, which no float32 run resolves
    to the band (the DRS witness of ``chip_smoke.py``; here the JAX step's
    scale gradient sat 7 % from the float64 value). Each is held instead,
    in units of the sum of its terms' magnitudes, to the JAX step's leaf
    within 2^-22: four units of 2^-24, two a side, where the JAX step's
    distance from the float64 value read 0.47 units and the port's 0.003
    (the scale's value is 7 units, so a zero leaf or a flipped sign
    fails); and to the port's step in float64 on the CPU within 2^-20
    (float32's rounding of a pairwise sum of 2^15 terms, ceil(log2 n) = 15
    units of 2^-24, with the terms' own errors)."""
    s = step_pair
    assert set(s["tgrads"]) == set(s["jgrads"])
    floor = _residue_floor(s["jgrads"])
    for name, g in s["tgrads"].items():
        if name in s["witness"]:
            want, mag = s["witness"][name]
            jax_g = s["jgrads"][name].double()
            unit = 2.0 ** -24 * mag
            print(f"{name} in units of 2^-24 of its terms' magnitudes: value "
                  f"{(want / unit).tolist()}, port-JAX {((g - jax_g).abs() / unit).tolist()}, "
                  f"JAX-float64 {((jax_g - want).abs() / unit).tolist()}, port-float64 "
                  f"{((g - want).abs() / unit).tolist()}")
            excess = (g.double() - jax_g).abs() - 2.0 ** -22 * mag
            assert float(excess.max()) <= 0.0, (name, "JAX", g, jax_g, mag)
            excess = (g.double() - want).abs() - 2.0 ** -20 * mag
            assert float(excess.max()) <= 0.0, (name, "float64", g, want, mag)
        else:
            _band(g.numpy(), s["jgrads"][name].numpy(), name, floor)
    np.testing.assert_allclose(float(global_grad_norm(list(s["tgrads"].values()))),
                               s["jmetrics"]["grad_norm"], rtol=1e-3)


def test_train_step_post_step_params_and_batch_stats_match_jax(step_pair):
    """Parameters after Adam within the sensitivity bound of the JAX oracle
    test (Adam's first step moves a parameter by lr * g / (|g| + eps), so a
    gradient inside the band may move it by up to lr * min(2, delta /
    (|g| + eps)), and a residue leaf in any direction, by up to 2 lr); the BN
    running statistics within the band."""
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


def test_nan_gate_leaves_params_adam_state_and_bn_buffers_unchanged():
    """A NaN wave: the step reports skipped = 1 and leaves every parameter,
    every Adam tensor (step counts included) and every BN buffer bitwise as
    it was, as the JAX step's branchless where does."""
    cfg = _tiny(config_for_variant("dcs"))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=3)
    opt = make_optimizer(model.parameters(), cfg.optim)
    noisy, clean = _waves(2)
    TS.train_step(model, opt, TS.batch_from_waves(
        torch.from_numpy(noisy), torch.from_numpy(clean), cfg), cfg)
    before = [t.clone() for t in (list(model.parameters()) + list(model.buffers())
                                  + optimizer_tensors(opt))]
    noisy[0, 100] = np.nan
    out = TS.train_step(model, opt, TS.batch_from_waves(
        torch.from_numpy(noisy), torch.from_numpy(clean), cfg), cfg)
    assert float(out["skipped"]) == 1.0 and not np.isfinite(float(out["loss"]))
    after = list(model.parameters()) + list(model.buffers()) + optimizer_tensors(opt)
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a.detach(), b)
    assert step_count(opt) == 1


@pytest.mark.parametrize("loss_type", range(7))
@pytest.mark.parametrize("one_minus_alpha", [True, False])
def test_calc_loss_matches_jax(loss_type, one_minus_alpha):
    rng = np.random.default_rng(10 + loss_type)
    waves = {k: (0.1 * rng.standard_normal((3, 800))).astype(np.float32)
             for k in ("clean_audio", "predict_clean_audio", "noise_audio",
                       "noisy_audio", "predict_noise_audio")}
    masks = {k: [rng.standard_normal((3, 8, 5)).astype(np.float32) for _ in range(2)]
             for k in ("target_mask", "predict_mask")}
    cfgs = []
    for make in (jax_config_for_variant, config_for_variant):
        c = make("dcs")
        cfgs.append(c.replace(
            loss=dataclasses.replace(c.loss, noise_loss_type=loss_type),
            quirks=dataclasses.replace(c.quirks, loss_one_minus_alpha=one_minus_alpha)))
    want = JL.calc_loss(cfgs[0], **{k: jnp.asarray(v) for k, v in waves.items()},
                        **{k: JaxCArray(*map(jnp.asarray, v)) for k, v in masks.items()})
    got = TL.calc_loss(cfgs[1], **{k: torch.from_numpy(v) for k, v in waves.items()},
                       **{k: CArray(*map(torch.from_numpy, v)) for k, v in masks.items()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_dropout_gradients_are_finite_thanks_to_the_abs_guard(monkeypatch):
    """Train mode with dropout on zeroes some mask pixels to exactly (0, 0),
    where |z| has no derivative: with the guard every gradient leaf is
    finite; with a plain sqrt(re^2 + im^2) in its place they are not."""
    cfg = _tiny(config_for_variant("dcs"), dropout=True)
    noisy, clean = _waves(4)
    batch = TS.batch_from_waves(torch.from_numpy(noisy), torch.from_numpy(clean), cfg)

    def grads():
        torch.manual_seed(0)
        model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=5)
        return TS.loss_and_grads(model, batch, cfg)[1]

    assert all(bool(torch.isfinite(g).all()) for g in grads())
    monkeypatch.setattr(CArray, "abs", lambda z: torch.sqrt(z.re * z.re + z.im * z.im))
    assert not all(bool(torch.isfinite(g).all()) for g in grads())


def test_data_pipeline_yields_the_jax_packages_batches(tmp_path):
    """Synthetic fixtures, the partition and the loader's seeded crops and
    shuffles are the JAX package's, so both packages train on the same
    batches: both loaders on their numpy paths, equal bit for bit (the
    native front ends are held against each other, and against this path,
    in ``test_torch_native_loader.py``)."""
    troot, jroot = str(tmp_path / "port"), str(tmp_path / "jax")
    tcfg = synthetic.generate(troot, n_train=6, n_test=2, seconds=0.6)
    jcfg = jsynthetic.generate(jroot, n_train=6, n_test=2, seconds=0.6)
    tpart, jpart = partition.make_partition(tcfg, seed=1), jpartition.make_partition(jcfg, seed=1)
    assert tpart == jpart and len(tpart["train"]) == 5
    tcfg = dataclasses.replace(tcfg, crop_samples=CROP)
    jcfg = dataclasses.replace(jcfg, crop_samples=CROP)
    tl = dataset.Loader(dataset.VoiceBankDataset(tpart["train"], tcfg, "train"),
                        batch_size=2, drop_last=True, seed=1, use_native=False)
    jl = jdataset.Loader(jdataset.VoiceBankDataset(jpart["train"], jcfg, "train"),
                         batch_size=2, drop_last=True, seed=1, use_native=False)
    try:
        for epoch in (0, 1):
            tb, jb = list(tl.epoch(epoch)), list(jl.epoch(epoch))
            assert len(tb) == len(jb) == 2
            for a, b in zip(tb, jb):
                assert a["id"] == b["id"]
                np.testing.assert_array_equal(a["start"], b["start"])
                np.testing.assert_array_equal(a["noisy"], b["noisy"])
                np.testing.assert_array_equal(a["clean"], b["clean"])
    finally:
        tl.close()
        jl.close()


@pytest.mark.parametrize("metrics", [
    [-3.0, -5.0, -5.0, -4.9, -4.8, -4.7, -4.6, -4.5, -4.4, -4.3, -4.2],
    [2.0, 1.0, 1.0, 1.0, 0.9999, 1.0, float("nan"), 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
], ids=["negative-losses", "positive-with-nan"])
def test_plateau_schedule_matches_the_jax_mirror(metrics):
    """torch's ReduceLROnPlateau as ``make_plateau`` builds it lowers the
    learning rate at the same epochs as the JAX package's mirror, down to
    ``min_lr`` (relative threshold on negative and positive losses, a NaN
    counting as no improvement). On a negative loss the relative threshold
    counts a repeated value as an improvement (-5 < -5 (1 - 1e-4)), in both."""
    o = dataclasses.replace(config_for_variant("dcs").optim, plateau_patience=1,
                            plateau_min_lr=2e-7)
    jax_plateau = JaxPlateau(factor=o.plateau_factor, patience=o.plateau_patience,
                             threshold=o.plateau_threshold, min_lr=o.plateau_min_lr)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=o.lr)
    plateau, lr = make_plateau(opt, o), o.lr
    for m in metrics:
        lr = jax_plateau.step(m, lr)
        plateau.step(m)
        assert get_lr(opt) == pytest.approx(lr, rel=1e-12)
    assert lr == pytest.approx(o.plateau_min_lr)


def test_synthetic_flag_writes_fixtures_under_the_log_dir(tmp_path, capsys):
    """``--synthetic`` writes the fixture tree under ``<log-dir>/synthetic_data``
    once, points the data root there, and reuses it on the next run."""
    p = cli_common.argparse.ArgumentParser()
    cli_common.add_common_args(p)
    argv = ["dcs", "--synthetic", "--synthetic-n", "5", "--log-dir", str(tmp_path)]
    cfg = cli_common.build_config(p.parse_args(argv))
    assert cfg.data.root == str(tmp_path / "synthetic_data")
    assert cfg.run.ckpt_dir == str(tmp_path / "dcs" / "checkpoints")
    part = partition.make_partition(cfg.data, seed=cfg.run.seed)
    assert (len(part["train"]), len(part["val"]), len(part["test"])) == (4, 1, 2)
    assert "generating synthetic fixtures" in capsys.readouterr().out
    cli_common.build_config(p.parse_args(argv))
    assert "generating" not in capsys.readouterr().out


def test_trainer_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    """``cli/train.py --device cpu`` on synthetic data: an epoch of 2 steps
    writes a checkpoint; ``--resume`` restores it (model, Adam, plateau,
    epoch) and trains the next epoch from step 2."""
    dcfg = synthetic.generate(str(tmp_path / "data"), n_train=8, n_test=2, seconds=0.4)
    base = _tiny(config_for_variant("dcs"), dropout=True)

    def run(epochs, *flags):
        cfg = base.replace(
            data=dataclasses.replace(dcfg, crop_samples=CROP, batch_size=BATCH,
                                     num_workers=1),
            run=dataclasses.replace(base.run, max_epochs=epochs,
                                    ckpt_dir=str(tmp_path / "ckpt"),
                                    log_dir=str(tmp_path / "logs")))
        path = tmp_path / "config.json"
        path.write_text(cfg.to_json())
        return cli_train.main(["dcs", "--config-json", str(path), "--device", "cpu",
                               "--limit-train-batches", "2", *flags])

    first = run(1)
    assert first["steps"] == 2 and first["nonfinite_loss_steps"] == 0
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2
    second = run(2, "--resume")
    assert "resumed from step 2 (epoch 1)" in capsys.readouterr().out
    assert second["epoch"] == 1 and second["steps"] == 2
    assert ckpt.latest_step() == 4 and np.isfinite(second["loss"])
    assert os.path.exists(tmp_path / "logs" / "events.jsonl")


@pytest.mark.parametrize("variant,flags", [
    ("drs", ["--dtype", "bfloat16"]),
    ("dcs", ["--steps-per-dispatch", "2"]),
], ids=["bf16", "scan"])
def test_train_cli_rejects_unported_flags(variant, flags, capsys, tmp_path, monkeypatch):
    """Flags the port once refused, now taken. ``--dtype bfloat16`` for the
    real variants: with ``--synthetic`` (the variant's config narrowed) the
    CLI trains DRS at bf16 for a capped epoch to a finite loss, its
    checkpoint's config at bf16 (the parity of the step is
    ``test_torch_bf16_train_drs.py``'s). ``--steps-per-dispatch``: at 2 on
    the CPU the CLI trains an epoch of 3 steps, a dispatch of 2 and a single
    step, then resumes for a second."""
    if "--dtype" in flags:
        monkeypatch.setattr(cli_common, "config_for_variant",
                            lambda variant, **kw: _tiny(config_for_variant(variant, **kw)))
        metrics = cli_train.main([variant, "--synthetic", "--synthetic-n", "8", "--log-dir",
                                  str(tmp_path), "--device", "cpu", *flags, "--epochs", "1",
                                  "--limit-train-batches", "1"])
        assert metrics["steps"] == 1 and metrics["nonfinite_loss_steps"] == 0
        assert np.isfinite(metrics["loss"])
        with open(tmp_path / variant / "checkpoints" / "config.json") as f:
            assert '"compute_dtype": "bfloat16"' in f.read()
        return
    dcfg = synthetic.generate(str(tmp_path / "data"), n_train=8, n_test=2, seconds=0.4)
    base = _tiny(config_for_variant("dcs"))
    cfg = base.replace(
        data=dataclasses.replace(dcfg, crop_samples=CROP, batch_size=BATCH, num_workers=1),
        run=dataclasses.replace(base.run, ckpt_dir=str(tmp_path / "ckpt"),
                                log_dir=str(tmp_path / "logs")))
    path = tmp_path / "config.json"
    for epochs, resume in ((1, []), (2, ["--resume"])):
        path.write_text(cfg.replace(run=dataclasses.replace(
            cfg.run, max_epochs=epochs)).to_json())
        metrics = cli_train.main(["dcs", "--config-json", str(path), "--device", "cpu",
                                  *flags, *resume])
        assert "steps_per_dispatch=2" in capsys.readouterr().out
        assert metrics["epoch"] == epochs - 1 and metrics["steps"] == 3
        assert metrics["nonfinite_loss_steps"] == 0 and np.isfinite(metrics["loss"])
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 6


def test_train_cli_takes_no_tensorboard(tmp_path, monkeypatch):
    """``--no-tensorboard``, a flag of the JAX train CLI, is accepted: with
    ``--synthetic`` the CLI trains one capped epoch (the variant's config
    narrowed) and hands the Trainer ``use_tensorboard=False``."""
    from dcs_net_tpu_torch.train import loop as tloop

    monkeypatch.setattr(cli_common, "config_for_variant",
                        lambda variant, **kw: _tiny(config_for_variant(variant, **kw)))
    seen = []

    class Recording(tloop.Trainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            seen.append(self.use_tensorboard)

    monkeypatch.setattr(tloop, "Trainer", Recording)
    metrics = cli_train.main(["dcs", "--synthetic", "--synthetic-n", "8", "--log-dir",
                              str(tmp_path), "--device", "cpu", "--no-tensorboard",
                              "--epochs", "1", "--limit-train-batches", "1"])
    assert seen == [False]
    assert metrics["steps"] == 1 and metrics["nonfinite_loss_steps"] == 0
    assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_loss"])
    assert os.path.exists(tmp_path / "dcs" / "events.jsonl")


def test_train_cli_trains_the_real_variants(tmp_path, capsys):
    """No variant is rejected: DR and DRS train an epoch of 2 steps on the
    CPU (a narrow three-layer net), with finite losses and a checkpoint."""
    dcfg = synthetic.generate(str(tmp_path / "data"), n_train=6, n_test=2, seconds=0.4)
    for variant in ("dr", "drs"):
        base = config_for_variant(variant)
        cfg = base.replace(
            model=dataclasses.replace(
                base.model, n_layers=3, channels=(1, 4, 8, 16, 8, 16),
                stride_e=((2, 2), (2, 1), (2, 1)), upsample=((2, 1), (2, 1), (2, 2)),
                ca_reduction=4),
            data=dataclasses.replace(dcfg, crop_samples=CROP, batch_size=BATCH,
                                     num_workers=1),
            run=dataclasses.replace(base.run, max_epochs=1,
                                    ckpt_dir=str(tmp_path / variant / "ckpt"),
                                    log_dir=str(tmp_path / variant / "logs")))
        path = tmp_path / f"{variant}.json"
        path.write_text(cfg.to_json())
        metrics = cli_train.main([variant, "--config-json", str(path), "--device", "cpu"])
        assert f"variant={variant} complex=False" in capsys.readouterr().out
        assert metrics["steps"] == 2 and metrics["nonfinite_loss_steps"] == 0
        assert np.isfinite(metrics["loss"]) and np.isfinite(metrics["val_loss"])
        assert ("noise_loss" in metrics) == (variant == "drs")
        assert CheckpointManager(cfg.run.ckpt_dir).latest_step() == 2
