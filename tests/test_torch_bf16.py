"""The port's serving path at ``compute_dtype = dft_dtype = "bfloat16"``
against the JAX package at the same setting, on the CPU (the kernels' plain
versions), with the JAX weights moved by ``convert.py``.

Bands, stated in PERF.md section 2 before the first chip run:
* a bf16 class's plain version against the JAX function it stands for
  (kernel 1's STFT and iSTFT, kernel 3's tap conv against the Pallas kernel
  in interpret mode, kernel 2's conv against the Pallas conv in interpret
  mode): both sum exact bf16 products in float32, so a bf16 output agrees to
  2^-7 of its largest value (one bf16 unit where the sum orders round
  apart), a float32 output to 1e-4;
* the gate, the LSTM and the whole net against JAX: a band, not equality,
  since XLA on the CPU may keep excess precision across fused bf16
  elementwise ops and so rounds at other points than the port: the gate and
  the LSTM within 2^-6 of their largest value (a few bf16 units); the
  enhanced waveform within half of JAX's own bf16 to float32 distance from
  JAX's bf16 result, the net's bounded mask within twice that distance
  (half was the band predicted; the JAX decoder rounds at more points, see
  the mask's test), both within 0.1 absolute (the JAX package's own bound,
  ``tests/test_model.py:124-125``).
Then the CPU models of the bf16 packings, the routing to the bf16 classes
(training's too: the conv entry, its input gradient and the tap conv's
input gradient take their bf16 classes in both directions, at the complex
and the real classes), the real family at bf16 through every CLI and the
trainer (once refused, now run: their parity is ``test_torch_bf16_real.py``'s),
the refusal that remains (the bf16 STFT under autograd), and the two
serving CLIs at ``--dtype bfloat16``.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import STFTConfig as JaxSTFTConfig
from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.dsp import stft as jdsp
from dcs_net_tpu.models.enhance import enhance_full as jax_enhance_full
from dcs_net_tpu.models.enhance import enhance_streaming as jax_enhance_streaming
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.ops import attention as jatt
from dcs_net_tpu.ops import complex_layers as jcl
from dcs_net_tpu.ops.lstm import ComplexLSTM as JaxComplexLSTM
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_xla
from dcs_net_tpu.ops.pallas_tapconv import tapconv_valid as jax_tapconv
from dcs_net_tpu.utils.carray import CArray as JC

from dcs_net_tpu_torch.cli import enhance as cli_enhance
from dcs_net_tpu_torch.cli import test as cli_test
from dcs_net_tpu_torch.cli import train as cli_train
from dcs_net_tpu_torch.cli import tune as cli_tune
from dcs_net_tpu_torch.cli.common import add_common_args, build_config
from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import Config, STFTConfig, config_for_variant
from dcs_net_tpu_torch.data import synthetic
from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
from dcs_net_tpu_torch.dsp import stft as tdsp
from dcs_net_tpu_torch.dsp import stft_cuda
from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
from dcs_net_tpu_torch.models.graphed import GraphCache
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import attention as tatt
from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv
from dcs_net_tpu_torch.ops.lstm import ComplexLSTM
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
from dcs_net_tpu_torch.train.loop import Trainer
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_enhance import NARROW, _perturb
from test_torch_layers import _jc, _load, _pair, _tc
from test_torch_train import _one_torch_thread  # noqa: F401

B16 = torch.bfloat16
BF16_OUT = 2.0 ** -7       # a bf16 output against its plain version or JAX
F32_OUT = 1e-4             # a float32 output of bf16 products
BAND = 2.0 ** -6           # the gate and the LSTM against JAX's rounding points


def _np(t) -> np.ndarray:
    """A torch, JAX or numpy array as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfg16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                       stft=dataclasses.replace(cfg.stft, dft_dtype="bfloat16"))


# -- kernel 1 -----------------------------------------------------------------

def test_stft_and_istft_at_bf16_match_jax():
    """The bf16 class's plain version (frames and the float64 -> float32 ->
    bf16 basis, float32 sums) against the JAX ``dsp.stft`` at
    ``dft_dtype="bfloat16"``; the iSTFT (spectrogram and bases rounded,
    float32 product and overlap-add) against the JAX ``istft``; both away
    from the float32 transform by more than the band (the rounding is
    there)."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((2, 4000))).astype(np.float32)
    t32, t16 = STFTConfig(), STFTConfig(dft_dtype="bfloat16")
    j16 = JaxSTFTConfig(dft_dtype="bfloat16")
    want = jax.jit(lambda a: jdsp.stft(a, j16))(jnp.asarray(x))
    got = tdsp.stft(torch.from_numpy(x), t16)
    f32 = tdsp.stft(torch.from_numpy(x), t32)
    for g, w, f in ((got.re, want.re, f32.re), (got.im, want.im, f32.im)):
        assert g.dtype == torch.float32 and g.shape == (2, 256, 126)
        assert _rel(g, w) <= F32_OUT
        assert _rel(f, w) > 10 * F32_OUT
    full = tdsp.pad_bins(got, t16, pad_top=True)
    want_w = jax.jit(lambda r, i: jdsp.istft(JC(r, i), j16, length=4000))(
        jnp.asarray(full.re.numpy()), jnp.asarray(full.im.numpy()))
    got_w = tdsp.istft(full, t16, length=4000)
    assert got_w.dtype == torch.float32 and _rel(got_w, want_w) <= F32_OUT
    assert _rel(tdsp.istft(full, t32, length=4000), want_w) > 3 * F32_OUT


def test_dense_basis_bf16_is_jax_rounding_in_core_matrix_order():
    """The bf16 class's packed basis: the folded float32 bases rounded as JAX
    rounds them (``jnp.asarray(b, bf16)``), bit for bit, element (k, n) of
    column block j and chunk c at [j, c, k // 8, n, k % 8] of the K-major
    core-matrix image, zero past n_fft and past the bins."""
    cfg = STFTConfig(dft_dtype="bfloat16", n_fft=200, win_length=200, hop=50)
    cos_b, sin_b = tdsp._dft_basis_eff(cfg, np.float32)
    packed = stft_cuda.dense_basis_bf16(cos_b, sin_b)
    k, f = cos_b.shape
    assert packed.shape == (4, 7, 4, 64, 8) and packed.dtype == B16
    ref = [np.asarray(jnp.asarray(b, jnp.bfloat16).astype(jnp.float32)) for b in (cos_b, sin_b)]
    dense = packed.float().permute(1, 2, 4, 0, 3).reshape(7 * 32, 4 * 64).numpy()
    for j in range(4):
        for part, r in enumerate(ref):
            cols = dense[:, 64 * j + 32 * part:64 * j + 32 * part + 32]
            bins = min(32, f - 32 * j)
            np.testing.assert_array_equal(cols[:k, :bins], r[:, 32 * j:32 * j + bins])
            assert not cols[k:].any() and not cols[:, bins:].any()


class _Recorder:
    """Stands in for a CudaKernel on meta tensors: counts its launches."""

    def __init__(self, name):
        self.name, self.launches = name, 0

    def __call__(self, device, *args):
        self.launches += 1


def test_stft_at_bf16_takes_the_dense_bf16_class_at_every_size(monkeypatch):
    """On a tensor off the CPU (meta) the bf16 plan launches the dense bf16
    class once, whatever the size, and neither float32 entry: its span body
    where hop is a multiple of 16 (the model's 512 / 32, and 352 / 32), its
    chunked body otherwise (400 / 100), each on the basis its body reads."""
    recs = {k: _Recorder(k) for k in ("KERNEL", "KERNEL_DENSE", "KERNEL_DENSE_BF16",
                                      "KERNEL_DENSE_BF16_CHUNKED")}
    for k, r in recs.items():
        monkeypatch.setattr(stft_cuda, k, r)
    for n_fft, hop, body in ((512, 32, "dense_bf16"), (400, 100, "dense_bf16_chunked"),
                             (352, 32, "dense_bf16")):
        assert stft_cuda.choose_entry(n_fft, hop, "bfloat16") == body
        cfg = STFTConfig(dft_dtype="bfloat16", n_fft=n_fft, win_length=n_fft, hop=hop)
        plan = tdsp._analysis_plan(cfg, torch.device("meta"))
        assert plan.bf16 and plan.dense.dtype == B16 and plan.cos_b is None
        assert plan.dense.dim() == (4 if body == "dense_bf16" else 5)
        re, im = stft_cuda.stft_analysis(torch.empty(2, 4000, device="meta"), plan)
        assert re.dtype == torch.float32
    assert [recs[k].launches for k in recs] == [0, 0, 2, 1]


# -- kernel 3 -----------------------------------------------------------------

@pytest.mark.parametrize("B,H,W,cin,n,pad", [
    (2, 4, 9, 32, 16, (1, 1, 1, 1)),       # a decoder stage's form
    (1, 5, 6, 20, 8, (0, 2, 1, 1)),        # Cin no multiple of 8, asymmetric
], ids=["stage", "ragged"])
def test_tapconv_bf16_plain_matches_pallas_interpret(B, H, W, cin, n, pad):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((9, cin, n)) / (3 * np.sqrt(cin))).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(B16), torch.from_numpy(w).to(B16)
    got = cuda_tapconv.tapconv_valid(xt, wt, 3, 3, pad)
    top, bottom, left, right = pad
    xp = np.pad(x, ((0, 0), (top, bottom), (left, right), (0, 0)))
    want = jax_tapconv(jnp.asarray(xp).astype(jnp.bfloat16),
                       jnp.asarray(w).astype(jnp.bfloat16), 3, 3, interpret=True)
    assert got.dtype == B16 and want.dtype == jnp.bfloat16
    assert got.shape == want.shape
    assert _rel(got, want) <= BF16_OUT


@pytest.mark.parametrize("cin,n,bn", [(32, 512, 128), (20, 70, 64), (40, 8, 8)])
def test_pack_weights_bf16_round_trip_and_core_matrix_order(cin, n, bn):
    """The CPU model of ``dcs_tapconv_pack_bf16``: unpack(pack(w)) == w, and
    weight (tap, c, m) at [m // bn, c // 32, tap, (c % 32) // 8, m % bn,
    c % 8], zero past Cin and N."""
    w = torch.randn(9, cin, n).to(B16)
    wp = cuda_tapconv.pack_weights_bf16(w, bn)
    nt, nc = -(-n // bn), -(-cin // 32)
    assert wp.shape == (nt, nc, 9, 4, bn, 8) and wp.dtype == B16
    assert torch.equal(cuda_tapconv.unpack_weights_bf16(wp, cin, n), w)
    for tap, c, m in ((0, 0, 0), (4, cin - 1, n - 1), (8, cin // 2, n // 3)):
        assert wp[m // bn, c // 32, tap, (c % 32) // 8, m % bn, c % 8] == w[tap, c, m]
    full = torch.zeros(9, nc * 32, nt * bn, dtype=B16)
    full[:, :cin, :n] = w
    assert torch.equal(wp.flatten().sort()[0], full.flatten().sort()[0])


def test_tapconv_at_bf16_takes_its_bf16_class_on_meta(monkeypatch):
    """On meta tensors a bf16 tap conv launches the bf16 packing and kernel
    once each, with bf16 packed weights, and nothing of the float32 class."""
    recs = {k: _Recorder(k) for k in ("KERNEL", "PACK", "KERNEL_BF16", "PACK_BF16")}
    for k, r in recs.items():
        monkeypatch.setattr(cuda_tapconv, k, r)
    x = torch.empty(4, 2, 251, 512, device="meta", dtype=B16)
    w = torch.empty(9, 512, 512, device="meta", dtype=B16)
    y = cuda_tapconv.tapconv_valid(x, w, 3, 3, (1, 1, 1, 1))
    assert y.dtype == B16 and y.shape == (4, 2, 251, 512)
    assert [recs[k].launches for k in recs] == [0, 0, 1, 1]


# -- kernel 2 -----------------------------------------------------------------

def test_spatial_gate_bf16_matches_jax_and_its_conv_the_pallas_conv():
    """The bf16 pool and gate (plain versions) against the JAX complex
    spatial attention at ``dtype=bfloat16`` applied to its input
    (``complex_mul_bcast``); the pooled map against JAX's mean (float32 sum,
    rounded) and max; the gate's conv, in float32 on the bf16 values,
    against the Pallas conv's plain reference at bf16 (``_conv_fwd_xla``):
    its interpret mode does not run at bf16 on the CPU, whose dot takes no
    bf16 x bf16 = float32 product."""
    x = _pair((2, 16, 12, 6), 10)
    xb = JC(*(jnp.asarray(p).astype(jnp.bfloat16) for p in x))
    mod = jatt.ComplexSpatialAttention(7, dtype=jnp.bfloat16)
    v = jax.jit(mod.init)(jax.random.PRNGKey(6), xb)
    want = jax.jit(lambda v, a: jcl.complex_mul_bcast(a, mod.apply(v, a)))(v, xb)
    port = _load(tatt.ComplexSpatialAttention(7, dtype=B16), v).eval()
    xt = CArray(*(torch.from_numpy(p).to(B16) for p in x))
    with torch.no_grad():
        got = port.gate(xt)
    assert got.re.dtype == B16
    assert max(_rel(got.re, want.re), _rel(got.im, want.im)) <= BAND

    pooled = cuda_conv.sa_pool(xt.re, xt.im)
    assert pooled.dtype == B16
    jpool = jnp.concatenate([f(p, axis=-1, keepdims=True) for p in xb
                             for f in (jnp.mean, jnp.max)], axis=-1)
    assert _rel(pooled, jpool) <= BF16_OUT
    np.testing.assert_array_equal(_np(pooled)[..., 1::2], _np(jpool)[..., 1::2])

    w = port.packed_kernel()
    conv = cuda_conv.conv2d_same_small_cout_plain(pooled.float(), w.float(),
                                                  torch.zeros(2)).to(B16)
    ref = _conv_fwd_xla(jnp.asarray(_np(pooled)).astype(jnp.bfloat16),
                        jnp.asarray(_np(w)).astype(jnp.bfloat16), jnp.zeros(2, jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    assert _rel(conv, ref) <= BF16_OUT


# -- the LSTM -----------------------------------------------------------------

@pytest.mark.parametrize("bidir,with_state", [(True, False), (False, True)])
def test_complex_lstm_bf16_recurrence_matches_jax(bidir, with_state):
    """The bf16 recurrence (bf16 products rounded, float32 gates, h and c)
    against the JAX ``ComplexLSTM`` at ``dtype=bfloat16``: the bf16 output
    and the float32 state."""
    B, T, F, H, L = 2, 9, 6, 5, 2
    D = 2 if bidir else 1
    x = _pair((B, T, F), 11)
    xb = JC(*(jnp.asarray(p).astype(jnp.bfloat16) for p in x))
    state_np = None
    if with_state:
        rng = np.random.default_rng(12)
        state_np = tuple(tuple(rng.standard_normal((L * D, 2 * B, H)).astype(np.float32)
                               for _ in range(2)) for _ in range(2))
    mod = JaxComplexLSTM(H, L, bidir, dtype=jnp.bfloat16)
    jstate = None if state_np is None else jax.tree.map(jnp.asarray, state_np)
    v = jax.jit(mod.init)(jax.random.PRNGKey(7), xb, jstate)
    want, want_state = jax.jit(mod.apply)(v, xb, jstate)
    port = _load(ComplexLSTM(F, H, L, bidir, dtype=B16), v)
    tstate = None if state_np is None else tuple(
        tuple(torch.from_numpy(a) for a in s) for s in state_np)
    with torch.no_grad():
        got, got_state = port(CArray(*(torch.from_numpy(p).to(B16) for p in x)), tstate)
    assert got.re.dtype == B16
    assert max(_rel(got.re, want.re), _rel(got.im, want.im)) <= BAND
    for g, w in zip([t for s in got_state for t in s], jax.tree.leaves(want_state)):
        assert g.dtype == torch.float32 and _rel(g, w) <= BAND
    # float32 state, as the JAX carry: the bf16 path is not nn.LSTM at bf16
    f32 = _load(ComplexLSTM(F, H, L, bidir), v)
    with torch.no_grad():
        ref, _ = f32(_tc(x), tstate)
    assert _rel(ref.re, want.re) > BF16_OUT / 4


# -- the net and the enhance paths ---------------------------------------------

@pytest.fixture(scope="module")
def bf16_pair():
    """The narrow DCS in both packages at both types from one set of seeded
    weights (made by the port and moved to JAX, so no JAX init compiles; BN
    moved off its init), and JAX's bf16 and float32 results, all in one JAX
    compile: the bounded mask of a spectrogram, the full enhance and the
    grouped stream of one wave."""
    jcfg32 = _narrow(jax_config_for_variant("dcs"))
    tcfg32 = _narrow(config_for_variant("dcs"))
    jcfg16, tcfg16 = _cfg16(jcfg32), _cfg16(tcfg32)
    m32, m16 = JaxDCSNet(jcfg32.model, jcfg32.quirks), JaxDCSNet(jcfg16.model, jcfg16.quirks)
    rng = np.random.default_rng(2)
    spec = tuple(rng.standard_normal((2, 256, 16)).astype(np.float32) for _ in range(2))
    t = np.arange(2016) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220.0 * t)[None]
            + 0.05 * rng.standard_normal((2, 2016))).astype(np.float32)
    seeded = DCSNet(tcfg32.model, tcfg32.quirks, device="cpu", seed=0).state_dict()
    variables = jax.tree.map(jnp.asarray, _perturb(jax_from_params(seeded), 1))

    def both(v, s, w):
        out = {}
        for name, m, c in (("16", m16, jcfg16), ("32", m32, jcfg32)):
            out["mask" + name] = m.apply(v, s, train=False)
            out["full" + name] = jax_enhance_full(m, v, w, c)
            out["stream" + name] = jax_enhance_streaming(m, v, w, c, chunk_frames=32,
                                                         overlap=8, chunk_batch=2)
        return out

    want = jax.jit(both)(variables, _jc(spec), jnp.asarray(wave))
    port = DCSNet(tcfg16.model, tcfg16.quirks, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables), strict=True)
    return dict(tcfg16=tcfg16, tcfg32=tcfg32, port=port, spec=spec, wave=wave,
                want=jax.tree.map(_np, want), variables=variables)


def _narrow(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, channels=NARROW,
                                                 ca_reduction=4))


def _in_band(got, want16, want32, share):
    """Within ``share`` of JAX's own bf16 -> float32 distance (the largest
    elementwise difference) from JAX's bf16 result, and within 0.1
    absolute."""
    d_jax = float(np.abs(want16 - want32).max())
    d = float(np.abs(got - want16).max())
    assert np.all(np.isfinite(got)) and d_jax > 0
    assert d <= share * d_jax, (d, d_jax)
    assert d <= 0.1


def test_dcsnet_bf16_mask_in_band_of_jax(bf16_pair):
    """The bounded mask within twice JAX's own bf16 -> float32 distance of
    JAX's bf16 mask: two roundings of one net, each about that far from
    float32 (the triangle's bound). Not half of it, the band predicted: the
    JAX decoder rounds each phase's and input's product to bf16 and sums in
    bf16 (``dcs_net_tpu/ops/conv_engine.py:755-777``) where kernel 3 rounds
    once, so layer by layer the two bf16 nets stand about as far apart as
    each from float32 (the mask at 0.59 and 1.11 of it at two weight
    seeds)."""
    p, want = bf16_pair, bf16_pair["want"]
    with torch.no_grad():
        mask = p["port"](_tc(p["spec"]))
    assert mask.re.dtype == torch.float32       # the bound runs in float32
    for part in (0, 1):
        _in_band(_np(mask[part]), want["mask16"][part], want["mask32"][part], 2.0)
    # parameters stay float32: the checkpoint of a float32 run loads as is
    assert all(t.dtype == torch.float32 for t in p["port"].state_dict().values())


@pytest.mark.parametrize("path", ["full", "stream"])
def test_enhance_paths_bf16_in_band_of_jax(bf16_pair, path):
    p, want = bf16_pair, bf16_pair["want"]
    wave = torch.from_numpy(p["wave"])
    if path == "full":
        got = enhance_full(p["port"], wave, p["tcfg16"])
    else:
        got = enhance_streaming(p["port"], wave, p["tcfg16"], chunk_frames=32, overlap=8,
                                chunk_batch=2)
    assert got.dtype == torch.float32 and got.shape == (2, 2016)
    _in_band(_np(got), want[path + "16"], want[path + "32"], 0.5)


def test_enhance_paths_bf16_through_a_graph_cache_equal_eager(bf16_pair):
    """The graphed paths on the CPU are the eager ones (a GraphCache calls
    the function there); the cache keys by the config, which holds the
    operand type, so a float32 and a bf16 model of one shape never share an
    entry."""
    p = bf16_pair
    wave = torch.from_numpy(p["wave"])
    cache = GraphCache()
    torch.testing.assert_close(enhance_full(p["port"], wave, p["tcfg16"], graphs=cache),
                               enhance_full(p["port"], wave, p["tcfg16"]), rtol=0, atol=0)
    key16 = cache._key(enhance_full, (wave,), dict(model=p["port"], cfg=p["tcfg16"]))
    key32 = cache._key(enhance_full, (wave,), dict(model=p["port"], cfg=p["tcfg32"]))
    assert key16 != key32


def test_carried_stream_bf16_is_the_full_pass_when_chunk_local():
    """The streaming preset at bf16, chunk-local ops but the LSTM, no
    overlap: the carried stream is the full pass (the bf16 recurrence
    continues its float32 state across chunks; every other op sees the same
    values), within a few bf16 units of the waveform's peak."""
    cfg = _cfg16(config_for_variant("dcs", streaming=True))
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, channels=(1, 2, 2, 4, 4, 8, 8, 8), ca_reduction=2,
        kernel_e=(1,) * 7, kernel_d=(1,) * 7, sa_kernel=1, attention=False))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).eval()
    wave = torch.from_numpy((0.1 * np.random.default_rng(4).standard_normal((1, 4064))
                             ).astype(np.float32))
    full = enhance_full(model, wave, cfg)
    carried = enhance_streaming(model, wave, cfg, chunk_frames=32, overlap=0,
                                carry_lstm_state=True)
    assert _rel(carried, full) <= 4 * BF16_OUT


# -- the real family at bf16 (once refused) -------------------------------------

class _Loader:
    """Stands in for a data loader where a CLI's trainer is stubbed."""
    front_end = "stub"

    def close(self):
        pass


@pytest.mark.parametrize("cli", [cli_train, cli_tune], ids=["train", "tune"])
def test_training_clis_refuse_bf16(cli, tmp_path, monkeypatch):
    """Once a refusal, now run: the training CLIs parse ``drs --dtype
    bfloat16`` and their trainer builds the full-width DRS at bf16 (its
    layers', attention's and LSTM's operand type bf16, its parameters
    float32); the loaders and ``Trainer.fit`` are stubbed, so nothing
    trains."""
    built = []

    def fit(self, *a, **k):
        built.append(self.model)
        return {}

    monkeypatch.setattr(cli, "make_loaders", lambda cfg: (_Loader(), _Loader()))
    monkeypatch.setattr(Trainer, "fit", fit)
    extra = ["--trials", "1", "--trial-epochs", "1"] if cli is cli_tune else []
    cli.main(["drs", "--dtype", "bfloat16", "--device", "cpu", "--log-dir", str(tmp_path),
              *extra])
    (model,) = built
    assert model.cfg.compute_dtype == "bfloat16" and not model.cfg.complex_valued
    assert model.skip0_sa.dtype == model.lstm.dtype == model.fc.dtype == B16
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("cli,variant", [(cli_enhance, "dr"), (cli_test, "drs")],
                         ids=["enhance", "test"])
def test_serving_clis_refuse_the_real_variants_at_bf16(cli, variant, tmp_path, capsys):
    """Once a refusal, now run: ``cli.enhance dr --dtype bfloat16`` writes the
    enhanced wav, ``cli.test drs --dtype bfloat16`` evaluates a float32
    checkpoint to finite means and its CSV, each on the CPU at a narrow
    ``--config-json``."""
    cfg = _narrow(config_for_variant(variant))
    if cli is cli_enhance:
        src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
        wave = (0.1 * np.random.default_rng(7).standard_normal(4000)).astype(np.float32)
        write_wav(src, wave, 16000)
        path = tmp_path / "cfg.json"
        path.write_text(cfg.to_json())
        cli_enhance.main([variant, "--in", src, "--out", dst, "--config-json", str(path),
                          "--dtype", "bfloat16", "--device", "cpu"])
        got, sr = read_wav(dst)
        assert sr == 16000 and got.shape == (4000,) and np.all(np.isfinite(got))
        assert np.abs(got).max() > 0
        return
    root = str(tmp_path / "vb")
    synthetic.generate(root, n_train=4, n_test=2, seconds=0.6)
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout_conv=0.0, dropout_fc=0.0),
        data=dataclasses.replace(cfg.data, root=root, batch_size=2, num_workers=1),
        run=dataclasses.replace(cfg.run, log_dir=str(tmp_path / "logs"),
                                ckpt_dir=str(tmp_path / "ck")))
    trainer = Trainer(cfg, device="cpu", log_dir=str(tmp_path / "l32"), pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    trainer.save(CheckpointManager(cfg.run.ckpt_dir), 0)
    path = tmp_path / "cfg16.json"
    path.write_text(_cfg16(cfg).to_json())
    metrics = cli_test.main([variant, "--config-json", str(path), "--device", "cpu",
                             "--no-tensorboard"])
    assert "restored step 0" in capsys.readouterr().out
    assert all(np.isfinite(metrics[k]) for k in ("test_stoi", "test_loss"))
    assert os.path.exists(os.path.join(cfg.run.log_dir + "-test", "per_utterance.csv"))


@pytest.mark.parametrize("variant", ["dr", "drs"])
def test_real_variants_refuse_bf16(variant):
    """Once a refusal, now run: DR and DRS build at bf16 at full width with
    float32 parameters (a float32 checkpoint loads as is), and their
    forward gives a finite float32 mask of the input's shape."""
    cfg = _cfg16(config_for_variant(variant))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu").eval()
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    mag = torch.from_numpy(np.abs(np.random.default_rng(8).standard_normal(
        (1, 256, 16))).astype(np.float32))
    with torch.no_grad():
        mask = model(mag)
    assert mask.dtype == torch.float32 and mask.shape == (1, 256, 16)
    assert bool(torch.isfinite(mask).all())


def test_trainer_refuses_to_train_at_bf16(tmp_path):
    """Once a refusal, now run: ``init_state`` builds a DRS model at bf16,
    its parameters float32, ready to train."""
    cfg = _cfg16(config_for_variant("drs"))
    trainer = Trainer(cfg, device="cpu", log_dir=str(tmp_path), pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    assert trainer.model is not None and trainer.model.lstm.dtype == B16
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())


def _bf16(*shape, device="cpu", grad=False):
    return torch.zeros(shape, device=device, dtype=B16, requires_grad=grad)


@pytest.mark.parametrize("name,call,launched", [
    ("real pool", lambda d: cuda_conv.sa_pool_real(_bf16(1, 8, 8, 4, device=d)),
     "POOL_REAL_BF16"),
    ("real gate", lambda d: cuda_conv.sa_gate_real(
        _bf16(1, 8, 8, 2, device=d), _bf16(7, 7, 2, 1, device=d), _bf16(1, 8, 8, 4, device=d)),
     "GATE_REAL_BF16"),
    ("STFT under autograd", lambda d: tdsp.stft(
        torch.zeros(1, 4000, device=d, requires_grad=True), STFTConfig(dft_dtype="bfloat16")),
     None),
])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bf16_at_an_entry_without_a_bf16_class_raises(name, call, launched, device,
                                                     monkeypatch):
    """The bf16 STFT has no backward (the train step's waves take none): a
    bf16 STFT under autograd raises, on the CPU and off it (meta: the card's
    route, the kernels stubbed), and nothing is launched or cast to float32
    quietly. The real pool and gate, once refused here, have bf16 classes:
    on the CPU their plain versions give a bf16 output and launch nothing;
    off it each launches its bf16 class once and no float32 class."""
    names = ("KERNEL", "DGRAD", "POOL_REAL", "GATE_REAL", "POOL_REAL_BF16", "GATE_REAL_BF16")
    recs = {k: _Recorder(k) for k in names}
    for k, r in recs.items():
        monkeypatch.setattr(cuda_conv, k, r)
    trecs = [_Recorder(k) for k in ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK")]
    for r in trecs:
        monkeypatch.setattr(cuda_tapconv, r.name, r)
    if launched is None:
        with pytest.raises((TypeError, NotImplementedError)):
            call(device)
        assert all(r.launches == 0 for r in list(recs.values()) + trecs)
        return
    out = call(device)
    assert out.dtype == B16
    want = {} if device == "cpu" else {launched: 1}
    assert {k: r.launches for k, r in recs.items() if r.launches} == want
    assert all(r.launches == 0 for r in trecs)


def _record(monkeypatch):
    """Recorders in place of every conv-entry and tap-conv kernel, float32
    and bf16 classes: name -> recorder."""
    recs = {}
    for mod, names in ((cuda_conv, ("KERNEL", "DGRAD", "KERNEL_BF16", "DGRAD_BF16")),
                       (cuda_tapconv, ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK",
                                       "KERNEL_BF16", "KERNEL_BF16_TAP", "PACK_BF16",
                                       "DGRAD_BF16", "DGRAD_BF16_TAP", "DGRAD_PACK_BF16",
                                       "DGRAD_NARROW_BF16"))):
        for k in names:
            recs[f"{mod.__name__.rsplit('.', 1)[1]}.{k}"] = r = _Recorder(k)
            monkeypatch.setattr(mod, k, r)
    return recs


def _entry_case(entry, device):
    """(inputs that autograd follows, the entry's output, the bf16 kernels
    its forward and backward launch off the CPU) of one of training's bf16
    classes: the conv entry at the gate's class (7, 4, 2), whose input
    gradient is class (7, 2, 4); the conv entry at the real gate's class
    (7, 2, 1), whose input gradient is class (7, 1, 2); and kernel 3 at
    dec1's (x padded by one pixel), whose input gradient is the tap conv's
    bf16 input-gradient class."""
    rng = np.random.default_rng(21)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            device=device, dtype=B16).requires_grad_()

    if entry in ("conv entry", "real conv entry"):
        cin, cout = (4, 2) if entry == "conv entry" else (2, 1)
        x, w = t(2, 8, 12, cin), t(7, 7, cin, cout)
        y = cuda_conv.conv2d_same_small_cout(x, w, cuda_conv.zero_bias(cout, x.device))
        return (x, w), y, {"cuda_conv.KERNEL_BF16": 1, "cuda_conv.DGRAD_BF16": 1}
    x, w = t(2, 4, 251, 32), t(9, 32, 64)
    y = cuda_tapconv.tapconv_valid(x, w, 3, 3, (1, 1, 1, 1))
    return (x, w), y, {"cuda_tapconv.KERNEL_BF16": 1, "cuda_tapconv.PACK_BF16": 1,
                       "cuda_tapconv.DGRAD_BF16": 1}


@pytest.mark.parametrize("entry", ["conv entry", "tap conv", "real conv entry"])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_bf16_entry_takes_its_bf16_class_in_both_directions(entry, device, monkeypatch):
    """Training's entries at bf16 under autograd: the conv entry (its bf16
    class forward, the input gradient's class (7, 2, 4) backward; at the
    real class (7, 2, 1), (7, 1, 2) backward) and the
    tap conv (its bf16 forward, the bf16 input-gradient class backward) give
    bf16 outputs and bf16 gradients of x and w. On the CPU they run their
    plain versions and launch nothing; off it (meta: the card's route, the
    kernels stubbed) each bf16 class once, and nothing of a float32 class."""
    recs = _record(monkeypatch)
    inputs, y, want = _entry_case(entry, device)
    assert y.dtype == B16 and y.requires_grad
    grads = torch.autograd.grad(y, inputs, torch.ones_like(y))
    assert all(g.dtype == B16 and g.shape == i.shape for g, i in zip(grads, inputs))
    got = {k: r.launches for k, r in recs.items() if r.launches}
    assert got == ({} if device == "cpu" else want)


def test_tapconv_input_gradient_bf16_launch_takes_its_class(monkeypatch):
    """The input gradient's entry (the card's route: meta here) takes bf16 g
    and w through its bf16 class, never a float32 cast: the staged body on
    g, padded by the window less the forward's padding, reading the
    forward's packing of w (16-channel chunks of its Cin, N tiles of its
    N), which a caller without the forward's packs with the forward's own
    packing kernel; a bf16 dx of x's pixels; float32 takes the float32
    entry."""
    recs = _record(monkeypatch)
    seen = {}

    def pack(dev, w, wp, taps, cin, n, bn, kb):
        seen["pack"] = (taps, cin, n, bn, kb)
        recs["cuda_tapconv.PACK_BF16"].launches += 1

    monkeypatch.setattr(cuda_tapconv, "PACK_BF16", pack)
    g, w = _bf16(2, 4, 251, 64, device="meta"), _bf16(9, 32, 64, device="meta")
    dx = cuda_tapconv._launch_dgrad(g, w, 3, 3, (1, 1, 1, 1), (4, 251))
    assert dx.dtype == B16 and dx.shape == (2, 4, 251, 32)
    assert seen["pack"] == (9, 32, 64, 64, cuda_tapconv.STAGED_KB)
    assert cuda_tapconv.dgrad_pad_bf16((1, 1, 1, 1), 3, 3) == (1, 1, 1, 1)
    assert cuda_tapconv.dgrad_pad_bf16((0, 2, 1, 1), 3, 3) == (2, 0, 1, 1)
    with pytest.raises(ValueError, match="window"):
        cuda_tapconv.dgrad_pad_bf16((3, 0, 0, 0), 3, 3)
    got = {k: r.launches for k, r in recs.items() if r.launches}
    assert got == {"cuda_tapconv.DGRAD_BF16": 1, "cuda_tapconv.PACK_BF16": 1}
    # on the forward's packing: the body alone
    cuda_tapconv._launch_dgrad(g, w, 3, 3, (1, 1, 1, 1), (4, 251),
                               (_bf16(1, 2, 9, 2, 64, 8, device="meta"), 64, 16))
    got = {k: r.launches for k, r in recs.items() if r.launches}
    assert got == {"cuda_tapconv.DGRAD_BF16": 2, "cuda_tapconv.PACK_BF16": 1}
    f32 = cuda_tapconv._launch_dgrad(g.float(), w.float(), 3, 3, (1, 1, 1, 1), (4, 251))
    assert f32.dtype == torch.float32
    assert recs["cuda_tapconv.DGRAD"].launches == recs["cuda_tapconv.DGRAD_PACK"].launches == 1


def test_conv_entry_bf16_launch_refuses_a_class_without_a_tiled_body(monkeypatch):
    """The conv entry's bf16 class has the tensor-core body at the tiled
    classes only (the complex and the real ones): any other class at bf16
    ((7, 2, 2), or 3 x 3) raises off the CPU and launches nothing; the CPU's
    plain version takes every class, its float32 sums rounded once."""
    recs = _record(monkeypatch)
    for shape in ((7, 7, 2, 2), (3, 3, 4, 2)):
        x = _bf16(1, 8, 8, shape[2], device="meta")
        with pytest.raises(ValueError, match="bf16 class"):
            cuda_conv.conv2d_same_small_cout(x, _bf16(*shape, device="meta"),
                                             torch.zeros(shape[3], device="meta"))
        y = cuda_conv.conv2d_same_small_cout(_bf16(1, 8, 8, shape[2]), _bf16(*shape),
                                             torch.zeros(shape[3]))
        assert y.dtype == B16
    assert all(r.launches == 0 for r in recs.values())


# -- the serving CLIs ---------------------------------------------------------

def test_build_config_sets_both_operand_types():
    """``--dtype`` sets ``compute_dtype`` and ``dft_dtype``, as the JAX
    ``build_config`` does."""
    p = argparse.ArgumentParser()
    add_common_args(p)
    cfg = build_config(p.parse_args(["dcs", "--dtype", "bfloat16", "--log-dir", "x"]))
    assert (cfg.model.compute_dtype, cfg.stft.dft_dtype) == ("bfloat16", "bfloat16")
    cfg = build_config(p.parse_args(["dcs", "--log-dir", "x"]))
    assert (cfg.model.compute_dtype, cfg.stft.dft_dtype) == ("float32", "float32")


@pytest.mark.parametrize("flags,streaming", [
    ([], False), (["--stream", "--chunk-frames", "32"], False),
    (["--carry", "--chunk-frames", "32"], True)], ids=["full", "stream", "carry"])
def test_enhance_cli_serves_a_float32_checkpoint_at_bf16(flags, streaming, tmp_path, capsys):
    """``cli.enhance --dtype bfloat16`` on a float32 checkpoint (its config
    saved beside it, float32): the wav it writes is the bf16 model's
    ``enhance_full`` / ``enhance_streaming`` of the same weights."""
    cfg32 = _narrow(config_for_variant("dcs", streaming=streaming))
    cfg32 = cfg32.replace(run=dataclasses.replace(cfg32.run, ckpt_dir=str(tmp_path / "ck")))
    trainer = Trainer(cfg32, device="cpu", log_dir=str(tmp_path / "logs"),
                      pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    trainer.save(CheckpointManager(cfg32.run.ckpt_dir), 0)
    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.wav")
    wave = (0.1 * np.random.default_rng(5).standard_normal(4000)).astype(np.float32)
    write_wav(src, wave, 16000)
    cli_enhance.main(["dcs", "--in", src, "--out", dst, "--ckpt-dir", cfg32.run.ckpt_dir,
                      "--device", "cpu", "--dtype", "bfloat16", *flags])
    got, sr = read_wav(dst)
    cfg16 = _cfg16(cfg32)
    model = DCSNet(cfg16.model, cfg16.quirks, device="cpu").eval()
    model.load_state_dict(trainer.model.state_dict())
    x = torch.from_numpy(read_wav(src)[0])[None]
    if flags:
        want = enhance_streaming(model, x, cfg16, chunk_frames=32,
                                 overlap=0 if streaming else 8, carry_lstm_state=streaming)
    else:
        want = enhance_full(model, x, cfg16)
    assert sr == 16000 and got.shape == (4000,)
    np.testing.assert_allclose(got, want[0].numpy(), atol=1.0 / 2 ** 15 + 1e-9)


def test_test_cli_evaluates_at_bf16(tmp_path, capsys):
    """``cli.test`` on a float32 checkpoint with a bf16 config: the test
    pass runs (batch 1, the bf16 STFT, net and iSTFT) to finite means."""
    root = str(tmp_path / "vb")
    synthetic.generate(root, n_train=4, n_test=2, seconds=0.6)
    cfg = _narrow(config_for_variant("dcs"))
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dropout_conv=0.0, dropout_fc=0.0),
        data=dataclasses.replace(cfg.data, root=root, batch_size=2, num_workers=1),
        run=dataclasses.replace(cfg.run, log_dir=str(tmp_path / "logs"),
                                ckpt_dir=str(tmp_path / "ck")))
    trainer = Trainer(cfg, device="cpu", log_dir=str(tmp_path / "l32"), pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    trainer.save(CheckpointManager(cfg.run.ckpt_dir), 0)
    path = tmp_path / "cfg16.json"
    path.write_text(_cfg16(cfg).to_json())
    metrics = cli_test.main(["dcs", "--config-json", str(path), "--device", "cpu",
                             "--no-tensorboard"])
    assert "restored step 0" in capsys.readouterr().out
    assert {"test_stoi", "test_loss"} <= set(metrics)
    assert all(np.isfinite(metrics[k]) for k in ("test_stoi", "test_loss"))
    assert os.path.exists(os.path.join(cfg.run.log_dir + "-test", "per_utterance.csv"))
    assert isinstance(Config.from_json(path.read_text()), Config)
