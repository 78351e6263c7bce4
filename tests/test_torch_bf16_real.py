"""The real family (DR, DRS) at ``compute_dtype = dft_dtype = "bfloat16"``
against the JAX package at the same setting, on the CPU (the kernels' plain
versions), with the JAX weights moved by ``convert.py``.

One JAX compile: every JAX function the file compares is traced into one
jitted call (the module fixture ``jres``), the JAX decoder in its unified
form (``conv_engine.UNIFIED_UPDOT``, whose tap conv is the Pallas kernel
kernel 3 ports; nothing in the JAX package changes).

Bands, the bf16 serving path's (``test_torch_bf16.py``):
* ``enhance_full`` of narrow three-layer DR and DRS: the waveform within
  half of JAX's own bf16 -> float32 distance from JAX's bf16 result and
  within 0.1; the mask within twice that distance;
* each new class's plain version against its JAX rule, and the real conv,
  convT and linear layers at bf16: 2^-7 of the largest value (the same exact
  bf16 products summed in float32 in another order, one bf16 unit apart at
  most); the real dropout at bf16 (``x / keep`` in bf16, the masks injected
  into both) bit for bit;
* the real gate and the LSTM at bf16: 2^-6 of the largest value (XLA on the
  CPU may round its fused bf16 elementwise ops at other points).
Then the CPU models of the new kernel classes (the conv entry's bf16 class
at the real classes on its tensor-core body, at forced tiles; the real
gate's rounding points and its product's walk over 16-byte words of 8
bf16), the routing of a narrow DRS net at bf16 on meta tensors, and kernel
3's bf16 bodies and plans at the full DRS decoder's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.models.enhance import enhance_full as jax_enhance_full
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.ops import attention as jatt
from dcs_net_tpu.ops import conv_engine as jax_conv_engine
from dcs_net_tpu.ops import real_layers as jrl
from dcs_net_tpu.ops import widen
from dcs_net_tpu.ops.lstm import LSTM as JaxLSTM
from dcs_net_tpu.ops.pallas_conv import _bwd as jax_conv_bwd
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_pallas

from dcs_net_tpu_torch.convert import jax_from_params
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.models.enhance import enhance_full
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import attention, cuda_conv, cuda_tapconv
from dcs_net_tpu_torch.ops import real_layers as rl
from dcs_net_tpu_torch.ops.lstm import LSTM
from dcs_net_tpu_torch.tools.time_gate import sites

from test_torch_conv import _tiled_conv_model
from test_torch_real import BATCH, FRAMES, NARROW, _narrow, _np, _perturb, _wave
from test_torch_train import _one_torch_thread  # noqa: F401

B16 = torch.bfloat16
BF16_OUT = 2.0 ** -7       # a bf16 output against its plain version or JAX
BAND = 2.0 ** -6           # the gate and the LSTM against JAX's rounding points
KEEP = 0.9                 # the dropout's keep rate (DCS-Net's conv dropout 0.1)


def _cfg16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                       stft=dataclasses.replace(cfg.stft, dft_dtype="bfloat16"))


def _f32(t) -> np.ndarray:
    """A torch, JAX or numpy array as float32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(got, want) -> float:
    """max |got - want| / max |want|, in float32."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _b16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).to(B16)


def _jb16(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _variables(module: torch.nn.Module, name: str) -> dict:
    """A port layer's weights as its JAX layer's variables (``name`` ends in
    ``_convt`` for a transposed conv, whose kernel the converter flips)."""
    tree = jax_from_params({f"{name}.{k}": v for k, v in module.state_dict().items()})
    return {"params": jax.tree.map(jnp.asarray, tree["params"][name])}


def _layers():
    """The port's real layers at bf16 with seeded weights, and the inputs
    (numpy, float32; the layers round them to bf16): name -> (port module,
    its JAX module, JAX variables, inputs)."""
    g = torch.Generator().manual_seed(5)
    out = {}
    conv = rl.Conv2d(4, 6, 5, stride=(2, 1), padding=2, generator=g, dtype=B16)
    out["conv"] = (conv, jrl.Conv2d(6, 5, stride=(2, 1), padding=2, dtype=jnp.bfloat16),
                   _variables(conv, "conv"), (_np((2, 16, 12, 4), 21),))
    convt = rl.ConvTranspose2d(7, 5, 3, padding=1, upsample=(2, 2), generator=g, dtype=B16)
    out["convt"] = (convt, jrl.ConvTranspose2d(5, 3, padding=1, upsample=(2, 2),
                                              dtype=jnp.bfloat16),
                    _variables(convt, "dec_convt"),
                    (_np((2, 5, 6, 3), 22), _np((2, 5, 6, 4), 23)))
    lin = rl.Linear(12, 10, generator=g, dtype=B16)
    out["linear"] = (lin, jrl.Linear(10, dtype=jnp.bfloat16), _variables(lin, "fc"),
                     (_np((2, 9, 12), 24),))
    sa = attention.RealSpatialAttention(7, generator=g, dtype=B16)
    out["gate"] = (sa, jatt.RealSpatialAttention(7, dtype=jnp.bfloat16),
                   _variables(sa, "sa"), (_np((2, 16, 12, 6), 25),))
    return out


LSTM_CASES = {"bidir": (True, False), "stream": (False, True)}   # bidirectional, state


def _lstms():
    """name -> (port LSTM at bf16, its JAX LSTM, variables, x (B, T, F), the
    state or None): two layers, bidirectional without a state, and the
    streaming form (unidirectional) with a carried float32 state."""
    out = {}
    for i, (name, (bidir, with_state)) in enumerate(LSTM_CASES.items()):
        port = LSTM(6, 5, 2, bidir, generator=torch.Generator().manual_seed(30 + i),
                    dtype=B16)
        d = 2 if bidir else 1
        state = (tuple(_np((2 * d, 3, 5), 32 + i + k) for k in range(2))
                 if with_state else None)
        out[name] = (port, JaxLSTM(5, 2, bidir, dtype=jnp.bfloat16),
                     _variables(port, "lstm"), _np((3, 9, 6), 31 + i), state)
    return out


class _Ints:
    """Stands in for a CudaKernel: notes the integer arguments of each
    launch (its shape and tile), launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(tuple(a for a in args if isinstance(a, int)))


def _masks(shape, seed):
    return np.random.default_rng(seed).random(shape) < KEEP


@pytest.fixture(scope="module")
def jres():
    """Every JAX result the file compares, in one compile: narrow DR and DRS
    at bf16 and float32 from the port's seeded weights (BN off its init):
    the mask of a magnitude and ``enhance_full`` of a wave; the real layers
    at bf16; the real pool, the Pallas conv at (7, 2, 1) in interpret mode
    and ``_bwd``'s input gradient at bf16; the LSTM at bf16; the dropout at
    bf16 on injected masks."""
    cfgs = {v: (_narrow(jax_config_for_variant(v)), _narrow(config_for_variant(v)))
            for v in ("dr", "drs")}
    weights = _perturb(DCSNet(cfgs["drs"][1].model, cfgs["drs"][1].quirks, device="cpu",
                              seed=0).state_dict(), 1)
    variables = jax.tree.map(jnp.asarray, jax_from_params(weights))
    models = {(v, t): JaxDCSNet(c.model, c.quirks)
              for v, (jc, _) in cfgs.items()
              for t, c in (("16", _cfg16(jc)), ("32", jc))}
    mag = np.abs(_np((BATCH, 256, FRAMES), 4)) + 0.01
    wave = _wave(3008, 5)
    layers, lstms = _layers(), _lstms()
    pooled_in = _np((2, 16, 20, 2), 40)
    w_sa = _np((7, 7, 2, 1), 41, 0.3)
    g_sa = _np((2, 16, 20, 1), 42)
    x_pool = _np((2, 9, 13, 24), 43)
    x_drop = _np((2, 8, 6, 5), 44)
    drop_mask = _masks(x_drop.shape, 45)

    def run(v, mag, wave):
        out = {}
        for (variant, t), m in models.items():
            c = _cfg16(cfgs[variant][0]) if t == "16" else cfgs[variant][0]
            out[f"full_{variant}{t}"] = jax_enhance_full(m, v, wave, c)
            if variant == "drs":
                out[f"mask{t}"] = m.apply(v, mag, train=False)
        for name, (_, mod, lv, ins) in layers.items():
            xs = tuple(_jb16(a) for a in ins)
            if name == "gate":
                out[name] = widen.mul_bcast(xs[0], mod.apply(lv, xs[0]))
            else:
                out[name] = mod.apply(lv, xs if name == "convt" else xs[0])
        for name, (_, mod, lv, x, state) in lstms.items():
            st = None if state is None else tuple(jnp.asarray(s) for s in state)
            out["lstm_" + name] = mod.apply(lv, _jb16(x), st)
        xb = _jb16(x_pool)
        out["pool"] = jnp.concatenate([jnp.mean(xb, axis=-1, keepdims=True),
                                       jnp.max(xb, axis=-1, keepdims=True)], axis=-1)
        out["conv_721"] = _conv_fwd_pallas(_jb16(pooled_in), _jb16(w_sa),
                                           jnp.zeros(1, jnp.bfloat16), interpret=True)
        out["dgrad_712"] = jax_conv_bwd((_jb16(pooled_in), _jb16(w_sa)),
                                        jnp.asarray(g_sa))[0]
        out["dropout"] = jrl.Dropout(1.0 - KEEP).apply(
            {}, _jb16(x_drop), train=True, rngs={"dropout": jax.random.PRNGKey(0)})
        return out

    def injected(key, p, shape):
        return jnp.asarray(drop_mask.reshape(shape))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_conv_engine, "UNIFIED_UPDOT", True)
        mp.setattr(jax.random, "bernoulli", injected)
        want = jax.jit(run)(variables, jnp.asarray(mag), jnp.asarray(wave))
    return dict(cfgs=cfgs, weights=weights, mag=mag, wave=wave, layers=layers,
                lstms=lstms, pooled_in=pooled_in, w_sa=w_sa, g_sa=g_sa, x_pool=x_pool,
                x_drop=x_drop, drop_mask=drop_mask, want=want)


def _port16(cfg, weights):
    c16 = _cfg16(cfg)
    model = DCSNet(c16.model, c16.quirks, device="cpu").eval()
    model.load_state_dict(weights, strict=True)
    return model, c16


def _in_band(got, want16, want32, share):
    """Within ``share`` of JAX's own bf16 -> float32 distance (the largest
    elementwise difference) from JAX's bf16 result, and within 0.1."""
    got, want16, want32 = _f32(got), _f32(want16), _f32(want32)
    d_jax = float(np.abs(want16 - want32).max())
    d = float(np.abs(got - want16).max())
    print(f"\n{d / d_jax:.3f} of JAX's own distance ({d:.3e} / {d_jax:.3e})")
    assert np.all(np.isfinite(got)) and d_jax > 0
    assert d <= share * d_jax, (d, d_jax)
    assert d <= 0.1


# -- the nets ------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["dr", "drs"])
def test_enhance_full_bf16_in_band_of_jax(jres, variant):
    """Narrow DR and DRS at bf16: the enhanced waveform within half of JAX's
    own bf16 -> float32 distance of JAX's bf16 result, and within 0.1; the
    parameters stay float32 (a float32 checkpoint serves as it is)."""
    model, c16 = _port16(jres["cfgs"][variant][1], jres["weights"])
    got = enhance_full(model, torch.from_numpy(jres["wave"]), c16)
    assert got.dtype == torch.float32 and got.shape == (BATCH, 3008)
    w = jres["want"]
    _in_band(got, w[f"full_{variant}16"], w[f"full_{variant}32"], 0.5)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())


def test_mask_bf16_in_band_of_jax(jres):
    """The DRS mask at bf16 (its output sigmoid in float32) within twice
    JAX's own bf16 -> float32 distance of JAX's bf16 mask."""
    model, _ = _port16(jres["cfgs"]["drs"][1], jres["weights"])
    with torch.no_grad():
        mask = model(torch.from_numpy(jres["mag"]))
    assert mask.dtype == torch.float32
    _in_band(mask, jres["want"]["mask16"], jres["want"]["mask32"], 2.0)


# -- the layers ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["conv", "convt", "linear"])
def test_real_layers_at_bf16_match_jax(jres, name):
    """The real conv (strided: ``F.conv2d``), convT (two inputs, upsample (2,
    2): kernel 3) and linear layers at bf16: bf16 operands, float32 sums, the
    bias rounded and added in bf16; a bf16 output within 2^-7."""
    port, _, _, ins = jres["layers"][name]
    xs = [_b16(a) for a in ins]
    with torch.no_grad():
        got = port(xs if name == "convt" else xs[0])
    assert got.dtype == B16
    assert _rel(got, jres["want"][name]) <= BF16_OUT


def test_real_dropout_at_bf16_is_jax_bit_for_bit(jres, monkeypatch):
    """The real dropout at bf16 on the same mask (injected into both): x
    divided by the keep rate rounded to bf16, as JAX's ``x / keep`` (its
    Python ``keep`` takes x's type), bit for bit; the float32 path still
    multiplies by the float32 mask."""
    mask = torch.from_numpy(jres["drop_mask"])
    monkeypatch.setattr(rl, "dropout_mask",
                        lambda shape, like, rate, gen: mask.to(like.dtype) / (1 - rate))
    drop = rl.Dropout(1.0 - KEEP)
    x = _b16(jres["x_drop"])
    got = drop(x)
    assert got.dtype == B16
    np.testing.assert_array_equal(_f32(got), _f32(jres["want"]["dropout"]))
    # dividing by 0.9 itself rounds a third of them to the other neighbour
    assert _f32((x.float() / KEEP).to(B16) * mask).tolist() != _f32(got).tolist()
    x32 = torch.from_numpy(jres["x_drop"])
    torch.testing.assert_close(drop(x32), x32 * (mask / KEEP), rtol=0, atol=0)


@pytest.mark.parametrize("name", list(LSTM_CASES))
def test_lstm_bf16_recurrence_matches_jax(jres, name):
    """The LSTM at bf16 (the recurrence shared with the complex LSTM: bf16
    products rounded, float32 gates, h and c) against the JAX ``LSTM`` at
    ``dtype=bfloat16``: the bf16 output and the float32 state within 2^-6;
    bidirectional over two layers, and the streaming form with a carried
    state."""
    port, _, _, x, state = jres["lstms"][name]
    st = None if state is None else tuple(torch.from_numpy(s) for s in state)
    with torch.no_grad():
        out, (h, c) = port(_b16(x), st)
    want, (wh, wc) = jres["want"]["lstm_" + name]
    assert out.dtype == B16 and h.dtype == c.dtype == torch.float32
    for g, w in ((out, want), (h, wh), (c, wc)):
        assert _rel(g, w) <= BAND
    # float32 is nn.LSTM, another function at this band
    f32 = LSTM(6, 5, 2, port.bidirectional)
    f32.load_state_dict(port.state_dict())
    with torch.no_grad():
        ref, _ = f32(torch.from_numpy(x), st)
    assert _rel(ref, want) > BF16_OUT / 4


# -- kernel 2's new classes ---------------------------------------------------

def test_real_pool_bf16_plain_matches_jax(jres):
    """The real pool's bf16 class, plain: the mean summed in float32 and
    rounded once (within 2^-7 of JAX's), the max exact."""
    got = cuda_conv.sa_pool_real(_b16(jres["x_pool"]))
    want = jres["want"]["pool"]
    assert got.dtype == B16 and got.shape == (2, 9, 13, 2)
    assert _rel(got, want) <= BF16_OUT
    np.testing.assert_array_equal(_f32(got)[..., 1], _f32(want)[..., 1])


def test_real_conv_bf16_plain_matches_the_pallas_conv(jres):
    """The conv entry's bf16 class at (7, 2, 1), plain, against the Pallas
    conv in interpret mode at bf16; its input gradient's class (7, 1, 2)
    against the dx of the JAX ``_bwd`` at bf16."""
    x, w = _b16(jres["pooled_in"]), _b16(jres["w_sa"])
    got = cuda_conv.conv2d_same_small_cout(x, w, torch.zeros(1))
    assert got.dtype == B16 and _rel(got, jres["want"]["conv_721"]) <= BF16_OUT
    dx = cuda_conv.conv2d_same_small_cout_dgrad_bf16_plain(
        torch.from_numpy(jres["g_sa"]), w.float())
    assert dx.dtype == B16 and dx.shape == (2, 16, 20, 2)
    assert _rel(dx, jres["want"]["dgrad_712"]) <= BF16_OUT


def test_real_gate_bf16_matches_jax_attention_then_product(jres):
    """The real gate at bf16 (the module's, plain pool and gate, and the
    un-fused form under autograd) against the JAX real spatial attention at
    bf16 followed by ``widen.mul_bcast``, within 2^-6; the packed kernel is
    rounded to bf16 once, and the fused and un-fused forms agree."""
    sa, _, _, (x,) = jres["layers"]["gate"]
    xb = _b16(x)
    want = jres["want"]["gate"]
    with torch.no_grad():
        got = sa.gate(xb)
        w = sa.packed_kernel()
    assert got.dtype == w.dtype == B16 and w.shape == (7, 7, 2, 1)
    assert sa.packed_kernel() is w
    plain = cuda_conv.spatial_gate_real_plain(xb, w)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert _rel(got, want) <= BAND
    xg = xb.clone().requires_grad_(True)
    unfused = sa.gate(xg)
    assert unfused.grad_fn is not None and unfused.dtype == B16
    assert _rel(unfused, want) <= BAND and _rel(unfused, got) <= BF16_OUT


def _bf16_np(a: np.ndarray) -> np.ndarray:
    """float32 numpy rounded to bf16 (nearest even), as float32."""
    return _b16(np.ascontiguousarray(a, np.float32)).float().numpy()


def _tap_words(w: torch.Tensor) -> np.ndarray:
    """The tiled body's view of a bf16 kernel (7, 7, Cin, Cout): a tap's Cin
    Cout weights as words of ``tap_word_bytes`` bytes, read by word index
    from the flat buffer, widened exactly; back as (7, 7, Cin, Cout)."""
    K, _, cin, cout = w.shape
    per_word = cuda_conv.tap_word_bytes(cin, cout, 2) // 2
    flat = w.contiguous().view(-1).float().numpy()
    words = flat.reshape(K * K, (cin * cout) // per_word, per_word)
    return words.reshape(w.shape)


@pytest.mark.parametrize("shape,tile", [
    ((1, 5, 11, 2), (2, 32, 4)),
    ((2, 3, 9, 2), (16, 32, 8)),
    ((1, 9, 41, 2), (4, 64, 4)),       # two column tasks, one past the image
    ((1, 4, 3, 2), (1, 32, 4)),        # W below one product's span
    ((1, 5, 11, 1), (2, 64, 2)),       # the input gradient's class (7, 1, 2)
    ((2, 9, 41, 1), (8, 128, 8)),
    ((1, 18, 70, 1), (16, 64, 4)),
])
def test_conv_entry_bf16_model_at_the_real_classes(shape, tile):
    """The conv entry's bf16 class at (7, 2, 1) and (7, 1, 2): the
    tensor-core body's model (``test_torch_conv7_mma_bf16.mma_model``: x
    staged as 4-byte words, one pixel at Cin 2, two at Cin 1; w read as it
    lies into the B table; float32 sums of each m16n8k16 product) at forced
    tiles, the float32 bias added and each output rounded once: the same as
    the class's plain version within a bf16 unit, every output stored once;
    the entry asks x to lie on its pixel only (2 Cin bytes)."""
    from test_torch_conv7_mma_bf16 import mma_model

    cin = shape[-1]
    cout = 3 - cin
    assert cuda_conv.mma_fits(*shape[:3], cin, cout, tile)
    m = cuda_conv.mma_class(cin, cout)
    assert (m.px, m.sc * m.sr * cout) == (2 if cin == 1 else 1, 8)
    x, w = _b16(_np(shape, 60)), _b16(_np((7, 7, cin, cout), 61, 0.2))
    b = _np((cout,), 62)
    got, stores = mma_model(x, w, b, tile)
    want = cuda_conv.conv2d_same_small_cout_bf16_plain(x, w, torch.from_numpy(b))
    assert (stores == 1).all()
    assert _rel(got, want) <= BF16_OUT


def _real_gate_bf16_model(x, pooled, w, tile, vec):
    """sa_gate_real_kernel's bf16 class in numpy: the tiled conv (float32
    sums), rounded to bf16; its sigmoid rounded to bf16; then the block's
    128 threads walk the tile's rows_v x cols_v pixels as words (16-byte
    words of 8 bf16 where vec, else single bf16), word e of the tile at row
    e // n, word i = e % n of that row, whose pixel is i >> shift (or i //
    nv); each product rounded once. Every word written exactly once."""
    R, TX, TY = tile
    B, H, W, C = x.shape
    tw = R * TX
    conv = _bf16_np(_tiled_conv_model(pooled, w, np.zeros(1, np.float32), tile)[..., 0])
    a = _bf16_np(1.0 / (1.0 + np.exp(-conv)))
    nv = C // 8 if vec else C
    shift = nv.bit_length() - 1 if nv & (nv - 1) == 0 else -1
    words = x.reshape(-1, 8) if vec else x.reshape(-1, 1)
    out = np.full_like(words, np.nan)
    writes = np.zeros(len(words), np.int64)
    for b in range(B):
        for h0 in range(0, H, TY):
            for w0 in range(0, W, tw):
                hv, wv = min(TY, H - h0), min(tw, W - w0)
                n = wv * nv
                pix0 = (b * H + h0) * W + w0
                for tid in range(cuda_conv.BLOCK_THREADS):
                    for e in range(tid, hv * n, cuda_conv.BLOCK_THREADS):
                        row, i = divmod(e, n)
                        px = i >> shift if shift >= 0 else i // nv
                        k = (pix0 + row * W) * nv + i
                        out[k] = _bf16_np(words[k] * a[b, h0 + row, w0 + px])
                        writes[k] += 1
    assert (writes == 1).all()
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape,tile,vec", [
    ((2, 5, 11, 24), (2, 4, 2), True),      # 3 words a pixel: no shift
    ((2, 5, 11, 12), (2, 4, 2), False),     # C no multiple of 8
    ((1, 3, 9, 16), (4, 2, 1), True),       # one-row tile, shift 1
    ((2, 4, 20, 1), (8, 2, 2), False),      # C = 1, R = 8
    ((1, 2, 9, 256), (2, 4, 1), True),      # a small site's depth
])
def test_real_gate_bf16_model_matches_plain(shape, tile, vec):
    """The real gate's bf16 class, indexing and rounding points (the conv's
    float32 sums rounded, the sigmoid rounded, the product rounded once),
    equals ``sa_gate_real_bf16_plain`` within a bf16 unit of the largest
    value; the pooled map from the bf16 pool's plain version."""
    x = _b16(_np(shape, 63))
    pooled = cuda_conv.sa_pool_real(x)
    w = _b16(_np((7, 7, 2, 1), 64, 0.3))
    want = cuda_conv.sa_gate_real(pooled, w, x)
    assert want.dtype == B16
    got = _real_gate_bf16_model(x.float().numpy(), pooled.float().numpy(),
                                _tap_words(w), tile, vec)
    assert _rel(got, want) <= BF16_OUT


def test_real_entries_take_their_bf16_classes_on_meta(monkeypatch):
    """Off the CPU (meta: the card's route, the kernels stubbed) a bf16 x
    takes the real pool's and gate's bf16 classes, with a bf16 pooled map
    and output, and the conv entry's bf16 class at (7, 2, 1) and (7, 1, 2)
    on the tiled tile; nothing of a float32 class. The gate checks the
    words of pooled and w (4 bytes) and refuses a float32 operand beside a
    bf16 x."""
    recs = {}
    for name in ("KERNEL", "DGRAD", "POOL_REAL", "GATE_REAL", "KERNEL_BF16",
                 "DGRAD_BF16", "POOL_REAL_BF16", "GATE_REAL_BF16"):
        recs[name] = _Ints()
        monkeypatch.setattr(cuda_conv, name, recs[name])
    x = torch.empty((2, 8, 20, 16), device="meta", dtype=B16)
    w = torch.empty((7, 7, 2, 1), device="meta", dtype=B16)
    out = cuda_conv.spatial_gate_real(x, w)
    assert out.dtype == B16 and out.shape == x.shape
    assert recs["POOL_REAL_BF16"].calls == [(2, 8, 20, 16)]
    assert recs["GATE_REAL_BF16"].calls == [(2, 8, 20, 16) + cuda_conv.gate_tile(2, 8, 20, 2, 1)]
    pooled = torch.empty((2, 8, 20, 2), device="meta", dtype=B16)
    y = cuda_conv.conv2d_same_small_cout(pooled, w, torch.zeros(1, device="meta"))
    dx = cuda_conv._same_conv(y, cuda_conv.dgrad_kernel(w), torch.zeros(2, device="meta"),
                              dgrad=True)
    assert y.dtype == dx.dtype == B16 and dx.shape == (2, 8, 20, 2)
    assert recs["KERNEL_BF16"].calls == [(2, 8, 20, 2, 7, 1) + cuda_conv.mma_tile(
        2, 8, 20, 2, 1)]
    assert recs["DGRAD_BF16"].calls == [(2, 8, 20, 1, 7, 2) + cuda_conv.mma_tile(
        2, 8, 20, 1, 2)]
    for name in ("KERNEL", "DGRAD", "POOL_REAL", "GATE_REAL"):
        assert not recs[name].calls, name
    with pytest.raises(TypeError, match="bfloat16"):
        cuda_conv.sa_gate_real(pooled, w.float(), x)


# -- the net's routing off the CPU --------------------------------------------

def _drs16_net(monkeypatch, full=False):
    """A DRS net at bf16 on the meta device (narrow unless ``full``), its
    LSTM stubbed by an output of its shape and type (PyTorch runs the
    recurrence step by step on meta tensors, and it launches no kernel of
    this repository)."""
    cfg = _cfg16(config_for_variant("drs"))
    extra = {} if full else NARROW
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **extra, dropout_conv=0.0,
                                                dropout_fc=0.0))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).to("meta")
    features = model.fc.weight.shape[1]
    monkeypatch.setattr(model.lstm, "forward", lambda seq, state: (
        (seq[..., :1] * torch.ones(features, device=seq.device, dtype=seq.dtype)), state))
    return model


def _record_all(monkeypatch):
    recs = {}
    for mod in (cuda_conv, cuda_tapconv):
        for attr, k in list(vars(mod).items()):
            if type(k).__name__ == "CudaKernel":
                recs[k.name] = _Ints()
                monkeypatch.setattr(mod, attr, recs[k.name])
    return recs


def test_drs_net_at_bf16_off_the_cpu_takes_the_bf16_classes(monkeypatch):
    """A narrow DRS net at bf16 on meta tensors: in eval under no_grad one
    bf16 real pool and one bf16 real gate a site (3 skips + 2 decoder
    stages) on the gates' tile, kernel 3's bf16 class at every stage (dec1
    at N = 8 and dec2 at N = 4 on its tap body); under autograd the un-fused form, the conv
    entry's bf16 class at (7, 2, 1) forward and (7, 1, 2) backward through
    ``Conv2dSameSmallCout``, and kernel 3's bf16 input gradient (the staged
    body on the forward's packing at dec0, the narrow body at dec1 and dec2,
    whose reductions are N = 8 and 4 channels). Nothing of a float32
    class."""
    recs = _record_all(monkeypatch)
    model = _drs16_net(monkeypatch).eval()
    with torch.no_grad():
        mask = model(torch.empty(2, 256, 64, device="meta"))
    assert mask.shape == (2, 256, 64) and mask.dtype == torch.float32
    got = {k: len(r.calls) for k, r in recs.items() if r.calls}
    assert got == {"sa_pool_real_bf16": 5, "sa_gate_real_bf16": 5, "tapconv_valid_bf16": 1,
                   "tapconv_valid_bf16_tap": 2, "tapconv_pack_bf16": 3}
    for p, g in zip(recs["sa_pool_real_bf16"].calls, recs["sa_gate_real_bf16"].calls):
        B, H, W, C = p
        assert g == (B, H, W, C) + cuda_conv.gate_tile(B, H, W, 2, 1)
    assert [c[6] for c in recs["tapconv_valid_bf16_tap"].calls] == [8, 4]
    for r in recs.values():
        r.calls.clear()
    model.train()
    seen = []
    monkeypatch.setattr(cuda_conv.Conv2dSameSmallCout, "apply", (
        lambda orig: lambda *a: seen.append(a[0].dtype) or orig(*a))(
            cuda_conv.Conv2dSameSmallCout.apply))
    model(torch.empty(2, 256, 64, device="meta")).sum().backward()
    got = {k: len(r.calls) for k, r in recs.items() if r.calls}
    assert got == {"conv_same_small_cout_bf16": 5, "conv_same_small_cout_dgrad_bf16": 5,
                   "tapconv_valid_bf16": 1, "tapconv_valid_bf16_tap": 2,
                   "tapconv_pack_bf16": 3, "tapconv_valid_dgrad_bf16": 1,
                   "tapconv_valid_dgrad_narrow_bf16": 2}
    assert seen == [B16] * 5
    for args in recs["conv_same_small_cout_bf16"].calls:
        B, H, W = args[:3]
        assert args[3:] == (2, 7, 1) + cuda_conv.mma_tile(B, H, W, 2, 1)
    for args in recs["conv_same_small_cout_dgrad_bf16"].calls:
        B, H, W = args[:3]
        assert args[3:] == (1, 7, 2) + cuda_conv.mma_tile(B, H, W, 1, 2)


@pytest.mark.parametrize("batch,frames", [(4, 2008), (32, 256), (1, 251)],
                         ids=["enhance", "train", "request"])
def test_kernel3_bf16_bodies_and_plans_at_the_drs_decoder(batch, frames):
    """Kernel 3's bf16 class at the full DRS decoder's shapes (the real
    channel counts, not halved): dec0-dec5 on the staged body, dec6 at N =
    4 on the tap body (an 8-wide N tile), each with a plan; the input
    gradient at N' = Cin on the staged body but at dec6, whose reduction is
    the forward's N = 4 channels: the narrow body."""
    cfg = config_for_variant("drs")
    m = cfg.model
    skips = sites(cfg, batch, frames)[:m.n_layers]       # encoder outputs 7 ... 1
    h, w = skips[0][1], skips[0][2]
    bodies, dgrad_bodies = [], []
    for i in range(m.n_layers):
        cin, cout = m.dec_channels(i)
        s_h, s_w = m.upsample[i]
        n = s_h * s_w * cout
        pad = (1, 1, 1, 1)
        body = cuda_tapconv.bf16_body(batch, h, w, cin, n, 3, 3, pad)
        plan = cuda_tapconv.forward_plan(batch, h, w, cin, n, 3, 3, pad, bf16=True)
        assert plan[0] == cuda_tapconv.tile_n(n) if body == "tap" else plan[0] in (64, 128)
        gpad = cuda_tapconv.dgrad_pad_bf16(pad, 3, 3)
        dbody = cuda_tapconv.dgrad_body_bf16(batch, h, w, n, cin, 3, 3, gpad)
        if dbody != "narrow":
            cuda_tapconv.forward_plan(batch, h, w, n, cin, 3, 3, gpad, bf16=True, body=dbody)
        bodies.append(body)
        dgrad_bodies.append(dbody)
        h, w = h * s_h, w * s_w
    assert n == 4 and cin == 32
    assert bodies == ["staged"] * 6 + ["tap"]
    assert dgrad_bodies == ["staged"] * 6 + ["narrow"]


def test_full_drs_net_at_bf16_launches_the_smoke_counts(monkeypatch):
    """The full-width DRS net at bf16 on meta tensors makes the launches
    ``chip_smoke.py`` holds the card to: in eval 13 + 13 real pool and gate
    launches, kernel 3's staged body 6 times and its tap body once (dec6),
    7 packings; a train step's forward and backward 13 + 13 conv-entry
    launches and kernel 3's input gradient 6 (the staged body, on the
    forward's packing: no packing of its own) + 1 (the narrow body)."""
    recs = _record_all(monkeypatch)
    model = _drs16_net(monkeypatch, full=True).eval()
    with torch.no_grad():
        model(torch.empty(1, 256, 64, device="meta"))
    assert {k: len(r.calls) for k, r in recs.items() if r.calls} == {
        "sa_pool_real_bf16": 13, "sa_gate_real_bf16": 13, "tapconv_valid_bf16": 6,
        "tapconv_valid_bf16_tap": 1, "tapconv_pack_bf16": 7}
    for r in recs.values():
        r.calls.clear()
    model.train()
    model(torch.empty(1, 256, 64, device="meta")).sum().backward()
    assert {k: len(r.calls) for k, r in recs.items() if r.calls} == {
        "conv_same_small_cout_bf16": 13, "conv_same_small_cout_dgrad_bf16": 13,
        "tapconv_valid_bf16": 6, "tapconv_valid_bf16_tap": 1, "tapconv_pack_bf16": 7,
        "tapconv_valid_dgrad_bf16": 6, "tapconv_valid_dgrad_narrow_bf16": 1}
