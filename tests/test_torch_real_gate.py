"""Kernel 2 at the real family's classes (DR, DRS): the real spatial-attention
gate (pool, then the (7, 2, 1) conv with a sigmoid-and-product epilogue) and
the register-tiled body at (K, Cin, Cout) = (7, 2, 1) and its input
gradient's (7, 1, 2).

The gate's plain version against the JAX ``RealSpatialAttention`` followed by
``widen.mul_bcast`` (one JAX compile for every shape), the module's gate
against its un-fused form, CPU models of the tiled body's and the gate's
indexing, the 4-byte bank layout, the tiles the wrapper chooses, and the
launches a DRS net makes on meta tensors (which stand in for the card's).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.ops import attention as jatt
from dcs_net_tpu.ops import widen

from dcs_net_tpu_torch.convert import params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import attention, cuda_conv, cuda_tapconv
from dcs_net_tpu_torch.tools.time_gate import sites

from test_torch_conv import _Recorder, _tiled_conv_model
from test_torch_train import _one_torch_thread  # noqa: F401


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _port_attention(kernel: np.ndarray) -> attention.RealSpatialAttention:
    """The port's real spatial attention holding the JAX kernel (7, 7, 2, 1),
    moved through the converter."""
    sd = params_from_jax({"params": {"conv": {"kernel": kernel}}})
    port = attention.RealSpatialAttention(7)
    port.load_state_dict(sd, strict=True)
    return port


# (B, H, W, C): the DRS sites at batch 1-2 with the frames cut to 32 (their
# H and C as at full width), C = 6 (no multiple of 4), H = 1
GATE_SHAPES = [(1, 2, 8, 256), (2, 16, 8, 128), (1, 32, 8, 64), (2, 64, 16, 32),
               (1, 128, 32, 16), (2, 5, 9, 6), (1, 1, 7, 16)]


def test_real_gate_plain_matches_jax_attention_then_product():
    """spatial_gate_real_plain and RealSpatialAttention.gate (plain versions
    on the CPU) against the JAX real spatial attention followed by
    ``widen.mul_bcast``, jitted once over every shape; rtol = atol = 1e-5
    (float32, the two convs sum the 98 taps in other orders)."""
    kernel = _np((7, 7, 2, 1), 70, 0.3)
    xs = [_np(s, 71 + i) for i, s in enumerate(GATE_SHAPES)]
    mod = jatt.RealSpatialAttention(7)
    variables = {"params": {"conv": {"kernel": jnp.asarray(kernel)}}}
    want = jax.jit(lambda v, ins: [widen.mul_bcast(a, mod.apply(v, a)) for a in ins])(
        variables, [jnp.asarray(a) for a in xs])
    port = _port_attention(kernel)
    w = port.packed_kernel()
    np.testing.assert_array_equal(w.numpy(), kernel)
    for a, ref in zip(xs, want):
        x = torch.from_numpy(a)
        with torch.no_grad():
            got = port.gate(x)
        plain = cuda_conv.spatial_gate_real_plain(x, w)
        assert got.shape == a.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 6, 9, 16), (1, 3, 5, 1), (2, 4, 4, 6)])
def test_real_gate_on_the_cpu_is_the_unfused_attention(shape):
    """On the CPU the gate is the same arithmetic as x * sa(x): equal to the
    last bit (tolerance 0). Under autograd it is the un-fused form itself, so
    gradients reach x and the conv weight; at kernel size 3 it is un-fused
    too."""
    x = torch.from_numpy(_np(shape, 80))
    sa = attention.RealSpatialAttention(7, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = sa.gate(x), x * sa(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    xg = x.clone().requires_grad_(True)
    out = sa.gate(xg)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), (xg * sa(xg)).detach(), rtol=0, atol=0)
    out.sum().backward()
    assert xg.grad is not None and sa.conv.weight.grad is not None
    sa3 = attention.RealSpatialAttention(3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(sa3.gate(x), x * sa3(x), rtol=0, atol=0)


def test_real_gate_packed_kernel_follows_the_weight():
    """The packed (7, 7, 2, 1) kernel is kept between calls and rebuilt once
    the weight changes in place."""
    sa = attention.RealSpatialAttention(7, generator=torch.Generator().manual_seed(2))
    first = sa.packed_kernel()
    assert sa.packed_kernel() is first
    with torch.no_grad():
        sa.conv.weight.mul_(2.0)
    second = sa.packed_kernel()
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first, rtol=0, atol=0)


# --- the tiled body at the real classes, modelled on the CPU ----------------

@pytest.mark.parametrize("shape,tile", [
    ((1, 5, 11, 2), (2, 4, 2)),        # W no multiple of the run, H odd
    ((2, 3, 9, 2), (4, 2, 16)),        # H below the tile height
    ((1, 18, 70, 2), (4, 8, 16)),      # the large-image tile, ragged both ways
    ((1, 4, 3, 2), (8, 1, 1)),         # W below one thread's run
    ((1, 9, 41, 2), (8, 4, 4)),        # R = 8
    ((1, 5, 11, 1), (2, 4, 2)),        # the same at the input gradient's class
    ((2, 3, 9, 1), (4, 2, 16)),
    ((1, 18, 70, 1), (4, 8, 16)),
    ((1, 4, 3, 1), (8, 1, 1)),
    ((2, 9, 41, 1), (8, 16, 8)),
])
def test_tiled_conv_model_matches_plain_at_the_real_classes(shape, tile):
    """The tiled body at (7, 2, 1) (float2 pixels, one output) and (7, 1, 2)
    (float pixels at the pitch padded for 4-byte loads, two outputs): every
    pixel written once from staged slots, equal to the plain conv within
    1e-5 (float32 sums in another order)."""
    cin = shape[-1]
    cout = 3 - cin
    x, w, b = _np(shape, 90), _np((7, 7, cin, cout), 91, 0.1), _np((cout,), 92)
    want = cuda_conv.conv2d_same_small_cout_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    got = _tiled_conv_model(x, w, b, tile)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _real_gate_model(x, pooled, w, tile, vec):
    """sa_gate_real_kernel's indexing in numpy: the map from the tiled body,
    through the sigmoid into the block's tile; then the block's 128 threads
    walk its rows_v x cols_v pixels as words (float4 where vec, else
    floats), word e of the tile at row e // n, word i = e % n of that row,
    whose pixel is i >> shift (or i // nv). Every word of x must be written
    exactly once."""
    R, TX, TY = tile
    B, H, W, C = x.shape
    tw = R * TX
    a = 1.0 / (1.0 + np.exp(-_tiled_conv_model(pooled, w, np.zeros(1, np.float32),
                                               tile)[..., 0]))
    nv = C // 4 if vec else C
    shift = nv.bit_length() - 1 if nv & (nv - 1) == 0 else -1
    words = x.reshape(-1, 4) if vec else x.reshape(-1, 1)
    out = np.full_like(words, np.nan)
    writes = np.zeros(len(words), np.int64)
    for b in range(B):
        for h0 in range(0, H, TY):
            for w0 in range(0, W, tw):
                att = np.zeros((TY, tw), np.float32)
                hv, wv = min(TY, H - h0), min(tw, W - w0)
                att[:hv, :wv] = a[b, h0:h0 + hv, w0:w0 + wv]
                n = wv * nv
                pix0 = (b * H + h0) * W + w0
                for tid in range(cuda_conv.BLOCK_THREADS):
                    for e in range(tid, hv * n, cuda_conv.BLOCK_THREADS):
                        row, i = divmod(e, n)
                        px = i >> shift if shift >= 0 else i // nv
                        assert px == i // nv
                        k = (pix0 + row * W) * nv + i
                        out[k] = words[k] * att[row, px]
                        writes[k] += 1
    assert (writes == 1).all()
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape,tile,vec", [
    ((2, 5, 11, 12), (2, 4, 2), True),     # 3 words a pixel: no shift
    ((2, 5, 11, 12), (2, 4, 2), False),    # x unaligned: 12 floats a pixel
    ((1, 3, 9, 16), (4, 2, 1), True),      # one-row tile, shift 2
    ((1, 18, 35, 4), (4, 8, 16), True),    # the large-image tile, ragged
    ((2, 4, 20, 1), (8, 2, 2), False),     # C = 1, R = 8
    ((1, 2, 9, 256), (2, 4, 1), True),     # a small site's depth
])
def test_real_gate_model_matches_plain(shape, tile, vec):
    """The real gate's whole indexing (tiled conv, sigmoid, the product's
    walk over the tile) equals sa_gate_real_plain within 1e-5."""
    x = _np(shape, 93)
    pooled = cuda_conv.sa_pool_real_plain(torch.from_numpy(x))
    w = _np((7, 7, 2, 1), 94, 0.3)
    want = cuda_conv.sa_gate_real_plain(pooled, torch.from_numpy(w),
                                        torch.from_numpy(x)).numpy()
    got = _real_gate_model(x, pooled.numpy(), w, tile, vec)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _real_tiles():
    tiles = {cuda_conv.choose_tile(B, H, W, cin, 3 - cin) for cin in (1, 2)
             for B in (1, 4, 8, 32) for H in (1, 2, 3, 8, 16, 32, 64, 128)
             for W in (1, 7, 32, 64, 128, 251, 1004)}
    return sorted(tiles | {(4, 3, 5), (2, 5, 3), (8, 4, 4), (8, 3, 7), (2, 24, 4)})


def test_staged_slots_spread_a_warp_over_the_banks_at_4_bytes():
    """A float load is served a warp at a time: the 32 threads of a warp
    (over as many tile rows as it spans) must hit 32 different 4-byte banks
    at every window position j, for every tile the wrapper chooses at the
    real classes and for tile widths that divide no warp. The unpadded pitch
    would not (checked for the large-image tile)."""
    for tile in _real_tiles():
        R, tx, ty = tile
        pitch = cuda_conv.tile_pitch(tile, 1)
        assert pitch >= cuda_conv.tile_pitch(tile, 4)
        active = tx * ty
        for w0 in range(0, active, 32):
            threads = range(w0, min(w0 + 32, active))
            for j in range(R + 6):
                banks = {((t // tx) * pitch + cuda_conv.slot((t % tx) * R + j, R)) % 32
                         for t in threads}
                assert len(banks) == len(threads), (tile, w0, j)
    R, tx, ty = 4, 8, 16
    plain = cuda_conv.tile_pitch((R, tx, ty), 4)
    banks = {((t // tx) * plain + cuda_conv.slot((t % tx) * R, R)) % 32 for t in range(32)}
    assert len(banks) < 32


@pytest.mark.parametrize("batch,frames", [(1, 2008), (4, 2008), (8, 256), (32, 256),
                                          (2, 64), (16, 1004)])
def test_chosen_tiles_fit_every_class_at_the_drs_sites(batch, frames):
    """At every DRS site shape, for every tiled class (and for the real
    gate, which takes the gates' tile at class (7, 2, 1)), the chosen tile
    has at most 128 conv threads and fits 48 KB of shared memory (the
    kernel's own limits, ``_check_tile``), and covers the image with at
    most 65535 tile rows. The real classes' conv tiles hold 64 to 1024
    pixels."""
    for B, H, W, _ in sites(config_for_variant("drs"), batch, frames):
        cases = [(cuda_conv.choose_tile(B, H, W, cin, cout), cin, cout, True)
                 for _, cin, cout in cuda_conv.TILED_CLASSES]
        cases.append((cuda_conv.gate_tile(B, H, W, 2, 1), 2, 1, False))
        for tile, cin, cout, conv in cases:
            cuda_conv._check_tile(tile, cin, cout)
            R, tx, ty = tile
            assert tx * ty <= cuda_conv.BLOCK_THREADS
            assert cuda_conv.tile_smem_bytes(tile, cin, cout) <= 48 * 1024
            assert -(-H // ty) <= 65535
            if conv and cin * cout == 2:
                assert 64 <= R * tx * ty <= 1024


# --- routing off the CPU: meta tensors and recorders ------------------------

NARROW = dict(n_layers=3, channels=(1, 4, 8, 16, 8, 16),
              stride_e=((2, 2), (2, 1), (2, 1)),
              upsample=((2, 1), (2, 1), (2, 2)), ca_reduction=4)


def _record(monkeypatch):
    recs = {}
    for mod, names in ((cuda_conv, ("KERNEL", "DGRAD", "POOL", "GATE", "POOL_REAL",
                                    "GATE_REAL")),
                       (cuda_tapconv, ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK"))):
        for name in names:
            rec = _Recorder()
            monkeypatch.setattr(mod, name, rec)
            recs[f"{mod.__name__.rsplit('.', 1)[-1]}.{name}"] = rec
    return recs


def _drs_net(monkeypatch):
    """A narrow DRS net on the meta device. Its LSTM, which launches no
    kernel of this repository and which PyTorch runs step by step on meta
    tensors (tens of seconds), is stubbed by an output of its shape."""
    cfg = config_for_variant("drs")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **NARROW, dropout_conv=0.0,
                                                dropout_fc=0.0))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).to("meta")
    features = model.fc.weight.shape[1]
    monkeypatch.setattr(model.lstm, "forward", lambda seq, state: (
        (seq[..., :1] * torch.ones(features, device=seq.device)), state))
    return model


def test_drs_net_off_the_cpu_runs_the_real_gate_in_eval(monkeypatch):
    """A (narrow) DRS net in eval under no_grad launches one real pool and
    one real gate per attention site (3 skips + 2 decoder stages), on the
    gates' tile, and kernel 2's conv entry never."""
    recs = _record(monkeypatch)
    model = _drs_net(monkeypatch).eval()
    with torch.no_grad():
        mask = model(torch.empty(2, 256, 64, device="meta"))
    assert mask.shape == (2, 256, 64)
    pools, gates = recs["cuda_conv.POOL_REAL"].calls, recs["cuda_conv.GATE_REAL"].calls
    assert len(pools) == len(gates) == 5
    for p, g in zip(pools, gates):
        B, H, W, C = p[2:]
        assert g[4:] == (B, H, W, C) + cuda_conv.gate_tile(B, H, W, 2, 1)
    for name in ("KERNEL", "DGRAD", "POOL", "GATE"):
        assert not recs[f"cuda_conv.{name}"].calls, name
    assert len(recs["cuda_tapconv.KERNEL"].calls) == 3


def test_drs_net_off_the_cpu_trains_on_the_tiled_bodies(monkeypatch):
    """Under grad (train mode) the same net runs each site's conv on kernel
    2's conv entry at (7, 2, 1) and its input gradient at (7, 1, 2), both on
    the chosen tiled tile, and neither real gate entry."""
    recs = _record(monkeypatch)
    model = _drs_net(monkeypatch).train()
    model(torch.empty(2, 256, 64, device="meta")).sum().backward()
    fwd, dgrad = recs["cuda_conv.KERNEL"].calls, recs["cuda_conv.DGRAD"].calls
    assert len(fwd) == len(dgrad) == 5
    for args in fwd:
        B, H, W = args[4:7]
        assert args[7:] == (2, 7, 1) + cuda_conv.choose_tile(B, H, W, 2, 1)
    for args in dgrad:
        B, H, W = args[4:7]
        assert args[7:] == (1, 7, 2) + cuda_conv.choose_tile(B, H, W, 1, 2)
    assert not recs["cuda_conv.POOL_REAL"].calls and not recs["cuda_conv.GATE_REAL"].calls


def test_real_gate_raises_under_autograd_off_the_cpu(monkeypatch):
    """The real pool and gate entries are forward-only: on a card's (meta)
    tensor that autograd follows they raise and launch nothing; the gate
    checks its shapes and the tile's limits."""
    recs = _record(monkeypatch)
    x = torch.empty((2, 8, 20, 16), device="meta", requires_grad=True)
    w = torch.empty((7, 7, 2, 1), device="meta")
    pooled = torch.empty((2, 8, 20, 2), device="meta")
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.sa_pool_real(x)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.sa_gate_real(pooled, w, x)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.spatial_gate_real(x, w)
    assert not recs["cuda_conv.POOL_REAL"].calls and not recs["cuda_conv.GATE_REAL"].calls
    x = x.detach()
    with pytest.raises(ValueError, match="7, 7, 2, 1"):
        cuda_conv.sa_gate_real(pooled, torch.empty((7, 7, 4, 2), device="meta"), x)
    with pytest.raises(ValueError):
        cuda_conv.sa_gate_real(pooled, w, x, (16, 1, 1))
    out = cuda_conv.spatial_gate_real(x, w)
    assert out.shape == x.shape
    assert recs["cuda_conv.POOL_REAL"].calls[0][2:] == (2, 8, 20, 16)
    assert recs["cuda_conv.GATE_REAL"].calls[0][4:] == (
        (2, 8, 20, 16) + cuda_conv.gate_tile(2, 8, 20, 2, 1))


def test_real_gate_counts_on_its_own():
    """The real pool and gate entries count their launches on counters of
    their own, not on the conv entry's nor the complex gate's."""
    assert cuda_conv.POOL_REAL.name == "sa_pool_real"
    assert cuda_conv.GATE_REAL.name == "sa_gate_real"
    assert cuda_conv.POOL_REAL.counted_with is None
    assert cuda_conv.GATE_REAL.counted_with is None
    assert cuda_conv.GATE_REAL.symbol == "dcs_sa_gate_real"
