"""Kernels 2 and 3 of the port (their plain versions, which CPU tensors take)
and the port's conv engine against the JAX package: the Pallas kernels in
interpret mode, their XLA formulations, and ``conv_engine``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.ops import conv_engine as jce
from dcs_net_tpu.ops import pallas_conv
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_pallas, _conv_fwd_xla
from dcs_net_tpu.ops.pallas_tapconv import tapconv_valid as jax_tapconv

from dcs_net_tpu_torch.ops import attention, conv_engine as tce
from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_tapconv_fwd import entry_model
from test_torch_train import _one_torch_thread  # noqa: F401


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


SMALL_COUT = [
    # (B, H, W, Cin), K, Cout
    ((2, 16, 32, 4), 7, 2),    # CBAM spatial-attention class
    ((1, 8, 16, 8), 3, 16),
    ((2, 24, 8, 3), 5, 1),
]


@pytest.mark.parametrize("shape,k,cout", SMALL_COUT)
def test_conv_same_plain_matches_pallas_and_xla(shape, k, cout):
    x, w, b = _np(shape, 1), _np((k, k, shape[-1], cout), 2, 0.1), _np((cout,), 3)
    got = cuda_conv.conv2d_same_small_cout(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    pallas = _conv_fwd_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              interpret=True)
    xla = jax.jit(_conv_fwd_xla)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-5, atol=1e-5)


def test_conv_same_rejects_unsupported_shapes():
    x = torch.zeros(1, 8, 8, 4)
    with pytest.raises(ValueError):
        cuda_conv.conv2d_same_small_cout(x, torch.zeros(3, 3, 4, 17), torch.zeros(17))
    with pytest.raises(ValueError):
        cuda_conv.conv2d_same_small_cout(x, torch.zeros(4, 4, 4, 2), torch.zeros(2))


TAPCONV = [
    # (B, Hp, Wp, Cin), (Dh, Dw), N
    ((2, 10, 9, 64), (3, 3), 32),
    ((1, 6, 8, 16), (3, 3), 8),
    ((2, 5, 7, 24), (2, 2), 12),
]


@pytest.mark.parametrize("shape,taps,n", TAPCONV)
def test_tapconv_plain_matches_pallas_and_patch_dot(shape, taps, n):
    dh_n, dw_n = taps
    x = _np(shape, 4)
    w = _np((dh_n * dw_n, shape[-1], n), 5, 0.1)
    got = cuda_tapconv.tapconv_valid(torch.from_numpy(x), torch.from_numpy(w),
                                     dh_n, dw_n).numpy()
    pallas = jax_tapconv(jnp.asarray(x), jnp.asarray(w), dh_n, dw_n,
                         interpret=True)
    patch_dot = jax.lax.dot_general(
        jce._updot_patches(jnp.asarray(x), taps),
        jnp.asarray(w).reshape(dh_n * dw_n * shape[-1], n),
        (((3,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(patch_dot), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cins,cout,scale", [
    ((3, 4), 6, (2, 1)),
    ((3, 4), 6, (2, 2)),
    ((2, 2), 40, (2, 2)),
    ((5,), 4, (1, 1)),
])
def test_upsampled_conv2d_multi_matches_jax(cins, cout, scale):
    K, B, H, W = 3, 2, 9, 7
    xs = [_np((B, H, W, c), 10 + j) for j, c in enumerate(cins)]
    ws = [_np((K, K, c, cout), 20 + j, 0.2) for j, c in enumerate(cins)]
    want = jax.jit(lambda a, b: jce.upsampled_conv2d_multi(a, b, scale))(
        tuple(map(jnp.asarray, xs)), tuple(map(jnp.asarray, ws)))
    got = tce.upsampled_conv2d_multi([torch.from_numpy(a) for a in xs],
                                     [torch.from_numpy(a) for a in ws], scale)
    assert got.shape == (B, scale[0] * H, scale[1] * W, cout)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,k,cout,stride", [
    ((2, 24, 16, 4), 7, 2, (1, 1)),     # small-Cout class -> kernel 2
    ((2, 16, 12, 6), 5, 8, (2, 1)),     # strided encoder conv
    ((2, 17, 9, 2), 7, 8, (2, 2)),      # odd sizes, strided
    ((2, 1, 1, 16), 1, 4, (1, 1)),      # channel-attention 1x1 FC
])
def test_conv2d_matches_jax(shape, k, cout, stride):
    x, w = _np(shape, 30), _np((k, k, shape[-1], cout), 31, 0.1)
    want = jax.jit(lambda a, b: jce.conv2d(a, b, stride, k // 2))(
        jnp.asarray(x), jnp.asarray(w))
    got = tce.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride, k // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_use_tuned_routes_the_spatial_attention_class():
    assert tce.use_tuned(7, (1, 1), 3, 2)
    assert tce.use_tuned(3, (1, 1), 1, 16)
    assert tce.use_tuned(5, (1, 1), 2, 8)       # no TPU lane-packing limit
    assert not tce.use_tuned(7, (2, 2), 3, 2)
    assert not tce.use_tuned(3, (1, 1), 1, 17)
    assert not tce.use_tuned(9, (1, 1), 4, 1)   # K beyond kernel 2's bound


def _low13(t):
    return t.view(torch.int32) & 0x1FFF


def test_split_tf32_parts_are_tf32_and_sum_to_the_input():
    """hi and lo have their low 13 mantissa bits zero (TF32 values) and
    hi + lo reproduces the float32 input to 2^-21 relative (two roundings of
    2^-11 each: 2^-22, with a factor of two to spare)."""
    x = torch.from_numpy(_np((64, 257), 40) * np.logspace(-6, 6, 257).astype(np.float32))
    hi, lo = cuda_tapconv.split_tf32(x)
    assert int(_low13(hi).abs().max()) == 0 and int(_low13(lo).abs().max()) == 0
    back = hi.double() + lo.double()
    assert float(((back - x.double()).abs() / x.double().abs()).max()) <= 2.0 ** -21
    # round to nearest, ties away from zero, as cvt.rna.tf32.f32: 1 + 2^-11
    # is a tie between 1 and 1 + 2^-10
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    hi, lo = cuda_tapconv.split_tf32(tie)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    assert lo.tolist() == [-(2.0 ** -11), 2.0 ** -11]


def test_three_pass_tf32_product_is_as_close_as_float32():
    """The kernel's arithmetic, emulated: lo*hi + hi*lo + hi*hi over split
    operands (the pixels truncated, the weights rounded, as the kernel splits
    them), accumulated in float32, at the longest reduction of the slice
    (K = 9 * 512 = 4608). Its error against a float64 product is within 2x
    of a float32 matmul's: the dropped lo*lo term is ~2^-22 per product."""
    a, b = _np((96, 4608), 41), _np((4608, 80), 42, 1.0 / np.sqrt(4608))
    ref = torch.from_numpy(a.astype(np.float64) @ b.astype(np.float64))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err32 = float(((ta @ tb).double() - ref).abs().max())
    bh, bl = cuda_tapconv.split_tf32(tb)
    for truncate in (True, False):
        ah, al = cuda_tapconv.split_tf32(ta, truncate=truncate)
        assert int(_low13(ah).abs().max()) == 0 and int(_low13(al).abs().max()) == 0
        assert float(((ah.double() + al.double() - ta.double()).abs()
                      / ta.double().abs()).max()) <= 2.0 ** (-20 if truncate else -21)
        three = al @ bh + ah @ bl + ah @ bh
        assert float((three.double() - ref).abs().max()) <= 2 * err32
    one = float(((ah @ bh).double() - ref).abs().max())
    assert one > 20 * err32     # a single TF32 pass would not hold the band


@pytest.mark.parametrize("taps,cin,n", [(9, 64, 32), (9, 70, 130), (4, 24, 12),
                                        (9, 32, 8), (1, 36, 5), (9, 32, 4)])
def test_pack_weights_layout_round_trips(taps, cin, n):
    """The K-major tiles the packing kernel writes, in PyTorch: element
    [n tile, chunk, tap, part, j, m, i] is channel 32*chunk + 4*j + i of
    output nt*bn + m, zero past Cin and N, and unpacking gives w back."""
    w = torch.from_numpy(_np((taps, cin, n), 43, 0.1))
    bn = cuda_tapconv.tile_n(n)
    assert bn == (8 if n <= 8 else 64 if n <= 64 else 128)
    packed = cuda_tapconv.pack_weights(w, bn)
    assert packed.shape == (-(-n // bn), -(-cin // 32), taps, 2, 8, bn, 4)
    assert int(_low13(packed).abs().max()) == 0
    hi, lo = cuda_tapconv.split_tf32(w)
    for part, want in ((0, hi), (1, lo)):
        for nt, c, tap, j, m, i in [(0, 0, 0, 0, 0, 0), (0, (cin - 1) // 32, taps - 1,
                                                         ((cin - 1) % 32) // 4, (n - 1) % bn,
                                                         (cin - 1) % 4)]:
            ch, out = 32 * c + 4 * j + i, nt * bn + m
            assert float(packed[nt, c, tap, part, j, m, i]) == float(want[tap, ch, out])
    full = torch.nn.functional.pad(
        torch.ones(taps, cin, n), (0, packed.shape[0] * bn - n, 0, packed.shape[1] * 32 - cin))
    mask = cuda_tapconv.pack_weights(full, bn)[:, :, :, 0] == 0
    assert float(packed[:, :, :, 0][mask].abs().max() if mask.any() else 0.0) == 0.0
    back = cuda_tapconv.unpack_weights(packed, cin, n)
    assert back.shape == w.shape
    assert float(((back - w).abs() / w.abs()).max()) <= 2.0 ** -21
    x = torch.from_numpy(_np((1, 5, 6, cin), 44))
    d = int(round(taps ** 0.5))
    torch.testing.assert_close(cuda_tapconv.tapconv_valid(x, back, d, d),
                               cuda_tapconv.tapconv_valid_plain(x, w, d, d),
                               rtol=1e-5, atol=1e-5)


def test_tapconv_cpu_tensor_takes_plain_version():
    """A CPU tensor goes through the plain version: nothing is packed and
    nothing launches."""
    x, w = torch.from_numpy(_np((1, 6, 8, 16), 45)), torch.from_numpy(_np((9, 16, 8), 46))
    before = cuda_tapconv.KERNEL.launches, cuda_tapconv.PACK.launches
    got = cuda_tapconv.tapconv_valid(x, w, 3, 3)
    assert (cuda_tapconv.KERNEL.launches, cuda_tapconv.PACK.launches) == before
    torch.testing.assert_close(got, cuda_tapconv.tapconv_valid_plain(x, w, 3, 3),
                               rtol=0, atol=0)


@pytest.mark.parametrize("stage,zero_elements,zero_blocks", [
    (0, 3 / 9, 3 / 9), (1, 3 / 9, 3 / 9), (2, 3 / 9, 3 / 9), (3, 3 / 9, 0.0),
    (4, 5 / 9, 0.0), (5, 5 / 9, 0.0), (6, 5 / 9, 0.0)])
def test_unified_decoder_weights_hold_structural_zeros(monkeypatch, stage,
                                                       zero_elements, zero_blocks):
    """The unified weights that each decoder stage of the product config hands
    kernel 3 (built by the engine itself from all-ones weights at one input
    channel, so every zero is structural): the share of zero elements, and the
    share of (tap, N tile) blocks that are zero as a whole, which a kernel
    could skip without touching its inner loop. Each output phase of an
    upsampled stage reads 2 of the window's 3 rows (columns), so 1/3 of the
    elements are zero at 2x1 stages and 5/9 at 2x2 stages; whole blocks are
    zero only where a phase fills an N tile (dec0-dec2)."""
    from dcs_net_tpu_torch.core.config import config_for_variant

    m = config_for_variant("dcs").model
    K, scale = m.kernel_d[stage], tuple(m.upsample[stage])
    cout = 2 * m.dec_channels(stage)[1]           # real and imaginary columns
    seen = []
    monkeypatch.setattr(tce, "tapconv_valid", lambda x, kbig, dh, dw, pad: (
        seen.append(kbig), cuda_tapconv.tapconv_valid(x, kbig, dh, dw, pad))[1])
    tce.upsampled_conv2d_multi([torch.ones(1, 2, 2, 1)], [torch.ones(K, K, 1, cout)],
                               scale)
    (kbig,) = seen
    taps, _, n = kbig.shape
    assert taps == 9 and n == scale[0] * scale[1] * cout
    bn = cuda_tapconv.tile_n(n)
    tiles = torch.nn.functional.pad(kbig[:, 0], (0, -n % bn)).reshape(taps, -1, bn)
    assert float((kbig == 0).float().mean()) == pytest.approx(zero_elements, abs=1e-6)
    assert float((tiles.abs().sum(-1) == 0).float().mean()) == pytest.approx(
        zero_blocks, abs=1e-6)


# --- kernel 2's register-tiled (7, 4, 2) body, modelled on the CPU ----------

def _tiled_conv_model(x, w, bias, tile):
    """The tiled body's indexing in numpy, for any odd K: a block stages its
    tile plus halo (zero outside the image) with pixel p of a row at
    ``slot(p)``; thread (tx, ty) loads the R + K - 1 pixels under its run
    through the same slots, once per tap row, and slides the taps over that
    window; the map goes through the block's shared tile and only pixels
    inside the image are written."""
    R, TX, TY = tile
    B, H, W, cin = x.shape
    K, cout = w.shape[0], w.shape[-1]
    halo = K - 1
    tw = R * TX
    # at K = 7 the source's pitch (padded further for 8-byte slots, Cin 2)
    pitch = (cuda_conv.tile_pitch(tile, cin) if K == 7
             else cuda_conv.slot(tw + halo - 1, R) + 1)
    y = np.full((B, H, W, cout), np.nan, np.float32)
    for b in range(B):
        for h0 in range(0, H, TY):
            for w0 in range(0, W, tw):
                xs = np.full((TY + halo, pitch, cin), np.nan, np.float32)
                for row in range(TY + halo):
                    for col in range(tw + halo):
                        hh, ww = h0 - halo // 2 + row, w0 - halo // 2 + col
                        inside = 0 <= hh < H and 0 <= ww < W
                        xs[row, cuda_conv.slot(col, R)] = x[b, hh, ww] if inside else 0.0
                att = np.zeros((TY, tw, cout), np.float32)
                for ty in range(TY):
                    for tx in range(TX):
                        acc = np.zeros((R, cout), np.float32)
                        for kh in range(K):
                            win = np.stack([xs[ty + kh, cuda_conv.slot(tx * R + j, R)]
                                            for j in range(R + halo)])
                            for kw in range(K):
                                acc += win[kw:kw + R] @ w[kh, kw]
                        att[ty, tx * R:(tx + 1) * R] = acc + bias
                hv, wv = min(TY, H - h0), min(tw, W - w0)
                y[b, h0:h0 + hv, w0:w0 + wv] = att[:hv, :wv]
    return y


@pytest.mark.parametrize("shape,k,tile", [
    ((1, 5, 11, 4), 7, (2, 4, 2)),     # W no multiple of the run, H odd
    ((2, 3, 9, 4), 7, (4, 2, 16)),     # H below the tile height
    ((1, 18, 70, 4), 7, (4, 8, 16)),   # the large-image tile, ragged both ways
    ((1, 4, 3, 4), 7, (4, 1, 1)),      # W below one thread's run
    ((1, 6, 13, 3), 5, (4, 3, 5)),
    ((2, 7, 10, 2), 3, (2, 4, 4)),
])
def test_tiled_conv_model_matches_plain(shape, k, tile):
    x, w, b = _np(shape, 50), _np((k, k, shape[-1], 2), 51, 0.1), _np((2,), 52)
    want = cuda_conv.conv2d_same_small_cout_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    got = _tiled_conv_model(x, w, b, tile)
    assert not np.isnan(got).any()          # every pixel written, no padding read
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R", [2, 4])
def test_staged_slots_spread_a_quarter_warp_over_the_banks(R):
    """A float4 load is served a quarter-warp at a time: the 8 threads of a
    row, whose runs start R pixels apart, must hit 8 different 16-byte bank
    groups at every window position j, for any 8 neighbouring threads
    (unpadded rows would put them on 4 and 2 groups)."""
    for tx0 in range(0, 32, 8):
        for j in range(R + 6):
            groups = {cuda_conv.slot((tx0 + t) * R + j, R) % 8 for t in range(8)}
            assert len(groups) == 8, (R, tx0, j)
    # no two pixels of a row share a slot, and the pitch holds the last one
    for cols in (R * 8 + 6, R * 16 + 6, 23):
        slots = [cuda_conv.slot(p, R) for p in range(cols)]
        assert len(set(slots)) == cols and slots == sorted(slots)


@pytest.mark.parametrize("shape,tile", [
    ((1, 5, 11, 2), (2, 4, 2)),        # W no multiple of the run, H odd
    ((2, 3, 9, 2), (4, 2, 16)),        # H below the tile height
    ((1, 18, 70, 2), (4, 8, 16)),      # the large-image tile, ragged both ways
    ((1, 4, 3, 2), (4, 1, 1)),         # W below one thread's run
    ((2, 9, 20, 2), (2, 3, 5)),        # a tile width that divides no half-warp
])
def test_tiled_conv_model_matches_plain_input_gradient_class(shape, tile):
    """The tiled body at the input gradient's class (7, 2, 4): float2 pixels
    at the pitch padded for 8-byte loads, 4 outputs a pixel."""
    x, w, b = _np(shape, 53), _np((7, 7, 2, 4), 54, 0.1), _np((4,), 55)
    want = cuda_conv.conv2d_same_small_cout_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)).numpy()
    got = _tiled_conv_model(x, w, b, tile)
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _tiles_to_check():
    tiles = {cuda_conv.choose_tile(B, H, W, 4, 2) for B in (1, 4, 32)
             for H in (1, 2, 3, 8, 16, 32, 64, 128) for W in (1, 7, 32, 64, 128, 251)}
    return sorted(tiles | {(4, 3, 5), (2, 5, 3), (4, 12, 2), (2, 24, 4)})


def test_staged_slots_spread_a_half_warp_over_the_banks_at_8_bytes():
    """A float2 load is served a half-warp at a time: the 16 threads of a
    half-warp (over as many tile rows as it spans) must hit 16 different
    8-byte bank groups at every window position j, for every tile
    ``choose_tile`` gives and for tile widths that divide no half-warp. The
    unpadded pitch would not (checked for the large-image tile)."""
    for tile in _tiles_to_check():
        R, tx, ty = tile
        pitch = cuda_conv.tile_pitch(tile, 2)
        assert pitch >= cuda_conv.tile_pitch(tile, 4)
        active = tx * ty
        for h0 in range(0, active, 16):
            threads = range(h0, min(h0 + 16, active))
            for j in range(R + 6):
                groups = {((t // tx) * pitch + cuda_conv.slot((t % tx) * R + j, R)) % 16
                          for t in threads}
                assert len(groups) == len(threads), (tile, h0, j)
        cuda_conv._check_tile(tile, 2, 4)
    R, tx, ty = 4, 8, 16
    plain = cuda_conv.tile_pitch((R, tx, ty), 4)
    groups = {((t // tx) * plain + cuda_conv.slot((t % tx) * R, R)) % 16 for t in range(16)}
    assert len(groups) < 16


def test_choose_tile_gives_tiles_the_kernel_takes():
    """Every choice passes the kernel's own limits, holds 8 to 512 pixels,
    is no taller than the image needs and at least 8 runs wide once it has 2 rows."""
    for B in (1, 4, 8, 32):
        for H in (1, 2, 3, 8, 16, 33, 128, 256):
            for W in (1, 7, 32, 251, 1004, 4000):
                tile = cuda_conv.choose_tile(B, H, W, 4, 2)
                cuda_conv._check_tile(tile)
                R, tx, ty = tile
                assert 8 <= R * tx * ty <= 512 and R in (2, 4)
                assert ty <= 16 and ty < 2 * H and (tx >= 8 or ty == 1)
    with pytest.raises(ValueError):
        cuda_conv._check_tile((3, 8, 8))
    with pytest.raises(ValueError):
        cuda_conv._check_tile((4, 32, 8))       # 256 conv threads
    with pytest.raises(ValueError):
        cuda_conv._check_tile((4, 128, 1))      # more shared memory than 48 KB
    for cin, cout in ((4, 2), (2, 4)):          # R = 8 only at the real classes
        with pytest.raises(ValueError):
            cuda_conv._check_tile((8, 1, 1), cin, cout)


class _Recorder:
    """Stands in for a CudaKernel: notes the arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(args)


@pytest.mark.parametrize("shape,k,cout,tiled", [
    ((4, 16, 251, 4), 7, 2, True),      # the spatial-attention class
    ((2, 16, 12, 4), 5, 8, False),      # every other class: the generic body
    ((2, 16, 12, 4), 7, 3, False),
    ((2, 16, 12, 2), 7, 2, False),
    ((2, 16, 12, 4), 3, 2, False),
    ((4, 64, 34, 2), 7, 1, True),       # the real attention's class (7, 2, 1)
    ((4, 64, 34, 1), 7, 2, True),       # and its input gradient's (7, 1, 2)
])
def test_conv_entry_routes_only_the_tuned_class_to_the_tiled_body(
        monkeypatch, shape, k, cout, tiled):
    """Off the CPU the wrapper launches (never the plain version): meta
    tensors stand in for the card's, a recorder for the kernel."""
    rec = _Recorder()
    monkeypatch.setattr(cuda_conv, "KERNEL", rec)
    x = torch.empty(shape, device="meta")
    w = torch.empty((k, k, shape[-1], cout), device="meta")
    y = cuda_conv.conv2d_same_small_cout(x, w, torch.empty(cout, device="meta"))
    assert y.shape == shape[:3] + (cout,)
    (args,), B, H, W = rec.calls, *shape[:3]
    assert args[4:10] == (B, H, W, shape[-1], k, cout)
    want = (cuda_conv.choose_tile(B, H, W, shape[-1], cout) if tiled
            else cuda_conv.GENERIC_TILE)
    assert args[10:] == want
    # R = 8 is a tile only at the real classes (two weights a tap)
    refused = (16, 1, 1) if shape[-1] * cout == 2 else (8, 1, 1)
    with pytest.raises(ValueError):
        cuda_conv.launch_conv(x, w, torch.empty(cout, device="meta"), refused)
    if not tiled:
        with pytest.raises(ValueError, match="no tiled body"):
            cuda_conv.launch_conv(x, w, torch.empty(cout, device="meta"), (2, 8, 8))


def test_spatial_gate_off_the_cpu_is_two_launches(monkeypatch):
    pool, gate = _Recorder(), _Recorder()
    monkeypatch.setattr(cuda_conv, "POOL", pool)
    monkeypatch.setattr(cuda_conv, "GATE", gate)
    re = torch.empty((4, 8, 251, 128), device="meta")
    out_re, out_im = cuda_conv.spatial_gate(re, re, torch.empty((7, 7, 4, 2), device="meta"))
    assert out_re.shape == re.shape and out_im.shape == re.shape
    assert len(pool.calls) == 1 and len(gate.calls) == 1
    assert pool.calls[0][3:] == (4, 8, 251, 128)
    assert gate.calls[0][6:] == (4, 8, 251, 128) + cuda_conv.gate_tile(4, 8, 251, 4, 2)
    with pytest.raises(ValueError, match="7, 7, 4, 2"):
        cuda_conv.sa_gate(torch.empty((4, 8, 251, 4), device="meta"),
                          torch.empty((5, 5, 4, 2), device="meta"), re, re)


def test_gate_launch_counts_as_one_of_kernel_2():
    """The gate entry runs kernel 2's conv body, so its launches count on the
    conv's counter too; the pooling pass counts on its own only."""
    assert cuda_conv.GATE.counted_with is cuda_conv.KERNEL
    assert cuda_conv.POOL.counted_with is None and cuda_conv.KERNEL.counted_with is None


@pytest.mark.parametrize("shape", [(2, 6, 9, 16), (1, 3, 5, 1), (2, 4, 4, 6)])
def test_spatial_gate_plain_is_the_eager_sequence(shape):
    """pooled order [mean re, max re, mean im, max im]; out = x * sigmoid(conv)
    as the complex product with the 2-channel map read as (a_re, a_im)."""
    re, im = torch.from_numpy(_np(shape, 60)), torch.from_numpy(_np(shape, 61))
    w = torch.from_numpy(_np((7, 7, 4, 2), 62, 0.3))
    pooled = cuda_conv.sa_pool(re, im)
    torch.testing.assert_close(pooled[..., 0], re.mean(-1))
    torch.testing.assert_close(pooled[..., 1], re.amax(-1))
    torch.testing.assert_close(pooled[..., 2], im.mean(-1))
    torch.testing.assert_close(pooled[..., 3], im.amax(-1))
    a = torch.sigmoid(torch.nn.functional.conv2d(
        pooled.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=3)).permute(0, 2, 3, 1)
    z = torch.complex(re, im) * torch.complex(a[..., :1], a[..., 1:])
    got_re, got_im = cuda_conv.spatial_gate(re, im, w)
    torch.testing.assert_close(got_re, z.real, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_im, z.imag, rtol=1e-5, atol=1e-5)


def _close(got, want, rel=1e-5):
    """|got - want| <= rel * max |want|: the bound the Functions' backward
    rules are held to against the JAX package's."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * float(np.abs(want).max()))


def _function_grads(fn, inputs, g):
    """Forward ``fn`` on leaf copies of ``inputs``, then backward with ``g``:
    (output, the inputs' gradients)."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y = fn(*leaves)
    y.backward(torch.from_numpy(g))
    return y.detach().numpy(), [t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("shape,k,cout", SMALL_COUT)
def test_conv_same_function_backward_matches_jax_bwd(shape, k, cout):
    """Conv2dSameSmallCout's forward and backward on CPU tensors against the
    JAX custom_vjp's forward (Pallas, interpret mode) and backward rule
    (``pallas_conv._bwd``): dx, dw, db."""
    x, w, b = _np(shape, 70), _np((k, k, shape[-1], cout), 71, 0.1), _np((cout,), 72)
    g = _np(shape[:3] + (cout,), 73)
    y, (dx, dw, db) = _function_grads(cuda_conv.Conv2dSameSmallCout.apply, (x, w, b), g)
    want_y = _conv_fwd_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              interpret=True)
    want = jax.jit(pallas_conv._bwd)((jnp.asarray(x), jnp.asarray(w)), jnp.asarray(g))
    _close(y, want_y)
    for got, ref in zip((dx, dw, db), want):
        _close(got, ref)


@pytest.mark.parametrize("shape,k,cout", SMALL_COUT)
def test_conv_same_dgrad_is_the_forward_with_the_flipped_kernel(shape, k, cout):
    """The input gradient of the plain conv equals the plain conv of the
    upstream gradient with ``dgrad_kernel(w)``, Cin and Cout swapped (for
    the spatial attention (7, 4, 2) -> (7, 2, 4)), zero bias; and the weight
    gradient equals ``weight_grad``."""
    x = torch.from_numpy(_np(shape, 74)).requires_grad_()
    w = torch.from_numpy(_np((k, k, shape[-1], cout), 75, 0.1)).requires_grad_()
    g = torch.from_numpy(_np(shape[:3] + (cout,), 76))
    cuda_conv.conv2d_same_small_cout_plain(x, w, torch.zeros(cout)).backward(g)
    wt = cuda_conv.dgrad_kernel(w.detach())
    assert wt.shape == (k, k, cout, shape[-1])
    dx = cuda_conv.conv2d_same_small_cout_plain(g, wt, torch.zeros(shape[-1]))
    torch.testing.assert_close(dx, x.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cuda_conv.weight_grad(x.detach(), g, k), w.grad,
                               rtol=1e-5, atol=1e-5)


# kernel 3's input gradient at the train step's decoder classes: dec0-dec5
# carry many channels both ways; dec6's unified N = 2x2 phases x 2 = 8 becomes
# the input gradient's Cin' = 8, a quarter of one 32-channel chunk
TAPCONV_GRAD = [
    ((2, 6, 9, 64), (3, 3), 32),
    ((2, 10, 12, 32), (3, 3), 8),       # dec6's class: Cin' = 8, N' = 32
    ((2, 5, 7, 24), (2, 2), 12),
]


@pytest.mark.parametrize("shape,taps,n", TAPCONV_GRAD)
def test_tapconv_function_backward_matches_jax_updot(shape, taps, n):
    """TapconvValid's forward and backward on CPU tensors against
    ``jax.vjp`` through the JAX package's ``_updot`` custom_vjp (its XLA
    forward on the CPU, ``_updot_bwd``): dxp and dkbig."""
    dh_n, dw_n = taps
    x, w = _np(shape, 77), _np((dh_n * dw_n, shape[-1], n), 78, 0.1)
    g = _np((shape[0], shape[1] - dh_n + 1, shape[2] - dw_n + 1, n), 79)
    y, (dx, dw) = _function_grads(
        lambda a, b: cuda_tapconv.TapconvValid.apply(a, b, dh_n, dw_n), (x, w), g)
    want_y, vjp = jax.vjp(lambda a, b: jce._updot(a, b, taps), jnp.asarray(x),
                          jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    _close(y, want_y)
    _close(dx, want_dx)
    _close(dw, want_dw)


@pytest.mark.parametrize("shape,taps,n", TAPCONV_GRAD)
def test_tapconv_dgrad_is_a_valid_tap_correlation(shape, taps, n):
    """The input gradient of the plain tap correlation equals the plain tap
    correlation of the upstream gradient padded by (Dh - 1, Dw - 1) with
    ``dgrad_weights(w)`` (Cin' = N, N' = Cin), exactly (B, Hp, Wp, Cin); the
    weight gradient equals ``weight_grad``."""
    dh_n, dw_n = taps
    x = torch.from_numpy(_np(shape, 80)).requires_grad_()
    w = torch.from_numpy(_np((dh_n * dw_n, shape[-1], n), 81, 0.1)).requires_grad_()
    g = torch.from_numpy(_np((shape[0], shape[1] - dh_n + 1, shape[2] - dw_n + 1, n), 82))
    cuda_tapconv.tapconv_valid_plain(x, w, dh_n, dw_n).backward(g)
    gp = cuda_tapconv.dgrad_input(g, dh_n, dw_n)
    wt = cuda_tapconv.dgrad_weights(w.detach())
    assert wt.shape == (dh_n * dw_n, n, shape[-1])
    dx = cuda_tapconv.tapconv_valid_plain(gp, wt, dh_n, dw_n)
    assert dx.shape == shape
    torch.testing.assert_close(dx, x.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(cuda_tapconv.weight_grad(x.detach(), g, dh_n, dw_n),
                               w.grad, rtol=1e-5, atol=1e-5)


# TAPCONV_GRAD's cases with the zero padding passed to the tap conv:
# (top, bottom, left, right)
TAPCONV_PADS = [(1, 1, 1, 1), (1, 1, 1, 1), (0, 1, 1, 0)]


@pytest.mark.parametrize("case,pad", list(zip(TAPCONV_GRAD, TAPCONV_PADS)))
def test_tapconv_function_with_pad_matches_jax_updot_of_padded_input(case, pad):
    """TapconvValid with ``pad`` (the padding the decoder's unified conv
    applies) on CPU tensors against ``jax.vjp`` of the JAX ``_updot`` of
    ``jnp.pad(x, pads)``: y, dx (of x's own pixels) and dkbig."""
    shape, taps, n = case
    dh_n, dw_n = taps
    top, bottom, left, right = pad
    xshape = (shape[0], shape[1] - top - bottom, shape[2] - left - right, shape[3])
    x, w = _np(xshape, 83), _np((dh_n * dw_n, shape[-1], n), 84, 0.1)
    g = _np((shape[0], shape[1] - dh_n + 1, shape[2] - dw_n + 1, n), 85)
    y, (dx, dw) = _function_grads(
        lambda a, b: cuda_tapconv.TapconvValid.apply(a, b, dh_n, dw_n, pad), (x, w), g)
    pads = ((0, 0), (top, bottom), (left, right), (0, 0))
    want_y, vjp = jax.vjp(lambda a, b: jce._updot(jnp.pad(a, pads), b, taps),
                          jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(g))
    assert dx.shape == xshape
    _close(y, want_y)
    _close(dx, want_dx)
    _close(dw, want_dw)


def _dgrad_model(g, w, dh_n, dw_n, pad, hw, flat, wgs):
    """Kernel 3's input-gradient entry, its indexing in numpy: the entry's
    model (``entry_model``: flat or one-row tiles, zero fill outside the
    tensor read, skipped tap rows) on g read in place with the flipped,
    transposed weights, at (oh, ow) = (top - (Dh - 1), left - (Dw - 1)),
    without a split. Returns dx and how often each pixel was written."""
    wt = np.ascontiguousarray(w[::-1].transpose(0, 2, 1))    # (taps, N, Cin)
    kb, _ = cuda_tapconv.dgrad_tiles(g.shape[-1], w.shape[1])
    dx, _, stored = entry_model(g, wt, dh_n, dw_n, pad[0] - (dh_n - 1),
                                pad[2] - (dw_n - 1), hw, flat, wgs, 1, kb)
    return dx, stored


DGRAD_CASES = [
    # (B, H, W, N -> Cin), (Dh, Dw), pad (top, bottom, left, right)
    ((3, 2, 32, 8, 6), (3, 3), (1, 1, 1, 1)),      # dec0's 2 x 32, narrowed
    ((2, 4, 32, 5, 3), (3, 3), (1, 1, 1, 1)),      # dec1
    ((2, 8, 32, 4, 4), (3, 3), (1, 1, 1, 1)),      # dec2
    ((1, 5, 64, 4, 2), (3, 3), (1, 1, 1, 1)),      # dec5's width, rows cut
    ((2, 3, 33, 3, 5), (3, 3), (1, 1, 1, 1)),      # ragged: tiles cross rows
    ((3, 1, 65, 6, 3), (3, 3), (1, 1, 1, 1)),      # H = 1: the outer tap rows skip
    ((2, 7, 1, 4, 3), (3, 3), (1, 1, 1, 1)),       # W = 1
    ((1, 2, 130, 4, 3), (3, 3), (1, 1, 1, 1)),     # one row a tile, ragged
    ((2, 5, 9, 3, 4), (2, 2), (0, 1, 1, 0)),       # a 2 x 2 window
    ((1, 6, 20, 3, 2), (5, 5), (2, 2, 0, 4)),      # 5 x 5, uneven padding
    ((2, 6, 20, 4, 32), (3, 3), (1, 1, 1, 1)),     # the real dec6: N = 4 -> 32
]


@pytest.mark.parametrize("case,taps,pad", DGRAD_CASES)
@pytest.mark.parametrize("flat,wgs", [(1, 1), (1, 2), (0, 1), (0, 2), (None, None)])
def test_dgrad_tiling_model_writes_each_pixel_once_and_equals_plain(case, taps, pad,
                                                                   flat, wgs):
    """At narrowed stage shapes and ragged ones, under each tiling (and the
    one ``dgrad_plan`` picks), the model of the input-gradient entry writes
    every pixel of dx exactly once and equals ``tapconv_dgrad_plain``."""
    B, H, W, n, cin = case
    dh_n, dw_n = taps
    if flat is None:
        _, _, flat, wgs = cuda_tapconv.dgrad_plan(B, H, W, n, cin, dh_n, dw_n)
    ho = H + pad[0] + pad[1] - dh_n + 1
    wo = W + pad[2] + pad[3] - dw_n + 1
    g, w = _np((B, ho, wo, n), 86), _np((dh_n * dw_n, cin, n), 87, 0.2)
    got, writes = _dgrad_model(g, w, dh_n, dw_n, pad, (H, W), flat, wgs)
    assert (writes == 1).all()
    want = cuda_tapconv.tapconv_dgrad_plain(torch.from_numpy(g), torch.from_numpy(w),
                                            dh_n, dw_n, pad, (H, W))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)


# the train step's decoder stages (batch 32): dx H x W, the forward's N
# (the input gradient's reduction) and Cin (its outputs)
TRAIN_DGRAD_STAGES = [(2, 32, 512, 512), (4, 32, 512, 512), (8, 32, 512, 256),
                      (16, 32, 256, 128), (32, 32, 128, 128), (64, 64, 64, 64),
                      (128, 128, 8, 32), (128, 128, 4, 32)]


@pytest.mark.parametrize("H,W,n,cin", TRAIN_DGRAD_STAGES)
def test_dgrad_plan_fills_the_wgmma_rows_at_the_train_stages(H, W, n, cin):
    """At every decoder stage of the train step at least 90 % of the M rows
    the entry computes hold pixels of dx (one-row tiles of 64 pixels filled
    34 of 64 at 32-column images), its halo tiles fit shared memory, and
    dec6's class (N = 8 -> Cin 32, the real family's N = 4 -> 32) takes
    8-channel chunks and 32-wide N tiles."""
    B = 32
    kb, bn, flat, wgs = cuda_tapconv.dgrad_plan(B, H, W, n, cin, 3, 3)
    tiles, arows, apw = cuda_tapconv.tiling(flat, wgs, H, W, 3, 3)
    rows = B * tiles * (1 if flat else H) * 64 * wgs
    assert B * H * W / rows >= 0.9
    assert cuda_tapconv.smem_bytes(kb, bn, 1, n, 9, arows, apw) <= 227 * 1024
    assert (kb, bn) == ((8, 32) if n <= 8 else (32, 128 if cin > 64 else 64))


@pytest.mark.parametrize("taps,cin,n", [(9, 32, 8), (9, 512, 256), (4, 24, 12),
                                        (9, 5, 33), (1, 36, 5), (9, 32, 4)])
def test_dgrad_packing_layout_is_pack_weights_of_the_flipped_weights(taps, cin, n):
    """The packing entry of the input gradient, its index math in numpy
    (thread (n tile, chunk, tap, 4-channel group j, n) reads w[taps - 1 -
    tap, n, 4 j + i] of the forward's w, zero past N and Cin), equals
    ``pack_weights(dgrad_weights(w))`` at the same chunk and tile."""
    w = _np((taps, cin, n), 88, 0.1)
    kb, bn = cuda_tapconv.dgrad_tiles(n, cin)
    want = cuda_tapconv.pack_weights(cuda_tapconv.dgrad_weights(torch.from_numpy(w)),
                                      bn, kb)
    nt, nc = -(-cin // bn), -(-n // kb)
    t, c, tap, j, m, i = np.meshgrid(np.arange(nt), np.arange(nc), np.arange(taps),
                                     np.arange(kb // 4), np.arange(bn), np.arange(4),
                                     indexing="ij")
    ch, out = c * kb + 4 * j + i, t * bn + m
    ok = (ch < n) & (out < cin)
    v = np.where(ok, w[taps - 1 - tap, np.minimum(out, cin - 1), np.minimum(ch, n - 1)], 0)
    hi, lo = cuda_tapconv.split_tf32(torch.from_numpy(v.astype(np.float32)))
    assert want.shape == (nt, nc, taps, 2, kb // 4, bn, 4)
    assert torch.equal(want[:, :, :, 0], hi) and torch.equal(want[:, :, :, 1], lo)


def test_conv_same_off_the_cpu_carries_gradients_through_kernel_2(monkeypatch):
    """Meta tensors stand in for the card's: the conv's output is attached to
    Conv2dSameSmallCout, whose backward launches kernel 2 once more for the
    input gradient (class (7, 2, 4): the register-tiled body, at the tile
    the forward takes), counted as DGRAD."""
    fwd, dgrad = _Recorder(), _Recorder()
    monkeypatch.setattr(cuda_conv, "KERNEL", fwd)
    monkeypatch.setattr(cuda_conv, "DGRAD", dgrad)
    x = torch.empty((4, 16, 251, 4), device="meta", requires_grad=True)
    w = torch.empty((7, 7, 4, 2), device="meta", requires_grad=True)
    b = torch.empty(2, device="meta", requires_grad=True)
    y = cuda_conv.conv2d_same_small_cout(x, w, b)
    assert type(y.grad_fn).__name__ == "Conv2dSameSmallCoutBackward"
    assert len(fwd.calls) == 1 and not dgrad.calls
    y.backward(torch.empty_like(y))
    (args,) = dgrad.calls
    assert args[4:] == (4, 16, 251, 2, 7, 4) + cuda_conv.choose_tile(4, 16, 251, 2, 4)
    assert len(fwd.calls) == 1
    assert x.grad.shape == x.shape and w.grad.shape == w.shape and b.grad.shape == b.shape


def test_tapconv_off_the_cpu_carries_gradients_through_kernel_3(monkeypatch):
    """The tap conv's output is attached to TapconvValid, whose forward hands
    the kernel x unpadded with the padding offsets; its backward packs
    the flipped, transposed weights straight from w and launches the
    input-gradient entry on g unpadded, writing x's own pixels (Cin' = N =
    8, N' = Cin = 32: dec6's class, with its small-K tiles), counted
    apart."""
    recs = {name: _Recorder() for name in ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK")}
    for name, rec in recs.items():
        monkeypatch.setattr(cuda_tapconv, name, rec)
    x = torch.empty((2, 128, 256, 32), device="meta", requires_grad=True)
    w = torch.empty((9, 32, 8), device="meta", requires_grad=True)
    y = cuda_tapconv.tapconv_valid(x, w, 3, 3, (1, 1, 1, 1))
    assert type(y.grad_fn).__name__ == "TapconvValidBackward"
    bn, flat, wgs, split = cuda_tapconv.forward_plan(2, 128, 256, 32, 8, 3, 3, (1, 1, 1, 1))
    assert recs["KERNEL"].calls[0][3:] == (2, 128, 256, 32, 128, 256, 8, 3, 3, 1, 1,
                                           flat, wgs, bn, split)
    y.backward(torch.empty_like(y))
    assert [len(recs[k].calls) for k in ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK")] == [1, 1, 1, 1]
    kb, bn, flat, wgs = cuda_tapconv.dgrad_plan(2, 128, 256, 8, 32, 3, 3)
    assert (kb, bn, flat) == (8, 32, 0)
    assert recs["DGRAD"].calls[0][3:] == (2, 128, 256, 8, 128, 256, 32, 3, 3, 1, 1,
                                          flat, wgs, kb, bn)
    assert recs["DGRAD_PACK"].calls[0][2:] == (9, 32, 8, kb, bn)
    assert x.grad.shape == x.shape and w.grad.shape == w.shape


def test_decoder_conv_off_the_cpu_takes_the_input_gradient_entry(monkeypatch):
    """The decoder's unified conv hands the tap conv x and the window's
    padding: on the card its backward launches the input-gradient entry
    with that padding and returns the gradient of x's own shape; a launch
    that fails raises out of the backward (no other route is taken)."""
    recs = {name: _Recorder() for name in ("KERNEL", "PACK", "DGRAD", "DGRAD_PACK")}
    for name, rec in recs.items():
        monkeypatch.setattr(cuda_tapconv, name, rec)
    x = torch.empty((2, 4, 32, 16), device="meta", requires_grad=True)
    w = torch.empty((3, 3, 16, 6), device="meta", requires_grad=True)
    y = tce.upsampled_conv2d_multi([x], [w], (2, 1))
    assert y.shape == (2, 8, 32, 6)
    y.backward(torch.empty_like(y))
    (args,) = recs["DGRAD"].calls
    assert args[3:14] == (2, 4, 32, 12, 4, 32, 16, 3, 3, 1, 1)
    assert x.grad.shape == x.shape

    def refuse(device, *args):
        raise RuntimeError("CUDA kernel tapconv_valid_dgrad failed to launch")

    monkeypatch.setattr(cuda_tapconv, "DGRAD", refuse)
    y = tce.upsampled_conv2d_multi([x], [w], (2, 1))
    with pytest.raises(RuntimeError, match="tapconv_valid_dgrad"):
        y.backward(torch.empty_like(y))


def test_fused_gate_raises_under_grad_and_the_module_unfuses(monkeypatch):
    """The pool and gate entries are forward-only: on the card, under grad,
    they raise. ComplexSpatialAttention.gate then takes the un-fused form,
    whose conv is Conv2dSameSmallCout; under no_grad it keeps the fused
    pool + gate launches."""
    recs = {name: _Recorder() for name in ("KERNEL", "POOL", "GATE")}
    for name, rec in recs.items():
        monkeypatch.setattr(cuda_conv, name, rec)
    re = torch.empty((2, 8, 20, 16), device="meta", requires_grad=True)
    w = torch.empty((7, 7, 4, 2), device="meta")
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.sa_pool(re, re)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.sa_gate(torch.empty((2, 8, 20, 4), device="meta"), w, re, re)
    sa = attention.ComplexSpatialAttention(7).to("meta")
    x = CArray(re, torch.empty_like(re))
    out = sa.gate(x)
    assert len(recs["KERNEL"].calls) == 1 and not recs["POOL"].calls
    assert out.re.requires_grad
    with torch.no_grad():
        sa.gate(x)
    assert len(recs["POOL"].calls) == 1 and len(recs["GATE"].calls) == 1


def test_kernels_skip_their_function_where_autograd_follows_nothing(monkeypatch):
    """Under no_grad, or on operands that need no gradient, kernels 2 and 3
    launch without their autograd Function (the enhance paths' host cost
    stays as it was): one forward launch each, no grad_fn."""
    conv, tap, pack = _Recorder(), _Recorder(), _Recorder()
    monkeypatch.setattr(cuda_conv, "KERNEL", conv)
    monkeypatch.setattr(cuda_tapconv, "KERNEL", tap)
    monkeypatch.setattr(cuda_tapconv, "PACK", pack)
    x = torch.empty((2, 16, 20, 4), device="meta", requires_grad=True)
    w = torch.empty((7, 7, 4, 2), device="meta", requires_grad=True)
    b = torch.empty(2, device="meta")
    xt = torch.empty((2, 10, 12, 32), device="meta")
    wt = torch.empty((9, 32, 8), device="meta")
    with torch.no_grad():
        assert cuda_conv.conv2d_same_small_cout(x, w, b).grad_fn is None
    assert cuda_tapconv.tapconv_valid(xt, wt, 3, 3).grad_fn is None
    assert len(conv.calls) == len(tap.calls) == len(pack.calls) == 1
