"""Kernel 3's forward entry as the card runs it, on the CPU: a numpy model of
its indexing (flat or one-row tiles, x read in place through the padding
offsets with zero fill and skipped tap rows, the channel chunks split among
S ranks whose partial tiles are added in rank order) against the port's
plain version and the JAX package's Pallas kernel in interpret mode; the
plan the wrapper takes from the shape; and, off the CPU, the arguments the
wrapper hands the kernel (x itself, never a padded copy).
"""

import functools
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcs_net_tpu.ops.pallas_tapconv import tapconv_valid as jax_tapconv

from dcs_net_tpu_torch.ops import conv_engine as tce
from dcs_net_tpu_torch.ops import cuda_tapconv as ct

from test_torch_train import _one_torch_thread  # noqa: F401


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def entry_model(src, wk, dh_n, dw_n, oh, ow, out_hw, flat, wgs, split=1, kb=ct.BK):
    """Kernel 3's entry point, its indexing in numpy. ``src`` (B, Hg, Wg, Cg)
    is the tensor read in place, ``wk`` (taps, Cg, N) the weights as the
    packing lays them out; output pixel (h, w) at tap (dh, dw) reads
    src[h + oh + dh, w + ow + dw], zero outside src. Every block (a flat tile
    of BM = 64 * wgs consecutive pixels of one image, or BM pixels of one
    row) stages its halo tile with zero fill outside src (NaN past the rows
    and pixels it stages) and skips the tap rows that read only zeros. Each
    of ``split`` ranks runs its chunks of ``kb`` channels, a chain per chunk
    added in float32, into a partial tile; the partials are added in rank
    order and rank r stores rows [r BM / S, (r + 1) BM / S) of the tile.
    Returns y (B, H, W, N), how often each pixel entered each rank's partial
    tile (split, B * H * W) and how often it was stored (B * H * W)."""
    B, Hg, Wg, Cg = src.shape
    N = wk.shape[-1]
    H, W = out_hw
    bm = 64 * wgs
    tiles, arows, apw = ct.tiling(flat, wgs, H, W, dh_n, dw_n)
    nchunks = -(-Cg // kb)
    y = np.full((B * H * W, N), np.nan, np.float32)
    parts_written = np.zeros((split, B * H * W), np.int64)
    stored = np.zeros(B * H * W, np.int64)
    for blk in range(B * tiles * (1 if flat else H)):
        if flat:
            b, t = divmod(blk, tiles)
            q0 = t * bm
            count = min(bm, H * W - q0)
            h_a, h_b, pw, c0 = q0 // W, (q0 + count - 1) // W, W + dw_n - 1, ow
            q = q0 + np.arange(count)
            hrel, wrel, out = q // W - h_a, q % W, b * H * W + q
        else:
            row, t = divmod(blk, tiles)
            q0 = t * bm
            b, h_a = divmod(row, H)
            count, h_b, pw, c0 = min(bm, W - q0), h_a, bm + dw_n - 1, q0 + ow
            hrel, wrel = np.zeros(count, np.int64), np.arange(count)
            out = row * W + q0 + np.arange(count)
        nr, r0 = h_b - h_a + dh_n, h_a + oh
        assert nr <= arows and pw <= apw
        halo = np.full((arows, apw, Cg), np.nan, np.float32)
        for r in range(nr):
            for p in range(pw):
                rr, cc = r0 + r, c0 + p
                inside = 0 <= rr < Hg and 0 <= cc < Wg
                halo[r, p] = src[b, rr, cc] if inside else 0.0
        dh_lo, dh_hi = max(0, -(h_b + oh)), min(dh_n - 1, Hg - 1 - r0)
        parts = []
        for rank in range(split):
            part = np.zeros((count, N), np.float32)
            for chunk in range(rank * nchunks // split, (rank + 1) * nchunks // split):
                cs = slice(chunk * kb, min((chunk + 1) * kb, Cg))
                chain = np.zeros((count, N), np.float32)
                for dh in range(dh_n):
                    for dw in range(dw_n):
                        a = halo[hrel + dh, wrel + dw, cs]
                        if dh_lo <= dh <= dh_hi:
                            chain += a @ wk[dh * dw_n + dw, cs]
                        else:
                            assert not a.any()      # a skipped row reads only zeros
                part += chain
            parts.append(part)
            parts_written[rank, out] += 1
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        for rank in range(split):
            rows = np.arange(rank * bm // split, min((rank + 1) * bm // split, count))
            y[out[rows]] = total[rows]
            stored[out[rows]] += 1
    return y.reshape(B, H, W, N), parts_written, stored


def forward_model(x, w, dh_n, dw_n, pad, flat, wgs, split):
    """The forward entry: x read in place through (oh, ow) = (-top, -left)."""
    top, bottom, left, right = pad
    H, W = x.shape[1:3]
    ho, wo = H + top + bottom - dh_n + 1, W + left + right - dw_n + 1
    return entry_model(x, w, dh_n, dw_n, -top, -left, (ho, wo), flat, wgs, split)


FWD_CASES = [
    # (B, H, W, Cin, N), (Dh, Dw), pad (top, bottom, left, right)
    ((1, 2, 32, 64, 12), (3, 3), (1, 1, 1, 1)),     # dec0 at batch 1, narrowed
    ((1, 4, 32, 96, 8), (3, 3), (1, 1, 1, 1)),      # dec1
    ((1, 8, 32, 64, 6), (3, 3), (1, 1, 1, 1)),      # dec2
    ((8, 2, 32, 64, 4), (3, 3), (1, 1, 1, 1)),      # dec0 of a streaming chunk group
    ((2, 3, 33, 40, 5), (3, 3), (1, 1, 1, 1)),      # ragged: tiles cross rows
    ((3, 1, 65, 36, 6), (3, 3), (1, 1, 1, 1)),      # H = 1: the outer tap rows skip
    ((2, 7, 1, 33, 4), (3, 3), (1, 1, 1, 1)),       # W = 1
    ((1, 2, 130, 64, 4), (3, 3), (1, 1, 1, 1)),     # one row a tile, ragged
    ((2, 5, 9, 64, 3), (2, 2), (0, 1, 1, 0)),       # a 2 x 2 window
    ((1, 6, 20, 72, 3), (5, 5), (2, 2, 0, 4)),      # 5 x 5, uneven padding
]
FORCED = list(itertools.product((0, 1), (1, 2), (1, 2, 4, 8)))


@functools.lru_cache(maxsize=None)
def _case(i):
    """x, w, the plain version on the padded x, and the Pallas kernel on
    ``jnp.pad(x)`` in interpret mode (one compile a case)."""
    (B, H, W, cin, n), (dh_n, dw_n), pad = FWD_CASES[i]
    x, w = _np((B, H, W, cin), 90 + i), _np((dh_n * dw_n, cin, n), 110 + i, 0.2)
    top, bottom, left, right = pad
    plain = ct.tapconv_valid_plain(ct._pad(torch.from_numpy(x), pad),
                                   torch.from_numpy(w), dh_n, dw_n).numpy()
    pads = ((0, 0), (top, bottom), (left, right), (0, 0))
    pallas = np.asarray(jax_tapconv(jnp.pad(jnp.asarray(x), pads), jnp.asarray(w),
                                    dh_n, dw_n, interpret=True))
    return x, w, plain, pallas


@pytest.mark.parametrize("i", range(len(FWD_CASES)))
@pytest.mark.parametrize("flat,wgs,split", FORCED + [(None, None, None)])
def test_forward_model_writes_each_pixel_once_per_rank_and_equals_plain_and_pallas(
        i, flat, wgs, split):
    """Under every forced (flat, wgs, S) and under ``forward_plan``'s own
    choice, the model of the forward entry puts every output pixel into each
    rank's partial tile once and stores it once, and its sum equals the
    plain version on the padded x and the Pallas kernel on ``jnp.pad(x)``."""
    (B, H, W, cin, n), (dh_n, dw_n), pad = FWD_CASES[i]
    x, w, plain, pallas = _case(i)
    if flat is None:
        _, flat, wgs, split = ct.forward_plan(B, H, W, cin, n, dh_n, dw_n, pad)
    got, parts_written, stored = forward_model(x, w, dh_n, dw_n, pad, flat, wgs, split)
    assert (parts_written == 1).all() and (stored == 1).all()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


# the decoder stages at 256 frames (a test utterance of the eval path, a
# train crop): x H x W, Cin, N, padded by (1, 1, 1, 1); then the real
# family's dec6 (N = 4)
STAGES = [(2, 32, 512, 512), (4, 32, 512, 512), (8, 32, 512, 256),
          (16, 32, 256, 128), (32, 32, 128, 128), (64, 64, 64, 64),
          (128, 128, 32, 8), (128, 128, 32, 4)]
# the same stages in the batch-4 enhance call of 4 s (2008 frames)
ENHANCE_STAGES = [(2, 251, 512, 512), (4, 251, 512, 512), (8, 251, 512, 256),
                  (16, 251, 256, 128), (32, 251, 128, 128), (64, 502, 64, 64),
                  (128, 1004, 32, 8)]
PAD = (1, 1, 1, 1)


def _tiles(B, H, W, flat, wgs):
    return B * ct.tiling(flat, wgs, H, W, 3, 3)[0] * (1 if flat else H)


def _smem(H, W, cin, plan):
    bn, flat, wgs, split = plan
    _, arows, apw = ct.tiling(flat, wgs, H, W, 3, 3)
    return ct.launch_smem(bn, wgs, cin, 9, arows, apw, split)


@pytest.mark.parametrize("H,W,cin,n", STAGES)
def test_forward_plan_splits_the_batch_1_eval_stages_within_one_wave(H, W, cin, n):
    """At batch 1 (one test utterance) a stage whose grid leaves more than
    half of the H100's 132 SMs idle takes a split of 2, 4 or 8, every rank of
    it has a 32-channel chunk, its clusters run in one wave (on the H100 at
    one block an SM: 66 clusters of 2, 30 of 4, 15 of 8), and a block's
    shared memory fits 227 KB; the N tile stays the full one."""
    plan = ct.forward_plan(1, H, W, cin, n, 3, 3, PAD)
    bn, flat, wgs, split = plan
    flat0, wgs0 = ct._tile_plan(1, H, W, cin, n, ct.BK, bn, 3, 3, ct.SMS)
    idle = 2 * _tiles(1, H, W, flat0, wgs0) * -(-n // bn) <= ct.SMS
    assert (split > 1) == (idle and cin > ct.BK)
    assert split in (1, 2, 4, 8) and split <= -(-cin // ct.BK)
    assert bn == ct.tile_n(n)
    assert _tiles(1, H, W, flat, wgs) * -(-n // bn) <= ct.H100_CLUSTERS[split] or split == 1
    assert _smem(H, W, cin, plan) <= 227 * 1024


# chip_smoke.py's sweep of the forward on the H100 (80GB HBM3, 700 W): the
# fastest (flat, wgs, S) at dec0-dec2 at batch 1 and at a chunk group (batch
# 8), where the unsplit grid is under half a wave; x (B, H, W, Cin) -> N
SWEEP_FASTEST = [((1, 2, 32, 512, 512), (0, 1, 8)), ((1, 4, 32, 512, 512), (1, 1, 8)),
                 ((1, 8, 32, 512, 256), (1, 1, 8)), ((8, 2, 32, 512, 512), (0, 1, 2)),
                 ((8, 4, 32, 512, 512), (1, 1, 2)), ((8, 8, 32, 512, 256), (1, 1, 2))]


# the bf16 class's staged body: the fastest tilings of its sweep (chip_smoke.py
# phase "bf16", H100) where the plan's cost model runs (batch 1; at batch 8
# the grid is over half a wave and the plan keeps its default tiling)
BF16_SWEEP_FASTEST = [(("bf16", 1, 2, 32, 512, 512), (0, 1, 8)),
                      (("bf16", 1, 4, 32, 512, 512), (1, 1, 8)),
                      (("bf16", 1, 8, 32, 512, 256), (1, 1, 8))]


@pytest.mark.parametrize("shape,fastest", SWEEP_FASTEST + BF16_SWEEP_FASTEST)
def test_forward_plan_picks_the_sweeps_fastest_tiling(shape, fastest):
    """Where the grid is under half a wave, the plan's cost model picks the
    tiling the sweep on the card measured fastest (of the float32 class, and
    of the bf16 class's staged body for shapes marked "bf16")."""
    bf16 = shape[0] == "bf16"
    B, H, W, cin, n = shape[1:] if bf16 else shape
    assert ct.forward_plan(B, H, W, cin, n, 3, 3, PAD, bf16=bf16)[1:] == fastest


@pytest.mark.parametrize("H,W,cin,n", STAGES)
def test_forward_plan_fills_the_wgmma_rows_at_the_train_stages(H, W, cin, n):
    """At batch 32 (the train step) at least 90 % of the M rows the forward
    computes hold pixels of y (one-row tiles of 64 pixels filled 32 of 64 at
    32-column images), the grid needs no split, and the tiles fit shared
    memory."""
    B = 32
    plan = ct.forward_plan(B, H, W, cin, n, 3, 3, PAD)
    bn, flat, wgs, split = plan
    assert B * H * W / (_tiles(B, H, W, flat, wgs) * 64 * wgs) >= 0.9
    assert (bn, split) == (ct.tile_n(n), 1)
    assert _smem(H, W, cin, plan) <= 227 * 1024


@pytest.mark.parametrize("H,W,cin,n", ENHANCE_STAGES)
def test_forward_plan_keeps_one_row_tiles_at_the_enhance_stages(H, W, cin, n):
    """The batch-4 enhance call's images are wider than 128 columns: one row a
    tile, the full N tile, and no split (the grid fills half a wave)."""
    assert ct.forward_plan(4, H, W, cin, n, 3, 3, PAD) == (
        (ct.tile_n(n), 0) + ct._tile_plan(4, H, W, cin, n, ct.BK, ct.tile_n(n), 3, 3,
                                           ct.SMS)[1:] + (1,))


@pytest.mark.parametrize("H,W,top", [(2, 32, 1), (4, 32, 1), (3, 33, 1), (1, 65, 1),
                                     (7, 1, 1), (6, 20, 2), (5, 9, 0)])
def test_live_taps_are_the_tap_rows_the_model_runs(H, W, top):
    """The plan's count of the taps each M tile runs (``_live_taps``) is what
    the entry's model runs: the tap rows reading inside x for some output
    row of the tile, times Dw."""
    dh_n = dw_n = 5 if top == 2 else 3
    ho = H + 2 * top - dh_n + 1
    for flat, wgs in itertools.product((0, 1), (1, 2)):
        taps = ct._live_taps(flat, wgs, H, ho, W, top, dh_n, dw_n)
        bm = 64 * wgs
        tiles = ct.tiling(flat, wgs, ho, W, dh_n, dw_n)[0] * (1 if flat else ho)
        assert len(taps) == tiles
        for t, live in enumerate(taps):
            rows = (range((t * bm) // W, (min((t + 1) * bm, ho * W) - 1) // W + 1) if flat
                    else [t // -(-W // bm)])
            want = sum(any(0 <= h - top + dh < H for h in rows) for dh in range(dh_n))
            assert live == dw_n * want


class _Recorder:
    """Stands in for a CudaKernel: notes the arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(args)


def _no_padded_copy(*args, **kw):
    raise AssertionError("the forward made a padded copy of x")


@pytest.mark.parametrize("shape,n,pad", [
    ((1, 2, 32, 512), 512, (1, 1, 1, 1)),        # dec0 at batch 1: a split
    ((4, 2, 251, 512), 512, (1, 1, 1, 1)),       # the enhance call: one-row tiles
    ((2, 5, 9, 24), 12, (0, 1, 1, 0)),           # uneven padding
])
def test_tapconv_off_the_cpu_hands_the_kernel_x_unpadded(monkeypatch, shape, n, pad):
    """Off the CPU ``tapconv_valid(x, w, 3, 3, pad)`` hands the kernel x
    itself with x's own extent, the output's, the padding offsets and the
    plan, and makes no padded copy; a refused launch raises (no other route
    is taken)."""
    kernel, pack = _Recorder(), _Recorder()
    monkeypatch.setattr(ct, "KERNEL", kernel)
    monkeypatch.setattr(ct, "PACK", pack)
    monkeypatch.setattr(ct, "_pad", _no_padded_copy)
    monkeypatch.setattr(ct.F, "pad", _no_padded_copy)
    B, H, W, cin = shape
    top, bottom, left, right = pad
    ho, wo = H + top + bottom - 2, W + left + right - 2
    x = torch.empty(shape, device="meta")
    y = ct.tapconv_valid(x, torch.empty((9, cin, n), device="meta"), 3, 3, pad)
    assert y.shape == (B, ho, wo, n)
    (args,) = kernel.calls
    bn, flat, wgs, split = ct.forward_plan(B, H, W, cin, n, 3, 3, pad)
    assert args[3:] == (B, H, W, cin, ho, wo, n, 3, 3, top, left, flat, wgs, bn, split)
    assert pack.calls[0][2:] == (9, cin, n, bn)

    def refuse(device, *args):
        raise RuntimeError("CUDA kernel tapconv_valid failed to launch")

    monkeypatch.setattr(ct, "KERNEL", refuse)
    with pytest.raises(RuntimeError, match="tapconv_valid"):
        ct.tapconv_valid(x, torch.empty((9, cin, n), device="meta"), 3, 3, pad)


def test_decoder_conv_hands_the_kernel_the_concatenated_input_unpadded(monkeypatch):
    """The decoder's unified conv (skip concat + upsample + conv) on the card:
    the kernel reads the concatenation in place, padded by (1, 1, 1, 1)
    through its offsets, at the plan of the output's shape."""
    kernel, pack = _Recorder(), _Recorder()
    monkeypatch.setattr(ct, "KERNEL", kernel)
    monkeypatch.setattr(ct, "PACK", pack)
    monkeypatch.setattr(ct, "_pad", _no_padded_copy)
    xs = [torch.empty((1, 2, 32, 256), device="meta") for _ in range(2)]
    ws = [torch.empty((3, 3, 256, 128), device="meta") for _ in range(2)]
    y = tce.upsampled_conv2d_multi(xs, ws, (2, 1))
    assert y.shape == (1, 4, 32, 128)
    (args,) = kernel.calls
    bn, flat, wgs, split = ct.forward_plan(1, 2, 32, 512, 256, 3, 3, (1, 1, 1, 1))
    assert split > 1
    assert args[3:] == (1, 2, 32, 512, 2, 32, 256, 3, 3, 1, 1, flat, wgs, bn, split)


def _sweep_plans(cin):
    """(flat, wgs, S) the smoke's sweep times at Cin channels."""
    return [(f, w, s) for f, w, s in itertools.product((0, 1), (1, 2), (1, 2, 4, 8))
            if s <= -(-cin // ct.BK)]


def test_fit_tool_recovers_the_step_costs_from_sweep_lines(tmp_path, capsys):
    """``tools/fit_tapconv_plan.py`` reads the smoke's sweep lines and fits
    ``STEP_MS``: on lines whose times are the model's own (waves x steps x
    STEP_MS + 0.01 ms) it recovers the constants in use and names the
    fastest tiling of each shape beside the plan's."""
    from dcs_net_tpu_torch.tools import fit_tapconv_plan as fit

    lines = []
    for (B, H, W, cin, n), _ in SWEEP_FASTEST:
        shape = (B, H, W, cin, n, 3, 3, PAD)
        times = {}
        for flat, wgs, split in _sweep_plans(cin):
            plan = (128, flat, wgs, split)
            f1, f2, _ = fit.features(shape, plan)
            times[plan] = f1 * ct.STEP_MS[1] + f2 * ct.STEP_MS[2] + 0.01
        lines.append(f"kernel tapconv_valid sweep: x ({B}, {H}, {W}, {cin}) -> N {n}, "
                     f"3x3, pad {PAD}; (bn, flat, wgs, S) ms: "
                     + ", ".join(f"{p}={t:.6f}" for p, t in times.items())
                     + "; the plan ...")
    log = tmp_path / "smoke.log"
    log.write_text("\n".join(["device: none"] + lines) + "\n")
    fit.main([str(log)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("STEP_MS = {1: 0.00094, 2: 0.00126} (constant 0.0100 ms)")
    assert len(out) == 1 + len(SWEEP_FASTEST)
