"""Kernel 3's bf16 input gradient as the card runs it, on the CPU: a numpy
model of the narrow-reduction body's loop (dec6) built from the wrapper's
own tiling, tap folding and column order, and the staged body's input
gradient on the forward's packing read MN-major (``staged_model``'s
transposed form), against the plain version and the JAX ``_updot_bwd`` at
bf16; the routing of every variant's decoder on meta tensors. Band: a bf16
output within 2^-7 of its largest value (the kernels and the plain version
sum exact bf16 products in float32 and round once).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcs_net_tpu.ops.conv_engine import _updot_bwd

from dcs_net_tpu_torch.ops import cuda_tapconv as ct
from dcs_net_tpu_torch.tools.time_dgrad_bf16 import stages

from test_torch_bf16_kernels import BF16_OUT, _bf16, _rel, staged_model
from test_torch_train import _one_torch_thread  # noqa: F401

B16 = torch.bfloat16


def narrow_model(g, w, pad, hw):
    """The narrow body: tile (b, rows 4 r.., columns 64 c..) stages g's halo
    of 6 x 66 pixels from (4 r + top - 2, 64 c + left - 2) with C channels a
    pixel (zeros outside g and past N); warp i computes output row 4 r + i
    in four m16 tiles of 16 columns, A[p, k] = the halo at row i + tap // 3,
    column 16 m + p + tap % 3, channel k % C for tap = min(k // C, 8), B[k,
    8 j + col] = w[8 - k // C, narrow_channel(j, col), k % C] (zero past
    tap 8, N and Cin), one float32 product, stored at the column's channel
    where the pixel and the channel exist. Returns dx (B, H, W, Cin) as
    float32 rounded to bf16 and each value's store count."""
    B, HO, WO, n = g.shape
    cin = w.shape[1]
    H, W = hw
    C, S = ct.narrow_fold(n)
    R, TW = ct.NARROW_ROWS, ct.NARROW_COLS
    gb, wb = _bf16(g), _bf16(w)
    k = np.arange(16 * S)
    tap, ch = k // C, k % C
    tc = np.minimum(tap, 8)
    chan = np.array([ct.narrow_channel(j, col) for j in range(4) for col in range(8)])
    live = (tap[:, None] < 9) & (ch[:, None] < n) & (chan[None, :] < cin)
    bm = np.where(live, wb[8 - tc[:, None], np.minimum(chan, cin - 1)[None, :],
                           np.minimum(ch, n - 1)[:, None]], 0.0).astype(np.float32)
    dx = np.full((B, H, W, cin), np.nan, np.float32)
    stored = np.zeros((B, H, W, cin), np.int64)
    for b in range(B):
        for h0 in range(0, H, R):
            for w0 in range(0, W, TW):
                rr = h0 + pad[0] - 2 + np.arange(R + 2)
                cc = w0 + pad[2] - 2 + np.arange(TW + 2)
                inside = ((rr >= 0) & (rr < HO))[:, None] & ((cc >= 0) & (cc < WO))[None, :]
                halo = np.zeros((R + 2, TW + 2, C), np.float32)
                vals = gb[b][np.clip(rr, 0, HO - 1)[:, None], np.clip(cc, 0, WO - 1)[None, :]]
                halo[..., :n] = np.where(inside[..., None], vals, 0.0)
                for i in range(R):
                    if h0 + i >= H:
                        continue
                    for m in range(TW // 16):
                        if w0 + 16 * m >= W:
                            continue
                        p = 16 * m + np.arange(16)
                        a = halo[i + tc[None, :] // 3, p[:, None] + tc[None, :] % 3, ch[None, :]]
                        d = a @ bm
                        for row in range(16):
                            wc = w0 + 16 * m + row
                            ok = chan < cin
                            if wc < W:
                                dx[b, h0 + i, wc, chan[ok]] = d[row, ok]
                                stored[b, h0 + i, wc, chan[ok]] += 1
    return _bf16(dx), stored


def _case(B, H, W, cin, n, pad, seed):
    rng = np.random.default_rng(seed)
    ho, wo = H + pad[0] + pad[1] - 2, W + pad[2] + pad[3] - 2
    g = rng.standard_normal((B, ho, wo, n)).astype(np.float32)
    w = (rng.standard_normal((9, cin, n)) / (3 * np.sqrt(cin))).astype(np.float32)
    return g, w


def _plain(g, w, pad, hw):
    return ct.tapconv_dgrad_bf16_plain(torch.from_numpy(g), torch.from_numpy(w), 3, 3, pad,
                                       hw).float().numpy()


@pytest.mark.parametrize("B,H,W,cin,n,pad", [
    (2, 4, 64, 32, 4, (1, 1, 1, 1)),      # DR/DRS dec6's class, whole tiles
    (2, 4, 64, 32, 8, (1, 1, 1, 1)),      # DC/DCS dec6's class
    (1, 7, 70, 32, 4, (1, 1, 1, 1)),      # a ragged last tile in rows and columns
    (1, 5, 37, 32, 8, (0, 2, 2, 1)),      # uneven padding, ragged tiles
    (2, 3, 20, 20, 3, (2, 0, 1, 1)),      # N no multiple of 4, Cin no multiple of 8
    (1, 6, 9, 8, 5, (1, 1, 0, 2)),        # N = 5 in 8 slots, Cin 8
], ids=["drs-dec6", "dcs-dec6", "ragged", "uneven-pad", "n3-cin20", "n5-cin8"])
def test_narrow_model_equals_plain(B, H, W, cin, n, pad):
    """The narrow body's loop writes every value of dx once and equals the
    plain version within a bf16 unit."""
    g, w = _case(B, H, W, cin, n, pad, B * H + W + n)
    dx, stored = narrow_model(g, w, pad, (H, W))
    assert (stored == 1).all() and np.isfinite(dx).all()
    assert _rel(dx, _plain(g, w, pad, (H, W))) <= BF16_OUT


@pytest.mark.parametrize("n", [4, 8])
def test_narrow_model_equals_jax_updot_bwd_at_bf16(n):
    """The model against the dx of the JAX ``_updot_bwd`` at bf16 (its
    gradient of the padded x, whose interior is x's), on numpy inputs."""
    H, W, cin, pad = 5, 70, 32, (1, 1, 1, 1)
    g, w = _case(2, H, W, cin, n, pad, 40 + n)
    xp = jnp.zeros((2, H + 2, W + 2, cin), jnp.bfloat16)
    dxp, _ = _updot_bwd((3, 3), (xp, jnp.asarray(w, jnp.bfloat16)), jnp.asarray(g))
    want = np.asarray(jnp.asarray(dxp, jnp.float32))[:, 1:1 + H, 1:1 + W]
    dx, _ = narrow_model(g, w, pad, (H, W))
    assert _rel(dx, want) <= BF16_OUT


def test_narrow_fold_and_column_order():
    """K = 9 taps x C slots in k16 steps (36 -> 48, 72 -> 80), and the 32
    columns of the N tile a permutation of Cin 0-31 in which a thread's
    columns (2 q and 2 q + 1 of every n8 tile) are channels 8 q .. 8 q + 7."""
    assert ct.narrow_fold(4) == (4, 3) and ct.narrow_fold(8) == (8, 5)
    assert ct.narrow_fold(1) == (4, 3) and ct.narrow_fold(5) == (8, 5)
    cols = [ct.narrow_channel(j, c) for j in range(4) for c in range(8)]
    assert sorted(cols) == list(range(32))
    for q in range(4):
        assert sorted(ct.narrow_channel(j, 2 * q + e) for j in range(4) for e in (0, 1)) == \
            list(range(8 * q, 8 * q + 8))


@pytest.mark.parametrize("B,H,W,cin,n,pad,fkb,plan", [
    (2, 3, 9, 40, 24, (1, 1, 1, 1), 16, None),           # a box of Cin chunks past the tile
    (1, 4, 6, 40, 136, (1, 0, 1, 1), 16, None),          # N over two tiles of the forward
    (2, 2, 12, 36, 16, (1, 1, 1, 1), 32, None),          # the forward tap body's packing
    (2, 2, 32, 64, 64, (1, 1, 1, 1), 16, (64, 0, 1, 2)),  # a dec0-like row tile, split 2
    (1, 4, 6, 72, 32, (1, 1, 1, 1), 16, (128, 1, 2, 1)),  # 128-wide N tile, two warpgroups
    (2, 3, 22, 32, 32, (1, 1, 1, 1), 16, (64, 2, 1, 2)),  # planes: a tile from mid-row, split
    (1, 2, 32, 512, 64, (1, 1, 1, 1), 16, None),         # dec0's image: one plane tile of 64
], ids=["box-past-tile", "two-n-tiles", "tap-packing", "row-split", "bn128", "planes-split",
        "dec0-image"])
def test_staged_input_gradient_on_the_forward_packing_equals_plain(B, H, W, cin, n, pad,
                                                                   fkb, plan):
    """The staged body's input gradient reading the forward's packing
    MN-major (the transpose bit), taps in reverse order, on the halo grid's
    tiles and in planes (flat = 2: no halo columns among the M rows),
    writes every pixel once and equals the plain version within a bf16
    unit."""
    g, w = _case(B, H, W, cin, n, pad, B + H + W + cin)
    gpad = ct.dgrad_pad_bf16(pad, 3, 3)
    ho, wo = g.shape[1:3]
    assert ct.dgrad_body_bf16(B, ho, wo, n, cin, 3, 3, gpad) == "staged"
    plan = plan or ct.forward_plan(B, ho, wo, n, cin, 3, 3, gpad, bf16=True, body="staged",
                                   planes=True)
    dx, stored = staged_model(g, w, gpad, plan, transposed=True, fkb=fkb)
    assert dx.shape == (B, H, W, cin)
    assert (stored == 1).all() and np.isfinite(dx).all()
    assert _rel(dx, _plain(g, w, pad, (H, W))) <= BF16_OUT


@pytest.mark.parametrize("variant", ["dcs", "dc", "drs", "dr"])
def test_train_step_routes_dec6_to_the_narrow_body(variant):
    """At a bf16 train step (32 x 8160: 256 frames) every variant's dec6
    input gradient (N = 4 or 8 to Cin 32) takes the narrow body and dec0-dec5
    the staged body, each with a plan that fits: dec0 and dec1 (a half and
    two thirds of the halo grid's M rows live) in planes, dec2-dec5 on the
    halo grid."""
    bodies, flats = [], []
    gpad = ct.dgrad_pad_bf16((1, 1, 1, 1), 3, 3)
    for _, B, H, W, cin, n in stages(variant, 32, 256):
        body = ct.dgrad_body_bf16(B, H, W, n, cin, 3, 3, gpad)
        if body == "staged":
            bn, flat, wgs, split = ct.forward_plan(B, H, W, n, cin, 3, 3, gpad, bf16=True,
                                                   body=body, planes=True)
            npix = ct.staged_tiling(flat, wgs, H, W, 3, 3)[3] * (3 if flat == 2 else 1)
            assert ct.staged_smem(bn, wgs, 9, npix, n, split) <= ct.SMEM_LIMIT
            flats.append(flat)
        bodies.append(body)
    assert bodies == ["staged"] * 6 + ["narrow"]
    assert flats == [2, 2, 1, 1, 1, 1]
    assert (n, cin) == ((8, 32) if variant.startswith("dc") else (4, 32))


class _Rec:
    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(tuple(a for a in args if isinstance(a, int)))


@pytest.mark.parametrize("n,pad", [(4, (1, 1, 1, 1)), (8, (0, 2, 1, 1))])
def test_narrow_launch_on_meta(monkeypatch, n, pad):
    """Off the CPU (meta: the card's route, the kernels stubbed) the narrow
    class launches once on g and w as they are, with the forward's padding,
    and nothing else: no packing, no other body; a bf16 dx of x's pixels."""
    recs = {k: _Rec() for k in ("DGRAD_NARROW_BF16", "DGRAD_BF16", "DGRAD_BF16_TAP",
                                "DGRAD_PACK_BF16", "PACK_BF16")}
    for k, r in recs.items():
        monkeypatch.setattr(ct, k, r)
    H, W = 128, 128
    ho, wo = H + pad[0] + pad[1] - 2, W + pad[2] + pad[3] - 2
    g = torch.empty((32, ho, wo, n), device="meta", dtype=B16)
    w = torch.empty((9, 32, n), device="meta", dtype=B16)
    dx = ct._launch_dgrad(g, w, 3, 3, pad, (H, W))
    assert dx.dtype == B16 and dx.shape == (32, H, W, 32)
    assert recs["DGRAD_NARROW_BF16"].calls == [(32, ho, wo, n, H, W, 32, 3, 3, pad[0], pad[2])]
    assert all(not r.calls for k, r in recs.items() if k != "DGRAD_NARROW_BF16")
