"""Kernel 2's bf16 conv entry on tensor cores (``cuda_conv.launch_conv`` at
bf16, ``csrc/conv_same.cu:conv7_mma_kernel``) on the CPU, at its four
classes: the spatial attention's conv (7, 4, 2) and its input gradient's
(7, 2, 4), the real attention's (7, 2, 1) and (7, 1, 2).

* ``mma_model``: a model of the body at the fragment level, written from
  the wrapper's tables (``mma_class``, ``mma_geometry``) and the kernel's
  own index rules: a block stages its tile as the kernel's copies leave it
  (th + 6 rows of words from ``lead`` columns left of the tile, zero
  outside the image; at Cin 1 two pixels a word), builds the B table word
  by word as ``mma_b_taps`` does, walks each warp task's staged rows,
  gathers every lane's A registers (4 a step) and B registers into the
  m16n8k16 operands, sums each product in float32, and stores each lane's
  two sums with the bias as the epilogue does, each output once. It equals
  the class's plain version (``conv2d_same_small_cout_bf16_plain``, or the
  input gradient's ``conv2d_same_small_cout_dgrad_bf16_plain``) within
  2^-7 of max |plain| (one bf16 unit: both sum the same exact products in
  float32 and round once) at odd shapes (H = 1, W = 1, W = 33, H = 7,
  B = 1, images narrower and shorter than a tile, the halo at every edge),
  at the train sites' (H, W) at narrow batch and at forced tiles; and the
  JAX package at bf16 in the same band: ``_conv_fwd_pallas`` in interpret
  mode at (7, 2, 1) and, at (7, 4, 2), its XLA formulation
  ``_conv_fwd_xla`` (the interpret mode does not run there at bf16 on the
  CPU: XLA's CPU dot takes no bf16 x bf16 = float32 at Cin 4, as
  ``test_torch_bf16_train.py`` found), each with a zero bias (JAX rounds y
  before it adds the bias); and ``_bwd``'s dx at (7, 2, 4) and (7, 1, 2)
  on a bf16 upstream gradient.
* The B table: the kernel's words equal ``mma_b_table`` in fragment order;
  every (tap, channel) of every output once in its column, 0 elsewhere; at
  (7, 4, 2) the fused gate's table as it was (``fused_b_table``).
* The tile rule at the train sites, and the routing on meta tensors: a
  full-width bf16 train step of DC, DCS, DR and DRS launches the body 13
  times forward and 13 backward at ``mma_tile``'s tiles, nothing of a
  float32 class; the entry refuses a tile it does not fit and x off its
  pixel.

One JAX compile (the four JAX results in one ``jax.jit``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.ops.pallas_conv import _bwd as jax_conv_bwd
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_pallas, _conv_fwd_xla

from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import cuda_conv as cc
from dcs_net_tpu_torch.ops import cuda_tapconv
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_train import _one_torch_thread  # noqa: F401

B16 = torch.bfloat16
BF16_OUT = 2.0 ** -7       # a bf16 output against its plain version or JAX
CLASSES = [(4, 2), (2, 4), (2, 1), (1, 2)]
IDS = [f"{c}{o}" for c, o in CLASSES]


def _rel(got, want) -> float:
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want.float() if isinstance(want, torch.Tensor) else want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def b_words(w: torch.Tensor) -> np.ndarray:
    """The kernel's B table (``mma_b_taps``), word by word: (32 WORDS, 2),
    word e's two bf16 halves (k even, k odd) widened. Word e is lane l = e %
    32's register r = (e / 32) % 2 of step u at row offset d (e / 64 = d U
    + u); the lane holds n = l / 4 and, in register r, k = 2 (l % 4) + 8 r +
    {0, 1}."""
    _, _, cin, cout = w.shape
    m = cc.mma_class(cin, cout)
    wf = w.float().reshape(-1).numpy()
    out = np.zeros((m.words * 32, 2), np.float32)
    for e in range(m.words * 32):
        lane, r, su = e & 31, (e >> 5) & 1, e >> 6
        u, d = su % m.u, su // m.u
        n, t = lane >> 2, lane & 3
        co, q = n % cout, n // cout
        s, kh = q % m.sc, d - q // m.sc
        for h in range(2):
            slot = 4 * u + t if cin == 4 else t + 4 * r if cin == 2 else 2 * t + 8 * r + h
            ci = 2 * r + h if cin == 4 else h if cin == 2 else 0
            kw = slot - s - (m.lead - 3)
            if 0 <= kh < 7 and 0 <= kw < 7:
                out[e, h] = wf[((kh * 7 + kw) * cin + ci) * cout + co]
    return out


LANES = np.arange(32)
GID, TIG = LANES >> 2, LANES & 3


def _b_operands(words: np.ndarray, m) -> np.ndarray:
    """(D, U, 16, 8): each (d, u)'s B from the lanes' registers b0, b1:
    B[2 tig + 8 r + h, gid] = register r's half h."""
    bop = np.zeros((m.d, m.u, 16, 8), np.float32)
    for d in range(m.d):
        for u in range(m.u):
            for r in range(2):
                reg = words[((d * m.u + u) * 2 + r) * 32 + LANES]       # (32, 2)
                for h in range(2):
                    bop[d, u, 2 * TIG + 8 * r + h, GID] = reg[:, h]
    return bop


def staged_words(xp: np.ndarray, m, geo, h0: int, w0: int) -> np.ndarray:
    """A block's staged tile as its copies leave it: (th + 6, pitch, 4 or 2)
    float32; word (i, j) holds image row h0 - 3 + i at the pixel w0 - lead +
    j (its Cin channels), or at Cin 1 the two pixels w0 - lead + 2 j + {0,
    1}; zero outside the image. ``xp``: one image zero-padded by 8 rows and
    8 columns before it and enough after."""
    rows = xp[h0 + 8 - 3:h0 + 8 - 3 + geo.th + 6]
    c = w0 + 8 - m.lead
    cols = rows[:, c:c + geo.pitch * m.px]
    return cols.reshape(geo.th + 6, geo.pitch, -1)


def mma_model(x: torch.Tensor, w: torch.Tensor, bias, tile=None):
    """The tensor-core body in numpy (see the module docstring): y (B, H, W,
    Cout) bf16 and the count of stores of each output."""
    B, H, W, cin = x.shape
    cout = w.shape[-1]
    m = cc.mma_class(cin, cout)
    geo = cc.mma_geometry(B, H, W, cin, cout, tile)
    th, tw, rb = geo.th, geo.tw, geo.rb
    ng = rb // m.sr
    bop = _b_operands(b_words(w), m)
    bias = np.asarray(bias, np.float32).reshape(-1)
    xf = x.float().numpy()
    y = np.full((B, H, W, cout), np.nan, np.float32)
    stores = np.zeros((B, H, W, cout), np.int64)
    # the lane's columns n = 2 tig + {0, 1}: the epilogue's pixel and outputs
    dy = TIG if cout == 1 else TIG // m.sc if cout == 2 else 0 * TIG
    s = TIG % m.sc if cout == 2 else TIG >> 1 if cout == 4 else 0 * TIG
    ch = 2 * (TIG & 1) if cout == 4 else 0 * TIG
    bb = np.stack([bias[ch], bias[ch + (1 if cout > 1 else 0)]], -1)       # (32, 2)
    nct = -(-tw // m.span)
    tasks = nct * -(-th // rb)
    for b in range(B):
        xp = np.zeros((H + th + 16, W + tw + 32, cin), np.float32)
        xp[8:8 + H, 8:8 + W] = xf[b]
        for h0 in range(0, H, th):
            for w0 in range(0, W, tw):
                words = staged_words(xp, m, geo, h0, w0)
                rows_v, cols_v = min(th, H - h0), min(tw, W - w0)
                for task in range(tasks):
                    q, ct = divmod(task, nct)
                    r0 = q * rb
                    c0 = ct * m.span + m.sc * GID                       # per lane
                    ca = np.minimum(c0, tw - m.sc) // m.px
                    cb = np.minimum(c0 + 8 * m.sc, tw - m.sc) // m.px
                    acc = np.zeros((ng, 16, 8), np.float32)
                    for i in range(rb + 6):
                        row = words[min(r0 + i, th + 5)]
                        for u in range(m.u):
                            # the lane's registers a0..a3, each two bf16
                            if cin == 4:
                                regs = (row[ca + 4 * u + TIG, 0:2], row[cb + 4 * u + TIG, 0:2],
                                        row[ca + 4 * u + TIG, 2:4], row[cb + 4 * u + TIG, 2:4])
                            else:
                                regs = (row[ca + TIG], row[cb + TIG], row[ca + TIG + 4],
                                        row[cb + TIG + 4])
                            a = np.zeros((16, 16), np.float32)
                            for h in range(2):
                                a[GID, 2 * TIG + h] = regs[0][:, h]
                                a[GID + 8, 2 * TIG + h] = regs[1][:, h]
                                a[GID, 2 * TIG + 8 + h] = regs[2][:, h]
                                a[GID + 8, 2 * TIG + 8 + h] = regs[3][:, h]
                            for j in range(ng):
                                d = i - m.sr * j
                                if 0 <= d < m.d:
                                    acc[j] += a @ bop[d, u]
                    for j in range(ng):
                        for half in range(2):
                            v = np.stack([acc[j][GID + 8 * half, 2 * TIG],
                                          acc[j][GID + 8 * half, 2 * TIG + 1]], -1) + bb
                            row = r0 + m.sr * j + dy
                            col = c0 + half * 8 * m.sc + s
                            for lane in range(32):
                                rr, cc_ = int(row[lane]), int(col[lane])
                                if rr >= rows_v or cc_ >= cols_v:
                                    continue
                                hh, ww = h0 + rr, w0 + cc_
                                if cout > 1:
                                    k = int(ch[lane])
                                    y[b, hh, ww, k:k + 2] = v[lane]
                                    stores[b, hh, ww, k:k + 2] += 1
                                else:
                                    y[b, hh, ww, 0] = v[lane, 0]
                                    stores[b, hh, ww, 0] += 1
                                    if cc_ + 1 < cols_v:
                                        y[b, hh, ww + 1, 0] = v[lane, 1]
                                        stores[b, hh, ww + 1, 0] += 1
    return torch.from_numpy(y).to(B16), stores


def _case(shape, cin, cout, seed):
    """x (or the upstream gradient) and the kernel the entry is given, bf16,
    and the plain version's output: the forward classes on w (7, 7, Cin,
    Cout) with a bias; the input-gradient classes on ``dgrad_kernel`` of
    the forward's w, zero bias."""
    B, H, W = shape
    x = torch.from_numpy(_np((B, H, W, cin), seed)).to(B16)
    if (cin, cout) in ((4, 2), (2, 1)):
        w = torch.from_numpy(_np((7, 7, cin, cout), seed + 1, 0.2)).to(B16)
        bias = torch.from_numpy(_np((cout,), seed + 2))
        return x, w, bias, cc.conv2d_same_small_cout_bf16_plain(x, w, bias)
    wf = torch.from_numpy(_np((7, 7, cout, cin), seed + 1, 0.2)).to(B16)
    return (x, cc.dgrad_kernel(wf), torch.zeros(cout),
            cc.conv2d_same_small_cout_dgrad_bf16_plain(x, wf))


# odd shapes ((B, H, W)): one pixel, one row, one column, W = 33 (an odd
# pair at Cin 1), H = 7, images narrower and shorter than a tile with the
# halo at every edge; then train sites' (H, W) at narrow batch
SHAPES = [(1, 1, 1), (2, 1, 40), (1, 9, 1), (2, 7, 33), (1, 5, 3), (3, 3, 70),
          (1, 2, 32), (2, 16, 32), (1, 64, 64), (1, 128, 128)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_model_matches_plain(cls, shape):
    cin, cout = cls
    x, w, bias, want = _case(shape, cin, cout, sum(shape) + cin)
    got, stores = mma_model(x, w, bias)
    assert (stores == 1).all()
    assert got.dtype == want.dtype == B16 and got.shape == want.shape
    assert _rel(got, want) <= BF16_OUT
    # the wrapper's CPU path is the plain version
    if (cin, cout) in ((4, 2), (2, 1)):
        assert torch.equal(cc.conv2d_same_small_cout(x, w, bias), want)
    else:
        assert torch.equal(cc._same_conv(x, w, bias, dgrad=True), want)


# tiles the rule does not pick: several row and column tasks a block, rows
# no multiple of RB, the smallest RB, a block past the image on both sides
FORCED = {(4, 2): [(3, 64, 2), (16, 32, 8)], (2, 4): [(5, 64, 4), (8, 96, 2)],
          (2, 1): [(6, 32, 4), (16, 64, 8)], (1, 2): [(3, 128, 2), (9, 64, 8)]}


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_model_at_forced_tiles(cls, which):
    cin, cout = cls
    tile = FORCED[cls][which]
    shape = (2, 13, 75)
    assert cc.mma_fits(*shape, cin, cout, tile)
    x, w, bias, want = _case(shape, cin, cout, 40 + which)
    got, stores = mma_model(x, w, bias, tile)
    assert (stores == 1).all() and _rel(got, want) <= BF16_OUT


def _fused_table_before(w: torch.Tensor) -> torch.Tensor:
    """The fused gate's B table as its own loops built it before the classes
    shared one table: n = 4 dy + 2 s + c, w[d - dy][4 u + t - s][ch][c]."""
    b = torch.zeros((8, 2, 16, 8), dtype=w.dtype)
    for d in range(8):
        for u in range(2):
            for k, (t, ch) in enumerate(cc.FUSED_K_ORDER):
                for n in range(8):
                    dy, sx, c = n // 4, (n // 2) % 2, n % 2
                    kh, kw = d - dy, 4 * u + t - sx
                    if 0 <= kh < 7 and 0 <= kw < 7:
                        b[d, u, k, n] = w[kh, kw, ch, c]
    return b


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_b_table_in_fragment_order(cls):
    """The kernel's words, read into the fragments, are ``mma_b_table``;
    column n = (dy sc + s) Cout + co holds each of output co's 49 Cin
    weights exactly once over (d, u, k) and zeros elsewhere (taps outside
    the kernel); at (7, 4, 2) the table is the fused gate's as it was."""
    cin, cout = cls
    m = cc.mma_class(cin, cout)
    assert cout * m.sc * m.sr == 8 and m.words == m.d * m.u * 2
    w = (1.0 + torch.arange(49 * cin * cout, dtype=torch.float32)).reshape(7, 7, cin, cout)
    table = cc.mma_b_table(w)
    assert table.shape == (m.d, m.u, 16, 8)
    np.testing.assert_array_equal(_b_operands(b_words(w), m), table.numpy())
    for n in range(8):
        col = table[..., n]
        assert int((col != 0).sum()) == 49 * cin
        assert sorted(col[col != 0].tolist()) == sorted(w[..., n % cout].flatten().tolist())
    order = cc.mma_k_order(cin)
    assert sorted(order) == sorted({(p, c) for p, c in order}) and len(set(order)) == 16
    if cls == (4, 2):
        assert torch.equal(cc.fused_b_table(w), _fused_table_before(w))
        assert cc.FUSED_K_ORDER == order


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package at bf16 in one compile: the Pallas conv in interpret
    mode at (7, 2, 1) and its XLA formulation at (7, 4, 2), zero bias (see
    the module docstring); ``_bwd``'s dx at the input
    gradients' classes (7, 2, 4) and (7, 1, 2) on a bf16 upstream gradient
    (the forward's x and w given, Cin 4 and 2). H = 16: the Pallas kernel
    computes whole row tiles of 8 or more, dividing H."""
    data = {}
    for cin, cout in ((4, 2), (2, 1)):
        data[(cin, cout)] = (_np((2, 16, 37, cin), 50 + cin), _np((7, 7, cin, cout), 51, 0.2),
                             _np((2, 16, 37, cout), 52 + cin))

    def run(d):
        out = {}
        for (cin, cout), (x, w, g) in d.items():
            xb, wb = x.astype(jnp.bfloat16), w.astype(jnp.bfloat16)
            if cin == 4:
                out[f"fwd{cin}{cout}"] = _conv_fwd_xla(xb, wb, jnp.zeros(cout, jnp.float32))
            else:
                out[f"fwd{cin}{cout}"] = _conv_fwd_pallas(xb, wb,
                                                          jnp.zeros(cout, jnp.bfloat16),
                                                          interpret=True)
            out[f"dx{cin}{cout}"] = jax_conv_bwd((xb, wb), g.astype(jnp.bfloat16))[0]
        return out

    jd = {k: tuple(jnp.asarray(a) for a in v) for k, v in data.items()}
    want = jax.jit(run)(jd)
    return data, {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in want.items()}


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_model_in_band_of_jax(jax_results, cls):
    data, want = jax_results
    cin, cout = cls
    if cls in data:
        x, w, _ = data[cls]
        xb, wb = torch.from_numpy(x).to(B16), torch.from_numpy(w).to(B16)
        got, _ = mma_model(xb, wb, np.zeros(cout, np.float32))
        assert _rel(got, want[f"fwd{cin}{cout}"]) <= BF16_OUT
    else:
        fwd = (cout, cin)
        _, w, g = data[fwd]
        gb, wb = torch.from_numpy(g).to(B16), torch.from_numpy(w).to(B16)
        got, _ = mma_model(gb, cc.dgrad_kernel(wb), np.zeros(cout, np.float32))
        assert got.shape == (2, 16, 37, cout)
        assert _rel(got, want[f"dx{fwd[0]}{fwd[1]}"]) <= BF16_OUT


# the train step's 13 sites (B 32 x 256 frames): (H, W) and the tiles
TRAIN_SITES = ((2, 32), (4, 32), (8, 32), (16, 32), (32, 32), (64, 64), (128, 128))
TRAIN_TILES = {(4, 2): [(2, 32, 2), (4, 32, 2)] + [(8, 32, 2)] * 3 + [(8, 64, 4), (16, 64, 8)],
               (2, 4): [(2, 32, 2), (4, 32, 2)] + [(8, 32, 2)] * 3 + [(8, 64, 4), (16, 64, 8)],
               (2, 1): [(2, 32, 4), (4, 32, 4)] + [(8, 32, 4)] * 3 + [(8, 64, 4), (16, 64, 8)],
               (1, 2): [(2, 64, 2), (4, 64, 2)] + [(8, 64, 2)] * 4 + [(16, 64, 4)]}


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_tiles_at_the_train_sites(cls):
    """The rule's tiles at the train step's sites: 16 x 64 at the 128 x 128
    sites (1.5x staged per output, two blocks an SM), at most 8 rows where a
    16-row grid would leave an SM under two blocks, each within the card's
    limits and at least one task a warp where the tile allows."""
    cin, cout = cls
    got = [cc.mma_tile(32, H, W, cin, cout) for H, W in TRAIN_SITES]
    assert got == TRAIN_TILES[cls]
    for (H, W), tile in zip(TRAIN_SITES, got):
        assert cc.mma_fits(32, H, W, cin, cout, tile)
        geo = cc.mma_geometry(32, H, W, cin, cout, tile)
        blocks = geo.grid[0] * geo.grid[1] * geo.grid[2]
        m = cc.mma_class(cin, cout)
        assert geo.smem <= 48 * 1024
        assert blocks >= cc.MMA_MIN_BLOCKS or tile[0] <= 8
        assert -(-tile[1] // m.span) * -(-tile[0] // tile[2]) >= min(
            cc.MMA_WARPS, -(-tile[1] // m.span) * -(-tile[0] // max(2, m.sr)))


class _Ints:
    """Stands in for a CudaKernel: notes the integer arguments of each
    launch (its shape and tile), launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(tuple(a for a in args if isinstance(a, int)))


@pytest.mark.parametrize("variant", ["dcs", "dc", "drs", "dr"])
def test_bf16_train_step_launches_the_body_13_plus_13(variant, monkeypatch):
    """A full-width bf16 train step on meta tensors (batch 32, 256 frames;
    the LSTM stubbed by an output of its shape: it launches no kernel of
    this repository and steps one frame at a time on meta) launches the
    bf16 conv entry 13 times forward and 13 for the input gradient, at the
    class of the variant and ``mma_tile``'s tile, and nothing of a float32
    class of kernel 2."""
    recs = {}
    for mod in (cc, cuda_tapconv):
        for attr, k in list(vars(mod).items()):
            if type(k).__name__ == "CudaKernel":
                recs[k.name] = _Ints()
                monkeypatch.setattr(mod, attr, recs[k.name])
    cfg = config_for_variant(variant)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).to("meta").train()
    if cfg.model.complex_valued:
        ones = torch.ones(cfg.model.lstm_hidden * (2 if cfg.model.lstm_bidir else 1),
                          device="meta")
        monkeypatch.setattr(model.lstm, "forward", lambda x, state: (
            CArray(x.re[..., :1] * ones.to(x.re.dtype), x.im[..., :1] * ones.to(x.im.dtype)),
            state))
        spec = CArray(torch.empty(32, 256, 256, device="meta"),
                      torch.empty(32, 256, 256, device="meta"))
        out = model(spec)
        (out.re.sum() + out.im.sum()).backward()
    else:
        ones = torch.ones(model.fc.weight.shape[1], device="meta")
        monkeypatch.setattr(model.lstm, "forward", lambda seq, state: (
            seq[..., :1] * ones.to(seq.dtype), state))
        model(torch.empty(32, 256, 256, device="meta")).sum().backward()
    fin, fout = (4, 2) if cfg.model.complex_valued else (2, 1)
    fwd, dgrad = recs["conv_same_small_cout_bf16"].calls, recs[
        "conv_same_small_cout_dgrad_bf16"].calls
    assert len(fwd) == len(dgrad) == 13
    for calls, (cin, cout) in ((fwd, (fin, fout)), (dgrad, (fout, fin))):
        for args in calls:
            B, H, W = args[:3]
            assert args[3:] == (cin, 7, cout) + cc.mma_tile(B, H, W, cin, cout)
        assert sorted({a[1:3] for a in calls}) == sorted(TRAIN_SITES)
    for name in ("conv_same_small_cout", "conv_same_small_cout_dgrad", "sa_pool", "sa_gate",
                 "sa_pool_real", "sa_gate_real", "sa_fused_bf16"):
        assert not recs[name].calls, name


@pytest.mark.parametrize("cls", CLASSES, ids=IDS)
def test_entry_checks_on_meta(cls, monkeypatch):
    """Off the CPU the bf16 class launches once at its tile (x and w as
    they are) and refuses what the body does not take: a tile whose width
    is no multiple of a product's span, RB no multiple of the row shifts or
    past 8, the float32 body's tile, x off its pixel."""
    cin, cout = cls
    rec = _Ints()
    monkeypatch.setattr(cc, "KERNEL_BF16", rec)
    x = torch.empty((2, 9, 40, cin), device="meta", dtype=B16)
    w = torch.empty((7, 7, cin, cout), device="meta", dtype=B16)
    bias = torch.empty(cout, device="meta")
    y = cc._same_conv(x, w, bias)
    assert y.dtype == B16 and y.shape == (2, 9, 40, cout)
    assert rec.calls == [(2, 9, 40, cin, 7, cout) + cc.mma_tile(2, 9, 40, cin, cout)]
    m = cc.mma_class(cin, cout)
    for tile in ((4, m.span + 16, 4), (4, m.span, 16), (4, m.span, 1), (4, 4, 2)):
        with pytest.raises(ValueError, match="tensor-core body"):
            cc.launch_conv(x, w, bias, tile)
    if m.sr == 4:
        with pytest.raises(ValueError, match="tensor-core body"):
            cc.launch_conv(x, w, bias, (4, m.span, 2))
    # x one bf16 off its 4-byte line: off a pixel at Cin 2 and 4, a pixel
    # boundary at Cin 1 (a pair the image's edge does not split is then
    # staged by two loads)
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 2 if t.dim() == 4 and
                        t.shape[-1] == cin and t.shape[0] == 2 else 0)
    if cin > 1:
        with pytest.raises(ValueError, match="off its word"):
            cc._same_conv(x, w, bias)
        assert len(rec.calls) == 1
    else:
        cc._same_conv(x, w, bias)
        assert len(rec.calls) == 2
