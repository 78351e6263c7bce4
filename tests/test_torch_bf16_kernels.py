"""The bf16 classes of kernels 1 and 3 as the card runs them, on the CPU:
numpy models of their loops, built from the wrappers' own tables and plans,
against the plain versions and the JAX package.

Kernel 1's span body stages each tile's sample span as rows of ``hop``
samples and reads the frames and the resident basis through ``wgmma``
descriptors; kernel 3's staged body stages a 16-channel chunk's halo tile as
8-channel planes and reads each tap through a shifted descriptor. The models
read every operand through the same descriptor arithmetic (start, leading
and stride offsets in 16-byte units over the K-major core-matrix images) so
that a wrong offset, plane pitch or tile origin shows here. Bands: a float32
output of bf16 products within 1e-4 of its largest value, a bf16 output
within 2^-7 (both the kernel and its plain version sum exact products in
float32 and round once).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import STFTConfig as JaxSTFTConfig
from dcs_net_tpu.dsp import stft as jdsp
from dcs_net_tpu.ops.pallas_tapconv import tapconv_valid as jax_tapconv

from dcs_net_tpu_torch.core.config import STFTConfig
from dcs_net_tpu_torch.dsp import stft as tdsp
from dcs_net_tpu_torch.dsp import stft_cuda as sc
from dcs_net_tpu_torch.ops import cuda_tapconv as ct

from test_torch_train import _one_torch_thread  # noqa: F401

B16 = torch.bfloat16
F32_OUT = 1e-4
BF16_OUT = 2.0 ** -7


def _bf16(a):
    """float32 numpy rounded to bf16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(B16).float().numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _desc(units, start, lbo, sbo, rows):
    """The (rows x 16) operand a no-swizzle K-major ``wgmma`` descriptor
    reads from ``units`` (U, 8), shared memory in 16-byte rows of 8 bf16:
    element (m, k) of core matrix (m // 8, k // 8) at row start + (k // 8)
    lbo + (m // 8) sbo + m % 8, column k % 8 (offsets in 16-byte units)."""
    m = np.arange(rows)[:, None]
    k = np.arange(16)[None, :]
    return units[start + (k // 8) * lbo + (m // 8) * sbo + m % 8, k % 8]


def _desc_mn(units, start, lbo, sbo, cols):
    """The (16 x cols) operand a no-swizzle MN-major ``wgmma`` descriptor
    (the transpose bit) reads: element (k, m) of core matrix (k // 8, m //
    8), 8 k rows of 8 consecutive columns, at row start + (k // 8) lbo + (m
    // 8) sbo + k % 8, column m % 8."""
    k = np.arange(16)[:, None]
    m = np.arange(cols)[None, :]
    return units[start + (k // 8) * lbo + (m // 8) * sbo + k % 8, m % 8]


# -- kernel 1: the span body ----------------------------------------------------

def _reflect(i, n, pad):
    if pad > 0:
        i = np.where(i < 0, -i, i)
        i = np.where(i >= n, 2 * (n - 1) - i, i)
    return i


def span_model(x, packed, n_fft, hop, pad, n_bins, frames, groups):
    """The span body: block (g, jb, b) walks tiles g, g + groups, ...; each
    tile's span is staged as (hop / 8, rows, 8) bf16 (sample r hop + j at
    [j / 8][r][j % 8], reflect padding per sample, zeros past the signal),
    and k16 step kk multiplies the basis at descriptor start kk * 128 (LBO
    1024 bytes, SBO 128) by the image at start 2 (kk % steps) rows + kk //
    steps (LBO rows * 16 bytes, SBO 128); accumulator row r < 32 is the cos
    of bin 32 jb + r, else the sin. Returns (re, im) and how often each
    output was written."""
    B, n = x.shape
    taps, steps = sc.span_taps(n_fft, hop), hop // 16
    rows = frames + taps - 1
    T = 1 + (n + 2 * pad - n_fft) // hop
    tiles = -(-T // frames)
    nb = packed.shape[0]
    re = np.full((B, n_bins, T), np.nan, np.float32)
    im = np.full_like(re, np.nan)
    written = np.zeros((2, B, n_bins, T), np.int64)
    basis = packed.float().numpy().reshape(nb, -1, 8)      # 16-byte rows
    for b in range(B):
        for jb in range(nb):
            for g in range(groups):
                for tile in range(g, tiles, groups):
                    t0 = tile * frames
                    r = np.arange(rows)[None, :, None]
                    grp = np.arange(hop // 8)[:, None, None]
                    i = (t0 + r) * hop - pad + 8 * grp + np.arange(8)[None, None, :]
                    i = _reflect(i, n, pad)
                    img = np.where((i >= 0) & (i < n), x[b][np.clip(i, 0, n - 1)], 0.0)
                    img = _bf16(img).reshape(-1, 8)
                    acc = np.zeros((64, frames), np.float32)
                    for kk in range(taps * steps):
                        a = _desc(basis[jb], kk * 128, 64, 8, 64)
                        bm = _desc(img, 2 * (kk % steps) * rows + kk // steps, rows, 8, frames)
                        acc += a @ bm.T
                    nt = min(frames, T - t0)
                    for row in range(64):
                        f = 32 * jb + row % 32
                        if f < n_bins:
                            out = re if row < 32 else im
                            out[b, f, t0:t0 + nt] = acc[row, :nt]
                            written[int(row >= 32), b, f, t0:t0 + nt] += 1
    return re, im, written


@pytest.mark.parametrize("B,n,n_fft,hop,center,groups", [
    (1, 4000, 512, 32, True, None),      # the model's size, B = 1, reflect at both ends
    (2, 1400, 512, 32, True, 1),         # T = 44 < 64, one block walks every tile
    (3, 2100, 512, 32, True, 2),         # ragged T (66), tiles shared by two blocks
    (2, 1000, 200, 48, False, None),     # hop does not divide n_fft (5 taps, zero rows)
    (1, 700, 96, 112, True, None),       # hop > n_fft (one tap)
    (2, 600, 81, 16, True, None),        # odd n_fft
], ids=["model-B1", "short", "ragged", "hop-ndiv", "hop-gt-nfft", "odd-nfft"])
def test_span_model_equals_plain(B, n, n_fft, hop, center, groups):
    """The span body's loop, on the wrapper's own basis and plan, writes
    every output once and equals the plain version on the rounded samples."""
    cfg = STFTConfig(dft_dtype="bfloat16", n_fft=n_fft, win_length=n_fft, hop=hop,
                     center=center)
    assert sc.choose_entry(n_fft, hop, "bfloat16") == "dense_bf16"
    cos_b, sin_b = tdsp._dft_basis_eff(cfg, np.float32)
    packed = sc.span_basis_bf16(cos_b, sin_b, hop)
    x = (0.3 * np.random.default_rng(n_fft + hop).standard_normal((B, n))).astype(np.float32)
    pad = n_fft // 2 if center else 0
    T = 1 + (n + 2 * pad - n_fft) // hop
    frames, plan_groups = sc.span_plan(n_fft, hop, cfg.n_bins, B, T)
    re, im, written = span_model(x, packed, n_fft, hop, pad, cfg.n_bins, frames,
                                 groups or plan_groups)
    assert (written == 1).all()
    plan = tdsp._analysis_plan(cfg, torch.device("cpu"))
    want = sc.stft_analysis(torch.from_numpy(x), plan)
    for got, w in zip((re, im), want):
        assert _rel(got, w.numpy()) <= F32_OUT


def test_span_model_equals_jax_stft_at_bf16():
    """The model at the model's size against the JAX ``dsp.stft`` at
    ``dft_dtype="bfloat16"`` (one JAX compile)."""
    x = (0.3 * np.random.default_rng(5).standard_normal((2, 3000))).astype(np.float32)
    cfg = STFTConfig(dft_dtype="bfloat16")
    want = jax.jit(lambda a: jdsp.stft(a, JaxSTFTConfig(dft_dtype="bfloat16")))(
        jnp.asarray(x))
    cos_b, sin_b = tdsp._dft_basis_eff(cfg, np.float32)
    T = 1 + 3000 // cfg.hop
    re, im, _ = span_model(x, sc.span_basis_bf16(cos_b, sin_b, cfg.hop), cfg.n_fft,
                           cfg.hop, cfg.n_fft // 2, cfg.n_bins,
                           *sc.span_plan(cfg.n_fft, cfg.hop, cfg.n_bins, 2, T))
    assert _rel(re, np.asarray(want.re)) <= F32_OUT
    assert _rel(im, np.asarray(want.im)) <= F32_OUT


def test_span_basis_is_the_chunked_basis_over_taps_times_hop_rows():
    """The span body's basis holds the chunked body's values in the same
    K-major core-matrix order, over taps * hop rows (zero past n_fft)."""
    cfg = STFTConfig(dft_dtype="bfloat16", n_fft=200, win_length=200, hop=48)
    cos_b, sin_b = tdsp._dft_basis_eff(cfg, np.float32)
    span = sc.span_basis_bf16(cos_b, sin_b, 48)
    chunked = sc.dense_basis_bf16(cos_b, sin_b)            # 224 rows
    assert span.shape == (4, 240 // 8, 64, 8) and span.dtype == B16
    assert torch.equal(span[:, :25], chunked.reshape(4, -1, 64, 8)[:, :25])
    assert not span[:, 25:].float().any()


def test_span_plan_and_routing():
    """The plan at the paths' shapes, the shared memory it asks, and the
    routing by shape between the span and the chunked body."""
    # enhance 4 x 4 s: 128-frame tiles, 4 blocks a (batch row, column block)
    assert sc.span_plan(512, 32, 256, 4, 2001) == (128, 4)
    # a test utterance (3 x 8160 samples): 64-frame tiles, a block each
    assert sc.span_plan(512, 32, 256, 3, 256) == (64, 4)
    # the 30 s stream at batch 1
    assert sc.span_plan(512, 32, 256, 1, 15001) == (128, 16)
    assert sc.span_smem_bytes(512, 32, 128) <= sc.SMEM_LIMIT
    for n_fft, hop, body in ((512, 32, "dense_bf16"), (1024, 256, "dense_bf16_chunked"),
                             (400, 100, "dense_bf16_chunked"), (512, 33, "dense_bf16_chunked"),
                             (2048, 512, "dense_bf16_chunked"), (4096, 1024, "dense_bf16_chunked")):
        assert sc.choose_entry(n_fft, hop, "bfloat16") == body
        assert (sc.span_smem_bytes(n_fft, hop, 32) <= sc.SMEM_LIMIT) == (
            body == "dense_bf16" or hop % 16 != 0)


# -- kernel 3: the staged body --------------------------------------------------

def staged_model(x, w, pad, plan, transposed=False, fkb=16):
    """The staged body: block (M tile, N tile, rank) runs its 16-channel
    chunks; a chunk's halo tile is two 8-channel planes of ``npix`` 16-byte
    rows, the tensor copy's box of arows x pw pixels from x's (r0, c0) (zeros
    outside x and past Cin, NaN past the box), the weights the packing's
    (9, 2, bn, 8) slab; tap t of consumer warpgroup c reads the plane at
    start s0 + 64 c + (t // 3) pw + t % 3 (LBO npix, SBO 8 units) against the
    slab at start 2 bn t (LBO bn, SBO 8), into one float32 chain over all the
    rank's chunks. Ranks add their partial tiles in rank order and round
    once. Returns y (B, HO, WO, N) as float32 and each pixel's store count.

    ``transposed``: the input gradient's form, x the upstream gradient g and
    w the forward's (9, Cin_f, N_f), of which the body reads the forward's
    packing (N tile ``ct.tile_n(N_f)``, ``fkb``-channel chunks) as it is: a
    chunk's weights are the tensor copy's box (8, 16, fkb / 8, bn / fkb, 9)
    of that packing seen as (8, N tile, fkb / 8, tiles x chunks, taps) from
    (0, 16 chunk % N tile, 0, 16 chunk // N tile * chunks + bn / fkb N
    tile, 0) (zeros past the tensor), landing as [tap][bn / 8][16][8]; tap t
    reads tap 8 - t at start 2 bn (8 - t), MN-major (LBO 8, SBO 16 units).
    Its flat tiles in planes (``flat`` = 2, ``staged_tiling``'s): three a
    group, plane d the box of arows x W pixels from (r0, c0 + d), tap t of
    warpgroup c read at start 2 npix (t % 3) + s0 + 64 c + (t // 3) W. The
    output has Cin_f channels."""
    B, H, W, cin = x.shape
    top, bottom, left, right = pad
    HO, WO = H + top + bottom - 2, W + left + right - 2
    bn, flat, wgs, split = plan
    bm = 64 * wgs
    planes = 3 if flat == 2 else 1
    tiles, pw, arows, npix = ct.staged_tiling(flat, wgs, HO, WO, 3, 3)
    if transposed:
        n, fbn = w.shape[1], ct.tile_n(w.shape[2])
        fpk = ct.pack_weights_bf16(torch.from_numpy(w).to(B16), fbn, fkb).float().numpy()
        fchunks = fpk.shape[1]
        fpk = fpk.reshape(-1, 9, fkb // 8, fbn, 8)
        nt, nchunks = -(-n // bn), -(-cin // 16)
    else:
        n = w.shape[-1]
        packed = ct.pack_weights_bf16(torch.from_numpy(w).to(B16), bn, ct.STAGED_KB)
        nt, nchunks = packed.shape[0], packed.shape[1]
        packed = packed.float().numpy()
    xb = _bf16(x)
    y = np.full((B * HO * WO, n), np.nan, np.float32)
    stored = np.zeros(B * HO * WO, np.int64)
    for blk in range(B * tiles * (1 if flat else HO)):
        if flat:
            b, p0 = divmod(blk, tiles)
            p0 *= bm
            h_a, s0, c0 = p0 // pw, p0 % pw, -left
            pos = p0 + np.arange(bm)
            hh, ww = pos // pw, pos % pw
            valid = (hh < HO) & (ww < WO)
            pix = (b * HO + hh) * WO + ww
        else:
            row, q0 = divmod(blk, tiles)
            q0 *= bm
            b, h_a = divmod(row, HO)
            s0, c0 = 0, q0 - left
            valid = q0 + np.arange(bm) < WO
            pix = row * WO + q0 + np.arange(bm)
        r0 = h_a - top
        for ntile in range(nt):
            parts = []
            for rank in range(split):
                acc = np.zeros((bm, bn), np.float32)
                for chunk in range(rank * nchunks // split, (rank + 1) * nchunks // split):
                    image = np.full((planes, 2, npix, 8), np.nan, np.float32)
                    hr, pc = np.divmod(np.arange(arows * pw), pw)
                    for pl in range(planes):
                        rr, cc = r0 + hr, c0 + pl + pc
                        inside = (rr >= 0) & (rr < H) & (cc >= 0) & (cc < W)
                        for gi in range(2):
                            ch = chunk * 16 + gi * 8 + np.arange(8)
                            vals = xb[b, np.clip(rr, 0, H - 1)[:, None],
                                      np.clip(cc, 0, W - 1)[:, None],
                                      np.clip(ch, 0, cin - 1)[None, :]]
                            ok = inside[:, None] & (ch < cin)[None, :]
                            image[pl, gi, :arows * pw] = np.where(ok, vals, 0.0)
                    units_a = image.reshape(-1, 8)
                    if transposed:
                        box = np.zeros((9, bn // fkb, fkb // 8, 16, 8), np.float32)
                        k0 = 16 * chunk
                        first = k0 // fbn * fchunks + ntile * (bn // fkb)
                        rows = k0 % fbn + np.arange(16)
                        for j in range(bn // fkb):
                            if first + j < fpk.shape[0]:
                                box[:, j][:, :, rows < fbn] = fpk[first + j][:, :, rows[rows < fbn]]
                        units_b = box.reshape(-1, 8)
                    else:
                        units_b = packed[ntile, chunk].reshape(-1, 8)
                    for c in range(wgs):
                        for t in range(9):
                            shift = (t % 3) * 2 * npix if planes > 1 else t % 3
                            a = _desc(units_a, s0 + 64 * c + (t // 3) * pw + shift, npix, 8, 64)
                            if transposed:
                                wb = _desc_mn(units_b, 2 * bn * (8 - t), 8, 16, bn)
                            else:
                                wb = _desc(units_b, 2 * bn * t, bn, 8, bn).T
                            acc[64 * c:64 * c + 64] += a @ wb
                parts.append(acc)
            total = parts[0].copy()
            for p in parts[1:]:
                total += p
            cols = slice(ntile * bn, min(n, ntile * bn + bn))
            y[pix[valid], cols] = total[valid][:, :cols.stop - cols.start]
            stored[pix[valid]] += ntile == 0
    return _bf16(y).reshape(B, HO, WO, n), stored


def _tap_case(B, H, W, cin, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, cin)).astype(np.float32)
    w = (rng.standard_normal((9, cin, n)) / (3 * np.sqrt(cin))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("B,H,W,cin,n,pad,plan", [
    (2, 3, 9, 24, 70, (1, 1, 1, 1), None),               # flat, its halo columns masked
    (1, 2, 7, 40, 16, (0, 2, 1, 1), (64, 1, 2, 1)),      # flat at two warpgroups, uneven pad
    (1, 2, 130, 16, 12, (1, 1, 1, 1), (64, 0, 2, 1)),    # one-row tiles, ragged last tile
    (1, 4, 6, 48, 130, (1, 1, 1, 1), (128, 1, 1, 3)),    # split in rank order, two N tiles
    (2, 2, 32, 32, 64, (1, 1, 1, 1), (64, 0, 1, 2)),     # a dec0-like row tile, split 2
], ids=["flat", "flat-wgs2", "row", "split3", "row-split"])
def test_staged_model_equals_plain(B, H, W, cin, n, pad, plan):
    """The staged body's loop writes every pixel once (NaN past the tensor
    copy's box stays in the halo columns it never stores) and equals the
    plain version within a bf16 unit."""
    x, w = _tap_case(B, H, W, cin, n, B * H + W)
    plan = plan or ct.forward_plan(B, H, W, cin, n, 3, 3, pad, bf16=True, body="staged")
    y, stored = staged_model(x, w, pad, plan)
    assert (stored == 1).all() and np.isfinite(y).all()
    want = ct.tapconv_valid_bf16_plain(ct._pad(torch.from_numpy(x), pad),
                                       torch.from_numpy(w), 3, 3)
    assert _rel(y, want.float().numpy()) <= BF16_OUT


def test_staged_model_equals_pallas_at_bf16():
    """The model against the JAX Pallas kernel in interpret mode at bf16
    operands (one JAX compile)."""
    x, w = _tap_case(2, 4, 9, 32, 16, 11)
    pad = (1, 1, 1, 1)
    y, _ = staged_model(x, w, pad, ct.forward_plan(2, 4, 9, 32, 16, 3, 3, pad, bf16=True))
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = jax_tapconv(jnp.asarray(xp).astype(jnp.bfloat16),
                       jnp.asarray(w).astype(jnp.bfloat16), 3, 3, interpret=True)
    assert _rel(y, np.asarray(want.astype(jnp.float32))) <= BF16_OUT


def test_staged_chain_over_the_whole_reduction_stays_in_band():
    """One float32 chain over every chunk (Cin 512: 4608 products a sum, as
    dec0-dec2 run it) against the products summed in float64: far inside
    the bf16 output's band before the rounding."""
    rng = np.random.default_rng(2)
    a = _bf16(rng.standard_normal((64, 4608)))
    b = _bf16(rng.standard_normal((4608, 64)) / 68.0)
    chain = np.zeros((64, 64), np.float32)
    for k in range(0, 4608, 16):
        chain += a[:, k:k + 16] @ b[k:k + 16]
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel(chain, exact) <= 2.0 ** -16


@pytest.mark.parametrize("cin,n,bn", [(32, 512, 128), (20, 70, 64), (40, 8, 8)])
def test_pack_weights_bf16_at_16_channel_chunks(cin, n, bn):
    """The staged body's packing: 16-channel chunks, a chunk's 9 taps one
    contiguous run; unpack(pack(w)) == w; weight (tap, c, m) at [m // bn,
    c // 16, tap, (c % 16) // 8, m % bn, c % 8]."""
    w = torch.randn(9, cin, n).to(B16)
    wp = ct.pack_weights_bf16(w, bn, ct.STAGED_KB)
    nt, nc = -(-n // bn), -(-cin // 16)
    assert wp.shape == (nt, nc, 9, 2, bn, 8)
    assert torch.equal(ct.unpack_weights_bf16(wp, cin, n), w)
    for tap, c, m in ((0, 0, 0), (4, cin - 1, n - 1), (8, cin // 2, n // 3)):
        assert wp[m // bn, c // 16, tap, (c % 16) // 8, m % bn, c % 8] == w[tap, c, m]


@pytest.mark.parametrize("shape,n,window,body", [
    ((4, 2, 251, 512), 512, (3, 3), "staged"),     # dec0 at the enhance call
    ((8, 32, 32, 128), 128, (3, 3), "staged"),     # dec4 at a stream group
    ((4, 64, 502, 64), 64, (3, 3), "staged"),      # dec5
    ((4, 128, 1004, 32), 8, (3, 3), "tap"),        # dec6: N <= 8
    ((1, 5, 6, 20), 8, (3, 3), "tap"),             # Cin % 8 != 0 (and N <= 8)
    ((1, 5, 6, 20), 70, (3, 3), "tap"),            # Cin % 8 != 0
    ((2, 40, 150, 40), 128, (5, 5), "tap"),        # another window
], ids=["dec0", "dec4-stream", "dec5", "dec6", "ragged-cin", "ragged-cin-n70", "5x5"])
def test_bf16_routing_by_shape(monkeypatch, shape, n, window, body):
    """The bf16 class's body is chosen from the shape alone, and a bf16 tap
    conv off the CPU (meta) launches that body once with its own packing
    (16-channel chunks for the staged body, 32 for the tap body)."""
    dh, dw = window
    assert ct.bf16_body(*shape, n, dh, dw, (1, 1, 1, 1)) == body

    class Rec:
        def __init__(self):
            self.calls = []

        def __call__(self, device, *args):
            self.calls.append(args)

    recs = {k: Rec() for k in ("KERNEL_BF16", "KERNEL_BF16_TAP", "PACK_BF16")}
    for k, r in recs.items():
        monkeypatch.setattr(ct, k, r)
    x = torch.empty(shape, device="meta", dtype=B16)
    y = ct.tapconv_valid(x, torch.empty((dh * dw, shape[-1], n), device="meta", dtype=B16),
                         dh, dw, ((dh - 1) // 2,) * 2 + ((dw - 1) // 2,) * 2)
    assert y.dtype == B16
    launched = recs["KERNEL_BF16" if body == "staged" else "KERNEL_BF16_TAP"]
    assert len(launched.calls) == 1
    assert len(recs["KERNEL_BF16_TAP" if body == "staged" else "KERNEL_BF16"].calls) == 0
    (pack,) = recs["PACK_BF16"].calls
    assert pack[-1] == (ct.STAGED_KB if body == "staged" else ct.BK)


@pytest.mark.parametrize("B,H,W,cin,n,plan", [
    (4, 2, 251, 512, 512, (128, 0, 1, 1)),    # dec0, enhance: 128-pixel row tiles
    (4, 4, 251, 512, 512, (128, 0, 2, 1)),    # dec1
    (4, 64, 502, 64, 64, (64, 0, 2, 1)),      # dec5
    (8, 4, 32, 512, 512, (128, 1, 1, 1)),     # dec1 at a stream group: flat tiles
    (1, 2, 32, 512, 512, (128, 0, 1, 8)),     # dec0 at batch 1: a split of 8
], ids=["dec0", "dec1", "dec5", "dec1-stream", "dec0-b1"])
def test_staged_plan_on_meta(B, H, W, cin, n, plan):
    """The staged body's plan at the model's stages (meta: the H100's 132
    SMs and cluster counts), and the shared memory it asks fits."""
    got = ct.forward_plan(B, H, W, cin, n, 3, 3, (1, 1, 1, 1), bf16=True)
    assert got == plan
    bn, flat, wgs, split = got
    _, _, _, npix = ct.staged_tiling(flat, wgs, H, W, 3, 3)
    assert ct.staged_stages(bn, wgs, 9, npix, cin, split) >= 2
    assert ct.staged_smem(bn, wgs, 9, npix, cin, split) <= ct.SMEM_LIMIT


def test_fit_tool_recovers_the_staged_bodys_step_costs(tmp_path, capsys):
    """``tools/fit_tapconv_plan.py --bf16`` reads the smoke's bf16 sweep
    lines and fits ``STEP_MS_BF16``: on lines whose times are the model's
    own it recovers the constants in use."""
    from dcs_net_tpu_torch.tools import fit_tapconv_plan as fit

    pad, lines = (1, 1, 1, 1), []
    for B, H, W, cin, n in ((1, 2, 32, 512, 512), (1, 8, 32, 512, 256), (8, 4, 32, 512, 512)):
        shape, times = (B, H, W, cin, n, 3, 3, pad), {}
        for flat in (0, 1):
            for wgs in (1, 2):
                for split in (1, 2, 4, 8):
                    plan = (ct.tile_n(n), flat, wgs, split)
                    f1, f2, _ = fit.features(shape, plan, bf16=True)
                    times[plan] = f1 * ct.STEP_MS_BF16[1] + f2 * ct.STEP_MS_BF16[2] + 0.012
        lines.append(f"kernel tapconv_valid_bf16 sweep: x ({B}, {H}, {W}, {cin}) -> N {n}, "
                     f"3x3, pad {pad}; (bn, flat, wgs, S) ms: "
                     + ", ".join(f"{p}={t:.6f}" for p, t in times.items()) + "; the plan ...")
    log = tmp_path / "smoke.log"
    log.write_text("\n".join(["device: none"] + lines) + "\n")
    fit.main([str(log), "--bf16"])
    out = capsys.readouterr().out.splitlines()
    want = f"STEP_MS_BF16 = {{1: {ct.STEP_MS_BF16[1]:.5f}, 2: {ct.STEP_MS_BF16[2]:.5f}}}"
    assert out[0].startswith(want + " (constant 0.0120 ms)")
    assert len(out) == 4
