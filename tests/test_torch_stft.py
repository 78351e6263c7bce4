"""The port's STFT / iSTFT (dcs_net_tpu_torch/dsp) against the JAX package's,
and kernel 1's plain version against the Pallas STFT kernel in interpret mode.

Inputs are made with numpy from fixed seeds and fed to both packages. The
port runs on the CPU here, i.e. through the plain versions of its kernels.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import STFTConfig as JaxSTFTConfig
from dcs_net_tpu.dsp import stft as jdsp
from dcs_net_tpu.dsp.stft_pallas import stft_pallas
from dcs_net_tpu.utils.carray import CArray as JaxCArray

from dcs_net_tpu_torch.core.config import STFTConfig
from dcs_net_tpu_torch.dsp import stft as tdsp
from dcs_net_tpu_torch.dsp import stft_cuda
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_train import _one_torch_thread  # noqa: F401

JCFG = JaxSTFTConfig()
TCFG = STFTConfig()


def _wave(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 2016), (1, 8160), (3, 1000)])
def test_stft_matches_jax(shape):
    x = _wave(shape, 1)
    want = jax.jit(lambda v: jdsp.stft(v, JCFG))(jnp.asarray(x))
    got = tdsp.stft(torch.from_numpy(x), TCFG)
    assert got.shape == tuple(want.re.shape) == shape[:1] + (256, 1 + shape[1] // 32)
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), atol=2e-5)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 8160), (1, 2016)])
def test_stft_plain_matches_pallas_interpret(shape):
    """Kernel 1's plain version against stft_pallas(.., interpret=True) at the
    band of the JAX package's own Pallas STFT test."""
    x = _wave(shape, 2)
    with jax.default_matmul_precision("highest"):
        want = stft_pallas(jnp.asarray(x), JCFG, True)
    cos_b, sin_b = (torch.from_numpy(a) for a in tdsp._dft_basis_eff(TCFG))
    re, im = stft_cuda.stft_dft_plain(torch.from_numpy(x), cos_b, sin_b,
                                      TCFG.hop, TCFG.n_fft // 2)
    np.testing.assert_allclose(re.numpy(), np.asarray(want.re), atol=2e-4)
    np.testing.assert_allclose(im.numpy(), np.asarray(want.im), atol=2e-4)


def test_stft_cpu_tensor_takes_plain_version():
    """A CPU tensor goes through the plain version and launches nothing."""
    x = torch.from_numpy(_wave((2, 2016), 3))
    cos_b, sin_b = (torch.from_numpy(a) for a in tdsp._dft_basis_eff(TCFG))
    before = stft_cuda.KERNEL.launches, stft_cuda.KERNEL_DENSE.launches
    b = stft_cuda.stft_dft_plain(x, cos_b, sin_b, 32, 256)
    mixed_cfg = STFTConfig(n_fft=400, hop=100, win_length=400)
    dense_cfg = STFTConfig(n_fft=352, hop=32, win_length=352)
    # the compiled FFT's size, the mixed-radix FFT's and the dense kernel's
    for cfg in (TCFG, mixed_cfg, dense_cfg):
        c = stft_cuda.stft_analysis(x, tdsp._analysis_plan(cfg, x.device))
        if cfg is TCFG:
            for u, v in zip(c, b):
                torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert (stft_cuda.KERNEL.launches, stft_cuda.KERNEL_DENSE.launches) == before


@pytest.mark.parametrize("n_fft,hop,entry", [(512, 32, "fft"), (400, 100, "fft"),
                                             (352, 32, "dense"), (512, 1024, "dense")])
def test_plan_off_the_cpu_holds_only_what_its_entry_reads(n_fft, hop, entry):
    """A plan for another device than the CPU carries the FFT's tables (no
    row table for the compiled size) or the dense entry's packed
    basis, never both and never the plain version's bases (the meta device
    stands in for the card); the CPU's plan always carries the bases of the
    plain version, and the FFT tables where the FFT entry takes the size."""
    cfg = STFTConfig(n_fft=n_fft, hop=hop, win_length=n_fft)
    plan = tdsp._analysis_plan(cfg, torch.device("meta"))
    assert stft_cuda.choose_entry(n_fft, hop) == entry
    assert (plan.fft is not None) == (entry == "fft")
    assert (plan.dense is not None) == (entry == "dense")
    assert plan.cos_b is None and plan.sin_b is None
    if entry == "fft":
        assert (plan.fft[3] is None) == (n_fft == stft_cuda.FFT_COMPILED)
    assert (plan.n_fft, plan.n_bins, plan.hop) == (n_fft, n_fft // 2, hop)
    cpu = tdsp._analysis_plan(cfg, torch.device("cpu"))
    assert cpu.cos_b.shape == cpu.sin_b.shape == (n_fft, n_fft // 2)
    assert cpu.dense is None
    assert (cpu.fft is not None) == (stft_cuda.fft_radices(n_fft) is not None)


def test_stft_rejects_short_input():
    with pytest.raises(ValueError):
        tdsp.stft(torch.zeros(1, 200), TCFG)


@pytest.mark.parametrize("polar,pad_top", [(True, True), (False, True),
                                           (True, False), (False, False)])
def test_spec_to_wave_matches_jax(polar, pad_top):
    rng = np.random.default_rng(4)
    re = rng.standard_normal((2, 256, 64)).astype(np.float32)
    im = rng.standard_normal((2, 256, 64)).astype(np.float32)
    want = jax.jit(lambda a, b: jdsp.spec_to_wave(
        JaxCArray(a, b), JCFG, atan2_eps=1e-6, pad_top=pad_top, length=2000,
        polar=polar))(jnp.asarray(re), jnp.asarray(im))
    got = tdsp.spec_to_wave(CArray(torch.from_numpy(re), torch.from_numpy(im)),
                            TCFG, atan2_eps=1e-6, pad_top=pad_top, length=2000,
                            polar=polar)
    assert got.shape == (2, 2000)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_istft_inverts_full_bin_stft():
    cfg = STFTConfig(drop_dc=False)
    x = _wave((2, 4000), 5)
    back = tdsp.istft(tdsp.stft(torch.from_numpy(x), cfg), cfg, length=4000)
    np.testing.assert_allclose(back.numpy(), x, atol=2e-5)


def _small_dft(r):
    ang = -2.0 * np.pi * np.outer(np.arange(r), np.arange(r)) / r
    return torch.from_numpy(np.exp(1j * ang).astype(np.complex64))


def _skew(s):
    return s + (s >> 5)


def frames_through_skewed_span(xpad, n_fft, hop, n_frames, ft=32):
    """The even and the odd samples of every frame, (B, T, n_fft/2) each, read
    as the FFT kernel reads them: a tile of ``ft`` frames stages its sample
    span in shared memory skewed by one word per 32 (zeros past the signal's
    end), and frame lane l reads words skew(l*hop + 2n) and skew(l*hop + 2n
    + 1). Words the staging never writes are NaN here."""
    span = hop * (ft - 1) + n_fft
    s = torch.arange(span)
    nn = 2 * torch.arange(n_fft // 2)
    even, odd = [], []
    for t0 in range(0, n_frames, ft):
        src = t0 * hop + s
        ok = src < xpad.shape[-1]
        fxs = torch.full(xpad.shape[:-1] + (int(_skew(span - 1)) + 1,), float("nan"))
        fxs[..., _skew(s)] = torch.where(ok, xpad[..., src.clamp(max=xpad.shape[-1] - 1)],
                                         torch.zeros(()))
        word = (torch.arange(min(ft, n_frames - t0)) * hop)[:, None] + nn
        even.append(fxs[..., _skew(word)])
        odd.append(fxs[..., _skew(word + 1)])
    return torch.cat(even, dim=-2), torch.cat(odd, dim=-2)


def stage_rows(radices, s):
    """The rows item g of stage s >= 1 reads and writes, (n_fft/2 / Rs, Rs),
    and its residue q, as the kernel computes them: k1 = g mod R1,
    t = g div R1, q = t mod Qs, h = t div Qs, rows k1 + R1 (q + Qs r + Rs Qs h)."""
    r1, rs = radices[0], radices[s]
    qs = int(np.prod(radices[s + 1:], dtype=np.int64))
    g = np.arange(int(np.prod(radices)) // rs)
    k1, t = g % r1, g // r1
    q, h = t % qs, t // qs
    rows = k1[:, None] + r1 * (q[:, None] + qs * np.arange(rs) + rs * qs * h[:, None])
    return torch.from_numpy(rows), torch.from_numpy(q)


def fft_kernel_model(x, cfg):
    """What the FFT kernel computes, step by step in float32, from the plan
    and tables the wrapper hands it: frames of the reflect-padded signal read
    out of the skewed span of their tile of ``fft_tile_frames`` frames, the
    real frame packed into n_fft/2 complex points times ``win2``; stage 1,
    radix R1 over r for each residue q (n = q + Q1 r), twiddled by the first
    ``tw`` block, to rows k1 + R1 q of the tile; each later stage in place
    on its rows, twiddled by its ``tw`` block but the last; then the split
    step, reading output k at ``rows[k]``, with ``sp`` for the kept bins."""
    plan = tdsp._analysis_plan(cfg, x.device)
    win2, tw, sp, rows = plan.fft
    tw, sp = torch.view_as_complex(tw), torch.view_as_complex(sp)
    radices = stft_cuda.fft_radices(cfg.n_fft)
    n2 = int(np.prod(radices))
    if plan.pad:
        x = torch.nn.functional.pad(x[:, None], (plan.pad, plan.pad),
                                    mode="reflect")[:, 0]
    n_frames = cfg.num_frames(x.shape[-1] - 2 * plan.pad)
    ft = stft_cuda.fft_tile_frames(cfg.n_fft, cfg.hop, x.shape[0], n_frames)
    even, odd = frames_through_skewed_span(x, cfg.n_fft, cfg.hop, n_frames, ft)
    z = torch.complex(even * win2[:, 0], odd * win2[:, 1])    # (B, T, n_fft/2)
    r1, q1 = radices[0], n2 // radices[0]
    y = torch.einsum("kr,btrq->btqk", _small_dft(r1),
                     z.reshape(z.shape[:-1] + (r1, q1)))      # [q, k1]
    off = 0
    if len(radices) > 1:
        y = y * tw[:q1 * r1].reshape(q1, r1)
        off = q1 * r1
    tile = torch.zeros_like(z)
    tile[..., (torch.arange(r1)[None, :] + r1 * torch.arange(q1)[:, None]).reshape(-1)] = (
        y.reshape(y.shape[:-2] + (-1,)))
    for s in range(1, len(radices)):
        idx, q = stage_rows(radices, s)                       # (G, Rs), (G,)
        v = torch.einsum("kr,btgr->btgk", _small_dft(radices[s]), tile[..., idx])
        if s + 1 < len(radices):
            block = tw[off:off + n2 // radices[s]].reshape(-1, radices[s])
            v = v * block[q]
            off += block.numel()
        tile[..., idx] = v
    k = torch.arange(plan.first_bin, plan.first_bin + cfg.n_bins)
    a = tile[..., rows.long()[k % n2]]
    c = tile[..., rows.long()[(n2 - k) % n2]]
    e = torch.complex(a.real + c.real, a.imag - c.imag)
    o = torch.complex(a.imag + c.imag, c.real - a.real)
    out = (e + o * sp[k]).transpose(-1, -2)
    return out.real.contiguous(), out.imag.contiguous()


FFT_CASES = [
    # n_fft, hop, center, drop_dc, (B, n): T = 65 and 14 leave a ragged last
    # tile of 32 frames; (1, 1024) at n_fft 512 without centering gives T = 17
    (512, 32, True, True, (2, 2064)),
    (512, 32, False, True, (1, 1024)),
    (512, 32, True, False, (1, 4000)),
    (256, 64, True, True, (2, 2100)),
    (128, 32, False, False, (2, 555)),
    (64, 16, True, True, (3, 1000)),
    # the mixed-radix kernel (tiles of 8 frames at these grids): 16 x 10,
    # 8 x 5 x 5, 16 x 15, 8 x 8 x 5, 10 x 8 x 6, 8 x 8 x 8, 16 x 8 x 8; T = 13,
    # 21, 14 and 10 leave a ragged last tile
    (320, 160, True, True, (2, 2000)),
    (400, 100, True, True, (1, 2000)),
    (480, 120, False, True, (2, 2000)),
    (640, 160, True, False, (1, 3000)),
    (960, 240, True, True, (1, 3000)),
    (1024, 256, True, True, (1, 2560)),
    (2048, 512, True, True, (1, 4800)),
]
# odd hops: an odd lane's sample pair starts at an odd word, and may lie
# across a skew step of the staged span
FFT_ODD_HOP_CASES = [
    (128, 31, True, True, (2, 2100)),
    (64, 7, False, False, (1, 700)),
    (512, 33, True, True, (1, 2500)),
    (256, 1, False, True, (1, 300)),
    (400, 33, True, True, (1, 2000)),
    (1024, 255, False, True, (1, 4000)),
]


@pytest.mark.parametrize("n_fft,hop,center,drop_dc,shape", FFT_CASES)
def test_fft_kernel_model_matches_plain_and_pallas(n_fft, hop, center, drop_dc, shape):
    """The FFT factorisation kernel 1 runs (modelled in float32 from the
    wrapper's own tables) against the dense plain version and the Pallas
    kernel in interpret mode. atol 2e-5 on unit-variance input: the outputs
    are O(1) sums of n_fft float32 products scaled by n_fft**-0.5, so both
    forms carry a few float32 ulps (~1e-6) of rounding, and XLA's CPU matmul
    adds a little more; a wrong twiddle, stage order or bin shows as O(1)."""
    kw = dict(n_fft=n_fft, hop=hop, win_length=n_fft, center=center, drop_dc=drop_dc)
    cfg, jcfg = STFTConfig(**kw), JaxSTFTConfig(**kw)
    x = _wave(shape, 6)
    plan = tdsp._analysis_plan(cfg, torch.device("cpu"))
    assert stft_cuda.choose_entry(n_fft, hop) == "fft"
    re, im = fft_kernel_model(torch.from_numpy(x), cfg)
    pre, pim = stft_cuda.stft_dft_plain(torch.from_numpy(x), plan.cos_b,
                                        plan.sin_b, plan.hop, plan.pad)
    assert re.shape == pre.shape == (shape[0], cfg.n_bins, cfg.num_frames(shape[1]))
    np.testing.assert_allclose(re.numpy(), pre.numpy(), atol=2e-5)
    np.testing.assert_allclose(im.numpy(), pim.numpy(), atol=2e-5)
    with jax.default_matmul_precision("highest"):
        want = stft_pallas(jnp.asarray(x), jcfg, True)
    np.testing.assert_allclose(re.numpy(), np.asarray(want.re), atol=2e-5)
    np.testing.assert_allclose(im.numpy(), np.asarray(want.im), atol=2e-5)


@pytest.mark.parametrize("n_fft,hop,center,drop_dc,shape", FFT_ODD_HOP_CASES)
def test_fft_kernel_model_odd_hop_matches_plain_and_jax(n_fft, hop, center, drop_dc, shape):
    """The same model at odd hops, which the Pallas kernel does not take (it
    needs hop | n_fft): held against the dense plain version and the JAX
    package's ``dsp.stft``, same band as above."""
    kw = dict(n_fft=n_fft, hop=hop, win_length=n_fft, center=center, drop_dc=drop_dc)
    cfg, jcfg = STFTConfig(**kw), JaxSTFTConfig(**kw)
    x = _wave(shape, 8)
    plan = tdsp._analysis_plan(cfg, torch.device("cpu"))
    assert stft_cuda.choose_entry(n_fft, hop) == "fft"
    re, im = fft_kernel_model(torch.from_numpy(x), cfg)
    pre, pim = stft_cuda.stft_dft_plain(torch.from_numpy(x), plan.cos_b,
                                        plan.sin_b, plan.hop, plan.pad)
    assert re.shape == pre.shape == (shape[0], cfg.n_bins, cfg.num_frames(shape[1]))
    np.testing.assert_allclose(re.numpy(), pre.numpy(), atol=2e-5)
    np.testing.assert_allclose(im.numpy(), pim.numpy(), atol=2e-5)
    with jax.default_matmul_precision("highest"):
        want = jdsp.stft(jnp.asarray(x), jcfg)
    np.testing.assert_allclose(re.numpy(), np.asarray(want.re), atol=2e-5)
    np.testing.assert_allclose(im.numpy(), np.asarray(want.im), atol=2e-5)


PLANNED_SIZES = [16, 24, 28, 32, 36, 64, 98, 128, 162, 256, 320, 392, 400, 450, 480, 512,
                 640, 960, 1024, 1250, 1750, 2048]


@pytest.mark.parametrize("n_fft", PLANNED_SIZES)
def test_fft_tables_are_float64_accurate(n_fft):
    """The tables are rounded once from float64: unit-modulus twiddles of
    every stage boundary and of the split step, the window halves; the plan's
    radices are codelets of at most 16 whose product is n_fft / 2 (at most
    three stages but for 625 and 875 points); the rows are a permutation."""
    radices = stft_cuda.fft_radices(n_fft)
    assert int(np.prod(radices)) * 2 == n_fft and max(radices) <= 16
    assert set(radices) <= set(stft_cuda.CODELETS)
    assert len(radices) <= (4 if n_fft in (1250, 1750) else 3)
    if n_fft == stft_cuda.FFT_COMPILED:
        assert radices == (16, 16)
    w = np.random.default_rng(7).uniform(0.1, 1.0, n_fft)
    win2, tw, sp, rows = stft_cuda.fft_tables(w)
    assert win2.dtype == tw.dtype == sp.dtype == np.float32 and rows.dtype == np.int32
    np.testing.assert_array_equal(win2.reshape(-1), (0.5 * w).astype(np.float32))
    k = np.arange(n_fft // 2 + 1)
    np.testing.assert_allclose(sp[:, 0] + 1j * sp[:, 1],
                               np.exp(-2j * np.pi * k / n_fft), atol=6e-8)
    off = 0
    for s in range(len(radices) - 1):
        r, q = radices[s], int(np.prod(radices[s + 1:]))
        qk = np.outer(np.arange(q), np.arange(r))
        block = tw[off:off + q * r].reshape(q, r, 2)
        np.testing.assert_allclose(block[..., 0] + 1j * block[..., 1],
                                   np.exp(-2j * np.pi * qk / (q * r)), atol=6e-8)
        off += q * r
    assert off == tw.shape[0]
    assert sorted(rows) == list(range(n_fft // 2))


@pytest.mark.parametrize("n_fft,hop,entry", [
    (512, 32, "fft"), (256, 64, "fft"), (128, 128, "fft"), (64, 16, "fft"),
    (512, 33, "fft"), (64, 7, "fft"),
    (400, 100, "fft"), (1024, 256, "fft"), (32, 8, "fft"),
    (96, 24, "fft"), (512, 1024, "dense"),
    (352, 32, "dense"), (401, 100, "dense"), (4096, 1024, "dense"),
])
def test_entry_point_is_chosen_from_the_shape(n_fft, hop, entry):
    """Every even n_fft up to 2048 whose half is 7-smooth names the FFT
    entry at 0 < hop <= n_fft; every other size names the dense entry, and
    has no FFT tables. No launch happens."""
    assert stft_cuda.choose_entry(n_fft, hop) == entry
    tables = stft_cuda.fft_tables(np.ones(n_fft))
    assert (tables is None) == (stft_cuda.fft_radices(n_fft) is None)


def _seven_smooth(m):
    for p in (2, 3, 5, 7):
        while m % p == 0:
            m //= p
    return m == 1


def test_entry_rule_enumerates_the_sizes():
    """``choose_entry`` names ``"fft"`` for exactly the even n_fft in
    [16, 2048] whose half is 7-smooth (136 sizes), at hop 1 and hop n_fft,
    and ``"dense"`` for every other n_fft up to 4100 and for hop > n_fft."""
    fft = [n for n in range(1, 4101) if stft_cuda.choose_entry(n, n) == "fft"]
    assert fft == [n for n in range(16, 2049, 2) if _seven_smooth(n // 2)]
    assert len(fft) == 136
    for n in range(1, 4101):
        assert stft_cuda.choose_entry(n, 1) == stft_cuda.choose_entry(n, n)
        assert stft_cuda.choose_entry(n, n + 1) == "dense"


def test_codelet_constants_in_the_source_are_the_float64_roots():
    """The cases of ``root_entry`` in ``csrc/stft.cu`` are exactly
    ``root_cases_source()``: entry i, in order, is cos / sin of 2 pi m / R
    rounded once from float64. The source declares no ``__constant__``
    variable (a user constant bank slowed every launch of the module)."""
    src = (Path(stft_cuda.__file__).parent.parent / "csrc" / "stft.cu").read_text()
    cases = stft_cuda.root_cases_source()
    assert cases in src and "__constant__" not in src
    found = re.findall(r"case (\d+): return \{(\S+)f, (\S+)f\};", cases)
    assert [int(i) for i, _, _ in found] == list(range(81))
    values = [float(v) for _, c, sn in found for v in (c, sn)]
    want = np.concatenate([stft_cuda.root_values(r).reshape(-1)
                           for r in stft_cuda.CODELETS if r & (r - 1)])
    assert len(values) == want.size == 2 * 81
    np.testing.assert_array_equal(np.float32(values), want)
    for r in (c for c in stft_cuda.CODELETS if c & (c - 1)):
        ang = 2 * np.pi * np.arange(r) / r
        np.testing.assert_allclose(stft_cuda.root_values(r),
                                   np.stack([np.cos(ang), np.sin(ang)], -1), atol=6e-8)


def test_fft_tile_fits_shared_memory_and_fills_the_grid():
    """The mixed kernel's frames a block: every planned size at hop n_fft
    (the largest span) fits 227 KB at 8 frames; 32 where the grid gives
    every SM two blocks, 8 for small grids (n_fft 64, 128 and 256 too, on
    the mixed kernel); the compiled size keeps 32."""
    for n_fft in range(16, 2049, 2):
        if stft_cuda.fft_radices(n_fft) is not None:
            ft = stft_cuda.fft_tile_frames(n_fft, n_fft, 1, 10)
            assert stft_cuda.fft_smem_bytes(n_fft, n_fft, ft) <= stft_cuda.SMEM_LIMIT
    assert stft_cuda.fft_tile_frames(512, 32, 4, 2001) == 32
    assert stft_cuda.fft_tile_frames(512, 32, 1, 3) == 32
    assert stft_cuda.fft_tile_frames(400, 100, 16, 1601) == 32
    assert stft_cuda.fft_tile_frames(1024, 256, 32, 251) == 16
    assert stft_cuda.fft_tile_frames(400, 100, 2, 121) == 8
    assert stft_cuda.fft_tile_frames(256, 64, 2, 141) == 8
    assert stft_cuda.fft_tile_frames(128, 32, 32, 512) == 32
    assert stft_cuda.fft_smem_bytes(2048, 512, 32) > stft_cuda.SMEM_LIMIT


def unpack_dense(packed):
    """The dense entry's packed basis back to its hi and lo (Kp, 2 Fp)
    matrices: slab element [k // 4, n, k % 4] of column block j and chunk c
    is (32 c + k, 64 j + n)."""
    j, c = packed.shape[:2]
    parts = packed.transpose(2, 1, 3, 5, 0, 4).reshape(2, 32 * c, 64 * j)
    return parts[0], parts[1]


def test_dense_basis_packs_cos_then_sin_of_32_bins():
    """The dense entry's basis: (n_fft rounded up to 32, 2 F rounded up to
    64), block j the cos then the sin of bins 32 j .. 32 j + 31, zeros past
    n_fft and F, split into TF32 hi and lo, in slabs of 32 rows laid out as
    the K-major core matrices the kernel reads; the cluster split doubles
    while the doubled grid runs at once (at the blocks an SM it is given)
    and every rank keeps two chunks."""
    cfg = STFTConfig(n_fft=101, hop=13, win_length=101)
    cos_b, sin_b = tdsp._dft_basis_eff(cfg)
    packed = stft_cuda.dense_basis(cos_b, sin_b)
    assert packed.shape == (2, 4, 2, 8, 64, 4) and packed.dtype == np.float32
    hi, lo = unpack_dense(packed)
    np.testing.assert_array_equal(packed[1, 2, 0, 3, 5], hi[64 + 12:64 + 16, 64 + 5])
    np.testing.assert_array_equal(hi, stft_cuda.tf32_round(hi))
    np.testing.assert_array_equal(lo, stft_cuda.tf32_round(lo))
    basis = hi + lo                       # the float32 basis to ~2^-22
    assert basis.shape == (128, 128)
    np.testing.assert_allclose(basis[:101, :32], cos_b[:, :32], rtol=0, atol=1e-8)
    np.testing.assert_allclose(basis[:101, 32:64], sin_b[:, :32], rtol=0, atol=1e-8)
    np.testing.assert_allclose(basis[:101, 64:82], cos_b[:, 32:], rtol=0, atol=1e-8)
    np.testing.assert_allclose(basis[:101, 96:114], sin_b[:, 32:], rtol=0, atol=1e-8)
    assert not basis[101:].any() and not basis[:, 82:96].any() and not basis[:, 114:].any()
    assert stft_cuda.dense_split(352, 176, 2, 376) == 4
    assert stft_cuda.dense_split(352, 176, 2, 376, resident=2) == 2
    assert stft_cuda.dense_split(352, 176, 4, 2001) == 1
    assert stft_cuda.dense_split(1100, 550, 1, 11) == 8
    assert stft_cuda.dense_split(401, 200, 1, 16) == 4
    assert stft_cuda.dense_split(22, 12, 2, 1001) == 1


def _trunc19(a):
    """The top 19 bits of float32 values: what the tensor cores read of a
    float32 operand, and the kernel's hi part of a frame sample."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def dense_kernel_model(x, cfg, products=3):
    """The dense entry's product in float32: the frames split by truncation
    (hi the top 19 bits, lo the exact rest, of which the tensor cores read
    the top 19 bits), the wrapper's packed basis already split into TF32 hi
    and lo; then lo*hi + hi*lo + hi*hi (three products, the kernel's order),
    or hi*hi alone (``products=1``)."""
    plan = tdsp._analysis_plan(cfg, torch.device("cpu"))
    bh, bl = (b[:cfg.n_fft] for b in unpack_dense(
        stft_cuda.dense_basis(*tdsp._dft_basis_eff(cfg, np.float64))))
    xp = torch.nn.functional.pad(torch.from_numpy(x)[:, None], (plan.pad, plan.pad),
                                 mode="reflect")[:, 0]
    frames = xp.unfold(-1, cfg.n_fft, cfg.hop).numpy()
    ah = _trunc19(frames)
    acc = ah @ bh
    if products == 3:
        acc = _trunc19(frames - ah) @ bh + ah @ bl + acc
    blocks = acc.reshape(acc.shape[:-1] + (-1, 2, stft_cuda.DENSE_BINS))

    def part(j):                 # the cos (re) or sin (im) columns -> (B, F, T)
        v = blocks[..., j, :].reshape(acc.shape[:-1] + (-1,))[..., :cfg.n_bins]
        return np.ascontiguousarray(np.swapaxes(v, -1, -2))

    return part(0), part(1)


def test_dense_3xtf32_model_holds_the_band_and_one_product_does_not():
    """The dense entry's 3xTF32 product (modelled in float32 on the TF32
    bits: the basis rounded, the frames truncated) against the plain version at n_fft 352, hop 32: within 1e-5 of
    the largest output. One TF32 product leaves that band (~1e-3 of it), so
    a dropped term fails."""
    cfg = STFTConfig(n_fft=352, hop=32, win_length=352)
    x = _wave((2, 3000), 9)
    plan = tdsp._analysis_plan(cfg, torch.device("cpu"))
    want = [t.numpy() for t in stft_cuda.stft_dft_plain(
        torch.from_numpy(x), plan.cos_b, plan.sin_b, plan.hop, plan.pad)]
    ref = max(np.abs(w).max() for w in want)
    got = dense_kernel_model(x, cfg)
    err = max(np.abs(g - w).max() for g, w in zip(got, want)) / ref
    assert got[0].shape == want[0].shape and err <= 1e-5
    one = dense_kernel_model(x, cfg, products=1)
    assert max(np.abs(g - w).max() for g, w in zip(one, want)) / ref > 1e-4


def test_card_routes_each_size_to_the_entry_it_names(monkeypatch):
    """On the card (meta tensors here) a CUDA tensor launches the entry
    ``choose_entry`` names once, with the plan's radices, tile and row table
    (none for the compiled size only), or the dense entry's basis and split."""
    calls = []
    monkeypatch.setattr(stft_cuda, "KERNEL", lambda dev, *a: calls.append(("fft", a)))
    monkeypatch.setattr(stft_cuda, "KERNEL_DENSE", lambda dev, *a: calls.append(("dense", a)))
    x = torch.empty((2, 12000), device="meta")
    for n_fft, hop, entry in ((512, 32, "fft"), (400, 100, "fft"), (2048, 512, "fft"),
                              (256, 64, "fft"), (352, 32, "dense")):
        cfg = STFTConfig(n_fft=n_fft, hop=hop, win_length=n_fft)
        re, im = tdsp.stft(x, cfg)
        T = cfg.num_frames(12000)
        assert re.shape == (2, cfg.n_bins, T) and calls[-1][0] == entry
        ints = [a for a in calls[-1][1] if isinstance(a, int)]
        if entry == "fft":
            radices = stft_cuda.fft_radices(n_fft)
            assert ints[:8] == [2, 12000, n_fft, hop, 1, cfg.n_bins, T, n_fft // 2]
            assert tuple(r for r in ints[8:12] if r) == radices
            assert ints[12] == stft_cuda.fft_tile_frames(n_fft, hop, 2, T)
            assert (calls[-1][1][4] is None) == (n_fft == stft_cuda.FFT_COMPILED)
        else:
            assert ints == [2, 12000, n_fft, hop, cfg.n_bins, T, n_fft // 2,
                            stft_cuda.dense_split(n_fft, cfg.n_bins, 2, T)]
    assert len(calls) == 5


@pytest.mark.parametrize("shape,center", [((2, 2016), True), ((1, 8160), True),
                                          ((2, 992), False)])
def test_stft_function_backward_matches_jax_adjoint(shape, center):
    """The STFT Function's backward (``stft_adjoint``: basis transpose,
    overlap-add, the reflect padding folded back) on a CPU tensor against
    ``jax.vjp`` through ``stft_pallas`` (interpret mode), whose backward is
    ``_adjoint``; within 1e-5 of the largest gradient."""
    import dataclasses

    jcfg = dataclasses.replace(JCFG, center=center)
    tcfg = dataclasses.replace(TCFG, center=center)
    x = _wave(shape, 20)
    n_frames = 1 + (shape[1] + (TCFG.n_fft if center else 0) - TCFG.n_fft) // TCFG.hop
    g_re, g_im = _wave((shape[0], 256, n_frames), 21), _wave((shape[0], 256, n_frames), 22)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda v: stft_pallas(v, jcfg, True), jnp.asarray(x))
        (want,) = vjp(JaxCArray(jnp.asarray(g_re), jnp.asarray(g_im)))
    xt = torch.from_numpy(x).requires_grad_()
    re, im = tdsp.STFT.apply(xt, tcfg)
    torch.autograd.backward((re, im), (torch.from_numpy(g_re), torch.from_numpy(g_im)))
    want = np.asarray(want)
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_stft_off_the_cpu_is_the_function_and_launches_kernel_1(monkeypatch):
    """On the card (meta tensors here) ``stft`` runs kernel 1 through the
    STFT Function, so the spectrogram stays attached to autograd; where
    autograd does not follow (enhance, under no_grad) it launches the kernel
    alone."""
    calls = []
    monkeypatch.setattr(stft_cuda, "KERNEL", lambda dev, *args: calls.append(args))
    x = torch.empty((3, 8160), device="meta", requires_grad=True)
    spec = tdsp.stft(x, TCFG)
    assert len(calls) == 1 and spec.shape == (3, 256, 256)
    assert type(spec.re.grad_fn).__name__ == "ViewBackward0"
    assert type(spec.re.grad_fn.next_functions[0][0]).__name__ == "STFTBackward"
    with torch.no_grad():
        assert tdsp.stft(x, TCFG).re.grad_fn is None
    assert len(calls) == 2
