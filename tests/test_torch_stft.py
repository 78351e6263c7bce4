"""The port's STFT / iSTFT (dcs_net_tpu_torch/dsp) against the JAX package's,
and kernel 1's plain version against the Pallas STFT kernel in interpret mode.

Inputs are made with numpy from fixed seeds and fed to both packages. The
port runs on the CPU here, i.e. through the plain versions of its kernels.
"""

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
    dense_cfg = STFTConfig(n_fft=400, hop=100, win_length=400)
    for cfg in (TCFG, dense_cfg):       # the FFT's size and the dense kernel's
        c = stft_cuda.stft_analysis(x, tdsp._analysis_plan(cfg, x.device))
        if cfg is TCFG:
            for u, v in zip(c, b):
                torch.testing.assert_close(u, v, rtol=0, atol=0)
    assert (stft_cuda.KERNEL.launches, stft_cuda.KERNEL_DENSE.launches) == before


@pytest.mark.parametrize("n_fft,hop,entry", [(512, 32, "fft"), (400, 100, "dense"),
                                             (512, 1024, "dense")])
def test_plan_off_the_cpu_holds_only_what_its_entry_reads(n_fft, hop, entry):
    """A plan for another device than the CPU carries the FFT tables or the
    dense bases, never both (the meta device stands in for the card); the
    CPU's plan always carries the bases of the plain version."""
    cfg = STFTConfig(n_fft=n_fft, hop=hop, win_length=n_fft)
    plan = tdsp._analysis_plan(cfg, torch.device("meta"))
    assert stft_cuda.choose_entry(n_fft, hop) == entry
    assert (plan.fft is not None) == (entry == "fft")
    assert (plan.cos_b is not None) == (plan.sin_b is not None) == (entry == "dense")
    assert (plan.n_fft, plan.n_bins, plan.hop) == (n_fft, n_fft // 2, hop)
    cpu = tdsp._analysis_plan(cfg, torch.device("cpu"))
    assert cpu.cos_b.shape == cpu.sin_b.shape == (n_fft, n_fft // 2)
    assert (cpu.fft is not None) == (n_fft in stft_cuda.FFT_RADICES)


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


def frames_through_skewed_span(xpad, n_fft, hop, n_frames):
    """The even and the odd samples of every frame, (B, T, n_fft/2) each, read
    as the FFT kernel reads them: a tile of 32 frames stages its sample span
    in shared memory skewed by one word per 32 (zeros past the signal's end),
    and lane l reads words skew(l*hop + 2n) and skew(l*hop + 2n + 1). Words
    the staging never writes are NaN here."""
    span = hop * 31 + n_fft
    s = torch.arange(span)
    nn = 2 * torch.arange(n_fft // 2)
    even, odd = [], []
    for t0 in range(0, n_frames, 32):
        src = t0 * hop + s
        ok = src < xpad.shape[-1]
        fxs = torch.full(xpad.shape[:-1] + (int(_skew(span - 1)) + 1,), float("nan"))
        fxs[..., _skew(s)] = torch.where(ok, xpad[..., src.clamp(max=xpad.shape[-1] - 1)],
                                         torch.zeros(()))
        word = (torch.arange(min(32, n_frames - t0)) * hop)[:, None] + nn
        even.append(fxs[..., _skew(word)])
        odd.append(fxs[..., _skew(word + 1)])
    return torch.cat(even, dim=-2), torch.cat(odd, dim=-2)


def fft_kernel_model(x, cfg):
    """What the FFT kernel computes, step by step in float32, from the tables
    the wrapper hands it: frames of the reflect-padded signal read out of the
    skewed span of their tile, the real frame
    packed into n_fft/2 complex points times ``win2``, radix R1 over r for
    each residue q (n = q + R2 r), the ``tw`` twiddles, radix R2 over q giving
    Z[k1 + R1 k2], then the split step with ``sp`` for the kept bins."""
    plan = tdsp._analysis_plan(cfg, x.device)
    win2, tw, sp = (torch.view_as_complex(t) if i else t
                    for i, t in enumerate(plan.fft))
    r1, r2 = stft_cuda.FFT_RADICES[cfg.n_fft]
    n2 = r1 * r2
    if plan.pad:
        x = torch.nn.functional.pad(x[:, None], (plan.pad, plan.pad),
                                    mode="reflect")[:, 0]
    even, odd = frames_through_skewed_span(x, cfg.n_fft, cfg.hop,
                                           cfg.num_frames(x.shape[-1] - 2 * plan.pad))
    z = torch.complex(even * win2[:, 0], odd * win2[:, 1])    # (B, T, n_fft/2)
    z = z.reshape(z.shape[:-1] + (r1, r2))                       # [r, q]
    y = torch.einsum("kr,btrq->btqk", _small_dft(r1), z) * tw    # [q, k1]
    zz = torch.einsum("jq,btqk->btjk", _small_dft(r2), y)        # [k2, k1]
    zz = zz.reshape(zz.shape[:-2] + (n2,))                       # k = k1 + R1 k2
    k = torch.arange(plan.first_bin, plan.first_bin + cfg.n_bins)
    a, c = zz[..., k % n2], zz[..., (n2 - k) % n2]
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
]
# odd hops: an odd lane's sample pair starts at an odd word, and may lie
# across a skew step of the staged span
FFT_ODD_HOP_CASES = [
    (128, 31, True, True, (2, 2100)),
    (64, 7, False, False, (1, 700)),
    (512, 33, True, True, (1, 2500)),
    (256, 1, False, True, (1, 300)),
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


@pytest.mark.parametrize("n_fft", sorted(stft_cuda.FFT_RADICES))
def test_fft_tables_are_float64_accurate(n_fft):
    """The tables are rounded once from float64: unit-modulus twiddles, the
    window halves, and radices whose product is n_fft / 2."""
    r1, r2 = stft_cuda.FFT_RADICES[n_fft]
    assert r1 * r2 * 2 == n_fft and max(r1, r2) <= 16
    w = np.random.default_rng(7).uniform(0.1, 1.0, n_fft)
    win2, tw, sp = stft_cuda.fft_tables(w)
    assert win2.dtype == tw.dtype == sp.dtype == np.float32
    np.testing.assert_array_equal(win2.reshape(-1), (0.5 * w).astype(np.float32))
    k = np.arange(n_fft // 2 + 1)
    np.testing.assert_allclose(sp[:, 0] + 1j * sp[:, 1],
                               np.exp(-2j * np.pi * k / n_fft), atol=6e-8)
    qk = np.outer(np.arange(r2), np.arange(r1))
    np.testing.assert_allclose(tw[..., 0] + 1j * tw[..., 1],
                               np.exp(-4j * np.pi * qk / n_fft), atol=6e-8)


@pytest.mark.parametrize("n_fft,hop,entry", [
    (512, 32, "fft"), (256, 64, "fft"), (128, 128, "fft"), (64, 16, "fft"),
    (512, 33, "fft"), (64, 7, "fft"),
    (400, 100, "dense"), (1024, 256, "dense"), (32, 8, "dense"),
    (96, 24, "dense"), (512, 1024, "dense"),
])
def test_entry_point_is_chosen_from_the_shape(n_fft, hop, entry):
    """Sizes the FFT kernel is instantiated for name it; every other size,
    power of two or not, names the dense DFT kernel. No launch happens."""
    assert stft_cuda.choose_entry(n_fft, hop) == entry
    tables = stft_cuda.fft_tables(np.ones(n_fft))
    assert (tables is None) == (n_fft not in stft_cuda.FFT_RADICES)


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
