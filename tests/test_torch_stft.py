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
    before = stft_cuda.KERNEL.launches
    a = stft_cuda.stft_dft(x, cos_b, sin_b, 32, 256)
    b = stft_cuda.stft_dft_plain(x, cos_b, sin_b, 32, 256)
    assert stft_cuda.KERNEL.launches == before
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


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
