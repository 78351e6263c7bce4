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
from dcs_net_tpu.ops.pallas_conv import _conv_fwd_pallas, _conv_fwd_xla
from dcs_net_tpu.ops.pallas_tapconv import tapconv_valid as jax_tapconv

from dcs_net_tpu_torch.ops import conv_engine as tce
from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv


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
