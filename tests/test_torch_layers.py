"""The port's complex layers against the JAX package's flax modules, with the
JAX weights moved by ``dcs_net_tpu_torch.convert``: complex conv, convT
(multi-input, fused upsample), linear, whitening BN (eval and train), CBAM,
the complex LSTM and the mask bound. The port runs on the CPU.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from dcs_net_tpu.ops import attention as jatt
from dcs_net_tpu.ops import complex_layers as jcl
from dcs_net_tpu.ops import masks as jmasks
from dcs_net_tpu.ops.lstm import ComplexLSTM as JaxComplexLSTM
from dcs_net_tpu.utils.carray import CArray as JC

from dcs_net_tpu_torch.convert import params_from_jax
from dcs_net_tpu_torch.ops import attention as tatt
from dcs_net_tpu_torch.ops import complex_layers as tcl
from dcs_net_tpu_torch.ops import initializers as tinit
from dcs_net_tpu_torch.ops import masks as tmasks
from dcs_net_tpu_torch.ops.lstm import ComplexLSTM
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_train import _one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _jc(p):
    return JC(jnp.asarray(p[0]), jnp.asarray(p[1]))


def _tc(p):
    return CArray(torch.from_numpy(p[0]), torch.from_numpy(p[1]))


def _load(port: nn.Module, variables, name: str = "layer") -> nn.Module:
    """Move a JAX layer's variables into ``port`` through the converter (the
    layer is named ``name`` in the tree so module-name rules apply)."""
    tree = {col: {name: v} for col, v in variables.items()}
    sd = {k[len(name) + 1:]: v for k, v in params_from_jax(tree).items()}
    port.load_state_dict(sd, strict=True)
    return port


def _close(got: CArray, want: JC, **tol):
    np.testing.assert_allclose(got.re.detach().numpy(), np.asarray(want.re), **(tol or TOL))
    np.testing.assert_allclose(got.im.detach().numpy(), np.asarray(want.im), **(tol or TOL))


@pytest.mark.parametrize("cin,cout,k,stride,bias", [
    (1, 8, 7, (2, 2), True),
    (4, 6, 5, (2, 1), True),
    (2, 1, 7, (1, 1), False),    # spatial-attention conv: kernel 2's class
])
def test_complex_conv2d(cin, cout, k, stride, bias):
    x = _pair((2, 16, 12, cin), 1)
    mod = jcl.ComplexConv2d(cout, k, stride=stride, padding=k // 2, use_bias=bias)
    v = jax.jit(mod.init)(jax.random.PRNGKey(0), _jc(x))
    want = jax.jit(mod.apply)(v, _jc(x))
    port = _load(tcl.ComplexConv2d(cin, cout, k, stride=stride, padding=k // 2,
                                   use_bias=bias), v)
    _close(port(_tc(x)), want)


@pytest.mark.parametrize("upsample", [(2, 1), (2, 2)])
def test_complex_conv_transpose2d_multi_input(upsample):
    d, skip = _pair((2, 5, 6, 3), 2), _pair((2, 5, 6, 4), 3)
    mod = jcl.ComplexConvTranspose2d(5, 3, padding=1, upsample=upsample)
    v = jax.jit(mod.init)(jax.random.PRNGKey(1), (_jc(d), _jc(skip)))
    want = jax.jit(mod.apply)(v, (_jc(d), _jc(skip)))
    port = _load(tcl.ComplexConvTranspose2d(7, 5, 3, padding=1, upsample=upsample),
                 v, name="layer_convt")
    got = port((_tc(d), _tc(skip)))
    assert got.shape == (2, 5 * upsample[0], 6 * upsample[1], 5)
    _close(got, want)


def test_complex_linear():
    x = _pair((2, 7, 6), 4)
    mod = jcl.ComplexLinear(5)
    v = jax.jit(mod.init)(jax.random.PRNGKey(2), _jc(x))
    want = jax.jit(mod.apply)(v, _jc(x))
    _close(_load(tcl.ComplexLinear(6, 5), v)(_tc(x)), want)


def _perturbed_bn_variables(v, seed):
    """BN variables with gammas, betas and running stats moved off init, so
    the layer is not close to the identity."""
    rng = np.random.default_rng(seed)
    out = {"params": {}, "batch_stats": {}}
    for col in out:
        for k, a in v[col].items():
            a = np.asarray(a)
            out[col][k] = a + rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
    out["batch_stats"]["vrr"] = np.abs(out["batch_stats"]["vrr"]) + 0.5
    out["batch_stats"]["vii"] = np.abs(out["batch_stats"]["vii"]) + 0.5
    return out


def test_complex_batchnorm_eval():
    x = _pair((2, 6, 5, 4), 5)
    mod = jcl.ComplexBatchNorm2d(4)
    v = jax.jit(lambda k, a: mod.init(k, a, train=False))(jax.random.PRNGKey(3), _jc(x))
    v = _perturbed_bn_variables(v, 6)
    want = jax.jit(lambda vv, a: mod.apply(vv, a, train=False))(v, _jc(x))
    port = _load(tcl.ComplexBatchNorm2d(4), v).eval()
    _close(port(_tc(x)), want)


def test_complex_batchnorm_train_and_running_stats():
    x = _pair((2, 6, 5, 4), 7)
    mod = jcl.ComplexBatchNorm2d(4)
    v = jax.jit(lambda k, a: mod.init(k, a, train=False))(jax.random.PRNGKey(4), _jc(x))
    v = _perturbed_bn_variables(v, 8)
    want, upd = jax.jit(lambda vv, a: mod.apply(
        vv, a, train=True, mutable=["batch_stats"]))(v, _jc(x))
    port = _load(tcl.ComplexBatchNorm2d(4), v).train()
    _close(port(_tc(x)), want, rtol=1e-5, atol=2e-5)
    for k, a in upd["batch_stats"].items():
        np.testing.assert_allclose(getattr(port, k).numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("maxpool_is_avg", [True, False])
def test_complex_channel_attention(maxpool_is_avg):
    x = _pair((2, 6, 5, 16), 9)
    mod = jatt.ComplexChannelAttention(16, 4, maxpool_is_avg=maxpool_is_avg)
    v = jax.jit(mod.init)(jax.random.PRNGKey(5), _jc(x))
    want = jax.jit(mod.apply)(v, _jc(x))
    port = _load(tatt.ComplexChannelAttention(16, 4, maxpool_is_avg=maxpool_is_avg), v)
    got = port(_tc(x))
    assert got.shape == (2, 1, 1, 16)
    _close(got, want)


def test_complex_spatial_attention():
    x = _pair((2, 16, 12, 6), 10)
    mod = jatt.ComplexSpatialAttention(7)
    v = jax.jit(mod.init)(jax.random.PRNGKey(6), _jc(x))
    want = jax.jit(mod.apply)(v, _jc(x))
    got = _load(tatt.ComplexSpatialAttention(7), v)(_tc(x))
    assert got.shape == (2, 16, 12, 1)
    _close(got, want)


@pytest.mark.parametrize("bidir,with_state", [(True, False), (False, True)])
def test_complex_lstm(bidir, with_state):
    B, T, F, H, L = 2, 9, 6, 5, 2
    D = 2 if bidir else 1
    x = _pair((B, T, F), 11)
    state_np = None
    if with_state:
        rng = np.random.default_rng(12)
        state_np = tuple(tuple(rng.standard_normal((L * D, 2 * B, H)).astype(np.float32)
                               for _ in range(2)) for _ in range(2))
    mod = JaxComplexLSTM(H, L, bidir)
    jstate = None if state_np is None else jax.tree.map(jnp.asarray, state_np)
    v = jax.jit(mod.init)(jax.random.PRNGKey(7), _jc(x), jstate)
    want, want_state = jax.jit(mod.apply)(v, _jc(x), jstate)
    port = _load(ComplexLSTM(F, H, L, bidir), v)
    tstate = None if state_np is None else tuple(
        tuple(torch.from_numpy(a) for a in s) for s in state_np)
    got, got_state = port(_tc(x), tstate)
    _close(got, want)
    for g, w in zip(jax.tree.leaves(tuple(tuple(s) for s in got_state)),
                    jax.tree.leaves(want_state)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name,make,bound", [
    ("xavier", lambda: tinit.xavier_uniform(12, 20), np.sqrt(6.0 / 32)),
    ("kaiming", lambda: tinit.kaiming_uniform(12), np.sqrt(1.0 / 12)),
    ("bias", lambda: tinit.torch_bias_uniform(9), 1.0 / 3.0),
    ("lstm", lambda: tinit.lstm_uniform(16), 0.25),
])
def test_initializers_bounds_and_generator(name, make, bound):
    """The torch distributions' bounds, and one seed -> one draw."""
    init = make()
    a = init((4000,), torch.Generator().manual_seed(3))
    b = init((4000,), torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(a.abs().max()) <= bound
    assert float(a.abs().max()) > 0.95 * bound


def test_bound_crm():
    m = _pair((2, 64, 33), 13)
    m[0][0, 0, :3] = [-1e-6, 0.0, 3.0]   # includes the guarded (0, 0) point
    m[1][0, 0, :3] = [0.0, 0.0, -4.0]
    want = jax.jit(lambda a: jmasks.bound_crm(a, 1e-6))(_jc(m))
    _close(tmasks.bound_crm(_tc(m), 1e-6), want, rtol=1e-6, atol=1e-6)


def _loaded_spatial_attention(x, seed):
    mod = jatt.ComplexSpatialAttention(7)
    v = jax.jit(mod.init)(jax.random.PRNGKey(seed), _jc(x))
    return mod, v, _load(tatt.ComplexSpatialAttention(7), v)


def test_spatial_gate_matches_jax_attention_then_product():
    """The fused gate (plain versions on the CPU) against the JAX spatial
    attention followed by the complex product, and against the module's own
    un-fused path."""
    from dcs_net_tpu_torch.ops import cuda_conv

    x = _pair((2, 16, 12, 6), 20)
    mod, v, port = _loaded_spatial_attention(x, 8)
    want = jax.jit(lambda vv, a: a * mod.apply(vv, a))(v, _jc(x))
    with torch.no_grad():
        got = port.gate(_tc(x))
        unfused = tcl.complex_mul_bcast(_tc(x), port(_tc(x)))
        plain = cuda_conv.spatial_gate_plain(*_tc(x), port.packed_kernel())
    assert got.shape == (2, 16, 12, 6)
    _close(got, want)
    _close(CArray(*plain), want)
    torch.testing.assert_close(got.re, unfused.re, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.im, unfused.im, rtol=1e-5, atol=1e-5)


def test_spatial_gate_other_kernel_size_takes_the_unfused_path():
    x = _pair((1, 8, 9, 4), 21)
    port = tatt.ComplexSpatialAttention(3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, want = port.gate(_tc(x)), tcl.complex_mul_bcast(_tc(x), port(_tc(x)))
    torch.testing.assert_close(got.re, want.re, rtol=0, atol=0)
    torch.testing.assert_close(got.im, want.im, rtol=0, atol=0)


def test_packed_kernel_is_kept_and_follows_the_weights():
    """Without autograd the packed block kernel is built once; a
    ``load_state_dict``, an in-place update and a dtype/device move each
    replace it. It serves the forward-only fused gate alone, so it stays
    detached with autograd on; the gate then takes the un-fused form, through
    which gradients reach the weights."""
    gen = torch.Generator().manual_seed(1)
    sa = tatt.ComplexSpatialAttention(7, generator=gen)
    other = tatt.ComplexSpatialAttention(7, generator=gen)
    x = _tc(_pair((1, 6, 7, 4), 22))

    def fresh(m):
        return m.conv.block_kernel().detach()

    with torch.no_grad():
        first = sa.packed_kernel()
        assert first.shape == (7, 7, 4, 2) and first.is_contiguous()
        assert sa.packed_kernel() is first                   # kept
        torch.testing.assert_close(first, fresh(sa), rtol=0, atol=0)
        before = sa.gate(x)

        sa.load_state_dict(other.state_dict())
        second = sa.packed_kernel()
        assert second is not first
        torch.testing.assert_close(second, fresh(other), rtol=0, atol=0)
        after = sa.gate(x)
        want = other.gate(x)
        torch.testing.assert_close(after.re, want.re, rtol=0, atol=0)
        assert float((after.re - before.re).abs().max()) > 1e-4

        sa.conv.weight_i.mul_(0.5)                           # an optimizer step
        third = sa.packed_kernel()
        assert third is not second
        torch.testing.assert_close(third, fresh(sa), rtol=0, atol=0)

        sa.double()                                          # new storage
        assert sa.packed_kernel().dtype == torch.float64
        sa.float()
        sa.train()
        assert sa.packed_kernel() is sa.packed_kernel()      # no autograd: kept

    assert not sa.packed_kernel().requires_grad              # inference only
    out = sa.gate(x)
    (out.re.sum() + out.im.sum()).backward()
    assert sa.conv.weight_r.grad is not None and float(sa.conv.weight_r.grad.abs().max()) > 0
    sa.requires_grad_(False)
    assert sa.packed_kernel() is sa.packed_kernel()          # frozen weights: kept
