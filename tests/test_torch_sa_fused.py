"""Kernel 2's fused bf16 gate (``cuda_conv.sa_fused_bf16``, ``csrc/conv_same.cu:
sa_fused_bf16_kernel``) on the CPU, and DC (the complex family without the
subtractive mask) served through it.

* A float32 model of the kernel's arithmetic, written from the wrapper's own
  tables: the tile plan and the box each block's tensor copies bring
  (``fused_geometry``, ``fused_box_origin``), the pooled map with zeros
  outside the image and in its two pad columns, each pooled value rounded
  to bf16, the conv as k16 steps of (16 pixels x 16) x (16 x 8) products
  on ``fused_b_table`` (2 outputs x 2 row x 2 column shifts in its 8
  columns; taps outside the kernel zero), the sigmoid and the complex
  product from the box, each output rounded once. It equals the pair's
  plain versions, ``sa_gate_bf16_plain(sa_pool_bf16_plain(...))``, within
  2^-7 of max |plain| (both sum exact bf16 products in float32 and round
  once: they differ by the order of the float32 sums), at the DCS sites'
  (H, W, C) at narrow batch, at odd sizes and at forced tiles; and the JAX
  ``ComplexSpatialAttention`` at bf16 applied to its input within 2^-6 (the
  band of ``test_spatial_gate_bf16_matches_jax_and_its_conv_the_pallas_conv``:
  XLA rounds at other points).
* The tile plan on meta tensors: the 13 sites of a full-width DCS forward
  at the enhance, stream, carry and eval shapes each launch the fused entry
  once, at the pinned tile, within shared memory, on the grid it should.
* Routing: the fused entry at C % 8 == 0 (up to 256), PR 15's pair
  otherwise; the float32 gate as before; forward-only under autograd.
* Narrow DC ``enhance_full`` against the JAX package at float32 (the oracle
  band, atol 3e-4 / rtol 1e-3) and at bf16 (within half of JAX's own bf16 to
  float32 distance, as ``test_enhance_paths_bf16_in_band_of_jax``).

One JAX compile (the attention and both DC calls in one ``jax.jit``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcs_net_tpu.core.config import config_for_variant as jax_config_for_variant
from dcs_net_tpu.models.enhance import enhance_full as jax_enhance_full
from dcs_net_tpu.models.unet import DCSNet as JaxDCSNet
from dcs_net_tpu.ops import attention as jatt
from dcs_net_tpu.ops import complex_layers as jcl
from dcs_net_tpu.utils.carray import CArray as JC

from dcs_net_tpu_torch.convert import jax_from_params, params_from_jax
from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.models.enhance import enhance_full
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.ops import attention as tatt
from dcs_net_tpu_torch.ops import cuda_conv
from dcs_net_tpu_torch.utils.carray import CArray

from test_torch_enhance import NARROW, _perturb
from test_torch_layers import _load, _pair
from test_torch_train import _one_torch_thread  # noqa: F401

B16 = torch.bfloat16
BF16_OUT = 2.0 ** -7       # a bf16 output against its plain version
BAND = 2.0 ** -6           # the gate against JAX's rounding points


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(B16).float()


def _rel(got, want) -> float:
    got = [g.float() for g in got]
    want = [w.float() for w in want]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    return err / max(max(float(w.abs().max()) for w in want), 1e-30)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    re, im = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(B16)
              for _ in range(2))
    w = torch.from_numpy((0.3 * rng.standard_normal((7, 7, 4, 2))).astype(np.float32))
    return re, im, w.to(B16)


def fused_model(re, im, w, tile=None):
    """sa_fused_bf16_kernel in float32 on the CPU, block by block, from the
    wrapper's tables (see the module docstring). Returns (out_re, out_im)
    bf16 and the pooled maps of every block, {(b, h0, w0): map}."""
    B, H, W, C = re.shape
    geo = cuda_conv.fused_geometry(B, H, W, C, tile)
    th, tw, br, bc, pp = geo.th, geo.tw, geo.br, geo.bc, geo.pp
    xr, xi = re.float(), im.float()
    bt = cuda_conv.fused_b_table(w).float()                # (8, 2, 16, 8)
    out_r, out_i = torch.empty(B, H, W, C), torch.empty(B, H, W, C)
    maps = {}
    nx, ny, nb = geo.grid
    for b in range(nb):
        for by in range(ny):
            for bx in range(nx):
                h0, w0 = by * th, bx * tw
                sh, sw = cuda_conv.fused_box_origin(geo, H, W, h0, w0)
                box_r, box_i = xr[b, sh:sh + br, sw:sw + bc], xi[b, sh:sh + br, sw:sw + bc]
                assert box_r.shape[:2] == (br, bc)          # the copy stays in x
                hh = h0 - 3 + torch.arange(th + 6)[:, None]
                ww = w0 - 3 + torch.arange(pp)[None]
                inside = ((ww < w0 + tw + 3) & (hh >= 0) & (hh < H) & (ww >= 0)
                          & (ww < W))
                # every image pixel of the tile and its halo lies in the box
                assert bool(((hh - sh >= 0) & (hh - sh < br) & (ww - sw >= 0)
                             & (ww - sw < bc))[inside].all())
                rows = (hh - sh).clamp(0, br - 1).expand(th + 6, pp)
                cols = (ww - sw).clamp(0, bc - 1).expand(th + 6, pp)
                pr, pi = box_r[rows, cols], box_i[rows, cols]    # (th + 6, pp, C)
                pooled = torch.stack([pr.mean(-1), pr.amax(-1), pi.mean(-1), pi.amax(-1)],
                                     dim=-1)
                pm = torch.where(inside[..., None], _bf16(pooled), torch.zeros(()))
                maps[(b, h0, w0)] = pm
                # the conv: a product's M row is an even tile column ce, its
                # A row of (pooled row r + d, step u) holds, at k, the map at
                # (r + d, ce + 4 u + t), channel ch, for (t, ch) =
                # FUSED_K_ORDER[k]; its columns n = 4 dy + 2 s + c are tile
                # pixel (r + dy, ce + s)'s outputs c. Rows past the map (the
                # last pair's second row at odd th) read zeros.
                pm2 = torch.nn.functional.pad(pm, (0, 0, 0, 0, 0, 2))
                rr = torch.arange(0, th, 2)[:, None]
                ce = torch.arange(0, tw, 2)[None]
                acc = torch.zeros(rr.shape[0], ce.shape[1], 8)
                for d in range(8):
                    for u in range(2):
                        a = torch.stack([pm2[rr + d, ce + 4 * u + t, ch]
                                         for t, ch in cuda_conv.FUSED_K_ORDER], dim=-1)
                        acc = acc + a @ bt[d, u]
                att = torch.zeros(th + 1, tw + 1, 2)
                for n in range(0, 8, 2):
                    dy, sx = n // 4, (n // 2) % 2
                    att[rr + dy, ce + sx] = torch.sigmoid(acc[..., n:n + 2])
                rv, cv = min(th, H - h0), min(tw, W - w0)
                a_re, a_im = att[:rv, :cv, :1], att[:rv, :cv, 1:]
                x_r = box_r[h0 - sh:h0 - sh + rv, w0 - sw:w0 - sw + cv]
                x_i = box_i[h0 - sh:h0 - sh + rv, w0 - sw:w0 - sw + cv]
                out_r[b, h0:h0 + rv, w0:w0 + cv] = x_r * a_re - x_i * a_im
                out_i[b, h0:h0 + rv, w0:w0 + cv] = x_r * a_im + x_i * a_re
    return (out_r.to(B16), out_i.to(B16)), maps


def _plain(re, im, w):
    return cuda_conv.sa_gate_bf16_plain(cuda_conv.sa_pool_bf16_plain(re, im), w, re, im)


# the DCS sites' (H, W, C) at the enhance widths, at narrow batch; then odd
# sizes: W no multiple of the tile, H and W under one tile, C = 8 and 256,
# C no power of two, a box narrower than the tile plus its halo
@pytest.mark.parametrize("shape", [
    (1, 2, 251, 128), (2, 4, 251, 128), (1, 8, 251, 128), (1, 16, 251, 64),
    (1, 32, 251, 32), (1, 64, 502, 16), (1, 128, 1004, 8),
    (2, 9, 37, 8), (1, 5, 3, 8), (3, 6, 20, 24), (1, 3, 70, 256), (1, 12, 30, 128),
    (2, 1, 9, 16)])
def test_fused_model_matches_the_pair_plain(shape):
    re, im, w = _inputs(shape, sum(shape))
    got, _ = fused_model(re, im, w)
    want = _plain(re, im, w)
    assert got[0].dtype == B16 and got[0].shape == re.shape
    assert _rel(got, want) <= BF16_OUT
    # the wrapper's CPU path is the pair's plain versions
    cpu = cuda_conv.sa_fused_bf16(re, im, w)
    assert all(torch.equal(a, b) for a, b in zip(cpu, want))


@pytest.mark.parametrize("shape,tile", [
    ((2, 20, 40, 8), (4, 8)), ((1, 20, 40, 8), (16, 16)), ((1, 7, 90, 32), (7, 64)),
    ((2, 4, 33, 128), (1, 8)), ((1, 10, 17, 16), (3, 24))])
def test_fused_model_at_forced_tiles(shape, tile):
    re, im, w = _inputs(shape, 7 + sum(tile))
    assert cuda_conv.fused_fits(*shape, tile)
    got, _ = fused_model(re, im, w, tile)
    assert _rel(got, _plain(re, im, w)) <= BF16_OUT


def test_halo_is_the_convs_zero_padding():
    """Pooling a zero-filled pixel gives 0, the conv's zero padding of the
    pooled map; the model's map of a corner block is the zero-padded plain
    pooled map, and zero in the two pad columns past the halo."""
    zeros = torch.zeros((1, 1, 1, 16), dtype=B16)
    assert torch.equal(cuda_conv.sa_pool_bf16_plain(zeros, zeros),
                       torch.zeros((1, 1, 1, 4), dtype=B16))
    re, im, w = _inputs((1, 9, 20, 16), 3)
    geo = cuda_conv.fused_geometry(1, 9, 20, 16, (4, 8))
    _, maps = fused_model(re, im, w, (4, 8))
    padded = torch.nn.functional.pad(cuda_conv.sa_pool_bf16_plain(re, im).float(),
                                     (0, 0, 3, 3, 3, 3))
    for (b, h0, w0), pm in maps.items():
        want = padded[b, h0:h0 + geo.th + 6, w0:w0 + geo.tw + 6]
        torch.testing.assert_close(pm[:want.shape[0], :want.shape[1]], want, rtol=0,
                                   atol=0)
        assert not bool(pm[:, geo.tw + 6:].any())


def test_b_table_is_the_packed_kernel_in_fragment_order():
    """A thread's k = 2 t + {0, 1} and 2 t + 8 + {0, 1} are pooled pixel t's
    channels (0, 1) and (2, 3); column n = 4 dy + 2 s + c of row offset d and
    step u is w[d - dy][4 u + t - s][ch][c], and each tap of each output
    (dy, s, c) appears exactly once over (d, u, k)."""
    order = cuda_conv.FUSED_K_ORDER
    assert order[:4] == ((0, 0), (0, 1), (1, 0), (1, 1))
    assert order[8:12] == ((0, 2), (0, 3), (1, 2), (1, 3)) and order[15] == (3, 3)
    assert sorted(order) == [(t, c) for t in range(4) for c in range(4)]
    w = 1.0 + torch.arange(7 * 7 * 4 * 2, dtype=torch.float32).reshape(7, 7, 4, 2)
    b = cuda_conv.fused_b_table(w)
    assert b.shape == (8, 2, 16, 8)
    for n in range(8):
        dy, sx, c = n // 4, (n // 2) % 2, n % 2
        col = b[..., n]
        # the 196 weights of output c, each once; zeros elsewhere
        assert int((col != 0).sum()) == 196
        assert sorted(col[col != 0].tolist()) == sorted(w[..., c].flatten().tolist())
        assert not bool(col[:dy].any())                    # taps above the kernel
    for d, u, k, n in ((0, 0, 0, 0), (3, 1, 5, 6), (7, 1, 11, 5), (2, 0, 15, 2)):
        t, ch = order[k]
        dy, sx, c = n // 4, (n // 2) % 2, n % 2
        torch.testing.assert_close(b[d, u, k, n], w[d - dy, 4 * u + t - sx, ch, c])


def test_fused_model_in_band_of_jax_attention(jax_results):
    """The model against the JAX complex spatial attention at bf16 applied
    to its input (``complex_mul_bcast``), and the attention module's gate
    (its CPU path) in the same band."""
    x, variables, want = jax_results["x"], jax_results["sa_vars"], jax_results["gate"]
    port = _load(tatt.ComplexSpatialAttention(7, dtype=B16), variables).eval()
    re, im = (torch.from_numpy(p).to(B16) for p in x)
    w = port.packed_kernel()
    got, _ = fused_model(re, im, w)
    want = [torch.from_numpy(np.array(jnp.asarray(p, jnp.float32))) for p in want]
    assert _rel(got, want) <= BAND
    with torch.no_grad():
        gated = port.gate(CArray(re, im))
    assert _rel((gated.re, gated.im), want) <= BAND


# --- the tile plan and the routing on meta tensors ------------------------------

class _Recorder:
    """Stands in for a CudaKernel: notes the integer arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(tuple(a for a in args if isinstance(a, int)))


# (B, T) of each bf16 path's forward: a 4 x 4 s enhance call (frames padded
# to 2008), a stream group of 8 chunks, a carried chunk and the eval forward
# (256 frames at batch 1); the 13 sites' (H, W, C) and the pinned tiles
SITES = ((2, 128), (4, 128), (4, 128), (8, 128), (8, 128), (16, 64), (16, 64), (32, 32),
         (32, 32), (64, 16), (64, 16), (128, 8), (128, 8))
PATHS = {
    "enhance": ((4, 2008), {2: (2, 8), 4: (4, 8), 8: (8, 8), 16: (16, 8), 32: (8, 16),
                            64: (64, 10), 128: (32, 26)}),
    "stream": ((8, 256), {2: (2, 8), 4: (4, 8), 8: (8, 8), 16: (16, 8), 32: (8, 8),
                          64: (16, 10), 128: (32, 26)}),
    "carry": ((1, 256), {2: (2, 8), 4: (4, 8), 8: (8, 8), 16: (16, 8), 32: (8, 8),
                         64: (4, 10), 128: (4, 26)}),
}
PATHS["eval"] = PATHS["carry"]


def _record(monkeypatch):
    recs = {}
    for name in ("FUSED_BF16", "POOL_BF16", "GATE_BF16", "POOL", "GATE"):
        recs[name] = _Recorder()
        monkeypatch.setattr(cuda_conv, name, recs[name])
    return recs


@pytest.mark.parametrize("path", sorted(PATHS))
def test_dcs_forward_at_bf16_launches_the_fused_entry_at_every_site(path, monkeypatch):
    """A full-width DCS forward at bf16 on meta tensors (its LSTM stubbed by
    an output of its shape: it launches no kernel of this repository and
    runs step by step on meta) launches the fused entry once a site, 13
    times, at the pinned tile within shared memory, and the pair never."""
    from dcs_net_tpu_torch.ops import cuda_tapconv

    recs = _record(monkeypatch)
    for name in ("KERNEL_BF16", "KERNEL_BF16_TAP", "PACK_BF16"):
        monkeypatch.setattr(cuda_tapconv, name, _Recorder())
    cfg = config_for_variant("dcs")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"))
    model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=0).to("meta").eval()
    hidden = cfg.model.lstm_hidden * (2 if cfg.model.lstm_bidir else 1)
    ones = torch.ones(hidden, device="meta")
    monkeypatch.setattr(model.lstm, "forward", lambda x, state: (
        CArray(x.re[..., :1] * ones, x.im[..., :1] * ones), state))
    (B, T), tiles = PATHS[path]
    with torch.no_grad():
        model(CArray(torch.empty(B, 256, T, device="meta"),
                     torch.empty(B, 256, T, device="meta")))
    calls = recs["FUSED_BF16"].calls
    W0 = T // 8
    assert [c[1:4] for c in calls] == [(H, W0 * max(1, H // 32), C) for H, C in SITES]
    for Bc, H, W, C, th, tw in calls:
        assert Bc == B and (th, tw) == tiles[H] == cuda_conv.fused_tile(B, H, W, C)
        geo = cuda_conv.fused_geometry(B, H, W, C)
        assert geo.smem <= cuda_conv.FUSED_SMEM_LIMIT and cuda_conv.fused_fits(B, H, W, C)
        assert geo.grid == (-(-W // tw), -(-H // th), B)
        assert (geo.br, geo.bc) == (min(th + 6, H), min(tw + 6, W))
        assert geo.flat == (C <= 16)          # rows of up to 512 bytes a copy
    for name in ("POOL_BF16", "GATE_BF16", "POOL", "GATE"):
        assert not recs[name].calls, name


@pytest.mark.parametrize("shape,dtype,fused", [
    ((4, 8, 251, 128), B16, True), ((2, 5, 7, 8), B16, True), ((1, 3, 9, 256), B16, True),
    ((2, 5, 7, 12), B16, False), ((2, 5, 7, 4), B16, False), ((1, 3, 9, 264), B16, False),
    ((1, 16, 20, 256), B16, False),       # a spanning tile too large for shared memory
    ((4, 8, 251, 128), torch.float32, False)])
def test_spatial_gate_routes_by_shape(shape, dtype, fused, monkeypatch):
    """The fused entry at bf16 where it takes the shape; PR 15's pool and
    gate pair otherwise (C % 8 != 0, C above 256, a tile that does not fit);
    the float32 pair at float32."""
    recs = _record(monkeypatch)
    re = torch.empty(shape, device="meta", dtype=dtype)
    w = torch.empty((7, 7, 4, 2), device="meta", dtype=dtype)
    assert cuda_conv.fused_takes(re, re) == fused
    out_re, out_im = cuda_conv.spatial_gate(re, re, w)
    assert out_re.shape == shape and out_re.dtype == dtype
    n = [len(recs[k].calls) for k in ("FUSED_BF16", "POOL_BF16", "GATE_BF16", "POOL", "GATE")]
    bf16 = dtype == B16
    assert n == ([1, 0, 0, 0, 0] if fused else [0, 1, 1, 0, 0] if bf16 else [0, 0, 0, 1, 1])
    if fused:
        assert recs["FUSED_BF16"].calls[0] == shape + cuda_conv.fused_tile(*shape)


def test_fused_entry_is_forward_only_and_refuses_what_it_cannot_take(monkeypatch):
    _record(monkeypatch)
    w = torch.empty((7, 7, 4, 2), device="meta", dtype=B16)
    x = torch.empty((2, 8, 20, 16), device="meta", dtype=B16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        cuda_conv.sa_fused_bf16(x, x, w)
    with torch.no_grad():
        cuda_conv.sa_fused_bf16(x, x, w)
        with pytest.raises(ValueError, match="does not take"):
            cuda_conv.sa_fused_bf16(x, x, w, tile=(0, 8))
        y = torch.empty((2, 8, 20, 12), device="meta", dtype=B16)
        with pytest.raises(ValueError, match="does not take"):
            cuda_conv.sa_fused_bf16(y, y, w)
        with pytest.raises(TypeError):
            cuda_conv.sa_fused_bf16(x.float(), x.float(), w)


# --- DC through the fused gate: the narrow net against the JAX package ----------

def _narrow(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, channels=NARROW,
                                                 ca_reduction=4))


def _cfg16(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="bfloat16"),
                       stft=dataclasses.replace(cfg.stft, dft_dtype="bfloat16"))


@pytest.fixture(scope="module")
def jax_results():
    """In one JAX compile: the JAX complex spatial attention at bf16 applied
    to its input (an input of 16 channels, which the fused entry takes), and
    narrow DC's ``enhance_full`` at float32 and at bf16 from one set of
    seeded weights (made by the port and moved to JAX, BN moved off its
    init)."""
    x = _pair((2, 16, 40, 16), 11)
    xb = JC(*(jnp.asarray(p).astype(jnp.bfloat16) for p in x))
    sa = jatt.ComplexSpatialAttention(7, dtype=jnp.bfloat16)
    rng = np.random.default_rng(12)
    sa_vars = {"params": {"conv": {
        k: jnp.asarray((0.2 * rng.standard_normal((7, 7, 2, 1))).astype(np.float32))
        for k in ("kernel_r", "kernel_i")}}}
    jcfg32 = _narrow(jax_config_for_variant("dc"))
    tcfg32 = _narrow(config_for_variant("dc"))
    jcfg16 = _cfg16(jcfg32)
    m32, m16 = JaxDCSNet(jcfg32.model, jcfg32.quirks), JaxDCSNet(jcfg16.model, jcfg16.quirks)
    seeded = DCSNet(tcfg32.model, tcfg32.quirks, device="cpu", seed=0).state_dict()
    variables = jax.tree.map(jnp.asarray, _perturb(jax_from_params(seeded), 1))
    t = np.arange(2016) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220.0 * t)[None]
            + 0.05 * rng.standard_normal((2, 2016))).astype(np.float32)

    def run(sv, v, xb, w):
        return {"gate": jcl.complex_mul_bcast(xb, sa.apply(sv, xb)),
                "full32": jax_enhance_full(m32, v, w, jcfg32),
                "full16": jax_enhance_full(m16, v, w, jcfg16)}

    out = jax.jit(run)(sa_vars, variables, xb, jnp.asarray(wave))
    port = DCSNet(tcfg32.model, tcfg32.quirks, device="cpu").eval()
    port.load_state_dict(params_from_jax(variables), strict=True)
    port16 = DCSNet(_cfg16(tcfg32).model, tcfg32.quirks, device="cpu").eval()
    port16.load_state_dict(params_from_jax(variables), strict=True)
    return dict(x=x, sa_vars=sa_vars, gate=out["gate"], wave=wave, tcfg32=tcfg32,
                port=port, port16=port16,
                full32=np.asarray(out["full32"]), full16=np.asarray(out["full16"]))


def test_dc_enhance_full_matches_jax_at_float32(jax_results):
    p = jax_results
    got = enhance_full(p["port"], torch.from_numpy(p["wave"]), p["tcfg32"])
    assert got.shape == (2, 2016)
    np.testing.assert_allclose(got.numpy(), p["full32"], rtol=1e-3, atol=3e-4)


def test_dc_enhance_full_at_bf16_in_band_of_jax(jax_results, monkeypatch):
    """DC at bf16 through the fused gate's CPU path (every site of the
    narrow net has C % 8 == 0 but the first, whose one channel takes the
    pair), within half of JAX's own bf16 to float32 distance from JAX's
    bf16 result, and within 0.1."""
    p = jax_results
    fused_sites = []
    real = cuda_conv.sa_fused_bf16
    monkeypatch.setattr(cuda_conv, "sa_fused_bf16",
                        lambda re, im, w: fused_sites.append(re.shape) or real(re, im, w))
    got = enhance_full(p["port16"], torch.from_numpy(p["wave"]), _cfg16(p["tcfg32"]))
    got = got.numpy()
    d_jax = float(np.abs(p["full16"] - p["full32"]).max())
    d = float(np.abs(got - p["full16"]).max())
    assert np.all(np.isfinite(got)) and d_jax > 0
    assert d <= 0.5 * d_jax, (d, d_jax)
    assert d <= 0.1
    assert fused_sites and all(s[-1] % 8 == 0 for s in fused_sites)
