#!/usr/bin/env python3
"""On-card smoke test of dcs_net_tpu_torch, the PyTorch/CUDA port.

Run from the repository root with one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints one or more lines; any failure exits non-zero):
  1. device  -- requires CUDA; prints the card's name and power limit as
               ``nvidia-smi --query-gpu=name,power.limit`` gives them;
  2. build   -- compiles the three kernel sources of dcs_net_tpu_torch/csrc
               with nvcc for sm_90a (one process per source, in parallel):
               stft.cu (kernel 1: an FFT inside the kernel, and the dense DFT
               for the sizes the FFT is not instantiated for), conv_same.cu
               (kernel 2) and tapconv.cu (kernel 3: a 3xTF32 wgmma implicit
               GEMM and the kernel that packs its weights);
  3. slice   -- full-width DCS ``enhance_full`` on 4 requests of 4 s at 16 kHz
               (seeded weights, BN statistics moved off their init): checks
               shape, finiteness and each kernel's launch count in that call,
               times the call, and holds a 1 s request on the card against
               the same weights on the CPU (atol 3e-4, rtol 1e-3);
  4. kernels -- each kernel against its plain PyTorch version on the card at
               every shape the slice launched it with (error relative to
               max |plain| <= 1e-4, TF32 off), with its device time per
               call (CUDA graph replay), the plain version's, one PyTorch
               library call's and the card's bound for the function; the
               same for what the slice does not launch: kernel 1's dense
               entry point at a size that is no power of two; then, against
               the plain version only, kernel 1's FFT entry point at its
               other sizes, at odd hops and without centering, kernel 3 at
               ragged shapes and at windows up to 12x12, and kernel 3's
               packed weights bit for bit against the PyTorch layout helper;
  5. cli     -- a 48 kHz wav through ``python -m dcs_net_tpu_torch.cli.enhance``
               (``main``), read back and checked.
The last lines are the kernels JSON, the nvidia-smi line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
SR = 16000
BATCH, SECONDS = 4, 4
REL_TOL = 1e-4                    # kernel vs plain, relative to max |plain|
SLICE_RTOL, SLICE_ATOL = 1e-3, 3e-4
# H100 SXM data sheet: HBM3 rate, float32 (non-tensor-core) peak, dense TF32
# tensor-core peak. Kernel 3 runs float32-accurate products as three TF32
# passes (3xTF32), so the rate its operations are held against is TF32 / 3.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
TF32X3_FLOPS_PER_S = TF32_FLOPS_PER_S / 3

# kernel name -> (source, the TPU kernel it replaces, design, the rate its
# least operations are held against)
KERNEL_INFO = {
    "stft": ("dcs_net_tpu_torch/csrc/stft.cu", "dcs_net_tpu/dsp/stft_pallas.py:120",
             "fft", F32_FLOPS_PER_S),
    "stft_dense": ("dcs_net_tpu_torch/csrc/stft.cu", "dcs_net_tpu/dsp/stft_pallas.py:120",
                   "dense-dft", F32_FLOPS_PER_S),
    "conv_same_small_cout": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                             "dcs_net_tpu/ops/pallas_conv.py:138", "simt-f32",
                             F32_FLOPS_PER_S),
    "tapconv_valid": ("dcs_net_tpu_torch/csrc/tapconv.cu",
                      "dcs_net_tpu/ops/pallas_tapconv.py:91", "3xtf32-wgmma",
                      TF32X3_FLOPS_PER_S),
}
# what the slice does not launch: kernel 1's dense entry point at a size that
# is no power of two (B, n, n_fft, hop); its FFT entry point at the other
# sizes it is instantiated for, at odd hops and without centering
# (B, n, n_fft, hop, center, drop_dc); and kernel 3 at ragged shapes and at
# windows whose halo tiles need the 64-pixel tile (5x5 over a long row) or a
# single halo-tile stage (7x7, 12x12) to fit shared memory
# ((B, Hp, Wp, Cin), (Dh, Dw), N)
DENSE_STFT_CASE = (2, 12000, 400, 100)
FFT_STFT_EXTRA = [(2, 3000, 64, 16, True, True), (3, 5000, 128, 32, False, False),
                  (2, 9000, 256, 64, True, True), (2, 4100, 128, 31, True, True),
                  (1, 2000, 64, 7, False, False), (2, 7000, 512, 33, True, True),
                  (1, 6000, 256, 1, False, True), (2, 9000, 512, 512, True, False)]
TAPCONV_EXTRA = [((2, 10, 9, 64), (3, 3), 32), ((2, 5, 7, 24), (2, 2), 12),
                 ((2, 5, 140, 7), (3, 3), 5), ((1, 4, 300, 36), (1, 1), 130),
                 ((2, 40, 150, 40), (5, 5), 128), ((1, 9, 100, 72), (7, 7), 100),
                 ((1, 12, 80, 68), (7, 7), 24), ((1, 14, 90, 36), (12, 12), 70),
                 ((2, 12, 200, 16), (5, 3), 6)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def speech_like(n_req: int, n: int, seed: int) -> np.ndarray:
    """Voiced harmonic tones with a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    out = np.zeros((n_req, n))
    for b in range(n_req):
        f0 = rng.uniform(100.0, 250.0) * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t))
        phase = 2 * np.pi * np.cumsum(f0) / SR
        voiced = sum(rng.uniform(0.2, 1.0) / k * np.sin(k * phase) for k in range(1, 9))
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t) ** 2
        out[b] = 0.3 * voiced * env / np.abs(voiced).max()
    out += 0.05 * rng.standard_normal(out.shape)
    return out.astype(np.float32)


def perturb_bn(model, seed: int) -> None:
    """Move every complex BN's gammas, betas and running statistics off their
    init values so BN is not the identity (covariances stay positive)."""
    import torch

    from dcs_net_tpu_torch.ops.complex_layers import ComplexBatchNorm2d

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if not isinstance(mod, ComplexBatchNorm2d):
                continue
            for name in ("gamma_rr", "gamma_ii", "gamma_ri", "beta_r", "beta_i",
                         "mean_r", "mean_i", "vri"):
                t = getattr(mod, name)
                t.add_((torch.rand(t.shape, generator=g) * 0.2 - 0.1).to(t.device))
            for name in ("vrr", "vii"):
                t = getattr(mod, name)
                t.mul_((torch.rand(t.shape, generator=g) * 0.8 + 0.8).to(t.device))


def graph_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card: after two warm-up
    calls on a side stream, ``iters`` calls are captured in one CUDA graph,
    and one replay of it is timed with CUDA events, so the host's dispatch
    (Python, ctypes, PyTorch's op overhead) drops out of the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class ShapeLog:
    """Stands in for a CudaKernel during the shape-discovery pass: notes the
    integer arguments of every launch, then launches."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.calls = []

    def __call__(self, device, *args):
        self.calls.append(tuple(a for a in args if isinstance(a, int)))
        return self.kernel(device, *args)


def discover_shapes(run):
    """Run ``run()`` with every kernel wrapped in a ShapeLog; return
    {kernel name: [int-args per launch]}."""
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv

    mods = (stft_cuda, cuda_conv, cuda_tapconv)
    logs = {m: ShapeLog(m.KERNEL) for m in mods}
    try:
        for m, log in logs.items():
            m.KERNEL = log
        run()
    finally:
        for m, log in logs.items():
            m.KERNEL = log.kernel
    return {log.kernel.name: log.calls for log in logs.values()}


def kernel_cases(name, args, dev, cfg):
    """For one recorded launch: (kernel fn, plain fn, library fn, bytes,
    flops, design flops), all on fresh seeded tensors of the recorded shapes.
    bytes and flops are the least the function needs; design flops, where
    not None, are what the kernel's own algorithm does."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv

    g = torch.Generator(device=dev).manual_seed(SEED + 7)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    if name in ("stft", "stft_dense"):
        if name == "stft":
            B, n, n_fft, hop, first_bin, n_bins, T, pad = args
            scfg = cfg.stft
        else:
            B, n, n_fft, hop, n_bins, T, pad = args
            scfg = dataclasses.replace(cfg.stft, n_fft=n_fft, hop=hop, win_length=n_fft)
        entry = stft_cuda.choose_entry(n_fft, hop)
        if entry != {"stft": "fft", "stft_dense": "dense"}[name]:
            fail(f"n_fft {n_fft}, hop {hop} names the {entry} entry point, not {name}")
        plan = dsp._analysis_plan(scfg, dev)
        cos_b, sin_b = dsp._on_device(dsp._dft_basis_eff, scfg, dev)
        x = randn(B, n, scale=0.3)
        win = torch.from_numpy(dsp.window_np(scfg).astype(np.float32)).to(dev)
        # least traffic: the signal, the window and twiddle tables (the
        # (n_fft, F) bases for the dense entry point), the output
        consts = (sum(t.numel() for t in plan.fft) if name == "stft"
                  else 2 * n_fft * n_bins)
        nbytes = 4 * (B * n + consts + 2 * B * n_bins * T)
        # least work: a real-input FFT per frame, 2.5 n log2 n flops; the
        # dense entry point does 2 dots of n_fft per bin and frame
        flops = int(B * T * 2.5 * n_fft * math.log2(n_fft))
        dft_flops = None if name == "stft" else 2 * 2 * B * T * n_bins * n_fft
        return (lambda: stft_cuda.stft_analysis(x, plan),
                lambda: stft_cuda.stft_dft_plain(x, cos_b, sin_b, hop, pad),
                lambda: torch.stft(x, n_fft, hop, n_fft, win, center=pad > 0,
                                   pad_mode="reflect", normalized=True,
                                   return_complex=True),
                nbytes, flops, dft_flops)
    if name == "conv_same_small_cout":
        B, H, W, cin, K, cout = args
        x = randn(B, H, W, cin)
        w = randn(K, K, cin, cout, scale=0.1)
        bias = randn(cout)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = 4 * (x.numel() + w.numel() + cout + B * H * W * cout)
        flops = 2 * B * H * W * K * K * cin * cout
        return (lambda: cuda_conv.conv2d_same_small_cout(x, w, bias),
                lambda: cuda_conv.conv2d_same_small_cout_plain(x, w, bias),
                lambda: F.conv2d(x_nchw, w_oihw, bias, padding=K // 2),
                nbytes, flops, None)
    if name == "tapconv_valid":
        B, hp, wp, cin, dh, dw, n = args[:7]
        x = randn(B, hp, wp, cin)
        w = randn(dh * dw, cin, n, scale=1.0 / math.sqrt(dh * dw * cin))
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.reshape(dh, dw, cin, n).permute(3, 2, 0, 1).contiguous()
        ho, wo = hp - dh + 1, wp - dw + 1
        nbytes = 4 * (x.numel() + w.numel() + B * ho * wo * n)
        flops = 2 * B * ho * wo * dh * dw * cin * n
        return (lambda: cuda_tapconv.tapconv_valid(x, w, dh, dw),
                lambda: cuda_tapconv.tapconv_valid_plain(x, w, dh, dw),
                lambda: F.conv2d(x_nchw, w_oihw),
                nbytes, flops, None)
    raise KeyError(name)


def check_kernels(shapes, launches, dev, cfg, card):
    """Phase 4: every recorded shape, kernel vs plain on the card, each
    timed as device time per call (``graph_ms``)."""
    import torch

    rows = []
    for name, calls in shapes.items():
        src, repl, design_name, ops_rate = KERNEL_INFO[name]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
        max_abs = max_rel = 0.0
        timed = {}
        for args in calls:
            kern, plain, lib, nbytes, flops, design_flops = kernel_cases(
                name, args, dev, cfg)
            if args not in timed:
                got, want = kern(), plain()
                torch.cuda.synchronize()
                if isinstance(got, tuple):
                    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                    ref = max(float(b.abs().max()) for b in want)
                else:
                    err, ref = float((got - want).abs().max()), float(want.abs().max())
                rel = err / max(ref, 1e-30)
                bound = max(nbytes / HBM_BYTES_PER_S, flops / ops_rate) * 1e3
                iters = max(3, min(50, int(1.0 / max(bound, 1e-3))))
                t_k = graph_ms(kern, iters)
                t_p = graph_ms(plain, iters)
                t_l = graph_ms(lib, iters)
                timed[args] = (t_k, t_p, t_l)
                design = ("" if design_flops is None else
                          f" design_ceiling_ms={design_flops / F32_FLOPS_PER_S * 1e3:.4f}"
                          f" (its own {design_flops / 1e9:.2f} GFLOP at the float32 rate)")
                print(f"kernel {name} args={args} max_abs_err={err:.3e} "
                      f"rel_err={rel:.3e} ms={t_k:.4f} plain_ms={t_p:.4f} "
                      f"library_ms={t_l:.4f} bound_ms={bound:.4f}{design} [{card}]",
                      flush=True)
                if not math.isfinite(rel) or rel > REL_TOL:
                    fail(f"{name} at {args}: error {rel:.3e} relative to max "
                         f"|plain| exceeds {REL_TOL}")
                max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
            t_k, t_p, t_l = timed[args]
            tot["ms"] += t_k
            tot["plain_ms"] += t_p
            tot["library_ms"] += t_l
            tot["bytes"] += nbytes
            tot["flops"] += flops
        t_bytes = tot["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = tot["flops"] / ops_rate * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "design": design_name, "launches": launches[name],
            "max_abs_err": max_abs,
            "max_rel_err": max_rel, "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": {"bytes_per_s": HBM_BYTES_PER_S, "flops_per_s": ops_rate},
            "library_ms": tot["library_ms"], "shapes": len(set(calls)),
        })
        where = (f"{len(calls)} launches per enhance call" if launches[name]
                 else "not on the slice's path")
        print(f"kernel {name} ({design_name}): {where}, "
              f"summed ms={tot['ms']:.4f} plain_ms={tot['plain_ms']:.4f} "
              f"library_ms={tot['library_ms']:.4f} bound_ms={rows[-1]['bound_ms']:.4f} "
              f"({rows[-1]['bound_by']}) [{card}]", flush=True)
    return rows


def check_stft_fft_off_path(dev, cfg) -> None:
    """Kernel 1's FFT entry point where the slice does not take it: every
    size it is instantiated for, odd hops (a lane's sample pair then starts
    at an odd word of the skewed span), no centering, the DC bin kept."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.dsp import stft as dsp
    from dcs_net_tpu_torch.dsp import stft_cuda

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    for B, n, n_fft, hop, center, drop_dc in FFT_STFT_EXTRA:
        scfg = dataclasses.replace(cfg.stft, n_fft=n_fft, hop=hop, win_length=n_fft,
                                   center=center, drop_dc=drop_dc)
        if stft_cuda.choose_entry(n_fft, hop) != "fft":
            fail(f"n_fft {n_fft}, hop {hop} does not name the FFT entry point")
        plan = dsp._analysis_plan(scfg, dev)
        cos_b, sin_b = dsp._on_device(dsp._dft_basis_eff, scfg, dev)
        x = torch.randn((B, n), generator=g, device=dev) * 0.3
        before = stft_cuda.KERNEL.launches
        got = stft_cuda.stft_analysis(x, plan)
        want = stft_cuda.stft_dft_plain(x, cos_b, sin_b, hop, plan.pad)
        torch.cuda.synchronize()
        if stft_cuda.KERNEL.launches != before + 1:
            fail(f"stft at n_fft {n_fft}, hop {hop} did not launch the FFT kernel")
        rel = (max(float((a - b).abs().max()) for a, b in zip(got, want))
               / max(float(b.abs().max()) for b in want))
        print(f"kernel stft off the path: x ({B}, {n}) n_fft {n_fft} hop {hop} "
              f"center {center} drop_dc {drop_dc} -> {tuple(got[0].shape)}: "
              f"rel_err={rel:.3e}", flush=True)
        if got[0].shape != want[0].shape or not math.isfinite(rel) or rel > REL_TOL:
            fail(f"stft (fft) at n_fft {n_fft}, hop {hop}: error {rel:.3e} "
                 f"exceeds {REL_TOL}")


def check_tapconv_off_path(dev) -> None:
    """Kernel 3 where the slice does not take it: ragged pixel runs, channel
    counts that fill no chunk or tile, other windows; and the weights its
    packing kernel writes, bit for bit against ``pack_weights``."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_tapconv as ct
    from dcs_net_tpu_torch.utils.cuda_lib import ptr

    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    for shape, (dh, dw), n in TAPCONV_EXTRA:
        x = torch.randn(shape, generator=g, device=dev)
        w = torch.randn((dh * dw, shape[-1], n), generator=g, device=dev) * 0.1
        got, want = ct.tapconv_valid(x, w, dh, dw), ct.tapconv_valid_plain(x, w, dh, dw)
        rel = float((got - want).abs().max()) / float(want.abs().max())
        want_packed = ct.pack_weights(w, ct.tile_n(n))
        packed = torch.empty_like(want_packed)
        ct.PACK(dev, ptr(w), ptr(packed), dh * dw, shape[-1], n, ct.tile_n(n))
        torch.cuda.synchronize()
        same = bool((packed.view(torch.int32) == want_packed.view(torch.int32)).all())
        print(f"kernel tapconv_valid off the path: x {shape} {dh}x{dw} -> {n}: "
              f"rel_err={rel:.3e}, packed weights equal pack_weights: {same}", flush=True)
        if not math.isfinite(rel) or rel > REL_TOL:
            fail(f"tapconv_valid at {shape}: error {rel:.3e} exceeds {REL_TOL}")
        if not same:
            fail(f"tapconv_pack at {shape}: layout differs from pack_weights")


def main() -> int:
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, write_wav
    from dcs_net_tpu_torch.dsp import stft_cuda  # noqa: F401  (registers kernel 1)
    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.ops import cuda_conv, cuda_tapconv  # noqa: F401
    from dcs_net_tpu_torch.utils import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    card = f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}"
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} [{card}]",
          flush=True)

    # phase 2: build
    t0 = time.perf_counter()
    build_s = cuda_lib.build_all()
    print(f"build: {len(cuda_lib.KERNELS)} kernels ({', '.join(cuda_lib.KERNELS)}) "
          f"built in {build_s:.1f} s (nvcc {cuda_lib.find_nvcc()}), "
          f"into {cuda_lib.BUILD_DIR}", flush=True)

    # phase 3: the slice at full width
    cfg = config_for_variant("dcs")
    model = DCSNet(cfg.model, cfg.quirks, device=dev, seed=SEED).eval()
    perturb_bn(model, SEED + 1)
    x = torch.from_numpy(speech_like(BATCH, SECONDS * SR, SEED + 2)).to(dev)

    shapes = discover_shapes(lambda: enhance_full(model, x, cfg))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    out = enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t1
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"slice: enhance_full launches {launches}", flush=True)
    if tuple(out.shape) != (BATCH, SECONDS * SR):
        fail(f"enhance_full returned {tuple(out.shape)}")
    if not bool(torch.isfinite(out).all()):
        fail("enhance_full returned non-finite samples")
    want = {"stft": (1, None), "conv_same_small_cout": (13, 13),
            "tapconv_valid": (7, 7), "tapconv_pack": (7, 7)}
    for name, (lo, hi) in want.items():
        n = launches.get(name, 0)
        if n < lo or (hi is not None and n > hi):
            fail(f"kernel {name} launched {n} times in one enhance call, "
                 f"expected {lo if hi is None else hi}{'+' if hi is None else ''}")
    reps = 3
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        enhance_full(model, x, cfg)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t1) / reps
    print(f"slice: {BATCH} requests x {SECONDS} s: counted call {t_call * 1e3:.1f} ms, "
          f"steady {t_steady * 1e3:.1f} ms per call (latency per request), "
          f"{BATCH * SECONDS / t_steady:.1f} audio-s/s, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]",
          flush=True)

    short = torch.from_numpy(speech_like(1, SR, SEED + 3))
    on_card = enhance_full(model, short.to(dev), cfg).cpu()
    cpu_model = DCSNet(cfg.model, cfg.quirks, device="cpu", seed=SEED)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    on_cpu = enhance_full(cpu_model, short, cfg)
    diff = (on_card - on_cpu).abs()
    bad = int((diff > SLICE_ATOL + SLICE_RTOL * on_cpu.abs()).sum())
    print(f"slice: 1 s request card vs CPU: max |diff| {float(diff.max()):.3e}, "
          f"{bad} samples outside atol {SLICE_ATOL} rtol {SLICE_RTOL}", flush=True)
    if bad:
        fail("card and CPU disagree on the 1 s request")

    # phase 4: kernels against their plain versions, at the slice's shapes
    B, n, n_fft, hop = DENSE_STFT_CASE
    dense_args = (B, n, n_fft, hop, n_fft // 2, 1 + n // hop, n_fft // 2)
    shapes = {"stft": shapes["stft"], "stft_dense": [dense_args],
              "conv_same_small_cout": shapes["conv_same_small_cout"],
              "tapconv_valid": shapes["tapconv_valid"]}
    rows = check_kernels(shapes, launches, dev, cfg, card)
    check_stft_fft_off_path(dev, cfg)
    check_tapconv_off_path(dev)

    # phase 5: CLI on a 48 kHz wav
    from dcs_net_tpu_torch.cli import enhance as cli

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "noisy48k.wav"), os.path.join(tmp, "clean.wav")
        n48 = 2 * 48000
        t = np.arange(n48) / 48000.0
        rng = np.random.default_rng(SEED + 4)
        write_wav(src, (0.3 * np.sin(2 * np.pi * 330.0 * t)
                        + 0.05 * rng.standard_normal(n48)).astype(np.float32), 48000)
        cli.main(["dcs", "--in", src, "--out", dst])
        audio, sr = read_wav(dst)
    if sr != SR or audio.shape != (n48 // 3,) or not np.all(np.isfinite(audio)):
        fail(f"CLI output: sr {sr}, shape {audio.shape}")
    print(f"cli: 2 s at 48 kHz -> {audio.shape[0]} samples at {sr} Hz, finite", flush=True)
    print(f"total: {time.perf_counter() - t0:.1f} s after the device check", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
