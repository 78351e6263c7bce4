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
               (kernel 2: the small-Cout conv, the spatial-attention pooling
               pass and the conv with the gate's sigmoid-and-product epilogue)
               and tapconv.cu (kernel 3: a 3xTF32 wgmma implicit GEMM and the
               kernel that packs its weights);
  3. slice   -- full-width DCS ``enhance_full`` on 4 requests of 4 s at 16 kHz
               (seeded weights, BN statistics moved off their init): checks
               shape, finiteness and each kernel's launch count in that call,
               times the call, and holds a 1 s request on the card against
               the same weights on the CPU (atol 3e-4, rtol 1e-3);
  4. stream  -- full-width DCS ``enhance_streaming``: (a) one 30 s request,
               256-frame chunks overlapping by 64 in groups of 8: shape,
               finiteness, launch counts (1 STFT; 13 gates and 7 tap convs a
               group), time per call, and a 3 s request card vs CPU; (b) the
               streaming preset with the LSTM carry, no overlap, 10 s: with
               chunk-local ops (1x1 convs, no attention) chunked == full pass
               on the card within 1e-4; with the product's ops finite, its
               correlation with the full pass printed, and 2 s card vs CPU;
  5. kernels -- each kernel against its plain PyTorch version on the card at
               every shape the slice launched it with (error relative to
               max |plain| <= 1e-4, TF32 off), with its device time per
               call (CUDA graph replay), the plain version's, one PyTorch
               library call's and the card's bound for the function; kernel
               2's conv entry at the gate's shapes of the full-utterance call
               and of a streaming chunk group, beside the body it replaced
               and an empty launch; the same for what the slice does not
               launch: kernel 1's dense entry point at a size that is no
               power of two; then, against the plain version only, kernel 1's
               FFT entry point at its other sizes, at odd hops and without
               centering, kernel 2's three entries at odd and tiny shapes and
               other (K, Cin, Cout), kernel 3 at ragged shapes and at windows
               up to 12x12, and kernel 3's packed weights bit for bit against
               the PyTorch layout helper;
  6. cli     -- a 48 kHz wav through ``python -m dcs_net_tpu_torch.cli.enhance``
               (``main``), full and with ``--stream``, read back and checked.
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
                             "dcs_net_tpu/ops/pallas_conv.py:138",
                             "simt-f32-register-tiled", F32_FLOPS_PER_S),
    "sa_pool": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                "dcs_net_tpu/ops/pallas_conv.py:138", "channel-mean-max",
                F32_FLOPS_PER_S),
    "sa_gate": ("dcs_net_tpu_torch/csrc/conv_same.cu",
                "dcs_net_tpu/ops/pallas_conv.py:138",
                "conv-sigmoid-product-epilogue", F32_FLOPS_PER_S),
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
# kernel 2 where the slice does not take it. The tiled (7, 4, 2) body and the
# gate: odd H and W, W below one thread's run, batch 1 and 32, C = 1 and C no
# multiple of 4 ((B, H, W, C)); the generic body: K = 3 and 5, Cout = 8,
# other Cin ((B, H, W, Cin), K, Cout)
GATE_EXTRA = [(1, 5, 3, 1), (2, 7, 9, 6), (3, 17, 129, 12), (32, 4, 8, 16),
              (1, 3, 70, 20), (1, 1, 1, 4), (2, 33, 300, 8)]
CONV_EXTRA = [((2, 9, 40, 4), 3, 2), ((2, 16, 33, 4), 5, 8), ((1, 7, 5, 3), 7, 2),
              ((3, 20, 50, 6), 7, 16), ((32, 6, 10, 4), 7, 3)]
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

    slots = [(stft_cuda, "KERNEL"), (cuda_conv, "KERNEL"), (cuda_conv, "POOL"),
             (cuda_conv, "GATE"), (cuda_tapconv, "KERNEL")]
    logs = [ShapeLog(getattr(mod, attr)) for mod, attr in slots]
    try:
        for (mod, attr), log in zip(slots, logs):
            setattr(mod, attr, log)
        run()
    finally:
        for (mod, attr), log in zip(slots, logs):
            setattr(mod, attr, log.kernel)
    return {log.kernel.name: log.calls for log in logs}


def kernel_cases(name, args, dev, cfg):
    """For one recorded launch: (kernel fn, plain fn, library fn or None,
    bytes, flops, design flops, extras), all on fresh seeded tensors of the
    recorded shapes. bytes and flops are the least the function needs; design
    flops, where not None, are what the kernel's own algorithm does; extras
    are further functions to time beside the kernel, by column name."""
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
                nbytes, flops, dft_flops, {})
    if name == "conv_same_small_cout":
        B, H, W, cin, K, cout = args[:6]
        x = randn(B, H, W, cin)
        w = randn(K, K, cin, cout, scale=0.1)
        bias = randn(cout)
        x_nchw = x.permute(0, 3, 1, 2).contiguous()
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = 4 * (x.numel() + w.numel() + cout + B * H * W * cout)
        flops = 2 * B * H * W * K * K * cin * cout
        # earlier_ms: the body this shape class ran before the tiled one
        return (lambda: cuda_conv.conv2d_same_small_cout(x, w, bias),
                lambda: cuda_conv.conv2d_same_small_cout_plain(x, w, bias),
                lambda: F.conv2d(x_nchw, w_oihw, bias, padding=K // 2),
                nbytes, flops, None,
                {"earlier_ms": lambda: cuda_conv.launch_conv(
                    x, w, bias, cuda_conv.GENERIC_TILE)})
    if name in ("sa_pool", "sa_gate"):
        B, H, W, C = args[:4]
        re, im = randn(B, H, W, C), randn(B, H, W, C)
        w = randn(7, 7, 4, 2, scale=0.3)
        zero = torch.zeros(2, device=dev)
        pooled = cuda_conv.sa_pool_plain(re, im)
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        P = B * H * W
        if name == "sa_pool":
            # x read once, the pooled map written; a sum and a max per value
            return (lambda: cuda_conv.sa_pool(re, im),
                    lambda: cuda_conv.sa_pool_plain(re, im), None,
                    4 * (2 * P * C + 4 * P), 4 * P * C, None, {})

        def eager_library():
            a = torch.sigmoid(F.conv2d(pooled.permute(0, 3, 1, 2), w_oihw, padding=3))
            a_re, a_im = a[:, 0, :, :, None], a[:, 1, :, :, None]
            return re * a_re - im * a_im, re * a_im + im * a_re

        def replaced_sequence():
            # what the module ran before the fused gate, pooling included:
            # 4 reductions, a concatenation, the conv's earlier body on the
            # card, a sigmoid, the complex product as 6 elementwise passes
            a = torch.sigmoid(cuda_conv.launch_conv(
                cuda_conv.sa_pool_plain(re, im), w, zero, cuda_conv.GENERIC_TILE))
            a_re, a_im = a[..., :1], a[..., 1:]
            return re * a_re - im * a_im, re * a_im + im * a_re

        # pooled map and weights read, x read once and written once
        return (lambda: cuda_conv.sa_gate(pooled, w, re, im),
                lambda: cuda_conv.sa_gate_plain(pooled, w, re, im),
                eager_library,
                4 * (4 * P + w.numel() + 4 * P * C),
                2 * P * 7 * 7 * 4 * 2 + 8 * P * C, None,
                {"replaced_pool_and_gate_ms": replaced_sequence})
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
                nbytes, flops, None, {})
    raise KeyError(name)


def check_kernels(shapes, launches, dev, cfg, card, where):
    """Every recorded shape, kernel vs plain on the card, each timed as
    device time per call (``graph_ms``). ``where`` names the call whose
    launches ``shapes`` lists; returns one row per kernel, summed over them."""
    import torch

    from dcs_net_tpu_torch.utils.timing import graph_ms

    rows = []
    for name, calls in shapes.items():
        src, repl, design_name, ops_rate = KERNEL_INFO[name]
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0, flops=0)
        max_abs = max_rel = 0.0
        timed = {}
        for args in calls:
            kern, plain, lib, nbytes, flops, design_flops, extras = kernel_cases(
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
                t = {"ms": graph_ms(kern, iters), "plain_ms": graph_ms(plain, iters),
                     "library_ms": None if lib is None else graph_ms(lib, iters)}
                t.update({k: graph_ms(fn, iters) for k, fn in extras.items()})
                timed[args] = t
                design = ("" if design_flops is None else
                          f" design_ceiling_ms={design_flops / F32_FLOPS_PER_S * 1e3:.4f}"
                          f" (its own {design_flops / 1e9:.2f} GFLOP at the float32 rate)")
                times = " ".join(f"{k}={'null' if v is None else format(v, '.4f')}"
                                 for k, v in t.items())
                print(f"kernel {name} args={args} max_abs_err={err:.3e} "
                      f"rel_err={rel:.3e} {times} bound_ms={bound:.4f}{design} "
                      f"[{card}]", flush=True)
                if not math.isfinite(rel) or rel > REL_TOL:
                    fail(f"{name} at {args}: error {rel:.3e} relative to max "
                         f"|plain| exceeds {REL_TOL}")
                if "earlier_ms" in t and t["ms"] > t["earlier_ms"]:
                    fail(f"{name} at {args}: {t['ms']:.4f} ms, slower than the "
                         f"body it replaced ({t['earlier_ms']:.4f} ms)")
                max_abs, max_rel = max(max_abs, err), max(max_rel, rel)
            for k, v in timed[args].items():
                tot[k] = None if v is None else tot.get(k, 0.0) + v
            tot["bytes"] += nbytes
            tot["flops"] += flops
        t_bytes = tot.pop("bytes") / HBM_BYTES_PER_S * 1e3
        t_ops = tot.pop("flops") / ops_rate * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "design": design_name, "launches": launches.get(name, 0),
            "max_abs_err": max_abs, "max_rel_err": max_rel, **tot,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_rate": {"bytes_per_s": HBM_BYTES_PER_S, "flops_per_s": ops_rate},
            "shapes": len(set(calls)),
        })
        on_path = (f"{len(calls)} launches per {where}" if launches.get(name, 0)
                   else "not on the slice's path")
        times = " ".join(f"{k}={'null' if v is None else format(v, '.4f')}"
                         for k, v in tot.items())
        print(f"kernel {name} ({design_name}): {on_path}, summed {times} "
              f"bound_ms={rows[-1]['bound_ms']:.4f} ({rows[-1]['bound_by']}) "
              f"[{card}]", flush=True)
    return rows


def empty_launch_ms() -> float:
    """Device time of a kernel that does nothing (conv_same.cu's
    ``dcs_empty_launch``), timed like every other row: the floor under a
    small launch."""
    import ctypes

    import torch

    from dcs_net_tpu_torch.ops import cuda_conv
    from dcs_net_tpu_torch.utils.timing import graph_ms

    cuda_conv.KERNEL._load()
    fn = cuda_conv.KERNEL._lib.dcs_empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if fn(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) != 0:
            fail("the empty kernel did not launch")

    return graph_ms(launch, 50)


def check_conv_off_path(dev) -> None:
    """Kernel 2 where the slice does not take it: the pooling pass, the gate
    and the tiled conv body at odd and tiny shapes, at channel counts that
    are 1 or no multiple of 4, on a view that is not 16-byte aligned, at
    batch 1 and 32; the generic body at other (K, Cin, Cout)."""
    import torch

    from dcs_net_tpu_torch.ops import cuda_conv as cc

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    def rel(got, want):
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        return (max(float((a - b).abs().max()) for a, b in zip(got, want))
                / max(float(b.abs().max()) for b in want))

    w = randn(7, 7, 4, 2, scale=0.3)
    bias = randn(2)
    for B, H, W, C in GATE_EXTRA:
        re, im = randn(B, H, W, C), randn(B, H, W, C)
        pooled = cc.sa_pool_plain(re, im)
        before = cc.KERNEL.launches, cc.POOL.launches, cc.GATE.launches
        errs = {"pool": rel(cc.sa_pool(re, im), pooled),
                "gate": rel(cc.sa_gate(pooled, w, re, im),
                            cc.sa_gate_plain(pooled, w, re, im)),
                "pool+gate": rel(cc.spatial_gate(re, im, w),
                                 cc.spatial_gate_plain(re, im, w)),
                "conv": rel(cc.conv2d_same_small_cout(pooled, w, bias),
                            cc.conv2d_same_small_cout_plain(pooled, w, bias))}
        # the same values behind a pointer that is 4 bytes off a 16-byte line
        off = randn(re.numel() + 1)[1:].view(re.shape).copy_(re)
        errs["gate, unaligned x"] = rel(cc.spatial_gate(off, im, w),
                                        cc.spatial_gate_plain(re, im, w))
        off4 = randn(pooled.numel() + 1)[1:].view(pooled.shape).copy_(pooled)
        errs["conv, unaligned x"] = rel(cc.conv2d_same_small_cout(off4, w, bias),
                                        cc.conv2d_same_small_cout_plain(pooled, w, bias))
        torch.cuda.synchronize()
        after = cc.KERNEL.launches, cc.POOL.launches, cc.GATE.launches
        if tuple(a - b for a, b in zip(after, before)) != (5, 3, 3):
            fail(f"kernel 2 at {(B, H, W, C)}: launches {before} -> {after}")
        print(f"kernel 2 off the path: x ({B}, {H}, {W}, {C}) tile "
              f"{cc.choose_tile(B, H, W)}: " + ", ".join(
                  f"{k} rel_err={v:.3e}" for k, v in errs.items()), flush=True)
        for k, v in errs.items():
            if not math.isfinite(v) or v > REL_TOL:
                fail(f"kernel 2 ({k}) at {(B, H, W, C)}: error {v:.3e} exceeds {REL_TOL}")
    for shape, K, cout in CONV_EXTRA:
        x = randn(*shape)
        wk, bk = randn(K, K, shape[-1], cout, scale=0.1), randn(cout)
        v = rel(cc.conv2d_same_small_cout(x, wk, bk),
                cc.conv2d_same_small_cout_plain(x, wk, bk))
        print(f"kernel conv_same_small_cout off the path (generic body): x {shape} "
              f"K {K} -> {cout}: rel_err={v:.3e}", flush=True)
        if not math.isfinite(v) or v > REL_TOL:
            fail(f"conv_same_small_cout at {shape}, K {K}, Cout {cout}: error "
                 f"{v:.3e} exceeds {REL_TOL}")


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


def compare_card_cpu(what: str, on_card, on_cpu) -> None:
    diff = (on_card - on_cpu).abs()
    bad = int((diff > SLICE_ATOL + SLICE_RTOL * on_cpu.abs()).sum())
    print(f"{what} card vs CPU: max |diff| {float(diff.max()):.3e}, "
          f"{bad} samples outside atol {SLICE_ATOL} rtol {SLICE_RTOL}", flush=True)
    if bad:
        fail(f"card and CPU disagree on {what}")


def check_streaming(model, cpu_model, cfg, dev, card):
    """Phase "stream". Returns the kernel shapes and launch counts of the
    30 s streaming call."""
    import dataclasses

    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.utils import cuda_lib

    # (a) one 30 s request through the default (bidirectional) model
    seconds, chunk, overlap, group = 30, 256, 64, 8
    x = torch.from_numpy(speech_like(1, seconds * SR, SEED + 5)).to(dev)
    frames = 1 + seconds * SR // cfg.stft.hop
    n_chunks = max(1, math.ceil(max(frames - overlap, 1) / (chunk - overlap)))
    n_groups = -(-n_chunks // group)
    shapes = discover_shapes(lambda: enhance_streaming(model, x, cfg))
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t1 = time.perf_counter()
    out = enhance_streaming(model, x, cfg, chunk_frames=chunk, overlap=overlap,
                            chunk_batch=group)
    torch.cuda.synchronize()
    t_call = time.perf_counter() - t1
    launches = {k.name: k.launches for k in cuda_lib.KERNELS.values()}
    print(f"stream: enhance_streaming, {seconds} s, {n_chunks} chunks of {chunk} "
          f"frames in {n_groups} groups: launches {launches}", flush=True)
    if tuple(out.shape) != (1, seconds * SR) or not bool(torch.isfinite(out).all()):
        fail(f"enhance_streaming returned {tuple(out.shape)} or non-finite samples")
    want = {"stft": 1, "sa_pool": 13 * n_groups, "sa_gate": 13 * n_groups,
            "conv_same_small_cout": 13 * n_groups, "tapconv_valid": 7 * n_groups,
            "tapconv_pack": 7 * n_groups}
    for name, n in want.items():
        if launches.get(name, 0) != n:
            fail(f"kernel {name} launched {launches.get(name, 0)} times in the "
                 f"streaming call, expected {n}")
    reps = 3
    t1 = time.perf_counter()
    for _ in range(reps):
        enhance_streaming(model, x, cfg, chunk_frames=chunk, overlap=overlap,
                          chunk_batch=group)
    torch.cuda.synchronize()
    t_steady = (time.perf_counter() - t1) / reps
    print(f"stream: 1 request x {seconds} s: counted call {t_call * 1e3:.1f} ms, "
          f"steady {t_steady * 1e3:.1f} ms per call, {seconds / t_steady:.1f} "
          f"audio-s/s [{card}]", flush=True)
    short = torch.from_numpy(speech_like(1, 3 * SR, SEED + 6))
    compare_card_cpu("stream: 3 s request (2 chunks of 256, overlap 64)",
                     enhance_streaming(model, short.to(dev), cfg).cpu(),
                     enhance_streaming(cpu_model, short, cfg))

    # (b) the LSTM carry. Chunked == full pass only where every other op is
    # chunk-local, so exactness is held on a full-width model with 1x1 convs
    # and no attention; the streaming preset itself is held to finiteness, to
    # its closeness to the full pass (printed) and to the CPU.
    scfg = config_for_variant("dcs", streaming=True)
    local = scfg.replace(model=dataclasses.replace(
        scfg.model, kernel_e=(1,) * 7, kernel_d=(1,) * 7, sa_kernel=1,
        attention=False))
    x10 = torch.from_numpy(speech_like(1, 10 * SR, SEED + 7)).to(dev)
    exact = DCSNet(local.model, local.quirks, device=dev, seed=SEED + 1).eval()
    perturb_bn(exact, SEED + 2)
    full = enhance_full(exact, x10, local)
    carried = enhance_streaming(exact, x10, local, chunk_frames=chunk, overlap=0,
                                carry_lstm_state=True)
    restart = enhance_streaming(exact, x10, local, chunk_frames=chunk, overlap=0,
                                chunk_batch=1)
    d_carry = float((carried - full).abs().max())
    d_restart = float((restart - full).abs().max())
    print(f"stream: carry, 10 s in {math.ceil((1 + 10 * SR // 32) / chunk)} chunks, "
          f"chunk-local ops (1x1 convs, no attention): max |chunked - full| "
          f"{d_carry:.3e} (limit 1e-4; without the carry {d_restart:.3e}), "
          f"max |full| {float(full.abs().max()):.3f}", flush=True)
    if not d_carry <= 1e-4:
        fail("chunks that carry the LSTM state do not reproduce the full pass")
    del exact

    smodel = DCSNet(scfg.model, scfg.quirks, device=dev, seed=SEED).eval()
    perturb_bn(smodel, SEED + 1)
    cuda_lib.reset_launch_counts()
    full = enhance_full(smodel, x10, scfg)
    carried = enhance_streaming(smodel, x10, scfg, chunk_frames=chunk, overlap=0,
                                carry_lstm_state=True)
    torch.cuda.synchronize()
    if tuple(carried.shape) != (1, 10 * SR) or not bool(torch.isfinite(carried).all()):
        fail("the carried stream of the streaming preset is not finite")
    corr = float(torch.corrcoef(torch.stack([full[0], carried[0]]))[0, 1])
    print(f"stream: carry, streaming preset (attention on, 3x3 to 7x7 convs), "
          f"10 s: finite, correlation with the full pass {corr:.4f}, max "
          f"|chunked - full| {float((carried - full).abs().max()):.3e}", flush=True)
    scpu = DCSNet(scfg.model, scfg.quirks, device="cpu", seed=SEED)
    scpu.load_state_dict({k: v.cpu() for k, v in smodel.state_dict().items()})
    short = torch.from_numpy(speech_like(1, 2 * SR, SEED + 8))
    kw = dict(chunk_frames=64, overlap=0, carry_lstm_state=True)
    compare_card_cpu("stream: carry, 2 s request (4 chunks of 64)",
                     enhance_streaming(smodel, short.to(dev), scfg, **kw).cpu(),
                     enhance_streaming(scpu, short, scfg, **kw))
    return shapes, launches


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
            "sa_pool": (13, 13), "sa_gate": (13, 13),
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
    compare_card_cpu("slice: 1 s request", on_card, on_cpu)

    # phase 4: streaming
    stream_shapes, stream_launches = check_streaming(model, cpu_model, cfg, dev, card)

    # phase 5: kernels against their plain versions, at the slice's shapes.
    # Kernel 2's conv entry is held at the shapes the gate entry ran its body
    # at: the 13 of the full-utterance call and those of one chunk group.
    B, n, n_fft, hop = DENSE_STFT_CASE
    dense_args = (B, n, n_fft, hop, n_fft // 2, 1 + n // hop, n_fft // 2)
    floor = empty_launch_ms()
    print(f"kernel floor: an empty launch takes {floor:.4f} ms of device time "
          f"[{card}]", flush=True)

    def conv_shapes(gate_calls):
        return [a[:3] + (4, 7, 2) for a in gate_calls]

    shapes = {"stft": shapes["stft"], "stft_dense": [dense_args],
              "conv_same_small_cout": conv_shapes(shapes["sa_gate"]),
              "sa_pool": shapes["sa_pool"], "sa_gate": shapes["sa_gate"],
              "tapconv_valid": shapes["tapconv_valid"]}
    rows = check_kernels(shapes, launches, dev, cfg, card, "enhance call")
    group = {"stft": stream_shapes["stft"],
             "conv_same_small_cout": conv_shapes(stream_shapes["sa_gate"][:13]),
             "sa_pool": stream_shapes["sa_pool"][:13],
             "sa_gate": stream_shapes["sa_gate"][:13],
             "tapconv_valid": stream_shapes["tapconv_valid"][:7]}
    stream_rows = {r["name"]: r for r in check_kernels(
        group, stream_launches, dev, cfg, card, "streaming chunk group")}
    for row in rows:
        row["launches_stream"] = stream_launches.get(row["name"], 0)
        if row["name"] in stream_rows:
            row["chunk_group"] = {k: stream_rows[row["name"]][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "max_abs_err", "shapes")}
        if row["name"] == "conv_same_small_cout":
            row["empty_launch_ms"] = floor
    check_stft_fft_off_path(dev, cfg)
    check_conv_off_path(dev)
    check_tapconv_off_path(dev)

    # phase 6: CLI on a 48 kHz wav, full and streamed
    from dcs_net_tpu_torch.cli import enhance as cli

    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "noisy48k.wav"), os.path.join(tmp, "clean.wav")
        n48 = 2 * 48000
        t = np.arange(n48) / 48000.0
        rng = np.random.default_rng(SEED + 4)
        write_wav(src, (0.3 * np.sin(2 * np.pi * 330.0 * t)
                        + 0.05 * rng.standard_normal(n48)).astype(np.float32), 48000)
        for flags in ([], ["--stream", "--chunk-frames", "128"],
                      ["--carry", "--chunk-frames", "128"]):
            cli.main(["dcs", "--in", src, "--out", dst, *flags])
            audio, sr = read_wav(dst)
            if sr != SR or audio.shape != (n48 // 3,) or not np.all(np.isfinite(audio)):
                fail(f"CLI output with {flags}: sr {sr}, shape {audio.shape}")
            print(f"cli {' '.join(flags) or '(full)'}: 2 s at 48 kHz -> "
                  f"{audio.shape[0]} samples at {sr} Hz, finite", flush=True)
    print(f"total: {time.perf_counter() - t0:.1f} s after the device check", flush=True)

    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
