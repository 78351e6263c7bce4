"""Kernel 2's tile choice, measured: the conv entry and the gate entry at every
tile the kernel takes, for the spatial-attention sites of the full-width DCS
model, or with ``--real`` of the full-width DRS model.

``python -m dcs_net_tpu_torch.tools.time_gate [--frames 2008] [--batch 4]
[--real] [--dgrad] [--dtype bfloat16]``

For each site (B, H, W, C) of a U-Net pass over ``--frames`` spectrogram
frames at ``--batch`` it prints the device time per launch (CUDA graph
replay) of the conv entry and of the gate entry with the tiles that
``ops/cuda_conv.py:choose_tile`` and ``gate_tile`` pick, with the best tile
found by a sweep over R in (2, 4) (and 8 at the real classes) and
power-of-two TX and TY, and with the generic body (conv only); the pooling
pass's time; and the site's bound for pool + gate (x read twice and written
once, the pooled map written and read, at the card's memory rate). The last
line sums each column over the 13 sites. ``--frames 256 --batch 8`` gives the sites of one streaming
chunk group; ``--no-sweep`` leaves the sweep out.

``--real`` does the same for the real attention of DR / DRS: the conv entry
at class (7, 2, 1), the real pool and gate entries, and beside them the
eager sequence the gate replaces (mean, max, concatenation, ``F.conv2d``,
sigmoid, product). ``--dgrad`` sweeps the conv entry at the input gradient's
class instead, (7, 2, 4) or with ``--real`` (7, 1, 2) (g (B, H, W, Cout) ->
(B, H, W, Cin)), beside the generic body; ``--dgrad --frames 256 --batch
32`` gives the 13 launches of a train step.

``--dtype bfloat16`` times the conv entry's bf16 class (the un-fused gate's
conv in a bf16 train step) as the package on the path routes it
(``cuda_conv._same_conv``): (7, 4, 2), with ``--dgrad`` (7, 2, 4), with
``--real`` (7, 2, 1) (and the real pool's and gate's bf16 classes beside
the bf16 eager sequence, as at float32), with both (7, 1, 2); ``--all-classes``
all four. Each site prints the body's ms, its tile, the error against the
plain version, the bound (bytes at 3.35 TB/s, operations at 989 TFLOP/s)
and one bf16 library call (``F.conv2d``, or ``conv2d_input`` for an input
gradient); without ``--no-sweep`` also the fastest tile of the
tensor-core body's (TH, TW, RB) where the package has that body. The tool
imports the package from the path, so one copy times two trees in one
call: ``git archive <parent> | tar -x -C build/parent``, then ``for t in
build/parent . . build/parent; do PYTHONPATH=$t python3
dcs_net_tpu_torch/tools/time_gate.py --dtype bfloat16 --all-classes
--frames 256 --batch 32 --no-sweep; done``.
"""

from __future__ import annotations

import argparse
import subprocess

HBM_BYTES_PER_S = 3.35e12


def sites(cfg, batch: int, frames: int):
    """(B, H, W, C) of the 13 spatial-attention sites of one U-Net pass: the
    7 skips (encoder outputs 7 ... 1) and the outputs of decoder stages 0-5,
    which have the shapes of encoder outputs 6 ... 1."""
    m = cfg.model
    shapes, h, w = [], cfg.stft.n_bins, frames
    for i in range(m.n_layers):
        h, w = -(-h // m.stride_e[i][0]), -(-w // m.stride_e[i][1])
        shapes.append((batch, h, w, m.enc_channels(i)[1]))
    return shapes[::-1] + shapes[-2::-1]


def candidate_tiles(H: int, cin: int = 4, cout: int = 2):
    from dcs_net_tpu_torch.ops import cuda_conv as cc

    out = []
    for R in (2, 4, 8) if cin * cout == 2 else (2, 4):
        for ty in (1, 2, 4, 8, 16):
            for tx in (1, 2, 4, 8, 16, 32, 64, 128):
                t = (R, tx, ty)
                if (ty <= max(1, 2 * H) and tx * ty <= cc.BLOCK_THREADS
                        and tx * ty >= 8
                        and cc.tile_smem_bytes(t, cin, cout) <= 48 * 1024):
                    out.append(t)
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--frames", type=int, default=2008)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--no-sweep", action="store_true",
                   help="time the chosen tile and the generic body only")
    p.add_argument("--real", action="store_true",
                   help="the real attention's sites and classes (DRS)")
    p.add_argument("--dgrad", action="store_true",
                   help="the conv entry at the input gradient's class")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="bfloat16: the conv entry's bf16 class (and with --real the real "
                        "pool's and gate's)")
    p.add_argument("--all-classes", action="store_true",
                   help="with --dtype bfloat16: the conv entry's four bf16 classes")
    args = p.parse_args(argv)
    if args.all_classes and args.dtype != "bfloat16":
        p.error("--all-classes takes --dtype bfloat16")
    if args.dtype == "bfloat16" and (args.all_classes or not args.real or args.dgrad):
        return time_bf16(args)
    if args.dgrad:
        return sweep_dgrad(args)
    if args.real:
        return sweep_real(args)

    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda", 0)
    smi = card_line()
    print(f"card: {smi}")
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((7, 7, 4, 2), generator=g, device=dev) * 0.1
    zb = torch.zeros(2, device=dev)
    tot = dict(conv=0.0, conv_best=0.0, conv_generic=0.0, pool=0.0, gate=0.0,
               gate_best=0.0, bound=0.0)
    timed = {}
    for site in sites(config_for_variant("dcs"), args.batch, args.frames):
        if site not in timed:
            B, H, W, C = site
            re = torch.randn(site, generator=g, device=dev)
            im = torch.randn(site, generator=g, device=dev)
            pooled = cc.sa_pool(re, im)
            conv, gate = {}, {}
            sweep = [] if args.no_sweep else candidate_tiles(H)
            for t in sweep + [cc.choose_tile(B, H, W, 4, 2), cc.gate_tile(B, H, W, 4, 2)]:
                if t not in conv:
                    conv[t] = graph_ms(lambda: cc.launch_conv(pooled, w, zb, t),
                                       args.iters)
                    gate[t] = graph_ms(lambda: cc.sa_gate(pooled, w, re, im, t),
                                       args.iters)
            generic = graph_ms(
                lambda: cc.launch_conv(pooled, w, zb, cc.GENERIC_TILE), args.iters)
            pool = graph_ms(lambda: cc.sa_pool(re, im), args.iters)
            bound = 4 * (6 * re.numel() + 2 * pooled.numel()) / HBM_BYTES_PER_S * 1e3
            timed[site] = (conv, gate, generic, pool, bound)
        conv, gate, generic, pool, bound = timed[site]
        chosen, gchosen = cc.choose_tile(*site[:3], 4, 2), cc.gate_tile(*site[:3], 4, 2)
        cb, gb = min(conv, key=conv.get), min(gate, key=gate.get)
        print(f"site {site}: chosen {chosen} conv {conv[chosen]:.4f}, {gchosen} gate "
              f"{gate[gchosen]:.4f} | best conv {cb} {conv[cb]:.4f} | best gate "
              f"{gb} {gate[gb]:.4f} | generic conv {generic:.4f} | pool "
              f"{pool:.4f} | pool+gate bound {bound:.4f} ms")
        for name, d in (("conv", conv), ("gate", gate)) if not args.no_sweep else ():
            top = sorted(d, key=d.get)[:5]
            print(f"    {name} top 5: " + ", ".join(f"{t} {d[t]:.4f}" for t in top))
        for k, v in (("conv", conv[chosen]), ("conv_best", conv[cb]),
                     ("conv_generic", generic), ("pool", pool),
                     ("gate", gate[gchosen]), ("gate_best", gate[gb]),
                     ("bound", bound)):
            tot[k] += v
    print("summed over the 13 sites (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) + f" [{smi}]")


def sweep_real(args) -> None:
    """The real attention's 13 DRS sites: the conv entry at (7, 2, 1) (chosen
    tile, best of the sweep, generic body), the real pool and gate entries
    (chosen and best gate tile), the eager sequence the gate replaces, and
    the pool + gate bound; summed over the sites."""
    import torch
    import torch.nn.functional as F

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda", 0)
    smi = card_line()
    print(f"card: {smi} at {args.dtype}")
    dt = getattr(torch, args.dtype)
    f32 = dt == torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((7, 7, 2, 1), generator=g, device=dev) * 0.3).to(dt)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    zb = torch.zeros(1, device=dev)
    tot = dict(conv=0.0, conv_best=0.0, conv_generic=0.0, pool=0.0, gate=0.0,
               gate_best=0.0, eager=0.0, bound=0.0)
    timed = {}
    for site in sites(config_for_variant("drs"), args.batch, args.frames):
        if site not in timed:
            B, H, W, C = site
            x = torch.randn(site, generator=g, device=dev).to(dt)
            pooled = cc.sa_pool_real(x)

            def eager():
                cat = torch.cat([x.mean(dim=-1, keepdim=True),
                                 x.amax(dim=-1, keepdim=True)], dim=-1)
                a = torch.sigmoid(F.conv2d(cat.permute(0, 3, 1, 2), w_oihw, padding=3))
                return x * a.permute(0, 2, 3, 1)

            conv, gate = {}, {}
            sweep = [] if args.no_sweep else candidate_tiles(H, 2, 1)
            for t in sweep + [cc.choose_tile(B, H, W, 2, 1), cc.gate_tile(B, H, W, 2, 1)]:
                if t not in conv:
                    # at bf16 the conv entry runs its own body and tile
                    # (time_bf16 sweeps them): the routed call at each tile
                    conv[t] = graph_ms((lambda: cc.launch_conv(pooled, w, zb, t)) if f32
                                       else (lambda: cc._same_conv(pooled, w, zb)),
                                       args.iters)
                    gate[t] = graph_ms(lambda: cc.sa_gate_real(pooled, w, x, t),
                                       args.iters)
            generic = graph_ms(lambda: cc.launch_conv(pooled, w, zb, cc.GENERIC_TILE),
                               args.iters) if f32 else float("nan")
            pool = graph_ms(lambda: cc.sa_pool_real(x), args.iters)
            eager_ms = graph_ms(eager, args.iters)
            bound = (x.element_size() * (3 * x.numel() + 2 * pooled.numel())
                     / HBM_BYTES_PER_S * 1e3)
            timed[site] = (conv, gate, generic, pool, eager_ms, bound)
        conv, gate, generic, pool, eager_ms, bound = timed[site]
        chosen, gchosen = cc.choose_tile(*site[:3], 2, 1), cc.gate_tile(*site[:3], 2, 1)
        cb, gb = min(conv, key=conv.get), min(gate, key=gate.get)
        print(f"real site {site}: chosen {chosen} conv {conv[chosen]:.4f}, {gchosen} gate "
              f"{gate[gchosen]:.4f} | best conv {cb} {conv[cb]:.4f} | best gate "
              f"{gb} {gate[gb]:.4f} | generic conv {generic:.4f} | pool "
              f"{pool:.4f} | eager {eager_ms:.4f} | pool+gate bound {bound:.4f} ms")
        for name, d in (("conv", conv), ("gate", gate)) if not args.no_sweep else ():
            top = sorted(d, key=d.get)[:5]
            print(f"    {name} top 5: " + ", ".join(f"{t} {d[t]:.4f}" for t in top))
        for k, v in (("conv", conv[chosen]), ("conv_best", conv[cb]),
                     ("conv_generic", generic), ("pool", pool),
                     ("gate", gate[gchosen]), ("gate_best", gate[gb]),
                     ("eager", eager_ms), ("bound", bound)):
            tot[k] += v
    print(f"real: summed over the 13 sites at {args.dtype} (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) + f" [{smi}]")


BF16_CLASSES = {(False, False): (4, 2), (False, True): (2, 4), (True, False): (2, 1),
                (True, True): (1, 2)}
BF16_FLOPS_PER_S = 989e12


def mma_candidates(B: int, H: int, W: int, cin: int, cout: int):
    """The tensor-core body's tiles (TH, TW, RB) that fit a site: TH a power
    of two to 16, TW one to four product spans up to the width, every RB."""
    from dcs_net_tpu_torch.ops import cuda_conv as cc

    m = cc.mma_class(cin, cout)
    out = []
    for th in (1, 2, 4, 8, 16):
        for k in (1, 2, 4):
            tw = k * m.span
            for rb in (2, 4, 8):
                if (th <= max(1, 2 * H) and (k == 1 or tw <= 2 * W)
                        and cc.mma_fits(B, H, W, cin, cout, (th, tw, rb))):
                    out.append((th, tw, rb))
    return out


def _time_bf16_site(args, cc, graph_ms, B, H, W, cin, cout, w, wf, bias, dgrad, mma, g):
    """One site of :func:`time_bf16`: prints its line, returns its times."""
    import torch
    import torch.nn.functional as F

    dev, b16 = w.device, torch.bfloat16
    w_oihw = wf.permute(3, 2, 0, 1).contiguous()
    x = torch.randn((B, H, W, cin), generator=g, device=dev).to(b16)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    got = cc._same_conv(x, w, bias, dgrad)
    want = (cc.conv2d_same_small_cout_dgrad_bf16_plain(x, wf) if dgrad
            else cc.conv2d_same_small_cout_bf16_plain(x, w, bias))
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp_min(1e-30))
    ms = graph_ms(lambda: cc._same_conv(x, w, bias, dgrad), args.iters)
    if dgrad:
        lib = graph_ms(lambda: torch.nn.grad.conv2d_input(
            (B, cout, H, W), w_oihw, x_nchw, padding=3), args.iters)
    else:
        lib = graph_ms(lambda: F.conv2d(x_nchw, w_oihw, bias.to(b16), padding=3), args.iters)
    nbytes = 2 * (x.numel() + w.numel() + B * H * W * cout) + 4 * cout
    bound = max(nbytes / HBM_BYTES_PER_S,
                2 * B * H * W * 49 * cin * cout / BF16_FLOPS_PER_S) * 1e3
    tile = cc.mma_tile(B, H, W, cin, cout) if mma else cc.choose_tile(B, H, W, cin, cout)
    best, best_ms = tile, ms
    if mma and not args.no_sweep:
        t = {c: graph_ms(lambda: cc.launch_conv(x, w, bias, c, dgrad), args.iters)
             for c in mma_candidates(B, H, W, cin, cout)}
        best = min(t, key=t.get)
        best_ms = t[best]
        top = sorted(t, key=t.get)[:5]
        print("    top 5: " + ", ".join(f"{k} {t[k]:.4f}" for k in top), flush=True)
    print(f"bf16 (7, {cin}, {cout}) site ({B}, {H}, {W}): tile {tile} {ms:.4f} ms | best "
          f"{best} {best_ms:.4f} | bound {bound:.4f} | library {lib:.4f} | rel_err "
          f"{err:.3e}", flush=True)
    if not err <= 2.0 ** -7:
        raise SystemExit(f"({cin}, {cout}) at {(B, H, W)}: error {err:.3e} exceeds 2^-7 "
                         "of max |plain|")
    return {"ms": ms, "best": best_ms, "bound": bound, "library": lib}


def time_bf16(args) -> None:
    """The conv entry's bf16 classes at the sites of the train step (or of
    ``--frames``/``--batch``), as the package on the path routes them: a
    site's ms, tile, error against the plain version, bound and library
    call; the fastest tensor-core tile where the package has that body and
    the sweep is asked for; summed over the sites."""
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda", 0)
    smi = card_line()
    mma = hasattr(cc, "mma_tile")
    print(f"card: {smi}; package {cc.__file__}; tensor-core body: {mma}", flush=True)
    classes = (list(BF16_CLASSES.values()) if args.all_classes
               else [BF16_CLASSES[(args.real, args.dgrad)]])
    g = torch.Generator(device=dev).manual_seed(0)
    for cin, cout in classes:
        dgrad = (cin, cout) in ((2, 4), (1, 2))
        real = cin * cout == 2
        # the forward's kernel (7, 7, Cin_f, Cout_f); an input gradient's
        # entry takes its dgrad_kernel and a zero bias
        fin, fout = (cout, cin) if dgrad else (cin, cout)
        wf = (torch.randn((7, 7, fin, fout), generator=g, device=dev) * 0.2).to(torch.bfloat16)
        w = cc.dgrad_kernel(wf) if dgrad else wf
        bias = (torch.zeros(cout, device=dev) if dgrad
                else torch.randn(cout, generator=g, device=dev))
        tot = dict(ms=0.0, best=0.0, bound=0.0, library=0.0)
        timed = {}
        for B, H, W, _ in sites(config_for_variant("drs" if real else "dcs"), args.batch,
                                args.frames):
            if (B, H, W) not in timed:
                timed[(B, H, W)] = _time_bf16_site(args, cc, graph_ms, B, H, W, cin, cout,
                                                   w, wf, bias, dgrad, mma, g)
            for k, v in timed[(B, H, W)].items():
                tot[k] += v
        print(f"bf16 (7, {cin}, {cout}): summed over the 13 sites (ms): "
              + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) + f" [{smi}]", flush=True)


def sweep_dgrad(args) -> None:
    """The conv entry at the input gradient's class, (7, 2, 4) or with
    ``--real`` (7, 1, 2), in float32 at each site: the chosen tile, the best
    of the sweep, the generic body; summed over the sites (at bf16:
    :func:`time_bf16`)."""
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda", 0)
    smi = card_line()
    # the forward class (Cin, Cout); the input gradient's is (Cout, Cin)
    fin, fout = (2, 1) if args.real else (4, 2)
    g = torch.Generator(device=dev).manual_seed(0)
    wt = cc.dgrad_kernel(torch.randn((7, 7, fin, fout), generator=g, device=dev) * 0.1)
    zb = torch.zeros(fin, device=dev)
    tot = dict(chosen=0.0, best=0.0, generic=0.0)
    variant = "drs" if args.real else "dcs"
    for B, H, W, _ in sites(config_for_variant(variant), args.batch, args.frames):
        gy = torch.randn((B, H, W, fout), generator=g, device=dev)
        chosen = cc.choose_tile(B, H, W, fout, fin)
        tiles = [] if args.no_sweep else candidate_tiles(H, fout, fin)
        t = {tile: graph_ms(lambda: cc.launch_conv(gy, wt, zb, tile), args.iters)
             for tile in tiles + [chosen]}
        generic = graph_ms(lambda: cc.launch_conv(gy, wt, zb, cc.GENERIC_TILE), args.iters)
        best = min(t, key=t.get)
        print(f"dgrad ({fout}, {fin}) site ({B}, {H}, {W}): chosen {chosen} "
              f"{t[chosen]:.4f} | best {best} {t[best]:.4f} | generic {generic:.4f} ms")
        if not args.no_sweep:
            top = sorted(t, key=t.get)[:5]
            print("    top 5: " + ", ".join(f"{k} {t[k]:.4f}" for k in top))
        for k, v in (("chosen", t[chosen]), ("best", t[best]), ("generic", generic)):
            tot[k] += v
    print(f"dgrad ({fout}, {fin}): summed over the 13 sites (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) + f" [{smi}]")


if __name__ == "__main__":
    main()
