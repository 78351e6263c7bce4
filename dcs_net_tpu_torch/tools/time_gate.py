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
32`` gives the 13 launches of a train step. ``--dtype bfloat16`` (with
``--real`` or ``--dgrad``) times the bf16 classes instead on bf16 tensors:
the conv entry's, the real pool's and gate's, beside the bf16 eager
sequence; the generic body, which has no bf16 class, is then left out.
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
                   help="bfloat16: the bf16 classes (with --real or --dgrad)")
    args = p.parse_args(argv)
    if args.dtype == "bfloat16" and not (args.real or args.dgrad):
        p.error("--dtype bfloat16 takes --real or --dgrad: the complex gate at bf16 is "
                "the fused entry, which chip_smoke.py's phase \"bf16\" sweeps")
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
                    conv[t] = graph_ms(lambda: cc.launch_conv(pooled, w, zb, t),
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


def sweep_dgrad(args) -> None:
    """The conv entry at the input gradient's class, (7, 2, 4) or with
    ``--real`` (7, 1, 2), at each site: the chosen tile, the best of the
    sweep, the generic body; summed over the sites."""
    import torch

    from dcs_net_tpu_torch.core.config import config_for_variant
    from dcs_net_tpu_torch.ops import cuda_conv as cc
    from dcs_net_tpu_torch.utils.timing import graph_ms

    dev = torch.device("cuda", 0)
    smi = card_line()
    # the forward class (Cin, Cout); the input gradient's is (Cout, Cin)
    fin, fout = (2, 1) if args.real else (4, 2)
    dt = getattr(torch, args.dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    wt = cc.dgrad_kernel(torch.randn((7, 7, fin, fout), generator=g, device=dev) * 0.1
                         ).to(dt)
    zb = torch.zeros(fin, device=dev)
    tot = dict(chosen=0.0, best=0.0, generic=0.0)
    variant = "drs" if args.real else "dcs"
    for B, H, W, _ in sites(config_for_variant(variant), args.batch, args.frames):
        gy = torch.randn((B, H, W, fout), generator=g, device=dev).to(dt)
        chosen = cc.choose_tile(B, H, W, fout, fin)
        tiles = [] if args.no_sweep else candidate_tiles(H, fout, fin)
        t = {tile: graph_ms(lambda: cc.launch_conv(gy, wt, zb, tile), args.iters)
             for tile in tiles + [chosen]}
        generic = (graph_ms(lambda: cc.launch_conv(gy, wt, zb, cc.GENERIC_TILE), args.iters)
                   if dt == torch.float32 else float("nan"))
        best = min(t, key=t.get)
        print(f"dgrad ({fout}, {fin}) site ({B}, {H}, {W}): chosen {chosen} "
              f"{t[chosen]:.4f} | best {best} {t[best]:.4f} | generic {generic:.4f} ms")
        if not args.no_sweep:
            top = sorted(t, key=t.get)[:5]
            print("    top 5: " + ", ".join(f"{k} {t[k]:.4f}" for k in top))
        for k, v in (("chosen", t[chosen]), ("best", t[best]), ("generic", generic)):
            tot[k] += v
    print(f"dgrad ({fout}, {fin}) at {args.dtype}: summed over the 13 sites (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()) + f" [{smi}]")


if __name__ == "__main__":
    main()
