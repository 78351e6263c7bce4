"""Kernel 3's bf16 input gradient at the decoder stages of a bf16 train
step, on the card, with whichever ``dcs_net_tpu_torch`` is first on the
path, so two trees compare in one process each:

    PYTHONPATH=<tree> python3 dcs_net_tpu_torch/tools/time_dgrad_bf16.py \\
        [--variants dcs,drs] [--batch 32] [--frames 256] [--repeats 3]

(from the repository root; ``PYTHONPATH=.`` for this tree, or the root of
an unpacked ``git archive`` of another commit). The first line is the
card's name and power limit; then one JSON line a variant and stage
(dec0-dec6; a batch of 32 x 8160 samples is 256 frames): the body the
input gradient takes and its plan, its device time a call as the train
step launches it (in a tree whose forward keeps its packing of w,
``cuda_tapconv.pack_bf16``, on that packing, made beforehand as the
forward makes it; in an older tree with the flipped packing it launches),
that packing alone where the tree launches one, the forward's bf16 body
alone at the same stage (its weights packed beforehand), one bf16
``torch.nn.grad.conv2d_input`` (used nowhere in the port), the bound (g, w
and dx moved once at 3.35 TB/s against the products at 989 TFLOP/s), and
the error against the plain version relative to its largest value;
``--sweep`` adds a line a (flat, wgs) of each flat staged stage (flat 2:
planes). Times:
``graph_ms`` (a CUDA graph of 20 calls, one replay timed with CUDA events,
warm L2), ``--repeats`` times. Inputs: ``torch.randn`` on the card, seeded.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.ops import cuda_tapconv as ct
from dcs_net_tpu_torch.tools.time_gate import sites
from dcs_net_tpu_torch.utils.cuda_lib import ptr
from dcs_net_tpu_torch.utils.timing import graph_ms

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def stages(variant: str, batch: int, frames: int):
    """(stage, B, H, W, Cin, N) of the decoder's tap convs in the port's
    tensors (a complex channel is two real ones), each padded (1, 1, 1, 1)."""
    m = config_for_variant(variant).model
    mult = 2 if m.complex_valued else 1
    skip = sites(config_for_variant(variant), batch, frames)[0]
    h, w = skip[1], skip[2]
    out = []
    for i in range(m.n_layers):
        cin, cout = m.dec_channels(i)
        s_h, s_w = m.upsample[i]
        out.append((i, batch, h, w, mult * cin, mult * s_h * s_w * cout))
        h, w = h * s_h, w * s_w
    return out


def forward_body(x, w, pad, dev):
    """The forward's bf16 body at x and w, its weights packed beforehand: a
    call that launches the body alone."""
    B, H, W, cin = x.shape
    n = w.shape[2]
    body = ct.bf16_body(B, H, W, cin, n, 3, 3, pad)
    bn, flat, wgs, split = ct.forward_plan(B, H, W, cin, n, 3, 3, pad, dev, bf16=True,
                                           body=body)
    kb = ct.STAGED_KB if body == "staged" else ct.BK
    packed = torch.empty((-(-n // bn), -(-cin // kb), 9, kb // 8, bn, 8), device=dev,
                         dtype=torch.bfloat16)
    ct.PACK_BF16(dev, ptr(w), ptr(packed), 9, cin, n, bn, kb)
    y = torch.empty((B, H, W, n), device=dev, dtype=torch.bfloat16)
    kernel = ct.KERNEL_BF16 if body == "staged" else ct.KERNEL_BF16_TAP
    return body, kb, bn, lambda: kernel(dev, ptr(x), ptr(packed), ptr(y), B, H, W, cin, H,
                                        W, n, 3, 3, pad[0], pad[2], flat, wgs, bn, split)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="dcs,drs")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the staged body's input gradient at every (flat, wgs) "
                         "of a flat stage, one line a plan (this tree only)")
    args = ap.parse_args(argv)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b16 = torch.bfloat16
    keeps_packing = hasattr(ct, "pack_bf16")
    pad = (1, 1, 1, 1)
    gpad = ct.dgrad_pad_bf16(pad, 3, 3)
    for variant in args.variants.split(","):
        for i, B, H, W, cin, n in stages(variant, args.batch, args.frames):
            x = torch.randn((B, H, W, cin), generator=gen, device=dev).to(b16)
            w = (torch.randn((9, cin, n), generator=gen, device=dev)
                 / math.sqrt(9 * cin)).to(b16)
            g = torch.randn((B, H, W, n), generator=gen, device=dev).to(b16)
            fbody, fkb, fbn, fwd = forward_body(x, w, pad, dev)
            pack = None
            if keeps_packing:
                body = ct.dgrad_body_bf16(B, H, W, n, cin, 3, 3, gpad)
                packing = ct.pack_bf16(w, fbn, fkb)

                def dgrad():
                    return ct._launch_dgrad(g, w, 3, 3, pad, (H, W), packing)
            else:
                body = ct.bf16_body(B, H, W, n, cin, 3, 3, gpad)

                def dgrad():
                    return ct._launch_dgrad(g, w, 3, 3, pad, (H, W))
            # this tree's input gradient takes its flat tiles in planes
            planes = {"planes": True} if keeps_packing else {}
            plan = (None if body == "narrow" else
                    ct.forward_plan(B, H, W, n, cin, 3, 3, gpad, dev, bf16=True, body=body,
                                    **planes))
            if plan is not None and (body == "tap" or not keeps_packing):
                kb = ct.STAGED_KB if body == "staged" else ct.BK
                bn = plan[0]
                packed = torch.empty((-(-cin // bn), -(-n // kb), 9, kb // 8, bn, 8),
                                     device=dev, dtype=b16)

                def pack():
                    ct.DGRAD_PACK_BF16(dev, ptr(w), ptr(packed), 9, cin, n, bn, kb)
            g_nchw = g.permute(0, 3, 1, 2).contiguous()
            w_oihw = w.reshape(3, 3, cin, n).permute(3, 2, 0, 1).contiguous()

            def library():
                return torch.nn.grad.conv2d_input((B, cin, H, W), w_oihw, g_nchw, padding=1)
            got = dgrad()
            want = ct.tapconv_dgrad_bf16_plain(g, w, 3, 3, pad, (H, W))
            err = float((got.float() - want.float()).abs().max()) / float(
                want.float().abs().max())
            nbytes = 2 * (g.numel() + w.numel() + B * H * W * cin)
            flops = 2 * B * H * W * 9 * cin * n
            row = {"package": ct.__file__, "variant": variant, "stage": f"dec{i}",
                   "g": [B, H, W, n], "dx_channels": cin, "body": body, "plan": plan,
                   "forward_body": fbody,
                   "ms": [graph_ms(dgrad, 20) for _ in range(args.repeats)],
                   "pack_ms": (None if pack is None else
                               [graph_ms(pack, 20) for _ in range(args.repeats)]),
                   "forward_ms": [graph_ms(fwd, 20) for _ in range(args.repeats)],
                   "library_ms": [graph_ms(library, 20) for _ in range(args.repeats)],
                   "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3,
                   "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                >= flops / BF16_FLOPS_PER_S else "operations"),
                   "rel_err": err}
            print(json.dumps(row), flush=True)
            if args.sweep and keeps_packing and body == "staged" and plan[1]:
                dx = torch.empty((B, H, W, cin), device=dev, dtype=b16)
                packed_f = packing[0]
                for flat in (1, 2):
                    for wgs in (1, 2):
                        forced = (plan[0], flat, wgs, 1)

                        def kern():
                            ct.DGRAD_BF16(dev, ptr(g), ptr(packed_f), ptr(dx), B, H, W, n, H,
                                          W, cin, 3, 3, gpad[0], gpad[2], flat, wgs, plan[0], 1,
                                          fbn, fkb)
                        kern()
                        e = float((dx.float() - want.float()).abs().max()) / float(
                            want.float().abs().max())
                        print(json.dumps({"variant": variant, "stage": f"dec{i}", "sweep": forced,
                                          "ms": [graph_ms(kern, 20) for _ in range(args.repeats)],
                                          "rel_err": e}), flush=True)


if __name__ == "__main__":
    main()
