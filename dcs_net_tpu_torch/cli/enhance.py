"""Enhance a wav file on the GPU:
``python -m dcs_net_tpu_torch.cli.enhance dcs --in noisy.wav --out clean.wav``.

The flags are the JAX CLI's plus ``--device`` (default cuda; ``cpu`` runs the
kernels' plain versions). Streaming (``--stream``, ``--carry``) and
checkpoints (``--ckpt-dir``) are not yet ported and exit with an error that
names their ROADMAP item. Without ``--ckpt-dir`` the model has freshly
initialised weights (seed 0).
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("variant", choices=("dr", "dc", "drs", "dcs"))
    p.add_argument("--in", dest="infile", required=True)
    p.add_argument("--out", dest="outfile", required=True)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--stream", action="store_true",
                   help="fixed-shape chunked streaming (not yet ported)")
    p.add_argument("--carry", action="store_true",
                   help="thread LSTM (h, c) across chunks (not yet ported)")
    p.add_argument("--chunk-frames", type=int, default=256)
    p.add_argument("--chunk-batch", type=int, default=8)
    p.add_argument("--overlap", type=int, default=None)
    p.add_argument("--idiomatic", action="store_true")
    p.add_argument("--config-json", default=None,
                   help="load a serialized Config (overrides variant flags)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.stream or args.carry:
        p.error("--stream/--carry: streaming enhancement is not yet ported to "
                "dcs_net_tpu_torch (ROADMAP Queue 1 item 2); drop the flag for "
                "full-utterance enhancement")
    if args.ckpt_dir:
        p.error("--ckpt-dir: checkpoints are not yet ported to "
                "dcs_net_tpu_torch (ROADMAP Queue 1 item 5)")

    import torch

    from dcs_net_tpu_torch.core.config import Config, config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, resample, write_wav
    from dcs_net_tpu_torch.models.enhance import enhance_full
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.utils.device import resolve_device

    cfg = config_for_variant(args.variant, faithful=not args.idiomatic)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = Config.from_json(f.read())
    device = resolve_device(args.device)
    # the float32 model runs in full float32, as the JAX reference does:
    # cuDNN would otherwise run the encoder convs and the LSTM in TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wave, sr = read_wav(args.infile)
    if sr != cfg.data.sr:
        wave = resample(wave, sr, cfg.data.sr)
    print("WARNING: no --ckpt-dir; enhancing with untrained weights")
    model = DCSNet(cfg.model, cfg.quirks, device=device, seed=0)
    x = torch.from_numpy(np.ascontiguousarray(wave, np.float32))[None, :]
    out = enhance_full(model, x, cfg)[0].cpu().numpy()
    write_wav(args.outfile, out, cfg.data.sr)
    print(f"wrote {args.outfile}: {out.shape[0] / cfg.data.sr:.2f}s @ "
          f"{cfg.data.sr} Hz (full, {device})")


if __name__ == "__main__":
    main()
