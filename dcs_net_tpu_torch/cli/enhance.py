"""Enhance a wav file on the GPU:
``python -m dcs_net_tpu_torch.cli.enhance {dr,dc,drs,dcs} --in noisy.wav
--out clean.wav [--ckpt-dir DIR] [--stream | --carry]``.

The flags are the JAX CLI's plus ``--device`` (default cuda; ``cpu`` runs the
kernels' plain versions). ``--ckpt-dir`` serves a checkpoint that
``cli/train.py`` wrote: the latest ``step_<N>.pt`` there, loaded straight
onto the device, with the ``config.json`` saved beside it in place of the
variant's (and of ``--config-json``). Without it the model has freshly
initialised weights (seed 0), with a warning. ``--stream`` cuts the
utterance into fixed-size chunks whose masks are crossfaded; ``--carry`` also
threads the LSTM state across the chunks (streaming config preset, no
overlap; a checkpoint must have been trained with it). On the card the
fixed-shape parts run through a ``models/graphed.py`` ``GraphCache``: a
stream's groups (or carried chunks) from the third on replay one CUDA graph.
``--dtype bfloat16`` serves the (float32) weights with bf16 operands and
float32 sums, as the JAX package's ``--dtype`` runs them (every variant; it
overrides the operand type of ``--config-json`` and of a checkpoint's
config).
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
                   help="fixed-shape chunked streaming")
    p.add_argument("--carry", action="store_true",
                   help="thread LSTM (h, c) across chunks (implies --stream; "
                        "uses the streaming config preset: unidirectional "
                        "LSTM + time-major latent; exact chunked == full "
                        "when --overlap 0)")
    p.add_argument("--chunk-frames", type=int, default=256)
    p.add_argument("--chunk-batch", type=int, default=8,
                   help="without --carry, independent chunks run batched in "
                        "groups of this size")
    p.add_argument("--overlap", type=int, default=None,
                   help="chunk overlap frames (default 64, clamped to a "
                        "quarter of the chunk; 0 with --carry)")
    p.add_argument("--idiomatic", action="store_true")
    p.add_argument("--config-json", default=None,
                   help="load a serialized Config (overrides variant flags)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="matmul/conv operand dtype (bfloat16: bf16 operands, "
                        "float32 accumulation)")
    args = p.parse_args(argv)
    if args.carry:
        args.stream = True
    if args.carry and args.overlap:
        # the state carried out of chunk c has already consumed the overlap
        # frames that chunk c + 1 reads again
        p.error("--carry requires --overlap 0: the carried LSTM state is "
                "time-aligned only with non-overlapping chunk tiling "
                "(where chunked == full exactly). Drop --overlap, or drop "
                "--carry to stream with mask crossfade only.")
    if args.overlap is None:
        args.overlap = 0 if args.carry else min(64, args.chunk_frames // 4)
    if not 0 <= args.overlap < args.chunk_frames:
        p.error(f"--overlap must be in [0, chunk_frames): got "
                f"{args.overlap} with --chunk-frames {args.chunk_frames}")

    import os

    import torch

    from dcs_net_tpu_torch.cli.common import with_dtype
    from dcs_net_tpu_torch.core.config import Config, config_for_variant
    from dcs_net_tpu_torch.data.audio_io import read_wav, resample, write_wav
    from dcs_net_tpu_torch.models.enhance import enhance_full, enhance_streaming
    from dcs_net_tpu_torch.models.graphed import GraphCache
    from dcs_net_tpu_torch.models.unet import DCSNet
    from dcs_net_tpu_torch.train.checkpoint import checkpoint_steps, load_model
    from dcs_net_tpu_torch.utils.device import resolve_device

    if args.ckpt_dir and not checkpoint_steps(args.ckpt_dir):
        p.error(f"--ckpt-dir {args.ckpt_dir}: no checkpoint (step_<N>.pt) there")
    cfg = config_for_variant(args.variant, faithful=not args.idiomatic,
                             streaming=args.carry)
    if args.config_json:
        with open(args.config_json) as f:
            cfg = Config.from_json(f.read())
    if args.ckpt_dir:
        cfg_path = os.path.join(args.ckpt_dir, "config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = Config.from_json(f.read())
            print(f"using config saved with checkpoint ({cfg.variant})")
    if args.dtype:
        cfg = with_dtype(cfg, args.dtype)
    if args.carry and cfg.model.lstm_bidir:
        p.error("--carry needs a model trained with the streaming preset "
                "(lstm_bidir=False, lstm_time_major=True): a bidirectional "
                "LSTM cannot carry state across chunks. Train one with "
                f"`python -m dcs_net_tpu_torch.cli.train {args.variant} "
                "--streaming`, or drop --carry to stream with mask crossfade "
                "only.")
    device = resolve_device(args.device)
    # the float32 model runs in full float32, as the JAX reference does:
    # cuDNN would otherwise run the encoder convs and the LSTM in TF32; at
    # bf16 cuBLAS sums bf16 products in float32 (its default may reduce lower)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    wave, sr = read_wav(args.infile)
    if sr != cfg.data.sr:
        wave = resample(wave, sr, cfg.data.sr)
    model = DCSNet(cfg.model, cfg.quirks, device=device, seed=0)
    if args.ckpt_dir:
        step = load_model(args.ckpt_dir, model)
        print(f"restored checkpoint step {step} from {args.ckpt_dir} onto {device}")
    else:
        print("WARNING: no --ckpt-dir; enhancing with untrained weights")
    x = torch.from_numpy(np.ascontiguousarray(wave, np.float32))[None, :]
    # on the card the fixed-shape parts run as CUDA graphs: a single call's
    # first use of a shape is eager, so this costs it nothing
    graphs = GraphCache()
    if args.stream:
        out = enhance_streaming(model, x, cfg, chunk_frames=args.chunk_frames,
                                overlap=args.overlap,
                                carry_lstm_state=args.carry,
                                chunk_batch=args.chunk_batch, graphs=graphs)
    else:
        out = enhance_full(model, x, cfg, graphs=graphs)
    out = out[0].cpu().numpy()
    write_wav(args.outfile, out, cfg.data.sr)
    print(f"wrote {args.outfile}: {out.shape[0] / cfg.data.sr:.2f}s @ "
          f"{cfg.data.sr} Hz ({'stream' if args.stream else 'full'}, {device})")


if __name__ == "__main__":
    main()
