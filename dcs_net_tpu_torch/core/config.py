"""Typed configuration: a serializable tree of frozen dataclasses.

This is the port's own copy of the JAX package's ``core/config.py`` (same
fields, defaults and JSON layout, so a ``config.json`` written by either
package loads in the other). The model variant is two orthogonal axes:

    variant     complex_valued   subtractive
    dr          False            False
    dc          True             False
    drs         False            True
    dcs         True             True

:class:`Quirks` flags behaviours of the original DCS-Net code that differ from
the obvious intent; all True (except ``nan_gate_loss_only``) reproduces it.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

VARIANTS = ("dr", "dc", "drs", "dcs")


def _axes_for_variant(variant: str) -> Tuple[bool, bool]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    return ("c" in variant[1:], variant.endswith("s"))


@dataclass(frozen=True)
class STFTConfig:
    """torch.stft semantics: 512-point FFT, hop 32, Hann window, normalized,
    center (reflect) padding, DC bin dropped -> 256 frequency bins."""

    n_fft: int = 512
    hop: int = 32
    win_length: int = 512
    window: str = "hann"
    normalized: bool = True
    center: bool = True
    pad_mode: str = "reflect"
    drop_dc: bool = True
    # operand dtype of the DFT/iDFT basis products (float32 accumulation
    # either way): "float32" or "bfloat16" (every CLI takes --dtype, for
    # every variant)
    dft_dtype: str = "float32"

    @property
    def n_bins(self) -> int:
        """Frequency bins after the optional DC drop."""
        full = self.n_fft // 2 + 1
        return full - 1 if self.drop_dc else full

    def num_frames(self, n_samples: int) -> int:
        if not self.center:
            return 1 + (n_samples - self.n_fft) // self.hop
        return 1 + n_samples // self.hop


@dataclass(frozen=True)
class Quirks:
    """Behaviour flags of the original code (all True == exact parity).

    istft_pad_top_bin: resynthesis appends one zero bin on top of the 256
        network bins instead of re-inserting the dropped DC bin at the bottom.
    double_bound_mask: the complex network output is tanh-mag bounded inside
        the model forward AND again before the mask is applied.
    real_ca_max_only: real channel attention keeps only its max branch.
    complex_maxpool_is_avg: the complex "adaptive max pool" is an average.
    loss_one_minus_alpha: noise loss combined as ``1 - alpha * L``.
    polar_resynthesis: every audio stream is resynthesized through a
        mag/atan2(+eps) polar decomposition.
    nan_gate_loss_only: the NaN-skip inspects only the loss (default False
        also gates on gradient finiteness).
    """

    istft_pad_top_bin: bool = True
    double_bound_mask: bool = True
    real_ca_max_only: bool = True
    complex_maxpool_is_avg: bool = True
    loss_one_minus_alpha: bool = True
    polar_resynthesis: bool = True
    nan_gate_loss_only: bool = False

    @classmethod
    def idiomatic(cls) -> "Quirks":
        return cls(
            istft_pad_top_bin=False,
            double_bound_mask=False,
            real_ca_max_only=False,
            complex_maxpool_is_avg=False,
            loss_one_minus_alpha=False,
            polar_resynthesis=False,
            nan_gate_loss_only=False,
        )

    def perf(self) -> "Quirks":
        """This quirk set with polar_resynthesis off (identical up to O(eps))."""
        return dataclasses.replace(self, polar_resynthesis=False)


@dataclass(frozen=True)
class ModelConfig:
    """U-Net topology. ``channels`` are the real-network counts; the complex
    network halves every entry (each complex channel is a (re, im) pair)."""

    complex_valued: bool = True
    subtractive: bool = True
    n_layers: int = 7
    channels: Tuple[int, ...] = (1, 16, 32, 64, 128, 256, 256, 256)
    kernel_e: Tuple[int, ...] = (7, 7, 5, 5, 3, 3, 3)
    kernel_d: Tuple[int, ...] = (3, 3, 3, 3, 3, 3, 3)
    stride_e: Tuple[Tuple[int, int], ...] = (
        (2, 2), (2, 2), (2, 2), (2, 1), (2, 1), (2, 1), (2, 1))
    upsample: Tuple[Tuple[int, int], ...] = (
        (2, 1), (2, 1), (2, 1), (2, 1), (2, 2), (2, 2), (2, 2))
    lstm_layers: int = 2
    lstm_bidir: bool = True
    # streaming mode: flatten the latent time-major so LSTM state carried
    # across chunks equals one continuous pass (parity requires False)
    lstm_time_major: bool = False
    dropout: bool = True
    dropout_conv: float = 0.1
    dropout_fc: float = 0.2
    attention: bool = True
    ca_reduction: int = 16
    sa_kernel: int = 7
    atan2_eps: float = 1e-6
    init: str = "xavier_uniform"
    # conv/matmul operand dtype, "float32" or "bfloat16" (bf16 operands,
    # float32 sums, bf16 activations: every variant);
    # the parameters are float32 whatever it is
    compute_dtype: str = "float32"
    param_dtype: str = "float32"

    @property
    def variant(self) -> str:
        return ("dc" if self.complex_valued else "dr") + ("s" if self.subtractive else "")

    def enc_channels(self, i: int) -> Tuple[int, int]:
        """(in, out) channel counts for encoder layer i, halved when complex."""
        cin = 1 if i == 0 else self._ch(self.channels[i])
        return cin, self._ch(self.channels[i + 1])

    def dec_channels(self, i: int) -> Tuple[int, int]:
        """(in-with-skip, out) channel counts for decoder stage i."""
        cin = self._ch(self.channels[self.n_layers - i])
        cout = max(self._ch(self.channels[self.n_layers - 1 - i]), 1)
        return 2 * cin, cout

    def _ch(self, c: int) -> int:
        return max(c // 2, 1) if self.complex_valued else c

    @property
    def latent_channels(self) -> int:
        return self._ch(self.channels[self.n_layers])

    @property
    def lstm_hidden(self) -> int:
        return self._ch(self.channels[4])

    @property
    def fc_features(self) -> int:
        return self._ch(self.channels[5])


@dataclass(frozen=True)
class LossConfig:
    noise_loss_type: int = 6
    speech_loss_type: int = 0
    speech_alpha: float = 0.7
    sisnr_eps: float = 1e-8
    wsdr_eps: float = 2e-8
    crm_eps: float = 1e-8


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-6
    weight_decay: float = 1e-4
    amsgrad: bool = True
    clip_norm: float = 100.0
    plateau_patience: int = 10
    plateau_factor: float = 0.1
    plateau_threshold: float = 1e-4
    plateau_min_lr: float = 0.0
    swa: bool = True
    swa_start_frac: float = 0.8
    nan_skip: bool = True


@dataclass(frozen=True)
class DataConfig:
    root: str = ""
    dataset_type: int = 28
    sr: int = 16000
    file_sr: int = 48000
    train_val_split: float = 0.8
    batch_size: int = 32
    crop_samples: int = 8160
    normalize_audio: bool = True
    load_into_ram: bool = False
    partition_json: str = "data_json/partition.json"
    prefetch: int = 2
    num_workers: int = 2


@dataclass(frozen=True)
class RunConfig:
    seed: int = 0
    max_epochs: int = 200
    log_every_n_steps: int = 25
    val_log_sample_size: int = 1
    num_sanity_val_steps: int = 1
    detect_anomaly: bool = True
    ckpt_dir: str = "checkpoints"
    log_dir: str = "logs"
    data_axis: str = "data"
    donate_state: bool = True
    steps_per_dispatch: int = 1
    per_utterance_eval_metrics: bool = False


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    stft: STFTConfig = field(default_factory=STFTConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    run: RunConfig = field(default_factory=RunConfig)
    quirks: Quirks = field(default_factory=Quirks)

    @property
    def variant(self) -> str:
        return self.model.variant

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), indent=2, **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def _tupled(x: Any) -> Any:
            if isinstance(x, list):
                return tuple(_tupled(v) for v in x)
            return x

        kwargs = {}
        for f in dataclasses.fields(cls):
            sub = d.get(f.name)
            if sub is None:
                continue
            sub_cls = f.default_factory  # type: ignore[misc]
            kwargs[f.name] = sub_cls(**{k: _tupled(v) for k, v in sub.items()})
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def config_for_variant(variant: str, *, faithful: bool = True,
                       streaming: bool = False, **overrides: Any) -> Config:
    """Default config for one of {dr, dc, drs, dcs}.

    ``streaming=True`` applies the long-utterance streaming preset:
    unidirectional LSTM + time-major latent flatten.
    """
    complex_valued, subtractive = _axes_for_variant(variant)
    model = ModelConfig(complex_valued=complex_valued, subtractive=subtractive)
    if streaming:
        model = dataclasses.replace(
            model, lstm_bidir=False, lstm_time_major=True)
    cfg = Config(
        model=model,
        quirks=Quirks() if faithful else Quirks.idiomatic(),
    )
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
