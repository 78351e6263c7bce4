"""dcs_net_tpu_torch: the DCS-Net speech-enhancement family in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The JAX package ``dcs_net_tpu`` is the reference this port is held against;
nothing here imports it or JAX. Entry points run on CUDA unless the caller
passes ``device="cpu"``, which runs each kernel's plain PyTorch version.
"""

from dcs_net_tpu_torch.core.config import (  # noqa: F401
    Config, ModelConfig, Quirks, STFTConfig, config_for_variant)

__version__ = "0.1.0"
