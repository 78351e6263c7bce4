"""bf16 operands with float32 sums: the JAX package's ``compute_dtype`` and
``dft_dtype`` "bfloat16" (its ``--dtype bfloat16``).

Under it every conv and matmul of the complex net takes bf16 operands and
sums their products in float32; the parameters stay float32 and are rounded
where they are used. On the card a bf16 product is one cuBLAS or cuDNN call
in bf16 (the entry points set
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction =
False``, whose default lets cuBLAS reduce below float32). On the CPU a bf16
GEMM leaves its accumulation unspecified, so the product runs in float32 on
the bf16 values and is rounded once: the same function up to the order of
the sum, since the product of two bf16 values is exact in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

BF16 = torch.bfloat16


def operand_dtype(compute_dtype: str) -> Optional[torch.dtype]:
    """The operand type the layers cast to: None for "float32" (operands as
    they come: float32, or float64 in a CPU witness run), bf16 for
    "bfloat16"."""
    if compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(f"compute_dtype={compute_dtype!r}: the port takes "
                                  "float32 and bfloat16")
    return BF16 if compute_dtype == "bfloat16" else None


def cast(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` in the operand type ``dtype``, or as it is where that is None."""
    return t if dtype is None else t.to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16 operands as bf16, from float32 sums (see above)."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(BF16)
    return torch.matmul(a, b)
