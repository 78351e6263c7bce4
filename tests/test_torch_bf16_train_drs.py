"""DRS's train step at ``compute_dtype = dft_dtype = "bfloat16"`` against the
JAX package's, in the bands of ``test_torch_bf16_train.py`` (whose tests
these are, on DRS's steps: the real family's bf16 layers, the LSTM's bf16
recurrence, the un-fused real gate on the conv entry's bf16 class at (7, 2,
1) and its input gradient at (7, 1, 2), and the gated FC dropout's net): the
loss and the whole gradient within twice JAX's own bf16 -> float32
distance, every leaf above 1e-5 of the largest gradient within four times
its own. A file of its own so that each file's one JAX compile (float32 and
bf16 steps together) keeps it under a minute."""

import pytest

from test_torch_bf16_train import (_steps,  # noqa: F401
                                   test_bf16_train_step_every_gradient_leaf_in_band_of_jax,
                                   test_bf16_train_step_loss_and_gradient_in_band_of_jax)
from test_torch_train import _one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def bf16_step():
    return _steps("drs")
