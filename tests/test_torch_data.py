"""The port's data-side pieces against the JAX package's: ``resample_torch``
(the ``resample_jax`` counterpart), ``VoiceBankDataset.full_utterance``, and
the tripwires of ``train/debug.py``.

Tolerances: ``resample_torch`` and ``resample_jax`` are float32 convolutions
summed in different orders, within 1e-5 of signals of magnitude below 1; the
host ``resample`` likewise. The dataset's numpy path reads the same files
with the same code in both packages: equal bit for bit.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dcs_net_tpu.core.config import DataConfig as JDataConfig
from dcs_net_tpu.data import audio_io as jaudio_io
from dcs_net_tpu.data import dataset as jdataset

from dcs_net_tpu_torch.core.config import DataConfig
from dcs_net_tpu_torch.data import dataset, partition, synthetic
from dcs_net_tpu_torch.data.audio_io import resample, resample_torch
from dcs_net_tpu_torch.train import debug

from test_torch_train import _one_torch_thread  # noqa: F401


def _signal(shape, seed):
    rng = np.random.default_rng(seed)
    return (0.5 * np.tanh(rng.standard_normal(shape))).astype(np.float32)


def test_resample_torch_matches_resample_jax():
    """One JAX call (48 -> 16 kHz, the pipeline's ratio) on a batch of two
    waves of a length that is no multiple of 3."""
    x = _signal((2, 4801), 0)
    got = resample_torch(torch.from_numpy(x), 48000, 16000)
    want = np.asarray(jaudio_io.resample_jax(x, 48000, 16000))
    assert got.shape == want.shape == (2, 1601) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,orig,new", [((4801,), 48000, 16000),
                                            ((2, 3, 1000), 48000, 16000),
                                            ((2, 999), 16000, 48000),
                                            ((3, 700), 44100, 16000),
                                            ((5,), 48000, 16000)])
def test_resample_torch_matches_the_host_resample(shape, orig, new):
    """Leading dimensions kept; several phases (16 -> 48 kHz, 44.1 -> 16 kHz);
    a wave shorter than the kernel."""
    x = _signal(shape, 1)
    got = resample_torch(torch.from_numpy(x), orig, new)
    want = resample(x, orig, new)
    assert got.shape == want.shape == shape[:-1] + (-(-shape[-1] * new // orig),)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    same = torch.from_numpy(x)
    assert resample_torch(same, 16000, 16000) is same


def test_full_utterance_is_the_jax_datasets(tmp_path):
    root = str(tmp_path)
    synthetic.generate(root, n_train=3, n_test=1, seconds=0.3)
    ids = partition.make_partition(DataConfig(root=root))["train"]
    tds = dataset.VoiceBankDataset(ids, DataConfig(root=root), "train")
    jds = jdataset.VoiceBankDataset(ids, JDataConfig(root=root), "train")
    for i in range(len(ids)):
        got, want = tds.full_utterance(i), jds.full_utterance(i)
        assert got["id"] == want["id"] == ids[i] and got["start"] == want["start"] == 0
        assert got["clean"].shape == (4800,)
        np.testing.assert_array_equal(got["clean"], want["clean"])
        np.testing.assert_array_equal(got["noisy"], want["noisy"])


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_sanitize_batch_names_the_non_finite_leaf(bad, as_tensor):
    wrap = torch.tensor if as_tensor else np.asarray
    leaf = np.zeros((2, 3), np.float32)
    leaf[1, 2] = bad
    batch = {"clean": wrap(np.zeros((2, 3), np.float32)), "id": ["a", "b"],
             "start": np.asarray([0, 4]),
             "extra": [wrap(np.ones(2, np.float32)), {"noisy": wrap(leaf)}]}
    with pytest.raises(FloatingPointError, match=r"batch leaf \['extra'\]\[1\]\['noisy'\]"):
        debug.sanitize_batch(batch)
    batch["extra"][1]["noisy"] = wrap(np.zeros((2, 3), np.float32))
    debug.sanitize_batch(batch)


def test_checked_raises_on_a_backward_that_makes_nan():
    """A step whose loss is finite but whose backward divides 0 by 0 (the
    gradient of sqrt at 0 times 0): plain, it leaves NaN in the gradient;
    checked, it raises naming the function."""
    def step(w):
        loss = (torch.sqrt(w) * 0.0).sum()
        loss.backward()
        return loss.detach()

    w = torch.zeros(3, requires_grad=True)
    assert float(step(w)) == 0.0 and bool(torch.isnan(w.grad).any())
    w.grad = None
    with pytest.warns(UserWarning), pytest.raises(RuntimeError, match="nan"):
        debug.checked(step)(w)
    assert not torch.is_anomaly_enabled()
    ok = torch.ones(3, requires_grad=True)
    with pytest.warns(UserWarning):
        assert float(debug.checked(step)(ok)) == 0.0


def test_enable_debug_nans_sets_anomaly_mode():
    try:
        debug.enable_debug_nans()
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_debug_nans(False)
    assert not torch.is_anomaly_enabled()
