"""The port's evaluation metrics against the JAX package's on the same seeded
numpy audio: STOI (plain and extended, at 16 and 10 kHz), the composite
measures (SegSNR, LLR, WSS, CSIG/CBAK/COVL), ``calc_metric``'s NaN and
failure rules, SI-SDR, and the native PESQ estimator: the port's source is
the JAX package's but for its header comment, the port's binding scores as
the JAX one on the same signals, and two processes that build the port's
library at once both load it. The JAX side loads a PESQ library this file
builds under its own temporary directory, never the JAX package's shared
build."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dcs_net_tpu.metrics import composite as jcomposite
from dcs_net_tpu.metrics import harness as jharness
from dcs_net_tpu.metrics import pesq as jpesq
from dcs_net_tpu.metrics import stoi as jstoi

from dcs_net_tpu_torch.metrics import composite as tcomposite
from dcs_net_tpu_torch.metrics import harness as tharness
from dcs_net_tpu_torch.metrics import pesq as tpesq
from dcs_net_tpu_torch.metrics import stoi as tstoi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(REPO, "native", "pesq", "pesq.cc")
SR = 16000
# numpy on the same float64 inputs in the same order: only the last bits of
# a sum may differ
TOL = 1e-9


def _speech(seed, n=SR, level=0.1):
    """Noise under a 3 Hz envelope, and a degraded copy of it."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (rng.standard_normal(n) * (0.55 + 0.45 * np.sin(2 * np.pi * 3 * t))
         * level).astype(np.float32)
    y = (x + 0.03 * rng.standard_normal(n)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def jax_pesq_library(tmp_path_factory):
    """The JAX package's PESQ source built under this module's temporary
    directory and named by ``DCSNET_PESQ_SO`` while the module runs, so the
    JAX binding never builds its shared library. Returns the JAX ``pesq``."""
    so = tmp_path_factory.mktemp("jax_pesq") / "libpesq.so"
    subprocess.run(["g++", *tpesq.GXX_FLAGS, "-o", str(so), JAX_SOURCE], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCSNET_PESQ_SO", str(so))
        yield jpesq.pesq


@pytest.mark.parametrize("sr", [16000, 10000])
@pytest.mark.parametrize("extended", [False, True])
def test_stoi_matches_jax(sr, extended):
    x, y = _speech(1, n=2 * sr)
    got = tstoi.stoi(x, y, sr, extended=extended)
    want = jstoi.stoi(x, y, sr, extended=extended)
    assert np.isfinite(want) and 0.2 < want < 1.0
    assert abs(got - want) <= TOL, (got, want)


def test_stoi_of_a_short_signal_is_nan_in_both():
    """Under 30 frames after silent-frame removal: NaN, which the harness
    then drops."""
    x, y = _speech(2, n=4000)
    assert np.isnan(tstoi.stoi(x, y, SR)) and np.isnan(jstoi.stoi(x, y, SR))


@pytest.mark.parametrize("name", ["segsnr", "llr", "wss"])
def test_composite_measures_match_jax(name):
    x, y = _speech(3)
    got = getattr(tcomposite, name)(x, y, SR)
    want = getattr(jcomposite, name)(x, y, SR)
    assert np.isfinite(want)
    assert abs(got - want) <= TOL * max(1.0, abs(want)), (got, want)


def test_composite_and_its_regressions_match_jax():
    x, y = _speech(4)
    got = tcomposite.composite(x, y, SR, pesq_mos=2.75)
    want = jcomposite.composite(x, y, SR, pesq_mos=2.75)
    assert got.keys() == want.keys() == {"pesq", "segsnr", "llr", "wss", "csig",
                                         "cbak", "covl"}
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), k
    assert tcomposite.csig_cbak_covl(9.0, -3.0, 0.0, 40.0) == \
        jcomposite.csig_cbak_covl(9.0, -3.0, 0.0, 40.0) == \
        {"csig": 5.0, "cbak": 5.0, "covl": 5.0}


def test_calc_metric_drops_nans_and_failures_as_jax():
    """Per utterance: a NaN and a raise are left out of the mean; a batch
    with none left gives 0.0."""
    rng = np.random.default_rng(5)
    clean = rng.standard_normal((4, 300))
    clean[:, 0] = np.arange(4)          # each row's index, for the metric below
    pred = clean + 0.1 * rng.standard_normal((4, 300))

    def metric(c, p, sr):
        i = int(c[0])
        if i == 2:
            raise ValueError("a failing utterance")
        return [0.25, float("nan"), None, 0.75][i]

    for impl in (tharness, jharness):
        assert impl.calc_metric(clean, pred, SR, metric) == 0.5
        assert impl.calc_metric(clean, pred, SR, lambda *a: float("nan")) == 0.0
        assert impl.calc_metric(clean[:0], pred[:0], SR, lambda *a: 1.0) == 0.0
    got = tharness.calc_metric(clean, pred, SR, tharness.si_sdr)
    assert got == jharness.calc_metric(clean, pred, SR, jharness.si_sdr)


def test_si_sdr_matches_jax():
    x, y = _speech(6)
    assert tharness.si_sdr(x, y) == jharness.si_sdr(x, y)
    assert tharness.si_sdr(x, 3.0 * x) > 100.0


def test_pesq_source_is_the_jax_packages():
    """The port's ``csrc/pesq.cc`` is ``native/pesq/pesq.cc`` byte for byte
    from line 7 on; lines 4-6, the header's note on where the original code
    gets its scores, differ only in wording."""
    with open(JAX_SOURCE, "rb") as f:
        want = f.read().split(b"\n")
    got = tpesq.SOURCE.read_bytes().split(b"\n")
    assert len(got) == len(want)
    assert got[:3] == want[:3] and got[6:] == want[6:]
    assert all(line.startswith(b"// ") for line in got[3:6])


def test_pesq_matches_jax(jax_pesq_library):
    """The same MOS on the same signals: clean, a slightly and a heavily
    degraded copy, a delayed copy; NaN for a short signal and for 44.1
    kHz."""
    x, y = _speech(7, n=2 * SR)
    rng = np.random.default_rng(8)
    noisy = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    delayed = np.concatenate([np.zeros(800, np.float32), y[:-800]])
    scores = []
    for deg in (x, y, noisy, delayed):
        got, want = tpesq.pesq(x, deg, SR), jax_pesq_library(x, deg, SR)
        assert got == want, (got, want)
        scores.append(got)
    assert scores[0] >= 4.4 and scores[1] > scores[2]
    short = np.zeros(100, np.float32)
    assert np.isnan(tpesq.pesq(short, short, SR))
    with np.errstate(all="ignore"):
        assert np.isnan(tpesq.pesq(x, y, 44100))
    assert tpesq.is_estimate() == jpesq.is_estimate()
    assert tharness.pesq_metric(x, y, SR) == jharness.pesq_metric(x, y, SR)


_BUILD_AND_LOAD = """
import ctypes, sys
from dcs_net_tpu_torch.metrics.pesq import build_library
lib = ctypes.CDLL(str(build_library(sys.argv[1])))
print(lib.pesq_version())
"""


def test_two_processes_building_the_library_at_once_both_load_it(tmp_path):
    """Two processes started together build into one empty directory: the
    lock lets one compile and the other load its file; both load a whole
    library, and no temporary file is left."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "862"
    assert sorted(os.listdir(tmp_path)) == ["libpesq.lock", "libpesq.so"]


def test_the_library_is_rebuilt_when_older_than_its_source(tmp_path):
    so = tpesq.build_library(tmp_path)
    first = so.stat().st_mtime
    assert tpesq.build_library(tmp_path) == so and so.stat().st_mtime == first
    old = tpesq.SOURCE.stat().st_mtime - 10
    os.utime(so, (old, old))
    tpesq.build_library(tmp_path)
    assert so.stat().st_mtime >= tpesq.SOURCE.stat().st_mtime
