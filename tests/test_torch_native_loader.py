"""The port's native audio front end (``data/native_loader.py``,
``csrc/audioio.cc``) against the JAX package's (``native/audio/audioio.cc``)
and against the port's numpy path.

Both libraries are built under the test's temporary directory: the JAX one
with its own flags, named by ``DCSNET_AUDIOIO_SO`` before the JAX binding
loads it; the port's through its build helper, named by
``DCSNET_TORCH_AUDIOIO_SO``. Neither test builds in place under ``build/``,
where another worker may be loading a library.

Tolerances: the native fills (the faithful one, which decodes and resamples
whole utterances, and the windowed one, which reads only each crop's window)
equal the JAX package's bit for bit: the same double sums in the same order.
The numpy path resamples with float32 products summed by BLAS, so the native
batches agree with it within 1e-5 (a sample's magnitude is below 1).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import struct
import subprocess
import sys
import wave

import numpy as np
import pytest

from dcs_net_tpu.core.config import DataConfig as JDataConfig
from dcs_net_tpu.data import dataset as jdataset
from dcs_net_tpu.data import native_loader as jnl

from dcs_net_tpu_torch.core.config import DataConfig
from dcs_net_tpu_torch.data import dataset, native_loader as tnl, partition, synthetic
from dcs_net_tpu_torch.data.audio_io import resample, read_wav

from test_torch_train import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SOURCE = os.path.join(REPO, "native", "audio", "audioio.cc")
FILE_SR, SR, CROP = 48000, 16000, 4000
SHORT = "p900_900"      # a pair shorter than the crop
PCM32 = "p901_901"      # a 32-bit pair


def _write_pcm(path, x, sr, width, channels=1):
    """float samples in [-1, 1] (n, channels) -> PCM of ``width`` bytes."""
    full = 2 ** (8 * width - 1)
    v = np.clip(np.round(np.asarray(x, np.float64) * (full - 1)), -full, full - 1)
    v = v.astype(np.int64).reshape(-1)
    raw = b"".join(int(s).to_bytes(width, "little", signed=True) for s in v)
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(raw)


def _write_float_wav(path, x, sr):
    """An IEEE-float (format 3) wav, which neither native front end reads."""
    data = np.asarray(x, "<f4").tobytes()
    fmt = struct.pack("<HHIIHH", 3, 1, sr, sr * 4, 4, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """Both libraries built under a temporary directory and loaded from
    there for the module's tests."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native front ends cannot build")
    tmp = tmp_path_factory.mktemp("audioio")
    jso = tmp / "jax" / "libaudioio.so"
    jso.parent.mkdir()
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-pthread", "-o", str(jso),
                    JAX_SOURCE], check=True)
    tso = tnl.build_library(tmp / "port")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DCSNET_AUDIOIO_SO", str(jso))
        mp.setattr(jnl, "_lib", None)
        mp.setattr(jnl, "_build_failed", False)
        mp.setenv(tnl.ENV_SO, str(tso))
        mp.setattr(tnl._LIBRARY, "_lib", None)
        mp.setattr(tnl._LIBRARY, "error", None)
        assert jnl.native_available() and tnl.native_available()
        yield tso


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree (10 train pairs of 0.6 s at 48 kHz, PCM16) plus a
    pair of 0.2 s, shorter than the crop, and a 32-bit pair of 0.5 s; and,
    outside it, 24-bit, stereo and float files."""
    root = str(tmp_path_factory.mktemp("vb"))
    cfg = synthetic.generate(root, n_train=10, n_test=2, seconds=0.6)
    rng = np.random.default_rng(5)
    for name, seconds, width in ((SHORT, 0.2, 2), (PCM32, 0.5, 4)):
        clean = 0.3 * np.sin(np.arange(int(seconds * FILE_SR)) * 0.01)
        noisy = clean + 0.05 * rng.standard_normal(clean.shape)
        _write_pcm(os.path.join(partition.trainset_dir(cfg), name + ".wav"), clean, FILE_SR, width)
        _write_pcm(os.path.join(partition.noisy_trainset_dir(cfg), name + ".wav"), noisy,
                   FILE_SR, width)
    extra = os.path.join(root, "extra")
    os.makedirs(extra)
    x = 0.4 * np.sin(np.arange(int(0.3 * FILE_SR)) * 0.02)
    _write_pcm(os.path.join(extra, "pcm24.wav"), x, FILE_SR, 3)
    _write_pcm(os.path.join(extra, "stereo.wav"), np.stack([x, -0.5 * x], 1), FILE_SR, 2, 2)
    _write_pcm(os.path.join(extra, "short.wav"), x[:30], FILE_SR, 2)
    _write_float_wav(os.path.join(extra, "float.wav"), x, FILE_SR)
    return root


def _pairs(root):
    cd = partition.trainset_dir(DataConfig(root=root))
    nd = partition.noisy_trainset_dir(DataConfig(root=root))
    names = sorted(os.listdir(cd))
    return [os.path.join(cd, n) for n in names], [os.path.join(nd, n) for n in names]


def _length(path):
    with wave.open(path, "rb") as w:
        return -(-w.getnframes() * SR // w.getframerate())


@pytest.mark.parametrize("where", ["start", "mid", "last_window", "past_end"])
@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("fill", ["fill_batch", "fill_batch_full"])
def test_fill_batch_equals_the_jax_front_end(libs, tree, fill, threads, where):
    """Every pair of the tree (PCM16 and PCM32, one shorter than the crop,
    right-padded), cropped at the start, mid-file, at the last full window
    or past the end: the port's windowed and faithful fills equal the JAX
    fill bit for bit."""
    clean, noisy = _pairs(tree)
    starts = []
    for p in clean:
        n = _length(p)
        starts.append({"start": 0, "mid": max(n - CROP, 0) // 2,
                       "last_window": max(n - CROP, 0), "past_end": n + 7}[where])
    got = getattr(tnl, fill)(clean, noisy, starts, CROP, n_threads=threads)
    want = jnl.fill_batch(clean, noisy, starts, CROP, n_threads=threads)
    for g, w in zip(got, want):
        assert g.shape == (len(clean), CROP) and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    short = clean.index(os.path.join(os.path.dirname(clean[0]), SHORT + ".wav"))
    n_short = _length(clean[short])
    if where != "past_end":
        assert np.all(got[0][short, n_short:] == 0) and np.any(got[0][short, :n_short] != 0)
    else:
        assert not np.any(got[0])


@pytest.mark.parametrize("name", ["pcm24.wav", "stereo.wav", "short.wav"])
def test_fill_batch_other_pcm_equals_the_jax_front_end(libs, tree, name):
    """24-bit and stereo PCM, and an utterance shorter than the resampler's
    window, through both fills at three starts."""
    p = os.path.join(tree, "extra", name)
    n = _length(p)
    starts = [0, max(n - 1000, 0) // 2, max(n - 1000, 0)]
    want = jnl.fill_batch([p] * 3, [p] * 3, starts, 1000)
    for fill in (tnl.fill_batch, tnl.fill_batch_full):
        for g, w in zip(fill([p] * 3, [p] * 3, starts, 1000), want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("resampled", [False, True])
def test_load_wav_equals_the_jax_front_end(libs, tree, resampled):
    kw = {"orig_freq": FILE_SR, "new_freq": SR} if resampled else {}
    clean, _ = _pairs(tree)
    extra = [os.path.join(tree, "extra", n) for n in ("pcm24.wav", "stereo.wav", "short.wav")]
    for p in clean + extra:
        got, want = tnl.load_wav(p, **kw), jnl.load_wav(p, **kw)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if resampled:
            assert got.shape == (_length(p),)


def test_load_wav_agrees_with_the_numpy_path(libs, tree):
    clean, _ = _pairs(tree)
    for p in clean:
        raw, sr = read_wav(p)
        np.testing.assert_allclose(tnl.load_wav(p), raw, atol=1e-7)
        np.testing.assert_allclose(tnl.load_wav(p, orig_freq=sr, new_freq=SR),
                                   resample(raw, sr, SR), atol=1e-5)


def _loaders(root, batch=3, **kw):
    """The port's and the JAX package's datasets on the same train split."""
    tcfg = DataConfig(root=root, crop_samples=CROP, **kw)
    jcfg = JDataConfig(root=root, crop_samples=CROP, **kw)
    ids = partition.make_partition(tcfg, seed=2)["train"]
    return (dataset.VoiceBankDataset(ids, tcfg, "train"),
            jdataset.VoiceBankDataset(ids, jcfg, "train"))


@pytest.mark.parametrize("drop_last", [False, True])
def test_native_loader_equals_the_jax_native_loader(libs, tree, drop_last):
    """Two epochs of both packages' loaders on their native front ends: the
    same ids, starts and waves, bit for bit."""
    tds, jds = _loaders(tree)
    tl = dataset.Loader(tds, 3, drop_last=drop_last, seed=4, use_native=True)
    jl = jdataset.Loader(jds, 3, drop_last=drop_last, seed=4, use_native=True)
    try:
        assert tl.front_end == "native"
        for epoch in (0, 1):
            tb, jb = list(tl.epoch(epoch)), list(jl.epoch(epoch))
            assert len(tb) == len(jb) == len(tl) == len(jl)
            for a, b in zip(tb, jb):
                assert a["id"] == b["id"]
                np.testing.assert_array_equal(a["start"], b["start"])
                np.testing.assert_array_equal(a["clean"], b["clean"])
                np.testing.assert_array_equal(a["noisy"], b["noisy"])
    finally:
        tl.close()
        jl.close()


def test_native_loader_agrees_with_the_numpy_path(libs, tree):
    """The port's two front ends over two epochs: ids and starts equal, the
    waves within 1e-5."""
    tds, _ = _loaders(tree)
    nat = dataset.Loader(tds, 4, seed=7, use_native=True)
    py = dataset.Loader(tds, 4, seed=7, use_native=False)
    try:
        assert py.front_end == "python (use_native=False)"
        for epoch in (0, 1):
            for a, b in zip(nat.epoch(epoch), py.epoch(epoch), strict=True):
                assert a["id"] == b["id"]
                np.testing.assert_array_equal(a["start"], b["start"])
                np.testing.assert_allclose(a["clean"], b["clean"], atol=1e-5, rtol=0)
                np.testing.assert_allclose(a["noisy"], b["noisy"], atol=1e-5, rtol=0)
    finally:
        nat.close()
        py.close()


def test_utterance_lengths_are_the_resampled_lengths(libs, tree):
    tds, _ = _loaders(tree)
    loader = dataset.Loader(tds, 4)
    try:
        got = loader._utt_lengths()
        want = [tnl.load_wav(os.path.join(tds.clean_dir, u + ".wav"), orig_freq=FILE_SR,
                             new_freq=SR).shape[0] for u in tds.ids]
        assert got == want
    finally:
        loader.close()


@pytest.mark.parametrize("drop_last", [False, True])
def test_len_and_unshuffled_order_are_the_jax_loaders(libs, tree, drop_last):
    tds, jds = _loaders(tree)
    tl = dataset.Loader(tds, 4, shuffle=False, drop_last=drop_last, use_native=True)
    jl = jdataset.Loader(jds, 4, shuffle=False, drop_last=drop_last, use_native=True)
    try:
        assert len(tl) == len(jl) == (len(tds) // 4 if drop_last else -(-len(tds) // 4))
        tb, jb = list(tl.epoch(3)), list(jl.epoch(3))
        assert [b["id"] for b in tb] == [b["id"] for b in jb]
        assert sum((b["id"] for b in tb), []) == tds.ids[:len(tb) * 4]
    finally:
        tl.close()
        jl.close()


def test_the_jax_rule_picks_the_front_end(libs, tree, monkeypatch):
    """Native when the library loads and ``load_into_ram`` is off; else the
    numpy path, saying why (a prebuilt library that does not load: the
    loader's error)."""
    cfg = DataConfig(root=tree)
    assert dataset.choose_front_end(cfg) == (True, "native")
    assert dataset.choose_front_end(dataclasses.replace(cfg, load_into_ram=True)) == (
        False, "python (load_into_ram)")
    assert dataset.choose_front_end(cfg, False) == (False, "python (use_native=False)")
    missing = os.path.join(tree, "missing", "libaudioio.so")
    monkeypatch.setenv(tnl.ENV_SO, missing)
    monkeypatch.setattr(tnl._LIBRARY, "_lib", None)
    monkeypatch.setattr(tnl._LIBRARY, "error", None)
    assert not tnl.native_available()
    assert missing in tnl.load_error()
    use, why = dataset.choose_front_end(cfg)
    assert not use and why.startswith("python (native front end unavailable: ")
    assert missing in why
    with pytest.raises(RuntimeError, match="unavailable"):
        tnl.fill_batch([missing], [missing], [0], CROP)


@pytest.mark.parametrize("fill", ["fill_batch", "fill_batch_full"])
def test_a_missing_file_raises_naming_the_item(libs, tree, fill):
    clean, noisy = _pairs(tree)
    paths = [clean[0], os.path.join(tree, "nonexistent.wav"), clean[2]]
    with pytest.raises(IOError, match="item 1: .*nonexistent.wav"):
        getattr(tnl, fill)(paths, [noisy[0], noisy[1], noisy[2]], [0, 0, 0], CROP)
    with pytest.raises(IOError):
        jnl.fill_batch(paths, [noisy[0], noisy[1], noisy[2]], [0, 0, 0], CROP)
    with pytest.raises(IOError):
        tnl.load_wav(paths[1])


def test_a_missing_file_raises_through_the_loader(libs, tree, tmp_path):
    root = str(tmp_path / "vb")
    shutil.copytree(tree, root)
    tds, _ = _loaders(root)
    os.remove(os.path.join(tds.noisy_dir, tds.ids[0] + ".wav"))
    loader = dataset.Loader(tds, 4, shuffle=False, use_native=True)
    try:
        with pytest.raises(IOError, match=f"item 0: .*{tds.ids[0]}"):
            list(loader.epoch(0))
    finally:
        loader.close()


@pytest.mark.parametrize("fill", ["fill_batch", "fill_batch_full"])
def test_float_wavs_and_unequal_lengths_are_refused(libs, tree, fill):
    """IEEE-float samples (format 3) are refused by both packages' native
    front ends; so is a pair whose clean and noisy lengths differ."""
    clean, noisy = _pairs(tree)
    fl = os.path.join(tree, "extra", "float.wav")
    for fn in (getattr(tnl, fill), jnl.fill_batch):
        with pytest.raises(IOError, match="item 0"):
            fn([fl], [fl], [0], CROP)
        with pytest.raises(IOError, match="item 1"):
            fn([clean[0], clean[1]], [noisy[0], os.path.join(tree, "extra", "pcm24.wav")],
               [0, 0], CROP)
    for load in (tnl.load_wav, jnl.load_wav):
        with pytest.raises(IOError):
            load(fl)


_BUILD_AND_LOAD = """
import ctypes, sys
from dcs_net_tpu_torch.data.native_loader import build_library
lib = ctypes.CDLL(str(build_library(sys.argv[1])))
print(lib.audioio_version())
"""


def test_two_processes_building_the_library_at_once_both_load_it(libs, tmp_path):
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
        assert out.strip() == "2"
    assert sorted(os.listdir(tmp_path)) == ["libaudioio.lock", "libaudioio.so"]


def test_the_library_is_rebuilt_when_older_than_its_source(libs, tmp_path):
    so = tnl.build_library(tmp_path)
    first = so.stat().st_mtime
    assert tnl.build_library(tmp_path) == so and so.stat().st_mtime == first
    old = tnl.SOURCE.stat().st_mtime - 10
    os.utime(so, (old, old))
    tnl.build_library(tmp_path)
    assert so.stat().st_mtime >= tnl.SOURCE.stat().st_mtime
