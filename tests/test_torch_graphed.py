"""The port's shape-keyed CUDA graphs (``models/graphed.py``) on the CPU.

A CPU has no CUDA graph, so these tests put a stand-in in place of the
capture: it runs the captured body once (what the capture records) and runs
it again at every ``replay()``, writing into the captured outputs as a
replay writes into a graph's static outputs. With it: the cache's life cycle
(warm-up, capture, replay), clones out, one entry a key and the LRU bound, a
capture error reaching the caller, the three enhance paths and the trainer's
eval batch graphed against eager, ``Trainer.restore`` dropping the eval
graphs, and the device constants a graph read outliving the caches that
made them.
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from dcs_net_tpu_torch.core.config import config_for_variant
from dcs_net_tpu_torch.dsp import stft as tdsp
from dcs_net_tpu_torch.models import enhance as tenh
from dcs_net_tpu_torch.models import graphed
from dcs_net_tpu_torch.models.graphed import GraphCache
from dcs_net_tpu_torch.models.unet import DCSNet
from dcs_net_tpu_torch.train import steps as TS
from dcs_net_tpu_torch.train.checkpoint import CheckpointManager
from dcs_net_tpu_torch.train.loop import Trainer
from dcs_net_tpu_torch.utils import device as device_module
from dcs_net_tpu_torch.ops import conv_engine, cuda_conv, cuda_tapconv
from dcs_net_tpu_torch.utils.device import holding

from test_torch_train import _one_torch_thread  # noqa: F401

TINY = (1, 2, 2, 4, 4, 8, 8, 8)


class FakeGraph:
    """A captured body that a replay runs again, writing into the outputs
    the capture returned and reading the device constants the capture read
    (those its entry holds), as a graph's replay reads them by address."""

    replaying = False

    def __init__(self, body, out, constants):
        self.body, self.out, self.constants = body, out, constants

    def replay(self):
        FakeGraph.replaying = True
        try:
            with holding(self.constants):
                fresh = pytree.tree_flatten(self.body())[0]
        finally:
            FakeGraph.replaying = False
        for static, new in zip(pytree.tree_flatten(self.out)[0], fresh):
            static.copy_(new)


@pytest.fixture
def captures(monkeypatch):
    """CPU tensors take the graphed path, captured by :class:`FakeGraph`;
    the list of the graphs captured."""
    made = []

    def capture(body, pool, device):
        out = body()
        made.append(FakeGraph(body, out, device_module._holders[-1]))
        return made[-1], out, "pool" if pool is None else pool, 0

    monkeypatch.setattr(graphed, "_capturable", lambda t: True)
    monkeypatch.setattr(graphed, "_capture", capture)
    return made


def _body_runs():
    runs = []

    def fn(x, y, *, scale):
        runs.append(FakeGraph.replaying)
        return {"sum": x * scale + y, "pair": (x - y, y.sum(0))}
    return fn, runs


def test_life_cycle_warm_up_capture_replay(captures):
    fn, runs = _body_runs()
    cache = GraphCache()
    rng = np.random.default_rng(0)
    for i in range(5):
        x, y = (torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32))
                for _ in range(2))
        got = cache(fn, x, y, scale=2.0)
        torch.testing.assert_close(got["sum"], x * 2.0 + y, rtol=0, atol=0)
        torch.testing.assert_close(got["pair"][0], x - y, rtol=0, atol=0)
        torch.testing.assert_close(got["pair"][1], y.sum(0), rtol=0, atol=0)
        entry = cache.entry(fn, x, y, scale=2.0)
        assert entry.warm and (entry.graph is None) == (i == 0) and entry.replays == i
    # the body ran eagerly twice, at the warm-up and at the capture; every
    # later run was a replay
    assert runs == [False, False] + [True] * 4
    assert len(captures) == 1 and entry.replays == 4 and entry.capture_s >= 0
    assert entry.launches == {}     # no kernel launches on the CPU


def test_results_are_clones(captures):
    fn, _ = _body_runs()
    cache = GraphCache()
    x, y = torch.ones(2, 3), torch.zeros(2, 3)
    outs = [cache(fn, x * i, y, scale=1.0)["sum"] for i in range(4)]
    for i, out in enumerate(outs):     # each result survives the later replays
        torch.testing.assert_close(out, torch.full((2, 3), float(i)), rtol=0, atol=0)
    static = cache.entry(fn, x, y, scale=1.0).outputs
    ptrs = {o.data_ptr() for o in outs} | {s.data_ptr() for s in static}
    assert len(ptrs) == len(outs) + len(static)


def test_a_key_an_entry_and_the_lru_bound(captures, monkeypatch):
    fn, _ = _body_runs()
    monkeypatch.setattr(graphed, "MAX_ENTRIES", 2)
    cache = GraphCache()
    a, b, c = (torch.ones(n, 2) for n in (1, 2, 3))
    for t in (a, a, b):
        cache(fn, t, t, scale=1.0)
    cache(fn, a, a, scale=2.0)          # another static argument: another key
    assert len(cache) == 2 and cache.entry(fn, a, a, scale=1.0) is None
    cache = GraphCache()
    for t in (a, b, a, c):              # a used after b: b goes first
        cache(fn, t, t, scale=1.0)
    assert cache.entry(fn, b, b, scale=1.0) is None
    assert cache.entry(fn, a, a, scale=1.0).warm and cache.entry(fn, c, c, scale=1.0)


def test_a_failed_capture_raises(monkeypatch):
    fn, runs = _body_runs()

    def broken(body, pool, device):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphed, "_capturable", lambda t: True)
    monkeypatch.setattr(graphed, "_capture", broken)
    cache = GraphCache()
    x = torch.ones(2, 2)
    cache(fn, x, x, scale=1.0)          # the warm-up runs eagerly
    for _ in range(2):                  # no eager fallback, now or later
        with pytest.raises(RuntimeError, match="capturing"):
            cache(fn, x, x, scale=1.0)
    assert len(runs) == 1


def test_cpu_tensors_take_the_plain_path():
    fn, runs = _body_runs()
    cache = GraphCache()
    x = torch.ones(2, 2)
    for _ in range(3):
        cache(fn, x, x, scale=1.0)
    assert len(cache) == 0 and runs == [False] * 3


def _model(streaming, seed=0, variant="dcs"):
    cfg = config_for_variant(variant, streaming=streaming)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, channels=TINY, ca_reduction=2))
    return DCSNet(cfg.model, cfg.quirks, device="cpu", seed=seed).eval(), cfg


def _waves(lengths, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((0.1 * rng.standard_normal((2, n))).astype(np.float32))
            for n in lengths]


@pytest.mark.parametrize("path,variant", [("full", "dcs"), ("stream", "dcs"),
                                          ("carry", "dcs"), ("full", "drs"),
                                          ("carry", "drs")])
def test_enhance_paths_graphed_equal_eager(captures, path, variant):
    """Each path through the cache equals the eager path on the same
    waves, warm-up, capture and replays alike; a stream's groups (5 chunks
    in groups of 2, the last padded) share one entry, a carried stream's
    chunks another, their state (the complex net's four tensors, the real
    net's two) threaded through the replays."""
    model, cfg = _model(streaming=path == "carry", seed=3, variant=variant)
    kw = {"full": {}, "stream": dict(chunk_frames=32, overlap=8, chunk_batch=2),
          "carry": dict(chunk_frames=32, overlap=0, carry_lstm_state=True)}[path]
    run = tenh.enhance_full if path == "full" else tenh.enhance_streaming
    cache = GraphCache()
    for wave in _waves([4000, 4000, 4000], 1):   # T = 126: 5 chunks of 32 / 24
        torch.testing.assert_close(run(model, wave, cfg, graphs=cache, **kw),
                                   run(model, wave, cfg, **kw), rtol=0, atol=0)
    (entry,) = cache.entries.values()
    calls = {"full": 3, "stream": 3 * 3, "carry": 3 * 4}[path]
    assert entry.replays == calls - 1 and len(captures) == 1


def test_trainer_eval_graphs_and_restore(captures, tmp_path):
    """The trainer's eval batch through its cache equals the eager eval
    step; a restore (and a new model) drops the cache."""
    cfg = config_for_variant("dcs")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, channels=TINY, ca_reduction=2))
    trainer = Trainer(cfg, device="cpu", log_dir=str(tmp_path), pesq_fn=lambda *a: 0.0)
    trainer.init_state()
    rng = np.random.default_rng(2)
    batches = [{k: (0.1 * rng.standard_normal((2, 2016))).astype(np.float32)
                for k in ("noisy", "clean")} for _ in range(3)]
    for batch in batches:
        losses, audio = trainer._eval_batch(batch)
        want_losses, want_audio = TS.eval_step(trainer.model,
                                               trainer._device_batch(batch), cfg)
        assert losses == {k: float(v) for k, v in want_losses.items()}
        for k, v in want_audio.items():
            np.testing.assert_array_equal(audio[k], v.numpy())
    (entry,) = trainer._eval_graphs.entries.values()
    assert entry.replays == 2
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    trainer.save(ckpt, 0)
    trainer.restore(ckpt)
    assert len(trainer._eval_graphs) == 0
    trainer._eval_batch(batches[0])
    trainer.init_state()
    assert len(trainer._eval_graphs) == 0


def _tensors(value):
    return [t for t in pytree.tree_flatten(value)[0] if isinstance(t, torch.Tensor)]


def test_graph_constants_outlive_the_caches(captures):
    """The constants an entry read (the STFT plan and bases, the window
    envelope, the crossfade) stay alive, held by the entry, after every
    device cache is cleared and garbage is collected, while one made outside
    an entry does not; the capture after the caches evicted the entry's
    constants makes none anew, and a replay after 20 other lengths equals
    the eager call."""
    model, cfg = _model(streaming=False, seed=4)
    cache = GraphCache()
    wave, *others = _waves([3000 + 32 * i for i in range(21)], 5)
    want = tenh.enhance_full(model, wave, cfg)
    tenh.enhance_full(model, wave, cfg, graphs=cache)        # the warm-up
    entry = cache.entry(tenh._enhance_full, wave, model=model, cfg=cfg)
    for other in others:     # > 16 lengths: the envelope's cache evicts wave's
        tenh.enhance_full(model, other, cfg)
    misses = tdsp._inv_window_envelope.cache_info().misses
    tenh.enhance_full(model, wave, cfg, graphs=cache)        # the capture
    assert tdsp._inv_window_envelope.cache_info().misses == misses
    held = [weakref.ref(t) for t in _tensors(list(entry.constants.values()))]
    assert len(held) >= 3
    loose = weakref.ref(tenh._crossfade(3, 64, 16, torch.device("cpu"))[0])
    for fn in (tdsp._on_device, tdsp._analysis_plan, tdsp._inv_window_envelope,
               tenh._crossfade, conv_engine._unified_fold, cuda_conv.zero_bias,
               cuda_tapconv._clusters_at_once):
        fn.cache_clear()
    gc.collect()
    assert all(r() is not None for r in held) and loose() is None
    for other in others:
        tenh.enhance_full(model, other, cfg, graphs=cache)
    torch.testing.assert_close(tenh.enhance_full(model, wave, cfg, graphs=cache), want,
                               rtol=0, atol=0)
    assert entry.replays == 1 + 1


@pytest.mark.parametrize("counts,want,taken", [
    ((1516, 1516), 0, 2),                     # two whole windows
    ((1489, 1516, 1516), 1, 3),               # the first lost records
    ((1516, 1499, 1516), 0, 3),               # a later one lost records
    ((1514, 1516, 1514, 1516), 1, 4),         # a lower count seen twice first
    ((1, 2, 3, 4, 5, 6), None, 6),            # no two agree: not measured
    # a call whose own count varies (the eager carried stream on the H100):
    # a larger count seen once, the largest count seen twice taken
    ((28159, 28288, 28159, 28425, 28171, 28160), 0, 6),
])
def test_profiled_whole_takes_a_window_with_the_calls_count(monkeypatch, counts,
                                                            want, taken):
    """Busy time is read only from a window whose kernel count is the
    largest seen and seen twice (records are lost, never gained); where no
    such count comes in the windows taken, the largest count seen twice."""
    from dcs_net_tpu_torch.utils import timing

    windows = iter([(float(i), 0.0, n, []) for i, n in enumerate(counts)])
    monkeypatch.setattr(timing, "profiled", lambda fn: next(windows))
    window, n = timing.profiled_whole(lambda: None)
    assert n == taken
    assert (window is None) if want is None else window[0] == float(want)
