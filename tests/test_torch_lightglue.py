"""LightGlue's runtime wrapper (cslam_tpu_torch/models/lightglue.py) on
the CPU: `match` is the mutual filter of exactly what the instance's
`scores` returns, runs eagerly and records no graph counter; and the
body of the card's pair graph (`_PairGraph.stage` and `forward`, run
uncaptured) gives the eager scores bit for bit, with the image size
given or taken from the keypoints' bounds, restaged pair after pair.
The captured graph itself runs only on the card
(tests/test_torch_cuda.py, `-k lightglue`)."""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from cslam_tpu_torch.models import lightglue as tlg
from cslam_tpu_torch.models import zoo
from cslam_tpu_torch.runtime.tracing import tracer

torch.set_num_threads(1)

SIZE = (241, 96)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def traced():
    """The process-wide tracer, on and empty; off and empty after."""
    tracer.clear()
    tracer.enable(None)
    try:
        yield tracer
    finally:
        tracer.disable()
        tracer.clear()


@pytest.fixture(scope="module")
def lg():
    return tlg.LightGlue(zoo.shipped_checkpoint("lightglue_synth.npz"),
                         num_layers=3, device="cpu")


def _pair(seed, k0=128, k1=96):
    """Two padded sides as the handler passes them, 100 and 70 slots
    valid, matches among them (chip_smoke.lightglue_pair)."""
    return _chip_smoke().lightglue_pair(np.random.default_rng(seed), k0, k1,
                                        100, 70, SIZE)


def _eager(lg, args, size):
    t = [torch.from_numpy(a) for a in args]
    if size is None:
        size = torch.clamp(torch.amax(torch.cat([t[1], t[4]]), dim=0),
                           min=1.0)
    with torch.no_grad():
        return lg.model(t[0], tlg.normalize_keypoints(t[1], size), t[2],
                        t[3], tlg.normalize_keypoints(t[4], size), t[5])


@pytest.mark.parametrize("size", [SIZE, None])
def test_match_is_the_eager_filter_of_the_instance_scores(lg, traced, size):
    args = _pair(1)
    seen = []
    scores = lg.scores

    def wrapped(*a, size=None):
        out = scores(*a, size=size)
        seen.append(out)
        return out
    lg.scores = wrapped
    try:
        idx1, valid = lg.match(*args, size=size)
    finally:
        del lg.scores
    assert len(seen) == 1
    ref = _eager(lg, args, size)
    assert torch.equal(seen[0], ref)
    best1, want = tlg.mutual_matches(ref, torch.from_numpy(args[2]),
                                     lg.score_threshold)
    assert idx1.dtype == np.int32 and valid.dtype == np.float32
    assert np.array_equal(valid, want.numpy().astype(np.float32))
    assert np.array_equal(idx1, best1.numpy().astype(np.int32))
    assert valid.sum() >= 20  # the pair has matches to judge
    assert "lightglue" not in traced.counter_totals()
    assert lg._stream is None and not lg._graphs


def test_match_filters_what_scores_returned(lg):
    """A wrapper that answers otherwise (the columns reversed) is what
    the filter sees: match reads no scores of its own."""
    args = _pair(2)
    scores = lg.scores
    lg.scores = lambda *a, size=None: scores(*a, size=size).flip(-1)
    try:
        idx1, valid = lg.match(*args, size=SIZE)
    finally:
        del lg.scores
    ref = _eager(lg, args, SIZE).flip(-1)
    best1, want = tlg.mutual_matches(ref, torch.from_numpy(args[2]),
                                     lg.score_threshold)
    assert np.array_equal(valid, want.numpy().astype(np.float32))
    assert np.array_equal(idx1[want.numpy()],
                          best1.numpy().astype(np.int32)[want.numpy()])
    assert valid.sum() >= 20


@pytest.mark.parametrize("k0,k1", [(128, 96), (128, 128)])
def test_pair_graph_body_matches_eager_scores(lg, k0, k1):
    """stage() then forward(), as the capture records them, restaged
    for pair after pair in one buffer (size given, taken from the
    bounds, given again; numpy, CPU tensors and bool masks)."""
    entry = tlg._PairGraph(lg.model, torch.device("cpu"), k0, k1, 256)
    for seed, size in ((3, SIZE), (4, None), (5, (320, 240))):
        args = _pair(seed, k0, k1)
        staged = list(args)
        if seed == 5:
            staged[1] = torch.from_numpy(args[1])
            staged[2] = args[2] > 0
        entry.stage(None, staged, size)
        with torch.no_grad():
            got = entry.forward()
        assert torch.equal(got, _eager(lg, args, size))
        assert torch.equal(got, lg.scores(*args, size=size))
