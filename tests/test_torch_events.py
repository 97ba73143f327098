"""PyTorch port's event-window operations vs the JAX package and the numpy
oracle `accumulate_events_numpy`.

Both ETA paths are covered: the full-stream mask and the `cap` path that
takes a fixed number of events from the window start (start clamped to
N - cap) and reports how many events a too-small cap dropped. The scene
entry points and the parameter bridge put their tensors on the card unless
asked for the CPU.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benerf_tpu.data import events as jev
from benerf_tpu_torch.data import events as tev

H, W = 32, 48


def _random_events(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, W, n), rng.integers(0, H, n),
            rng.random(n).astype(np.float32), rng.choice([-1.0, 1.0], n))


def _both(seed=0, n=5000):
    x, y, ts, pol = _random_events(n, seed)
    return (x, y, ts, pol), jev.prepare(x, y, ts, pol, W), tev.prepare(x, y, ts, pol, W, device="cpu")


def _oracle(x, y, ts, pol, lo, hi):
    keep = (ts >= lo) & (ts <= hi)
    return jev.accumulate_events_numpy(x[keep], y[keep], pol[keep], H, W).reshape(-1)


def test_prepare_and_accumulate_all():
    (x, y, ts, pol), je, te = _both()
    np.testing.assert_array_equal(te.pix_idx.numpy(), np.asarray(je.pix_idx))
    np.testing.assert_array_equal(te.ts.numpy(), np.asarray(je.ts))
    np.testing.assert_array_equal(te.pol.numpy(), np.asarray(je.pol))
    assert te.num == 5000 and torch.all(torch.diff(te.ts) >= 0)
    eta = tev.accumulate_all(te, H * W).numpy()
    np.testing.assert_array_equal(eta, jev.accumulate_events_numpy(
        x, y, pol, H, W).reshape(-1))
    np.testing.assert_array_equal(eta, np.asarray(jev.accumulate_all(je, H * W)))


# windows from the sorted times: inside, touching the start, touching the
# end, and ends on two events' exact times (inclusive ends)
WINDOWS = {"mid": lambda ts: (0.3, 0.4), "start": lambda ts: (0.0, 0.07),
           "end": lambda ts: (0.95, 1.0), "on_events": lambda ts: (ts[100], ts[300])}


@pytest.mark.parametrize("window", list(WINDOWS))
def test_eta_time_window_both_paths_match_jax_and_oracle(window):
    (x, y, ts, pol), je, te = _both(seed=1)
    srt = np.sort(ts)
    lo, hi = np.float32(WINDOWS[window](srt)[0]), np.float32(WINDOWS[window](srt)[1])
    oracle = _oracle(x, y, ts, pol, lo, hi)
    cap = jev.window_cap(srt, float(hi - lo))
    assert tev.window_cap(srt, float(hi - lo)) == cap
    for c in (0, cap):
        eta_t, ov_t = tev.eta_time_window(te, H * W, torch.tensor(lo),
                                          torch.tensor(hi), cap=c)
        eta_j, ov_j = jev.eta_time_window(je, H * W, jnp.asarray(lo),
                                          jnp.asarray(hi), cap=c)
        np.testing.assert_array_equal(eta_t.numpy(), oracle)
        np.testing.assert_array_equal(eta_t.numpy(), np.asarray(eta_j))
        assert int(ov_t) == int(ov_j) == 0


@pytest.mark.parametrize("cap", [8, 64, 300])
def test_undersized_cap_reports_the_same_overflow(cap):
    (_, _, ts, _), je, te = _both(seed=2)
    lo, hi = np.float32(0.3), np.float32(0.4)
    eta_t, ov_t = tev.eta_time_window(te, H * W, torch.tensor(lo),
                                      torch.tensor(hi), cap=cap)
    eta_j, ov_j = jev.eta_time_window(je, H * W, jnp.asarray(lo),
                                      jnp.asarray(hi), cap=cap)
    in_window = int(((ts >= lo) & (ts <= hi)).sum())
    assert int(ov_t) == int(ov_j) == max(in_window - cap, 0) > 0
    np.testing.assert_array_equal(eta_t.numpy(), np.asarray(eta_j))
    assert float(eta_t.abs().sum()) <= cap


def test_cap_window_clamped_at_stream_end():
    """A window whose start lies within `cap` of the end reads the last cap
    events (start clamped to N - cap) and masks the leading extras."""
    (x, y, ts, pol), je, te = _both(seed=3, n=800)
    lo, hi = np.float32(np.sort(ts)[-50]), np.float32(1.0)
    eta, ov = tev.eta_time_window(te, H * W, torch.tensor(lo), torch.tensor(hi),
                                  cap=200)
    np.testing.assert_array_equal(eta.numpy(), _oracle(x, y, ts, pol, lo, hi))
    assert int(ov) == 0


def test_sample_time_window_bounds():
    for i in range(5):
        g = torch.Generator()
        g.manual_seed(i)
        lo, hi = tev.sample_time_window(g, 0.1, True)
        assert lo.ndim == 0 and 0.0 <= float(lo) <= 0.9
        assert abs(float(hi) - float(lo) - 0.1) < 1e-6
    slots = set()
    for i in range(20):
        g = torch.Generator()
        g.manual_seed(i)
        slots.add(float(tev.sample_time_window(g, 0.25, False)[0]))
    assert slots <= {0.0, 0.25, 0.5} and len(slots) > 1


@pytest.mark.parametrize("random_placement", [True, False])
def test_eta_count_window_is_a_contiguous_slice(random_placement):
    (_, _, _, _), _, te = _both(seed=4)
    g = torch.Generator()
    g.manual_seed(0)
    eta, t0, t1 = tev.eta_count_window(te, H * W, g, 0.2, random_placement)
    n_window = round(te.num * 0.2)
    start = int(torch.searchsorted(te.ts, t0))
    assert float(te.ts[start + n_window - 1]) == float(t1)
    sl = slice(start, start + n_window)
    want = np.zeros(H * W)
    np.add.at(want, te.pix_idx[sl].numpy(), te.pol[sl].numpy())
    np.testing.assert_array_equal(eta.numpy(), want)
    if not random_placement:
        assert start % n_window == 0


def test_scene_entry_points_default_to_the_card(monkeypatch):
    """random_scene and prepare put the events on the card unless asked
    for the CPU, and raise without a card; a window lands on its
    generator's device."""
    from benerf_tpu_torch.data import datasets as tdatasets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = types.SimpleNamespace(event_width=W, event_height=H, rgb_width=W,
                                rgb_height=H, channels=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdatasets.random_scene(cfg, 100, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.prepare(*_random_events(10), W)
    scene = tdatasets.random_scene(cfg, 100, seed=0, device="cpu")
    assert scene.events.ts.device.type == "cpu" and scene.events.num == 100
    assert scene.image.shape == (1, H, W, 3)
    lo, hi = tev.sample_time_window(torch.Generator().manual_seed(0), 0.1)
    assert lo.device.type == hi.device.type == "cpu"


def test_params_from_numpy_defaults_to_the_card(monkeypatch):
    """The parameter bridge puts the JAX package's parameters on the card
    unless asked for the CPU, and raises without a card."""
    from benerf_tpu_torch.models import bridge

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones((2, 3), np.float32), "b": [np.zeros(3, np.float64)]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_numpy(tree)
    got = bridge.params_from_numpy(tree, device="cpu")
    assert got["w"].device.type == "cpu" and got["w"].dtype == torch.float32
    assert got["b"][0].dtype == torch.float64
