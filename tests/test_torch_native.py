"""The port's host C++ event engine (data/_native.py over csrc/events.cpp)
against the JAX package's binding (benerf_tpu/data/_native.py) and against
the numpy versions, on the inputs of tests/test_events.py's native test:
indices, counts and the time-sorted order exactly equal. A build that fails
raises."""

import numpy as np
import pytest

from benerf_tpu.data import _native as jnative
from benerf_tpu.data import events as jev
from benerf_tpu_torch.data import _native as tnative
from benerf_tpu_torch.data import events as tev

N, H, W = 20000, 48, 64


def _raw(seed=7, ties=False):
    """tests/test_events.py test_native_engine_parity's stream; with `ties`
    its times rounded to whole units, so the stable sort orders many
    equal timestamps."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, W, N)
    y = rng.integers(0, H, N)
    pol = rng.choice([-1.0, 1.0], N)
    t = rng.random(N) * 500.0
    return x, y, (np.floor(t) if ties else t), pol


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("window", [(50.0, 450.0), (0.0, 500.0), (120.0, 120.0)])
def test_prepare_events_matches_jax_and_numpy(ties, window):
    x, y, t, pol = _raw(ties=ties)
    got = tnative.prepare_events(x, y, t, pol, W, *window)
    plain = tnative.prepare_events_numpy(x, y, t, pol, W, *window)
    want = jnative.prepare_events(x, y, t, pol, W, *window)
    keep = (t >= window[0]) & (t <= window[1])
    assert len(got[0]) == keep.sum()
    for a, b, c in zip(got, plain, want):
        assert a.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert np.all(np.diff(got[1]) >= 0)


def test_accumulate_events_matches_jax_and_numpy():
    x, y, _, pol = _raw()
    got = tnative.accumulate_events(x, y, pol, H, W)
    np.testing.assert_array_equal(got, tev.accumulate_events_numpy(x, y, pol, H, W))
    np.testing.assert_array_equal(got, jnative.accumulate_events(x, y, pol, H, W))
    assert got.sum() == pol.sum()


def test_accumulate_events_refuses_pixels_outside_the_frame():
    with pytest.raises(ValueError, match="outside"):
        tnative.accumulate_events([W], [0], [1.0], H, W)


def test_time_window_matches_searchsorted():
    rng = np.random.default_rng(3)
    ts = np.sort(rng.random(5000)).astype(np.float32)
    for t0, t1 in ((0.2, 0.6), (ts[100], ts[900]), (-1.0, 2.0), (0.7, 0.3)):
        got = tnative.time_window(ts, t0, t1)
        assert got == jnative.time_window(ts, t0, t1)
        assert got == (int(np.searchsorted(ts, np.float32(t0), "left")),
                       int(np.searchsorted(ts, np.float32(t1), "right")))


def test_prepare_raw_goes_through_the_engine():
    x, y, t, pol = _raw(seed=8, ties=True)
    got = tev.prepare_raw(x, y, t, pol, W, 50.0, 450.0, device="cpu")
    pix, ts, pp = tnative.prepare_events(x, y, t, pol, W, 50.0, 450.0)
    np.testing.assert_array_equal(got.pix_idx.numpy(), pix.astype(np.int64))
    np.testing.assert_array_equal(got.ts.numpy(), ts)
    np.testing.assert_array_equal(got.pol.numpy(), pp)
    want = jev.prepare_raw(x, y, t, pol, W, 50.0, 450.0)
    np.testing.assert_array_equal(got.pix_idx.numpy(), np.asarray(want.pix_idx))
    np.testing.assert_array_equal(got.ts.numpy(), np.asarray(want.ts))


@pytest.fixture
def fresh_engine(tmp_path, monkeypatch):
    """The engine unloaded, building into tmp_path."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_a_failed_build_raises(fresh_engine, monkeypatch):
    bad = fresh_engine / "events.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="event engine build failed"):
        tnative.prepare_events([0], [0], [0.5], [1.0], W, 0.0, 1.0)
    assert tnative._lib is None


def test_no_compiler_raises(fresh_engine, monkeypatch):
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tnative.time_window(np.zeros(3, np.float32), 0.0, 1.0)


def test_the_build_is_keyed_by_its_source(fresh_engine):
    path = tnative.build()
    assert path.exists() and path.parent == fresh_engine / "build"
    assert tnative.build() == path  # built once
    assert not list(path.parent.glob("*.tmp"))


def test_one_build_for_the_engine_and_the_kernels(tmp_path):
    """core/libbuild compiles every job at once, moves each good library into
    place and raises naming each failure, for both of its callers: the
    engine (data/_native) and the kernels (ops/mlp_kernels), whose library
    paths it keys by flags and sources."""
    import shutil

    from benerf_tpu_torch.core import libbuild
    from benerf_tpu_torch.ops import mlp_kernels

    good, bad = tmp_path / "good.cpp", tmp_path / "bad.cpp"
    good.write_text('extern "C" int one() { return 1; }\n')
    bad.write_text("this is not C++\n")
    cxx = shutil.which("g++") or shutil.which("c++")
    flags = ("-O1", "-fPIC", "-shared")
    paths = {n: libbuild.library_path(tmp_path / "build", n, flags, [src])
             for n, src in (("good", good), ("bad", bad))}
    with pytest.raises(RuntimeError, match="demo build failed") as err:
        libbuild.compile_libraries(
            [(n, [cxx, *flags, str(tmp_path / f"{n}.cpp")], paths[n])
             for n in paths], "demo")
    assert "bad:" in str(err.value) and "good:" not in str(err.value)
    assert paths["good"].exists() and not paths["bad"].exists()
    assert libbuild.library_path(tmp_path, "good", ("-O2",), [good]) \
        != libbuild.library_path(tmp_path, "good", flags, [good])
    assert tnative.build().name.startswith("libbenerf_events-")
    assert mlp_kernels._target("fused_mlp_fwd") == libbuild.library_path(
        mlp_kernels.BUILD_DIR, "fused_mlp_fwd", mlp_kernels.NVCC_FLAGS,
        mlp_kernels._source_files("fused_mlp_fwd"))
