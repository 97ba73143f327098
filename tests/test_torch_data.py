"""The port's data slice against the JAX package and imageio.

- data/png.py: decodes what imageio writes and imageio decodes what it
  writes, for gray, gray + alpha, RGB and RGBA; every filter type (rows
  filtered here, decoded by both); palette and 16-bit files, which imageio
  writes, raise as malformed or unsupported files do;
- the scene loaders on the same files for the five formats of SURVEY.md
  §2.2, `loadpose` and `loadtrans`: equal arrays (events: equal times, and
  each equal-time group as a multiset, since the JAX ingest runs its C++
  engine where it is built);
- raw ingest (`prepare_raw`) bit for bit against the numpy branch of the
  JAX ingest, and `polarity_image`, `accumulate_events_numpy`,
  `EventSlicer`, the camera paths and the undistortion LUTs equal to the
  JAX package's;
- the synthetic writer against the JAX writer on one seed: knots and
  frames to fp32 rounding, equal PNGs and sidecars, event counts within 1%;
- the motion-scale pose init equal to the JAX package's to 1e-6 relative.
Writer sizes: 40x40, 7 virtual frames, one image.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from imageio.v3 import imread, imwrite

from benerf_tpu.core.config import Config as JConfig
from benerf_tpu.data import _native
from benerf_tpu.data import datasets as jdatasets
from benerf_tpu.data import events as jevents
from benerf_tpu.data import synthetic as jsynthetic
from benerf_tpu.data import undistort as jundistort
from benerf_tpu.geometry import camera_paths as jpaths
from benerf_tpu.train import pose_init as jpose_init
from benerf_tpu_torch.core.config import Config as TConfig
from benerf_tpu_torch.data import datasets as tdatasets
from benerf_tpu_torch.data import events as tevents
from benerf_tpu_torch.data import png
from benerf_tpu_torch.data import synthetic as tsynthetic
from benerf_tpu_torch.data import undistort as tundistort
from benerf_tpu_torch.geometry import camera_paths as tpaths
from benerf_tpu_torch.train import pose_init as tpose_init

H, W, FOCAL = 40, 40, 50.0
WRITER = dict(H=H, W=W, focal=FOCAL, n_virtual=7, seed=0)
KNOT_RTOL = 1e-5  # ~80 fp32 ulps: calibrated_trajectory's two rescales


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny: one intra-op thread, so that six test
    workers sharing the CPU do not oversubscribe it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- PNG ---------------------------------------------------------------------


SHAPES = {"gray": (13, 17), "gray_alpha": (13, 17, 2), "rgb": (13, 17, 3),
          "rgba": (13, 17, 4)}


def _image(shape, seed=0):
    """Noise on a smooth ramp: rows where each filter type does work."""
    rng = np.random.default_rng(seed)
    ramp = np.add.outer(np.arange(shape[0]), 3 * np.arange(shape[1]))
    ramp = ramp.reshape(ramp.shape + (1,) * (len(shape) - 2))
    return ((ramp + rng.integers(0, 40, shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_reads_what_imageio_writes(kind):
    img = _image(SHAPES[kind])
    data = imwrite("<bytes>", img, extension=".png")
    np.testing.assert_array_equal(png.decode(data), img)


@pytest.mark.parametrize("kind", list(SHAPES))
def test_imageio_reads_what_png_writes(kind, tmp_path):
    img = _image(SHAPES[kind], seed=1)
    path = str(tmp_path / "a.png")
    png.write(path, img)
    np.testing.assert_array_equal(imread(path), img)
    np.testing.assert_array_equal(png.read(path), img)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _png_file(ihdr, raw_rows):
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw_rows)) + _chunk(b"IEND", b""))


def _filtered_png(img, ftype):
    """A PNG of `img` (uint8, (H, W, C)) with every row under filter
    `ftype`, filtered by the PNG specification's formulas."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - left
        elif ftype == 2:
            f = x - up
        elif ftype == 3:
            f = x - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            f = x - np.where((pa <= pb) & (pa <= pc), left,
                             np.where(pb <= pc, up, ul))
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return _png_file(struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0),
                     b"".join(out))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4],
                         ids=["none", "sub", "up", "average", "paeth"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_undoes_every_filter_type(ftype, channels):
    img = _image((9, 11, channels), seed=ftype)
    data = _filtered_png(img, ftype)
    np.testing.assert_array_equal(png.decode(data).reshape(img.shape), img)
    np.testing.assert_array_equal(
        imread(data, extension=".png").reshape(img.shape), img)


def test_png_palette_and_16_bit_files_read_as_imageio_reads_them():
    """The reader takes 8-bit gray / RGB files only: palette and 16-bit
    files, which imageio reads, raise rather than being misread (the
    loaders scale every image by 1/255)."""
    from PIL import Image
    import io

    rng = np.random.default_rng(3)
    for colors in (4, 16, 200):  # bit depths 2, 4, 8
        rgb = (rng.integers(0, 6, (9, 11, 3)) * 50).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE,
                                     colors=colors).save(buf, format="PNG")
        assert imread(buf.getvalue(), extension=".png").shape == (9, 11, 3)
        with pytest.raises(ValueError, match="palette"):
            png.decode(buf.getvalue())
    g16 = rng.integers(0, 65535, (9, 11)).astype(np.uint16)
    data = imwrite("<bytes>", g16, extension=".png")
    np.testing.assert_array_equal(imread(data, extension=".png"), g16)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode(data)


def test_png_refuses_what_it_cannot_read():
    good = png.encode(_image((4, 5, 3)))
    with pytest.raises(ValueError, match="signature"):
        png.decode(b"GIF89a" + good[6:])
    with pytest.raises(ValueError, match="CRC"):
        png.decode(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    rows = bytes(4 * (1 + 5 * 3))
    for ihdr, match in (((5, 4, 8, 2, 0, 0, 1), "interlaced"),
                        ((5, 4, 4, 0, 0, 0, 0), "bit depth"),
                        ((5, 4, 8, 5, 0, 0, 0), "header")):
        with pytest.raises(ValueError, match=match):
            png.decode(_png_file(struct.pack(">IIBBBBB", *ihdr), rows))
    with pytest.raises(ValueError, match="holds"):
        png.decode(_png_file(struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0),
                             rows[:-1]))
    with pytest.raises(ValueError, match="uint8"):
        png.encode(np.zeros((2, 2), np.float32))


def test_non_png_images_need_imageio(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *a, **k):
        if name.startswith("imageio"):
            raise ImportError("No module named 'imageio'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imageio)
    with pytest.raises(ImportError, match="needs imageio"):
        png.read(str(tmp_path / "a.jpg"))


# ---- scenes on disk, read by both loaders -------------------------------------


def _cfg_kw(dataset, threshold=0.1, **kw):
    return dict(dataset=dataset, index=0, channels=3, event_width=W,
                event_height=H, rgb_fx=FOCAL, rgb_fy=FOCAL, rgb_cx=W / 2,
                rgb_cy=H / 2, rgb_width=W, rgb_height=H, event_fx=FOCAL,
                event_fy=FOCAL, event_cx=W / 2, event_cy=H / 2,
                event_threshold=threshold, event_shift_start=0,
                event_shift_end=0, **kw)


def _write_images(d, n, gt):
    rng = np.random.default_rng(5)
    for sub in (["images", "images_test"] if gt else ["images"]):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i in range(n):
            imwrite(os.path.join(d, sub, f"{i:03d}.png"),
                    (rng.random((12, 16, 3)) * 255).astype(np.uint8))


def _tum_vie(d):
    h5py = pytest.importorskip("h5py")
    _write_images(d, 2, gt=False)
    rng = np.random.default_rng(2)
    n = 600
    t = np.sort(rng.integers(0, 1_000_000, n)).astype(np.float64)  # us, ties
    os.makedirs(os.path.join(d, "events"), exist_ok=True)
    with h5py.File(os.path.join(d, "events", "events.h5"), "w") as f:
        g = f.create_group("events")
        g.create_dataset("x", data=rng.integers(0, 16, n))
        g.create_dataset("y", data=rng.integers(0, 12, n))
        g.create_dataset("t", data=t)
        g.create_dataset("p", data=rng.integers(0, 2, n))
    np.savetxt(os.path.join(d, "image_timestamps.txt"), [400_000.0, 700_000.0])
    np.savetxt(os.path.join(d, "image_exposures.txt"), [100_000.0, 100_000.0])


def _poses_bounds(d, rng):
    """poses_bounds(_cubic)(_events).npy: 4 LLFF poses (3x5 + 2 bounds)."""
    for suffix in ("", "_cubic"):
        for ev in ("", "_events"):
            R = np.linalg.qr(rng.normal(size=(4, 3, 3)))[0]
            t = rng.normal(size=(4, 3, 1))
            hwf = np.tile([[H], [W], [FOCAL]], (4, 1, 1))
            arr = np.concatenate([np.concatenate([R, t, hwf], -1).reshape(4, 15),
                                  rng.uniform(1, 5, (4, 2))], -1)
            np.save(os.path.join(d, f"poses_bounds{suffix}{ev}.npy"), arr)
    np.save(os.path.join(d, "trans.npy"), rng.normal(size=6) * 0.01)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """{name: (dir, port config kwargs)}: a BeNeRF_Blender scene by each
    package's writer (the port's also read as BeNeRF_Unreal, with loadpose
    and with loadtrans), the port's two E2NeRF writers and a TUM_VIE file."""
    root = tmp_path_factory.mktemp("scenes")
    out = {}
    for pkg, mod in (("port", tsynthetic), ("jax", jsynthetic)):
        d = str(root / f"blender_{pkg}")
        mod.write_benerf_blender_scene(d, n_images=1, **WRITER)
        out[f"blender_{pkg}"] = (d, _cfg_kw("BeNeRF_Blender"))
    d = out["blender_port"][0]
    _poses_bounds(d, np.random.default_rng(4))
    out["unreal"] = (d, _cfg_kw("BeNeRF_Unreal"))
    out["loadpose"] = (d, _cfg_kw("BeNeRF_Blender", loadpose=True))
    out["loadpose_cubic"] = (d, _cfg_kw("BeNeRF_Blender", loadpose=True,
                                        model="benerf_cubic"))
    out["loadtrans"] = (d, _cfg_kw("BeNeRF_Blender", loadtrans=True))
    d = str(root / "e2syn")
    tsynthetic.write_e2nerf_synthetic_scene(d, **WRITER)
    out["e2nerf_synthetic"] = (d, _cfg_kw("E2NeRF_Synthetic", 0.2))
    d = str(root / "e2real")
    tsynthetic.write_e2nerf_real_scene(d, **WRITER)
    out["e2nerf_real"] = (d, _cfg_kw("E2NeRF_Real", -1.0))
    d = str(root / "tumvie")
    _tum_vie(d)
    out["tum_vie"] = (d, {**_cfg_kw("TUM_VIE"), "event_width": 16,
                          "event_height": 12})
    return out


def _assert_same_events(te, je):
    """Equal time order; within each equal-time group the same
    (pixel, polarity) multiset."""
    ts, jts = te.ts.numpy(), np.asarray(je.ts)
    np.testing.assert_array_equal(ts, jts)
    pix, pol = te.pix_idx.numpy(), te.pol.numpy()
    jpix, jpol = np.asarray(je.pix_idx), np.asarray(je.pol)
    key, jkey = np.lexsort((pol, pix, ts)), np.lexsort((jpol, jpix, jts))
    np.testing.assert_array_equal(pix[key], jpix[jkey])
    np.testing.assert_array_equal(pol[key], jpol[jkey])


@pytest.mark.parametrize("name", [
    "blender_port", "unreal", "loadpose", "loadpose_cubic", "loadtrans",
    "e2nerf_synthetic", "e2nerf_real", "tum_vie"])
def test_loader_matches_jax(scenes, name):
    d, kw = scenes[name]
    ts = tdatasets.load_scene(d, TConfig(**kw), device="cpu")
    js = jdatasets.load_scene(d, JConfig(**kw))
    assert ts.events.num == js.events.num > 40
    assert ts.events.pix_idx.dtype == torch.int64
    _assert_same_events(ts.events, js.events)
    for field in ("image", "imgtest", "rgb_exp_ts", "poses", "ev_poses",
                  "trans", "gt_knots", "gt_exp_us", "gt_plane_depth"):
        a, b = getattr(ts, field), getattr(js, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), field)
    if kw.get("loadpose"):
        assert ts.poses.shape == ((4 if "model" in kw else 2), 3, 5)
    if kw.get("loadtrans"):
        assert ts.trans.shape == (6,)


def test_load_scene_puts_events_on_the_card_unless_asked(scenes, monkeypatch):
    d, kw = scenes["blender_port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdatasets.load_scene(d, TConfig(**kw))


# ---- raw ingest, host-side event helpers, geometry ----------------------------


def _raw_stream(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    # integer times: many ties, so the sort's stability shows
    return (rng.integers(0, W, n).astype(np.float64),
            rng.integers(0, H, n).astype(np.float64),
            rng.integers(0, 400, n).astype(np.float64),
            rng.choice([-1.0, 1.0], n))


def test_prepare_raw_equals_the_jax_numpy_branch_bit_for_bit(monkeypatch):
    x, y, t, p = _raw_stream()
    monkeypatch.setattr(_native, "_load", lambda: None)
    want = _native.prepare_events(x, y, t, p, W, 50.0, 350.0)
    got = tevents.prepare_raw(x, y, t, p, W, 50.0, 350.0, device="cpu")
    np.testing.assert_array_equal(got.pix_idx.numpy(), want[0])
    np.testing.assert_array_equal(got.ts.numpy(), want[1])
    np.testing.assert_array_equal(got.pol.numpy(), want[2])
    assert got.ts.dtype == torch.float32 and got.pix_idx.dtype == torch.int64


def test_prepare_raw_matches_the_jax_ingest_as_multisets():
    x, y, t, p = _raw_stream(seed=1)
    _assert_same_events(
        tevents.prepare_raw(x, y, t, p, W, 50.0, 350.0, device="cpu"),
        jevents.prepare_raw(x, y, t, p, W, 50.0, 350.0))


def test_polarity_image_and_accumulation_match_jax():
    x, y, _, p = _raw_stream(seed=2)
    np.testing.assert_array_equal(tevents.polarity_image(x, y, p, H, W),
                                  jevents.polarity_image(x, y, p, H, W))
    np.testing.assert_array_equal(
        tevents.accumulate_events_numpy(x, y, p, H, W),
        jevents.accumulate_events_numpy(x, y, p, H, W))


def test_event_slicer_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(6)
    n = 2000
    t = np.sort(rng.integers(0, 50_000, n))  # us
    path = str(tmp_path / "ev.h5")
    with h5py.File(path, "w") as f:
        for k, v in (("t", t), ("x", rng.integers(0, W, n)),
                     ("y", rng.integers(0, H, n)), ("p", rng.integers(0, 2, n))):
            f.create_dataset(f"events/{k}", data=v)
        f.create_dataset("ms_to_idx", data=np.searchsorted(
            t, np.arange(0, 51) * 1000, side="left"))
        f.create_dataset("t_offset", data=7_000)
    with h5py.File(path, "r") as f:
        a, b = tevents.EventSlicer(f), jevents.EventSlicer(f)
        assert a.get_final_time_us() == b.get_final_time_us()
        assert a.get_start_time_us() == b.get_start_time_us() == 7_000
        for lo, hi in ((7_000, 9_500), (12_345, 31_000), (50_000, 56_999),
                       (3_000, 9_000), (40_000, 90_000)):
            ga, gb = a.get_events(lo, hi), b.get_events(lo, hi)
            assert (ga is None) == (gb is None), (lo, hi)
            if ga is not None:
                for k in "pxyt":
                    np.testing.assert_array_equal(ga[k], gb[k])
        with pytest.raises(ValueError, match="empty window"):
            a.get_events(9_000, 9_000)


def test_camera_paths_match_jax():
    rng = np.random.default_rng(8)
    R = np.linalg.qr(rng.normal(size=(6, 3, 3)))[0]
    poses = np.concatenate([R, rng.normal(size=(6, 3, 1)),
                            np.tile([[H], [W], [FOCAL]], (6, 1, 1))], -1)
    bounds = rng.uniform(1.0, 6.0, (6, 2))
    np.testing.assert_array_equal(tpaths.recenter_poses(poses),
                                  jpaths.recenter_poses(poses))
    for kw in ({}, {"spherify": True}, {"path_zflat": True}):
        np.testing.assert_array_equal(
            tpaths.regenerate_pose(poses, bounds, **kw),
            jpaths.regenerate_pose(poses, bounds, **kw))
    for a, b in zip(tpaths.spherify_path(poses, bounds),
                    jpaths.spherify_path(poses, bounds)):
        np.testing.assert_array_equal(a, b)
    assert tdatasets.recenter_poses is tpaths.recenter_poses


def test_undistort_luts_match_jax():
    K = np.array([[320.0, 0, 64.0], [0, 320.0, 48.0], [0, 0, 1.0]])
    D = np.array([-0.05, 0.01, -0.002, 0.0005])
    newton = tundistort.undistort_lut(128, 96, K, D, use_opencv=False)
    np.testing.assert_array_equal(
        newton, jundistort.undistort_lut(128, 96, K, D, use_opencv=False))
    cfg = _cfg_kw("TUM_VIE", rgb_dist=[-0.02, 0, 0, 0],
                  event_dist=[-0.02, 0, 0, 0])
    for a, b in zip(tundistort.luts_for_config(TConfig(**cfg)),
                    jundistort.luts_for_config(JConfig(**cfg))):
        np.testing.assert_array_equal(a, b)
    assert tundistort.luts_for_config(TConfig()) == (None, None)
    pytest.importorskip("cv2")
    cv = tundistort.undistort_lut(128, 96, K, D, use_opencv=True)
    np.testing.assert_array_equal(
        cv, jundistort.undistort_lut(128, 96, K, D, use_opencv=True))
    assert np.max(np.abs(newton - cv)) < 1e-2


# ---- the synthetic writer ------------------------------------------------------


def test_writer_matches_jax(scenes):
    """Same seed, same scene: the spline is fp32 in both packages but its
    operations run in another order, so knots and frames agree to fp32
    rounding; a threshold crossing may flip, so events are compared by
    count (measured: equal counts at this size)."""
    dt, dj = scenes["blender_port"][0], scenes["blender_jax"][0]
    gt_t, gt_j = np.load(f"{dt}/gt_trajectory.npz"), np.load(f"{dj}/gt_trajectory.npz")
    np.testing.assert_allclose(gt_t["knots"], gt_j["knots"], rtol=KNOT_RTOL)
    for k in ("t_lo", "t_hi", "plane_depth"):
        assert gt_t[k] == gt_j[k]
    for sub in ("images", "images_test"):
        np.testing.assert_array_equal(imread(f"{dt}/{sub}/000.png"),
                                      imread(f"{dj}/{sub}/000.png"))
    np.testing.assert_array_equal(np.loadtxt(f"{dt}/poses_ts.txt"),
                                  np.loadtxt(f"{dj}/poses_ts.txt"))
    ev_t, ev_j = np.load(f"{dt}/events/events.npy"), np.load(f"{dj}/events/events.npy")
    assert abs(len(ev_t) - len(ev_j)) <= 0.01 * len(ev_j)
    assert np.all(np.diff(ev_t[:, 2]) >= 0)
    with open(f"{dt}/scene_meta.json") as a, open(f"{dj}/scene_meta.json") as b:
        assert json.load(a) == json.load(b)


def test_writer_frames_and_knots_match_jax_to_fp32_rounding():
    K = np.array([[FOCAL, 0, W / 2], [0, FOCAL, H / 2], [0, 0, 1]])
    kt = tsynthetic.calibrated_trajectory(3, K)
    kj = jsynthetic.calibrated_trajectory(3, K)
    # the rescale by target / sweep carries the sweep's fp32 rounding into
    # every knot, twice (measured 1.05e-6 relative for this seed)
    np.testing.assert_allclose(kt, kj, rtol=KNOT_RTOL)
    scene = tsynthetic.make_scene(3)
    us = np.linspace(0.0, 1.0, 3)
    poses = tsynthetic._spline_poses(kj, us)
    import jax.numpy as jnp
    from benerf_tpu.geometry import spline as jspline

    jposes = np.asarray(jspline.cubic_bspline_pose(jnp.asarray(kj), jnp.asarray(us)))
    np.testing.assert_allclose(poses, jposes, rtol=0, atol=2e-7)
    ft = tsynthetic.render_frame(scene, poses[1], 12, 16, K, n_samples=32)
    fj = jsynthetic.render_frame(jsynthetic.make_scene(3), jposes[1], 12, 16, K,
                                 n_samples=32)
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-5)


# ---- pose init -------------------------------------------------------------------


def test_initial_knots_match_jax(scenes):
    d, kw = scenes["blender_port"]
    kw = {**kw, "pose_init": "motion_scale", "seed": 3}
    kt, dt = tpose_init.initial_knots(
        TConfig(**kw), tdatasets.load_scene(d, TConfig(**kw), device="cpu"))
    kj, dj = jpose_init.initial_knots(JConfig(**kw),
                                      jdatasets.load_scene(d, JConfig(**kw)))
    assert dt == pytest.approx(dj, rel=1e-12) and dt > 0.5
    assert kt.dtype == np.float32
    np.testing.assert_allclose(kt, kj, rtol=1e-6, atol=0)
    assert tpose_init._max_angle(kt) == pytest.approx(dt / FOCAL, rel=2e-2)
