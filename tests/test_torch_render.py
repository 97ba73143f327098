"""PyTorch port's rays / NDC / compositing / inverse-CDF sampling and the
hierarchical renderer vs the JAX package and the golden fixtures.

Random draws are injected (stratification uniforms, pdf uniforms, sigma
noise) so both frameworks evaluate the same function; torch.Generator
streams are only checked for properties (ranges, ordering, joint == split).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benerf_tpu.models import nerf as jnerf
from benerf_tpu.render import pdf as jpdf
from benerf_tpu.render import rays as jrays
from benerf_tpu.render import renderer as jrenderer
from benerf_tpu.render import volume as jvolume
from benerf_tpu_torch.models import bridge
from benerf_tpu_torch.render import pdf as tpdf
from benerf_tpu_torch.render import rays as trays
from benerf_tpu_torch.render import renderer as trenderer
from benerf_tpu_torch.render import volume as tvolume


def _t(x):
    return torch.as_tensor(np.array(x))


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _pose(rng, n):
    """(n, 3, 4) camera-to-world poses near identity, 1 unit back on z."""
    from benerf_tpu.geometry import se3 as jse3

    wu = rng.normal(scale=0.05, size=(n, 6)).astype(np.float32)
    Rt = np.array(jse3.se3_to_SE3(jnp.asarray(wu)))
    Rt[:, 2, 3] += 1.0
    return Rt


K_NP = np.array([[50.0, 0.0, 30.0], [0.0, 52.0, 20.0], [0.0, 0.0, 1.0]],
                np.float32)


def test_golden_rays_ndc_composite_pdf(golden):
    ro, rd = trays.rays_for_pixels(_t(golden["rays_i"]), _t(golden["rays_j"]),
                                   _t(golden["rays_K"]), _t(golden["rays_c2w"]))
    np.testing.assert_allclose(ro.numpy(), golden["rays_o"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(rd.numpy(), golden["rays_d"], rtol=0, atol=1e-5)
    o, d = trays.ndc_rays(400, 600, 541.850232, 1.0, _t(golden["ndc_ro_in"]),
                          _t(golden["ndc_rd_in"]))
    np.testing.assert_allclose(o.numpy(), golden["ndc_ro_out"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), golden["ndc_rd_out"], rtol=0, atol=1e-5)
    out = tvolume.composite(_t(golden["comp_raw"]), _t(golden["comp_z"]),
                            _t(golden["comp_raysd"]), channels=3, noise_std=0.0)
    for k, g, atol in (("rgb_map", "comp_rgb_map", 1e-5),
                       ("disp_map", "comp_disp", 1e-4),
                       ("acc_map", "comp_acc", 1e-5),
                       ("weights", "comp_weights", 1e-5),
                       ("depth_map", "comp_depth", 1e-5),
                       ("sigma", "comp_sigma", 1e-5)):
        np.testing.assert_allclose(out[k].numpy(), golden[g], rtol=0, atol=atol,
                                   err_msg=k)
    s = tpdf.sample_pdf(_t(golden["pdf_bins"]), _t(golden["pdf_weights"]), 64,
                        u=_t(golden["pdf_u"]))
    np.testing.assert_allclose(s.numpy(), golden["pdf_samples"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("remap", [False, True])
def test_rays_from_flat_idx_and_ndc_match_jax(remap):
    rng = np.random.default_rng(1)
    H, W, n = 40, 60, 33
    idx = rng.choice(H * W, n, replace=False)
    c2w = _pose(rng, n)
    lut = (rng.random((H * W, 2)) * [W, H]).astype(np.float32) if remap else None
    ro_j, rd_j = jrays.rays_from_flat_idx(
        jnp.asarray(idx), W, jnp.asarray(K_NP), jnp.asarray(c2w),
        None if lut is None else jnp.asarray(lut))
    ro_t, rd_t = trays.rays_from_flat_idx(
        _t(idx), W, _t(K_NP), _t(c2w), None if lut is None else _t(lut))
    np.testing.assert_allclose(ro_t.numpy(), np.asarray(ro_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(rd_t.numpy(), np.asarray(rd_j), rtol=0, atol=1e-6)
    o_j, d_j = jrays.ndc_rays(H, W, 50.0, 1.0, ro_j, rd_j)
    o_t, d_t = trays.ndc_rays(H, W, 50.0, 1.0, ro_t, rd_t)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("C", [1, 3])
def test_composite_with_injected_noise_matches_jax(C):
    rng = np.random.default_rng(C)
    R, S = 9, 16
    raw = rng.normal(size=(R, S, C + 1)).astype(np.float32)
    z = np.sort(rng.random((R, S)), axis=-1).astype(np.float32)
    rd = rng.normal(size=(R, 3)).astype(np.float32)
    noise = rng.normal(size=(R, S)).astype(np.float32)

    def jfn(raw_):
        out = jvolume.composite(raw_, jnp.asarray(z), jnp.asarray(rd), C,
                                noise=jnp.asarray(noise))
        return jnp.sum(out["rgb_map"]) + jnp.sum(out["disp_map"] * 1e-3), out

    (_, want), gj = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(raw))
    raw_t = _t(raw).requires_grad_(True)
    got = tvolume.composite(raw_t, _t(z), _t(rd), C, noise=_t(noise))
    (gt,) = torch.autograd.grad(
        torch.sum(got["rgb_map"]) + torch.sum(got["disp_map"] * 1e-3), raw_t)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-5)
    # a generator turns the sigma noise on; no generator leaves it off
    a = tvolume.composite(_t(raw), _t(z), _t(rd), C, generator=_gen(0))
    b = tvolume.composite(_t(raw), _t(z), _t(rd), C)
    assert not torch.equal(a["sigma"], b["sigma"])


def test_stratified_z_matches_jax_and_bounds():
    t_rand = np.random.default_rng(2).random((7, 12)).astype(np.float32)
    want = np.asarray(jvolume.stratified_z(None, 7, 12, t_rand=jnp.asarray(t_rand)))
    got = tvolume.stratified_z(None, 7, 12, t_rand=_t(t_rand)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    z = tvolume.stratified_z(_gen(0), 100, 64).numpy()
    assert z.shape == (100, 64) and z.min() >= 0.0 and z.max() <= 1.0
    assert np.all(np.diff(z, axis=-1) > 0)
    zd = tvolume.stratified_z(None, 4, 8).numpy()
    np.testing.assert_allclose(zd[0], np.linspace(0, 1, 8), rtol=0, atol=1e-7)


@pytest.mark.parametrize("inject", [True, False])
def test_sample_pdf_matches_jax(inject):
    rng = np.random.default_rng(3)
    bins = np.sort(rng.random((6, 33)), axis=-1).astype(np.float32)
    w = rng.random((6, 32)).astype(np.float32)
    w[0] = 0.0  # a ray with no mass: uniform pdf from the 1e-5 floor
    u = rng.random((6, 40)).astype(np.float32) if inject else None
    want = np.asarray(jpdf.sample_pdf(jnp.asarray(bins), jnp.asarray(w), 40,
                                      u=None if u is None else jnp.asarray(u)))
    got = tpdf.sample_pdf(_t(bins), _t(w), 40,
                          u=None if u is None else _t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sample_pdf_sorted_draws_ascending_in_range():
    bins = torch.linspace(0.0, 1.0, 17).expand(256, 17)
    w = torch.rand((256, 16), generator=_gen(0)) + 0.1
    s_sorted = tpdf.sample_pdf(bins, w, 64, generator=_gen(1), sorted_draws=True)
    s_iid = tpdf.sample_pdf(bins, w, 64, generator=_gen(2))
    assert torch.all(torch.diff(s_sorted, dim=-1) >= 0)
    assert s_sorted.min() >= 0.0 and s_sorted.max() <= 1.0
    h1, _ = np.histogram(s_sorted.numpy(), bins=20, range=(0, 1))
    h2, _ = np.histogram(s_iid.numpy(), bins=20, range=(0, 1))
    assert np.max(np.abs(h1 - h2) / np.maximum(np.sqrt(h1 + h2), 1)) < 6.0


def test_merge_sorted_equals_sort_of_concat():
    a = torch.sort(torch.rand((17, 64), generator=_gen(3)), -1).values
    b = torch.sort(torch.rand((17, 64), generator=_gen(4)), -1).values
    ref = torch.sort(torch.cat([a, b], -1), -1).values
    assert torch.equal(tpdf.merge_sorted(a, b), ref)
    a2 = torch.tensor([[0.0, 0.5, 0.5, 1.0]])
    b2 = torch.tensor([[0.5, 0.5, 2.0]])
    assert torch.equal(tpdf.merge_sorted(a2, b2),
                       torch.sort(torch.cat([a2, b2], -1), -1).values)
    jm = np.asarray(jpdf.merge_sorted(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
    np.testing.assert_array_equal(tpdf.merge_sorted(a, b).numpy(), jm)


def _small_mlps(C, seed=0):
    """Coarse and fine MLPs, 6 layers of width 64 (skip at layer 5)."""
    return [jax.tree.map(np.asarray, jnerf.init_params(
        jax.random.PRNGKey(seed + i), depth=6, width=64, channels=C))
        for i in range(2)]


def _families(rng, C, S, N):
    """Two pose-major families with different cameras and ray counts, and
    their injected draws."""
    specs = []
    for P, R, H, W in ((2, 5, 10, 14), (3, 4, 12, 16)):
        n = P * R
        specs.append(dict(
            poses=_pose(rng, P), ray_idx=rng.choice(H * W, R, replace=False),
            K=K_NP, H=H, W=W, remap=None,
            keys={"z_u": rng.random((n, S)).astype(np.float32),
                  "pdf_u": rng.random((n, N)).astype(np.float32),
                  "noise_c_vals": rng.normal(size=(n, S)).astype(np.float32),
                  "noise_f_vals": rng.normal(size=(n, S + N)).astype(np.float32)}))
    return specs


# (C, barf, rtol of the per-ray maps, gradient bound as relative RMS), each
# a few times the measured distance between the two fp32 results. With
# C = 3 this draw puts fine samples on flat stretches of the CDF, where
# sample_pdf magnifies rounding: there JAX's fp32 gradients sit 0.8% and the
# port's 2.1% (RMS) from a float64 run of the port, its maps up to 2e-4, and
# the two fp32 results 2.3% and 1.2e-3 from each other. The C = 1 case is
# well conditioned (5e-6 apart).
RENDER_CASES = [(3, False, 5e-3, 5e-2), (1, True, 1e-4, 1e-5)]


@pytest.mark.parametrize("C,barf,out_rtol,grad_rel", RENDER_CASES)
def test_render_pose_families_matches_jax(C, barf, out_rtol, grad_rel):
    """The training-path render, outputs and gradients w.r.t. the poses and
    the MLP weights, with every random draw injected."""
    S, N = 8, 8
    rng = np.random.default_rng(10 + C)
    pc, pf = _small_mlps(C)
    specs = _families(rng, C, S, N)
    kw = dict(n_samples=S, n_importance=N, channels=C, use_barf_c2f=barf,
              max_iter=1000)
    js = jrenderer.RenderSettings(use_pallas=False, **kw)
    ts = trenderer.RenderSettings(**kw)

    def jfn(pc_, pf_, poses):
        fams = [dict(s, poses=p, ray_idx=jnp.asarray(s["ray_idx"]),
                     K=jnp.asarray(s["K"]),
                     keys={k: jnp.asarray(v) for k, v in s["keys"].items()})
                for s, p in zip(specs, poses)]
        outs = jrenderer.render_pose_families_with_ray_idx(
            pc_, pf_, fams, js, step=300)
        loss = sum(jnp.sum(o["rgb_map"] ** 2) + jnp.sum(o["rgb0"]) for o in outs)
        return loss, outs

    (_, jouts), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, pc), jax.tree.map(jnp.asarray, pf),
        [jnp.asarray(s["poses"]) for s in specs])

    tpc, tpf = bridge.params_from_numpy(pc, device="cpu"), bridge.params_from_numpy(pf, device="cpu")
    leaves = bridge.tree_leaves(tpc) + bridge.tree_leaves(tpf)
    for t in leaves:
        t.requires_grad_(True)
    poses = [_t(s["poses"]).requires_grad_(True) for s in specs]
    touts = trenderer.render_pose_families_with_ray_idx(
        tpc, tpf,
        [dict(s, poses=p, ray_idx=_t(s["ray_idx"]), K=_t(s["K"]),
              keys={k: _t(v) for k, v in s["keys"].items()})
         for s, p in zip(specs, poses)], ts, step=300)
    loss = sum(torch.sum(o["rgb_map"] ** 2) + torch.sum(o["rgb0"]) for o in touts)
    tgrads = torch.autograd.grad(loss, leaves + poses)

    # the per-sample fine sigma also sees the sample positions' rounding
    # times the 2^9 frequency of the encoding: atol 1e-2
    for jo, to in zip(jouts, touts):
        assert set(jo) == set(to)
        for k in jo:
            np.testing.assert_allclose(
                to[k].detach().numpy(), np.asarray(jo[k]), rtol=out_rtol,
                atol=1e-2 if k == "sigma" else 1e-4, err_msg=k)
    want = (bridge.tree_leaves(jax.tree.map(np.asarray, jgrads[0]))
            + bridge.tree_leaves(jax.tree.map(np.asarray, jgrads[1]))
            + [np.asarray(g) for g in jgrads[2]])
    assert len(want) == len(tgrads)
    rms = lambda x: float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))
    for got, w in zip(tgrads, want):
        err = rms(got.numpy().astype(np.float64) - w)
        assert err <= grad_rel * max(rms(w), 1e-30), (w.shape, err, rms(w))


def test_joint_family_render_matches_separate():
    """One coarse + one fine MLP call over both families gives each family
    what rendering it alone gives, on the generator (merge) path too."""
    pc, pf = [bridge.params_from_numpy(p, device="cpu") for p in _small_mlps(3, seed=5)]
    settings = trenderer.RenderSettings(n_samples=8, n_importance=8, channels=3)
    rng = np.random.default_rng(6)

    def fam(i, R, H, W, focal):
        rd = rng.normal(size=(R, 3)) * 0.05 + [0.0, 0.0, -1.0]
        return dict(rays_o=torch.tensor([[0.0, 0.0, 1.0]]).expand(R, 3),
                    rays_d=_t(rd.astype(np.float32)), H=H, W=W, focal=focal,
                    seeds=[10 * i + k for k in range(4)])

    def with_keys(f):
        return dict(f, keys={k: _gen(s) for k, s in
                             zip(("z", "pdf", "noise_c", "noise_f"), f["seeds"])})

    f0, f1 = fam(1, 24, 40, 40, 50.0), fam(2, 17, 30, 50, 70.0)
    joint = trenderer.render_ray_families(pc, pf, [with_keys(f0), with_keys(f1)],
                                          settings)
    for f, j in zip((f0, f1), joint):
        (solo,) = trenderer.render_ray_families(pc, pf, [with_keys(f)], settings)
        assert set(j) == set(solo)
        for k in j:
            # disp is 0/0 = NaN on a ray with no density, as in the reference
            torch.testing.assert_close(j[k], solo[k], rtol=0, atol=1e-6,
                                       equal_nan=True)
    assert torch.all(torch.isfinite(joint[0]["rgb_map"]))
