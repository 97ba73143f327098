"""The BeNeRF train step: event window + ETA, spline poses, both ray
families' coarse+fine render, both losses, backward, five Adam groups.

Port of benerf_tpu/train/step.py. The loss keeps the JAX package's split:
loss_fn(params, batch, draws, step) is a pure function of the `draws` dict,
and draw_fn(generators) makes that dict from the step's torch.Generators,
so parity tests inject recorded draws and compare loss and gradients
through the production code path. The JAX package's jit of one step is an
eager call here (make_train_step); its lax.scan of several steps per
dispatch (make_multi_step) is a CUDA graph of one step, replayed.

Under a mesh (parallel/mesh.py `RayMesh`; every function here takes
`mesh=None`, as the JAX package's do) every rank makes the step's global
draws from the same generators, keeps its block of each family's pixels
and the rows of those pixels at every pose, and renders them; each loss
term is its share of the global term (train/loss.py). One all-reduce of
one flat buffer then sums every gradient, the per-term knot gradients and
the loss metrics over the ranks before the grad norms and Adam, so the
ranks' parameters stay equal and the step computes what the unsharded one
does from the same draws.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from benerf_tpu_torch import resolve_device
from benerf_tpu_torch.core import profiling
from benerf_tpu_torch.core import rng as rng_mod
from benerf_tpu_torch.data import events as events_mod
from benerf_tpu_torch.geometry import spline as spline_mod
from benerf_tpu_torch.models import crf as crf_mod
from benerf_tpu_torch.models import nerf as nerf_mod
from benerf_tpu_torch.models.bridge import tree_leaves
from benerf_tpu_torch.ops import mlp as mlp_ops
from benerf_tpu_torch.parallel import mesh as mesh_mod
from benerf_tpu_torch.render import pdf as pdf_mod
from benerf_tpu_torch.render import renderer as renderer_mod
from benerf_tpu_torch.render import volume as volume_mod
from benerf_tpu_torch.train import loss as loss_mod
from benerf_tpu_torch.train import optim as optim_mod


class SceneBatch(NamedTuple):
    """Device-resident training data for one scene (static across steps)."""

    events: events_mod.EventArrays
    image_flat: torch.Tensor   # (H*W, C) observed blurry image
    rgb_exp_ts: torch.Tensor   # (2,) normalized exposure interval
    K_rgb: torch.Tensor        # (3,3)
    K_evt: torch.Tensor        # (3,3)
    img_remap: Optional[torch.Tensor] = None  # (H*W, 2) undistort LUT
    evt_remap: Optional[torch.Tensor] = None


class TrainState(NamedTuple):
    params: Any                  # dict of collections of leaf tensors
    optimizer: torch.optim.Optimizer
    step: int


def build_params(cfg, seed: int = 0, init_knots=None, init_transform=None,
                 device=None):
    """All trainable collections (reference Model.build_network): knots ~
    U(0, 0.01), transform = 0, NeRF MLPs Xavier/zero, CRFs Xavier with zero
    (rgb) / one (event) biases. Every leaf requires grad. device: "cuda"
    unless given; with no device and no card this raises.

    As in the JAX package, the NeRF MLPs take the default encoding widths
    (63 / 27 rows) whatever cfg.multires / multires_views say; a caller
    with other encodings builds its MLPs with nerf.init_params and passes
    them to init_state."""
    device = resolve_device(device)
    if init_knots is not None and tuple(torch.as_tensor(init_knots).shape) != (4, 6):
        raise ValueError(
            "init_knots must be (4, 6) se(3) knots, got shape "
            f"{tuple(torch.as_tensor(init_knots).shape)} (loadpose hands over "
            "(n, 3, 5) poses; their conversion to knots is not implemented)")
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    params = {
        "nerf": nerf_mod.init_params(g, depth=cfg.netdepth, width=cfg.netwidth,
                                     channels=cfg.channels, device=device),
        "nerf_fine": nerf_mod.init_params(g, depth=cfg.netdepth_fine,
                                          width=cfg.netwidth_fine,
                                          channels=cfg.channels, device=device),
        # copies: the optimizer updates the leaves in place
        "knots": (torch.as_tensor(init_knots, dtype=torch.float32,
                                  device=device).clone()
                  if init_knots is not None
                  else torch.rand((4, 6), generator=g, device=device) * 0.01),
        "transform": (torch.as_tensor(init_transform, dtype=torch.float32,
                                      device=device).reshape(6).clone()
                      if init_transform is not None
                      else torch.zeros((6,), device=device)),
        "rgb_crf": crf_mod.init_params(g, cfg.rgb_crf_net_hidden,
                                       cfg.rgb_crf_net_width, bias_init=0.0,
                                       device=device),
        "event_crf": crf_mod.init_params(g, cfg.event_crf_net_hidden,
                                         cfg.event_crf_net_width,
                                         bias_init=1.0, device=device),
    }
    for t in tree_leaves(params):
        t.requires_grad_(True)
    return params


def init_state(cfg, seed: int = 0, device=None, params=None, **kw) -> TrainState:
    """The state at step 0: the caller's `params`, or build_params' on
    `device` (see there)."""
    if params is None:
        params = build_params(cfg, seed, device=device, **kw)
    return TrainState(params, optim_mod.build_optimizer(cfg, params), 0)


def _apply_crf(crf_params, x):
    """Elementwise 1->1 CRF applied per channel."""
    return crf_mod.apply(crf_params, x.reshape(-1, 1)).reshape(x.shape)


# metrics every rank computes whole; the others are the ranks' partial sums
REPLICATED_METRICS = ("eta_window_overflow",)


def make_loss_fn(cfg, H: int, W: int, mesh=None):
    """(loss_fn, draw_fn) for one iteration.

    loss_fn(params, batch, draws, step) -> (total, metrics);
    draw_fn(generators) -> draws (step_generators' dict in, window bounds,
    ray subsets and per-family generators out). The draws are global under
    a mesh too: loss_fn takes this rank's share of them, and its total and
    metrics (but REPLICATED_METRICS) are this rank's share of the global
    ones.
    """
    settings = renderer_mod.RenderSettings.from_config(cfg)
    H_evt, W_evt = cfg.event_height, cfg.event_width
    hw_rgb, hw_evt = H * W, H_evt * W_evt
    n_evt_rays = cfg.sampling_event_rays
    n_rgb_rays = cfg.sampling_rgb_rays // cfg.num_interpolated_pose
    n_poses = cfg.num_interpolated_pose

    if mesh is not None:
        n_dev = mesh.size
        if (2 * n_evt_rays) % n_dev:  # the JAX package's check and message
            need = n_dev // math.gcd(2, n_dev)
            raise ValueError(
                f"sampling_event_rays={n_evt_rays} gives {2 * n_evt_rays} "
                f"event-render rays, not divisible by the {n_dev}-device "
                f"mesh — choose a multiple of {need}"
            )
        if min(n_evt_rays, n_rgb_rays) < n_dev:
            raise ValueError(
                f"{n_evt_rays} event and {n_rgb_rays} rgb pixels a step "
                f"cannot give each of the {n_dev} ranks one of each")

    def family_rows(keys, poses, n_pix, dtype, device):
        """This rank's rows of a family's per-row draws, which are pose-major
        over `poses` x n_pix global rows: injected values as given, else
        drawn whole from the family's generators as the renderer would draw
        them (the sorted fine-sample draws marked so)."""
        rows, S, N = poses * n_pix, settings.n_samples, settings.n_importance
        if "z_u" in keys:
            vals = dict(keys)
        else:
            vals = {"z_u": volume_mod.stratified_draws(keys["z"], rows, S,
                                                       device, dtype)}
            if N > 0:
                vals["pdf_u"] = pdf_mod.sorted_uniforms(keys["pdf"], (rows,),
                                                        N, device, dtype)
            std = settings.sigma_noise_std
            if std > 0.0:
                vals["noise_c_vals"] = volume_mod.sigma_noise(
                    keys["noise_c"], (rows, S), std, device, dtype)
                vals["noise_f_vals"] = volume_mod.sigma_noise(
                    keys["noise_f"], (rows, S + N), std, device, dtype)
        out = {k: mesh_mod.shard_rows(v.reshape(poses, n_pix, -1), mesh,
                                      dim=1).reshape(-1, v.shape[-1])
               for k, v in vals.items()}
        if "z_u" not in keys:
            out["pdf_u_sorted"] = True
        return out

    def rand_subset(g, n, k):
        """k distinct pixel indices out of n: a slice of a uniform
        permutation (reference randperm), or with fast_ray_sampling the
        top-k of iid uniforms."""
        if cfg.fast_ray_sampling:
            return torch.topk(torch.rand(n, generator=g, device=g.device), k).indices
        return torch.randperm(n, generator=g, device=g.device)[:k]

    def draw_fn(gens):
        draws = {}
        if cfg.event_time_window:
            draws["low_t"], draws["up_t"] = events_mod.sample_time_window(
                gens["window"], cfg.accumulate_time_length,
                cfg.random_sampling_window, device=gens["window"].device)
        else:
            draws["window_gen"] = gens["window"]
        draws["ray_idx_evt"] = rand_subset(gens["ray_evt"], hw_evt, n_evt_rays)
        draws["ray_idx_rgb"] = rand_subset(gens["ray_rgb"], hw_rgb, n_rgb_rays)
        for fam in ("evt", "rgb"):
            draws[f"keys_{fam}"] = {
                "z": gens[f"z_{fam}"], "pdf": gens[f"pdf_{fam}"],
                "noise_c": gens[f"noise_{fam}_c"],
                "noise_f": gens[f"noise_{fam}_f"],
            }
        return draws

    def loss_fn(params, batch: SceneBatch, draws, step):
        # 1. event window + ETA
        with profiling.span("step.window"):
            if cfg.event_time_window:
                low_t, up_t = draws["low_t"], draws["up_t"]
                eta, eta_overflow = events_mod.eta_time_window(
                    batch.events, hw_evt, low_t, up_t, cap=cfg.event_window_cap)
            else:
                eta, low_t, up_t = events_mod.eta_count_window(
                    batch.events, hw_evt, draws["window_gen"],
                    cfg.accumulate_time_length, cfg.random_sampling_window)
                eta_overflow = torch.zeros((), dtype=torch.int64,
                                           device=eta.device)

        # 2. spline poses, the event and the rgb knot sets in one pass; its
        # backward is the span spline.bwd
        knots = params["knots"]
        with profiling.span("spline.fwd"):
            bwd = profiling.backward_span("spline.bwd")
            knots_in, transform = bwd.inputs(knots, params["transform"])
            evt_poses, rgb_poses = spline_mod.interpolate_pose_sets(
                torch.stack([knots_in, knots_in + transform[None, :]]),
                [(low_t, up_t), (batch.rgb_exp_ts[0], batch.rgb_exp_ts[1])],
                [2, n_poses], cfg.traj)
            evt_poses, rgb_poses = bwd.outputs(evt_poses, rgb_poses)

        # 3-4. both families through one joint coarse+fine pass; under a
        # mesh this rank's pixels at every pose
        ray_idx_evt, ray_idx_rgb = draws["ray_idx_evt"], draws["ray_idx_rgb"]
        keys_evt, keys_rgb = draws["keys_evt"], draws["keys_rgb"]
        idx_evt_all = None
        if mesh is not None:
            idx_evt_all = ray_idx_evt
            with profiling.span("step.draws"):
                keys_evt = family_rows(keys_evt, 2, n_evt_rays, knots.dtype,
                                       knots.device)
                keys_rgb = family_rows(keys_rgb, n_poses, n_rgb_rays,
                                       knots.dtype, knots.device)
                ray_idx_evt = mesh_mod.shard_rows(ray_idx_evt, mesh)
                ray_idx_rgb = mesh_mod.shard_rows(ray_idx_rgb, mesh)
        with profiling.span("render.fwd"):
            ret_evt, ret_rgb = renderer_mod.render_pose_families_with_ray_idx(
                params["nerf"], params["nerf_fine"],
                [
                    dict(poses=evt_poses, ray_idx=ray_idx_evt, K=batch.K_evt,
                         H=H_evt, W=W_evt, keys=keys_evt,
                         remap=batch.evt_remap),
                    dict(poses=rgb_poses, ray_idx=ray_idx_rgb, K=batch.K_rgb,
                         H=H, W=W, keys=keys_rgb, remap=batch.img_remap),
                ],
                settings, step=step, mesh=mesh,
            )
        n_evt = ray_idx_evt.shape[0]
        with profiling.span("step.losses"):
            metrics = {}
            total = torch.zeros((), device=knots.device, dtype=knots.dtype)

            # 5. event loss on the window endpoints
            if cfg.event_loss:
                fine, coarse = ret_evt["rgb_map"], ret_evt["rgb0"]
                b1_f, b2_f = fine[:n_evt], fine[n_evt:]
                b1_c, b2_c = coarse[:n_evt], coarse[n_evt:]
                if cfg.optimize_event_crf:
                    b1_f, b2_f, b1_c, b2_c = (_apply_crf(params["event_crf"], b)
                                              for b in (b1_f, b2_f, b1_c, b2_c))
                eta_target = eta[ray_idx_evt][:, None]
                kw = dict(dataset=cfg.dataset, channels=cfg.channels,
                          event_threshold=cfg.event_threshold,
                          coeff_syn=cfg.event_coeff_syn,
                          coeff_real=cfg.event_coeff_real, mesh=mesh,
                          eta_all=(None if mesh is None
                                   else eta[idx_evt_all][:, None]))
                ev_fine = loss_mod.event_loss_term(b1_f, b2_f, eta_target,
                                                   **kw)
                ev_coarse = loss_mod.event_loss_term(b1_c, b2_c, eta_target,
                                                     **kw)
                metrics["event_loss_fine"] = ev_fine
                metrics["event_loss_coarse"] = ev_coarse
                metrics["event_loss"] = ev_fine + ev_coarse
                total = total + ev_fine + ev_coarse

            # 6. blur-synthesis rgb loss
            if cfg.rgb_loss:
                rgb_fine, rgb_coarse = ret_rgb["rgb_map"], ret_rgb["rgb0"]
                if cfg.optimize_rgb_crf:
                    rgb_fine = _apply_crf(params["rgb_crf"], rgb_fine)
                    rgb_coarse = _apply_crf(params["rgb_crf"], rgb_coarse)
                target = batch.image_flat[ray_idx_rgb]
                n_all = None if mesh is None else n_rgb_rays
                rgb_fine_l = loss_mod.blur_rgb_loss_term(rgb_fine, target,
                                                         cfg.rgb_coeff, n_all)
                rgb_coarse_l = loss_mod.blur_rgb_loss_term(rgb_coarse, target,
                                                           cfg.rgb_coeff, n_all)
                metrics["rgb_loss_fine"] = rgb_fine_l
                metrics["rgb_loss_coarse"] = rgb_coarse_l
                metrics["rgb_loss"] = rgb_fine_l + rgb_coarse_l
                total = total + rgb_fine_l + rgb_coarse_l

            metrics["eta_window_overflow"] = eta_overflow
            metrics["loss"] = total
        return total, metrics

    return loss_fn, draw_fn


def _make_body(cfg, H: int, W: int, mesh=None):
    """body(params, optimizer, batch, gens, step) -> metrics: one full
    iteration (draws from the generators `gens`, loss, backward, under a
    mesh the all-reduce, grad norms, Adam) with the optimizer's lrs already
    set for it. step: an int, or the 0-d tensor that a captured step
    advances on the card (BARF reads it)."""
    loss_fn, draw_fn = make_loss_fn(cfg, H, W, mesh)
    # per-term knot gradients (log_knot_grad_terms, diagnostics only):
    # (loss term, metric)
    terms = [(m, k) for on, m, k in (
        (cfg.event_loss, "event_loss", "knot_grad_event"),
        (cfg.rgb_loss, "rgb_loss", "knot_grad_rgb")) if on]

    def body(params, optimizer, batch, gens, step):
        with profiling.span("step.draws"):
            draws = draw_fn(gens)
        for t in tree_leaves(params):
            t.grad = None
        total, metrics = loss_fn(params, batch, draws, step)
        knot_grads = {}
        with profiling.span("step.backward"):
            if cfg.log_knot_grad_terms:
                # which loss steers the spline: each term's gradient w.r.t.
                # the knots from this step's graph, before the total's
                # backward
                for term, key in terms:
                    knot_grads[key], = torch.autograd.grad(
                        metrics[term], params["knots"], retain_graph=True)
            total.backward()
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mesh is not None:  # the step's one collective
                with profiling.span("step.exchange"):
                    mesh_mod.all_reduce_flat(
                        [t.grad for t in tree_leaves(params)
                         if t.grad is not None]
                        + list(knot_grads.values())
                        + [v for k, v in metrics.items()
                           if k not in REPLICATED_METRICS], mesh)
        with profiling.span("step.adam"):
            with torch.no_grad():
                metrics["grad_norm_knots"] = torch.linalg.norm(
                    params["knots"].grad)
                nerf_grads = [t.grad for c in ("nerf", "nerf_fine")
                              for t in tree_leaves(params[c])]
                metrics["grad_norm_nerf"] = torch.sqrt(
                    sum(torch.sum(g * g) for g in nerf_grads))
                metrics.update({k: torch.linalg.norm(g)
                                for k, g in knot_grads.items()})
            optimizer.step()
        return metrics

    return body


def make_train_step(cfg, H: int, W: int, mesh=None):
    """step_fn(state, batch, seed) -> (state, metrics): one full iteration,
    with its draws made from (seed, state.step); each metric a 0-d tensor,
    under a mesh the global one on every rank."""
    body = _make_body(cfg, H, W, mesh)

    def step_fn(state: TrainState, batch: SceneBatch, seed: int):
        gens = rng_mod.step_generators(seed, state.step,
                                       state.params["knots"].device)
        optim_mod.set_learning_rates(state.optimizer, state.step)
        with profiling.span("step", index=state.step):
            metrics = body(state.params, state.optimizer, batch, gens,
                           state.step)
        return TrainState(state.params, state.optimizer, state.step + 1), metrics

    return step_fn


def make_multi_step(cfg, H: int, W: int, n_inner: int, mesh=None,
                    spans: bool = False):
    """multi_fn(state, batch, seed) -> (state, metrics): n_inner iterations
    per dispatch, the counterpart of the JAX package's make_multi_step (its
    lax.scan of the step body). Each metric is a tensor of shape (n_inner,),
    row k that of iteration state.step + k, with make_train_step's dtype.

    The iterations run through one persistent set of per-step generators
    (re-seeded from (seed, step) before each), a step counter and a metrics
    buffer on the parameters' device, so each draws and computes what
    make_train_step does from the same state. On the CPU they run eagerly,
    the plain version. On the card, the first dispatch (and the first after
    the state's tensors moved, as a restore moves Adam's) takes one real
    step eagerly on a side stream as warm-up, captures one step in a
    torch.cuda.CUDAGraph and replays it for the rest; every later dispatch
    replays it n_inner times. Between replays the host only re-seeds the
    generators and writes the lr tensors; nothing syncs with the host until
    the caller reads the metrics. A capture that fails raises.

    Under an NCCL mesh the graph holds the step's all-reduce (the warm-up
    step launches it once first). A gloo mesh cannot be captured: with one
    on the card this raises ValueError instead of running uncaptured.

    spans: record the step's spans (core/profiling.py) inside the step, so
    the graph holds their event-record nodes; after a dispatch's host read,
    multi_fn.span_ms() gives the device ms of each span of its last step
    ({} off the card). Off, no span of the step records, even under an
    enclosing recording(), and the graph is that of the step alone."""
    if (mesh is not None and mesh.device.type == "cuda"
            and mesh.backend != "nccl"):
        raise ValueError(
            f"a {mesh.backend} mesh on the card cannot be captured in a CUDA "
            "graph: use NCCL, or make_train_step for uncaptured steps")
    return _MultiStep(_make_body(cfg, H, W, mesh), n_inner, spans)


# CUDA graphs of the step captured and replayed on the card, over the
# process (the warm-up step of a capture runs eagerly and is in neither)
GRAPHS = {"captured": 0, "replayed": 0}
# what a step launches (the MLP's kernels and routes, the mesh's
# collectives): a captured step's are re-counted at each replay
COUNTERS = mlp_ops.COUNTERS + (mesh_mod.COLLECTIVES,)


class _MultiStep:
    def __init__(self, body, n_inner: int, spans: bool = False):
        if n_inner < 1:
            raise ValueError(f"n_inner must be >= 1, got {n_inner}")
        self.body, self.n_inner, self.spans = body, n_inner, spans
        self.gens = self.step_t = self.row_t = self.buf = None
        self.names = self.dtypes = None
        self.graph, self.key, self.counts = None, None, None
        # the spans of the last step run, and those the graph holds
        self.records = self.graph_records = None

    def __call__(self, state: TrainState, batch: SceneBatch, seed: int):
        device = state.params["knots"].device
        if self.gens is None:
            self.gens = rng_mod.step_generators(seed, state.step, device)
            self.step_t = torch.zeros((), dtype=torch.int64, device=device)
            self.row_t = torch.zeros((1,), dtype=torch.int64, device=device)
        self.step_t.fill_(state.step)
        self.row_t.zero_()
        step, done = state.step, 0
        if device.type == "cuda" and (self.graph is None
                                      or self.key != _addresses(state, batch)):
            with profiling.span("dispatch.capture"):
                # frees the old graph's memory pool, then its events
                self.graph = self.records = self.graph_records = None
                self._prepare(state, seed, step)
                side = torch.cuda.Stream(device)
                side.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(side):
                    self._step(state, batch, step)
                torch.cuda.current_stream(device).wait_stream(side)
                step, done = step + 1, 1
                self._capture(state, batch)
        for _ in range(done, self.n_inner):
            self._prepare(state, seed, step)
            if device.type == "cuda":
                with profiling.span("dispatch.replay", index=step):
                    self.graph.replay()
                self.records = self.graph_records
                mlp_ops.add_counts(self.counts, counters=COUNTERS)
                GRAPHS["replayed"] += 1
            else:
                self._step(state, batch, step)
            step += 1
        with profiling.span("dispatch.read"):
            metrics = {k: self.buf[:, j].to(self.dtypes[k], copy=True)
                       for j, k in enumerate(self.names)}
        return TrainState(state.params, state.optimizer, step), metrics

    def span_ms(self) -> dict:
        """{span name: [device ms]} of the last step (replayed or not) of
        the last dispatch, read after its host read; {} without spans or
        off the card."""
        return {} if self.records is None else self.records.device_ms()

    def _prepare(self, state, seed, step):
        """The host's part of a step: its generators and its lrs."""
        with profiling.span("dispatch.prepare", index=step):
            rng_mod.step_generators(seed, step, None, out=self.gens)
            optim_mod.set_learning_rates(state.optimizer, step)

    def _step(self, state, batch, index):
        """One iteration on the persistent generators and step counter, its
        metrics into row row_t of the buffer: what the graph captures. With
        spans, its spans are recorded in self.records; without, none."""
        device = self.step_t.device
        with profiling.recording(device, enabled=self.spans) as records, \
                profiling.span("step", index=index):
            metrics = self.body(state.params, state.optimizer, batch, self.gens,
                                self.step_t)
            with profiling.span("step.row"):
                if self.buf is None:  # the first step, never under capture
                    self.names = list(metrics)
                    self.dtypes = {k: v.dtype for k, v in metrics.items()}
                    self.buf = torch.zeros((self.n_inner, len(self.names)),
                                           dtype=torch.float64, device=device)
                row = torch.stack([metrics[k].to(torch.float64)
                                   for k in self.names])
                self.buf.index_copy_(0, self.row_t, row[None])
                self.row_t.add_(1)
                self.step_t.add_(1)
        self.records = records

    def _capture(self, state, batch):
        before = mlp_ops.counts(COUNTERS)
        for t in tree_leaves(state.params):
            t.grad = None
        graph = torch.cuda.CUDAGraph()
        for g in self.gens.values():
            graph.register_generator_state(g)
        last = self.records
        with torch.cuda.graph(graph):
            self._step(state, batch, None)
        # the graph's events time its replays; the last step run is still
        # the eager one
        self.graph_records, self.records = self.records, last
        # the capture launched nothing: count its launches at each replay
        self.counts = mlp_ops.counts_since(before, COUNTERS)
        mlp_ops.add_counts(self.counts, -1, COUNTERS)
        self.graph, self.key = graph, _addresses(state, batch)
        GRAPHS["captured"] += 1


def _addresses(state, batch):
    """The device addresses a captured step reads and writes: every
    parameter, Adam state tensor and lr, and the batch."""
    opt = state.optimizer
    tensors = tree_leaves(state.params)
    tensors += [v for st in opt.state.values() for v in st.values()]
    tensors += [g["lr"] for g in opt.param_groups]
    tensors += [*batch.events] + [t for t in batch[1:] if t is not None]
    return (id(opt),) + tuple(t.data_ptr() for t in tensors)


def metrics_to_host(metrics) -> dict:
    """{name: float64 numpy array of shape (n,)} from metrics of 0-d or
    (n,) tensors, in one device-to-host copy: the train loop's one read of
    a dispatch."""
    names = list(metrics)
    with profiling.span("dispatch.read"):
        vals = torch.stack([metrics[k].reshape(-1).to(torch.float64)
                            for k in names]).cpu().numpy()
    return dict(zip(names, vals))
