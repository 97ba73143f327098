"""A cell's inputs, made from the seed on the device in a few large calls:
the scene (events and blurry image) and the weights.

The scene follows the port's random scene: `n_events` events of uniform
pixel over the event sensor, uniform time in [0, 1] (sorted) and polarity
+-1, and a uniform H x W blurry image, with the exposure at `rgb_exp_ts`
of the event time. The weights are laid out as the port keeps them (per
MLP layer `w` (fan_in, fan_out) and `b`, the skip layer's weight split by
rows into `w_pe` / `w_h`, the views layer's into `w_feat` / `w_pe`; knots,
transform, two CRFs): Xavier-uniform weights over each layer's whole
fan-in, zero biases (one for the event CRF), knots U(0, 0.01), transform 0.
Both sides, the program and the reference, are handed these same tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for stream `stream` of the seed."""
    state = np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)
    g = torch.Generator(device=device)
    g.manual_seed(int(state[0]) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def scene(conf, seed: int, device) -> dict:
    c = conf["config"]
    g = generator(seed, 1, device)
    n = conf["n_events"]
    He, We = c["event_height"], c["event_width"]
    H, W, C = int(c["rgb_height"]), int(c["rgb_width"]), c["channels"]
    pix = (torch.randint(0, He, (n,), generator=g, device=device) * We
           + torch.randint(0, We, (n,), generator=g, device=device))
    ts = torch.sort(torch.rand(n, generator=g, device=device)).values
    pol = torch.randint(0, 2, (n,), generator=g, device=device).float() * 2 - 1

    def K(p):
        return torch.tensor([[c[p + "fx"], 0, c[p + "cx"]],
                             [0, c[p + "fy"], c[p + "cy"]], [0, 0, 1]],
                            dtype=torch.float32, device=device)

    return dict(events=(pix, ts, pol),
                image=torch.rand((H * W, C), generator=g, device=device),
                rgb_exp_ts=torch.tensor(conf["rgb_exp_ts"], dtype=torch.float32,
                                        device=device),
                K_rgb=K("rgb_"), K_evt=K("event_"), H=H, W=W, H_evt=He, W_evt=We)


def _mlp_shapes(depth, width, channels, input_ch=63, views_ch=27, skip=4):
    """[(path, shape, kind)] of one MLP: kind "xavier:<fan_in>:<fan_out>" or
    a constant."""
    out = []
    for i in range(depth):
        if i > 0 and i - 1 == skip:
            fan = input_ch + width
            out += [((("pts", i, "w_pe")), (input_ch, width), ("x", fan, width)),
                    ((("pts", i, "w_h")), (width, width), ("x", fan, width))]
        else:
            fan = input_ch if i == 0 else width
            out.append((("pts", i, "w"), (fan, width), ("x", fan, width)))
        out.append((("pts", i, "b"), (width,), 0.0))
    fan = width + views_ch
    out += [(("feature", "w"), (width, width), ("x", width, width)),
            (("feature", "b"), (width,), 0.0),
            (("alpha", "w"), (width, 1), ("x", width, 1)),
            (("alpha", "b"), (1,), 0.0),
            (("views", "w_feat"), (width, width // 2), ("x", fan, width // 2)),
            (("views", "w_pe"), (views_ch, width // 2), ("x", fan, width // 2)),
            (("views", "b"), (width // 2,), 0.0),
            (("rgb", "w"), (width // 2, channels), ("x", width // 2, channels)),
            (("rgb", "b"), (channels,), 0.0)]
    return out


def _crf_shapes(hidden, width, bias):
    sizes = [1, width] + [width] * hidden + [1]
    out = []
    for i in range(len(sizes) - 1):
        out += [(("layers", i, "w"), (sizes[i], sizes[i + 1]),
                 ("x", sizes[i], sizes[i + 1])),
                (("layers", i, "b"), (sizes[i + 1],), bias)]
    return out


def _put(tree, path, value):
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(tree) <= k:
                tree.append({} if not isinstance(nxt, int) else [])
            tree = tree[k]
        else:
            tree = tree.setdefault(k, [] if isinstance(nxt, int) else {})
    tree[path[-1]] = value


def weights(c, seed: int, device, dtype=torch.float32) -> dict:
    """Every trainable tensor, made from one uniform draw."""
    spec = []
    for coll, depth, width in (("nerf", c["netdepth"], c["netwidth"]),
                               ("nerf_fine", c["netdepth_fine"], c["netwidth_fine"])):
        spec += [((coll,) + p, s, k) for p, s, k in
                 _mlp_shapes(depth, width, c["channels"])]
    spec.append((("knots",), (4, 6), ("u", 0.0, 0.01)))
    spec.append((("transform",), (6,), 0.0))
    spec += [(("rgb_crf",) + p, s, k) for p, s, k in
             _crf_shapes(c["rgb_crf_net_hidden"], c["rgb_crf_net_width"], 0.0)]
    spec += [(("event_crf",) + p, s, k) for p, s, k in
             _crf_shapes(c["event_crf_net_hidden"], c["event_crf_net_width"], 1.0)]
    sizes = [int(np.prod(s)) for _, s, _ in spec]
    u = torch.rand(sum(sizes), generator=generator(seed, 2, device),
                   device=device, dtype=dtype)
    params: dict = {}
    for (path, shape, kind), part in zip(spec, torch.split(u, sizes)):
        if isinstance(kind, float):
            t = torch.full(shape, kind, device=device, dtype=dtype)
        elif kind[0] == "u":
            t = (kind[1] + (kind[2] - kind[1]) * part).reshape(shape)
        else:
            a = (6.0 / (kind[1] + kind[2])) ** 0.5
            t = (part * (2 * a) - a).reshape(shape)
        _put(params, path, t.contiguous())
    return params
