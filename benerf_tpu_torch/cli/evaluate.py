"""Offline folder-vs-folder evaluation CLI of the port.

Port of benerf_tpu/cli/evaluate.py (reference evaluate.py:37-56):
    python -m benerf_tpu_torch.cli.evaluate --result DIR --groundtruth DIR [--device N]
PSNR / SSIM (and LPIPS when its weights are on disk) over the sorted image
pairs of two folders, averaged. PSNR / SSIM are host numpy, as in the JAX
package; LPIPS's network runs on the card cuda:N unless the caller asks for
the CPU (`device="cpu"`). PNGs are read by data/png.py (the card machine
has no imageio); a .jpg goes through a lazy imageio import, which raises
where imageio is not installed.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from benerf_tpu_torch import cli_device
from benerf_tpu_torch.data import png
from benerf_tpu_torch.eval import metrics as metrics_mod


def load_folder(d):
    files = [
        os.path.join(d, f)
        for f in sorted(os.listdir(d))
        if f.lower().endswith(("jpg", "png"))
    ]
    return [np.asarray(png.read(f), np.float64) / 255.0 for f in files]


def evaluate(result_dir: str, gt_dir: str, device=None):
    """{metric: mean} over the folders' image pairs. device: where LPIPS
    runs (None: the card; raises without one)."""
    device = cli_device(device=device)
    res = load_folder(result_dir)
    gts = load_folder(gt_dir)
    assert len(res) == len(gts), f"{len(res)} results vs {len(gts)} GT images"
    out = {"psnr": [], "ssim": [], "lpips": []}
    for r, g in zip(res, gts):
        out["psnr"].append(metrics_mod.psnr(r, g))
        out["ssim"].append(metrics_mod.ssim(r, g))
        lp = metrics_mod.lpips(r, g, device=device)
        if lp is not None:
            out["lpips"].append(lp)
    return {k: float(np.mean(v)) for k, v in out.items() if len(v) > 0}


def main(argv=None, device=None):
    p = argparse.ArgumentParser()
    p.add_argument("--result", type=str, required=True)
    p.add_argument("--groundtruth", type=str, required=True)
    p.add_argument("--device", type=int, default=0, help="cuda:N to run on")
    args = p.parse_args(argv)
    summary = evaluate(args.result, args.groundtruth,
                       cli_device(args.device, device))
    for k, v in summary.items():
        print(f"{k}: {v:.6f}")


if __name__ == "__main__":
    main()
