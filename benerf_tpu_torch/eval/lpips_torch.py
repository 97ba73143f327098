"""LPIPS perceptual metric (VGG16 variant) in torch, weight-gated.

The port's copy of benerf_tpu/eval/lpips_torch.py. The reference uses the
`lpips` pip package (metrics.py:12,36), whose pretrained VGG + linear-head
weights download from the network. This re-implements the architecture and
loads weights from a local file when one is given:

  BENERF_LPIPS_WEIGHTS=/path/to/lpips_vgg.pth   (a state_dict containing
  'features.*' VGG16 conv weights and 'lins.*' 1x1 linear head weights, as
  saved by `torch.save(lpips.LPIPS(net='vgg').state_dict(), ...)` plus
  torchvision's vgg16 features under 'net.*')

Without weights, eval paths report LPIPS as None (PSNR/SSIM always work).
The model runs on the CPU.
"""

from __future__ import annotations

import os

import numpy as np

_MODEL = None

# VGG16 feature config (conv layer channel plan, 'M' = maxpool)
_VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
              512, 512, 512, "M", 512, 512, 512]
# indices (in the conv-only sequence) after which LPIPS taps activations
_SLICE_ENDS = (2, 4, 7, 10, 13)  # conv1_2, conv2_2, conv3_3, conv4_3, conv5_3
_CHNS = (64, 128, 256, 512, 512)

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _build(weights_path):
    import torch
    import torch.nn as nn

    class VGGFeatures(nn.Module):
        def __init__(self):
            super().__init__()
            layers = []
            in_ch = 3
            for v in _VGG16_CFG:
                if v == "M":
                    layers.append(nn.MaxPool2d(2, 2))
                else:
                    layers.append(nn.Conv2d(in_ch, v, 3, padding=1))
                    layers.append(nn.ReLU(inplace=True))
                    in_ch = v
            self.features = nn.Sequential(*layers)

        def forward(self, x):
            feats = []
            conv_idx = 0
            for layer in self.features:
                x = layer(x)
                if isinstance(layer, nn.ReLU):
                    conv_idx += 1
                    if conv_idx in _SLICE_ENDS:
                        feats.append(x)
            return feats

    class LPIPSNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = VGGFeatures()
            self.lins = nn.ModuleList(
                [nn.Conv2d(c, 1, 1, bias=False) for c in _CHNS]
            )

        def forward(self, a, b):
            shift = torch.tensor(_SHIFT).view(1, 3, 1, 1)
            scale = torch.tensor(_SCALE).view(1, 3, 1, 1)
            fa = self.net((a - shift) / scale)
            fb = self.net((b - shift) / scale)
            total = 0.0
            for xa, xb, lin in zip(fa, fb, self.lins):
                na = xa / (xa.norm(dim=1, keepdim=True) + 1e-10)
                nb = xb / (xb.norm(dim=1, keepdim=True) + 1e-10)
                d = lin((na - nb) ** 2)
                total = total + d.mean(dim=(2, 3))
            return total

    model = LPIPSNet()
    sd = torch.load(weights_path, map_location="cpu")
    # accept either the combined dict or lpips-package naming (lin0.model.1.*)
    remapped = {}
    for k, v in sd.items():
        k2 = k
        if k.startswith("lin") and ".model.1.weight" in k:
            k2 = f"lins.{k[3]}.weight"
        remapped[k2] = v
    model.load_state_dict(remapped, strict=False)
    model.eval()
    return model


def compute(im1, im2, weights_path=None):
    """im1, im2: (H,W,C) or (H,W) arrays in [0,1]. Returns float distance."""
    import torch

    global _MODEL
    weights_path = weights_path or os.environ.get("BENERF_LPIPS_WEIGHTS")
    if not weights_path or not os.path.exists(weights_path):
        raise FileNotFoundError(
            "LPIPS weights not found (set BENERF_LPIPS_WEIGHTS)"
        )
    if _MODEL is None:
        _MODEL = _build(weights_path)

    def prep(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 2:
            x = x[..., None]
        if x.shape[-1] == 1:
            x = np.repeat(x, 3, -1)
        x = np.clip(x * 2.0 - 1.0, -1, 1)  # metrics.py:51-52 domain
        return torch.tensor(x).permute(2, 0, 1)[None]

    with torch.no_grad():
        return float(_MODEL(prep(im1), prep(im2)).item())
