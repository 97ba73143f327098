#!/usr/bin/env python3
"""Sweep the unroll depth of the fused MLP kernels' layer product.

    python3 tools/torch_unroll_sweep.py

Builds K1 and K2 (benerf_tpu_torch/csrc) once per FMLP_UNROLL value (input
rows of `mm_acc` unrolled together), and prints for each: the median
CUDA-event time of K1 and of K2 at the fine call's n = 3,055 x 128 =
391,040 points, K1's max abs error against the plain version, whether K2's
results equal the first build's, and ptxas' register / spill report.
Needs one CUDA card; imports nothing of JAX or of the JAX package.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from benerf_tpu_torch.models import nerf  # noqa: E402
from benerf_tpu_torch.ops import fused_mlp  # noqa: E402

UNROLLS = (2, 4, 8, 16)
S = 128


def main():
    if not torch.cuda.is_available():
        sys.exit("torch_unroll_sweep: torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    base = fused_mlp.NVCC_FLAGS
    params, pts, vd, _, _ = cs._inputs(torch, cs.RAYS, S, 3, 1, False)
    n = cs.RAYS * S
    packed = fused_mlp.pack_params(params).contiguous()
    band = fused_mlp.band_weights(None, None, "cuda")
    x = pts.reshape(n, 3).contiguous()
    g = torch.randn((n, 4), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    with torch.no_grad():
        plain = nerf.apply(params, pts, vd).reshape(n, 4)
    ref = None
    for u in UNROLLS:
        fused_mlp.NVCC_FLAGS = base + (f"-DFMLP_UNROLL={u}",)
        fused_mlp._libs.clear()
        fused_mlp.build()
        regs = {k: [line.strip() for line in v.splitlines()
                    if "registers" in line or "spill" in line]
                for k, v in fused_mlp.BUILD_LOG.items()}
        out = fused_mlp.launch_fwd(packed, x, vd, band, S, 3)
        dp, dx, _ = fused_mlp.launch_bwd(packed, x, vd, band, g, S, 3)
        if ref is None:
            ref = (dp.clone(), dx.clone())
        k1 = cs.time_ms(torch, lambda: fused_mlp.launch_fwd(packed, x, vd, band, S, 3))
        k2 = cs.time_ms(torch, lambda: fused_mlp.launch_bwd(packed, x, vd, band, g, S, 3))
        print(u, json.dumps(dict(
            k1_ms=k1, k2_ms=k2, k1_err=float((out - plain).abs().max()),
            dp_rel=float((dp - ref[0]).abs().max() / ref[0].abs().max()),
            dx_equal=bool(torch.equal(dx, ref[1])), regs=regs)), flush=True)
    print(cs.nvidia_smi_line())


if __name__ == "__main__":
    main()
