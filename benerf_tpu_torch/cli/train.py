"""Training CLI of the port, flag-compatible with the reference:

    python -m benerf_tpu_torch.cli.train --config configs/demo.txt \\
        --datadir D --logdir L [--device N] [--index i]

(reference: python train.py --device N --config cfg.txt --index i). Every
config field is also a --flag that overrides the file. --device N runs on
the card cuda:N; without a card the run raises. On N cards, one process
per card, each on cuda:LOCAL_RANK (parallel/mesh.py):

    python -m torch.distributed.run --nproc_per_node N \\
        -m benerf_tpu_torch.cli.train --config ... --mesh_devices N
"""

from __future__ import annotations

from benerf_tpu_torch import cli_device
from benerf_tpu_torch.core.config import config_from_cli
from benerf_tpu_torch.parallel import mesh as mesh_mod
from benerf_tpu_torch.train.loop import train


def main(argv=None, device=None):
    """Parse argv (None: sys.argv) and train; returns the final TrainState.
    device: None runs on cuda:<--device> (under a launcher
    cuda:LOCAL_RANK); tests pass "cpu"."""
    cfg = config_from_cli(argv)
    device = (mesh_mod.initialize_distributed(device)
              or cli_device(cfg.device, device))
    print(f"[INFO] dataset={cfg.dataset} datadir={cfg.datadir} "
          f"index={cfg.index} device={device}")
    try:
        return train(cfg, device=device)
    finally:
        mesh_mod.finalize_distributed()


if __name__ == "__main__":
    main()
