"""Training CLI of the port, flag-compatible with the reference:

    python -m benerf_tpu_torch.cli.train --config configs/demo.txt \\
        --datadir D --logdir L [--device N] [--index i]

(reference: python train.py --device N --config cfg.txt --index i). Every
config field is also a --flag that overrides the file. --device N runs on
the card cuda:N; without a card the run raises.
"""

from __future__ import annotations

from benerf_tpu_torch import cli_device
from benerf_tpu_torch.core.config import config_from_cli
from benerf_tpu_torch.train.loop import train


def main(argv=None, device=None):
    """Parse argv (None: sys.argv) and train; returns the final TrainState.
    device: None runs on cuda:<--device>; tests pass "cpu"."""
    cfg = config_from_cli(argv)
    device = cli_device(cfg.device, device)
    print(f"[INFO] dataset={cfg.dataset} datadir={cfg.datadir} "
          f"index={cfg.index} device={device}")
    return train(cfg, device=device)


if __name__ == "__main__":
    main()
