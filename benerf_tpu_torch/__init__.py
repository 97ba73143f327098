"""benerf_tpu_torch: the PyTorch + CUDA port of benerf_tpu for one NVIDIA H100.

Same subpackage layout and module names as benerf_tpu (the JAX reference it
is tested against); imports torch and numpy, never jax or benerf_tpu.
Entry points run on the card unless the caller passes device="cpu"; without
a card and without that request they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` if given, else "cuda".

    Raises when no device is given and no CUDA card is visible, so a run
    never lands on the CPU unless the caller asked for it.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return torch.device("cuda")


def cli_device(index: int = 0, device=None) -> torch.device:
    """The device a CLI runs on: `device` if given (tests pass "cpu"), else
    the card cuda:`index`, made the current device so that the kernels
    launch on its stream. Raises when no device is given and no card is
    visible."""
    if device is not None:
        return torch.device(device)
    resolve_device()  # raises without a card
    device = torch.device("cuda", index)
    torch.cuda.set_device(device)
    return device
