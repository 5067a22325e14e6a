"""Device selection for the port's entry points."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.

    Defaults to the card. Raises when CUDA is asked for (explicitly or by
    default) and absent: the port never falls back to the CPU on its own;
    a caller who wants the CPU (the tests) asks for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queue (a no-op on the CPU): PyTorch returns
    before the card has finished, so host clocks read after this."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
