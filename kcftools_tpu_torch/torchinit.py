"""Device selection for the port.

The device is ``cuda:0`` unless ``KCFTOOLS_TORCH_DEVICE`` names another
one; ``KCFTOOLS_TORCH_DEVICE=cpu`` is the one way to run on the CPU
(the kernels' plain torch versions). A CUDA device asked for on a host
without CUDA is an error: the port never falls back to the CPU.
"""

import os

import torch

ENV = "KCFTOOLS_TORCH_DEVICE"


def resolve_device() -> torch.device:
    dev = torch.device(os.environ.get(ENV, "cuda:0"))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{ENV}={dev} but CUDA is not available; set {ENV}=cpu "
                "to run the plain torch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"{ENV}={dev}: only {torch.cuda.device_count()} CUDA "
                "device(s) visible"
            )
    elif dev.type != "cpu":
        raise RuntimeError(f"{ENV}={dev}: only cuda[:N] or cpu")
    return dev


def device_count(dev: torch.device) -> int:
    """Accelerators the engine routing sees: the visible CUDA devices on
    a CUDA run, one on a CPU run."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1
