"""Device selection for the port.

The device is ``cuda:0`` unless ``KCFTOOLS_TORCH_DEVICE`` names another
one; ``KCFTOOLS_TORCH_DEVICE=cpu`` is the one way to run on the CPU
(the kernels' plain torch versions). A CUDA device asked for on a host
without CUDA is an error: the port never falls back to the CPU.

The multi-device tier works on a list of mesh slots (``resolve_devices``),
the counterpart of ``jax.devices()``: every visible CUDA device, or the
one named device. ``KCFTOOLS_TORCH_VIRTUAL_DEVICES=N`` makes it N slots
that all run on the resolved device, as XLA's
``--xla_force_host_platform_device_count`` does for the JAX tests; it is
for tests and the smoke run, and never moves work off that device. Under
``torch.distributed`` every process contributes its local slots, in rank
order. A slot is identified by its position, never by its
``torch.device``: on a virtual mesh several slots share one device.

``phase`` is the stage timer's stage (``utils/stagetimer.py``) that
first waits for the devices it names (``sync_devices``); the device
engines and getVariations time their device work with it.
"""

import os
from typing import NamedTuple

import torch

from .utils import stagetimer

ENV = "KCFTOOLS_TORCH_DEVICE"
VIRTUAL_ENV = "KCFTOOLS_TORCH_VIRTUAL_DEVICES"


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


class Slot(NamedTuple):
    """One mesh slot: its position in the global slot list, the device
    that runs it, and the rank of the process that owns it."""

    index: int
    device: torch.device
    process_index: int


def process_index() -> int:
    """This process's rank (0 outside torch.distributed)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def local_devices() -> list:
    """This process's slot devices: N copies of the resolved device
    under KCFTOOLS_TORCH_VIRTUAL_DEVICES=N, else every visible CUDA
    device when KCFTOOLS_TORCH_DEVICE is unset or ``cuda``, else the
    one device it names."""
    n_virtual = int(os.environ.get(VIRTUAL_ENV) or 0)
    if n_virtual < 0:
        raise RuntimeError(f"{VIRTUAL_ENV}={n_virtual}: must be >= 0")
    if n_virtual:
        return [resolve_device()] * n_virtual
    if os.environ.get(ENV, "cuda") == "cuda":
        resolve_device()  # raises without CUDA
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device()]


def resolve_devices() -> list:
    """Every slot of the run, in rank order (``jax.devices()``)."""
    local = local_devices()
    n = len(local)
    return [
        Slot(p * n + i, dev, p)
        for p in range(process_count())
        for i, dev in enumerate(local)
    ]


def device_count() -> int:
    """Slots the engine routing sees (``jax.device_count()``)."""
    return len(resolve_devices())


def sync_devices(devices):
    """Wait for the queued work of every distinct CUDA device among
    ``devices`` (torch devices or slots)."""
    seen = set()
    for d in devices:
        d = d.device if isinstance(d, Slot) else d
        if d.type == "cuda" and d not in seen:
            seen.add(d)
            torch.cuda.synchronize(d)


class phase(stagetimer.stage):
    """A stagetimer stage that first waits for the queued work of every
    device it names (torch devices or mesh slots), so that device time
    lands in the phase that queued it."""

    __slots__ = ("devices",)

    def __init__(self, name, *devices):
        super().__init__(name)
        self.devices = devices

    def __exit__(self, *exc):
        if self.on:
            sync_devices(self.devices)
        return super().__exit__(*exc)
