"""Device choice for the CLI and the models' ``fit`` (the counterpart of
ranklib_tpu.cli._ensure_backend).

``RANKLIB_TPU_TORCH_DEVICE`` forces a device (``cpu``, ``cuda``,
``cuda:1``); otherwise the current CUDA device. With no CUDA device and
the variable unset the entry points refuse to start rather than train on
the CPU unasked: ``RANKLIB_TPU_TORCH_DEVICE=cpu`` asks for the CPU. The
choice is logged on one line and then passed down explicitly;
nothing here is global state.
"""

from __future__ import annotations

import os

import torch

from ranklib_tpu_torch.utils.errors import RankLibError
from ranklib_tpu_torch.utils.logging import log

DEVICE_ENV = "RANKLIB_TPU_TORCH_DEVICE"


def choose_device(*, quiet: bool = False) -> torch.device:
    """The one device rule of the port, for the CLI and for entry points
    called without a device; ``quiet`` leaves out the log line."""
    forced = os.environ.get(DEVICE_ENV)
    if forced:
        try:
            dev = torch.device(forced)
        except RuntimeError as e:
            raise RankLibError(f"{DEVICE_ENV}={forced!r}: {e}") from None
        if dev.type not in ("cpu", "cuda"):
            raise RankLibError(f"{DEVICE_ENV}={forced!r}: only cpu and cuda "
                               f"devices are supported")
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RankLibError(f"{DEVICE_ENV}={forced!r} but CUDA is not "
                               f"available")
    elif torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        raise RankLibError(f"no CUDA device is available; set {DEVICE_ENV}=cpu "
                           f"to run on the CPU")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RankLibError(f"no CUDA device {dev.index} "
                               f"({torch.cuda.device_count()} available)")
        if not quiet:
            log(f"Device: {dev} ({torch.cuda.get_device_name(dev)})")
    elif not quiet:
        log("Device: cpu")
    return dev
