"""PyTorch port of the SSR reproduction (``repro``), for NVIDIA Hopper.

The package mirrors ``repro``'s layout — ``repro_torch.core`` holds the
stream compiler and its lowering, ``repro_torch.kernels`` the kernel suite —
and imports neither JAX nor anything of ``repro``.  The streamed kernels run
as hand-written CUDA C++ (``csrc/``) on a CUDA device and through their plain
PyTorch versions on the CPU.

Entry points (``kernels.ops``, ``core.lowering.ssr_call``,
``kernels.frontend.NestKernel``) run on ``cuda`` unless the caller asks for
the CPU, per call through ``device=`` or for the process through
:func:`set_default_device`.  Asking for ``cuda`` where there is none raises:
the CPU path is never taken silently.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_default = {"device": torch.device("cuda")}


def set_default_device(device: Union[str, torch.device]) -> None:
    """Pick the device that entry points use when no ``device=`` is given."""
    _default["device"] = _check(torch.device(device))


def default_device() -> torch.device:
    return _default["device"]


def _check(dev: torch.device) -> torch.device:
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a call runs on; raises when ``cuda`` is asked for but absent."""
    dev = _check(torch.device(device) if device is not None
                 else _default["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: the call asks for cuda but torch.cuda.is_available() "
            "is False; pass device='cpu' or set_default_device('cpu') to run "
            "the plain PyTorch versions")
    return dev


def to_device(x, device: Optional[torch.device]) -> torch.Tensor:
    """A tensor (or numpy array / scalar) as a tensor on ``device``."""
    return torch.as_tensor(x, device=device)
