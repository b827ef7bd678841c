"""Device resolution shared by every entry point of the port.

``device=None`` means the card (``torch.device("cuda")``).  Without one the
entry points raise instead of carrying on on the CPU; tests and other CPU
callers ask for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on.

    Also pins float32 matrix products to full precision: TF32 keeps about
    three decimal digits, below the port's parity bars, so both TF32
    switches are turned off explicitly whenever a CUDA device is resolved.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def div_f32(t: torch.Tensor, n) -> torch.Tensor:
    """``t / n`` as a true float32 division on every device.

    On a CUDA tensor torch divides by a python scalar as a multiply by the
    scalar's float32 reciprocal, which misses the quotient by an ulp where
    ``1/n`` is inexact (``n = 25``, ``n = 100``).  A 0-dim divisor filled on
    the tensor's own device (no copy from the host, so no wait for the
    device's queue) keeps the true division that the CPU and the reference
    make.  A tensor ``n`` is divided by as it is.
    """
    if isinstance(n, torch.Tensor):
        return t / n
    return t / torch.full((), n, dtype=torch.float32, device=t.device)
