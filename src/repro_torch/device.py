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
