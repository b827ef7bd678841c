"""Production and local meshes, and the card's peaks for the roofline.

The port of the reference's ``repro/launch/mesh.py``: a
:class:`repro_torch.sharding.Mesh` with the reference's shapes and axis
names.  The reference's roofline constants are a TPU v5e's; the port's are
an H100's (:mod:`repro_torch.benchmarks.roofline` reads them).
"""
from __future__ import annotations

from repro_torch.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")``: the reference's pod and two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over ``("data", "model")``."""
    return Mesh((data, model), ("data", "model"))


# H100 SXM at 700 W, per card, from the NVIDIA data sheet (dense rates).
#: bfloat16 tensor-core FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: float32 FLOP/s outside the tensor cores (the kernels' bound's rate)
PEAK_FLOPS_FP32 = 67e12
#: HBM3 bytes/s
HBM_BW = 3.35e12
#: NVLink bytes/s each way.  NVLink joins the cards of one host; a mesh of
#: 256 cards spans hosts, so its collectives cross the hosts' network and
#: a collective term at this rate is optimistic.
LINK_BW = 450e9
#: HBM bytes
HBM_BYTES = 80e9
