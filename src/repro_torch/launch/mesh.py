"""The local mesh of the serve path and the tests.

The port of ``make_local_mesh`` from the reference's ``repro/launch/mesh.py``:
a :class:`repro_torch.sharding.Mesh` of ``data x model`` ranks with the axes
``("data", "model")``.  The reference's production meshes and roofline
constants there are a TPU pod's and have no counterpart here.
"""
from __future__ import annotations

from repro_torch.sharding import Mesh


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over ``("data", "model")``."""
    return Mesh((data, model), ("data", "model"))
