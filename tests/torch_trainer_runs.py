"""Whole steps of the port's sharded trainer on either transport, for
``tests/test_torch_trainer_processes.py``: :func:`run_case` runs on the
thread mesh in the test's process and on every rank of a gloo world of
processes, each of which runs this file as a script:

    python tests/torch_trainer_runs.py RANK STORE SPEC.json OUT.pt

It imports no jax, so the ranks start quickly; SPEC.json holds the
reference's settings, the mesh, the cases and the batch, and optionally
per case its own mesh (``meshes``, over the same world) and OTA axes
(``ota_axes``; ``('data',)`` otherwise).
"""
import json
import math
import sys

import numpy as np
import torch

from repro_torch import rng
from repro_torch import sharding
from repro_torch.configs.base import OTAConfig, TrainConfig, get_config
from repro_torch.convert import ravel, tree_leaves
from repro_torch.sharding import Mesh
from repro_torch.train import trainer as T


def run_case(spec, case, mesh):
    """``spec["steps"]`` steps of ``case`` on ``mesh`` from
    ``init_state(PRNGKey(0))``, the batch ``spec["tokens"]`` every step and
    the key ``PRNGKey(step)``: ĝ of every step (whole), the params
    (raveled), the error state's leaves (on a process-group mesh this
    rank's blocks) and the metrics of every step."""
    over, sliced = spec["cases"][case]
    make = T.make_train_step_sliced if sliced else T.make_train_step
    ts = make(get_config(spec["arch"]).reduced(),
              TrainConfig(**spec["train"]),
              OTAConfig(**{**spec["ota"], **over}), mesh,
              ota_axes=tuple(spec.get("ota_axes", {}).get(case, ["data"])),
              donate=False, device="cpu")
    ghats = []
    aggregate = ts.aggregate_fn

    def keep_ghat(*args):
        ghat, met, seconds = aggregate(*args)
        ghats.append(ravel(ghat).clone())
        return ghat, met, seconds

    ts.aggregate_fn = keep_ghat
    tokens = np.asarray(spec["tokens"], dtype=np.int32)
    params, opt_state, delta = ts.init_state(rng.PRNGKey(0))
    fn = ts.jitted({"tokens": tokens})
    mets = []
    for step in range(spec["steps"]):
        params, opt_state, delta, met = fn(
            params, opt_state, delta, {"tokens": tokens}, step,
            rng.PRNGKey(step))
        mets.append({k: v.clone() for k, v in met.items()})
    return {"ghat": ghats, "params": ravel(params).clone(),
            "delta": [leaf.clone() for leaf in tree_leaves(delta)],
            "metrics": mets}


def main(rank, store, spec_path, out):
    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    shape, names = spec["mesh"]
    world = sharding.init_process_mesh(
        shape, names, rank=rank, world_size=math.prod(shape),
        init_method="file://" + store, timeout=300)
    try:
        torch.save({case: run_case(spec, case, case_mesh(spec, case, world))
                    for case in spec["cases"]}, out)
    finally:
        sharding.close_process_mesh()


def case_mesh(spec, case, world):
    """``case``'s mesh: its own layout of the world's ranks where
    ``spec["meshes"]`` names one (every rank builds it, in case order),
    else the world's."""
    if case not in spec.get("meshes", {}):
        return world
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = (tuple(x) for x in spec["meshes"][case])
    return Mesh(shape, names, device_mesh=init_device_mesh(
        "cpu", shape, mesh_dim_names=names))


if __name__ == "__main__":
    main(int(sys.argv[1]), *sys.argv[2:5])
