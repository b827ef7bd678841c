"""The sharded trainer on a process-group mesh in the two layouts that
split the collectives differently from ``test_torch_trainer_processes``:
edge-site OTA (``ota_axes=('pod',)`` on a 2 x 2 x 2 mesh, so phase 1
scatters over two axes and ĝ is gathered over the tuple ``('data',
'model')``) and grouped A-DSGD (``num_groups=2`` on 4 x 2, a psum over
groups of the OTA axis).

One world of 8 gloo processes, one CPU thread each, starts at the
module's start (``tests/torch_trainer_runs.py``; the site case on its own
2 x 2 x 2 layout of the world's ranks) and runs both cases for ``STEPS``
steps; the test's process runs the same cases on meshes of rank threads
while the world runs.

Bar: every process's ĝ at every step, its params, its block of the error
state and its metrics are bitwise the thread mesh's.  The thread mesh's
grouped steps are held against the reference in
``test_torch_trainer_steps``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import torch_trainer_ref as R
import torch_trainer_runs as W
from repro_torch import sharding
from repro_torch.sharding import Mesh, P

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 8
STEPS = 2
#: case: (OTA overrides, sliced, mesh, ota_axes, the error state's spec)
CASES = {
    "site": ({}, False, R.MESH_2X2X2, ("pod",), P("pod", ("data", "model"))),
    "groups": (*R.STEP_CASES["groups"], R.MESH_4X2, ("data",),
               P("data", "model")),
}
WORLD_TIMEOUT = 600


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _spec():
    return dict(arch=R.ARCH, train=R.TRAIN, ota=R.OTA, steps=STEPS,
                cases={k: [c[0], c[1]] for k, c in CASES.items()},
                mesh=[list(R.MESH_4X2[0]), list(R.MESH_4X2[1])],
                meshes={k: [list(c[2][0]), list(c[2][1])]
                        for k, c in CASES.items() if c[2] != R.MESH_4X2},
                ota_axes={k: list(c[3]) for k, c in CASES.items()},
                tokens=R.batch_tokens().tolist())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8 ranks, started at once; calling the value waits for them and
    returns each rank's results."""
    tmp = tmp_path_factory.mktemp("world")
    spec = tmp / "spec.json"
    spec.write_text(json.dumps(_spec()))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, HERE])
    env["OMP_NUM_THREADS"] = "1"
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_trainer_runs.py"),
         str(r), str(tmp / "store"), str(spec), str(outs[r])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    results = []

    def wait():
        if not results:
            logs = [p.communicate(timeout=WORLD_TIMEOUT)[0] for p in procs]
            assert [p.returncode for p in procs] == [0] * WORLD, \
                "\n".join(log[-3000:] for log in logs)
            results.extend(torch.load(o) for o in outs)
        return results

    yield wait
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("case", list(CASES))
def test_process_mesh_is_the_thread_mesh_bitwise(world, case):
    mesh = Mesh(*CASES[case][2])
    want = W.run_case(_spec(), case, mesh)
    spec = CASES[case][4]
    for rank, got in enumerate(world()):
        got = got[case]
        assert len(got["ghat"]) == len(want["ghat"]) == STEPS
        for step, (a, b) in enumerate(zip(got["ghat"], want["ghat"])):
            assert _same(a, b), (rank, "ghat", step)
        assert _same(got["params"], want["params"]), (rank, "params")
        (a,), (b,) = got["delta"], want["delta"]
        assert _same(a, sharding.local_block(mesh, b, spec,
                                             mesh.coords(rank))), \
            (rank, "delta")
        for step, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            assert a.keys() == b.keys(), (rank, step)
            for k in a:
                assert _same(a[k], b[k]), (rank, step, k)
