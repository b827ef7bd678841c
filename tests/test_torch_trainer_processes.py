"""The sharded trainer on a process-group mesh, repro_torch against its own
thread mesh and against repro: whole steps of flat A-DSGD, the ideal link
and the sliced layout on a 4 x 2 mesh of 8 gloo processes.

One world of 8 processes, one CPU thread each, starts at the module's
start and runs those cases of ``torch_trainer_ref.STEP_CASES`` for
``R.STEPS`` steps (``tests/torch_trainer_runs.py``, a ``FileStore`` under
the module's temporary directory); the test's process runs the same
cases on a 4 x 2 mesh of rank threads while the world runs, and the
reference's steps run in a subprocess of their own
(``tests/torch_trainer_ref.py``, part ``steps``).

Bars:

* every process's ĝ at every step, its params, its block of the error
  state and its metrics: bitwise the thread mesh's (the block: the
  thread mesh's error state at the process's coordinates);
* every process's metrics within ``test_steps_match_reference``'s bars
  of the reference's steps;
* every process's ``loss`` is OTA rank 0's local loss and its
  ``global_loss`` the rank-order mean of the four local losses.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_trainer_ref as R
import torch_trainer_runs as W
from repro_torch import rng
from repro_torch import sharding
from repro_torch.configs.base import OTAConfig, TrainConfig, get_config
from repro_torch.models import model as tmodel
from repro_torch.sharding import Mesh, P
from repro_torch.train import trainer as T
from test_torch_trainer_steps import FRAME_RTOL, LOSS_RTOL, METRIC_RTOL

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD = 8
#: the cases of R.STEP_CASES run here: the thread mesh's side costs ~35 s
#: an analog case on two CPU threads, so the grouped case (bitwise too)
#: stays out of the module's budget
CASES = ("adsgd", "ideal", "sliced")
#: seconds the world may take (~30 s alone)
WORLD_TIMEOUT = 600


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def ref(tmp_path_factory):
    """The reference, started before the module's first test."""
    ref = R.Reference(tmp_path_factory.mktemp("ref") / "steps.npz",
                      "steps", cases=CASES)
    yield ref
    ref.close()


def _spec():
    return dict(arch=R.ARCH, train=R.TRAIN, ota=R.OTA, steps=R.STEPS,
                cases={k: list(R.STEP_CASES[k]) for k in CASES},
                mesh=[list(R.MESH_4X2[0]), list(R.MESH_4X2[1])],
                tokens=R.batch_tokens().tolist())


class World:
    """The 8 ranks, started at once; ``result(rank)`` waits for all of
    them on first use."""

    def __init__(self, tmp):
        spec = tmp / "spec.json"
        spec.write_text(json.dumps(_spec()))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join([SRC, HERE])
        env["OMP_NUM_THREADS"] = "1"
        self.outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_trainer_runs.py"),
             str(r), str(tmp / "store"), str(spec), str(self.outs[r])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(WORLD)]
        self._results = None

    def result(self, rank):
        if self._results is None:
            logs = [p.communicate(timeout=WORLD_TIMEOUT)[0]
                    for p in self.procs]
            assert [p.returncode for p in self.procs] == [0] * WORLD, \
                "\n".join(log[-3000:] for log in logs)
            self._results = [torch.load(o) for o in self.outs]
        return self._results[rank]

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    w = World(tmp_path_factory.mktemp("world"))
    yield w
    w.close()


_THREADS = {}


def _thread_run(case):
    if case not in _THREADS:
        _THREADS[case] = W.run_case(_spec(), case, Mesh(*R.MESH_4X2))
    return _THREADS[case]


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _delta_specs(sliced):
    """The error state's leaves' specs, in ``tree_leaves`` order."""
    if sliced:
        return [P("data", None), P("data", "model", None)]   # rep, sh
    return [P("data", "model")]


@pytest.mark.parametrize("case", CASES)
def test_process_mesh_is_the_thread_mesh_bitwise(world, case):
    want = _thread_run(case)
    mesh = Mesh(*R.MESH_4X2)
    specs = _delta_specs(R.STEP_CASES[case][1])
    for rank in range(WORLD):
        got = world.result(rank)[case]
        assert len(got["ghat"]) == len(want["ghat"]) == R.STEPS
        for step, (a, b) in enumerate(zip(got["ghat"], want["ghat"])):
            assert _same(a, b), (rank, "ghat", step)
        assert _same(got["params"], want["params"]), (rank, "params")
        assert len(got["delta"]) == len(specs)
        for a, b, spec in zip(got["delta"], want["delta"], specs):
            block = sharding.local_block(mesh, b, spec, mesh.coords(rank))
            assert _same(a, block), (rank, "delta", spec)
        for step, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
            assert a.keys() == b.keys(), (rank, step)
            for k in a:
                assert _same(a[k], b[k]), (rank, step, k)


@pytest.mark.parametrize("case", CASES)
def test_process_mesh_metrics_match_reference(ref, world, case):
    for rank in range(WORLD):
        mets = world.result(rank)[case]["metrics"]
        for step, met in enumerate(mets):
            want = {k.split("/")[-1]: ref[k] for k in ref
                    if k.startswith(f"step/{case}/{step}/")}
            assert set(met) == set(want), (rank, step)
            for k, w in want.items():
                bar = (FRAME_RTOL if step and k in ("alpha", "tau",
                                                    "frame_power")
                       else LOSS_RTOL if k == "global_loss"
                       else METRIC_RTOL)
                assert _rel(met[k], w) <= bar, (rank, step, k,
                                                float(met[k]), float(w))


def test_every_process_gets_ota_rank0s_metrics(world):
    """``loss`` is OTA rank 0's local loss in every process, not the
    process's own; ``global_loss`` the mean of the four in rank order."""
    arch = get_config(R.ARCH).reduced()
    ts = T.make_train_step(arch, TrainConfig(**R.TRAIN),
                           OTAConfig(**R.OTA), Mesh(*R.MESH_4X2),
                           device="cpu")
    params, _, _ = ts.init_state(rng.PRNGKey(0))
    with torch.no_grad():
        local = [tmodel.loss_fn(params, arch,
                                {"tokens": torch.from_numpy(t.copy())},
                                compute_dtype=torch.float32)[0]
                 for t in np.split(R.batch_tokens(), 4)]
    acc = local[0]
    for x in local[1:]:
        acc = acc + x
    assert len({float(x) for x in local}) == 4
    for rank in range(WORLD):
        for case in CASES:
            met = world.result(rank)[case]["metrics"][0]
            assert float(met["loss"]) == float(local[0]), (rank, case)
            assert float(met["global_loss"]) == float(acc * 0.25), \
                (rank, case)
