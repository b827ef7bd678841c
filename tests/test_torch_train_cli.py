"""The trainer's command line (``repro_torch.launch.train``) and the
``distributed_ota`` example on the CPU, at the reference's settings.

Each run prints finite losses; ``--ckpt`` writes the final params and
optimizer state, which ``load_checkpoint`` reads back bitwise; four
processes under torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) write, from rank 0, the
checkpoint of the run on a mesh of rank threads, bitwise; the example's
loss falls over its first steps (its batches cycle over four).
"""
import contextlib
import io
import math
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from repro_torch.convert import tree_leaves
from repro_torch.examples import distributed_ota
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import load_checkpoint

LOSS = re.compile(r"step\s+(\d+)\s+loss ([-\d.naif]+)")
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(argv)
    return rc, buf.getvalue()


def _losses(text):
    return {int(s): float(v) for s, v in LOSS.findall(text)}


def test_train_cli_4x2_writes_a_checkpoint(tmp_path, monkeypatch):
    saved = {}
    save = launch_train.save_checkpoint

    def spy(path, state, step=0):
        saved.update(state=state, step=step)
        save(path, state, step)

    monkeypatch.setattr(launch_train, "save_checkpoint", spy)
    path = str(tmp_path / "ckpt.npz")
    rc, out = _main(["--reduced", "--mesh", "4x2", "--steps", "3",
                     "--device", "cpu", "--log-every", "1", "--ckpt", path])
    assert rc == 0, out
    assert "M=4" in out and "ota_axes=('data',)" in out
    losses = _losses(out)
    assert sorted(losses) == [0, 1, 2]
    assert all(math.isfinite(v) for v in losses.values()), losses
    state, step = load_checkpoint(path, device="cpu")
    assert step == saved["step"] == 3
    want, got = tree_leaves(saved["state"]), tree_leaves(state)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_train_cli_under_torchrun_writes_the_thread_meshs_checkpoint(
        tmp_path):
    argv = ["--reduced", "--mesh", "2x2", "--steps", "2", "--device", "cpu",
            "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv, "--ckpt",
         str(tmp_path / "pg.npz")],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    # the thread mesh on one CPU thread, as each rank runs: at the
    # launcher's 16 x 64 tokens the CPU's products round by their thread
    # count
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc, out = _main(argv + ["--ckpt", str(tmp_path / "threads.npz")])
        torch.set_num_threads(n)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        torch.set_num_threads(n)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert rc == 0 and [p.returncode for p in procs] == [0] * 4, logs
    # rank 0 alone prints, as the thread mesh's run does
    assert _losses(logs[0]) == _losses(out) and len(_losses(out)) == 2
    assert not any(LOSS.search(log) for log in logs[1:]), logs[1:]
    got, step = load_checkpoint(str(tmp_path / "pg.npz"), device="cpu")
    want, want_step = load_checkpoint(str(tmp_path / "threads.npz"),
                                      device="cpu")
    assert step == want_step == 2
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_train_cli_under_torchrun_needs_a_card_or_device_cpu(monkeypatch):
    """A rank with no card and no ``--device cpu`` raises before it joins
    the group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in dict(WORLD_SIZE="4", RANK="0", LOCAL_RANK="0").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--reduced", "--mesh", "2x2", "--steps", "1"])


def test_train_cli_site_ota_on_2x2x2():
    rc, out = _main(["--reduced", "--mesh", "2x2x2", "--site-ota",
                     "--steps", "1", "--device", "cpu"])
    assert rc == 0, out
    assert "M=2" in out and "ota_axes=('pod',)" in out
    losses = _losses(out)
    assert sorted(losses) == [0]
    assert all(math.isfinite(v) for v in losses.values()), losses


def test_distributed_ota_example_loss_falls():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        distributed_ota.main(steps=6, device="cpu")
    out = buf.getvalue()
    losses = _losses(out)
    assert sorted(losses) == [0, 5], out
    assert losses[5] < losses[0], losses
    power = [float(x) for x in re.findall(r"frame power ([\d.]+)", out)]
    assert all(abs(p - 500.0) < 5.0 for p in power), power
    assert "done" in out
