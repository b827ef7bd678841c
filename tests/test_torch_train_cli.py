"""The trainer's command line (``repro_torch.launch.train``) and the
``distributed_ota`` example on the CPU, at the reference's settings.

Each run prints finite losses; ``--ckpt`` writes the final params and
optimizer state, which ``load_checkpoint`` reads back bitwise; the
example's loss falls over its first steps (its batches cycle over four).
"""
import contextlib
import io
import math
import re

import pytest
import torch

from repro_torch.convert import tree_leaves
from repro_torch.examples import distributed_ota
from repro_torch.launch import train as launch_train
from repro_torch.train.checkpoint import load_checkpoint

LOSS = re.compile(r"step\s+(\d+)\s+loss ([-\d.naif]+)")


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
