"""Whole runs on the CPU at a tiny size, past the look for a card: a sound
run comes out correct, and the control and each fault the cell can have
come out not correct under the cells' own limits.

The control is the reference computed in TF32, put in the program's
place.  The faults are planted in the program under test: a step that
leaves its state unchanged, half of each device's batch left out (the
mean taken over the rest), a token altered where it is drawn.  The cell
runs on one chip, so it has no exchange between chips to leave out."""
import pytest

from fedbench.tests import tiny

CODE = r'''
import json, time
from fedbench import bench
from fedbench.reference import fedllm as ref


class Frozen:
    """A step that returns its state unchanged."""
    def __init__(self, opt):
        self.init = opt.init

    def apply(self, params, grads, state):
        return params, state


def batch_fault(kind):
    def plant(c):
        draw = c.fed._device_batch
        calls = [0]

        def broken(key):
            b = draw(key)
            tok = b["tokens"]
            if kind == "half_batch":
                b["tokens"] = tok[: tok.shape[0] // 2]
            elif calls[0] % c.fed.m == 0:
                tok = tok.clone()
                tok[0, 3] = (tok[0, 3] + 1) % c.fed.arch.vocab
                b["tokens"] = tok
            calls[0] += 1
            return b
        c.fed._device_batch = broken
    return plant


def control(c):
    """The program's set-up runs; its readings are the control's."""
    settings = ref.Settings.from_files(c.config, c.workload)
    setup = c.setup

    def readings():
        setup()
        return ref.run(settings, c.seed, 3, "cpu", "tf32")
    c.setup = readings


def frozen(c):
    c.fed.opt = Frozen(c.fed.opt)


PLANTS = {"sound": None, "control": control, "frozen": frozen,
          "half_batch": batch_fault("half_batch"),
          "token": batch_fault("token")}
out = {}
for case in CASES:
    r = bench.run(CELL, 2**31 + 101, 0.5, False, time.perf_counter(),
                  device="cpu", plant=PLANTS[case])
    out[case] = {"correct": r["correct"], "checks": r["checks"]}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("fedbench"))


@pytest.mark.parametrize("cell", ["tiny_dense.adsgd_round",
                                  "tiny_moe.adsgd_round"])
def test_sound_run_is_correct_and_every_fault_is_not(root, cell):
    cases = ["sound", "control", "frozen", "half_batch", "token"]
    out = tiny.run_python(root, f"CELL = {cell!r}\nCASES = {cases!r}\n"
                          + CODE)
    assert out["sound"]["correct"], out["sound"]
    for case in cases[1:]:
        assert not out[case]["correct"], (case, out[case])
