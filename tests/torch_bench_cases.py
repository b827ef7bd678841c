"""The tiny scale at which the reference's benchmark scripts and the port's
(``benchmarks/`` and ``repro_torch.benchmarks``) run side by side on the
CPU, shared by ``tests/test_torch_figures.py``,
``tests/test_torch_figures_gates.py`` and ``tests/test_torch_benchmarks.py``.

Both harnesses are shrunk the same way, with nothing added to either:
``SCALE``'s fields, the surrogate's ``dim`` (``make_classification`` in
each package's ``common`` and ``data.synthetic``), and Fig. 10's ``spec``.
The surrogate at noise 1.0 and Adam at lr 0.05 let the model learn within
the few rounds, so the rows hold trajectories, not chance.  Every script
that writes a JSON file is pointed at ``tmp_path``.
"""
import contextlib
import functools
import io
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import benchmarks.common as jcommon  # noqa: E402
import repro.data.synthetic as jsyn  # noqa: E402
import repro_torch.benchmarks.common as tcommon  # noqa: E402
import repro_torch.data.synthetic as tsyn  # noqa: E402

DIM = 16
TINY = dict(m=4, b=32, n_train=4000, n_test=200, steps=5, amp_iters=3,
            eval_every=2, noise=1.0, lr=0.05)
#: Fig. 10 at the tiny scale: K == M at 2 and 4 devices of a 128-sample
#: pool, and 4-device cohorts over 16 and 64 devices
SPEC = dict(m_full=(2, 4), total=128, m_sampled=(16, 64), k=4, b=16,
            steps=5, capacity=32)


def shrink(monkeypatch) -> None:
    """Both harnesses at the tiny scale."""
    for common, syn in ((jcommon, jsyn), (tcommon, tsyn)):
        small = functools.partial(syn.make_classification, dim=DIM)
        monkeypatch.setattr(common, "make_classification", small)
        monkeypatch.setattr(syn, "make_classification", small)
        for field, value in TINY.items():
            monkeypatch.setattr(common.SCALE, field, value)


@pytest.fixture
def tiny(monkeypatch):
    shrink(monkeypatch)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port on one intra-op thread (thousands of small ops, which a
    parallel run's busy cores slow with a pool of threads to wake)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_main(fn, **kw):
    """``fn(collect=summary, **kw)``'s printed lines, its ``SystemExit``
    message (``None`` if it returned) and its summary triples."""
    out, summary, exit_msg = io.StringIO(), [], None
    with contextlib.redirect_stdout(out):
        try:
            fn(collect=summary, **kw)
        except SystemExit as e:
            exit_msg = str(e)
    return out.getvalue().splitlines(), exit_msg, summary


def comparable(lines):
    """The printed lines both harnesses must share: all but the timing
    lines and the paths they wrote."""
    return [ln for ln in lines if "us/round" not in ln and "wrote " not in ln]


def csv_rows(lines):
    """``figure,series,step,value`` rows, keyed by (figure, series)."""
    out = {}
    for ln in lines:
        parts = ln.split(",")
        if len(parts) == 4 and parts[0].startswith(("fig", "thm")) \
                and parts[0] != "figure":
            out.setdefault((parts[0], parts[1]), []).append(
                (parts[2], parts[3]))
    return out
