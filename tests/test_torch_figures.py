"""The port's paper figures (``repro_torch.benchmarks.fig2``-``fig8``)
against the reference's scripts (``benchmarks/fig2``-``fig8``) on the CPU.

Each figure runs its reference ``main`` and its port ``main`` at the tiny
scale of ``tests/torch_bench_cases.py``; the CSV rows (series, steps and
4-decimal accuracies), the comment lines and the summary's names and final
accuracies must be equal.  The gated figures are in
``tests/test_torch_figures_gates.py``.

One documented gap (ROADMAP.md §3): Fig. 2's SignSGD series on the non-IID
split.  The port's device gradients are within 3e-7 of the reference's
but not bitwise (torch's and XLA's products round in different orders);
label shards make the absent classes' gradient columns equal up to those
ulps, so the top-q_t sign selection at q_t = 7 of 170 breaks the ties
differently.  Its rows are held to 6 test samples of 200 (measured 4);
:func:`test_signsgd_noniid_gap_is_the_gradient_ulps` pins the cause.
"""
import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import compression as jcomp
from repro.core.schemes import get_scheme as jget_scheme
from repro.train import paper_repro as jpr
from repro_torch.core import compression as tcomp
from repro_torch.train import paper_repro as tpr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tests.torch_bench_cases import (  # noqa: E402,F401
    comparable, csv_rows, jcommon, one_torch_thread, run_main, tcommon, tiny,
)

FIGURES = ("fig2_schemes", "fig3_power_alloc", "fig4_power_sweep",
           "fig5_bandwidth", "fig6_devices", "fig7_s_tradeoff", "fig8_bias")
#: (figure, series) whose rows differ from the reference's (module doc)
GAP_SERIES = {("fig2", "signsgd_noniid")}
#: 6 test samples of the tiny scale's 200; measured 0.02 (4 samples)
GAP_ACC = 0.03


def assert_same_output(jlines, tlines, jsum, tsum):
    jl, tl = comparable(jlines), comparable(tlines)
    jrows, trows = csv_rows(jl), csv_rows(tl)
    assert list(trows) == list(jrows)
    for key, want in jrows.items():
        got = trows[key]
        if key in GAP_SERIES:
            assert [s for s, _ in got] == [s for s, _ in want]
            np.testing.assert_allclose([float(a) for _, a in got],
                                       [float(a) for _, a in want],
                                       rtol=0, atol=GAP_ACC)
        else:
            assert got == want, key
    assert [ln for ln in tl if "," not in ln] == \
        [ln for ln in jl if "," not in ln]
    gap_names = {f"{fig}_{series}" for fig, series in GAP_SERIES}
    assert [n for n, _, _ in tsum] == [n for n, _, _ in jsum]
    for (name, _, got), (_, _, want) in zip(tsum, jsum):
        if name in gap_names:
            assert abs(got - want) <= GAP_ACC
        else:
            assert got == want, name


@pytest.mark.parametrize("name", FIGURES)
def test_figure_rows_equal_reference(tiny, name):
    jmod = importlib.import_module(f"benchmarks.{name}")
    tmod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    jl, jexit, jsum = run_main(jmod.main)
    tl, texit, tsum = run_main(tmod.main, device="cpu")
    assert jexit is None and texit is None
    assert csv_rows(tl), "no rows printed"
    assert_same_output(jl, tl, jsum, tsum)
    for _, us, _ in tsum:
        assert us > 0


def test_signsgd_noniid_gap_is_the_gradient_ulps(tiny):
    """The first round of Fig. 2's non-IID SignSGD: the port's device
    gradients are within 1e-6 of the reference's (measured 3e-7), and the
    port's compressor is the reference's on the same gradients, so the
    selection gap comes from the gradients' ulps alone."""
    (xd, yd), _ = tcommon.dataset(iid=False)
    dim = xd.shape[-1]
    params = {"w": jnp.zeros((dim, 10)), "b": jnp.zeros(10)}
    _, unravel = ravel_pytree(params)
    want = np.asarray(jax.jit(lambda x, y: jpr.device_grads(
        params, unravel, x, y, None)[0])(jnp.asarray(xd), jnp.asarray(yd)))
    got, _ = tpr.device_grads(tpr.init_linear(dim, 10, "cpu"),
                              torch.from_numpy(xd),
                              torch.from_numpy(yd).long(), None)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    scheme = jget_scheme(jcommon.ota("signsgd"), want.shape[1], xd.shape[0])
    q0 = int(np.asarray(scheme.q_sched)[0])
    for row in got:
        np.testing.assert_array_equal(
            tcomp.signsgd_compress(row, torch.tensor(q0),
                                   scheme.q_max).numpy(),
            np.asarray(jcomp.signsgd_compress(jnp.asarray(row.numpy()), q0,
                                              scheme.q_max)))
