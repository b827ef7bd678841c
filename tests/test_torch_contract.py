"""The port's contract: no JAX, no reference imports, the card by default,
and kernel dispatch by the tensor's device with no fallback."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs.base import OTAConfig
from repro_torch.kernels import ops, ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, runpy, sys
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(mod.name)
        runpy.run_path("chip_smoke.py", run_name="chip_smoke_import_check")
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                     or m == "repro" or m.startswith("repro."))
        print(len([m for m in sys.modules if m.startswith("repro_torch")]))
        assert not bad, bad
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20     # every submodule loaded


def test_run_federated_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.train.paper_repro import run_federated
    x = np.zeros((2, 4, 8), np.float32)
    y = np.zeros((2, 4), np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_federated(x, y, x[0], y[0], OTAConfig(scheme="ideal"), steps=1)


def test_to_torch_defaults_to_the_card_and_carries_tuples():
    tree = ({"w": np.ones((2, 3), np.float32)},
            [np.arange(3, dtype=np.int32)], np.zeros(4, np.float32))
    out = convert.to_torch(tree, "cpu")
    assert isinstance(out, tuple) and isinstance(out[1], list)
    assert out[1][0].dtype == torch.int32 and out[0]["w"].shape == (2, 3)
    back = convert.to_numpy(out)
    np.testing.assert_array_equal(back[1][0], tree[1][0])
    if torch.cuda.is_available():
        assert convert.to_torch(tree)[2].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            convert.to_torch(tree)


def test_cpu_tensor_takes_the_plain_version():
    ops.reset_launches()
    x = torch.randn(3, 2, 64)
    y = ops.ota_project(x, seed=5, s_block=16, use_kernel=True)
    np.testing.assert_array_equal(y.numpy(),
                                  ref.ota_project_ref(x, 5, 16).numpy())
    g, d = torch.randn(3, 50), torch.randn(3, 50)
    tau = torch.tensor([0.1, 0.5, 1.0])
    sp, nd = ops.ef_sparsify(g, d, tau, use_kernel=True)
    np.testing.assert_array_equal(sp.numpy(),
                                  ref.ef_sparsify_ref(g, d, tau)[0].numpy())
    r = torch.randn(3, 2, 16)
    np.testing.assert_array_equal(
        ops.ota_project_t(r, seed=5, c=64, use_kernel=True).numpy(),
        ref.ota_project_t_ref(r, 5, 64).numpy())
    ops.amp_decode_fused(torch.randn(2, 16), seed=1, c=64, iters=3)
    assert ops.launch_counts() == {"ef_sparsify": 0, "ota_project": 0,
                                   "ota_project_t": 0, "amp_fused": 0}


def test_kernel_sources_present_and_hashed():
    from repro_torch.kernels import build
    names = {p.name for p in build.sources()}
    assert names == {"ef_sparsify.cu", "ota_project.cu", "ota_project_t.cu",
                     "amp_fused.cu"}
    for name in ("ef_sparsify", "ota_project", "ota_project_t", "amp_fused"):
        assert f"{name}_launch" in build.SIGNATURES
    assert (build.CSRC / "hash.cuh").is_file()
    assert build.library_path().name.startswith("librepro_torch_kernels_")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
