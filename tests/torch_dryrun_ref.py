"""The reference's dry run, production meshes and roofline on 512 forced
host devices, for ``tests/test_torch_dryrun.py`` and
``tests/test_torch_roofline.py``.

Run as a script with an output directory and a part; it runs in a process
of its own, since the device count must be set before jax starts (the
tests import it for its case tables and :class:`Reference`):

    python tests/torch_dryrun_ref.py OUT_DIR dryrun|roofline

It writes ``OUT_DIR/ref.json`` and, for each compiled record, the
reference's own JSON under ``OUT_DIR/records/`` (the files its roofline
reads).

``dryrun``: the production meshes' shapes and axis names; ``input_specs``,
``decode_window_for`` and ``SKIPS`` for every arch x shape; the records of
``SERVE_CASES`` from the reference's own ``dryrun_one``; the error its
``train_4k`` raises on the Explicit axes of ``make_production_mesh``; and
the train layouts of ``TRAIN_CASES`` from its ``TrainStep`` built on a
16 x 16 (or 2 x 16 x 16) mesh with *Auto* axes, with each argument's
per-device bytes from ``NamedSharding.shard_shape`` (nothing compiles).

``roofline``: the records of ``ROOFLINE_CASES``, ``analytic_flops`` for
every arch x shape x aggregator on both meshes, and the reference's
``load_rows`` over its records.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import traceback

if __name__ == "__main__":
    # a process of its own: 512 host devices, set before jax starts
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"

#: prefill and decode records held byte for byte: (arch, shape)
SERVE_CASES = [("smollm_360m", "decode_32k"), ("smollm_360m", "prefill_32k"),
               ("smollm_360m", "long_500k"),
               ("granite_moe_1b_a400m", "decode_32k"),
               ("rwkv6_3b", "decode_32k"), ("whisper_base", "decode_32k")]
#: train layouts: name -> (arch, multi_pod, OTA overrides)
TRAIN_CASES = {
    "smollm_flat": ("smollm_360m", False, {}),
    "smollm_flat_mp": ("smollm_360m", True, {}),
    "smollm_sliced": ("smollm_360m", False, {"layout": "sliced"}),
    "mistral_groups": ("mistral_large_123b", False, {}),
}
#: the records the roofline test reads
ROOFLINE_CASES = [("smollm_360m", "decode_32k"),
                  ("smollm_360m", "prefill_32k"),
                  ("smollm_360m", "long_500k")]
AGGREGATORS = ("a_dsgd", "ideal", None)
#: the reference's v5e constants, as its ``repro/launch/mesh.py`` has them
V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


def _leaf(x):
    return {"shape": list(x.shape), "dtype": str(x.dtype)}


def _dryrun_part(out):
    import jax
    import numpy as np
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import (ARCH_IDS, INPUT_SHAPES, TrainConfig,
                               get_config, ota_overrides)
    from repro.launch import dryrun as jdry
    from repro.launch import mesh as jmesh
    from repro.train import trainer as jtr

    meshes = {}
    for mp in (False, True):
        m = jmesh.make_production_mesh(multi_pod=mp)
        meshes["mp" if mp else "sp"] = {
            "shape": list(m.devices.shape), "axis_names": list(m.axis_names)}
    out["meshes"] = meshes

    specs = {}
    for a in ARCH_IDS:
        arch = get_config(a)
        for s, shape in INPUT_SHAPES.items():
            specs[f"{a}/{s}"] = {
                "inputs": {k: _leaf(v) for k, v in
                           jdry.input_specs(arch, shape).items()},
                "window": jdry.decode_window_for(arch, shape)}
    out["input_specs"] = specs
    out["skips"] = [[a, s, r] for (a, s), r in jdry.SKIPS.items()]
    out["long_window"] = jdry.LONG_WINDOW

    out["records"] = {}
    for a, s in SERVE_CASES:
        info = jdry.dryrun_one(a, s, False)
        out["records"][f"{a}/{s}"] = info
    try:
        jdry.dryrun_one("smollm_360m", "train_4k", False)
        out["train_error"] = None
    except Exception as e:   # noqa: BLE001 -- the error is the datum
        out["train_error"] = f"{type(e).__name__}: {e}"

    layouts = {}
    for name, (a, mp, over) in TRAIN_CASES.items():
        arch = get_config(a)
        shape = (2, 16, 16) if mp else (16, 16)
        names = ("pod", "data", "model") if mp else ("data", "model")
        mesh = jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape),
                             devices=jax.devices()[:math.prod(shape)])
        tc = TrainConfig(compute_dtype="bfloat16", remat=True,
                         total_steps=1000)
        ota = dataclasses.replace(ota_overrides(a), scheme="a_dsgd", **over)
        axes = ("pod", "data") if mp else ("data",)
        mk = (jtr.make_train_step_sliced if ota.layout == "sliced"
              else jtr.make_train_step)
        ts = mk(arch, tc, ota, mesh, ota_axes=axes, donate=True)
        aparams = jtr.abstract_params(arch)
        aopt = jax.eval_shape(lambda p: jtr.make_optimizer(tc).init(p),
                              aparams)
        batch = jdry.input_specs(arch, INPUT_SHAPES["train_4k"], tc)
        sdt = np.dtype(ota.state_dtype)

        def nbytes(tree, shardings):
            leaves = jax.tree.leaves(tree)
            shs = jax.tree.leaves(
                shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
            if len(shs) == 1 and len(leaves) > 1:
                shs = shs * len(leaves)
            return int(sum(math.prod(sh.shard_shape(lf.shape))
                           * np.dtype(lf.dtype).itemsize
                           for lf, sh in zip(leaves, shs)))

        if ota.layout == "sliced":
            sh_shape, rep_shape = ts.delta_shape
            delta = {"sh": jax.ShapeDtypeStruct(sh_shape, sdt),
                     "rep": jax.ShapeDtypeStruct(rep_shape, sdt)}
        else:
            delta = jax.ShapeDtypeStruct(ts.delta_shape, sdt)
        bsh = NamedSharding(mesh, ts.batch_spec)
        layouts[name] = dict(
            d=ts.d, d_pad=ts.d_pad, m_devices=ts.m_devices,
            delta_shape=json.loads(json.dumps(ts.delta_shape)),
            params_bytes=nbytes(aparams, ts.param_sharding),
            opt_bytes=nbytes(aopt, ts.opt_sharding),
            delta_bytes=nbytes(delta, ts.delta_sharding),
            batch_bytes=nbytes(batch, bsh))
    out["train_layouts"] = layouts


def _roofline_part(out, records_dir):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), ".."))
    from repro.configs import ARCH_IDS, INPUT_SHAPES
    from repro.launch import dryrun as jdry
    from benchmarks import roofline as jroof

    os.makedirs(records_dir, exist_ok=True)
    for a, s in ROOFLINE_CASES:
        info = jdry.dryrun_one(a, s, False)
        tag = f"{a}__{s}__sp__a_dsgd__baseline"
        with open(os.path.join(records_dir, tag + ".json"), "w") as f:
            json.dump(info, f, indent=1)
    flops = {}
    for a in ARCH_IDS:
        for s, shape in INPUT_SHAPES.items():
            for agg in AGGREGATORS:
                for n in (256, 512):
                    flops[f"{a}/{s}/{agg}/{n}"] = jroof.analytic_flops(
                        a, s, shape.kind, agg, n_chips=n)
    out["analytic_flops"] = flops
    jroof.RESULTS = records_dir
    out["rows"] = [{k: v for k, v in r.items() if k != "advice"}
                   for r in jroof.load_rows()]


def main(out_dir, part):
    out = {}
    if part == "dryrun":
        _dryrun_part(out)
    else:
        _roofline_part(out, os.path.join(out_dir, "records"))
    with open(os.path.join(out_dir, "ref.json"), "w") as f:
        json.dump(out, f, default=str)


class Reference:
    """This script for ``part`` in a subprocess of its own, started at once;
    :meth:`data` waits for it, so a test module computes the port's side
    while the reference runs (a module-scoped fixture; ``close`` at its
    teardown)."""

    def __init__(self, out_dir, part, timeout=600):
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(here, "..", "src")
        self.out_dir, self.timeout, self._data = str(out_dir), timeout, None
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), self.out_dir, part],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def data(self):
        if self._data is None:
            out, err = self.proc.communicate(timeout=self.timeout)
            assert self.proc.returncode == 0, \
                f"stdout:\n{out}\nstderr:\n{err}"
            with open(os.path.join(self.out_dir, "ref.json")) as f:
                self._data = json.load(f)
        return self._data

    def __getitem__(self, key):
        return self.data()[key]

    @property
    def records_dir(self):
        return os.path.join(self.out_dir, "records")

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


if __name__ == "__main__":
    try:
        main(sys.argv[1], sys.argv[2])
    except Exception:   # noqa: BLE001 -- reported on stderr, exit 1
        traceback.print_exc()
        sys.exit(1)
