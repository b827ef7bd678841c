"""The reference's sharded drivers on 8 forced host devices, for
``tests/test_torch_distributed.py`` and ``tests/test_torch_sharding.py``.

Run as a script with the output path; it runs in a process of its own,
since the device count must be set before jax starts (a test imports it
for its case tables and :func:`run_reference`):

    python tests/torch_sharded_ref.py OUT.npz collectives|drivers

It writes the inputs it drew and every case's outputs into one npz.  The
sizes are small: D = 512, blocks of 64, 5 AMP iterations.
"""
import os
import sys

if __name__ == "__main__":
    # a process of its own: 8 host devices, set before jax starts
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.base import OTAConfig  # noqa: E402
from repro.core import distributed, schemes  # noqa: E402
from repro.core.schemes import MACContext, get_scheme  # noqa: E402
from repro.sharding import shard_map  # noqa: E402

D = 512
BLOCK = 64
#: the 4 x 2 (devices x shards) mesh of the slice driver, and the 8 devices
#: of round_sharded
DEV, SHARD = 4, 2
N = DEV * SHARD
GROUPS_4 = ((0, 1), (2, 3))
GROUPS_8 = ((0, 1, 2, 3), (4, 5, 6, 7))
KEY = 3


def blocked(scheme="a_dsgd", **kw):
    base = dict(scheme=scheme, projection="blocked", block_size=BLOCK,
                s_frac=0.5, k_frac=0.25, rademacher=True, p_avg=500.0,
                total_steps=10, amp_iters=5, mean_removal_steps=3,
                fading_threshold=0.3, csi_err_var=0.2, ps_antennas=4)
    base.update(kw)
    return OTAConfig(**base)


#: sharded_round cases on the 4 x 2 mesh: (scheme config, context knobs,
#: step)
SLICE_CASES = {
    "ideal": (OTAConfig(scheme="ideal", total_steps=10), {}, 0),
    "ideal_groups": (OTAConfig(scheme="ideal", total_steps=10),
                     dict(groups=GROUPS_4), 0),
    "adsgd": (blocked(), {}, 0),
    "adsgd_no_mr": (blocked(), {}, 5),
    "adsgd_shard_decode": (blocked(), dict(shard_decode=True), 0),
    "adsgd_bf16": (blocked(), dict(frame_dtype=jnp.bfloat16), 0),
    "adsgd_salt_pscale": (blocked(), dict(key_salt=3, p_scale=0.5), 0),
    "adsgd_groups_site_mac": (blocked(), dict(groups=GROUPS_4,
                                              site_mac=True), 0),
    "adsgd_groups": (blocked(), dict(groups=GROUPS_4), 0),
    "fading_site_mac": (blocked("a_dsgd_fading"),
                        dict(groups=GROUPS_4, site_mac=True,
                             site_noise_scale=1.5), 0),
    "blind": (blocked("a_dsgd_blind"), {}, 0),
}
#: and on a 3 x 2 mesh, where dividing by the device count or a group size
#: of 3 is not exact
SLICE3_CASES = {
    "ideal3": (OTAConfig(scheme="ideal", total_steps=10), {}, 0),
    "ideal3_groups": (OTAConfig(scheme="ideal", total_steps=10),
                      dict(groups=((0, 1, 2),)), 0),
    "adsgd3_groups": (blocked(), dict(groups=((0, 1, 2),)), 0),
}

#: round_sharded cases on 8 devices: (scheme config, groups, step)
ROUND_CASES = {}
for _name, _cfg in {
        "ideal": OTAConfig(scheme="ideal", total_steps=10),
        "adsgd": blocked(),
        "adsgd_fading": blocked("a_dsgd_fading"),
        "adsgd_csi_err": blocked("a_dsgd_csi_err"),
        "adsgd_blind": blocked("a_dsgd_blind"),
        "d_dsgd": OTAConfig(scheme="d_dsgd", total_steps=10, p_avg=500.0),
        "signsgd": OTAConfig(scheme="signsgd", total_steps=10, p_avg=500.0),
        "qsgd": OTAConfig(scheme="qsgd", total_steps=10, p_avg=500.0)}.items():
    ROUND_CASES[_name] = (_cfg, None, 0, N)
    ROUND_CASES[_name + "_sites"] = (_cfg, GROUPS_8, 0, N)
#: on 6 of the devices, alone and in sites of 3: divisions by M and the
#: group size that are not exact
ROUND_CASES["ideal_m6"] = (ROUND_CASES["ideal"][0], None, 0, 6)
for _name in ("ideal", "adsgd"):
    ROUND_CASES[_name + "_m6_sites"] = (ROUND_CASES[_name][0],
                                        ((0, 1, 2), (3, 4, 5)), 0, 6)


def inputs():
    rs = np.random.RandomState(0)
    grads = rs.randn(N, D).astype(np.float32)
    deltas = (0.1 * rs.randn(N, D)).astype(np.float32)
    return grads, deltas


def slice_cases():
    """(name, rows, config, knobs, step) of every slice-driver case."""
    return ([(n, DEV, *c) for n, c in SLICE_CASES.items()]
            + [(n, 3, *c) for n, c in SLICE3_CASES.items()])


def run_slice_cases(grads, deltas, out):
    spec = P("dev", "shard")
    for name, rows, cfg, knobs, step in slice_cases():
        mesh = jax.make_mesh((rows, SHARD), ("dev", "shard"),
                             devices=jax.devices()[:rows * SHARD])
        # one D-vector per device row, split over the shards
        g, dl = jnp.asarray(grads[:rows]), jnp.asarray(deltas[:rows])
        sch = get_scheme(cfg, D, rows)
        ctx = MACContext(m=rows, device_axes=("dev",),
                         shard_axes=("shard",), d_pad=D, chunk_blocks=2,
                         fading=cfg.fading, csi=sch.csi, **knobs)

        def body(g, dl, sch=sch, ctx=ctx, step=step):
            ghat, nd, met = distributed.sharded_round(
                sch, g.reshape(-1), dl.reshape(-1), step,
                jax.random.PRNGKey(KEY), ctx)
            return (ghat.reshape(1, 1, -1), nd.reshape(1, -1),
                    met["p_t"].reshape(1, 1))

        ghat, nd, p_t = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(spec, spec),
            out_specs=(P("dev", "shard"), spec, P("dev", "shard")),
            axis_names={"dev", "shard"}, check_vma=False))(g, dl)
        out[f"slice/{name}/ghat"] = np.asarray(ghat)
        out[f"slice/{name}/delta"] = np.asarray(nd)
        out[f"slice/{name}/p_t"] = np.asarray(p_t)

    # encode_slice alone: the frame, the threshold, the kept entries and
    # the new state; and the shard-folded seed
    mesh = jax.make_mesh((DEV, SHARD), ("dev", "shard"))
    g, dl = jnp.asarray(grads[:DEV]), jnp.asarray(deltas[:DEV])
    sch = get_scheme(blocked(), D, DEV)
    ctx = MACContext(m=DEV, device_axes=("dev",), shard_axes=("shard",),
                     d_pad=D, chunk_blocks=2)

    def enc(g, dl):
        frame, nd, met = sch.encode_slice(g.reshape(-1), dl.reshape(-1), 0,
                                          jax.random.PRNGKey(KEY), ctx)
        seed, shard_idx = sch._slice_seed(ctx)
        return (frame["body"][None, None], frame["slots"].reshape(1, 1, 2),
                nd.reshape(1, -1), met["tau"].reshape(1, 1),
                met["alpha"].reshape(1, 1),
                jnp.stack([seed, shard_idx]).reshape(1, 1, 2))

    sp = P("dev", "shard")
    body, slots, nd, tau, alpha, seeds = jax.jit(shard_map(
        enc, mesh=mesh, in_specs=(spec, spec),
        out_specs=(sp, sp, spec, sp, sp, sp),
        axis_names={"dev", "shard"}, check_vma=False))(g, dl)
    for k, v in dict(body=body, slots=slots, delta=nd, tau=tau, alpha=alpha,
                     seeds=seeds).items():
        out[f"encode_slice/{k}"] = np.asarray(v)


def run_round_cases(grads, deltas, out):
    for name, (cfg, groups, step, n) in ROUND_CASES.items():
        mesh = jax.make_mesh((n,), ("dev",), devices=jax.devices()[:n])
        g, dl = jnp.asarray(grads[:n]), jnp.asarray(deltas[:n])
        sch = get_scheme(cfg, D, n)
        ctx = MACContext(m=n, device_axes=("dev",), d_pad=D,
                         fading=cfg.fading, csi=sch.csi, groups=groups,
                         site_mac=groups is not None)

        def body(g, dl, sch=sch, ctx=ctx, step=step):
            ghat, nd, _ = schemes.round_sharded(
                sch, g.reshape(-1), dl.reshape(-1), step,
                jax.random.PRNGKey(KEY), ctx)
            return ghat[None], nd.reshape(1, -1)

        ghat, nd = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P("dev"), P("dev")),
            out_specs=(P("dev"), P("dev")), axis_names={"dev"},
            check_vma=False))(g, dl)
        out[f"round/{name}/ghat"] = np.asarray(ghat)
        out[f"round/{name}/delta"] = np.asarray(nd)


def run_collectives(out):
    """psum over 8 devices in float32, in bfloat16 and with groups, and
    all_gather over one and two axes, tiled and not."""
    rs = np.random.RandomState(1)
    x = (rs.randn(N, 4096) * np.exp(rs.randn(N, 1) * 3)).astype(np.float32)
    out["coll/x"] = x
    mesh = jax.make_mesh((N,), ("dev",))

    def run(body, xin, out_spec=P("dev")):
        return np.asarray(jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P("dev"),), out_specs=out_spec,
            axis_names={"dev"}, check_vma=False))(xin))

    out["coll/psum_f32"] = run(lambda v: jax.lax.psum(v, "dev"), x)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out["coll/psum_bf16"] = run(
        lambda v: jax.lax.psum(v, "dev"), xb).astype(np.float32)
    out["coll/psum_groups"] = run(lambda v: jax.lax.psum(
        v, "dev", axis_index_groups=[[0, 5, 2], [7, 1], [3, 4, 6]]), x)
    mesh2 = jax.make_mesh((DEV, SHARD), ("dev", "shard"))
    xs = jnp.asarray(x[:, :6].reshape(DEV, SHARD * 6))
    for axes in (("dev",), ("shard",), ("dev", "shard"), ("shard", "dev")):
        for tiled in (False, True):
            def body(v, axes=axes, tiled=tiled):
                r = jax.lax.all_gather(v, axes, tiled=tiled)
                return r[None]
            r = jax.jit(shard_map(
                body, mesh=mesh2, in_specs=(P("dev", "shard"),),
                out_specs=P(("dev", "shard")), axis_names={"dev", "shard"},
                check_vma=False))(xs)
            out[f"coll/all_gather/{'.'.join(axes)}/{int(tiled)}"] = \
                np.asarray(r)


def main(path, part):
    """``part``: "collectives" (the mesh's psum and all_gather) or
    "drivers" (sharded_round, encode_slice and round_sharded)."""
    out = {}
    if part == "collectives":
        run_collectives(out)
    else:
        grads, deltas = inputs()
        out.update(grads=grads, deltas=deltas)
        run_slice_cases(grads, deltas, out)
        run_round_cases(grads, deltas, out)
    np.savez(path, **out)


def run_reference(path, part, timeout=300):
    """Run this script for ``part`` in a subprocess of its own and return
    the loaded npz (for a test's module-scoped fixture)."""
    import subprocess
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(here, "..", "src")
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(path), part], capture_output=True, text=True,
                       timeout=timeout, env=env)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return dict(np.load(path))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
