"""The reference's sharded trainer and multi-rank serve step on 8 forced
host devices, for ``tests/test_torch_trainer.py``.

Run as a script with the output path; it runs in a process of its own,
since the device count must be set before jax starts (the test imports it
for its case tables and :func:`run_reference`):

    python tests/torch_trainer_ref.py OUT.npz phases|steps [CASE,...]

``phases``: the step's layouts, phase 1 and phase 2 apart (phase 2 from
phase 1's gradient stack) and the serve step; ``steps``: whole steps, of
every case of ``STEP_CASES`` or of the cases named.

The meshes have *Auto* axes: the reference's ``make_local_mesh`` gives
Explicit axes on jax 0.9.0, where its step fails (ROADMAP, North star).
The model is smollm-360m reduced in float32 with the settings of the
reference's own ``tests/test_distributed.py``.  It writes the inputs it
drew and every case's outputs into one npz (the layouts as one JSON
string under ``layout/json``).
"""
import json
import math
import os
import subprocess
import sys
from collections.abc import Mapping

if __name__ == "__main__":
    # a process of its own: 8 host devices, set before jax starts
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.flatten_util  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import OTAConfig, TrainConfig  # noqa: E402
from repro.core import distributed  # noqa: E402
from repro.core.schemes import MACContext, get_scheme  # noqa: E402
from repro.models import model as model_lib  # noqa: E402
from repro.sharding import constrain, shard_map  # noqa: E402
from repro.train import serve as jserve  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402

ARCH = "smollm_360m"
TRAIN = dict(optimizer="adam", lr=1e-3, warmup_steps=0, total_steps=50,
             compute_dtype="float32", remat=True)
OTA = dict(scheme="a_dsgd", projection="blocked", block_size=512,
           s_frac=0.25, k_frac=0.5, rademacher=True, p_avg=500.0,
           total_steps=50, amp_iters=10, mean_removal_steps=3)
BATCH = (8, 32)
STEPS = 3
#: phase 2 from phase 1's stack: the step and the key's seed
AGG_STEP, AGG_KEY = 1, 5
MESH_4X2 = ((4, 2), ("data", "model"))
MESH_2X2X2 = ((2, 2, 2), ("pod", "data", "model"))

#: layouts: (mesh, OTA overrides, ota_axes, sliced)
LAYOUT_CASES = {
    "flat": (MESH_4X2, {}, ("data",), False),
    "sliced": (MESH_4X2, {"layout": "sliced"}, ("data",), True),
    "groups": (MESH_4X2, {"num_groups": 2}, ("data",), False),
    "pod_data": (MESH_2X2X2, {}, ("pod", "data"), False),
    "site": (MESH_2X2X2, {}, ("pod",), False),
    "sliced_pod_data": (MESH_2X2X2, {"layout": "sliced"}, ("pod", "data"),
                        True),
    "bf16_state": (MESH_4X2, {"state_dtype": "bfloat16"}, ("data",), False),
}
#: phase 2 from the reference's phase-1 stack on the 4 x 2 mesh: (OTA
#: overrides, sliced)
AGG_CASES = {
    "adsgd": ({}, False),
    "ideal": ({"scheme": "ideal"}, False),
    "groups": ({"num_groups": 2}, False),
    "shard_decode": ({"shard_decode": True}, False),
    "sliced": ({"layout": "sliced"}, True),
}
#: whole steps on the 4 x 2 mesh, STEPS of them: (OTA overrides, sliced)
STEP_CASES = {
    "adsgd": ({}, False),
    "ideal": ({"scheme": "ideal"}, False),
    "sliced": ({"layout": "sliced"}, True),
    "groups": ({"num_groups": 2}, False),
}
#: the serve step on a 2 x 2 mesh: batch, prompt length, decode steps
SERVE_B, SERVE_PROMPT, SERVE_STEPS = 2, 4, 4


def arch():
    return get_config(ARCH).reduced()


def ota_cfg(**over):
    return OTAConfig(**{**OTA, **over})


def mesh(shape, names):
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(
        shape), devices=jax.devices()[:math.prod(shape)])


def _spec(s):
    """A PartitionSpec (or NamedSharding) as nested lists."""
    s = s.spec if isinstance(s, NamedSharding) else s
    return [list(e) if isinstance(e, tuple) else e for e in s]


def _spec_tree(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (NamedSharding, P)))
    return {jax.tree_util.keystr(k): _spec(v) for k, v in flat}


def make_step(ota, m, ota_axes, sliced):
    mk = jtr.make_train_step_sliced if sliced else jtr.make_train_step
    return mk(arch(), TrainConfig(**TRAIN), ota, m, ota_axes=ota_axes,
              donate=False)


def run_layouts(out):
    lay = {}
    for name, ((shape, names), over, axes, sliced) in LAYOUT_CASES.items():
        ts = make_step(ota_cfg(**over), mesh(shape, names), axes, sliced)
        params, opt_state, delta = jax.eval_shape(ts.init_state,
                                                  jax.random.PRNGKey(0))
        lay[name] = dict(
            d=ts.d, d_pad=ts.d_pad, m_devices=ts.m_devices,
            delta_shape=ts.delta_shape, batch_spec=_spec(ts.batch_spec),
            param_sharding=_spec_tree(ts.param_sharding),
            opt_sharding=_spec_tree(ts.opt_sharding),
            delta_sharding=_spec_tree(ts.delta_sharding),
            state={jax.tree_util.keystr(k): [list(v.shape), str(v.dtype)]
                   for k, v in jax.tree_util.tree_flatten_with_path(
                       (params, opt_state, delta))[0]})
    out["layout/json"] = np.array(json.dumps(lay))


def batch_tokens():
    return np.asarray(jax.random.randint(jax.random.PRNGKey(1), BATCH, 0,
                                         arch().vocab))


def phase1(m, params, batch):
    """The reference's flat ``grads_body`` under its own ``shard_map``
    (``src/repro/train/trainer.py:149-164``, 193-196)."""
    a, tc = arch(), TrainConfig(**TRAIN)
    ota_axes, auto_axes = ("data",), ("model",)
    aparams = jtr.abstract_params(a)
    d, _ = jtr.ravel_meta(aparams)
    d_pad = jtr._pad_multiple(d, OTA["block_size"] * 2)

    def grads_body(params, batch):
        def local_loss(p):
            return model_lib.loss_fn(p, a, batch, compute_dtype=jnp.float32,
                                     remat=tc.remat, loss_chunk=2048)
        (loss, metrics), grads = jax.value_and_grad(local_loss,
                                                    has_aux=True)(params)
        gflat, _ = jax.flatten_util.ravel_pytree(grads)
        gflat = jnp.pad(gflat.astype(jnp.float32), (0, d_pad - d))
        gflat = constrain(gflat, m, P(auto_axes))
        loss_g = loss
        for ax in ota_axes:
            loss_g = jax.lax.psum(loss_g, ax)
        gflat = gflat.reshape((1,) * len(ota_axes) + (d_pad,))
        return gflat, dict(metrics, global_loss=loss_g / 4)

    rep = jax.tree.map(lambda _: P(), aparams)
    fn = jax.jit(shard_map(
        grads_body, mesh=m, in_specs=(rep, {"tokens": P(ota_axes)}),
        out_specs=(P(*ota_axes, None), P()), axis_names=set(ota_axes),
        check_vma=False))
    g, met = fn(params, batch)
    return np.asarray(g), {k: np.asarray(v) for k, v in met.items()}


def phase2_flat(ota, m, g, delta, step, key):
    """The reference's flat ``agg_body`` under its ``shard_map``
    (``src/repro/train/trainer.py:123-172``, 198-203)."""
    ota_axes, auto_axes = ("data",), ("model",)
    d_pad = g.shape[-1]
    groups, m_eff = None, 4
    if ota.num_groups and ota.num_groups < 4:
        gs = 4 // ota.num_groups
        groups = [[k * gs + i for i in range(gs)]
                  for k in range(ota.num_groups)]
        m_eff = ota.num_groups
    scheme = get_scheme(ota, d_pad, m_eff)
    ctx = MACContext(
        m=m_eff, device_axes=ota_axes, shard_axes=auto_axes,
        groups=(tuple(tuple(x) for x in groups) if groups else None),
        fading=ota.fading, csi=scheme.csi, d_pad=d_pad,
        shard_decode=ota.shard_decode, use_kernel=ota.use_kernel)

    def agg_body(gs_, ds_, step, key):
        ghat, nd, met = distributed.sharded_round(
            scheme, gs_.reshape(-1), ds_.reshape(-1), step, key, ctx)
        return ghat.reshape(gs_.shape), nd.reshape(ds_.shape), met

    spec = P(*ota_axes, auto_axes)
    fn = jax.jit(shard_map(
        agg_body, mesh=m, in_specs=(spec, spec, P(), P()),
        out_specs=(P(None, auto_axes), spec, P()),
        axis_names=set(ota_axes) | set(auto_axes), check_vma=False))
    ghat, nd, met = fn(jnp.asarray(g), jnp.asarray(delta),
                       jnp.asarray(step), key)
    return (np.asarray(ghat).reshape(d_pad), np.asarray(nd),
            {k: np.asarray(v) for k, v in met.items()})


def sliced_layout(ota):
    """``(info, d_sh, d_rep, d_sh_pad, d_rep_pad, p_share_sh)`` as
    ``make_train_step_sliced`` builds them (``:255-296``)."""
    aparams = jtr.abstract_params(arch())
    from repro.sharding.specs import param_specs
    pspecs = param_specs(aparams, 2)
    info, _ = jtr._classify_leaves(aparams, pspecs)
    c = ota.block_size
    d_sh = sum(int(np.prod(lf.shape)) // 2 for _, lf, _, sh in info if sh)
    d_rep = sum(int(np.prod(lf.shape)) for _, lf, _, sh in info if not sh)
    d_sh_pad = jtr._pad_multiple(max(d_sh, c), c)
    d_rep_pad = jtr._pad_multiple(max(d_rep, c), c)
    p_share = (d_sh * 2) / (d_sh * 2 + d_rep)
    return info, pspecs, d_sh, d_rep, d_sh_pad, d_rep_pad, p_share


def phase2_sliced(ota, m, gtree, dsh, drep, step, key):
    """The reference's sliced ``agg_body`` under its ``shard_map``
    (``src/repro/train/trainer.py:298-364``, 378-419): ĝ as a tree."""
    info, pspecs, d_sh, d_rep, d_sh_pad, d_rep_pad, p_share = \
        sliced_layout(ota)
    scheme = get_scheme(ota, d_sh_pad * 2 + d_rep_pad, 4)
    ctx_sh = MACContext(m=4, device_axes=("data",), shard_axes=("model",),
                        fading=ota.fading, csi=scheme.csi,
                        d_pad=d_sh_pad * 2, p_scale=p_share)
    ctx_rep = MACContext(m=4, device_axes=("data",), shard_axes=(),
                         fading=ota.fading, csi=scheme.csi, d_pad=d_rep_pad,
                         p_scale=1.0 - p_share, key_salt=1789)

    def flat(leaves):
        if not leaves:
            return jnp.zeros((0,), jnp.float32)
        return jnp.concatenate([lf.reshape(-1) for lf in leaves])

    def agg_body(grads, delta_sh, delta_rep, step, key):
        leaves = jax.tree.leaves(grads)
        g_sh = jnp.pad(flat([lf[0] for lf, i in zip(leaves, info) if i[3]]),
                       (0, d_sh_pad - d_sh))
        g_rep = jnp.pad(flat([lf[0] for lf, i in zip(leaves, info)
                              if not i[3]]), (0, d_rep_pad - d_rep))
        ghat_sh, nd_sh, met = distributed.sharded_round(
            scheme, g_sh, delta_sh.reshape(-1), step, key, ctx_sh)
        ghat_rep, nd_rep, _ = distributed.sharded_round(
            scheme, g_rep, delta_rep.reshape(-1), step, key, ctx_rep)
        out, i_sh, i_rep = [], 0, 0
        for lf, (_, _, _, sh) in zip(leaves, info):
            shape = lf.shape[1:]
            n = int(np.prod(shape))
            if sh:
                out.append(ghat_sh[i_sh:i_sh + n].reshape(shape))
                i_sh += n
            else:
                out.append(ghat_rep[i_rep:i_rep + n].reshape(shape))
                i_rep += n
        return (jax.tree.unflatten(jax.tree.structure(grads), out),
                nd_sh.reshape(delta_sh.shape),
                nd_rep.reshape(delta_rep.shape), met)

    treedef = jax.tree.structure(pspecs, is_leaf=lambda x: isinstance(x, P))
    gspecs = jax.tree.unflatten(treedef, [P("data", *s)
                                          for _, _, s, _ in info])
    ospecs = jax.tree.unflatten(treedef, [P(*s) for _, _, s, _ in info])
    sh_spec, rep_spec = P("data", "model", None), P("data", None)
    fn = jax.jit(shard_map(
        agg_body, mesh=m,
        in_specs=(gspecs, sh_spec, rep_spec, P(), P()),
        out_specs=(ospecs, sh_spec, rep_spec, P()),
        axis_names={"data", "model"}, check_vma=False))
    ghat, nsh, nrep, met = fn(gtree, jnp.asarray(dsh), jnp.asarray(drep),
                              jnp.asarray(step), key)
    gflat, _ = jax.flatten_util.ravel_pytree(ghat)
    return (np.asarray(gflat), np.asarray(nsh), np.asarray(nrep),
            {k: np.asarray(v) for k, v in met.items()})


def run_phases(out):
    m = mesh(*MESH_4X2)
    a = arch()
    params = model_lib.init_params(a, jax.random.PRNGKey(0))
    tokens = batch_tokens()
    out["tokens"] = tokens
    g, met = phase1(m, params, {"tokens": jnp.asarray(tokens)})
    out["phase1/grads"] = g
    for k, v in met.items():
        out[f"phase1/{k}"] = v
    rs = np.random.RandomState(0)
    delta = (0.01 * rs.randn(*g.shape)).astype(np.float32)
    out["phase2/delta"] = delta
    key = jax.random.PRNGKey(AGG_KEY)
    _, unravel = jtr.ravel_meta(jtr.abstract_params(a))
    d, _ = jtr.ravel_meta(jtr.abstract_params(a))
    for name, (over, sliced) in AGG_CASES.items():
        ota = ota_cfg(**over)
        if not sliced:
            ghat, nd, met = phase2_flat(ota, m, g, delta, AGG_STEP, key)
            out[f"phase2/{name}/delta"] = nd
        else:
            rows = [unravel(jnp.asarray(g[i, :d])) for i in range(4)]
            gtree = jax.tree.map(lambda *xs: jnp.stack(xs), *rows)
            _, _, _, _, d_sh_pad, d_rep_pad, _ = sliced_layout(ota)
            dsh = (0.01 * rs.randn(4, 2, d_sh_pad)).astype(np.float32)
            drep = (0.01 * rs.randn(4, d_rep_pad)).astype(np.float32)
            out[f"phase2/{name}/delta_sh_in"] = dsh
            out[f"phase2/{name}/delta_rep_in"] = drep
            ghat, nsh, nrep, met = phase2_sliced(ota, m, gtree, dsh, drep,
                                                 AGG_STEP, key)
            out[f"phase2/{name}/delta_sh"] = nsh
            out[f"phase2/{name}/delta_rep"] = nrep
        out[f"phase2/{name}/ghat"] = ghat
        for k, v in met.items():
            out[f"phase2/{name}/{k}"] = v


def run_steps(out, cases=tuple(STEP_CASES)):
    m = mesh(*MESH_4X2)
    tokens = batch_tokens()
    out["tokens"] = tokens
    batch = {"tokens": jnp.asarray(tokens)}
    for name in cases:
        over, sliced = STEP_CASES[name]
        ts = make_step(ota_cfg(**over), m, ("data",), sliced)
        params, opt_state, delta = ts.init_state(jax.random.PRNGKey(0))
        fn = ts.jitted(batch)
        for step in range(STEPS):
            params, opt_state, delta, met = fn(
                params, opt_state, delta, batch, jnp.asarray(step),
                jax.random.PRNGKey(step))
            for k, v in met.items():
                out[f"step/{name}/{step}/{k}"] = np.asarray(v)
        out[f"step/{name}/params"] = np.asarray(
            jax.flatten_util.ravel_pytree(params)[0])
        for i, leaf in enumerate(jax.tree.leaves(delta)):
            out[f"step/{name}/delta/{i}"] = np.asarray(leaf)


def run_serve(out):
    """``make_serve_step`` on a 2 x 2 mesh in float32: a prefill and
    greedy decode steps, and its spec trees."""
    a = arch()
    ss = jserve.make_serve_step(a, mesh((2, 2), ("data", "model")), SERVE_B,
                                SERVE_PROMPT + SERVE_STEPS,
                                compute_dtype=jnp.float32,
                                cache_dtype=jnp.float32)
    out["serve/specs"] = np.array(json.dumps(dict(
        param_sharding=_spec_tree(ss.param_sharding),
        cache_sharding=_spec_tree(ss.cache_sharding))))
    # the params placed first: publish's donated identity from one device
    # onto the 2 x 2 placement fails on jax 0.9.0 (an aliasing error)
    params = ss.publish(jax.device_put(
        model_lib.init_params(a, jax.random.PRNGKey(0)), ss.param_sharding))
    prompt = np.random.RandomState(2).randint(
        0, a.vocab, (SERVE_B, SERVE_PROMPT)).astype(np.int32)
    out["serve/prompt"] = prompt
    logits, cache = ss.prefill_fn(params, ss.init_cache(jnp.float32),
                                  jnp.asarray(prompt))
    out["serve/logits/0"] = np.asarray(logits)
    for i in range(SERVE_STEPS):
        tok = jnp.argmax(logits[:, -1, :], axis=-1)[:, None].astype(
            jnp.int32)
        logits, cache = ss.decode_fn(params, cache, tok,
                                     jnp.int32(SERVE_PROMPT + i))
        out[f"serve/logits/{i + 1}"] = np.asarray(logits)


def main(path, part, cases=None):
    out = {}
    if part == "phases":
        run_layouts(out)
        run_phases(out)
        run_serve(out)
    else:
        run_steps(out, *([cases.split(",")] if cases else []))
    np.savez(path, **out)


class Reference(Mapping):
    """This script for ``part`` in a subprocess of its own, started at once;
    the npz loads on first access, so a test module computes the port's
    side while the reference runs (a module-scoped fixture; ``close`` at
    its teardown); ``cases``: the ``steps`` part's cases, all if None."""

    def __init__(self, path, part, timeout=600, cases=None):
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.path.join(here, "..", "src")
        self.path, self.timeout, self._data = path, timeout, None
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(path), part,
             *([",".join(cases)] if cases else [])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env)

    def data(self):
        if self._data is None:
            out, err = self.proc.communicate(timeout=self.timeout)
            assert self.proc.returncode == 0, \
                f"stdout:\n{out}\nstderr:\n{err}"
            self._data = dict(np.load(self.path))
        return self._data

    def __getitem__(self, key):
        return self.data()[key]

    def __iter__(self):
        return iter(self.data())

    def __len__(self):
        return len(self.data())

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


if __name__ == "__main__":
    main(*sys.argv[1:4])
