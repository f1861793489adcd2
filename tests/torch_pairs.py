"""Helpers that hold a port module against its JAX counterpart on the CPU.

``bridge(jm, pm, *args)`` initialises the flax module on ``args``, moves every
parameter off its initial value (``randomize``) and every BatchNorm
statistic (means near 0, variances in [0.5, 1.5]), and loads both into the
port's module with ``load_jax_params``. ``hold(...)`` runs both on the same
inputs (the JAX side eagerly: its per-op compiles are shared by every test
of a process, where a jit would compile each test's whole program): in eval
mode in float32, in train mode in float64 on both sides (the
batch statistics, the running statistics they move), and compares every
output and every moved statistic.
"""

from __future__ import annotations

import copy

import flax
import jax
import jax.numpy as jnp
import numpy as np
import torch

from difffacto_torch import load_jax_params
from difffacto_torch.utils.jax_params import flatten_jax_tree
from test_torch_generation import randomize

TOL = dict(rtol=1e-5, atol=1e-5)
RNGS = {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1),
        "dropout": jax.random.PRNGKey(2)}


def np_(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def stats_like(stats, seed):
    """BatchNorm running statistics of the shapes of ``stats``, off their
    initial values."""
    if not stats:
        return stats
    rng = np.random.RandomState(seed)
    flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(stats))
    for key, leaf in flat.items():
        shape = np.shape(leaf)
        flat[key] = (0.1 * rng.randn(*shape) if key[-1] == "mean"
                     else 0.5 + rng.rand(*shape)).astype(np.float32)
    return flax.traverse_util.unflatten_dict(flat)


def bridge(jm, pm, *args, method=None, seed=3, jit=False, **kw):
    """Initialise ``jm`` on ``args``, randomise, load into ``pm``; the JAX
    variables. ``jit`` compiles the initialisation as one program, which
    pays for a whole model where eager flax would compile each of its ops."""
    init = lambda r, a: jm.init(r, *a, method=method, **kw)
    variables = (jax.jit(init) if jit else init)(RNGS, args)
    params = randomize(flax.core.unfreeze(variables["params"]), seed)
    stats = stats_like(variables.get("batch_stats"), seed + 1)
    load_jax_params(pm, params, stats)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64)) if np.asarray(a).dtype == np.float32
        else jnp.asarray(a), tree)


def wide(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


def leaves(tree):
    """A nested output (tuples, lists, dicts, None) as a flat list of arrays."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [np_(tree)]


def close(got, want, tol=TOL, what=""):
    got, want = leaves(got), leaves(want)
    assert len(got) == len(want), (what, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   err_msg=f"{what} output {i}", **tol)


def hold(jm, variables, pm, inputs, train, jcall, pcall, tol=TOL):
    """``jcall(jm, variables, inputs, train, **apply_kw)`` and ``pcall(pm,
    inputs, train)`` on numpy ``inputs``: eval in float32, train in float64
    with the moved BatchNorm statistics compared too. Returns (got, want)."""
    if not train:
        buffers = {n: b.clone() for n, b in pm.named_buffers()}
        want = jcall(jm, variables, [jnp.asarray(a) for a in inputs], False)
        got = pcall(pm, [torch.as_tensor(np.asarray(a)) for a in inputs], False)
        close(got, want, tol)
        assert all(torch.equal(b, buffers[n]) for n, b in pm.named_buffers())
        return got, want
    with jax.enable_x64(True):
        want, mutated = jcall(jm, f64(variables), [jnp.asarray(wide(a)) for a in inputs], True,
                              mutable=["batch_stats"])
        want = jax.tree_util.tree_map(np.asarray, want)
        moved = flatten_jax_tree(jax.device_get(mutated.get("batch_stats", {})))
    pm64 = copy.deepcopy(pm).double()
    got = pcall(pm64, [torch.as_tensor(wide(a)) for a in inputs], True)
    close(got, want, tol)
    buffers = dict(pm64.named_buffers())
    assert sorted(buffers) == sorted(moved)
    for n, b in buffers.items():
        np.testing.assert_allclose(np_(b), moved[n], err_msg=n, **tol)
    return got, want


def patch_normals(monkeypatch, module, eps):
    """``module.reparameterize_gaussian`` takes its standard normals from
    ``eps``, in order: mean + exp(logvar / 2) eps, as the JAX function."""
    queue = [jnp.asarray(e) for e in eps]

    def fake(rng, mean, logvar):
        e = queue.pop(0)
        assert e.shape == mean.shape, (e.shape, mean.shape)
        return mean + jnp.exp(0.5 * logvar) * e.astype(mean.dtype)

    monkeypatch.setattr(module, "reparameterize_gaussian", fake)
    return queue
