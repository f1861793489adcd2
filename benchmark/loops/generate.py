"""Closed-loop generation: batches of ``batch`` shapes back to back.

Each unit is one call of the program's ``sample_generation`` on a batch
whose draws (z, cimle_noise, x_T, the step noise) and part-presence patterns
come from the run's seed and the batch's index; the unit ends when the card
has finished it. The check picks ``check_shapes`` of the window's shapes
from the seed and runs the plain reference on the same weights and draws.
Compared: ``gen_rel_l2``, the largest relative L2 distance of a checked
shape from the reference's.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

import inputs
import program
from reference.generation import Generation

# The control's precision: the model's products one step below the
# configuration's bfloat16.
CONTROL = "fp8"


def setup(run):
    st = SimpleNamespace(B=run.traffic["batch"], preds=[])
    st.model, st.weights = program.build(run.config, run.seed, run.device)
    generate(run, st, "warmup")
    st.preds.clear()
    return st


def generate(run, st, key):
    """One batch through the program; its shapes stay on the device."""
    from difffacto_torch import sample_generation

    model = run.config["model"]
    with run.span("draws"):
        valid = torch.as_tensor(inputs.presence(run.seed, key, st.B, model["num_anchors"]),
                                device=run.device)
        d = inputs.draws(run.seed, key, st.B, model, run.device)
    with run.span("sample_generation"):
        out = sample_generation(st.model, st.B, valid_id=valid, **d)
    with run.span("wait"):
        run.synchronize()
    st.preds.append(out["pred"])
    return out["pred"]


def step(run, st, i):
    generate(run, st, i)
    return {"shapes": st.B, "batches": 1}


def reference_rows(run, st, key, rows, precision="float32"):
    """The reference's shapes for ``rows`` of batch ``key``."""
    model = run.config["model"]
    d = inputs.draws(run.seed, key, st.B, model, run.device)
    valid = torch.as_tensor(inputs.presence(run.seed, key, st.B, model["num_anchors"]),
                            device=run.device)
    r = torch.as_tensor(rows, device=run.device)
    ref = Generation(st.weights, model, precision)
    return ref.sample(d["z"][r], d["cimle_noise"][r], valid[r], d["noise"][r],
                      d["step_noise"][:, r])


def rel_l2(got, want) -> float:
    """The largest relative L2 distance over the rows; inf where either side
    is not finite."""
    got, want = got.float(), want.float()
    rel = (got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)
    rel = torch.where(torch.isfinite(rel), rel, torch.full_like(rel, float("inf")))
    return float(rel.max())


def pick(run, n: int, k: int, *keys) -> np.ndarray:
    """``k`` distinct indices below ``n``, drawn from the seed."""
    return np.sort(inputs.numpy_rng(run.seed, "check", *keys).choice(n, size=min(k, n),
                                                                      replace=False))


def check(run, st, control=False):
    """({"gen_rel_l2": ...}, failed shapes). With ``control`` the checked
    shapes are the reference's in ``CONTROL`` precision instead of the
    program's."""
    failed = sum(int((~torch.isfinite(p)).flatten(1).any(dim=1).sum()) for p in st.preds)
    picks = pick(run, len(st.preds) * st.B, run.traffic["check_shapes"])
    kept = {}
    for i in picks:
        kept.setdefault(int(i) // st.B, []).append(int(i) % st.B)
    got = {b: st.preds[b][torch.as_tensor(rows, device=run.device)] for b, rows in kept.items()}
    st.preds.clear()
    st.model = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    worst = 0.0
    for b, rows in kept.items():
        want = reference_rows(run, st, b, rows)
        have = got[b] if not control else reference_rows(run, st, b, rows, CONTROL)
        worst = max(worst, rel_l2(have, want))
    return {"gen_rel_l2": worst}, failed
