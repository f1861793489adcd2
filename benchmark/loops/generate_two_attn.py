"""Closed-loop generation with two-attention blocks: the ``generate`` loop's
unit (a batch of ``batch`` shapes through the program's
``sample_generation``, waited for) and its check, judged by the
two-attention reference (``reference/generation_two_attn.py``).

Compared: ``gen_rel_l2``, the largest relative L2 distance of a checked
shape from the reference's.
"""

from __future__ import annotations

import torch

import inputs
from loops.generate import generate, pick, rel_l2, setup, step  # noqa: F401
from reference.generation_two_attn import GenerationTwoAttn

# The control's precision: the model's products one step below the
# configuration's bfloat16.
CONTROL = "fp8"


def reference_rows(run, st, key, rows, precision="float32"):
    """The reference's shapes for ``rows`` of batch ``key``."""
    model = run.config["model"]
    d = inputs.draws(run.seed, key, st.B, model, run.device)
    valid = torch.as_tensor(inputs.presence(run.seed, key, st.B, model["num_anchors"]),
                            device=run.device)
    r = torch.as_tensor(rows, device=run.device)
    ref = GenerationTwoAttn(st.weights, model, precision)
    return ref.sample(d["z"][r], d["cimle_noise"][r], valid[r], d["noise"][r],
                      d["step_noise"][:, r])


def check(run, st, control=False):
    """({"gen_rel_l2": ...}, failed shapes), as the ``generate`` loop's check.
    With ``control`` the checked shapes are the reference's in ``CONTROL``
    precision instead of the program's."""
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
