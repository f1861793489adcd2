"""A whole run with the timed path broken underneath comes out not
correct: for each fault a cell can have, on the CPU at a tiny size. (One
chip: no cell has an exchange between chips to leave out.)"""

import pytest
import torch

import harness
from conftest import TINY_SAMPLE, TINY_VAL_GEN

# Above what the sound tiny runs read (gen_rel_l2 1e-3 to 3e-3, cd_rel
# about 1e-7, metrics exact), and the tests' EMD eps (conftest.py).
LIMITS = {"gen_rel_l2": 0.02, "fps_max_abs": 1e-5, "cd_rel": 1e-4, "emd_abs": 0.01,
          "metrics_abs": 0.0}


def run_cell(cfg, traffic, seed=2**31 + 5, units=2):
    run = harness.Run(cfg, dict(traffic), seed, torch.device("cpu"))
    drv = harness.loop(traffic["loop"])
    st = drv.setup(run)
    for i in range(units):
        drv.step(run, st, i)
    values, failed = drv.check(run, st)
    limits = {k: v for k, v in LIMITS.items() if k in values}
    return harness.judge(values, limits)[0] and failed == 0, values


def unchanged_step(monkeypatch):
    from difffacto_torch.models.diffusion import AnchoredDiffusion

    monkeypatch.setattr(AnchoredDiffusion, "p_sample",
                        lambda self, fn, x, *a, **k: {"sample": x, "pred_xstart": x})


def half_batch(monkeypatch):
    import difffacto_torch

    real = difffacto_torch.sample_generation

    def half(model, n, valid_id=None, z=None, cimle_noise=None, noise=None, step_noise=None):
        h = n // 2
        out = real(model, h, valid_id=valid_id[:h], z=z[:h], cimle_noise=cimle_noise[:h],
                   noise=noise[:h], step_noise=step_noise[:, :h])
        rest = out["pred"].mean(0, keepdim=True).expand(n - h, -1, -1)
        return {"pred": torch.cat([out["pred"], rest])}

    monkeypatch.setattr(difffacto_torch, "sample_generation", half)


def altered_answer(monkeypatch):
    from difffacto_torch.models.diffusion import AnchoredDiffusion

    real = AnchoredDiffusion.p_sample_loop

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        out["pred"] = out["pred"] + 0.05 * out["pred"].std()
        return out

    monkeypatch.setattr(AnchoredDiffusion, "p_sample_loop", altered)


def test_sound_runs_pass(tiny):
    assert run_cell(tiny(), TINY_SAMPLE)[0]
    assert run_cell(tiny(npoints=64), TINY_VAL_GEN, units=1)[0]


@pytest.mark.parametrize("fault", [unchanged_step, half_batch, altered_answer])
def test_generation_faults(tiny, monkeypatch, fault):
    fault(monkeypatch)
    ok, values = run_cell(tiny(), TINY_SAMPLE)
    assert not ok, values


def half_pairs(monkeypatch):
    import difffacto_torch.metrics.eval as ev

    real = ev.chamfer_split

    def half(x, y):
        # the first half of each chunk left out, filled with the mean of the rest
        h = x.shape[0] // 2
        dl, dr = real(x[h:], y[h:])
        return (torch.cat([dl.mean(0, keepdim=True).expand(h, -1), dl]),
                torch.cat([dr.mean(0, keepdim=True).expand(h, -1), dr]))

    monkeypatch.setattr(ev, "chamfer_split", half)


def altered_metric(monkeypatch):
    import difffacto_torch.runner.evaluation as evaluation

    real = evaluation.compute_all_metrics

    def altered(*a, **k):
        out = real(*a, **k)
        out["lgan_mmd-EMD"] += 1e-3
        return out

    monkeypatch.setattr(evaluation, "compute_all_metrics", altered)


def half_emd_launch(monkeypatch):
    import difffacto_torch.metrics.eval as ev

    real = ev.emd_cost_eval

    def half(xa, xb, *a, **k):
        # every other pair of each launch left out, filled with the mean of the
        # rest (at this size a launch's second half is the sweep's padding)
        out = real(xa[::2], xb[::2], *a, **k)
        full = out.mean().repeat(xa.shape[0])
        full[::2] = out
        return full

    monkeypatch.setattr(ev, "emd_cost_eval", half)


@pytest.mark.parametrize("fault", [unchanged_step, half_pairs, half_emd_launch, altered_metric])
def test_protocol_faults(tiny, monkeypatch, fault):
    fault(monkeypatch)
    ok, values = run_cell(tiny(npoints=64), TINY_VAL_GEN, units=1)
    assert not ok, values
