"""The benchmark's own tests: CPU only, at tiny sizes, importing neither JAX
nor the JAX package. Run with ``python -m pytest benchmark/tests -q`` from
the root of the repository."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(BENCH))
sys.path.insert(0, BENCH)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason where there is none")


def tiny_model(npoints=64, steps=3):
    """gen_chair's model at a size the CPU runs in a second: every kind of
    layer present, the widths cut."""
    with open(os.path.join(BENCH, "configs", "gen_chair.json")) as f:
        cfg = json.load(f)
    m = cfg["model"]
    m.update(npoints=npoints, num_timesteps=steps)
    e = m["encoder"]
    e["encoder"]["zdim"] = 32
    e.update(latent_flow_depth=2, latent_flow_hidden_dim=32)
    e["part_aligner"].update(in_channels=32, n_heads=2, d_head=16, depth=1)
    m["diffusion"]["net"].update(depth=1, context_dim=38)
    cfg["val_gen_shapes"] = 5
    return cfg


TINY_SAMPLE = {"loop": "generate", "batch": 4, "check_shapes": 4,
               "rates": {"gen_shapes_per_s": "shapes"}, "attempted": "shapes"}
TINY_VAL_GEN = {"loop": "val_gen", "check_shapes": 2, "check_pair_stride": 2,
                "rates": {"val_pairs_per_s": "pairs"}, "attempted": "protocols"}


@pytest.fixture
def tiny(monkeypatch):
    import torch

    torch.set_num_threads(min(4, torch.get_num_threads()))
    # the CPU's auction converges in seconds at this eps; the EMD check's
    # limit in these tests is the same eps
    monkeypatch.setenv("DIFFFACTO_EMD_EPS", "0.01")
    return tiny_model


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
