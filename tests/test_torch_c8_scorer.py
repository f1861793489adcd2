"""C8's scorer probe: the CD half of both packages' protocol at full size.

Both ``compute_all_metrics`` (``difffacto_tpu/metrics/eval.py`` and the
port's ``difffacto_torch/metrics/eval.py``, on the CPU) score the same two
sets of 64 clouds of 2048 points with ``compute_emd=False``: the reference
set is shapes 0..63 of the port's synthetic data, the sample set shapes
64..127 scaled by 1.08 and jittered by N(0, 0.02^2), made from a numpy seed,
so that 1-NNA lies strictly between 0.5 and 1. 1-NNA-CD and COV-CD (counts
over the 64 shapes) must be equal, MMD-CD within 1e-5 relative. The EMD
half differs by design (the JAX package off the TPU runs the reference
auction, ``difffacto_tpu/ops/emd.py:169-176``) and is not probed.

A probe of ``ROADMAP.md`` §C item 8, outside Tier-1 (``-m slow``): several
minutes on one CPU worker.
"""

import numpy as np
import pytest

from difffacto_torch.data.synthetic import SyntheticPartDataset

KEYS = ("1-NN-CD-acc", "lgan_cov-CD", "lgan_mmd-CD")


def probe_sets():
    ds = SyntheticPartDataset(npoints=2048, size=128, seed=0)
    clouds = np.stack([ds[i]["ref"] for i in range(128)]).astype(np.float32)
    rng = np.random.RandomState(8)
    sample = 1.08 * clouds[64:] + 0.02 * rng.randn(64, 2048, 3).astype(np.float32)
    return sample.astype(np.float32), clouds[:64]


@pytest.mark.slow
def test_both_scorers_agree_on_the_cd_metrics_at_full_size():
    from difffacto_torch.metrics.eval import compute_all_metrics as port_metrics
    from difffacto_tpu.metrics.eval import compute_all_metrics as jax_metrics

    sample, ref = probe_sets()
    want = jax_metrics(sample, ref, batch_size=32, compute_emd=False)
    got = port_metrics(sample, ref, batch_size=32, compute_emd=False, device="cpu")
    print({k: (float(want[k]), float(got[k])) for k in KEYS})
    assert 0.5 < float(want["1-NN-CD-acc"]) < 1.0
    for k in KEYS[:2]:
        assert float(got[k]) == float(want[k]), (k, got[k], want[k])
    np.testing.assert_allclose(float(got["lgan_mmd-CD"]), float(want["lgan_mmd-CD"]),
                               rtol=1e-5)
