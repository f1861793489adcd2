"""The port's metric sweeps dealt out to gloo ranks on the CPU: bit for bit.

The JAX package's ``tests/test_metrics_mesh.py`` is the specification. Two
and four ranks (``tests/torch_dist_ranks.py``, suite "metrics") run each
sweep with ``mesh=`` (its chunks of ``batch_size`` pairs dealt out to the
ranks, the values gathered) and rank 0 runs it without; the results must be
equal (np.array_equal, not allclose): each chunk is computed as one rank
computes it. Clouds of 32 points, 60 auction iterations.
"""

import numpy as np
import pytest

from torch_dist_ranks import spawn_async


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    started = {w: spawn_async("metrics", w, tmp_path_factory.mktemp(f"metrics{w}"))
               for w in (2, 4)}
    return {w: f.result() for w, f in started.items()}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sweep", ["pairwise", "self", "paired", "all"])
def test_sweep_with_a_mesh_is_bit_identical(ranks, world, sweep):
    """``pairwise_cd_emd`` (6 x 5 with a sample mask), ``pairwise_self_cd_emd``
    (7 clouds: 21 pairs, ragged over the ranks), ``emd_cd_paired`` (9 pairs)
    and ``compute_all_metrics`` (6 against 5): the mesh's values equal one
    rank's exactly."""
    r = ranks[world][0]
    assert r[f"{sweep}_mesh"].shape == r[f"{sweep}_one"].shape
    np.testing.assert_array_equal(r[f"{sweep}_mesh"], r[f"{sweep}_one"])


@pytest.mark.parametrize("world", [2, 4])
def test_default_eval_mesh_routes(ranks, world):
    """``set_default_eval_mesh`` shards a call that names no mesh (the
    dataset ``evaluate`` hooks' path): its values equal one rank's."""
    r = ranks[world][0]
    np.testing.assert_array_equal(r["default_mesh"], r["self_one"])


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("sweep", ["pairwise", "self", "paired", "all"])
def test_every_rank_gets_the_whole_sweep(ranks, world, sweep):
    """Every rank holds the gathered values, equal to rank 0's (sha256)."""
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r[f"{sweep}_digest"], ranks[world][0][f"{sweep}_digest"])
