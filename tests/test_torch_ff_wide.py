"""The fused LN-GEGLU FF at the aligner's width D = 256 (difffacto_torch/ops/fused_ff.py,
csrc/fused_ff.cu namespace ``wide``) on the CPU.

The kernel splits the FF's 1024 GEGLU units over a cluster of 8 thread
blocks a 64-token tile (``wide_plan``), each block computing an f32 partial
of the output from its slice, and sums the 8 partials of each band of 32
output columns in rank order. ``fused_ln_geglu_ff_sliced`` is that
arithmetic in plain PyTorch; here it is held against the plain version and
against the JAX package's Pallas kernel in interpret mode, and the plan
against the tiles, slices and bands it has to cover. The kernel itself is
held against the plain version on the card (``tests/test_torch_gpu.py``).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from difffacto_tpu.ops.fused_ff import fused_ln_geglu_ff as jax_fused_ff
from difffacto_torch.ops import fused_ff
from difffacto_torch.ops.fused_core import operands

# The Pallas kernel in interpret mode against the port, as
# tests/test_torch_two_attn.py holds the plain version: f32 within 2e-4;
# bf16 within one bf16 step at the outputs' size, twice over (3.125e-2).
F32_TOL, BF16_ATOL = dict(rtol=2e-4, atol=2e-4), 3.125e-2
# The sliced sum against the plain version's one product, both f32: only
# the order of the f32 sums differs. Relative to the output's largest entry.
SLICED_REL = 1e-5


def wide_block(plan, b):
    """What block ``b`` of the grid covers, as ``wide_plan`` states it: its
    token rows, GEGLU units (of 4 D) and the output columns it sums."""
    tile, r = divmod(b, plan["cluster"])
    return dict(tokens=(tile * plan["tile"], (tile + 1) * plan["tile"]),
                units=(r * plan["slice"], (r + 1) * plan["slice"]),
                columns=(r * plan["band"], (r + 1) * plan["band"]))


@pytest.mark.parametrize("T", [1, 63, 64, 100, 128, 1024, 32768])
def test_wide_plan_covers_every_tile_slice_and_band_once(T):
    plan = fused_ff.wide_plan(T)
    assert plan["grid"] == plan["tiles"] * plan["cluster"]
    assert (plan["tiles"] - 1) * plan["tile"] < T <= plan["tiles"] * plan["tile"]
    blocks = [wide_block(plan, b) for b in range(plan["grid"])]
    assert len({(b["tokens"], b["units"]) for b in blocks}) == plan["grid"]
    for i in range(plan["tiles"]):
        tile = [b for b in blocks if b["tokens"] == (64 * i, 64 * i + 64)]
        assert len(tile) == plan["cluster"]
        units = sorted(u for b in tile for u in range(*b["units"]))
        cols = sorted(c for b in tile for c in range(*b["columns"]))
        assert units == list(range(1024)) and cols == list(range(256))


@pytest.mark.parametrize("T", [100, 128, 1024])
def test_sliced_sum_matches_plain_version(T):
    args = operands(fused_ff.example_inputs(T, 256, seed=T), "cpu", torch.float32)
    got = fused_ff.fused_ln_geglu_ff_sliced(*args)
    want = fused_ff.fused_ln_geglu_ff_reference(*args)
    assert got.shape == want.shape == (T, 256)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert rel <= SLICED_REL, rel


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 256])
def test_sliced_sum_matches_pallas_kernel(T, dtype):
    """The slice model against the Pallas kernel in interpret mode at D = 256,
    the operands in ``dtype`` and the biases f32, as on the card."""
    inp = fused_ff.example_inputs(T, 256, seed=T + 1)
    jdt = jnp.dtype(dtype)
    want = np.asarray(jax_fused_ff(
        *[jnp.asarray(v, jnp.float32 if k in ("b1", "b2") else jdt) for k, v in inp.items()],
        128, True)).astype(np.float32)
    got = fused_ff.fused_ln_geglu_ff_sliced(*operands(inp, "cpu", getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (T, 256)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_no_source_of_the_port_names_wmma():
    """Every product of the port's kernels is wgmma; no WMMA is left."""
    csrc = Path(fused_ff.__file__).resolve().parent.parent / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert sources
    assert [p.name for p in sources if "wmma" in p.read_text().lower()] == []
