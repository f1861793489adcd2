"""The host side of the persistent trunk kernel (``csrc/fused_core.cu``), on the CPU.

The wrappers compute the kernel's walk over (batch row, 128-token tile) work
items with ``ops/fused_core.schedule`` and pass its grid and tiles per row to
the kernel, which walks tile = block, block + grid, ... These tests hold that
schedule to what the walk must do: every tile exactly once, the ragged edge
covered, one block per SM or per tile. The kernel's own side (its TMA maps and
weight ring) is held against the plain version by the card tests.
"""

import pytest
import torch

from difffacto_torch.nn.functional import gelu
from difffacto_torch.ops import fused_core as fc

H100_SMS = 132


def _walk(sched, block):
    """The (batch row, first token) of each tile thread block ``block`` takes,
    in the kernel's order: tile = block, block + grid, ... < total_tiles."""
    tpr = sched["tiles_per_row"]
    return [(t // tpr, fc.TILE * (t % tpr))
            for t in range(block, sched["total_tiles"], sched["grid"])]


@pytest.mark.parametrize("B, N, sms", [
    (256, 2048, H100_SMS),  # the timed shape: 4096 tiles, 31 or 32 per block
    (32, 2048, H100_SMS),   # more tiles than twice the SMs
    (2, 1000, H100_SMS),    # ragged N
    (1, 100, H100_SMS),     # N shorter than one tile
    (1, 1000, H100_SMS),    # fewer tiles than SMs
    (3, 129, 7),            # one token past a tile, a small card
    (5, 128, 1),            # one block walks everything
    (128, 2048, 114),       # another SM count
])
def test_schedule_walks_every_tile_once(B, N, sms):
    s = fc.schedule(B, N, sms)
    tpr = -(-N // fc.TILE)
    assert s["tiles_per_row"] == tpr and s["total_tiles"] == B * tpr
    assert s["grid"] == min(sms, B * tpr) >= 1
    walked = [_walk(s, blk) for blk in range(s["grid"])]
    flat = [tile for tiles in walked for tile in tiles]
    want = {(b, fc.TILE * i) for b in range(B) for i in range(tpr)}
    assert len(flat) == len(want) and set(flat) == want
    counts = [len(tiles) for tiles in walked]
    assert max(counts) == s["tiles_per_block"] and max(counts) - min(counts) <= 1
    assert all(0 <= n0 < N for _, n0 in flat)
    for tiles in walked:  # each block's tiles in walk order
        assert tiles == sorted(tiles)


def test_schedule_tail_rows_are_the_ragged_edge():
    """At N = 1000 the last tile of a row starts at 896 and holds 104 tokens;
    the kernel zero-fills the other 24 and stores none of them."""
    s = fc.schedule(2, 1000, H100_SMS)
    starts = sorted({n0 for blk in range(s["grid"]) for _, n0 in _walk(s, blk)})
    assert starts == list(range(0, 1000, fc.TILE)) and 1000 - starts[-1] == 104


@pytest.mark.parametrize("B, N, sms", [(256, 2048, 132), (1, 100, 132), (3, 129, 7)])
def test_launch_schedule_is_the_schedule_on_the_cards_sm_count(monkeypatch, B, N, sms):
    """What the wrappers pass to the C entry points: ``schedule``'s grid and
    tiles per row at the card's SM count; the tiles reach past the last token
    by less than one tile, as the kernel requires."""
    monkeypatch.setattr(fc, "_sms", lambda index: sms)
    grid, tiles_per_row = fc.launch_schedule(B, N, torch.device("cuda", 0))
    s = fc.schedule(B, N, sms)
    assert (grid, tiles_per_row) == (s["grid"], s["tiles_per_row"])
    assert (tiles_per_row - 1) * fc.TILE < N <= tiles_per_row * fc.TILE
    assert 1 <= grid <= min(sms, B * tiles_per_row)


def test_gelu_as_a_sigmoid_is_the_tanh_form():
    """The kernel computes gelu_tanh(g) as g / (1 + exp(-2 z)) with
    z = sqrt(2/pi) (g + 0.044715 g^3): the same function, without tanh."""
    g = torch.linspace(-12, 12, 20001, dtype=torch.float64)
    z = g * (0.7978845608028654 + 0.0356774081363001 * g * g)
    torch.testing.assert_close(g / (1 + torch.exp(-2 * z)), gelu(g), rtol=1e-12, atol=1e-12)
