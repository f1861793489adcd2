"""The Runner and the CLI of the port over gloo ranks on the CPU.

Two ranks run ``tools/run_net_torch.py``'s ``main`` with ``--launcher
pytorch --cpu`` on tests/configs/tiny_gen.py (``tests/torch_dist_ranks.py``,
suite "runner"): 2 epochs straight, and 1 epoch then a resume for the
second. They are held against the same Runner in this one process, with its
step and its CIMLE re-cache replaced by the two ranks' arithmetic done in
turn (each rank's slice of the global batch, its folded stream, the means),
and against each other. No JAX here: the sharded paths are held against the
port's own one-device run.
"""

import numpy as np
import pytest
import torch

from difffacto_torch import Config
from difffacto_torch.models import select_best_noise
from difffacto_torch.parallel import fold_generator, initialize_distributed
from difffacto_torch.parallel.train import fold_rng
from difffacto_torch.runner.runner import Runner, device_batch
from torch_dist_ranks import TINY, runner_state, spawn_async

# The ranks compute with one thread each: so does this process, so that its
# one-process run of the two ranks' arithmetic sums in the same order.
torch.set_num_threads(1)
WORLD = 2


@pytest.fixture(scope="module")
def ranks_started(tmp_path_factory):
    return spawn_async("runner", WORLD, tmp_path_factory.mktemp("runner_ranks"))


@pytest.fixture(scope="module")
def spare_started(tmp_path_factory):
    return spawn_async("spare", 3, tmp_path_factory.mktemp("spare_ranks"))


@pytest.fixture(scope="module")
def ranks(ranks_started):
    return ranks_started.result()


class EmulatedRanks:
    """The W-rank dp step in one process: each rank's slice through
    ``TrainStep.local`` from the same BatchNorm statistics with its folded
    stream, the means of the gradients, scalars and statistics, then
    ``TrainStep.apply``."""

    def __init__(self, step, world):
        self.step, self.world = step, world

    def __call__(self, state, batch, rng, epoch):
        step, W = self.step, self.world
        b = batch["ref"].shape[0] // W
        start = [x.clone() for x in step.buffers]
        totals, metrics, grads, stats = [], [], [], []
        for d in range(W):
            for buf, s in zip(step.buffers, start):
                buf.copy_(s)
            local = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
            t, m, g = step.local(state, local, fold_rng(rng, d), epoch)
            totals.append(t)
            metrics.append(m)
            grads.append(g)
            stats.append([x.clone() for x in step.buffers])
        with torch.no_grad():
            for buf, s in zip(step.buffers, [sum(ss) / W for ss in zip(*stats)]):
                buf.copy_(s)
        mean_metrics = {k: sum(m[k] for m in metrics) / W for k in metrics[0]}
        # the means written into the first slice's gradient tensors, as a rank
        # writes them into its own: a norm's summation order may follow the
        # memory layout
        with torch.no_grad():
            mean = [gs[0].copy_(sum(gs) / W) for gs in zip(*grads)]
        return step.apply(state, sum(totals) / W, mean_metrics, mean, start)


def emulated_cache_noise(runner, world):
    """``Runner.cache_noise`` of ``world`` ranks in one process."""
    gen = torch.Generator().manual_seed(runner.seed + runner.epoch)
    all_noise, all_ids = [], []
    for batch in runner.train_loader:
        db = device_batch(batch, runner.device, runner._slim_train)
        b = db["ref"].shape[0] // world
        start = gen.get_state()
        selected = []
        for d in range(world):
            gen.set_state(start)
            local = {k: v[d * b:(d + 1) * b] for k, v in db.items()}
            selected.append(select_best_noise(runner.model, local,
                                              generator=fold_generator(gen, d))[2])
        all_noise.append(np.nan_to_num(torch.cat(selected).float().numpy(), nan=0.0,
                                       posinf=0.0, neginf=0.0))
        all_ids.append(np.asarray(batch["id"]))
    runner.train_loader.dataset.store_noise(all_noise, all_ids)


@pytest.fixture(scope="module")
def emulated(ranks_started, spare_started, tmp_path_factory, monkeypatch_module):
    monkeypatch_module.setenv("DIFFFACTO_EMD_ITERS", "16")
    cfg = Config(TINY)
    cfg.work_dir = str(tmp_path_factory.mktemp("emulated"))
    runner = Runner(cfg=cfg, device="cpu")
    runner._step_fn = EmulatedRanks(runner._step_fn, WORLD)
    runner.cache_noise = lambda: emulated_cache_noise(runner, WORLD)
    runner.run()
    return runner_state(runner)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.mark.parametrize("key", ["params", "buffers", "opt", "table"])
def test_two_ranks_train_as_their_arithmetic_on_one_device(emulated, ranks, key):
    """2 epochs of the 2-rank Runner (CIMLE re-cache, 4 steps, val, a
    checkpoint) against the same Runner in one process doing both ranks'
    arithmetic in turn: parameters, BatchNorm statistics, Adam's state and
    the CIMLE table equal bit for bit (a mean of two terms is exact in
    either order, and both sides compute on one thread). A tolerance would
    not help: at 2 shapes a rank, a 2e-5 difference in step 1's gradients
    (threads summing in another order) becomes 0.6% of the weights by
    step 4 through Adam and BatchNorm."""
    np.testing.assert_array_equal(ranks[0][f"straight_{key}"], emulated[key])


@pytest.mark.parametrize("key", ["params", "buffers", "opt", "table"])
def test_two_rank_resume_is_bit_for_bit(ranks, key):
    """1 epoch, a checkpoint, a new pair of ranks resumed from it for the
    second epoch: equal bit for bit to the straight 2 epochs."""
    assert ranks[0]["resumed_epoch"] == ranks[0]["straight_epoch"] == 2
    assert ranks[0]["first_epoch"] == 1
    np.testing.assert_array_equal(ranks[0][f"resumed_{key}"], ranks[0][f"straight_{key}"])


@pytest.mark.parametrize("key", ["straight_digest", "first_digest", "resumed_digest", "val_digest"])
def test_every_rank_holds_rank_0s_state(ranks, key):
    """After each run every rank holds rank 0's weights, optimizer state
    and CIMLE table, and val's metrics (sharded decode, gathered) agree:
    equal sha256 digests."""
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r][key], ranks[0][key])


def test_two_rank_val_metrics_are_finite(ranks):
    """The 12 metrics of the 2-rank val (generation sharded over the data
    mesh) are finite."""
    assert ranks[0]["val_metrics"].shape == (12,)
    assert np.isfinite(ranks[0]["val_metrics"]).all()


def test_a_rank_past_the_batch_idles(spare_started):
    """3 ranks, batch 4: the data mesh is the largest rank count that divides
    the batch (2, ``runner.py:198-203``); ranks 0 and 1 train one epoch to
    the same weights, rank 2 idles and stays at epoch 0."""
    ranks = spare_started.result()
    assert [int(r["spare"]) for r in ranks] == [0, 0, 1]
    assert [int(r["epoch"]) for r in ranks] == [1, 1, 0]
    np.testing.assert_array_equal(ranks[1]["digest"], ranks[0]["digest"])


def test_launcher_without_a_process_group_refuses(monkeypatch):
    """``--launcher pytorch`` where no ``torch.distributed.run`` environment
    exists raises instead of training alone; without ``--launcher`` nothing
    is asked of it."""
    from difffacto_torch.runner.cli import main

    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="--launcher pytorch requested"):
        main(["--config-file", TINY, "--launcher", "pytorch", "--cpu"])
    assert initialize_distributed("cpu") is False


@pytest.mark.parametrize("flags", [["--runner", "pretrain"], ["--task", "interpolation"],
                                   ["--task", "mixing"]])
def test_launcher_refuses_the_single_device_paths(flags):
    """``--launcher pytorch`` with the pretrain runner or an editing task,
    which have no sharded path, raises before it joins a process group."""
    from difffacto_torch.runner.cli import main

    with pytest.raises(NotImplementedError, match="--launcher pytorch"):
        main(["--config-file", TINY, "--launcher", "pytorch", "--cpu"] + flags)
    assert not torch.distributed.is_initialized()


def test_launcher_rank_without_a_card_refuses(monkeypatch):
    """A ``--launcher pytorch`` rank that is not given ``--cpu`` and sees no
    card raises: it never carries on on the CPU."""
    from difffacto_torch.runner.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main(["--config-file", TINY, "--launcher", "pytorch"])


def test_cli_takes_the_launcher_flags():
    from difffacto_torch.runner.cli import parse_args

    args = parse_args(["--config-file", TINY, "--launcher", "pytorch", "--local-rank", "3"])
    assert (args.launcher, args.local_rank) == ("pytorch", 3)
    assert parse_args(["--config-file", TINY]).launcher == "none"
