"""The port's data tools (``tools/*_torch.py``) against the JAX package's.

Each peer runs with ``--cpu`` as a subprocess beside the JAX tool with
``--cpu`` on the same input, and every array of the two output files must
be equal. The clouds are seeded random points, which hold no ties for FPS.
Then the chain a PartNet user runs: ``.ply`` scans through
``tools/ply_to_txt.py`` (numpy only, shared by both packages) and
``tools/process_data_torch.py`` into the ``Partnet`` dataset; and the
PartGlot packing round trip into ``PartglotTriplet``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(tool, *args, cpu=True):
    cmd = [sys.executable, os.path.join(ROOT, "tools", tool), *map(str, args)]
    if cpu:
        cmd.append("--cpu")
    return subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=300)


def assert_same_outputs(tool, tmp_path, *args, cpu=True):
    """Run the JAX tool and its peer with ``args`` + ``--output``; every array
    of the two npz files is equal, dtypes too."""
    outs = {}
    for name in (tool, tool.replace(".py", "_torch.py")):
        out = tmp_path / f"{name}.npz"
        done = run(name, *args, "--output", out, cpu=cpu)
        assert done.returncode == 0, done.stderr
        outs[name] = np.load(out)
    want, got = outs.values()
    assert sorted(got.files) == sorted(want.files) and got.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


def dense(seed, shapes=5, points=300, n_class=4):
    rng = np.random.RandomState(seed)
    pts = (rng.randn(shapes, points, 3) * rng.uniform(0.3, 1.0, (shapes, 1, 3))).astype(np.float32)
    labels = rng.randint(0, n_class, (shapes, points))
    labels[1, labels[1] == 3] = 0  # a part absent
    return pts, labels


def test_process_data_npz(tmp_path):
    pts, labels = dense(0)
    np.savez(tmp_path / "dense.npz", points=pts, labels=labels + 1)
    assert_same_outputs("process_data.py", tmp_path, "--input", tmp_path / "dense.npz",
                        "--npoints", 128, "--label-base", 1)


def test_process_data_txt_directory(tmp_path):
    """Clouds of several lengths, some shorter than --npoints (tiled up to
    it), read by each package's native text parser."""
    rng = np.random.RandomState(1)
    txt = tmp_path / "txt"
    txt.mkdir()
    for i, n in enumerate((300, 90, 300, 200, 90)):
        rows = np.concatenate([rng.randn(n, 3), rng.rand(n, 2), rng.randint(0, 4, (n, 1))], 1)
        np.savetxt(txt / f"shape{i}.txt", rows, fmt="%.6f")
    got = assert_same_outputs("process_data.py", tmp_path, "--input", txt, "--npoints", 128)
    assert got["points"].shape == (5, 128, 3)


def test_fps_shape(tmp_path):
    pts, labels = dense(2)
    np.savez(tmp_path / "dense.npz", points=pts, labels=labels)
    got = assert_same_outputs("fps_shape.py", tmp_path, "--input", tmp_path / "dense.npz",
                              "--npoints", 96, "--clip")
    assert got["part_scale"].shape == (5, 4, 3)


def test_extract_parts(tmp_path):
    """Canonicalized parts of several lengths: those of at least --npoint
    points through FPS, the shorter ones padded, those under 10 dropped."""
    pts, labels = dense(3, shapes=6, points=256)
    labels[2, :250] = 0  # shape 2: parts of 6, and the rest in part 0
    np.savez(tmp_path / "dump.npz", pred=pts, pred_seg_mask=labels)
    got = assert_same_outputs("extract_parts.py", tmp_path, "--dump", tmp_path / "dump.npz",
                              "--npoint", 64, "--canonical")
    assert set(got.files) == {"part_0", "part_1", "part_2", "part_3"}


def test_tools_need_the_card_unless_asked_for_the_cpu(tmp_path):
    """Without --cpu a peer runs FPS on the card, and where there is none it
    fails loudly rather than falling back to the CPU."""
    pts, labels = dense(4, shapes=2, points=64)
    np.savez(tmp_path / "dense.npz", points=pts, labels=labels)
    done = run("fps_shape_torch.py", "--input", tmp_path / "dense.npz", "--output",
               tmp_path / "out.npz", "--npoints", 16, cpu=False)
    if torch.cuda.is_available():
        assert done.returncode == 0, done.stderr
    else:
        assert done.returncode != 0 and "torch.cuda.is_available() is False" in done.stderr


def write_game(tmp_path, h5py):
    rng = np.random.RandomState(0)
    S, n_seg, npt = 6, 5, 16
    with h5py.File(tmp_path / "segs.h5", "w") as f:
        f["data"] = rng.randn(S, n_seg, npt, 3).astype(np.float32)
        f["mask"] = (rng.rand(S, n_seg) > 0.2).astype(np.float32)
    game = {
        "text": [["a", "chair", "with", "thick", "legs"], ["tall", "back"], ["nice", "one"],
                 "wide seat and arms"],
        "target_chair": [0, 1, 2, 0],
        "chair_a": [0, 1, 5, 2], "chair_b": [3, 4, 0, 1], "chair_c": [1, 2, 3, 4],
    }
    with open(tmp_path / "game.pkl", "wb") as f:
        pickle.dump((game, {"a": 2, "chair": 3, "legs": 4, "back": 5}, None, None, None, None), f)
    return (n_seg, npt)


def test_pack_partglot_round_trip(tmp_path):
    """The peer's npz equals the JAX tool's and loads through the port's
    PartglotTriplet (as tests/test_metrics_data.py holds the JAX tool)."""
    h5py = pytest.importorskip("h5py")
    n_seg, npt = write_game(tmp_path, h5py)
    got = assert_same_outputs("pack_partglot.py", tmp_path, "--game-data", tmp_path / "game.pkl",
                              "--h5", tmp_path / "segs.h5", "--part-only", cpu=False)
    assert got["texts"].shape[0] == 6
    from difffacto_torch.utils.registry import DATASETS, build_from_cfg

    loader, _ = build_from_cfg(dict(type="PartglotTriplet", batch_size=2,
                                    path=str(tmp_path / "pack_partglot_torch.py.npz")), DATASETS)
    batch = next(iter(loader))
    assert batch["gt_geos"].shape == (2, n_seg, npt, 3)
    assert batch["text"].shape[0] == 2 and batch["part_indicator"].shape == (2, 4)


def test_pack_is_a_function_of_arrays():
    """``pack`` takes the frame, word2int and the clouds as arrays; no h5py."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import pack_partglot_torch as tool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    game = {"text": ["the legs", "a chair"], "target_chair": [1, 0],
            "chair_a": [0, 1], "chair_b": [1, 2], "chair_c": [2, 0]}
    segs = np.arange(3 * 2 * 4 * 3, dtype=np.float32).reshape(3, 2, 4, 3)
    packed, kept = tool.pack(game, None, segs, np.ones((3, 2), np.float32), max_len=6,
                             part_only=True)
    assert kept == 1 and packed["texts"].shape == (2, 6)
    assert tool.pack(game, None, segs, np.ones((3, 2), np.float32), max_len=6)[1] == 2
    np.testing.assert_array_equal(packed["gt_geos"][0], segs[1])
    np.testing.assert_array_equal(packed["part_indicator"][0], [0, 0, 1, 0])
    assert "import h5py" not in open(tool.__file__).read().split("def main")[0]


def write_ply(path, pts):
    with open(path, "w") as f:
        f.write(f"ply\nformat ascii 1.0\nelement vertex {len(pts)}\nproperty float x\n"
                "property float y\nproperty float z\nend_header\n")
        for p in pts:
            f.write(" ".join(f"{v:.6f}" for v in p) + "\n")


def test_ply_to_partnet_chain(tmp_path):
    """.ply scans and their .labels (1-based, padding points at the origin)
    -> tools/ply_to_txt.py -> tools/process_data_torch.py --cpu -> Partnet:
    the packed npz equals the JAX tool's, and a batch reads."""
    rng = np.random.RandomState(5)
    scans = tmp_path / "scans"
    scans.mkdir()
    for i in range(4):
        pts = rng.randn(200, 3).astype(np.float32)
        pts[-5:] = 0.0  # padding, dropped by ply_to_txt
        write_ply(scans / f"s{i}_ori.ply", pts)
        np.savetxt(scans / f"s{i}_ori.labels", rng.randint(1, 5, 200), fmt="%d")
    done = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ply_to_txt.py"),
                           "--data-dir", str(scans), "--save-dir", str(tmp_path / "txt"),
                           "--label-offset", "-1"], capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    got = assert_same_outputs("process_data.py", tmp_path, "--input", tmp_path / "txt",
                              "--npoints", 128)
    assert got["labels"].min() >= 0 and got["labels"].max() <= 3
    root = tmp_path / "partnet"
    root.mkdir()
    os.replace(tmp_path / "process_data_torch.py.npz", root / "partnet_train.npz")
    from difffacto_torch.utils.registry import DATASETS, build_from_cfg

    loader, _ = build_from_cfg(dict(type="Partnet", batch_size=2, root=str(root), npoints=64),
                               DATASETS)
    batch = next(iter(loader))
    assert batch["input"].shape == (2, 64, 3) and batch["present"].shape == (2, 4)
