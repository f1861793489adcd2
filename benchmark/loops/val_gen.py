"""The val_gen protocol, protocol after protocol, as the Runner runs it.

Each unit generates the configuration's ``val_gen_shapes`` shapes with the
program's ``sample_generation`` (draws and part presence from the seed and
the protocol's index, the first CIMLE hypothesis of each), copies them to
the host, and scores them with the program's ``evaluate_gen`` against as
many part-structured reference clouds of the model's ``npoints`` points,
drawn from the seed, with the ref-vs-ref block in a ``ref_self_cache`` that
set-up fills.

The check takes one protocol of the window, drawn from the seed, and judges
each stage of it against the plain reference:

* ``gen_rel_l2``: ``check_shapes`` generated shapes against the reference
  chain on the same weights and draws (relative L2, the largest);
* ``fps_max_abs``: the clouds the sweep was given (FPS to 2048 points and
  bbox-normalised, the program's) against the reference's FPS and
  normalisation of the program's shapes and of the refs (largest absolute
  difference of a coordinate);
* ``cd_rel``: every Chamfer value of the three blocks (ref x gen, gen x gen,
  ref x ref) against the reference's on the reference's clouds (largest
  relative difference);
* ``emd_abs``: EMD values against the optimal matching's mean distance
  (largest absolute difference; the protocol's auction is held to its eps).
  One pair is drawn from every ``check_pair_stride`` consecutive pairs of
  each block, in the order the program sweeps them, so that every launch of
  the EMD kernel, and its first, middle and last thread blocks, have pairs
  checked;
* ``metrics_abs``: the 12 numbers against the reference's MMD, COV and 1-NNA
  of the program's own matrices (largest absolute difference).

The sweep's matrices and clouds are read where the protocol hands them on:
the program's ``metrics.eval.pairwise_cd_emd`` and ``pairwise_self_cd_emd``
are wrapped for the run, and pass everything through unchanged.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

import inputs
import program
from loops.generate import CONTROL, pick, reference_rows, rel_l2
from reference import protocol

POINTS = 2048  # the protocol's cloud size after FPS
# The control's precision for the protocol's clouds, distances and matrices:
# one step below the float32 that the protocol states.
CONTROL_PROTOCOL = "bfloat16"
EMD_THREADS = 4  # exact assignments solved at once in the check


def record_sweeps(st):
    """Wrap the program's two sweep functions so that each call's inputs and
    matrices are kept in ``st.calls``: ("pair", a, b, (cd, emd)) or ("self",
    pts, None, (cd, emd))."""
    import difffacto_torch.metrics.eval as ev

    pair_fn, self_fn = ev.pairwise_cd_emd, ev.pairwise_self_cd_emd

    def pair(a, b, *args, **kw):
        out = pair_fn(a, b, *args, **kw)
        st.calls.append(("pair", a, b, out))
        return out

    def self_pairs(pts, *args, **kw):
        out = self_fn(pts, *args, **kw)
        st.calls.append(("self", pts, None, out))
        return out

    ev.pairwise_cd_emd, ev.pairwise_self_cd_emd = pair, self_pairs


def setup(run):
    model = run.config["model"]
    st = SimpleNamespace(B=run.config["val_gen_shapes"], calls=[], protocols=[], cache={})
    st.model, st.weights = program.build(run.config, run.seed, run.device)
    st.refs = inputs.ref_clouds(run.seed, st.B, model["npoints"], model["num_anchors"])
    record_sweeps(st)
    gen = generate(run, st, "warmup")
    evaluate(run, st, gen[:2])
    # the ref x ref block, kept in the cache for every protocol
    refs_n = next(c[1] for c in st.calls if c[0] == "pair")
    st.rr = next(c for c in st.calls if c[0] == "self" and np.array_equal(c[1], refs_n))
    st.calls.clear()
    return st


def generate(run, st, key) -> np.ndarray:
    from difffacto_torch import sample_generation

    model = run.config["model"]
    with run.span("draws"):
        valid = torch.as_tensor(inputs.presence(run.seed, key, st.B, model["num_anchors"]),
                                device=run.device)
        d = inputs.draws(run.seed, key, st.B, model, run.device)
    with run.span("sample_generation"):
        out = sample_generation(st.model, st.B, valid_id=valid, **d)
    with run.span("copy to host"):
        K = st.model.cimle_sample_num if st.model.cimle else 1
        return out["pred"].float().reshape(st.B, K, -1, 3)[:, 0].cpu().numpy()


def evaluate(run, st, gen):
    from difffacto_torch.runner.evaluation import evaluate_gen

    with run.span("evaluate_gen"):
        return evaluate_gen(gen, st.refs, ref_self_cache=st.cache, device=run.device)


def step(run, st, i):
    gen = generate(run, st, i)
    metrics = evaluate(run, st, gen)
    st.protocols.append(dict(gen=gen, metrics=metrics, calls=list(st.calls)))
    st.calls.clear()
    S, R = st.B, len(st.refs)
    return {"pairs": S * R + S * (S - 1) // 2, "protocols": 1, "shapes": S}


def _blocks(proto, rr):
    """The three blocks' (first clouds, second clouds, ii, jj, cd, emd), each
    over its pairs: ref x gen whole, and the strict upper triangle of the
    two self blocks."""
    pair = next(c for c in proto["calls"] if c[0] == "pair")
    ss = next(c for c in proto["calls"] if c[0] == "self")
    out = {}
    for name, a, b, (cd, emd) in (("rs", pair[1], pair[2], pair[3]), ("ss", ss[1], ss[1], ss[3]),
                                  ("rr", rr[1], rr[1], rr[3])):
        if name == "rs":
            ii, jj = np.meshgrid(np.arange(cd.shape[0]), np.arange(cd.shape[1]), indexing="ij")
            ii, jj = ii.ravel(), jj.ravel()
        else:
            ii, jj = np.triu_indices(cd.shape[0], k=1)
        out[name] = (np.asarray(a), np.asarray(b), ii, jj, np.asarray(cd)[ii, jj],
                     np.asarray(emd)[ii, jj])
    return out


def strata(run, n: int, stride: int, *keys) -> np.ndarray:
    """One index from each run of ``stride`` consecutive indices below
    ``n``, drawn from the seed."""
    starts = np.arange(0, n, stride)
    width = np.minimum(stride, n - starts)
    return starts + (inputs.numpy_rng(run.seed, "check", *keys).random(len(starts))
                     * width).astype(np.int64)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.abs(want)
    return float(np.max(np.where(np.isfinite(rel), rel, np.inf)))


def check(run, st, control=False):
    """The five numbers of the module's note, and the protocols that gave a
    non-finite shape or metric. With ``control`` the stages' outputs are the
    reference's: the generated shapes in ``CONTROL`` precision, the clouds,
    Chamfer and EMD values in ``CONTROL_PROTOCOL``."""
    tr, dev = run.traffic, run.device
    failed = sum(1 for p in st.protocols if not np.isfinite(p["gen"]).all()
                 or not all(np.isfinite(v) for v in p["metrics"].values()))
    key = int(pick(run, len(st.protocols), 1, "protocol")[0])
    proto = st.protocols[key]
    st.protocols, st.model = [], None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    low = CONTROL_PROTOCOL if control else None
    values = {}
    if not np.isfinite(proto["gen"]).all():
        # nothing downstream of a non-finite shape can be judged: the
        # numbers left out read as missing, and the run as not correct
        return {"gen_rel_l2": float("inf")}, failed

    rows = [int(r) for r in pick(run, st.B, tr["check_shapes"], "rows")]
    want = reference_rows(run, st, key, rows)
    have = (torch.as_tensor(proto["gen"][rows], device=dev) if not control
            else reference_rows(run, st, key, rows, CONTROL))
    values["gen_rel_l2"] = rel_l2(have, want)

    blocks = _blocks(proto, st.rr)
    gen_n = protocol.resample(proto["gen"], POINTS, dev)
    refs_n = protocol.resample(st.refs, POINTS, dev)
    got_refs, got_gen = blocks["rs"][0], blocks["rs"][1]
    if low:
        got_refs = protocol.resample(st.refs, POINTS, dev, low)
        got_gen = protocol.resample(proto["gen"], POINTS, dev, low)
    values["fps_max_abs"] = float(max(np.abs(got_refs - refs_n).max(),
                                      np.abs(got_gen - gen_n).max(),
                                      np.abs(blocks["rr"][0] - refs_n).max()))

    clouds = {"rs": (refs_n, gen_n), "ss": (gen_n, gen_n), "rr": (refs_n, refs_n)}
    cd_worst = 0.0
    for name, (a, b, ii, jj, cd, _) in blocks.items():
        want_cd = protocol.chamfer(*clouds[name], ii, jj, dev)
        got_cd = cd if not low else protocol.chamfer(*clouds[name], ii, jj, dev, low)
        cd_worst = max(cd_worst, _rel(got_cd, want_cd))
    values["cd_rel"] = cd_worst

    jobs = []
    for name, (_, _, ii, jj, _, emd) in blocks.items():
        a, b = clouds[name]
        for k in strata(run, len(ii), tr["check_pair_stride"], "pairs", name):
            jobs.append((a[ii[k]], b[jj[k]], emd[k]))
    with ThreadPoolExecutor(EMD_THREADS) as ex:
        emd_want = list(ex.map(lambda j: protocol.emd_exact(j[0], j[1]), jobs))
        emd_got = ([j[2] for j in jobs] if not low else
                   list(ex.map(lambda j: protocol.emd_exact(j[0], j[1], low), jobs)))
    gap = np.abs(np.asarray(emd_got, np.float64) - np.asarray(emd_want, np.float64))
    values["emd_abs"] = float(np.max(np.where(np.isfinite(gap), gap, np.inf)))

    pair, ss = (next(c for c in proto["calls"] if c[0] == kind) for kind in ("pair", "self"))
    mats = lambda c: {"CD": np.asarray(c[3][0]), "EMD": np.asarray(c[3][1])}
    want_m = protocol.metrics(mats(pair), mats(st.rr), mats(ss))
    values["metrics_abs"] = max(abs(proto["metrics"].get(k, np.inf) - v)
                                for k, v in want_m.items())
    return values, failed
