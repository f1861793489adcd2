"""Pack PartGlot language-game data into the triplet npz the language
datasets read.

The PyTorch port's peer of ``tools/pack_partglot.py``, with its flags: from
PartGlot's ``game_data.pkl`` (a frame with text, target_chair and
chair_a/b/c, or a tuple whose second item is its word2int) and the
``cic_bsp.h5`` super-segment clouds (``data`` (S, n_seg, npoint, 3), ``mask``
(S, n_seg)), one npz with

  gt_geos / distractor_geos   (T, n_seg, npoint, 3)
  gt_mask / distractor_mask   (T, n_seg)
  texts                       (T, max_len) int32 token ids
  part_indicator              (T, n_class)

which ``PartglotTriplet`` reads. Text is tokenized with game_data's word2int
where it has one (its ids kept, unknown words on an id above them), else the
built-in vocabulary (``difffacto_torch.models.language``); part indicators
come from part words in the utterance (back, seat, leg, arm). The packing is
``pack`` on arrays; only ``main`` reads the h5 file (h5py).

    python tools/pack_partglot_torch.py --game-data game_data.pkl --h5 cic_bsp.h5 \
        --output packed.npz [--part-only]
"""

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

PART_WORDS = {
    "back": 0, "backrest": 0,
    "seat": 1,
    "leg": 2, "legs": 2, "wheel": 2, "wheels": 2,
    "arm": 3, "arms": 3, "armrest": 3, "armrests": 3,
}


def part_indicator_from_text(words, n_class=4):
    ind = np.zeros(n_class, np.float32)
    for w in words:
        k = PART_WORDS.get(str(w).lower().strip(".,!?"))
        if k is not None:
            ind[k] = 1.0
    return ind


def pack(game, word2int, segs, segs_mask, max_len=33, n_class=4, part_only=False):
    """The triplet arrays of ``game`` (text, target_chair, chair_a/b/c) over
    the clouds ``segs`` (S, n_seg, npoint, 3) and their ``segs_mask``:
    (dict of stacked arrays, number of utterances kept)."""
    from difffacto_torch.models.language import Vocabulary, tokenizing

    vocab = None
    if word2int:
        # PartGlot's ids as they are (pretrained embeddings index by them);
        # unknown words on an id above them, padding 0.
        vocab = Vocabulary()
        vocab.word2idx = {str(w): int(i) for w, i in dict(word2int).items()}
        vocab.word2idx.setdefault("<unk>", max(vocab.word2idx.values()) + 1)

    texts = list(game["text"])
    targets = np.asarray(game["target_chair"], np.int64)
    geo_ids = np.stack(
        [np.asarray(game[c], np.int64) for c in ("chair_a", "chair_b", "chair_c")], axis=1)
    out = {k: [] for k in ("gt_geos", "distractor_geos", "gt_mask", "distractor_mask", "texts",
                           "part_indicator")}
    kept = 0
    for i in range(len(texts)):
        words = texts[i] if isinstance(texts[i], (list, tuple)) else str(texts[i]).split()
        ind = part_indicator_from_text(words, n_class)
        if part_only and ind.sum() == 0:
            continue
        tgt = geo_ids[i, targets[i]]
        dis = [geo_ids[i, j] for j in range(3) if j != targets[i]]
        tok = tokenizing(" ".join(map(str, words)), vocab, max_len=max_len)
        for d in dis:
            out["gt_geos"].append(segs[tgt])
            out["distractor_geos"].append(segs[d])
            out["gt_mask"].append(segs_mask[tgt])
            out["distractor_mask"].append(segs_mask[d])
            out["texts"].append(tok)
            out["part_indicator"].append(ind)
        kept += 1
    return {k: np.stack(v) for k, v in out.items()}, kept


def main(argv=None):
    ap = argparse.ArgumentParser(description="PartGlot game data -> triplet npz")
    ap.add_argument("--game-data", required=True, help="game_data.pkl (PartGlot)")
    ap.add_argument("--h5", required=True, help="cic_bsp.h5 super-segment clouds")
    ap.add_argument("--output", required=True)
    ap.add_argument("--max-len", type=int, default=33)
    ap.add_argument("--n-class", type=int, default=4)
    ap.add_argument("--part-only", action="store_true",
                    help="keep only utterances naming a part (reference default)")
    args = ap.parse_args(argv)

    with open(args.game_data, "rb") as f:
        payload = pickle.load(f)
    # PartGlot's pickle is a tuple (frame, word2int, int2word, int2sn, sn2int,
    # sorted_sn); a bare frame also works
    if isinstance(payload, tuple):
        game, word2int = payload[0], payload[1]
    else:
        game, word2int = payload, None

    import h5py  # optional

    with h5py.File(args.h5, "r") as h5:
        segs = np.asarray(h5["data"], np.float32)
        segs_mask = np.asarray(h5["mask"], np.float32)

    packed, kept = pack(game, word2int, segs, segs_mask, args.max_len, args.n_class,
                        args.part_only)
    np.savez_compressed(args.output, **packed)
    print(f"kept {kept}/{len(game['text'])} utterances -> "
          + " ".join(f"{k}{v.shape}" for k, v in packed.items()))


if __name__ == "__main__":
    main()
