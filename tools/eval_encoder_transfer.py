"""Cross-channel transfer evaluation for a pretrained speech encoder.

New capability (no reference counterpart — the reference ships Google's
pre-trained embedding and never measures it). This is the harness behind
the shipped asset's sidecar numbers: unseen-word centroid identification
and confusable minimal-pair discrimination, on the formant channel, the
resonator channel, and the held-out telephone-EQ/reverb/clip fx chains
(`train/pretrain_encoder.evaluate_transfer`).

Usage:
    python tools/eval_encoder_transfer.py [ASSET.msgpack]
        [--words 48] [--pairs 96] [--vocab 1536] [--baseline] [--out r.json]

ASSET defaults to the bundled asset. --vocab must match the asset's
training vocabulary so eval words are sampled disjoint from it (the
sidecar records vocab_size). The 48/96 defaults are the LARGE eval
(576 pair trials per channel, ~0.02 resolution); the build-time eval
uses 24/24 (~0.04 resolution).
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("asset", nargs="?", default=None,
                   help=".msgpack encoder asset (default: bundled)")
    p.add_argument("--words", type=int, default=48)
    p.add_argument("--pairs", type=int, default=96)
    p.add_argument("--vocab", type=int, default=None,
                   help="training vocab size to exclude "
                        "(default: the asset sidecar's vocab_size)")
    p.add_argument("--baseline", action="store_true",
                   help="also score a random-init encoder")
    p.add_argument("--out", default=None, help="write the report JSON here")
    args = p.parse_args()

    from nanowakeword_tpu import serialization

    from nanowakeword_tpu.assets import speech_encoder_asset_path
    from nanowakeword_tpu.train.pretrain_encoder import (
        evaluate_transfer, sample_training_vocab)

    asset = args.asset or speech_encoder_asset_path()
    if not asset or not os.path.exists(asset):
        sys.exit(f"encoder asset not found: {asset!r}")
    with open(asset, "rb") as f:
        enc_vars = serialization.msgpack_restore(f.read())

    vocab = args.vocab
    if vocab is None:
        sidecar = asset + ".json"
        vocab = (json.load(open(sidecar)).get("vocab_size", 1536)
                 if os.path.exists(sidecar) else 1536)
    train_words = sample_training_vocab(int(vocab), seed=10,
                                        confusable_fraction=0.5)

    report = evaluate_transfer(enc_vars, train_words,
                               n_words=args.words, n_pairs=args.pairs,
                               with_random_baseline=args.baseline,
                               cross_channel=True, verbose=False)
    report["asset"] = os.path.abspath(asset)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
