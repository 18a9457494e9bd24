"""Paired-bootstrap confidence interval for the encoder ship decision.

The corpus-scaling ladder decided v4 (= rung L4) over the previously
shipped v3 by ship_score 0.7899 vs 0.7625 (campaign/encoder_ladder/
ladder.json) — point estimates with no error bar. Because every rung is
scored on the SAME seeded eval draw, the comparison is paired at the
minimal-pair level: this tool synthesizes the shared 96-pair eval once
per channel (identical seeds/math to train/pretrain_encoder.
confusable_pair_accuracy: per-word clip seed 9003 + 37*i, enroll 3 /
test 3, cosine-nearest of the pair's two centroids), embeds the clips
with BOTH encoders, and bootstrap-resamples pairs to put a CI and a
P(v4 <= v3) on the ship_score difference.

The pair set excludes v4's 3072-word training vocab; sample_vocab is
sequential-deterministic, so v3's 1536-word vocab is a prefix of it and
the set is disjoint from BOTH models' training words. On this set v4's
per-channel accuracies must reproduce its recorded L4_eval.json numbers
exactly (asserted — an integrity check of the committed record); v3's
differ slightly from its sidecar because its own eval excluded only its
smaller vocab.

ship_score = mean(resonator_pair_acc, heldout_fx_pair_acc), fx = mean
of the formant_fx / resonator_fx chains (the ladder's ex-ante criterion,
tools/encoder_ladder.py).

Usage:
    python tools/ship_decision_ci.py \
        [--pairs 96] [--boot 10000] [--out campaign/encoder_ladder/ship_decision_ci.json]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_ENROLL = 3
N_TEST = 3
CLIP_SAMPLES = 24000
PAIR_SEED = 9003          # confusable_pair_accuracy's synthesis seed
CHANNELS = ("resonator", "formant_fx", "resonator_fx")


def per_pair_outcomes(embed_fn, params, clips, n_pairs):
    """[P] per-pair accuracy from the metric's exact centroid math."""
    import jax.numpy as jnp

    from nanowakeword_tpu.models.embedding import EMBEDDING_DIM

    vecs = []
    chunk = 384                        # fixed shape -> one compile, ~37 MB/upload
    for i in range(0, len(clips), chunk):
        blk = clips[i:i + chunk]
        if len(blk) < chunk:           # pad tail to the compiled shape
            pad = np.zeros((chunk - len(blk), clips.shape[1]), np.float32)
            out = np.asarray(embed_fn(params, jnp.asarray(
                np.concatenate([blk, pad]))))[:len(blk)]
        else:
            out = np.asarray(embed_fn(params, jnp.asarray(blk)))
        vecs.append(out)
    vecs = np.concatenate(vecs)
    vecs /= np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-8)
    vecs = vecs.reshape(n_pairs, 2, N_ENROLL + N_TEST, EMBEDDING_DIM)

    centroids = vecs[:, :, :N_ENROLL].mean(axis=2)
    centroids /= np.maximum(
        np.linalg.norm(centroids, axis=-1, keepdims=True), 1e-8)
    test = vecs[:, :, N_ENROLL:]
    sims = np.einsum("pwte,pce->pwtc", test, centroids)
    pred = sims.argmax(axis=-1)
    truth = np.broadcast_to(np.arange(2)[None, :, None], pred.shape)
    return (pred == truth).reshape(n_pairs, -1).mean(axis=1)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", type=int, default=96)
    p.add_argument("--boot", type=int, default=10000)
    p.add_argument("--a", default=None, metavar="NAME=PATH",
                   help="baseline asset (default v3=<bundled v3>)")
    p.add_argument("--b", default=None, metavar="NAME=PATH",
                   help="candidate asset (default v4=<bundled v4>)")
    p.add_argument("--out", default=os.path.join(
        REPO, "campaign", "encoder_ladder", "ship_decision_ci.json"))
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    from nanowakeword_tpu import serialization

    from nanowakeword_tpu.data.features import EMB_OFFSET
    from nanowakeword_tpu.models.embedding import (build_encoder,
                                                   infer_encoder_arch)
    from nanowakeword_tpu.ops import mel as melops
    from nanowakeword_tpu.train.pretrain_encoder import (
        make_confusable_pairs, sample_training_vocab,
        synthesize_word_variants)

    def parse_asset(spec, default_name, default_file):
        if spec is None:
            return default_name, os.path.join(
                REPO, "nanowakeword_tpu", "assets", default_file)
        name, _, path = spec.partition("=")
        return name, path

    name_a, path_a = parse_asset(args.a, "v3", "speech_encoder_v3.msgpack")
    name_b, path_b = parse_asset(args.b, "v4", "speech_encoder_v4.msgpack")
    assets = {name_a: path_a, name_b: path_b}
    enc_vars = {}
    for name, path in assets.items():
        with open(path, "rb") as f:
            enc_vars[name] = serialization.msgpack_restore(f.read())

    # one jitted embed shared by both assets (same wide128 geometry)
    arch = infer_encoder_arch(enc_vars[name_b])
    assert arch == infer_encoder_arch(enc_vars[name_a]), "arch mismatch"
    encoder = build_encoder(arch)

    @jax.jit
    def embed(params, audio):
        mel = melops.mel_frontend(audio, compute_dtype=jnp.bfloat16)
        return encoder.apply(params, mel[:, EMB_OFFSET:]).mean(axis=1)

    # the ladder's eval draw: exclude v4's 3072-word vocab (v3's 1536 is a
    # deterministic prefix of it -> disjoint from both models' training)
    train_words = sample_training_vocab(3072, seed=10,
                                        confusable_fraction=0.5)
    pairs = make_confusable_pairs(args.pairs, seed=515151,
                                  exclude=train_words)
    words = [w for pair in pairs for w in pair]

    outcomes = {name: {} for name in assets}
    accs = {name: {} for name in assets}
    for channel in CHANNELS:
        print(f"[ci] synthesizing {len(words)} words x "
              f"{N_ENROLL + N_TEST} variants on {channel}", flush=True)
        clips = np.concatenate([
            synthesize_word_variants(w, N_ENROLL + N_TEST, CLIP_SAMPLES,
                                     seed=PAIR_SEED + 37 * i,
                                     channel=channel)
            for i, w in enumerate(words)]).astype(np.float32)
        for name in assets:
            o = per_pair_outcomes(embed, enc_vars[name], clips, len(pairs))
            outcomes[name][channel] = o
            accs[name][channel] = float(o.mean())
            print(f"[ci]   {name} {channel}: {o.mean():.4f}", flush=True)

    def ship_vector(name):
        o = outcomes[name]
        fx = (o["formant_fx"] + o["resonator_fx"]) / 2.0
        return (o["resonator"] + fx) / 2.0          # [P]

    s_a, s_b = ship_vector(name_a), ship_vector(name_b)
    rng = np.random.default_rng(20260820)
    idx = rng.integers(0, len(s_a), (args.boot, len(s_a)))
    deltas = (s_b[idx] - s_a[idx]).mean(axis=1)
    report = {
        "criterion": "ship_score = mean(resonator_pair_acc, "
                     "heldout_fx_pair_acc); paired bootstrap over the "
                     f"{len(pairs)} shared eval pairs, {args.boot} resamples",
        "accs": accs,
        "ship_score": {name_a: float(s_a.mean()), name_b: float(s_b.mean())},
        f"delta_{name_b}_minus_{name_a}": float(s_b.mean() - s_a.mean()),
        "delta_ci95": [float(np.percentile(deltas, 2.5)),
                       float(np.percentile(deltas, 97.5))],
        f"p_{name_b}_le_{name_a}": float((deltas <= 0.0).mean()),
        "note": "all ladder evals share this seeded pair draw, so recorded "
                "per-channel accuracies reproduce exactly when an asset's "
                "own vocab exclusion drew the same pairs",
    }

    # integrity check against the committed ladder record (v4 == rung L4)
    if name_b == "v4":
        l4 = json.load(open(os.path.join(REPO, "campaign", "encoder_ladder",
                                         "L4_eval.json")))
        if args.pairs == l4["n_confusable_pairs"]:
            rec_fx = (accs["v4"]["formant_fx"]
                      + accs["v4"]["resonator_fx"]) / 2
            report["reproduces_L4_eval"] = bool(
                abs(accs["v4"]["resonator"] - l4["resonator_pair_acc"]) < 1e-9
                and abs(rec_fx - l4["heldout_fx_pair_acc"]) < 1e-9)

    print(json.dumps(report, indent=1))
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[ci] written to {args.out}", flush=True)


if __name__ == "__main__":
    main()
