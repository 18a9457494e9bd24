"""Model-only evaluation over precomputed feature files, with model ranking.

Parity target: `/root/reference/test_model/evaluate_model_with_features.py` —
batched scoring of .npy feature sets for several models, misses/false-alarms
table ranked by total error, with batch-size fallback to 1 on failure.

Usage:
    python test_model/evaluate_model_with_features.py \
        --models a.nww b.nww --positive pos_features.npy \
        --negative neg_features.npy [--threshold 0.5] [--batch 328]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
from tqdm import tqdm

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from nanowakeword_tpu.export.artifact import load_nww  # noqa: E402
from nanowakeword_tpu.interpreter.nanointerpreter import \
    _LocalSession  # noqa: E402


def _load_scorer(model_path):
    """-> (run_batch fn, feature_length). Accepts `.nww` artifacts and
    exported `.onnx` graphs (the reference script's model format; scored
    here through the JAX ONNX runtime, export/onnx_jax.py)."""
    import jax
    import jax.numpy as jnp

    if model_path.endswith(".onnx"):
        from nanowakeword_tpu.export.onnx_jax import OnnxJaxModel
        m = OnnxJaxModel(model_path)

        def run_batch(b):
            # fixed-batch-1 conv graphs raise here; the caller's batch-1
            # fallback (reference parity) absorbs them
            return m(np.asarray(b, np.float32)).reshape(-1)

        return run_batch, int(m.input_shape[1])

    header, model, _ = load_nww(model_path)
    session = _LocalSession(model, header)

    def run_batch(b):
        probs = jax.nn.sigmoid(session.model.module.apply(
            session.model.variables, jnp.asarray(b, jnp.float32),
            deterministic=True))
        return np.asarray(probs).reshape(-1)

    return run_batch, session.feature_length


def score_features(run_batch, features, batch_size):
    """Batched sigmoid scores with fallback to batch 1 on failure."""
    out = []
    try:
        for i in tqdm(range(0, len(features), batch_size), desc="scoring"):
            out.append(run_batch(features[i:i + batch_size]))
    except Exception as e:  # noqa: BLE001
        print(f"Batched scoring failed ({e}); retrying with batch size 1.")
        out = [run_batch(features[i:i + 1]) for i in range(len(features))]
    return np.concatenate(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--models", nargs="+", required=True)
    parser.add_argument("--positive", required=True)
    parser.add_argument("--negative", required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--batch", type=int, default=328)
    args = parser.parse_args()

    pos = np.load(args.positive, mmap_mode="r")
    neg = np.load(args.negative, mmap_mode="r")
    print(f"Positive features: {pos.shape}; negative features: {neg.shape}")

    results = []
    for model_path in args.models:
        name = os.path.splitext(os.path.basename(model_path))[0]
        run_batch, T = _load_scorer(model_path)
        pos_t = np.asarray(pos[:, :T], np.float32)
        neg_t = np.asarray(neg[:, :T], np.float32)
        pos_scores = score_features(run_batch, pos_t, args.batch)
        neg_scores = score_features(run_batch, neg_t, args.batch)
        misses = int((pos_scores < args.threshold).sum())
        fas = int((neg_scores > args.threshold).sum())
        results.append((name, misses, fas, misses + fas))

    results.sort(key=lambda r: r[3])
    print("\n{:<32} {:>8} {:>12} {:>8}".format(
        "Model", "Misses", "FalseAlarms", "Total"))
    print("-" * 64)
    for name, misses, fas, total in results:
        print(f"{name:<32} {misses:>8} {fas:>12} {total:>8}")


if __name__ == "__main__":
    main()
