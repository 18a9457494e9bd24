"""Property sweep of the ONNX exporter: random architecture geometries.

The per-family parity tests (test_onnx_export.py) pin one or two geometries
each; this sweep drives the exporter across a seeded random sample of the
CONFIG SPACE — layer widths, depths, activations, per-family knobs, and
batch sizes — asserting the exported graph scores match the live Flax model
through the bundled numpy evaluator (and for a sample of cases through the
JAX ONNX runtime). Mirrors the reference's "any config exports" contract
(`/root/reference/nanowakeword/_export/onnx.py:26-88`) the way a fuzzer
would, so lowering bugs that only bite at odd widths (e.g. non-multiple-of-
head d_model splits, 1-block recurrences, widened TCN stacks) surface here.
"""

import numpy as np
import pytest

from nanowakeword_tpu.export import onnx_eval
from nanowakeword_tpu.export.onnx_export import build_onnx
from nanowakeword_tpu.models.model import Model

ACTIVATIONS = ["relu", "gelu", "silu"]


def _random_case(rng):
    family = rng.choice([
        "dnn", "cnn", "lstm", "gru", "rnn", "crnn", "tcn", "quartznet",
        "transformer", "conformer", "e_branchformer", "bcresnet"])
    config = {
        "activation_function": str(rng.choice(ACTIVATIONS)),
        "embedding_dim": int(rng.choice([16, 32, 48])),
    }
    layer_dim = int(rng.choice([8, 24, 40]))
    n_blocks = int(rng.integers(1, 4))
    if family == "crnn":
        config["crnn_cnn_channels"] = [
            int(c) for c in rng.choice([8, 16, 24, 32],
                                       size=rng.integers(2, 4))]
        config["crnn_rnn_type"] = str(rng.choice(["gru", "lstm"]))
    elif family == "tcn":
        config["tcn_channels"] = [
            int(c) for c in rng.choice([16, 32, 48, 64],
                                       size=rng.integers(2, 5))]
        config["tcn_kernel_size"] = int(rng.choice([3, 5, 7]))
    elif family == "quartznet":
        config["quartznet_config"] = [
            [int(rng.choice([64, 128, 192])), int(rng.choice([15, 23, 33])),
             1]
            for _ in range(rng.integers(1, 4))]
    elif family in ("transformer", "conformer", "e_branchformer"):
        n_head = int(rng.choice([2, 4]))
        d_model = n_head * int(rng.choice([16, 24, 36]))
        key = {"transformer": "transformer",
               "conformer": "conformer",
               "e_branchformer": "branchformer"}[family]
        config[f"{key}_d_model"] = d_model
        config[f"{key}_n_head"] = n_head
        n_blocks = int(rng.integers(1, 3))
    batch = int(rng.choice([1, 2, 5]))
    return family, config, layer_dim, n_blocks, batch


def _perturb_batch_stats(model, rng):
    import jax
    variables = dict(model.variables)
    if "batch_stats" not in variables:
        return

    def perturb(leaf):
        a = np.asarray(leaf)
        return np.abs(rng.normal(0.5, 0.3, a.shape)).astype(a.dtype) + 0.1
    variables["batch_stats"] = jax.tree_util.tree_map(
        perturb, variables["batch_stats"])
    model.load_variables(variables)


@pytest.mark.parametrize("case", range(20))
def test_random_geometry_score_parity(case):
    rng = np.random.default_rng(1000 + case)
    family, config, layer_dim, n_blocks, batch = _random_case(rng)
    model = Model(config=config, model_name=f"fuzz_{case}",
                  input_shape=(16, 96), model_type=family,
                  layer_dim=layer_dim, n_blocks=n_blocks, dropout_prob=0.1)
    _perturb_batch_stats(model, rng)

    data = build_onnx(model)
    feats = rng.normal(size=(batch, 16, 96)).astype(np.float32)
    got = onnx_eval.run(data, {"features": feats})["score"]
    logits = np.asarray(model(feats))
    want = 1.0 / (1.0 + np.exp(-logits))
    np.testing.assert_allclose(
        got.reshape(-1), want.reshape(-1), atol=2e-4,
        err_msg=f"family={family} config={config} layer_dim={layer_dim} "
                f"n_blocks={n_blocks} batch={batch}")


@pytest.mark.parametrize("case", [0, 5, 11, 17])
def test_random_geometry_on_jax_runtime(case, tmp_path):
    from nanowakeword_tpu.export.onnx_export import export_onnx
    from nanowakeword_tpu.export.onnx_jax import OnnxJaxModel

    rng = np.random.default_rng(1000 + case)
    family, config, layer_dim, n_blocks, batch = _random_case(rng)
    model = Model(config=config, model_name=f"fuzzj_{case}",
                  input_shape=(16, 96), model_type=family,
                  layer_dim=layer_dim, n_blocks=n_blocks, dropout_prob=0.1)
    _perturb_batch_stats(model, rng)

    path = tmp_path / f"fuzz_{case}.onnx"
    export_onnx(model, str(path))
    runtime = OnnxJaxModel(str(path))
    feats = rng.normal(size=(batch, 16, 96)).astype(np.float32)
    got = np.asarray(runtime(feats))
    logits = np.asarray(model(feats))
    want = 1.0 / (1.0 + np.exp(-logits))
    np.testing.assert_allclose(
        got.reshape(-1), want.reshape(-1), atol=2e-4,
        err_msg=f"family={family} config={config}")
