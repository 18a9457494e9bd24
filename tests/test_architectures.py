"""Architecture zoo: every model_type builds, applies, and is trainable."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanowakeword_tpu.models.model import Model

INPUT_SHAPE = (16, 96)

ALL_TYPES = [
    "dnn", "cnn", "lstm", "gru", "rnn", "transformer", "crnn", "tcn",
    "quartznet", "conformer", "e_branchformer", "bcresnet",
]

SMALL_CONFIG = {
    "activation_function": "relu",
    "embedding_dim": 32,
    "transformer_d_model": 32, "transformer_n_head": 2,
    "conformer_d_model": 32, "conformer_n_head": 2,
    "branchformer_d_model": 32, "branchformer_n_head": 2,
    "crnn_cnn_channels": [8, 16], "crnn_rnn_type": "gru",
    "tcn_channels": [16, 32], "tcn_kernel_size": 3,
    "quartznet_config": [[32, 9, 1], [64, 9, 1]],
}


def _build(model_type):
    return Model(config=dict(SMALL_CONFIG), model_name=f"test_{model_type}",
                 input_shape=INPUT_SHAPE, model_type=model_type,
                 layer_dim=16, n_blocks=2, dropout_prob=0.3)


@pytest.mark.parametrize("model_type", ALL_TYPES)
def test_forward_shape(model_type):
    model = _build(model_type)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(4,) + INPUT_SHAPE).astype(np.float32))
    logits = model(x)
    assert logits.shape == (4, 1)
    assert np.isfinite(np.asarray(logits)).all()


@pytest.mark.parametrize("model_type", ["dnn", "gru", "crnn", "bcresnet"])
def test_train_mode_needs_rngs_and_updates_stats(model_type):
    """Training apply runs with dropout rng and (where present) mutates
    batch_stats."""
    model = _build(model_type)
    x = jnp.asarray(np.random.default_rng(1).normal(
        size=(4,) + INPUT_SHAPE).astype(np.float32))
    has_bn = "batch_stats" in model.variables
    out = model.module.apply(
        model.variables, x, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)},
        mutable=["batch_stats"] if has_bn else [])
    logits = out[0] if has_bn else out[0]
    assert logits.shape == (4, 1)


def test_streaming_gru_carry():
    """The stateful streaming arch threads its carry across calls and gives
    the same result as one long sequence."""
    model = Model(config=dict(SMALL_CONFIG), model_name="sgru",
                  input_shape=INPUT_SHAPE, model_type="streaming_gru",
                  layer_dim=16, n_blocks=1, dropout_prob=0.0)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(1, 16, 96)).astype(np.float32))

    full_logits, _ = model.module.apply(model.variables, x)

    logits1, carry = model.module.apply(model.variables, x[:, :8])
    logits2, _ = model.module.apply(model.variables, x[:, 8:], carry=carry)
    np.testing.assert_allclose(np.asarray(full_logits),
                               np.asarray(logits2), rtol=1e-4, atol=1e-5)


def test_swa_averaging():
    model = _build("dnn")
    p1 = model.params
    p2 = jax.tree_util.tree_map(lambda x: x + 1.0, p1)
    avg = Model.average_models([p1, p2])
    leaf1 = jax.tree_util.tree_leaves(p1)[0]
    leafa = jax.tree_util.tree_leaves(avg)[0]
    np.testing.assert_allclose(np.asarray(leafa),
                               np.asarray(leaf1) + 0.5, rtol=1e-6)


def test_custom_model_loading(tmp_path):
    src = tmp_path / "my_arch.py"
    src.write_text(
        "from nanowakeword_tpu import nn\n"
        "class MyNet(nn.Module):\n"
        "    embedding_dim: int\n"
        "    dropout_prob: float = 0.0\n"
        "    @nn.compact\n"
        "    def __call__(self, x, deterministic=True):\n"
        "        x = x.reshape((x.shape[0], -1))\n"
        "        return nn.Dense(self.embedding_dim)(x)\n")
    cfg = dict(SMALL_CONFIG)
    cfg["custom_model_config"] = {"module_path": str(src),
                                  "class_name": "MyNet"}
    model = Model(config=cfg, model_name="custom_test",
                  input_shape=INPUT_SHAPE, model_type="custom")
    x = jnp.zeros((2,) + INPUT_SHAPE)
    assert model(x).shape == (2, 1)


@pytest.mark.parametrize("model_type", ["rnn", "lstm", "gru", "crnn"])
def test_recurrent_archs_accept_bfloat16_inputs(model_type):
    """bf16 activations against f32 params promote the scan gates to f32;
    the carry must start in the same dtype (regression: bench bf16 path)."""
    model = _build(model_type)
    x = jnp.ones((2,) + INPUT_SHAPE, jnp.bfloat16)
    out = model(x)
    assert out.shape == (2, 1)
    assert np.isfinite(np.asarray(out, np.float32)).all()
