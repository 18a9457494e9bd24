"""The in-repo layer library (nanowakeword_tpu/nn.py) against Flax linen.

Every zoo backbone and encoder is built twice from the same source: once
on `nanowakeword_tpu.nn` (the code the package runs) and once on
`flax.linen` (the library the models were first written against). The two
must agree on parameter-tree layout, initial values for a given key, the
training-mode forward (dropout draws and BatchNorm statistics included) and
the updated collections. Flax is a test-only reference here; the package
itself never imports it.
"""

import dataclasses
import importlib
import inspect
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanowakeword_tpu import nn
from nanowakeword_tpu.models import architectures as A
from nanowakeword_tpu.models import embedding as E
from nanowakeword_tpu.models.model import build_backbone

linen = pytest.importorskip("flax.linen")

INPUT_SHAPE = (16, 24)
ARCH_CONFIG = {
    "transformer_d_model": 16, "transformer_n_head": 2,
    "conformer_d_model": 16, "conformer_n_head": 2,
    "branchformer_d_model": 16, "branchformer_n_head": 2,
    "crnn_cnn_channels": [4, 8], "crnn_rnn_type": "gru",
    "tcn_channels": [8, 8], "quartznet_config": [[8, 5, 1], [16, 5, 1]],
}
ARCHS = ["dnn", "cnn", "lstm", "gru", "rnn", "streaming_gru", "transformer",
         "crnn", "tcn", "quartznet", "conformer", "e_branchformer",
         "bcresnet"]


def _flax_twin(modname: str, replace=()):
    """A copy of a package module whose `nn` is flax.linen."""
    twin_name = "_linen_twin_" + modname.rsplit(".", 1)[1]
    if twin_name in sys.modules:
        return sys.modules[twin_name]
    src = inspect.getsource(importlib.import_module(modname))
    src = src.replace("from nanowakeword_tpu import nn\n",
                      "import flax.linen as nn\n")
    for old, new in replace:
        src = src.replace(old, new)
    mod = types.ModuleType(twin_name)
    sys.modules[twin_name] = mod
    exec(compile(src, f"<linen twin of {modname}>", "exec"), mod.__dict__)
    return mod


def _twin_archs():
    _flax_twin("nanowakeword_tpu.models.fast_rnn")
    return _flax_twin(
        "nanowakeword_tpu.models.architectures",
        replace=[("from nanowakeword_tpu.models.fast_rnn import",
                  "from _linen_twin_fast_rnn import")])


def _twin_of(module, twin_mod):
    fields = {f.name: getattr(module, f.name)
              for f in dataclasses.fields(module) if f.name != "name"}
    return getattr(twin_mod, type(module).__name__)(**fields)


def _leaves_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_matches_linen(arch):
    ours, stateful = build_backbone(arch, ARCH_CONFIG, INPUT_SHAPE, 8, 2,
                                    0.2, 16, A.get_activation("relu"))
    twin = _twin_of(ours, _twin_archs())
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=(3,) + INPUT_SHAPE).astype(np.float32))
    key = jax.random.PRNGKey(7)

    v_ours = ours.init({"params": key}, x)
    v_twin = twin.init({"params": key}, x)
    _leaves_equal(v_ours, v_twin)

    # training mode: dropout draws and BatchNorm statistics must match too
    kw = dict(deterministic=False, rngs={"dropout": jax.random.PRNGKey(3)},
              mutable=["batch_stats"])
    y_ours, upd_ours = ours.apply(v_ours, x, **kw)
    y_twin, upd_twin = twin.apply(v_twin, x, **kw)
    _leaves_equal(y_ours, y_twin)
    _leaves_equal(upd_ours, upd_twin)
    # eval mode
    _leaves_equal(ours.apply(v_ours, x), twin.apply(v_twin, x))


@pytest.mark.parametrize("arch", sorted(E.ENCODER_ARCHS))
def test_encoder_matches_linen(arch):
    twin_e = _flax_twin("nanowakeword_tpu.models.embedding")
    ours = E.build_encoder(arch)
    twin = twin_e.ENCODER_ARCHS[arch]()
    mel = jnp.asarray(np.random.default_rng(1).normal(
        size=(2, E.EMB_WINDOW + 16, 32)).astype(np.float32))
    v_ours = ours.init(jax.random.PRNGKey(10), mel)
    v_twin = twin.init(jax.random.PRNGKey(10), mel)
    _leaves_equal(v_ours, v_twin)
    _leaves_equal(ours.apply(v_ours, mel), twin.apply(v_twin, mel))


class TestModuleSemantics:
    def test_auto_names_and_explicit_names(self):
        class Net(nn.Module):
            @nn.compact
            def __call__(self, x):
                x = nn.Dense(3)(x)
                x = nn.Dense(3, name="head")(x)
                return nn.Dense(2)(nn.LayerNorm()(x))

        v = Net().init(jax.random.PRNGKey(0), jnp.ones((1, 4)))
        assert sorted(v["params"]) == ["Dense_0", "Dense_1", "LayerNorm_0",
                                       "head"]

    def test_field_submodule_takes_field_name(self):
        class Outer(nn.Module):
            inner: nn.Module

            @nn.compact
            def __call__(self, x):
                return self.inner(x)

        v = Outer(inner=nn.Dense(2)).init(jax.random.PRNGKey(0),
                                          jnp.ones((1, 3)))
        assert list(v["params"]) == ["inner"]

    def test_apply_mutable_forms(self):
        bn = nn.BatchNorm(use_running_average=False)
        x = jnp.arange(12.0).reshape(4, 3)
        v = bn.init(jax.random.PRNGKey(0), x)
        # init leaves the running statistics at their initial values
        np.testing.assert_array_equal(v["batch_stats"]["mean"], np.zeros(3))
        out, upd = bn.apply(v, x, mutable=["batch_stats"])
        np.testing.assert_allclose(upd["batch_stats"]["mean"],
                                   0.01 * np.asarray(x).mean(0), rtol=1e-6)
        # the caller's variables are not mutated
        np.testing.assert_array_equal(v["batch_stats"]["mean"], np.zeros(3))
        # an empty mutable list still returns the (empty) update dict
        d = nn.Dense(2)
        vd = d.init(jax.random.PRNGKey(0), x)
        out, upd = d.apply(vd, x, mutable=[])
        assert upd == {} and out.shape == (4, 2)
        with pytest.raises(ValueError, match="not mutable"):
            bn.apply(v, x)

    def test_missing_parameter_raises(self):
        with pytest.raises(ValueError, match="missing parameter"):
            nn.Dense(2).apply({"params": {}}, jnp.ones((1, 3)))

    def test_dropout_needs_a_key_only_when_active(self):
        drop = nn.Dropout(0.5)
        x = jnp.ones((4, 8))
        np.testing.assert_array_equal(drop.apply({}, x, deterministic=True),
                                      x)
        with pytest.raises(ValueError, match="PRNG key"):
            drop.apply({}, x, deterministic=False)
        y = drop.apply({}, x, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        assert set(np.unique(np.asarray(y))) <= {0.0, 2.0}
