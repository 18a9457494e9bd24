"""The .nww model artifact: self-contained deployable wake-word model.

Replaces the reference's ONNX export (`/root/reference/nanowakeword/_export/
onnx.py:26-88`) as the native deployment format. An `.nww` file carries:

* a JSON header describing how to rebuild the Flax module (model_type and the
  arch config keys of `modules/model.py:94-214`), the input shape, and
  metadata (`--info` surface);
* the trained classifier variables;
* optionally the feature-frontend encoder variables, so a deployed model is
  fully self-contained — the reference instead downloads mel/embedding ONNX
  separately at first run (`interpreter/models/_registry.py:34-47`).

The interpreter loads `.nww` natively into a jitted apply fn. ONNX export is
still offered for CLI-surface parity when the `onnx` package is installed
(`export_onnx_model` below); it is a host-side converter, not the deploy path.

Like the reference's exported graphs, the stored model outputs sigmoid
probabilities shaped [B, 1, 1] (`_export/onnx.py:35-44` contract).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import jax
import numpy as np
from nanowakeword_tpu import serialization

from nanowakeword_tpu.utils.logger import print_error, print_info

MAGIC = b"NWW2"
FORMAT_VERSION = 2
EXTENSION = ".nww"

# Arch-specific config keys that must survive into the artifact so the module
# can be rebuilt at load time (modules/model.py:94-214).
ARCH_CONFIG_KEYS = [
    "activation_function", "embedding_dim",
    "transformer_d_model", "transformer_n_head",
    "conformer_d_model", "conformer_n_head",
    "branchformer_d_model", "branchformer_n_head",
    "crnn_cnn_channels", "crnn_rnn_type",
    "tcn_channels", "tcn_kernel_size",
    "quartznet_config", "custom_model_config",
]


def _to_plain(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


WEIGHTS_DTYPES = ("float32", "bfloat16", "int8")

# Marks a leaf that was stored unquantized inside an int8 artifact (biases,
# norm parameters, anything below the quantization cutoff).
_NO_SCALE = np.zeros((0,), np.float32)


def int8_quantize(x, axis: int = -1):
    """Symmetric per-channel int8 along ``axis`` (the output-channel axis).

    -> (int8 array, 1-D per-channel scales), or (x, the no-scale sentinel)
    for leaves below the quantization cutoff (non-f32, <2-D, tiny). The one
    quantization recipe shared by the .nww artifact (last axis: Flax Dense
    [in, out] and conv [..., in, out] keep output channels last) and the
    ONNX exporter (whichever axis the ONNX weight layout puts channels on).
    """
    x = np.asarray(x)
    if x.dtype != np.float32 or x.ndim < 2 or x.size < 64:
        return x, _NO_SCALE
    ax = axis % x.ndim
    red = tuple(i for i in range(x.ndim) if i != ax)
    amax = np.max(np.abs(x), axis=red, keepdims=True)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale.reshape(-1)


def _int8_quantize_tree(tree):
    """-> (stored_tree, parallel scales_tree); one quantization pass."""
    is_pair = lambda p: isinstance(p, tuple)  # noqa: E731
    pairs = jax.tree_util.tree_map(int8_quantize, tree)
    stored = jax.tree_util.tree_map(lambda p: p[0], pairs, is_leaf=is_pair)
    scales = jax.tree_util.tree_map(lambda p: p[1], pairs, is_leaf=is_pair)
    return stored, scales


def _int8_dequantize_tree(stored, scales):
    def leaf(x, s):
        x, s = np.asarray(x), np.asarray(s)
        return x.astype(np.float32) * s if s.size else x
    return jax.tree_util.tree_map(leaf, stored, scales)


def save_nww(path: str, *, model, config, model_name: str,
             encoder_variables=None, extra_meta: Optional[dict] = None,
             weights_dtype: Optional[str] = None) -> str:
    """Serialize a trained Model (+ optional frontend encoder) to one file.

    weights_dtype="bfloat16" halves the artifact; weights_dtype="int8"
    stores every >=2-D float kernel as symmetric per-output-channel int8
    (~4x smaller than float32 — a ~12K-param gate student lands well under
    the reference's "~50KB lite ONNX" claim, `CHANGELOG.md:23`). Weights are
    restored to float32 at load, so training/serving code never sees the
    storage dtype. Both are useful for lite/gate models shipped to edge
    fleets.
    """
    if weights_dtype is not None and weights_dtype not in WEIGHTS_DTYPES:
        raise ValueError(f"weights_dtype must be one of {WEIGHTS_DTYPES}, "
                         f"got {weights_dtype!r}")
    arch_config = {}
    # The model's OWN config wins (a distilled student carries different
    # embedding_dim/activation than the pipeline config used to train the
    # teacher); the passed config only fills gaps.
    sources = [getattr(model, "config", None), config]
    for key in ARCH_CONFIG_KEYS:
        val = None
        for src in sources:
            if src is None:
                continue
            try:
                val = src.get(key, None)
            except Exception:  # noqa: BLE001
                val = None
            if val is not None:
                break
        if val is None:
            continue
        if hasattr(val, "to_dict"):
            val = val.to_dict()
        arch_config[key] = val
    # embedding_dim is authoritative on the model object
    arch_config["embedding_dim"] = model.embedding_dim

    header = {
        "format_version": FORMAT_VERSION,
        "model_name": model_name,
        "model_type": model.model_type,
        "input_shape": list(model.input_shape),
        "n_classes": model.n_classes,
        "embedding_dim": model.embedding_dim,
        "stateful": bool(model.stateful),
        "layer_dim": int(getattr(model, "layer_dim", 0)) or None,
        "arch_config": arch_config,
        "n_params": model.n_params(),
        "has_encoder": encoder_variables is not None,
    }
    # module hyperparams needed to re-instantiate exactly
    header["build"] = {
        "layer_dim": model._build_args["layer_dim"],
        "n_blocks": model._build_args["n_blocks"],
        "dropout_prob": model._build_args["dropout_prob"],
    }
    if extra_meta:
        header["meta"] = extra_meta

    def _cast(tree):
        """-> (stored_tree, scales_tree|None)."""
        if weights_dtype == "int8":
            return _int8_quantize_tree(_to_plain(tree))
        if weights_dtype != "bfloat16":
            return _to_plain(tree), None
        import jax.numpy as jnp

        def leaf(x):
            x = np.asarray(x)
            if x.dtype == np.float32:
                return np.asarray(jnp.asarray(x, jnp.bfloat16))
            return x
        return jax.tree_util.tree_map(leaf, tree), None

    header["weights_dtype"] = weights_dtype or "float32"
    stored_vars, var_scales = _cast(model.variables)
    payload = {"variables": stored_vars}
    if var_scales is not None:
        payload["scales"] = var_scales
    if encoder_variables is not None:
        stored_enc, enc_scales = _cast(encoder_variables)
        payload["encoder_variables"] = stored_enc
        if enc_scales is not None:
            payload["encoder_scales"] = enc_scales
    blob = serialization.msgpack_serialize(payload)
    header_bytes = json.dumps(header).encode("utf-8")

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header_bytes)))
        f.write(header_bytes)
        f.write(blob)
    print_info(f"Saved model artifact to '{path}' "
               f"({os.path.getsize(path) / 1024:.1f} KB)")
    return path


def read_nww_header(path: str) -> dict:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"'{path}' is not a .nww model artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        return json.loads(f.read(hlen).decode("utf-8"))


def load_nww(path: str):
    """-> (header dict, Model with restored variables, encoder_variables|None)."""
    from nanowakeword_tpu.models.model import Model

    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"'{path}' is not a .nww model artifact")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        payload = serialization.msgpack_restore(f.read())

    config = dict(header.get("arch_config", {}))
    build = header.get("build", {})
    model = Model(
        config=config,
        model_name=header["model_name"],
        n_classes=int(header.get("n_classes", 1)),
        input_shape=tuple(header["input_shape"]),
        model_type=header["model_type"],
        layer_dim=int(build.get("layer_dim", 128)),
        n_blocks=int(build.get("n_blocks", 1)),
        dropout_prob=float(build.get("dropout_prob", 0.5)),
    )
    weights_dtype = header.get("weights_dtype", "float32")

    def _upcast(tree, scales):
        if weights_dtype == "int8":
            return _int8_dequantize_tree(tree, scales)
        if weights_dtype != "bfloat16":
            return tree
        import jax.numpy as jnp

        def leaf(x):
            arr = np.asarray(x)
            if arr.dtype == jnp.bfloat16:
                return arr.astype(np.float32)
            return arr
        return jax.tree_util.tree_map(leaf, tree)

    restored = serialization.from_state_dict(
        model.variables,
        _upcast(payload["variables"], payload.get("scales")))
    model.load_variables(restored)
    encoder_vars = payload.get("encoder_variables")
    if encoder_vars is not None:
        encoder_vars = _upcast(encoder_vars, payload.get("encoder_scales"))
    return header, model, encoder_vars


def export_model(model, input_shape, config, model_name: str,
                 output_dir: str, encoder_variables=None,
                 weights_dtype: Optional[str] = None) -> str:
    """The built-in export step (replaces export_onnx_model in the pipeline)."""
    path = os.path.join(output_dir, model_name + EXTENSION)
    return save_nww(path, model=model, config=config, model_name=model_name,
                    encoder_variables=encoder_variables,
                    weights_dtype=weights_dtype)


def export_params_msgpack(model, model_name: str, output_dir: str) -> str:
    """Raw-parameters export (the reference's .pt state_dict analogue,
    `_export/pytorch.py:26-46`)."""
    path = os.path.join(output_dir, model_name + ".msgpack")
    print_info(f"Saving raw parameters to '{path}'")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(_to_plain(model.variables)))
    return path


def export_onnx_model(model, input_shape, config, model_name: str,
                      output_dir: str,
                      weights_dtype: Optional[str] = None) -> Optional[str]:
    """ONNX interchange export (reference `_export/onnx.py:26-88` parity).

    Self-contained: the graph is built straight from the Flax parameters and
    serialized by the bundled protobuf writer — no onnx/torch dependency.
    Covers EVERY family: the zoo (conv families, native GRU/LSTM nodes for
    recurrent ones, lowered MHSA for attention, stateful streaming_gru),
    the pipeline's distilled lite/gate students, AND user-supplied `custom`
    modules via jaxpr lowering (jaxpr_onnx.py) — matching the reference's
    torch.onnx.export-any-nn.Module contract. A custom module using a
    primitive with no ONNX lowering returns None (deploys via .nww).
    """
    from nanowakeword_tpu.export.onnx_export import SUPPORTED_TYPES, \
        export_onnx
    if model.model_type not in SUPPORTED_TYPES + ("custom", "custom_model"):
        print_error(f"ONNX export covers {SUPPORTED_TYPES} plus 'custom' "
                    f"models; '{model.model_type}' deploys via the .nww "
                    "artifact (served by the jitted runtime).")
        return None
    path = os.path.join(output_dir, model_name + ".onnx")
    try:
        # int8 is the only quantized ONNX form; bfloat16 is .nww-only
        return export_onnx(model, path, input_shape=input_shape,
                           weights_dtype=("int8" if weights_dtype == "int8"
                                          else None))
    except NotImplementedError as e:
        print_error(f"ONNX export skipped: {e}")
        return None
