"""Model wrapper: backbone dispatch + shared classifier head + utilities.

Parity target: `/root/reference/nanowakeword/modules/model.py` — the `Model`
class that (a) dispatches `model_type` to a backbone with per-arch config keys
(`model.py:94-214`), including custom user modules loaded from a file path or
module name with signature-filtered kwargs (`model.py:155-211`); (b) appends
the shared classifier head Dense(E -> E/2) -> act -> Dropout -> Dense(-> 1)
(`model.py:216-221`); (c) provides SWA parameter averaging (`model.py:376-401`)
and the training-history plot (`model.py:227-361`).

Differences from the reference: parameters are immutable pytrees (params +
batch_stats collections); "state_dict" operations become pytree maps;
everything applies under jit with explicit PRNG keys.
"""

from __future__ import annotations

import collections
import importlib
import importlib.util
import inspect
import os
from typing import Any, Optional

from nanowakeword_tpu import nn
import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.models import architectures as A
from nanowakeword_tpu.utils.logger import print_info

UNSTABLE_ARCHS = {"conformer", "e_branchformer", "crnn"}


def build_backbone(model_type: str, config, input_shape, layer_dim: int,
                   n_blocks: int, dropout_prob: float, embedding_dim: int,
                   activation) -> tuple[nn.Module, bool]:
    """Dispatch model_type -> (backbone module, is_stateful).

    Config-key surface matches reference modules/model.py:94-214.
    """
    mt = model_type.lower()
    if mt == "dnn":
        return A.DNNModel(layer_dim, n_blocks, embedding_dim, dropout_prob,
                          activation), False
    if mt == "cnn":
        return A.CNNModel(embedding_dim, dropout_prob, activation), False
    if mt == "lstm":
        return A.LSTMModel(layer_dim, n_blocks, embedding_dim,
                           dropout_prob), False
    if mt == "gru":
        return A.GRUModel(layer_dim, n_blocks, embedding_dim,
                          dropout_prob), False
    if mt == "rnn":
        return A.RNNModel(n_blocks, embedding_dim, dropout_prob), False
    if mt == "streaming_gru":
        return A.StreamingGRUModel(layer_dim, n_blocks, embedding_dim,
                                   dropout_prob), True
    if mt == "transformer":
        return A.TransformerModel(
            d_model=int(config.get("transformer_d_model", 128)),
            n_head=int(config.get("transformer_n_head", 4)),
            n_layers=n_blocks, embedding_dim=embedding_dim,
            dropout_prob=dropout_prob), False
    if mt == "crnn":
        return A.CRNNModel(
            cnn_channels=tuple(config.get("crnn_cnn_channels", [16, 32, 32])),
            rnn_type=str(config.get("crnn_rnn_type", "lstm")),
            rnn_hidden_size=layer_dim, n_rnn_layers=n_blocks,
            embedding_dim=embedding_dim, dropout_prob=dropout_prob,
            activation=activation), False
    if mt == "tcn":
        return A.TCNModel(
            num_channels=tuple(config.get("tcn_channels", [64, 64, 128])),
            embedding_dim=embedding_dim,
            kernel_size=int(config.get("tcn_kernel_size", 3)),
            dropout_prob=dropout_prob), False
    if mt == "quartznet":
        qcfg = config.get("quartznet_config",
                          [[256, 33, 1], [256, 33, 1], [512, 39, 1]])
        return A.QuartzNetModel(
            quartznet_config=tuple(tuple(b) for b in qcfg),
            embedding_dim=embedding_dim, dropout_prob=dropout_prob), False
    if mt == "conformer":
        return A.ConformerModel(
            d_model=int(config.get("conformer_d_model", 144)),
            n_head=int(config.get("conformer_n_head", 4)),
            n_layers=n_blocks, embedding_dim=embedding_dim,
            dropout_prob=dropout_prob), False
    if mt == "e_branchformer":
        return A.EBranchformerModel(
            d_model=int(config.get("branchformer_d_model", 144)),
            n_head=int(config.get("branchformer_n_head", 4)),
            n_layers=n_blocks, embedding_dim=embedding_dim,
            dropout_prob=dropout_prob), False
    if mt == "bcresnet":
        return A.BcResNetModel(embedding_dim, dropout_prob, activation), False
    if mt in {"custom", "custom_model"}:
        return _build_custom(config, input_shape, embedding_dim, dropout_prob,
                             activation), False
    raise ValueError(f"Unsupported model_type: '{model_type}'.")


def _build_custom(config, input_shape, embedding_dim, dropout_prob,
                  activation) -> nn.Module:
    """Load a user Flax module from a file path or importable module name
    (reference modules/model.py:155-211)."""
    custom_cfg = config.get("custom_model_config", {})
    module_path = custom_cfg.get("module_path")
    class_name = custom_cfg.get("class_name")
    if not module_path or not class_name:
        raise ValueError(
            "For model_type='custom', custom_model_config must contain "
            "'module_path' and 'class_name'.")

    abs_path = os.path.abspath(str(module_path))
    if os.path.isfile(abs_path):
        module_name = os.path.splitext(os.path.basename(abs_path))[0]
        spec = importlib.util.spec_from_file_location(module_name, abs_path)
        if spec is None or spec.loader is None:
            raise ImportError(f"Unable to load custom module from '{abs_path}'")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(str(module_path))

    custom_class = getattr(module, str(class_name), None)
    if custom_class is None:
        raise AttributeError(
            f"Custom model class '{class_name}' not found in '{module_path}'.")

    params_cfg = custom_cfg.get("params", {}) or {}
    if hasattr(params_cfg, "to_dict"):
        params_cfg = params_cfg.to_dict()
    base_kwargs = {
        "input_shape": tuple(input_shape),
        "embedding_dim": embedding_dim,
        "dropout_prob": dropout_prob,
        "activation": activation,
    }
    try:
        sig = inspect.signature(custom_class)
        supported = {k: v for k, v in base_kwargs.items()
                     if k in sig.parameters}
    except (ValueError, TypeError):
        supported = base_kwargs
    supported.update(params_cfg)
    return custom_class(**supported)


class WakeWordModule(nn.Module):
    """Backbone + the shared classifier head (modules/model.py:216-221)."""

    backbone: nn.Module
    embedding_dim: int
    n_classes: int = 1
    dropout_prob: float = 0.5
    activation: Any = nn.relu
    stateful: bool = False

    @nn.compact
    def __call__(self, x, carry=None, deterministic: bool = True):
        if self.stateful:
            emb, new_carry = self.backbone(x, carry=carry,
                                           deterministic=deterministic)
        else:
            emb = self.backbone(x, deterministic=deterministic)
        h = nn.Dense(self.embedding_dim // 2)(emb)
        h = self.activation(h)
        h = nn.Dropout(self.dropout_prob)(h, deterministic=deterministic)
        logits = nn.Dense(self.n_classes)(h)
        if self.stateful:
            return logits, new_carry
        return logits


class Model:
    """Host-side model handle: module + variables + history + utilities."""

    def __init__(self, config, model_name: str, n_classes: int = 1,
                 input_shape=(16, 96), model_type: str = "dnn",
                 layer_dim: int = 128, n_blocks: int = 1,
                 seconds_per_example: Optional[float] = None,
                 dropout_prob: float = 0.5, seed: int = 10):
        self.config = config
        self.model_name = model_name
        self.model_type = model_type.lower()
        self.n_classes = n_classes
        self.input_shape = tuple(int(s) for s in input_shape)
        self.seconds_per_example = seconds_per_example
        self.history = collections.defaultdict(list)
        self._build_args = {"layer_dim": layer_dim, "n_blocks": n_blocks,
                            "dropout_prob": dropout_prob}

        if self.model_type in UNSTABLE_ARCHS:
            print_info(
                f"\n[WARNING] The '{model_type.upper()}' architecture is highly "
                "sensitive to hyperparameters and may exhibit convergence "
                "instability.\n")

        activation = A.get_activation(config.get("activation_function", "relu"))
        self.embedding_dim = int(config.get("embedding_dim", 64))
        backbone, stateful = build_backbone(
            model_type, config, self.input_shape, layer_dim, n_blocks,
            dropout_prob, self.embedding_dim, activation)
        self.stateful = stateful
        self.module = WakeWordModule(
            backbone=backbone, embedding_dim=self.embedding_dim,
            n_classes=n_classes, dropout_prob=dropout_prob,
            activation=activation, stateful=stateful)

        dummy = jnp.zeros((1,) + self.input_shape, jnp.float32)
        self.variables = self.module.init(
            {"params": jax.random.PRNGKey(seed)}, dummy)
        self._apply_eval = jax.jit(self._eval_fn)

    # -- apply ---------------------------------------------------------------

    def _eval_fn(self, variables, x):
        return self.module.apply(variables, x, deterministic=True)

    def __call__(self, x) -> jnp.ndarray:
        """Eval-mode logits for [B, T, F] features -> [B, n_classes]."""
        return self._apply_eval(self.variables, jnp.asarray(x))

    @property
    def params(self):
        return self.variables["params"]

    @params.setter
    def params(self, new_params):
        self.variables = dict(self.variables, params=new_params)

    def load_variables(self, variables):
        self.variables = variables

    def n_params(self) -> int:
        return int(sum(np.prod(p.shape)
                       for p in jax.tree_util.tree_leaves(self.params)))

    def summary(self) -> str:
        lines = [f"Model '{self.model_name}' ({self.model_type})",
                 f"  input shape : {self.input_shape}",
                 f"  parameters  : {self.n_params():,}"]
        flat = jax.tree_util.tree_leaves_with_path(self.params)
        for path, leaf in flat:
            name = "/".join(getattr(p, "key", str(p)) for p in path)
            lines.append(f"    {name:50s} {str(leaf.shape):>18s}")
        out = "\n".join(lines)
        print_info(out)
        return out

    # -- SWA averaging (modules/model.py:376-401) -----------------------------

    @staticmethod
    def average_models(param_trees: list):
        """Average a list of parameter pytrees (float leaves only)."""
        if not param_trees:
            raise ValueError("Cannot average an empty list of param trees.")

        def avg(*leaves):
            first = leaves[0]
            if jnp.issubdtype(first.dtype, jnp.floating):
                return sum(l.astype(jnp.float32) for l in leaves) / len(leaves)
            return first

        return jax.tree_util.tree_map(avg, *param_trees)

    # -- history plot (modules/model.py:227-361) -------------------------------

    def plot_history(self, output_dir: str):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        print_info("Generating training performance graph...")
        graph_dir = os.path.join(output_dir, "graphs")
        os.makedirs(graph_dir, exist_ok=True)

        loss_history = np.asarray(self.history.get("loss", []), np.float64)
        alpha = float(self.config.get("ema_alpha", 0.01))
        ema, ema_hist = None, []
        for v in loss_history:
            ema = v if ema is None else alpha * v + (1 - alpha) * ema
            ema_hist.append(ema)

        fig, ax_loss = plt.subplots(figsize=(13, 6))
        ax_rate = ax_loss.twinx()
        lines = []
        l, = ax_loss.plot(loss_history, color="#7EB6E8", alpha=0.3,
                          linewidth=1.0, label="Train Loss (Raw)")
        lines.append(l)
        l, = ax_loss.plot(ema_hist, color="#1A5FA6", linewidth=2.2,
                          label="Train Loss (EMA)")
        lines.append(l)
        if self.history.get("val_loss"):
            l, = ax_loss.plot(self.history["val_loss_steps"],
                              self.history["val_loss"], color="#B85C00",
                              linestyle="--", marker="o", markersize=4,
                              linewidth=2.2, label="Val Loss")
            lines.append(l)
        ax_loss.set_ylabel("Loss", color="#1A5FA6")
        ax_loss.set_ylim(bottom=0)

        tr_steps = self.history.get("train_recall_steps", [])
        tr_vals = self.history.get("train_recall", [])
        if tr_vals:
            ema_r, ema_tr = None, []
            for r in tr_vals:
                ema_r = r if ema_r is None else 0.05 * r + 0.95 * ema_r
                ema_tr.append(ema_r)
            l, = ax_rate.plot(tr_steps, tr_vals, color="#82E0AA", alpha=0.4,
                              linewidth=1.0, label="Train Recall (Raw)")
            lines.append(l)
            l, = ax_rate.plot(tr_steps, ema_tr, color="#1A8A44", linewidth=2.2,
                              label="Train Recall (EMA)")
            lines.append(l)
        if self.history.get("val_recall"):
            vs = self.history["val_recall_steps"]
            l, = ax_rate.plot(vs, self.history["val_recall"], color="#C0392B",
                              linestyle="--", marker="o", markersize=4,
                              linewidth=2.2, label="Val Recall")
            lines.append(l)
            l, = ax_rate.plot(vs, self.history["val_fpr"], color="#7D3C98",
                              linestyle=":", marker="s", markersize=3,
                              linewidth=2.0, label="Val FPR")
            lines.append(l)
        ax_rate.set_ylabel("Recall / FPR", color="#555555")
        ax_rate.set_ylim(-0.02, 1.05)
        ax_loss.set_title("Training Performance", fontsize=14, weight="bold")
        ax_loss.set_xlabel("Training Steps")
        ax_loss.grid(True, linestyle="--", alpha=0.25)
        ax_loss.legend(lines, [l.get_label() for l in lines], loc="best",
                       frameon=True, framealpha=0.7, facecolor="white",
                       fontsize=9)
        save_path = os.path.join(graph_dir, "training_performance_graph.png")
        plt.tight_layout()
        plt.savefig(save_path, dpi=150)
        plt.close()
        print_info(f"Performance graph saved to: {save_path}")
        return save_path
