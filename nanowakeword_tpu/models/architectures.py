"""The wake-word classifier architecture zoo, as Flax modules.

Parity target: the 12 selectable backbones of the reference
(`/root/reference/nanowakeword/modules/architectures.py`) with the same
config-key surface (`model_type`, `layer_size`, `n_blocks`, `embedding_dim`,
`dropout_prob`, plus per-arch keys — see `modules/model.py:94-214`), operating
on `[B, T, 96]` feature frames and emitting a `embedding_dim` vector that the
shared classifier head (heads.py) maps to one logit.

Notes:
* Everything is jit-compiled with static shapes; recurrent nets are a
  `lax.scan` — sequences here are short (typically 16-45 frames).
* BatchNorm state lives in the `batch_stats` collection; training steps apply
  with `mutable=["batch_stats"]`.
* Dropout uses the `dropout` PRNG collection and a `deterministic` flag.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

from nanowakeword_tpu import nn
import jax
import jax.numpy as jnp
import numpy as np


Activation = Callable[[jnp.ndarray], jnp.ndarray]


def get_activation(name: str) -> Activation:
    """relu/gelu/silu selection (reference modules/model.py:79-85)."""
    name = (name or "relu").lower()
    if name == "gelu":
        return nn.gelu
    if name == "silu":
        return nn.silu
    return nn.relu


# ---------------------------------------------------------------------------
# Recurrent helpers
# ---------------------------------------------------------------------------

class BiRNN(nn.Module):
    """Multi-layer bidirectional LSTM/GRU over [B, T, F].

    Mirrors torch's nn.LSTM(bidirectional=True) semantics: each layer consumes
    the concatenated fwd/bwd outputs of the previous layer; inter-layer
    dropout only when n_layers > 1.

    Built on the scan-lean Fast{GRU,LSTM} layers (models/fast_rnn.py): input
    projections run as one batched MXU matmul per layer/direction instead of
    T sequential per-step matmuls.
    """

    hidden: int
    n_layers: int = 1
    cell: str = "lstm"          # "lstm" | "gru"
    dropout: float = 0.0

    def _make_layer(self, reverse: bool):
        from nanowakeword_tpu.models.fast_rnn import FastGRU, FastLSTM
        if self.cell == "gru":
            return FastGRU(hidden=self.hidden, reverse=reverse)
        return FastLSTM(hidden=self.hidden, reverse=reverse)

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        for i in range(self.n_layers):
            fwd = self._make_layer(reverse=False)(x)
            bwd = self._make_layer(reverse=True)(x)
            x = jnp.concatenate([fwd, bwd], axis=-1)
            if i < self.n_layers - 1 and self.dropout > 0:
                x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        return x


class UniRNN(nn.Module):
    """Unidirectional (causal, streamable) LSTM/GRU with explicit carry I/O.

    Used by the streaming runtime for stateful models: `initial_carry` gives
    the zero state and `__call__` can resume from a carry, mirroring the
    reference's hidden_in/cell_in threading (`nanointerpreter.py:679-687`).
    """

    hidden: int
    n_layers: int = 1
    cell: str = "lstm"
    dropout: float = 0.0

    def _make_cell(self):
        if self.cell == "gru":
            return nn.GRUCell(features=self.hidden)
        return nn.OptimizedLSTMCell(features=self.hidden)

    @nn.compact
    def __call__(self, x, carry=None, deterministic: bool = True):
        new_carries = []
        for i in range(self.n_layers):
            rnn = nn.RNN(self._make_cell(), return_carry=True)
            layer_carry = None if carry is None else carry[i]
            c, x = rnn(x, initial_carry=layer_carry)
            new_carries.append(c)
            if i < self.n_layers - 1 and self.dropout > 0:
                x = nn.Dropout(self.dropout)(x, deterministic=deterministic)
        return x, tuple(new_carries)


# ---------------------------------------------------------------------------
# 1. DNN ("dnn") — reference architectures.py:100-125
# ---------------------------------------------------------------------------

class DNNModel(nn.Module):
    layer_dim: int
    n_blocks: int
    embedding_dim: int
    dropout_prob: float
    activation: Activation = nn.relu

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = x.reshape((x.shape[0], -1))
        x = self.activation(nn.LayerNorm()(nn.Dense(self.layer_dim)(x)))
        x = nn.Dropout(self.dropout_prob)(x, deterministic=deterministic)
        for _ in range(self.n_blocks):
            x = self.activation(nn.LayerNorm()(nn.Dense(self.layer_dim)(x)))
        return nn.Dense(self.embedding_dim)(x)


# ---------------------------------------------------------------------------
# 2. CNN ("cnn") — reference architectures.py:50-79
# ---------------------------------------------------------------------------

class CNNModel(nn.Module):
    embedding_dim: int
    dropout_prob: float
    activation: Activation = nn.relu

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = x[..., None]  # [B, T, F, 1]
        x = self.activation(nn.Conv(16, (3, 3), padding="SAME")(x))
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = self.activation(nn.Conv(32, (3, 3), padding="SAME")(x))
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = x.reshape((x.shape[0], -1))
        x = self.activation(nn.Dense(128)(x))
        x = nn.Dropout(self.dropout_prob)(x, deterministic=deterministic)
        return nn.Dense(self.embedding_dim)(x)


# ---------------------------------------------------------------------------
# 3/4/5. LSTM / GRU / RNN — reference architectures.py:82-160
# ---------------------------------------------------------------------------

class LSTMModel(nn.Module):
    hidden_dim: int
    n_layers: int
    embedding_dim: int
    dropout_prob: float
    cell: str = "lstm"

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        dr = self.dropout_prob if self.n_layers > 1 else 0.0
        out = BiRNN(self.hidden_dim, self.n_layers, self.cell, dr)(
            x, deterministic=deterministic)
        last = out[:, -1, :]
        last = nn.Dropout(self.dropout_prob)(last, deterministic=deterministic)
        return nn.Dense(self.embedding_dim)(last)


class GRUModel(LSTMModel):
    cell: str = "gru"


class RNNModel(nn.Module):
    """Fixed bi-LSTM-64 variant (reference architectures.py:148-160)."""

    n_blocks: int
    embedding_dim: int
    dropout_prob: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        dr = self.dropout_prob if self.n_blocks > 1 else 0.0
        out = BiRNN(64, self.n_blocks, "lstm", dr)(x, deterministic=deterministic)
        last = nn.Dropout(self.dropout_prob)(out[:, -1, :],
                                             deterministic=deterministic)
        return nn.Dense(self.embedding_dim)(last)


class StreamingGRUModel(nn.Module):
    """Causal GRU with explicit carry, for stateful streaming inference.

    The bidirectional zoo models re-score a full window per chunk; this one
    carries its hidden state across chunks like the reference's stateful-ONNX
    path (`nanointerpreter.py:679-687`) and scores each new frame in O(1).
    Selectable via model_type "streaming_gru".
    """

    hidden_dim: int
    n_layers: int
    embedding_dim: int
    dropout_prob: float
    cell: str = "gru"

    @nn.compact
    def __call__(self, x, carry=None, deterministic: bool = True):
        dr = self.dropout_prob if self.n_layers > 1 else 0.0
        out, new_carry = UniRNN(self.hidden_dim, self.n_layers, self.cell, dr)(
            x, carry=carry, deterministic=deterministic)
        last = nn.Dropout(self.dropout_prob)(out[:, -1, :],
                                             deterministic=deterministic)
        return nn.Dense(self.embedding_dim)(last), new_carry


# ---------------------------------------------------------------------------
# 6. Transformer — reference architectures.py:25-47,163-204
# ---------------------------------------------------------------------------

def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class PostLNEncoderLayer(nn.Module):
    """Post-norm transformer encoder layer (torch TransformerEncoderLayer
    defaults: norm_first=False, relu FFN of 4x width)."""

    d_model: int
    n_head: int
    dropout: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.n_head, qkv_features=self.d_model,
            dropout_rate=self.dropout, deterministic=deterministic)(x, x)
        attn = nn.Dropout(self.dropout)(attn, deterministic=deterministic)
        x = nn.LayerNorm()(x + attn)
        h = nn.relu(nn.Dense(self.d_model * 4)(x))
        h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        h = nn.Dense(self.d_model)(h)
        h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        return nn.LayerNorm()(x + h)


class TransformerModel(nn.Module):
    d_model: int
    n_head: int
    n_layers: int
    embedding_dim: int
    dropout_prob: float
    max_len: int = 512

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        T = x.shape[1]
        x = nn.Dense(self.d_model)(x) * math.sqrt(self.d_model)
        pe = jnp.asarray(sinusoidal_positions(self.max_len, self.d_model))
        x = x + pe[None, :T]
        x = nn.Dropout(self.dropout_prob)(x, deterministic=deterministic)
        for _ in range(self.n_layers):
            x = PostLNEncoderLayer(self.d_model, self.n_head,
                                   self.dropout_prob)(x, deterministic)
        pooled = x.mean(axis=1)
        return nn.Dense(self.embedding_dim)(pooled)


# ---------------------------------------------------------------------------
# 7. CRNN — reference architectures.py:208-286
# ---------------------------------------------------------------------------

class CRNNModel(nn.Module):
    """Conv stack then bi-RNN. Faithful to the reference's (quirky) geometry:
    the RNN scans over the reduced *feature* axis (conv width), with
    channels x reduced-time as the per-step feature vector
    (architectures.py:269-275)."""

    cnn_channels: Sequence[int]
    rnn_type: str
    rnn_hidden_size: int
    n_rnn_layers: int
    embedding_dim: int
    dropout_prob: float
    activation: Activation = nn.relu

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        h = x[..., None]  # [B, T, F, 1]
        for ch in self.cnn_channels:
            h = nn.Conv(ch, (3, 3), padding="SAME")(h)
            h = nn.BatchNorm(use_running_average=deterministic)(h)
            h = self.activation(h)
            h = nn.max_pool(h, (2, 2), strides=(2, 2))
        # [B, H', W', C] -> sequence over W' with features C*H'
        B, Hc, Wc, C = h.shape
        seq = h.transpose(0, 2, 3, 1).reshape(B, Wc, C * Hc)
        dr = self.dropout_prob if self.n_rnn_layers > 1 else 0.0
        cell = "gru" if self.rnn_type.lower() == "gru" else "lstm"
        out = BiRNN(self.rnn_hidden_size, self.n_rnn_layers, cell, dr)(
            seq, deterministic=deterministic)
        last = nn.Dropout(self.dropout_prob)(out[:, -1, :],
                                             deterministic=deterministic)
        return nn.Dense(self.embedding_dim)(last)


# ---------------------------------------------------------------------------
# 8. TCN — reference architectures.py:289-361
# ---------------------------------------------------------------------------

class TemporalBlock(nn.Module):
    n_outputs: int
    kernel_size: int
    dilation: int
    dropout: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        # x: [B, T, C]; causal conv == left-pad by (k-1)*dilation, VALID conv
        pad = (self.kernel_size - 1) * self.dilation
        out = nn.Conv(self.n_outputs, (self.kernel_size,),
                      kernel_dilation=(self.dilation,),
                      padding=[(pad, 0)])(x)
        out = nn.relu(out)
        out = nn.Dropout(self.dropout)(out, deterministic=deterministic)
        out = nn.Conv(self.n_outputs, (self.kernel_size,),
                      kernel_dilation=(self.dilation,),
                      padding=[(pad, 0)])(out)
        out = nn.relu(out)
        out = nn.Dropout(self.dropout)(out, deterministic=deterministic)
        res = x if x.shape[-1] == self.n_outputs else nn.Conv(
            self.n_outputs, (1,))(x)
        return nn.relu(out + res)


class TCNModel(nn.Module):
    num_channels: Sequence[int]
    embedding_dim: int
    kernel_size: int
    dropout_prob: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        for i, ch in enumerate(self.num_channels):
            x = TemporalBlock(ch, self.kernel_size, 2 ** i,
                              self.dropout_prob)(x, deterministic)
        return nn.Dense(self.embedding_dim)(x[:, -1, :])


# ---------------------------------------------------------------------------
# 9. QuartzNet — reference architectures.py:369-436
# ---------------------------------------------------------------------------

class QuartzNetBlock(nn.Module):
    out_channels: int
    kernel_size: int
    dropout: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        in_ch = x.shape[-1]
        residual = x
        h = nn.Conv(in_ch, (self.kernel_size,), padding="SAME",
                    feature_group_count=in_ch)(x)       # depthwise
        h = nn.Conv(self.out_channels, (1,))(h)          # pointwise
        h = nn.BatchNorm(use_running_average=deterministic)(h)
        if in_ch != self.out_channels:
            residual = nn.Conv(self.out_channels, (1,))(residual)
            residual = nn.BatchNorm(use_running_average=deterministic)(residual)
        h = nn.relu(h + residual)
        return nn.Dropout(self.dropout)(h, deterministic=deterministic)


class QuartzNetModel(nn.Module):
    quartznet_config: Sequence          # [[channels, kernel, repetitions], ...]
    embedding_dim: int
    dropout_prob: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        for channels, kernel, reps in self.quartznet_config:
            for _ in range(int(reps)):
                x = QuartzNetBlock(int(channels), int(kernel),
                                   self.dropout_prob)(x, deterministic)
        pooled = x.mean(axis=1)
        return nn.Dense(self.embedding_dim)(pooled)


# ---------------------------------------------------------------------------
# 10/11. Conformer & E-Branchformer — reference architectures.py:440-615
# ---------------------------------------------------------------------------

def swish(x):
    return x * jax.nn.sigmoid(x)


class ConvolutionModule(nn.Module):
    d_model: int
    kernel_size: int = 31

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        h = nn.LayerNorm()(x)
        h = nn.Conv(self.d_model * 2, (1,))(h)
        a, b = jnp.split(h, 2, axis=-1)
        h = a * jax.nn.sigmoid(b)                        # GLU
        h = nn.Conv(self.d_model, (self.kernel_size,), padding="SAME",
                    feature_group_count=self.d_model)(h)  # depthwise
        h = nn.BatchNorm(use_running_average=deterministic)(h)
        h = swish(h)
        h = nn.Conv(self.d_model, (1,))(h)
        return nn.Dropout(0.1)(h, deterministic=deterministic)


class FeedForwardModule(nn.Module):
    d_model: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        h = nn.LayerNorm()(x)
        h = swish(nn.Dense(self.d_model * 4)(h))
        h = nn.Dropout(self.dropout)(h, deterministic=deterministic)
        h = nn.Dense(self.d_model)(h)
        return nn.Dropout(self.dropout)(h, deterministic=deterministic)


class ConformerBlock(nn.Module):
    d_model: int
    n_head: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = x + 0.5 * FeedForwardModule(self.d_model, self.dropout)(
            x, deterministic)
        attn = nn.MultiHeadDotProductAttention(
            num_heads=self.n_head, qkv_features=self.d_model,
            dropout_rate=self.dropout, deterministic=deterministic)(x, x)
        x = x + attn
        x = x + ConvolutionModule(self.d_model)(x, deterministic)
        x = x + 0.5 * FeedForwardModule(self.d_model, self.dropout)(
            x, deterministic)
        return nn.LayerNorm()(x)


class ConformerModel(nn.Module):
    d_model: int
    n_head: int
    n_layers: int
    embedding_dim: int
    dropout_prob: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = nn.Dense(self.d_model)(x)
        x = nn.Dropout(self.dropout_prob)(x, deterministic=deterministic)
        for _ in range(self.n_layers):
            x = ConformerBlock(self.d_model, self.n_head,
                               self.dropout_prob)(x, deterministic)
        return nn.Dense(self.embedding_dim)(x.mean(axis=1))


class EBranchformerBlock(nn.Module):
    d_model: int
    n_head: int
    dropout: float = 0.1

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        attn_in = nn.LayerNorm()(x)
        attn_out = nn.MultiHeadDotProductAttention(
            num_heads=self.n_head, qkv_features=self.d_model,
            dropout_rate=self.dropout, deterministic=deterministic)(
                attn_in, attn_in)
        conv_out = ConvolutionModule(self.d_model)(x, deterministic)
        gate = jax.nn.sigmoid(nn.Dense(self.d_model)(conv_out))
        merged = attn_out * gate + conv_out * (1.0 - gate)
        x = nn.LayerNorm()(x + merged)
        return x + FeedForwardModule(self.d_model, self.dropout)(
            x, deterministic)


class EBranchformerModel(nn.Module):
    d_model: int
    n_head: int
    n_layers: int
    embedding_dim: int
    dropout_prob: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        x = nn.Dense(self.d_model)(x)
        x = nn.Dropout(self.dropout_prob)(x, deterministic=deterministic)
        for _ in range(self.n_layers):
            x = EBranchformerBlock(self.d_model, self.n_head,
                                   self.dropout_prob)(x, deterministic)
        return nn.Dense(self.embedding_dim)(x.mean(axis=1))


# ---------------------------------------------------------------------------
# 12. BcResNet — reference architectures.py:618-686
# ---------------------------------------------------------------------------

class BcResNetBlock(nn.Module):
    out_channels: int
    stride: tuple = (1, 1)
    activation: Activation = nn.relu

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        in_ch = x.shape[-1]
        shortcut = x
        if self.stride != (1, 1) or in_ch != self.out_channels:
            shortcut = nn.Conv(self.out_channels, (1, 1), strides=self.stride,
                               use_bias=False)(x)
            shortcut = nn.BatchNorm(use_running_average=deterministic)(shortcut)
        h = nn.Conv(in_ch, (3, 3), strides=self.stride, padding="SAME",
                    feature_group_count=in_ch, use_bias=False)(x)  # depthwise
        h = nn.Conv(self.out_channels, (1, 1), use_bias=False)(h)  # pointwise
        h = nn.BatchNorm(use_running_average=deterministic)(h)
        h = self.activation(h)
        return h + shortcut


class BcResNetModel(nn.Module):
    embedding_dim: int
    dropout_prob: float = 0.2
    activation: Activation = nn.relu

    @nn.compact
    def __call__(self, x, deterministic: bool = True):
        h = x[..., None]  # [B, T, F, 1]
        h = nn.Conv(32, (3, 3), padding="SAME", use_bias=False)(h)
        h = nn.BatchNorm(use_running_average=deterministic)(h)
        h = self.activation(h)
        h = nn.max_pool(h, (2, 2), strides=(2, 2))
        h = BcResNetBlock(64, (2, 2), self.activation)(h, deterministic)
        h = BcResNetBlock(128, (2, 2), self.activation)(h, deterministic)
        h = BcResNetBlock(256, (2, 1), self.activation)(h, deterministic)
        pooled = h.mean(axis=(1, 2))
        pooled = nn.Dropout(self.dropout_prob)(pooled,
                                               deterministic=deterministic)
        return nn.Dense(self.embedding_dim)(pooled)
