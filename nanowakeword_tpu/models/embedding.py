"""Speech-embedding encoder: mel frames -> 96-dim acoustic embeddings.

The reference uses Google's frozen `speech_embedding` ONNX model
(`/root/reference/nanowakeword/data/AudioFeatures.py:172-183`): it slices the
mel sequence into 76-frame windows at stride 8 and runs each window through a
conv net, producing one 96-dim vector per window. The batch path materializes
every window — a 9.5x data blow-up — and the streaming path re-runs the whole
window every 80 ms.

Redesign: the encoder is a **fully-convolutional** stack whose
total time stride is exactly 8 and receptive field exactly 76, with VALID
padding. Applying it once over the whole mel sequence yields one embedding
per stride-8 window position — identical, by construction, to windowed
application (tested in tests/test_embedding.py), with zero duplication. The
per-window contract (76 frames -> 1x96) survives, so every downstream shape
in the framework matches the reference: ``n_frames = (mel_frames - 76)//8 + 1``
(`AudioFeatures.py:265`).

Time geometry:  k=10/s=2 -> k=8/s=2 -> k=8/s=2 -> k=4/s=1
    receptive field = 10 + 7*2 + 7*4 + 3*8 = 76,   stride = 2*2*2*1 = 8
Freq geometry (32 mel bins): k=4/s=2 -> k=4/s=2 -> k=3/s=2 -> k=2/s=1 -> 1

The encoder is our own trainable module (~0.2M params, comparable to the
reference's frozen asset). It can be trained end-to-end or frozen from a
pretrained checkpoint; either way the [B, T, 96] feature interface that the
rest of the framework consumes is unchanged.
"""

from __future__ import annotations

import functools

from nanowakeword_tpu import nn
import jax
import jax.numpy as jnp

EMBEDDING_DIM = 96
EMB_WINDOW = 76     # mel frames per embedding window
EMB_STRIDE = 8      # mel frames between embedding windows


def n_embedding_frames(n_mel_frames: int) -> int:
    """Embeddings produced for a mel sequence (AudioFeatures.py:265 contract)."""
    if n_mel_frames < EMB_WINDOW:
        return 0
    return (n_mel_frames - EMB_WINDOW) // EMB_STRIDE + 1


class SpeechEmbeddingEncoder(nn.Module):
    """Fully-convolutional mel -> 96-dim embedding encoder.

    Input:  [B, T, 32]  transformed log-mel (T >= 76)
    Output: [B, (T-76)//8 + 1, 96]

    `precision` defaults to HIGH. DEFAULT precision lets XLA pick a reduced-
    precision algorithm (one bf16 pass, or TF32 on a GPU) whose choice is
    shape-dependent, which can break the streaming == batch guarantee: the
    [B,76,32] streaming window and the [B,970,32] full buffer must agree
    inside the 1e-3 score-trace budget. HIGH asks for more mantissa than
    one bf16 pass at a fraction of HIGHEST's cost; what XLA runs for it is
    backend-specific. Throughput-critical bulk extraction can opt into
    `precision=None` where 0.5% feature noise is irrelevant; bit-for-bit
    cross-shape reproducibility needs `precision=jax.lax.Precision.HIGHEST`.
    """

    features: tuple = (32, 48, 64, EMBEDDING_DIM)
    dtype: jnp.dtype = jnp.float32
    precision: object = jax.lax.Precision.HIGH

    @nn.compact
    def __call__(self, mel: jnp.ndarray) -> jnp.ndarray:
        x = mel[..., None].astype(self.dtype)  # [B, T, 32, 1] (NHWC: H=time, W=freq)
        specs = [
            ((10, 4), (2, 2)),
            ((8, 4), (2, 2)),
            ((8, 3), (2, 2)),
            ((4, 2), (1, 1)),
        ]
        for feats, (kernel, stride) in zip(self.features, specs):
            x = nn.Conv(feats, kernel_size=kernel, strides=stride,
                        padding="VALID", dtype=self.dtype,
                        precision=self.precision)(x)
            x = nn.relu(x)
        # [B, T', 1, 96] -> [B, T', 96]; final linear mixes channels per frame
        x = x.squeeze(axis=2)
        x = nn.Dense(EMBEDDING_DIM, dtype=self.dtype,
                     precision=self.precision)(x)
        return x


class WideSpeechEmbeddingEncoder(nn.Module):
    """Wide encoder variant ("wide128"): same time geometry and
    [B, T, 32] -> [B, (T-76)//8 + 1, 96] contract as SpeechEmbeddingEncoder,
    but the first conv consumes the WHOLE 32-bin freq axis into 128 channels
    and the rest are pure 1-D temporal convs at 128 channels.

    Why: matrix units work in wide tiles, so narrow 32/48/64/96-channel
    convs leave most of each tile idle; at 128 channels the tiles are full,
    at 2.1x the parameters (0.38M, still tiny).

    Time geometry:  k=10/s=2 -> k=8/s=2 -> k=8/s=2 -> k=4/s=1
        receptive field = 76, stride = 8  (identical to the small encoder)
    """

    width: int = 128
    dtype: jnp.dtype = jnp.float32
    precision: object = jax.lax.Precision.HIGH

    @nn.compact
    def __call__(self, mel: jnp.ndarray) -> jnp.ndarray:
        x = mel[..., None].astype(self.dtype)            # [B, T, 32, 1]
        x = nn.Conv(self.width, (10, 32), strides=(2, 1), padding="VALID",
                    dtype=self.dtype, precision=self.precision)(x)
        x = nn.relu(x).squeeze(axis=2)                   # [B, T1, 128]
        for k, s in ((8, 2), (8, 2), (4, 1)):
            x = nn.Conv(self.width, (k,), strides=(s,), padding="VALID",
                        dtype=self.dtype, precision=self.precision)(x)
            x = nn.relu(x)
        return nn.Dense(EMBEDDING_DIM, dtype=self.dtype,
                        precision=self.precision)(x)


# wide256 measured (pretrain v7/v8, large 48-word cross-channel eval):
# with supcon at 12k steps it scores 0.839 formant / 0.797 resonator /
# 0.707 heldout-fx pair acc — BELOW the shipped wide128 v3 asset
# (0.844/0.792/0.733) at 3.7x the parameters. Capacity is not the binding
# constraint on this synthetic corpus; the arch stays registered for users
# who pretrain on real speech.
ENCODER_ARCHS = {
    "conv4": SpeechEmbeddingEncoder,
    "wide128": WideSpeechEmbeddingEncoder,
    "wide256": functools.partial(WideSpeechEmbeddingEncoder, width=256),
}
DEFAULT_ENCODER_ARCH = "conv4"


def build_encoder(arch: str = DEFAULT_ENCODER_ARCH, **kwargs):
    """Encoder module for an architecture id ("conv4"|"wide128"|"wide256")."""
    try:
        return ENCODER_ARCHS[arch](**kwargs)
    except KeyError:
        raise ValueError(f"unknown encoder arch '{arch}'; "
                         f"known: {sorted(ENCODER_ARCHS)}") from None


def infer_encoder_arch(variables) -> str:
    """Architecture id from a variables pytree (shape of the first conv).

    Assets and `.nww`-bundled encoders carry no explicit arch field from
    older versions; the first kernel's freq extent identifies the family
    and its channel count the width: (10, 4, 1, 32) -> conv4,
    (10, 32, 1, 128) -> wide128, (10, 32, 1, 256) -> wide256.
    """
    params = variables.get("params", variables)
    kernel = params["Conv_0"]["kernel"]
    shape = tuple(int(s) for s in kernel.shape)
    if shape[:3] == (10, 32, 1):
        return "wide256" if shape[3] == 256 else "wide128"
    return "conv4"
