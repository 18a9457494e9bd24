"""AudioFeatures: audio -> mel -> 96-dim embeddings, batch and streaming.

Parity target: `/root/reference/nanowakeword/data/AudioFeatures.py` — the
feature frontend that every layer above consumes. Public surface matches:
`embed_clips()` (`AudioFeatures.py:301`), `__call__`/`_streaming_features`
(`:410-464`), `get_features()` (`:455`), `reset()` (`:116`),
`get_embedding_shape()` (`:186`), plus the buffer geometry (10 s raw window,
970-frame mel buffer, 120-frame feature buffer, 1280-sample chunks —
`:106-112`).

Redesign:
* mel + embedding are OUR jit-compiled kernels (ops/mel.py, models/
  embedding.py), not downloaded ONNX sessions; no ThreadPools — batching is
  the parallelism.
* the streaming path is a single jitted step over a fixed-shape state pytree
  (mel ring, feature ring, 320-sample tail) — and it is EXACTLY equal to the
  batch path (the reference admits its own streaming drifts from batch,
  `AudioFeatures.py:388-393`; our equivalence is tested in
  tests/test_features.py).
* the encoder weights are a framework asset: deterministically initialised
  (seed 10) by default, replaceable with trained weights via
  `load_encoder_params` / the training pipeline's end-to-end mode.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.models.embedding import (EMB_STRIDE, EMB_WINDOW,
                                               EMBEDDING_DIM,
                                               SpeechEmbeddingEncoder,
                                               build_encoder,
                                               infer_encoder_arch)
from nanowakeword_tpu.ops import mel as melops

MEL_BUFFER_FRAMES = 970      # ~10 s of mel history (AudioFeatures.py:108)
FEATURE_BUFFER_FRAMES = 120  # ~10 s of embeddings (AudioFeatures.py:112)
CHUNK = melops.CHUNK         # 1280 samples / 80 ms
ENCODER_SEED = 10

# Streaming emits one embedding per 80 ms chunk from the freshest 76 mel
# frames; those windows END at multiples of 8, i.e. start at offset 4 (mod 8).
# The batch path drops the first EMB_OFFSET mel frames so its stride-8 windows
# land on the SAME grid — this is what makes batch == streaming exact (the
# reference's two paths are silently 40 ms apart). Frame-count contract:
# n = (n_mel - EMB_OFFSET - 76)//8 + 1, which equals the reference's counts
# for all standard clip lengths (2 s -> 16 frames, 4 s -> 41 frames).
EMB_OFFSET = 4


def batch_embedding_frames(n_mel: int) -> int:
    if n_mel < EMB_OFFSET + EMB_WINDOW:
        return 0
    return (n_mel - EMB_OFFSET - EMB_WINDOW) // EMB_STRIDE + 1


class StreamState(NamedTuple):
    """Fixed-shape streaming state, threaded through the jitted step."""
    tail: jnp.ndarray       # [320] last raw samples (mel left context)
    mel_buf: jnp.ndarray    # [970, 32] mel ring (newest at the end)
    feat_buf: jnp.ndarray   # [120, 96] embedding ring (newest at the end)


@functools.lru_cache(maxsize=4)
def _default_encoder_variables(seed: int = ENCODER_SEED,
                               arch: str = "conv4"):
    """Deterministic random initialisation (template / last-resort fallback)."""
    enc = build_encoder(arch)
    return enc.init(jax.random.PRNGKey(seed),
                    jnp.zeros((1, EMB_WINDOW, melops.N_MELS)))


@functools.lru_cache(maxsize=1)
def pretrained_encoder_variables():
    """Bundled pretrained encoder variables, or None if the asset is absent.

    The asset is produced by train/pretrain_encoder.py (word-classification
    proxy task over synthetic speech) and plays the role of the reference's
    downloaded frozen speech-embedding model (AudioFeatures.py:172-183).
    The encoder architecture is inferred from the stored kernel shapes
    (models/embedding.py:infer_encoder_arch), so versioned assets with
    different geometries load transparently.
    """
    from nanowakeword_tpu.assets import speech_encoder_asset_path
    path = speech_encoder_asset_path()
    if path is None:
        return None
    from nanowakeword_tpu import serialization
    with open(path, "rb") as f:
        payload = serialization.msgpack_restore(f.read())
    arch = infer_encoder_arch(payload)
    return serialization.from_state_dict(
        _default_encoder_variables(arch=arch), payload)


def default_encoder_variables():
    """The frontend's default encoder weights: pretrained asset if bundled,
    else the deterministic seed-10 initialisation."""
    pretrained = pretrained_encoder_variables()
    return pretrained if pretrained is not None \
        else _default_encoder_variables()


class AudioFeatures:
    """Feature frontend with identical call surface to the reference class."""

    def __init__(self,
                 encoder_variables=None,
                 sr: int = 16000,
                 ncpu: int = 1,                     # accepted for parity; unused
                 inference_framework: str = "jax",  # parity arg
                 device: str = "gpu",               # parity arg
                 compute_dtype=jnp.bfloat16,
                 debug_mode: bool = False,
                 debug_limit: int = 10):
        del ncpu, inference_framework, device
        self.sr = sr
        self.compute_dtype = compute_dtype
        self.debug_mode = debug_mode
        self.debug_limit = debug_limit
        self.encoder_variables = (encoder_variables
                                  or default_encoder_variables())
        # module geometry must match the loaded weights (versioned assets)
        self.encoder = build_encoder(
            infer_encoder_arch(self.encoder_variables))

        self._jit_stream_step = jax.jit(self._stream_step_impl)
        self._jit_embed = jax.jit(self._embed_impl)
        self._jit_mel = jax.jit(
            lambda x: melops.mel_frontend(x, compute_dtype=self.compute_dtype))

        self.reset()

    # -- pure compute ---------------------------------------------------------

    def _embed_impl(self, audio: jnp.ndarray) -> jnp.ndarray:
        """[N, samples] audio -> [N, frames, 96]; one fused pass, no windows."""
        mel = melops.mel_frontend(audio, compute_dtype=self.compute_dtype)
        return self.encoder.apply(self.encoder_variables, mel[:, EMB_OFFSET:])

    def _stream_step_impl(self, state: StreamState,
                          chunk: jnp.ndarray) -> StreamState:
        """1280 new samples -> 8 new mel frames -> 1 new embedding frame."""
        tail, new_mel = melops.mel_streaming_step(
            state.tail, chunk, compute_dtype=self.compute_dtype)
        mel_buf = jnp.roll(state.mel_buf, -melops.FRAMES_PER_CHUNK, axis=0)
        mel_buf = mel_buf.at[-melops.FRAMES_PER_CHUNK:].set(new_mel)
        window = mel_buf[-EMB_WINDOW:][None]           # [1, 76, 32]
        emb = self.encoder.apply(self.encoder_variables, window)[0, 0]
        feat_buf = jnp.roll(state.feat_buf, -1, axis=0).at[-1].set(emb)
        return StreamState(tail=tail, mel_buf=mel_buf, feat_buf=feat_buf)

    # -- lifecycle -------------------------------------------------------------

    def reset(self):
        """Reset internal streaming buffers (AudioFeatures.py:116-122)."""
        self.raw_data_remainder = np.empty(0, dtype=np.float32)
        self.accumulated_samples = 0
        if not hasattr(self, "_chunker"):
            # chunk framing + remainder carry runs in the native runtime
            # (native/nww_runtime.cc) with a numpy fallback inside Chunker
            from nanowakeword_tpu.runtime import Chunker
            self._chunker = Chunker(CHUNK)
        self._chunker.reset()
        self._frames_seen = 0  # embedding frames emitted since reset
        self.state = StreamState(
            tail=jnp.zeros(melops.LEFT_PAD, jnp.float32),
            mel_buf=jnp.ones((MEL_BUFFER_FRAMES, melops.N_MELS), jnp.float32),
            feat_buf=jnp.zeros((FEATURE_BUFFER_FRAMES, EMBEDDING_DIM),
                               jnp.float32),
        )

    # -- batch path -------------------------------------------------------------

    def embed_clips(self, x, batch_size: int = 128, ncpu: int = 1) -> np.ndarray:
        """[N, samples] int16/float audio -> [N, frames, 96]
        (AudioFeatures.py:301-384). batch_size bounds per-call device memory.

        Multi-chip: with more than one device the batch is sharded over the
        data axis of a 1-D mesh — bulk feature extraction scales linearly
        across a pod slice (new capability; the reference ThreadPools a CPU,
        AudioFeatures.py:192-299)."""
        del ncpu
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[None]
        sharding = self._data_sharding()
        # int16 PCM flows through unconverted: half the host->device bytes
        # (the mel frontend converts on device; int16 -> f32 is exact)
        in_dtype = np.int16 if x.dtype == np.int16 else np.float32
        outs = []
        for i in range(0, x.shape[0], batch_size):
            batch = np.asarray(x[i:i + batch_size], in_dtype)
            n = batch.shape[0]
            if sharding is not None:
                # Bucket each sub-batch to a fixed shape so a ragged final
                # batch never retraces under serving load. Full sub-batches
                # use one signature (batch_size rounded to a device
                # multiple); small calls snap to the least power-of-two
                # device multiple >= n instead of paying a full
                # batch_size-row forward for a handful of clips — a bounded
                # log2 family of signatures, not one per ragged size.
                n_dev = len(jax.devices())
                full = -(-batch_size // n_dev) * n_dev
                bucket = n_dev
                while bucket < n:
                    bucket *= 2
                bucket = min(bucket, full)
                pad = bucket - n
                if pad:
                    batch = np.concatenate(
                        [batch, np.zeros((pad,) + batch.shape[1:],
                                         in_dtype)])
                dev_batch = jax.device_put(batch, sharding)
                outs.append(np.asarray(self._jit_embed(dev_batch))[:n])
            else:
                outs.append(np.asarray(self._jit_embed(jnp.asarray(batch))))
        return np.concatenate(outs, axis=0)

    @staticmethod
    @functools.lru_cache(maxsize=1)
    def _data_sharding():
        """1-D batch sharding over all devices, or None on a single device."""
        devices = jax.devices()
        if len(devices) <= 1:
            return None
        from jax.sharding import Mesh, NamedSharding, PartitionSpec
        mesh = Mesh(np.asarray(devices), ("data",))
        return NamedSharding(mesh, PartitionSpec("data"))

    def _get_melspectrogram(self, x) -> np.ndarray:
        """Whole-clip mel (AudioFeatures.py:124-153 contract)."""
        x = np.asarray(x, np.float32)
        return np.asarray(self._jit_mel(jnp.asarray(x)))

    def _get_embeddings(self, x, **kwargs) -> np.ndarray:
        """Whole-clip embeddings [frames, 96] (AudioFeatures.py:172-183)."""
        out = self.embed_clips(np.asarray(x, np.float32)[None], **kwargs)
        return out[0]

    def get_embedding_shape(self, audio_length: float, sr: int = 16000):
        """Output embedding shape for a clip length in seconds
        (AudioFeatures.py:186-189)."""
        n = int(audio_length * sr)
        return (batch_embedding_frames(melops.n_mel_frames(n)), EMBEDDING_DIM)

    # -- streaming path ----------------------------------------------------------

    def _streaming_features(self, x) -> int:
        """Accumulate raw audio; process in whole 1280-sample chunks.

        Returns the number of samples processed this call (or the number
        accumulated so far if < 1280), mirroring AudioFeatures.py:410-453.
        """
        x = np.asarray(x, np.float32).reshape(-1)
        chunks = self._chunker.feed(x)   # [n_chunks, 1280] float32
        if chunks.shape[0] == 0:
            self.accumulated_samples = self._chunker.pending
            return self.accumulated_samples

        state = self.state
        for chunk in chunks:
            state = self._jit_stream_step(state, jnp.asarray(chunk))
        self.state = state
        self._frames_seen += chunks.shape[0]

        self.accumulated_samples = self._chunker.pending
        return chunks.shape[0] * CHUNK

    def __call__(self, x) -> int:
        return self._streaming_features(x)

    @property
    def feature_buffer(self) -> np.ndarray:
        """Last-120-frames embedding buffer view (numpy, newest last).

        Exposes only the frames actually emitted since reset, so warm-up
        checks (`nanointerpreter.py:660-662`) see the true fill level.
        """
        buf = np.asarray(self.state.feat_buf)
        n = min(self._frames_seen, FEATURE_BUFFER_FRAMES)
        return buf[FEATURE_BUFFER_FRAMES - n:]

    def get_features(self, n_feature_frames: int = 16,
                     start_ndx: int = -1) -> np.ndarray:
        """[1, n, 96] slice of the feature buffer (AudioFeatures.py:455-461)."""
        buf = np.asarray(self.state.feat_buf)
        n = int(n_feature_frames)
        if start_ndx != -1:
            end = start_ndx + n if start_ndx + n != 0 else FEATURE_BUFFER_FRAMES
            return buf[start_ndx:end][None].astype(np.float32)
        return buf[-n:][None].astype(np.float32)

    def load_encoder_params(self, variables):
        self.encoder_variables = variables
        self.encoder = build_encoder(infer_encoder_arch(variables))
        self._jit_stream_step = jax.jit(self._stream_step_impl)
        self._jit_embed = jax.jit(self._embed_impl)
