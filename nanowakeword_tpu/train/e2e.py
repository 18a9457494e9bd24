"""End-to-end training: raw audio -> mel -> encoder -> classifier, jointly.

New capability beyond the reference. The reference treats the speech
embedding as a frozen downloaded asset and can only train the classifier on
precomputed features (SURVEY.md §7 translation table: our encoder is "a
trainable or optionally-frozen stage"). This module delivers the trainable
half: one Flax module spanning the whole acoustic stack, trained from raw
(optionally device-augmented) audio with gradients flowing through the
encoder — the mel frontend is parameter-free and differentiates cleanly.

Pipeline integration: `end_to_end.enabled: true` in the config makes the -T
stage train this module from `end_to_end.audio_manifest` (categories ->
audio dirs). The export step bundles the TRAINED encoder into the `.nww`
artifact, so the interpreter transparently uses it.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Tuple

from nanowakeword_tpu import nn
import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.models.embedding import build_encoder
from nanowakeword_tpu.ops import mel as melops
from nanowakeword_tpu.utils.audio_io import load_audio
from nanowakeword_tpu.utils.logger import print_info


class EndToEndModule(nn.Module):
    """audio [B, S] (int16 scale) -> wake-word logits [B, 1].

    Composes the parameter-free mel frontend, a trainable
    SpeechEmbeddingEncoder, and any zoo backbone + classifier head
    (a WakeWordModule). `freeze_encoder` stops encoder gradients while
    keeping one set of variables (optionally-frozen semantics).
    """

    classifier: nn.Module            # a WakeWordModule
    context_frames: int = 16
    freeze_encoder: bool = False
    encoder_dtype: jnp.dtype = jnp.bfloat16
    encoder_arch: str = "conv4"

    @nn.compact
    def __call__(self, audio: jnp.ndarray, deterministic: bool = True):
        from nanowakeword_tpu.data.features import EMB_OFFSET
        mel = melops.mel_frontend(audio, compute_dtype=jnp.bfloat16)
        emb = build_encoder(self.encoder_arch, dtype=self.encoder_dtype,
                            precision=None,
                            name="encoder")(mel[:, EMB_OFFSET:])
        if self.freeze_encoder:
            emb = jax.lax.stop_gradient(emb)
        t = emb.shape[1]
        if t >= self.context_frames:
            feats = emb[:, -self.context_frames:]
        else:
            feats = jnp.pad(emb, ((0, 0), (self.context_frames - t, 0),
                                  (0, 0)))
        return self.classifier(feats.astype(jnp.float32),
                               deterministic=deterministic)


def split_variables(e2e_variables) -> Tuple[dict, dict]:
    """E2E variables -> (encoder_variables, classifier_variables).

    The encoder half feeds AudioFeatures / `.nww` bundling; the classifier
    half restores into a standalone Model for export and serving.
    """
    def _split(coll):
        enc, clf = {}, {}
        for key, sub in coll.items():
            if key == "encoder":
                enc.update(sub)
            elif key == "classifier":
                clf.update(sub)
            else:
                clf[key] = sub
        return enc, clf

    enc_out, clf_out = {}, {}
    for coll_name, coll in e2e_variables.items():
        enc, clf = _split(coll)
        if enc:
            enc_out[coll_name] = enc
        if clf:
            clf_out[coll_name] = clf
    return enc_out, clf_out


class AudioClipDataset:
    """Raw-audio training set: (path, label) per clip, ISBL hardness per clip.

    The audio analogue of AdaptiveLossAwareDataset — same index-pool /
    hardness interface so DynamicClassAwareSampler works unchanged; `gather`
    decodes and fixes length on the host (threaded by the caller's workers),
    leaving all DSP to the device augmentation chain.
    """

    def __init__(self, audio_manifest: Dict[str, List[str]],
                 clip_samples: int = 32000, seed: int = 10):
        import pathlib
        self.clip_samples = clip_samples
        self._rng = random.Random(seed)
        self.entries: List[Tuple[str, float]] = []
        self.index_pools: Dict[str, np.ndarray] = {}
        cursor = 0
        for category, dirs in audio_manifest.items():
            label = 1.0 if category == "targets" else 0.0
            if isinstance(dirs, dict):   # manifest style {key: dir}
                pairs = dirs.items()
            else:
                pairs = ((f"{category}_{i}", d) for i, d in enumerate(dirs))
            for key, d in pairs:
                paths = sorted(str(p) for p in pathlib.Path(d).rglob("*.wav"))
                if not paths:
                    continue
                self.entries.extend((p, label) for p in paths)
                self.index_pools[key] = np.arange(cursor,
                                                  cursor + len(paths),
                                                  dtype=np.int64)
                cursor += len(paths)
        self.total_samples = cursor
        self.sample_hardness = np.ones(cursor, np.float32)
        print_info(f"E2E audio dataset: {len(self.index_pools)} sources | "
                   f"{cursor} clips")

    def __len__(self):
        return self.total_samples

    def _fixed_length(self, data: np.ndarray) -> np.ndarray:
        n = len(data)
        out = np.zeros(self.clip_samples, np.float32)
        if n > self.clip_samples:
            start = self._rng.randint(0, n - self.clip_samples)
            out[:] = data[start:start + self.clip_samples]
        else:
            out[:n] = data
        return out

    def gather(self, indices):
        feats = np.zeros((len(indices), self.clip_samples), np.float32)
        labels = np.zeros(len(indices), np.float32)
        for j, idx in enumerate(indices):
            path, label = self.entries[int(idx)]
            data = load_audio(path)
            if data is not None:
                feats[j] = self._fixed_length(data)
            labels[j] = label
        return feats, labels, np.asarray(indices, np.int64)

    def update_hardness(self, indices, raw_bce, alpha=0.05, floor=0.05):
        old = self.sample_hardness[indices]
        new = alpha * raw_bce.astype(np.float32) + (1 - alpha) * old
        self.sample_hardness[indices] = np.maximum(new, floor)

    def reset_hardness(self, decay=0.5):
        self.sample_hardness *= decay
        self.sample_hardness += 1.0 - decay


class E2EModel:
    """Model-compatible handle over an EndToEndModule (what Trainer needs:
    .module / .variables / .history / .load_variables / params utils)."""

    def __init__(self, classifier_model, clip_samples: int = 32000,
                 context_frames: int = 16, freeze_encoder: bool = False,
                 seed: int = 10):
        self.classifier_model = classifier_model
        self.model_name = classifier_model.model_name
        self.model_type = classifier_model.model_type
        self.n_classes = classifier_model.n_classes
        self.input_shape = (clip_samples,)
        self.embedding_dim = classifier_model.embedding_dim
        self.stateful = False
        self.history = classifier_model.history
        self.clip_samples = clip_samples
        self.context_frames = context_frames

        # Warm-start the encoder from the bundled pretrained asset when
        # present — e2e training then fine-tunes (or freezes) a real speech
        # embedding instead of learning one from scratch. The module's
        # encoder geometry follows the asset's architecture.
        from nanowakeword_tpu.data.features import pretrained_encoder_variables
        from nanowakeword_tpu.models.embedding import infer_encoder_arch
        pretrained = pretrained_encoder_variables()
        arch = (infer_encoder_arch(pretrained)
                if pretrained is not None else "conv4")

        self.module = EndToEndModule(
            classifier=classifier_model.module,
            context_frames=context_frames,
            freeze_encoder=freeze_encoder,
            encoder_arch=arch)
        dummy = jnp.zeros((1, clip_samples), jnp.float32)
        self.variables = self.module.init(
            {"params": jax.random.PRNGKey(seed)}, dummy)
        if pretrained is not None:
            params = dict(self.variables["params"])
            params["encoder"] = pretrained["params"]
            self.variables = dict(self.variables, params=params)

    @property
    def params(self):
        return self.variables["params"]

    def load_variables(self, variables):
        self.variables = variables

    def n_params(self) -> int:
        return int(sum(np.prod(p.shape)
                       for p in jax.tree_util.tree_leaves(self.params)))

    @staticmethod
    def average_models(param_trees):
        from nanowakeword_tpu.models.model import Model
        return Model.average_models(param_trees)

    def plot_history(self, output_dir):
        return self.classifier_model.plot_history(output_dir)

    def export_components(self):
        """-> (classifier Model with trained weights, encoder_variables)."""
        enc_vars, clf_vars = split_variables(self.variables)
        self.classifier_model.load_variables(clf_vars)
        return self.classifier_model, enc_vars
