"""Frontend model-asset registry.

Parity target: `/root/reference/nanowakeword/interpreter/models/_registry.py`
— lazy attribute access (`models.melspectrogram_onnx`, `:84-114`) resolving
pretrained assets, downloading on first use (`:34-47`).

Difference from the reference: the mel frontend and speech-embedding encoder are
*computed* components of this framework (ops/mel.py, models/embedding.py),
not downloaded graphs — so the registry's job inverts: it materialises and
caches the framework's own assets (the deterministic encoder initialisation,
or a trained encoder checkpoint) on disk, and still supports pulling
user-specified remote checkpoints by URL for teams that distribute a shared
pretrained encoder.
"""

from __future__ import annotations

import os
from typing import Optional

from nanowakeword_tpu.utils.logger import print_info

DEFAULT_CACHE = os.path.join(os.path.expanduser("~"), ".cache",
                             "nanowakeword_tpu", "models")

# name -> optional remote URL override via env NWW_<NAME>_URL
_ASSETS = ("speech_encoder", "vad")


class ModelRegistry:
    """Resolves named frontend assets to local paths, creating or
    downloading them on first access."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or os.environ.get("NWW_CACHE",
                                                     DEFAULT_CACHE)

    def _ensure_dir(self, name: str) -> str:
        d = os.path.join(self.cache_dir, name)
        os.makedirs(d, exist_ok=True)
        return d

    def _maybe_download(self, name: str) -> Optional[str]:
        url = os.environ.get(f"NWW_{name.upper()}_URL")
        if not url:
            return None
        from nanowakeword_tpu.utils.download_files import download_file
        return download_file(url, self._ensure_dir(name))

    @property
    def speech_encoder(self) -> str:
        """Path to the speech-embedding encoder variables (.msgpack).

        Preference order: NWW_SPEECH_ENCODER_URL download > bundled
        PRETRAINED asset (shipped with the package, trained by
        train/pretrain_encoder.py) > cached file > freshly materialised
        deterministic (seed-10) initialisation as a last resort.
        """
        remote = self._maybe_download("speech_encoder")
        if remote:
            return remote
        from nanowakeword_tpu.assets import speech_encoder_asset_path
        bundled = speech_encoder_asset_path()
        if bundled is not None:
            return bundled
        d = self._ensure_dir("speech_encoder")
        path = os.path.join(d, "speech_encoder.msgpack")
        if not os.path.exists(path):
            from nanowakeword_tpu import serialization
            import jax
            import numpy as np
            from nanowakeword_tpu.data.features import \
                _default_encoder_variables
            variables = jax.tree_util.tree_map(
                np.asarray, _default_encoder_variables())
            with open(path, "wb") as f:
                f.write(serialization.msgpack_serialize(variables))
            print_info(f"Materialised default speech encoder at {path}")
        return path

    def load_speech_encoder_variables(self):
        """Load the registry's encoder variables as a pytree."""
        from nanowakeword_tpu import serialization
        from nanowakeword_tpu.data.features import _default_encoder_variables
        with open(self.speech_encoder, "rb") as f:
            payload = serialization.msgpack_restore(f.read())
        template = _default_encoder_variables()
        return serialization.from_state_dict(template, payload)

    def __getattr__(self, name: str):
        # lazy attribute surface like the reference registry (`:84-114`)
        if name.endswith("_path") and name[:-5] in _ASSETS:
            return getattr(self, name[:-5])
        raise AttributeError(name)


models = ModelRegistry()
