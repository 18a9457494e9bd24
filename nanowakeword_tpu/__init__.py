"""nanowakeword-tpu: a JAX wake-word detection framework.

Public API parity with the reference package
(`/root/reference/nanowakeword/__init__.py:1-5`): `NanoInterpreter`, `VAD`,
`AudioFeatures` at the top level; the interpreter subpackage re-exports the
security API.
"""

__version__ = "0.6.0"

from nanowakeword_tpu.data.features import AudioFeatures  # noqa: F401
from nanowakeword_tpu.interpreter.nanointerpreter import (  # noqa: F401
    DetectionResult, NanoInterpreter)
from nanowakeword_tpu.interpreter.vad import VAD  # noqa: F401

__all__ = ["NanoInterpreter", "DetectionResult", "VAD", "AudioFeatures"]

# module-root path constant, as in the reference (`__init__.py:8-12`)
from pathlib import Path as _Path

PROJECT_ROOT = _Path(__file__).resolve().parent
