"""Variable trees to and from bytes, in Flax's msgpack state-dict format.

Nested string-keyed dicts are msgpack maps; arrays are msgpack extension
type 1 holding a packed `(shape, dtype name, C-order bytes)` triple, and
numpy scalars extension type 3 (Flax's type 2, Python complex numbers, no
file here holds). The encoder assets and `.nww` artifacts are
written in this format, so files written by Flax and by this module read the
same either way.
"""

from __future__ import annotations

from typing import Any

import jax
import msgpack
import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_to_bytes(arr) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    dtype = jax.numpy.bfloat16 if dtype_name == b"bfloat16" \
        else np.dtype(dtype_name.decode())
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def _ext_pack(x):
    if isinstance(x, (np.ndarray, jax.Array)):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    return x


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def msgpack_serialize(tree: Any) -> bytes:
    """Bytes of a tree of dicts, lists, scalars and arrays."""
    return msgpack.packb(tree, default=_ext_pack, strict_types=True)


def msgpack_restore(data: bytes) -> Any:
    """The tree `msgpack_serialize` wrote; arrays come back as numpy."""
    return msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False)


def from_state_dict(target: Any, state: Any) -> Any:
    """`state` restricted to the dict keys of `target`, checked recursively:
    a key of `target` missing from `state` raises."""
    if not isinstance(target, dict):
        return state
    missing = {str(k) for k in target} - set(state)
    if missing:
        raise ValueError(f"state dict lacks keys {sorted(missing)}")
    return {k: from_state_dict(v, state[str(k)]) for k, v in target.items()}
