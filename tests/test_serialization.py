"""Variable trees to and from bytes (nanowakeword_tpu/serialization.py).

The shipped encoder assets and `.nww` artifacts were written by Flax; they
must read back to the same arrays and write back to the same bytes."""

import glob
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanowakeword_tpu import serialization as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = sorted(glob.glob(os.path.join(REPO, "nanowakeword_tpu", "assets",
                                       "*.msgpack")))
ARTIFACTS = sorted(glob.glob(os.path.join(REPO, "campaign", "*.nww")))


def _payload(path: str) -> bytes:
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".nww"):
        (hlen,) = struct.unpack("<I", data[4:8])
        return data[8 + hlen:]
    return data


@pytest.mark.parametrize("path", ASSETS + ARTIFACTS,
                         ids=lambda p: os.path.basename(p))
def test_shipped_files_round_trip_byte_for_byte(path):
    blob = _payload(path)
    tree = S.msgpack_restore(blob)
    assert jax.tree_util.tree_leaves(tree), "no arrays restored"
    assert S.msgpack_serialize(tree) == blob


@pytest.mark.parametrize("path", ASSETS[:1] + ARTIFACTS[:1],
                         ids=lambda p: os.path.basename(p))
def test_restore_matches_flax(path):
    flax_ser = pytest.importorskip("flax.serialization")
    blob = _payload(path)
    ours, theirs = S.msgpack_restore(blob), flax_ser.msgpack_restore(blob)
    assert (jax.tree_util.tree_structure(ours)
            == jax.tree_util.tree_structure(theirs))
    for a, b in zip(jax.tree_util.tree_leaves(ours),
                    jax.tree_util.tree_leaves(theirs)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_dtypes_scalars_and_device_arrays():
    tree = {"f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "bf16": jnp.asarray([1.5, -2.0], jnp.bfloat16),
            "i8": np.asarray([-3, 4], np.int8),
            "scalar": np.float32(0.25), "meta": {"name": "x", "n": 3}}
    back = S.msgpack_restore(S.msgpack_serialize(tree))
    assert back["bf16"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(back["bf16"], np.asarray(tree["bf16"]))
    np.testing.assert_array_equal(back["f32"], tree["f32"])
    assert back["i8"].dtype == np.int8
    assert back["scalar"] == np.float32(0.25)
    assert back["meta"] == {"name": "x", "n": 3}


def test_from_state_dict_checks_keys():
    target = {"params": {"a": 0, "b": 0}}
    state = {"params": {"a": 1, "b": 2, "extra": 3}}
    assert S.from_state_dict(target, state) == {"params": {"a": 1, "b": 2}}
    with pytest.raises(ValueError, match="lacks keys"):
        S.from_state_dict(target, {"params": {"a": 1}})
