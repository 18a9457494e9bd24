"""Device-memory sizing: one rule for every platform."""

import types

import pytest

from nanowakeword_tpu.config import generator as G
from nanowakeword_tpu.utils import devices as D

GiB = 2 ** 30


def _fake(stats):
    return types.SimpleNamespace(memory_stats=lambda: stats)


@pytest.mark.parametrize("stats, want", [
    ({"bytes_limit": 60 * GiB, "bytes_in_use": 0}, 60 * GiB),
    ({"bytes_in_use": 5}, None),
    (None, None),
])
def test_device_memory_bytes(stats, want):
    assert D.device_memory_bytes(_fake(stats)) == want


@pytest.mark.parametrize("mem, want", [
    (None, 128),                 # unknown (the CPU): the low end
    (512 * 2 ** 20, 128),        # clamped up
    (16 * GiB, 2048),
    (60 * GiB, 4096),            # clamped down
])
def test_feature_batch_per_device(mem, want):
    assert D.feature_batch_per_device(mem) == want


def test_generator_sizes_from_memory(monkeypatch):
    monkeypatch.setattr(G, "_device_info", lambda: (4, 60 * GiB))
    cfg = G.ConfigGenerator().generate()
    assert cfg["feature_batch_size"] == 4 * 4096
    assert cfg["tts_batch_size"] == 256
    monkeypatch.setattr(G, "_device_info", lambda: (8, None))
    cfg = G.ConfigGenerator().generate()
    assert cfg["feature_batch_size"] == 8 * 128
    assert cfg["tts_batch_size"] == 64


def test_int8_corpus_threshold_follows_device_memory(monkeypatch):
    from nanowakeword_tpu.train import pretrain_encoder as pe
    from nanowakeword_tpu.utils import devices
    monkeypatch.setattr(pe, "_CLIP_INT8_BYTES", None)
    monkeypatch.setattr(devices, "device_memory_bytes", lambda: 80 * GiB)
    assert pe._clip_int8_bytes() == 40 * GiB
    monkeypatch.setattr(devices, "device_memory_bytes", lambda: None)
    assert pe._clip_int8_bytes() == float("inf")
    monkeypatch.setattr(pe, "_CLIP_INT8_BYTES", 1)
    assert pe._clip_int8_bytes() == 1
