"""What the program may ask of its devices: memory and sizing rules."""

from __future__ import annotations

from typing import Optional

import jax

# device memory budgeted per clip of a feature-extraction batch: audio,
# mel, encoder activations and XLA's temporaries, with room to spare
FEATURE_BYTES_PER_CLIP = 8 * 2**20
FEATURE_BATCH_RANGE = (128, 4096)


def device_memory_bytes(device=None) -> Optional[int]:
    """The memory the allocator may use on `device` (default: the first),
    or None where the backend reports none (the CPU)."""
    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats()
    if not stats or "bytes_limit" not in stats:
        return None
    return int(stats["bytes_limit"])


def feature_batch_per_device(bytes_limit: Optional[int]) -> int:
    """Clips per device in one feature-extraction step: the largest power
    of two within FEATURE_BYTES_PER_CLIP each, clamped to
    FEATURE_BATCH_RANGE; the low end where memory is unknown."""
    lo, hi = FEATURE_BATCH_RANGE
    if not bytes_limit:
        return lo
    n = bytes_limit // FEATURE_BYTES_PER_CLIP
    return max(lo, min(hi, 1 << (max(int(n), 1).bit_length() - 1)))
