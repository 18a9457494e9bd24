"""ISBL dataset + sampler: loss-aware importance sampling over mmap features.

Parity target: `/root/reference/nanowakeword/data/data_sampler.py` —
`AdaptiveLossAwareDataset` (`:26`), `DynamicClassAwareSampler` (`:122`) and
`ValidationDataset` (`:238`).

Design: no torch Dataset/DataLoader. The dataset is a set of
numpy memmaps concatenated into one global index space; the sampler runs on
the host with a numpy Generator and assembles whole batches (gathered from
the memmaps) ready for `jax.device_put`. Hardness scores live in a host-side
float32 array; the jitted train step returns per-example raw BCE which the
host folds in with an EMA — the ISBL feedback loop of
`train/train_model.py:563-598` without a device sync stall (the transfer is
[B] floats and overlaps the next step's dispatch).
"""

from __future__ import annotations

import bisect
import sys
from typing import Dict, Iterator, List, Optional

import numpy as np

from nanowakeword_tpu.utils.logger import print_error, print_info

HARDNESS_SMOOTHING = 0.75   # weights = hardness ** 0.75 (data_sampler.py:136,210)
WEIGHT_FLOOR = 1e-6         # (data_sampler.py:212)


class AdaptiveLossAwareDataset:
    """Concatenates feature memmaps; label 1.0 iff category == 'targets'
    (data_sampler.py:63). Tracks per-sample hardness, init 1.0 (:91)."""

    def __init__(self, feature_manifests: Dict[str, Dict[str, str]]):
        self.memmaps: List[np.memmap] = []
        self.source_info: List[dict] = []
        self.index_pools: Dict[str, np.ndarray] = {}

        cumulative = 0
        for category, manifest in feature_manifests.items():
            if not manifest:
                continue
            for key, path in manifest.items():
                if not path:
                    continue
                try:
                    mm = np.load(path, mmap_mode="r")
                except FileNotFoundError:
                    print_error(f"File not found for key '{key}', skipping: {path}")
                    sys.exit(1)
                except Exception as e:  # noqa: BLE001
                    print_error(f"Could not load file for key '{key}'. Error: {e}")
                    continue
                length = len(mm)
                self.memmaps.append(mm)
                label = 1.0 if category == "targets" else 0.0
                self.source_info.append({
                    "label": label, "length": length, "start_index": cumulative,
                })
                self.index_pools[key] = np.arange(cumulative,
                                                  cumulative + length,
                                                  dtype=np.int64)
                cumulative += length

        self.total_samples = cumulative
        self._start_indices = [s["start_index"] for s in self.source_info]
        self.sample_hardness = np.ones(self.total_samples, dtype=np.float32)
        print_info(f"Dataset initialized with {len(self.index_pools)} sources "
                   f"| Total samples: {self.total_samples}")

    def __len__(self) -> int:
        return self.total_samples

    def _locate(self, index: int):
        file_idx = bisect.bisect_right(self._start_indices, index) - 1
        if file_idx < 0:
            raise RuntimeError(f"No data source for index {index}")
        return file_idx, index - self.source_info[file_idx]["start_index"]

    def __getitem__(self, index: int):
        if index < 0 or index >= self.total_samples:
            raise IndexError(f"Index {index} out of bounds "
                             f"(size {self.total_samples})")
        file_idx, local = self._locate(index)
        feature = np.asarray(self.memmaps[file_idx][local], np.float32)
        return feature, self.source_info[file_idx]["label"], index

    def gather(self, indices: np.ndarray):
        """Vectorised batch fetch -> (features [B,T,F], labels [B], indices).

        Features of differing frame counts are normalised to the batch's most
        common length by pad/truncate (the collate policy of
        trainer.py:95-121)."""
        feats, labels = [], np.empty(len(indices), np.float32)
        for j, idx in enumerate(indices):
            f, lbl, _ = self[int(idx)]
            feats.append(f)
            labels[j] = lbl
        lengths = [f.shape[0] for f in feats]
        target_len = max(set(lengths), key=lengths.count)
        out = np.zeros((len(feats), target_len, feats[0].shape[1]), np.float32)
        for j, f in enumerate(feats):
            n = min(f.shape[0], target_len)
            out[j, :n] = f[:n]
        return out, labels, np.asarray(indices, np.int64)

    def update_hardness(self, indices: np.ndarray, raw_bce: np.ndarray,
                        alpha: float = 0.05, floor: float = 0.05):
        """EMA hardness update with floor (train_model.py:567-588)."""
        old = self.sample_hardness[indices]
        new = alpha * raw_bce.astype(np.float32) + (1.0 - alpha) * old
        self.sample_hardness[indices] = np.maximum(new, floor)

    def reset_hardness(self, decay: float = 0.5):
        """Partial reset toward 1.0 (train_model.py:593-598)."""
        self.sample_hardness *= decay
        self.sample_hardness += 1.0 - decay


class DynamicClassAwareSampler:
    """Batch sampler honouring `batch_composition` quotas per key-or-category,
    with hardness-weighted multinomial selection (data_sampler.py:122-235)."""

    def __init__(self, dataset: AdaptiveLossAwareDataset,
                 batch_composition: Dict[str, int],
                 feature_manifests: Dict[str, Dict[str, str]],
                 seed: int = 10):
        self.dataset = dataset
        self.batch_composition = {k: int(v) for k, v in batch_composition.items()}
        self.feature_manifests = feature_manifests
        self.rng = np.random.default_rng(seed)
        self.num_samples_per_batch = sum(self.batch_composition.values())
        self.num_batches = self._calculate_num_batches()

    def _keys_for_category(self, category: str) -> List[str]:
        return list(self.feature_manifests.get(category, {}).keys())

    def _pool_for(self, key_or_category: str) -> Optional[np.ndarray]:
        if key_or_category in self.dataset.index_pools:
            return self.dataset.index_pools[key_or_category]
        keys = self._keys_for_category(key_or_category)
        pools = [self.dataset.index_pools[k] for k in keys
                 if k in self.dataset.index_pools]
        if not pools:
            return None
        return np.concatenate(pools)

    def _calculate_num_batches(self) -> int:
        """min over pools of pool_size // quota (data_sampler.py:138-176)."""
        min_batches = None
        for rule, quota in self.batch_composition.items():
            if quota == 0:
                continue
            pool = self._pool_for(rule)
            available = 0 if pool is None else len(pool)
            if available == 0:
                return 0
            possible = available // quota
            min_batches = possible if min_batches is None else min(min_batches,
                                                                   possible)
        return 0 if min_batches is None else min_batches

    def sample_batch(self) -> List[int]:
        """One batch of global indices (the loop body of
        data_sampler.py:183-232)."""
        hardness = self.dataset.sample_hardness
        batch: List[np.ndarray] = []
        for rule, quota in self.batch_composition.items():
            if quota == 0:
                continue
            pool = self._pool_for(rule)
            if pool is None or len(pool) == 0:
                continue
            weights = hardness[pool] ** HARDNESS_SMOOTHING + WEIGHT_FLOOR
            p = weights / weights.sum()
            replace = len(pool) < quota
            chosen = self.rng.choice(len(pool), size=quota, replace=replace, p=p)
            batch.append(pool[chosen])
        if not batch:
            return []
        flat = np.concatenate(batch)
        self.rng.shuffle(flat)
        return flat.tolist()

    def __iter__(self) -> Iterator[List[int]]:
        for _ in range(self.num_batches):
            b = self.sample_batch()
            if b:
                yield b

    def __len__(self) -> int:
        return self.num_batches


class ValidationDataset:
    """Flat dataset over `*_val` manifests with per-path memmap cache
    (data_sampler.py:238-287)."""

    def __init__(self, feature_manifest: Dict[str, Dict[str, str]]):
        self._entries: List[tuple] = []   # (path, local_index, label)
        self._mmap_cache: Dict[str, np.memmap] = {}
        for category, manifest_paths in feature_manifest.items():
            label = 1.0 if category == "targets" else 0.0
            for key, path in manifest_paths.items():
                try:
                    data = np.load(path, mmap_mode="r")
                except FileNotFoundError:
                    print_error(f"Validation file not found, skipping: {path}")
                    sys.exit(1)
                except Exception as e:  # noqa: BLE001
                    print_error(f"Could not probe validation file '{path}'. "
                                f"Error: {e}")
                    continue
                self._mmap_cache[path] = data
                for i in range(len(data)):
                    self._entries.append((path, i, label))

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, index: int):
        path, local, label = self._entries[index]
        return (np.asarray(self._mmap_cache[path][local], np.float32),
                label, index)

    def batches(self, batch_size: int):
        """Sequential batches (features, labels) — the val DataLoader of
        trainer.py:451-458."""
        for start in range(0, len(self._entries), batch_size):
            idx = range(start, min(start + batch_size, len(self._entries)))
            feats = np.stack([self[i][0] for i in idx])
            labels = np.asarray([self[i][1] for i in idx], np.float32)
            yield feats, labels
