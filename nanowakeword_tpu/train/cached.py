"""Device-resident ISBL training: compiled multi-step dispatches.

The host-loop trainer (train/trainer.py) pays per step: an ISBL sample on
the host, an mmap gather, a host->device batch transfer, a dispatch, and a
metrics fetch. For feature datasets that fit in HBM (a 1M-clip set at
[16, 96] float32 is ~6 GB), ALL of it can live on device:

* features, labels, per-rule index pools, and the hardness array are
  uploaded once;
* each dispatch runs K training steps inside one `lax.scan`: per step it
  samples the batch composition ON DEVICE (Gumbel top-k over
  `log(hardness^0.75 + eps)` == multinomial without replacement — the
  reference's exact sampler semantics, data_sampler.py:208-220), gathers the
  batch with a device take, runs the fused train step, and scatters the
  hardness EMA update back;
* the host gets back one [K, 6] metrics array per dispatch — loss,
  grad_norm, tp, fn, fa, n_pos per step — and touches nothing else.

Per-step host traffic: zero. Per-K-steps: one dispatch + one small fetch.
Enabled via `device_cache: {enabled: true, steps_per_dispatch: 100}`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.train import loss as losses
from nanowakeword_tpu.train.step import (TrainState, cast_floating,
                                          resolve_compute_dtype)
from nanowakeword_tpu.utils.logger import print_info

HARDNESS_SMOOTHING = 0.75
WEIGHT_FLOOR = 1e-6


class CachedData(NamedTuple):
    features: jnp.ndarray          # [N, T, F] on device
    labels: jnp.ndarray            # [N]
    hardness: jnp.ndarray          # [N]
    pools: Tuple[jnp.ndarray, ...]  # per-rule global index arrays
    quotas: Tuple[int, ...]         # static per-rule quotas
    replace: Tuple[bool, ...]       # static with-replacement flags


def materialize_rows(dataset):
    """Contiguous host copies of every (feature, label) row of a dataset.

    Shared by the device-cache builders (training here, distillation in
    train/distill.py): one pass over the mmap-backed rows into dense
    float32 arrays, ready for a single host->device upload. Rows with
    differing frame counts are pad/truncated to the dataset's most common
    length — the same collate policy as Dataset.gather, applied once
    globally instead of per batch (a static device cache needs one shape)."""
    n = len(dataset)
    rows = []
    labels = np.empty(n, np.float32)
    for i in range(n):
        f, lbl, _ = dataset[i]
        rows.append(f)
        labels[i] = lbl
    lengths = [r.shape[0] for r in rows]
    target_len = max(set(lengths), key=lengths.count)
    feats = np.zeros((n, target_len, rows[0].shape[1]), np.float32)
    for i, f in enumerate(rows):
        m = min(f.shape[0], target_len)
        feats[i, :m] = f[:m]
    return feats, labels


def build_cached_data(dataset, batch_composition: Dict[str, int],
                      feature_manifests) -> CachedData:
    """Upload the whole dataset + ISBL state to the device."""
    print_info(f"Uploading {len(dataset)} feature rows to device HBM "
               "(device-cache training mode)...")
    feats, labels = materialize_rows(dataset)

    pools, quotas, replace = [], [], []
    for rule, quota in batch_composition.items():
        quota = int(quota)
        if quota == 0:
            continue
        if rule in dataset.index_pools:
            pool = dataset.index_pools[rule]
        else:
            keys = list(feature_manifests.get(rule, {}).keys())
            parts = [dataset.index_pools[k] for k in keys
                     if k in dataset.index_pools]
            if not parts:
                continue
            pool = np.concatenate(parts)
        pools.append(jnp.asarray(pool, jnp.int32))
        quotas.append(quota)
        replace.append(len(pool) < quota)

    return CachedData(
        features=jax.device_put(feats),
        labels=jax.device_put(labels),
        hardness=jax.device_put(dataset.sample_hardness.astype(np.float32)),
        pools=tuple(pools), quotas=tuple(quotas), replace=tuple(replace))


def put_cached_on_mesh(data: CachedData, mesh) -> CachedData:
    """Replicate the device cache across every chip of a mesh.

    The cache is replicated (it must fit per-chip HBM — same budget as the
    single-chip mode); only the sampled BATCH is sharded, inside the loop.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P
    repl = NamedSharding(mesh, P())

    def put(x):
        return jax.device_put(x, repl)

    return CachedData(features=put(data.features), labels=put(data.labels),
                      hardness=put(data.hardness),
                      pools=tuple(put(p) for p in data.pools),
                      quotas=data.quotas, replace=data.replace)


# Pool size above which "auto" sampling switches to approx_max_k. Exact
# top_k is sort-based and grows superlinearly with the pool; approx_max_k
# is a partial reduction on backends that implement one. On the GPU, XLA
# lowers approx_max_k to an exact top-k, so there both choices give the
# same samples and the option only matters elsewhere.
APPROX_SAMPLING_MIN_POOL = 131_072


def _sample_rule(key, pool, hardness, quota: int, with_replacement: bool,
                 sampling: str = "auto"):
    """ISBL selection for one composition rule, on device.

    ``sampling``: "exact" keeps the reference's multinomial-without-
    replacement distribution bit-for-bit (Gumbel top-k, sort-based);
    "approx" uses `jax.lax.approx_max_k` (default 0.95 recall target),
    a statistically indistinguishable weighted sample whose cost stays
    near-flat in pool size; "auto" picks exact below
    APPROX_SAMPLING_MIN_POOL and approx above it.
    """
    w = hardness[pool] ** HARDNESS_SMOOTHING + WEIGHT_FLOOR
    logw = jnp.log(w)
    if with_replacement:
        chosen = jax.random.categorical(key, logw, shape=(quota,))
    else:
        # Gumbel top-k == weighted sampling without replacement
        gumbel = -jnp.log(-jnp.log(
            jax.random.uniform(key, logw.shape, minval=1e-7, maxval=1.0)))
        approx = sampling == "approx" or (
            sampling == "auto" and pool.shape[0] > APPROX_SAMPLING_MIN_POOL)
        if approx:
            _, chosen = jax.lax.approx_max_k(logw + gumbel, quota)
        else:
            _, chosen = jax.lax.top_k(logw + gumbel, quota)
    return pool[chosen]


def make_cached_train_loop(module, tx, *, quotas: Tuple[int, ...],
                           replace: Tuple[bool, ...], k_steps: int,
                           loss_function: str = "bias_weighted",
                           loss_bias: float = 0.75,
                           logit_reg_weight: float = 2e-4,
                           logit_reg_margin: float = 6.0,
                           hardness_alpha: float = 0.05,
                           hardness_floor: float = 0.05,
                           sampling: str = "auto",
                           compute_dtype: str = "float32",
                           mesh=None):
    """Build (state, hardness, key, features, labels, pools) ->
    (state, hardness, key, metrics [K, 6]).

    With ``mesh``, each step's sampled batch is sharded over the ``data``
    axis — sampling and the hardness scatter stay replicated (they are O(N)
    elementwise, not worth a collective), while the forward/backward FLOPs
    split across chips and XLA psums the gradients over ICI. Use
    `put_cached_on_mesh` + `parallel.dp.shard_train_state` on the inputs.
    """
    if sampling not in ("exact", "approx", "auto"):
        raise ValueError("device_cache.sampling must be 'exact', 'approx' "
                         f"or 'auto', got {sampling!r}")
    loss_fn_name = loss_function.lower()
    # bf16 mixed precision: see make_train_step's compute_dtype note —
    # masters/loss/grads/BatchNorm running stats stay f32; apply-side casts
    # of params and features only
    cdt = resolve_compute_dtype(compute_dtype)

    batch_sharding = None
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        from nanowakeword_tpu.parallel.mesh import DATA_AXIS
        batch_sharding = NamedSharding(mesh, P(DATA_AXIS))

    def one_step(carry, _):
        state, hardness, key, features, labels, pools = carry
        key, *rule_keys = jax.random.split(key, len(quotas) + 1)
        idx = jnp.concatenate([
            _sample_rule(rk, pool, hardness, q, r, sampling)
            for rk, pool, q, r in zip(rule_keys, pools, quotas, replace)])
        batch_x = jnp.take(features, idx, axis=0)
        batch_y = jnp.take(labels, idx, axis=0)
        if batch_sharding is not None:
            batch_x = jax.lax.with_sharding_constraint(batch_x,
                                                       batch_sharding)
            batch_y = jax.lax.with_sharding_constraint(batch_y,
                                                       batch_sharding)

        def loss_and_aux(params, batch_stats, rng):
            if cdt is not None:
                apply_params = cast_floating(params, cdt)
                x_in = batch_x.astype(cdt)
            else:
                apply_params, x_in = params, batch_x
            variables = {"params": apply_params}
            if batch_stats:
                variables["batch_stats"] = batch_stats
                logits, updates = module.apply(
                    variables, x_in, deterministic=False,
                    rngs={"dropout": rng}, mutable=["batch_stats"])
            else:
                logits = module.apply(variables, x_in,
                                      deterministic=False,
                                      rngs={"dropout": rng})
                updates = {}
            logits = logits.reshape(-1).astype(jnp.float32)
            if loss_fn_name == "asymmetric_focal":
                total, _ = losses.asymmetric_focal_loss(logits, batch_y,
                                                        loss_bias)
            else:
                total, _ = losses.bias_weighted_loss(logits, batch_y,
                                                     loss_bias)
            if logit_reg_weight > 0:
                total = total + logit_reg_weight * \
                    losses.logit_regularisation(logits, batch_y,
                                                logit_reg_margin)
            raw = losses.raw_bce(jax.lax.stop_gradient(logits), batch_y)
            new_bs = updates.get("batch_stats", batch_stats)
            return total, (raw, jax.lax.stop_gradient(logits), new_bs)

        import optax
        rng = jax.random.fold_in(state.rng, state.step)
        (total, (raw, logits, new_bs)), grads = jax.value_and_grad(
            loss_and_aux, has_aux=True)(state.params, state.batch_stats, rng)
        grad_norm = optax.global_norm(grads)
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        state = TrainState(params=new_params, batch_stats=new_bs,
                           opt_state=new_opt, step=state.step + 1,
                           rng=state.rng)

        # hardness EMA + floor, scattered in place (train_model.py:563-588)
        old = hardness[idx]
        new = jnp.maximum(hardness_alpha * raw + (1 - hardness_alpha) * old,
                          hardness_floor)
        hardness = hardness.at[idx].set(new)

        # per-step stats for history/recall logging
        yp = jax.nn.sigmoid(logits)
        is_pos = batch_y == 1
        tp = jnp.sum((yp >= 0.5) & is_pos).astype(jnp.float32)
        fn = jnp.sum((yp < 0.5) & is_pos).astype(jnp.float32)
        fa = jnp.sum((yp > 0.5) & (~is_pos)).astype(jnp.float32)
        n_pos = jnp.sum(is_pos).astype(jnp.float32)
        metrics = jnp.stack([total.astype(jnp.float32),
                             grad_norm.astype(jnp.float32), tp, fn, fa,
                             n_pos])
        return (state, hardness, key, features, labels, pools), metrics

    def run(state, hardness, key, features, labels, pools):
        (state, hardness, key, _, _, _), metrics = jax.lax.scan(
            one_step, (state, hardness, key, features, labels, pools),
            None, length=k_steps)
        return state, hardness, key, metrics

    return jax.jit(run, donate_argnums=(0, 1))
