"""Knowledge distillation: teacher -> tiny DNN "lite" gate model.

Parity target: `/root/reference/nanowakeword/train/distill.py` —
`distill_model` (`:83-213`), `distill_from_onnx`'s standalone-from-artifact
mode (`:216-362`, here `distill_from_artifact` over `.nww`), and the student
recipe: always a DNN, default layer=8 / blocks=1 / emb=8 ≈ 12K params
(`:45-76`); loss = alpha * T^2 * binaryKL + (1-alpha) * BCE with T=4.0,
alpha=0.7 (`:154-184`); AdamW + OneCycle over 8000 steps, grad clip 1.0,
EMA-best state restore (`:186-208`).

Design: one jitted distill step evaluates teacher (frozen) and student
and applies the update; the teacher's logits come straight from its Flax
apply — no ONNX round-trip or sigmoid inversion needed.
"""

from __future__ import annotations

import copy
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from tqdm import tqdm

from nanowakeword_tpu.models.model import Model
from nanowakeword_tpu.train.cached import materialize_rows
from nanowakeword_tpu.train.loss import distill_loss
from nanowakeword_tpu.utils.logger import print_info


def build_student(teacher_name: str, input_shape: Tuple[int, ...],
                  dist_cfg) -> Model:
    """Tiny DNN student with the teacher's I/O interface (distill.py:45-76)."""
    student_config = {
        "activation_function": "relu",
        "embedding_dim": int(dist_cfg.get("student_embedding_dim", 8)),
    }
    return Model(
        config=student_config,
        model_name=teacher_name + "_lite",
        n_classes=1,
        input_shape=input_shape,
        model_type="dnn",
        layer_dim=int(dist_cfg.get("student_layer_size", 8)),
        n_blocks=int(dist_cfg.get("student_n_blocks", 1)),
        dropout_prob=float(dist_cfg.get("student_dropout_prob", 0.1)),
    )


def _make_distill_step(teacher_module, teacher_variables, student_module, tx,
                       temperature: float, alpha: float):
    def teacher_logits_fn(features):
        return teacher_module.apply(teacher_variables, features,
                                    deterministic=True).reshape(-1)

    def loss_fn(params, rng, features, labels):
        t_logits = jax.lax.stop_gradient(teacher_logits_fn(features))
        s_logits = student_module.apply(
            {"params": params}, features, deterministic=False,
            rngs={"dropout": rng}).reshape(-1)
        return distill_loss(s_logits, t_logits, labels, temperature, alpha)

    @jax.jit
    def step(params, opt_state, rng, step_idx, features, labels):
        k = jax.random.fold_in(rng, step_idx)
        loss, grads = jax.value_and_grad(loss_fn)(params, k, features, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def _run_distill_loop(teacher_module, teacher_variables, student: Model,
                      X_train, steps: int, temperature: float,
                      alpha: float, lr: float, log_interval: int,
                      desc: str) -> Model:
    tx = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adamw(
            learning_rate=optax.cosine_onecycle_schedule(
                transition_steps=steps, peak_value=lr, pct_start=0.3,
                div_factor=25.0, final_div_factor=1e4),
            weight_decay=1e-3))
    params = student.params
    opt_state = tx.init(params)
    rng = jax.random.PRNGKey(10)
    step_fn = _make_distill_step(teacher_module, teacher_variables,
                                 student.module, tx, temperature, alpha)

    ema_alpha = 0.02

    # Device-resident K-step dispatches (same shape as train/cached.py):
    # a per-step host loop would pay a SYNCHRONOUS loss fetch every step
    # plus a full best-params fetch on every EMA improvement. The EMA and
    # the best-(EMA, params) tracker run inside
    # the scan instead; semantics are bit-identical (same rng, same EMA
    # recurrence seeded by the first loss, same strict-< improvement rule)
    # and the host fetches one [K] loss trace per dispatch.
    #
    # The FEATURES are device-resident too: the dataset uploads once and
    # each dispatch ships only the sampler's [K, batch] int32 index matrix
    # — ~0.26 MB vs the ~786 MB of gathered float32 batches a host path
    # would ship per 250-step dispatch, as train/cached.py does. Same
    # rng/EMA/best-restore semantics; the gather moves inside the scan.
    feats_host, labels_host = materialize_rows(X_train[0])
    print_info(f"[Distillation] Uploading {len(feats_host)} feature rows "
               "to device HBM (device-cache distill mode)...")
    cache_f = jax.device_put(feats_host)
    cache_l = jax.device_put(labels_host)
    del feats_host, labels_host

    def one_step_in(cache_f, cache_l):
        def one_step(carry, inputs):
            params, opt_state, ema, best_loss, best_params = carry
            i, row_idx = inputs
            feats = jnp.take(cache_f, row_idx, axis=0)
            labels = jnp.take(cache_l, row_idx, axis=0)
            params, opt_state, loss = step_fn(params, opt_state, rng, i,
                                              feats, labels)
            ema = jnp.where(i == 0, loss, ema_alpha * loss
                            + (1 - ema_alpha) * ema)
            improved = ema < best_loss
            best_loss = jnp.where(improved, ema, best_loss)
            best_params = jax.tree_util.tree_map(
                lambda b, p: jnp.where(improved, p, b), best_params, params)
            return (params, opt_state, ema, best_loss, best_params), ema
        return one_step

    @functools.partial(jax.jit, donate_argnums=(0,))
    def run_k(carry, idx, row_idx, cache_f, cache_l):
        return jax.lax.scan(one_step_in(cache_f, cache_l), carry,
                            (idx, row_idx))

    k_steps = int(min(250, steps))
    # best_params must be a REAL copy: params is donated, and donating the
    # same buffer twice (params + a no-copy alias) is an XLA error
    carry = (params, opt_state, jnp.float32(0.0), jnp.float32(np.inf),
             jax.tree_util.tree_map(jnp.copy, params))
    pbar = tqdm(total=steps, desc=desc, unit="step")
    done = 0
    ema_tail = float("nan")
    index_iter = _cycle_indices(X_train)
    while done < steps:
        k = min(k_steps, steps - done)
        row_idx = np.stack([next(index_iter) for _ in range(k)])
        carry, ema_trace = run_k(
            carry, jnp.arange(done, done + k),
            jnp.asarray(row_idx, jnp.int32), cache_f, cache_l)
        ema_tail = float(np.asarray(ema_trace)[-1])
        done += k
        pbar.update(k)
        pbar.set_postfix({"ema_loss": f"{ema_tail:.4f}"})
    pbar.close()

    _, _, _, best_loss, best_params = carry
    best_loss = float(best_loss)
    if np.isfinite(best_loss):
        params = best_params
        print_info(f"[Distillation] Best EMA loss: {best_loss:.4f}")
    student.params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p)), params)
    print_info("[Distillation] Student model ready.")
    return student


def _cycle_indices(X_train):
    """Endless sampled-row-index iterator over a (dataset, sampler) pair.

    The gather itself happens on device against the uploaded cache
    (_run_distill_loop), so only these int indices ever cross the host
    boundary."""
    _, sampler = X_train
    while True:
        yield np.asarray(sampler.sample_batch(), np.int64)


def distill_model(teacher: Model, X_train, config,
                  input_shape: Tuple[int, ...]) -> Model:
    """Distill from an in-memory trained teacher (distill.py:83-213)."""
    dist_cfg = config.get("distillation", {})
    steps = int(dist_cfg.get("steps", 8000))
    temperature = float(dist_cfg.get("temperature", 4.0))
    alpha = float(dist_cfg.get("alpha", 0.7))
    lr = float(dist_cfg.get("learning_rate", 5e-4))
    log_interval = int(dist_cfg.get("log_interval", 500))

    student = build_student(teacher.model_name, input_shape, dist_cfg)
    t_params, s_params = teacher.n_params(), student.n_params()
    print_info(f"[Distillation] Teacher params : {t_params:,}")
    print_info(f"[Distillation] Student params : {s_params:,}  "
               f"({t_params / max(s_params, 1):.1f}x smaller)")
    print_info(f"[Distillation] Steps          : {steps}")
    print_info(f"[Distillation] Temperature    : {temperature}")
    print_info(f"[Distillation] Alpha (soft)   : {alpha}")

    return _run_distill_loop(teacher.module, teacher.variables, student,
                             X_train, steps, temperature,
                             alpha, lr, log_interval, desc="Distilling")


def distill_from_artifact(artifact_path: str, X_train, config,
                          input_shape: Tuple[int, ...], output_dir: str,
                          model_name: str) -> str:
    """Standalone distillation from an exported .nww teacher
    (the reference's distill_from_onnx, distill.py:216-362)."""
    from nanowakeword_tpu.export.artifact import EXTENSION, export_model, \
        load_nww

    dist_cfg = config.get("distillation", {})
    from nanowakeword_tpu.trainer import _check_weights_dtype
    _check_weights_dtype(dist_cfg)  # fail before the distill loop runs
    steps = int(dist_cfg.get("steps", 8000))
    temperature = float(dist_cfg.get("temperature", 4.0))
    alpha = float(dist_cfg.get("alpha", 0.7))
    lr = float(dist_cfg.get("learning_rate", 5e-4))
    log_interval = int(dist_cfg.get("log_interval", 500))

    header, teacher, encoder_vars = load_nww(artifact_path)
    student = build_student(model_name, input_shape, dist_cfg)
    print_info(f"[Distillation] Student params: {student.n_params():,}")
    print_info(f"[Distillation] Steps: {steps}, Temperature: {temperature}, "
               f"Alpha: {alpha}")

    student = _run_distill_loop(teacher.module, teacher.variables, student,
                                X_train, steps, temperature,
                                alpha, lr, log_interval,
                                desc="Distilling (from artifact)")

    lite_name = model_name + "_lite"
    export_model(student, input_shape, config, lite_name, output_dir,
                 encoder_variables=encoder_vars,
                 weights_dtype=dist_cfg.get("weights_dtype"))
    lite_path = f"{output_dir}/{lite_name}{EXTENSION}"
    print_info(f"[Distillation] Lite model exported to: {lite_path}")
    return lite_path
