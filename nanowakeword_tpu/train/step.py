"""The jitted training step: forward, loss, logit-reg, clip, update, metrics.

Parity target: the per-step body of the reference training loop
(`/root/reference/nanowakeword/train/train_model.py:496-664`) — fused into a
single XLA computation instead of a Python-interpreted torch loop:

    forward (backbone + head)                 train_model.py:505-506
    bias-weighted / focal loss                train_model.py:508-519
    asymmetric logit regularisation           train_model.py:529-551
    grad clip 1.0 + optimizer + schedule      train_model.py:553-561
    raw per-example BCE (hardness signal)     train_model.py:574-579
    batch recall / FA / miss / logit means    train_model.py:628-664

The step is donated (`donate_argnums`) so parameter and optimizer buffers are
updated in place in HBM. Multi-chip data parallelism is layered on by
`nanowakeword_tpu.parallel.dp` via sharding annotations — the step function
itself is mesh-agnostic.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from nanowakeword_tpu.train import loss as losses


class TrainState(NamedTuple):
    """Everything the step mutates, as one donatable pytree."""
    params: Any
    batch_stats: Any            # {} for BN-free architectures
    opt_state: Any
    step: jnp.ndarray           # int32 scalar
    rng: jax.Array              # PRNG key for dropout


class StepMetrics(NamedTuple):
    """Step metrics, PACKED as one device vector so the host reads them
    with a single device-to-host transfer per step:

        packed = [loss, grad_norm, per_example_bce (B), logits (B)]
    """

    packed: jnp.ndarray

    @property
    def loss(self):
        return self.packed[0]

    @property
    def grad_norm(self):
        return self.packed[1]

    @property
    def per_example_bce(self):
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2:2 + b]

    @property
    def logits(self):
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2 + b:]

    def fetch(self) -> "HostMetrics":
        """One device->host transfer; returns numpy-backed views."""
        return HostMetrics(np.asarray(self.packed))


class HostMetrics(NamedTuple):
    packed: "np.ndarray"

    @property
    def loss(self):
        return float(self.packed[0])

    @property
    def grad_norm(self):
        return float(self.packed[1])

    @property
    def per_example_bce(self):
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2:2 + b]

    @property
    def logits(self):
        b = (self.packed.shape[0] - 2) // 2
        return self.packed[2 + b:]


def create_train_state(module, variables, tx: optax.GradientTransformation,
                       seed: int = 10) -> TrainState:
    params = variables["params"]
    return TrainState(
        params=params,
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(params),
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(seed),
    )


def resolve_compute_dtype(compute_dtype) -> Optional[Any]:
    """Map a config ``compute_dtype`` string to an apply-side cast dtype.

    Returns jnp.bfloat16 for "bfloat16"/"bf16", None for full precision
    ("float32"/"f32"/"fp32"). Anything else is a config error — a silent
    fallback would make a "float16" typo train in full precision while the
    user believes mixed precision is on. Shared by the host-loop and
    device-cached train steps so the alias set and the mixed-precision
    casting rules live in one place.
    """
    name = str(compute_dtype).lower()
    if name in ("bfloat16", "bf16"):
        return jnp.bfloat16
    if name in ("float32", "f32", "fp32"):
        return None
    raise ValueError(
        "training.compute_dtype must be 'float32' or 'bfloat16', got "
        f"{compute_dtype!r} (f16/fp16 is not supported; use "
        "bfloat16)")


def cast_floating(tree, dtype):
    """Cast every floating-point leaf of ``tree`` to ``dtype``.

    Integer/bool leaves (e.g. step counters) pass through untouched. Do NOT
    apply this to BatchNorm running stats: they must stay float32 so the
    momentum-0.99 EMA can accumulate sub-bf16-ulp increments (flax computes
    batch statistics in f32 internally, so f32 stats are free in a bf16
    forward pass).
    """
    return jax.tree_util.tree_map(
        lambda p: p.astype(dtype)
        if jnp.issubdtype(p.dtype, jnp.floating) else p, tree)


def make_train_step(module, tx: optax.GradientTransformation, *,
                    loss_function: str = "bias_weighted",
                    loss_bias: float = 0.75,
                    logit_reg_weight: float = 2e-4,
                    logit_reg_margin: float = 6.0,
                    afl_gamma_pos: float = 0.0,
                    afl_gamma_neg: float = 4.0,
                    compute_dtype: str = "float32",
                    donate: bool = True,
                    jit: bool = True):
    """Build the (state, features, labels) -> (state, metrics) step function.

    compute_dtype="bfloat16" runs the forward/backward in bf16 (mixed
    precision): master params, optimizer
    moments, loss, and gradients stay float32; params/features are cast to
    bf16 around `module.apply` only. BatchNorm running stats stay float32
    end to end: flax computes batch statistics in f32 regardless of input
    dtype, so feeding the f32 stats changes nothing in the forward pass
    (verified bit-identical) while keeping the EMA update full-precision —
    a bf16-rounded running mean would erase any per-step increment below
    ~0.2% relative and freeze the stats off the true batch statistics.
    """
    loss_fn_name = loss_function.lower()
    cdt = resolve_compute_dtype(compute_dtype)

    def loss_and_aux(params, batch_stats, rng, features, labels):
        if cdt is not None:
            apply_params = cast_floating(params, cdt)
            features = features.astype(cdt)
        else:
            apply_params = params
        variables = {"params": apply_params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
            logits, updates = module.apply(
                variables, features, deterministic=False,
                rngs={"dropout": rng}, mutable=["batch_stats"])
        else:
            logits = module.apply(variables, features, deterministic=False,
                                  rngs={"dropout": rng})
            updates = {}
        logits = logits.reshape(-1).astype(jnp.float32)

        if loss_fn_name == "asymmetric_focal":
            total, per_ex = losses.asymmetric_focal_loss(
                logits, labels, loss_bias,
                gamma_pos=afl_gamma_pos, gamma_neg=afl_gamma_neg)
        else:
            total, per_ex = losses.bias_weighted_loss(logits, labels, loss_bias)

        if logit_reg_weight > 0:
            total = total + logit_reg_weight * losses.logit_regularisation(
                logits, labels, logit_reg_margin)

        raw = losses.raw_bce(jax.lax.stop_gradient(logits), labels)
        new_bs = updates.get("batch_stats", batch_stats)
        return total, (raw, jax.lax.stop_gradient(logits), new_bs)

    def step_fn(state: TrainState, features, labels):
        rng = jax.random.fold_in(state.rng, state.step)
        (total, (raw, logits, new_bs)), grads = jax.value_and_grad(
            loss_and_aux, has_aux=True)(
                state.params, state.batch_stats, rng, features, labels)
        grad_norm = optax.global_norm(grads)
        updates, new_opt_state = tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        new_state = TrainState(
            params=new_params, batch_stats=new_bs, opt_state=new_opt_state,
            step=state.step + 1, rng=state.rng)
        packed = jnp.concatenate([
            total.reshape(1).astype(jnp.float32),
            grad_norm.reshape(1).astype(jnp.float32),
            raw.astype(jnp.float32), logits.astype(jnp.float32)])
        return new_state, StepMetrics(packed)

    if not jit:
        return step_fn
    return jax.jit(step_fn, donate_argnums=(0,) if donate else ())


def make_eval_step(module, jit: bool = True):
    """(params, batch_stats, features) -> logits [B], eval mode."""

    def eval_fn(params, batch_stats, features):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        logits = module.apply(variables, features, deterministic=True)
        return logits.reshape(-1)

    return jax.jit(eval_fn) if jit else eval_fn
