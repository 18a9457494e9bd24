"""The Trainer: step-driven training with ISBL feedback, checkpoint pools,
SWA, validation threshold sweeps, early stopping, and durable resume.

Parity target: `/root/reference/nanowakeword/train/train_model.py` — the
`Trainer` class (`:60`), `validate` (`:147`), `auto_train` (`:240`) and
`train_model` (`:346`), with the same config-key surface.

Structure: the per-step math is one jitted XLA computation
(train/step.py); the Python loop only pumps batches, folds the returned
per-example BCE into the host-side hardness array (the ISBL loop), and
handles bookkeeping. RNG state is a single JAX key checkpointed alongside
the numpy sampler state — replacing the reference's 4-way RNG dump
(`train_model.py:699-702`).
"""

from __future__ import annotations

import collections
import copy
import logging
import os
import pickle
import re
import threading
import time
from logging.handlers import RotatingFileHandler
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.models.model import Model
from nanowakeword_tpu.train import loss as losses
from nanowakeword_tpu.train.optim import build_optimizer
from nanowakeword_tpu.train.step import (TrainState, create_train_state,
                                         make_eval_step, make_train_step)
from nanowakeword_tpu.utils.logger import (print_final_report_header,
                                           print_info, print_key_value)


class Trainer:
    def __init__(self, model: Model, config, mesh=None):
        self.model = model
        self.config = config
        self.mesh = mesh

        steps = int(config.get("steps", 15000))
        self.tx = build_optimizer(config, total_steps=steps)
        self.state = create_train_state(model.module, model.variables, self.tx,
                                        seed=int(config.get("seed", 10)))
        loss_kwargs = dict(
            loss_function=str(config.get("loss_function", "bias_weighted")),
            loss_bias=float(config.get("LOSS_BIAS", 0.75)),
            logit_reg_weight=float(config.get("logit_reg_weight", 2e-4)),
            logit_reg_margin=float(config.get("logit_reg_margin", 6.0)),
            afl_gamma_pos=float(config.get("afl_gamma_pos", 0.0)),
            afl_gamma_neg=float(config.get("afl_gamma_neg", 4.0)),
            compute_dtype=str(config.get("compute_dtype", "float32")),
        )
        if mesh is not None:
            from nanowakeword_tpu.parallel.dp import (make_dp_train_step,
                                                      shard_train_state)
            self.state = shard_train_state(self.state, mesh)
            self._step = make_dp_train_step(model.module, self.tx, mesh,
                                            **loss_kwargs)
        else:
            self._step = make_train_step(model.module, self.tx, **loss_kwargs)
        self._eval = make_eval_step(model.module)

        print_info(f"Using optimizer: "
                   f"{str(config.get('optimizer_type', 'adamw')).upper()}")
        print_info(f"Learning rate scheduler: "
                   f"{str(config.get('lr_scheduler_type', 'onecycle')).upper()}")

        self.history = model.history
        self.best_training_checkpoints: list = []
        self.best_training_scores: list = []
        self.best_error_score = float("inf")
        self.best_model_on_error_score = None

    # -- helpers ---------------------------------------------------------------

    def _variables_for_eval(self, params=None):
        v = {"params": params if params is not None else self.state.params}
        if self.state.batch_stats:
            v["batch_stats"] = self.state.batch_stats
        return v

    def _host_params(self):
        return jax.tree_util.tree_map(np.asarray, self.state.params)

    # -- validation (train_model.py:147-237) ------------------------------------

    def validate(self, val_dataset, params=None):
        """Threshold-sweep validation minimising miss_weight*FN + fp_weight*FP."""
        if params is None:
            params = self.state.params
        batch_size = int(self.config.get("validation_batch_size", 256))
        max_batches = int(self.config.get("val_subsample_batches", 0))

        all_logits, all_labels = [], []
        for bi, (feats, labels) in enumerate(val_dataset.batches(batch_size)):
            if max_batches > 0 and bi >= max_batches:
                break
            logits = self._eval(params, self.state.batch_stats,
                                jnp.asarray(feats))
            all_logits.append(np.asarray(logits))
            all_labels.append(labels)
        logits = np.concatenate(all_logits)
        labels = np.concatenate(all_labels)

        val_loss = float(np.mean(np.asarray(
            losses.raw_bce(jnp.asarray(logits), jnp.asarray(labels)))))

        miss_w = float(self.config.get("val_miss_weight", 4.0))
        fp_w = float(self.config.get("val_fp_weight", 1.0))
        probs = 1.0 / (1.0 + np.exp(-logits))

        best = dict(error=float("inf"), thresh=0.5, tp=0, tn=0, fp=0, fn=0)
        for thresh in np.linspace(0.2, 0.8, 13):
            preds = probs >= thresh
            tp = int(((preds == 1) & (labels == 1)).sum())
            tn = int(((preds == 0) & (labels == 0)).sum())
            fp = int(((preds == 1) & (labels == 0)).sum())
            fn = int(((preds == 0) & (labels == 1)).sum())
            err = miss_w * fn + fp_w * fp
            if err < best["error"]:
                best = dict(error=err, thresh=float(thresh),
                            tp=tp, tn=tn, fp=fp, fn=fn)

        recall = best["tp"] / max(best["tp"] + best["fn"], 1)
        fpr = best["fp"] / max(best["fp"] + best["tn"], 1)
        return collections.OrderedDict(
            val_loss=val_loss, val_recall=recall, val_fpr=fpr,
            total_false_alarms=best["fp"], total_misses=best["fn"],
            error_score=best["error"],
            raw_error_score=best["fp"] + best["fn"],
            best_threshold=best["thresh"])

    # -- checkpointing ------------------------------------------------------------

    def _checkpoint_payload(self, step_ndx, sampler, extra):
        return {
            "step": step_ndx,
            "state": jax.tree_util.tree_map(np.asarray, self.state),
            "model_history": dict(self.history),
            "best_error_score": self.best_error_score,
            "best_model_on_error_score": self.best_model_on_error_score,
            "best_training_checkpoints": self.best_training_checkpoints,
            "best_training_scores": self.best_training_scores,
            "sampler_rng_state": sampler.rng.bit_generator.state
            if sampler is not None else None,
            **extra,
        }

    def save_checkpoint(self, checkpoint_dir, step_ndx, sampler, **extra):
        """Durable checkpoint. Backend selectable via
        `checkpointing.backend`: "pickle" (default, single file) or "orbax"
        (directory: orbax array store + pickled host metadata — the
        jax-ecosystem format for large states / async saving)."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        payload = self._checkpoint_payload(step_ndx, sampler, extra)
        backend = str(self.config.get("checkpointing", {})
                      .get("backend", "pickle")).lower()

        if backend == "orbax":
            import orbax.checkpoint as ocp
            path = os.path.join(checkpoint_dir,
                                f"checkpoint_step_{step_ndx}.orbax")
            state = payload.pop("state")
            ckptr = ocp.PyTreeCheckpointer()
            ckptr.save(os.path.abspath(os.path.join(path, "state")),
                       state._asdict())
            with open(os.path.join(path, "meta.pkl"), "wb") as f:
                pickle.dump(payload, f)
            return path

        path = os.path.join(checkpoint_dir, f"checkpoint_step_{step_ndx}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        return path

    @staticmethod
    def find_latest_checkpoint(checkpoint_dir) -> Optional[str]:
        if not os.path.isdir(checkpoint_dir):
            return None
        best_step, best = -1, None
        for f in os.listdir(checkpoint_dir):
            m = re.match(r"checkpoint_step_(\d+)\.(pkl|orbax)$", f)
            if m and int(m.group(1)) > best_step:
                best_step, best = int(m.group(1)), f
        return os.path.join(checkpoint_dir, best) if best else None

    def restore_checkpoint(self, path, sampler=None) -> dict:
        if path.endswith(".orbax"):
            import orbax.checkpoint as ocp
            ckptr = ocp.PyTreeCheckpointer()
            # restore against the live state as the structure template so
            # optax namedtuples keep their types
            template = jax.tree_util.tree_map(np.asarray,
                                              self.state._asdict())
            state_dict = ckptr.restore(
                os.path.abspath(os.path.join(path, "state")), item=template)
            with open(os.path.join(path, "meta.pkl"), "rb") as f:
                ckpt = pickle.load(f)
            ckpt["state"] = TrainState(**state_dict)
        else:
            with open(path, "rb") as f:
                ckpt = pickle.load(f)
        st = ckpt["state"]
        self.state = TrainState(
            params=jax.tree_util.tree_map(jnp.asarray, st.params),
            batch_stats=jax.tree_util.tree_map(jnp.asarray, st.batch_stats),
            opt_state=jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
                st.opt_state),
            step=jnp.asarray(st.step),
            rng=jnp.asarray(st.rng))
        self.history.clear()
        self.history.update(ckpt.get("model_history", {}))
        self.best_error_score = ckpt.get("best_error_score", float("inf"))
        self.best_model_on_error_score = ckpt.get("best_model_on_error_score")
        self.best_training_checkpoints = ckpt.get("best_training_checkpoints",
                                                  [])
        self.best_training_scores = ckpt.get("best_training_scores", [])
        if sampler is not None and ckpt.get("sampler_rng_state"):
            sampler.rng.bit_generator.state = ckpt["sampler_rng_state"]
        return ckpt

    # -- device-cached training (train/cached.py) --------------------------------

    @staticmethod
    def _rotate_checkpoints(checkpoint_dir, limit):
        all_ckpts = sorted(
            (f for f in os.listdir(checkpoint_dir)
             if f.startswith("checkpoint_step_")),
            key=lambda f: int(re.search(r"(\d+)", f).group(1)))
        while len(all_ckpts) > limit:
            victim = os.path.join(checkpoint_dir, all_ckpts.pop(0))
            if os.path.isdir(victim):
                import shutil
                shutil.rmtree(victim)
            else:
                os.remove(victim)

    def train_device_cached(self, X, X_val, max_steps, log_path,
                            resume_from_dir=None):
        """Fully device-resident ISBL training in K-step compiled dispatches.

        Zero per-step host traffic: sampling, gather, step, and hardness
        updates all run on device; the host sees one [K, 6] metrics array
        per dispatch. Bookkeeping happens at dispatch granularity with the
        SAME semantics as the host loop (train_model.py:346-759 parity):
        EMA/validation early stopping, SWA checkpoint pool, periodic
        hardness reset, durable checkpoints (state + hardness + loop RNG
        key), and --resume.
        """
        from nanowakeword_tpu.train.cached import (build_cached_data,
                                                   make_cached_train_loop,
                                                   put_cached_on_mesh)
        dataset, sampler = X
        config = self.config
        dc = config.get("device_cache", {})
        k_steps = int(dc.get("steps_per_dispatch", 100))

        cached = build_cached_data(dataset, sampler.batch_composition,
                                   sampler.feature_manifests)
        mesh = None
        if bool(dc.get("data_parallel", False)) and len(jax.devices()) > 1:
            from nanowakeword_tpu.parallel import dp as DP
            from nanowakeword_tpu.parallel import mesh as M
            mesh = M.make_mesh(
                model_parallel=int(dc.get("model_parallel", 1)))
            print_info(f"Device-cache training data-parallel over "
                       f"{mesh.devices.size} chips "
                       f"(mesh {dict(mesh.shape)}).")
            self.state = DP.shard_train_state(self.state, mesh)
            cached = put_cached_on_mesh(cached, mesh)
        loop = make_cached_train_loop(
            self.model.module, self.tx, mesh=mesh,
            quotas=cached.quotas, replace=cached.replace, k_steps=k_steps,
            loss_function=str(config.get("loss_function", "bias_weighted")),
            loss_bias=float(config.get("LOSS_BIAS", 0.75)),
            logit_reg_weight=float(config.get("logit_reg_weight", 2e-4)),
            logit_reg_margin=float(config.get("logit_reg_margin", 6.0)),
            hardness_alpha=float(config.get("hardness_ema_alpha", 0.05)),
            hardness_floor=float(config.get("hardness_floor", 0.05)),
            sampling=str(dc.get("sampling", "auto")),
            compute_dtype=str(config.get("compute_dtype", "float32")))

        ema_loss = None
        ema_alpha = float(config.get("ema_alpha", 0.01))
        top_k = int(config.get("checkpoint_averaging_top_k", 5))
        pool_interval = int(config.get("checkpoint_pool_interval", 500))
        stabilization = int(config.get("stabilization_steps",
                                       int(max_steps * 0.05)))
        val_interval = int(config.get("val_interval", 500))
        min_delta = float(config.get("min_delta", 0.0001))

        user_patience = config.get("early_stopping_patience", None)
        if user_patience is not None:
            patience = int(user_patience)
        elif int(config.get("steps", max_steps)) < 3000:
            patience = 0
        else:
            patience = int(max_steps * 0.10)
        best_ema_for_stopping = float("inf")
        steps_without_improvement = 0
        val_patience = int(config.get("val_early_stopping_patience",
                                      int(max_steps * 0.15)))
        val_steps_without_improvement = 0

        hardness_reset_interval = int(config.get("hardness_reset_interval",
                                                 5000))
        hardness_reset_decay = float(config.get("hardness_reset_decay", 0.5))

        ckpt_cfg = config.get("checkpointing", {})
        ckpt_enabled = bool(ckpt_cfg.get("enabled", False))
        ckpt_interval = int(ckpt_cfg.get("interval_steps", 1000))
        ckpt_limit = int(ckpt_cfg.get("limit", 3))
        checkpoint_dir = os.path.join(log_path, "checkpoints")
        if ckpt_enabled:
            os.makedirs(checkpoint_dir, exist_ok=True)
            print_info(f"Checkpointing ENABLED every ~{ckpt_interval} steps "
                       f"(dispatch-aligned).")

        hardness = cached.hardness
        key = jax.random.PRNGKey(int(config.get("seed", 10)) + 1)

        step_ndx = 0
        if resume_from_dir:
            resume_ckpt_dir = os.path.join(resume_from_dir,
                                           "training_artifacts", "checkpoints")
            latest = self.find_latest_checkpoint(resume_ckpt_dir)
            if latest:
                print_info(f"Resuming device-cached run from: {latest}")
                ckpt = self.restore_checkpoint(latest, sampler)
                step_ndx = int(ckpt["step"])
                ema_loss = ckpt.get("ema_loss")
                steps_without_improvement = ckpt.get(
                    "steps_without_improvement", 0)
                best_ema_for_stopping = ckpt.get("best_ema_loss_for_stopping",
                                                 float("inf"))
                val_steps_without_improvement = ckpt.get(
                    "val_steps_without_improvement", 0)
                if ckpt.get("dataset_hardness") is not None:
                    hardness = jnp.asarray(ckpt["dataset_hardness"],
                                           jnp.float32)
                if ckpt.get("loop_rng_key") is not None:
                    key = jnp.asarray(ckpt["loop_rng_key"])
                if mesh is not None:
                    from nanowakeword_tpu.parallel.dp import shard_train_state
                    self.state = shard_train_state(self.state, mesh)
                print_info(f"Restored state; resuming from step {step_ndx}.")
            else:
                print_info(f"WARNING: no checkpoint in '{resume_ckpt_dir}'. "
                           "Starting fresh.")

        def _save(step):
            self.save_checkpoint(
                checkpoint_dir, step, sampler,
                ema_loss=ema_loss,
                best_ema_loss_for_stopping=best_ema_for_stopping,
                steps_without_improvement=steps_without_improvement,
                val_steps_without_improvement=val_steps_without_improvement,
                dataset_hardness=np.asarray(hardness),
                loop_rng_key=np.asarray(key))
            self._rotate_checkpoints(checkpoint_dir, ckpt_limit)

        use_train_stop = X_val is None or len(X_val) == 0
        next_pool = max(((max(step_ndx, stabilization) // pool_interval) + 1)
                        * pool_interval, step_ndx + 1)
        next_val = max(((max(step_ndx, stabilization, int(config.get(
            "val_stabilization_steps", stabilization))) // val_interval) + 1)
            * val_interval, step_ndx + 1)
        next_ckpt = ((step_ndx // ckpt_interval) + 1) * ckpt_interval
        next_hreset = (((step_ndx // hardness_reset_interval) + 1)
                       * hardness_reset_interval
                       if hardness_reset_interval > 0 else None)
        stopped_early = False

        while step_ndx < max_steps and not stopped_early:
            self.state, hardness, key, metrics = loop(
                self.state, hardness, key, cached.features, cached.labels,
                cached.pools)
            m = np.asarray(metrics)  # one fetch per K steps
            losses_k = m[:, 0]
            self.history["loss"].extend(losses_k.tolist())
            # per-step EMA + improvement counting, exactly as the host loop
            for lv in losses_k:
                ema_loss = lv if ema_loss is None else (
                    ema_alpha * lv + (1 - ema_alpha) * ema_loss)
                if patience > 0:
                    if ema_loss < best_ema_for_stopping - min_delta:
                        best_ema_for_stopping = ema_loss
                        steps_without_improvement = 0
                    else:
                        steps_without_improvement += 1
            # recall at ~100-step granularity from in-step counters
            for off in range(0, k_steps, 100):
                tp, fn = m[off, 2], m[off, 3]
                if tp + fn > 0:
                    self.history["train_recall_steps"].append(step_ndx + off)
                    self.history["train_recall"].append(
                        float(tp / (tp + fn)))
            step_ndx += k_steps

            if next_hreset is not None and step_ndx >= next_hreset:
                next_hreset += hardness_reset_interval
                # same decay-toward-1.0 semantics as dataset.reset_hardness
                hardness = (hardness * hardness_reset_decay
                            + (1.0 - hardness_reset_decay))

            if step_ndx >= next_pool and step_ndx > stabilization:
                next_pool += pool_interval
                host_params = self._host_params()
                score = float(ema_loss)
                if len(self.best_training_checkpoints) < top_k:
                    self.best_training_checkpoints.append(host_params)
                    self.best_training_scores.append(
                        {"step": step_ndx, "stable_loss": score})
                else:
                    worst = max(s["stable_loss"]
                                for s in self.best_training_scores)
                    if score < worst:
                        wi = [i for i, s in
                              enumerate(self.best_training_scores)
                              if s["stable_loss"] == worst][0]
                        self.best_training_checkpoints[wi] = host_params
                        self.best_training_scores[wi] = {
                            "step": step_ndx, "stable_loss": score}

            if (X_val is not None and len(X_val) > 0
                    and step_ndx >= next_val):
                next_val += val_interval
                vm = self.validate(X_val)
                self.history["val_loss_steps"].append(step_ndx)
                self.history["val_loss"].append(vm["val_loss"])
                self.history["val_recall_steps"].append(step_ndx)
                self.history["val_recall"].append(vm["val_recall"])
                self.history["val_fpr"].append(vm["val_fpr"])
                if vm["error_score"] < self.best_error_score:
                    self.best_error_score = vm["error_score"]
                    self.best_model_on_error_score = self._host_params()
                    val_steps_without_improvement = 0
                else:
                    val_steps_without_improvement += val_interval
                if (val_patience > 0 and step_ndx > stabilization
                        and val_steps_without_improvement >= val_patience):
                    print_info(f"\nValidation early stopping at step "
                               f"{step_ndx}: no val-error improvement for "
                               f"{val_patience} steps.")
                    stopped_early = True

            if (patience > 0 and use_train_stop and not stopped_early
                    and step_ndx > stabilization
                    and steps_without_improvement >= patience):
                print_info(f"\nEarly stopping at step {step_ndx}: no stable-"
                           f"loss improvement for {patience} steps.")
                stopped_early = True

            if ckpt_enabled and step_ndx >= next_ckpt:
                next_ckpt = ((step_ndx // ckpt_interval) + 1) * ckpt_interval
                _save(step_ndx)

        if ckpt_enabled and stopped_early:
            _save(step_ndx)   # durable record of the stopping point
        dataset.sample_hardness[:] = np.asarray(hardness)
        print_info(f"Device-cached training finished at step {step_ndx} "
                   f"({k_steps} steps/dispatch).")
        return step_ndx

    # -- the training loop (train_model.py:346-759) ---------------------------------

    def train_model(self, X, X_val, max_steps, log_path, table_updater=None,
                    resume_from_dir=None):
        """X: (dataset, sampler) pair; X_val: ValidationDataset or None."""
        dataset, sampler = X
        config = self.config

        dc_cfg = config.get("device_cache", {})
        if dc_cfg and dc_cfg.get("enabled", False) and self.mesh is None:
            return self.train_device_cached(X, X_val, max_steps, log_path,
                                            resume_from_dir=resume_from_dir)

        debug_mode = bool(config.get("debug_mode", False))
        log_dir = os.path.join(log_path, "training_debug")
        os.makedirs(log_dir, exist_ok=True)
        logger = logging.getLogger("NanoTrainerDebug")
        if debug_mode:
            logger.setLevel(logging.INFO)
            if not logger.handlers:
                handler = RotatingFileHandler(
                    os.path.join(log_dir, "training_debug.log"),
                    maxBytes=5_000_000, backupCount=30, encoding="utf-8")
                handler.setFormatter(logging.Formatter(
                    "%(asctime)s [%(levelname)s] %(message)s",
                    datefmt="%H:%M:%S"))
                logger.addHandler(handler)
            logger.propagate = False
            print_info(f"Debug mode ON. Logs in: {log_dir}")
        else:
            logger.disabled = True

        ckpt_cfg = config.get("checkpointing", {})
        ckpt_enabled = bool(ckpt_cfg.get("enabled", False))
        ckpt_interval = int(ckpt_cfg.get("interval_steps", 1000))
        ckpt_limit = int(ckpt_cfg.get("limit", 3))
        checkpoint_dir = os.path.join(log_path, "checkpoints")
        if ckpt_enabled:
            os.makedirs(checkpoint_dir, exist_ok=True)
            print_info(f"Checkpointing ENABLED every {ckpt_interval} steps.")

        ema_loss = None
        ema_alpha = float(config.get("ema_alpha", 0.01))
        top_k = int(config.get("checkpoint_averaging_top_k", 5))
        pool_interval = int(config.get("checkpoint_pool_interval", 500))

        stabilization_steps = int(config.get("stabilization_steps",
                                             int(max_steps * 0.05)))
        min_delta = float(config.get("min_delta", 0.0001))
        best_ema_for_stopping = float("inf")
        steps_without_improvement = 0

        user_patience = config.get("early_stopping_patience", None)
        if user_patience is not None:
            patience = int(user_patience)
        elif int(config.get("steps", max_steps)) < 3000:
            patience = 0
        else:
            patience = int(max_steps * 0.10)

        val_interval = int(config.get("val_interval", 500))
        val_stb = int(config.get("val_stabilization_steps",
                                 stabilization_steps))
        val_patience = int(config.get("val_early_stopping_patience",
                                      int(max_steps * 0.15)))
        val_steps_without_improvement = 0

        hardness_alpha = float(config.get("hardness_ema_alpha", 0.05))
        hardness_floor = float(config.get("hardness_floor", 0.05))
        hardness_reset_interval = int(config.get("hardness_reset_interval",
                                                 5000))
        hardness_reset_decay = float(config.get("hardness_reset_decay", 0.5))

        if patience == 0:
            print_info("Early stopping is DISABLED; training for the full "
                       "'steps' duration.")
        else:
            print_info(f"Training for {max_steps} steps; early stopping "
                       f"activates after {stabilization_steps} steps.")

        start_step = 0
        # (step, indices, bce) of the step whose hardness update was NOT yet
        # applied when the checkpoint was written — replayed after the first
        # resumed batch is drawn, exactly where the continuous run applied it
        pending_restored = None
        if resume_from_dir:
            resume_ckpt_dir = os.path.join(resume_from_dir,
                                           "training_artifacts", "checkpoints")
            latest = self.find_latest_checkpoint(resume_ckpt_dir)
            if latest:
                print_info(f"Resuming from checkpoint: {latest}")
                ckpt = self.restore_checkpoint(latest, sampler)
                start_step = int(ckpt["step"]) + 1
                ema_loss = ckpt.get("ema_loss")
                steps_without_improvement = ckpt.get(
                    "steps_without_improvement", 0)
                best_ema_for_stopping = ckpt.get("best_ema_loss_for_stopping",
                                                 float("inf"))
                val_steps_without_improvement = ckpt.get(
                    "val_steps_without_improvement", 0)
                if "dataset_hardness" in ckpt and ckpt["dataset_hardness"] is not None:
                    dataset.sample_hardness[:] = ckpt["dataset_hardness"]
                if (ckpt.get("dataset_rng_state") is not None
                        and hasattr(dataset, "_rng")):
                    dataset._rng.setstate(ckpt["dataset_rng_state"])
                pending_restored = ckpt.get("pending_hardness_update")
                print_info(f"Restored state; resuming from step {start_step}.")
            else:
                print_info(f"WARNING: no checkpoint in '{resume_ckpt_dir}'. "
                           "Starting fresh.")

        if table_updater is not None:
            table_updater.update(force_print=True)

        # optional device tracing (new capability, SURVEY.md §5.1): capture
        # an xprof trace of steps [profile_start, profile_start + profile_steps)
        profile_dir = config.get("profile_trace_dir")
        profile_start = int(config.get("profile_start_step", 10))
        profile_steps = int(config.get("profile_steps", 20))
        profiling_active = False

        # Batch prefetch as a DETERMINISTIC software pipeline. ISBL sampling
        # + gather run on a background thread overlapping device compute, but
        # hardness visibility follows a fixed total order regardless of
        # thread timing:
        #
        #     ... draw(N+1) -> update(N) [-> reset, if due] -> draw(N+2) ...
        #
        # i.e. the batch for step N is sampled against hardness that reflects
        # exactly the updates from steps <= N-2. That makes the batch
        # sequence a pure function of the sampler RNG + checkpoint state, so
        # a mid-run resume replays the uninterrupted run bit-for-bit
        # (reference contract: train_model.py:682-712 full-RNG resume).
        from nanowakeword_tpu.utils.prefetch import Prefetcher

        pipe = threading.Condition()
        stop_pipe = [False]
        # last step whose batch has been drawn / whose hardness update landed
        drawn_through = [start_step - 1]
        drained_through = [start_step - 2 if pending_restored is not None
                          else start_step - 1]
        produce_counter = [start_step]

        def produce_batch():
            my_step = produce_counter[0]
            produce_counter[0] += 1
            with pipe:
                while drained_through[0] < my_step - 2 and not stop_pipe[0]:
                    pipe.wait(0.5)
                if stop_pipe[0]:
                    raise StopIteration
            batch_indices = np.asarray(sampler.sample_batch(), np.int64)
            if batch_indices.size == 0:
                raise ValueError("Sampler produced an empty batch — check "
                                 "batch_composition vs feature_manifest.")
            feats, labels, indices = dataset.gather(batch_indices)
            # RNG state right after this batch was fully produced:
            # checkpointing THIS (not the live state, which has drawn ahead)
            # is what makes resume continue the exact same batch sequence.
            # AudioClipDataset's random-crop stream (e2e mode) is part of
            # batch production, so snapshot it too.
            rng_snapshot = {
                "sampler": sampler.rng.bit_generator.state,
                "dataset": (dataset._rng.getstate()
                            if hasattr(dataset, "_rng") else None),
            }
            # start the host->device transfer HERE, on the prefetch thread:
            # device_put is async, so the copy overlaps the current step
            if self.mesh is not None:
                from nanowakeword_tpu.parallel.dp import device_put_batch
                f_dev, l_dev = device_put_batch(feats, labels, self.mesh)
            else:
                f_dev = jax.device_put(feats)
                l_dev = jax.device_put(labels)
            with pipe:
                drawn_through[0] = my_step
                pipe.notify_all()
            return f_dev, l_dev, labels, indices, rng_snapshot

        prefetcher = Prefetcher(produce_batch, depth=2)
        # (step, indices, bce) of the most recently applied hardness update —
        # saved in checkpoints so resume can replay it in order
        last_update_record = [None]

        def apply_hardness_update(upd_step, indices, bce):
            """Apply step `upd_step`'s hardness EMA update (and the periodic
            reset, when step upd_step+1 is a reset step) in pipeline order:
            only after batch upd_step+1 has been drawn."""
            with pipe:
                while (drawn_through[0] < upd_step + 1 and not stop_pipe[0]
                       and prefetcher._error is None):
                    pipe.wait(0.5)
            dataset.update_hardness(indices, bce,
                                    alpha=hardness_alpha,
                                    floor=hardness_floor)
            last_update_record[0] = (upd_step, indices, bce)
            nxt = upd_step + 1
            if (hardness_reset_interval > 0 and nxt > 0
                    and nxt % hardness_reset_interval == 0):
                dataset.reset_hardness(hardness_reset_decay)
                if debug_mode:
                    logger.info(f"[{nxt:5d}] Hardness scores partially "
                                f"reset (decay={hardness_reset_decay}).")
            with pipe:
                drained_through[0] = upd_step
                pipe.notify_all()

        # Async metric pipeline: don't block on step N's results until step
        # N+1 has been dispatched — hides the device->host sync behind compute.
        pending = None  # (step_ndx, indices, metrics)

        def drain(p):
            nonlocal ema_loss, steps_without_improvement, best_ema_for_stopping
            step_ndx, indices, metrics = p
            m = metrics.fetch()   # ONE device->host transfer for all metrics
            apply_hardness_update(step_ndx,
                                  indices, np.asarray(m.per_example_bce))
            current_loss = m.loss
            self.history["loss"].append(current_loss)
            if ema_loss is None:
                ema_loss = current_loss
            ema_loss = ema_alpha * current_loss + (1 - ema_alpha) * ema_loss

            # checkpoint pool for SWA (train_model.py:611-625)
            if step_ndx > stabilization_steps and step_ndx % pool_interval == 0:
                score = ema_loss
                host_params = self._host_params()
                if len(self.best_training_checkpoints) < top_k:
                    self.best_training_checkpoints.append(host_params)
                    self.best_training_scores.append(
                        {"step": step_ndx, "stable_loss": score})
                else:
                    worst = max(s["stable_loss"]
                                for s in self.best_training_scores)
                    if score < worst:
                        wi = [i for i, s in enumerate(self.best_training_scores)
                              if s["stable_loss"] == worst][0]
                        self.best_training_checkpoints[wi] = host_params
                        self.best_training_scores[wi] = {
                            "step": step_ndx, "stable_loss": score}

            # recall logging every 100 steps (train_model.py:628-664)
            if step_ndx % 100 == 0:
                logits = m.logits
                labels01 = labels_cache[step_ndx]
                yp = 1 / (1 + np.exp(-logits))
                is_pos = labels01 == 1
                tp = int((yp[is_pos] >= 0.5).sum())
                fn = int((yp[is_pos] < 0.5).sum())
                recall = tp / max(tp + fn, 1)
                self.history["train_recall_steps"].append(step_ndx)
                self.history["train_recall"].append(recall)
                if debug_mode:
                    is_neg = ~is_pos
                    fa = int((yp[is_neg] > 0.5).sum())
                    logger.info(
                        f"[{step_ndx:5d}] L:{current_loss:.6f} "
                        f"|PA:{yp[is_pos].mean() if is_pos.any() else 0:.3f} "
                        f"NA:{yp[is_neg].mean() if is_neg.any() else 0:.3f} "
                        f"|FA:{fa}/{int(is_neg.sum())} "
                        f"Ms:{fn}/{int(is_pos.sum())} |Recall:{recall:.3f} "
                        f"gNorm:{m.grad_norm:.8f}")
                del labels_cache[step_ndx]

            # train-EMA early stopping bookkeeping
            if patience > 0 and ema_loss is not None:
                if ema_loss < best_ema_for_stopping - min_delta:
                    best_ema_for_stopping = ema_loss
                    steps_without_improvement = 0
                else:
                    steps_without_improvement += 1
            return step_ndx

        labels_cache: dict = {}
        stop = False
        step_ndx = start_step
        rng_after_current = None   # sampler RNG state after drawing this batch
        try:
            while step_ndx < max_steps and not stop:
                f_dev, l_dev, labels, indices, rng_after_current = \
                    prefetcher.get()
                if step_ndx % 100 == 0:
                    labels_cache[step_ndx] = labels.copy()

                if profile_dir and not profiling_active \
                        and step_ndx == profile_start:
                    jax.profiler.start_trace(str(profile_dir))
                    profiling_active = True
                if profiling_active and step_ndx == profile_start + profile_steps:
                    jax.profiler.stop_trace()
                    profiling_active = False
                    print_info(f"Device trace written to {profile_dir}")

                self.state, metrics = self._step(self.state, f_dev, l_dev)

                if pending is not None:
                    drain(pending)
                elif pending_restored is not None:
                    # replay the checkpoint's deferred hardness update at the
                    # exact pipeline slot the continuous run applied it
                    apply_hardness_update(*pending_restored)
                    pending_restored = None
                pending = (step_ndx, indices, metrics)
                # (periodic hardness reset is folded into apply_hardness_update
                # so it lands at a deterministic point in the sampling order)

                # early stopping on train EMA (only without val data)
                use_train_stop = X_val is None or len(X_val) == 0
                if (patience > 0 and use_train_stop
                        and step_ndx > stabilization_steps
                        and steps_without_improvement >= patience):
                    drain(pending)
                    pending = None
                    print_info(f"\nEarly stopping at step {step_ndx}: no stable-"
                               f"loss improvement for {patience} steps.")
                    break

                # durable checkpoint (train_model.py:682-712). Saved state is
                # pipeline-consistent: hardness BEFORE this step's update (what
                # batch N+1 was sampled against), plus that update itself for
                # in-order replay, plus the RNG snapshot taken right after batch
                # N was drawn (the live sampler has already drawn ahead).
                if (ckpt_enabled and step_ndx > 0
                        and step_ndx % ckpt_interval == 0):
                    hardness_before = dataset.sample_hardness.copy()
                    pend_rec = None
                    if pending is not None:
                        drain(pending)
                        pending = None
                        pend_rec = last_update_record[0]
                    self.save_checkpoint(
                        checkpoint_dir, step_ndx, sampler,
                        ema_loss=ema_loss,
                        best_ema_loss_for_stopping=best_ema_for_stopping,
                        steps_without_improvement=steps_without_improvement,
                        val_steps_without_improvement=val_steps_without_improvement,
                        dataset_hardness=hardness_before,
                        pending_hardness_update=pend_rec,
                        sampler_rng_state=(rng_after_current or {}).get("sampler"),
                        dataset_rng_state=(rng_after_current or {}).get("dataset"))
                    self._rotate_checkpoints(checkpoint_dir, ckpt_limit)

                # validation (train_model.py:714-756)
                if (X_val is not None and len(X_val) > 0
                        and step_ndx > val_stb and step_ndx % val_interval == 0):
                    if pending is not None:
                        drain(pending)
                        pending = None
                    vm = self.validate(X_val)
                    self.history["val_loss_steps"].append(step_ndx)
                    self.history["val_loss"].append(vm["val_loss"])
                    self.history["val_recall_steps"].append(step_ndx)
                    self.history["val_recall"].append(vm["val_recall"])
                    self.history["val_fpr"].append(vm["val_fpr"])
                    if vm["error_score"] < self.best_error_score:
                        self.best_error_score = vm["error_score"]
                        self.best_model_on_error_score = self._host_params()
                        val_steps_without_improvement = 0
                        if debug_mode:
                            logger.info(
                                f"[VAL {step_ndx:5d}] New best! "
                                f"err={vm['error_score']:.1f} "
                                f"FA={vm['total_false_alarms']} "
                                f"Miss={vm['total_misses']} "
                                f"thresh={vm['best_threshold']:.2f}")
                    else:
                        val_steps_without_improvement += val_interval
                    if (val_patience > 0 and step_ndx > stabilization_steps
                            and val_steps_without_improvement >= val_patience):
                        print_info(f"\nValidation early stopping at step "
                                   f"{step_ndx}: no val-error improvement for "
                                   f"{val_patience} steps.")
                        break

                step_ndx += 1

            if pending is not None:
                drain(pending)
        finally:
            # ALWAYS release the producer thread and close the
            # prefetcher — an exception mid-loop (device OOM, a
            # validation error) must not leave the daemon producer
            # spin-waiting on the pipeline gate forever
            with pipe:
                stop_pipe[0] = True
                pipe.notify_all()
            prefetcher.close()
            if profiling_active:
                jax.profiler.stop_trace()
                print_info(f"Device trace written to {profile_dir}")
        return step_ndx

    # -- auto_train (train_model.py:240-343) ----------------------------------------

    def auto_train(self, X_train, X_val, steps, table_updater=None,
                   debug_path=".", resume_from_dir=None):
        self.train_model(X=X_train, X_val=X_val, max_steps=steps,
                         log_path=debug_path, table_updater=table_updater,
                         resume_from_dir=resume_from_dir)
        print_info("Training finished. Building final model...")

        dataset, sampler = X_train
        final_params = self._host_params()

        # suspicious-validation heuristic (train_model.py:272-291)
        val_suspicious = (self.best_error_score == 0.0
                          and self.best_model_on_error_score is not None)

        if self.best_model_on_error_score is not None and not val_suspicious:
            print_info("Using best validation-error-score checkpoint as the "
                       "final model.")
            final_params = self.best_model_on_error_score
        elif self.best_training_checkpoints:
            if val_suspicious:
                print_info(
                    "WARNING: Validation achieved 0 errors — your validation "
                    "set likely overlaps training data. Using training-loss "
                    "checkpoint averaging instead.")
            else:
                print_info("No validation data used. Averaging top "
                           "training-loss checkpoints.")
            final_params = Model.average_models(self.best_training_checkpoints)
            final_params = jax.tree_util.tree_map(np.asarray, final_params)
        else:
            print_info("No checkpoints available. Using the model at the end "
                       "of training.")

        self.model.load_variables(
            self._variables_for_eval(
                jax.tree_util.tree_map(jnp.asarray, final_params)))

        print_info("Calculating performance metrics for the final model...")
        final_results = collections.OrderedDict()
        if self.best_training_scores:
            avg_stable = float(np.mean(
                [s["stable_loss"] for s in self.best_training_scores]))
            final_results["Average Stable Loss"] = f"{avg_stable:.4f}"
        else:
            final_results["Average Stable Loss"] = "N/A"

        try:
            batch_indices = np.asarray(sampler.sample_batch(), np.int64)
            feats, labels, _ = dataset.gather(batch_indices)
            logits = np.asarray(self._eval(
                self.model.variables["params"], self.state.batch_stats,
                jnp.asarray(feats)))
            pos, neg = logits[labels == 1], logits[labels == 0]
            final_results["Avg. Positive Score (Logit)"] = (
                f"{pos.mean():.3f}" if pos.size else "N/A (No positives)")
            final_results["Avg. Negative Score (Logit)"] = (
                f"{neg.mean():.3f}" if neg.size else "N/A (No negatives)")
        except Exception as e:  # noqa: BLE001
            final_results["Confidence Score"] = f"N/A (Error: {e})"

        print_final_report_header()
        print_info("NOTE: These metrics are indicators of model health, not "
                   "real-world performance.")
        for k, v in final_results.items():
            print_key_value(k, v)
        self.history["final_report"] = final_results
        return self.model
