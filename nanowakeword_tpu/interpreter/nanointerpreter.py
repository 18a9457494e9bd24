"""NanoInterpreter: the streaming wake-word inference engine.

Parity target: `/root/reference/nanowakeword/interpreter/nanointerpreter.py` —
`DetectionResult` (`:45-115`) and `NanoInterpreter` (`:117-954`) with the same
public surface: `load_model()` (cascade auto-discovery, explicit gate, remote
verifier, no-local-model), `predict()` (warm-up guards, cascade skip, VAD
gate, patience/debounce post-filters), `predict_clip()`, `listen()`,
`reset()`, `detected()`, `stop()`, the score properties and `info`.

Differences from the reference:
* models are `.nww` artifacts loaded into jitted Flax applies — no
  onnxruntime; a "session" here is `lambda feats: sigmoid(module.apply(...))`.
* stateful models thread an explicit carry pytree instead of
  hidden_in/cell_in input tensors (`nanointerpreter.py:679-687`).
* the preprocessor is our jit-compiled AudioFeatures whose streaming path is
  numerically identical to the batch path.
"""

from __future__ import annotations

import logging
import os
import threading
import time
import wave
from collections import defaultdict, deque
from functools import partial
from typing import Callable, Dict, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.data.features import AudioFeatures
from nanowakeword_tpu.export.artifact import EXTENSION, load_nww

try:
    import noisereduce as nr
    NOISEREDUCE_AVAILABLE = True
except ImportError:
    NOISEREDUCE_AVAILABLE = False


class DetectionResult:
    """Rich result object returned by predict() (nanointerpreter.py:45-115)."""

    __slots__ = ("scores", "model_name", "gate_name", "threshold", "_detected")

    def __init__(self, scores: dict, model_name: str,
                 gate_name: Optional[str], threshold: float = 0.0):
        self.scores = scores
        self.model_name = model_name
        self.gate_name = gate_name
        self.threshold = threshold
        self._detected = None

    @property
    def score(self) -> float:
        return self.scores.get(self.model_name, 0.0)

    @property
    def gate_score(self) -> float:
        if self.gate_name:
            return self.scores.get(self.gate_name, 0.0)
        return 0.0

    @property
    def detected(self) -> bool:
        return self.score >= self.threshold if self.threshold > 0 else False

    def get(self, model_name: str, default: float = 0.0) -> float:
        if model_name not in self.scores and self.scores:
            # a typo'd model name otherwise reads as a permanent 0.0 "no
            # detection" — warn once with the names that DO exist
            import warnings
            warnings.warn(
                f"DetectionResult.get('{model_name}'): unknown model; "
                f"loaded models are {sorted(self.scores)}", stacklevel=2)
        return self.scores.get(model_name, default)

    def __getitem__(self, key: str) -> float:
        return self.scores[key]

    def __contains__(self, key: str) -> bool:
        return key in self.scores

    def __repr__(self) -> str:
        parts = [f"score={self.score:.4f}"]
        if self.gate_name:
            parts.append(f"gate={self.gate_score:.4f}")
        if self.threshold > 0:
            parts.append(f"detected={self.detected}")
        return f"DetectionResult({', '.join(parts)})"


class _LocalSession:
    """A jitted eval session over a loaded .nww Model (the onnxruntime
    InferenceSession analogue). Outputs sigmoid probability, matching the
    reference's exported-graph contract (_export/onnx.py:35-44).

    With `mesh` given (a jax.sharding.Mesh), batched scoring shards the
    batch dimension over the mesh's data axis — every chip scores a slice of
    the coalesced request batch, a capability the single-host reference
    cannot express. Parameters replicate; XLA inserts no collectives on the
    forward (scores are per-example), so scale is linear in chips.
    """

    def __init__(self, model, header, mesh=None):
        self.model = model
        self.header = header
        self.stateful = bool(header.get("stateful", False))
        self.mesh = None
        self._n_data = 1
        if self.stateful:
            def run_stateful(variables, feats, carry):
                logits, new_carry = model.module.apply(
                    variables, feats, carry=carry, deterministic=True)
                return jax.nn.sigmoid(logits), new_carry
            self._fn = jax.jit(run_stateful)
        else:
            def run(variables, feats):
                logits = model.module.apply(variables, feats,
                                            deterministic=True)
                return jax.nn.sigmoid(logits)
            self._fn = jax.jit(run)
            if mesh is not None:
                from nanowakeword_tpu.parallel.mesh import (DATA_AXIS,
                                                            batch_sharding,
                                                            replicated)
                self.mesh = mesh
                self._n_data = int(mesh.shape[DATA_AXIS])
                self._sharded_fn = jax.jit(
                    run,
                    in_shardings=(replicated(mesh), batch_sharding(mesh)),
                    out_shardings=batch_sharding(mesh))
                self._sharded_vars = jax.device_put(model.variables,
                                                    replicated(mesh))

    @property
    def feature_length(self) -> int:
        return int(self.header["input_shape"][0])

    def run(self, feats: np.ndarray, carry=None):
        feats = jnp.asarray(feats, jnp.float32)
        if self.stateful:
            probs, new_carry = self._fn(self.model.variables, feats, carry)
            return float(np.asarray(probs).reshape(-1)[0]), new_carry
        probs = self._fn(self.model.variables, feats)
        return float(np.asarray(probs).reshape(-1)[0]), None

    def run_batch(self, feats: np.ndarray) -> np.ndarray:
        """[B, T, F] -> [B] probabilities (stateless models; the server's
        dynamic micro-batching path). On a multi-chip mesh the batch is
        right-padded to a multiple of the data-axis size and sharded across
        chips; padding rows are dropped from the result."""
        n = feats.shape[0]
        if self.mesh is not None:
            rem = -n % self._n_data
            if rem:
                feats = np.concatenate(
                    [feats, np.zeros((rem,) + feats.shape[1:],
                                     np.float32)], axis=0)
            probs = self._sharded_fn(self._sharded_vars,
                                     jnp.asarray(feats, jnp.float32))
            return np.asarray(probs).reshape(-1)[:n]
        probs = self._fn(self.model.variables,
                         jnp.asarray(feats, jnp.float32))
        return np.asarray(probs).reshape(-1)


class _OnnxSession:
    """A jit-compiled session over an exported `.onnx` graph.

    The interchange-format twin of _LocalSession: the graph (ours or a
    reference torch.onnx export of the same op set) is translated to a pure
    JAX function (export/onnx_jax.py) and compiled for the session backend.
    Exported graphs already end in a Sigmoid, so `run` returns the score
    probability directly — same contract as _LocalSession.run."""

    def __init__(self, path: str):
        from nanowakeword_tpu.export.onnx_jax import OnnxJaxModel
        self._model = OnnxJaxModel(path)
        self.mesh = None
        # stateful detection by input name, exactly like the reference
        # (nanointerpreter.py:879-891): hidden_in/cell_in ride the feed
        self._state_shapes = {vi.name: [int(d) for d in vi.shape]
                              for vi in self._model.graph.inputs
                              if vi.name in ("hidden_in", "cell_in")}
        self.stateful = "hidden_in" in self._state_shapes

    @property
    def feature_length(self) -> int:
        # input [batch, T, 96] — same read as the reference's
        # session.get_inputs()[0].shape[1] (nanointerpreter.py:161)
        return int(self._model.input_shape[1])

    def run(self, feats: np.ndarray, carry=None):
        feats = np.asarray(feats, np.float32)
        if feats.ndim == 2:
            feats = feats[None]
        if not self.stateful:
            return float(self._model(feats).reshape(-1)[0]), None
        feed = {self._model.input_name: feats}
        if carry is None:
            carry = tuple(np.zeros(self._state_shapes[k], np.float32)
                          for k in ("hidden_in", "cell_in"))
        feed["hidden_in"], feed["cell_in"] = carry
        score, h_out, c_out = self._model.run(
            ["score", "hidden_out", "cell_out"], feed)
        return float(score.reshape(-1)[0]), (h_out, c_out)

    def run_batch(self, feats: np.ndarray) -> np.ndarray:
        """Batched scoring. Non-attention exports declare a dynamic batch
        axis (reference `_export/onnx.py:74-82` parity) and score the whole
        batch in one compiled call; fixed-batch-1 graphs fall back to
        per-row scoring."""
        feats = np.asarray(feats, np.float32)
        try:
            return self._model(feats).reshape(len(feats))
        except Exception:  # noqa: BLE001 — fixed-batch graph
            return np.asarray([self.run(f)[0] for f in feats], np.float32)


class NanoInterpreter:
    """Main inference engine. Use `NanoInterpreter.load_model()`."""

    def __init__(self, wakeword_models: List[str], **kwargs):
        self.models: Dict[str, object] = {}
        self.model_feature_length: Dict[str, int] = {}
        self.is_stateful: Dict[str, bool] = {}
        self.hidden_states: Dict[str, object] = {}
        self.class_mapping: Dict[str, Dict[str, str]] = {}
        self.raw_scores: Dict[str, float] = {}
        self.post_processed_scores: Dict[str, float] = {}

        encoder_vars = kwargs.pop("encoder_variables", None)
        for mdl_path in wakeword_models:
            model_key = os.path.splitext(os.path.basename(mdl_path))[0]
            if model_key in self.models:
                logging.warning(f"Model '{model_key}' already loaded. Skipping.")
                continue
            if mdl_path.endswith(".onnx"):
                # exported interchange graphs compile onto the JAX backend
                # (export/onnx_jax.py) — the reference's .onnx models load
                # here exactly like its ORT sessions (nanointerpreter.py:873)
                session = _OnnxSession(mdl_path)
                enc_vars = None
            else:
                header, model, enc_vars = load_nww(mdl_path)
                session = _LocalSession(model, header)
            self.models[model_key] = session
            self.model_feature_length[model_key] = session.feature_length
            self.is_stateful[model_key] = session.stateful
            self.hidden_states[model_key] = None
            self.class_mapping[model_key] = {"0": model_key}
            self.raw_scores[model_key] = 0.0
            self.post_processed_scores[model_key] = 0.0
            if encoder_vars is None and enc_vars is not None:
                encoder_vars = enc_vars

        self._setup_components(encoder_variables=encoder_vars, **kwargs)
        self.cascade_config: dict = {}
        self._listen_thread: Optional[threading.Thread] = None
        self._stop_event: Optional[threading.Event] = None
        self._fused_step = self._build_fused_step()

    # -- properties (nanointerpreter.py:180-258) --------------------------------

    @property
    def is_cascade(self) -> bool:
        return bool(self.cascade_config)

    @property
    def model_name(self) -> str:
        if self.is_cascade:
            return self.cascade_config["verifier"]
        return next(iter(self.models))

    @property
    def gate_name(self) -> Optional[str]:
        return self.cascade_config.get("gate")

    @property
    def gate_score(self) -> float:
        if self.gate_name:
            return self.post_processed_scores.get(self.gate_name, 0.0)
        return 0.0

    @property
    def verifier_score(self) -> float:
        return self.post_processed_scores.get(self.model_name, 0.0)

    @property
    def score(self) -> float:
        return self.verifier_score

    @property
    def info(self) -> dict:
        from nanowakeword_tpu.interpreter.remote_verifier import _RemoteSession
        verifier_name = self.cascade_config.get("verifier", self.model_name)
        is_remote = isinstance(self.models.get(verifier_name), _RemoteSession)
        d = {
            "model_name": self.model_name,
            "is_cascade": self.is_cascade,
            "is_remote": is_remote,
            "gate_name": self.gate_name,
            "gate_threshold": self.cascade_config.get("gate_threshold", None),
            "loaded_models": list(self.models.keys()),
            "score": self.score,
            "gate_score": self.gate_score,
            "raw_scores": dict(self.raw_scores),
        }
        if is_remote:
            d["remote_uri"] = self.models[verifier_name].uri
        return d

    def __repr__(self) -> str:
        if self.is_cascade:
            return (f"NanoInterpreter(model='{self.model_name}', "
                    f"gate='{self.gate_name}', gate_threshold="
                    f"{self.cascade_config.get('gate_threshold', 0.3)})")
        models = list(self.models.keys())
        if len(models) == 1:
            return f"NanoInterpreter(model='{models[0]}')"
        return f"NanoInterpreter(models={models})"

    def detected(self, threshold: float, model: Optional[str] = None) -> bool:
        name = model or self.model_name
        return self.post_processed_scores.get(name, 0.0) >= threshold

    def stop(self) -> None:
        if self._stop_event is not None:
            self._stop_event.set()
        if self._listen_thread is not None and self._listen_thread.is_alive():
            self._listen_thread.join(timeout=2.0)
        self._listen_thread = None
        self._stop_event = None

    # -- load_model (nanointerpreter.py:295-528) ----------------------------------

    @classmethod
    def load_model(cls,
                   model: Union[str, List[str], None] = None,
                   cascade: bool = False,
                   gate_model: Optional[str] = None,
                   gate_threshold: float = 0.3,
                   remote_verifier: Optional[str] = None,
                   remote_pipeline: str = "verifier_only",
                   remote_timeout: float = 2.0,
                   remote_api_key: Optional[str] = None,
                   remote_token: Optional[str] = None,
                   remote_ssl_certfile: Optional[str] = None,
                   remote_ssl_keyfile: Optional[str] = None,
                   remote_ssl_ca_certs: Optional[str] = None,
                   **kwargs):
        from nanowakeword_tpu.interpreter.remote_verifier import \
            _VALID_PIPELINES

        if remote_pipeline not in _VALID_PIPELINES:
            raise ValueError(f"Invalid remote_pipeline '{remote_pipeline}'. "
                             f"Choose from: {sorted(_VALID_PIPELINES)}")

        paths: List[str] = []
        if model is not None:
            if isinstance(model, str):
                paths = [model]
            elif isinstance(model, list):
                paths = model
            else:
                raise TypeError("`model` must be a string, list of strings, "
                                "or None.")
            for path in paths:
                if not os.path.exists(path):
                    raise FileNotFoundError(f"Model file not found: {path}")

        remote_cfg: Optional[dict] = None
        if remote_verifier is not None:
            if len(paths) > 1:
                raise ValueError(
                    "remote_verifier supports at most one local model path "
                    "(the gate). The verifier runs on the remote server.")
            if paths:
                gate_stem = os.path.splitext(os.path.basename(paths[0]))[0]
                verifier_stem = (gate_stem[:-5] if gate_stem.endswith("_lite")
                                 else gate_stem + "_remote")
            else:
                gate_stem = None
                verifier_stem = "remote_model"
            remote_cfg = {
                "gate": gate_stem, "verifier": verifier_stem,
                "gate_threshold": gate_threshold, "uri": remote_verifier,
                "pipeline": remote_pipeline, "timeout": remote_timeout,
                "api_key": remote_api_key, "token": remote_token,
                "ssl_certfile": remote_ssl_certfile,
                "ssl_keyfile": remote_ssl_keyfile,
                "ssl_ca_certs": remote_ssl_ca_certs,
            }
            logging.info(
                f"[NanoInterpreter] Remote mode: gate='{gate_stem or 'none'}' "
                f"(local) -> verifier='{verifier_stem}' "
                f"(remote @ {remote_verifier}, pipeline='{remote_pipeline}')")

        cascade_cfg: dict = {}
        effective_cascade = cascade or (gate_model is not None)
        if remote_cfg is None and effective_cascade and len(paths) == 1:
            main_path = paths[0]
            stem = os.path.splitext(os.path.basename(main_path))[0]
            if gate_model is not None:
                if not os.path.exists(gate_model):
                    raise FileNotFoundError(
                        f"The specified gate model does not exist: {gate_model}")
                gate_path_found = gate_model
                gate_name = os.path.splitext(os.path.basename(gate_model))[0]
                logging.info(f"[NanoInterpreter] Cascade (custom gate): "
                             f"gate='{gate_name}' -> verifier='{stem}'")
            else:
                model_dir = os.path.dirname(os.path.abspath(main_path))
                gate_name = stem + "_lite"
                # auto-discover `<stem>_lite` beside the model: the native
                # artifact first, then the interchange `.onnx` (the
                # reference's discovery target, nanointerpreter.py:443-487)
                gate_path_found = None
                for ext in (EXTENSION, ".onnx"):
                    candidate = os.path.join(model_dir, gate_name + ext)
                    if os.path.exists(candidate):
                        gate_path_found = candidate
                        break
                if gate_path_found is None:
                    gate_path_found = os.path.join(model_dir,
                                                      gate_name + EXTENSION)
                if not os.path.exists(gate_path_found):
                    logging.warning(
                        f"[NanoInterpreter] cascade=True but no lite model at "
                        f"'{gate_path_found}'. Falling back to single-model "
                        "mode. Generate one with: nanowakeword-tpu -c "
                        "config.yaml --distill")
                    gate_path_found = None
                else:
                    logging.info(
                        f"[NanoInterpreter] Cascade (auto-discovered): "
                        f"gate='{gate_name}' -> verifier='{stem}'")
            if gate_path_found:
                paths = [gate_path_found, main_path]
                cascade_cfg = {"gate": gate_name, "verifier": stem,
                               "gate_threshold": gate_threshold}

        no_local_models = (remote_cfg is not None and not paths)
        if no_local_models:
            instance = cls.__new__(cls)
            instance.models = {}
            instance.model_feature_length = {}
            instance.is_stateful = {}
            instance.hidden_states = {}
            instance.class_mapping = {}
            instance.raw_scores = {}
            instance.post_processed_scores = {}
            instance.cascade_config = {}
            instance._listen_thread = None
            instance._stop_event = None
            instance._fused_step = None
            instance._setup_components_no_preprocessor(**kwargs)
        else:
            instance = cls(wakeword_models=paths, **kwargs)

        if remote_cfg is not None:
            instance._inject_remote_session(remote_cfg)
            instance.cascade_config = {
                "gate": remote_cfg["gate"],
                "verifier": remote_cfg["verifier"],
                "gate_threshold": remote_cfg["gate_threshold"],
            }
            if remote_cfg["gate"] is None:
                instance.cascade_config = {}
        else:
            instance.cascade_config = cascade_cfg
        return instance

    def _inject_remote_session(self, remote_cfg: dict) -> None:
        from nanowakeword_tpu.interpreter.remote_verifier import _RemoteSession
        verifier_name = remote_cfg["verifier"]
        session = _RemoteSession(
            uri=remote_cfg["uri"], model_name=verifier_name,
            pipeline=remote_cfg["pipeline"], timeout=remote_cfg["timeout"],
            api_key=remote_cfg.get("api_key"), token=remote_cfg.get("token"),
            ssl_certfile=remote_cfg.get("ssl_certfile"),
            ssl_keyfile=remote_cfg.get("ssl_keyfile"),
            ssl_ca_certs=remote_cfg.get("ssl_ca_certs"))
        self.models[verifier_name] = session
        self.model_feature_length[verifier_name] = session.feature_length
        self.is_stateful[verifier_name] = False
        self.hidden_states[verifier_name] = None
        self.raw_scores[verifier_name] = 0.0
        self.post_processed_scores[verifier_name] = 0.0
        self.class_mapping[verifier_name] = {"0": verifier_name}
        # remote sessions can't join the fused device step
        self._fused_step = None
        logging.info(f"[NanoInterpreter] Remote verifier '{verifier_name}' "
                     f"registered (pipeline='{remote_cfg['pipeline']}').")

    # -- component setup (nanointerpreter.py:893-912) -------------------------------

    def _setup_components(self, **kwargs):
        self.prediction_buffer = defaultdict(partial(deque, maxlen=30))
        use_noise_reduction = kwargs.pop("enable_noise_reduction", False)
        self.noise_reducer_enabled = use_noise_reduction
        if use_noise_reduction and not NOISEREDUCE_AVAILABLE:
            logging.warning("`enable_noise_reduction` is True, but "
                            "`noisereduce` is not installed. Disabling.")
            self.noise_reducer_enabled = False
        self.vad_threshold = kwargs.pop("vad_threshold", 0)
        if self.vad_threshold > 0:
            from nanowakeword_tpu.interpreter.vad import VAD
            self.vad = VAD()
        onnx_frontend = kwargs.pop("onnx_frontend", None)
        if onnx_frontend is not None:
            # alternative feature frontend: the exported `_mel_stream` /
            # `_embedding` ONNX graph pair driven by the numpy evaluator —
            # the reference's edge architecture (mel+embedding ARE onnx
            # models, _registry.py:34-47). Accepts (mel_path, emb_path) or
            # a path prefix such as "<dir>/<model_name>".
            from nanowakeword_tpu.export.frontend import OnnxStreamingFrontend
            if isinstance(onnx_frontend, (tuple, list)):
                mel_path, emb_path = onnx_frontend
            else:
                mel_path = f"{onnx_frontend}_mel_stream.onnx"
                emb_path = f"{onnx_frontend}_embedding.onnx"
            self.preprocessor = OnnxStreamingFrontend(mel_path, emb_path)
            return
        self.preprocessor = AudioFeatures(**kwargs)

    def _setup_components_no_preprocessor(self, **kwargs):
        self.prediction_buffer = defaultdict(partial(deque, maxlen=30))
        use_noise_reduction = kwargs.pop("enable_noise_reduction", False)
        self.noise_reducer_enabled = use_noise_reduction and NOISEREDUCE_AVAILABLE
        self.vad_threshold = kwargs.pop("vad_threshold", 0)
        if self.vad_threshold > 0:
            from nanowakeword_tpu.interpreter.vad import VAD
            self.vad = VAD()
        self.preprocessor = None

    # -- fused streaming fast path -----------------------------------------------

    def _build_fused_step(self):
        """One jitted call per 80 ms chunk: mel step + encoder + EVERY local
        stateless model's score. Collapses the reference's
        per-model-session round trips (`nanointerpreter.py:656-689`) into a
        single device dispatch — the p50-latency path.

        Returns None (general path) when any model is remote or stateful.
        """
        if self.preprocessor is None or not self.models:
            return None
        if not hasattr(self.preprocessor, "_stream_step_impl"):
            return None     # non-jax frontend (e.g. OnnxStreamingFrontend)
        sessions = list(self.models.items())
        if any(not isinstance(s, _LocalSession) for _, s in sessions):
            return None

        pre = self.preprocessor
        names = [name for name, _ in sessions]
        lengths = [self.model_feature_length[name] for name, _ in sessions]
        stateful = [s.stateful for _, s in sessions]
        all_variables = tuple(s.model.variables for _, s in sessions)
        modules = [s.model.module for _, s in sessions]

        def step(variables_tuple, state, carries, chunk):
            new_state = pre._stream_step_impl(state, chunk)
            scores, new_carries = [], []
            for module, variables, L, is_st, carry in zip(
                    modules, variables_tuple, lengths, stateful, carries):
                feats = new_state.feat_buf[-L:][None]
                if is_st:
                    logits, new_carry = module.apply(
                        variables, feats, carry=carry, deterministic=True)
                    new_carries.append(new_carry)
                else:
                    logits = module.apply(variables, feats,
                                          deterministic=True)
                    new_carries.append(carry)
                scores.append(jax.nn.sigmoid(logits.reshape(())))
            return new_state, tuple(new_carries), jnp.stack(scores)

        jitted = jax.jit(step, donate_argnums=(1,))

        def run(chunk_f32):
            carries = tuple(self.hidden_states.get(n) for n in names)
            self.preprocessor.state, new_carries, scores = jitted(
                all_variables, self.preprocessor.state, carries, chunk_f32)
            self.preprocessor._frames_seen += 1
            for n, is_st, c in zip(names, stateful, new_carries):
                if is_st:
                    self.hidden_states[n] = c
            return dict(zip(names, np.asarray(scores, np.float64)))

        return run

    def _predict_fused(self, x: np.ndarray, patience, threshold,
                       debounce_time):
        """predict() body over the fused step; semantics identical to the
        general path (warm-up guard, cascade gating, VAD, post-filters)."""
        pre = self.preprocessor
        x = np.asarray(x, np.float32).reshape(-1)
        chunks = pre._chunker.feed(x)    # native framing + remainder carry
        if chunks.shape[0] == 0:
            pre.accumulated_samples = pre._chunker.pending
            return DetectionResult(scores=dict(self.post_processed_scores),
                                   model_name=self.model_name,
                                   gate_name=self.gate_name)

        raw = {}
        for chunk in chunks:
            raw = self._fused_step(jnp.asarray(chunk))
        n_prepared = chunks.shape[0] * 1280
        pre.accumulated_samples = pre._chunker.pending

        frames_avail = min(pre._frames_seen, pre.state.feat_buf.shape[0])
        chunk_scores = {}
        for model_key, score in raw.items():
            if frames_avail < self.model_feature_length[model_key]:
                chunk_scores[model_key] = 0.0
                continue
            if self.cascade_config \
                    and model_key == self.cascade_config["verifier"]:
                gate_score = chunk_scores.get(
                    self.cascade_config["gate"], 0.0)
                if gate_score < self.cascade_config["gate_threshold"]:
                    chunk_scores[model_key] = 0.0
                    continue
            score = float(score)
            self.raw_scores[model_key] = score
            if len(self.prediction_buffer.get(model_key, [])) < 5:
                score = 0.0
            chunk_scores[model_key] = score

        gated_scores = chunk_scores.copy()
        if self.vad_threshold > 0:
            self.vad(x)
            vad_frames = list(self.vad.prediction_buffer)[-7:-4]
            vad_max = np.max(vad_frames) if len(vad_frames) > 0 else 0
            if vad_max < self.vad_threshold:
                for model_key in gated_scores:
                    gated_scores[model_key] = 0.0

        self._apply_post_processing(gated_scores, patience, threshold,
                                    debounce_time, n_prepared)
        for model_key, score in gated_scores.items():
            self.prediction_buffer[model_key].append(score)
            self.post_processed_scores[model_key] = score
        return DetectionResult(scores=dict(gated_scores),
                               model_name=self.model_name,
                               gate_name=self.gate_name)

    # -- predict (nanointerpreter.py:592-722) ----------------------------------------

    def predict(self, x: np.ndarray, patience: dict = {},
                threshold: dict = {},
                debounce_time: float = 0.0) -> DetectionResult:
        if not isinstance(x, np.ndarray):
            raise ValueError("Input audio `x` must be a Numpy array.")

        if self.noise_reducer_enabled:
            x = self._reduce_noise(x)

        # full-remote: no local preprocessor, raw audio to the server
        if self.preprocessor is None:
            chunk_scores = {}
            for model_key, session in self.models.items():
                score = session.run_audio(x)
                self.raw_scores[model_key] = score
                if len(self.prediction_buffer.get(model_key, [])) < 5:
                    score = 0.0
                chunk_scores[model_key] = score
            for model_key, score in chunk_scores.items():
                self.prediction_buffer[model_key].append(score)
                self.post_processed_scores[model_key] = score
            return DetectionResult(scores=dict(chunk_scores),
                                   model_name=self.model_name,
                                   gate_name=self.gate_name)

        if self._fused_step is not None:
            return self._predict_fused(x, patience, threshold, debounce_time)

        n_prepared_samples = self.preprocessor(x)
        if n_prepared_samples < 1280:
            return DetectionResult(scores=dict(self.post_processed_scores),
                                   model_name=self.model_name,
                                   gate_name=self.gate_name)

        chunk_scores = {}
        for model_key, session in self.models.items():
            required_frames = self.model_feature_length[model_key]

            # warm-up guard (nanointerpreter.py:660-662)
            if self.preprocessor.feature_buffer.shape[0] < required_frames:
                chunk_scores[model_key] = 0.0
                continue

            # cascade gate check (nanointerpreter.py:665-674)
            if self.cascade_config:
                gate_name_ = self.cascade_config["gate"]
                verifier_name = self.cascade_config["verifier"]
                gate_thr = self.cascade_config["gate_threshold"]
                if model_key == verifier_name:
                    if chunk_scores.get(gate_name_, 0.0) < gate_thr:
                        chunk_scores[model_key] = 0.0
                        continue

            features = self.preprocessor.get_features(required_frames)
            if self.is_stateful.get(model_key, False):
                score, new_carry = session.run(
                    features, carry=self.hidden_states.get(model_key))
                self.hidden_states[model_key] = new_carry
            else:
                score, _ = session.run(features)

            self.raw_scores[model_key] = score
            # zero initial predictions (nanointerpreter.py:694-696)
            if len(self.prediction_buffer.get(model_key, [])) < 5:
                score = 0.0
            chunk_scores[model_key] = score

        gated_scores = chunk_scores.copy()

        # VAD gate over frames [-7:-4] (nanointerpreter.py:703-709)
        if self.vad_threshold > 0:
            self.vad(x)
            vad_frames = list(self.vad.prediction_buffer)[-7:-4]
            vad_max = np.max(vad_frames) if len(vad_frames) > 0 else 0
            if vad_max < self.vad_threshold:
                for model_key in gated_scores:
                    gated_scores[model_key] = 0.0

        self._apply_post_processing(gated_scores, patience, threshold,
                                    debounce_time, n_prepared_samples)

        for model_key, score in gated_scores.items():
            self.prediction_buffer[model_key].append(score)
            self.post_processed_scores[model_key] = score

        return DetectionResult(scores=dict(gated_scores),
                               model_name=self.model_name,
                               gate_name=self.gate_name)

    def reset(self):
        self.prediction_buffer.clear()
        if self.preprocessor is not None:
            self.preprocessor.reset()
        for model_key in self.hidden_states:
            self.hidden_states[model_key] = None
        for model_key in self.raw_scores:
            self.raw_scores[model_key] = 0.0
            self.post_processed_scores[model_key] = 0.0

    def predict_clip(self, clip: Union[str, np.ndarray],
                     chunk_size: int = 1280, **kwargs) -> list:
        """Predict on a full clip by simulating a stream
        (nanointerpreter.py:738-751)."""
        if isinstance(clip, str):
            with wave.open(clip, mode="rb") as f:
                if (f.getframerate() != 16000 or f.getsampwidth() != 2
                        or f.getnchannels() != 1):
                    raise ValueError("Audio clip must be a 16kHz, 16-bit, "
                                     "single-channel WAV file.")
                data = np.frombuffer(f.readframes(f.getnframes()),
                                     dtype=np.int16)
        elif isinstance(clip, np.ndarray):
            data = clip
        else:
            raise TypeError("`clip` must be a file path or a numpy array.")
        return [self.predict(data[i:i + chunk_size], **kwargs)
                for i in range(0, len(data), chunk_size)]

    def listen(self,
               on_detection: Optional[Callable[[str, float], None]] = None,
               threshold: float = 0.5,
               cooldown: float = 1.0,
               chunk_size: int = 1280,
               on_score: Optional[Callable[[float, float], None]] = None,
               on_audio: Optional[Callable[[np.ndarray], None]] = None,
               blocking: bool = True) -> None:
        """Microphone loop (nanointerpreter.py:753-863). Requires pyaudio."""
        try:
            import pyaudio
        except ImportError:
            raise ImportError("PyAudio is required for listen(). Install it "
                              "with: pip install pyaudio")

        if on_detection is None:
            def on_detection(name: str, score: float) -> None:
                print(f"\nDetected '{name}'!  (score: {score:.5f})")

        def _loop():
            # Real-time structure: a dedicated capture thread pushes int16
            # frames into the native SPSC ring (native/nww_runtime.cc —
            # lock-free, drops OLDEST on overflow so capture never blocks);
            # this thread pops whole chunks and scores them. A slow scoring
            # step therefore skips audio instead of stalling the microphone,
            # unlike the reference's read->score-in-one-thread loop
            # (nanointerpreter.py:753-863).
            from nanowakeword_tpu.runtime import AudioRing
            ring = AudioRing(capacity=16000 * 10)
            pa = pyaudio.PyAudio()
            stream = pa.open(format=pyaudio.paInt16, channels=1, rate=16000,
                             input=True, frames_per_buffer=chunk_size)
            last_detection = 0.0
            stop_event = self._stop_event
            capture_stop = threading.Event()

            def _capture():
                while not capture_stop.is_set():
                    try:
                        ring.push(np.frombuffer(
                            stream.read(chunk_size,
                                        exception_on_overflow=False),
                            dtype=np.int16))
                    except OSError:
                        return

            capture_thread = threading.Thread(target=_capture, daemon=True)
            capture_thread.start()
            try:
                while not (stop_event and stop_event.is_set()):
                    if ring.size < chunk_size:
                        time.sleep(chunk_size / 16000 / 4)
                        continue
                    audio = ring.pop(chunk_size)
                    if on_audio is not None:
                        on_audio(audio)
                    self.predict(audio)
                    v_score, g_score = self.verifier_score, self.gate_score
                    if on_score is not None:
                        on_score(v_score, g_score)
                    now = time.monotonic()
                    if (v_score > threshold
                            and (now - last_detection) > cooldown):
                        on_detection(self.model_name, v_score)
                        last_detection = now
                        self.reset()
            except KeyboardInterrupt:
                pass
            finally:
                capture_stop.set()
                stream.stop_stream()
                stream.close()
                pa.terminate()
                capture_thread.join(timeout=1.0)

        if blocking:
            _loop()
        else:
            self._stop_event = threading.Event()
            self._listen_thread = threading.Thread(target=_loop, daemon=True)
            self._listen_thread.start()

    # -- helpers ----------------------------------------------------------------

    def _reduce_noise(self, x: np.ndarray) -> np.ndarray:
        try:
            audio_float = x.astype(np.float32) / 32767.0
            reduced = nr.reduce_noise(y=audio_float, sr=16000, stationary=True)
            return (reduced * 32767.0).astype(np.int16)
        except Exception as e:  # noqa: BLE001
            logging.warning(f"Noise reduction failed: {e}. Returning original "
                            "audio.")
            return x

    def _apply_post_processing(self, predictions, patience, threshold,
                               debounce_time, n_prepared_samples):
        """Patience / debounce filters (nanointerpreter.py:924-954)."""
        if not patience and debounce_time <= 0:
            return
        if (patience or debounce_time > 0) and not threshold:
            raise ValueError("`threshold` must be provided when using "
                             "`patience` or `debounce_time`.")
        if patience and debounce_time > 0:
            raise ValueError("`patience` and `debounce_time` cannot be used "
                             "together.")

        for model_key in predictions.keys():
            if predictions[model_key] == 0.0:
                continue
            if model_key in patience:
                required = patience[model_key]
                if len(self.prediction_buffer[model_key]) < required:
                    predictions[model_key] = 0.0
                    continue
                recent = np.array(
                    list(self.prediction_buffer[model_key])[-(required - 1):]
                    + [predictions[model_key]])
                if (recent >= threshold[model_key]).sum() < required:
                    predictions[model_key] = 0.0
            elif debounce_time > 0 and model_key in threshold:
                frame_dur = n_prepared_samples / 16000.0
                if frame_dur <= 0:
                    continue
                n_check = int(np.ceil(debounce_time / frame_dur))
                recent = np.array(self.prediction_buffer[model_key])[-n_check:]
                if (predictions[model_key] >= threshold[model_key]
                        and (recent >= threshold[model_key]).any()):
                    predictions[model_key] = 0.0
