"""Run the wake-word main path once on a GPU and check what comes out.

    python chip_smoke.py            # one GPU: serve, extract, train, mel
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases (one process; the card is never shared with a child process):

1. serve    the shipped CRNN artifact and its lite gate in NanoInterpreter,
            ~10 s of seeded audio as 80 ms chunks through predict(), plain
            and as a gate -> verifier cascade; the server's batched path
            (_LocalSession.run_batch) and the websocket server itself.
2. extract  AudioFeatures.embed_clips on 4096 x 1 s int16 clips, scored by
            the shipped CRNN head.
3. train    Trainer.train_device_cached with the campaign model, and the
            augment -> mel -> encoder -> train-step chain at batch 2048 x
            1 s in float32 and bfloat16.
4. mel      XLA's mel stage alone at 4096 x 1 s, timed, with its share of
            the card's memory bandwidth.

Every comparison prints its value beside its tolerance, and a value outside
its tolerance ends the run with a non-zero exit. The last line of standard
output is one JSON object naming the device. Without a GPU the script exits
non-zero before doing anything.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CAMPAIGN = os.path.join(REPO, "campaign")
SEED = 20261016

# The campaign's model (campaign/config_hey_nano.yaml): CRNN, 16/32/32
# channels, two GRU layers of 64, 96-dim embedding.
CRNN_CONFIG = {
    "activation_function": "relu", "embedding_dim": 96,
    "crnn_cnn_channels": [16, 32, 32], "crnn_rnn_type": "gru",
    "optimizer_type": "adamw", "learning_rate_max": 0.0015,
    "lr_scheduler_type": "onecycle", "weight_decay": 0.01,
}
BATCH_COMPOSITION = {"t": 96, "pa": 28, "pah": 20, "wa": 16, "gen": 28,
                     "dn": 36, "nz": 32}

# Peak memory bandwidth by device kind (NVIDIA H100 SXM data sheet).
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

# -- tolerances --------------------------------------------------------------
# Streaming vs batch score trace: the repo's invariant (docs/DESIGN.md §2,
# tests/test_score_trace.py). Never loosened.
TOL_SCORE_TRACE = 1e-3
# Log-mel against the float64 numpy DFT oracle. The product path rounds
# audio rows and DFT bases to bfloat16 (2^-9 relative) before float32
# accumulation; in the log10 domain that is a few 1e-3 on loud bins, and up
# to ~1e-1 on bins within a few dB of the 1e-8 floor, where a tiny absolute
# error is a large relative one. The mean over all bins stays small.
TOL_MEL_MAX = 0.1
TOL_MEL_MEAN = 5e-3
# Embeddings and scores of the bf16 bulk path against the same graph in
# float32 under "highest" precision: the bf16 mel above feeds a 4-layer
# conv encoder; relative to the embedding scale the error stays ~1e-2.
TOL_EMB_REL = 5e-2
TOL_SCORE_BULK = 1e-2
# First training step's loss against the same step in float32 "highest":
# float32 matmuls may run as TF32 (10-bit mantissa) on the card; the chain
# also feeds bf16 mel and a bf16 encoder into both steps' features.
TOL_LOSS_F32 = 1e-2
TOL_LOSS_BF16 = 2e-2
# Sharded results against one device: the same graph, summed in another
# order and, on the card, through algorithms chosen for each shard's shape.
# Losses and scores are compared as they are; embeddings relative to their
# largest magnitude.
TOL_SHARDED = 1e-3


class Reporter:
    """Prints each result on its own line with the card's name and power
    limit beside it, and fails the run on a value outside its tolerance."""

    def __init__(self, card: str):
        self.card = card

    def line(self, phase: str, text: str):
        print(f"[{phase}] {text} | {self.card}", flush=True)

    def check(self, phase: str, name: str, value: float, tol: float):
        ok = bool(np.isfinite(value) and value <= tol)
        self.line(phase, f"{name} = {value:.6g} (tolerance {tol:g}) "
                         f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"{phase}: {name} = {value} > {tol}")

    def require(self, phase: str, what: str, cond: bool):
        self.line(phase, f"{what}: {'ok' if cond else 'FAILED'}")
        if not cond:
            raise AssertionError(f"{phase}: {what}")


def card_name_and_power() -> str:
    """`name, power.limit` of the first GPU, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def require_gpu(n_devices: int):
    """The run goes on only on GPUs. JAX falls back to the CPU silently when
    its CUDA plugin fails to start, so the backend is checked by name."""
    import jax
    backend = jax.default_backend()
    devices = jax.devices()
    if backend != "gpu" or len(devices) < n_devices:
        sys.exit(f"chip_smoke: needs {n_devices} GPU(s); JAX backend is "
                 f"'{backend}' with devices {devices}")
    return devices


def result_line(devices) -> str:
    """The last line: the run passed, on these devices as JAX reports them."""
    dev = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}})


def _timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _stream_audio(seconds: float, seed: int) -> np.ndarray:
    """Seeded int16 audio: low-level noise with the example positive clip
    spliced in twice, so the models' scores leave the floor."""
    import wave
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000) // 1280 * 1280
    audio = rng.normal(0.0, 300.0, n)
    with wave.open(os.path.join(REPO, "examples", "training_data",
                                "positive", "positive_sample.wav")) as f:
        clip = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    for at in (0.3, 0.65):
        s = int(at * n)
        e = min(n, s + len(clip))
        audio[s:e] += clip[:e - s]
    return np.clip(audio, -32768, 32767).astype(np.int16)


def _windows(feats: np.ndarray, n_frames: int) -> np.ndarray:
    """[F, 96] -> [F - n_frames + 1, n_frames, 96] sliding windows."""
    idx = np.arange(feats.shape[0] - n_frames + 1)[:, None] \
        + np.arange(n_frames)[None, :]
    return feats[idx]


# ---------------------------------------------------------------------------
# 1. serve
# ---------------------------------------------------------------------------

def phase_serve(rep: Reporter, seconds: float = 10.0):
    from nanowakeword_tpu.data.features import AudioFeatures
    from nanowakeword_tpu.export.artifact import load_nww
    from nanowakeword_tpu.interpreter.nanointerpreter import (
        NanoInterpreter, _LocalSession)

    P = "serve"
    crnn_path = os.path.join(CAMPAIGN, "hey_nano_crnn.nww")
    lite_path = os.path.join(CAMPAIGN, "hey_nano_crnn_lite.nww")
    audio = _stream_audio(seconds, SEED)
    n_chunks = len(audio) // 1280

    # batch path: whole-clip features, every window scored in one batch
    # through the server's batched session
    header, model, enc_vars = load_nww(crnn_path)
    _, lite_model, _ = load_nww(lite_path)
    n_frames = int(header["input_shape"][0])
    af = AudioFeatures(encoder_variables=enc_vars)
    feats, t_feat = _timed(lambda a: af.embed_clips(a[None])[0], audio)
    wins = _windows(feats, n_frames)
    sess = _LocalSession(model, header)
    lite_sess = _LocalSession(lite_model, {"input_shape": (n_frames, 96)})
    batch_scores, t_rb = _timed(sess.run_batch, wins)
    lite_scores = lite_sess.run_batch(wins)
    rep.line(P, f"batch path: {len(audio) / 16000:.2f} s of audio -> "
                f"{feats.shape[0]} embedding frames -> {len(wins)} windows; "
                f"embed {t_feat:.3f} s, run_batch {t_rb:.3f} s (first calls, "
                f"compile included); score range "
                f"[{batch_scores.min():.4f}, {batch_scores.max():.4f}]")

    # streaming path: 80 ms chunks through predict()
    def stream(interp):
        traces = {k: [] for k in interp.models}
        t0 = time.perf_counter()
        for c in range(n_chunks):
            r = interp.predict(audio[c * 1280:(c + 1) * 1280])
            for k in traces:
                traces[k].append(r.get(k))
        return {k: np.asarray(v) for k, v in traces.items()}, \
            time.perf_counter() - t0

    # Chunk c scores the window ending at embedding frame c - 9; from chunk
    # 40 on, that window is fully real audio and past the warm-up guard
    # (tests/test_score_trace.py).
    cs = np.arange(40, n_chunks)
    cs = cs[cs - 24 < len(wins)]

    plain = NanoInterpreter.load_model(crnn_path)
    tr, t_stream = stream(plain)
    s = tr["hey_nano_crnn"]
    rep.line(P, f"plain predict(): {n_chunks} chunks in {t_stream:.3f} s "
                f"({t_stream / n_chunks * 1e3:.3f} ms/chunk, first call "
                f"compiles); {len(cs)} comparable chunks")
    rep.check(P, "plain stream vs batch score max|diff|",
              float(np.abs(s[cs] - batch_scores[cs - 24]).max()),
              TOL_SCORE_TRACE)
    # the embedding ring itself against the batch frames (frame c - 9)
    ring = np.asarray(plain.preprocessor.state.feat_buf)
    last = n_chunks - 1 - 9
    k = min(60, last + 1 - 40)
    rep.line(P, f"stream vs batch embedding frames (last {k}): max|diff| = "
                f"{np.abs(ring[-k:] - feats[last - k + 1:last + 1]).max():.3g}"
                f" of max|feature| {np.abs(feats).max():.3g}")

    cascade = NanoInterpreter.load_model(crnn_path, cascade=True)
    rep.require(P, "cascade loaded gate 'hey_nano_crnn_lite'",
                cascade.gate_name == "hey_nano_crnn_lite")
    tr, t_cas = stream(cascade)
    gate, verifier = tr["hey_nano_crnn_lite"], tr["hey_nano_crnn"]
    thr = cascade.cascade_config["gate_threshold"]
    passed = gate[cs] >= thr
    rep.line(P, f"cascade predict(): {n_chunks} chunks in {t_cas:.3f} s; "
                f"gate passed {int(passed.sum())} of {len(cs)} comparable "
                f"chunks (threshold {thr})")
    rep.check(P, "cascade gate stream vs batch score max|diff|",
              float(np.abs(gate[cs] - lite_scores[cs - 24]).max()),
              TOL_SCORE_TRACE)
    want = np.where(passed, batch_scores[cs - 24], 0.0)
    rep.check(P, "cascade verifier stream vs gated batch score max|diff|",
              float(np.abs(verifier[cs] - want).max()), TOL_SCORE_TRACE)

    _serve_over_websocket(rep, crnn_path, wins, batch_scores)


def _serve_over_websocket(rep, crnn_path, wins, batch_scores):
    import socket

    from nanowakeword_tpu.interpreter.remote_verifier import (
        _RemoteSession, serve)

    P = "serve"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ready = threading.Event()
    failure = []

    def run():
        try:
            serve(model_path=crnn_path, host="127.0.0.1", port=port,
                  log_level="WARNING", _ready_callback=lambda _: ready.set())
        except BaseException as e:  # noqa: BLE001 — reported below
            failure.append(e)
            ready.set()

    threading.Thread(target=run, daemon=True).start()
    rep.require(P, "websocket server started",
                ready.wait(timeout=300) and not failure)
    client = _RemoteSession(uri=f"ws://127.0.0.1:{port}",
                            model_name="hey_nano_crnn", timeout=60.0)
    pick = np.linspace(0, len(wins) - 1, 8).astype(int)
    t0 = time.perf_counter()
    got = np.asarray([client.run(wins[i][None])[0] for i in pick])
    dt = time.perf_counter() - t0
    client.close()
    rep.line(P, f"websocket: {len(pick)} requests in {dt:.3f} s")
    rep.check(P, "websocket score vs run_batch max|diff|",
              float(np.abs(got - batch_scores[pick]).max()), TOL_SCORE_TRACE)


# ---------------------------------------------------------------------------
# 2. extract
# ---------------------------------------------------------------------------

def phase_extract(rep: Reporter, n_clips: int = 4096, n_ref_clips: int = 64):
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import AudioFeatures
    from nanowakeword_tpu.export.artifact import load_nww
    from nanowakeword_tpu.interpreter.nanointerpreter import _LocalSession
    from nanowakeword_tpu.ops import mel as melops

    P = "extract"
    rng = np.random.default_rng(SEED + 1)
    audio = rng.integers(-16000, 16000, (n_clips, 16000)).astype(np.int16)

    af = AudioFeatures()
    emb, t_first = _timed(lambda a: af.embed_clips(a, batch_size=n_clips),
                          audio)
    emb, t_warm = _timed(lambda a: af.embed_clips(a, batch_size=n_clips),
                         audio)
    rep.line(P, f"embed_clips {n_clips} x 1 s int16 -> {emb.shape}: first "
                f"call {t_first:.3f} s, warm call {t_warm:.4f} s "
                f"({n_clips / t_warm:,.0f} clips/s, host transfers included)")

    header, model, _ = load_nww(os.path.join(CAMPAIGN, "hey_nano_crnn.nww"))
    n_frames = int(header["input_shape"][0])

    def pad(e):
        return np.pad(e, ((0, 0), (n_frames - e.shape[1], 0), (0, 0)))

    sess = _LocalSession(model, header)
    scores, t_score = _timed(sess.run_batch, pad(emb))
    rep.require(P, f"scores finite, shape {scores.shape}",
                scores.shape == (n_clips,) and bool(np.isfinite(scores).all()))
    rep.line(P, f"CRNN scores in {t_score:.4f} s (first call)")

    # log-mel of the product path against the float64 oracle
    mel = np.asarray(af._jit_mel(jnp.asarray(audio)))
    ref = melops.mel_frontend_reference(audio[:n_ref_clips])
    d = np.abs(mel[:n_ref_clips] - ref)
    rep.check(P, f"log-mel vs float64 reference max|diff| ({n_ref_clips} "
                 f"clips)", float(d.max()), TOL_MEL_MAX)
    rep.check(P, "log-mel vs float64 reference mean|diff|", float(d.mean()),
              TOL_MEL_MEAN)

    # the same graph in float32 under "highest" precision
    with jax.default_matmul_precision("highest"):
        af32 = AudioFeatures(compute_dtype=jnp.float32)
        emb_ref = af32.embed_clips(audio, batch_size=n_clips)
        scores_ref = _LocalSession(model, header).run_batch(pad(emb_ref))
    rel = float(np.abs(emb - emb_ref).max() / np.abs(emb_ref).max())
    rep.check(P, "embeddings vs float32-highest max|diff| / max|emb|", rel,
              TOL_EMB_REL)
    rep.check(P, "scores vs float32-highest max|diff|",
              float(np.abs(scores - scores_ref).max()), TOL_SCORE_BULK)


# ---------------------------------------------------------------------------
# 3. train
# ---------------------------------------------------------------------------

def _crnn(config=CRNN_CONFIG, dropout=0.3):
    from nanowakeword_tpu.models.model import Model
    return Model(config=dict(config), model_name="smoke_crnn",
                 input_shape=(16, 96), model_type="crnn", layer_dim=64,
                 n_blocks=2, dropout_prob=dropout)


def _device_cache_data(workdir: str, rows_per_pool: int):
    from nanowakeword_tpu.data.dataset import (AdaptiveLossAwareDataset,
                                               DynamicClassAwareSampler)
    rng = np.random.default_rng(SEED + 2)
    manifest = {"targets": {}, "negatives": {}}
    for name in BATCH_COMPOSITION:
        x = rng.normal(size=(rows_per_pool, 16, 96)).astype(np.float32)
        if name == "t":
            x += 0.5
        path = os.path.join(workdir, f"{name}.npy")
        np.save(path, x)
        manifest["targets" if name == "t" else "negatives"][name] = path
    dataset = AdaptiveLossAwareDataset(manifest)
    sampler = DynamicClassAwareSampler(dataset, dict(BATCH_COMPOSITION),
                                       manifest)
    return dataset, sampler


def _train_cached(workdir: str, rows_per_pool: int, k_steps: int,
                  max_steps: int, data_parallel: bool = False,
                  dropout: float = 0.3):
    """Trainer.train_device_cached on seeded pools -> (trainer, steps, s)."""
    from nanowakeword_tpu.train.trainer import Trainer
    cfg = dict(CRNN_CONFIG, steps=max_steps, stabilization_steps=1,
               early_stopping_patience=0, checkpoint_pool_interval=10**9,
               device_cache={"enabled": True, "data_parallel": data_parallel,
                             "steps_per_dispatch": k_steps})
    trainer = Trainer(_crnn(dropout=dropout), cfg)
    X = _device_cache_data(workdir, rows_per_pool)
    t0 = time.perf_counter()
    steps = trainer.train_device_cached(X, None, max_steps=max_steps,
                                        log_path=workdir)
    return trainer, steps, time.perf_counter() - t0


def phase_train(rep: Reporter, workdir: str, batch: int = 2048,
                rows_per_pool: int = 4096, k_steps: int = 4):
    import jax

    P = "train"
    # -- device-cached ISBL training through the Trainer ------------------------
    trainer, steps, dt = _train_cached(workdir, rows_per_pool, k_steps,
                                       2 * k_steps)
    losses = np.asarray(trainer.history["loss"])
    rep.require(P, f"device-cached training: {steps} steps in {dt:.3f} s "
                   f"(2 dispatches, compile included), losses "
                   f"{np.round(losses, 4).tolist()}",
                steps == 2 * k_steps and len(losses) == steps
                and bool(np.isfinite(losses).all())
                and int(trainer.state.step) == steps)
    with jax.default_matmul_precision("highest"):
        ref = _train_cached(workdir, rows_per_pool, k_steps, k_steps)[0]
    rep.check(P, "device-cached first-step loss vs float32-highest |diff|",
              abs(float(losses[0]) - float(ref.history["loss"][0])),
              TOL_LOSS_F32)

    # -- the augmentation chain at the benchmark's batch ------------------------
    _train_chain(rep, batch)


def _train_chain(rep: Reporter, batch: int, n_steps: int = 3):
    import jax
    import jax.numpy as jnp

    from bench import _mel_bf16, make_aug_train_step
    from nanowakeword_tpu.data.features import default_encoder_variables
    from nanowakeword_tpu.models.embedding import (build_encoder,
                                                   infer_encoder_arch)
    from nanowakeword_tpu.ops import mel as melops
    from nanowakeword_tpu.ops.augment import AugmentParams
    from nanowakeword_tpu.train.optim import build_optimizer
    from nanowakeword_tpu.train.step import (create_train_state,
                                             make_train_step)

    P = "train"
    rng = np.random.default_rng(SEED + 3)
    model = _crnn()
    tx = build_optimizer(dict(CRNN_CONFIG), 1000)
    enc_vars = jax.device_put(default_encoder_variables())
    arch = infer_encoder_arch(enc_vars)
    args = tuple(jax.device_put(a) for a in (
        enc_vars,
        rng.integers(-16000, 16000, (batch, 16000)).astype(np.int16),
        rng.integers(-2000, 2000, (batch, 16000)).astype(np.float32),
        np.zeros((batch, 1600), np.float32),
        np.full(batch, 16000, np.int32),
        np.ones(batch, bool), np.zeros(batch, bool),
        (rng.random(batch) < 0.5).astype(np.float32)))
    aug_params = AugmentParams.from_settings({"rir_prob": 0.0})

    def first_loss_and_steps(compute_dtype, reference):
        step = make_train_step(model.module, tx, donate=False, jit=False,
                               compute_dtype=compute_dtype)
        if reference:
            encoder = build_encoder(arch,
                                    precision=jax.lax.Precision.HIGHEST)
            mel_fn = lambda a: melops.mel_frontend(  # noqa: E731
                a, compute_dtype=jnp.float32)
        else:   # bench.py's chain: bf16 mel, bf16 encoder
            encoder = build_encoder(arch, dtype=jnp.bfloat16, precision=None)
            mel_fn = _mel_bf16
        fn = jax.jit(make_aug_train_step(step, encoder, aug_params, mel_fn))
        st = jax.device_put(create_train_state(model.module, model.variables,
                                               tx))
        losses, times = [], []
        for i in range(1 if reference else n_steps):
            (st, loss), dt = _timed(fn, i, st, *args)
            losses.append(float(loss))
            times.append(dt)
        return losses, times, int(st.step)

    with jax.default_matmul_precision("highest"):
        ref_loss = first_loss_and_steps("float32", True)[0][0]
    for dtype, tol in (("float32", TOL_LOSS_F32), ("bfloat16", TOL_LOSS_BF16)):
        losses, times, n = first_loss_and_steps(dtype, False)
        rep.require(P, f"chain {dtype} batch {batch} x 1 s: {n} steps, "
                       f"losses {np.round(losses, 4).tolist()}, step times "
                       f"{np.round(times, 4).tolist()} s (first compiles; "
                       f"{batch / times[-1]:,.0f} clips/s on the last)",
                    n == n_steps and bool(np.isfinite(losses).all()))
        rep.check(P, f"chain {dtype} first-step loss vs float32-highest "
                     "|diff|", abs(losses[0] - ref_loss), tol)


# ---------------------------------------------------------------------------
# 4. mel stage timing
# ---------------------------------------------------------------------------

def phase_mel_timing(rep: Reporter, n_clips: int = 4096, reps: int = 20):
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.ops import mel as melops

    P = "mel"
    kind = jax.devices()[0].device_kind
    peak = PEAK_BYTES_PER_S.get(kind)
    audio = jax.device_put(np.random.default_rng(SEED + 4).integers(
        -16000, 16000, (n_clips, 16000)).astype(np.int16))
    for out_dtype in (jnp.float32, jnp.bfloat16):
        fn = jax.jit(lambda a, _o=out_dtype: melops.mel_frontend(
            a, compute_dtype=jnp.bfloat16).astype(_o))
        for _ in range(3):
            out = jax.block_until_ready(fn(audio))
        times = []
        for _ in range(reps):
            times.append(_timed(fn, audio)[1])
        t = float(np.median(times))
        nbytes = audio.nbytes + out.size * out.dtype.itemsize
        share = "not in the peak table" if peak is None else \
            f"{nbytes / t / peak:.4f} of {peak / 1e12:.2f} TB/s"
        rep.line(P, f"mel {n_clips} x 1 s int16 -> {out.shape} "
                    f"{out.dtype}: median {t * 1e6:.1f} us, min "
                    f"{min(times) * 1e6:.1f} us over {reps} runs; moves "
                    f"{nbytes / 1e6:.1f} MB -> {nbytes / t / 1e9:.1f} GB/s, "
                    f"{share}")


# ---------------------------------------------------------------------------
# --multi: the sharded paths against one device
# ---------------------------------------------------------------------------

def _placement(arr) -> str:
    return ",".join(sorted({str(s.device.id) for s in arr.addressable_shards}))


def phase_multi(rep: Reporter, workdir: str, n_dev: int,
                rows_per_pool: int = 4096, k_steps: int = 4,
                n_clips: int = 4096, batch_per_device: int = 256):
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import AudioFeatures
    from nanowakeword_tpu.interpreter.nanointerpreter import _LocalSession
    from nanowakeword_tpu.parallel import dp
    from nanowakeword_tpu.parallel import mesh as M
    from nanowakeword_tpu.train.step import create_train_state, \
        make_train_step

    P = "multi"
    rng = np.random.default_rng(SEED + 5)
    rep.line(P, f"devices: {[str(d) for d in jax.devices()]}")

    # -- data-parallel device-cached training (Trainer) -------------------------
    one, many = (_train_cached(workdir, rows_per_pool, k_steps, k_steps,
                               data_parallel=dp_on, dropout=0.0)[0]
                 for dp_on in (False, True))
    kernel = jax.tree_util.tree_leaves(many.state.params)[0]
    rep.line(P, f"device-cached DP training: parameter shards on devices "
                f"{_placement(kernel)}; losses 1 device "
                f"{np.round(one.history['loss'], 5).tolist()}, {n_dev} "
                f"devices {np.round(many.history['loss'], 5).tolist()}")
    rep.check(P, "DP device-cached losses vs 1 device max|diff|",
              float(np.abs(np.asarray(one.history["loss"])
                           - np.asarray(many.history["loss"])).max()),
              TOL_SHARDED)

    # -- DP/TP train step (parallel/dp.py) ---------------------------------------
    model = _crnn(dropout=0.0)
    tx = one.tx
    # host copies: the donated steps consume their state's device buffers
    host_vars = jax.tree_util.tree_map(np.asarray, model.variables)
    batch = batch_per_device * n_dev
    feats = rng.normal(size=(batch, 16, 96)).astype(np.float32)
    labels = (rng.random(batch) < 0.5).astype(np.float32)
    _, ref_metrics = make_train_step(model.module, tx, donate=False)(
        create_train_state(model.module, host_vars, tx),
        jnp.asarray(feats), jnp.asarray(labels))
    for tp in (1, 2):
        mesh = M.make_mesh(n_dev, model_parallel=tp)
        state = dp.shard_train_state(
            create_train_state(model.module, host_vars, tx), mesh)
        step = dp.make_dp_train_step(model.module, tx, mesh)
        f_dev, l_dev = dp.device_put_batch(feats, labels, mesh)
        state, metrics = step(state, f_dev, l_dev)
        rep.line(P, f"DP/TP step mesh {dict(mesh.shape)}: batch shards on "
                    f"devices {_placement(f_dev)}")
        rep.check(P, f"DP/TP step (tp={tp}) loss vs 1 device |diff|",
                  abs(float(metrics.loss) - float(ref_metrics.loss)),
                  TOL_SHARDED)

    # -- sharded embed_clips ---------------------------------------------------------
    audio = rng.integers(-16000, 16000, (n_clips, 16000)).astype(np.int16)
    af = AudioFeatures()
    sharded, dt = _timed(lambda a: af.embed_clips(a, batch_size=n_clips),
                         audio)
    single = np.asarray(af._jit_embed(jax.device_put(audio,
                                                     jax.devices()[0])))
    sh = AudioFeatures._data_sharding()
    placed = jax.device_put(audio[:n_dev * 2], sh)
    rep.line(P, f"sharded embed_clips {n_clips} x 1 s in {dt:.3f} s (first "
                f"call); input shards on devices {_placement(placed)}")
    rep.check(P, "sharded embed_clips vs 1 device max|diff| / max|emb|",
              float(np.abs(sharded - single).max() / np.abs(single).max()),
              TOL_SHARDED)

    # -- data-parallel serving ---------------------------------------------------------
    header = {"input_shape": (16, 96), "stateful": False}
    dp_mesh = M.make_mesh(n_dev)
    wins = rng.normal(size=(4 * n_dev - 1, 16, 96)).astype(np.float32)
    dp_sess = _LocalSession(model, header, mesh=dp_mesh)
    got = dp_sess.run_batch(wins)
    want = _LocalSession(model, header).run_batch(wins)
    rep.line(P, f"DP serving: replicated parameters on devices "
                f"{_placement(jax.tree_util.tree_leaves(dp_sess._sharded_vars)[0])}")
    rep.check(P, "DP serving scores vs 1 device max|diff|",
              float(np.abs(got - want).max()), TOL_SHARDED)


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    n_dev = 4 if args.multi else 1

    devices = require_gpu(n_dev)
    card = card_name_and_power()
    print(f"card: {card}", flush=True)

    sys.path.insert(0, REPO)
    from nanowakeword_tpu.utils.compile_cache import (CacheCounter,
                                                      enable_compile_cache)
    cache_dir = enable_compile_cache()
    counter = CacheCounter()
    rep = Reporter(card)
    rep.line("setup", f"JAX devices {[str(d) for d in devices]}, compile "
                      f"cache {cache_dir}")

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        phases = ([("multi", lambda: phase_multi(rep, workdir, n_dev))]
                  if args.multi else
                  [("serve", lambda: phase_serve(rep)),
                   ("extract", lambda: phase_extract(rep)),
                   ("train", lambda: phase_train(rep, workdir)),
                   ("mel", lambda: phase_mel_timing(rep))])
        for name, run in phases:
            t0 = time.perf_counter()
            run()
            rep.line(name, f"phase wall time {time.perf_counter() - t0:.2f} s")
    rep.line("setup", f"compile cache: {counter.hits} hits, "
                      f"{counter.misses} misses; total "
                      f"{time.perf_counter() - t_all:.1f} s")
    counter.close()

    print(f"card: {card}", flush=True)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
