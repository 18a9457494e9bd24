"""Throughput benchmark: 1-sec clips/sec per device (mel + embedding + CRNN).

The headline metric: end-to-end audio -> wake-word score throughput for the
CRNN configuration (wav -> mel -> speech-embedding -> CRNN -> prob). Also
measures p50 streaming frame latency (80 ms chunk -> score) and the on-device
time of one streaming frame.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def build_forward():
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import (EMB_OFFSET,
                                                default_encoder_variables)
    from nanowakeword_tpu.models.embedding import (build_encoder,
                                                   infer_encoder_arch)
    from nanowakeword_tpu.models.model import Model

    config = {
        "activation_function": "relu",
        "embedding_dim": 96,
        "crnn_cnn_channels": [16, 32, 32],
        "crnn_rnn_type": "gru",
    }
    model = Model(config=config, model_name="bench_crnn",
                  input_shape=(16, 96), model_type="crnn",
                  layer_dim=64, n_blocks=2, dropout_prob=0.0)
    # throughput path: bf16 MXU passes everywhere; the encoder is the
    # SHIPPED pretrained asset (same weights + geometry the product runs)
    enc_vars = default_encoder_variables()
    encoder = build_encoder(infer_encoder_arch(enc_vars),
                            dtype=jnp.bfloat16, precision=None)
    bf16_vars = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if hasattr(x, "dtype") and x.dtype == jnp.float32 else x,
        model.variables)

    def forward(variables, encoder_variables, audio):
        mel = _mel_bf16(audio)
        emb = encoder.apply(encoder_variables, mel[:, EMB_OFFSET:])
        pad = 16 - emb.shape[1]
        feats = jnp.pad(emb, ((0, 0), (pad, 0), (0, 0)))
        logits = model.module.apply(variables, feats.astype(jnp.bfloat16),
                                    deterministic=True)
        return jax.nn.sigmoid(logits.reshape(-1))

    return jax.jit(forward), bf16_vars, enc_vars


def _mel_bf16(audio):
    """The bulk mel path: hop-DFT in bf16, bf16 out (the bf16 encoder
    casts anyway, so the values are the same at half the traffic)."""
    import jax.numpy as jnp

    from nanowakeword_tpu.ops import mel as melops
    return melops.mel_frontend(audio, compute_dtype=jnp.bfloat16).astype(
        jnp.bfloat16)


def bench_throughput(batch: int = 4096, iters: int = 256) -> float:
    import jax
    import jax.numpy as jnp

    fwd, variables, enc_vars = build_forward()
    rng = np.random.default_rng(0)
    # int16 PCM — the reference pipeline's native dtype (16 kHz int16 wavs)
    audio_host = np.asarray(rng.integers(-16000, 16000, (batch, 16000)),
                            np.int16)
    # Inputs live on device (a production input pipeline double-buffers
    # transfers); iterations are chained by a data dependency inside ONE
    # jitted fori_loop so async dispatch cannot hide work from the timer.
    audio = jax.device_put(audio_host)
    variables = jax.device_put(variables)
    enc_vars = jax.device_put(enc_vars)

    @jax.jit
    def loop(variables, enc_vars, audio):
        def body(_, carry):
            # fold the previous result into the input with a non-zero (but
            # negligible) coupling: a literal *0 gets constant-folded and the
            # whole loop body hoisted as invariant. (1e-30 rounds to 0 in the
            # int16 cast, so the fed values are unchanged — but the data
            # dependency on `carry` is real to XLA.)
            coupled = audio + (carry * jnp.float32(1e-30)).astype(audio.dtype)
            out = fwd(variables, enc_vars, coupled)
            return out.sum().astype(jnp.float32)
        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

    loop(variables, enc_vars, audio).block_until_ready()  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        loop(variables, enc_vars, audio).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return batch * iters / best


def bench_stream_latency(n_frames: int = 200) -> float:
    """p50 latency of one fused 80 ms streaming step (mel+embed+score in a
    single device call — the NanoInterpreter fast path)."""
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import AudioFeatures
    from nanowakeword_tpu.models.model import Model

    config = {"activation_function": "relu", "embedding_dim": 96,
              "crnn_cnn_channels": [16, 32, 32], "crnn_rnn_type": "gru"}
    model = Model(config=config, model_name="bench_stream",
                  input_shape=(16, 96), model_type="crnn",
                  layer_dim=64, n_blocks=2, dropout_prob=0.0)
    af = AudioFeatures()

    def fused(variables, state, chunk):
        new_state = af._stream_step_impl(state, chunk)
        feats = new_state.feat_buf[-16:][None]
        logits = model.module.apply(variables, feats, deterministic=True)
        return new_state, jax.nn.sigmoid(logits.reshape(()))

    step = jax.jit(fused, donate_argnums=(1,))
    rng = np.random.default_rng(0)
    chunk = jnp.asarray(rng.integers(-16000, 16000, 1280).astype(np.float32))

    state = af.state
    for _ in range(4):  # compile + warm
        state, score = step(model.variables, state, chunk)
        score.block_until_ready()

    times = []
    for _ in range(n_frames):
        t0 = time.perf_counter()
        state, score = step(model.variables, state, chunk)
        score.block_until_ready()
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50) * 1000.0)


def bench_on_chip_frame_latency(k_frames: int = 512, reps: int = 5) -> float:
    """On-device per-frame step time: K fused streaming steps chained in
    ONE dispatch (lax.scan over chunks), so the per-dispatch host cost
    amortises to 1/K. The separately-reported p50_stream_frame_latency_ms
    includes one host->device->host round trip per frame."""
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import AudioFeatures
    from nanowakeword_tpu.models.model import Model

    config = {"activation_function": "relu", "embedding_dim": 96,
              "crnn_cnn_channels": [16, 32, 32], "crnn_rnn_type": "gru"}
    model = Model(config=config, model_name="bench_onchip",
                  input_shape=(16, 96), model_type="crnn",
                  layer_dim=64, n_blocks=2, dropout_prob=0.0)
    af = AudioFeatures()

    @jax.jit
    def run_k(variables, state, chunks):
        def body(st, chunk):
            ns = af._stream_step_impl(st, chunk)
            feats = ns.feat_buf[-16:][None]
            logits = model.module.apply(variables, feats, deterministic=True)
            return ns, jax.nn.sigmoid(logits.reshape(()))
        state, scores = jax.lax.scan(body, state, chunks)
        return jnp.sum(scores)

    rng = np.random.default_rng(0)
    chunks = jax.device_put(np.asarray(
        rng.integers(-16000, 16000, (k_frames, 1280)), np.float32))
    variables = jax.device_put(model.variables)
    state = jax.device_put(af.state)

    run_k(variables, state, chunks).block_until_ready()  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run_k(variables, state, chunks).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best / k_frames * 1000.0


def _fetch_timed(fn, *args, iters: int = 256, per_item: int = 1):
    """Chained fori_loop timing (steady state), as in bench_throughput."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def loop(*a):
        def body(_, carry):
            out = fn(*a[:-1], a[-1] + carry * jnp.float32(1e-30))
            return jnp.sum(out).astype(jnp.float32)
        return jax.lax.fori_loop(0, iters, body, jnp.float32(0.0))

    loop(*args).block_until_ready()
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        loop(*args).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return per_item * iters / best


def make_aug_train_step(step_fn, encoder, aug_params, mel_fn=_mel_bf16):
    """The config-3 training chain as one function of the step index:
    augmentation -> mel -> SpecAugment -> encoder -> train step.

    Everything device-resident passes as ARGS (closure-captured arrays get
    baked into the graph as constants). The step index folds into the key:
    with a fixed key the augment->mel->encoder prefix is loop-invariant and
    XLA hoists it out of a chained loop; a real training loop draws fresh
    augmentation every batch."""
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import EMB_OFFSET
    from nanowakeword_tpu.ops.augment import augment_batch, spec_augment

    def train_with_aug(i, st, ev, key_audio, bg_, rirs_, fg_lens_, flags_,
                       no_flags_, labels_):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        # augment_batch returns int16; the mel frontend reads it as is
        aug = augment_batch(key, key_audio, bg_, rirs_, fg_lens_, flags_,
                            no_flags_, aug_params)
        # (no grad flows through mel here — features computed outside step)
        mel = spec_augment(key, mel_fn(aug))
        emb = encoder.apply(ev, mel[:, EMB_OFFSET:])
        f = jnp.pad(emb, ((0, 0), (16 - emb.shape[1], 0), (0, 0)))
        new_state, metrics = step_fn(st, f, labels_)
        return new_state, metrics.loss

    return train_with_aug


def bench_all(batch: int = 2048):
    """The five BASELINE configs, reported as items/sec each."""
    import jax
    import jax.numpy as jnp

    from nanowakeword_tpu.data.features import (EMB_OFFSET,
                                                default_encoder_variables)
    from nanowakeword_tpu.models.embedding import (build_encoder,
                                                   infer_encoder_arch)
    from nanowakeword_tpu.models.model import Model
    from nanowakeword_tpu.ops.augment import AugmentParams
    from nanowakeword_tpu.train.optim import build_optimizer
    from nanowakeword_tpu.train.step import create_train_state, \
        make_train_step

    rng = np.random.default_rng(0)
    results = {}
    base = {"activation_function": "relu", "embedding_dim": 64,
            "crnn_cnn_channels": [16, 32, 32], "crnn_rnn_type": "gru",
            "transformer_d_model": 128, "transformer_n_head": 4,
            "conformer_d_model": 144, "conformer_n_head": 4,
            "quartznet_config": [[256, 33, 1], [256, 33, 1], [512, 39, 1]]}

    def build(mt, **kw):
        return Model(config=dict(base), model_name=f"b_{mt}",
                     input_shape=(16, 96), model_type=mt, layer_dim=64,
                     n_blocks=2, dropout_prob=0.0, **kw)

    _enc_host = default_encoder_variables()
    encoder = build_encoder(infer_encoder_arch(_enc_host),
                            dtype=jnp.bfloat16, precision=None)
    enc_vars = jax.device_put(_enc_host)
    feats16 = jax.device_put(np.asarray(
        rng.normal(size=(batch, 16, 96)), np.float32))
    audio1s = jax.device_put(np.asarray(
        rng.integers(-16000, 16000, (batch, 16000)), np.int16))

    # 1. DNN scoring precomputed features (evaluate_model_with_features path)
    dnn = build("dnn")
    def _emit(k, v):
        results[k] = v
        print(f"{k}: {v:,.1f}", flush=True)

    _emit("dnn_features_scores_per_s", _fetch_timed(
        lambda v, f: jax.nn.sigmoid(dnn.module.apply(v, f,
                                                     deterministic=True)),
        jax.device_put(dnn.variables), feats16, per_item=batch))

    # 2. CNN + GRU end-to-end wav -> score (evaluate_model_with_audio path)
    for mt in ("cnn", "gru"):
        m = build(mt)

        def e2e(v, ev, a, _m=m):
            mel = _mel_bf16(a)
            emb = encoder.apply(ev, mel[:, EMB_OFFSET:])
            f = jnp.pad(emb, ((0, 0), (16 - emb.shape[1], 0), (0, 0)))
            return jax.nn.sigmoid(_m.module.apply(v, f, deterministic=True))

        _emit(f"{mt}_e2e_clips_per_s", _fetch_timed(
            e2e, jax.device_put(m.variables), enc_vars, audio1s,
            per_item=batch))

    # 3. CRNN training step with augmentation (noise mix + SpecAugment)
    crnn = build("crnn")
    tx = build_optimizer({"optimizer_type": "adamw",
                          "learning_rate_max": 1e-3,
                          "lr_scheduler_type": "onecycle"}, 1000)
    state = create_train_state(crnn.module, crnn.variables, tx)
    step = make_train_step(crnn.module, tx, donate=False, jit=False)
    labels = jax.device_put(np.asarray(rng.random(batch) < 0.5, np.float32))
    aug_params = AugmentParams.from_settings({"rir_prob": 0.0})
    bg = jax.device_put(np.asarray(
        rng.integers(-2000, 2000, (batch, 16000)), np.float32))
    rirs = jax.device_put(np.zeros((batch, 1600), np.float32))
    fg_lens = jax.device_put(np.full(batch, 16000, np.int32))
    flags = jax.device_put(np.ones(batch, bool))
    no_flags = jax.device_put(np.zeros(batch, bool))

    state = jax.device_put(state)
    targs = (enc_vars, audio1s, bg, rirs, fg_lens, flags, no_flags, labels)
    # steady-state: chain the steps inside ONE jitted loop (a real training
    # loop never syncs per step)
    n_steps = 16
    # opt-in bf16 mixed-precision variant of the same chain
    # (training.compute_dtype: bfloat16 — f32 masters, bf16 apply)
    step_bf16 = make_train_step(crnn.module, tx, donate=False, jit=False,
                                compute_dtype="bfloat16")

    for metric, step_fn in (("crnn_train_aug_clips_per_s", step),
                            ("crnn_train_aug_bf16_clips_per_s", step_bf16)):
        chain_step = make_aug_train_step(step_fn, encoder, aug_params)

        @jax.jit
        def train_chain(st, *ta, _cs=chain_step):
            def body(i, carry):
                st_, _loss = carry
                return _cs(i, st_, *ta)
            return jax.lax.fori_loop(0, n_steps, body,
                                     (st, jnp.float32(0.0)))

        state2, loss = train_chain(state, *targs)
        loss.block_until_ready()  # compile + warm
        t0 = time.perf_counter()
        _, loss = train_chain(state2, *targs)
        loss.block_until_ready()  # one sync for the whole chain
        _emit(metric, batch * n_steps / (time.perf_counter() - t0))

    # 4. BcResNet + QuartzNet feature-extraction + scoring throughput
    for mt in ("bcresnet", "quartznet"):
        m = build(mt)

        def feat_fwd(v, ev, a, _m=m):
            mel = _mel_bf16(a)
            emb = encoder.apply(ev, mel[:, EMB_OFFSET:])
            f = jnp.pad(emb, ((0, 0), (16 - emb.shape[1], 0), (0, 0)))
            return jax.nn.sigmoid(_m.module.apply(v, f, deterministic=True))

        _emit(f"{mt}_feature_clips_per_s", _fetch_timed(
            feat_fwd, jax.device_put(m.variables), enc_vars, audio1s,
            per_item=batch))

    # 5. Conformer + Transformer stateful frame-by-frame streaming
    from nanowakeword_tpu.data.features import AudioFeatures
    for mt in ("conformer", "transformer"):
        m = build(mt)
        af = AudioFeatures()

        def fused(v, state_, chunk, _m=m):
            ns = af._stream_step_impl(state_, chunk)
            f = ns.feat_buf[-16:][None]
            return ns, jax.nn.sigmoid(
                _m.module.apply(v, f, deterministic=True).reshape(()))

        sstep = jax.jit(fused, donate_argnums=(1,))
        chunk = jnp.asarray(rng.integers(-16000, 16000, 1280)
                            .astype(np.float32))
        st = af.state
        for _ in range(3):
            st, sc = sstep(m.variables, st, chunk)
            sc.block_until_ready()
        times = []
        for _ in range(60):
            t0 = time.perf_counter()
            st, sc = sstep(m.variables, st, chunk)
            sc.block_until_ready()
            times.append(time.perf_counter() - t0)
        _emit(f"{mt}_stream_p50_ms",
              float(np.percentile(times, 50) * 1000))

    return results


def main():
    import jax

    from nanowakeword_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    if "--all" in sys.argv:
        results = bench_all()
        for k, v in results.items():
            print(f"{k:>40}: {v:,.1f}")
        return

    throughput = bench_throughput()
    p50_ms = bench_stream_latency()
    on_chip_ms = bench_on_chip_frame_latency()
    dev = jax.devices()[0]
    result = {
        "metric": "1sec_clips_per_sec_per_device_mel+embed+crnn_forward",
        "value": throughput,
        "unit": "clips/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        # device time per 80 ms frame (K frames chained in one dispatch)
        "on_chip_frame_ms": on_chip_ms,
        # one frame's host -> device -> host round trip
        "p50_stream_frame_latency_ms": p50_ms,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
