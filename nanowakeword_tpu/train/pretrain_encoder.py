"""Speech-embedding encoder pretraining (the framework's frozen-asset recipe).

The reference's model quality rests on a *pretrained* speech-embedding graph
it downloads (`/root/reference/nanowakeword/data/AudioFeatures.py:172-183`,
`interpreter/models/_registry.py:34-47`) but cannot reproduce — the training
recipe for that asset is not part of the reference at all. This module IS the
recipe for ours: a word-classification proxy task over a synthetic
formant-TTS corpus with on-device augmentation, trained end-to-end on the device.

Task design: W pseudo-words (phone sequences sampled to cover the phone
inventory) are synthesized with many "speakers" (f0 / length / noise-scale /
jitter-seed variations), mixed with colored noise at random SNR, pitch- and
gain-perturbed on device, then classified from the mean+max-pooled encoder
embedding. Classifying *which word* was said — invariant to speaker and
noise — forces the embedding to carry exactly the phonetic content a
downstream wake-word head needs. Transfer is measured on words never seen in
pretraining (nearest-centroid identification), which is the property the
bundled asset must have: useful features for arbitrary wake words.

The result is saved as the registry's default asset
(`nanowakeword_tpu/assets/speech_encoder_v4.msgpack`); AudioFeatures and the
training pipeline pick it up automatically (data/features.py).

Run: python -m nanowakeword_tpu.train.pretrain_encoder --out <path>
"""

from __future__ import annotations

import functools
import json
import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from nanowakeword_tpu import nn
import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.models.embedding import (EMBEDDING_DIM,
                                               SpeechEmbeddingEncoder,
                                               build_encoder,
                                               infer_encoder_arch)
from nanowakeword_tpu.ops import mel as melops
from nanowakeword_tpu.ops.augment import AugmentParams, augment_batch
from nanowakeword_tpu.utils.logger import print_info

SR = 16000

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")
DEFAULT_ASSET = os.path.join(ASSET_DIR, "speech_encoder_v4.msgpack")

# Phone inventory for pseudo-word sampling (onsets/nuclei/codas the formant
# synthesizer renders distinctly).
# corpora above this byte size are stored int8 in device memory; None
# derives it from the device (see _clip_int8_bytes)
_CLIP_INT8_BYTES = None


def _clip_int8_bytes() -> float:
    """Half the device's memory: the int16 corpus plus a step's temporaries
    must fit beside it. Unbounded where the device reports no limit."""
    if _CLIP_INT8_BYTES is not None:
        return _CLIP_INT8_BYTES
    from nanowakeword_tpu.utils.devices import device_memory_bytes
    mem = device_memory_bytes()
    return float("inf") if mem is None else mem / 2

_ONSETS = ["B", "D", "G", "K", "P", "T", "M", "N", "L", "R", "S", "SH",
           "F", "V", "Z", "CH", "JH", "W", "Y", "HH", "TH"]
_NUCLEI = ["AA", "AE", "AH", "AO", "EH", "ER", "EY", "IH", "IY", "OW",
           "UW", "AY", "AW", "OY", "UH"]
_CODAS = ["", "N", "M", "NG", "S", "T", "K", "L", "R", "SH", "Z", "D"]


class PretrainConfig(NamedTuple):
    vocab_size: int = 512
    confusable_fraction: float = 0.5   # fraction of vocab that is a
                                       # minimal-pair twin of another word
    variants_per_word: int = 24    # train variants (distinct "speakers")
    heldout_variants: int = 4      # extra variants held out for eval
    clip_samples: int = 24000      # 1.5 s
    noise_clips: int = 240
    rir_clips: int = 64
    batch_size: int = 256
    steps: int = 4000
    encoder_arch: str = "conv4"    # models/embedding.py ENCODER_ARCHS
    peak_lr: float = 2e-3
    weight_decay: float = 1e-4
    warmup_frac: float = 0.05
    seed: int = 10
    channels: str = "union"        # synthesis domain(s) of the corpus:
                                   # "formant" | "resonator" | "union"
                                   # (the *_fx chain stays eval-only)
    companding_prob: float = 0.0   # mu-law codec round-trip augmentation
    bandlimit_prob: float = 0.0    # random lowpass-cutoff augmentation
    contrastive_weight: float = 0.0  # supervised-contrastive auxiliary loss
                                     # on the mean-pooled embedding (0 = off)
    contrastive_temp: float = 0.15   # SupCon temperature
    contrastive_group: int = 4       # variants per word in each batch when
                                     # the contrastive loss is on


def sample_vocab(n_words: int, seed: int = 10,
                 min_syllables: int = 2, max_syllables: int = 3,
                 exclude: Sequence[str] = ()) -> List[str]:
    """Sample n phonetically-distinct pseudo-words (as spellings).

    Words are built syllable-by-syllable from the phone inventory, converted
    to spellings with the reverse G2P, and deduped by their ROUND-TRIP phone
    sequence (the synthesizer re-derives phones from the spelling, so two
    spellings that read back identically are the same acoustic class).
    """
    import random

    from nanowakeword_tpu.data.generator.g2p import (phones_to_word,
                                                     word_to_phones)
    rng = random.Random(seed)
    seen = {tuple(word_to_phones(w)) for w in exclude}
    words: List[str] = []
    attempts = 0
    while len(words) < n_words and attempts < n_words * 60:
        attempts += 1
        phones: List[str] = []
        for _ in range(rng.randint(min_syllables, max_syllables)):
            phones.append(rng.choice(_ONSETS))
            phones.append(rng.choice(_NUCLEI))
            if rng.random() < 0.35:
                coda = rng.choice(_CODAS)
                if coda:
                    phones.append(coda)
        spelling = phones_to_word(phones)
        key = tuple(word_to_phones(spelling))
        if len(key) < 3 or key in seen:
            continue
        seen.add(key)
        words.append(spelling)
    if len(words) < n_words:
        raise RuntimeError(f"could only sample {len(words)} distinct words")
    return words


def sample_training_vocab(vocab_size: int, seed: int = 10,
                          confusable_fraction: float = 0.5) -> List[str]:
    """Training vocabulary with built-in minimal pairs.

    A word-classification proxy over random words teaches coarse phonetic
    separation but saturates before fine discrimination (measured: the
    confusable-pair transfer metric stalls at ~0.73 with a plain 512-word
    vocab). Seeding the vocab with confusable TWINS — for half the base
    words, a second class differing by exactly one confusable phone — makes
    the classifier's job require exactly the property the downstream
    wake-word model needs: telling the wake word from its nearest phonetic
    neighbour (the reference generates such negatives as training DATA;
    here they shape the embedding itself).
    """
    import random

    from nanowakeword_tpu.data.generator.g2p import (CONFUSABLE,
                                                     phones_to_word,
                                                     word_to_phones)
    n_twins = int(vocab_size * confusable_fraction / (1 + confusable_fraction)
                  ) if confusable_fraction > 0 else 0
    n_base = vocab_size - n_twins
    base = sample_vocab(n_base, seed=seed)
    rng = random.Random(seed + 13)
    seen = {tuple(word_to_phones(w)) for w in base}
    twins: List[str] = []
    for word in base:
        if len(twins) >= n_twins:
            break
        phones = word_to_phones(word)
        positions = [i for i, p in enumerate(phones) if p in CONFUSABLE]
        rng.shuffle(positions)
        for pos in positions:
            alt = list(phones)
            alt[pos] = rng.choice(CONFUSABLE[phones[pos]])
            twin = phones_to_word(alt)
            key = tuple(word_to_phones(twin))
            if twin != word and key not in seen and len(key) >= 3:
                seen.add(key)
                twins.append(twin)
                break
    return base + twins


def synthesize_word_variants(word: str, n_variants: int, clip_samples: int,
                             seed: int,
                             channel: str = "formant") -> np.ndarray:
    """[n_variants, clip_samples] int16 clips of one word, varied speakers.

    `channel` selects the synthesis domain: "formant" / "resonator" /
    "harmonic" (three acoustically disjoint renderers —
    tts.formant_synthesize, the Klatt-style tts.resonator_synthesize, and
    the sinusoidal-model tts.harmonic_synthesize), "union" (variants
    alternate formant/resonator), "union3" (all three), or "formant_fx" /
    "resonator_fx" / "harmonic_fx" (the same rendering through the
    EVAL-ONLY telephone-EQ/reverb/soft-clip chain, tts.apply_channel_fx —
    the held-out transfer domain)."""
    import random

    import numpy as _np

    from nanowakeword_tpu.data.generator.tts import (apply_channel_fx,
                                                     cleanup_filter,
                                                     formant_synthesize,
                                                     harmonic_synthesize,
                                                     resonator_synthesize)
    rng = random.Random(seed)
    out = np.zeros((n_variants, clip_samples), np.int16)
    for v in range(n_variants):
        f0 = rng.uniform(85.0, 235.0)
        ls = rng.uniform(0.8, 1.25)
        ns = rng.uniform(0.2, 0.9)
        ch = channel
        if ch == "union":
            ch = "formant" if v % 2 == 0 else "resonator"
        elif ch == "union3":
            ch = ("formant", "resonator", "harmonic")[v % 3]
        if ch.startswith("formant"):
            audio = formant_synthesize(word, length_scale=ls, noise_scale=ns,
                                       f0=f0, seed=seed * 7919 + v)
        elif ch.startswith("harmonic"):
            audio = harmonic_synthesize(
                word, length_scale=ls, noise_scale=ns, f0=f0,
                seed=seed * 7919 + v,
                vtl_scale=rng.uniform(0.82, 1.18))
        else:
            audio = resonator_synthesize(
                word, length_scale=ls, noise_scale=ns, f0=f0,
                seed=seed * 7919 + v,
                vtl_scale=rng.uniform(0.82, 1.18))
        if ch.endswith("_fx"):
            audio = apply_channel_fx(
                audio, _np.random.default_rng(seed * 6007 + v))
        audio = cleanup_filter(audio)[:clip_samples]
        out[v, :len(audio)] = (audio * 32767.0).astype(np.int16)
    return out


def make_noise_pool(n_clips: int, clip_samples: int,
                    seed: int = 10) -> np.ndarray:
    """[n, clip_samples] int16 colored/babble noise for SNR mixing.

    Five kinds cycle: broadband, low-pass rumble, band-passed hiss,
    amplitude-modulated bursts, and BABBLE — overlapping speech from the
    same formant synthesizer, the hardest distractor for a speech encoder
    (it must separate the foreground word from speech-shaped interference,
    not just from stationary noise)."""
    from scipy.signal import butter, lfilter

    rng = np.random.default_rng(seed)
    out = np.zeros((n_clips, clip_samples), np.int16)
    babble_words = None
    for i in range(n_clips):
        kind = i % 5
        white = rng.standard_normal(clip_samples)
        if kind == 0:                         # broadband
            noise = white
        elif kind == 1:                       # low-pass "rumble"
            b, a = butter(2, rng.uniform(300, 1500) / (SR / 2), btype="low")
            noise = lfilter(b, a, white)
        elif kind == 2:                       # band-passed hiss
            lo = rng.uniform(800, 3000)
            hi = lo + rng.uniform(1000, 4000)
            b, a = butter(2, [lo / (SR / 2), min(hi, 7800) / (SR / 2)],
                          btype="band")
            noise = lfilter(b, a, white)
        elif kind == 3:                       # amplitude-modulated bursts
            env = np.clip(np.sin(2 * np.pi * rng.uniform(0.5, 4.0)
                                 * np.arange(clip_samples) / SR)
                          + rng.uniform(-0.3, 0.7), 0, None)
            b, a = butter(2, rng.uniform(1000, 6000) / (SR / 2), btype="low")
            noise = lfilter(b, a, white) * env
        else:                                 # babble (overlapped speech)
            from nanowakeword_tpu.data.generator.tts import formant_synthesize
            if babble_words is None:
                babble_words = sample_vocab(16, seed=seed + 555)
            noise = np.zeros(clip_samples)
            for j in range(rng.integers(3, 6)):
                w = babble_words[rng.integers(len(babble_words))]
                talk = formant_synthesize(
                    w, length_scale=rng.uniform(0.9, 1.2),
                    noise_scale=rng.uniform(0.3, 0.7),
                    f0=rng.uniform(90.0, 220.0),
                    seed=int(seed * 31 + i * 97 + j))
                off = rng.integers(0, max(clip_samples - len(talk), 1))
                seg = talk[:clip_samples - off]
                noise[off:off + len(seg)] += seg * rng.uniform(0.4, 1.0)
        peak = np.abs(noise).max()
        if peak > 0:
            noise = noise / peak * rng.uniform(0.3, 0.9)
        out[i] = (noise * 32767.0).astype(np.int16)
    return out


def make_rir_pool(n_rirs: int, rir_len: int = 2400,
                  seed: int = 10) -> np.ndarray:
    """[n, rir_len] float32 synthetic room impulse responses.

    Direct path + exponentially decaying noise tail (image-method shape),
    random decay time 40-150 ms and direct-to-reverberant ratio — enough
    reverb diversity to make the embedding robust to rooms without real RIR
    recordings (none are available offline)."""
    rng = np.random.default_rng(seed)
    t = np.arange(rir_len) / SR
    out = np.zeros((n_rirs, rir_len), np.float32)
    for i in range(n_rirs):
        rt = rng.uniform(0.04, 0.15)          # tail decay constant (s)
        tail = rng.standard_normal(rir_len) * np.exp(-3.0 * t / rt)
        tail[0] = 0.0
        drr = rng.uniform(1.5, 6.0)           # direct-to-reverb amplitude
        rir = tail / max(np.abs(tail).max(), 1e-9)
        rir[0] = drr
        out[i] = (rir / np.abs(rir).max()).astype(np.float32)
    return out


def build_corpus(config: PretrainConfig,
                 cache_path: Optional[str] = None,
                 verbose: bool = True) -> Dict[str, np.ndarray]:
    """Synthesize (or load cached) pretraining corpus.

    Returns dict with: clips [N, L] int16, labels [N] int32,
    heldout_clips/heldout_labels (unseen variants of seen words),
    noise [M, L] int16, words (object array of spellings).
    """
    if cache_path and os.path.exists(cache_path):
        data = dict(np.load(cache_path, allow_pickle=True))
        if ("rirs" in data and int(data["clips"].shape[0])
                == config.vocab_size * config.variants_per_word):
            if verbose:
                print_info(f"Loaded pretraining corpus from {cache_path}")
            return data
        # Refuse to clobber a mismatched cache: re-synthesizing would
        # OVERWRITE the existing corpus at this path, which may be hours
        # of synthesis for a different --vocab/--variants setting.
        raise ValueError(
            f"corpus cache {cache_path} holds "
            f"{int(data['clips'].shape[0])} clips but the requested config "
            f"needs {config.vocab_size * config.variants_per_word} "
            f"(vocab_size={config.vocab_size} x variants_per_word="
            f"{config.variants_per_word}); pass a different --cache path "
            "or delete the file to re-synthesize")

    words = sample_training_vocab(
        config.vocab_size, seed=config.seed,
        confusable_fraction=config.confusable_fraction)
    n_total = config.variants_per_word + config.heldout_variants
    clips, labels, ho_clips, ho_labels = [], [], [], []
    t0 = time.time()
    for w, word in enumerate(words):
        var = synthesize_word_variants(word, n_total, config.clip_samples,
                                       seed=config.seed + w * 1031,
                                       channel=config.channels)
        clips.append(var[:config.variants_per_word])
        labels.extend([w] * config.variants_per_word)
        ho_clips.append(var[config.variants_per_word:])
        ho_labels.extend([w] * config.heldout_variants)
        if verbose and (w + 1) % 64 == 0:
            print_info(f"  synthesized {w + 1}/{len(words)} words "
                       f"({time.time() - t0:.0f}s)")
    data = {
        "clips": np.concatenate(clips),
        "labels": np.asarray(labels, np.int32),
        "heldout_clips": np.concatenate(ho_clips),
        "heldout_labels": np.asarray(ho_labels, np.int32),
        "noise": make_noise_pool(config.noise_clips, config.clip_samples,
                                 seed=config.seed + 77),
        "rirs": make_rir_pool(config.rir_clips, seed=config.seed + 177),
        "words": np.asarray(words, object),
    }
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, **data)
        if verbose:
            print_info(f"Cached pretraining corpus at {cache_path}")
    return data


class EncoderPretrainModule(nn.Module):
    """audio [B, L] (int16 scale) -> word logits [B, vocab_size].

    The encoder submodule is named "encoder" so its variables lift out
    directly as the deployable asset (same numerics as inference:
    bf16 mel frontend, f32/HIGH-precision encoder).
    """

    vocab_size: int
    encoder_arch: str = "conv4"

    @nn.compact
    def __call__(self, audio: jnp.ndarray,
                 return_embedding: bool = False):
        from nanowakeword_tpu.data.features import EMB_OFFSET
        mel = melops.mel_frontend(audio, compute_dtype=jnp.bfloat16)
        emb = build_encoder(self.encoder_arch,
                            name="encoder")(mel[:, EMB_OFFSET:])
        pooled = jnp.concatenate([emb.mean(axis=1), emb.max(axis=1)], axis=-1)
        logits = nn.Dense(self.vocab_size, name="word_head")(pooled)
        if return_embedding:
            # the mean-pooled 96-d vector — the SAME space the downstream
            # centroid/cosine transfer metrics (and enrolment) operate in
            return logits, emb.mean(axis=1)
        return logits


def supcon_loss(z: jnp.ndarray, labels: jnp.ndarray,
                temperature: float = 0.15) -> jnp.ndarray:
    """Supervised-contrastive loss (Khosla et al. 2020) over embeddings.

    Pulls same-word embeddings together and pushes different words apart in
    cosine space — the exact geometry the downstream transfer metrics
    (nearest-centroid, minimal-pair discrimination) measure. With a batch
    sampled as P words x K variants, positives pair the SAME word across
    different speakers, augmentations, and synthesis CHANNELS, so the term
    explicitly optimizes channel invariance that the word-classifier CE can
    leave to the head.
    """
    z = z / jnp.maximum(jnp.linalg.norm(z, axis=-1, keepdims=True), 1e-6)
    sim = (z @ z.T) / temperature
    n = z.shape[0]
    eye = jnp.eye(n, dtype=bool)
    pos = (labels[:, None] == labels[None, :]) & ~eye
    sim = jnp.where(eye, -1e9, sim)            # anchors never pair with self
    log_prob = sim - jax.nn.logsumexp(sim, axis=1, keepdims=True)
    per_anchor = -(jnp.where(pos, log_prob, 0.0).sum(axis=1)
                   / jnp.maximum(pos.sum(axis=1), 1))
    # anchors with no positive in the batch contribute 0
    return per_anchor.mean()


def extract_encoder_variables(pretrain_variables) -> dict:
    """Pretrain-module variables -> SpeechEmbeddingEncoder variables."""
    out = {}
    for coll, sub in pretrain_variables.items():
        if "encoder" in sub:
            out[coll] = sub["encoder"]
    return out


def _pretrain_augment_params(
        config: PretrainConfig = PretrainConfig()) -> AugmentParams:
    return AugmentParams(
        rir_prob=0.25, gain_prob=0.5, pitch_prob=0.3,
        min_pitch=-1.5, max_pitch=1.5,
        min_snr=3.0, max_snr=25.0,
        min_gain=-6.0, max_gain=6.0,
        min_volume=0.4, max_volume=1.0,
        eq_prob=0.5,   # random channel EQ: close the gap to unseen channels
        # channel-robustness pair (off by default): mu-law codec round-trip
        # + random lowpass band-limit — linear+nonlinear distortion families
        # DISTINCT from the eval-only telephone-fx chain
        companding_prob=config.companding_prob,
        bandlimit_prob=config.bandlimit_prob)


def _find_latest_pretrain_ckpt(ckpt_dir: str) -> Optional[str]:
    import re
    if not os.path.isdir(ckpt_dir):
        return None
    best_step, best = -1, None
    for f in os.listdir(ckpt_dir):
        m = re.match(r"pretrain_step_(\d+)\.pkl$", f)
        if m and int(m.group(1)) > best_step:
            best_step, best = int(m.group(1)), f
    return os.path.join(ckpt_dir, best) if best else None


def pretrain_encoder(config: PretrainConfig = PretrainConfig(),
                     corpus: Optional[Dict[str, np.ndarray]] = None,
                     cache_path: Optional[str] = None,
                     log_every: int = 100,
                     verbose: bool = True,
                     checkpoint_dir: Optional[str] = None,
                     checkpoint_every: int = 1000,
                     resume: bool = False) -> Tuple[dict, dict]:
    """Train the encoder on the word-classification proxy task.

    Returns (encoder_variables, report). All clips live in device memory;
    each jitted step samples a batch, augments, and takes one optimizer step
    entirely on device — the host only fetches metrics every `log_every`.

    Durable checkpoints (crash-safety parity with the classifier loop,
    reference contract train_model.py:682-712): with `checkpoint_dir` set,
    (step, params, opt_state, loop key) is pickled every `checkpoint_every`
    steps; `resume=True` restores the newest and continues bit-exactly —
    the corpus is deterministic given the config/cache and batch sampling
    is driven solely by the restored key.
    """
    import optax
    import pickle

    if corpus is None:
        corpus = build_corpus(config, cache_path=cache_path, verbose=verbose)
    # Device residency: the whole corpus lives in device memory so every
    # step is a pure on-device gather (no host feed). A corpus above half
    # the device's memory leaves too little for the step's temporaries, so
    # it is stored as int8 (value/256, exact x256 dequant in-step).
    # Quantization noise is -48 dB relative to full scale — ~35 dB below
    # the SNR-mixed augmentation noise floor, negligible.
    limit = _clip_int8_bytes()
    clip_store_bits = 8 if corpus["clips"].nbytes > limit else 16
    if clip_store_bits == 8:
        if verbose:
            print_info(f"  corpus clips {corpus['clips'].nbytes / 2**30:.1f}"
                       f" GiB > {limit / 2**30:.1f} GiB: storing int8 on "
                       "device (x256 dequant)")
        q = np.empty(corpus["clips"].shape, np.int8)
        chunk = 16384
        for i in range(0, len(q), chunk):    # bound the int32 temp
            blk = corpus["clips"][i:i + chunk].astype(np.int32)
            np.clip((blk + 128) >> 8, -128, 127, out=blk)
            q[i:i + chunk] = blk.astype(np.int8)
        clips = jnp.asarray(q)                # [N, L] int8, on device
    else:
        clips = jnp.asarray(corpus["clips"])  # [N, L] int16, on device
    labels = jnp.asarray(corpus["labels"])        # [N] int32
    noise = jnp.asarray(corpus["noise"])          # [M, L] int16
    rirs = jnp.asarray(corpus.get(
        "rirs", np.zeros((1, 1), np.float32)))    # [R, len] float32
    use_rir = "rirs" in corpus and corpus["rirs"].shape[-1] > 1
    n_clips, clip_len = clips.shape
    vocab = int(labels.max()) + 1
    if config.contrastive_weight > 0.0 \
            and config.batch_size % config.contrastive_group:
        raise ValueError("batch_size must be divisible by contrastive_group")

    module = EncoderPretrainModule(vocab_size=vocab,
                                   encoder_arch=config.encoder_arch)
    variables = module.init(jax.random.PRNGKey(config.seed),
                            jnp.zeros((1, clip_len), jnp.float32))
    params = variables["params"]

    warmup = max(int(config.steps * config.warmup_frac), 1)
    schedule = optax.warmup_cosine_decay_schedule(
        0.0, config.peak_lr, warmup, max(config.steps, warmup + 1))
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(schedule, weight_decay=config.weight_decay))
    opt_state = tx.init(params)
    aug_params = _pretrain_augment_params(config)
    if not use_rir:
        aug_params = aug_params._replace(rir_prob=0.0)

    # corpus arrays are passed as jit ARGS, never closed over: closure-
    # captured device arrays become graph constants and the whole 350 MB
    # corpus would be shipped inside the compile request
    use_supcon = config.contrastive_weight > 0.0

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, key, clips, labels, noise, rirs):
        k_idx, k_noise, k_rir, k_aug = jax.random.split(key, 4)
        if use_supcon:
            # P words x K variants so every anchor has in-batch positives
            # (same word, different speaker/augmentation/channel)
            k_w, k_v = jax.random.split(k_idx)
            n_group = config.contrastive_group
            n_words_b = config.batch_size // n_group
            w_ids = jax.random.randint(k_w, (n_words_b,), 0,
                                       n_clips // config.variants_per_word)
            v_ids = jax.random.randint(k_v, (n_words_b, n_group), 0,
                                       config.variants_per_word)
            idx = (w_ids[:, None] * config.variants_per_word
                   + v_ids).reshape(-1)
        else:
            idx = jax.random.randint(k_idx, (config.batch_size,), 0, n_clips)
        nidx = jax.random.randint(k_noise, (config.batch_size,), 0,
                                  noise.shape[0])
        ridx = jax.random.randint(k_rir, (config.batch_size,), 0,
                                  rirs.shape[0])
        fg = jnp.take(clips, idx, axis=0)
        if clip_store_bits == 8:
            # exact dequant: values are multiples of 256, max 127*256=32512
            fg = fg.astype(jnp.int16) * jnp.int16(256)
        bg = jnp.take(noise, nidx, axis=0)
        rir = jnp.take(rirs, ridx, axis=0)
        y = jnp.take(labels, idx, axis=0)
        fg_lens = jnp.full((config.batch_size,), clip_len, jnp.int32)
        flags = jnp.ones((config.batch_size,), bool)
        audio = augment_batch(k_aug, fg, bg, rir,
                              fg_lens, flags, flags,
                              aug_params).astype(jnp.float32)

        def loss_fn(p):
            if use_supcon:
                logits, z = module.apply({"params": p}, audio,
                                         return_embedding=True)
                ce = optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean()
                loss = ce + config.contrastive_weight * supcon_loss(
                    z, y, config.contrastive_temp)
            else:
                logits = module.apply({"params": p}, audio)
                loss = optax.softmax_cross_entropy_with_integer_labels(
                    logits, y).mean()
            acc = (logits.argmax(-1) == y).mean()
            return loss, acc

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jnp.stack([loss, acc])

    key = jax.random.PRNGKey(config.seed + 1)
    start_step = 0
    if checkpoint_dir and resume:
        latest = _find_latest_pretrain_ckpt(checkpoint_dir)
        if latest:
            with open(latest, "rb") as f:
                ck = pickle.load(f)
            params = jax.tree_util.tree_map(jnp.asarray, ck["params"])
            opt_state = jax.tree_util.tree_map(
                lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x,
                ck["opt_state"])
            key = jnp.asarray(ck["key"])
            start_step = int(ck["step"])
            if verbose:
                print_info(f"  resuming pretraining from {latest} "
                           f"(step {start_step})")

    def _save_ckpt(done_steps):
        os.makedirs(checkpoint_dir, exist_ok=True)
        payload = {
            "step": done_steps,
            "params": jax.device_get(params),
            "opt_state": jax.device_get(opt_state),
            "key": np.asarray(key),
        }
        path = os.path.join(checkpoint_dir,
                            f"pretrain_step_{done_steps}.pkl")
        with open(path, "wb") as f:
            pickle.dump(payload, f)
        keep = sorted((f for f in os.listdir(checkpoint_dir)
                       if f.startswith("pretrain_step_")),
                      key=lambda f: int(f.split("_")[-1].split(".")[0]))
        for victim in keep[:-2]:
            os.remove(os.path.join(checkpoint_dir, victim))

    t0 = time.time()
    metrics = None
    for i in range(start_step, config.steps):
        key, sub = jax.random.split(key)
        params, opt_state, metrics = step(params, opt_state, sub,
                                          clips, labels, noise, rirs)
        if verbose and ((i + 1) % log_every == 0 or i + 1 == config.steps):
            m = np.asarray(metrics)   # device fetch = the only sync point
            done = i + 1 - start_step
            print_info(f"  pretrain step {i + 1}/{config.steps} "
                       f"loss={m[0]:.4f} acc={m[1]:.3f} "
                       f"({done / (time.time() - t0):.1f} steps/s)")
        if checkpoint_dir and (i + 1) % checkpoint_every == 0 \
                and i + 1 < config.steps:
            _save_ckpt(i + 1)
    final = np.asarray(metrics) if metrics is not None else np.zeros(2)

    full_vars = {"params": jax.device_get(params)}
    enc_vars = extract_encoder_variables(full_vars)

    # held-out variants of TRAINING words through the full classifier
    eval_fn = jax.jit(lambda p, a: module.apply({"params": p}, a).argmax(-1))
    ho, ho_y = corpus["heldout_clips"], corpus["heldout_labels"]
    correct = total = 0
    for i in range(0, len(ho), config.batch_size):
        batch = np.asarray(ho[i:i + config.batch_size], np.float32)
        pred = np.asarray(eval_fn(params, jnp.asarray(batch)))
        correct += int((pred == ho_y[i:i + config.batch_size]).sum())
        total += len(batch)

    report = {
        "vocab_size": vocab,
        "train_clips": int(n_clips),
        "steps": int(config.steps),
        "final_train_loss": float(final[0]),
        "final_train_acc": float(final[1]),
        "heldout_variant_acc": correct / max(total, 1),
        "wall_seconds": round(time.time() - t0, 1),
    }
    if verbose:
        print_info(f"Pretraining done: {json.dumps(report)}")
    return enc_vars, report


def centroid_word_accuracy(encoder_variables, words: Sequence[str],
                           n_enroll: int = 3, n_test: int = 3,
                           clip_samples: int = 24000,
                           seed: int = 9001,
                           channel: str = "formant") -> float:
    """Transfer metric: identify UNSEEN words by nearest embedding centroid.

    Synthesizes n_enroll + n_test speaker-variants per word, mean-pools the
    encoder embedding per clip, builds per-word centroids from the enroll
    split, and classifies the test split by cosine-nearest centroid. A good
    speech embedding separates words it never saw; a random-init encoder
    performs near chance (tests/test_pretrained_encoder.py relies on this).
    """
    encoder = build_encoder(infer_encoder_arch(encoder_variables))

    @jax.jit
    def embed(audio):
        from nanowakeword_tpu.data.features import EMB_OFFSET
        mel = melops.mel_frontend(audio, compute_dtype=jnp.bfloat16)
        emb = encoder.apply(encoder_variables, mel[:, EMB_OFFSET:])
        return emb.mean(axis=1)

    n_var = n_enroll + n_test
    all_clips = np.concatenate([
        synthesize_word_variants(w, n_var, clip_samples, seed=seed + 31 * i,
                                 channel=channel)
        for i, w in enumerate(words)]).astype(np.float32)
    vecs = np.asarray(embed(jnp.asarray(all_clips)))
    vecs = vecs / np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True),
                             1e-8)
    vecs = vecs.reshape(len(words), n_var, EMBEDDING_DIM)

    centroids = vecs[:, :n_enroll].mean(axis=1)
    centroids /= np.maximum(np.linalg.norm(centroids, axis=-1,
                                           keepdims=True), 1e-8)
    test = vecs[:, n_enroll:].reshape(-1, EMBEDDING_DIM)
    pred = (test @ centroids.T).argmax(axis=-1)
    truth = np.repeat(np.arange(len(words)), n_test)
    return float((pred == truth).mean())


def make_confusable_pairs(n_pairs: int, seed: int = 9002,
                          exclude: Sequence[str] = ()) -> List[Tuple[str, str]]:
    """Sample word pairs that differ by ONE acoustically-confusable phone.

    Uses the adversarial generator's confusability map (g2p.CONFUSABLE, the
    same groups the phoneme-adversarial negatives are built from): each pair
    is a minimal pair a wake-word model must discriminate — e.g. the
    difference between the wake word and its hardest false-alarm trigger."""
    import random

    from nanowakeword_tpu.data.generator.g2p import (CONFUSABLE,
                                                     phones_to_word,
                                                     word_to_phones)
    rng = random.Random(seed)
    base_words = sample_vocab(n_pairs * 3, seed=seed, exclude=exclude)
    pairs: List[Tuple[str, str]] = []
    for word in base_words:
        if len(pairs) >= n_pairs:
            break
        phones = word_to_phones(word)
        positions = [i for i, p in enumerate(phones) if p in CONFUSABLE]
        rng.shuffle(positions)
        for pos in positions:
            alt = list(phones)
            alt[pos] = rng.choice(CONFUSABLE[phones[pos]])
            twin = phones_to_word(alt)
            # the twin must round-trip to different phones than the original
            # (same spelling or same read-back == same acoustic class)
            if twin != word and word_to_phones(twin) != phones:
                pairs.append((word, twin))
                break
    return pairs


def confusable_pair_accuracy(encoder_variables,
                             pairs: Sequence[Tuple[str, str]],
                             n_enroll: int = 3, n_test: int = 3,
                             clip_samples: int = 24000,
                             seed: int = 9003,
                             channel: str = "formant") -> float:
    """Transfer metric #2 (the HARD one): two-way discrimination of unseen
    minimal pairs differing by a single confusable phone.

    For each pair, both words are enrolled by centroid and each test clip is
    classified between the TWO centroids only. Chance = 0.5; whole-word
    centroid identification (centroid_word_accuracy) saturates long before
    this does, because here every distractor is maximally close."""
    encoder = build_encoder(infer_encoder_arch(encoder_variables))

    @jax.jit
    def embed(audio):
        from nanowakeword_tpu.data.features import EMB_OFFSET
        mel = melops.mel_frontend(audio, compute_dtype=jnp.bfloat16)
        emb = encoder.apply(encoder_variables, mel[:, EMB_OFFSET:])
        return emb.mean(axis=1)

    n_var = n_enroll + n_test
    words = [w for pair in pairs for w in pair]
    all_clips = np.concatenate([
        synthesize_word_variants(w, n_var, clip_samples, seed=seed + 37 * i,
                                 channel=channel)
        for i, w in enumerate(words)]).astype(np.float32)
    vecs = np.array(embed(jnp.asarray(all_clips)))
    vecs /= np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-8)
    vecs = vecs.reshape(len(pairs), 2, n_var, EMBEDDING_DIM)

    centroids = vecs[:, :, :n_enroll].mean(axis=2)       # [P, 2, E]
    centroids /= np.maximum(
        np.linalg.norm(centroids, axis=-1, keepdims=True), 1e-8)
    test = vecs[:, :, n_enroll:]                         # [P, 2, n_test, E]
    # cosine of each test clip against both centroids of ITS pair
    sims = np.einsum("pwte,pce->pwtc", test, centroids)  # [P, 2, n_test, 2]
    pred = sims.argmax(axis=-1)
    truth = np.broadcast_to(np.arange(2)[None, :, None], pred.shape)
    return float((pred == truth).mean())


def save_encoder_asset(encoder_variables, path: str = DEFAULT_ASSET,
                       meta: Optional[dict] = None) -> str:
    """Serialize encoder variables (+ JSON sidecar) as a registry asset."""
    from nanowakeword_tpu import serialization
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    as_np = jax.tree_util.tree_map(np.asarray, encoder_variables)
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(as_np))
    with open(path + ".json", "w") as f:
        json.dump(meta or {}, f, indent=1)
    print_info(f"Saved encoder asset to {path}")
    return path


def evaluate_transfer(enc_vars, train_words: Sequence[str],
                      n_words: int = 24, n_pairs: int = 24,
                      with_random_baseline: bool = True,
                      cross_channel: bool = True,
                      verbose: bool = True) -> dict:
    """The full transfer report: unseen-word centroid identification plus
    confusable minimal-pair discrimination, each against a random-init
    encoder baseline (the quality gates tests/test_pretrained_encoder.py
    enforces on the shipped asset).

    With `cross_channel`, the same metrics are ALSO computed on the
    resonator synthesis channel and on the telephone-EQ/reverb/clip fx
    chain. Which of those are held-out depends on the training config:
    for the shipped union-trained asset the resonator numbers are
    IN-domain (it trains on both channels) and only the `*_fx` numbers
    measure never-trained-domain transfer (VERDICT r2 #1 — the fx chain
    is excluded from training by construction). For a `--channels formant`
    run the resonator numbers are cross-domain too."""
    transfer_words = sample_vocab(n_words, seed=424242, exclude=train_words)
    pairs = make_confusable_pairs(n_pairs, seed=515151, exclude=train_words)
    report = {
        "unseen_word_centroid_acc":
            centroid_word_accuracy(enc_vars, transfer_words),
        "confusable_pair_acc":
            confusable_pair_accuracy(enc_vars, pairs),
        "n_transfer_words": len(transfer_words),
        "n_confusable_pairs": len(pairs),
    }
    if cross_channel:
        report["resonator_centroid_acc"] = centroid_word_accuracy(
            enc_vars, transfer_words, channel="resonator")
        report["resonator_pair_acc"] = confusable_pair_accuracy(
            enc_vars, pairs, channel="resonator")
        # the sinusoidal-model channel: held-out for union/formant/resonator
        # training configs, in-domain for union3 (round-4 channel axis)
        report["harmonic_centroid_acc"] = centroid_word_accuracy(
            enc_vars, transfer_words, channel="harmonic")
        report["harmonic_pair_acc"] = confusable_pair_accuracy(
            enc_vars, pairs, channel="harmonic")
        # the *_fx chain is NEVER trained on — the true held-out domain
        # (definition kept STABLE across rounds — mean of formant_fx and
        # resonator_fx — so ladder scores stay comparable to v3-v8)
        report["heldout_fx_centroid_acc"] = float(np.mean([
            centroid_word_accuracy(enc_vars, transfer_words,
                                   channel="formant_fx"),
            centroid_word_accuracy(enc_vars, transfer_words,
                                   channel="resonator_fx")]))
        report["heldout_fx_pair_acc"] = float(np.mean([
            confusable_pair_accuracy(enc_vars, pairs, channel="formant_fx"),
            confusable_pair_accuracy(enc_vars, pairs,
                                     channel="resonator_fx")]))
    if with_random_baseline:
        from nanowakeword_tpu.models.embedding import EMB_WINDOW
        rand = build_encoder(infer_encoder_arch(enc_vars)).init(
            jax.random.PRNGKey(10), jnp.zeros((1, EMB_WINDOW, 32)))
        report["random_encoder_centroid_acc"] = centroid_word_accuracy(
            rand, transfer_words)
        report["random_encoder_pair_acc"] = confusable_pair_accuracy(
            rand, pairs)
    if verbose:
        print_info("Transfer eval: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in report.items()}))
    return report


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(description="Pretrain the speech encoder")
    p.add_argument("--out", default=DEFAULT_ASSET)
    p.add_argument("--steps", type=int, default=PretrainConfig().steps)
    p.add_argument("--vocab", type=int, default=PretrainConfig().vocab_size)
    p.add_argument("--variants", type=int,
                   default=PretrainConfig().variants_per_word)
    p.add_argument("--batch", type=int, default=PretrainConfig().batch_size)
    p.add_argument("--arch", default=PretrainConfig().encoder_arch,
                   help="encoder architecture id (conv4 | wide128 | "
                        "wide256)")
    p.add_argument("--cache", default=None,
                   help="corpus .npz cache path (skips re-synthesis)")
    p.add_argument("--channels", default=PretrainConfig().channels,
                   choices=["formant", "resonator", "harmonic", "union",
                            "union3"],
                   help="synthesis channel(s) for the training corpus")
    p.add_argument("--channel-robust", type=float, default=0.0,
                   metavar="P", help="probability for the mu-law codec and "
                   "random-bandlimit augmentations (0 disables)")
    p.add_argument("--contrastive", type=float, default=0.0, metavar="W",
                   help="weight of the supervised-contrastive auxiliary "
                        "loss on the pooled embedding (0 disables; batches "
                        "then sample P words x 4 variants)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="durable checkpoint dir (enables crash-safety)")
    p.add_argument("--checkpoint-every", type=int, default=1000)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in "
                        "--checkpoint-dir")
    args = p.parse_args(argv)

    config = PretrainConfig(vocab_size=args.vocab,
                            variants_per_word=args.variants,
                            batch_size=args.batch, steps=args.steps,
                            encoder_arch=args.arch, channels=args.channels,
                            companding_prob=args.channel_robust,
                            bandlimit_prob=args.channel_robust,
                            contrastive_weight=args.contrastive)
    enc_vars, report = pretrain_encoder(
        config, cache_path=args.cache,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume)

    train_words = [str(w) for w in build_corpus(
        config, cache_path=args.cache, verbose=False)["words"]]
    report.update(evaluate_transfer(enc_vars, train_words))
    report["encoder_arch"] = config.encoder_arch
    report["channels"] = config.channels
    channel_desc = {"formant": "formant-synthesized",
                    "resonator": "resonator-synthesized",
                    "harmonic": "sinusoidal-model synthesized",
                    "union": "formant+resonator (union of two disjoint "
                             "synthesis channels)",
                    "union3": "formant+resonator+harmonic (union of three "
                              "disjoint synthesis channels)"}[config.channels]
    robust = ""
    if config.companding_prob > 0 or config.bandlimit_prob > 0:
        robust = (f", mu-law codec round-trip p={config.companding_prob}, "
                  f"random-cutoff lowpass p={config.bandlimit_prob}")
    if config.contrastive_weight > 0:
        robust += (f", supervised-contrastive aux loss w="
                   f"{config.contrastive_weight} T={config.contrastive_temp}"
                   f" (P x {config.contrastive_group}-variant batches)")
    report["recipe"] = (
        f"word-classification proxy on {config.vocab_size} {channel_desc} "
        f"pseudo-words ({config.confusable_fraction:.0%} confusable "
        f"minimal-pair twins) x {config.variants_per_word} speakers; SNR "
        "3-25dB colored+babble noise, synthetic-RIR reverb p=0.25, pitch "
        f"+-1.5st, gain +-6dB, random 3-tap channel EQ p=0.5{robust}; adamw "
        f"warmup-cosine; {config.encoder_arch} encoder; the telephone-EQ/"
        "reverb/clip fx chain is NEVER trained on (held-out eval domain)")
    save_encoder_asset(enc_vars, args.out, meta=report)


if __name__ == "__main__":
    main()
