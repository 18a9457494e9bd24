"""On-device audio augmentation: SNR mixing, gain, pitch/speed, RIR, volume.

Parity target: the augmentation semantics of
`/root/reference/nanowakeword/data/augment_clips.py` — `_mix_snr` with RMS
floors (`:45-79`), random foreground placement (`:218-231`), Gain p=1.0,
PitchShift p=0.5 ±2 st, optional ApplyImpulseResponse p=0.5 (`:150-158`),
peak-normalised random volume in [0.5, 1.0] (`:246-255`), clamp -> int16.

Design: the reference runs torch_audiomentations module-by-module with
host round-trips; here the whole chain is ONE jitted, vmapped
function over the batch with explicit PRNG keys — fixed shapes, no host sync,
fusible by XLA. RIR is FFT convolution. Pitch shift is resampling-based
(pitch and tempo move together): unlike a phase vocoder it is fully static-
shape and artifact-free, and tempo variation is itself a useful speech
augmentation. SpecAugment (time/freq masking on mel) is provided as a new
capability for the training path.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

EPS = 1.19209e-07          # float32 eps, matches torch.finfo(float32).eps
MIN_BG_RMS = 0.005         # augment_clips.py:62
MIN_FG_RMS = 0.01          # -40 dBFS floor, augment_clips.py:73
INT16_MAX = 32767.0

DEFAULT_SETTINGS = {
    "rir_prob": 0.5, "gain_prob": 1.0, "pitch_prob": 0.5,
    "min_pitch_semitones": -2.0, "max_pitch_semitones": 2.0,
    "max_snr_in_db": 30.0, "min_snr_in_db": 5.0,
    "min_gain_in_db": -3.0, "max_gain_in_db": 3.0,
    "min_volume_augmentation": 0.5, "max_volume_augmentation": 1.0,
    "eq_prob": 0.0,   # random 3-tap channel EQ (off by default: reference
                      # parity; the encoder-pretraining recipe enables it)
    "companding_prob": 0.0,   # mu-law 8-bit codec round-trip
    "bandlimit_prob": 0.0,    # random windowed-sinc lowpass
}


def _rms(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.mean(x * x) + EPS)


def _shift_right(x: jnp.ndarray, offset: jnp.ndarray,
                 block_aligned: bool = False) -> jnp.ndarray:
    """Zero-filled right shift of a 1-D vector by a TRACED offset, exact.

    The shift is a two-stage one-hot contraction instead of a `jnp.roll`
    with a traced shift: decompose offset = q*BLK + r, shift whole
    BLK-sample blocks with a [NB, NB] one-hot dot, then shift the
    remainder r in-block with two [BLK, BLK] banded one-hot dots against
    the block rows and their predecessors. HIGHEST-precision dots with
    one-hot {0,1} operands reproduce the roll path bit-exactly. Whether
    this beats a plain roll or `dynamic_slice` on the current device has
    not been measured.

    With `block_aligned` (static) the caller guarantees offset % 128 == 0
    and the fine stage — two of the three dots — is skipped entirely.
    """
    n = x.shape[-1]
    blk = 128 if n % 128 == 0 else (32 if n % 32 == 0 else 0)
    if blk == 0:  # odd lengths: the original roll + front mask
        idx = jnp.arange(n)
        return jnp.where(idx >= offset, jnp.roll(x, offset), 0.0)
    nb = n // blk
    q, r = offset // blk, offset % blk
    blocks = x.reshape(nb, blk)
    ii = jnp.arange(nb)
    # Per-operand precision: the DATA side is exact (HIGHEST); the one-hot
    # side is {0,1}, exact at any precision (DEFAULT). Result is
    # bit-identical to HIGHEST-both: each output is a plain selection of
    # one f32 input.
    p_data_onehot = (jax.lax.Precision.HIGHEST, jax.lax.Precision.DEFAULT)
    p_onehot_data = (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGHEST)
    sel = (ii[:, None] - q == ii[None, :]).astype(x.dtype)      # [out, in]
    y = jax.lax.dot(sel, blocks, precision=p_onehot_data)
    if block_aligned and blk == 128:
        return y.reshape(n)
    z = jnp.concatenate([jnp.zeros((1, blk), x.dtype), y[:-1]])
    a = jnp.arange(blk)
    low = (a[:, None] + r == a[None, :]).astype(x.dtype)        # [in, out]
    upp = (a[:, None] - blk + r == a[None, :]).astype(x.dtype)
    out = (jax.lax.dot(y, low, precision=p_data_onehot)
           + jax.lax.dot(z, upp, precision=p_data_onehot))
    return out.reshape(n)


def mix_snr(fg: jnp.ndarray, bg: jnp.ndarray, offset: jnp.ndarray,
            snr_db: jnp.ndarray, has_bg: jnp.ndarray,
            block_aligned: bool = False) -> jnp.ndarray:
    """Place fg into bg at `offset` with the given SNR (floats in [-1, 1]).

    Matches `_mix_snr` (augment_clips.py:45-79): background RMS floored at
    MIN_BG_RMS, scaled foreground floored at MIN_FG_RMS. When has_bg is
    False, the foreground is placed at offset 0 on silence without SNR
    scaling (augment_clips.py:218-231).

    `block_aligned` (static): caller guarantees offset % 128 == 0, which
    lets the shift skip its in-block fine stage (see _shift_right).
    """
    fg_rms = _rms(fg)
    bg_rms = jnp.maximum(_rms(bg), MIN_BG_RMS)
    snr_linear = 10.0 ** (snr_db / 20.0)
    scale = snr_linear * bg_rms / fg_rms
    scaled_rms = scale * fg_rms
    scale = jnp.where(scaled_rms < MIN_FG_RMS,
                      scale * (MIN_FG_RMS / jnp.maximum(scaled_rms, EPS)),
                      scale)

    offset = jnp.where(has_bg, offset, 0)
    # shift fg right by `offset`, zero-filled (fg is zero-padded beyond its
    # content, so nothing real is dropped for valid offsets)
    shifted = _shift_right(fg, offset, block_aligned=block_aligned)
    return jnp.where(has_bg, bg + shifted * scale, shifted)


# Span-start block alignment shared by pitch_window and resample_pitch:
# the window must be a multiple of this and sized for starts aligned DOWN
# to it, so the two functions must agree (32 would waste up to 31 samples
# of span).
PITCH_SPAN_BLK = 16


def pitch_window(max_abs_semitones: float, frame: int = 40,
                 blk: int = PITCH_SPAN_BLK) -> int:
    """Source-span width needed for rates up to 2^(st/12), blk-aligned.

    Content need is ceil(frame * max_rate) + 2 (linear interp reads one
    sample past the end); block alignment of the span start wastes up to
    blk-1 more. Smaller blk => tighter window => a smaller [F, frame,
    window] interpolation-weight tensor, which is the routine's dominant
    cost (see resample_pitch). `blk` must match resample_pitch's
    PITCH_SPAN_BLK (non-default values are for window-size experiments
    only).
    """
    span = (int(np.ceil(frame * 2.0 ** (abs(max_abs_semitones) / 12.0)))
            + 2 + (blk - 1))
    return ((span + blk - 1) // blk) * blk


def resample_pitch(x: jnp.ndarray, semitones: jnp.ndarray,
                   apply: jnp.ndarray, frame: int = 40,
                   window: int = 128) -> jnp.ndarray:
    """Pitch/speed shift by linear-interpolation resampling (fixed shape).

    rate = 2^(semitones/12); output sample i reads position i*rate, so pitch
    up shortens content (past-the-end reads masked to 0).

    Formulated without element gathers:
      1. materialise all blk-aligned `window`-wide source spans as
         overlapping views of the `[n/blk, blk]` reshape (window//blk
         static shifted slices — the mel framing trick);
      2. select each output frame's span with a one-hot [F, n/blk] matmul;
      3. interpolate inside the span with a linear-B-spline hat weight
         matrix (`einsum('fk,fjk->fj')`).
    Same linear interpolation as the direct gather; the weights round
    differently (bf16 operands — ~0.2% FS worst case on white noise) —
    immaterial under augmentation noise. Whether a plain gather is faster
    on the current device has not been measured.

    `frame` is the output chunk size: smaller chunks need proportionally
    smaller spans, shrinking the [F, frame, window] weight tensor that
    dominates the cost. Block size 16 tightens the span-start alignment
    waste from 31 to 15 samples, cutting the ±2 st window from 96 to 64.

    `window` must cover frame*max_rate + 1 + blk (`pitch_window()` computes
    it); the default 128 covers ±12 semitones at frame=40. The augmentation
    chain passes the tight static value derived from its pitch bounds.
    """
    n = x.shape[-1]
    blk = PITCH_SPAN_BLK
    n_windows = n // blk - window // blk + 1
    if n % (frame * blk // math.gcd(frame, blk)) != 0 or n_windows < 1:
        # fall back to the direct formulation for odd lengths and for
        # inputs shorter than one source window (rare paths)
        rate = 2.0 ** (semitones / 12.0)
        pos = jnp.arange(n) * rate
        lo = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 1)
        frac = pos - lo
        out = x[lo] * (1.0 - frac) + x[jnp.clip(lo + 1, 0, n - 1)] * frac
        out = jnp.where(pos <= n - 1, out, 0.0)
        return jnp.where(apply, out, x)

    n_frames = n // frame
    rate = 2.0 ** (semitones / 12.0)

    # Operand dtype for the two contractions: bf16. The span select is
    # exact (one-hot); only the blended interpolation weights lose bits
    # (<= 2^-9 relative, ~0.2% FS worst case — inside the same tolerance
    # the f32 ulp of the absolute read position already costs). bf16
    # halves the bytes of the [F, frame, window] weight tensor.
    cdt = jnp.bfloat16

    # all blk-aligned window-wide spans, as shifted views (no gather)
    blocks = x.reshape(n // blk, blk)
    xw = jnp.concatenate([blocks[k:n_windows + k]
                          for k in range(window // blk)], axis=1)

    # span start (block-aligned) per output frame; select via one-hot matmul
    f_start = jnp.arange(n_frames, dtype=jnp.float32) * frame * rate
    start_blk = jnp.clip((f_start // blk).astype(jnp.int32), 0,
                         n_windows - 1)
    q = jnp.arange(n_windows, dtype=jnp.int32)
    sel = (q[None, :] == start_blk[:, None]).astype(cdt)       # [F, NW]
    spans = jnp.matmul(sel, xw.astype(cdt),
                       preferred_element_type=jnp.float32)

    # absolute read positions and within-span offsets
    j = jnp.arange(frame, dtype=jnp.float32)
    pos = (jnp.arange(n_frames, dtype=jnp.float32)[:, None] * frame + j) \
        * rate                                          # [F, frame]
    rel = pos - (start_blk * blk)[:, None].astype(jnp.float32)

    # Interpolation weights as the linear B-spline hat max(0, 1-|rel-k|):
    # identical to the lo/hi one-hot blend (the hat is exactly 1-w at
    # k=floor(rel) and w at k=floor(rel)+1, zero elsewhere) but generated
    # in ONE subtract/abs/relu pass over the [F, frame, window] tensor —
    # the elementwise-bound term of this routine — instead of two integer
    # comparisons plus a three-array blend.
    k = jnp.arange(window, dtype=jnp.float32)
    relc = jnp.clip(rel, 0.0, float(window - 1))
    weights = jnp.maximum(
        0.0, 1.0 - jnp.abs(relc[:, :, None] - k[None, None, :])).astype(cdt)
    out = jnp.einsum("fk,fjk->fj", spans.astype(cdt), weights,
                     preferred_element_type=jnp.float32)  # [F, frame]
    out = out.reshape(n)
    out = jnp.where(pos.reshape(n) <= n - 1, out, 0.0)
    return jnp.where(apply, out, x)


def pitch_grid(min_st: float, max_st: float, n_rates: int) -> tuple:
    """Static semitone grid for the grouped pitch path: n_rates uniform
    points over [min_st, max_st] (VERDICT r3 #2's rate quantization; at the
    default 16 points over ±2 st the 0.27-st spacing is far inside the
    ±2 st augmentation range's own randomness)."""
    return tuple(float(s) for s in np.linspace(min_st, max_st, n_rates))


def resample_pitch_grouped(x: jnp.ndarray, grid: tuple, perm: jnp.ndarray,
                           apply: jnp.ndarray, frame: int = 40,
                           window: int = 128) -> jnp.ndarray:
    """Rate-QUANTIZED batch pitch resample: clip b gets grid rate
    `perm[b // (B//R)]` instead of an i.i.d. continuous semitone draw.

    Same linear-interpolation math as `resample_pitch`, restructured so the
    per-clip [F, frame, window] hat-weight tensor — that routine's dominant,
    elementwise-bound term — is computed once PER RATE instead
    of once per clip: with R=16 rates at batch 2048 the weight/selector
    generation shrinks 128x and both contractions become rate-batched
    einsums over [R, B/R, ...] with rate-shared operands. `perm` (a traced
    per-step permutation of range(R)) decorrelates rate from batch position
    across steps, so label-ordered batches don't bind a label to a rate;
    within a step the batch is exactly stratified over the grid — same
    augmentation family, lower variance than i.i.d. draws.

    Everything is computed in-graph from the static `grid` (no captured
    device constants). Caller guarantees the fast-path shape conditions
    (B % R == 0, n % lcm(frame, blk) == 0, n_windows >= 1); `augment_batch`
    falls back to the per-clip path otherwise.
    """
    B, n = x.shape
    R = len(grid)
    G = B // R
    blk = PITCH_SPAN_BLK
    n_windows = n // blk - window // blk + 1
    n_frames = n // frame
    cdt = jnp.bfloat16    # same operand dtype as resample_pitch

    rates = 2.0 ** (jnp.asarray(grid, jnp.float32) / 12.0)
    rates = rates[perm]                                     # [R]

    # per-rate span starts, one-hot selectors, read positions, hat weights —
    # identical formulas to resample_pitch, leading axis R instead of vmap B
    f_start = (jnp.arange(n_frames, dtype=jnp.float32)[None, :]
               * frame * rates[:, None])                    # [R, F]
    start_blk = jnp.clip((f_start // blk).astype(jnp.int32), 0,
                         n_windows - 1)
    q = jnp.arange(n_windows, dtype=jnp.int32)
    sel = (q[None, None, :] == start_blk[:, :, None]).astype(cdt)
    j = jnp.arange(frame, dtype=jnp.float32)
    pos = (jnp.arange(n_frames, dtype=jnp.float32)[None, :, None] * frame
           + j[None, None, :]) * rates[:, None, None]       # [R, F, frame]
    rel = pos - (start_blk * blk)[:, :, None].astype(jnp.float32)
    k = jnp.arange(window, dtype=jnp.float32)
    relc = jnp.clip(rel, 0.0, float(window - 1))
    weights = jnp.maximum(
        0.0, 1.0 - jnp.abs(relc[..., None] - k)).astype(cdt)

    # rate-batched span select + interpolation (contractions unchanged)
    blocks = x.reshape(R, G, n // blk, blk)
    xw = jnp.concatenate([blocks[:, :, s:n_windows + s]
                          for s in range(window // blk)], axis=-1)
    spans = jnp.einsum("rfn,rgnw->rgfw", sel, xw.astype(cdt),
                       preferred_element_type=jnp.float32)
    out = jnp.einsum("rgfk,rfjk->rgfj", spans.astype(cdt), weights,
                     preferred_element_type=jnp.float32)    # [R, G, F, frame]
    out = jnp.where(pos.reshape(R, 1, n) <= n - 1,
                    out.reshape(R, G, n), 0.0).reshape(B, n)
    return jnp.where(apply[:, None], out, x)


PITCH_RATE_DEN = 64


def pitch_pgrid(min_st: float, max_st: float, n_rates: int,
                q: int = PITCH_RATE_DEN) -> tuple:
    """Static integer-numerator grid for the rational pitch path: rate
    p/q nearest to 2^(st/12) for n_rates uniform semitone points. At the
    default ±2 st / q=64 the numerators span 57..72, i.e. the rate
    quantum 1/64 ≈ 0.14 st is FINER than pitch_grid's 0.27-st spacing at
    R=16 (duplicate numerators after rounding are harmless — two groups
    then share a rate)."""
    sts = np.linspace(min_st, max_st, n_rates)
    return tuple(int(round(2.0 ** (s / 12.0) * q)) for s in sts)


def resample_pitch_rational(x: jnp.ndarray, p_grid: tuple,
                            apply: jnp.ndarray,
                            q: int = PITCH_RATE_DEN) -> jnp.ndarray:
    """Rational-rate batch pitch resample, INTERLEAVED static assignment:
    clip b is linearly resampled at rate p_grid[b % R] / q.

    The win over `resample_pitch_grouped`: with an integer rate p/q,
    output row t of out.reshape(n//q, q) reads EXACTLY x[t*p : t*p+p+1],
    so the overlapping source spans are one reshape plus a one-column
    strided tail — the [F, n_windows] one-hot span-select contraction
    (and the 8x-duplicated [.., n_windows, window] span view it feeds on)
    disappears entirely, and the per-rate hat weights collapse to a
    static [p+1, q] constant. Work drops from ~26 MMAC/clip to
    n*(p+1) ≈ 1.2 MMAC/clip; what remains is the HBM stream of the batch.

    Rate decorrelation — why a STATIC slot->rate map is sound here where
    the grouped path needed a traced perm: the numerator is SHAPE-defining,
    so a traced perm cannot index the grid, and routing the batch through
    a traced permutation (one-hot matmul, row gather or per-group
    lax.switch) costs a full extra pass over the batch. The interleaved
    static map needs no routing, and it does not weaken the
    statistics the perm existed to protect: (a) WITHIN a batch, every
    contiguous run of k*R slots sees each rate exactly k times, so
    slot-structured batches (the ISBL sampler's per-rule slot ranges,
    supcon's word groups) get a uniform rate mix every step — stronger
    stratification than a random group permutation; (b) ACROSS steps,
    which clip sits at slot b is already randomized by every caller
    (pretrain_encoder draws idx ~ uniform per step; augment_clips
    shuffles clip order per pass), so each clip's rate marginal is
    uniform over the grid without any routing here.

    Same linear interpolation and bf16 operand dtype as
    `resample_pitch` (reference parity: augment_clips.py pitch shift);
    past-the-end reads are masked to 0 identically. Caller guarantees
    B % R == 0 and n % q == 0; `augment_batch` gates on those.
    """
    B, n = x.shape
    R = len(p_grid)
    G = B // R
    cdt = jnp.bfloat16
    nq = n // q

    # Materialize the producer ONCE before the R strided readers. Without
    # this barrier XLA fuses whatever elementwise chain produced `x` (the
    # mix/gain pre-stage in augment_batch) into each of the R slice
    # consumers and into the final where's passthrough operand, re-running
    # it many times. Identity on values.
    x = jax.lax.optimization_barrier(x)

    xg = x.reshape(G, R, n)
    outs = []
    for r in range(R):
        p = int(p_grid[r])
        xr = xg[:, r]                                 # [G, n], slots r::R
        pad = nq * p + 1 - n
        xp = jnp.pad(xr, ((0, 0), (0, pad))) if pad > 0 else xr
        rows = xp[:, :nq * p].reshape(G, nq, p)
        tail = xp[:, p:nq * p + 1:p]                  # x[(t+1)*p]
        spans = jnp.concatenate([rows, tail[:, :, None]], axis=2)
        # hat weights: column j interpolates position j*p/q in the span
        m = jnp.arange(p + 1, dtype=jnp.float32)[:, None]
        jpos = (jnp.arange(q, dtype=jnp.float32) * p / q)[None, :]
        W = jnp.maximum(0.0, 1.0 - jnp.abs(jpos - m)).astype(cdt)
        out = jnp.einsum("gnp,pq->gnq", spans.astype(cdt), W,
                         preferred_element_type=jnp.float32).reshape(G, n)
        valid = jnp.arange(n) * p <= (n - 1) * q      # pos <= n-1, exact
        outs.append(jnp.where(valid[None, :], out, 0.0))

    out = jnp.stack(outs, axis=1).reshape(B, n)
    return jnp.where(apply[:, None], out, x)


def rir_convolve(x: jnp.ndarray, rir: jnp.ndarray,
                 apply: jnp.ndarray) -> jnp.ndarray:
    """Room-impulse-response FFT convolution, output truncated to len(x).

    The impulse is peak-normalised; output is RMS-matched to the dry signal
    so reverb does not change loudness before the gain stage.
    """
    n = x.shape[-1]
    r = rir / jnp.maximum(jnp.max(jnp.abs(rir)), EPS)
    fft_len = _fft_len(n + rir.shape[-1] - 1)
    X = jnp.fft.rfft(x, fft_len)
    R = jnp.fft.rfft(r, fft_len)
    wet = jnp.fft.irfft(X * R, fft_len)[:n]
    wet = wet * (_rms(x) / _rms(wet))
    return jnp.where(apply, wet, x)


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _fft_len(target: int) -> int:
    """FFT length >= target for the RIR convolution: min of 2^a and 9*2^a.

    Any length >= target is mathematically equivalent; FFT cost is not
    monotonic in length, and lengths with large prime factors are slow.
    The {2^a, 9*2^a} family keeps the padding small with only small
    factors. Which lengths are fastest on the current device has not been
    measured.
    """
    pow2 = 1 << (int(target) - 1).bit_length()
    nine = 9 << max(0, ((int(target) + 8) // 9 - 1).bit_length())
    return min(pow2, nine)


class AugmentParams(NamedTuple):
    rir_prob: float
    gain_prob: float
    pitch_prob: float
    min_pitch: float
    max_pitch: float
    min_snr: float
    max_snr: float
    min_gain: float
    max_gain: float
    min_volume: float
    max_volume: float
    eq_prob: float = 0.0
    companding_prob: float = 0.0
    bandlimit_prob: float = 0.0
    # rate-quantized pitch: number of grid points (0 = continuous per-clip
    # semitone draws). When > 1 and the batch/length shapes allow, pitch
    # runs through resample_pitch_grouped — same augmentation family,
    # with the weight tensor computed once per rate instead of per clip.
    pitch_grid: int = 16
    # foreground-placement quantum in samples (see _augment_pre): offsets
    # round down to this grid so the shift can skip its fine stage. Must be
    # a multiple of 128 to engage; 0/1 = exact sample placement.
    offset_quantum: int = 128
    # rational-rate pitch: quantize rates to p/64 so the resample becomes
    # a reshape + tiny static-weight matmul per rate (resample_pitch_rational)
    # instead of the grouped one-hot span select. The p/64 quantum (~0.14 st) is FINER than the grouped grid's
    # 0.27-st spacing at the default 16 rates. False = grouped einsum.
    pitch_rational: bool = True

    @classmethod
    def from_settings(cls, settings=None) -> "AugmentParams":
        cfg = dict(DEFAULT_SETTINGS)
        if settings:
            cfg.update({k: v for k, v in settings.items() if v is not None})
        return cls(
            rir_prob=float(cfg["rir_prob"]),
            gain_prob=float(cfg["gain_prob"]),
            pitch_prob=float(cfg["pitch_prob"]),
            min_pitch=float(cfg["min_pitch_semitones"]),
            max_pitch=float(cfg["max_pitch_semitones"]),
            min_snr=float(cfg["min_snr_in_db"]),
            max_snr=float(cfg["max_snr_in_db"]),
            min_gain=float(cfg["min_gain_in_db"]),
            max_gain=float(cfg["max_gain_in_db"]),
            min_volume=float(cfg["min_volume_augmentation"]),
            max_volume=float(cfg["max_volume_augmentation"]),
            eq_prob=float(cfg["eq_prob"]),
            companding_prob=float(cfg["companding_prob"]),
            bandlimit_prob=float(cfg["bandlimit_prob"]),
            pitch_grid=int(cfg.get("pitch_grid_rates",
                                   cls._field_defaults["pitch_grid"])),
            offset_quantum=int(cfg.get(
                "offset_quantum", cls._field_defaults["offset_quantum"])),
            pitch_rational=bool(cfg.get(
                "pitch_rational", cls._field_defaults["pitch_rational"])),
        )


def _offset_aligned(n: int, params: AugmentParams) -> bool:
    """Placement quantization engaged: offsets round down to a 128-sample
    (8 ms) grid so the shift skips its in-block fine stage — two of its
    three dots (see _shift_right). 8 ms placement granularity is far below
    the 80 ms frame hop the detector decides on, and the mel frontend's
    own 10 ms hop already makes sub-frame placement phase-only."""
    return (params.offset_quantum > 1 and n % 128 == 0
            and params.offset_quantum % 128 == 0)


def _pre_draws(key, fg_len, n: int, params: AugmentParams):
    """Per-clip random draws of the pre-pitch stage (offset/SNR/gain).
    Subkey derivation shares the 9-way split with
    _augment_post/_pitch_gate."""
    (k_off, k_snr, k_gain, _k_pitch, _k_rir, _k_vol, k_p1, _k_p2,
     _k_p3) = jax.random.split(key, 9)
    max_offset = jnp.maximum(n - fg_len, 0)
    offset = jax.random.randint(k_off, (), 0, jnp.maximum(max_offset, 1))
    if _offset_aligned(n, params):
        offset = (offset // params.offset_quantum) * params.offset_quantum
    snr_db = jax.random.uniform(k_snr, (), minval=params.min_snr,
                                maxval=params.max_snr)
    gain_db = jax.random.uniform(k_gain, (), minval=params.min_gain,
                                 maxval=params.max_gain)
    apply_gain = jax.random.uniform(k_p1, ()) < params.gain_prob
    return offset, snr_db, gain_db, apply_gain


def _augment_pre(key, fg, bg, fg_len, has_bg, params: AugmentParams):
    """Chain stages BEFORE pitch (mix + gain); vmapped over B."""
    n = fg.shape[-1]
    offset, snr_db, gain_db, apply_gain = _pre_draws(key, fg_len, n, params)
    mixed = mix_snr(fg, bg, offset, snr_db, has_bg,
                    block_aligned=_offset_aligned(n, params))
    return jnp.where(apply_gain, mixed * 10.0 ** (gain_db / 20.0), mixed)


def _pitch_gate(key, params: AugmentParams):
    """The per-clip pitch probability draw (k_p2 of the 9-way split)."""
    k_p2 = jax.random.split(key, 9)[7]
    return jax.random.uniform(k_p2, ()) < params.pitch_prob


def _augment_post(key, mixed, rir, has_rir, params: AugmentParams):
    """Chain stages AFTER pitch (RIR/EQ/bandlimit/volume/companding)."""
    (_k_off, _k_snr, _k_gain, _k_pitch, k_rir, k_vol, _k_p1, _k_p2,
     k_p3) = jax.random.split(key, 9)
    # EQ keys come from fold_in, NOT from widening the split: threefry
    # pairs counters across array halves, so split(key, 11) would re-pair
    # every subkey and silently change all pre-EQ augmentation draws even
    # with eq_prob=0. fold_in keeps the original nine bit-identical.
    k_eq = jax.random.fold_in(key, 101)
    k_p4 = jax.random.fold_in(key, 102)

    # RIR, probability gate (only when an impulse was provided).
    # params is STATIC: with rir_prob == 0 the FFT convolution is not even
    # traced — a jnp.where would still execute B large FFTs per batch and
    # dominate the step.
    if params.rir_prob > 0:
        apply_rir = jnp.logical_and(
            jax.random.uniform(k_p3, ()) < params.rir_prob, has_rir)
        mixed = rir_convolve(mixed, rir, apply_rir)

    # random channel EQ: a 3-tap FIR y[n] = x[n] + a1 x[n-1] + a2 x[n-2],
    # energy-renormalised — randomises spectral tilt/ripple the way real
    # mics and rooms do (domain randomisation for the encoder; NOT the
    # eval-only telephone fx chain, which additionally band-limits,
    # reverberates, and clips)
    if params.eq_prob > 0:
        a12 = jax.random.uniform(k_eq, (2,),
                                 minval=jnp.asarray([-0.8, -0.4]),
                                 maxval=jnp.asarray([0.8, 0.4]))
        apply_eq = jax.random.uniform(k_p4, ()) < params.eq_prob
        eq = (mixed + a12[0] * jnp.roll(mixed, 1).at[0].set(0.0)
              + a12[1] * jnp.roll(mixed, 2).at[:2].set(0.0))
        eq = eq / jnp.sqrt(1.0 + a12[0] ** 2 + a12[1] ** 2)
        mixed = jnp.where(apply_eq, eq, mixed)

    # random band-limit: windowed-sinc lowpass with a random cutoff —
    # randomises the channel's bandwidth (cheap mics, codecs, downsampled
    # sources) with a LINEAR filter family distinct from the eval-only fx
    # chain's fixed Butterworth telephone band
    if params.bandlimit_prob > 0:
        k_bl = jax.random.fold_in(key, 103)
        k_p5 = jax.random.fold_in(key, 104)
        fc = jax.random.uniform(k_bl, (), minval=2000.0, maxval=7000.0)
        half = 7
        t = jnp.arange(-half, half + 1, dtype=jnp.float32)
        h = jnp.sinc(2.0 * fc / 16000.0 * t) \
            * jnp.hamming(2 * half + 1).astype(jnp.float32)
        h = h / jnp.sum(h)                       # unity DC gain
        low = jnp.convolve(mixed, h, mode="same")
        apply_bl = jax.random.uniform(k_p5, ()) < params.bandlimit_prob
        mixed = jnp.where(apply_bl, low, mixed)

    # peak-normalised random volume (augment_clips.py:246-255)
    target = jax.random.uniform(k_vol, (), minval=params.min_volume,
                                maxval=params.max_volume)
    peak = jnp.max(jnp.abs(mixed))
    peak = jnp.where(peak < 1e-8, 1.0, peak)
    out = mixed * (target / peak)
    out = jnp.clip(out, -1.0, 1.0)

    # mu-law 8-bit codec round-trip: companding + quantisation noise that
    # tracks signal level, the way narrowband telephony/VoIP codecs do.
    # A NONLINEARITY family distinct from the eval fx chain's tanh soft
    # clip — applied at the normalised output level so the quantisation
    # step is meaningful relative to the signal.
    if params.companding_prob > 0:
        k_p6 = jax.random.fold_in(key, 105)
        mu = 255.0
        comp = jnp.sign(out) * jnp.log1p(mu * jnp.abs(out)) / jnp.log1p(mu)
        comp = jnp.round(comp * 127.0) / 127.0   # 8-bit code levels
        dec = jnp.sign(comp) * ((1.0 + mu) ** jnp.abs(comp) - 1.0) / mu
        apply_cmp = jax.random.uniform(k_p6, ()) < params.companding_prob
        out = jnp.where(apply_cmp, dec, out)
    return out


@functools.partial(jax.jit, static_argnames=("params",))
def augment_batch(key, fg, bg, rir, fg_lens, has_bg, has_rir,
                  params: AugmentParams) -> jnp.ndarray:
    """Batched augmentation.

    Args:
        key:     PRNG key.
        fg:      [B, L] foreground clips, int16 scale or [-1,1] floats.
        bg:      [B, L] background clips (zeros when none).
        rir:     [B, R] impulse responses (zeros when none).
        fg_lens: [B] true foreground lengths (for placement offsets).
        has_bg:  [B] bool, real background present.
        has_rir: [B] bool, impulse present.
        params:  AugmentParams (static).

    Returns:
        [B, L] int16 augmented audio.
    """
    # int16-scale detection: static by dtype for integer input (skips a
    # full-batch |max| reduce over the [B, L] array); runtime only for
    # float input, which may arrive either as [-1, 1] or int16-scale.
    def _to_unit(x):
        if jnp.issubdtype(x.dtype, jnp.integer):
            return x.astype(jnp.float32) * (1.0 / 32768.0)
        x = x.astype(jnp.float32)
        return x * jnp.where(jnp.max(jnp.abs(x)) > 2.0, 1.0 / 32768.0, 1.0)

    fg = _to_unit(fg)
    bg = _to_unit(bg)
    rir = rir.astype(jnp.float32)

    B, n = fg.shape
    keys = jax.random.split(key, B)

    def _pre_stage():
        """Mix+gain pre-stage, vmapped over the batch."""
        return jax.vmap(_augment_pre, in_axes=(0, 0, 0, 0, 0, None))(
            keys, fg, bg, fg_lens, has_bg, params)

    # Grouped (rate-quantized) pitch fast path: same chain, with the pitch
    # stage lifted out of the vmap into one rate-stratified batch op. Shape
    # gates mirror resample_pitch's fast-path conditions; anything else
    # falls back to the per-clip continuous path below.
    if params.pitch_prob > 0 and params.pitch_grid > 1:
        frame, blk = 40, PITCH_SPAN_BLK
        window = pitch_window(max(abs(params.min_pitch),
                                  abs(params.max_pitch)))
        rational = (params.pitch_rational and B % params.pitch_grid == 0
                    and n % PITCH_RATE_DEN == 0)
        grouped = (B % params.pitch_grid == 0
                   and n % (frame * blk // math.gcd(frame, blk)) == 0
                   and n // blk - window // blk + 1 >= 1)
        if rational or grouped:
            mixed = _pre_stage()
            gate = jax.vmap(_pitch_gate, in_axes=(0, None))(keys, params)
            if rational:
                pgrid = pitch_pgrid(params.min_pitch, params.max_pitch,
                                    params.pitch_grid)
                mixed = resample_pitch_rational(mixed, pgrid, gate)
            else:
                perm = jax.random.permutation(jax.random.fold_in(key, 106),
                                              params.pitch_grid)
                grid = pitch_grid(params.min_pitch, params.max_pitch,
                                  params.pitch_grid)
                mixed = resample_pitch_grouped(mixed, grid, perm, gate,
                                               frame=frame, window=window)
            out = jax.vmap(_augment_post, in_axes=(0, 0, 0, 0, None))(
                keys, mixed, rir, has_rir, params)
            return (out * INT16_MAX).astype(jnp.int16)

    # Generic path (continuous pitch / pitch off / odd shapes): the same
    # pre -> pitch -> post composition as _augment_one, decomposed into
    # stages. Bit-identical to the single-clip chain — the stage halves
    # share its key derivation.
    mixed = _pre_stage()
    if params.pitch_prob > 0:
        window = pitch_window(max(abs(params.min_pitch),
                                  abs(params.max_pitch)))

        def _pitch_one(k, m):
            k_pitch = jax.random.split(k, 9)[3]
            semis = jax.random.uniform(k_pitch, (), minval=params.min_pitch,
                                       maxval=params.max_pitch)
            return resample_pitch(m, semis, _pitch_gate(k, params),
                                  window=window)

        mixed = jax.vmap(_pitch_one)(keys, mixed)
    out = jax.vmap(_augment_post, in_axes=(0, 0, 0, 0, None))(
        keys, mixed, rir, has_rir, params)
    return (out * INT16_MAX).astype(jnp.int16)


def spec_augment(key, mel: jnp.ndarray, time_masks: int = 2,
                 time_width: int = 10, freq_masks: int = 2,
                 freq_width: int = 6) -> jnp.ndarray:
    """SpecAugment on [B, T, F] mel features (new capability; the BASELINE
    CRNN-training config calls for noise mix + SpecAugment)."""
    B, T, F = mel.shape
    fill = mel.min()

    def mask_axis(key, mel, axis_len, width, axis):
        k1, k2 = jax.random.split(key)
        starts = jax.random.randint(k1, (B,), 0, jnp.maximum(axis_len - width,
                                                             1))
        widths = jax.random.randint(k2, (B,), 0, width + 1)
        idx = jnp.arange(axis_len)
        mask = ((idx[None, :] >= starts[:, None])
                & (idx[None, :] < (starts + widths)[:, None]))
        shape = (B, T, 1) if axis == 1 else (B, 1, F)
        mask = mask.reshape(shape)
        return jnp.where(mask, fill, mel)

    keys = jax.random.split(key, time_masks + freq_masks)
    for i in range(time_masks):
        mel = mask_axis(keys[i], mel, T, time_width, axis=1)
    for i in range(freq_masks):
        mel = mask_axis(keys[time_masks + i], mel, F, freq_width, axis=2)
    return mel
