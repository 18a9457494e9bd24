"""Log-mel frontend (hop-DFT formulation, N_FFT = 480).

This is the acoustic core of nanowakeword-tpu. The reference implementation
(`/root/reference/nanowakeword/data/AudioFeatures.py:124-153`) delegates the
mel-spectrogram to an opaque ONNX model with the contract: 16 kHz int16 PCM in,
32 mel bins out at ~100 frames/sec, post-transformed with ``spec/10 + 2``.
That contract (bin count, frame rate, scale) is preserved; the transform
inside is our own design, built from matrix products:

* **Hop-granular DFT** — the analysis window (480) is exactly 3 hops (160),
  and with ``N_FFT == 480`` the window-length DFT factorizes over hops:

      X(t, f) = sum_k  e^{-i 2pi k f / 3} * S(t + k, f),      k = 0..2
      S(r, f) = sum_tau x[160 r + tau] e^{-i 2pi tau f / 480}

  so there is ONE pair of ``[160, n_bins]`` matmuls per hop ROW
  (every row is reused by the 3 frames that overlap it), instead of one
  ``[480, n_bins]`` pair per FRAME — 3x fewer DFT FLOPs than the frame-
  matrix route. The phase combine is cheap elementwise work.
* **Analytic Hann** — the periodic Hann window of length N_FFT is EXACTLY a
  3-tap convolution in frequency:

      Xw(f) = 0.5 X(f) - 0.25 X(f-1) - 0.25 X(f+1)     (X(-1) = conj X(1))

  applied after the phase combine; no window folding into bases needed.
* **Bin pruning** — only the spectral bins the mel filterbank reads are
  computed: with fmax = 3800 Hz that is bins 0..~116 of 241, padded to
  128 (every dropped bin has zero filter weight; the two
  edge lanes whose +-1 taps fall outside the tile are bins the filterbank
  also never reads).
* **Exact streaming == batch** — the frontend left-pads every clip with
  ``WINDOW - HOP = 320`` zero samples; every 1280-sample (80 ms) chunk then
  contributes exactly 8 new frames, and the streaming step runs the same
  per-row dots + combines on the same row values as the batch path, so the
  two agree to float32 determinism (tested, tests/test_mel.py). The
  reference's streaming admittedly diverges from its batch path
  (`AudioFeatures.py:388-393`); here it is an invariant.

History: the original design used N_FFT = 512 with the window and int16
scale folded into per-hop slabs of the frame basis (3 shifted [160, 128]
matmul pairs per frame; see git history). The hop-DFT factorization needs
only 1 pair per row.

Output contract:
    mel_frontend(x[n]) -> [n // HOP, N_MELS]   (for n a multiple of HOP)
    values = log10(mel_power + EPS) + LOG_OFFSET   (the ``x/10 + 2`` scale)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# Frontend constants (the numeric contract; see SURVEY.md §2 "numeric contract")
# ---------------------------------------------------------------------------
SAMPLE_RATE = 16000
HOP = 160                   # 10 ms
WINDOW = 480                # 30 ms = 3 hops (framing-by-reshape invariant)
N_FFT = 480                 # == WINDOW: enables the hop-DFT factorization
N_BINS = 128                # computed spectral bins (>= the 117 the filterbank reads)
N_MELS = 32
FMIN = 60.0
FMAX = 3800.0
CHUNK = 1280                # 80 ms streaming chunk
FRAMES_PER_CHUNK = CHUNK // HOP  # 8
LEFT_PAD = WINDOW - HOP     # 320 zero samples of left context
INT16_SCALE = 1.0 / 32768.0  # inputs arrive in int16 amplitude convention
MEL_EPS = 1e-8              # floor inside log10; log10(1e-8)+2 = -6, i.e.
                            # silence sits at the reference's -80 dB pad value
LOG_OFFSET = 2.0            # the reference's `spec/10 + 2` offset
PAD_VALUE = -6.0            # transformed-scale equivalent of the -80 dB pad
                            # used by the reference batch path (-80/10 + 2)


def _hann(n: int) -> np.ndarray:
    """Periodic Hann window."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


@functools.lru_cache(maxsize=None)
def _mel_filterbank() -> np.ndarray:
    """[N_BINS, N_MELS] triangular filterbank (HTK mel) on the N_FFT grid."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)

    mel_pts = np.linspace(hz_to_mel(FMIN), hz_to_mel(FMAX), N_MELS + 2)
    hz_pts = mel_to_hz(mel_pts)
    bin_freqs = np.arange(N_BINS) * SAMPLE_RATE / N_FFT
    fb = np.zeros((N_BINS, N_MELS))
    for m in range(N_MELS):
        lo, mid, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_freqs - lo) / max(mid - lo, 1e-9)
        down = (hi - bin_freqs) / max(hi - mid, 1e-9)
        fb[:, m] = np.clip(np.minimum(up, down), 0.0, None)
    return fb


@functools.lru_cache(maxsize=None)
def _hopdft_constants(dtype_name: str = "bfloat16"):
    """(b0_cos, b0_sin, phase_re, phase_im, mel_fb) numpy constants.

    b0_cos/b0_sin: [HOP, N_BINS] hop-length real-DFT basis with the int16
                   normalisation folded in (window is NOT folded — it is the
                   analytic 3-tap applied post-combine).
    phase_re/im:   [3, N_BINS] the e^{-i 2pi k f / 3} frame-combine factors.
    mel_fb:        [N_BINS, N_MELS] filterbank.
    """
    tau = np.arange(HOP)[:, None]
    f = np.arange(N_BINS)[None, :]
    ang = 2.0 * np.pi * tau * f / N_FFT
    b0c = (np.cos(ang) * INT16_SCALE).astype(np.float64)
    b0s = (-np.sin(ang) * INT16_SCALE).astype(np.float64)

    k = np.arange(3)[:, None]
    pang = 2.0 * np.pi * k * np.arange(N_BINS)[None, :] / 3.0
    p_re = np.cos(pang)
    p_im = -np.sin(pang)

    dt = np.dtype(np.float32) if dtype_name == "float32" else jnp.bfloat16
    return (np.asarray(b0c, dtype=dt), np.asarray(b0s, dtype=dt),
            np.asarray(p_re, np.float32), np.asarray(p_im, np.float32),
            np.asarray(_mel_filterbank(), dtype=dt))


def hann_taps(f_re: jnp.ndarray, f_im: jnp.ndarray):
    """Apply the periodic-Hann 3-tap frequency convolution along the last
    (bin) axis: Xw(f) = 0.5 X(f) - 0.25 X(f-1) - 0.25 X(f+1).

    Edge semantics: X(-1) = conj(X(1)) (real input); X(N_BINS) is not
    computed, so the TOP lane's +1 tap reads a duplicate — bins >= 117 have
    zero filterbank weight, so the result is unaffected.
    """
    m1_re = jnp.concatenate([f_re[..., 1:2], f_re[..., :-1]], axis=-1)
    m1_im = jnp.concatenate([-f_im[..., 1:2], f_im[..., :-1]], axis=-1)
    p1_re = jnp.concatenate([f_re[..., 1:], f_re[..., -1:]], axis=-1)
    p1_im = jnp.concatenate([f_im[..., 1:], f_im[..., -1:]], axis=-1)
    w_re = 0.5 * f_re - 0.25 * (m1_re + p1_re)
    w_im = 0.5 * f_im - 0.25 * (m1_im + p1_im)
    return w_re, w_im


def _log_mel_from_rows(rows: jnp.ndarray, t: int, *,
                       compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """[..., t+2, HOP] hop rows -> [..., t, N_MELS] transformed log-mel.

    The shared core of the batch and streaming paths: per-row hop DFT,
    phase combine over the 3 overlapping rows per frame, analytic Hann,
    power, filterbank, log compression. Identical row values in produce
    identical frames out, which is what makes streaming == batch exact.
    """
    b0c, b0s, p_re, p_im, fb = _hopdft_constants(
        "float32" if compute_dtype == jnp.float32 else "bfloat16")
    r = rows.astype(compute_dtype)
    s_re = jnp.matmul(r, b0c, preferred_element_type=jnp.float32)
    s_im = jnp.matmul(r, b0s, preferred_element_type=jnp.float32)

    f_re = s_re[..., 0:t, :]
    f_im = s_im[..., 0:t, :]
    for k in (1, 2):
        pr, pi = p_re[k], p_im[k]
        f_re = f_re + pr * s_re[..., k:t + k, :] - pi * s_im[..., k:t + k, :]
        f_im = f_im + pr * s_im[..., k:t + k, :] + pi * s_re[..., k:t + k, :]

    w_re, w_im = hann_taps(f_re, f_im)
    power = w_re * w_re + w_im * w_im
    mel = jnp.matmul(power.astype(compute_dtype), fb,
                     preferred_element_type=jnp.float32)
    return jnp.log10(jnp.maximum(mel, 0.0) + MEL_EPS) + LOG_OFFSET


def mel_frontend(x: jnp.ndarray, *, compute_dtype=jnp.bfloat16) -> jnp.ndarray:
    """Whole-clip log-mel. [..., n] int16-scale audio -> [..., n//HOP, N_MELS].

    The clip is left-padded with LEFT_PAD zeros, making the output length
    exactly n // HOP and the result identical to the streaming path.
    """
    x = x.astype(jnp.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    n = x.shape[-1]
    if n % HOP != 0:
        pad = HOP - n % HOP
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])
        n = x.shape[-1]
    t = n // HOP
    pad_widths = [(0, 0)] * (x.ndim - 1) + [(LEFT_PAD, 0)]
    rows = jnp.pad(x, pad_widths).reshape(x.shape[:-1] + (t + 2, HOP))
    out = _log_mel_from_rows(rows, t, compute_dtype=compute_dtype)
    return out[0] if squeeze else out


def mel_streaming_step(tail: jnp.ndarray, chunk: jnp.ndarray,
                       *, compute_dtype=jnp.bfloat16):
    """One streaming step: 1280 new samples -> 8 new mel frames.

    Args:
        tail:  [..., LEFT_PAD] the last 320 samples seen before `chunk`
               (zeros at stream start).
        chunk: [..., CHUNK] new audio samples (int16 scale, float).

    Returns:
        (new_tail [..., LEFT_PAD], frames [..., FRAMES_PER_CHUNK, N_MELS])

    Invariant (tested): concatenating the frames from successive steps equals
    `mel_frontend` of the concatenated audio, exactly — both paths run the
    same per-row dots on the same row values.
    """
    chunk = chunk.astype(jnp.float32)
    tail = tail.astype(jnp.float32)
    buf = jnp.concatenate([tail, chunk], axis=-1)       # [..., 1600]
    rows = buf.reshape(buf.shape[:-1] + (FRAMES_PER_CHUNK + 2, HOP))
    out = _log_mel_from_rows(rows, FRAMES_PER_CHUNK,
                             compute_dtype=compute_dtype)
    new_tail = buf[..., -LEFT_PAD:]
    return new_tail, out


def mel_frontend_reference(x: np.ndarray) -> np.ndarray:
    """Direct windowed N_FFT-point DFT mel in float64 numpy — the oracle the
    hop-DFT factorization is validated against (equal up to bf16/f32
    rounding of the fast path; tests/test_mel.py)."""
    x = np.asarray(x, np.float64) * INT16_SCALE
    if x.ndim == 1:
        x = x[None]
    b, n = x.shape
    t = n // HOP
    xp = np.pad(x, ((0, 0), (LEFT_PAD, 0)))
    win = _hann(N_FFT)
    tau = np.arange(N_FFT)[:, None]
    f = np.arange(N_BINS)[None, :]
    basis = np.exp(-2j * np.pi * tau * f / N_FFT) * win[:, None]
    frames = np.stack([xp[:, i * HOP:i * HOP + N_FFT] for i in range(t)],
                      axis=1)                           # [B, T, 480]
    spec = frames @ basis
    power = np.abs(spec) ** 2
    mel = power @ _mel_filterbank()
    return np.log10(np.maximum(mel, 0.0) + MEL_EPS) + LOG_OFFSET


def n_mel_frames(n_samples: int) -> int:
    """Number of mel frames produced for an n_samples clip."""
    return (n_samples + HOP - 1) // HOP
