"""Mel frontend: shape contract, streaming==batch exactness, numeric sanity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanowakeword_tpu.ops import mel as M


def _tone(n, freq=440.0, amp=8000.0, sr=16000):
    t = np.arange(n) / sr
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


class TestShapes:
    def test_one_second_clip(self):
        x = _tone(16000)
        out = M.mel_frontend(x)
        assert out.shape == (100, M.N_MELS)

    def test_batched(self):
        x = np.stack([_tone(32000, f) for f in (300, 500, 700)])
        out = M.mel_frontend(x)
        assert out.shape == (3, 200, M.N_MELS)

    def test_non_hop_multiple_pads(self):
        x = _tone(16000 + 37)
        out = M.mel_frontend(x)
        assert out.shape == (M.n_mel_frames(16000 + 37), M.N_MELS)

    def test_frames_per_chunk(self):
        assert M.CHUNK // M.HOP == M.FRAMES_PER_CHUNK == 8


class TestStreamingEquivalence:
    """The hard invariant the reference could not provide
    (AudioFeatures.py:388-393): streaming mel == whole-clip mel, exactly."""

    @pytest.mark.parametrize("n_chunks", [1, 3, 13])
    def test_streaming_matches_batch(self, rng, n_chunks):
        x = rng.integers(-20000, 20000, n_chunks * M.CHUNK).astype(np.float32)
        # jit both paths: that's how production runs them, and XLA's fused
        # log10 rounds differently from the op-by-op eager path (~5e-7).
        batch_out = np.asarray(jax.jit(
            lambda a: M.mel_frontend(a, compute_dtype=jnp.float32))(x))

        tail = jnp.zeros(M.LEFT_PAD)
        frames = []
        step = jax.jit(
            lambda t, c: M.mel_streaming_step(t, c, compute_dtype=jnp.float32)
        )
        for i in range(n_chunks):
            tail, f = step(tail, x[i * M.CHUNK:(i + 1) * M.CHUNK])
            frames.append(np.asarray(f))
        stream_out = np.concatenate(frames, axis=0)

        assert stream_out.shape == batch_out.shape
        # Same frames, same constants; residual is XLA matmul K-blocking
        # reassociation across shapes (a few float32 ulps).
        np.testing.assert_allclose(stream_out, batch_out, atol=1e-5)

    def test_streaming_matches_batch_bf16(self, rng):
        """Same invariant holds in the production bfloat16 compute path."""
        x = rng.integers(-20000, 20000, 5 * M.CHUNK).astype(np.float32)
        batch_out = np.asarray(jax.jit(M.mel_frontend)(x))
        tail = jnp.zeros(M.LEFT_PAD)
        step = jax.jit(M.mel_streaming_step)
        frames = []
        for i in range(5):
            tail, f = step(tail, x[i * M.CHUNK:(i + 1) * M.CHUNK])
            frames.append(np.asarray(f))
        np.testing.assert_allclose(np.concatenate(frames, 0), batch_out,
                                   atol=1e-5)


class TestNumerics:
    def test_tone_peaks_at_expected_mel_bin(self):
        """A 1 kHz tone must concentrate energy in the right mel band."""
        x = _tone(16000, freq=1000.0)
        out = np.asarray(M.mel_frontend(x, compute_dtype=jnp.float32))
        mid = out[20:80]  # steady-state frames
        peak_bin = int(np.argmax(mid.mean(axis=0)))
        # bin centres: mel-spaced 60..3800 over 32 bins; 1 kHz lands mid-scale
        fb = M._mel_filterbank()
        bin_freqs = np.arange(fb.shape[0]) * M.SAMPLE_RATE / M.N_FFT
        centre = float((fb[:, peak_bin] * bin_freqs).sum()
                       / fb[:, peak_bin].sum())
        assert abs(centre - 1000.0) < 150.0

    def test_hopdft_matches_direct_dft(self, rng):
        """The hop-DFT factorization (per-row dots + phase combine + 3-tap
        Hann) equals a direct windowed N_FFT-point DFT of each frame — the
        float64 oracle — to the fast path's rounding."""
        x = rng.integers(-20000, 20000, 16000).astype(np.float32)
        out = np.asarray(M.mel_frontend(x, compute_dtype=jnp.float32))
        ref = M.mel_frontend_reference(x)[0]
        np.testing.assert_allclose(out, ref, atol=2e-4)

    def test_hopdft_matches_fft_oracle(self, rng):
        """Fully independent oracle: np.fft.rfft over the windowed frames
        with an unpruned filterbank gives the same log-mel (the lane-tile
        bin pruning is lossless for fmax=3800)."""
        x = rng.integers(-20000, 20000, 16000).astype(np.float64)
        out = np.asarray(M.mel_frontend(x.astype(np.float32),
                                        compute_dtype=jnp.float32))
        n_bins = M.N_FFT // 2 + 1
        padded = np.concatenate([np.zeros(M.LEFT_PAD), x])
        t = len(x) // M.HOP
        frames = np.stack([padded[i * M.HOP:i * M.HOP + M.WINDOW]
                           for i in range(t)])
        win = (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(M.WINDOW)
                                  / M.WINDOW)) / 32768.0
        spec = np.fft.rfft(frames * win, n=M.N_FFT)[:, :n_bins]
        # full-spectrum filterbank, rebuilt without pruning
        def h2m(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
        def m2h(m):
            return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
        pts = m2h(np.linspace(h2m(M.FMIN), h2m(M.FMAX), M.N_MELS + 2))
        freqs = np.arange(n_bins) * M.SAMPLE_RATE / M.N_FFT
        fb = np.zeros((n_bins, M.N_MELS))
        for m in range(M.N_MELS):
            lo, mid, hi = pts[m], pts[m + 1], pts[m + 2]
            fb[:, m] = np.clip(np.minimum((freqs - lo) / (mid - lo),
                                          (hi - freqs) / (hi - mid)), 0, None)
        ref = np.log10(np.abs(spec) ** 2 @ fb + M.MEL_EPS) + M.LOG_OFFSET
        np.testing.assert_allclose(out, ref, atol=2e-4)

    def test_silence_hits_floor(self):
        x = np.zeros(16000, np.float32)
        out = np.asarray(M.mel_frontend(x, compute_dtype=jnp.float32))
        np.testing.assert_allclose(out, np.log10(M.MEL_EPS) + M.LOG_OFFSET, atol=1e-5)

    def test_scale_matches_reference_transform(self):
        """Louder audio -> larger values on the x/10+2 transformed dB scale:
        10x amplitude = +20 dB = +2.0 on the transformed scale."""
        quiet = np.asarray(M.mel_frontend(_tone(16000, amp=300.0),
                                          compute_dtype=jnp.float32))
        loud = np.asarray(M.mel_frontend(_tone(16000, amp=3000.0),
                                         compute_dtype=jnp.float32))
        peak = int(np.argmax(loud[50]))
        assert loud[50, peak] - quiet[50, peak] == pytest.approx(2.0, abs=0.05)

    def test_bf16_close_to_f32(self, rng):
        x = rng.integers(-20000, 20000, 16000).astype(np.float32)
        a = np.asarray(M.mel_frontend(x, compute_dtype=jnp.float32))
        b = np.asarray(M.mel_frontend(x, compute_dtype=jnp.bfloat16))
        assert np.abs(a - b).mean() < 0.05


class TestBulkPathAgainstReference:
    """The bulk (bf16) frontend at the shapes the benchmark and
    extraction run, against the float64 DFT oracle. Tolerance: bf16 rounding
    of rows and bases (2^-9 relative) in the log10 domain — a few 1e-3 on
    loud bins, more on bins near the MEL_EPS floor."""

    @pytest.mark.parametrize("shape", [
        (1, 16000),    # 100 frames
        (3, 32000),    # 200 frames
        (2, 64000),    # 400 frames
        (5, 12345),    # non-HOP-multiple length, odd batch
    ])
    def test_matches_reference(self, rng, shape):
        x = rng.integers(-20000, 20000, shape).astype(np.float32)
        out = np.asarray(M.mel_frontend(jnp.asarray(x),
                                        compute_dtype=jnp.bfloat16))
        assert out.shape == (shape[0], M.n_mel_frames(shape[1]), M.N_MELS)
        ref = M.mel_frontend_reference(x)
        d = np.abs(out[:, :ref.shape[1]] - ref)
        assert d.max() < 0.1 and d.mean() < 5e-3, (d.max(), d.mean())

    def test_frames_across_128_frame_boundaries(self, rng):
        """Frames straddling multiples of 128 (the bin tile width) agree
        with the reference like every other frame."""
        x = rng.integers(-20000, 20000, (2, 48000)).astype(np.float32)
        out = np.asarray(M.mel_frontend(jnp.asarray(x)))
        ref = M.mel_frontend_reference(x)
        for boundary in (128, 256):
            seg = slice(boundary - 3, boundary + 3)
            assert np.abs(out[:, seg] - ref[:, seg]).mean() < 5e-3

    def test_int16_input_matches_float(self, rng):
        """int16 PCM (the product's native dtype) gives bit-identical output
        to the same values fed as float32: int16 -> f32 is exact."""
        x = rng.integers(-20000, 20000, (4, 16000)).astype(np.int16)
        a = np.asarray(M.mel_frontend(jnp.asarray(x)))
        b = np.asarray(M.mel_frontend(jnp.asarray(x.astype(np.float32))))
        np.testing.assert_array_equal(a, b)

    def test_bf16_input(self, rng):
        """bf16 audio is read at its own (rounded) values."""
        x = rng.integers(-20000, 20000, (2, 16000)).astype(np.float32)
        xb = jnp.asarray(x, jnp.bfloat16)
        out = np.asarray(M.mel_frontend(xb))
        ref = M.mel_frontend_reference(np.asarray(xb, np.float32))
        assert np.abs(out - ref).mean() < 5e-3

    def test_1d_input_keeps_rank(self, rng):
        x = rng.integers(-20000, 20000, 16000).astype(np.float32)
        out = np.asarray(M.mel_frontend(jnp.asarray(x)))
        assert out.shape == (100, M.N_MELS)
        np.testing.assert_array_equal(
            out, np.asarray(M.mel_frontend(jnp.asarray(x[None])))[0])

    def test_batch_size_invariance(self, rng):
        """Each clip's frames do not depend on what else is in the batch."""
        x = rng.integers(-20000, 20000, (8, 16000)).astype(np.float32)
        fn = jax.jit(M.mel_frontend)
        whole = np.asarray(fn(jnp.asarray(x)))
        for i in (0, 5):
            np.testing.assert_allclose(
                whole[i], np.asarray(fn(jnp.asarray(x[i:i + 1])))[0],
                atol=1e-5)

    def test_bf16_output_equals_cast_of_f32(self, rng):
        """The benchmark's bf16-out mel is the f32 output rounded once."""
        import bench
        x = jnp.asarray(rng.integers(-20000, 20000, (4, 16000)), jnp.int16)
        b16 = np.asarray(jax.jit(bench._mel_bf16)(x))
        f32 = np.asarray(jax.jit(M.mel_frontend)(x))
        assert b16.dtype == np.dtype(jnp.bfloat16)
        np.testing.assert_array_equal(b16, f32.astype(jnp.bfloat16))
