"""Device augmentation: SNR math, placement, pitch, RIR, SpecAugment."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanowakeword_tpu.ops import augment as A


def _rms(x):
    return float(np.sqrt(np.mean(np.asarray(x, np.float64) ** 2)))


class TestMixSNR:
    def test_snr_ratio_respected(self):
        rng = np.random.default_rng(0)
        n = 16000
        fg = jnp.asarray(0.1 * rng.normal(size=n).astype(np.float32))
        bg = jnp.asarray(0.05 * rng.normal(size=n).astype(np.float32))
        out = A.mix_snr(fg, bg, jnp.asarray(0), jnp.asarray(20.0),
                        jnp.asarray(True))
        # fg was scaled to be 20 dB above bg RMS
        fg_part = np.asarray(out) - np.asarray(bg)
        snr_measured = 20 * np.log10(_rms(fg_part) / _rms(bg))
        assert snr_measured == pytest.approx(20.0, abs=0.5)

    def test_placement_offset(self):
        fg = jnp.asarray(np.concatenate([np.ones(100, np.float32) * 0.5,
                                         np.zeros(900, np.float32)]))
        bg = jnp.zeros(1000)
        out = np.asarray(A.mix_snr(fg, bg, jnp.asarray(300),
                                   jnp.asarray(10.0), jnp.asarray(True)))
        assert np.abs(out[:300]).max() == 0.0
        assert np.abs(out[300:400]).max() > 0.0

    def test_silence_background_places_at_zero(self):
        fg = jnp.asarray(np.ones(100, np.float32) * 0.3)
        fg = jnp.pad(fg, (0, 900))
        bg = jnp.zeros(1000)
        out = np.asarray(A.mix_snr(fg, bg, jnp.asarray(500),
                                   jnp.asarray(10.0), jnp.asarray(False)))
        assert np.abs(out[:100]).max() > 0.0   # at the start, not offset 500
        np.testing.assert_allclose(out[:100], np.asarray(fg[:100]))

    def test_quiet_foreground_floored(self):
        """MIN_FG_RMS floor keeps the foreground audible
        (augment_clips.py:70-74)."""
        rng = np.random.default_rng(1)
        fg = jnp.asarray(1e-4 * rng.normal(size=1000).astype(np.float32))
        bg = jnp.asarray(1e-4 * rng.normal(size=1000).astype(np.float32))
        out = A.mix_snr(fg, bg, jnp.asarray(0), jnp.asarray(-40.0),
                        jnp.asarray(True))
        fg_part = np.asarray(out) - np.asarray(bg)
        # The floor boosts a near-silent foreground far above its raw level.
        # (Exact MIN_FG_RMS isn't reached because eps inside sqrt dominates
        # the RMS estimate at this amplitude — same as the reference's
        # torch.sqrt(mean + eps), augment_clips.py:59-74.)
        assert _rms(fg_part) > 10 * _rms(np.asarray(fg))


class TestPitch:
    def test_shifts_frequency(self):
        t = np.arange(16000) / 16000
        x = jnp.asarray(np.sin(2 * np.pi * 440 * t).astype(np.float32))
        up = np.asarray(A.resample_pitch(x, jnp.asarray(12.0),
                                         jnp.asarray(True)))
        # +12 semitones = 2x rate: zero crossings double in the valid region
        zc_orig = int((np.diff(np.sign(np.asarray(x)[:8000])) != 0).sum())
        zc_up = int((np.diff(np.sign(up[:4000])) != 0).sum())
        assert zc_up == pytest.approx(zc_orig, rel=0.1)


    def test_mxu_path_matches_numpy_interpolation(self):
        """The span-matmul formulation == explicit linear interpolation
        (up to the bf16 operand rounding of the weights)."""
        rng = np.random.default_rng(3)
        x = rng.normal(size=3200).astype(np.float32) * 16000
        for st in (-4.0, -0.5, 1.7, 4.0):
            got = np.asarray(A.resample_pitch(jnp.asarray(x),
                                              jnp.asarray(st),
                                              jnp.asarray(True)))
            rate = 2.0 ** (st / 12.0)
            pos = np.arange(3200) * rate
            lo = np.clip(np.floor(pos).astype(int), 0, 3199)
            frac = (pos - lo).astype(np.float32)
            ref = x[lo] * (1 - frac) + x[np.clip(lo + 1, 0, 3199)] * frac
            ref = np.where(pos <= 3199, ref, 0.0)
            # the interpolation weights round at bf16 (2^-9 relative), so
            # the error bound is the adjacent-sample delta x 2^-9; on this
            # white-noise signal deltas reach ~2x the peak amplitude
            atol = float(np.abs(x).max()) * 2.0 ** -8
            np.testing.assert_allclose(got, ref, atol=atol)
            # and the valid region must correlate near-perfectly
            v = pos <= 3199
            c = np.corrcoef(got[v], ref[v])[0, 1]
            assert c > 0.99999, c

    def test_fallback_path_matches_numpy(self):
        """Odd lengths take the direct-gather formulation; same math."""
        rng = np.random.default_rng(4)
        x = rng.normal(size=1000).astype(np.float32) * 8000
        got = np.asarray(A.resample_pitch(jnp.asarray(x), jnp.asarray(-3.0),
                                          jnp.asarray(True)))
        # mirror the fallback's float32 arithmetic exactly
        rate = np.float32(2.0 ** (np.float32(-3.0) / np.float32(12.0)))
        pos = (np.arange(1000, dtype=np.float32) * rate).astype(np.float32)
        lo = np.clip(np.floor(pos).astype(int), 0, 999)
        frac = (pos - lo).astype(np.float32)
        ref = x[lo] * (1 - frac) + x[np.clip(lo + 1, 0, 999)] * frac
        ref = np.where(pos <= 999, ref, 0.0)
        np.testing.assert_allclose(got, ref, atol=8000 * 2e-3)

    def test_noop_when_not_applied(self):
        x = jnp.asarray(np.random.default_rng(0).normal(
            size=1000).astype(np.float32))
        out = A.resample_pitch(x, jnp.asarray(2.0), jnp.asarray(False))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(x))

    def test_input_shorter_than_window_falls_back(self):
        """n a multiple of lcm(frame, blk) but < window must not take the
        MXU span path (n_windows would be non-positive) — regression for
        the blk 32->16 change that let n=80 through the length gate."""
        rng = np.random.default_rng(7)
        for n in (80, 112):
            x = rng.normal(size=n).astype(np.float32) * 8000
            got = np.asarray(A.resample_pitch(
                jnp.asarray(x), jnp.asarray(-3.0), jnp.asarray(True)))
            rate = np.float32(2.0 ** (np.float32(-3.0) / np.float32(12.0)))
            pos = (np.arange(n, dtype=np.float32) * rate).astype(np.float32)
            lo = np.clip(np.floor(pos).astype(int), 0, n - 1)
            frac = (pos - lo).astype(np.float32)
            ref = x[lo] * (1 - frac) + x[np.clip(lo + 1, 0, n - 1)] * frac
            ref = np.where(pos <= n - 1, ref, 0.0)
            np.testing.assert_allclose(got, ref, atol=8000 * 2e-3)


class TestRIR:
    def test_convolution_smears_impulse(self):
        x = jnp.zeros(1000).at[100].set(1.0)
        rir = jnp.zeros(200).at[0].set(1.0).at[50].set(0.5)
        out = np.asarray(A.rir_convolve(x, rir, jnp.asarray(True)))
        # echo at 150 with half the energy of the direct path at 100
        assert abs(out[150] / out[100] - 0.5) < 0.05

    def test_preserves_rms(self):
        rng = np.random.default_rng(2)
        x = jnp.asarray(0.2 * rng.normal(size=4000).astype(np.float32))
        rir = jnp.asarray(np.exp(-np.arange(400) / 50).astype(np.float32))
        out = A.rir_convolve(x, rir, jnp.asarray(True))
        assert _rms(out) == pytest.approx(_rms(np.asarray(x)), rel=0.05)

    def test_matches_full_linear_convolution(self):
        """The chosen FFT length (possibly 9*2^a, not pow2) must still give
        the exact linear convolution on [0, n) — no circular wraparound."""
        rng = np.random.default_rng(7)
        n, r_len = 4000, 257
        x = rng.normal(size=n).astype(np.float32) * 0.1
        rir = rng.normal(size=r_len).astype(np.float32) \
            * np.exp(-np.arange(r_len) / 40)
        got = np.asarray(A.rir_convolve(jnp.asarray(x), jnp.asarray(rir),
                                        jnp.asarray(True)))
        rn = rir / np.abs(rir).max()
        ref = np.convolve(x, rn)[:n]
        ref = ref * (np.sqrt(np.mean(x * x) + A.EPS)
                     / np.sqrt(np.mean(ref[:n] ** 2) + A.EPS))
        np.testing.assert_allclose(got, ref, atol=5e-4)

    def test_fft_len_chooser(self):
        for target in (5, 9, 10, 100, 4256, 17599, 18432, 18433, 33599,
                       49599, 100000):
            length = A._fft_len(target)
            assert length >= target
            # member of {2^a, 9*2^a}
            while length % 2 == 0:
                length //= 2
            assert length in (1, 9)
            # never worse than the old next-pow2 policy
            assert A._fft_len(target) <= A._next_pow2(target)


class TestBatch:
    def test_shapes_dtype_and_determinism(self):
        rng = np.random.default_rng(3)
        B, L = 4, 8000
        fg = rng.integers(-8000, 8000, (B, L)).astype(np.float32)
        bg = rng.integers(-2000, 2000, (B, L)).astype(np.float32)
        rir = np.zeros((B, 1600), np.float32)
        args = (fg, bg, rir, np.full(B, L, np.int32), np.ones(B, bool),
                np.zeros(B, bool))
        params = A.AugmentParams.from_settings(None)
        out1 = np.asarray(A.augment_batch(jax.random.PRNGKey(7), *args,
                                          params))
        out2 = np.asarray(A.augment_batch(jax.random.PRNGKey(7), *args,
                                          params))
        assert out1.shape == (B, L) and out1.dtype == np.int16
        np.testing.assert_array_equal(out1, out2)
        out3 = np.asarray(A.augment_batch(jax.random.PRNGKey(8), *args,
                                          params))
        assert not np.array_equal(out1, out3)

    def test_volume_targets(self):
        rng = np.random.default_rng(4)
        fg = rng.integers(-12000, 12000, (8, 4000)).astype(np.float32)
        params = A.AugmentParams.from_settings(
            {"pitch_prob": 0.0, "rir_prob": 0.0, "gain_prob": 0.0})
        out = np.asarray(A.augment_batch(
            jax.random.PRNGKey(0), fg, np.zeros_like(fg),
            np.zeros((8, 100), np.float32), np.full(8, 4000, np.int32),
            np.ones(8, bool), np.zeros(8, bool), params))
        peaks = np.abs(out).max(axis=1) / 32767.0
        assert ((peaks >= 0.45) & (peaks <= 1.0)).all()


class TestBlockAlignedShift:
    def test_matches_full_path_on_aligned_offsets(self):
        """block_aligned skips the fine stage; for offsets that are
        multiples of 128 the result must be bit-identical to the full
        three-dot path (which is itself bit-identical to roll)."""
        x = jnp.asarray(np.random.default_rng(0).normal(
            0, 0.4, 1280).astype(np.float32))
        for off in (0, 128, 512, 1152):
            full = A._shift_right(x, jnp.int32(off))
            fast = A._shift_right(x, jnp.int32(off), block_aligned=True)
            np.testing.assert_array_equal(np.asarray(full), np.asarray(fast))

    def test_batch_offsets_are_quantized(self):
        """With the default offset_quantum, every foreground onset in the
        batch lands on the 128-sample grid (fg starts with a marker spike;
        bg is silence so placement is offset 0? no — has_bg True)."""
        B, L = 8, 2560
        fg = np.zeros((B, L), np.float32)
        fg[:, 0] = 20000.0                       # onset marker
        bg = np.full((B, L), 1.0, np.float32)    # flat, non-zero bg
        params = A.AugmentParams.from_settings(
            {"pitch_prob": 0.0, "rir_prob": 0.0, "gain_prob": 0.0,
             "min_snr_in_db": 30.0, "max_snr_in_db": 30.0,
             "min_volume_augmentation": 1.0, "max_volume_augmentation": 1.0})
        out = np.asarray(A.augment_batch(
            jax.random.PRNGKey(3), fg, bg, np.zeros((B, 100), np.float32),
            np.full(B, 256, np.int32), np.ones(B, bool), np.zeros(B, bool),
            params)).astype(np.float32)
        onsets = np.abs(out).argmax(axis=1)
        assert (onsets % 128 == 0).all(), onsets
        assert len(set(onsets.tolist())) > 1    # still randomly placed


class TestGroupedPitch:
    """Rate-quantized grouped pitch (resample_pitch_grouped + the
    augment_batch fast path around it)."""

    def test_matches_per_clip_path_bit_exact(self):
        """Each group's output must equal resample_pitch at the same grid
        rate — the grouped restructure only shares the weight/selector
        generation across the batch, the contractions are unchanged."""
        B, n, R = 32, 3200, 8
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.normal(0, 0.3, (B, n)).astype(np.float32))
        grid = A.pitch_grid(-2.0, 2.0, R)
        perm = jnp.asarray(np.random.default_rng(1).permutation(R),
                           jnp.int32)
        apply = jnp.asarray(rng.random(B) < 0.7)
        w = A.pitch_window(2.0)
        out = np.asarray(A.resample_pitch_grouped(x, grid, perm, apply,
                                                  window=w))
        G = B // R
        for b in range(B):
            ref = A.resample_pitch(x[b], jnp.float32(grid[int(perm[b // G])]),
                                   apply[b], window=w)
            np.testing.assert_array_equal(out[b], np.asarray(ref))

    def test_apply_false_passthrough(self):
        B, n, R = 16, 3200, 8
        x = jnp.asarray(np.random.default_rng(2).normal(
            0, 0.3, (B, n)).astype(np.float32))
        out = A.resample_pitch_grouped(
            x, A.pitch_grid(-2.0, 2.0, R), jnp.arange(R),
            jnp.zeros(B, bool), window=A.pitch_window(2.0))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(x))

    def _batch_args(self, B=16, L=8000, seed=3):
        rng = np.random.default_rng(seed)
        fg = rng.integers(-8000, 8000, (B, L)).astype(np.float32)
        bg = rng.integers(-2000, 2000, (B, L)).astype(np.float32)
        return (fg, bg, np.zeros((B, 1600), np.float32),
                np.full(B, L, np.int32), np.ones(B, bool),
                np.zeros(B, bool))

    def test_batch_ungated_clips_identical_across_paths(self):
        """The pre/pitch/post decomposition must draw bit-identical
        randomness to the fused chain: clips whose pitch gate is OFF come
        out bit-equal whether pitch_grid is on or off — and gated-on clips
        must differ (proof the grouped path actually engaged rather than
        silently falling back)."""
        args = self._batch_args()
        key = jax.random.PRNGKey(11)
        p_grid = A.AugmentParams.from_settings({"rir_prob": 0.0,
                                                "pitch_grid_rates": 16,
                                                "pitch_rational": False})
        p_cont = A.AugmentParams.from_settings({"rir_prob": 0.0,
                                                "pitch_grid_rates": 0})
        out_g = np.asarray(A.augment_batch(key, *args, p_grid))
        out_c = np.asarray(A.augment_batch(key, *args, p_cont))
        keys = jax.random.split(key, args[0].shape[0])
        gate = np.asarray(jax.vmap(A._pitch_gate, in_axes=(0, None))(
            keys, p_grid))
        assert gate.any() and not gate.all()   # seed chosen to cover both
        np.testing.assert_array_equal(out_g[~gate], out_c[~gate])
        assert (out_g[gate] != out_c[gate]).any(axis=1).all()

    def test_batch_falls_back_when_not_divisible(self):
        """B not divisible by the grid size -> bit-identical to the
        continuous path (the fast-path gate must not change semantics)."""
        args = self._batch_args(B=12)
        key = jax.random.PRNGKey(5)
        out_g = np.asarray(A.augment_batch(
            key, *args,
            A.AugmentParams.from_settings({"rir_prob": 0.0,
                                           "pitch_grid_rates": 16,
                                           "pitch_rational": False})))
        out_c = np.asarray(A.augment_batch(
            key, *args,
            A.AugmentParams.from_settings({"rir_prob": 0.0,
                                           "pitch_grid_rates": 0})))
        np.testing.assert_array_equal(out_g, out_c)

    def test_rate_stratification(self):
        """With pitch_prob=1 every batch position group gets one grid rate;
        a pure tone's zero-crossing rate per group must scale with it."""
        B, L, R = 16, 8000, 4
        t = np.arange(L) / 16000.0
        fg = np.tile((np.sin(2 * np.pi * 440 * t) * 8000).astype(np.float32),
                     (B, 1))
        key = jax.random.PRNGKey(9)
        params = A.AugmentParams.from_settings(
            {"rir_prob": 0.0, "gain_prob": 0.0, "pitch_prob": 1.0,
             "min_pitch_semitones": -6.0, "max_pitch_semitones": 6.0,
             "pitch_grid_rates": R, "pitch_rational": False,
             "min_volume_augmentation": 0.8,
             "max_volume_augmentation": 0.8})
        out = np.asarray(A.augment_batch(
            key, fg, np.zeros_like(fg), np.zeros((B, 100), np.float32),
            np.full(B, L, np.int32), np.ones(B, bool), np.zeros(B, bool),
            params)).astype(np.float32)
        grid = A.pitch_grid(-6.0, 6.0, R)
        perm = np.asarray(jax.random.permutation(
            jax.random.fold_in(key, 106), R))
        G = B // R
        for g in range(R):
            rate = 2.0 ** (grid[perm[g]] / 12.0)
            m = int(L / max(rate, 1.0) * 0.9)   # stay inside valid region
            zc = np.mean([(np.diff(np.sign(out[b, :m])) != 0).sum() / m
                          for b in range(g * G, (g + 1) * G)])
            want = 2 * 440 * rate / 16000.0
            assert zc == pytest.approx(want, rel=0.08), (g, zc, want)


class TestRationalPitch:
    """Rational-rate pitch (resample_pitch_rational + the augment_batch
    fast path around it): p/64 static numerators, interleaved slot->rate
    assignment (clip b at rate p_grid[b % R])."""

    def test_matches_explicit_linear_interp(self):
        """Each clip must equal explicit linear interpolation at its
        slot's p/64 rate within the bf16 operand-rounding bound (the same
        tolerance resample_pitch is held to)."""
        B, n, R = 8, 1280, 4
        rng = np.random.default_rng(0)
        x = rng.normal(0, 0.3, (B, n)).astype(np.float32)
        pgrid = (57, 62, 68, 72)
        out = np.asarray(A.resample_pitch_rational(
            jnp.asarray(x), pgrid, jnp.ones(B, bool)))
        for b in range(B):
            p = pgrid[b % R]
            pos = np.arange(n) * p / 64.0
            lo = np.clip(np.floor(pos).astype(int), 0, n - 1)
            frac = (pos - lo).astype(np.float32)
            ref = x[b, lo] * (1 - frac) \
                + x[b, np.clip(lo + 1, 0, n - 1)] * frac
            ref = np.where(pos <= n - 1, ref, 0.0)
            tol = np.abs(x[b]).max() * 2.0 ** -8
            assert np.abs(out[b] - ref).max() < tol, b

    def test_interleave_matches_single_rate_exactly(self):
        """Slots r::R must be bit-identical to a single-rate call at
        pgrid[r] on just those slots — the interleaved strided
        slice/stack must not perturb the payload."""
        B, n, R = 8, 640, 4
        rng = np.random.default_rng(1)
        x = jnp.asarray(rng.normal(0, 0.3, (B, n)).astype(np.float32))
        pgrid = (57, 62, 68, 72)
        out = np.asarray(A.resample_pitch_rational(
            x, pgrid, jnp.ones(B, bool)))
        for r in range(R):
            single = np.asarray(A.resample_pitch_rational(
                x[r::R], (pgrid[r],), jnp.ones(B // R, bool)))
            np.testing.assert_array_equal(out[r::R], single)

    def test_apply_false_passthrough(self):
        B, n = 8, 640
        x = jnp.asarray(np.random.default_rng(2).normal(
            0, 0.3, (B, n)).astype(np.float32))
        out = A.resample_pitch_rational(x, (57, 62, 68, 72),
                                        jnp.zeros(B, bool))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(x))

    def test_batch_ungated_clips_identical_across_paths(self):
        """Gate-off clips bit-equal to the continuous chain, gate-on clips
        differ — proof the rational path engaged inside augment_batch."""
        rng = np.random.default_rng(3)
        B, L = 16, 8000
        fg = rng.integers(-8000, 8000, (B, L)).astype(np.float32)
        bg = rng.integers(-2000, 2000, (B, L)).astype(np.float32)
        args = (fg, bg, np.zeros((B, 1600), np.float32),
                np.full(B, L, np.int32), np.ones(B, bool),
                np.zeros(B, bool))
        key = jax.random.PRNGKey(11)
        p_rat = A.AugmentParams.from_settings(
            {"rir_prob": 0.0, "pitch_grid_rates": 16,
             "pitch_rational": True})
        p_cont = A.AugmentParams.from_settings({"rir_prob": 0.0,
                                                "pitch_grid_rates": 0})
        out_r = np.asarray(A.augment_batch(key, *args, p_rat))
        out_c = np.asarray(A.augment_batch(key, *args, p_cont))
        keys = jax.random.split(key, B)
        gate = np.asarray(jax.vmap(A._pitch_gate, in_axes=(0, None))(
            keys, p_rat))
        assert gate.any() and not gate.all()
        np.testing.assert_array_equal(out_r[~gate], out_c[~gate])
        assert (out_r[gate] != out_c[gate]).any(axis=1).all()

    def test_batch_falls_back_to_grouped_when_not_64_divisible(self):
        """n % 64 != 0 but grouped-path-compatible -> bit-identical to the
        grouped path (gate ordering must not change semantics)."""
        rng = np.random.default_rng(4)
        B, L = 16, 2000                        # 2000 % 64 != 0, % 80 == 0
        fg = rng.integers(-8000, 8000, (B, L)).astype(np.float32)
        args = (fg, np.zeros_like(fg), np.zeros((B, 100), np.float32),
                np.full(B, L, np.int32), np.ones(B, bool),
                np.zeros(B, bool))
        key = jax.random.PRNGKey(7)
        out_r = np.asarray(A.augment_batch(key, *args,
                           A.AugmentParams.from_settings(
                               {"rir_prob": 0.0, "pitch_grid_rates": 16,
                                "pitch_rational": True})))
        out_g = np.asarray(A.augment_batch(key, *args,
                           A.AugmentParams.from_settings(
                               {"rir_prob": 0.0, "pitch_grid_rates": 16,
                                "pitch_rational": False})))
        np.testing.assert_array_equal(out_r, out_g)

    def test_rate_stratification(self):
        """A pure tone's zero-crossing rate per interleaved slot class
        (b % R) must scale with that slot's p/64 rate — and every
        contiguous R-slot window therefore sees all R rates."""
        B, L, R = 16, 8192, 4
        t = np.arange(L) / 16000.0
        fg = np.tile((np.sin(2 * np.pi * 440 * t) * 8000).astype(np.float32),
                     (B, 1))
        key = jax.random.PRNGKey(9)
        params = A.AugmentParams.from_settings(
            {"rir_prob": 0.0, "gain_prob": 0.0, "pitch_prob": 1.0,
             "min_pitch_semitones": -6.0, "max_pitch_semitones": 6.0,
             "pitch_grid_rates": R, "pitch_rational": True,
             "min_volume_augmentation": 0.8,
             "max_volume_augmentation": 0.8})
        out = np.asarray(A.augment_batch(
            key, fg, np.zeros_like(fg), np.zeros((B, 100), np.float32),
            np.full(B, L, np.int32), np.ones(B, bool), np.zeros(B, bool),
            params)).astype(np.float32)
        pgrid = A.pitch_pgrid(-6.0, 6.0, R)
        for r in range(R):
            rate = pgrid[r] / 64.0
            m = int(L / max(rate, 1.0) * 0.9)
            zc = np.mean([(np.diff(np.sign(out[b, :m])) != 0).sum() / m
                          for b in range(r, B, R)])
            want = 2 * 440 * rate / 16000.0
            assert zc == pytest.approx(want, rel=0.08), (r, zc, want)


class TestChannelRobustness:
    """mu-law codec round-trip + random band-limit (encoder-pretraining
    channel-robustness pair; both off by default)."""

    def _run(self, fg, **settings):
        base = {"pitch_prob": 0.0, "rir_prob": 0.0, "gain_prob": 0.0,
                "min_volume_augmentation": 0.8,
                "max_volume_augmentation": 0.8}
        base.update(settings)
        params = A.AugmentParams.from_settings(base)
        B = fg.shape[0]
        return np.asarray(A.augment_batch(
            jax.random.PRNGKey(5), fg, np.zeros_like(fg),
            np.zeros((B, 100), np.float32),
            np.full(B, fg.shape[1], np.int32),
            np.ones(B, bool), np.zeros(B, bool), params)) / 32767.0

    def test_bandlimit_attenuates_high_frequencies(self):
        t = np.arange(8000) / 16000.0
        hi = (0.5 * np.sin(2 * np.pi * 7600.0 * t))[None].astype(np.float32)
        clean = self._run(hi.copy())
        limited = self._run(hi.copy(), bandlimit_prob=1.0)
        spec_c = np.abs(np.fft.rfft(clean[0]))
        spec_l = np.abs(np.fft.rfft(limited[0]))
        band = slice(int(7600 / 16000 * 8000) - 50,
                     int(7600 / 16000 * 8000) + 50)
        # the 7.6 kHz tone sits above every random cutoff (2-7 kHz)
        assert spec_l[band].max() < 0.5 * spec_c[band].max()

    def test_companding_quantises_but_preserves_signal(self):
        rng = np.random.default_rng(11)
        fg = rng.normal(0, 0.2, (4, 4000)).astype(np.float32)
        clean = self._run(fg.copy())
        coded = self._run(fg.copy(), companding_prob=1.0)
        err = coded - clean
        assert np.abs(err).max() > 0            # the codec did something
        snr_db = 10 * np.log10(np.mean(clean ** 2) / np.mean(err ** 2))
        assert snr_db > 20.0                    # ...but only codec noise

    def test_disabled_probs_do_not_change_draws(self):
        """probs=0 must be bit-identical to a build without the features
        (static gates + fold_in keys: no retrace of the existing chain)."""
        rng = np.random.default_rng(12)
        fg = rng.integers(-12000, 12000, (4, 4000)).astype(np.float32)
        base = self._run(fg.copy())
        explicit = self._run(fg.copy(), companding_prob=0.0,
                             bandlimit_prob=0.0)
        np.testing.assert_array_equal(base, explicit)


class TestSettingsOverride:
    def test_from_settings(self):
        p = A.AugmentParams.from_settings({"min_snr_in_db": 15.0,
                                           "rir_prob": 0.0})
        assert p.min_snr == 15.0 and p.rir_prob == 0.0
        assert p.gain_prob == 1.0  # default preserved


class TestSpecAugment:
    def test_masks_applied(self):
        rng = np.random.default_rng(5)
        mel = jnp.asarray(rng.normal(loc=2.0, size=(3, 50, 32))
                          .astype(np.float32))
        out = np.asarray(A.spec_augment(jax.random.PRNGKey(0), mel))
        assert out.shape == mel.shape
        assert (out == np.asarray(mel).min()).sum() > 0  # something masked


class TestPreStage:
    """The 128-aligned shift / scale / mix / gain pre-stage against a
    numpy reference computed from the same per-clip draws."""

    @staticmethod
    def _inputs(B, n, seed):
        rng = np.random.default_rng(seed)
        fg = (rng.integers(-16000, 16000, (B, n)) / 32768.0).astype(
            np.float32)
        bg = (rng.integers(-3000, 3000, (B, n)) / 32768.0).astype(np.float32)
        fg_lens = rng.integers(n // 2, n + 1, B).astype(np.int32)
        has_bg = rng.random(B) < 0.7
        has_bg[:2] = [True, False]
        return fg, bg, fg_lens, has_bg

    def _numpy_pre(self, key, fg, bg, fg_len, has_bg, params):
        n = fg.shape[-1]
        offset, snr_db, gain_db, apply_gain = (
            np.asarray(v) for v in A._pre_draws(key, fg_len, n, params))
        fg64, bg64 = fg.astype(np.float64), bg.astype(np.float64)
        fg_rms = np.sqrt(np.mean(fg64 ** 2) + A.EPS)
        bg_rms = max(np.sqrt(np.mean(bg64 ** 2) + A.EPS), A.MIN_BG_RMS)
        scale = 10.0 ** (snr_db / 20.0) * bg_rms / fg_rms
        if scale * fg_rms < A.MIN_FG_RMS:
            scale *= A.MIN_FG_RMS / max(scale * fg_rms, A.EPS)
        off = int(offset) if has_bg else 0
        shifted = np.zeros(n)
        shifted[off:] = fg64[:n - off]
        out = bg64 + shifted * scale if has_bg else shifted
        return out * (10.0 ** (gain_db / 20.0) if apply_gain else 1.0), off

    @pytest.mark.parametrize("n", [1280, 2560])
    def test_matches_numpy_reference(self, n):
        B = 8
        fg, bg, fg_lens, has_bg = self._inputs(B, n, seed=n)
        params = A.AugmentParams.from_settings({"rir_prob": 0.0})
        assert A._offset_aligned(n, params)
        keys = jax.random.split(jax.random.PRNGKey(5), B)
        got = np.asarray(jax.vmap(
            A._augment_pre, in_axes=(0, 0, 0, 0, 0, None))(
                keys, jnp.asarray(fg), jnp.asarray(bg), jnp.asarray(fg_lens),
                jnp.asarray(has_bg), params))
        for b in range(B):
            want, off = self._numpy_pre(keys[b], fg[b], bg[b], fg_lens[b],
                                        has_bg[b], params)
            assert off % 128 == 0
            # float32 against float64: a few ulp of the clip's peak
            tol = 2.0 ** -20 * max(np.abs(want).max(), 1.0)
            assert np.abs(got[b] - want).max() <= tol, b
