"""Encoder geometry: full-sequence conv == windowed application (exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nanowakeword_tpu.models.embedding import (
    EMB_STRIDE, EMB_WINDOW, EMBEDDING_DIM, SpeechEmbeddingEncoder,
    n_embedding_frames,
)


@pytest.fixture(scope="module")
def encoder():
    enc = SpeechEmbeddingEncoder()
    params = enc.init(jax.random.PRNGKey(10), jnp.zeros((1, EMB_WINDOW, 32)))
    return enc, params


class TestGeometry:
    def test_single_window_gives_one_frame(self, encoder):
        enc, params = encoder
        out = enc.apply(params, jnp.zeros((2, EMB_WINDOW, 32)))
        assert out.shape == (2, 1, EMBEDDING_DIM)

    @pytest.mark.parametrize("T", [76, 84, 100, 131, 200, 204])
    def test_frame_count_contract(self, encoder, T):
        """Matches the reference contract n = (mel_frames - 76)//8 + 1
        (AudioFeatures.py:265)."""
        enc, params = encoder
        out = enc.apply(params, jnp.zeros((1, T, 32)))
        assert out.shape[1] == n_embedding_frames(T)

    @pytest.mark.parametrize("T", [100, 164, 200])
    def test_full_sequence_equals_windowed(self, encoder, rng, T):
        """The redesign's core claim: one conv pass over the whole
        mel sequence == the reference's explicit 76/8 windowing, exactly."""
        enc, params = encoder
        mel = jnp.asarray(rng.normal(size=(1, T, 32)).astype(np.float32))
        full = np.asarray(enc.apply(params, mel))

        n = n_embedding_frames(T)
        windows = jnp.stack(
            [mel[0, i * EMB_STRIDE: i * EMB_STRIDE + EMB_WINDOW] for i in range(n)]
        )
        windowed = np.asarray(enc.apply(params, windows))[:, 0, :]

        np.testing.assert_allclose(full[0], windowed, rtol=1e-5, atol=1e-5)

    def test_streaming_last_window(self, encoder, rng):
        """Streaming usage: encoding only the last 76 mel frames yields the
        same vector as the last frame of the full-sequence encoding."""
        enc, params = encoder
        mel = jnp.asarray(rng.normal(size=(1, 172, 32)).astype(np.float32))
        full = np.asarray(enc.apply(params, mel))
        last = np.asarray(enc.apply(params, mel[:, -EMB_WINDOW:]))
        # XLA picks different conv algorithms for the two input shapes, so
        # summation order differs; equality is up to float32 accumulation.
        np.testing.assert_allclose(full[0, -1], last[0, 0], atol=5e-3)


class TestArchRegistry:
    """build_encoder / infer_encoder_arch round-trips for every family."""

    @pytest.mark.parametrize("arch,width", [
        ("conv4", None), ("wide128", 128), ("wide256", 256)])
    def test_infer_roundtrip(self, arch, width):
        from nanowakeword_tpu.models.embedding import (build_encoder,
                                                       infer_encoder_arch)
        enc = build_encoder(arch)
        if width is not None:
            assert enc.width == width
        params = enc.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, EMB_WINDOW, 32)))
        assert infer_encoder_arch(params) == arch
        out = enc.apply(params, jnp.zeros((1, EMB_WINDOW, 32)))
        assert out.shape == (1, 1, EMBEDDING_DIM)

    def test_wide256_window_contract(self):
        """wide256 keeps the 76/8 fully-conv geometry of the family."""
        from nanowakeword_tpu.models.embedding import build_encoder
        enc = build_encoder("wide256")
        params = enc.init(jax.random.PRNGKey(1), jnp.zeros((1, 100, 32)))
        out = enc.apply(params, jnp.zeros((1, 100, 32)))
        assert out.shape == (1, n_embedding_frames(100), EMBEDDING_DIM)
