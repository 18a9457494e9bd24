"""Scan-lean recurrent layers: input projections hoisted out of the scan.

`nn.RNN` over a GRU/LSTM cell computes the input-side gate projections
inside every scan step — T sequential small matmuls, each too small to
fill the device. These layers compute ALL input projections in one big
matmul up front; the scan body keeps only the irreducible recurrent
matmul and the gate nonlinearities.

Gate conventions follow the torch nn.GRU / nn.LSTM equations (the zoo's
parity target), with both input and recurrent biases.
"""

from __future__ import annotations

from nanowakeword_tpu import nn
import jax
import jax.numpy as jnp


class FastGRU(nn.Module):
    """Unidirectional GRU over [B, T, F] -> [B, T, H]."""

    hidden: int
    reverse: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        B, T, _ = x.shape
        H = self.hidden
        # all input projections at once: [B, T, 3H]
        xg = nn.Dense(3 * H, name="input_proj")(x)
        w_h = self.param("recurrent_kernel", nn.initializers.orthogonal(),
                         (H, 3 * H))
        b_h = self.param("recurrent_bias", nn.initializers.zeros, (3 * H,))

        if self.reverse:
            xg = jnp.flip(xg, axis=1)

        def step(h, xg_t):
            hg = h @ w_h + b_h
            xr, xz, xn = jnp.split(xg_t, 3, axis=-1)
            hr, hz, hn = jnp.split(hg, 3, axis=-1)
            r = jax.nn.sigmoid(xr + hr)
            z = jax.nn.sigmoid(xz + hz)
            n = jnp.tanh(xn + r * hn)
            h_new = (1.0 - z) * n + z * h
            return h_new, h_new

        # carry must match the step's compute dtype: bf16 inputs against f32
        # params promote the gates to f32, so the carry starts f32 too
        h0 = jnp.zeros((B, H), jnp.result_type(xg.dtype, w_h.dtype))
        _, out = jax.lax.scan(step, h0, jnp.swapaxes(xg, 0, 1))
        out = jnp.swapaxes(out, 0, 1)
        if self.reverse:
            out = jnp.flip(out, axis=1)
        return out


class FastLSTM(nn.Module):
    """Unidirectional LSTM over [B, T, F] -> [B, T, H]."""

    hidden: int
    reverse: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        B, T, _ = x.shape
        H = self.hidden
        xg = nn.Dense(4 * H, name="input_proj")(x)
        w_h = self.param("recurrent_kernel", nn.initializers.orthogonal(),
                         (H, 4 * H))
        b_h = self.param("recurrent_bias", nn.initializers.zeros, (4 * H,))

        if self.reverse:
            xg = jnp.flip(xg, axis=1)

        def step(carry, xg_t):
            h, c = carry
            hg = h @ w_h + b_h
            xi, xf, xgate, xo = jnp.split(xg_t, 4, axis=-1)
            hi, hf, hgate, ho = jnp.split(hg, 4, axis=-1)
            i = jax.nn.sigmoid(xi + hi)
            f = jax.nn.sigmoid(xf + hf)
            g = jnp.tanh(xgate + hgate)
            o = jax.nn.sigmoid(xo + ho)
            c_new = f * c + i * g
            h_new = o * jnp.tanh(c_new)
            return (h_new, c_new), h_new

        cdt = jnp.result_type(xg.dtype, w_h.dtype)
        init = (jnp.zeros((B, H), cdt), jnp.zeros((B, H), cdt))
        _, out = jax.lax.scan(step, init, jnp.swapaxes(xg, 0, 1))
        out = jnp.swapaxes(out, 0, 1)
        if self.reverse:
            out = jnp.flip(out, axis=1)
        return out
