"""A small neural-network layer library: the subset of Flax linen the zoo uses.

The models are written in the linen style (`Module` dataclasses with
`@compact` methods, `init`/`apply` over variable collections) and this
module implements exactly that surface on plain JAX, so the framework has no
dependency beyond JAX itself. It keeps linen's conventions where they are
visible outside the module:

* parameter trees: automatic child names (`Dense_0`, `Conv_1`, ...), field
  submodules named after their field (`backbone`), explicit `name=`;
* collections: `params`, `batch_stats`; `apply(..., mutable=[...])` returns
  `(out, updated_collections)`;
* initialisers and their random streams: a parameter's key is the root key
  folded with the SHA-1 of its scope path and a per-scope counter, so a given
  seed initialises the same values as linen does;
* the layer numerics (dtype promotion, float32 normalisation statistics,
  attention scaling).

Layers: Dense, DenseGeneral, Conv, LayerNorm, BatchNorm, Dropout,
MultiHeadDotProductAttention (and SelfAttention), GRUCell, OptimizedLSTMCell,
RNN, max_pool / avg_pool, and the activations re-exported from `jax.nn`.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

initializers = jax.nn.initializers
relu = jax.nn.relu
gelu = jax.nn.gelu
silu = jax.nn.silu
sigmoid = jax.nn.sigmoid
tanh = jnp.tanh
softmax = jax.nn.softmax
one_hot = jax.nn.one_hot
logsumexp = jax.nn.logsumexp

default_kernel_init = initializers.lecun_normal()

_ctx = threading.local()


def _stack() -> list:
    if not hasattr(_ctx, "stack"):
        _ctx.stack = []
    return _ctx.stack


# ---------------------------------------------------------------------------
# Variable state and random streams
# ---------------------------------------------------------------------------

class _State:
    """Variables, random streams and flags of one `init`/`apply` call."""

    def __init__(self, variables, rngs, mutable, initializing):
        self.variables = variables
        self.rngs = rngs
        self.mutable = mutable
        self.initializing = initializing
        self.rng_counters: dict = {}

    def is_mutable(self, col: str) -> bool:
        return self.mutable is True or col in self.mutable

    def lookup(self, col: str, path: tuple, create: bool = False):
        d = self.variables.get(col)
        if d is None:
            if not create:
                return None
            d = self.variables[col] = {}
        for p in path:
            nxt = d.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = d[p] = {}
            d = nxt
        return d

    def make_rng(self, name: str, path: tuple):
        if name not in self.rngs:
            if "params" not in self.rngs:
                raise ValueError(f"module at {'/'.join(path) or '<root>'} "
                                 f"needs a PRNG key for '{name}'")
            name = "params"
        count = self.rng_counters.get((path, name), 0) + 1
        self.rng_counters[(path, name)] = count
        return _fold_in_static(self.rngs[name], path + (count,))


def _fold_in_static(key, data: tuple):
    """Fold static names and counters into a key by their SHA-1 (linen's
    scheme: one hash over the whole suffix, no separators)."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    h = int.from_bytes(m.digest()[:4], "big")
    return jax.random.fold_in(key, jnp.uint32(h))


def _copy_tree(d):
    return {k: _copy_tree(v) for k, v in d.items()} if isinstance(d, dict) \
        else d


class Variable:
    """A handle on one entry of a non-parameter collection."""

    def __init__(self, module: "Module", col: str, name: str):
        self._module, self._col, self._name = module, col, name

    @property
    def value(self):
        return self._module._state.lookup(self._col, self._module._path)[
            self._name]

    @value.setter
    def value(self, v):
        st = self._module._state
        if not st.is_mutable(self._col):
            raise ValueError(f"collection '{self._col}' is not mutable; "
                             "pass mutable=[...] to apply")
        st.lookup(self._col, self._module._path, create=True)[self._name] = v


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

def compact(fn):
    """Mark a method whose body creates submodules and parameters inline."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._state is None:
            raise ValueError(f"{type(self).__name__} is unbound: call it "
                             "through .init() or .apply()")
        outer = self._in_call
        if not outer:
            self._autoname = {}
        self._in_call = True
        _stack().append(self)
        try:
            return fn(self, *args, **kwargs)
        finally:
            _stack().pop()
            self._in_call = outer

    return wrapped


class Module:
    """Dataclass base of every layer and model.

    A module constructed inside another's `@compact` method is a child of
    that module and takes the name `<Class>_<n>` unless given `name=`.
    A module held in a field of its parent takes the field's name.
    """

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, unsafe_hash="__hash__" not in cls.__dict__,
                              repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_state", None)
        object.__setattr__(self, "_path", ())
        object.__setattr__(self, "_in_call", False)
        object.__setattr__(self, "_autoname", {})
        stack = _stack()
        if stack:
            parent = stack[-1]
            name = self.name
            if name is None:
                cls = type(self).__name__
                n = parent._autoname.get(cls, 0)
                parent._autoname[cls] = n + 1
                name = f"{cls}_{n}"
            self._bind(parent._state, parent._path + (name,))

    def _bind(self, state: _State, path: tuple):
        object.__setattr__(self, "_state", state)
        object.__setattr__(self, "_path", path)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Module) and v._state is None:
                child = v.clone()
                child._bind(state, path + (f.name,))
                object.__setattr__(self, f.name, child)

    def clone(self) -> "Module":
        """An unbound copy."""
        saved, _ctx.stack = _stack(), []
        try:
            return dataclasses.replace(self)
        finally:
            _ctx.stack = saved

    # -- variables -----------------------------------------------------------

    def param(self, name: str, init_fn: Callable, *init_args):
        st = self._state
        d = st.lookup("params", self._path)
        if d is not None and name in d:
            return d[name]
        if not st.is_mutable("params"):
            raise ValueError(f"missing parameter '{name}' at "
                             f"{'/'.join(self._path) or '<root>'}")
        value = init_fn(st.make_rng("params", self._path), *init_args)
        st.lookup("params", self._path, create=True)[name] = value
        return value

    def variable(self, col: str, name: str, init_fn: Callable, *init_args):
        st = self._state
        d = st.lookup(col, self._path)
        if d is None or name not in d:
            if not st.is_mutable(col):
                raise ValueError(f"missing variable '{col}/{name}' at "
                                 f"{'/'.join(self._path) or '<root>'}")
            st.lookup(col, self._path, create=True)[name] = init_fn(*init_args)
        return Variable(self, col, name)

    def make_rng(self, name: str = "params"):
        return self._state.make_rng(name, self._path)

    def is_initializing(self) -> bool:
        return self._state.initializing

    # -- entry points ----------------------------------------------------------

    def _run(self, state: _State, args, kwargs):
        root = self.clone()
        saved, _ctx.stack = _stack(), []
        try:
            root._bind(state, ())
            return root(*args, **kwargs)
        finally:
            _ctx.stack = saved

    def init(self, rngs, *args, **kwargs) -> dict:
        """Create every variable by tracing one call; return the collections."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        state = _State({}, rngs, True, True)
        self._run(state, args, kwargs)
        return state.variables

    def apply(self, variables: dict, *args, rngs=None, mutable=False,
              **kwargs):
        """Run with the given variables. With `mutable` (a collection name, a
        list of names or True) return `(out, updated_collections)`."""
        if isinstance(mutable, str):
            mutable = (mutable,)
        cols = dict(variables)
        if mutable is not False:
            for c in (cols if mutable is True else mutable):
                if c in cols:
                    cols[c] = _copy_tree(cols[c])
        rngs = {} if rngs is None else \
            (rngs if isinstance(rngs, dict) else {"params": rngs})
        state = _State(cols, rngs, mutable or (), False)
        out = self._run(state, args, kwargs)
        if mutable is False:
            return out
        keep = cols if mutable is True else mutable
        return out, {c: state.variables[c] for c in keep
                     if c in state.variables}


dataclasses.dataclass(Module, unsafe_hash=True, repr=False)


def merge_param(name: str, a, b):
    if (a is None) == (b is None):
        raise ValueError(f"'{name}' must be given exactly once: as a "
                         "field or as a call argument")
    return a if b is None else b


def _promote(*args, dtype=None):
    if dtype is None:
        dtype = jnp.result_type(*[a for a in args if a is not None])
        if not jnp.issubdtype(dtype, jnp.inexact):
            dtype = jnp.promote_types(jnp.float32, dtype)
    return [None if a is None else jnp.asarray(a, dtype) for a in args]


# ---------------------------------------------------------------------------
# Linear layers
# ---------------------------------------------------------------------------

class Dense(Module):
    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (jnp.shape(x)[-1], self.features),
                            self.param_dtype)
        bias = self.param("bias", self.bias_init, (self.features,),
                          self.param_dtype) if self.use_bias else None
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.dot_general(x, kernel, (((x.ndim - 1,), (0,)), ((), ())),
                            precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
        return y


class DenseGeneral(Module):
    """Dense over the last `len(axis)` input axes into `features` axes."""

    features: Any
    axis: Any = -1
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        features = tuple(self.features) if isinstance(
            self.features, (tuple, list)) else (self.features,)
        axis = tuple(self.axis) if isinstance(self.axis, (tuple, list)) \
            else (self.axis,)
        axis = tuple(a % x.ndim for a in axis)
        n_in = int(np.prod([x.shape[a] for a in axis]))
        n_out = int(np.prod(features))
        kernel_shape = tuple(x.shape[a] for a in axis) + features

        def kernel_init(key, shape, dtype):
            return jnp.reshape(self.kernel_init(key, (n_in, n_out), dtype),
                               shape)

        def bias_init(key, shape, dtype):
            return jnp.reshape(self.bias_init(key, (n_out,), dtype), shape)

        kernel = self.param("kernel", kernel_init, kernel_shape,
                            self.param_dtype)
        bias = self.param("bias", bias_init, features, self.param_dtype) \
            if self.use_bias else None
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        contract = tuple(range(len(axis)))
        y = lax.dot_general(x, kernel, ((axis, contract), ((), ())),
                            precision=self.precision)
        if bias is not None:
            y += jnp.reshape(bias, (1,) * (y.ndim - len(features)) + features)
        return y


def _tuple(x, n: int) -> tuple:
    if x is None:
        x = 1
    return (x,) * n if isinstance(x, int) else tuple(x)


class Conv(Module):
    """N-d convolution over channels-last input [batch..., spatial..., C]."""

    features: int
    kernel_size: Any
    strides: Any = 1
    padding: Any = "SAME"
    kernel_dilation: Any = 1
    feature_group_count: int = 1
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        ks = (self.kernel_size,) if isinstance(self.kernel_size, int) \
            else tuple(self.kernel_size)
        nsp = len(ks)
        n_batch = x.ndim - (nsp + 1)
        batch_shape = x.shape[:n_batch]
        if n_batch != 1:
            x = jnp.reshape(x, (-1,) + x.shape[n_batch:])
        padding = self.padding
        if isinstance(padding, int):
            padding = [(padding, padding)] * nsp
        elif not isinstance(padding, str):
            padding = [(p, p) if isinstance(p, int) else tuple(p)
                       for p in padding]
        nd = x.ndim
        lhs = (0, nd - 1) + tuple(range(1, nd - 1))
        dn = lax.ConvDimensionNumbers(lhs, (nd - 1, nd - 2)
                                      + tuple(range(nd - 2)), lhs)
        c_in = x.shape[-1]
        kernel = self.param("kernel", self.kernel_init,
                            ks + (c_in // self.feature_group_count,
                                  self.features), self.param_dtype)
        bias = self.param("bias", self.bias_init, (self.features,),
                          self.param_dtype) if self.use_bias else None
        x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
        y = lax.conv_general_dilated(
            x, kernel, _tuple(self.strides, nsp), padding,
            rhs_dilation=_tuple(self.kernel_dilation, nsp),
            dimension_numbers=dn,
            feature_group_count=self.feature_group_count,
            precision=self.precision)
        if bias is not None:
            y += bias.reshape((1,) * (y.ndim - 1) + bias.shape)
        if n_batch != 1:
            y = jnp.reshape(y, batch_shape + y.shape[1:])
        return y


# ---------------------------------------------------------------------------
# Normalisation and dropout
# ---------------------------------------------------------------------------

def _stats(x, axes, dtype):
    """Mean and variance in at least float32 (E[x^2] - E[x]^2, clipped)."""
    dtype = jnp.promote_types(dtype or jnp.result_type(x), jnp.float32)
    x = x.astype(dtype)
    mu, mu2 = x.mean(axes), jnp.square(x).mean(axes)
    return mu, jnp.maximum(0.0, mu2 - jnp.square(mu))


def _normalize(mdl, x, mean, var, red_axes, feat_axes, dtype, param_dtype,
               eps, use_bias, use_scale, bias_init, scale_init):
    feature_shape = [1] * x.ndim
    reduced = []
    for ax in feat_axes:
        feature_shape[ax] = x.shape[ax]
        reduced.append(x.shape[ax])
    mean = jnp.expand_dims(mean, red_axes)
    var = jnp.expand_dims(var, red_axes)
    y = x - mean
    mul = lax.rsqrt(var + eps)
    args = [x]
    if use_scale:
        scale = mdl.param("scale", scale_init, reduced,
                          param_dtype).reshape(feature_shape)
        mul *= scale
        args.append(scale)
    y *= mul
    if use_bias:
        bias = mdl.param("bias", bias_init, reduced,
                         param_dtype).reshape(feature_shape)
        y += bias
        args.append(bias)
    return jnp.asarray(y, dtype or jnp.result_type(*args))


class LayerNorm(Module):
    """Normalisation over the last axis."""

    epsilon: float = 1e-6
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x):
        mean, var = _stats(x, (x.ndim - 1,), self.dtype)
        return _normalize(self, x, mean, var, (x.ndim - 1,), (x.ndim - 1,),
                          self.dtype, self.param_dtype, self.epsilon,
                          self.use_bias, self.use_scale, self.bias_init,
                          self.scale_init)


class BatchNorm(Module):
    """Batch normalisation over every axis but the last, with running
    statistics in the `batch_stats` collection."""

    use_running_average: Optional[bool] = None
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Any = None
    param_dtype: Any = jnp.float32
    use_bias: bool = True
    use_scale: bool = True
    bias_init: Callable = initializers.zeros
    scale_init: Callable = initializers.ones

    @compact
    def __call__(self, x, use_running_average: Optional[bool] = None):
        use_ra = merge_param("use_running_average", self.use_running_average,
                             use_running_average)
        feat = (x.ndim - 1,)
        red = tuple(range(x.ndim - 1))
        shape = (x.shape[-1],)
        ra_mean = self.variable("batch_stats", "mean",
                                lambda s: jnp.zeros(s, jnp.float32), shape)
        ra_var = self.variable("batch_stats", "var",
                               lambda s: jnp.ones(s, jnp.float32), shape)
        if use_ra:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean, var = _stats(x, red, self.dtype)
            if not self.is_initializing():
                m = self.momentum
                ra_mean.value = m * ra_mean.value + (1 - m) * mean
                ra_var.value = m * ra_var.value + (1 - m) * var
        return _normalize(self, x, mean, var, red, feat, self.dtype,
                          self.param_dtype, self.epsilon, self.use_bias,
                          self.use_scale, self.bias_init, self.scale_init)


class Dropout(Module):
    rate: float
    deterministic: Optional[bool] = None
    rng_collection: str = "dropout"

    @compact
    def __call__(self, x, deterministic: Optional[bool] = None):
        deterministic = merge_param("deterministic", self.deterministic,
                                    deterministic)
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng(self.rng_collection),
                                    p=keep, shape=x.shape)
        return lax.select(mask, x / keep, jnp.zeros_like(x))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def dot_product_attention(query, key, value, dropout_rng=None,
                          dropout_rate: float = 0.0,
                          deterministic: bool = True, dtype=None,
                          precision=None):
    """softmax(q k^T / sqrt(d)) v over [batch..., length, heads, depth]."""
    query, key, value = _promote(query, key, value, dtype=dtype)
    dtype = query.dtype
    query = query / jnp.sqrt(query.shape[-1]).astype(dtype)
    w = jnp.einsum("...qhd,...khd->...hqk", query, key, precision=precision)
    w = jax.nn.softmax(w).astype(dtype)
    if not deterministic and dropout_rate > 0.0:
        keep_prob = 1.0 - dropout_rate
        shape = (1,) * (key.ndim - 2) + w.shape[-2:]
        keep = jax.random.bernoulli(dropout_rng, keep_prob, shape)
        w = w * (keep.astype(dtype) / jnp.asarray(keep_prob, dtype))
    return jnp.einsum("...hqk,...khd->...qhd", w, value, precision=precision)


class MultiHeadDotProductAttention(Module):
    num_heads: int
    qkv_features: Optional[int] = None
    out_features: Optional[int] = None
    dropout_rate: float = 0.0
    deterministic: Optional[bool] = None
    dtype: Any = None
    param_dtype: Any = jnp.float32
    precision: Any = None
    use_bias: bool = True
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, inputs_q, inputs_k=None, inputs_v=None,
                 deterministic: Optional[bool] = None):
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        features = self.out_features or inputs_q.shape[-1]
        qkv = self.qkv_features or inputs_q.shape[-1]
        head_dim = qkv // self.num_heads
        dense = functools.partial(
            DenseGeneral, axis=-1, features=(self.num_heads, head_dim),
            dtype=self.dtype, param_dtype=self.param_dtype,
            kernel_init=self.kernel_init, bias_init=self.bias_init,
            use_bias=self.use_bias, precision=self.precision)
        query = dense(name="query")(inputs_q)
        key = dense(name="key")(inputs_k)
        value = dense(name="value")(inputs_v)
        dropout_rng = None
        m_det = True
        if self.dropout_rate > 0.0:
            m_det = merge_param("deterministic", self.deterministic,
                                deterministic)
            if not m_det:
                dropout_rng = self.make_rng("dropout")
        x = dot_product_attention(query, key, value, dropout_rng,
                                  self.dropout_rate, m_det, self.dtype,
                                  self.precision)
        return DenseGeneral(features=features, axis=(-2, -1),
                            kernel_init=self.kernel_init,
                            bias_init=self.bias_init, use_bias=self.use_bias,
                            dtype=self.dtype, param_dtype=self.param_dtype,
                            precision=self.precision, name="out")(x)


class SelfAttention(MultiHeadDotProductAttention):
    @compact
    def __call__(self, inputs_q, deterministic: Optional[bool] = None):
        return super().__call__(inputs_q, deterministic=deterministic)


# ---------------------------------------------------------------------------
# Recurrent cells
# ---------------------------------------------------------------------------

class GRUCell(Module):
    """r/z/n GRU cell; carry h [batch..., features]."""

    features: int
    kernel_init: Callable = default_kernel_init
    recurrent_kernel_init: Callable = initializers.orthogonal()
    bias_init: Callable = initializers.zeros
    dtype: Any = None
    param_dtype: Any = jnp.float32

    @compact
    def __call__(self, carry, inputs):
        h = carry
        hidden = h.shape[-1]
        dense_h = functools.partial(
            Dense, features=hidden, use_bias=False, dtype=self.dtype,
            param_dtype=self.param_dtype,
            kernel_init=self.recurrent_kernel_init, bias_init=self.bias_init)
        dense_i = functools.partial(
            Dense, features=hidden, use_bias=True, dtype=self.dtype,
            param_dtype=self.param_dtype, kernel_init=self.kernel_init,
            bias_init=self.bias_init)
        r = sigmoid(dense_i(name="ir")(inputs) + dense_h(name="hr")(h))
        z = sigmoid(dense_i(name="iz")(inputs) + dense_h(name="hz")(h))
        n = jnp.tanh(dense_i(name="in")(inputs)
                     + r * dense_h(name="hn", use_bias=True)(h))
        new_h = (1.0 - z) * n + z * h
        return new_h, new_h

    def initialize_carry(self, rng, input_shape):
        return jnp.zeros(tuple(input_shape[:-1]) + (self.features,),
                         self.param_dtype)


class _DenseParams(Module):
    """Kernel (and bias) of a Dense, created but not applied."""

    features: int
    use_bias: bool = True
    param_dtype: Any = jnp.float32
    kernel_init: Callable = default_kernel_init
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        bias = self.param("bias", self.bias_init, (self.features,),
                          self.param_dtype) if self.use_bias else None
        return kernel, bias


class OptimizedLSTMCell(Module):
    """i/f/g/o LSTM cell with the four gate products fused; carry (c, h)."""

    features: int
    kernel_init: Callable = default_kernel_init
    recurrent_kernel_init: Callable = initializers.orthogonal()
    bias_init: Callable = initializers.zeros
    dtype: Any = None
    param_dtype: Any = jnp.float32

    @compact
    def __call__(self, carry, inputs):
        c, h = carry
        hidden = h.shape[-1]
        p_i, p_h = {}, {}
        for g in "ifgo":
            p_i[g] = _DenseParams(hidden, use_bias=False,
                                  param_dtype=self.param_dtype,
                                  kernel_init=self.kernel_init,
                                  bias_init=self.bias_init,
                                  name=f"i{g}")(inputs)
            p_h[g] = _DenseParams(hidden, use_bias=True,
                                  param_dtype=self.param_dtype,
                                  kernel_init=self.recurrent_kernel_init,
                                  bias_init=self.bias_init,
                                  name=f"h{g}")(h)

        def fused(x, params, use_bias):
            kernel = jnp.concatenate([k for k, _ in params.values()], -1)
            bias = jnp.concatenate([b for _, b in params.values()], -1) \
                if use_bias else None
            x, kernel, bias = _promote(x, kernel, bias, dtype=self.dtype)
            y = jnp.dot(x, kernel)
            if use_bias:
                y += jnp.reshape(bias, (1,) * (y.ndim - 1) + (-1,))
            return dict(zip(params, jnp.split(y, len(params), axis=-1)))

        dh = fused(h, p_h, True)
        di = fused(inputs, p_i, False)
        i = sigmoid(dh["i"] + di["i"])
        f = sigmoid(dh["f"] + di["f"])
        g = jnp.tanh(dh["g"] + di["g"])
        o = sigmoid(dh["o"] + di["o"])
        new_c = f * c + i * g
        new_h = o * jnp.tanh(new_c)
        return (new_c, new_h), new_h

    def initialize_carry(self, rng, input_shape):
        shape = tuple(input_shape[:-1]) + (self.features,)
        return (jnp.zeros(shape, self.param_dtype),
                jnp.zeros(shape, self.param_dtype))


class RNN(Module):
    """Scan a cell over the time axis of [batch, time, features]."""

    cell: Module
    return_carry: bool = False
    reverse: bool = False

    @compact
    def __call__(self, inputs, initial_carry=None):
        xs = jnp.swapaxes(inputs, 0, 1)              # time-major
        if self.reverse:
            xs = jnp.flip(xs, 0)
        carry = initial_carry
        if carry is None:
            carry = self.cell.initialize_carry(
                None, inputs.shape[:1] + inputs.shape[2:])
        if self.is_initializing():
            # create the cell's parameters outside the scan's trace
            self.cell(carry, xs[0])
        carry, ys = lax.scan(lambda c, x: self.cell(c, x), carry, xs)
        if self.reverse:
            ys = jnp.flip(ys, 0)
        ys = jnp.swapaxes(ys, 0, 1)
        return (carry, ys) if self.return_carry else ys


# ---------------------------------------------------------------------------
# Pooling
# ---------------------------------------------------------------------------

def pool(inputs, init, reduce_fn, window_shape, strides, padding):
    window_shape = tuple(window_shape)
    strides = tuple(strides or (1,) * len(window_shape))
    n_batch = inputs.ndim - (len(window_shape) + 1)
    single = n_batch == 0
    if single:
        inputs, n_batch = inputs[None], 1
    dims = (1,) * n_batch + window_shape + (1,)
    strides = (1,) * n_batch + strides + (1,)
    if not isinstance(padding, str):
        padding = ((0, 0),) * n_batch + tuple(map(tuple, padding)) \
            + ((0, 0),)
    y = lax.reduce_window(inputs, init, reduce_fn, dims, strides, padding)
    return y[0] if single else y


def max_pool(inputs, window_shape, strides=None, padding="VALID"):
    return pool(inputs, -jnp.inf, lax.max, window_shape, strides, padding)


def avg_pool(inputs, window_shape, strides=None, padding="VALID"):
    y = pool(inputs, 0.0, lax.add, window_shape, strides, padding)
    return y / np.prod(window_shape)


__all__ = [
    "Module", "compact", "Variable", "merge_param", "initializers",
    "Dense", "DenseGeneral", "Conv", "LayerNorm", "BatchNorm", "Dropout",
    "MultiHeadDotProductAttention", "SelfAttention", "dot_product_attention",
    "GRUCell", "OptimizedLSTMCell", "RNN", "pool", "max_pool",
    "avg_pool", "relu", "gelu", "silu", "sigmoid", "tanh",
    "softmax", "one_hot", "logsumexp",
]
