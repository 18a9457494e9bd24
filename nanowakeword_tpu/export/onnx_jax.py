"""ONNX graph -> jittable JAX function (the JAX ONNX runtime).

The reference serves exported `.onnx` wake-word models through onnxruntime
CPU sessions (`nanointerpreter.py:873-877`). Here the same files compile
onto the accelerator: the graph is parsed by the bundled protobuf reader
(onnx_proto.py) and translated node-by-node into a pure jnp/lax function
that `jax.jit` fuses like any native model. This gives NanoInterpreter
first-class `.onnx` loading (interpreter/nanointerpreter.py) with identical
scores to the numpy evaluator (onnx_eval.py) and onnxruntime.

Supported ops = everything onnx_export.py emits (Gemm/Conv/MaxPool/
LayerNormalization/BatchNormalization/activations/shape ops/MatMul/Softmax/
Concat + native GRU/LSTM) — which covers all 11 exportable zoo families and
the reference's own DNN-family exports.

Shape-bearing inputs (Reshape shapes, Slice indices) must be initializers —
true for every graph this package writes and for torch.onnx.export graphs
of the reference's static-shape models.
"""

from __future__ import annotations

from typing import Dict, Union

import jax
import jax.numpy as jnp
import numpy as np

from nanowakeword_tpu.export import onnx_proto as P


def _conv(x, w, b, pads, strides, dilations, group):
    """ONNX Conv on NCL/NCHW inputs via lax.conv_general_dilated."""
    rank = x.ndim - 2
    if rank == 1:                       # run 1D as H=1 2D (same as onnx_eval)
        y = _conv(x[:, :, None, :], w[:, :, None, :], b,
                  [0, pads[0], 0, pads[1]], [1, strides[0]],
                  [1, dilations[0]], group)
        return y[:, :, 0, :]
    pt, pl_, pb, pr = pads
    y = jax.lax.conv_general_dilated(
        x, jnp.asarray(w),
        window_strides=tuple(strides),
        padding=((pt, pb), (pl_, pr)),
        rhs_dilation=tuple(dilations),
        feature_group_count=group,
        dimension_numbers=("NCHW", "OIHW", "NCHW"))
    if b is not None:
        y = y + jnp.asarray(b)[None, :, None, None]
    return y


def _maxpool(x, kernel, strides):
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        (1, 1) + tuple(kernel), (1, 1) + tuple(strides), "VALID")


def _gru_dir(X, W, R, B, linear_before_reset, h0=None):
    """One direction of an ONNX GRU ((z,r,h) gate order) via lax.scan."""
    H = R.shape[1]
    Wb, Rb = B[:3 * H], B[3 * H:]
    xg = X @ W.T + Wb                               # [T, N, 3H]
    if h0 is None:
        h0 = jnp.zeros((X.shape[1], H), jnp.float32)
    else:
        h0 = jnp.asarray(h0, jnp.float32)

    def step(h, xg_t):
        hg = h @ R.T
        z = jax.nn.sigmoid(xg_t[:, :H] + hg[:, :H] + Rb[:H])
        r = jax.nn.sigmoid(xg_t[:, H:2 * H] + hg[:, H:2 * H] + Rb[H:2 * H])
        if linear_before_reset:
            n = jnp.tanh(xg_t[:, 2 * H:] + r * (hg[:, 2 * H:] + Rb[2 * H:]))
        else:
            n = jnp.tanh(xg_t[:, 2 * H:] + (r * h) @ R[2 * H:].T
                         + Rb[2 * H:])
        h = (1.0 - z) * n + z * h
        return h, h

    _, ys = jax.lax.scan(step, h0, xg)
    return ys


def _lstm_dir(X, W, R, B, h0=None, c0=None):
    """One direction of an ONNX LSTM ((i,o,f,c) gate order) via lax.scan
    -> (Y [T,N,H], final cell state [N,H])."""
    H = R.shape[1]
    Wb, Rb = B[:4 * H], B[4 * H:]
    xg = X @ W.T + (Wb + Rb)
    init = (jnp.zeros((X.shape[1], H), jnp.float32) if h0 is None
            else jnp.asarray(h0, jnp.float32),
            jnp.zeros((X.shape[1], H), jnp.float32) if c0 is None
            else jnp.asarray(c0, jnp.float32))

    def step(carry, xg_t):
        h, c = carry
        gates = xg_t + h @ R.T
        i = jax.nn.sigmoid(gates[:, :H])
        o = jax.nn.sigmoid(gates[:, H:2 * H])
        f = jax.nn.sigmoid(gates[:, 2 * H:3 * H])
        g = jnp.tanh(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * jnp.tanh(c)
        return (h, c), h

    (_, c_fin), ys = jax.lax.scan(step, init, xg)
    return ys, c_fin


def _rnn_node(op, x, attrs):
    X, W, R, B = x[0], jnp.asarray(x[1]), jnp.asarray(x[2]), jnp.asarray(x[3])
    initial_h = x[4] if len(x) > 4 else None
    initial_c = x[5] if len(x) > 5 else None
    direction = attrs.get("direction", "forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    kw = {}
    if op == "GRU":
        kw["linear_before_reset"] = attrs.get("linear_before_reset", 0)
    dirs, finals, cells = [], [], []
    for d in range(W.shape[0]):
        reverse = d == 1 or direction == "reverse"
        Xd = X[::-1] if reverse else X
        if initial_h is not None:
            kw["h0"] = initial_h[d]
        if op == "GRU":
            Y = _gru_dir(Xd, W[d], R[d], B[d], **kw)
        else:
            if initial_c is not None:
                kw["c0"] = initial_c[d]
            Y, c_fin = _lstm_dir(Xd, W[d], R[d], B[d], **kw)
            cells.append(c_fin)
        finals.append(Y[-1])
        if reverse:
            Y = Y[::-1]
        dirs.append(Y)
    # (Y [T, dirs, N, H], Y_h [dirs, N, H], Y_c [dirs, N, H] | None)
    return (jnp.stack(dirs, axis=1), jnp.stack(finals, axis=0),
            jnp.stack(cells, axis=0) if cells else None)


def _static(v, what):
    if not isinstance(v, np.ndarray):
        raise NotImplementedError(
            f"{what} must be a graph initializer (static) for the JAX "
            "ONNX runtime")
    return v


def make_jax_fn(model: Union[str, bytes, P.ParsedModel]):
    """Parse an ONNX model -> (fn, graph): `fn(inputs_dict)` is a pure
    jittable function returning {output_name: array}."""
    if not isinstance(model, P.ParsedModel):
        model = P.load_model(model)
    g = model.graph
    inits = {k: np.asarray(v) for k, v in g.initializers.items()}
    input_names = [vi.name for vi in g.inputs]

    def fn(inputs: Dict[str, jnp.ndarray]):
        env: Dict[str, object] = dict(inits)
        for name in input_names:
            env[name] = inputs[name]
        for nd in g.nodes:
            a = nd.attrs
            x = [env[i] for i in nd.inputs if i]
            op = nd.op_type
            if op == "Gemm":
                A = jnp.asarray(x[0])
                Bm = jnp.asarray(x[1])
                if a.get("transA", 0):
                    A = A.T
                if a.get("transB", 0):
                    Bm = Bm.T
                y = a.get("alpha", 1.0) * (A @ Bm)
                if len(x) > 2:
                    y = y + a.get("beta", 1.0) * jnp.asarray(x[2])
            elif op == "MatMul":
                y = jnp.asarray(x[0]) @ jnp.asarray(x[1])
            elif op == "DequantizeLinear":
                # weight-only per-axis symmetric form: (int8, scales[axis])
                w = jnp.asarray(x[0])
                axis = a.get("axis", 1) % w.ndim
                shape = [1] * w.ndim
                shape[axis] = -1
                y = w.astype(jnp.float32) * jnp.asarray(x[1]).reshape(shape)
            elif op == "Relu":
                y = jax.nn.relu(jnp.asarray(x[0]))
            elif op == "Sigmoid":
                y = jax.nn.sigmoid(jnp.asarray(x[0]))
            elif op == "Tanh":
                y = jnp.tanh(jnp.asarray(x[0]))
            elif op == "Softmax":
                y = jax.nn.softmax(jnp.asarray(x[0]), axis=a.get("axis", -1))
            elif op == "Add":
                y = jnp.asarray(x[0]) + jnp.asarray(x[1])
            elif op == "Sub":
                y = jnp.asarray(x[0]) - jnp.asarray(x[1])
            elif op == "Mul":
                y = jnp.asarray(x[0]) * jnp.asarray(x[1])
            elif op == "Div":
                y = jnp.asarray(x[0]) / jnp.asarray(x[1])
            elif op == "Concat":
                y = jnp.concatenate([jnp.asarray(v) for v in x],
                                    axis=a["axis"])
            elif op == "Flatten":
                axis = a.get("axis", 1)
                shape = x[0].shape
                y = jnp.asarray(x[0]).reshape(
                    int(np.prod(shape[:axis] or (1,))), -1)
            elif op == "Reshape":
                # 0 = "copy the input dim at this index" (ONNX allowzero=0)
                y = jnp.asarray(x[0]).reshape(
                    [x[0].shape[i] if int(d) == 0 else int(d)
                     for i, d in enumerate(_static(x[1], "Reshape shape"))])
            elif op == "Transpose":
                y = jnp.transpose(jnp.asarray(x[0]), a["perm"])
            elif op == "LayerNormalization":
                axis = a.get("axis", -1)
                eps = a.get("epsilon", 1e-5)
                v = jnp.asarray(x[0])
                mean = v.mean(axis=axis, keepdims=True)
                var = v.var(axis=axis, keepdims=True)
                y = (v - mean) / jnp.sqrt(var + eps)
                y = y * jnp.asarray(x[1]) + (jnp.asarray(x[2])
                                             if len(x) > 2 else 0.0)
            elif op == "Conv":
                rank = x[0].ndim - 2
                y = _conv(jnp.asarray(x[0]), x[1],
                          x[2] if len(x) > 2 else None,
                          a.get("pads", [0, 0] * rank),
                          a.get("strides", [1] * rank),
                          a.get("dilations", [1] * rank),
                          a.get("group", 1))
            elif op == "MaxPool":
                y = _maxpool(jnp.asarray(x[0]), a["kernel_shape"],
                             a.get("strides", a["kernel_shape"]))
            elif op == "BatchNormalization":
                scale, bias, mean, var = (jnp.asarray(v) for v in x[1:5])
                eps = a.get("epsilon", 1e-5)
                bshape = (1, -1) + (1,) * (x[0].ndim - 2)
                y = ((jnp.asarray(x[0]) - mean.reshape(bshape))
                     / jnp.sqrt(var.reshape(bshape) + eps)
                     * scale.reshape(bshape) + bias.reshape(bshape))
            elif op == "ReduceMean":
                y = jnp.asarray(x[0]).mean(
                    axis=tuple(a["axes"]),
                    keepdims=bool(a.get("keepdims", 1)))
            elif op == "ReduceSum":   # opset 13+: axes as second input
                axes = (tuple(int(v) for v in np.asarray(x[1]))
                        if len(x) > 1
                        else tuple(a.get("axes", range(x[0].ndim))))
                y = jnp.asarray(x[0]).sum(
                    axis=axes, keepdims=bool(a.get("keepdims", 1)))
            elif op == "ReduceMax":
                y = jnp.asarray(x[0]).max(
                    axis=tuple(a["axes"]),
                    keepdims=bool(a.get("keepdims", 1)))
            elif op == "ReduceMin":
                y = jnp.asarray(x[0]).min(
                    axis=tuple(a["axes"]),
                    keepdims=bool(a.get("keepdims", 1)))
            elif op == "Einsum":
                eq = a["equation"]
                if isinstance(eq, bytes):
                    eq = eq.decode()
                y = jnp.einsum(eq, *[jnp.asarray(v) for v in x])
            elif op == "Expand":
                shape = [int(d) for d in _static(x[1], "Expand shape")]
                y = jnp.asarray(x[0]) * jnp.ones(shape, jnp.float32)
            elif op == "Cast":
                y = jnp.asarray(x[0], jnp.float32)
            elif op == "Pad":
                pads = [int(v) for v in _static(x[1], "Pad pads")]
                nd_ = x[0].ndim
                value = float(np.asarray(x[2])) if len(x) > 2 else 0.0
                width = [(pads[i], pads[nd_ + i]) for i in range(nd_)]
                y = jnp.pad(jnp.asarray(x[0]), width,
                            constant_values=value)
            elif op == "Exp":
                y = jnp.exp(jnp.asarray(x[0]))
            elif op == "Log":
                y = jnp.log(jnp.asarray(x[0]))
            elif op == "Erf":
                y = jax.lax.erf(jnp.asarray(x[0]))
            elif op == "Sqrt":
                y = jnp.sqrt(jnp.asarray(x[0]))
            elif op == "Reciprocal":
                y = 1.0 / jnp.asarray(x[0])
            elif op == "Neg":
                y = -jnp.asarray(x[0])
            elif op == "Abs":
                y = jnp.abs(jnp.asarray(x[0]))
            elif op == "Sign":
                y = jnp.sign(jnp.asarray(x[0]))
            elif op == "Floor":
                y = jnp.floor(jnp.asarray(x[0]))
            elif op == "Ceil":
                y = jnp.ceil(jnp.asarray(x[0]))
            elif op == "Pow":
                y = jnp.power(jnp.asarray(x[0]), jnp.asarray(x[1]))
            elif op == "Max":
                y = jnp.asarray(x[0])
                for v in x[1:]:
                    y = jnp.maximum(y, jnp.asarray(v))
            elif op == "Min":
                y = jnp.asarray(x[0])
                for v in x[1:]:
                    y = jnp.minimum(y, jnp.asarray(v))
            elif op == "Greater":
                y = (jnp.asarray(x[0]) > jnp.asarray(x[1])).astype(
                    jnp.float32)
            elif op == "Less":
                y = (jnp.asarray(x[0]) < jnp.asarray(x[1])).astype(
                    jnp.float32)
            elif op == "GreaterOrEqual":
                y = (jnp.asarray(x[0]) >= jnp.asarray(x[1])).astype(
                    jnp.float32)
            elif op == "LessOrEqual":
                y = (jnp.asarray(x[0]) <= jnp.asarray(x[1])).astype(
                    jnp.float32)
            elif op == "Equal":
                y = (jnp.asarray(x[0]) == jnp.asarray(x[1])).astype(
                    jnp.float32)
            elif op == "Slice":
                data = jnp.asarray(x[0])
                starts = _static(x[1], "Slice starts")
                ends = _static(x[2], "Slice ends")
                axes = (_static(x[3], "Slice axes") if len(x) > 3
                        else np.arange(len(starts)))
                sl = [slice(None)] * data.ndim
                for s, e, ax in zip(starts, ends, axes):
                    sl[int(ax)] = slice(int(s),
                                        None if e >= 2**31 else int(e))
                y = data[tuple(sl)]
            elif op == "Identity":
                y = jnp.asarray(x[0])
            elif op in ("GRU", "LSTM"):
                Y, Y_h, Y_c = _rnn_node(op, x, a)
                if len(nd.outputs) > 1 and nd.outputs[1]:
                    env[nd.outputs[1]] = Y_h
                if len(nd.outputs) > 2 and nd.outputs[2] and Y_c is not None:
                    env[nd.outputs[2]] = Y_c
                y = Y
            else:
                raise NotImplementedError(
                    f"op '{op}' not supported by the JAX ONNX runtime")
            env[nd.outputs[0]] = y
        return {vi.name: jnp.asarray(env[vi.name]) for vi in g.outputs}

    return fn, g


class OnnxJaxModel:
    """A jit-compiled ONNX model (the onnxruntime InferenceSession
    analogue, running on the session's JAX backend).

    `input_shape`/`output_names` mirror what NanoInterpreter reads off an
    ORT session (reference `nanointerpreter.py:150-168`)."""

    def __init__(self, model: Union[str, bytes, P.ParsedModel]):
        fn, graph = make_jax_fn(model)
        self._jit = jax.jit(lambda feed: fn(feed))
        self.graph = graph
        self.input_name = graph.inputs[0].name
        self.input_shape = list(graph.inputs[0].shape)
        self.output_names = [vi.name for vi in graph.outputs]

    def __call__(self, feats) -> np.ndarray:
        out = self._jit({self.input_name: jnp.asarray(feats, jnp.float32)})
        return np.asarray(out[self.output_names[0]])

    def run(self, output_names, input_feed, run_options=None):
        """onnxruntime-compatible run()."""
        del run_options
        out = self._jit({k: jnp.asarray(v, jnp.float32)
                         for k, v in input_feed.items()})
        names = output_names or self.output_names
        return [np.asarray(out[n]) for n in names]
