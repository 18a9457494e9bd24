"""Arbitrary Flax modules -> ONNX, by translating their jaxpr.

Closes the last export hole vs. the reference, which runs ANY user
nn.Module through torch.onnx.export (`/root/reference/nanowakeword/_export/
onnx.py:26-88`, custom loading `modules/model.py:155-211`): here the
`custom` family (and any other pure-forward Flax module) is abstractly
traced to a jaxpr and each primitive is lowered to ONNX ops, reusing the
same dependency-free protobuf writer (onnx_proto.py) as the hand-built zoo
exporters.

Dynamic batch: the module is traced with a sentinel batch size; shapes that
carry the sentinel in their leading dim are rebuilt with -1 in Reshape
targets, and contractions lower to Einsum (whose letter equation is
shape-agnostic), so the emitted graph accepts any batch size — the
reference's export contract. The exported graph is VALIDATED against the
live module at two batch sizes by the bundled numpy evaluator
(onnx_eval.py); if a module bakes its batch into the graph some other way,
export falls back to a fixed batch_size=1 trace (still a working export).

Supported primitive families (what deterministic Flax forward passes are
made of): elementwise arithmetic + activations, dot_general (-> Einsum),
conv_general_dilated (-> Conv with NCHW boundary transposes), reductions,
reshape/transpose/broadcast/concat/slice/pad/squeeze, comparisons +
select_n (lowered to Cast/blend arithmetic), and inlined call primitives
(pjit, custom_jvp/vjp, remat). Anything else raises ExportUnsupported with
the primitive's name — such models still deploy via the `.nww` artifact.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from nanowakeword_tpu.export import onnx_proto as P

# sentinel batch size for tracing: prime and large enough that a collision
# with a real (static) dimension of the module is effectively impossible
_SENTINEL_BATCH = 509


class ExportUnsupported(NotImplementedError):
    """A jaxpr primitive with no ONNX lowering."""


class _Builder:
    """Node/initializer accumulator (mirrors onnx_export._GraphBuilder)."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self.inits: List[bytes] = []
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def init_tensor(self, hint: str, array) -> str:
        nm = self.name(hint)
        self.inits.append(P.tensor(nm, np.asarray(array)))
        return nm

    def add(self, op: str, inputs, n_out: int = 1, **attrs):
        outs = [self.name(op.lower()) for _ in range(n_out)]
        self.nodes.append(P.node(op, inputs, outs,
                                 name=self.name(f"n_{op.lower()}"), **attrs))
        return outs[0] if n_out == 1 else outs


def _letters():
    import string
    return iter(string.ascii_lowercase)


def _einsum_equation(dn, lhs_ndim: int, rhs_ndim: int) -> str:
    """dot_general dimension_numbers -> an einsum equation string."""
    (lc, rc), (lb, rb) = dn
    it = _letters()
    lhs = [None] * lhs_ndim
    rhs = [None] * rhs_ndim
    # shared letters for batch and contracting pairs
    for i, j in zip(lb, rb):
        letter = next(it)
        lhs[i] = rhs[j] = letter
    for i, j in zip(lc, rc):
        letter = next(it)
        lhs[i] = rhs[j] = letter
    for i in range(lhs_ndim):
        if lhs[i] is None:
            lhs[i] = next(it)
    for j in range(rhs_ndim):
        if rhs[j] is None:
            rhs[j] = next(it)
    out = ([lhs[i] for i in lb]
           + [lhs[i] for i in range(lhs_ndim) if i not in lb and i not in lc]
           + [rhs[j] for j in range(rhs_ndim) if j not in rb and j not in rc])
    return f"{''.join(lhs)},{''.join(rhs)}->{''.join(out)}"


class _Translator:
    """One jaxpr -> ONNX nodes, tracking the sentinel batch dimension."""

    def __init__(self, g: _Builder, dynamic_batch: bool):
        self.g = g
        self.dynamic = dynamic_batch
        self.env: Dict[object, str] = {}   # jaxpr Var -> tensor name
        self.const_vals: Dict[object, np.ndarray] = {}  # Var -> known value

    # -- plumbing -----------------------------------------------------------

    def read(self, atom) -> str:
        from jax.extend.core import Literal
        if isinstance(atom, Literal):
            val = np.asarray(atom.val)
            if val.dtype.kind in "fc":
                val = val.astype(np.float32)
            elif val.dtype.kind in "iub":
                # integer literals feeding float math: keep as f32; true
                # integer shape math never reaches the ONNX graph (it is
                # resolved statically during tracing)
                val = val.astype(np.float32)
            return self.g.init_tensor("lit", val)
        return self.env[atom]

    def write(self, var, name: str):
        self.env[var] = name

    @staticmethod
    def _shape(atom):
        return tuple(atom.aval.shape)

    def _target_shape(self, shape) -> np.ndarray:
        """A static shape -> ONNX Reshape target, batch dim -> -1."""
        out = []
        for i, d in enumerate(shape):
            if self.dynamic and d == _SENTINEL_BATCH:
                if i != 0 or any(x == _SENTINEL_BATCH for x in shape[1:]):
                    raise ExportUnsupported(
                        "batch dimension leaves the leading axis")
                out.append(-1)
            else:
                out.append(int(d))
        return np.asarray(out, np.int64)

    # -- the walk -----------------------------------------------------------

    def run(self, jaxpr, consts):
        g = self.g
        for var, cval in zip(jaxpr.constvars, consts):
            arr = np.asarray(cval)
            self.const_vals[var] = arr
            if arr.dtype.kind in "fc":
                arr = arr.astype(np.float32)
            elif arr.dtype.kind in "iub":
                arr = arr.astype(np.float32)
            self.write(var, g.init_tensor("const", arr))
        for eqn in jaxpr.eqns:
            self.eqn(eqn)

    # integer index math worth constant-folding so p_gather can prove
    # in-bounds indices (jnp.take's negative-index wraparound chain:
    # lt/add/select_n/broadcast_in_dim over a constant index vector)
    _FOLDABLE = frozenset({
        "add", "sub", "mul", "neg", "rem", "max", "min", "lt", "le", "gt",
        "ge", "eq", "ne", "select_n", "broadcast_in_dim", "reshape",
        "convert_element_type", "concatenate", "squeeze", "slice"})

    def _try_fold(self, eqn):
        """Record outvar values when every input value is already known."""
        from jax.extend.core import Literal
        if eqn.primitive.name not in self._FOLDABLE:
            return
        vals = []
        for v in eqn.invars:
            val = (np.asarray(v.val) if isinstance(v, Literal)
                   else self.const_vals.get(v))
            if val is None or val.size > 4096 or val.dtype.kind not in "iub":
                return
            vals.append(val)
        try:
            import jax
            out = eqn.primitive.bind(
                *[jax.numpy.asarray(v) for v in vals], **eqn.params)
        except Exception:  # noqa: BLE001 — folding is best-effort
            return
        outs = out if eqn.primitive.multiple_results else [out]
        for var, o in zip(eqn.outvars, outs):
            self.const_vals[var] = np.asarray(o)

    def eqn(self, eqn):
        self._try_fold(eqn)
        prim = eqn.primitive.name
        handler = getattr(self, f"p_{prim}", None)
        if handler is None:
            handler = _ELEMENTWISE.get(prim)
            if handler is not None:
                out = self.g.add(handler, [self.read(v)
                                           for v in eqn.invars])
                self.write(eqn.outvars[0], out)
                return
            raise ExportUnsupported(
                f"jax primitive '{prim}' has no ONNX lowering (this model "
                "still deploys via the .nww artifact)")
        handler(eqn)

    # -- call primitives: inline -------------------------------------------

    def _inline(self, eqn, inner, consts):
        from jax.extend.core import Literal
        for outer, inner_v in zip(eqn.invars, inner.invars):
            self.write(inner_v, self.read(outer))
            known = (np.asarray(outer.val) if isinstance(outer, Literal)
                     else self.const_vals.get(outer))
            if known is not None:
                self.const_vals[inner_v] = known
        sub = _Translator(self.g, self.dynamic)
        sub.env = self.env
        sub.const_vals = self.const_vals
        sub.run(inner, consts)
        for outer, inner_v in zip(eqn.outvars, inner.outvars):
            self.write(outer, sub.read(inner_v))
            known = (np.asarray(inner_v.val) if isinstance(inner_v, Literal)
                     else self.const_vals.get(inner_v))
            if known is not None:
                self.const_vals[outer] = known

    def p_pjit(self, eqn):
        closed = eqn.params["jaxpr"]
        self._inline(eqn, closed.jaxpr, closed.consts)

    p_jit = p_pjit   # the primitive's name in newer jax versions

    def p_closed_call(self, eqn):
        closed = eqn.params["call_jaxpr"]
        self._inline(eqn, closed.jaxpr, closed.consts)

    def p_custom_jvp_call(self, eqn):
        closed = eqn.params["call_jaxpr"]
        self._inline(eqn, closed.jaxpr, closed.consts)

    def p_custom_vjp_call(self, eqn):
        closed = eqn.params["call_jaxpr"]
        self._inline(eqn, closed.jaxpr, closed.consts)

    def p_custom_vjp_call_jaxpr(self, eqn):
        closed = eqn.params["fun_jaxpr"]
        self._inline(eqn, closed.jaxpr, closed.consts)

    def p_remat(self, eqn):
        self._inline(eqn, eqn.params["jaxpr"], ())

    def p_checkpoint(self, eqn):
        self._inline(eqn, eqn.params["jaxpr"], ())

    # -- structure ----------------------------------------------------------

    def p_reshape(self, eqn):
        tgt = self._target_shape(eqn.outvars[0].aval.shape)
        out = self.g.add("Reshape", [self.read(eqn.invars[0]),
                                     self.g.init_tensor("shape", tgt)])
        self.write(eqn.outvars[0], out)

    def p_squeeze(self, eqn):
        self.p_reshape(eqn)

    def p_expand_dims(self, eqn):
        self.p_reshape(eqn)

    def p_transpose(self, eqn):
        perm = [int(p_) for p_ in eqn.params["permutation"]]
        out = self.g.add("Transpose", [self.read(eqn.invars[0])], perm=perm)
        self.write(eqn.outvars[0], out)

    def p_broadcast_in_dim(self, eqn):
        in_shape = self._shape(eqn.invars[0])
        out_shape = tuple(eqn.outvars[0].aval.shape)
        bdims = tuple(eqn.params["broadcast_dimensions"])
        x = self.read(eqn.invars[0])
        # step 1: Reshape to out rank with 1s at new axes (static sizes).
        # A batch-sized operand dim becomes ONNX Reshape's 0 ("copy the
        # input dim at this index") so the graph stays batch-symbolic.
        mid = [1] * len(out_shape)
        for src, dst in enumerate(bdims):
            d = int(in_shape[src])
            if self.dynamic and d == _SENTINEL_BATCH:
                if dst != src:
                    raise ExportUnsupported(
                        "broadcast moves the batch axis")
                mid[dst] = 0
            else:
                mid[dst] = d
        if tuple(mid) != in_shape:
            x = self.g.add("Reshape", [x, self.g.init_tensor(
                "shape", np.asarray(mid, np.int64))])
        # step 2: expansion. ONNX elementwise ops broadcast numpy-style, so
        # size-1 axes need no materialisation; Expand only where a consumer
        # might need real sizes. Use dim=1 at the batch axis (Expand keeps
        # the input's dim there) — consumers broadcast it against the batch.
        need_expand = any(m == 1 and o != 1 and not (
            self.dynamic and o == _SENTINEL_BATCH)
            for m, o in zip(mid, out_shape))
        if need_expand:
            tgt = [1 if (self.dynamic and o == _SENTINEL_BATCH) else int(o)
                   for o in out_shape]
            x = self.g.add("Expand", [x, self.g.init_tensor(
                "shape", np.asarray(tgt, np.int64))])
        self.write(eqn.outvars[0], x)

    def p_concatenate(self, eqn):
        out = self.g.add("Concat", [self.read(v) for v in eqn.invars],
                         axis=int(eqn.params["dimension"]))
        self.write(eqn.outvars[0], out)

    def p_slice(self, eqn):
        strides = eqn.params.get("strides")
        starts = [int(s) for s in eqn.params["start_indices"]]
        ends = [int(e) for e in eqn.params["limit_indices"]]
        steps = ([int(s) for s in strides] if strides is not None
                 else [1] * len(starts))
        in_shape = self._shape(eqn.invars[0])
        # batch axis: full-range slices stay full-range at any batch size
        for i, (s, e, d) in enumerate(zip(starts, ends, in_shape)):
            if self.dynamic and d == _SENTINEL_BATCH:
                if s != 0 or e != d or steps[i] != 1:
                    raise ExportUnsupported("slicing the batch axis")
                ends[i] = 2**31 - 1
        axes = list(range(len(starts)))
        out = self.g.add("Slice", [
            self.read(eqn.invars[0]),
            self.g.init_tensor("starts", np.asarray(starts, np.int64)),
            self.g.init_tensor("ends", np.asarray(ends, np.int64)),
            self.g.init_tensor("axes", np.asarray(axes, np.int64)),
            self.g.init_tensor("steps", np.asarray(steps, np.int64))])
        self.write(eqn.outvars[0], out)

    def p_pad(self, eqn):
        cfg = eqn.params["padding_config"]
        in_shape = list(self._shape(eqn.invars[0]))
        x = self.read(eqn.invars[0])
        pad_value = self.read(eqn.invars[1])    # scalar

        # interior (dilated) padding: per axis, open a trailing size-1 axis,
        # pad it to (1 + i), flatten back, and trim the i values that landed
        # after the last element — d -> d + (d-1)*i, the lax.pad contract.
        for ax, (_, _, interior) in enumerate(cfg):
            i = int(interior)
            if i == 0:
                continue
            d = int(in_shape[ax])
            if self.dynamic and in_shape[ax] == _SENTINEL_BATCH:
                raise ExportUnsupported("interior padding on the batch axis")
            expanded = in_shape[:ax + 1] + [1] + in_shape[ax + 1:]
            x = self.g.add("Reshape", [x, self.g.init_tensor(
                "shape", self._target_shape(expanded))])
            pads = [0] * (2 * len(expanded))
            pads[len(expanded) + ax + 1] = i      # hi pad of the new axis
            x = self.g.add("Pad", [
                x, self.g.init_tensor("pads", np.asarray(pads, np.int64)),
                pad_value])
            in_shape[ax] = d * (1 + i)
            x = self.g.add("Reshape", [x, self.g.init_tensor(
                "shape", self._target_shape(in_shape))])
            x = self.g.add("Slice", [
                x, self.g.init_tensor("starts", np.asarray([0], np.int64)),
                self.g.init_tensor("ends",
                                   np.asarray([d + (d - 1) * i], np.int64)),
                self.g.init_tensor("axes", np.asarray([ax], np.int64))])
            in_shape[ax] = d + (d - 1) * i

        # edge padding: non-negative parts via Pad, negative parts (lax.pad
        # trimming) via a final Slice
        los = [int(lo) for lo, _, _ in cfg]
        his = [int(hi) for _, hi, _ in cfg]
        if any(lo > 0 or hi > 0 for lo, hi in zip(los, his)):
            pads = ([max(lo, 0) for lo in los] + [max(hi, 0) for hi in his])
            x = self.g.add("Pad", [
                x, self.g.init_tensor("pads", np.asarray(pads, np.int64)),
                pad_value])
        if any(lo < 0 or hi < 0 for lo, hi in zip(los, his)):
            starts, ends, axes = [], [], []
            for ax, (lo, hi) in enumerate(zip(los, his)):
                if lo < 0 or hi < 0:
                    if self.dynamic and in_shape[ax] == _SENTINEL_BATCH:
                        raise ExportUnsupported(
                            "negative padding on the batch axis")
                    d = in_shape[ax] + max(lo, 0) + max(hi, 0)
                    starts.append(-min(lo, 0))
                    ends.append(d + min(hi, 0))
                    axes.append(ax)
            x = self.g.add("Slice", [
                x, self.g.init_tensor("starts", np.asarray(starts, np.int64)),
                self.g.init_tensor("ends", np.asarray(ends, np.int64)),
                self.g.init_tensor("axes", np.asarray(axes, np.int64))])
        self.write(eqn.outvars[0], x)

    def p_gather(self, eqn):
        """`jnp.take`/int-array indexing along ONE axis -> ONNX Gather.

        Recognised pattern (what jnp.take(x, idx_1d, axis=k) traces to):
        indices [N, 1], start_index_map == collapsed_slice_dims == (k,),
        slice_sizes == operand shape with 1 at k, offset_dims == all output
        positions except k. General lax.gather stays unsupported."""
        dn = eqn.params["dimension_numbers"]
        operand, indices = eqn.invars
        op_shape = self._shape(operand)
        idx_shape = self._shape(indices)
        slice_sizes = tuple(int(s) for s in eqn.params["slice_sizes"])
        if (len(dn.start_index_map) != 1
                or dn.collapsed_slice_dims != dn.start_index_map
                or dn.operand_batching_dims
                or len(idx_shape) != 2 or idx_shape[1] != 1):
            raise ExportUnsupported(
                "general lax.gather (only single-axis jnp.take lowers)")
        k = int(dn.start_index_map[0])
        want_sizes = tuple(1 if i == k else int(d)
                           for i, d in enumerate(op_shape))
        want_offsets = tuple(i for i in range(len(op_shape)) if i != k)
        if slice_sizes != want_sizes or tuple(dn.offset_dims) != want_offsets:
            raise ExportUnsupported(
                "general lax.gather (only single-axis jnp.take lowers)")
        if self.dynamic and op_shape[k] == _SENTINEL_BATCH:
            raise ExportUnsupported("gather along the batch axis")
        idx = self.g.add("Reshape", [
            self.read(indices),
            self.g.init_tensor("shape", np.asarray([-1], np.int64))])
        idx = self.g.add("Cast", [idx], to=P.INT64)
        # OOB semantics differ: jax gathers clamp (clip mode) or NaN-fill
        # (jnp.take's fill default), ONNX Gather errors/wraps. Indices
        # known at export time and in-bounds need nothing; otherwise clip
        # mode materialises a Clip on the indices and fill mode (no ONNX
        # counterpart) stays unsupported.
        from jax.extend.core import Literal
        known = (np.asarray(indices.val) if isinstance(indices, Literal)
                 else self.const_vals.get(indices))
        mode = str(eqn.params.get("mode"))
        in_bounds = (known is not None and known.size
                     and known.min() >= 0 and known.max() < op_shape[k])
        if not in_bounds and "PROMISE" not in mode:
            if "FILL" in mode:
                raise ExportUnsupported(
                    "gather with fill-mode OOB semantics and indices not "
                    "provably in bounds")
            idx = self.g.add("Clip", [
                idx, self.g.init_tensor("lo", np.int64(0)),
                self.g.init_tensor("hi", np.int64(op_shape[k] - 1))])
        out = self.g.add("Gather", [self.read(operand), idx], axis=k)
        # ONNX Gather output dtype follows data (float); graph stays f32
        self.write(eqn.outvars[0], out)

    def p_argmax(self, eqn):
        axes = eqn.params["axes"]
        if len(axes) != 1:
            raise ExportUnsupported("argmax over multiple axes")
        ax = int(axes[0])
        if self.dynamic and self._shape(eqn.invars[0])[ax] == _SENTINEL_BATCH:
            raise ExportUnsupported("argmax along the batch axis")
        out = self.g.add("ArgMax", [self.read(eqn.invars[0])],
                         axis=ax, keepdims=0)
        out = self.g.add("Cast", [out], to=P.FLOAT)
        self.write(eqn.outvars[0], out)

    def p_convert_element_type(self, eqn):
        # all float compute is f32 in the emitted graph; other conversions
        # were resolved during tracing
        self.write(eqn.outvars[0], self.g.add(
            "Identity", [self.read(eqn.invars[0])]))

    def p_stop_gradient(self, eqn):
        self.write(eqn.outvars[0], self.g.add(
            "Identity", [self.read(eqn.invars[0])]))

    def p_copy(self, eqn):
        self.write(eqn.outvars[0], self.g.add(
            "Identity", [self.read(eqn.invars[0])]))

    # -- math ---------------------------------------------------------------

    def p_dot_general(self, eqn):
        dn = eqn.params["dimension_numbers"]
        lhs, rhs = eqn.invars
        eqn_str = _einsum_equation(dn, len(self._shape(lhs)),
                                   len(self._shape(rhs)))
        out = self.g.add("Einsum", [self.read(lhs), self.read(rhs)],
                         equation=eqn_str)
        self.write(eqn.outvars[0], out)

    def p_integer_pow(self, eqn):
        y = float(eqn.params["y"])
        out = self.g.add("Pow", [self.read(eqn.invars[0]),
                                 self.g.init_tensor(
                                     "exp", np.float32(y))])
        self.write(eqn.outvars[0], out)

    def p_rsqrt(self, eqn):
        s = self.g.add("Sqrt", [self.read(eqn.invars[0])])
        self.write(eqn.outvars[0], self.g.add("Reciprocal", [s]))

    def p_square(self, eqn):
        x = self.read(eqn.invars[0])
        self.write(eqn.outvars[0], self.g.add("Mul", [x, x]))

    def p_logistic(self, eqn):
        self.write(eqn.outvars[0], self.g.add(
            "Sigmoid", [self.read(eqn.invars[0])]))

    def _reduce(self, eqn, op):
        axes = [int(a) for a in eqn.params["axes"]]
        in_shape = self._shape(eqn.invars[0])
        if self.dynamic and any(in_shape[a] == _SENTINEL_BATCH
                                for a in axes):
            raise ExportUnsupported("reduction over the batch axis")
        if op == "ReduceSum":     # opset 13+: axes is an input
            out = self.g.add(op, [self.read(eqn.invars[0]),
                                  self.g.init_tensor(
                                      "axes", np.asarray(axes, np.int64))],
                             keepdims=0)
        else:                     # opset<18 attr form (matches onnx_eval)
            out = self.g.add(op, [self.read(eqn.invars[0])],
                             axes=axes, keepdims=0)
        self.write(eqn.outvars[0], out)

    def _reduce_window(self, eqn, mode):
        """lax.reduce_window (nn.avg_pool / nn.max_pool) -> ONNX pooling.

        Windowed axes move behind the remaining (batch/feature) axes, which
        flatten into [N, C]; MaxPool pads with -inf and AveragePool with
        count_include_pad=1 pads with 0 — exactly the reduce-window init
        values, so sum = AveragePool * window_size."""
        wd = [int(w) for w in eqn.params["window_dimensions"]]
        ws = [int(s) for s in eqn.params["window_strides"]]
        pad = [(int(lo), int(hi)) for lo, hi in eqn.params["padding"]]
        if any(int(d) != 1 for d in eqn.params.get("base_dilation",
                                                   [1] * len(wd))) or \
           any(int(d) != 1 for d in eqn.params.get("window_dilation",
                                                   [1] * len(wd))):
            raise ExportUnsupported("dilated reduce_window")
        in_shape = self._shape(eqn.invars[0])
        spatial = [i for i in range(len(wd))
                   if wd[i] > 1 or ws[i] > 1 or pad[i] != (0, 0)]
        x = self.read(eqn.invars[0])
        if not spatial:
            self.write(eqn.outvars[0], self.g.add("Identity", [x]))
            return
        if len(spatial) > 2:
            raise ExportUnsupported("reduce_window over >2 axes")
        if self.dynamic and any(in_shape[i] == _SENTINEL_BATCH
                                for i in spatial):
            raise ExportUnsupported("pooling the batch axis")
        keep = [i for i in range(len(wd)) if i not in spatial]
        if not keep:
            raise ExportUnsupported("reduce_window over every axis")
        perm = keep + spatial
        if perm != list(range(len(wd))):
            x = self.g.add("Transpose", [x], perm=perm)
        flat = [-1 if (self.dynamic
                       and in_shape[keep[0]] == _SENTINEL_BATCH
                       and keep[0] == 0) else int(in_shape[keep[0]]),
                int(np.prod([in_shape[i] for i in keep[1:]], dtype=np.int64))
                ] + [int(in_shape[i]) for i in spatial]
        x = self.g.add("Reshape", [x, self.g.init_tensor(
            "shape", np.asarray(flat, np.int64))])
        kernel = [wd[i] for i in spatial]
        strides = [ws[i] for i in spatial]
        pads = ([pad[i][0] for i in spatial] + [pad[i][1] for i in spatial])
        if mode == "max":
            x = self.g.add("MaxPool", [x], kernel_shape=kernel,
                           strides=strides, pads=pads)
        else:
            x = self.g.add("AveragePool", [x], kernel_shape=kernel,
                           strides=strides, pads=pads, count_include_pad=1)
            x = self.g.add("Mul", [x, self.g.init_tensor(
                "wsize", np.float32(np.prod(kernel)))])
        out_spatial = [
            (in_shape[i] + pad[i][0] + pad[i][1] - wd[i]) // ws[i] + 1
            for i in spatial]
        unflat = [flat[0]] + [int(in_shape[i]) for i in keep[1:]] \
            + out_spatial
        x = self.g.add("Reshape", [x, self.g.init_tensor(
            "shape", np.asarray(unflat, np.int64))])
        if perm != list(range(len(wd))):
            inv = [perm.index(i) for i in range(len(perm))]
            x = self.g.add("Transpose", [x], perm=inv)
        self.write(eqn.outvars[0], x)

    def p_reduce_window_sum(self, eqn):
        self._reduce_window(eqn, "sum")

    def p_reduce_window_max(self, eqn):
        self._reduce_window(eqn, "max")

    def p_reduce_sum(self, eqn):
        self._reduce(eqn, "ReduceSum")

    def p_reduce_max(self, eqn):
        self._reduce(eqn, "ReduceMax")

    def p_reduce_min(self, eqn):
        self._reduce(eqn, "ReduceMin")

    # comparisons: emit the ONNX comparison (bool) + Cast to f32 so the
    # select_n blend below stays pure f32 arithmetic
    def _compare(self, eqn, op, swap=False):
        a, b = self.read(eqn.invars[0]), self.read(eqn.invars[1])
        if swap:
            a, b = b, a
        c = self.g.add(op, [a, b])
        out = self.g.add("Cast", [c], to=P.FLOAT)
        self.write(eqn.outvars[0], out)

    def p_gt(self, eqn):
        self._compare(eqn, "Greater")

    def p_lt(self, eqn):
        self._compare(eqn, "Less")

    def p_ge(self, eqn):
        self._compare(eqn, "GreaterOrEqual")

    def p_le(self, eqn):
        self._compare(eqn, "LessOrEqual")

    def p_eq(self, eqn):
        self._compare(eqn, "Equal")

    def p_select_n(self, eqn):
        if len(eqn.invars) != 3:
            raise ExportUnsupported("select_n with more than two cases")
        pred = self.read(eqn.invars[0])        # f32 0/1 via the Cast above
        on_false = self.read(eqn.invars[1])
        on_true = self.read(eqn.invars[2])
        a = self.g.add("Mul", [pred, on_true])
        one = self.g.init_tensor("one", np.float32(1.0))
        inv = self.g.add("Sub", [one, pred])
        b = self.g.add("Mul", [inv, on_false])
        self.write(eqn.outvars[0], self.g.add("Add", [a, b]))

    def p_iota(self, eqn):
        shape = tuple(eqn.outvars[0].aval.shape)
        if self.dynamic and _SENTINEL_BATCH in shape:
            raise ExportUnsupported("iota over the batch axis")
        dim = int(eqn.params["dimension"])
        arr = np.arange(shape[dim], dtype=np.float32)
        arr = arr.reshape([-1 if i == dim else 1
                           for i in range(len(shape))])
        arr = np.broadcast_to(arr, shape).astype(np.float32)
        self.write(eqn.outvars[0], self.g.init_tensor("iota", arr))

    def p_conv_general_dilated(self, eqn):
        params = eqn.params
        if int(params.get("batch_group_count", 1)) != 1:
            raise ExportUnsupported("batch_group_count != 1")
        if any(int(d) != 1 for d in params.get("lhs_dilation", ())):
            raise ExportUnsupported("transposed convolution (lhs_dilation)")
        dn = params["dimension_numbers"]
        lhs_spec, rhs_spec, out_spec = dn.lhs_spec, dn.rhs_spec, dn.out_spec
        nd = len(lhs_spec)
        spatial = nd - 2

        x = self.read(eqn.invars[0])
        # lhs_spec is (batch_pos, feature_pos, *spatial_pos): transposing by
        # it yields the NC<spatial> layout ONNX Conv wants
        lhs_perm = [lhs_spec[0], lhs_spec[1]] + list(lhs_spec[2:])
        if lhs_perm != list(range(nd)):
            x = self.g.add("Transpose", [x], perm=lhs_perm)

        # kernel -> OI<spatial>: rhs_spec = (out_f, in_f, *spatial)
        w = self.read(eqn.invars[1])
        rhs_perm = [rhs_spec[0], rhs_spec[1]] + list(rhs_spec[2:])
        if rhs_perm != list(range(nd)):
            w = self.g.add("Transpose", [w], perm=rhs_perm)

        padding = [(int(lo), int(hi)) for lo, hi in params["padding"]]
        pads = [p_[0] for p_ in padding] + [p_[1] for p_ in padding]
        out = self.g.add(
            "Conv", [x, w],
            pads=pads,
            strides=[int(s) for s in params["window_strides"]],
            dilations=[int(d) for d in params["rhs_dilation"]],
            group=int(params.get("feature_group_count", 1)))

        # NC<spatial> -> the jaxpr's output layout
        out_rank = spatial + 2
        inv = [0] * out_rank
        onnx_order = [out_spec[0], out_spec[1]] + list(out_spec[2:])
        for onnx_pos, jax_pos in enumerate(onnx_order):
            inv[jax_pos] = onnx_pos
        if inv != list(range(out_rank)):
            out = self.g.add("Transpose", [out], perm=inv)
        self.write(eqn.outvars[0], out)


# primitives that are a 1:1 elementwise ONNX op
_ELEMENTWISE = {
    "add": "Add", "sub": "Sub", "mul": "Mul", "div": "Div",
    "max": "Max", "min": "Min", "pow": "Pow",
    "exp": "Exp", "log": "Log", "tanh": "Tanh", "erf": "Erf",
    "sqrt": "Sqrt", "neg": "Neg", "abs": "Abs", "sign": "Sign",
    "floor": "Floor", "ceil": "Ceil",
    "add_any": "Add",
}


def build_onnx_from_fn(fn, input_specs, output_names, name: str, *,
                       dynamic_batch: bool = True, validate: bool = True,
                       batch_sizes=(1, 3), rtol: float = 1e-4,
                       atol: float = 1e-5, input_scale: float = 1.0,
                       doc: str = "") -> bytes:
    """Trace an arbitrary pure JAX function and lower its jaxpr to ONNX.

    The general entry behind `build_onnx_from_module` — used for graphs that
    are not classifier modules (e.g. the feature frontend, export/frontend.py).

    Args:
        fn:            pure function of len(input_specs) float32 arrays.
        input_specs:   [(input_name, shape)] — shape EXCLUDES the batch dim
                       when dynamic_batch (it is prepended symbolically),
                       and is the full static shape otherwise.
        output_names:  names for fn's outputs (tuple outputs supported).
        dynamic_batch: emit a batch-symbolic graph (leading dim
                       "batch_size" on every input/output).
        validate:      run the bundled numpy evaluator against fn on random
                       inputs (at each of batch_sizes when dynamic) and
                       raise ExportUnsupported on any mismatch — there is NO
                       fixed-batch fallback here; callers wanting one use
                       build_onnx_from_module.

    Returns: serialized ModelProto bytes.
    """
    import jax
    import jax.numpy as jnp

    def build(batch):
        shapes = [((batch,) + tuple(s)) if dynamic_batch else tuple(s)
                  for _, s in input_specs]
        closed = jax.make_jaxpr(fn)(
            *[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
        g = _Builder()
        tr = _Translator(g, dynamic_batch=dynamic_batch)
        jaxpr = closed.jaxpr
        for var, (in_name, _) in zip(jaxpr.invars, input_specs):
            tr.write(var, in_name)
        tr.run(jaxpr, closed.consts)
        if len(jaxpr.outvars) != len(output_names):
            raise ExportUnsupported(
                f"fn returns {len(jaxpr.outvars)} outputs, "
                f"{len(output_names)} names given")
        out_infos = []
        for var, out_name in zip(jaxpr.outvars, output_names):
            g.nodes.append(P.node("Identity", [tr.read(var)], [out_name],
                                  name=f"n_{out_name}"))
            shape = tuple(var.aval.shape)
            if dynamic_batch:
                if not shape or shape[0] != _SENTINEL_BATCH:
                    raise ExportUnsupported(
                        f"output '{out_name}' lost the batch dimension")
                shape = ("batch_size",) + tuple(int(d) for d in shape[1:])
            out_infos.append(P.value_info(out_name, shape))
        batch_dim = ("batch_size",) if dynamic_batch else ()
        graph = P.graph(
            g.nodes, name=name,
            inputs=[P.value_info(n, batch_dim + tuple(s))
                    for n, s in input_specs],
            outputs=out_infos, initializers=g.inits,
            doc=doc or "nanowakeword_tpu function export (jaxpr lowering)")
        return P.model(graph, opset=17,
                       doc="exported by nanowakeword_tpu.export.jaxpr_onnx")

    def check(data: bytes, batch) -> Optional[str]:
        from nanowakeword_tpu.export import onnx_eval
        rng = np.random.default_rng(0)
        feeds = {}
        args = []
        for in_name, s in input_specs:
            shape = ((batch,) + tuple(s)) if dynamic_batch else tuple(s)
            x = rng.normal(0, input_scale, shape).astype(np.float32)
            feeds[in_name] = x
            args.append(jnp.asarray(x))
        # the emitted graph is pure float32; accelerator matmuls default to
        # reduced precision (bf16 passes or TF32), so the live reference must be
        # forced to f32-true precision for the comparison to mean anything
        with jax.default_matmul_precision("highest"):
            want = fn(*args)
        want = [np.asarray(w) for w in
                (want if isinstance(want, (tuple, list)) else (want,))]
        try:
            got = onnx_eval.run(data, feeds)
        except Exception as e:  # noqa: BLE001
            return f"evaluator error: {e}"
        for out_name, w in zip(output_names, want):
            gv = got[out_name]
            if gv.shape != w.shape:
                return (f"'{out_name}' shape mismatch: graph {gv.shape} vs "
                        f"fn {w.shape}")
            if not np.allclose(gv, w, rtol=rtol, atol=atol):
                return (f"'{out_name}' numeric mismatch: max abs diff "
                        f"{np.abs(gv - w).max():.3e}")
        return None

    data = build(_SENTINEL_BATCH if dynamic_batch else None)
    if validate:
        for batch in (batch_sizes if dynamic_batch else (None,)):
            reason = check(data, batch)
            if reason is not None:
                raise ExportUnsupported(
                    f"function export '{name}' failed validation: {reason}")
    return data


def build_onnx_from_module(module, variables, input_shape, n_classes: int,
                           name: str = "custom",
                           validate: bool = True) -> bytes:
    """Trace `module.apply(variables, x, deterministic=True)` and lower the
    jaxpr to an ONNX graph: input "features" [batch, *input_shape] ->
    output "score" [batch, n_classes] (sigmoid probability).

    Tries a dynamic-batch graph first and numerically validates it with the
    bundled evaluator at two batch sizes; falls back to a fixed batch_size=1
    graph if the module's shapes can't stay batch-symbolic.
    """
    import jax
    import jax.numpy as jnp

    def fn(x):
        logits = module.apply(variables, x, deterministic=True)
        return jax.nn.sigmoid(logits.reshape(logits.shape[0], -1))

    def build(batch, dynamic):
        closed = jax.make_jaxpr(fn)(
            jax.ShapeDtypeStruct((batch,) + tuple(input_shape), jnp.float32))
        g = _Builder()
        tr = _Translator(g, dynamic_batch=dynamic)
        jaxpr = closed.jaxpr
        tr.write(jaxpr.invars[0], "features")
        tr.run(jaxpr, closed.consts)
        final = tr.read(jaxpr.outvars[0])
        g.nodes.append(P.node("Identity", [final], ["score"],
                              name="n_score"))
        batch_dim = "batch_size" if dynamic else 1
        graph = P.graph(
            g.nodes, name=f"{name}_custom",
            inputs=[P.value_info("features",
                                 (batch_dim,) + tuple(input_shape))],
            outputs=[P.value_info("score", (batch_dim, n_classes))],
            initializers=g.inits,
            doc="nanowakeword_tpu custom-module export (jaxpr lowering)")
        return P.model(graph, opset=17,
                       doc="exported by nanowakeword_tpu.export.jaxpr_onnx")

    def check(data: bytes, batch: int) -> Optional[str]:
        """None when the graph matches the live module; else the reason."""
        from nanowakeword_tpu.export import onnx_eval
        x = np.random.default_rng(0).normal(
            0, 1, (batch,) + tuple(input_shape)).astype(np.float32)
        want = np.asarray(fn(jnp.asarray(x)))
        try:
            got = onnx_eval.run(data, {"features": x})["score"]
        except Exception as e:  # noqa: BLE001 — any failure means "not valid"
            return f"evaluator error at batch {batch}: {e}"
        if got.shape != want.shape:
            return (f"shape mismatch at batch {batch}: graph {got.shape} "
                    f"vs module {want.shape}")
        if not np.allclose(got, want, rtol=1e-4, atol=1e-5):
            return (f"numeric mismatch at batch {batch}: max abs diff "
                    f"{np.abs(got - want).max():.3e}")
        return None

    # Try the dynamic-batch graph first; if it can't be built or doesn't
    # validate, fall back to a fixed batch_size=1 trace — LOUDLY, naming the
    # constraint that broke (the reference always declares a dynamic batch,
    # _export/onnx.py:74-82, so a silent fixed-batch artifact would surprise
    # its users).
    reason = None
    try:
        data = build(_SENTINEL_BATCH, dynamic=True)
        if not validate:
            return data
        reason = check(data, 1) or check(data, 3)
        if reason is None:
            return data
    except ExportUnsupported as e:
        reason = f"unsupported for dynamic batch: {e}"
    from nanowakeword_tpu.utils.logger import print_warning
    print_warning(
        "Custom-module ONNX export falls back to a FIXED batch_size=1 "
        f"graph. Reason: {reason}")
    data = build(1, dynamic=False)
    if validate:
        fixed_reason = check(data, 1)
        if fixed_reason is not None:
            raise ExportUnsupported(
                f"custom module export failed validation: {fixed_reason}")
    return data
