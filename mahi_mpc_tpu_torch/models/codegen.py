"""A user's dynamics as C++ for the fused kernel: trace once, lower, emit.

The JAX package's Pallas kernel traces the model's own ``f`` into its body
(``mahi_mpc_tpu/solver/fused.py``: ``f_dyn = prob.dynamics.f``), and the
reference generates C for a user's model and compiles it with gcc
(``ModelGenerator``).  This module does the same for the CUDA kernel:

- **trace**: ``Dynamics.f`` once on the CPU with
  ``torch.fx.experimental.proxy_tensor.make_fx`` (fake tensors, so Python
  control flow on values raises instead of baking in one branch) at x
  ``(nx, LANES)``, u ``(nu, LANES)``;
- **lower**: every node of the graph to scalars, one per component, with
  the trailing lane dimension kept last throughout: a node that indexes,
  reduces or contracts over it mixes lanes and is refused;
- **emit**: a C++ model struct over unrolled scalars in the form of
  ``csrc/model_dynamics.cuh`` (compile-time ``NX``, ``NU``, ``NQ`` and a
  member template on the scalar ``T``, float, double or a dual number):
  ``acc(x, u, qdd)``, the last ``nq`` rows of ``f``, for a second-order
  model (``nq`` set, ``2 nq == nx``; its first rows are taken to be the
  velocities, as the kernel's nq-row step takes them), else ``f(x, u,
  out)`` with ``NQ = 0``.

The kernel's arithmetic rules hold in what it emits
(``csrc/fused_sqp.cuh``): every literal is an ``S(...)`` constant of the
kernel's scalar type, the operations run in the traced order, and nothing
asks for fast math.  Python-float constants that ``f`` folds before the
trace come through as they are.

The ops it lowers (what a lanes-polymorphic ``f`` can use inside a Pallas
body): ``+ - * /``, negation and reciprocals, ``sin cos tan exp log sqrt
rsqrt tanh abs``, ``pow`` by a constant, ``where`` with comparisons (and
their logical combinations), ``minimum``, ``maximum``, indexing
(``select``, ``slice``) and ``stack`` / ``cat`` / ``unsqueeze`` /
``squeeze`` / ``reshape`` on the leading dimensions, ``clone`` and
``detach`` (its tangent dropped, as ``torch.func`` drops it), and
broadcasts of Python scalars and of one-element constant tensors.
Anything else raises ``Unsupported``; the fused route
then refuses the problem (``solver.fused.fused_supported``), on the CPU and
on the card alike, before anything is built.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .base import Dynamics

# The trace's lane count: no component dimension of a model can be
# mistaken for it (a (7, ...) component block would need nx or nu = 7 and
# an op over that dimension, and the tests pin the refusal of lane mixing).
LANES = 7


class Unsupported(ValueError):
    """The emitter cannot lower this ``f`` (the reason says which node)."""


@dataclass(frozen=True)
class GeneratedModel:
    """A lowered model: its sizes (``nq`` 0 for a first-order model) and
    the C++ struct ``mpc::gen::Model<S>``."""

    name: str
    nx: int
    nu: int
    nq: int
    source: str


@dataclass
class _Val:
    """A node's value: an object array of scalar items over the leading
    (component) shape; ``lanes`` when the tensor carries the trailing lane
    dimension.  An item is (kind, text): kind "T" a scalar of the model's
    type, "S" a constant, "B" a bool."""

    items: np.ndarray
    lanes: bool


def _literal(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    v = float(v)
    if not math.isfinite(v):
        raise Unsupported(f"non-finite constant {v}")
    return f"S({v!r})"


_UNARY = {"neg": "-{}", "sin": "m_sin({})", "cos": "m_cos({})",
          "tan": "m_tan({})", "exp": "m_exp({})", "log": "m_log({})",
          "sqrt": "m_sqrt({})", "tanh": "m_tanh({})", "abs": "m_abs({})",
          "reciprocal": "S(1) / {}", "rsqrt": "S(1) / m_sqrt({})"}
_ARITH = {"add": "+", "sub": "-", "mul": "*", "div": "/"}
_COMPARE = {"gt": ">", "lt": "<", "ge": ">=", "le": "<=", "eq": "==",
            "ne": "!="}
_LOGICAL = {"logical_and": "&&", "logical_or": "||", "bitwise_and": "&&",
            "bitwise_or": "||"}
_PASS = {"clone", "alias", "lift_fresh_copy"}
_FILL = {"zeros_like": 0.0, "ones_like": 1.0}


class _Emitter:
    def __init__(self):
        self.stmts: list = []        # (name, kind, expr, operand names)
        self.n = 0

    def bind(self, kind: str, expr: str, deps) -> tuple:
        name = {"T": "t", "S": "c", "B": "b"}[kind] + str(self.n)
        self.n += 1
        self.stmts.append((name, kind, expr, tuple(deps)))
        return kind, name

    def lines(self, outputs) -> list:
        """The statements the outputs need, in the traced order."""
        live = {text for _, text in outputs}
        keep = []
        for name, kind, expr, deps in reversed(self.stmts):
            if name in live:
                keep.append((name, kind, expr))
                live.update(deps)
        ctype = {"T": "T", "S": "S", "B": "bool"}
        return [f"    const {ctype[k]} {n} = {e};"
                for n, k, e in reversed(keep)]


def _names(*items):
    return [text for _, text in items]


def _as_t(item) -> str:
    kind, text = item
    return text if kind == "T" else f"T({text})"


def _value_of(item) -> str:
    kind, text = item
    return f"m_value({text})" if kind == "T" else text


class _Lowering:
    def __init__(self, gm: torch.fx.GraphModule, nx: int, nu: int):
        self.gm = gm
        self.nx, self.nu = nx, nu
        self.em = _Emitter()
        self.env: dict = {}

    # ---- values
    def val(self, a):
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, bool):
            return _Val(_scalar(("B", _literal(a))), False)
        if isinstance(a, (int, float)):
            return _Val(_scalar(("S", _literal(a))), False)
        raise Unsupported(f"argument {a!r}")

    @staticmethod
    def meta_shape(node) -> tuple:
        v = node.meta.get("val")
        if not isinstance(v, torch.Tensor):
            raise Unsupported(f"{node.format_node()}: no tensor value")
        return tuple(int(s) for s in v.shape)

    def lead_of(self, v: _Val, with_lanes: bool) -> np.ndarray:
        """v's items over the leading shape it has against an operand that
        carries lanes: a constant's last dimension lines up with the lanes,
        so it must be 1 there."""
        if v.lanes or not with_lanes or v.items.ndim == 0:
            return v.items
        if v.items.shape[-1] != 1:
            raise Unsupported("a constant broadcast against the lanes")
        return v.items.reshape(v.items.shape[:-1])

    def elementwise(self, node, args, make) -> _Val:
        vals = [self.val(a) for a in args]
        lanes = any(v.lanes for v in vals)
        arrs = [self.lead_of(v, lanes) for v in vals]
        try:
            shape = np.broadcast_shapes(*[a.shape for a in arrs])
        except ValueError as e:
            raise Unsupported(f"{node.format_node()}: {e}") from None
        out = np.empty(shape, dtype=object)
        flat = [np.broadcast_to(a, shape) for a in arrs]
        for idx in np.ndindex(*shape):
            out[idx] = make(*[a[idx] for a in flat])
        return _Val(out, lanes)

    # ---- one node
    def lower_node(self, node) -> _Val:
        if node.op == "placeholder":
            sym, n = ("x", self.nx) if not self.env else ("u", self.nu)
            items = np.empty(n, dtype=object)
            for i in range(n):
                items[i] = ("T", f"{sym}[{i}]")
            return _Val(items, True)
        if node.op == "get_attr":
            t = getattr(self.gm, node.target)
            if t.numel() != 1 or t.is_complex():
                raise Unsupported(f"constant tensor of shape {tuple(t.shape)}")
            flag = t.dtype == torch.bool
            item = ("B" if flag else "S",
                    _literal(bool(t.item()) if flag else t.item()))
            return _Val(_fill(tuple(t.shape), item), False)
        if node.op != "call_function" or not hasattr(node.target,
                                                     "_overloadpacket"):
            raise Unsupported(f"{node.format_node()}")
        op = node.target._overloadpacket.__name__
        args, kw = node.args, dict(node.kwargs)
        em = self.em

        def arith(sym):
            def make(a, b):
                if "B" in (a[0], b[0]):
                    raise Unsupported(f"{node.format_node()}: bool arithmetic")
                kind = "S" if a[0] == b[0] == "S" else "T"
                return em.bind(kind, f"{a[1]} {sym} {b[1]}", _names(a, b))
            return make

        if op in _PASS or (op == "_to_copy" and set(kw) <= {"dtype"}
                           and kw.get("dtype") in (None, _dtype_of(args[0]))):
            return self.val(args[0])
        if op == "detach":          # the value alone: no tangent through it
            return self.elementwise(node, args[:1], lambda a: a if a[0] != "T"
                                    else em.bind("T", f"T(m_value({a[1]}))",
                                                 _names(a)))
        if op in ("add", "sub", "rsub"):
            alpha = kw.pop("alpha", 1)
            if kw or alpha != 1:
                raise Unsupported(f"{node.format_node()}: alpha / kwargs")
            a, b = (args[1], args[0]) if op == "rsub" else args[:2]
            return self.elementwise(node, (a, b),
                                    arith("+" if op == "add" else "-"))
        if op in ("mul", "div"):
            if kw.get("rounding_mode") is not None:
                raise Unsupported(f"{node.format_node()}: rounding mode")
            return self.elementwise(node, args[:2], arith(_ARITH[op]))
        if op in _UNARY:
            def make(a, fmt=_UNARY[op]):
                if a[0] == "B":
                    raise Unsupported(f"{node.format_node()}: bool input")
                return em.bind(a[0], fmt.format(a[1]), _names(a))
            return self.elementwise(node, args[:1], make)
        if op == "pow":
            if not isinstance(args[1], (int, float)) or \
                    isinstance(args[1], bool):
                raise Unsupported(f"{node.format_node()}: pow by a tensor")
            return self.elementwise(node, args[:1], lambda a: self.power(
                a, args[1]))
        if op in ("minimum", "maximum"):
            fn = "m_min" if op == "minimum" else "m_max"
            return self.elementwise(node, args[:2], lambda a, b: em.bind(
                "T", f"{fn}({_as_t(a)}, {_as_t(b)})", _names(a, b)))
        if op in _COMPARE:
            sym = _COMPARE[op]
            return self.elementwise(node, args[:2], lambda a, b: em.bind(
                "B", f"{_value_of(a)} {sym} {_value_of(b)}", _names(a, b)))
        if op in _LOGICAL:
            sym = _LOGICAL[op]

            def make(a, b):
                if a[0] != "B" or b[0] != "B":
                    raise Unsupported(f"{node.format_node()}: not bool")
                return em.bind("B", f"{a[1]} {sym} {b[1]}", _names(a, b))
            return self.elementwise(node, args[:2], make)
        if op in ("logical_not", "bitwise_not"):
            def make(a):
                if a[0] != "B":
                    raise Unsupported(f"{node.format_node()}: not bool")
                return em.bind("B", f"!{a[1]}", _names(a))
            return self.elementwise(node, args[:1], make)
        if op == "where":
            def make(c, a, b):
                if c[0] != "B" or "B" in (a[0], b[0]):
                    raise Unsupported(f"{node.format_node()}: where types")
                return em.bind("T", f"{c[1]} ? {_as_t(a)} : {_as_t(b)}",
                               _names(c, a, b))
            return self.elementwise(node, args[:3], make)
        if op in _FILL or op == "full_like":
            fill = _FILL.get(op, args[1] if len(args) > 1 else None)
            if not isinstance(fill, (int, float)):
                raise Unsupported(f"{node.format_node()}: fill value")
            src = self.val(args[0])
            return _Val(_fill(src.items.shape, ("S", _literal(fill))),
                        src.lanes)
        if op == "scalar_tensor":
            return _Val(_scalar(("S", _literal(args[0]))), False)
        return self.structural(node, op, args, kw)

    def power(self, a, e):
        em = self.em
        if a[0] == "B":
            raise Unsupported("pow of a bool")
        k, v = a
        e = float(e)
        if e == 0:
            return ("S", "S(1)")
        if e == 1:
            return a
        if e == 2:
            return em.bind(k, f"{v} * {v}", [v])
        if e == 3:
            sq = em.bind(k, f"{v} * {v}", [v])
            return em.bind(k, f"{sq[1]} * {v}", [sq[1], v])
        if e == -1:
            return em.bind(k, f"S(1) / {v}", [v])
        if e == -2:
            sq = em.bind(k, f"{v} * {v}", [v])
            return em.bind(k, f"S(1) / {sq[1]}", [sq[1]])
        if e == 0.5:
            return em.bind(k, f"m_sqrt({v})", [v])
        if e == -0.5:
            return em.bind(k, f"S(1) / m_sqrt({v})", [v])
        return em.bind(k, f"m_pow({v}, {_literal(e)})", [v])

    def structural(self, node, op, args, kw) -> _Val:
        """Indexing and stacking over the leading dimensions; the lane
        dimension must stay last and whole."""
        out_shape = self.meta_shape(node)
        if op in ("stack", "cat"):
            vals = [self.val(a) for a in args[0]]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            lanes = any(v.lanes for v in vals)
            if lanes and not all(v.lanes for v in vals):
                raise Unsupported(f"{node.format_node()}: lanes and constants")
            nd = len(out_shape)
            d = dim % nd
            if lanes and d == nd - 1:
                raise Unsupported(f"{node.format_node()}: over the lanes")
            arrs = [v.items for v in vals]
            items = np.stack(arrs, axis=d) if op == "stack" else \
                np.concatenate(arrs, axis=d)
            return self.checked(node, _Val(items, lanes), out_shape)
        src = self.val(args[0])
        nd_in = src.items.ndim + (1 if src.lanes else 0)
        if op == "select":
            d = args[1] % nd_in
            if src.lanes and d == nd_in - 1:
                raise Unsupported(f"{node.format_node()}: indexes the lanes")
            sl = [slice(None)] * src.items.ndim
            sl[d] = args[2]
            items = src.items[tuple(sl)]
            if not isinstance(items, np.ndarray):
                items = _scalar(items)
            return self.checked(node, _Val(items, src.lanes), out_shape)
        if op == "slice":
            d = (args[1] if len(args) > 1 else 0) % nd_in
            start = args[2] if len(args) > 2 else None
            end = args[3] if len(args) > 3 else None
            step = args[4] if len(args) > 4 else 1
            if src.lanes and d == nd_in - 1:
                if (start or 0) == 0 and (end is None or end >= LANES) \
                        and step == 1:
                    return src
                raise Unsupported(f"{node.format_node()}: slices the lanes")
            sl = [slice(None)] * src.items.ndim
            sl[d] = slice(start, end, step)
            return self.checked(node, _Val(src.items[tuple(sl)], src.lanes),
                                out_shape)
        if op == "unsqueeze":
            d = args[1] % (nd_in + 1)
            if src.lanes and d == nd_in:
                raise Unsupported(f"{node.format_node()}: past the lanes")
            return self.checked(node, _Val(np.expand_dims(src.items, d),
                                           src.lanes), out_shape)
        if op in ("squeeze", "view", "reshape", "_unsafe_view"):
            lead = out_shape[:-1] if src.lanes else out_shape
            if src.lanes and (not out_shape or out_shape[-1] != LANES):
                raise Unsupported(f"{node.format_node()}: moves the lanes")
            return self.checked(node, _Val(src.items.reshape(lead),
                                           src.lanes), out_shape)
        raise Unsupported(f"op {node.target} ({node.format_node()})")

    def checked(self, node, v: _Val, out_shape) -> _Val:
        want = v.items.shape + ((LANES,) if v.lanes else ())
        if want != tuple(out_shape):
            raise Unsupported(f"{node.format_node()}: shape {out_shape}, "
                              f"lowered as {want}")
        return v

    def run(self) -> _Val:
        out = None
        for node in self.gm.graph.nodes:
            if node.op == "output":
                out = self.env[node.args[0]] if isinstance(
                    node.args[0], torch.fx.Node) else None
                break
            v = self.lower_node(node)
            if node.op == "call_function":
                self.checked(node, v, self.meta_shape(node))
            self.env[node] = v
        return out


def _scalar(item) -> np.ndarray:
    a = np.empty((), dtype=object)
    a[()] = item
    return a


def _fill(shape, item) -> np.ndarray:
    a = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        a[idx] = item
    return a


def _dtype_of(a):
    v = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
    return getattr(v, "dtype", None)


def _trace(dyn: Dynamics) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx
    x = torch.zeros(dyn.nx, LANES, dtype=torch.float64)
    u = torch.zeros(dyn.nu, LANES, dtype=torch.float64)
    try:
        return make_fx(dyn.f, tracing_mode="fake",
                       _allow_non_fake_inputs=True)(x, u)
    except Exception as e:       # any failure to trace: not lowerable
        raise Unsupported(f"tracing {dyn.name!r} failed: "
                          f"{type(e).__name__}: {e}") from None


def _struct(dyn: Dynamics, nq: int, body: list, outs: list) -> str:
    if nq:
        sig = "acc(const T* x, const T* u, T* qdd) const"
        writes = [f"    qdd[{i}] = {_as_t(o)};" for i, o in enumerate(outs)]
    else:
        sig = "f(const T* x, const T* u, T* out) const"
        writes = [f"    out[{i}] = {_as_t(o)};" for i, o in enumerate(outs)]
    return "\n".join([
        f"// The dynamics {dyn.name!r} (nx={dyn.nx}, nu={dyn.nu}"
        + (f", nq={nq}" if nq else "") + "), generated by",
        "// mahi_mpc_tpu_torch/models/codegen.py from its traced f.",
        "namespace mpc {",
        "namespace gen {",
        "template <typename S>",
        "struct Model {",
        f"  static constexpr int NX = {dyn.nx}, NU = {dyn.nu}, NQ = {nq};",
        "  template <typename T>",
        f"  MPC_HD void {sig} {{",
        *body, *writes,
        "  }",
        "};",
        "}  // namespace gen",
        "}  // namespace mpc",
        ""])


@functools.lru_cache(maxsize=None)
def lower(dyn: Dynamics) -> GeneratedModel:
    """Trace and lower ``dyn.f`` (lanes-polymorphic); raises
    ``Unsupported`` when it cannot be lowered."""
    if not dyn.supports_lanes:
        raise Unsupported(f"{dyn.name!r} is not lanes-polymorphic")
    gm = _trace(dyn)
    low = _Lowering(gm, dyn.nx, dyn.nu)
    out = low.run()
    if out is None or not out.lanes or out.items.shape != (dyn.nx,):
        raise Unsupported(f"{dyn.name!r}: f does not return (nx, lanes)")
    items = list(out.items)
    if any(kind == "B" for kind, _ in items):
        raise Unsupported(f"{dyn.name!r}: f returns bools")
    nq = dyn.nq if dyn.nq is not None and 2 * dyn.nq == dyn.nx else 0
    outs = items[nq:]
    body = low.em.lines(outs)
    return GeneratedModel(dyn.name, dyn.nx, dyn.nu, nq,
                          _struct(dyn, nq, body, outs))


def lowerable(dyn: Dynamics) -> bool:
    """Whether ``lower`` succeeds for ``dyn``."""
    try:
        lower(dyn)
    except Unsupported:
        return False
    return True


__all__ = ["LANES", "GeneratedModel", "Unsupported", "lower", "lowerable"]
