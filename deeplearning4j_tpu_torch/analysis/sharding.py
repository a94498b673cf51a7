"""Sharding pass: mesh-axis bindings resolved per module, interprocedurally.

Port of ``deeplearning4j_tpu/analysis/sharding.py``.  The SH rules need
one fact the raw AST does not carry: *which mesh axes are in scope* at a
given expression.  In the port an axis name reaches a collective of
``parallel/collectives.py`` (``psum``, ``pmean``, ``all_gather``,
``reduce_scatter``, ``ppermute``, ``ring_shift``, ``copy_to_tp``/
``reduce_from_tp``, ...) and is resolved against the *active* mesh, the
innermost ``with mesh:`` — and a one-wide or absent axis makes the
collective the identity, so a typo'd or unbound axis silently reduces
nothing.  Axis sets enter a program through

- a ``Mesh(devices, axis_names)`` construction,
- the ``parallel/mesh.py`` helpers (``make_mesh``/``local_mesh``/
  ``elastic_mesh``/``shrink_mesh``/``grow_mesh``) that wrap it,
- a ``with <mesh>:`` block that binds those axes over its body (the
  reference's ``shard_map``/``pmap`` wrap sites),

and this module threads them through all three: mesh-producing calls and
assignments are resolved to axis sets, ``with`` blocks bind them over
their bodies, and bound axes propagate one module-internal call level at
a time to a fixed point, so a helper called inside a ``with mesh:`` block
inherits its axes.

Everything is deliberately *confidence-ranked*: a binding is either a
known ``frozenset`` of axis names, ``None`` ("bound, but through a mesh
we cannot resolve" — e.g. ``with self.mesh:``), or absent ("never
visibly bound").  SH01 only fires on KNOWN bindings; unknown silences the
rule rather than guessing.

The canonical axis-name registry is parsed straight out of the port's
``parallel/mesh.py`` (the ``DP, TP, PP, SP, EP = ...`` constants and the
``AXES`` table) so the linter and the runtime can never disagree about
which axis names exist.  ``set_axis_registry`` is the test hook.
"""

from __future__ import annotations

import ast
import pathlib

from .core import dotted_name, last_segment
from .jitinfo import ModuleInfo

#: last-resort axis table, used only when parallel/mesh.py is unreadable
_FALLBACK_AXES = ("dp", "tp", "pp", "sp", "ep")

#: the axis-taking collectives of parallel/collectives.py
COLLECTIVES = frozenset({
    "psum", "pmean", "all_gather", "reduce_scatter", "reduce_scatter_or_psum",
    "all_gather_or_identity", "ppermute", "ring_shift", "axis_index",
    "copy_to_tp", "reduce_from_tp", "barrier_sum",
})

#: collectives whose FIRST positional argument is the axis name
_AXIS_FIRST = frozenset({"axis_index", "barrier_sum"})

#: sentinel distinguishing "never bound" from "bound, axes unknown"
_UNWRAPPED = object()

_registry_cache: tuple[frozenset, dict] | None = None
_registry_override: tuple[frozenset, dict] | None = None


def set_axis_registry(axes) -> None:
    """Test hook: replace the parsed mesh.py axis table (None restores)."""
    global _registry_override
    if axes is None:
        _registry_override = None
    else:
        axes = tuple(axes)
        _registry_override = (frozenset(axes),
                              {a.upper(): a for a in axes})


def _parse_mesh_module() -> tuple[frozenset, dict]:
    """(axis-name set, constant-name -> axis-name) from parallel/mesh.py."""
    consts: dict[str, str] = {}
    axes: list[str] = []
    path = (pathlib.Path(__file__).resolve().parents[1]
            / "parallel" / "mesh.py")
    try:
        tree = ast.parse(path.read_text())
    except (OSError, SyntaxError):
        return frozenset(_FALLBACK_AXES), {a.upper(): a for a in _FALLBACK_AXES}
    for stmt in tree.body:
        targets = []
        value = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        for target in targets:
            # DP, TP, PP, SP, EP = "dp", "tp", "pp", "sp", "ep"
            if isinstance(target, ast.Tuple) and isinstance(value, ast.Tuple) \
                    and len(target.elts) == len(value.elts):
                for t, v in zip(target.elts, value.elts):
                    if isinstance(t, ast.Name) and isinstance(v, ast.Constant) \
                            and isinstance(v.value, str):
                        consts[t.id] = v.value
            # AXES: tuple[str, ...] = (DP, TP, PP, SP, EP)
            elif isinstance(target, ast.Name) and target.id == "AXES" \
                    and isinstance(value, (ast.Tuple, ast.List)):
                for v in value.elts:
                    if isinstance(v, ast.Constant) and isinstance(v.value, str):
                        axes.append(v.value)
                    elif isinstance(v, ast.Name) and v.id in consts:
                        axes.append(consts[v.id])
    if not axes:
        axes = list(consts.values()) or list(_FALLBACK_AXES)
    return frozenset(axes), consts


def axis_registry() -> frozenset:
    """The canonical set of mesh-axis names (SH02's ground truth)."""
    return _registry_tables()[0]


def axis_constants() -> dict:
    """Constant name -> axis name (``DP`` -> ``"dp"``) from mesh.py."""
    return _registry_tables()[1]


def _registry_tables() -> tuple[frozenset, dict]:
    global _registry_cache
    if _registry_override is not None:
        return _registry_override
    if _registry_cache is None:
        _registry_cache = _parse_mesh_module()
    return _registry_cache


class ShardingInfo:
    """Per-module axis-binding facts, computed once and cached on the
    :class:`ModuleInfo` (see :func:`sharding_info`)."""

    def __init__(self, module: ModuleInfo):
        self.module = module
        #: local names (incl. dotted like ``self.mesh``) -> axis sets
        self.mesh_axes: dict[str, frozenset | None] = {}
        #: ``with`` node or def -> frozenset (known axes) | None (unknown)
        self.bound: dict[ast.AST, object] = {}
        #: every collective call node -> its enclosing with/def chain
        self.collective_chains: dict[ast.Call, tuple] = {}
        self._defs_by_name: dict[str, list] = {}
        for fn in ast.walk(module.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._defs_by_name.setdefault(fn.name, []).append(fn)
        self._collect_mesh_vars()
        self._collect_bindings()
        self._propagate()
        self._collect_collectives()

    # ------------------------------------------------------------- axes
    def resolve_axis(self, node) -> str | None:
        """Literal/constant-resolved axis name, else None."""
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        name = self.module.canonical(node) or dotted_name(node)
        if not name:
            return None
        base = last_segment(name)
        consts = axis_constants()
        if base in consts and (name == base or name.endswith(f"mesh.{base}")):
            return consts[base]
        return None

    def resolve_axis_tuple(self, node) -> tuple | None:
        """All-resolvable tuple/list of axis names, else None."""
        if isinstance(node, (ast.Tuple, ast.List)):
            out = []
            for elt in node.elts:
                axis = self.resolve_axis(elt)
                if axis is None:
                    return None
                out.append(axis)
            return tuple(out)
        axis = self.resolve_axis(node)
        return None if axis is None else (axis,)

    # -------------------------------------------------------- mesh vars
    def _axes_from_mesh_call(self, call: ast.Call):
        """frozenset | None (unknown) | _UNWRAPPED (not a mesh call)."""
        canon = self.module.canonical(call.func) or ""
        base = last_segment(canon)
        if base == "Mesh":
            axis_arg = call.args[1] if len(call.args) > 1 else None
            for kw in call.keywords:
                if kw.arg == "axis_names":
                    axis_arg = kw.value
            if axis_arg is None:
                return None
            axes = self.resolve_axis_tuple(axis_arg)
            return None if axes is None else frozenset(axes)
        if base == "make_mesh":
            return frozenset(axis_registry())
        if base in ("local_mesh", "elastic_mesh"):
            axis_arg = None
            for kw in call.keywords:
                if kw.arg == "axis":
                    axis_arg = kw.value
            if axis_arg is None and len(call.args) > 1:
                axis_arg = call.args[1]
            if axis_arg is None:
                return frozenset({axis_constants().get("DP", "dp")})
            axis = self.resolve_axis(axis_arg)
            return None if axis is None else frozenset({axis})
        if base in ("shrink_mesh", "grow_mesh"):
            # dp-only by contract (see parallel/mesh.py)
            return frozenset({axis_constants().get("DP", "dp")})
        return _UNWRAPPED

    def _collect_mesh_vars(self) -> None:
        for node in ast.walk(self.module.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            axes = self._axes_from_mesh_call(node.value)
            if axes is _UNWRAPPED:
                continue
            for target in node.targets:
                name = dotted_name(target)
                if name is not None:
                    # two assigns with different axes -> unknown
                    prior = self.mesh_axes.get(name, axes)
                    self.mesh_axes[name] = axes if prior == axes else None

    def _with_mesh_axes(self, expr):
        """Axis set a ``with`` item binds: frozenset | None (a mesh we
        cannot resolve) | _UNWRAPPED (not a mesh)."""
        if isinstance(expr, ast.Call):
            return self._axes_from_mesh_call(expr)
        name = dotted_name(expr)
        if name is None:
            return _UNWRAPPED
        if name in self.mesh_axes:
            return self.mesh_axes[name]
        return None if "mesh" in last_segment(name).lower() else _UNWRAPPED

    # --------------------------------------------------------- bindings
    def _def_for_name(self, basename: str, lineno: int):
        """The local def ``basename`` refers to near ``lineno``; with
        several same-named defs, the closest one defined ABOVE wins."""
        cands = self._defs_by_name.get(basename)
        if not cands:
            return None
        if len(cands) == 1:
            return cands[0]
        above = [d for d in cands if d.lineno <= lineno]
        return max(above, key=lambda d: d.lineno) if above else None

    def _bind(self, target, axes) -> None:
        if target is None:
            return
        prior = self.bound.get(target, _UNWRAPPED)
        if axes is None or prior is None:
            self.bound[target] = None       # unknown dominates
        elif prior is _UNWRAPPED:
            self.bound[target] = frozenset(axes)
        else:
            self.bound[target] = prior | frozenset(axes)

    def _collect_bindings(self) -> None:
        for node in ast.walk(self.module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                axes = self._with_mesh_axes(item.context_expr)
                if axes is not _UNWRAPPED:
                    self._bind(node, axes)

    def _propagate(self) -> None:
        """Bound axes flow to module-local defs called from bound scopes —
        the interprocedural half, run to a (bounded) fixed point."""
        for _ in range(len(self._defs_by_name) + 1):
            changed = False
            for scope, axes in list(self.bound.items()):
                body = (scope.body if isinstance(scope, (ast.With,
                                                         ast.AsyncWith))
                        else [scope])
                for call in (n for stmt in body for n in ast.walk(stmt)):
                    if not isinstance(call, ast.Call):
                        continue
                    callee = dotted_name(call.func)
                    if callee is None:
                        continue
                    child = self._def_for_name(last_segment(callee),
                                               call.lineno)
                    if child is None or child is scope:
                        continue
                    prior = self.bound.get(child, _UNWRAPPED)
                    if axes is None:
                        if prior is not None:
                            self.bound[child] = None
                            changed = True
                    elif prior is _UNWRAPPED:
                        self.bound[child] = frozenset(axes)
                        changed = True
                    elif prior is not None and not (axes <= prior):
                        self.bound[child] = prior | axes
                        changed = True
            if not changed:
                return

    # ------------------------------------------------------ collectives
    def is_collective(self, call: ast.Call) -> bool:
        """A call of a ``parallel/collectives.py`` function (a mesh's own
        ``axis_index`` method resolves against that mesh, not the active
        one, and is not a collective)."""
        canon = self.module.canonical(call.func) or ""
        parts = canon.split(".")
        return parts[-1] in COLLECTIVES and (
            "collectives" in parts[:-1]
            or (len(parts) == 1
                and self.module.path.endswith("parallel/collectives.py")))

    def collective_axis_arg(self, call: ast.Call):
        """The axis-name argument expression of a collective call, or
        None when ``call`` is not a collective / has no axis argument."""
        if not self.is_collective(call):
            return None
        base = last_segment(self.module.canonical(call.func) or "")
        for kw in call.keywords:
            if kw.arg in ("axis_name", "axis"):
                return kw.value
        idx = 0 if base in _AXIS_FIRST else 1
        if idx < len(call.args):
            return call.args[idx]
        return None

    def _collect_collectives(self) -> None:
        def walk(node, chain):
            for child in ast.iter_child_nodes(node):
                sub = chain
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                      ast.Lambda, ast.With, ast.AsyncWith)):
                    sub = chain + (child,)
                if isinstance(child, ast.Call) and self.is_collective(child):
                    self.collective_chains[child] = chain
                walk(child, sub)

        walk(self.module.tree, ())

    def axes_for_chain(self, chain) -> frozenset | None:
        """Axes bound over a lexical with/def chain: the innermost scope
        with a binding decides (the collectives read the innermost ``with
        mesh:``; a def's binding is its callers').  None = unknown (an
        unresolvable mesh, or nothing bound at all)."""
        for scope in reversed(chain):
            b = self.bound.get(scope, _UNWRAPPED)
            if b is not _UNWRAPPED:
                return b
        return None


def sharding_info(module: ModuleInfo) -> ShardingInfo:
    """The module's (cached) sharding pass result."""
    info = getattr(module, "_sharding_info", None)
    if info is None or info.module is not module:
        info = ShardingInfo(module)
        module._sharding_info = info
    return info
