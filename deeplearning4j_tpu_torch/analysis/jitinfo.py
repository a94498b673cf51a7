"""Per-module device context: which callables produce device work.

Port of ``deeplearning4j_tpu/analysis/jitinfo.py``.  The reference
tracks ``jax.jit``-compiled callables, the values they return being the
device arrays a host sync drains the queue for.  The port compiles
nothing: PyTorch launches eagerly and asynchronously, so "jitted" here
means a *device-producing* callable, whose results are tensors on the
card that a ``.item()`` would wait for.  The registry resolves the
idioms of this codebase:

- the step callables the trainer and engine build: ``build_train_step``/
  ``build_finetune_step`` results, the ``_build_*_step`` closures
  (``fn = self._build_sync_step()``), the engine's ``_step``/
  ``_spec_step`` and the model's ``decode_step*``/``decode_window*``;
- the kernel wrappers of ``ops/cuda/`` (any callable reached through an
  ``ops.cuda`` module other than ``build``/``registry``);
- ``nn.Module`` calls: names bound from a ``torch.nn.<Layer>(...)`` or a
  module-local ``nn.Module`` subclass;
- ``torch.*`` factories given a ``device=`` and ``.cuda()`` copies, for
  the sync rules' taint (:meth:`ModuleInfo.is_device_call`).

Cross-module flow (a factory imported from another file) is out of scope
beyond these names: rules that need it match on the callee's *basename*,
which is why suppressions exist.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from .core import assigned_names, dotted_name, iter_functions, last_segment

#: callables that run model or step work on the device, by basename
_STEP_CALLABLES = frozenset({
    "_step", "_spec_step", "decode_step", "decode_step_paged",
    "decode_window", "decode_window_paged"})
#: factories whose result is a step callable (``_build_sync_step`` style)
_FACTORY = re.compile(r"^_?build_\w*step$")
#: ``ops.cuda`` modules that hold no kernel wrapper
_HOST_KERNEL_MODULES = frozenset({"build", "registry"})


@dataclasses.dataclass
class JitInfo:
    """What we know about one device-producing callable (the reference's
    name: a ``jax.jit`` there, a callable that launches CUDA work here):
    the dotted name it is bound to and the line that binds it."""

    name: str
    line: int = 0


class ModuleInfo:
    """Parsed module + the device facts the rules consume."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.aliases = self._collect_aliases()
        #: dotted name -> JitInfo for every callable known to launch work
        self.jitted: dict[str, JitInfo] = {}
        #: basenames of those callables (attribute-call matching)
        self.jitted_basenames: set[str] = set(_STEP_CALLABLES)
        #: local def basenames whose body calls a device-producing callable
        #: (one level of propagation for hot-loop rules)
        self.dispatching_basenames: set[str] = set()
        self._collect_device_facts()

    # ------------------------------------------------------------------ text
    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # ------------------------------------------------------------------ names
    def _collect_aliases(self) -> dict[str, str]:
        """local name -> canonical dotted prefix (``F`` ->
        ``torch.nn.functional``; a relative import keeps its module path:
        ``from ..ops.cuda import attention`` -> ``ops.cuda.attention``)."""
        aliases: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                # ``from . import collectives as clv`` names the module
                for a in node.names:
                    aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}" if node.module else a.name)
        return aliases

    def canonical(self, node: ast.AST) -> str | None:
        """Dotted name with the leading segment alias-resolved:
        ``nn.Linear`` -> ``torch.nn.Linear``."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    # ------------------------------------------------------------------ facts
    def _register(self, name: str, line: int) -> None:
        self.jitted[name] = JitInfo(name=name, line=line)
        self.jitted_basenames.add(last_segment(name))

    def _module_classes(self) -> set[str]:
        """Module-local classes that subclass ``nn.Module``."""
        out = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                for base in node.bases:
                    canon = self.canonical(base) or ""
                    if canon in ("torch.nn.Module", "nn.Module") \
                            or canon.endswith("nn.Module"):
                        out.add(node.name)
        return out

    def _produces_callable(self, call: ast.Call, classes: set[str]) -> bool:
        """Whether ``call`` returns a device-producing callable: a step
        factory, or an ``nn.Module`` constructor."""
        callee = dotted_name(call.func) or ""
        if _FACTORY.match(last_segment(callee) or ""):
            return True
        canon = self.canonical(call.func) or ""
        base = last_segment(canon)
        return (canon.startswith("torch.nn.") and base[:1].isupper()
                or base in classes)

    def _collect_device_facts(self) -> None:
        classes = self._module_classes()
        # pass 1: names bound from step factories and module constructors
        # (an IfExp choosing between two factories counts for both arms)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Assign):
                continue
            calls = ([node.value] if isinstance(node.value, ast.Call)
                     else [node.value.body, node.value.orelse]
                     if isinstance(node.value, ast.IfExp) else [])
            for call in calls:
                if isinstance(call, ast.Call) \
                        and self._produces_callable(call, classes):
                    for t in node.targets:
                        for name in assigned_names(t):
                            self._register(name, node.lineno)
                    break
        # pass 2: defs that CALL a device-producing callable (dispatch
        # propagation for the hot-loop rules)
        for fn in iter_functions(self.tree):
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = dotted_name(node.func)
                    if callee and self.is_jitted_call(callee, node):
                        self.dispatching_basenames.add(fn.name)
                        break

    # ------------------------------------------------------------------ queries
    def _is_kernel(self, call: ast.Call) -> bool:
        canon = self.canonical(call.func) or ""
        parts = canon.split(".")
        for i in range(len(parts) - 2):
            if parts[i] == "ops" and parts[i + 1] == "cuda":
                mod = parts[i + 2]
                return mod not in _HOST_KERNEL_MODULES and i + 3 < len(parts)
        return False

    def is_jitted_call(self, callee: str, call: ast.Call | None = None) -> bool:
        """Does a call to dotted name ``callee`` launch device work
        through a known callable?  Exact dotted match, else basename match
        (covers ``self._step_fn`` style attribute calls); with the call
        node, a kernel wrapper reached through an ``ops.cuda`` module."""
        return (callee in self.jitted
                or last_segment(callee) in self.jitted_basenames
                or (call is not None and self._is_kernel(call)))

    def is_dispatching_call(self, callee: str,
                            call: ast.Call | None = None) -> bool:
        """Device-producing call, or a call to a local def that itself
        dispatches."""
        return (self.is_jitted_call(callee, call)
                or last_segment(callee) in self.dispatching_basenames)

    def is_device_call(self, call: ast.Call) -> bool:
        """Does ``call`` return a tensor on the device: a dispatching
        call, a ``torch.*`` factory given ``device=``, or ``.cuda()``?"""
        callee = dotted_name(call.func)
        if callee and self.is_jitted_call(callee, call):
            return True
        canon = self.canonical(call.func) or ""
        if canon.startswith("torch.") and any(
                kw.arg == "device" for kw in call.keywords):
            return True
        return isinstance(call.func, ast.Attribute) \
            and call.func.attr == "cuda"
