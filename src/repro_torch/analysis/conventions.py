"""AST convention lint over ``src/repro_torch`` — the source-level contract layer.

The reference's lint (``repro.analysis.conventions``) carried to the
port's idioms. Three rules:

* **capture-rng-time (C1)** — no ``time.*`` / ``random.*`` /
  ``np.random.*`` calls inside a function that is captured once and
  replayed: one passed to (or decorated with) ``torch.compile``,
  ``torch.jit.script``, ``torch.jit.trace`` or
  ``torch.cuda.make_graphed_callables``, a body run under
  ``with torch.cuda.graph(...)``, and the module-local functions these
  call. A Python clock or RNG there runs *once, at capture time* — it
  bakes one arbitrary value into every replay, silently. (torch's own
  RNG ops are captured with their generator state, and are not flagged.)
  The port captures nothing today; the rule is in place for the first
  captured step.
* **wire-sort-stability (C2)** — in the wire-shaping modules
  (``core/mapreduce.py``, ``kernels/coded_shuffle``), every
  ``argsort`` call (``torch.argsort``, ``np.argsort``, ``Tensor.argsort``)
  and every ``torch.sort`` / ``np.sort`` must spell its stability
  (``stable=`` or numpy's ``kind=``). The identical-sort contract must be
  visible in the source, not inherited from a default.

* **callback-marker (C3)** — in the phase-B modules (``core/mapreduce.py``,
  ``kernels/wave_timer``, ``kernels/coded_shuffle``), every call that
  syncs with the host (``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``.nonzero()``, ``.to("cpu")``, ``torch.cuda.synchronize``)
  carries an ``# analysis: allow-callback`` marker on the call (or the
  line above), and sits in a function decorated with
  ``allowlist.allow_callback``. The marker and the decorator are the
  source-level half of the :mod:`repro_torch.analysis.allowlist`
  declaration that the determinism checker (D1) reads from the recorded
  programs: greppable, reviewed in diffs, and checked here so it cannot
  rot.

The ``analysis`` package itself is excluded from tree scans, as in the
reference.
"""

from __future__ import annotations

import ast
import pathlib
from typing import Iterable, List, Optional, Set

from repro_torch.analysis.report import Finding

# Callee names whose first positional argument is captured and replayed.
_CAPTURE_WRAPPERS = {"compile", "script", "trace", "make_graphed_callables"}
# Context managers whose body is captured (``torch.cuda.graph``).
_CAPTURE_CONTEXTS = {"graph"}
_SORT_ATTRS = {"argsort"}
_STABILITY_KWARGS = {"stable", "kind"}

# Files whose sorts shape the shuffle wire (C2 scope).
_WIRE_PARTS = ("core/mapreduce.py", "kernels/coded_shuffle")
# Files of phase B whose host syncs must be declared (C3 scope).
_CALLBACK_PARTS = ("core/mapreduce.py", "kernels/wave_timer", "kernels/coded_shuffle")
# Calls that make the host wait for the device.
_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy", "nonzero", "synchronize"}
_MARKER = "# analysis: allow-callback"
_DECLARE = "allow_callback"


def _final_attr(func: ast.expr) -> Optional[str]:
    """The last dotted component of a callee (``torch.jit.script`` → ``script``)."""
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _dotted(func: ast.expr) -> str:
    """Best-effort dotted name of a callee expression."""
    parts: List[str] = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


def _names(node: ast.expr) -> List[str]:
    """Bare function names in a callee argument (a name or a tuple of them)."""
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [e.id for e in node.elts if isinstance(e, ast.Name)]
    return []


class _ModuleLint:
    """One parsed module + the alias/def maps the two rules need."""

    def __init__(self, path: pathlib.Path):
        self.path = path
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=str(path))
        # Aliases of the host-effect modules, of torch and of numpy.
        self.time_aliases: Set[str] = set()
        self.random_aliases: Set[str] = set()
        self.numpy_aliases: Set[str] = set()
        self.torch_aliases: Set[str] = set()
        # Names imported *from* time/random (from time import perf_counter),
        # and capture wrappers imported from torch (from torch.jit import script).
        self.host_fn_names: Set[str] = set()
        self.torch_names: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name.split(".")[0]
                    head = a.name.split(".")[0]
                    if a.name == "time":
                        self.time_aliases.add(alias)
                    elif a.name == "random":
                        self.random_aliases.add(alias)
                    elif head == "numpy":
                        self.numpy_aliases.add(alias)
                    elif head == "torch":
                        self.torch_aliases.add(alias)
            elif isinstance(node, ast.ImportFrom):
                if node.module in ("time", "random"):
                    for a in node.names:
                        self.host_fn_names.add(a.asname or a.name)
                elif node.module and node.module.split(".")[0] == "torch":
                    for a in node.names:
                        self.torch_names.add(a.asname or a.name)
        # Function defs by bare name.
        self.defs = {
            n.name: n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    def _is_torch_callee(self, func: ast.expr, names: Set[str]) -> bool:
        """``func`` names one of ``names``, reached through torch."""
        if _final_attr(func) not in names:
            return False
        dotted = _dotted(func)
        head = dotted.split(".")[0]
        if "." in dotted:
            return head in self.torch_aliases or head in self.torch_names
        return dotted in self.torch_names

    # -- captured-root discovery --------------------------------------------

    def _captured_blocks(self) -> List[ast.With]:
        """``with torch.cuda.graph(...)`` statements."""
        blocks = []
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    ctx = item.context_expr
                    if isinstance(ctx, ast.Call) and \
                            self._is_torch_callee(ctx.func, _CAPTURE_CONTEXTS):
                        blocks.append(node)
                        break
        return blocks

    def captured_roots(self) -> Set[str]:
        """Names of functions whose body is captured and replayed."""
        roots: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Call):
                if self._is_torch_callee(node.func, _CAPTURE_WRAPPERS) and node.args:
                    roots.update(_names(node.args[0]))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    d = dec.func if isinstance(dec, ast.Call) else dec
                    if self._is_torch_callee(d, _CAPTURE_WRAPPERS):
                        roots.add(node.name)
                    # functools.partial(torch.compile, ...) decorators
                    if isinstance(dec, ast.Call) and \
                            _final_attr(dec.func) == "partial" and dec.args and \
                            self._is_torch_callee(dec.args[0], _CAPTURE_WRAPPERS):
                        roots.add(node.name)
        for block in self._captured_blocks():
            for stmt in block.body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                        roots.add(node.func.id)
        # Transitive closure over bare-name calls to module-local defs.
        frontier = [r for r in roots if r in self.defs]
        seen = set(frontier)
        while frontier:
            fn = self.defs[frontier.pop()]
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                    callee = node.func.id
                    if callee in self.defs and callee not in seen:
                        seen.add(callee)
                        frontier.append(callee)
        return seen

    def _is_host_effect_call(self, node: ast.Call) -> Optional[str]:
        """Dotted name when ``node`` calls a Python clock/RNG, else None."""
        dotted = _dotted(node.func)
        head = dotted.split(".")[0] if dotted else ""
        if head in self.time_aliases or head in self.random_aliases:
            return dotted
        if head in self.numpy_aliases and ".random." in f".{dotted}.":
            return dotted
        if isinstance(node.func, ast.Name) and \
                node.func.id in self.host_fn_names:
            return node.func.id
        return None

    def _excerpt(self, node: ast.AST) -> str:
        line = self.lines[node.lineno - 1].strip()
        return f"{self.path}:{node.lineno}: {line}"

    def _host_effect_finding(self, where: str, node: ast.Call, dotted: str) -> Finding:
        return Finding(
            checker="conventions",
            rule="capture-rng-time",
            target=str(self.path),
            summary=(
                f"{where} calls {dotted}() — it runs once at capture time "
                "and bakes one value into every replay"),
            evidence=[self._excerpt(node)],
        )

    # -- the two rules --------------------------------------------------------

    def check_capture_host_effects(self) -> List[Finding]:
        findings: List[Finding] = []
        for name in sorted(self.captured_roots()):
            fn = self.defs.get(name)
            if fn is None:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    dotted = self._is_host_effect_call(node)
                    if dotted:
                        findings.append(self._host_effect_finding(
                            f"captured function {name!r}", node, dotted))
        for block in self._captured_blocks():
            for stmt in block.body:
                for node in ast.walk(stmt):
                    if isinstance(node, ast.Call):
                        dotted = self._is_host_effect_call(node)
                        if dotted:
                            findings.append(self._host_effect_finding(
                                f"the body captured at line {block.lineno}", node,
                                dotted))
        return findings

    def check_wire_sorts(self) -> List[Finding]:
        posix = self.path.as_posix()
        if not any(part in posix for part in _WIRE_PARTS):
            return []
        findings: List[Finding] = []
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            attr = _final_attr(node.func)
            dotted = _dotted(node.func)
            head = dotted.split(".")[0]
            is_sort = attr in _SORT_ATTRS or (
                attr == "sort" and (head in self.torch_aliases
                                    or head in self.numpy_aliases))
            if not is_sort:
                continue
            kwargs = {kw.arg for kw in node.keywords}
            if kwargs & _STABILITY_KWARGS:
                continue
            findings.append(Finding(
                checker="conventions",
                rule="wire-sort-stability",
                target=str(self.path),
                summary=(
                    f"{dotted or attr}() in a wire-shaping module "
                    "without an explicit stability argument — the "
                    "identical-sort contract must be spelled out, not "
                    "inherited from a default"),
                evidence=[self._excerpt(node)],
            ))
        return findings


    def _is_sync_call(self, node: ast.Call) -> bool:
        attr = _final_attr(node.func)
        if attr in _SYNC_ATTRS and isinstance(node.func, ast.Attribute):
            return True
        if attr == "to" and isinstance(node.func, ast.Attribute):
            args = list(node.args) + [kw.value for kw in node.keywords if kw.arg == "device"]
            return any(isinstance(a, ast.Constant) and a.value == "cpu" for a in args)
        return False

    def _declared(self, fn) -> bool:
        return fn is not None and any(
            _final_attr(d.func if isinstance(d, ast.Call) else d) == _DECLARE
            for d in fn.decorator_list)

    def check_callback_markers(self) -> List[Finding]:
        posix = self.path.as_posix()
        if not any(part in posix for part in _CALLBACK_PARTS):
            return []
        findings: List[Finding] = []
        enclosing = {}
        for fn in ast.walk(self.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for node in ast.walk(fn):
                    enclosing[node] = fn          # innermost def wins (walk is outer first)
        flagged = set()
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call) or not self._is_sync_call(node) \
                    or node.lineno in flagged:
                continue
            start = max(0, node.lineno - 2)          # line above the call
            end = getattr(node, "end_lineno", node.lineno)
            marked = any(_MARKER in line for line in self.lines[start:end])
            fn = enclosing.get(node)
            if marked and self._declared(fn):
                continue
            flagged.add(node.lineno)
            why = ("without an '# analysis: allow-callback' marker" if not marked else
                   f"in {fn.name if fn else 'module scope'}, which is not decorated "
                   "with allowlist.allow_callback")
            findings.append(Finding(
                checker="conventions",
                rule="callback-marker",
                target=str(self.path),
                summary=(
                    f"host sync {_dotted(node.func) or 'call'}() {why} — syncs "
                    "must be declared where they are made, not discovered"),
                evidence=[self._excerpt(node)],
            ))
        return findings


def lint_paths(paths: Iterable[pathlib.Path]) -> List[Finding]:
    """Run all three convention rules over the given Python files."""
    findings: List[Finding] = []
    for p in paths:
        lint = _ModuleLint(pathlib.Path(p))
        findings.extend(lint.check_capture_host_effects())
        findings.extend(lint.check_wire_sorts())
        findings.extend(lint.check_callback_markers())
    return findings


def lint_tree(root) -> List[Finding]:
    """Lint every ``.py`` under ``root``, excluding the analysis package."""
    root = pathlib.Path(root)
    paths = sorted(
        p for p in root.rglob("*.py")
        if "analysis" not in p.parts
    )
    return lint_paths(paths)


def default_root() -> pathlib.Path:
    """The ``repro_torch`` package directory (what ``--check`` lints)."""
    return pathlib.Path(__file__).resolve().parent.parent
