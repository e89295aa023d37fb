"""Recorded phase-B programs and an op-level dependency DAG.

The reference's checkers read jaxprs; the port's phase B is a generator
(:func:`repro_torch.core.mapreduce._phase_b_body`, and the coded
:func:`~repro_torch.core.mapreduce._phase_b_coded`) that yields at each
collective while a driver performs it. Its "trace" is a **recorded run**:
:class:`Recorder` executes the real body on real tensors (the CPU by
default, CUDA just as well) and turns every operation into a node of one
producer → consumer DAG, :class:`OpGraph`, with the graph interface the
reference's ``EqnGraph`` gives its checkers.

What becomes a node:

* **Collectives.** The engine's own runners perform them
  (:func:`repro_torch.core.mapreduce._drive_stacked`,
  ``MapReduceJob._drive_sharded``); the recorder swaps in its functions
  that move data between slots (``_copy_chunk``, ``_transpose_slots``,
  and a sharded job's ``_copy_to`` / ``_exchange_to``, see
  :func:`one_slot`) as opaque ``all_to_all`` nodes. A body wrapped in
  :func:`tapped` also gives its ``spill`` and ``pmax`` yields nodes of
  their own (prims ``spill`` and ``pmax``), which no runner function
  performs.
* **Kernels.** Every public kernel wrapper (``fused_shuffle_reduce``, the
  XOR ops, the histograms, the wave-timer stamps, ...) is one *opaque*
  node on both devices, with the wrapper's tensors as its inputs and
  outputs: a ctypes launch is invisible to PyTorch's dispatcher, and the
  plain version's interior on the CPU is not the program the card runs.
  A stamp (``stamp_through``) has two output slots: 0 the pass-through
  copy, 1 the tick words.
* **Host syncs.** ``aten._local_scalar_dense`` (``.item()``, ``int(t)``),
  ``nonzero``, a boolean-mask index, ``.cpu()`` / ``.to("cpu")`` /
  ``.tolist()`` / ``.numpy()`` and ``torch.cuda.synchronize`` become
  prim ``host_callback``, resolved to the function that made them
  (``module.qualname``, the :mod:`repro_torch.analysis.allowlist` key).
  The Python-level ones are caught on either device, so a CPU recording
  names the syncs the card would make.
* **Every other aten op**, seen through a ``TorchDispatchMode``.

Edges follow *values*, not Python objects. A value is a storage at a
generation: each recorded op that writes a storage (an in-place
``index_add_`` or ``scatter_``, an ``out=`` argument, as its schema says)
starts a new generation that later readers depend on, and a view — which
shares its base's storage — shares its base's producer and is no node of
its own. (PyTorch's own version counter is bumped only after the
dispatcher returns, too late to key the writer's result.) A host constant
moved to the card is a graph source, as it is on the CPU. Every tensor
seen is kept alive until the recording ends, so no storage is recycled
under a live name.

Recording changes nothing: the same ops run on the same tensors, so a
recorded run's outputs equal an unrecorded run's bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

Slot = Tuple[int, int]

# aten ops that make the host wait for the card.
_SYNC_OPS = {"_local_scalar_dense", "nonzero", "equal", "masked_select", "_unique2",
             "unique_consecutive", "unique_dim"}
# aten ops whose result is a moved copy (a host constant uploaded to the card
# is a source, as the same constant is on the CPU).
_MOVE_OPS = {"_to_copy", "to", "copy", "copy_"}
# Allocations: their contents are no value anything depends on.
_EMPTY_OPS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
# Float accumulates whose order of additions is free on CUDA.
_ADD_OPS = {"index_add", "index_add_", "scatter_add", "scatter_add_"}
_REDUCE_OPS = {"scatter_reduce", "scatter_reduce_"}
_PUT_OPS = {"index_put", "index_put_", "_index_put_impl_"}

_THIS = __name__


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _written(func, args, kwargs) -> List[torch.Tensor]:
    """The tensor arguments an aten op writes, from its schema."""
    out = []
    for i, arg in enumerate(func._schema.arguments):
        info = arg.alias_info
        if info is None or not info.is_write:
            continue
        value = kwargs.get(arg.name) if arg.kwarg_only or i >= len(args) else args[i]
        out.extend(_tensors(value))
    return out


def caller_site() -> str:
    """``module.qualname`` of the innermost Python function outside torch
    and this module — the function that issued the current op."""
    frame = sys._getframe(1)
    while frame is not None:
        mod = frame.f_globals.get("__name__", "?")
        if not (mod == "torch" or mod.startswith("torch.") or mod == _THIS
                or mod == "contextlib"):
            return f"{mod}.{frame.f_code.co_qualname}"
        frame = frame.f_back
    return "?"


@dataclasses.dataclass
class Node:
    """One recorded operation."""

    id: int
    prim: str                        # aten op name, a collective, a kernel, host_callback
    site: str                        # module.qualname that issued it
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    preds: Set[Slot] = dataclasses.field(default_factory=set)

    def describe(self) -> str:
        """One readable line: id, prim, salient attributes, who made it."""
        bits = [f"{k}={v}" for k, v in sorted(self.attrs.items())
                if k in ("is_stable", "callback", "op", "label", "reduce", "accumulate")]
        extra = f" {' '.join(bits)}" if bits else ""
        return f"#{self.id} {self.prim}{extra} (by {self.site})"


class OpGraph:
    """Producer → consumer DAG over one recorded program (``EqnGraph``'s
    interface: nodes in program order, edges per output slot)."""

    def __init__(self):
        self.nodes: List[Node] = []
        self._succ_by_out: Dict[Slot, Set[int]] = {}
        self._succ: Dict[int, Set[int]] = {}
        # Producers of the program's outputs, one (node, slot) or None per
        # top-level output.
        self.outputs: List[Optional[Slot]] = []

    def _add(self, prim: str, preds: Iterable[Slot], site: str, **attrs) -> Node:
        node = Node(id=len(self.nodes), prim=prim, site=site, attrs=attrs)
        self.nodes.append(node)
        for prod in preds:
            node.preds.add(prod)
            self._succ_by_out.setdefault(prod, set()).add(node.id)
            self._succ.setdefault(prod[0], set()).add(node.id)
        return node

    # -- queries ------------------------------------------------------------

    def prims(self) -> List[str]:
        """The node prims in program order (a recording's fingerprint)."""
        return [n.prim for n in self.nodes]

    def by_prim(self, name: str) -> List[Node]:
        """All nodes of one prim, in program order."""
        return [n for n in self.nodes if n.prim == name]

    def consumers_of_output(self, node_id: int, out_idx: int) -> Set[int]:
        """Direct consumers of one specific output slot."""
        return self._succ_by_out.get((node_id, out_idx), set())

    def reachable_from(self, starts: Sequence[int]) -> Set[int]:
        """Transitive consumers of the given nodes (the nodes excluded)."""
        seen: Set[int] = set()
        frontier = list(starts)
        while frontier:
            nid = frontier.pop()
            for s in self._succ.get(nid, ()):
                if s not in seen:
                    seen.add(s)
                    frontier.append(s)
        return seen

    def ancestors_of(self, node_id: int) -> Set[int]:
        """Transitive producers feeding ``node_id`` (itself excluded)."""
        seen: Set[int] = set()
        frontier = [node_id]
        while frontier:
            nid = frontier.pop()
            for (p, _idx) in self.nodes[nid].preds:
                if p not in seen:
                    seen.add(p)
                    frontier.append(p)
        return seen

    def find_path(self, src: int, dst: int) -> List[int]:
        """One shortest dependency chain src → … → dst (BFS), [] if none."""
        if src == dst:
            return [src]
        parent: Dict[int, int] = {}
        frontier = [src]
        while frontier:
            nxt: List[int] = []
            for nid in frontier:
                for s in sorted(self._succ.get(nid, ())):
                    if s in parent:
                        continue
                    parent[s] = nid
                    if s == dst:
                        chain = [dst]
                        while chain[-1] != src:
                            chain.append(parent[chain[-1]])
                        return list(reversed(chain))
                    nxt.append(s)
            frontier = nxt
        return []

    def describe_path(self, chain: Sequence[int]) -> List[str]:
        """Render a node chain as readable evidence lines."""
        return [f"{'    ' if i == 0 else ' -> '}{self.nodes[nid].describe()}"
                for i, nid in enumerate(chain)]

    def output_producer_ids(self, out_indices: Sequence[int]) -> Set[int]:
        """Node ids producing the given top-level output slots."""
        return {self.outputs[i][0] for i in out_indices
                if i < len(self.outputs) and self.outputs[i] is not None}


class Recorder(TorchDispatchMode):
    """Record one program into an :class:`OpGraph` (``with Recorder() as rec``).

    Inside the ``with``: every aten op is a node, the kernel wrappers of
    :func:`_kernel_wrappers` and the stacked runner's collectives
    (:func:`_collectives`) are opaque nodes, and the host syncs named in
    the module docstring are ``host_callback`` nodes. :meth:`collective`
    adds a collective node, :meth:`suspended` runs code unrecorded, and
    :meth:`set_outputs` names the program's outputs.
    """

    def __init__(self):
        super().__init__()
        self.graph = OpGraph()
        self._producer: Dict[Tuple[int, int], Slot] = {}
        self._gen: Dict[int, int] = {}
        self._keep: List[torch.Tensor] = []
        self._suspend = 0
        self._synced: Set[int] = set()
        self._patches: List[Tuple[Any, str, Any]] = []

    # -- bookkeeping ----------------------------------------------------------

    def _key(self, t: torch.Tensor) -> Tuple[int, int]:
        """The value a tensor holds: its storage at its current generation."""
        c = _storage(t)
        return (c, self._gen.get(c, 0))

    def _preds(self, tensors: Iterable[torch.Tensor]) -> List[Slot]:
        out = []
        for t in tensors:
            self._keep.append(t)
            prod = self._producer.get(self._key(t))
            if prod is not None and prod not in out:
                out.append(prod)
        return out

    def _produce(self, node: Node, outs: Sequence[Optional[torch.Tensor]]) -> None:
        for i, t in enumerate(outs):
            if isinstance(t, torch.Tensor):
                self._keep.append(t)
                self._producer[self._key(t)] = (node.id, i)

    def producer_of(self, t: torch.Tensor) -> Optional[Slot]:
        """The node slot that made the value ``t`` holds (None for a source)."""
        return self._producer.get(self._key(t))

    @contextlib.contextmanager
    def suspended(self):
        """Run the body of the ``with`` unrecorded."""
        self._suspend += 1
        try:
            yield
        finally:
            self._suspend -= 1

    def opaque(self, prim: str, fn: Callable, *args, attrs=None, **kwargs):
        """Run ``fn`` unrecorded as one node ``prim``: its tensor arguments
        are the node's inputs, its tensor results its output slots in order."""
        if self._suspend:
            return fn(*args, **kwargs)
        preds = self._preds(_tensors((args, kwargs)))
        site = caller_site()
        with self.suspended():
            out = fn(*args, **kwargs)
        node = self.graph._add(prim, preds, site, **(attrs or {}))
        self._produce(node, _tensors(out))
        return out

    def collective(self, prim: str, fn: Callable, *args, **attrs):
        """One collective node: ``fn(*args)`` performed unrecorded."""
        return self.opaque(prim, fn, *args, attrs=attrs)

    def set_outputs(self, result) -> None:
        """Name the program's top-level outputs (a tuple of tensors)."""
        items = result if isinstance(result, (tuple, list)) else (result,)
        self.graph.outputs = [self.producer_of(t) if isinstance(t, torch.Tensor) else None
                              for t in items]

    # -- host syncs -----------------------------------------------------------

    def _host_sync(self, what: str, t: torch.Tensor, call: Callable):
        if self._suspend or (what in ("numpy", "tolist") and id(t) in self._synced):
            return call()
        preds = self._preds([t])
        site = caller_site()
        with self.suspended():
            out = call()
        node = self.graph._add("host_callback", preds, site, op=what, callback=site)
        if isinstance(out, torch.Tensor):
            self._synced.add(id(out))
            self._keep.append(out)
            if out is not t:
                self._produce(node, [out])
        return out

    def _install(self) -> None:
        rec = self
        orig_cpu, orig_to = torch.Tensor.cpu, torch.Tensor.to
        orig_tolist, orig_numpy = torch.Tensor.tolist, torch.Tensor.numpy
        orig_sync = torch.cuda.synchronize

        def cpu(t, *a, **k):
            return rec._host_sync("cpu", t, lambda: orig_cpu(t, *a, **k))

        def to(t, *a, **k):
            device = torch._C._nn._parse_to(*a, **k)[0]
            if device is not None and device.type == "cpu":
                return rec._host_sync("to_cpu", t, lambda: orig_to(t, *a, **k))
            return orig_to(t, *a, **k)

        def tolist(t):
            return rec._host_sync("tolist", t, lambda: orig_tolist(t))

        def numpy(t, *a, **k):
            return rec._host_sync("numpy", t, lambda: orig_numpy(t, *a, **k))

        def synchronize(device=None):
            if rec._suspend:
                return orig_sync(device)
            site = caller_site()
            with rec.suspended():
                orig_sync(device)
            rec.graph._add("host_callback", [], site, op="synchronize", callback=site)

        self._patch(torch.Tensor, "cpu", cpu)
        self._patch(torch.Tensor, "to", to)
        self._patch(torch.Tensor, "tolist", tolist)
        self._patch(torch.Tensor, "numpy", numpy)
        self._patch(torch.cuda, "synchronize", synchronize)
        for module, name, prim in _kernel_wrappers():
            self._patch(module, name,
                        _opaque_wrapper(self, prim, getattr(module, name), kernel=True))
        for module, name in _collectives():
            self._patch(module, name,
                        _opaque_wrapper(self, "all_to_all", getattr(module, name), label=name))

    def _patch(self, owner, name: str, value) -> None:
        self._patches.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        self._install()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            for owner, name, value in reversed(self._patches):
                setattr(owner, name, value)
            self._patches.clear()

    # -- the dispatcher -------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._suspend:
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        preds = self._preds(ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        name = func.overloadpacket.__name__
        mutated = _written(func, args, kwargs)
        in_storages = {_storage(t) for t in ins}
        if not mutated and outs and all(_storage(t) in in_storages for t in outs):
            return out                     # a view / alias: the base's producer
        if name in _EMPTY_OPS:
            return out                     # uninitialised memory: no value to depend on
        read = [t for t in ins if all(t is not w for w in mutated)]
        if name in _MOVE_OPS and read and not preds \
                and all(t.device.type == "cpu" for t in read) \
                and all(t.device.type != "cpu" for t in outs + mutated):
            for c in {_storage(t) for t in mutated}:     # a host constant uploaded:
                self._gen[c] = self._gen.get(c, 0) + 1   # a source, as on the CPU
            return out
        site = caller_site()
        attrs = _attrs(name, func, args, kwargs, ins)
        prim = "host_callback" if attrs.pop("host_sync", False) else name
        if prim == "host_callback":
            attrs.update(op=name, callback=site)
        node = self.graph._add(prim, preds, site, **attrs)
        for c in {_storage(t) for t in mutated}:
            self._gen[c] = self._gen.get(c, 0) + 1
        self._produce(node, outs)
        for t in mutated:
            self._keep.append(t)
            self._producer.setdefault(self._key(t), (node.id, 0))
        return out


def _attrs(name: str, func, args, kwargs, ins) -> Dict[str, Any]:
    """The attributes the checkers read, from one aten call."""
    attrs: Dict[str, Any] = {}
    if name in _SYNC_OPS:
        attrs["host_sync"] = True
    elif name in ("index", "index_put", "index_put_", "_index_put_impl_") and len(args) > 1:
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1]):
            attrs["host_sync"] = True      # a boolean mask: nonzero inside
    if name == "sort":
        attrs["is_stable"] = bool(kwargs.get("stable") or False)
    self_t = args[0] if args and isinstance(args[0], torch.Tensor) else None
    is_float = self_t is not None and self_t.is_floating_point()
    if name in _ADD_OPS:
        attrs["accumulate"] = "sum"
    elif name in _REDUCE_OPS:
        reduce = args[4] if len(args) > 4 else kwargs.get("reduce")
        attrs["reduce"] = reduce
        if reduce in ("sum", "mean"):
            attrs["accumulate"] = reduce
    elif name in _PUT_OPS:
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if acc:
            attrs["accumulate"] = "sum"
    if "accumulate" in attrs:
        attrs["float_accumulate"] = is_float
    return attrs


def _opaque_wrapper(rec: Recorder, prim: str, fn: Callable, **attrs) -> Callable:
    def wrapper(*args, **kwargs):
        return rec.opaque(prim, fn, *args, attrs=attrs, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper


def _kernel_wrappers():
    """``(module, attribute, prim)`` of every public kernel wrapper the
    engine calls through its module (``fused_ops.fused_shuffle_reduce``)."""
    from repro_torch.kernels.coded_shuffle import ops as cs_ops
    from repro_torch.kernels.fused_shuffle_reduce import ops as fused_ops
    from repro_torch.kernels.histogram import ops as hist_ops
    from repro_torch.kernels.moe_dispatch import ops as md_ops
    from repro_torch.kernels.segment_reduce import ops as seg_ops
    from repro_torch.kernels.sketch_hist import ops as sk_ops
    from repro_torch.kernels.wave_timer import ops as wt_ops

    return [(fused_ops, "fused_shuffle_reduce", "fused_shuffle_reduce"),
            (cs_ops, "encode_packets", "encode_packets"),
            (cs_ops, "xor_words", "xor_words"),
            (hist_ops, "histogram", "histogram"),
            (sk_ops, "sketch_hist", "sketch_hist"),
            (seg_ops, "segment_reduce_sorted", "segment_reduce_sorted"),
            (md_ops, "dispatch_ranks", "dispatch_ranks"),
            (wt_ops, "read_ticks", "read_ticks")]


def stamp_hook(rec: Recorder) -> Callable:
    """The measured executor's ``stamp_through=`` hook, recorded as one
    ``stamp`` node with two output slots (0 the pass-through copy, 1 the
    tick words). A stamp taken on the host (CPU tensors) names its host
    body as its ``callback``, which the determinism checker holds to the
    allowlist."""
    from repro_torch.analysis import allowlist
    from repro_torch.kernels.wave_timer import ops as wt_ops
    from repro_torch.kernels.wave_timer import ref as wt_ref

    def hook(primary, *anchors, **kwargs):
        attrs = {"kernel": True}
        if wt_ops.backend(primary) == "host":
            attrs["callback"] = allowlist.qualname_of(wt_ref.stamp_through_ref)
        return rec.opaque("stamp", wt_ops.stamp_through, primary, *anchors, attrs=attrs,
                          **kwargs)

    return hook


# ---------------------------------------------------------------------------
# Collectives: the engine's own runners, recorded.
# ---------------------------------------------------------------------------


def _collectives():
    """``(module, attribute)`` of the functions the stacked runner moves data
    between slots with: the copy of a chunk and the coded exchanges'
    transposes (``_copy_chunk`` calls ``_transpose_slots``: one node)."""
    from repro_torch.core import mapreduce as mr

    return [(mr, "_copy_chunk"), (mr, "_transpose_slots")]


def tapped(rec: Recorder, body):
    """``body``, a phase-B generator, with its ``spill`` and ``pmax`` yields
    recorded as they pass to the runner: the handed-over buckets become the
    ``spill`` node's outputs, and the reply to a ``pmax`` the ``pmax`` node's,
    fed by the value sent."""
    reply = None
    while True:
        try:
            kind, arg = body.send(reply)
        except StopIteration as stop:
            return stop.value
        if kind == "spill":
            arg = rec.collective("spill", lambda s: s, arg)
        reply = yield kind, arg
        if kind == "pmax":
            reply = rec.collective("pmax", lambda x, r: r, arg, reply)


@contextlib.contextmanager
def one_slot(rec: Recorder, job, slot: int = 0):
    """Record slot ``slot``'s program of a sharded ``job`` as its own runner
    (``MapReduceJob._drive_sharded``) runs it: the other slots' programs, and
    the copies they receive, run unrecorded (their tensors are this
    program's sources, as the other shards' values are to one shard_map
    body); what slot ``slot`` receives is one ``all_to_all`` node."""
    on_slot = job._on_slot

    def on_slot_recorded(j: int):
        stack = on_slot(j)
        if j != slot:
            stack.enter_context(rec.suspended())
        return stack

    patches = {"_on_slot": on_slot_recorded}
    for name in ("_copy_to", "_exchange_to"):
        patches[name] = _opaque_wrapper(rec, "all_to_all", getattr(job, name), label=name)
    vars(job).update(patches)
    try:
        yield
    finally:
        for name in patches:
            delattr(job, name)
