"""The reference's ``lax.while_loop`` on the card: gated iterations in
blocks, each block a replayed CUDA graph.

:func:`_device_while` runs ``state = body(state)`` while ``cond(state)``
holds, as ``lax.while_loop(cond, body, state)`` does, with the predicate
and the loop counter on the device:

* A *gated iteration* computes ``run = cond(state, limit)`` on the device
  and returns ``where(run, body(state), state)`` field by field.  With
  ``run`` false the body's kernels still launch ("gated off") and
  ``torch.where`` keeps the old bits exactly, NaNs included: it is the
  iteration the while loop never runs.
* A *block* is ``block`` gated iterations in a row, then the predicate of
  the next one.  The host reads that predicate, with the count of
  iterations that ran, once a block: one round trip where a host loop
  makes ``block``.
* On a CUDA state each block is captured once into a
  ``torch.cuda.CUDAGraph`` and replayed.  The state, the problem data and
  the budget go into static buffers before the first replay; the state
  is read out after the last.  The first block of a new key runs eagerly
  on a side stream (the warm-up of PyTorch's capture recipe: it loads the
  kernel library and sets the kernels' attributes before any capture),
  and the graph is captured right after it.  A capture or replay that
  fails raises; there is no fallback to an eager loop.
* Graphs are kept in a bounded cache across calls (``GRAPH_CACHE_SIZE``,
  least recently used dropped first), keyed by the caller's key, the
  block length and the shapes, dtypes and strides of every tensor, and
  share one memory pool.  No two replay at once, so the graphs over one
  state spec share one set of static state buffers, and those over one
  data spec one set of static data buffers: a call holds one copy of its
  problem on the card besides its own, whatever number of phases it
  runs, and keeps it while a graph over it is cached.  The data is copied
  in only when it is not the very tensors, unmodified, copied last; the
  caller's tensors are held by weak reference, never kept alive.
* On the CPU the same block runs eagerly, line for line the code that the
  card captures.

A graph replays the launches it captured.  Whatever decides them must be
in the key (the kernel set and the options are, in
:func:`pycllp_tpu_torch.solvers.hsd._run_phase`'s), not in module state
changed between calls: code that swaps a kernel wrapper for a run calls
:func:`_clear_graphs` before and after it.

The launch counters (``*_LAUNCHES`` of :mod:`pycllp_tpu_torch.ops.batchlast`
and :mod:`pycllp_tpu_torch.ops.df64`) are added to by Python at the call
that issues a launch, so at capture only: the capture's increments are
taken back, and every replay adds them again, so a counter counts the
launches that ran.
"""

from __future__ import annotations

import collections
import weakref

import torch

# gated iterations a block where the lanes share A: chosen on the card from
# {2, 3, 4, 6} by the main cell's wall and its gated-off share (PERF.md §6);
# the narrow cap of 12 and tier 1's budget of 3 are whole blocks
BLOCK = 3
# ... and where each lane has its own A: one, a predicate read an iteration
# as on the host loop and nothing gated off.  Such a batch keeps the card
# busy, so a gated-off iteration costs what a running one does (netlib's
# padded batch, PERF.md §6)
BLOCK_PER_INSTANCE = 1
# captured graphs kept across calls (least recently used dropped first)
GRAPH_CACHE_SIZE = 32

# gated iterations that ran with their predicate false (their result discarded)
GATED_OFF_STEPS = 0
# predicate reads by the host: one a block here, one an iteration on the
# host loop of pycllp_tpu_torch.solvers.hsd._run_phase
HOST_SYNCS = 0
# graphs captured and blocks replayed
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0

_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_STATIC: dict = {}
_POOLS: dict = {}
_SIDE_STREAMS: dict = {}


def _flatten(tree) -> list:
    """The tensors of a tree of (named) tuples, lists, tensors and None."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _flatten(x)]
    return []


def _map(fn, tree):
    """The tree with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def _spec(tree):
    """A hashable description of a tree: its structure, and each tensor's
    shape, dtype, strides and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.stride(), str(tree.device))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_spec(x) for x in tree)
    return tree


def _counters() -> list:
    from pycllp_tpu_torch.ops import batchlast, df64

    return [(mod, name) for mod in (batchlast, df64) for name in vars(mod)
            if name.endswith("_LAUNCHES")]


def _gated(cond, body, s, limit, steps):
    """One gated iteration: ``where(run, body(s), s)``, and the count of
    iterations that ran advanced by ``run``."""
    run = cond(s, limit)
    new = body(s)
    out = type(s)(*[o if n is o else torch.where(run, n, o) for n, o in zip(new, s)])
    return out, steps + run


def _block(cond, body, s, limit, steps, block: int):
    """``block`` gated iterations, then the predicate of the next."""
    for _ in range(block):
        s, steps = _gated(cond, body, s, limit, steps)
    return s, steps, cond(s, limit)


def _flag(more, steps):
    return torch.stack((more.to(torch.int32), steps))


class _Static:
    """Static buffers for the trees of one spec, shared by the graphs over
    it (they replay one at a time, each after loading its own inputs)."""

    def __init__(self, tree):
        self.tree = _map(torch.empty_like, tree)
        self.sources: list = []

    def load(self, tree, *, always: bool) -> None:
        """Copy ``tree`` in; unless ``always``, only where the buffers do not
        hold the very tensors, unmodified, that were copied last."""
        srcs = _flatten(tree)
        if not always and len(srcs) == len(self.sources) and all(
                ref() is t and t._version == v for (ref, v), t in zip(self.sources, srcs)):
            return
        for dst, src in zip(_flatten(self.tree), srcs):
            dst.copy_(src)
        self.sources = [] if always else [(weakref.ref(t), t._version) for t in srcs]


def _static(kind: str, tree):
    """The static buffers of ``tree``'s spec, made on first use: (key, buffers)."""
    key = (kind, _spec(tree))
    if key not in _STATIC:
        _STATIC[key] = _Static(tree)
    return key, _STATIC[key]


class _Graph:
    """One captured block over static buffers: the state and the data (each
    shared with the other graphs of its spec), the budget, the count of
    iterations that ran and the flag the host reads."""

    def __init__(self, cond, make_body, state, data, limit, block: int):
        self.cond, self.block = cond, block
        self.state_key, self._state = _static("state", state)
        self.data_key, self._data = _static("data", data)
        self.limit = limit.clone()
        self.body = make_body(self._data.tree)
        dev = limit.device
        self.steps = torch.zeros((), dtype=torch.int32, device=dev)
        self.flag = torch.zeros(2, dtype=torch.int32, device=dev)
        self.graph = None
        self.deltas: list = []

    @property
    def state(self):
        return self._state.tree

    def run_block(self) -> None:
        """The block on the static buffers, written back into them: what
        the graph captures."""
        s, steps, more = _block(self.cond, self.body, self.state, self.limit, self.steps,
                                self.block)
        for dst, src in zip(self.state, s):
            if dst is not src:
                dst.copy_(src)
        self.steps.copy_(steps)
        self.flag.copy_(_flag(more, steps))

    def load(self, state, data, limit) -> None:
        self._state.load(state, always=True)
        self._data.load(data, always=False)
        self.limit.copy_(limit)
        self.steps.zero_()

    def warm_up(self) -> None:
        """The first block, eagerly on the side stream (real launches)."""
        side = _side_stream(self.limit.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.run_block()
        torch.cuda.current_stream().wait_stream(side)

    def capture(self) -> None:
        global GRAPH_CAPTURES
        counters = _counters()
        before = [getattr(ns, name) for ns, name in counters]
        side = _side_stream(self.limit.device)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.limit.device)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=_pool(self.limit.device))
            try:
                self.run_block()
            finally:
                graph.capture_end()
        # nothing ran: take the capture's counts back, keep them per replay
        self.deltas = []
        for (ns, name), b in zip(counters, before):
            d = getattr(ns, name) - b
            setattr(ns, name, b)
            if d:
                self.deltas.append((ns, name, d))
        self.graph = graph
        GRAPH_CAPTURES += 1

    def replay(self) -> None:
        global GRAPH_REPLAYS
        self.graph.replay()
        for ns, name, d in self.deltas:
            setattr(ns, name, getattr(ns, name) + d)
        GRAPH_REPLAYS += 1


def _pool(device):
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def _side_stream(device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _clear_graphs() -> None:
    """Drop every cached graph, with their buffers and their memory pool (a
    pool whose graphs are all gone takes no new capture: the next capture
    gets a new one)."""
    _GRAPHS.clear()
    _STATIC.clear()
    _POOLS.clear()


def _evict() -> None:
    """Keep ``GRAPH_CACHE_SIZE`` graphs, and the static buffers they use."""
    while len(_GRAPHS) > GRAPH_CACHE_SIZE:
        _GRAPHS.popitem(last=False)
    live = {k for g in _GRAPHS.values() for k in (g.state_key, g.data_key)}
    for key in [k for k in _STATIC if k not in live]:
        del _STATIC[key]


def _eager(cond, body, state, limit, block: int):
    steps = torch.zeros((), dtype=torch.int32, device=limit.device)
    blocks = 0
    while True:
        state, steps, more = _block(cond, body, state, limit, steps, block)
        blocks += 1
        more_h, steps_h = _flag(more, steps).tolist()
        if not more_h:
            return state, steps_h, blocks


def _replayed(cond, make_body, state, data, limit, block: int, key):
    full_key = (key, block, _spec(state), _spec(data), _spec(limit))
    entry = _GRAPHS.get(full_key)
    blocks = 0
    if entry is None:
        entry = _Graph(cond, make_body, state, data, limit, block)
        entry.load(state, data, limit)
        entry.warm_up()
        blocks = 1
        entry.capture()
        _GRAPHS[full_key] = entry
        _evict()
        more, steps = entry.flag.tolist()
    else:
        _GRAPHS.move_to_end(full_key)
        entry.load(state, data, limit)
        more = True
    while more:
        entry.replay()
        blocks += 1
        more, steps = entry.flag.tolist()
    return type(state)(*[t.clone() for t in entry.state]), steps, blocks


def _device_while(cond, make_body, state, data, limit, block: int, key=()):
    """``lax.while_loop(cond, body, state)`` in blocks of gated iterations.

    ``state`` is a flat named tuple of tensors; ``cond(state, limit)`` gives
    a 0-d bool tensor and ``make_body(data)`` the loop body, built over
    ``data`` (a tree of tensors: on the card, its static copy); ``limit``
    is a 0-d tensor the predicate reads (the budget), and ``block`` the
    gated iterations a block.  ``key`` names the body for the graph cache:
    everything, besides the shapes, that decides the kernels it launches.
    Returns ``(state, iterations run)``.
    """
    global GATED_OFF_STEPS, HOST_SYNCS
    if limit.device.type == "cuda":
        state, steps, blocks = _replayed(cond, make_body, state, data, limit, block, key)
    else:
        state, steps, blocks = _eager(cond, make_body(data), state, limit, block)
    HOST_SYNCS += blocks
    GATED_OFF_STEPS += blocks * block - steps
    return state, steps
