"""The reference's ``jax.jit`` programs on the card: ``lax.while_loop`` as
gated iterations in blocks, each block a replayed CUDA graph, and the
straight-line code between the loops as replayed CUDA graphs too.

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

:func:`_segment` runs a straight-line call ``out = fn(state, data)`` (a
stage's code between two host reads) the same way: captured once a key
into a graph over static buffers, replayed after, eager on the CPU.  Its
inputs are copied in only where they are not the very tensors, unmodified,
copied last (a segment never writes its inputs), and its outputs are
copied out of the graph's output buffers, which the segments of one output
spec share.  A *borrowed* segment (``borrow=True``: a prologue whose
outputs, the problem data and the kernel sets' contexts, are large) keeps
output buffers of its own and returns them, not copies: they hold its
result until its next replay, and every replay marks them modified, so a
static copy made from them is made again.

A graph replays the launches it captured.  Whatever decides them must be
in the key (the kernel set and the options are, in
:func:`pycllp_tpu_torch.solvers.hsd._run_phase`'s), not in module state
changed between calls: code that swaps a kernel wrapper for a run calls
:func:`_clear_graphs` before and after it.

The launch counters (``*_LAUNCHES`` of :mod:`pycllp_tpu_torch.ops.batchlast`,
:mod:`pycllp_tpu_torch.ops.df64` and :mod:`pycllp_tpu_torch.ops.lanemv`, an
int or, for ``STREAM_LAUNCHES``, a ``collections.Counter`` of launch
shapes) and the Counter :data:`pycllp_tpu_torch.solvers.hsd.PREPARED_BYTES`
of prepared contexts are added to by Python at the call that issues a
launch or a prepare, so at capture only: the capture's increments are
taken back, and every replay adds them again, so a counter counts the
launches that ran.

The profiler marks (``torch.profiler.record_function`` ranges, recorded
only while a profiler runs, always in host code outside any captured
graph): ``predicate read`` (every host read), ``loop replay`` and
``segment replay`` (every replay), ``segment`` (the whole of a
:func:`_segment` call: key, lookup, loads, replay, copy out) and ``graph
capture`` (a new key's warm-up and capture).  ``CAPTURE_SECONDS`` adds up
the host seconds of the latter.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time
import weakref

import torch

# gated iterations a block where the lanes share A: chosen on the card from
# {2, 3, 4, 6} by the main cell's wall and its gated-off share (PERF.md §6);
# the narrow cap of 12 and tier 1's budget of 3 are whole blocks
BLOCK = 3
# ... and where each lane has its own A, or the shared A is past the
# lane-group factor (hsd._phase_block): one, a predicate read an iteration
# as on the host loop and nothing gated off.  Such a batch keeps the card
# busy, so a gated-off iteration costs what a running one does (netlib's
# padded batch, PERF.md §6)
BLOCK_PER_INSTANCE = 1
# captured graphs kept across calls (least recently used dropped first): a
# main-cell solve caches 19 a kernel set (5 loop blocks, 14 segments with
# the two prologues), config 5's sweep 47 with its ragged last window, one
# hsd_solve_batched at bench options 9 (3 loop blocks, 6 segments: a netlib
# bucket, the padded batch, a 16,384-lane chunk), dense_path 3; 128 holds
# the main path's three sets and the sweep together, so a second solve
# captures nothing
GRAPH_CACHE_SIZE = 128

# gated iterations that ran with their predicate false (their result discarded)
GATED_OFF_STEPS = 0
# predicate reads by the host: one a block here, one an iteration on the
# host loop of pycllp_tpu_torch.solvers.hsd._run_phase
HOST_SYNCS = 0
# graphs captured and replayed (the loops' blocks and the stages' segments)
GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0
# the stages' own predicate reads (the reference's lax.cond predicates and
# the drain rounds' loop predicate), and their straight-line segments run
STAGE_READS = 0
SEGMENT_CALLS = 0
# host seconds from the start of a new key's warm-up to the end of its
# capture (the capture synchronises the device before it begins), less a
# compile of the kernel library that the warm-up ran
CAPTURE_SECONDS = 0.0

_GRAPHS: collections.OrderedDict = collections.OrderedDict()
_STATIC: dict = {}
_POOLS: dict = {}
_SIDE_STREAMS: dict = {}


def _flatten(tree) -> list:
    """The tensors of a tree of (named) tuples, lists, dicts, tensors and None."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
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
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def _spec(tree):
    """A hashable description of a tree: its structure, and each tensor's
    shape, dtype, strides and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.stride(), str(tree.device))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_spec(x) for x in tree)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _spec(v)) for k, v in tree.items())
    return tree


def _spanned(name: str):
    """A decorator: each call of the function runs inside its own
    ``torch.profiler.record_function(name)`` range."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def _new_graph():
    """A new key's warm-up and capture: marked ``graph capture`` for the
    profiler, its host seconds added to ``CAPTURE_SECONDS``, less the
    compile of the kernel library where the warm-up's first launch ran it
    (a process's first graph in a checkout without the built library)."""
    global CAPTURE_SECONDS
    from pycllp_tpu_torch.ops import _build

    built = _build._INFO
    t0 = time.perf_counter()
    with torch.profiler.record_function("graph capture"):
        yield
    seconds = time.perf_counter() - t0
    if _build._INFO is not built:
        seconds -= _build._INFO.seconds
    CAPTURE_SECONDS += seconds


def _host_read(flag) -> list:
    """A predicate read by the host: the device tensor ``flag`` as a list
    (a scalar for a 0-d tensor), marked for the profiler."""
    with torch.profiler.record_function("predicate read"):
        return flag.tolist()


def _read(flag):
    """A stage's predicate read (the reference's ``lax.cond`` predicate, or
    a drain round's loop predicate): the 0-d ``flag`` as a Python scalar."""
    global STAGE_READS
    STAGE_READS += 1
    return _host_read(flag)


def _counters() -> list:
    from pycllp_tpu_torch.ops import batchlast, df64, lanemv
    from pycllp_tpu_torch.solvers import hsd

    return [(mod, name) for mod in (batchlast, df64, lanemv) for name in vars(mod)
            if name.endswith("_LAUNCHES")] + [(hsd, "PREPARED_BYTES")]


def _take_back(counters: list, before: list) -> list:
    """The counters' increments since ``before`` (their values then, a
    Counter copied), taken back: [(module, name, increment)], nonzero
    ones only.  A Counter is restored in place."""
    deltas = []
    for (ns, name), b in zip(counters, before):
        now = getattr(ns, name)
        if isinstance(now, collections.Counter):
            d = now - b
            now.clear()
            now.update(b)
        else:
            d = now - b
            setattr(ns, name, b)
        if d:
            deltas.append((ns, name, d))
    return deltas


def _add_back(deltas: list) -> None:
    """Each counter's increment of ``deltas`` added again (a replay's)."""
    for ns, name, d in deltas:
        now = getattr(ns, name)
        if isinstance(now, collections.Counter):
            now.update(d)
        else:
            setattr(ns, name, now + d)


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


def _static(kind, tree):
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

    @property
    def static_keys(self) -> tuple:
        return self.state_key, self.data_key

    def capture(self) -> None:
        self.graph, self.deltas = _capture(self.limit.device, self.run_block)

    def replay(self) -> None:
        _replay(self.graph, self.deltas, "loop replay")


def _capture(device, run):
    """``run`` captured into a new graph on the side stream, in the shared
    pool: (graph, the launch counts it adds a replay).  A capture that
    fails raises."""
    global GRAPH_CAPTURES
    counters = _counters()
    before = [collections.Counter(v) if isinstance(v, collections.Counter) else v
              for v in (getattr(ns, name) for ns, name in counters)]
    side = _side_stream(device)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize(device)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=_pool(device))
        try:
            run()
        finally:
            graph.capture_end()
    # nothing ran: take the capture's counts back, keep them per replay
    deltas = _take_back(counters, before)
    GRAPH_CAPTURES += 1
    return graph, deltas


def _replay(graph, deltas, what: str) -> None:
    global GRAPH_REPLAYS
    with torch.profiler.record_function(what):
        graph.replay()
    _add_back(deltas)
    GRAPH_REPLAYS += 1


class _Segment:
    """One captured straight-line call ``fn(state, data)`` over static
    buffers: each entry of the tuple ``state`` in the buffers of its
    position and spec, ``data`` in those of its spec (shared with the
    loops' graphs), and the output in those of its spec, shared by the
    segments whose output has it (each replay's output is copied out
    before any other replay), or, for a borrowed segment, in buffers of
    its own (``out_kind``), handed to the caller."""

    def __init__(self, fn, state: tuple, data, out_kind="out"):
        self.fn = fn
        self._ins = [_static(("in", i), t) for i, t in enumerate(state)]
        self.data_key, self._data = _static("data", data)
        self.out_kind = out_kind
        self.out_key = self._out = None
        self.graph = None
        self.deltas: list = []

    @property
    def static_keys(self) -> tuple:
        return tuple(k for k, _ in self._ins) + (self.data_key, self.out_key)

    def load(self, state: tuple, data) -> None:
        for (_, buf), t in zip(self._ins, state):
            buf.load(t, always=False)
        self._data.load(data, always=False)

    def call(self):
        """``fn`` on the static inputs."""
        return self.fn(tuple(buf.tree for _, buf in self._ins), self._data.tree)

    def run(self) -> None:
        """``fn`` on the static inputs, its output written into the output
        buffers: what the graph captures."""
        for dst, src in zip(_flatten(self._out.tree), _flatten(self.call())):
            dst.copy_(src)

    def warm_up(self, device) -> None:
        """``fn`` once, eagerly on the side stream (real launches), its
        output copied into the output buffers, made here to its spec."""
        side = _side_stream(device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = self.call()
        cur = torch.cuda.current_stream()
        cur.wait_stream(side)
        for t in _flatten(out):
            t.record_stream(cur)
        self.keep(out)

    def keep(self, out) -> None:
        """The output buffers, made to ``out``'s spec, with ``out`` copied in."""
        self.out_key, self._out = _static(self.out_kind, out)
        self._out.load(out, always=True)

    def capture(self, device) -> None:
        self.graph, self.deltas = _capture(device, self.run)

    def replay(self) -> None:
        _replay(self.graph, self.deltas, "segment replay")

    def result(self, borrow: bool):
        """A copy of the output buffers, the caller's to keep; with
        ``borrow`` the buffers themselves."""
        return self._out.tree if borrow else _map(torch.clone, self._out.tree)


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
    live = {k for g in _GRAPHS.values() for k in g.static_keys}
    for key in [k for k in _STATIC if k not in live]:
        del _STATIC[key]


def _eager(cond, body, state, limit, block: int):
    steps = torch.zeros((), dtype=torch.int32, device=limit.device)
    blocks = 0
    while True:
        state, steps, more = _block(cond, body, state, limit, steps, block)
        blocks += 1
        more_h, steps_h = _host_read(_flag(more, steps))
        if not more_h:
            return state, steps_h, blocks


def _replayed(cond, make_body, state, data, limit, block: int, key):
    full_key = (key, block, _spec(state), _spec(data), _spec(limit))
    entry = _GRAPHS.get(full_key)
    blocks = 0
    if entry is None:
        entry = _Graph(cond, make_body, state, data, limit, block)
        entry.load(state, data, limit)
        with _new_graph():
            entry.warm_up()
            entry.capture()
        blocks = 1
        _GRAPHS[full_key] = entry
        _evict()
        more, steps = _host_read(entry.flag)
    else:
        _GRAPHS.move_to_end(full_key)
        entry.load(state, data, limit)
        more = True
    while more:
        entry.replay()
        blocks += 1
        more, steps = _host_read(entry.flag)
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


def _captures(tree) -> bool:
    """Whether a segment over ``tree`` runs as a graph: its tensors are on
    a CUDA device."""
    ts = _flatten(tree)
    return bool(ts) and ts[0].device.type == "cuda"


@_spanned("segment")
def _segment(fn, state: tuple, data, key, eager: bool = False, borrow: bool = False):
    """``fn(state, data)``, a straight-line call that reads nothing back to
    the host (no ``bool``, ``int``, ``.item()``, ``nonzero`` or mask
    indexing), as one replayed CUDA graph.

    ``state`` is a tuple of trees of tensors (each entry in the static
    buffers of its position and spec, so that consecutive segments taking
    the same tensor at the same position copy it once) and ``data`` a tree
    (in the buffers of its spec, shared with the loops' graphs); ``key``
    names ``fn``: everything, besides the shapes, that decides its
    launches.  On a CUDA tensor the first call of a key runs ``fn`` eagerly
    on the side stream and captures it, later calls replay it; a capture
    or replay that fails raises.  The output is a copy, the caller's to
    keep; with ``borrow``, the segment's own output buffers, valid until
    its next call (for a result used within one solve).  On the CPU, or
    with ``eager``, ``fn`` runs eagerly on the caller's tensors.
    """
    global SEGMENT_CALLS
    SEGMENT_CALLS += 1
    if eager or not _captures((state, data)):
        return fn(state, data)
    full_key = ("segment", key, borrow, _spec(state), _spec(data))
    entry = _GRAPHS.get(full_key)
    if entry is None:
        dev = _flatten((state, data))[0].device
        entry = _Segment(fn, state, data, ("out", full_key) if borrow else "out")
        entry.load(state, data)
        with _new_graph():
            entry.warm_up(dev)
            entry.capture(dev)
        _GRAPHS[full_key] = entry
        _evict()
    else:
        _GRAPHS.move_to_end(full_key)
        entry.load(state, data)
        entry.replay()
        # the replay wrote the output buffers: a static copy made from a
        # borrowed one (its tensor, its version) is stale now
        for t in _flatten(entry._out.tree):
            torch.autograd.graph.increment_version(t)
    return entry.result(borrow)
