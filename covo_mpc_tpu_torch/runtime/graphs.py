"""CUDA graphs of the port's solves and control step: the units the JAX
package compiles with ``jax.jit``.

JAX traces each solve (``CoVOSolver.__call__``, ``act``, ``prepare``,
``MPPISolver.__call__``, ``PIDSolver.__call__``, ``RandomSolver.__call__``)
and the episode's control step into one XLA program each, with the solve's
key ``rng_act`` passed in as traced data. PyTorch runs eagerly, one launch a
device op; :func:`capture` records a callable's launches into one
``torch.cuda.CUDAGraph`` over static input buffers and replays it:

- the callable runs twice on the caller's stream first (cuBLAS / cuSOLVER
  handles, the kernel library, workspaces), then once under capture; the
  random streams it draws from (:meth:`BaseSolver.random_streams`, the
  env's step generator) are left as they were found, so the first replay
  draws what the first eager call would have drawn;
- every device generator among them is registered with the graph, so each
  replay advances it as an eager call would, and each seed stream's counter
  is a device tensor that the graph itself advances: every replay draws
  afresh, as JAX's traced keys do;
- a call copies the caller's tensors into the static buffers (a tensor
  passed again unchanged since the last call is not copied again), replays,
  and returns fresh copies of the outputs: a later call never overwrites an
  earlier result, as a jitted function returns fresh arrays;
- each captured kernel (``ops/kernels.py``) adds its launches to its count
  at every replay.

Non-tensor leaves (the solver params' floats, the env's int constants) are
part of the capture, as static arguments are part of a JAX trace: a call
with other values raises. Only CUDA tensors are taken: CPU tensors raise,
and so does any failure to capture. Nothing runs eagerly in its place.

:class:`Graphed` is the part of a solve that JAX jits inside an eager one:
a pure function (the reference Hessians, whose ``torch.func`` transforms
cost the host seconds a call eagerly) captured at its first call on card
tensors and replayed at every later one, while the rest of the solve runs
eagerly (CoVO's ``eigh`` reads the host, so its solve is not captured
whole).
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Sequence

import torch

from covo_mpc_tpu_torch.models.structs import tree_flatten as flatten
from covo_mpc_tpu_torch.models.structs import tree_unflatten as unflatten
from covo_mpc_tpu_torch.ops import kernels
from covo_mpc_tpu_torch.runtime import debug

WARMUP = 2  # eager calls on the caller's stream before the capture
# After a capture the H100 ran every graph replay ~11% slower (~43 ns an
# op) for 1.4-27.9 s in tools/clock_probe.py's runs; the clocks did not move.
# Timing that must read the settled speed starts SETTLE_S after it; where
# the caller gives a probe, settle() then watches it for the spell's end
# (a spell once outlasted SETTLE_S in a chip_smoke.py run).
SETTLE_S = 30.0
SETTLE_WATCH_S = 30.0  # how long settle() watches a probe that does not speed up
SETTLE_DROP = 1.05  # the spell ended: readings this much below the median before
PROBE_CHAIN = 16  # probe calls a reading (CUDA events around the chain)
PROBE_GAP_S = 0.25  # idle seconds between two readings
_last_capture = [float("-inf")]  # time.monotonic() at the end of the last one
_last_watch = [float("-inf")]  # time.monotonic() at the end of the last watch
last_readings: list = []  # the last watch's (seconds into it, ms a probe call)


def _probe_ms(probe: Callable) -> float:
    """Device ms a call of ``probe`` over a chain of PROBE_CHAIN calls."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(PROBE_CHAIN):
        probe()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / PROBE_CHAIN


def settle(seconds: float = SETTLE_S, probe: Callable = None,
           watch_s: float = SETTLE_WATCH_S) -> float:
    """Sleep until ``seconds`` have passed since this process's last
    capture (the slow spell above). Then, given ``probe`` (a call that
    enqueues the work to be timed, such as a replay) and a capture since
    the last watch, read its device ms every PROBE_GAP_S until three
    readings in a row lie SETTLE_DROP below the median of the five or more
    before them (the spell ended), or for ``watch_s`` (no reading fell: one speed
    throughout); the readings are kept in :data:`last_readings` (empty
    when nothing was watched). Returns the seconds slept and watched."""
    last_readings.clear()
    wait = _last_capture[0] + seconds - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    if probe is None or _last_watch[0] >= _last_capture[0]:
        return max(wait, 0.0)
    t0 = time.monotonic()
    while True:
        last_readings.append((time.monotonic() - t0, _probe_ms(probe)))
        ms = [r for _, r in last_readings]
        before = sorted(ms[:-3])  # its lower median: a spike up does not move it
        if (len(before) >= 5 and all(r * SETTLE_DROP < before[(len(before) - 1) // 2]
                                     for r in ms[-3:])
                or time.monotonic() - t0 >= watch_s):
            break
        time.sleep(PROBE_GAP_S)
    _last_watch[0] = time.monotonic()
    return max(wait, 0.0) + _last_watch[0] - t0


def copy_into(dst, src) -> None:
    """Copy every tensor of ``src`` into the tensor at its place in ``dst``
    (two trees of one spec), in place. A source that shares memory with
    another destination is cloned first, so the order of the copies does
    not matter; a source that is its destination is skipped."""
    d_leaves, d_spec = flatten(dst)
    s_leaves, s_spec = flatten(src)
    if d_spec != s_spec:
        raise ValueError("copy_into: the trees differ in structure, a constant, "
                         "a shape or a dtype")
    storages = {d.untyped_storage().data_ptr() for d in d_leaves}
    pairs = []
    for d, s in zip(d_leaves, s_leaves):
        if s.data_ptr() == d.data_ptr():
            continue
        if s.untyped_storage().data_ptr() in storages:
            s = s.clone()
        pairs.append((d, s))
    for d, s in pairs:
        d.copy_(s)


def _check_cuda(leaves: Sequence[torch.Tensor]) -> torch.device:
    devices = {t.device for t in leaves}
    if any(d.type != "cuda" for d in devices):
        raise ValueError("runtime.graphs captures CUDA tensors only, got "
                         f"{sorted(map(str, devices))} (a CPU caller runs eagerly)")
    if not torch.cuda.is_available():
        raise RuntimeError("runtime.graphs: no CUDA device")
    if len(devices) > 1:
        raise ValueError(f"runtime.graphs: tensors on several devices {sorted(map(str, devices))}")
    return devices.pop() if devices else torch.device("cuda", torch.cuda.current_device())


class CapturedCall:
    """``fn(*args)`` captured once as a CUDA graph (see the module
    docstring). ``args`` is the static input tree (the graph's buffers;
    ``fn`` may write into them, as the episode step writes its carry back),
    ``launches`` the kernel launches one replay makes."""

    def __init__(self, fn: Callable, args: tuple, streams: Sequence = ()):
        leaves, self._spec = flatten(args)
        device = _check_cuda(leaves)
        self.args = unflatten(self._spec, [t.clone() for t in leaves])
        self._leaves = flatten(self.args)[0]
        self._last: list = [None] * len(self._leaves)
        # the captured cudaGraph_t is kept beside its executable graph, so
        # its nodes can be read (``graph.raw_cuda_graph()``)
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        register = getattr(self.graph, "register_generator_state", None)
        generators = [s for s in streams if isinstance(s, torch.Generator)]
        if generators and register is None:
            raise RuntimeError("this torch has no CUDAGraph.register_generator_state: "
                               "a graph could not advance the solver's generators")
        if any(g.device.type != "cuda" for g in generators):
            raise ValueError("runtime.graphs: a generator that is not on the card")
        saved = [s.get_state() for s in streams]
        versions = [t._version for t in self._leaves]
        # the warm-up runs on the caller's stream: on a second stream its
        # eager work started the slow spell (SETTLE_S) at every capture
        for _ in range(WARMUP):
            fn(*self.args)
        for s, state in zip(streams, saved):
            s.set_state(state)
        for g in generators:
            register(g)
        with kernels.recording() as tally:
            with torch.cuda.graph(self.graph):
                out = fn(*self.args)
        self.graph.instantiate()
        for s, state in zip(streams, saved):
            s.set_state(state)
        self.launches = dict(tally)
        self._out_leaves, self._out_spec = flatten(out)
        # buffers fn writes into: a caller's unchanged tensor is copied
        # into them again at every call
        self._written = [t._version != v for t, v in zip(self._leaves, versions)]
        _last_capture[0] = time.monotonic()

    def replay(self) -> None:
        """Replay the graph on the static buffers as they stand."""
        self.graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n

    def load(self, *args) -> None:
        """Copy ``args`` (a tree of the captured spec) into the static
        buffers, skipping a tensor passed again unchanged (the same object,
        memory and version) since it was last copied into a buffer the
        graph does not write."""
        leaves, spec = flatten(args)
        if spec != self._spec:
            raise ValueError("captured call: arguments differ from the captured ones "
                             "in structure, a constant, a shape or a dtype")
        _check_cuda(leaves)
        for i, (dst, src) in enumerate(zip(self._leaves, leaves)):
            last = self._last[i]
            if (last is not None and not self._written[i] and last[0]() is src
                    and last[1] == src._version and last[2] == src.data_ptr()):
                continue
            dst.copy_(src)
            self._last[i] = (weakref.ref(src), src._version, src.data_ptr())

    def __call__(self, *args):
        self.load(*args)
        self.replay()
        return unflatten(self._out_spec, [t.clone() for t in self._out_leaves])


def capture(fn: Callable, *args, streams: Sequence = ()) -> CapturedCall:
    """Capture ``fn(*args)`` as a CUDA graph (:class:`CapturedCall`);
    ``streams`` are the device generators and seed streams it draws from."""
    return CapturedCall(fn, args, streams)


def capture_solver(method: Callable, solver, *args) -> CapturedCall:
    """Capture one of ``solver``'s solves (``solver`` itself, ``solver.act``
    or ``solver.prepare``) on example arguments, with every random stream
    the solver draws from (one left out would not advance, or the capture's
    warm-up would move it)."""
    return capture(method, *args, streams=solver.random_streams())


class Graphed:
    """``fn`` (pure: tensors in, tensors out, no random stream) as a CUDA
    graph when called on card tensors: captured at the first call with a
    spec of arguments (structure, constants, shapes, dtypes), replayed at
    every later call with it (fresh outputs each call). ``fn`` itself runs
    on CPU tensors, inside ``debug_mode()``, and while a stream is being
    captured (an enclosing capture records its ops as its own)."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self._captured: dict = {}

    def __call__(self, *args):
        leaves, spec = flatten(args)
        if (not leaves or leaves[0].device.type != "cuda" or debug.jit_disabled()
                or torch.cuda.is_current_stream_capturing()):
            return self.fn(*args)
        if spec not in self._captured:
            self._captured[spec] = capture(self.fn, *args)
        return self._captured[spec](*args)
