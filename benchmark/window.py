"""The measured window: the cell's captured step replayed for ``seconds``.

- a closed loop (``system.closed_loop``: a vehicle in the loop): each step
  replays the graph, copies the action to the host and synchronises; its
  wall time is taken by the host clock from before the launch to the
  action on the host.
- otherwise (a fleet): replays back to back. The host never waits for the
  device to drain: it keeps at most ``QUEUE`` replays in flight by waiting
  on the completion event of the replay ``QUEUE`` steps back, so the card
  always has the next replay queued (deeper queues read no faster). Each
  replay's device time comes from the CUDA events between replays, read
  once the window has closed.

The window is timed by the host clock and ends with a synchronise; a rate
is all the work of the window over all its time. A replay chosen for the
correctness check has its carry cloned before and after it (device copies,
in stream order).
"""

from __future__ import annotations

import time

import torch

QUEUE = 2  # a fleet's replays in flight


def run(system, seconds: float, check_at) -> dict:
    """Returns the steps, the window's wall seconds, each step's seconds
    (host wall for a closed loop, device events otherwise; a fleet's host
    seconds a launch beside) and the records of the checked replays."""
    check_at, closed_loop = set(check_at), system.closed_loop
    records, step_s, events, host_s = [], [], [], []
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    t_start = time.perf_counter()
    i = 0
    while True:
        pre = system.snapshot() if i in check_at else None
        if pre is not None and closed_loop:
            torch.cuda.current_stream().synchronize()
        if closed_loop:
            t0 = time.perf_counter()
            system.step()
            t1 = time.perf_counter()
            step_s.append(t1 - t0)
        else:
            if i >= QUEUE:
                events[i - QUEUE].synchronize()
            t0 = time.perf_counter()
            system.replay()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            t1 = time.perf_counter()
            host_s.append(t1 - t0)
        if pre is not None:
            records.append(system.record(pre))
        i += 1
        if t1 - t_start >= seconds:
            break
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t_start
    if not closed_loop:
        marks = [start, *events]
        step_s = [a.elapsed_time(b) * 1e-3 for a, b in zip(marks, marks[1:])]
    return dict(steps=i, window_s=window_s, step_s=step_s, host_s=host_s, records=records,
                missed=sorted(k for k in check_at if k >= i))


def catch_up(system, w: dict) -> None:
    """After the window: replays on to each checked replay that the window
    did not reach (one drawn past a short window) and records it."""
    i = w["steps"]
    for k in w["missed"]:
        for _ in range(k - i):
            system.step()
        pre = system.snapshot()
        system.step()
        w["records"].append(system.record(pre))
        i = k + 1
    torch.cuda.synchronize()
