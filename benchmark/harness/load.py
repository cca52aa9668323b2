"""Offering load: an open loop of callers that start each request when it
is due, and a closed loop of clients that each wait for their answer
before sending the next."""

from __future__ import annotations

import faulthandler
import sys
import threading
import time

import numpy as np


def open_loop(due: list[float], work, n_threads: int, stop_at: float
              ) -> tuple[list[threading.Thread], list[float]]:
    """Run ``work(i)`` for each request ``i`` at perf_counter time
    ``due[i]`` (ascending), from ``n_threads`` caller threads, for every
    request due before ``stop_at``.  A request whose every caller is busy
    starts late.  Returns the threads (the caller joins them) and the
    list that collects each started request's lateness in seconds."""
    lock = threading.Lock()
    nxt = [0]
    late: list[float] = []

    def caller():
        while True:
            with lock:
                i = nxt[0]
                if i >= len(due) or due[i] >= stop_at:
                    return
                nxt[0] += 1
            wait = due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            with lock:
                late.append(max(0.0, time.perf_counter() - due[i]))
            work(i)

    threads = [threading.Thread(target=caller, daemon=True,
                                name=f"bench-caller-{k}")
               for k in range(n_threads)]
    for t in threads:
        t.start()
    return threads, late


def open_window(gaps, ramp_s: float, seconds: float, callers: int, work,
                on_open, on_close, items) -> tuple[float, float, bool]:
    """The open loop of a cell: ``items[i]`` is due ``gaps[:i + 1].sum()``
    seconds after the start (its ``due`` set to that perf_counter time);
    the window opens ``ramp_s`` later and lasts ``seconds``; requests due
    after it are not sent.  Waits for the callers (two minutes at most)
    and reports how late the generator ran.  Returns ``(t_open, t_close,
    ended)``."""
    t_base = time.perf_counter() + 0.05
    due = (t_base + np.cumsum(gaps)).tolist()
    for it, d in zip(items, due):
        it.due = d
    t_close = t_base + ramp_s + seconds
    threads, late = open_loop(due, work, callers, t_close)
    time.sleep(max(0.0, t_base + ramp_s - time.perf_counter()))
    t_open = time.perf_counter()
    on_open()
    time.sleep(max(0.0, t_close - time.perf_counter()))
    t_close = time.perf_counter()
    on_close()
    ended = join_all(threads, time.perf_counter() + 120)
    if late:
        lt = np.asarray(late)
        print(f"[window] generator lateness p50 "
              f"{np.percentile(lt, 50) * 1e3:.3f} ms, p99 "
              f"{np.percentile(lt, 99) * 1e3:.3f} ms, max "
              f"{lt.max() * 1e3:.3f} ms over {len(lt)} requests",
              file=sys.stderr)
    return t_open, t_close, ended


def closed_loop(client_jobs: list[list[int]], work, stop: threading.Event
                ) -> tuple[list[threading.Thread], list[float]]:
    """Start one client thread a list of request indices: each runs
    ``work(i)`` for its requests in turn until ``stop`` is set.  Returns
    the threads (the caller joins them) and the list that collects the
    perf_counter time at which each client that used up its list did
    so."""
    ran_out: list[float] = []

    def client(jobs):
        for i in jobs:
            if stop.is_set():
                return
            work(i)
        ran_out.append(time.perf_counter())

    threads = [threading.Thread(target=client, args=(jobs,), daemon=True,
                                name=f"bench-client-{k}")
               for k, jobs in enumerate(client_jobs)]
    for t in threads:
        t.start()
    return threads, ran_out


def join_all(threads, deadline: float) -> bool:
    """Join ``threads`` until perf_counter ``deadline``; True when every
    one has ended.  Otherwise every thread's stack goes to standard error,
    to show where the callers wait."""
    for t in threads:
        t.join(max(0.0, deadline - time.perf_counter()))
    alive = sum(t.is_alive() for t in threads)
    if alive:
        print(f"[load] {alive} of {len(threads)} callers still running at "
              f"the deadline; the stacks of every thread:", file=sys.stderr)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
    return not alive
