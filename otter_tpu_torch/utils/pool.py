"""Ordered per-thread-context work pool (the reference's BS_thread_pool
usage pattern: per-thread handles, work-stealing over an index counter,
deterministic ordered emission — genotype.cpp:71-78, wgat.cpp:148).

Unlike naked threading.Thread workers, exceptions (INCLUDING SystemExit,
which threading.excepthook silently swallows) are captured and re-raised
in the caller after join, so a failing item aborts the run loudly exactly
like the sequential path instead of silently truncating output."""

from __future__ import annotations

import threading
from typing import Callable, List, Optional


def ordered_thread_map(n_items: int, n_threads: int,
                       make_ctx: Callable[[], object],
                       run_item: Callable[[object, int], object],
                       close_ctx: Callable[[object], None]):
    """Run ``run_item(ctx, i)`` for i in 0..n_items-1 across n_threads
    workers, each with its own ``make_ctx()`` handle; returns the results
    in item order. The first worker exception is re-raised here."""
    results: List[Optional[object]] = [None] * n_items
    nxt = [0]
    lock = threading.Lock()
    errors: List[BaseException] = []

    def worker() -> None:
        try:
            ctx = make_ctx()
        except BaseException as e:  # noqa: BLE001 - re-raised in caller
            with lock:
                errors.append(e)
            return
        try:
            while True:
                with lock:
                    if errors:
                        return  # another worker failed: stop early
                    i = nxt[0]
                    if i >= n_items:
                        return
                    nxt[0] += 1
                results[i] = run_item(ctx, i)
        except BaseException as e:  # noqa: BLE001 - re-raised in caller
            with lock:
                errors.append(e)
        finally:
            close_ctx(ctx)

    threads = [threading.Thread(target=worker)
               for _ in range(max(1, min(n_threads, n_items)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results
