"""Work-stealing parallel read pool for streamed scans (a copy of
clickhouse_tpu/storage/read_pool.py, which the port does not import).

The reference's dynamic read scheduling:

* `MergeTreeReadPool` (ref: src/Storages/MergeTree/MergeTreeReadPool.h:22):
  parts are split into tasks, reader threads pull tasks on demand so fast
  readers absorb slow ones' work.
* `ParallelReplicasReadingCoordinator` (ref: src/Storages/MergeTree/
  ParallelReplicasReadingCoordinator.cpp:219): a coordinator hands out
  disjoint ranges to replicas dynamically and reassigns the ranges of a
  replica that becomes unavailable.

Here the *task* is a chunk index of a `ChunkSource` and the *work* is host
chunk materialization (numpy part slicing, dictionary coding, null masks) —
the host-side cost that would otherwise serialize with device compute.  The
consumer drains chunks in any availability order; chunk-order independence
is guaranteed by the streaming engine's mergeable-state algebra (the same
property that lets the reference merge replicas' partial states in arrival
order).  The streamed program takes the chunks in index order
(iter_ordered) and copies them to the device after.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Set, Tuple

__all__ = ["ReadCoordinator", "ParallelChunkReader"]


class ReadCoordinator:
    """Hands out chunk tasks to named readers; reassigns on failure.

    Thread-safe.  A task is claimed by exactly one live reader; if that
    reader is marked unavailable before finishing, its in-flight tasks
    return to the queue (consistent with the reference coordinator's
    replica-failure reassignment semantics)."""

    def __init__(self, num_tasks: int):
        self._lock = threading.Lock()
        self._pending = list(range(num_tasks - 1, -1, -1))   # pop() = order
        self._in_flight: Dict[int, str] = {}                 # task -> reader
        self._done: Set[int] = set()
        self._dead: Set[str] = set()
        self.num_tasks = num_tasks

    def get_task(self, reader: str) -> Optional[int]:
        with self._lock:
            if reader in self._dead or not self._pending:
                return None
            t = self._pending.pop()
            self._in_flight[t] = reader
            return t

    def finish_task(self, reader: str, task: int) -> bool:
        """-> False if the task had been reassigned away from this reader
        (its result must be discarded to keep exactly-once accounting)."""
        with self._lock:
            if self._in_flight.get(task) != reader or task in self._done:
                return False
            del self._in_flight[task]
            self._done.add(task)
            return True

    def mark_unavailable(self, reader: str) -> int:
        """Requeue the reader's unfinished tasks; -> number requeued."""
        with self._lock:
            self._dead.add(reader)
            mine = [t for t, r in self._in_flight.items() if r == reader]
            for t in mine:
                del self._in_flight[t]
                self._pending.append(t)
            self._pending.sort(reverse=True)
            return len(mine)

    @property
    def all_done(self) -> bool:
        with self._lock:
            return len(self._done) == self.num_tasks


class ParallelChunkReader:
    """N reader threads pull chunk tasks from a ReadCoordinator, materialize
    host chunks, and feed a bounded queue; iteration yields
    (chunk_index, chunk_data, num_rows) in completion order."""

    def __init__(self, src, num_readers: int, max_buffered: int = 4):
        self.src = src
        self.coord = ReadCoordinator(src.num_chunks)
        self._out: "queue.Queue" = queue.Queue(maxsize=max(max_buffered, 1))
        self._threads = []
        self._failed: Optional[BaseException] = None
        n = max(1, min(num_readers, src.num_chunks))
        for r in range(n):
            t = threading.Thread(target=self._reader_loop,
                                 args=(f"replica-{r}",), daemon=True)
            t.start()
            self._threads.append(t)

    def _reader_loop(self, name: str) -> None:
        while True:
            task = self.coord.get_task(name)
            if task is None:
                return
            try:
                data, n = self.src.chunk(task)
            except BaseException as e:        # surfaced on the consumer
                self._failed = e
                self._out.put(None)
                return
            if self.coord.finish_task(name, task):
                self._out.put((task, data, n))

    def __iter__(self) -> Iterator[Tuple[int, dict, int]]:
        served = 0
        while served < self.coord.num_tasks:
            item = self._out.get()
            if item is None:
                raise self._failed            # reader thread error
            served += 1
            yield item

    def iter_ordered(self) -> Iterator[Tuple[int, dict, int]]:
        """Yield chunks in index order (reorder buffer over completion
        order) — keeps float-merge order deterministic while chunk prep
        still overlaps device compute.  Safe from deadlock because the
        output queue can hold every reader's in-flight chunk."""
        held: Dict[int, Tuple[dict, int]] = {}
        nxt = 0
        for i, data, n in self:
            held[i] = (data, n)
            while nxt in held:
                data_n = held.pop(nxt)
                yield nxt, data_n[0], data_n[1]
                nxt += 1
        while nxt in held:                    # drain (defensive)
            data_n = held.pop(nxt)
            yield nxt, data_n[0], data_n[1]
            nxt += 1
