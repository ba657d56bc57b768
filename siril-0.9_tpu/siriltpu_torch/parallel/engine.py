"""Generic sequence-processing engine: the functional analog of the
reference's one reusable "map over frames" machine.

Port of ``siriltpu.parallel.engine`` (host threads; the hooks decide
where the work runs), without ``relieve_map_pressure``, which exists only
for XLA:CPU, and without two faults of the JAX package's engine:

- a writer thread that died (its ``save_hook`` raised) while the queue
  was full made the next blocking ``put`` wait forever; here every put
  gives up as soon as the writer has stopped, and the writer's exception
  is raised;
- with a ``save_hook`` every output was also kept in the returned list
  until the run ended (an RGB frame of 6144 x 4096 is 144 MB); here an
  output handed to ``save_hook`` is not kept.

A read error in the prefetch thread is raised too (the JAX package's
thread swallowed it and the run ended early).

Reference: src/core/processing.c — ``generic_seq_args`` + hooks
(processing.h:7-65), ``generic_sequence_worker`` (:14-193): filtering
criterion → index mapping → per-frame read/hook/save → finalize;
cancellation via ``get_thread_run()`` polled in every loop (:91).

Here: frames stream through a chunked executor; the hooks do the chunk
work while a host thread reads the next chunk; cancellation is a callback
checked between frames. No shared globals, no locks — results are
returned, not appended under a mutex.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from siriltpu_torch.core.frame import Frame


class CancelledError(Exception):
    pass


@dataclass
class SequenceEngine:
    """Chunked map-over-frames with prefetch and cancellation."""

    chunk: int = 8
    cancel_check: Optional[Callable[[], bool]] = None
    progress: Optional[Callable[[int, int], None]] = None

    def _check(self):
        if self.cancel_check and self.cancel_check():
            raise CancelledError()

    def map_frames(self, seq, image_hook: Callable[[int, Frame], Any],
                   *, filter_fn: Optional[Callable[[int], bool]] = None,
                   save_hook: Optional[Callable[[int, Any], None]] = None,
                   async_save: bool = False,
                   stats: Optional[dict] = None) -> List[Any]:
        """generic_sequence_worker: apply image_hook to every selected
        frame, with one-chunk read-ahead on a host thread.

        Returns the outputs in frame order; with a ``save_hook`` each
        output goes to it instead and is not kept, and the list holds the
        indices of the frames mapped.

        ``async_save`` moves save_hook calls onto a single writer
        thread fed by a small bounded queue (FIFO — write order is
        preserved), so host write-back overlaps the next frames' compute —
        the reference's P5 loader/writer pattern (ser.c:671-683) at engine
        scope. A writer error is raised at the next put or at the end.
        ``stats`` (a dict) accumulates wall/read/compute/save seconds so
        callers can report the overlap (read_s + compute_s + save_s >
        wall_s when the threads actually ran concurrently)."""
        indices = [i for i in range(seq.number)
                   if (filter_fn(i) if filter_fn else seq.imgparam[i].incl)]
        results: List[Any] = []
        st = stats if stats is not None else {}
        st.setdefault("read_s", 0.0)
        st.setdefault("compute_s", 0.0)
        st.setdefault("save_s", 0.0)
        t_wall = time.perf_counter()

        def read_chunk(start):
            t0 = time.perf_counter()
            out = [(i, seq.read_frame(i))
                   for i in indices[start : start + self.chunk]]
            st["read_s"] += time.perf_counter() - t0
            return out

        writer_q: Optional[queue.Queue] = None
        writer_t: Optional[threading.Thread] = None
        writer_err: List[BaseException] = []
        if async_save and save_hook is not None:
            writer_q = queue.Queue(maxsize=max(2 * self.chunk, 4))

            def _writer():
                while True:
                    item = writer_q.get()
                    if item is None:
                        return
                    t0 = time.perf_counter()
                    try:
                        save_hook(*item)
                    except BaseException as e:  # re-raised by the main thread
                        writer_err.append(e)
                        return
                    finally:
                        st["save_s"] += time.perf_counter() - t0

            writer_t = threading.Thread(target=_writer, daemon=True)
            writer_t.start()

        def put(item):
            # a dead writer never drains a full queue: wait only while it
            # lives, and raise what stopped it
            while True:
                if writer_err:
                    raise writer_err[0]
                try:
                    writer_q.put(item, timeout=0.05)
                    return
                except queue.Full:
                    if not writer_t.is_alive() and not writer_err:
                        raise RuntimeError("the writer thread ended")

        try:
            with ThreadPoolExecutor(max_workers=1) as reader:
                pending = read_chunk(0)
                pos = 0
                while pending:
                    self._check()
                    # prefetch the next chunk while processing this one
                    nxt = reader.submit(read_chunk, pos + self.chunk)
                    for i, frame in pending:
                        self._check()
                        t0 = time.perf_counter()
                        out = image_hook(i, frame)
                        st["compute_s"] += time.perf_counter() - t0
                        if save_hook is None:
                            results.append(out)
                        elif writer_q is not None:
                            put((i, out))
                            results.append(i)
                        else:
                            t0 = time.perf_counter()
                            save_hook(i, out)
                            st["save_s"] += time.perf_counter() - t0
                            results.append(i)
                        del out
                        if self.progress:
                            self.progress(len(results), len(indices))
                    pos += self.chunk
                    pending = nxt.result()
        finally:
            if writer_t is not None:
                while writer_t.is_alive():
                    try:
                        writer_q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                writer_t.join()
        if writer_err:
            raise writer_err[0]
        st["wall_s"] = time.perf_counter() - t_wall
        return results


__all__ = ["SequenceEngine", "CancelledError"]
