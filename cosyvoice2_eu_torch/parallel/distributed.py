"""Process group bring-up and the host-side guards of a training run.

Counterpart of the host-side half of ``cosyvoice2_eu_tpu/parallel/distributed.py``
(reference: cosy_repo/cosyvoice/utils/train_utils.py:45-56
init_distributed, :269-287 cosyvoice_join, bin/train.py:505): the rank and
world size from torchrun's environment, the uneven-input join and the
straggler watchdog.  The port trains in one process: data parallelism over
several (NCCL and the gradient reduction) is ROADMAP item 8g, and until
then a world size above 1 raises, since each process would train its own
diverging copy.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time


def init_distributed() -> tuple[int, int]:
    """(rank, world size) from torchrun's ``RANK`` and ``WORLD_SIZE`` (0 and 1
    when unset); raises ``NotImplementedError`` above one process."""
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: data-parallel training over several processes (NCCL and "
            "the gradient reduction) is not ported yet: ROADMAP item 8g")
    logging.info("training process %d / %d", rank, world)
    return rank, world


def host_barrier(name: str = "barrier") -> None:
    """A sync point of every process; one process has nothing to wait for."""


def broadcast_from_host0(tree):
    """Process 0's tree everywhere (checkpoint resume); one process has it."""
    return tree


def _all_hosts_agree_continue(has_next: bool) -> bool:
    """True iff every process still has a batch; in one process, its own answer."""
    return has_next


def join_uneven_inputs(batch_iter, agree_fn=None, tag: str = "train"):
    """An epoch's batches, ending for every process at the shortest shard:
    the processes agree before each step that each still has a batch (the
    reference's cosyvoice_join, executor.py:51), dropping at most a tail."""
    agree = agree_fn or _all_hosts_agree_continue
    it = iter(batch_iter)
    while True:
        try:
            batch = next(it)
            mine = True
        except StopIteration:
            batch, mine = None, False
        if not agree(mine):
            if mine:
                logging.warning(
                    "%s: uneven input shards — another host exhausted its data; dropping "
                    "this host's tail batch(es) to rejoin at the epoch boundary", tag)
            return
        yield batch


class StragglerGuard:
    """Watchdog of a hung process (a lost peer, a wedged collective): logs
    an error with every thread's stack when no step beat comes within
    ``timeout_s`` (``first_beat_grace_s`` before the first, which includes
    the kernels' build).  ``COSY_STRAGGLER_FATAL=1`` makes it end the
    process with code 42, for a supervisor to restart.

        with StragglerGuard(timeout_s=600, tag="llm-train") as guard:
            for batch in batches:
                ...
                guard.beat(step)
    """

    def __init__(self, timeout_s: float = 600.0, tag: str = "train",
                 first_beat_grace_s: float = 3600.0):
        self.timeout_s = timeout_s
        self.tag = tag
        self.grace = first_beat_grace_s
        self.beats = 0
        self._last = None
        self._step = None
        self._stop = None
        self._thread = None

    def beat(self, step: int | None = None):
        self._last = time.monotonic()
        self._step = step
        self.beats += 1

    def __enter__(self):
        self._stop = threading.Event()
        start = time.monotonic()

        def watch():
            while not self._stop.wait(min(self.timeout_s, 30.0) / 2):
                now = time.monotonic()
                if self._last is None:
                    if now - start < self.grace:
                        continue
                    waited = now - start
                else:
                    waited = now - self._last
                    if waited < self.timeout_s:
                        continue
                logging.error(
                    "%s: NO step progress for %.0f s (last step=%s, process %d/%d) — a peer "
                    "host is likely lost or a collective is wedged; dumping stacks", self.tag,
                    waited, self._step, int(os.environ.get("RANK", 0)),
                    int(os.environ.get("WORLD_SIZE", 1)))
                faulthandler.dump_traceback(file=sys.stderr)
                if os.environ.get("COSY_STRAGGLER_FATAL") == "1":
                    os._exit(42)
                self._last = time.monotonic()  # re-arm, keep logging

        self._thread = threading.Thread(target=watch, name="cosy-straggler-guard", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        return False
