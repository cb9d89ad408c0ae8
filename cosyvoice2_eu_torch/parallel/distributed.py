"""Process group bring-up and the host-side guards of a training run.

Counterpart of ``cosyvoice2_eu_tpu/parallel/distributed.py`` (reference:
cosy_repo/cosyvoice/utils/train_utils.py:45-56 init_distributed,
:269-287 cosyvoice_join, bin/train.py:505).  The JAX package runs one
controller over every local device; the port runs one process per GPU under
``torchrun``, joined by ``torch.distributed``: NCCL on the card, gloo on the
CPU.  Collectives on tensors are ``all_reduce`` and ``broadcast`` only (the
two gloo runs on CUDA tensors too), and host values cross with
``broadcast_object_list``.  In one process (``WORLD_SIZE`` unset or 1) no
group is made and every collective here returns its input.
"""

from __future__ import annotations

import faulthandler
import logging
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

from cosyvoice2_eu_torch.utils.params import tree_leaves, tree_map


def is_distributed() -> bool:
    """True when this process belongs to a process group of more than one."""
    return in_group() and dist.get_world_size() > 1


def in_group() -> bool:
    """True when this process belongs to a process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if in_group():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def collective_device() -> torch.device:
    """Where a host value goes for a collective: this process's GPU under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(backend: str | None = None, device: str = "cuda") -> tuple[int, int]:
    """(rank, world size), from torchrun's ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.

    Above one process, or when ``backend`` is given, joins the process group
    (``env://``): ``backend``, else NCCL for ``device="cuda"`` and gloo for
    "cpu"; on CUDA it first makes ``cuda:LOCAL_RANK`` this process's device.
    A group that fails to form raises: nothing falls back to one process.
    In one process without a ``backend``, no group is made and the answer
    is (0, 1).  A group that already exists is kept.
    """
    if dist.is_initialized():
        return rank_and_world()
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if world == 1 and backend is None:
        logging.info("training process 0 / 1")
        return 0, 1
    if device != "cpu" and torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    logging.info("training process %d / %d (%s)", rank, world, backend)
    return rank, world


def host_barrier(name: str = "barrier") -> None:
    """A sync point of every process of the group."""
    if is_distributed():
        dist.barrier()


def broadcast_from_host0(tree):
    """Process 0's tree on every process (checkpoint resume): every tensor
    leaf is overwritten in place from rank 0 (a tree of the same structure,
    shapes and dtypes on every rank); other leaves come from rank 0's tree
    by ``broadcast_object_list``.  In one process, the tree as it is."""
    if not is_distributed():
        return tree
    box = [tree_map(lambda x: None if isinstance(x, torch.Tensor) else x, tree)]
    dist.broadcast_object_list(box, src=0)
    hosts = iter(tree_leaves(box[0]))

    def leaf(x):
        h = next(hosts)
        if isinstance(x, torch.Tensor):
            dist.broadcast(x, src=0)
            return x
        return h

    return tree_map(leaf, tree)


def _all_hosts_agree_continue(has_next: bool) -> bool:
    """True iff every process still has a batch: an all-reduce MIN of one int
    (on the CPU for gloo, on this process's GPU for NCCL)."""
    if not is_distributed():
        return has_next
    flag = torch.tensor([int(has_next)], dtype=torch.int32, device=collective_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item() == 1)


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
                    waited, self._step, *rank_and_world())
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
