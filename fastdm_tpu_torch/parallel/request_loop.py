"""Rank 0's request loop for a front-end on a mesh (the API server and the
Gradio UI under `torchrun --nproc-per-node N ... --mesh-shape ...`).

JAX drives every device from one controller, so its server hands
--mesh-shape straight to the engine. torch.distributed runs one process a
device, and every process must call generate() with the same arguments. So
rank 0 takes the requests: it validates and decodes each one, then
LeadEngine.generate broadcasts the call's arguments (decoded images
included) over the world group before it runs its own generate; every
other rank waits in follow() for the next broadcast and runs the same
call. A request rank 0 refuses never reaches the broadcast. Shutdown is a
broadcast of None.

An error inside generate fails the run on every rank: a follower's error
leaves follow(), a leader's calls `fail` (by default it ends the process,
so that torchrun ends the others), since the ranks' collectives are then
out of step. Nothing is caught and skipped.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any, Callable, Dict

logger = logging.getLogger("fastdm_tpu_torch.serve")

# engine attributes a front-end sets before a call that every rank must share
SHARED_STATE = ("scheduler_name",)


def _broadcast(message: Any = None) -> Any:
    """Rank 0's message on every rank of the world group."""
    import torch.distributed as dist

    box = [message]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def on_mesh() -> bool:
    """Whether this process is one rank of several."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _end_process(exc: BaseException) -> None:
    logger.critical("generate failed on rank 0 (%s); ending the run", exc, exc_info=exc)
    os._exit(1)


class LeadEngine:
    """Rank 0's engine: generate(**params) broadcasts the call, then runs it
    (one call at a time); every other attribute is the engine's."""

    def __init__(self, engine, fail: Callable[[BaseException], None] = _end_process):
        object.__setattr__(self, "engine", engine)
        object.__setattr__(self, "fail", fail)
        object.__setattr__(self, "_lock", threading.Lock())

    def __getattr__(self, name: str):
        return getattr(self.engine, name)

    def __setattr__(self, name: str, value) -> None:
        setattr(self.engine, name, value)

    def generate(self, **params):
        with self._lock:
            state = {k: getattr(self.engine, k, None) for k in SHARED_STATE}
            _broadcast((state, params))
            try:
                return self.engine.generate(**params)
            except BaseException as e:
                self.fail(e)
                raise

    def shutdown(self) -> None:
        with self._lock:
            _broadcast(None)


def follow(engine) -> int:
    """A follower's loop: every broadcast call run on this rank's engine
    until the shutdown message -> the number of calls run."""
    n = 0
    while True:
        message = _broadcast()
        if message is None:
            return n
        state, params = message
        for k, v in state.items():
            setattr(engine, k, v)
        engine.generate(**params)
        n += 1


def serve(engine, front_end: Callable[[Any], None]) -> Dict[str, int]:
    """front_end(engine) on one process; on a mesh, front_end(LeadEngine)
    on rank 0, which broadcasts the shutdown when front_end returns, and
    follow(engine) on the other ranks. -> {"rank": r, "followed": n}."""
    if not on_mesh():
        front_end(engine)
        return {"rank": 0, "followed": 0}
    import torch.distributed as dist

    rank = dist.get_rank()
    if rank != 0:
        return {"rank": rank, "followed": follow(engine)}
    lead = LeadEngine(engine)
    try:
        front_end(lead)
    finally:
        lead.shutdown()
    return {"rank": 0, "followed": 0}
