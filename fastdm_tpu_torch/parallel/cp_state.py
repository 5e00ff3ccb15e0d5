"""Process-wide context-parallel state (port of fastdm_tpu/parallel/cp_state.py).

While an engine whose mesh has sp > 1 generates, the kernel registry routes
dense sdpa to the ring backend (context_parallel.sdpa_ring) over the ring set
here: a GroupRing over the mesh's sp process group, or a VirtualRing of n
ranks run one after another in this process. Kept in its own tiny module so
that kernels/ and models/ need not import parallel/ at load.
"""

from __future__ import annotations

import contextlib

_ring = None


def set_cp_ring(ring) -> None:
    """Activate (or with None, deactivate) sequence-parallel attention."""
    global _ring
    if ring is not None:
        # registering the ring backend happens on import
        from fastdm_tpu_torch.parallel import context_parallel  # noqa: F401
    _ring = ring


def get_cp_ring():
    return _ring


@contextlib.contextmanager
def cp_ring(ring):
    """The ring active inside the block, the previous one restored after."""
    prev = get_cp_ring()
    set_cp_ring(ring)
    try:
        yield ring
    finally:
        set_cp_ring(prev)
