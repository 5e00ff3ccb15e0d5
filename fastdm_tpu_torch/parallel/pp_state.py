"""Process-wide pipeline-parallel state (port of fastdm_tpu/parallel/pp_state.py).

While an engine whose mesh has pp > 1 generates, the block runners
(models/flux.py flux_run_blocks, models/wan.py wan_run_blocks,
models/qwenimage.py qwen_run_blocks) run their stacks through the GPipe
schedule (pipeline.gpipe_run_blocks) over the pipeline set here: a
GroupPipeline over the mesh's pp (and dp) process groups, or a
VirtualPipeline of pp stages run in this process. The engine sets it only
for the duration of its own generate() and restores the previous one.
"""

from __future__ import annotations

import contextlib

_pipe = None


def set_pp_pipeline(pipe) -> None:
    """Activate (or with None, deactivate) pipeline-parallel block runs."""
    global _pipe
    _pipe = pipe


def get_pp_pipeline():
    return _pipe


@contextlib.contextmanager
def pp_pipeline(pipe):
    """The pipeline active inside the block, the previous one restored after."""
    prev = get_pp_pipeline()
    set_pp_pipeline(pipe)
    try:
        yield pipe
    finally:
        set_pp_pipeline(prev)
