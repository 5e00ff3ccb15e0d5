"""Structured logging and generation metrics (port of
fastdm_tpu/utils/logging.py): a namespaced logger and a GenerationStats
record of one generate call (step-skip counts come from the cache state)."""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

logger = logging.getLogger("fastdm_tpu_torch")
if not logger.handlers:
    h = logging.StreamHandler()
    h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s"))
    logger.addHandler(h)
    logger.setLevel(logging.INFO)


@dataclasses.dataclass
class GenerationStats:
    architecture: str = ""
    height: int = 0
    width: int = 0
    num_frames: int = 1
    num_inference_steps: int = 0
    steps_computed: Optional[int] = None   # from the cache state (None = no cache)
    steps_skipped: Optional[int] = None
    latency_s: float = 0.0
    compile_s: float = 0.0

    def log(self):
        skip = (f", skipped {self.steps_skipped}/{self.num_inference_steps} steps"
                if self.steps_skipped is not None else "")
        logger.info("%s %dx%d x%d steps=%d latency=%.2fs%s", self.architecture, self.height,
                    self.width, self.num_frames, self.num_inference_steps, self.latency_s, skip)


class Timer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.t0
