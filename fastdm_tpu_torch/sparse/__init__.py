"""Radial block-sparse attention tables (port of fastdm_tpu/sparse/)."""

from fastdm_tpu_torch.sparse.config import RadialAttnConfig, SparseConfig  # noqa: F401
from fastdm_tpu_torch.sparse.xsparse import RadialAttn, SparseAttn, radial_block_mask  # noqa: F401
