"""Radial block-sparse attention tables (port of fastdm_tpu/sparse/xsparse.py
and of mask_to_block_lists, fastdm_tpu/kernels/pallas/attention.py:1100-1118;
numpy on the host: the mask is static per video shape).

radial_block_mask builds the (ceil(S/bs), ceil(S/bs)) bool mask at the
config's block_size, bit for bit the JAX function: frame-pair windows halve
with log2 of the inter-frame distance (scaled by decay_factor), frames whose
window shrank below one block keep every split_factor-th diagonal, frame 0 is
an attention sink for wan, and a block is kept when more than 60% of its
non-zero columns have density above 1/3. RadialAttn packs it for the four
sparse modes of the Wan engine (FASTDM_SPARSE_GATHER):
  mask   -- block_mask: the (B, H, nq, nk) block mask of
            sparse_scaled_dot_product_attention;
  coarse -- block_lists: per-q-tile lists of coarse KV blocks
            (gather_sparse_attention);
  fine   -- block_lists_fine: CSR lists of native fine blocks
            (gather_fine_attention);
  super  -- block_lists_super: CSR lists of superblocks with bitmasks
            (gather_super_attention).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np

from fastdm_tpu_torch.sparse.config import RadialAttnConfig, SparseConfig


def _window_width(dist: int, token_per_frame: int, cfg: RadialAttnConfig) -> float:
    if cfg.model_type == "wan":
        if dist < 1:
            return token_per_frame
        if dist == 1:
            return token_per_frame // 2
    elif cfg.model_type == "hunyuan":
        if dist <= 1:
            return token_per_frame
    else:
        raise ValueError(f"unknown model type {cfg.model_type!r}")
    group = dist.bit_length()
    decay_length = 2 ** token_per_frame.bit_length() / 2**group * cfg.decay_factor
    return max(decay_length, cfg.block_size)


def _diagonal_split_keep(dist: int, token_per_frame: int, cfg: RadialAttnConfig) -> bool:
    group = dist.bit_length()
    decay_length = 2 ** token_per_frame.bit_length() / 2**group
    if decay_length >= cfg.block_size:
        return True
    split_factor = int(cfg.block_size / decay_length)
    return dist % split_factor == 0


def _shrink_mask_strict(mask: np.ndarray, block_size: int) -> np.ndarray:
    n = mask.shape[0] // block_size
    m = mask.shape[1] // block_size
    blocks = mask[: n * block_size, : m * block_size].reshape(n, block_size, m, block_size)
    col_density = blocks.sum(axis=1) / block_size  # (n, m, block_size)
    non_zero = (col_density > 0).sum(axis=-1)
    high = (col_density > 1 / 3).sum(axis=-1)
    return high / (non_zero + 1e-9) > 0.6


def radial_block_mask(video_token_num: int, num_frame: int, cfg: RadialAttnConfig,
                      total_tokens: Optional[int] = None) -> np.ndarray:
    """Static radial block mask, (ceil(S/bs), ceil(S/bs)) bool; rows and
    columns past the video tokens (text etc.) are dense."""
    bs = cfg.block_size
    s = total_tokens if total_tokens is not None else video_token_num
    nb = -(-s // bs)
    final = np.zeros((nb, nb), dtype=bool)
    tpf = video_token_num // num_frame
    border = video_token_num // bs
    final[border:, :] = True
    final[:, border:] = True

    offset = np.abs(np.arange(tpf)[None, :] - np.arange(tpf)[:, None])
    locals_: Dict[int, np.ndarray] = {}  # frame-pair pattern by distance (-1: the sink)
    for i in range(num_frame):
        for j in range(num_frame):
            key = -1 if j == 0 and cfg.model_type == "wan" else abs(i - j)
            if key not in locals_:
                if key < 0:  # attention sink
                    locals_[key] = np.ones((tpf, tpf), dtype=bool)
                elif _diagonal_split_keep(key, tpf, cfg):
                    locals_[key] = offset <= _window_width(key, tpf, cfg)
                else:
                    locals_[key] = np.zeros((tpf, tpf), dtype=bool)
            local = locals_[key]
            rem_r = (i * tpf) % bs
            rem_c = (j * tpf) % bs
            all_r = rem_r + (-(-tpf // bs)) * bs
            all_c = rem_c + (-(-tpf // bs)) * bs
            padded = np.zeros((all_r, all_c), dtype=bool)
            padded[rem_r : rem_r + tpf, rem_c : rem_c + tpf] = local
            block = _shrink_mask_strict(padded, bs)
            r0, c0 = (i * tpf) // bs, (j * tpf) // bs
            final[r0 : r0 + block.shape[0], c0 : c0 + block.shape[1]] |= block
    return final


def coarsen_block_mask(mask_2d, q_factor: int = 1, k_factor: int = 1) -> np.ndarray:
    """OR-coarsening of a 2D block mask (port of fastdm_tpu/kernels/pallas/
    attention.py:1049-1065): rows grouped by q_factor, columns by k_factor,
    zero-padded to a multiple first, so the result is a superset that never
    drops attention."""
    m = np.asarray(mask_2d, bool)
    if q_factor > 1 or k_factor > 1:
        nq, nk = m.shape
        pq, pk = (-nq) % q_factor, (-nk) % k_factor
        m = np.pad(m, ((0, pq), (0, pk)))
        m = m.reshape(m.shape[0] // q_factor, q_factor,
                      m.shape[1] // k_factor, k_factor).any(axis=(1, 3))
    return m


def super_tables_from_mask(m: np.ndarray, group: int, superblock: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a (nq, nfine) bool mask (q tiles x fine KV blocks) into the CSR
    superblock tables: (indices (T,) int32 superblock ids, valbits (T,) int32
    bitmask of active fine sub-blocks — bit j = fine block id*superblock + j —
    0 for padding slots, rows (nq, 2) int32 [start, count]). Each row's
    segment is padded to a multiple of `group` entries (at least one group)
    and lists its fully active superblocks first, in a stable order."""
    sb = superblock
    nq, nfine = m.shape
    nsuper = -(-nfine // sb)
    mp = np.zeros((nq, nsuper * sb), bool)
    mp[:, :nfine] = m
    weights = (1 << np.arange(sb)).astype(np.int32)
    bits_all = (1 << sb) - 1
    idx_segs, val_segs = [], []
    rows = np.zeros((nq, 2), np.int32)
    start = 0
    for r in range(nq):
        sub = mp[r].reshape(nsuper, sb)
        act = np.nonzero(sub.any(axis=1))[0].astype(np.int32)
        bits = (sub[act] * weights[None, :]).sum(axis=1).astype(np.int32)
        order = np.argsort(bits != bits_all, kind="stable")
        act, bits = act[order], bits[order]
        padded = -(-max(1, len(act)) // group) * group
        seg_i = np.zeros(padded, np.int32)
        seg_v = np.zeros(padded, np.int32)
        seg_i[: len(act)] = act
        seg_v[: len(act)] = bits
        rows[r] = (start, len(act))
        start += padded
        idx_segs.append(seg_i)
        val_segs.append(seg_v)
    return np.concatenate(idx_segs), np.concatenate(val_segs), rows


def mask_to_block_lists(mask_2d, q_factor: int = 1, k_factor: int = 1):
    """(nq, nk) bool block mask -> (indices (nq', max_nb) int32, counts (nq', 1)
    int32, max_nb): each row's active KV blocks in order, after OR-coarsening
    by (q_factor, k_factor); padding entries repeat index 0 and lie past the
    row's count, so they are never computed."""
    m = coarsen_block_mask(mask_2d, q_factor, k_factor)
    nq = m.shape[0]
    counts = m.sum(1).astype(np.int32)
    max_nb = max(1, int(counts.max()))
    idx = np.zeros((nq, max_nb), np.int32)
    for i in range(nq):
        active = np.nonzero(m[i])[0]
        idx[i, : len(active)] = active
    return idx, counts.reshape(nq, 1), max_nb


def fine_tables_from_mask(m: np.ndarray, group: int, fine: int, tokens: int
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack a (nq, nfine) bool mask (q tiles x fine KV blocks of `fine`
    tokens) into the CSR fine tables: (indices (T,) int32 fine block ids,
    valid (T,) int32 -- `fine`, or for the global last block the tokens of
    `tokens` it holds; 0 for padding slots -- rows (nq, 2) int32 [start,
    count]). Each row's segment is padded to a multiple of `group` entries
    (at least one group)."""
    nq, nfine = m.shape
    tail_id = nfine - 1
    tail_valid = tokens - tail_id * fine if tokens > tail_id * fine else fine
    idx_segs, val_segs = [], []
    rows = np.zeros((nq, 2), np.int32)
    start = 0
    for r in range(nq):
        active = np.nonzero(m[r])[0].astype(np.int32)
        padded = -(-max(1, len(active)) // group) * group
        seg_i = np.zeros(padded, np.int32)
        seg_v = np.zeros(padded, np.int32)
        seg_i[: len(active)] = active
        seg_v[: len(active)] = np.where(active == tail_id, min(tail_valid, fine), fine)
        rows[r] = (start, len(active))
        start += padded
        idx_segs.append(seg_i)
        val_segs.append(seg_v)
    return np.concatenate(idx_segs), np.concatenate(val_segs), rows


class SparseAttn:
    """Config-driven factory (SparseAttn.from_dict / from_json)."""

    _registry: Dict[str, Type["SparseAttn"]] = {}

    def __init__(self, config: SparseConfig):
        self.config = config
        self.video_token_num: Optional[int] = None
        self.num_frame: Optional[int] = None
        self._mask_cache: Dict[tuple, np.ndarray] = {}

    @classmethod
    def register(cls, name: str):
        def deco(sub):
            cls._registry[name.lower()] = sub
            return sub

        return deco

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SparseAttn":
        config = SparseConfig.from_dict(data)
        sub = cls._registry.get(config.sparse_algorithm.lower())
        if sub is None:
            raise ValueError(f"unknown sparse algorithm {config.sparse_algorithm!r}")
        return sub(config)

    @classmethod
    def from_json(cls, path: str) -> "SparseAttn":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def post_init(self, video_token_num: int, num_frame: int) -> None:
        self.video_token_num = video_token_num
        self.num_frame = num_frame


@SparseAttn.register("radial")
class RadialAttn(SparseAttn):
    def _mask2d(self) -> np.ndarray:
        key = (self.video_token_num, self.num_frame)
        if key not in self._mask_cache:
            self._mask_cache[key] = radial_block_mask(
                self.video_token_num, self.num_frame, self.config)
        return self._mask_cache[key]

    def block_mask(self, batch: int = 1, heads: int = 1,
                   block_tokens: Optional[int] = None) -> np.ndarray:
        """(batch, heads, nb, nb) int32 block mask at the consumer's tile size
        block_tokens (default: the config's block_size): a coarser tile ORs
        blocks together (a superset, never drops attention), a finer one
        repeats them."""
        m = self._mask2d()
        bs = self.config.block_size
        bt = bs if block_tokens is None else block_tokens
        if bt < 1:
            raise ValueError(f"block_tokens must be >= 1, got {bt}")
        if bt != bs:
            if bt % bs == 0:
                m = coarsen_block_mask(m, bt // bs, bt // bs)
            elif bs % bt == 0:
                f = bs // bt
                m = np.repeat(np.repeat(m, f, axis=0), f, axis=1)
            else:
                raise ValueError(f"block_tokens {bt} incompatible with mask block_size {bs}")
        m = m.astype(np.int32)
        return np.broadcast_to(m[None, None], (batch, heads, *m.shape)).copy()

    def block_lists(self, q_tokens: int = 512, k_tokens: int = 1024):
        """Per-q-tile lists of the active KV tiles of gather_sparse_attention,
        tiles of (q_tokens, k_tokens) tokens (multiples of block_size; the mask
        is OR-coarsened to them): (indices (nq, max_nb) int32, counts (nq, 1)
        int32)."""
        bs = self.config.block_size
        if q_tokens % bs or k_tokens % bs:
            raise ValueError(f"gather tile sizes ({q_tokens}, {k_tokens}) must be multiples of "
                             f"the radial mask block_size {bs}")
        idx, cnt, _ = mask_to_block_lists(self._mask2d(), q_tokens // bs, k_tokens // bs)
        return idx, cnt

    def block_lists_fine(self, q_tokens: int = 512, group: int = 8):
        """CSR tables of gather_fine_attention: the mask OR-coarsened to q tiles
        of q_tokens and kept at the native block_size along the keys. Returns
        (indices (T,) int32 fine block ids, valid (T,) int32 tokens of each
        entry -- block_size, the remainder for the global last block, 0 for
        padding slots -- and rows (nq, 2) int32 [start, count]); each row's
        segment is padded to a multiple of `group` entries (at least one
        group)."""
        bs = self.config.block_size
        if q_tokens % bs:
            raise ValueError(f"q_tokens {q_tokens} must be a multiple of the radial mask "
                             f"block_size {bs}")
        m = coarsen_block_mask(self._mask2d(), q_tokens // bs, 1)
        return fine_tables_from_mask(m, group, bs, self.video_token_num)

    def block_lists_super(self, q_tokens: int = 512, group: int = 8, superblock: int = 4):
        """Superblock gather tables for gather_super_attention: the radial mask
        OR-coarsened to q tiles of q_tokens (a multiple of block_size) and kept
        at the native block_size granularity along the keys, packed by
        super_tables_from_mask. Returns (indices, valbits, rows)."""
        bs = self.config.block_size
        if q_tokens % bs:
            raise ValueError(f"q_tokens {q_tokens} must be a multiple of the radial mask "
                             f"block_size {bs}")
        m = coarsen_block_mask(self._mask2d(), q_tokens // bs, 1)
        return super_tables_from_mask(m, group, superblock)
