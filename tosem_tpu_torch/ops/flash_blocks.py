"""Tile sizes of the flash kernel and the paged-decode page size.

The CUDA flash kernels have fixed tiles. The forward
(``csrc/flash_fwd.cu``) runs :data:`FLASH_BQ` query rows a block and
streams K/V in :data:`FLASH_BK`-key tiles through shared memory; both
backward kernels (``csrc/flash_bwd.cu``) keep :data:`FLASH_BQ_BWD` (dQ)
or :data:`FLASH_BK_BWD` (dK/dV) resident rows a block and stream the
other side in tiles of the same size. There is no VMEM budget and no
autotune cache on this card yet; :class:`BlockSizes` only names those
tiles, and :func:`select_block_sizes` returns them, so that a FLOP model
(``ops/kernel_suite.py``) counts the tiles the kernels really skip.

:func:`select_page_size` keeps the JAX package's page table, default
and clamp, so both packages pick the same page for a configuration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_SUBLANES = 8

FLASH_BQ = 64
FLASH_BK = 64
FLASH_BQ_BWD = 64   # flash_bwd.cu BR / BS: query rows of a dQ block
FLASH_BK_BWD = 64   # key rows of a dK/dV block


@dataclass(frozen=True)
class BlockSizes:
    """The kernels' tiles: ``bq`` query rows per forward block, ``bk``
    keys per streamed forward tile; ``bq_bwd``/``bk_bwd`` the query and
    key tiles of both backward kernels."""
    bq: int = FLASH_BQ
    bk: int = FLASH_BK
    bq_bwd: int = FLASH_BQ_BWD
    bk_bwd: int = FLASH_BK_BWD

    def as_list(self) -> List[int]:
        return [self.bq, self.bk, self.bq_bwd, self.bk_bwd]


def select_block_sizes(Tq: int, d: int, dtype: str,
                       Tk: Optional[int] = None, *,
                       mask_sig: Optional[str] = None,
                       backend: Optional[str] = None) -> BlockSizes:
    """The CUDA kernels' tiles for a (T, d, dtype) configuration. They
    are fixed, so every configuration gets the same tiles; a causal
    kernel skips the (64, 64) tile pairs past the diagonal whatever T
    is, and a mask program is compiled at these tiles. ``mask_sig`` and
    ``backend`` are the JAX package's keys of its sparse autotune cache;
    there is no such cache here yet, so they change nothing. Sets
    ``select_block_sizes.last_source`` to ``"fixed"``."""
    select_block_sizes.last_source = "fixed"
    return BlockSizes()


select_block_sizes.last_source = "fixed"


# (d, dtype) -> KV page size of the paged decode kernels (the JAX
# package's table: 128 tokens per page)
DECODE_PAGE_TABLE: Dict[Tuple[int, str], int] = {
    (64, "bfloat16"): 128,
    (64, "float32"): 128,
}

_DEFAULT_PAGE = 128


def select_page_size(d: int, dtype: str, *,
                     max_len: Optional[int] = None) -> int:
    """Page size for a (d, dtype) decode configuration: the table, else
    the default; then halved while it exceeds ``max_len``, floored at 8.
    Sets ``select_page_size.last_source``."""
    dtype = str(dtype).replace("torch.", "")
    hit = DECODE_PAGE_TABLE.get((d, dtype))
    picked, src = (int(hit), "table") if hit is not None \
        else (_DEFAULT_PAGE, "default")
    if max_len is not None:
        while picked > _SUBLANES and picked > max_len:
            picked //= 2
    select_page_size.last_source = src
    return max(picked, _SUBLANES)


select_page_size.last_source = "default"
