"""Tile sizes of the flash kernel and the paged-decode page size.

The CUDA flash kernel (``csrc/flash_fwd.cu``) has fixed tiles: a block
of :data:`FLASH_BQ` threads owns one query row each and streams K/V in
:data:`FLASH_BK`-key tiles through shared memory. There is no VMEM
budget and no autotune cache on this card yet; :class:`BlockSizes` only
names those tiles so callers can read them.

:func:`select_page_size` keeps the JAX package's page table, default
and clamp, so both packages pick the same page for a configuration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

_SUBLANES = 8

FLASH_BQ = 64
FLASH_BK = 64


@dataclass(frozen=True)
class BlockSizes:
    """Forward-kernel tiles: ``bq`` query rows per block, ``bk`` keys per
    streamed tile."""
    bq: int = FLASH_BQ
    bk: int = FLASH_BK


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
