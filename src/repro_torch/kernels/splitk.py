"""What the split-K decode kernels of ``quant_matmul`` and ``lut_matmul``
share: the rows up to which they run, the grid they aim for, and how K is
cut into splits.  Their partial tiles meet in the fixed-order reduction of
``csrc/common.cuh``."""
from __future__ import annotations

DECODE_M = 16                    # rows up to which the split-K kernels run
SMS = 132                        # streaming multiprocessors of an H100 SXM
TARGET_BLOCKS = 2 * SMS          # split-K grid: two blocks per SM


def split_rows(rows: int, splits: int) -> list[tuple[int, int]]:
    """The packed-row range ``[lo, hi)`` of each split, as the kernels
    compute it: ``lo = s * rows // splits``."""
    return [(s * rows // splits, (s + 1) * rows // splits)
            for s in range(splits)]
