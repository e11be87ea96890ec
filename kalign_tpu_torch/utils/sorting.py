"""glibc-compatible merge sort.

The reference engine's tie-breaking behavior depends on glibc ``qsort``,
which (memory permitting) is a top-down merge sort where the merge step
takes from the left run iff ``cmp(left, right) <= 0``.  Several reference
comparators never return 0 (e.g. ``sort_by_len`` in
``lib/src/pick_anchor.c:74-84`` returns only -1/1), so the result for equal
keys is defined by this exact merge rule rather than by stability.

``glibc_msort`` reproduces that ordering so that anchor selection, task
ordering, and sequence sorting match the reference bit-for-bit.
"""

from typing import Callable, List, TypeVar

T = TypeVar("T")


def glibc_msort(items: List[T], cmp: Callable[[T, T], int]) -> List[T]:
    """Sort a list with glibc-msort semantics (top-down, n1 = n//2,
    merge takes left element iff cmp(left, right) <= 0)."""
    a = list(items)
    _msort(a, 0, len(a), cmp, [None] * len(a))
    return a


def _msort(a, lo, hi, cmp, tmp):
    n = hi - lo
    if n <= 1:
        return
    n1 = n // 2
    mid = lo + n1
    _msort(a, lo, mid, cmp, tmp)
    _msort(a, mid, hi, cmp, tmp)
    i, j, k = lo, mid, lo
    while i < mid and j < hi:
        if cmp(a[i], a[j]) <= 0:
            tmp[k] = a[i]
            i += 1
        else:
            tmp[k] = a[j]
            j += 1
        k += 1
    while i < mid:
        tmp[k] = a[i]
        i += 1
        k += 1
    while j < hi:
        tmp[k] = a[j]
        j += 1
        k += 1
    a[lo:hi] = tmp[lo:hi]
