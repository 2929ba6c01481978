"""The port's own copy of the page allocators against the JAX package's.

The same seeded sequence of allocate / allocate_extra / adopt / free
operations runs on ``aigw_tpu.tpuserve.kvcache`` and on
``aigw_tpu_torch.tpuserve.kvcache`` (no prefix cache attached here:
``tests/test_torch_prefix.py`` holds the allocators with their caches
against the reference's). After every
operation both hand out the same pages, refuse the same requests with
OutOfPagesError, and report the same free/used/occupancy telemetry.
"""

import numpy as np
import pytest

from aigw_tpu.tpuserve import kvcache as jkv
from aigw_tpu_torch.tpuserve import kvcache as tkv


def _state(alloc, seqs):
    return ([alloc.pages(s) for s in seqs], alloc.free_pages,
            alloc.used_pages, alloc.occupancy)


def _apply(alloc, op, err):
    try:
        return op(alloc)
    except err:
        return "out of pages"


@pytest.mark.parametrize("cls", ["PageAllocator", "RefcountedAllocator"])
@pytest.mark.parametrize("seed", [0, 1])
def test_allocator_matches_reference(cls, seed):
    rng = np.random.default_rng(seed)
    ref = getattr(jkv, cls)(num_pages=24, page_size=16)
    port = getattr(tkv, cls)(num_pages=24, page_size=16)
    seqs = list(range(8))
    for _ in range(200):
        s = int(rng.choice(seqs))
        kind = rng.integers(4 if cls == "RefcountedAllocator" else 2)
        if kind == 0:
            n = int(rng.integers(1, 100))
            op = lambda a, s=s, n=n: a.allocate(s, n)  # noqa: E731
        elif kind == 1:
            op = lambda a, s=s: a.free(s)  # noqa: E731
        elif kind == 2:
            n = int(rng.integers(0, 4))
            op = lambda a, s=s, n=n: a.allocate_extra(s, n)  # noqa: E731
        else:  # share another live sequence's pages
            src = int(rng.choice(seqs))
            op = lambda a, s=s, src=src: a.adopt(  # noqa: E731
                s, list(a.pages(src)))
        got = _apply(port, op, tkv.OutOfPagesError)
        want = _apply(ref, op, jkv.OutOfPagesError)
        assert got == want
        assert _state(port, seqs) == _state(ref, seqs)


def test_shared_pages_return_on_last_release():
    a = tkv.RefcountedAllocator(num_pages=4, page_size=8)
    pages = a.allocate(0, 16)
    a.adopt(1, pages)
    a.free(0)
    assert a.free_pages == 2  # still referenced by sequence 1
    a.free(1)
    assert a.free_pages == 4
    with pytest.raises(tkv.OutOfPagesError):
        a.allocate(2, 8 * 5)
