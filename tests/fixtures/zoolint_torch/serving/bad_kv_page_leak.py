"""Seeded kv-page-leak violations.

Two shapes of the defect — an early return that strands an allocated
page list, and an unprotected handoff whose exception path leaks — with
clean admission/teardown shapes as the negative controls. Never
imported; fixture data for chip_smoke.py's phase 26 and
tests/test_torch_zoolint_dataflow.py.
"""


def admit_early_return_leak(pool, cache_cls, enc, need, budget):
    # VIOLATION kv-page-leak: the over-budget branch returns without
    # freeing `pages` — they never rejoin the pool's free list
    pages = pool.alloc_pages(need)
    if need > budget:
        return None
    return cache_cls(pool, pages)


def admit_exception_leak(pool, cache_cls, validate, enc, need):
    # VIOLATION kv-page-leak: `validate` raising between the alloc and
    # the handoff propagates out with `pages` still allocated
    pages = pool.alloc_pages(need)
    validate(enc)
    return cache_cls(pool, pages)


def admit_clean(pool, cache_cls, validate, enc, need):
    """Negative control: the handoff is guarded — any exception frees
    the pages before propagating (the scheduler's admission shape)."""
    pages = pool.alloc_pages(need)
    try:
        validate(enc)
        cache = cache_cls(pool, pages)
    except Exception:
        pool.free_pages(pages)
        raise
    return cache


def retire_clean(pool, seqs):
    """Negative control: both branches settle — short sequences free
    their pages directly, the rest hand theirs to the recycle bin."""
    recycled = []
    for seq in seqs:
        pages = pool.alloc_pages(seq.need)
        if seq.short:
            pool.free_pages(pages)
        else:
            recycled.append(pages)
    return recycled
