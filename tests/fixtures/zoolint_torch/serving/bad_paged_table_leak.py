"""Seeded kv-page-leak violation for the paged-attention table path.

One defect shape: pages allocated for a sequence's page table are
stranded when the admission guard raises before any callee receives
them. The clean shape below hands the pages to the table builder inside
the guard, which settles them. Never imported; fixture data for
chip_smoke.py's phase 26 and tests/test_torch_zoolint_dataflow.py.
"""


def build_table_guard_leak(pool, table_cls, seq, width, max_width):
    # VIOLATION kv-page-leak: the width guard raises with `pages` still
    # allocated — they never reach the table (which would settle them)
    # and never rejoin the pool's free list
    pages = pool.alloc_pages(width)
    if width > max_width:
        raise ValueError("sequence wider than the page-table rung")
    return table_cls(pool, pages, seq)


def build_table_clean(pool, table_cls, seq, width, max_width):
    """Negative control: guard first, allocate after — nothing to leak
    on the raise path, and the table receives the pages directly."""
    if width > max_width:
        raise ValueError("sequence wider than the page-table rung")
    return table_cls(pool, pool.alloc_pages(width), seq)
