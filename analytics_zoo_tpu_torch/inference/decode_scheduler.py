"""Step-level continuous batching for autoregressive decode.

Counterpart of ``analytics_zoo_tpu/inference/decode_scheduler.py``. A
:class:`DecodeScheduler` holds the live sequences and advances them ONE
wide model step at a time: between steps it admits new generations (their
prefill chunked across steps), retires finished ones and returns to the
caller, so the serving engine interleaves other work at step granularity.

The decode feedback buffer lives in fixed-size seq-axis pages of one
shared :class:`PagedKVAllocator` pool, float32 or int8 with per-page
scales (``ZOO_KV_DTYPE``, inference/quantize.py). The wide step either
gathers each sequence's pages on the host (``step_fn``) or hands the pool,
the page tables and the lengths to a paged step (``paged_step_fn``, e.g.
``InferenceModel.paged_decode_step_fn``) that gathers them on the device
with the paged gather kernel (ops/paged_attention.py). The two give the
same bits.

Speculative decoding rides the same loop: a draft model proposes
``spec_k`` tokens, the target verifies them in one wide step, and greedy
output stays bitwise identical to step-by-step decode.

Correctness for interleaving: the decoder is causal in time and
row-independent across the batch, so which sequences share a step, the
rung it pads to and when the caller pauses are invisible bitwise. On the
card that holds when every product's row count is fixed: the scheduler
pads each wide step to its batch rung, so pin ``batch_ladder`` to one
rung where bitwise equality across loads matters.

The process-wide counts ride the telemetry registry under the JAX
package's names (``zoo_paged_attn_steps_total``,
``zoo_paged_attn_fallback_total``, ``zoo_spec_{proposed,accepted}_total``,
``zoo_spec_accept_ratio``, ``zoo_kv_page_zeros_skipped_total``,
``zoo_kv_quant_requants_total``, ``zoo_kv_pages_{in_use,free}``,
``zoo_kv_quant_pool_bytes``); each scheduler and allocator also keeps its
own (``paged_steps``, ``paged_fallbacks``, ``spec_proposed``,
``spec_accepted``; ``zeros_skipped``, ``requants``). A sequence carries
its lane and its cost (``device_s``, its share of every wide step's wall
time, and ``pages_held``), which the serving engine settles into the
``zoo_request_cost_*`` histograms. Without the autotuner (ROADMAP A9),
``paged="auto"`` takes the paged step wherever a paged step function was
given; ``tune_paged`` measures both routes but persists nothing.
"""

from __future__ import annotations

import statistics
from time import perf_counter
from typing import Callable, List, Optional, Sequence

import numpy as np

from analytics_zoo_tpu_torch.common import compile_ahead, telemetry
from analytics_zoo_tpu_torch.inference import generation, quantize


# metric handles are resolved from the live registry on every write: a
# handle taken at import would go stale when telemetry.reset_for_tests
# swaps the registry
def _m_pages_in_use():
    return telemetry.get_registry().gauge(
        "zoo_kv_pages_in_use",
        "KV pages currently allocated to live decode sequences out of "
        "the shared pool")


def _m_pages_free():
    return telemetry.get_registry().gauge(
        "zoo_kv_pages_free",
        "KV pages currently free in the shared pool — what admission "
        "control checks before accepting a new generate sequence")


def _m_spec_proposed():
    return telemetry.get_registry().counter(
        "zoo_spec_proposed_total",
        "Draft tokens proposed by the speculative-decode draft model")


def _m_spec_accepted():
    return telemetry.get_registry().counter(
        "zoo_spec_accepted_total",
        "Draft tokens accepted by the target model's greedy verification")


def _m_spec_ratio():
    return telemetry.get_registry().gauge(
        "zoo_spec_accept_ratio",
        "Running accepted/proposed ratio of speculative decode — 1.0 "
        "means every draft token survived verification")


def _m_paged_steps():
    return telemetry.get_registry().counter(
        "zoo_paged_attn_steps_total",
        "Wide decode steps dispatched through the paged seam — the page "
        "pool consumed on device via the scalar-prefetched page table "
        "instead of a host-side gather")


def _m_paged_fallback():
    return telemetry.get_registry().counter(
        "zoo_paged_attn_fallback_total",
        "Wide decode steps that took the host gather_into fallback on a "
        "paged-capable scheduler (paged off, no verdict yet, or the "
        "autotune verdict favored gather)")


def _m_zeros_skipped():
    return telemetry.get_registry().counter(
        "zoo_kv_page_zeros_skipped_total",
        "Recycled-page memsets skipped because the paged kernel's length "
        "masking makes stale positions unreadable")


def _m_kv_requants():
    return telemetry.get_registry().counter(
        "zoo_kv_quant_requants_total",
        "int8 KV page requantizations — a later append raised a page's "
        "running amax, so its existing rows were rescaled to the grown "
        "per-page scale")


def _m_kv_pool_bytes():
    return telemetry.get_registry().gauge(
        "zoo_kv_quant_pool_bytes",
        "Resident bytes of the shared KV page pool including per-page "
        "scales — ZOO_KV_DTYPE=int8 shows up here as a ~4x drop at a "
        "fixed page count")


def spec_totals() -> "tuple[int, int]":
    """Draft tokens proposed and accepted so far, over every scheduler
    (``zoo_spec_{proposed,accepted}_total``)."""
    return (int(_m_spec_proposed().value), int(_m_spec_accepted().value))


class PagePoolExhausted(RuntimeError):
    """The shared KV page pool cannot hold another sequence right now —
    admission should defer until a live sequence retires its pages."""


def default_pool_pages(max_batch: int, max_seq: int, spec_k: int = 4,
                       page_size: int = generation.DEFAULT_SEQ_RUNGS[0]
                       ) -> int:
    """Page count a scheduler's lazily-built allocator uses for this
    config: ``max_batch`` sequences of ``max_seq`` generated positions +
    the speculative draft window + one."""
    positions = max(1, int(max_seq) + max(0, int(spec_k)) + 1)
    per_seq = -(-positions // int(page_size))
    return max(1, int(max_batch)) * per_seq


class PagedKVAllocator:
    """Fixed-size seq-axis pages from one shared ``[n_pages, page_size,
    dim]`` pool. Sequences own disjoint page lists, so pages a finished
    generation returns back the next admission at once.

    ``kv_dtype`` (default from ``ZOO_KV_DTYPE``) may be ``int8``: pages
    then hold symmetric-quantized rows with one float32 scale per page
    beside the pool. ``dtype`` stays the logical float dtype readers see.

    Not thread-safe: an allocator belongs to the one scheduler (and so the
    one driving thread) that created it.
    """

    def __init__(self, n_pages: int, page_size: int, dim: int,
                 dtype=np.float32, kv_dtype=None, lazy_zero: bool = False,
                 sync_gauges: bool = True):
        if int(n_pages) < 1 or int(page_size) < 1:
            raise ValueError("need n_pages >= 1 and page_size >= 1")
        self.page_size = int(page_size)
        self.dim = int(dim)
        self.dtype = np.dtype(dtype)
        self.kv_dtype = quantize.resolve_kv_dtype(kv_dtype)
        self.quantized = self.kv_dtype == np.dtype(np.int8)
        self._pool = np.zeros((int(n_pages), self.page_size, self.dim),
                              self.kv_dtype if self.quantized
                              else self.dtype)
        # per-page symmetric scale + the running |x|max it derives from;
        # all-ones for float pools so pool_view keeps one signature
        self._scales = np.ones((int(n_pages),), np.float32)
        self._amax = np.zeros((int(n_pages),), np.float32)
        self._free: List[int] = list(range(int(n_pages)))[::-1]
        self.lazy_zero = bool(lazy_zero)
        self.zeros_skipped = 0
        self.requants = 0
        # the registry's pool gauges describe the live pool; a private
        # allocator (tune_paged's) keeps out of them
        self._gauges_on = bool(sync_gauges)
        self._sync_gauges()

    @classmethod
    def for_grid(cls, max_batch: int, max_positions: int, dim: int,
                 page_size: int = generation.DEFAULT_SEQ_RUNGS[0],
                 dtype=np.float32, kv_dtype=None) -> "PagedKVAllocator":
        """Pool sized for ``max_batch`` concurrent sequences of up to
        ``max_positions`` each."""
        per_seq = -(-max(1, int(max_positions)) // int(page_size))
        return cls(max(1, int(max_batch)) * per_seq, page_size, dim,
                   dtype, kv_dtype=kv_dtype)

    @classmethod
    def for_pool_bytes(cls, budget_bytes: int, page_size: int, dim: int,
                       dtype=np.float32, kv_dtype=None
                       ) -> "PagedKVAllocator":
        """Pool sized from a byte budget: int8 pages cost about 4x less
        than float32, so the same budget admits about 4x the sequences."""
        kv = quantize.resolve_kv_dtype(kv_dtype)
        per_page = int(page_size) * int(dim) * kv.itemsize
        if kv == np.dtype(np.int8):
            per_page += 8            # per-page scale + running amax
        n_pages = max(1, int(budget_bytes) // per_page)
        return cls(n_pages, page_size, dim, dtype, kv_dtype=kv)

    # ------------------------------------------------------------ sizing
    @property
    def n_pages(self) -> int:
        return int(self._pool.shape[0])

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return self.n_pages - self.n_free

    def pages_for(self, positions: int) -> int:
        """Pages needed to hold ``positions`` sequence positions."""
        return -(-max(0, int(positions)) // self.page_size)

    @property
    def page_nbytes(self) -> int:
        """Bytes one page pins in the pool (rows plus its scale and amax
        when quantized)."""
        per = int(self._pool[0].nbytes)
        if self.quantized:
            per += int(self._scales.itemsize + self._amax.itemsize)
        return per

    @property
    def pool_nbytes(self) -> int:
        return int(self._pool.nbytes + self._scales.nbytes
                   + self._amax.nbytes)

    def _sync_gauges(self):
        if not self._gauges_on:
            return
        _m_pages_in_use().set(self.n_in_use)
        _m_pages_free().set(self.n_free)
        _m_kv_pool_bytes().set(self.pool_nbytes)

    def _grow(self, extra: int):
        """Extend the pool: a single request larger than the whole pool
        must still be servable."""
        base = self.n_pages
        self._pool = np.concatenate(
            [self._pool,
             np.zeros((int(extra), self.page_size, self.dim),
                      self._pool.dtype)])
        self._scales = np.concatenate(
            [self._scales, np.ones((int(extra),), np.float32)])
        self._amax = np.concatenate(
            [self._amax, np.zeros((int(extra),), np.float32)])
        self._free.extend(range(base + int(extra) - 1, base - 1, -1))
        self._sync_gauges()

    # ------------------------------------------------------- alloc/free
    def alloc_pages(self, n: int) -> List[int]:
        """Take ``n`` pages from the pool. Raises
        :class:`PagePoolExhausted` when other live sequences hold too many
        pages (the caller defers admission); a single request bigger than
        the entire pool grows it instead."""
        n = int(n)
        if n > self.n_pages:
            self._grow(n - self.n_pages)
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} KV pages, {len(self._free)} free of "
                f"{self.n_pages} — waiting for a sequence to retire")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            # a recycled page's scale must not dequantize the new owner's
            # rows
            self._scales[p] = 1.0
            self._amax[p] = 0.0
        if self.lazy_zero:
            # the paged gather's length mask makes stale positions
            # unreadable, and the host gather copies only positions <
            # length into a zeroed buffer: the memset is pure overhead
            self.zeros_skipped += len(pages)
            _m_zeros_skipped().inc(len(pages))
        else:
            for p in pages:
                self._pool[p].fill(0)
        self._sync_gauges()
        return pages

    def free_pages(self, pages: Sequence[int]) -> None:
        """Return pages to the pool, reusable by the next admission."""
        self._free.extend(int(p) for p in pages)
        self._sync_gauges()

    # -------------------------------------------------------- row access
    def write_row(self, page: int, off: int, vec: np.ndarray) -> None:
        """Write one position in place. int8 pools quantize under the
        page's symmetric scale, growing it (and requantizing the page's
        rows) when this row raises the page's running |x|max."""
        if not self.quantized:
            self._pool[page, off, :] = vec
            return
        vec = np.asarray(vec, np.float32)
        amax = float(np.max(np.abs(vec))) if vec.size else 0.0
        if amax > self._amax[page]:
            new_scale = quantize.page_scale(amax)
            if self._amax[page] > 0.0:
                self._pool[page] = quantize.requantize_rows(
                    self._pool[page], self._scales[page], new_scale)
                self.requants += 1
                _m_kv_requants().inc()
            self._scales[page] = new_scale
            self._amax[page] = amax
        self._pool[page, off, :] = quantize.quantize_rows(
            vec, self._scales[page])

    def read_row(self, page: int, off: int) -> np.ndarray:
        """One position as the logical float dtype (dequantized)."""
        if self.quantized:
            return quantize.dequantize_rows(self._pool[page, off, :],
                                            self._scales[page])
        return self._pool[page, off, :].copy()

    def read_page(self, page: int, upto: int) -> np.ndarray:
        """The first ``upto`` rows of a page, dequantized with the paged
        kernel's ``q * scale``."""
        rows = self._pool[page, :upto, :]
        if self.quantized:
            return quantize.dequantize_rows(rows, self._scales[page])
        return rows

    def pool_view(self):
        """``(pool, scales)``: the backing arrays appends write in place,
        handed to the paged step whole. ``scales`` is all-ones for float
        pools."""
        return self._pool, self._scales


class PagedKVCache:
    """One sequence's decode feedback buffer, stored in allocator pages.
    ``gather_into`` materializes the live positions into one row of the
    wide step buffer (zeros past :attr:`length`).

    Not thread-safe: a cache is owned by the one sequence holding it.
    """

    def __init__(self, alloc: PagedKVAllocator, pages: Sequence[int]):
        self._alloc = alloc
        self._pages = list(pages)
        self.length = 0

    @property
    def capacity(self) -> int:
        return len(self._pages) * self._alloc.page_size

    @property
    def n_pages(self) -> int:
        return len(self._pages)

    def _slot(self, pos: int):
        page, off = divmod(int(pos), self._alloc.page_size)
        return self._pages[page], off

    def append(self, vec: np.ndarray) -> None:
        if self.length >= self.capacity:
            # growth beyond the admission reservation
            self._pages.extend(self._alloc.alloc_pages(1))
        p, off = self._slot(self.length)
        self._alloc.write_row(p, off, vec)
        self.length += 1

    def append_block(self, mat: np.ndarray) -> None:
        """Write a chunk of positions (chunked prefill)."""
        for row in np.asarray(mat, self._alloc.dtype):
            self.append(row)

    def set(self, pos: int, vec: np.ndarray) -> None:
        p, off = self._slot(pos)
        self._alloc.write_row(p, off, vec)

    def token_id(self, pos: int) -> int:
        p, off = self._slot(pos)
        # argmax over raw storage is argmax over the dequantized row: the
        # per-page scale is one positive scalar
        return int(np.argmax(self._alloc._pool[p, off, :]))

    def row(self, pos: int) -> np.ndarray:
        p, off = self._slot(pos)
        return self._alloc.read_row(p, off)

    def truncate(self, n: int) -> None:
        """Drop positions ``>= n`` (rejected speculative drafts), zeroing
        them so later gathers see the causal zero tail again."""
        n = max(0, int(n))
        for pos in range(n, self.length):
            p, off = self._slot(pos)
            self._alloc._pool[p, off, :] = 0
        self.length = min(self.length, n)

    def gather_into(self, dst: np.ndarray) -> None:
        """Copy live positions into ``dst`` (``[rung, dim]``, zeroed by the
        caller), dequantizing int8 pages as the paged kernel does."""
        ps = self._alloc.page_size
        pos = 0
        for page in self._pages:
            if pos >= self.length:
                break
            take = min(ps, self.length - pos)
            dst[pos:pos + take, :] = self._alloc.read_page(page, take)
            pos += take

    def page_table(self, width: int) -> np.ndarray:
        """This sequence's page-table row, padded to ``width`` entries with
        page 0, which the length mask keeps out of the result."""
        table = np.zeros((int(width),), np.int32)
        own = self._pages[:int(width)]
        table[:len(own)] = own
        return table

    def close(self) -> None:
        """Free every page back to the pool (idempotent)."""
        pages, self._pages = self._pages, []
        self.length = 0
        self._alloc.free_pages(pages)


class DecodeSequence:
    """One live generation: its encoder row, paged cache, decode params,
    per-sequence rng stream and generated output.
    Not thread-safe — owned by one scheduler."""

    __slots__ = ("enc", "cache", "prefill", "max_new_tokens", "mode",
                 "temperature", "rng", "gen", "generated", "tag", "lane",
                 "trace_uri", "_prefill_pos", "_drafts", "t_admit",
                 "device_s", "pages_held")

    def __init__(self, enc, prefill, max_new_tokens, mode, temperature,
                 seed, cache, tag, lane="default", trace_uri=None):
        self.enc = enc
        self.prefill = prefill                  # [S, dim] teacher-forced
        self.max_new_tokens = int(max_new_tokens)
        self.mode = mode
        self.temperature = float(temperature)
        self.rng = np.random.default_rng(seed) if mode == "sample" \
            else None
        self.cache = cache
        dim = int(prefill.shape[-1])
        self.gen = np.zeros((self.max_new_tokens, dim), np.float32)
        self.generated = 0
        self.tag = tag
        self.lane = lane
        self.trace_uri = trace_uri
        self._prefill_pos = 0
        self._drafts = 0
        self.t_admit = perf_counter()
        # cost attribution, settled by the serving engine when the
        # sequence finishes: device_s accumulates this sequence's share of
        # every wide step's wall time; pages_held is the cache's page high
        # water (taken just before close frees the pages)
        self.device_s = 0.0
        self.pages_held = int(cache.n_pages)

    @property
    def prefilled(self) -> bool:
        return self._prefill_pos >= self.prefill.shape[0]

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    @property
    def result(self) -> np.ndarray:
        return self.gen

    def _feed(self, row: np.ndarray) -> np.ndarray:
        """One step's raw prediction row -> the vector fed back, by
        generation.feedback_rows. The rng stream is per sequence, so
        sample output does not depend on which sequences share a step."""
        fed = generation.feedback_rows(row[None], self.mode,
                                       self.temperature, self.rng)[0]
        self.cache.append(fed)
        self.gen[self.generated, :] = fed
        self.generated += 1
        return fed


def _median_ms(fn: Callable[[], object], iters: int) -> float:
    fn()                                       # first touch outside timing
    times = []
    for _ in range(max(1, int(iters))):
        t0 = perf_counter()
        fn()
        times.append((perf_counter() - t0) * 1e3)
    return statistics.median(times)


class DecodeScheduler:
    """The persistent step-level decode loop.

    ``step_fn(enc, dec) -> [batch, t_dec, dim]`` is the full-sequence
    decoder (e.g. ``InferenceModel.decode_step_fn()``). ``draft_fn`` has
    the same signature on a draft model; with ``spec_k > 0`` greedy
    sequences decode speculatively and the rest take the one-token step.
    ``paged_step_fn(enc, pool, scales, table, lengths) -> [rung,
    width*page_size, dim]`` is the wide target step over the page pool
    (``InferenceModel.paged_decode_step_fn()``); with one given, ``paged``
    ``"force"`` and ``"auto"`` take it for every wide step and ``"off"``
    takes the host gather (counted in ``paged_fallbacks``).

    One ``step()`` advances chunked prefill, runs ONE wide target step per
    group of at most ``max_batch`` live sequences (padded to the batch and
    seq rungs), feeds each sequence at its own position and retires the
    finished ones.

    Not thread-safe: each scheduler is confined to its driving thread.
    """

    def __init__(self, step_fn: Callable, *,
                 max_batch: int = 8,
                 max_seq: int = generation.DEFAULT_SEQ_RUNGS[1],
                 page_size: int = generation.DEFAULT_SEQ_RUNGS[0],
                 batch_ladder: Optional[compile_ahead.BucketLadder] = None,
                 allocator: Optional[PagedKVAllocator] = None,
                 draft_fn: Optional[Callable] = None, spec_k: int = 4,
                 prefill_chunk: int = 32,
                 paged_step_fn: Optional[Callable] = None,
                 paged: str = "auto"):
        if paged not in ("auto", "force", "off"):
            raise ValueError(
                f"paged must be auto|force|off, got {paged!r}")
        self._step_fn = step_fn
        self._paged_step_fn = paged_step_fn
        self._paged = paged
        self._draft_fn = draft_fn
        self.spec_k = max(0, int(spec_k))
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_batch = max(1, int(max_batch))
        self.max_seq = max(2, int(max_seq))
        self.page_size = max(1, int(page_size))
        self._batch_ladder = batch_ladder or compile_ahead.BucketLadder(
            1, self.max_batch)
        self._seq_ladder = generation.seq_ladder(
            self.max_seq + self.spec_k + 1, min_rung=self.page_size)
        self._alloc = allocator
        self._prefilling: List[DecodeSequence] = []
        self._decoding: List[DecodeSequence] = []
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.paged_steps = 0
        self.paged_fallbacks = 0
        self.steps_run = 0

    # ---------------------------------------------------------- admission
    @property
    def allocator(self) -> Optional[PagedKVAllocator]:
        return self._alloc

    @property
    def live(self) -> int:
        """Sequences currently admitted (prefilling + decoding)."""
        return len(self._prefilling) + len(self._decoding)

    def admit(self, enc, start, max_new_tokens: int, *,
              mode: str = "greedy", temperature: float = 1.0,
              seed: Optional[int] = None, tag=None, lane: str = "default",
              trace_uri: Optional[str] = None) -> DecodeSequence:
        """Admit one generation: reserve its worst-case pages up front (a
        sequence the pool cannot hold right now raises
        :class:`PagePoolExhausted`) and queue its prefill, chunked across
        the next steps. ``lane`` is the record's priority lane (the
        engine's preemption reads it)."""
        if mode not in generation.MODES:
            raise ValueError(
                f"mode must be one of {generation.MODES}, got {mode!r}")
        steps = int(max_new_tokens)
        if steps < 1:
            raise ValueError("max_new_tokens must be >= 1")
        enc = np.asarray(enc)
        prefill = np.asarray(start, np.float32)
        if prefill.ndim == 1:
            prefill = prefill[None, :]
        if prefill.ndim != 2:
            raise ValueError("start must be [dim] or [prefill_len, dim]")
        if self._alloc is None:
            self._alloc = PagedKVAllocator(
                default_pool_pages(self.max_batch, self.max_seq,
                                   self.spec_k, self.page_size),
                self.page_size, int(prefill.shape[-1]))
        # worst case: prefill + every generated position + a transient
        # speculative draft window past the live length
        need = self._alloc.pages_for(
            prefill.shape[0] + steps + self.spec_k)
        pages = self._alloc.alloc_pages(need)
        try:
            seq = DecodeSequence(enc, prefill, steps, mode, temperature,
                                 seed, PagedKVCache(self._alloc, pages),
                                 tag, lane, trace_uri)
        except Exception:
            self._alloc.free_pages(pages)
            raise
        self._prefilling.append(seq)
        return seq

    def abort_all(self) -> List[DecodeSequence]:
        """Drop every live sequence and free its pages."""
        dropped = self._prefilling + self._decoding
        self._prefilling, self._decoding = [], []
        for seq in dropped:
            seq.cache.close()
        return dropped

    def live_state(self):
        """``(pool, scales, table, lengths)`` the next paged wide step of
        the (first ``max_batch``) decoding sequences gets: the pool, the
        page tables at the width of their seq rung and the live lengths,
        pad rows repeating the last sequence."""
        seqs = self._decoding[:self.max_batch]
        if not seqs:
            raise ValueError("no sequence is decoding")
        seq_rung = self._seq_ladder.rung_for(
            max(s.cache.length + 1 for s in seqs))
        return self._paged_inputs(seqs, seq_rung)[1:]

    # -------------------------------------------------------------- steps
    def _advance_prefill(self):
        """Chunked prefill: each step copies at most ``prefill_chunk``
        positions per sequence."""
        still = []
        for seq in self._prefilling:
            lo = seq._prefill_pos
            hi = min(lo + self.prefill_chunk, seq.prefill.shape[0])
            if hi > lo:
                seq.cache.append_block(seq.prefill[lo:hi])
                seq._prefill_pos = hi
            if seq.prefilled:
                self._decoding.append(seq)
            else:
                still.append(seq)
        self._prefilling = still

    def step(self) -> List[DecodeSequence]:
        """Advance every live sequence by one wide target step (greedy
        sequences by up to ``spec_k + 1`` tokens with a draft model).
        Returns the sequences that finished this step, their pages already
        back in the pool."""
        self._advance_prefill()
        if not self._decoding:
            return []
        finished: List[DecodeSequence] = []
        # one wide call per encoder shape
        groups = {}
        for seq in self._decoding:
            groups.setdefault(tuple(seq.enc.shape), []).append(seq)
        for seqs in groups.values():
            for lo in range(0, len(seqs), self.max_batch):
                finished.extend(self._step_group(
                    seqs[lo:lo + self.max_batch]))
        self._decoding = [s for s in self._decoding
                          if s not in finished]
        self.steps_run += 1
        return finished

    def drain(self) -> List[DecodeSequence]:
        """Step until no sequence is live."""
        out: List[DecodeSequence] = []
        while self.live:
            out.extend(self.step())
        return out

    def _batch_rung(self, n: int) -> int:
        rung = min(self._batch_ladder.rung_for(n), self.max_batch)
        return max(rung, n)

    def _materialize(self, seqs: List[DecodeSequence], seq_rung: int):
        """Stack encoder rows and gather paged caches into the wide
        ``[batch_rung, seq_rung, dim]`` step buffer; pad rows repeat the
        last sequence and their outputs are never read."""
        rung = self._batch_rung(len(seqs))
        enc = np.stack([s.enc for s in seqs])
        dec = np.zeros((len(seqs), seq_rung, self._alloc.dim),
                       self._alloc.dtype)
        for i, s in enumerate(seqs):
            s.cache.gather_into(dec[i])
        return compile_ahead.pad_to_rung((enc, dec), rung, site="decode")

    def _use_paged_step(self) -> bool:
        return self._paged_step_fn is not None and self._paged != "off"

    def _paged_inputs(self, seqs: List[DecodeSequence], seq_rung: int):
        """``(enc, pool, scales, table, lengths)`` of one paged wide step;
        pad rows repeat the last sequence's table and length."""
        rung = self._batch_rung(len(seqs))
        width = self._alloc.pages_for(seq_rung)
        (enc,) = compile_ahead.pad_to_rung(
            (np.stack([s.enc for s in seqs]),), rung, site="decode")
        table = np.stack([s.cache.page_table(width) for s in seqs])
        lengths = np.array([s.cache.length for s in seqs], np.int32)
        pad = rung - len(seqs)
        if pad:
            table = np.concatenate([table, np.repeat(table[-1:], pad, 0)])
            lengths = np.concatenate([lengths, np.repeat(lengths[-1:], pad)])
        pool, scales = self._alloc.pool_view()
        return enc, pool, scales, table, lengths

    def _paged_step(self, seqs: List[DecodeSequence],
                    seq_rung: int) -> np.ndarray:
        """The paged counterpart of ``_materialize`` + step: the gather
        runs on the device, driven by the page tables."""
        out = np.asarray(self._paged_step_fn(
            *self._paged_inputs(seqs, seq_rung)))
        # the length mask is live from here on: recycled pages stop paying
        # the memset (the host gather stays safe — it only copies
        # positions < length into a zeroed buffer)
        self._alloc.lazy_zero = True
        self.paged_steps += 1
        _m_paged_steps().inc()
        return out

    def tune_paged(self, batch_rung: Optional[int] = None,
                   seq_rung: Optional[int] = None, enc_shape=None,
                   iters: int = 5) -> Optional[dict]:
        """Time one wide step through the host gather and through the
        paged step, on SYNTHETIC state at one shape (a private allocator
        of the live pool's size, never the live pool): the median of
        ``iters`` host-clock runs of each. Returns ``{"kernel":
        "paged_step", "speedup", "use_kernel", "best_ms",
        "reference_ms"}`` (``use_kernel``: the paged step was faster), or
        None without a paged step or an allocator. Nothing is persisted
        and ``paged="auto"`` does not read it (no autotuner yet). Shape
        arguments default to the live sequences'."""
        if self._paged_step_fn is None or self._alloc is None:
            return None
        live = self._prefilling + self._decoding
        if batch_rung is None:
            batch_rung = self._batch_rung(max(1, len(live)))
        if seq_rung is None:
            want = max((s.cache.length + 1 for s in live), default=2)
            seq_rung = self._seq_ladder.rung_for(want)
        if enc_shape is None:
            if not live:
                raise ValueError(
                    "enc_shape is required when no sequence is live")
            enc_shape = tuple(live[0].enc.shape)
        rung, seq_rung = int(batch_rung), int(seq_rung)
        rng = np.random.default_rng(0)
        alloc = PagedKVAllocator(self._alloc.n_pages, self.page_size,
                                 self._alloc.dim,
                                 kv_dtype=self._alloc.kv_dtype,
                                 sync_gauges=False)
        width = alloc.pages_for(seq_rung)
        fill = max(1, seq_rung - 1)
        caches = []
        for _ in range(rung):
            cache = PagedKVCache(alloc, alloc.alloc_pages(width))
            cache.append_block(rng.standard_normal(
                (fill, alloc.dim)).astype(np.float32))
            caches.append(cache)
        enc = rng.standard_normal(
            (rung,) + tuple(enc_shape)).astype(np.float32)
        table = np.stack([c.page_table(width) for c in caches])
        lengths = np.array([c.length for c in caches], np.int32)
        pool, scales = alloc.pool_view()

        def gather():
            dec = np.zeros((rung, seq_rung, alloc.dim), np.float32)
            for i, c in enumerate(caches):
                c.gather_into(dec[i])
            return np.asarray(self._step_fn(enc, dec))

        def paged():
            return np.asarray(
                self._paged_step_fn(enc, pool, scales, table, lengths))

        ref_ms = _median_ms(gather, iters)
        paged_ms = _median_ms(paged, iters)
        return {"kernel": "paged_step", "batch_rung": rung,
                "seq_rung": seq_rung, "best_ms": paged_ms,
                "reference_ms": ref_ms, "speedup": ref_ms / paged_ms,
                "use_kernel": paged_ms < ref_ms}

    def _step_group(self, seqs: List[DecodeSequence]
                    ) -> List[DecodeSequence]:
        t0 = perf_counter()
        spec = [s for s in seqs
                if self._draft_fn is not None and self.spec_k > 0
                and s.mode == "greedy"]
        if spec:
            self._propose(spec)
        seq_rung = self._seq_ladder.rung_for(
            max(s.cache.length + 1 for s in seqs))
        if self._use_paged_step():
            # bitwise the gather path: the on-device gather materializes
            # the identical (dequantized, causally zero-tailed) buffer
            out = self._paged_step(seqs, seq_rung)
        else:
            enc, dec = self._materialize(seqs, seq_rung)
            out = np.asarray(self._step_fn(enc, dec))
            if self._paged_step_fn is not None:
                self.paged_fallbacks += 1
                _m_paged_fallback().inc()
        finished = []
        for i, s in enumerate(seqs):
            before = s.generated
            if s._drafts:
                self._verify(s, out[i])
            else:
                s._feed(out[i, s.cache.length - 1, :])
            generation.count_decode_steps(s.generated - before)
            if s.done:
                s.pages_held = max(s.pages_held, s.cache.n_pages)
                s.cache.close()
                finished.append(s)
        # bill every participant an equal share of the wide step's wall
        # time (the engine's zoo_request_cost_device_seconds)
        share = (perf_counter() - t0) / max(1, len(seqs))
        for s in seqs:
            s.device_s += share
        return finished

    # ------------------------------------------------- speculative decode
    @property
    def spec_accept_ratio(self) -> float:
        if self.spec_proposed == 0:
            return 0.0
        return self.spec_accepted / self.spec_proposed

    def _propose(self, seqs: List[DecodeSequence]):
        """Draft phase: the draft model proposes up to ``spec_k`` greedy
        tokens per sequence, written past the live length (rejected ones
        are truncated back to zeros)."""
        want = {s: min(self.spec_k, s.max_new_tokens - s.generated)
                for s in seqs}
        for j in range(max(want.values())):
            live = [s for s in seqs if want[s] > j]
            if not live:
                break
            seq_rung = self._seq_ladder.rung_for(
                max(s.cache.length + 1 for s in live))
            enc, dec = self._materialize(live, seq_rung)
            out = np.asarray(self._draft_fn(enc, dec))
            for i, s in enumerate(live):
                row = out[i, s.cache.length - 1, :]
                fed = generation.feedback_rows(row[None], "greedy",
                                               1.0, None)[0]
                s.cache.append(fed)
                s._drafts += 1

    def _verify(self, s: DecodeSequence, out_row: np.ndarray):
        """Acceptance: take drafts while they match the target's greedy
        argmax at each position, then the target's own token at the first
        mismatch; all drafts accepted earns the bonus token the wide step
        already computed. Accepted tokens are bitwise the step-by-step
        greedy tokens, by causality."""
        k = s._drafts
        t0 = s.cache.length - k                # live length before drafts
        accepted = 0
        mismatched = False
        for j in range(k):
            if s.done:
                break
            tgt = int(np.argmax(out_row[t0 + j - 1, :]))
            if tgt == s.cache.token_id(t0 + j):
                accepted += 1
                s.gen[s.generated, :] = s.cache.row(t0 + j)
                s.generated += 1
            else:
                fed = np.zeros(self._alloc.dim, np.float32)
                fed[tgt] = 1.0
                s.cache.truncate(t0 + j)       # drop this + later drafts
                s.cache.append(fed)            # target's own token instead
                s.gen[s.generated, :] = fed
                s.generated += 1
                mismatched = True
                break
        if not mismatched:
            s.cache.truncate(t0 + accepted)    # drop unconsumed drafts
            if accepted == k and not s.done:
                s._feed(out_row[t0 + k - 1, :])
        self.spec_proposed += k
        self.spec_accepted += accepted
        s._drafts = 0
        _m_spec_proposed().inc(k)
        _m_spec_accepted().inc(accepted)
        proposed, accepted_all = spec_totals()
        if proposed:
            _m_spec_ratio().set(accepted_all / proposed)
