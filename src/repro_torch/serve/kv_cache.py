"""Paged KV cache: device page pools viewed through a block-pool manager.

Every attention cache leaf is a batchless page pool ``(reps, num_pages,
page_size, ...)`` on the engine's device — GQA K/V ``(KV, hd)`` lines or
MLA latent ``(r,)`` and rope ``(dr,)`` lines — all layers addressed through
one per-slot block table.  A recurrent mixer's O(1) state (mamba h and
conv tail, mLSTM C / n / m and conv tail, sLSTM c / n / h / m) is a
per-slot row ``(reps, num_slots, ...)`` instead: zeroed when a slot is
allocated, written by a whole-prompt prefill, carried by swap with the
slot's pages (``_paged`` flags each leaf).  Physical page 0 is the trash
page idle slots write to, so the decode step's shapes never depend on
which slots are live.  Page accounting lives in :class:`BlockPool` (ref-counted pages,
content-hash prefix index); this class owns the tensors, maps slots to
pages and performs the device copies the pool's decisions require:
on-demand growth, copy-on-write, freezing into the prefix index, and
swap-out / swap-in through pinned host memory in one copy each way.
Quantized pools (``cfg.kv_dtype`` int8 / fp8_e4m3) add a float32
``{name}_scale`` leaf beside each code leaf; every page operation moves it
with the codes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import synchronize
from ..kernels import quantize as kvq
from ..models.common import ModelConfig
from ..models import transformer as tfm
from ..models.params import instantiate, torch_dtype, tree_leaves, tree_map
from .block_pool import BlockPool, chain_hash, token_chain_hashes
from .graphs import StaticInput


_PAGED_MIXERS = ("attn", "mla")
_RECURRENT_MIXERS = tfm.RECURRENT_MIXERS
# byte alignment of each leaf in a swap snapshot's host buffer
PACK_ALIGN = 16


def gather_slot_pages(pools: Any, phys: torch.Tensor, paged: Any,
                      slot: int) -> Any:
    """A slot's physical pages ``phys`` (n,) of every paged leaf and its
    row ``slot`` (reps, 1, ...) of every state leaf (``paged``: the
    pools' tree of flags), copied out: the device half of a swap."""
    return tree_map(lambda t, f: t[:, phys].contiguous() if f
                    else t[:, slot:slot + 1].contiguous(), pools, paged)


def paged_flags(cfg: ModelConfig) -> List[Any]:
    """The decode cache's tree (``tfm.paged_cache_defs``'s) with a bool at
    every leaf: True for a page pool, False for a per-slot state row."""
    defs = tfm.paged_cache_defs(cfg, 1, 1, 1)
    flags = []
    for seg, (unit, _) in zip(defs, cfg.segments()):
        flags.append({f"b{i}": tree_map(lambda _, f=b.mixer in _PAGED_MIXERS:
                                        f, seg[f"b{i}"])
                      for i, b in enumerate(unit)})
    return flags


def split_leaves(pools: Any, paged: Any):
    """(paged leaves, state-row leaves) of a pool tree, in leaf order."""
    pairs = list(zip(tree_leaves(pools), tree_leaves(paged)))
    return [t for t, f in pairs if f], [t for t, f in pairs if not f]


def pack_leaves(leaves: List[torch.Tensor]):
    """The leaves' bytes in one flat uint8 buffer on their device, each
    leaf at a ``PACK_ALIGN``-aligned offset (zero padding between), so
    viewing a leaf's bytes as its dtype never meets a misaligned offset
    whatever the leaves' sizes (int8 codes beside float32 scales).
    Returns (buffer, offsets)."""
    pieces, offsets, total = [], [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        pad = -n % PACK_ALIGN
        offsets.append(total)
        pieces.append(t.reshape(-1).view(torch.uint8))
        if pad:
            pieces.append(torch.zeros(pad, dtype=torch.uint8,
                                      device=t.device))
        total += n + pad
    return torch.cat(pieces), offsets


def supports_paging(cfg: ModelConfig) -> bool:
    """True iff every mixer in the model has a paged decode path
    (decoder-only archs; enc-dec / VLM cross-attention is static-engine
    territory).  Recurrent mixers count: their state rows sit beside the
    pages."""
    if cfg.is_encoder_decoder or cfg.n_image_tokens:
        return False
    return all(b.mixer in _PAGED_MIXERS + _RECURRENT_MIXERS
               for b in cfg.block_pattern)


def supports_prefix_cache(cfg: ModelConfig) -> bool:
    """Prefix sharing needs (a) all state to live in pages — a recurrent
    mixer's O(1) state is position-dependent and per-slot — and (b)
    prefill of a suffix chunk to equal whole-prompt prefill, which an MoE
    FFN's tokens-per-call capacity cutoff breaks."""
    return (supports_paging(cfg)
            and all(b.mixer in _PAGED_MIXERS for b in cfg.block_pattern)
            and all(b.ffn != "moe" for b in cfg.block_pattern))


@dataclasses.dataclass
class _SlotMeta:
    """Host bookkeeping for one allocated slot."""
    n_blocks: int                    # leading table entries backed by pages
    budget: int                      # admission token ceiling for this slot
    cached_tokens: int = 0           # prefix-cache tokens skipped at alloc
    frozen_blocks: int = 0           # leading blocks registered in the index
    hash_chain: List[int] = dataclasses.field(default_factory=list)
    # blocks [exempt_lo, exempt_hi) are this slot's OWN eagerly-frozen
    # prompt pages: its prefill writes their canonical content, which is
    # exempt from copy-on-write
    exempt_lo: int = 0
    exempt_hi: int = 0


@dataclasses.dataclass
class SwapSnapshot:
    """A preempted slot's pages and state rows, parked in host memory.
    ``data`` mirrors the pool tree, each paged leaf's pages ``(reps,
    n_blocks, page, ...)`` and each state leaf's row ``(reps, 1, ...)``,
    as views into one pinned host buffer."""
    n_blocks: int
    budget: int
    frozen_blocks: int
    hash_chain: List[int]
    cached_tokens: int
    data: List[Any]

    @property
    def nbytes(self) -> int:
        return int(sum(x.numel() * x.element_size()
                       for x in tree_leaves(self.data)))


class PagedKVCache:
    """Page pools for every cache leaf of the model, viewed through a
    ref-counted :class:`BlockPool`."""

    def __init__(self, cfg: ModelConfig, num_slots: int, page_size: int,
                 max_len: int, device: torch.device,
                 num_pages: Optional[int] = None, margin_tokens: int = 0,
                 prefix_cache: bool = False, eager_freeze: bool = True):
        """``margin_tokens`` widens every block table past the ``max_len``
        admission ceiling WITHOUT backing pages: speculative verification
        writes up to k draft lines beyond a request's committed context,
        and near the end of its budget those positions must still resolve
        to a legal table entry.  Margin entries stay 0 (the trash page),
        so overflow writes land harmlessly and never alias live pages."""
        if not supports_paging(cfg):
            raise NotImplementedError(
                f"{cfg.name}: paged KV cache supports decoder-only archs "
                f"(mixers {_PAGED_MIXERS + _RECURRENT_MIXERS})")
        if prefix_cache and not supports_prefix_cache(cfg):
            raise NotImplementedError(
                f"{cfg.name}: prefix sharing needs attention/MLA mixers "
                "throughout and no MoE FFN (chunked-prefill identity)")
        tfm.check_supported(cfg)
        self.cfg = cfg
        self.device = device
        self.num_slots = num_slots
        self.page_size = page_size
        self.prefix_cache = prefix_cache
        # alloc-time registration of a request's own full prompt pages;
        # only sound when a prompt prefills whole within its admission step
        self.eager_freeze = eager_freeze
        admit_blocks = max(1, math.ceil(max_len / page_size))
        self.blocks_per_slot = admit_blocks + math.ceil(
            margin_tokens / page_size)
        self.max_len = admit_blocks * page_size
        if num_pages is None:
            # full backing store + the trash page (margin blocks are never
            # backed: they always point at the trash page)
            num_pages = 1 + num_slots * admit_blocks
        self.num_pages = num_pages
        self.pool = BlockPool(num_pages, page_size)
        defs = tfm.paged_cache_defs(cfg, num_slots, num_pages, page_size)
        self.pools = instantiate(defs, None, device)
        # leaf -> page pool (True) or per-slot state row (False)
        self._paged = paged_flags(cfg)
        self.block_tables = np.zeros((num_slots, self.blocks_per_slot),
                                     np.int32)
        # the device tables a decode / verify step reads, one persistent
        # buffer (a captured step keeps its pointer), refilled each step
        self.tables = StaticInput(self.block_tables.shape, torch.int32,
                                  device)
        self._free_slots: List[int] = list(range(num_slots - 1, -1, -1))
        self._meta: Dict[int, _SlotMeta] = {}

    # -- allocator ---------------------------------------------------------

    def pages_needed(self, n_tokens: int) -> int:
        return max(1, math.ceil(n_tokens / self.page_size))

    @property
    def available_page_count(self) -> int:
        """Pages obtainable right now: free + evictable cached."""
        return self.pool.available_page_count

    @property
    def free_slot_count(self) -> int:
        return len(self._free_slots)

    @property
    def page_bytes(self) -> int:
        """Device bytes of ONE physical page summed over every paged leaf
        (scales too): the unit of the capacity axis.  State rows are not
        paged and count in no page."""
        return sum(t.numel() // self.num_pages * t.element_size()
                   for t in split_leaves(self.pools, self._paged)[0])

    @property
    def state_row_bytes(self) -> int:
        """Device bytes of ONE slot's state rows over every recurrent
        leaf (0 for attention-only models)."""
        return sum(t.numel() // self.num_slots * t.element_size()
                   for t in split_leaves(self.pools, self._paged)[1])

    def prefix_match_pages(self, tokens: np.ndarray) -> int:
        """How many of ``tokens``'s full pages are in the prefix index (no
        references taken)."""
        if not self.prefix_cache:
            return 0
        m = 0
        for h in token_chain_hashes(np.asarray(tokens), self.page_size):
            if self.pool.peek(h) is None:
                break
            m += 1
        return m

    def pages_needed_for(self, tokens: np.ndarray) -> int:
        return self.pages_needed(len(tokens)) - self.prefix_match_pages(
            tokens)

    def can_admit(self, n_tokens: int, reserve_pages: int = 0) -> bool:
        """Whether a slot and ``n_tokens``' pages plus ``reserve_pages``
        are obtainable now (no prefix dedup: see :meth:`can_admit_tokens`)."""
        return (n_tokens <= self.max_len
                and bool(self._free_slots)
                and self.pages_needed(n_tokens) + reserve_pages
                <= self.available_page_count)

    def can_admit_tokens(self, tokens: np.ndarray,
                         reserve_pages: int = 0) -> bool:
        """Whether a slot and the context's pages (after prefix-cache
        dedup) plus ``reserve_pages`` are obtainable now."""
        return (len(tokens) <= self.max_len
                and bool(self._free_slots)
                and self.pages_needed_for(tokens) + reserve_pages
                <= self.available_page_count)

    def alloc(self, n_tokens: int, slot: Optional[int] = None,
              budget: Optional[int] = None,
              tokens: Optional[np.ndarray] = None) -> Optional[int]:
        """Reserve a slot plus pages backing an ``n_tokens`` context now
        (growth up to ``budget`` tokens is on demand).  ``slot`` pins a
        specific free slot: a draft-model cache mirroring the target
        engine packs its batch by the target's slot indices.  ``tokens``
        enables prefix-cache aliasing of matching leading full pages.
        Returns the slot, or None when slots or pages are exhausted."""
        budget = n_tokens if budget is None else budget
        if max(n_tokens, budget) > self.max_len:
            raise ValueError(f"request needs {max(n_tokens, budget)} tokens "
                             f"> max_len {self.max_len}")
        n_pages = self.pages_needed(n_tokens)
        if not self._free_slots:
            return None
        # at least one trailing token is always recomputed (the engine
        # needs its logits): a fully aligned match leaves the final page
        # aliased-but-about-to-be-written, the copy-on-write case
        matched: List[int] = []
        hashes: List[int] = []
        if self.prefix_cache and tokens is not None and n_tokens > 1:
            for h in token_chain_hashes(np.asarray(tokens)[:n_tokens],
                                        self.page_size):
                page = self.pool.lookup(h)
                if page is None:
                    break
                matched.append(page)
                hashes.append(h)
        fresh: List[int] = []
        for _ in range(n_pages - len(matched)):
            page = self.pool.acquire()
            if page is None:
                for p in fresh + matched:
                    self.pool.release(p)
                return None
            fresh.append(page)
        if slot is None:
            slot = self._free_slots.pop()
        elif slot in self._free_slots:
            self._free_slots.remove(slot)
        else:
            for p in fresh + matched:
                self.pool.release(p)
            raise ValueError(f"slot {slot} is not free")
        row = np.zeros((self.blocks_per_slot,), np.int32)
        row[:n_pages] = matched + fresh
        self.block_tables[slot] = row
        cached = min(len(matched) * self.page_size, n_tokens - 1) \
            if matched else 0
        self._meta[slot] = _SlotMeta(
            n_blocks=n_pages, budget=budget, cached_tokens=cached,
            frozen_blocks=len(matched), hash_chain=hashes)
        self._zero_slot_state(slot)
        if self.prefix_cache and self.eager_freeze and tokens is not None:
            meta = self._meta[slot]
            meta.exempt_lo = len(matched)
            self.freeze_committed(slot, np.asarray(tokens)[:n_tokens],
                                  n_tokens)
            meta.exempt_hi = meta.frozen_blocks
        return slot

    def prefix_cached_tokens(self, slot: int) -> int:
        return self._meta[slot].cached_tokens

    def slot_pages(self, slot: int) -> int:
        return self._meta[slot].n_blocks

    def ensure_writable(self, slot: int, start: int, end: int) -> bool:
        """Make positions ``[start, end)`` writable by this slot: acquire
        pages as the write frontier crosses page boundaries and copy any
        shared or frozen page in the span first.  Returns False when the
        pool is dry (the caller preempts)."""
        meta = self._meta[slot]
        end = min(end, meta.budget)
        if start >= end:
            return True
        row = self.block_tables[slot]
        for b in range(start // self.page_size,
                       (end - 1) // self.page_size + 1):
            if b >= meta.n_blocks:
                if b != meta.n_blocks:
                    raise RuntimeError(f"write frontier skipped block "
                                       f"{meta.n_blocks} -> {b}")
                page = self.pool.acquire()
                if page is None:
                    return False
                row[b] = page
                meta.n_blocks += 1
            elif (self.pool.cow_needed(int(row[b]))
                  and not meta.exempt_lo <= b < meta.exempt_hi):
                src = int(row[b])
                dst = self.pool.acquire()
                if dst is None:
                    return False
                self._copy_page(src, dst)
                self.pool.note_cow()
                self.pool.release(src)
                row[b] = dst
                meta.frozen_blocks = min(meta.frozen_blocks, b)
                del meta.hash_chain[b:]
        return True

    def freeze_committed(self, slot: int, tokens: np.ndarray,
                         final_len: int) -> None:
        """Register every full page whose positions ``< final_len`` are
        final under its chain hash.  No-op unless ``prefix_cache``."""
        if not self.prefix_cache:
            return
        meta = self._meta[slot]
        row = self.block_tables[slot]
        n_final = min(final_len // self.page_size, meta.n_blocks)
        tokens = np.asarray(tokens)
        for b in range(meta.frozen_blocks, n_final):
            parent = meta.hash_chain[b - 1] if b else None
            h = chain_hash(parent, tokens[b * self.page_size:
                                          (b + 1) * self.page_size])
            meta.hash_chain.append(h)
            self.pool.freeze(int(row[b]), h)
            meta.frozen_blocks = b + 1

    def free(self, slot: int) -> None:
        """Release every page the slot references and recycle the slot;
        freeing a slot that is not allocated raises."""
        meta = self._meta.pop(slot, None)
        if meta is None:
            raise ValueError(f"double free: slot {slot} is not allocated")
        row = self.block_tables[slot]
        for b in range(meta.n_blocks):
            self.pool.release(int(row[b]))
        self._free_slots.append(slot)
        self.block_tables[slot] = 0

    def table_refs(self) -> Dict[int, int]:
        """Per-page reference counts implied by the block tables."""
        refs: Dict[int, int] = {}
        for slot, meta in self._meta.items():
            for b in range(meta.n_blocks):
                p = int(self.block_tables[slot][b])
                refs[p] = refs.get(p, 0) + 1
        return refs

    # -- preemption / swap -------------------------------------------------

    def swap_out(self, slot: int) -> SwapSnapshot:
        """Copy the slot's pages and state rows to host memory and free
        them.  Every leaf's gathered pages (or row) are packed into one
        byte buffer on the device, so the swap crosses to the host as ONE
        copy (into pinned memory on CUDA); the snapshot's leaves are views
        of it."""
        meta = self._meta[slot]
        phys = torch.as_tensor(self.block_tables[slot][: meta.n_blocks],
                               dtype=torch.long, device=self.device)
        dev = gather_slot_pages(self.pools, phys, self._paged, slot)
        snap = SwapSnapshot(
            n_blocks=meta.n_blocks, budget=meta.budget,
            frozen_blocks=meta.frozen_blocks,
            hash_chain=list(meta.hash_chain),
            cached_tokens=meta.cached_tokens, data=self._pack_to_host(dev))
        self.free(slot)
        return snap

    def swap_in_pages_needed(self, snap: SwapSnapshot) -> int:
        hits = sum(1 for h in snap.hash_chain[: snap.frozen_blocks]
                   if self.pool.peek(h) is not None)
        return snap.n_blocks - hits

    def swap_in(self, snap: SwapSnapshot) -> Optional[int]:
        """Restore a swapped-out slot, into any free slot: frozen-prefix
        pages still in the index are aliased, the rest re-acquired and
        copied back from the host (each leaf in one copy from the pinned
        buffer), and the state rows copied into the new slot's rows.
        Returns the slot, or None if slots/pages are exhausted."""
        if not self._free_slots:
            return None
        pages: List[int] = []
        restore: List[int] = []
        frozen = 0
        for b in range(snap.n_blocks):
            page = None
            if b < snap.frozen_blocks:
                page = self.pool.lookup(snap.hash_chain[b])
            if page is None:
                page = self.pool.acquire()
                if page is None:
                    for p in pages:
                        self.pool.release(p)
                    return None
                restore.append(b)
            elif frozen == b:
                frozen = b + 1
            pages.append(page)
        slot = self._free_slots.pop()
        row = np.zeros((self.blocks_per_slot,), np.int32)
        row[: snap.n_blocks] = pages
        self.block_tables[slot] = row
        self._meta[slot] = _SlotMeta(
            n_blocks=snap.n_blocks, budget=snap.budget,
            cached_tokens=snap.cached_tokens, frozen_blocks=frozen,
            hash_chain=list(snap.hash_chain[:frozen]))
        dst = torch.as_tensor(np.asarray(pages, np.int64)[restore],
                              device=self.device)
        src = torch.as_tensor(restore, dtype=torch.long, device=self.device)

        def put(pool, host, paged):
            # each leaf crosses whole, in one copy out of the pinned
            # buffer; the pages to restore are picked on the device
            leaf = host.to(self.device)
            if not paged:
                pool[:, slot] = leaf[:, 0].to(pool.dtype)
            elif restore:
                pool[:, dst] = leaf[:, src].to(pool.dtype)

        tree_map(put, self.pools, snap.data, self._paged)
        return slot

    def _pack_to_host(self, dev: List[Any]) -> List[Any]:
        """One device->host copy for a whole tree of device tensors, packed
        into one byte buffer (:func:`pack_leaves`)."""
        leaves = tree_leaves(dev)
        flat, offsets = pack_leaves(leaves)
        host = torch.empty(flat.numel(), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        host.copy_(flat)                               # the one copy
        it = iter(zip(leaves, offsets))

        def unpack(_):
            t, off = next(it)
            n = t.numel() * t.element_size()
            return host[off:off + n].view(t.dtype).reshape(t.shape)

        self.pool.stats.swap_dmas += 1
        self.pool.stats.swap_transfers_saved += max(len(leaves) - 1, 0)
        return tree_map(unpack, dev)

    def synchronize(self) -> None:
        synchronize(self.device)

    # -- device page ops ---------------------------------------------------

    def _copy_page(self, src: int, dst: int) -> None:
        """Device-side page copy across every paged leaf (copy-on-write)."""
        def f(pool, paged):
            if paged:
                pool[:, dst] = pool[:, src]
        tree_map(f, self.pools, self._paged)

    def _zero_slot_state(self, slot: int) -> None:
        """A fresh request starts from zero recurrent state; attention
        pages need no reset (masked by position)."""
        def f(pool, paged):
            if not paged:
                pool[:, slot].zero_()
        tree_map(f, self.pools, self._paged)

    # -- views -------------------------------------------------------------

    def block_tables_for(self, slots: Optional[List[int]] = None
                         ) -> torch.Tensor:
        """Device block tables (int32), written into the persistent
        ``tables`` buffer and returned; rows not in ``slots`` point at the
        trash page so idle lanes cannot clobber live pages."""
        if slots is None:
            bt = self.block_tables
        else:
            bt = np.zeros_like(self.block_tables)
            bt[slots] = self.block_tables[slots]
        return self.tables.set(bt)

    def write_prefill_states(self, slot: int, states: List[Any],
                             prompt_len: int, start: int = 0) -> None:
        """Write whole-prompt prefill states into this slot: attention
        lines (per segment, stacked (reps, 1, S, ...); S may exceed
        ``prompt_len`` when padded) into its pages through
        :meth:`scatter_prefill_states`, where positions below ``start`` (a
        prefix-cache hit) and pad positions go to the trash page; a
        recurrent block's final state (reps, 1, ...) into its rows."""
        row = torch.as_tensor(self.block_tables[slot], device=self.device)
        self.scatter_prefill_states(row, states, start, prompt_len)
        for seg_pool, seg_state, seg_flag in zip(self.pools, states,
                                                 self._paged):
            for bname, blk in seg_pool.items():
                for name, pool in blk.items():
                    if not seg_flag[bname][name]:
                        pool[:, slot] = seg_state[bname][name][:, 0].to(
                            pool.dtype)

    def scatter_prefill_states(self, row: torch.Tensor, states: List[Any],
                               start, true_len) -> None:
        """Scatter prefill states through the block-table row ``row``
        (n_blocks,) on the device, in one fixed-shape index: every one of
        the states' S positions is written, and those outside ``[start,
        true_len)`` (0-d device tensors or ints) go to the trash page,
        table entry 0.  No host array is built and no shape depends on the
        prompt, so a captured prefill replays it at any length; the pools
        equal a scatter of the real positions alone everywhere outside
        page 0, whose lines the pad positions overwrite.  State rows are
        left alone (:meth:`write_prefill_states` writes them)."""
        states = self._quantize_states(states)
        lines = split_leaves(states, self._paged)[0]
        if not lines:
            return
        S = lines[0].shape[2]
        p = torch.arange(S, device=row.device)
        blk = row[torch.clamp(p // self.page_size, max=row.shape[0] - 1)]
        phys = torch.where((p >= start) & (p < true_len), blk.long(), 0)
        off = p % self.page_size

        def f(pool, state, paged):
            if paged:
                pool[:, phys, off] = state[:, 0].to(pool.dtype)

        tree_map(f, self.pools, states, self._paged)

    def _quantize_states(self, states: List[Any]) -> List[Any]:
        """Quantized pools carry ``*_scale`` leaves the collected prefill
        states lack: quantize each value stream over its line axis (the op
        the decode commit uses) and add the matching scale state, so the
        scatter maps over identical trees and its ``.to(pool.dtype)`` on
        the codes is a no-op, never a raw cast."""
        if not kvq.is_quantized(self.cfg.kv_dtype):
            return states
        out: List[Any] = []
        for seg_pool, seg_state in zip(self.pools, states):
            new_seg = {}
            for bname, blk_pool in seg_pool.items():
                blk = dict(seg_state[bname])
                for name in blk_pool:
                    if name.endswith("_scale"):
                        base = name[: -len("_scale")]
                        blk[base], blk[name] = kvq.quantize(
                            blk[base], self.cfg.kv_dtype, -1)
                new_seg[bname] = blk
            out.append(new_seg)
        return out

    def dense_view(self, slot: int) -> List[Any]:
        """One slot's cache gathered back into a dense batch-1 layout:
        paged leaves (reps, 1, max_len, ...), state leaves (reps, 1,
        ...).  Quantized pools are dequantized back to the model dtype and
        their scale leaves dropped, so the view's tree is the same whatever
        ``kv_dtype``.  For tests and debugging."""
        row = torch.as_tensor(self.block_tables[slot], dtype=torch.long,
                              device=self.device)

        def f(pool, paged):
            if not paged:
                return pool[:, slot:slot + 1].clone()
            g = pool[:, row]                    # (reps, blocks, page, ...)
            return g.reshape(g.shape[0], 1,
                             self.blocks_per_slot * self.page_size,
                             *g.shape[3:])[:, :, : self.max_len]

        dense = [tree_map(f, seg, flag)
                 for seg, flag in zip(self.pools, self._paged)]
        if kvq.is_quantized(self.cfg.kv_dtype):
            for seg in dense:
                for blk in seg.values():
                    for name in [n for n in blk if n.endswith("_scale")]:
                        base = name[: -len("_scale")]
                        blk[base] = kvq.dequantize(
                            blk[base], blk.pop(name)).to(
                                torch_dtype(self.cfg.dtype))
        return dense
