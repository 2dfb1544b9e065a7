"""Bounds checker for the CUDA kernels' index arithmetic: no kernel
launch (the counterpart of ``repro.analysis.kernelcheck``, which checks
the Pallas ``index_map``s).

The port's kernels compute their row indices in CUDA, and an index out of
range reads another tensor's memory on the card with no error. Each
kernel package states that arithmetic as module-level Python functions
that name the ``.cu`` lines they mirror
(``kernels.decode_attention.kernel``: ``split_block``, ``chunk_live``,
``partial_slot``, ``dense_rows``, ``paged_rows``;
``kernels.flash_attention.kernel``: ``kv_head``). This pass evaluates
them over the whole grid for a ledger of boundary states: lengths 0, 1,
either side of a chunk edge, C - 1, C and C + 7 (clamped to C as the
kernels do); caches of C positions that the chunk does not divide; block
tables from a real ledger-only ``runtime.paging.PagedKVCacheManager``
(shared prefixes, a partial tail, a full table row, decode growth, a
reset slot and an untouched slot); and an all-unallocated table. It
proves, under the reference pass's violation codes:

  * the split grid: every block decodes to one (chunk, row, KV head), each
    once (``*-block-identity``), and writes its partials inside the
    scratch, apart from every other block's (``decode-partial-slot``);
  * dense: every row read lies in the [B * C] rows (``dense-block-range``);
    a live position reads its own row b * C + pos
    (``dense-live-step-redirected``), and every live position is read by
    one block (``decode-live-position-missed``);
  * paged: every row lies in the pool (``paged-page-range``); a live
    position reads row ``table[b, pos // bs] * bs + pos % bs``
    (``paged-live-step-redirected``) of an allocated entry
    (``paged-live-step-unallocated``: the -1 an unallocated entry holds is
    clamped to the scratch page 0) that is not the scratch page
    (``paged-live-step-scratch``);
  * flash: the GQA fold stays inside the [B * Kv] KV rows
    (``flash-row-range``) and reads ``h // (H / Kv)``, the same KV head
    across the g query heads of a group (``flash-gqa-fold``);
  * the mLSTM backward (``kernels.mlstm_scan.kernel``: ``grad_grid``,
    ``grad_block``, ``grad_span``, ``state_tile``, ``state_span``,
    ``state_offset``), for S that the chunk does not divide and D that no
    tile divides: every gradient block decodes to one (b, h, chunk,
    column tile) (``mlstm-bwd-block-identity``), writes only inside [S, D]
    (``mlstm-bwd-write-range``: the ragged last chunk and the columns past
    D masked), and every (b, h, s, d) of dq, dk and dv is written by
    exactly one block (``mlstm-bwd-write-coverage``); the state tiles
    cover the [D, D] state once (``mlstm-bwd-state-tiles``); and chunk c's
    C and G states lie inside their buffers, apart from every other's
    (``mlstm-bwd-state-range``).

Each check takes the mirror as an argument, so the tests can hand it a
broken one and compare the codes with the reference pass's on the
equivalent Pallas map.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.analysis.report import Violation
from repro_torch.kernels.decode_attention import kernel as dec
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.mlstm_scan import kernel as mlstm

PASS = "kernelcheck"


def _boundary_lengths(C: int, chunk: int = dec.CHUNK) -> List[int]:
    """Empty row, one token, both sides of the first chunk edge, both
    sides of the capacity, and past it."""
    cand = [0, 1, chunk - 1, chunk, chunk + 1, C - 1, C, C + 7]
    return sorted({max(v, 0) for v in cand})


def _check_split_grid(prefix: str, where: str, B: int, Kv: int, g: int,
                      n_chunks: int, split: Callable) -> Tuple[list, list]:
    """The split grid decoded block by block: (violations, [(j, b, kvh)]
    of the blocks that decoded in range)."""
    out: List[Violation] = []
    seen, slots, blocks = set(), set(), []
    for x in range(B * Kv * n_chunks):
        j, b, kvh = split(x, n_chunks, B, Kv)
        if not (0 <= j < n_chunks and 0 <= b < B and 0 <= kvh < Kv):
            out.append(Violation(
                PASS, f"{prefix}-block-identity", where,
                f"split block {x} decodes to (chunk {j}, row {b}, head "
                f"{kvh}) outside ({n_chunks}, {B}, {Kv})"))
            continue
        if (j, b, kvh) in seen:
            out.append(Violation(
                PASS, f"{prefix}-block-identity", where,
                f"split block {x} repeats (chunk {j}, row {b}, head {kvh})"))
            continue
        seen.add((j, b, kvh))
        blocks.append((j, b, kvh))
        slot = dec.partial_slot(b, kvh, j, Kv, n_chunks, g)
        span = set(range(slot, slot + g))
        if slot < 0 or slot + g > B * Kv * n_chunks * g or span & slots:
            out.append(Violation(
                PASS, "decode-partial-slot", where,
                f"block (chunk {j}, row {b}, head {kvh}) writes partials "
                f"[{slot}, {slot + g}) outside [0, {B * Kv * n_chunks * g})"
                " or over another block's"))
        slots |= span
    return out, blocks


def check_dense_rows(C: int, lengths, Kv: int = 2, g: int = 2,
                     rows: Callable = dec.dense_rows,
                     split: Callable = dec.split_block) -> List[Violation]:
    """The dense split kernel over its whole grid for one lengths vector."""
    lens = [int(v) for v in lengths]
    B = len(lens)
    n_chunks = -(-C // dec.CHUNK)
    where = f"dense(C={C}, lens={lens})"
    out, blocks = _check_split_grid("dense", where, B, Kv, g, n_chunks,
                                    split)
    read = set()
    for j, b, kvh in blocks:
        n = dec.chunk_live(j, lens[b], C)
        p0 = j * dec.CHUNK
        for p, row in enumerate(rows(b, p0, n, C)):
            pos = p0 + p
            if not 0 <= row < B * C:
                out.append(Violation(
                    PASS, "dense-block-range", where,
                    f"row {b} position {pos} reads cache row {row} outside "
                    f"[0, {B * C})"))
            elif row != b * C + pos:
                out.append(Violation(
                    PASS, "dense-live-step-redirected", where,
                    f"row {b} live position {pos} (len={lens[b]}) reads "
                    f"cache row {row}, its own is {b * C + pos}"))
            read.add((b, kvh, pos))
    out += _missed(read, lens, C, Kv, where)
    return out


def _missed(read, lens, C: int, Kv: int, where: str) -> List[Violation]:
    out = []
    for b, ln in enumerate(lens):
        live = max(0, min(ln, C))
        for kvh in range(Kv):
            gone = [p for p in range(live) if (b, kvh, p) not in read]
            if gone:
                out.append(Violation(
                    PASS, "decode-live-position-missed", where,
                    f"row {b} head {kvh}: live positions {gone[:4]}... "
                    f"({len(gone)}) read by no block"))
    return out


def check_paged_rows(tables, lengths, num_pages: int, bs: int,
                     Kv: int = 2, g: int = 2, where: str = "",
                     rows: Callable = dec.paged_rows,
                     split: Callable = dec.split_block,
                     scratch_page: int = 0) -> List[Violation]:
    """The paged split kernel over its whole grid for one (block table,
    lengths) ledger state; ``tables`` int [B, n_blocks], < 0 =
    unallocated."""
    tbl = np.asarray(tables, np.int32)
    B, n_blocks = tbl.shape
    C = n_blocks * bs
    lens = [int(v) for v in lengths]
    n_chunks = -(-C // dec.CHUNK)
    where = where or f"paged(P={num_pages}, bs={bs}, B={B})"
    out, blocks = _check_split_grid("paged", where, B, Kv, g, n_chunks,
                                    split)
    read = set()
    for j, b, kvh in blocks:
        n = dec.chunk_live(j, lens[b], C)
        p0 = j * dec.CHUNK
        for p, row in enumerate(rows(tbl[b], p0, n, bs)):
            pos = p0 + p
            read.add((b, kvh, pos))
            if not 0 <= row < num_pages * bs:
                out.append(Violation(
                    PASS, "paged-page-range", where,
                    f"row {b} position {pos} reads pool row {row} (page "
                    f"{row // bs}) outside [0, {num_pages}) pages (table "
                    f"entry {int(tbl[b, pos // bs])}, len={lens[b]})"))
                continue
            want = int(tbl[b, pos // bs])
            if want < 0:
                out.append(Violation(
                    PASS, "paged-live-step-unallocated", where,
                    f"row {b} len={lens[b]}: live position {pos} has no "
                    f"page (table entry {want}, clamped to page 0): the "
                    "ledger promised coverage it did not allocate"))
            elif row != want * bs + pos % bs:
                out.append(Violation(
                    PASS, "paged-live-step-redirected", where,
                    f"row {b} live position {pos} reads pool row {row}, "
                    f"the table says {want * bs + pos % bs}"))
            elif row // bs == scratch_page:
                out.append(Violation(
                    PASS, "paged-live-step-scratch", where,
                    f"row {b} live position {pos} reads the reserved "
                    f"scratch page {scratch_page}"))
    out += _missed(read, lens, C, Kv, where)
    return out


def check_flash_fold(B: int, H: int, Kv: int,
                     fold: Callable = flash.kv_head) -> List[Violation]:
    """The GQA fold of every (batch row, query head) block: its KV row
    b * Kv + kvh inside [0, B * Kv), kvh = h // g, one per group."""
    out: List[Violation] = []
    g = H // Kv
    where = f"flash(B={B}, H={H}, Kv={Kv})"
    for b in range(B):
        for h in range(H):
            kvh = fold(h, H, Kv)
            row = b * Kv + kvh
            if not (0 <= kvh < Kv and 0 <= row < B * Kv):
                out.append(Violation(
                    PASS, "flash-row-range", where,
                    f"batch {b} head {h} reads KV row {row} outside "
                    f"[0, {B * Kv})"))
                continue
            lead = fold((h // g) * g, H, Kv)
            if kvh != h // g or kvh != lead:
                out.append(Violation(
                    PASS, "flash-gqa-fold", where,
                    f"batch {b} head {h} reads KV head {kvh}, its group's "
                    f"is {h // g}"))
    return out


def check_mlstm_bwd(BH: int, S: int, D: int,
                    block: Callable = mlstm.grad_block,
                    span: Callable = mlstm.grad_span,
                    tile_span: Callable = mlstm.state_span,
                    offset: Callable = mlstm.state_offset
                    ) -> List[Violation]:
    """The mLSTM backward's gradient grid, state tiles and state offsets
    for one (BH, S, D), at the kernels' chunk length."""
    out: List[Violation] = []
    chunk = mlstm.BACKWARD_CHUNK
    where = f"mlstm_bwd(BH={BH}, S={S}, D={D})"
    n_ck = -(-S // chunk)
    n_jt = -(-D // mlstm.BACKWARD_TILE)
    # one more row and column than the tensors hold: a write past S or D
    # lands there instead of vanishing
    writes = np.zeros((BH, S + chunk, D + mlstm.BACKWARD_TILE), np.int32)
    for y in range(BH):
        for x in range(mlstm.grad_grid(S, D)):
            bh, c, j = block(x, y, D)
            if not (0 <= bh < BH and 0 <= c < n_ck and 0 <= j < n_jt):
                out.append(Violation(
                    PASS, "mlstm-bwd-block-identity", where,
                    f"block ({x}, {y}) decodes to (bh {bh}, chunk {c}, "
                    f"tile {j}) outside ({BH}, {n_ck}, {n_jt})"))
                continue
            rows, cols = span(c, j, S, D)
            if (rows and (rows[0] < 0 or rows[-1] >= S)) or \
                    (cols and (cols[0] < 0 or cols[-1] >= D)):
                out.append(Violation(
                    PASS, "mlstm-bwd-write-range", where,
                    f"block (bh {bh}, chunk {c}, tile {j}) writes steps "
                    f"{rows.start}..{rows.stop - 1}, columns {cols.start}.."
                    f"{cols.stop - 1} of [{S}, {D}]"))
            r = slice(max(rows.start, 0), rows.stop)
            k = slice(max(cols.start, 0), cols.stop)
            writes[bh, r, k] += 1
    inside = writes[:, :S, :D]
    if (inside != 1).any():
        bh, s, d = np.argwhere(inside != 1)[0]
        out.append(Violation(
            PASS, "mlstm-bwd-write-coverage", where,
            f"{int((inside == 0).sum())} entries of dq/dk/dv written by no "
            f"block, {int((inside > 1).sum())} by more than one (first: bh "
            f"{bh}, s {s}, d {d}: {int(inside[bh, s, d])})"))
    n_st = -(-D // mlstm.BACKWARD_STATE_ROWS) * n_jt
    pad = mlstm.BACKWARD_STATE_ROWS + mlstm.BACKWARD_TILE
    cover = np.zeros((D + pad, D + pad), np.int32)
    for x in range(n_st):
        rows, cols = tile_span(x, D)
        cover[max(rows.start, 0):rows.stop, max(cols.start, 0):cols.stop] \
            += 1
    state = cover[:D, :D]
    if (state != 1).any() or cover.sum() != state.sum():
        out.append(Violation(
            PASS, "mlstm-bwd-state-tiles", where,
            f"{int((state == 0).sum())} state entries in no tile, "
            f"{int((state > 1).sum())} in more than one, "
            f"{int(cover.sum() - state.sum())} writes past D"))
    size = BH * n_ck * D * D
    spans = sorted((offset(bh, c, S, D), bh, c)
                   for bh in range(BH) for c in range(n_ck))
    end = 0
    for off, bh, c in spans:
        if off < 0 or off + D * D > size or off < end:
            out.append(Violation(
                PASS, "mlstm-bwd-state-range", where,
                f"the state of (bh {bh}, chunk {c}) spans [{off}, "
                f"{off + D * D}): outside [0, {size}) or over another's"))
        end = max(end, off + D * D)
    return out


def ledger_states(bs: int = 16):
    """Boundary ledger states from the port's own ledger-only manager:
    shared prefixes, a partial tail, a full table row, decode growth, a
    freshly reset slot and a never-touched (all -1, length 0) slot."""
    from repro_torch.runtime.paging import PagedKVCacheManager
    kv = PagedKVCacheManager(6, max_context=4 * bs, block_size=bs,
                             num_blocks=24)
    base = list(range(2 * bs))                  # two shareable full blocks
    kv.assign_blocks(0, base + [7] * 3)         # prefix + partial tail
    kv.set_length(0, 2 * bs + 4)
    kv.assign_blocks(1, base + [9] * (bs + 1))  # shares slot 0's prefix
    kv.set_length(1, 3 * bs + 2)
    kv.assign_blocks(2, list(range(4 * bs - 1)))   # full table row
    kv.set_length(2, 4 * bs)
    kv.assign_blocks(3, [5] * bs)               # prompt fills block 0
    kv.set_length(3, bs + 1)                    # next write is block 1
    kv.ensure_decode_page(3)                    # decode-growth tail page
    kv.reset_slot(4)                            # recovered slot, len 1
    # slot 5 never allocated: all -1, length 0
    return kv


#: (C, lengths) of the dense cases: a chunk multiple, C that the chunk
#: does not divide (60 < one chunk, 100, 13), and one chunk exactly
DENSE_CACHES = (128, 60, 100, 13, 64)
#: (B, H, Kv) of the flash cases: GQA, MHA, one KV head, g = 7
FLASH_SHAPES = ((2, 8, 2), (1, 4, 4), (3, 6, 1), (2, 14, 2))
#: (BH, S, D) of the mLSTM backward's cases (L = 64): one step; a ragged
#: chunk and a D under one tile; L - 1, L + 1, 2 L + 1 and 2 L + 3 steps
#: against D that neither tile divides; the train shape's D
MLSTM_BWD_CASES = ((2, 1, 64), (2, 37, 48), (3, 63, 200), (1, 65, 260),
                   (2, 131, 132), (2, 129, 200), (1, 130, 1024))


def run(fast: bool = False, log=None) -> Tuple[List[Violation], Dict]:
    """Every mirror over its case matrix."""
    out: List[Violation] = []
    cases = 0
    for C in (DENSE_CACHES[:2] if fast else DENSE_CACHES):
        out += check_dense_rows(C, _boundary_lengths(C))
        cases += 1
    for bs in ((16,) if fast else (16, 48)):
        kv = ledger_states(bs)
        out += check_paged_rows(kv._tables, kv.lengths(),
                                kv.pool.num_blocks, bs,
                                where=f"paged(ledger, bs={bs})")
        cases += 1
    empty = np.full((3, 4), -1, np.int32)
    out += check_paged_rows(empty, [0, 0, 0], 8, 16,
                            where="paged(all-unallocated)")
    cases += 1
    for B, H, Kv in (FLASH_SHAPES[:2] if fast else FLASH_SHAPES):
        out += check_flash_fold(B, H, Kv)
        cases += 1
    for BH, S, D in (MLSTM_BWD_CASES[:2] if fast else MLSTM_BWD_CASES):
        out += check_mlstm_bwd(BH, S, D)
        cases += 1
    if log is not None:
        log(f"kernelcheck: {cases} cases, {len(out)} violations")
    return out, {"kernel_cases": cases, "fast": fast}
