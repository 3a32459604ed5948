"""Device-side JPEG entropy ENCODING: Huffman bit emission on device.

Goes one step beyond the size oracle (ops/jpeg_size.py): the actual
entropy-coded bitstream is assembled on device — every symbol's bit offset
comes from prefix sums (no sequential bit writer), and the whole pipeline
is scatter-free:

  1. per-block LOCAL packing: each block's symbols (DC code+magnitude,
     merged ZRL pairs, AC code+magnitude, EOB — every field ≤ 32 bits) are
     deposited into a fixed (LWORDS,) big-endian u32 buffer per block with
     one-hot masked reductions over the word axis — elementwise work,
     vectorized over all blocks and all 64 zigzag positions at once;
  2. GLOBAL assembly: every block's buffer is funnel-shifted onto the
     global word grid, then output word w sums (a) the first words of all
     blocks STARTING in w via one one-hot matmul (bit ranges are
     disjoint, so per-byte sums stay ≤ 255 and accumulate exactly), and
     (b) the continuation word of the single earlier block spanning w,
     found by a prefix sum over the same matmul's starter counts (no
     searchsorted) and fetched with one sorted row-gather.  Oversized
     single images (one-hot > _MATMUL_ASSEMBLE_LIMIT) fall back to a
     windowed-gather assembly over the ≤K blocks touching each word.

The host then pulls the total bit count (a scalar) and the used word
prefix (≈ the size of the compressed file, typically 100-1000× smaller
than the coefficient tensors), 1-pads the final byte, 0xFF-stuffs, and
wraps the container.

Standard Annex-K tables, interleaved single scan, no restart markers — the
configuration the engine's standard-table encode uses.  Byte-for-byte
equality with the C++ encoder is asserted in tests.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import emit_onehot_cap
from ..codecs import tables as std_tables
from .dct import ZIGZAG
from .jpeg_size import _bitlen, mcu_order


def _code_arrays(bits, values, size: int) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, lengths) int32 arrays indexed by symbol; length 0 = absent."""
    codes = np.zeros(size, dtype=np.int32)
    lens = np.zeros(size, dtype=np.int32)
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = code
            lens[values[k]] = length
            code += 1
            k += 1
        code <<= 1
    return codes, lens


@functools.lru_cache(maxsize=4)
def _std_code_arrays():
    dc_l = _code_arrays(std_tables.DC_LUMA_BITS, std_tables.DC_LUMA_VALS, 16)
    ac_l = _code_arrays(std_tables.AC_LUMA_BITS, std_tables.AC_LUMA_VALS,
                        256)
    dc_c = _code_arrays(std_tables.DC_CHROMA_BITS,
                        std_tables.DC_CHROMA_VALS, 16)
    ac_c = _code_arrays(std_tables.AC_CHROMA_BITS,
                        std_tables.AC_CHROMA_VALS, 256)
    return dc_l, ac_l, dc_c, ac_c


@functools.lru_cache(maxsize=64)
def _scan_layout(padded_h: int, padded_w: int, subsample: bool):
    """Static layout: per component, (mcu_order, inverse mcu_order,
    raster→scan-slot) index arrays, plus the total block count."""
    by, bx = padded_h // 8, padded_w // 8
    if subsample:
        cby, cbx = padded_h // 16, padded_w // 16
        y_order = mcu_order(bx, by, 2, 2)
        blocks_per_mcu = [4, 1, 1]
    else:
        cby, cbx = by, bx
        y_order = mcu_order(bx, by, 1, 1)
        blocks_per_mcu = [1, 1, 1]
    c_order = mcu_order(cbx, cby, 1, 1)
    n_y = bx * by
    n_c = cbx * cby
    total = n_y + 2 * n_c
    n_mcus = total // sum(blocks_per_mcu)

    # Component k-th MCU-traversal block → global scan slot.
    slots = [np.empty(n_y, np.int64), np.empty(n_c, np.int64),
             np.empty(n_c, np.int64)]
    ks = [0, 0, 0]
    g = 0
    for _ in range(n_mcus):
        for ci, nb in enumerate(blocks_per_mcu):
            for _ in range(nb):
                slots[ci][ks[ci]] = g
                ks[ci] += 1
                g += 1

    out = []
    for order, slot_by_k, n in ((y_order, slots[0], n_y),
                                (c_order, slots[1], n_c),
                                (c_order, slots[2], n_c)):
        inv = np.empty(n, np.int64)  # raster idx → MCU-traversal k
        inv[order] = np.arange(n)
        raster_slot = slot_by_k[inv]  # raster idx → global scan slot
        out.append((order.astype(np.int32), inv.astype(np.int32),
                    raster_slot.astype(np.int32)))
    return out, total


def emit_words_for_bits(nbits: int) -> int:
    """uint32 word-buffer size for a scan of `nbits`: next power of two
    of nbits//32 plus 64 slack words, floored at 256.  One shared rule so
    the single-image and batch engines agree on buffer shapes (and jit
    cache entries) for the same scan.

    Bound: total_bits is carried in int32 AND pull_emit_words reserves
    bit 31 of the bits column for the optimistic-lwords overflow flag,
    so a scan must stay under 2^31 bits (= a 256 MB entropy stream,
    ~77 gigapixel at typical rates — far past any real image, but the
    invariant is asserted rather than assumed)."""
    n = max(256, nbits // 32 + 64)
    p = 1
    while p < n:
        p *= 2
    assert p * 32 < 2 ** 31, (
        f"fennec: scan of {nbits} bits exceeds the 2^31-bit emission "
        f"bound (int32 bit counts + flag bit 31)")
    return p


def _lut(table_2xS: jnp.ndarray, idx: jax.Array):
    """Look idx up in a tiny (2, S) int table via one-hot matmuls.

    Exactness without f32 matmuls: every looked-up value is split
    into ≤8-bit halves, each exactly representable in bf16, and the
    one-hot rows select exactly one entry, so bf16 accumulation is exact.

    For S=256 (AC run/size symbols, idx = run*16 + size) the 256-wide
    one-hot is decomposed into two 16-wide one-hots — the big (M, 256)
    intermediate (which XLA materializes in HBM) shrinks to (M, 16)s,
    turning an HBM-bound op into a compute-trivial one.

    Returns two int32 arrays of idx's shape: (codes, lengths).
    """
    s = table_2xS.shape[1]
    codes = table_2xS[0].astype(jnp.int32)
    lens = table_2xS[1].astype(jnp.int32)
    # (S, 3): code high byte, code low byte, length — all ≤ 255.
    t3 = jnp.stack([codes >> 8, codes & 255, lens], axis=1)
    i16 = jnp.arange(16, dtype=jnp.int32)
    if s == 256:
        t3 = t3.reshape(16, 16 * 3).astype(jnp.bfloat16)
        run = (idx >> 4).astype(jnp.int32)
        size = (idx & 15).astype(jnp.int32)
        oh_r = (run[..., None] == i16).astype(jnp.bfloat16)
        oh_s = (size[..., None] == i16).astype(jnp.bfloat16)
        # p[m, s, c] = T[run_m, s, c]: one 16-wide dot per element.
        p = jax.lax.dot_general(
            oh_r.reshape(-1, 16), t3, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.bfloat16)
        p = p.reshape(*idx.shape, 16, 3)
        # Select the size column: exactly one oh_s term is 1 — exact.
        vals = jnp.sum(p * oh_s[..., None], axis=-2).astype(jnp.int32)
    else:
        t3 = t3.astype(jnp.bfloat16)  # (S ≤ 16, 3)
        oh = (idx[..., None] == jnp.arange(s, dtype=jnp.int32)).astype(
            jnp.bfloat16)
        vals = jax.lax.dot_general(
            oh.reshape(-1, s), t3, (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.bfloat16)
        vals = vals.reshape(*idx.shape, 3).astype(jnp.int32)
    code = (vals[..., 0] << 8) | vals[..., 1]
    return code, vals[..., 2]


def _symbols(blocks: jax.Array, order: np.ndarray, inv_order: np.ndarray):
    """Table-independent symbol stream of one component.

    blocks: (N, 64) natural-order raster.  Everything is raster-indexed;
    DC diffs computed along the MCU chain and mapped back.  The same
    stream feeds both the emission (with code tables) and the symbol
    histogram that optimal tables are built FROM — guaranteeing the two
    agree.
    """
    zz = blocks.astype(jnp.int32)[:, ZIGZAG]
    n = zz.shape[0]
    idx = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (n, 64))

    dc = zz[:, 0]
    dc_mcu = dc[jnp.asarray(order)]
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), dc_mcu[:-1]])
    diff = (dc_mcu - prev)[jnp.asarray(inv_order)]  # back to raster order
    s_dc = _bitlen(diff)
    dc_val = jnp.where(diff >= 0, diff, diff + (1 << s_dc) - 1)

    nz = zz != 0
    nz_marked = nz.at[:, 0].set(True)
    marked_idx = jnp.where(nz_marked, idx, 0)
    prev_nz = jax.lax.associative_scan(jnp.maximum, marked_idx, axis=1)
    prev_nz = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32), prev_nz[:, :-1]], axis=1)
    gap = idx - prev_nz - 1
    s_ac = _bitlen(zz)
    zrl = jnp.clip(gap // 16, 0, 3)
    rem = gap - zrl * 16
    sym = rem * 16 + s_ac
    ac_val = jnp.where(zz >= 0, zz, zz + (1 << s_ac) - 1)
    ac_nz = nz.at[:, 0].set(False)
    has_eob = zz[:, 63] == 0

    return {
        "s_dc": s_dc, "dc_val": dc_val, "sym": sym, "s_ac": s_ac,
        "ac_val": ac_val, "ac_nz": ac_nz, "zrl": zrl, "has_eob": has_eob,
    }


def _component_fields(blocks: jax.Array, order: np.ndarray,
                      inv_order: np.ndarray, dc_tbl, ac_tbl):
    """Per-block/position emission fields for one component.

    dc_tbl/ac_tbl: either static (codes_np, lens_np) tuples or traced
    (2, S) arrays (row 0 codes, row 1 lengths) — the latter enables
    per-image optimal tables under vmap.
    """
    if isinstance(dc_tbl, tuple):
        dc_tbl = jnp.asarray(np.stack([dc_tbl[0], dc_tbl[1]]))
    if isinstance(ac_tbl, tuple):
        ac_tbl = jnp.asarray(np.stack([ac_tbl[0], ac_tbl[1]]))

    s = _symbols(blocks, order, inv_order)
    n = s["s_dc"].shape[0]
    s_dc, s_ac = s["s_dc"], s["s_ac"]
    dc_code, dc_clen = _lut(dc_tbl, s_dc)
    dc_bits = dc_clen + s_dc
    ac_code, ac_clen = _lut(ac_tbl, s["sym"])
    ac_nz, zrl = s["ac_nz"], s["zrl"]

    zrl_code = ac_tbl[0, 0xF0]
    zrl_len = ac_tbl[1, 0xF0].astype(jnp.int32)
    eob_code = ac_tbl[0, 0x00]
    eob_clen = ac_tbl[1, 0x00].astype(jnp.int32)

    contrib = jnp.where(ac_nz, zrl * zrl_len + ac_clen + s_ac, 0)
    eob_len = jnp.where(s["has_eob"], eob_clen, 0)
    block_bits = dc_bits + jnp.sum(contrib, axis=1) + eob_len
    pos_start = dc_bits[:, None] + jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32),
         jnp.cumsum(contrib, axis=1)[:, :-1]], axis=1)
    eob_off = block_bits - eob_len

    return {
        "dc_code": dc_code, "dc_clen": dc_clen, "dc_val": s["dc_val"],
        "s_dc": s_dc, "block_bits": block_bits,
        "ac_code": ac_code, "ac_clen": ac_clen, "ac_val": s["ac_val"],
        "s_ac": s_ac, "ac_nz": ac_nz, "zrl": zrl,
        "zrl_code": zrl_code, "zrl_len": zrl_len,
        "pos_start": pos_start, "has_eob": s["has_eob"],
        "eob_off": eob_off,
        "eob_code": eob_code, "eob_clen": eob_clen,
    }


def _ac_hist_matmul(sym: jax.Array, nz: jax.Array) -> jax.Array:
    """AC run/size histogram as a 16×16 one-hot outer product.

    H[r, s] = Σ_m oh_run[m, r] · (oh_size[m, s] · nz_m).  The naive
    256-bin compare materializes an HBM-bound (M, 256) mask; decomposing
    sym = run*16 + size shrinks the operands to two (M, 16) one-hots and
    puts the reduction in a matmul.  bf16 inputs are 0/1 (exact); f32
    accumulation is exact below 2^24, so the m axis is segmented and
    segments add in int32.  Returns (256,) int32 in sym-bin order.
    """
    run = (sym >> 4).astype(jnp.int32).reshape(-1)
    size = (sym & 15).astype(jnp.int32).reshape(-1)
    live = nz.reshape(-1)
    m = run.shape[0]
    seg = min(m, 1 << 22)
    nseg = -(-m // seg)
    pad = nseg * seg - m
    if pad:
        run = jnp.pad(run, (0, pad))
        size = jnp.pad(size, (0, pad))
        live = jnp.pad(live, (0, pad))
    i16 = jnp.arange(16, dtype=jnp.int32)
    oh_r = (run[:, None] == i16).astype(jnp.bfloat16).reshape(
        nseg, seg, 16)
    oh_s = ((size[:, None] == i16) & live[:, None]).astype(
        jnp.bfloat16).reshape(nseg, seg, 16)
    h = jax.lax.dot_general(oh_r, oh_s, (((1,), (1,)), ((0,), (0,))),
                            preferred_element_type=jnp.float32)
    return jnp.sum(h.astype(jnp.int32), axis=0).reshape(256)


def scan_symbol_hist_device(qy: jax.Array, qcb: jax.Array, qcr: jax.Array,
                            padded_h: int, padded_w: int, subsample: bool):
    """Per-class symbol frequencies of the scan — the device analogue of
    the C++ fennec_jpeg_count_symbols (codecs/jpeg.py
    encode_scan_optimized), feeding T.81 K.2 optimal-table construction.

    Returns (dc_freq (2, 16) int32, ac_freq (2, 256) int32) for classes
    [luma, chroma].  One-hot compare-reductions — no scatter.
    """
    layout, total = _scan_layout(padded_h, padded_w, subsample)
    dc_bins = jnp.arange(16, dtype=jnp.int32)
    dc_freq = jnp.zeros((2, 16), jnp.int32)
    ac_freq = jnp.zeros((2, 256), jnp.int32)
    for blocks, (order, inv, _slot), cls in ((qy, layout[0], 0),
                                             (qcb, layout[1], 1),
                                             (qcr, layout[2], 1)):
        s = _symbols(blocks, order, inv)
        dc_h = jnp.sum(s["s_dc"][:, None] == dc_bins, axis=0,
                       dtype=jnp.int32)
        ac_h = _ac_hist_matmul(s["sym"], s["ac_nz"])
        nzrl = jnp.sum(jnp.where(s["ac_nz"], s["zrl"], 0),
                       dtype=jnp.int32)
        neob = jnp.sum(s["has_eob"], dtype=jnp.int32)
        ac_h = ac_h.at[0xF0].add(nzrl).at[0x00].add(neob)
        dc_freq = dc_freq.at[cls].add(dc_h)
        ac_freq = ac_freq.at[cls].add(ac_h)
    return dc_freq, ac_freq


# Per-block local bitstream buffer: 64 words = 2048 bits.  A block never
# exceeds ~1680 bits (DC ≤ 16+11, 63 × AC ≤ 16+10, ZRL runs only replace
# absent coefficients), so 64 gives slack for any legal Huffman spec.
LWORDS = 64

# Optimistic per-block buffer width for the production batch paths.  The
# deposit's masked reductions and the assembly's row windows both scale
# LINEARLY in the buffer width, and real content sits far below the
# legal worst case (a 500² photographic batch at the Balanced target
# measures mean 15 / p99.9 32 / max 44 bits per block — 2 words; 16
# words = 512 bits covers every plausible block).  Callers that pass
# lwords > 0 to emit_scan_device get back an EXACT per-image overflow
# flag (computed from the true block_bits before assembly) and must
# redo flagged images at the safe LWORDS width — so a pathological
# block can never corrupt an output silently.
EMIT_LWORDS = max(2, min(LWORDS, int(os.environ.get(
    "FENNEC_EMIT_LWORDS", "16"))))


def _deposit_local(buf: jax.Array, val, ln, off) -> jax.Array:
    """Deposit big-endian bit fields into per-block local buffers.

    buf: (N, LWORDS) uint32.  val/ln/off: (N,) or (N, F) int32-ish —
    field f of block n occupies local bits [off, off+ln) (ln == 0 →
    absent).  Fields are ≤ 32 bits so each touches at most two words;
    one-hot masks over the word axis turn the deposit into a masked
    reduction over F — elementwise work, no scatter.
    """
    v = jnp.asarray(val).astype(jnp.uint32)
    ln = jnp.asarray(ln).astype(jnp.int32)
    off = jnp.asarray(off).astype(jnp.int32)
    if v.ndim == 1:
        v, ln, off = v[:, None], ln[:, None], off[:, None]
    word = off >> 5
    bit = off & 31
    shift = 32 - bit - ln
    ushift = jnp.clip(shift, 0, 31).astype(jnp.uint32)
    dshift = jnp.clip(-shift, 0, 31).astype(jnp.uint32)
    hi = jnp.where(shift >= 0, v << ushift, v >> dshift)
    lo = v << jnp.clip(32 + shift, 0, 31).astype(jnp.uint32)
    live = ln > 0
    # Buffer width comes from the buffer itself (LWORDS or the caller's
    # optimistic width); fields past the last word find no matching iota
    # and drop harmlessly — emit_scan_device's exact block-bits overflow
    # flag catches the affected image.
    iota = jnp.arange(buf.shape[1], dtype=jnp.int32)
    m1 = (word[:, :, None] == iota) & live[:, :, None]
    m2 = ((word + 1)[:, :, None] == iota) \
        & (live & (shift < 0))[:, :, None]
    buf = buf + jnp.sum(jnp.where(m1, hi[:, :, None], 0), axis=1)
    buf = buf + jnp.sum(jnp.where(m2, lo[:, :, None], 0), axis=1)
    return buf


def _pack_blocks_local(fields, lwords: int = LWORDS) -> jax.Array:
    """Pack every block's symbol fields into its own (lwords,) big-endian
    bit buffer — all blocks and all 64 zigzag positions at once."""
    n = fields["dc_code"].shape[0]
    buf = jnp.zeros((n, lwords), dtype=jnp.uint32)

    # DC: Huffman code and magnitude bits merged into one ≤27-bit field.
    dc_len = fields["dc_clen"] + fields["s_dc"]
    dc_field = (fields["dc_code"] << fields["s_dc"]) | fields["dc_val"]
    buf = _deposit_local(buf, dc_field, dc_len, jnp.zeros_like(dc_len))

    # AC positions: up to three ZRLs (first two merged — 2×16 ≤ 32 bits),
    # then the run/size code with its magnitude bits merged (≤26 bits).
    nz = fields["ac_nz"]
    z = fields["zrl"]
    zl = fields["zrl_len"]
    zc = jnp.asarray(fields["zrl_code"]).astype(jnp.uint32)
    zlu = jnp.asarray(zl).astype(jnp.uint32)
    n01 = jnp.minimum(z, 2)
    len01 = jnp.where(nz, n01 * zl, 0)
    val01 = jnp.where(n01 == 2, (zc << zlu) | zc, zc)
    val01 = jnp.broadcast_to(val01, nz.shape)
    buf = _deposit_local(buf, val01, len01, fields["pos_start"])
    len2 = jnp.where(nz & (z == 3), zl, 0)
    buf = _deposit_local(buf, jnp.broadcast_to(zc, nz.shape), len2,
                         fields["pos_start"] + len01)
    ac_len = jnp.where(nz, fields["ac_clen"] + fields["s_ac"], 0)
    ac_field = (fields["ac_code"] << fields["s_ac"]) | fields["ac_val"]
    buf = _deposit_local(buf, ac_field, ac_len,
                         fields["pos_start"] + z * zl)

    # EOB.
    eob_len = jnp.where(fields["has_eob"], fields["eob_clen"], 0)
    eob = jnp.broadcast_to(
        jnp.asarray(fields["eob_code"]).astype(jnp.uint32), (n,))
    buf = _deposit_local(buf, eob, eob_len, fields["eob_off"])
    return buf


def _rows_sorted(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Gather whole rows of table (T, C) at sorted indices idx (W,).

    Row gathers amortize the per-index gather cost over C contiguous
    elements, and the sorted hint lets XLA skip re-ordering.
    """
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,), start_index_map=(0,))
    return jax.lax.gather(
        table, idx[:, None].astype(jnp.int32), dnums,
        (1, table.shape[1]), indices_are_sorted=True,
        mode=jax.lax.GatherScatterMode.CLIP)


def _grid_align(bufs: jax.Array, block_bits: jax.Array):
    """Shared assembly prologue: funnel-shift every block's local buffer
    so its words align with the GLOBAL 32-bit word grid.

    Returns (s_rows (T, LWORDS+1) uint32, starts, base, last_word)."""
    t = bufs.shape[0]
    starts = jnp.concatenate(
        [jnp.zeros(1, jnp.int32), jnp.cumsum(block_bits)[:-1]])
    sh = (starts & 31).astype(jnp.uint32)[:, None]
    base = starts >> 5
    zero = jnp.zeros((t, 1), jnp.uint32)
    lpad = jnp.concatenate([zero, bufs, zero], axis=1)
    left, right = lpad[:, :-1], lpad[:, 1:]
    s_rows = jnp.where(sh == 0, right,
                       (left << (np.uint32(32) - sh)) | (right >> sh))
    last_word = (starts + block_bits - 1) >> 5
    return s_rows, starts, base, last_word


def _assemble_global_matmul(bufs: jax.Array, block_bits: jax.Array,
                            max_words: int):
    """Assemble the output stream with one matmul — no searchsorted,
    no gather window, no per-candidate loop.

    Output word w receives (a) the first grid-aligned word of every block
    STARTING in w ("starters"), and (b) the continuation word of the one
    block that started earlier and spans w.  Starters sum via a one-hot
    matmul: block bit ranges are disjoint, so within any byte of word w
    the starters' contributions sum to ≤ 255 — each byte column
    accumulates exactly in bf16×f32, and recombining bytes with shifts
    reconstructs the exact uint32 word.  The same matmul's extra
    ones-column counts starters per word, whose exclusive cumsum IS the
    continuation block's index — replacing the old binary search
    (jnp.searchsorted was ~half the assembly cost) with a prefix sum.

    Materializes a (T, max_words) one-hot: callers gate on T*max_words
    (emit_scan_device uses the windowed-gather path above the limit).
    """
    t = bufs.shape[0]
    s_rows, starts, base, last_word = _grid_align(bufs, block_bits)
    total_bits = jnp.sum(block_bits)
    ncol = s_rows.shape[1]
    w = jnp.arange(max_words, dtype=jnp.int32)

    fw = s_rows[:, 0]
    m = jnp.stack([(fw >> 24) & 0xFF, (fw >> 16) & 0xFF,
                   (fw >> 8) & 0xFF, fw & 0xFF,
                   jnp.ones_like(fw)], axis=1).astype(jnp.bfloat16)
    oh = (base[:, None] == w[None, :]).astype(jnp.bfloat16)  # (T, mw)
    sums = jax.lax.dot_general(oh, m, (((0,), (0,)), ((), ())),
                               preferred_element_type=jnp.float32)
    si = sums.astype(jnp.uint32)
    starters = (si[:, 0] << 24) | (si[:, 1] << 16) \
        | (si[:, 2] << 8) | si[:, 3]
    nb = sums[:, 4].astype(jnp.int32)

    # Continuation: the last block with base < w, if it spans word w.
    b0 = jnp.cumsum(nb) - nb - 1  # exclusive starter count - 1
    has = b0 >= 0
    b0c = jnp.clip(b0, 0, t - 1)
    rows = _rows_sorted(s_rows, b0c)  # (mw, ncol)
    aux = jnp.stack([base, last_word], axis=1).astype(jnp.int32)
    ar = _rows_sorted(aux, b0c)
    d0 = jnp.clip(w - ar[:, 0], 0, ncol - 1)
    sel = (d0[:, None]
           == jnp.arange(ncol, dtype=jnp.int32)).astype(jnp.uint32)
    cont = jnp.where(has & (w <= ar[:, 1]),
                     jnp.sum(rows * sel, axis=1), 0)
    return starters + cont, total_bits


# Above this many one-hot elements per image (T blocks × max_words), the
# windowed-gather assembly takes over from the matmul assembly; 1<<27
# bf16 elements = 256 MB.  The cap on the whole vmapped operand comes
# from the device's memory limit (backend.emit_onehot_cap).
_MATMUL_ASSEMBLE_LIMIT = 1 << 27


def _assemble_global(bufs: jax.Array, block_bits: jax.Array,
                     max_words: int, k_window: int = 10):
    """Gather per-block local buffers into the flat output stream.

    bufs: (T, LWORDS) uint32 in SCAN-SLOT order; block_bits: (T,) int32.
    Every block's buffer is first funnel-shifted by its start offset mod
    32 so its words align with the GLOBAL word grid (elementwise — the
    shift is per block).  Output word w then sums column (w - base_b) of
    the ≤k_window candidate blocks overlapping bits [32w, 32w+32) — with
    Annex-K tables a block is ≥ 4 bits, so 10 candidates always cover a
    35-bit reach.  Block bit ranges are disjoint, so add is exact.  All
    lookups are whole-row gathers at sorted indices; the only searchsorted
    runs over the small (T,) block-start table.
    """
    t = bufs.shape[0]
    s_rows, starts, base, last_word = _grid_align(bufs, block_bits)
    total_bits = jnp.sum(block_bits)
    w = jnp.arange(max_words, dtype=jnp.int32)
    first = jnp.searchsorted(starts, w * 32, side="right").astype(
        jnp.int32) - 1
    ncol = s_rows.shape[1]

    # Candidate 0 — the block covering bit 32w — is the only one that
    # reads a data column other than 0 (every later candidate STARTS
    # inside word w).  Fetch its word with one flat gather at strictly
    # increasing indices.
    b0 = jnp.clip(first, 0, t - 1)
    base0 = base[b0]
    d0 = jnp.clip(w - base0, 0, ncol - 1)
    flat = s_rows.reshape(-1)
    v0 = _rows_sorted(flat[:, None], b0 * ncol + d0)[:, 0]
    out = jnp.where(w <= last_word[b0], v0, 0)

    # Candidates 1..k-1: blocks starting inside word w contribute their
    # (already grid-aligned) first word.  Row-gather just the 3 scalars
    # needed per block: first data word, base word, last word.
    aux = jnp.stack([s_rows[:, 0], base.astype(jnp.uint32),
                     last_word.astype(jnp.uint32)], axis=1)
    for k in range(1, k_window):
        b = first + k
        rows = _rows_sorted(aux, jnp.clip(b, 0, t - 1))
        valid = (b < t) & (rows[:, 1].astype(jnp.int32) == w)
        out = out + jnp.where(valid, rows[:, 0], 0)
    return out, total_bits


@functools.lru_cache(maxsize=64)
def _slot_permutation(padded_h: int, padded_w: int, subsample: bool):
    """Static scan-slot → concatenated-raster-row permutation for
    [Y; Cb; Cr] stacked per-component arrays."""
    layout, total = _scan_layout(padded_h, padded_w, subsample)
    perm = np.empty(total, dtype=np.int32)
    base = 0
    for order, inv, raster_slot in layout:
        n = raster_slot.shape[0]
        perm[raster_slot] = np.arange(base, base + n, dtype=np.int32)
        base += n
    return perm


def emit_scan_device(qy: jax.Array, qcb: jax.Array, qcr: jax.Array,
                     padded_h: int, padded_w: int, subsample: bool,
                     max_words: int, dc_tables=None, ac_tables=None,
                     batch_hint: int = 1, lwords: int = 0):
    """Assemble the entropy-coded scan on device.

    Inputs: (N, 64) quantized blocks per component (natural order raster,
    any numeric dtype).  Returns (words uint32 (max_words,), total_bits
    int32) — plus a per-image overflow bool when lwords > 0 (below).
    Caller must size max_words generously (bits never exceed
    26 per coefficient plus per-block overhead; scan_bits_device gives the
    exact count if needed).

    dc_tables/ac_tables: optional traced per-image code tables, shaped
    (2 classes, 2 {codes, lengths}, 16|256) — the device side of per-image
    optimal Huffman.  None → the static Annex-K tables.

    batch_hint: number of images this trace is vmapped over.  The
    matmul-assembly one-hot materializes with the vmap batch factor, so
    the HBM gate must see B·T·max_words, not T·max_words.

    lwords: optimistic per-block buffer width in words (0 → the safe
    LWORDS=64).  When > 0, returns (words, total_bits, ovf) where ovf
    is an EXACT bool — True iff some block's bits exceed lwords·32, in
    which case that image's words are invalid (bits silently dropped)
    and the caller must redo it at the safe width.  block_bits is
    computed from the symbol stream before packing, so the flag never
    misses an overflow.  Real content sits far below the legal
    worst case (see EMIT_LWORDS), making the redo rare while the
    deposit masks and assembly windows shrink by LWORDS/lwords.
    """
    layout, total = _scan_layout(padded_h, padded_w, subsample)
    if dc_tables is None:
        dc_l, ac_l, dc_c, ac_c = _std_code_arrays()
        tables = ((dc_l, ac_l), (dc_c, ac_c), (dc_c, ac_c))
        k_window = 10  # Annex-K: every block is ≥ 4 bits
    else:
        tables = ((dc_tables[0], ac_tables[0]),
                  (dc_tables[1], ac_tables[1]),
                  (dc_tables[1], ac_tables[1]))
        k_window = 17  # optimal tables: blocks can be as short as 2 bits

    lw = lwords if lwords > 0 else LWORDS
    bufs = []
    bits = []
    for blocks, (order, inv, raster_slot), (dct, act) in (
            (qy, layout[0], tables[0]),
            (qcb, layout[1], tables[1]),
            (qcr, layout[2], tables[2])):
        fields = _component_fields(blocks, order, inv, dct, act)
        bufs.append(_pack_blocks_local(fields, lw))
        bits.append(fields["block_bits"])

    perm = jnp.asarray(_slot_permutation(padded_h, padded_w, subsample))
    bits_cat = jnp.concatenate(bits)
    bufs_slot = jnp.concatenate(bufs, axis=0)[perm]
    bits_slot = bits_cat[perm]
    if (total * max_words <= _MATMUL_ASSEMBLE_LIMIT
            and max(1, batch_hint) * total * max_words
            <= emit_onehot_cap()):
        words, total_bits = _assemble_global_matmul(bufs_slot, bits_slot,
                                                    max_words)
    else:
        words, total_bits = _assemble_global(bufs_slot, bits_slot,
                                             max_words, k_window)
    if lwords > 0:
        ovf = jnp.max(bits_cat) > lw * 32
        return words, total_bits, ovf
    return words, total_bits


def finalize_scan_host(words: np.ndarray, total_bits: int) -> bytes:
    """1-pad the final byte, trim, and 0xFF-stuff — pure numpy."""
    nbytes = (int(total_bits) + 7) // 8
    raw = np.ascontiguousarray(words).astype(">u4").tobytes()[:nbytes]
    buf = bytearray(raw)
    rem = int(total_bits) % 8
    if rem:
        buf[-1] |= (1 << (8 - rem)) - 1
    arr = np.frombuffer(bytes(buf), dtype=np.uint8)
    ff = np.nonzero(arr == 0xFF)[0]
    if ff.size:
        arr = np.insert(arr, ff + 1, np.uint8(0))
    return arr.tobytes()
