"""Device-side JPEG entropy-size oracle.

Computes the exact Huffman bit count of a baseline scan from quantized
coefficients — entirely on device, vectorized over blocks.  This turns the
target-size engine's size probes (reference targetsize.go:146-166: one full
host encode per bisection step) into pure device arithmetic; the host only
entropy-codes the final winner (and verifies it, since byte-stuffing adds a
data-dependent handful of bytes the bit count cannot know).

Per block (T.81 F.1.2):
  DC: diff vs previous block in MCU scan order → size category s,
      bits = len(dc_code[s]) + s.  The prediction chain is a first
      difference along a static MCU-order permutation — no sequential scan
      needed.
  AC: for each nonzero coefficient at zigzag position p with r zeros since
      the previous nonzero: bits = (r//16)·len(ZRL) + len(ac_code[(r%16,s)])
      + s; plus EOB when the block ends in zeros.  The run lengths come
      from an exclusive cumulative max of nonzero positions — vectorized,
      no loop.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..codecs import tables as std_tables
from .dct import ZIGZAG


def _code_lengths(bits: List[int], values: List[int],
                  size: int) -> np.ndarray:
    """(size,) int32 code lengths per symbol; 0 for absent symbols."""
    out = np.zeros(size, dtype=np.int32)
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[values[k]] = length
            k += 1
    return out


@functools.lru_cache(maxsize=4)
def _length_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
    dc_l = _code_lengths(std_tables.DC_LUMA_BITS,
                         std_tables.DC_LUMA_VALS, 16)
    ac_l = _code_lengths(std_tables.AC_LUMA_BITS,
                         std_tables.AC_LUMA_VALS, 256)
    dc_c = _code_lengths(std_tables.DC_CHROMA_BITS,
                         std_tables.DC_CHROMA_VALS, 16)
    ac_c = _code_lengths(std_tables.AC_CHROMA_BITS,
                         std_tables.AC_CHROMA_VALS, 256)
    return dc_l, ac_l, dc_c, ac_c


@functools.lru_cache(maxsize=256)
def mcu_order(bw: int, bh: int, h: int, v: int) -> np.ndarray:
    """Static permutation: raster block index per MCU-scan position."""
    mx, my = bw // h, bh // v
    order = np.empty(bw * bh, dtype=np.int32)
    k = 0
    for m_y in range(my):
        for m_x in range(mx):
            for dy in range(v):
                for dx in range(h):
                    order[k] = (m_y * v + dy) * bw + (m_x * h + dx)
                    k += 1
    return order


def _bitlen(v: jax.Array) -> jax.Array:
    """Size category: number of magnitude bits of |v| (0 for 0)."""
    a = jnp.abs(v).astype(jnp.int32)
    # |v| <= 2047 for 8-bit baseline JPEG; float log2 is exact at powers
    # of two in this range, but use integer doubling to stay exact anyway.
    bits = jnp.zeros_like(a)
    x = a
    for _ in range(12):  # 2^12 > 2047
        bits = bits + (x > 0).astype(jnp.int32)
        x = x >> 1
    return bits


def _lut1(table: jax.Array, idx: jax.Array) -> jax.Array:
    """Tiny-table lookup as a one-hot f32 dot.  HIGHEST precision: a
    lower one may round the operands (TF32 or bf16) and corrupt values
    wider than their mantissa."""
    s = table.shape[0]
    flat = idx.reshape(-1, 1)
    onehot = (flat == jnp.arange(s, dtype=idx.dtype)).astype(jnp.float32)
    vals = jnp.dot(onehot, table.astype(jnp.float32)[:, None],
                   precision=jax.lax.Precision.HIGHEST)
    return vals[:, 0].astype(jnp.int32).reshape(idx.shape)


def component_scan_bits(qblocks: jax.Array, order: jax.Array,
                        dc_len: jax.Array, ac_len: jax.Array) -> jax.Array:
    """Total scan bits of one component's (N, 64) quantized blocks
    (natural order raster; `order` maps MCU-scan position → raster idx)."""
    zz = qblocks[:, ZIGZAG].astype(jnp.int32)  # (N, 64) zigzag order

    # ── DC: first difference along MCU order ──
    dc = zz[:, 0]
    dc_mcu = dc[order]
    prev = jnp.concatenate([jnp.zeros(1, jnp.int32), dc_mcu[:-1]])
    s_dc = _bitlen(dc_mcu - prev)
    dc_bits = jnp.sum(_lut1(dc_len, s_dc) + s_dc)

    # ── AC: runs from exclusive cummax of nonzero positions ──
    n = zz.shape[0]
    idx = jnp.broadcast_to(jnp.arange(64, dtype=jnp.int32), (n, 64))
    nz = zz != 0
    # Treat position 0 (DC) as "nonzero" so the first AC run counts from 1.
    nz_marked = nz.at[:, 0].set(True)
    marked_idx = jnp.where(nz_marked, idx, 0)
    prev_nz = jax.lax.associative_scan(jnp.maximum, marked_idx, axis=1)
    prev_nz = jnp.concatenate(
        [jnp.zeros((n, 1), jnp.int32), prev_nz[:, :-1]], axis=1)
    gap = idx - prev_nz - 1
    s_ac = _bitlen(zz)
    zrl = gap // 16
    rem = gap - zrl * 16
    sym_bits = _lut1(ac_len, rem * 16 + s_ac) + s_ac + zrl * ac_len[0xF0]
    ac_nz = nz.at[:, 0].set(False)
    ac_bits = jnp.sum(jnp.where(ac_nz, sym_bits, 0))

    # EOB for every block whose last zigzag coefficient is zero.
    eob_bits = jnp.sum(jnp.where(zz[:, 63] == 0, ac_len[0x00], 0))
    return dc_bits + ac_bits + eob_bits


def scan_bits_device(qy: jax.Array, qcb: jax.Array, qcr: jax.Array,
                     padded_h: int, padded_w: int,
                     subsample: bool) -> jax.Array:
    """Exact total entropy-coded bits of a 3-component interleaved scan."""
    dc_l, ac_l, dc_c, ac_c = _length_tables()
    by, bx = padded_h // 8, padded_w // 8
    if subsample:
        cby, cbx = padded_h // 16, padded_w // 16
        y_order = jnp.asarray(mcu_order(bx, by, 2, 2))
    else:
        cby, cbx = by, bx
        y_order = jnp.asarray(mcu_order(bx, by, 1, 1))
    c_order = jnp.asarray(mcu_order(cbx, cby, 1, 1))
    bits = component_scan_bits(qy, y_order, jnp.asarray(dc_l),
                               jnp.asarray(ac_l))
    bits += component_scan_bits(qcb, c_order, jnp.asarray(dc_c),
                                jnp.asarray(ac_c))
    bits += component_scan_bits(qcr, c_order, jnp.asarray(dc_c),
                                jnp.asarray(ac_c))
    return bits


def scan_bytes_estimate(bits: jax.Array) -> jax.Array:
    """ceil(bits/8) — the scan body size before 0xFF byte stuffing."""
    return (bits + 7) // 8


def bits_std_from_hist(dc_freq: jax.Array,
                       ac_freq: jax.Array) -> jax.Array:
    """Exact standard-table scan bits from per-class symbol frequencies
    (ops/jpeg_emit.scan_symbol_hist_device).

    Every emitted field's length is a pure function of its symbol: a DC
    symbol s costs len(dc_code[s]) + s magnitude bits, an AC symbol
    (r, s) costs len(ac_code[rs]) + (rs & 15), and ZRL (0xF0) / EOB
    (0x00) carry no magnitude bits (their low nibble is 0).  So the
    total is one dot product over the (2, 16) + (2, 256) histograms —
    this replaces a full scan_bits_device pass over the coefficients in
    the histogram paths (tests pin equality).

    dc_freq: (..., 2, 16) int; ac_freq: (..., 2, 256) int →
    (...,) int32 total bits.
    """
    dc_l, ac_l, dc_c, ac_c = _length_tables()
    dc_len = jnp.asarray(np.stack([dc_l, dc_c]))           # (2, 16)
    ac_len = jnp.asarray(np.stack([ac_l, ac_c]))           # (2, 256)
    dc_extra = jnp.arange(16, dtype=jnp.int32)
    ac_extra = jnp.arange(256, dtype=jnp.int32) & 15
    dc_bits = jnp.sum(dc_freq * (dc_len + dc_extra), axis=(-2, -1))
    ac_bits = jnp.sum(ac_freq * (ac_len + ac_extra), axis=(-2, -1))
    return (dc_bits + ac_bits).astype(jnp.int32)
