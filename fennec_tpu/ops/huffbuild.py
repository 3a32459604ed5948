"""Device-side optimal Huffman table construction (ITU T.81 Annex K.2).

Builds per-image length-limited Huffman specs ON DEVICE from the symbol
histograms, bit-exactly matching the host builders
(codecs/huffopt.optimal_spec and the C++ fennec_build_optimal_specs):
the fused batch engine can then search → histogram → build tables →
emit in ONE dispatch, removing the per-chunk histogram pull and the
host table-build round-trip from the pipeline (reference encode loop:
compress.go:44-73; the reference itself has no optimizer — Go stdlib
image/jpeg emits fixed Annex-K tables).

Device formulation of K.2's sequential data structures:

- the two-least-frequent merge loop's linked-list codesize walk
  (huffopt.py `others`) becomes a vectorized GROUP-membership update:
  every symbol carries the index of its current tree root; merging adds
  +1 codesize to both trees' members with two compare-masks and
  relabels the absorbed tree — no pointer chasing;
- all B·4 tables (dc/ac × luma/chroma) advance in LOCKSTEP through one
  `lax.while_loop` whose condition is "any table still has ≥ 2 live
  chains", with per-lane masking — one compiled loop, not B·4;
- DC tables are padded to the AC layout (reserved symbol at index 256
  instead of 16): padding indices have zero frequency so they are never
  selected, and every min/tie-break comparison orders the reserved
  symbol above real symbols exactly as at index 16 — merge-for-merge
  identical to the host builder;
- the K.3 16-bit length redistribution runs its (rare, usually
  zero-trip) inner loops as masked while_loops over the (33,) bits
  vectors;
- canonical code assignment uses the same closed form as
  huffopt.code_tables_batch, with the int32-safe identity
  code_k = pre_k >> (16 - len_k) (each prefix term is a multiple of
  2^(16-len_k) because canonical lengths are nondecreasing);
- symbol→table scatter is a one-hot f32 matmul (packed entries fit 21
  bits < 2^24, exact in f32) instead of a scatter.

Codesize > 32 bits (where the host builder raises ValueError) is
reported per image via an overflow flag; the engine redoes flagged
images on the host path, which raises the identical error.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Plain numpy, NOT jnp: an eager module-level jnp scalar is a committed
# device array, which a traced function would embed as a constant.
_BIG = np.int32(1 << 30)


def _merge_codesizes(freq: jax.Array) -> jax.Array:
    """K.2 merge loop for T tables in lockstep.

    freq: (T, 257) int32 — real symbols in [0, 256), reserved symbol
    (frequency 1) at 256.  Returns codesize (T, 257) int32.
    """
    t, n = freq.shape
    idx = jnp.arange(n, dtype=jnp.int32)

    def live_count(f):
        return jnp.sum((f > 0).astype(jnp.int32), axis=-1)

    def cond(state):
        f, _, _ = state
        return jnp.any(live_count(f) > 1)

    def body(state):
        f, codesize, group = state
        active = live_count(f) > 1  # (T,)
        fm = jnp.where(f > 0, f, _BIG)
        m1 = fm.min(axis=-1, keepdims=True)
        # v1: LARGEST index among the minimum-frequency live chains
        # (huffopt.py:41 tie-break), then v2 over the rest.
        v1 = jnp.where((f == m1) & (f > 0), idx, -1).max(axis=-1)
        not_v1 = idx[None, :] != v1[:, None]
        f2 = jnp.where((f > 0) & not_v1, f, _BIG)
        m2 = f2.min(axis=-1, keepdims=True)
        v2 = jnp.where((f == m2) & (f > 0) & not_v1, idx,
                       -1).max(axis=-1)

        # Finished lanes can select v1/v2 = -1; their updates are masked
        # by `active`, but the gathers must stay in bounds.
        v1 = jnp.maximum(v1, 0)
        v2 = jnp.maximum(v2, 0)
        g1 = jnp.take_along_axis(group, v1[:, None], axis=-1)
        g2 = jnp.take_along_axis(group, v2[:, None], axis=-1)
        in1 = group == g1
        in2 = group == g2
        grow = (in1 | in2) & active[:, None]
        codesize = codesize + grow.astype(jnp.int32)
        group = jnp.where(in2 & active[:, None], g1, group)

        f2v = jnp.take_along_axis(f, v2[:, None], axis=-1)
        is1 = idx[None, :] == v1[:, None]
        is2 = idx[None, :] == v2[:, None]
        f = jnp.where(is1 & active[:, None], f + f2v, f)
        f = jnp.where(is2 & active[:, None], 0, f)
        return f, codesize, group

    codesize0 = jnp.zeros((t, n), jnp.int32)
    group0 = jnp.broadcast_to(idx, (t, n)).astype(jnp.int32)
    _, codesize, _ = jax.lax.while_loop(cond, body,
                                        (freq, codesize0, group0))
    return codesize


def _limit_16(bits33: jax.Array) -> jax.Array:
    """K.2 Figure K.3: redistribute code lengths > 16 and drop the
    reserved symbol's slot.  bits33: (T, 33) int32."""
    idx = jnp.arange(33, dtype=jnp.int32)

    b = bits33
    for i in range(32, 16, -1):
        def cond(b, i=i):
            return jnp.any(b[:, i] > 0)

        def body(b, i=i):
            active = b[:, i] > 0  # (T,)
            j = jnp.where((idx[None, :] <= i - 2) & (b > 0),
                          idx[None, :], -1).max(axis=-1)  # (T,)
            onej = (idx[None, :] == j[:, None]).astype(jnp.int32)
            onej1 = (idx[None, :] == (j + 1)[:, None]).astype(jnp.int32)
            delta = (-2 * (idx[None, :] == i) + (idx[None, :] == i - 1)
                     + 2 * onej1 - onej)
            return jnp.where(active[:, None], b + delta, b)

        b = jax.lax.while_loop(cond, body, b)

    imax = jnp.where((idx[None, :] >= 1) & (idx[None, :] <= 16)
                     & (b > 0), idx[None, :], -1).max(axis=-1)
    b = b - (idx[None, :] == imax[:, None]).astype(jnp.int32)
    return b


def _canonical_packed(bits16: jax.Array, vals: jax.Array,
                      nvals: jax.Array, size: int) -> jax.Array:
    """Packed canonical tables (code << 5 | length) scattered to symbol
    positions — the jnp mirror of huffopt.code_tables_batch.

    bits16 (T, 16), vals (T, 257) canonical-order symbols, nvals (T,).
    Returns (T, size) int32.
    """
    t, v = vals.shape
    k = jnp.arange(v, dtype=jnp.int32)
    cum = jnp.cumsum(bits16, axis=-1)  # (T, 16)
    lens = 1 + jnp.sum(k[None, None, :] >= cum[:, :, None], axis=1,
                       dtype=jnp.int32)  # (T, V)
    valid = k[None, :] < nvals[:, None]
    lens = jnp.where(valid, lens, 0)
    kraft = jnp.where(valid, jnp.int32(1) << (16 - lens), 0)
    pre = jnp.cumsum(kraft, axis=-1) - kraft
    # pre is a multiple of 2^(16-len) (nondecreasing canonical lengths)
    # → exact int32 right shift, no 2^32 intermediate.
    codes = pre >> jnp.where(valid, 16 - lens, 0)
    packed = jnp.where(valid, (codes << 5) | lens, 0)
    # One-hot scatter: packed entries < 2^21 are exact in f32.
    onehot = (vals[:, :, None] == jnp.arange(size, dtype=jnp.int32)
              [None, None, :]) & valid[:, :, None]
    out = jnp.einsum("tv,tvs->ts", packed.astype(jnp.float32),
                     onehot.astype(jnp.float32),
                     precision=jax.lax.Precision.HIGHEST)
    return out.astype(jnp.int32)


def build_tables_device(dc_freq: jax.Array, ac_freq: jax.Array):
    """Per-image optimal Huffman specs + packed code tables, on device.

    dc_freq (B, 2, 16) int32, ac_freq (B, 2, 256) int32 (classes
    [luma, chroma]).  Returns:

    - tables (B, 2, 272) int32 — dc (…, :16) | ac (…, 16:) packed
      entries code << 5 | length, the batched_emit_custom upload format;
    - bits (B, 4, 16) int32 — DHT BITS lists, table order
      [dc-luma, dc-chroma, ac-luma, ac-chroma] (the C builder's);
    - vals (B, 4, 256) int32 — DHT VALS in canonical order, zero-padded;
    - nvals (B, 4) int32;
    - overflow (B,) bool — some code length exceeded 32 bits pre-
      redistribution (host builder raises ValueError; redo on host).
    """
    b = dc_freq.shape[0]
    dcp = jnp.zeros((b, 2, 256), jnp.int32)
    dcp = dcp.at[:, :, :16].set(dc_freq.astype(jnp.int32))
    freq = jnp.stack([dcp[:, 0], dcp[:, 1],
                      ac_freq[:, 0].astype(jnp.int32),
                      ac_freq[:, 1].astype(jnp.int32)], axis=1)
    # Empty classes code symbol 0 (huffopt.py:108-111).
    empty = freq.sum(axis=-1, keepdims=True) == 0
    freq = freq.at[:, :, 0].add(empty[..., 0].astype(jnp.int32))
    freq = jnp.concatenate(
        [freq, jnp.ones((b, 4, 1), jnp.int32)], axis=-1)  # reserved

    codesize = _merge_codesizes(freq.reshape(b * 4, 257))

    overflow = jnp.any((codesize > 32).reshape(b, 4, 257), axis=(1, 2))

    lbins = jnp.arange(33, dtype=jnp.int32)
    cs_clip = jnp.clip(codesize, 0, 32)
    bits33 = jnp.sum(
        (cs_clip[:, :, None] == lbins[None, None, :])
        & (codesize[:, :, None] > 0), axis=1, dtype=jnp.int32)
    bits33 = _limit_16(bits33)
    bits16 = bits33[:, 1:17]

    # Canonical symbol order: (original codesize, symbol), reserved and
    # uncoded symbols sorted to the end (huffopt.py:88-89).
    sym = jnp.arange(257, dtype=jnp.int32)
    real = (sym[None, :] < 256) & (codesize > 0)
    key = jnp.where(real, cs_clip * 256 + sym[None, :], _BIG)
    skey = jnp.sort(key, axis=-1)
    nvals = jnp.sum(real, axis=-1, dtype=jnp.int32)
    vals = jnp.where(jnp.arange(257)[None, :] < nvals[:, None],
                     skey & 255, 0)

    dc_packed = _canonical_packed(
        bits16.reshape(b, 4, 16)[:, :2].reshape(b * 2, 16),
        vals.reshape(b, 4, 257)[:, :2].reshape(b * 2, 257),
        nvals.reshape(b, 4)[:, :2].reshape(b * 2), 16).reshape(b, 2, 16)
    ac_packed = _canonical_packed(
        bits16.reshape(b, 4, 16)[:, 2:].reshape(b * 2, 16),
        vals.reshape(b, 4, 257)[:, 2:].reshape(b * 2, 257),
        nvals.reshape(b, 4)[:, 2:].reshape(b * 2), 256).reshape(b, 2,
                                                                256)
    tables = jnp.concatenate([dc_packed, ac_packed], axis=-1)
    return (tables, bits16.reshape(b, 4, 16),
            vals[:, :256].reshape(b, 4, 256), nvals.reshape(b, 4),
            overflow)
