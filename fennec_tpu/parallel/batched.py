"""Batched (vmapped) and mesh-sharded compression kernels.

The mega-batch analogue of the reference's CompressBatch worker pool
(batch.go:58-128): a whole size-bucket of images moves through the
SSIM-guided quality search as ONE device program — vmapped bisection, all
images searching in lockstep with per-image convergence state — and the
batch axis shards across chips over a Mesh('data') axis via pjit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine.compress import (
    batched_quality_search_device,
    batched_quality_search_quantize_device,
)
from ..ops.color import luminance_device
from ..ops.ssim import ssim_map_device


# ── Production data-parallel mesh ───────────────────────────────────────
#
# The reference's CompressBatch saturates every core with a goroutine
# worker pool (batch.go:58-128).  Here the fused mega-batch dispatches
# shard over ALL local devices via one Mesh('data') axis: each device
# searches/quantizes/emits its shard of the chunk, no collectives needed
# (images are independent).

def data_mesh():
    """The mesh the production batch engines shard over, or None
    (backend.data_mesh_devices decides).  Single-device backends always
    return None — the unsharded dispatch path is byte-identical and
    avoids shard_map overhead."""
    from ..backend import data_mesh_devices

    devs = data_mesh_devices()
    if devs is None:
        return None
    return Mesh(np.array(devs), ("data",))


_SHARD_CACHE: dict = {}


def shard_data_call(mesh: Mesh, key, fn, *args, replicated: int = 0):
    """Dispatch fn(*args) SPMD over mesh's 'data' axis via jax.shard_map.

    Every arg and every output leaf is a batch-leading array sharded on
    dim 0, except the LAST `replicated` args, which are replicated to
    every device (cross-image side inputs, e.g. the coefficient path's
    flat exception lists).  Batch dim 0 of the sharded args must divide
    by mesh.size (the engines pad chunks accordingly).

    `key` must uniquely identify fn's traced program (name + every
    static argument fn closes over) — the wrapped jit is cached on
    (devices, key) so repeated chunks reuse one program per shape, same
    as the unsharded @jax.jit entry points."""
    nk = (tuple(int(d.id) for d in mesh.devices.flat), key, replicated)
    cached = _SHARD_CACHE.get(nk)
    if cached is None:
        nshard = len(args) - replicated
        in_specs = tuple([P("data")] * nshard + [P()] * replicated)
        cached = jax.jit(jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs, out_specs=P("data"),
            check_vma=False))
        _SHARD_CACHE[nk] = cached
    dsh = NamedSharding(mesh, P("data"))
    rsh = NamedSharding(mesh, P())
    nshard = len(args) - replicated
    put = [jax.device_put(a, dsh if i < nshard else rsh)
           for i, a in enumerate(args)]
    return cached(*put)


@functools.partial(jax.jit, static_argnums=(2,))
def batched_quality_search(imgs: jax.Array, targets: jax.Array,
                           subsample: bool = True):
    """(B, H, W, 4) float32 images + (B,) targets → per-image
    (quality int32, ssim f32, found bool), all on device.  Lockstep
    bisection; each probe scores the whole batch in one program
    (engine/compress._bisect_device_batch)."""
    return batched_quality_search_device(imgs, targets, subsample)


@functools.partial(jax.jit, static_argnums=(2,))
def batched_search_and_quantize(imgs: jax.Array, targets: jax.Array,
                                subsample: bool = True):
    """(B, H, W, 4) images (any dtype; cast on device) + (B,) targets →
    (qualities, ssims, found, packed, fits_int8).

    packed: (B, Ny+2Nc, 64) int16 quantized blocks at each image's winning
    quality — y then cb then cr.  fits_int8: scalar bool, True when every
    coefficient fits int8 (the host may then pull the int8 view instead,
    halving the device→host transfer; see packed_to_int8).

    The full encode-side device work for a bucket in ONE dispatch; the
    host only Huffman-codes the blocks.  uint8 input keeps the
    host→device transfer at 1 byte per channel; 3-channel input (opaque
    images) saves another 25% — alpha is synthesized on device.
    """
    imgs = imgs.astype(jnp.float32)
    if imgs.shape[-1] == 3:
        alpha = jnp.full(imgs.shape[:-1] + (1,), 255.0, dtype=jnp.float32)
        imgs = jnp.concatenate([imgs, alpha], axis=-1)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, subsample)
    fits_int8 = jnp.all(jnp.abs(packed) <= 127)
    return q, s, f, packed, fits_int8


def _pack_search_small(q, s, f, bits_std, dc_freq, ac_freq) -> jax.Array:
    """Trace-time packing of a search's host-visible outputs into ONE
    (B, 548) int32 array (col 0 q, col 1 ssim f32 bits, col 2 found,
    col 3 bits_std, 4:36 dc_freq, 36:548 ac_freq) — each pulled array
    costs a device→host round-trip, so everything the host needs rides
    together.  Decode with split_search_small."""
    b = q.shape[0]
    return jnp.concatenate([
        q.astype(jnp.int32)[:, None],
        jax.lax.bitcast_convert_type(
            s.astype(jnp.float32), jnp.int32)[:, None],
        f.astype(jnp.int32)[:, None],
        bits_std.astype(jnp.int32)[:, None],
        dc_freq.reshape(b, -1).astype(jnp.int32),
        ac_freq.reshape(b, -1).astype(jnp.int32)], axis=1)


@functools.partial(jax.jit, static_argnums=(2,))
def batched_search_hist(imgs: jax.Array, targets: jax.Array,
                        subsample: bool = True):
    """Pixel-path analogue of batched_decode_search_hist_i8: images in,
    winning coefficients resident on device + the packed (B, 548) small
    output (split_search_small) with per-class symbol histograms and the
    exact standard-table scan bits.  Stage 2 (batched_emit_custom /
    batched_emit_std) sizes its word buffer from the bit counts — optimal
    tables never exceed the standard-table size, so overflow is
    impossible by construction."""
    from ..ops.jpeg_emit import scan_symbol_hist_device
    from ..ops.jpeg_size import bits_std_from_hist

    imgs = imgs.astype(jnp.float32)
    if imgs.shape[-1] == 3:
        alpha = jnp.full(imgs.shape[:-1] + (1,), 255.0, dtype=jnp.float32)
        imgs = jnp.concatenate([imgs, alpha], axis=-1)
    h, w = imgs.shape[1:3]
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if subsample else ny

    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, subsample)

    def hist_one(p):
        return scan_symbol_hist_device(p[:ny], p[ny:ny + nc],
                                       p[ny + nc:], ph, pw, subsample)

    dc_freq, ac_freq = jax.vmap(hist_one)(packed)
    # The exact standard-table bit count is a dot over the histograms —
    # no separate coefficient pass (ops/jpeg_size.bits_std_from_hist).
    bits_std = bits_std_from_hist(dc_freq, ac_freq)
    return _pack_search_small(q, s, f, bits_std, dc_freq, ac_freq), packed


def _split_yuv420_wire(buf: jax.Array, h: int, w: int):
    """Unpack the flat uint8 YCbCr 4:2:0 wire (B, ph·pw + 2·(ph/2)·(pw/2))
    into (y (B, ph, pw), cb, cr (B, ph/2, pw/2)) planes."""
    b = buf.shape[0]
    ph, pw = h + (-h) % 16, w + (-w) % 16
    ch, cw = ph // 2, pw // 2
    ny = ph * pw
    nc = ch * cw
    yp = buf[:, :ny].reshape(b, ph, pw)
    cbp = buf[:, ny:ny + nc].reshape(b, ch, cw)
    crp = buf[:, ny + nc:].reshape(b, ch, cw)
    return yp, cbp, crp


@functools.partial(jax.jit, static_argnums=(2, 3))
def batched_search_hist_yuv420(buf: jax.Array, targets: jax.Array,
                               h: int, w: int):
    """batched_search_hist over the halved YCbCr 4:2:0 pixel wire
    (engine/batched.py FENNEC_PIXEL_WIRE): the host ships 1.5 bytes/px
    of already-converted planes instead of 3 bytes/px RGB, halving the
    in-memory path's upload.  Output contract identical to
    batched_search_hist."""
    from ..engine.compress import batched_quality_search_quantize_yuv420
    from ..ops.jpeg_emit import scan_symbol_hist_device
    from ..ops.jpeg_size import bits_std_from_hist

    ph, pw = h + (-h) % 16, w + (-w) % 16
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16)
    yp, cbp, crp = _split_yuv420_wire(buf, h, w)
    q, s, f, packed = batched_quality_search_quantize_yuv420(
        yp, cbp, crp, targets, h, w)

    def hist_one(p):
        return scan_symbol_hist_device(p[:ny], p[ny:ny + nc],
                                       p[ny + nc:], ph, pw, True)

    dc_freq, ac_freq = jax.vmap(hist_one)(packed)
    bits_std = bits_std_from_hist(dc_freq, ac_freq)
    return _pack_search_small(q, s, f, bits_std, dc_freq, ac_freq), packed


@functools.partial(jax.jit, static_argnums=(2, 3))
def batched_search_opt_yuv420(buf: jax.Array, targets: jax.Array,
                              h: int, w: int):
    """batched_search_opt over the YCbCr 4:2:0 wire: dispatch 1 of the
    chained fused-opt pixel path (header, resident packed, resident
    device-built K.2 tables)."""
    from ..engine.compress import batched_quality_search_quantize_yuv420

    ph, pw = h + (-h) % 16, w + (-w) % 16
    yp, cbp, crp = _split_yuv420_wire(buf, h, w)
    q, s, f, packed = batched_quality_search_quantize_yuv420(
        yp, cbp, crp, targets, h, w)
    return _search_build_tail(q, s, f, packed, ph, pw, True)


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def packed_hist_bits(packed: jax.Array, h: int, w: int,
                     out_subsample: bool):
    """Symbol histograms + exact standard-table bit count for already-
    quantized packed blocks (B, Ny+2Nc, 64) — stage 1 of device emission
    when the search already ran (single-image path, engine/compress.py).
    Returns ONE (B, 545) int32 array — col 0 bits_std, cols 1:33
    dc_freq, cols 33:545 ac_freq — so the host pays one device→host
    round-trip."""
    from ..ops.jpeg_emit import scan_symbol_hist_device
    from ..ops.jpeg_size import bits_std_from_hist

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    def one(p):
        qy, qcb, qcr = p[:ny], p[ny:ny + nc], p[ny + nc:]
        return scan_symbol_hist_device(qy, qcb, qcr, ph, pw,
                                       out_subsample)

    dcf, acf = jax.vmap(one)(packed)
    b = packed.shape[0]
    return jnp.concatenate([
        bits_std_from_hist(dcf, acf).astype(jnp.int32)[:, None],
        dcf.reshape(b, -1).astype(jnp.int32),
        acf.reshape(b, -1).astype(jnp.int32)], axis=1)


# ── Chained-dispatch optimal-Huffman emission ───────────────────────────
#
# The two-stage optimal path (hist pull → host K.2 build → emit dispatch
# → words pull) pays two device round-trips per chunk.  With the K.2
# builder on device (ops/huffbuild.py, bit-exact vs the host builder)
# the chain becomes: dispatch 1 — search → histograms → table build
# (resident coefficients + resident tables + header out); dispatch 2 —
# custom-table emission fed the RESIDENT handles.  Both dispatches are
# async, so the host never blocks between them: one upload, one guarded
# pull per chunk.  (In a fully fused single program XLA pessimizes the
# emission's one-hot code lookups when the tables are loop-carried
# intermediates instead of program inputs; two programs avoid that.)
#
# Final output layout, (B, OPT_HDR + max_words) uint32:
#   col 0 q | 1 ssim (f32 bits) | 2 found | 3 total emitted bits |
#   4 K.2 overflow flag (codesize > 32 pre-redistribution: redo this
#     image on the host, which raises the identical ValueError) |
#   5:69   DHT BITS lists, (4, 16) table order [dcl, dcc, acl, acc] |
#   69:73  nvals (4,) |
#   73:209 DHT VALS bytes — dcl[16] dcc[16] acl[256] acc[256] = 544
#          bytes packed 4/word |
#   209:   the emitted scan words.

OPT_HDR = 209


def _pack_opt_header(q, s, f, bits, ovf, bits16, vals, nvals):
    b = q.shape[0]
    vals_u8 = jnp.concatenate([
        vals[:, 0, :16], vals[:, 1, :16], vals[:, 2, :],
        vals[:, 3, :]], axis=1).astype(jnp.uint8)  # (B, 544)
    vals_w = jax.lax.bitcast_convert_type(
        vals_u8.reshape(b, 136, 4), jnp.uint32)
    return jnp.concatenate([
        q.astype(jnp.uint32)[:, None],
        jax.lax.bitcast_convert_type(
            s.astype(jnp.float32), jnp.uint32)[:, None],
        f.astype(jnp.uint32)[:, None],
        bits.astype(jnp.uint32)[:, None],
        ovf.astype(jnp.uint32)[:, None],
        bits16.reshape(b, 64).astype(jnp.uint32),
        nvals.astype(jnp.uint32), vals_w], axis=1)


def _search_build_tail(q, s, f, packed, ph: int, pw: int,
                       out_subsample: bool):
    """Shared tail of every dispatch-1 entry: resident winning
    coefficients → histograms → device K.2 tables → (header with
    bits col 3 zeroed, resident packed, resident tables)."""
    from ..ops.huffbuild import build_tables_device
    from ..ops.jpeg_emit import scan_symbol_hist_device

    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny
    dc_freq, ac_freq = jax.vmap(lambda p: scan_symbol_hist_device(
        p[:ny], p[ny:ny + nc], p[ny + nc:], ph, pw,
        out_subsample))(packed)
    tables, bits16, vals, nvals, ovf = build_tables_device(
        dc_freq, ac_freq)
    hdr = _pack_opt_header(q, s, f, jnp.zeros_like(q), ovf, bits16,
                           vals, nvals)
    return hdr, packed, tables


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def batched_emit_custom_hdr(packed: jax.Array, tables: jax.Array,
                            hdr: jax.Array, h: int, w: int,
                            out_subsample: bool, max_words: int,
                            lwords: int = 0):
    """Dispatch 2 of the chained optimal path: emit the RESIDENT
    coefficients with the RESIDENT device-built tables, splice the total
    bit count into header col 3, and return the single packed
    (B, OPT_HDR + max_words) output (split_opt_header +
    pull-guard layout above).

    lwords > 0 emits at the optimistic per-block width
    (ops/jpeg_emit.EMIT_LWORDS rationale — worst-case 53-words/block
    programs are very large); the EXACT per-image block-overflow flag
    is OR'd into header col 4, the same redo column the K.2 >32-bit
    flag uses, so the existing per-image redo path covers both."""
    from ..ops.jpeg_emit import emit_scan_device

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    def one(p, tabp):
        dcp, acp = tabp[:, :16], tabp[:, 16:]
        dct = jnp.stack([dcp >> 5, dcp & 31], axis=1)
        act = jnp.stack([acp >> 5, acp & 31], axis=1)
        out = emit_scan_device(
            p[:ny], p[ny:ny + nc], p[ny + nc:], ph, pw, out_subsample,
            max_words, dc_tables=dct, ac_tables=act,
            batch_hint=packed.shape[0], lwords=lwords)
        if lwords > 0:
            words, bits, ovf = out
            return words, bits, ovf.astype(jnp.uint32)
        words, bits = out
        return words, bits, jnp.zeros((), jnp.uint32)

    words, bits, bovf = jax.vmap(one)(packed, tables)
    return jnp.concatenate([
        hdr[:, :3], bits.astype(jnp.uint32)[:, None],
        (hdr[:, 4] | bovf)[:, None], hdr[:, 5:],
        words], axis=1)


def split_opt_header(hdr_host: np.ndarray):
    """Host decode of the fused-opt header (B, OPT_HDR) uint32 →
    (q, ssim f32, found, bits int64, overflow, bits16 (B,4,16),
    vals bytes (B,544), nvals (B,4))."""
    b = hdr_host.shape[0]
    q = hdr_host[:, 0].astype(np.int32)
    s = np.ascontiguousarray(hdr_host[:, 1]).view(np.float32)
    f = hdr_host[:, 2] != 0
    bits = hdr_host[:, 3].astype(np.int64)
    ovf = hdr_host[:, 4] != 0
    bits16 = hdr_host[:, 5:69].reshape(b, 4, 16).astype(np.int32)
    nvals = hdr_host[:, 69:73].astype(np.int32)
    vals = np.ascontiguousarray(
        hdr_host[:, 73:209]).view(np.uint8).reshape(b, 544)
    return q, s, f, bits, ovf, bits16, nvals, vals


def specs_from_opt_header(bits16, nvals, vals, j: int):
    """Rebuild the (dc_specs, ac_specs) lists for image j from pulled
    header arrays — the codecs.jpeg._dht_segment_custom input."""
    segs = (vals[j, :16], vals[j, 16:32], vals[j, 32:288],
            vals[j, 288:544])
    dc_specs = [(bits16[j, c].tolist(),
                 segs[c][:nvals[j, c]].tolist()) for c in range(2)]
    ac_specs = [(bits16[j, 2 + c].tolist(),
                 segs[2 + c][:nvals[j, 2 + c]].tolist())
                for c in range(2)]
    return dc_specs, ac_specs


@functools.partial(jax.jit, static_argnums=(2,))
def batched_search_opt(imgs: jax.Array, targets: jax.Array,
                       subsample: bool):
    """Pixel-path dispatch 1 of the chained optimal path: images in →
    (header, resident packed coefficients, resident K.2 tables).  Chase
    with batched_emit_custom_hdr — no host pull in between."""
    imgs = imgs.astype(jnp.float32)
    if imgs.shape[-1] == 3:
        alpha = jnp.full(imgs.shape[:-1] + (1,), 255.0,
                         dtype=jnp.float32)
        imgs = jnp.concatenate([imgs, alpha], axis=-1)
    h, w = imgs.shape[1:3]
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, subsample)
    return _search_build_tail(q, s, f, packed, ph, pw, subsample)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def batched_decode_search_opt_i8(packed_i8: jax.Array,
                                 exc_img: jax.Array, exc_off: jax.Array,
                                 exc_val: jax.Array,
                                 in_qtabs: jax.Array, targets: jax.Array,
                                 h: int, w: int, in_subsample: bool,
                                 out_subsample: bool):
    """Coefficient fast path, dense-i8 upload, dispatch 1 of the
    chained optimal path: decode → search → quantize → histograms →
    device K.2 tables → (header, resident packed, resident tables)."""
    from ..engine.compress import decode_jpeg_image_device

    dense = _i8_zigzag_to_natural(packed_i8, exc_img, exc_off, exc_val)

    mult_in = 16 if in_subsample else 8
    phi, pwi = h + (-h) % mult_in, w + (-w) % mult_in
    nyi = (phi // 8) * (pwi // 8)
    nci = (phi // 16) * (pwi // 16) if in_subsample else nyi

    imgs = jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(dense[:, :nyi], dense[:, nyi:nyi + nci],
                             dense[:, nyi + nci:], in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    return _search_build_tail(q, s, f, packed, ph, pw, out_subsample)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def batched_emit_std(packed: jax.Array, h: int, w: int,
                     out_subsample: bool, max_words: int,
                     lwords: int = 0):
    """Stage 2 with the standard Annex-K tables: emit resident quantized
    coefficients.  Returns (B, max_words+1) uint32 — column 0 is the
    total bit count, columns 1: the big-endian scan words — one array so
    the host pays ONE device→host round-trip (decode with pull_emit_words).
    lwords: optimistic per-block width, overflow flag in col-0 bit 31
    (see batched_emit_custom)."""
    from ..ops.jpeg_emit import emit_scan_device

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    def one(p):
        out = emit_scan_device(
            p[:ny], p[ny:ny + nc], p[ny + nc:], ph, pw, out_subsample,
            max_words, batch_hint=packed.shape[0], lwords=lwords)
        if lwords > 0:
            words, bits, ovf = out
            return words, (bits.astype(jnp.uint32)
                           | (ovf.astype(jnp.uint32) << 31))
        return out

    words, bits = jax.vmap(one)(packed)
    return jnp.concatenate(
        [bits.astype(jnp.uint32)[:, None], words], axis=1)


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def batched_decode_search_quantize(in_y: jax.Array, in_cb: jax.Array,
                                   in_cr: jax.Array, in_qtabs: jax.Array,
                                   h: int, w: int, in_subsample: bool,
                                   out_subsample: bool, *,
                                   targets: jax.Array):
    """JPEG-in → JPEG-out batch core, pixels never leave the device.

    in_y/cb/cr: (B, N, 64) int16 decoded quantized blocks; in_qtabs:
    (B, 2, 64) per-image quant tables.  Each image is reconstructed on
    device, runs the SSIM-guided search, and is re-quantized at its
    winning quality.  Returns (q, ssim, found, packed_out, fits_int8).
    """
    from ..engine.compress import decode_jpeg_image_device

    imgs = jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(in_y, in_cb, in_cr, in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    fits_int8 = jnp.all(jnp.abs(packed) <= 127)
    return q, s, f, packed, fits_int8


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def batched_decode_resize_search_quantize(
        in_y: jax.Array, in_cb: jax.Array, in_cr: jax.Array,
        in_qtabs: jax.Array, h: int, w: int, in_subsample: bool,
        out_subsample: bool, *, resize_wh: jax.Array,
        resize_wv: jax.Array, targets: jax.Array):
    """JPEG-in → Lanczos resize → JPEG-out, all on device.

    Same as batched_decode_search_quantize plus a smart-resize between
    reconstruction and the quality search (weight matrices precomputed on
    host, ops/resize.py)."""
    from ..engine.compress import decode_jpeg_image_device
    from ..ops.resize import lanczos_resize_device

    def dec_one(y, cb, cr, qt):
        img = decode_jpeg_image_device(
            y.astype(jnp.float32), cb.astype(jnp.float32),
            cr.astype(jnp.float32), qt.astype(jnp.float32),
            h, w, in_subsample)
        return lanczos_resize_device(img, resize_wh, resize_wv)

    imgs = jax.vmap(dec_one)(in_y, in_cb, in_cr, in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    fits_int8 = jnp.all(jnp.abs(packed) <= 127)
    return q, s, f, packed, fits_int8


def _scatter_exceptions(flat: jax.Array, exc_img: jax.Array,
                        exc_off: jax.Array, exc_val: jax.Array) -> jax.Array:
    """Write exception values into (B, N) int32 blocks; rows whose image
    index falls outside [0, B) are dropped.  Under the data mesh the
    indices are rebased per shard, so earlier shards' rows arrive
    NEGATIVE: they must be dropped too, not wrapped to the end of this
    shard as numpy-style indexing would."""
    img = jnp.where(exc_img < 0, flat.shape[0], exc_img)
    return flat.at[img, exc_off].set(exc_val.astype(jnp.int32),
                                     mode="drop")


def _i8_zigzag_to_natural(packed_i8: jax.Array, exc_img: jax.Array,
                          exc_off: jax.Array,
                          exc_val: jax.Array) -> jax.Array:
    """(B, NT, K≤64) int8 ZIGZAG-order blocks + sparse exceptions →
    (B, NT, 64) int32 natural-order blocks.

    The upload layout is zigzag-ordered and truncated at the batch's
    maximum nonzero extent (decode_jpeg_to_coefs_i8); reconstruction is
    a zero-pad plus a static column permutation — free under XLA.
    Exceptions are (image, offset-within-image) pairs so both index
    arrays stay int32 even when B·NT·64 exceeds 2^31 (large images ×
    deep chunks); padding rows carry img == B and are dropped.
    """
    from ..ops.dct import ZIGZAG

    b = packed_i8.shape[0]
    k = packed_i8.shape[-1]
    dense = packed_i8.astype(jnp.int32)
    flat = _scatter_exceptions(dense.reshape(b, -1), exc_img, exc_off,
                               exc_val)
    dense = flat.reshape(packed_i8.shape)
    if k < 64:
        dense = jnp.pad(dense, ((0, 0), (0, 0), (0, 64 - k)))
    inv = np.zeros(64, np.int32)
    inv[np.asarray(ZIGZAG)] = np.arange(64, dtype=np.int32)
    return dense[:, :, jnp.asarray(inv)]


def _coo_to_natural(dc: jax.Array, pos: jax.Array, val: jax.Array,
                    exc_img: jax.Array, exc_off: jax.Array,
                    exc_val: jax.Array) -> jax.Array:
    """(B, NT) int8 DC plane + (B, NT, R) (pos, val) AC nonzero pairs +
    sparse exceptions → (B, NT, 64) int32 natural-order blocks.

    The sparse upload format for photographic JPEG inputs: ~92% of
    truncated-extent coefficients are zero, so shipping only the nonzero
    (zigzag position, int8 value) pairs cuts the host→device bytes
    ~2.5× vs the dense int8 layout.  Reconstruction is one
    one-hot bf16 dot per block row — positions within a block are
    distinct, so each output cell receives at most one term (exact);
    |v| > 127 values, overflow beyond R slots, and rare decode quirks
    ride the (image, offset) exception lists, scattered after the dense
    rebuild.  pos == 0 slots are padding (position 0 is the DC plane).
    """
    from ..ops.dct import ZIGZAG

    b, nt, r = pos.shape
    i64 = jnp.arange(64, dtype=jnp.int32)
    oh = (pos.astype(jnp.int32)[..., None] == i64).astype(jnp.bfloat16)
    dense = jax.lax.dot_general(
        val.astype(jnp.bfloat16), oh,
        (((2,), (2,)), ((0, 1), (0, 1))),
        preferred_element_type=jnp.float32).astype(jnp.int32)
    dense = dense.at[:, :, 0].set(dc.astype(jnp.int32))
    flat = _scatter_exceptions(dense.reshape(b, -1), exc_img, exc_off,
                               exc_val)
    dense = flat.reshape(b, nt, 64)
    inv = np.zeros(64, np.int32)
    inv[np.asarray(ZIGZAG)] = np.arange(64, dtype=np.int32)
    return dense[:, :, jnp.asarray(inv)]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def unpack_chunk_coo(buf: jax.Array, b: int, nt: int, r: int, e: int):
    """Split the feeder's SINGLE int32 COO upload back into device
    inputs — the sparse twin of unpack_chunk_buf.

    Byte layout (int8 within the int32 words, see
    engine/batched._prep_chunk_coo): [dc (B·NT) | pos (B·NT·R) |
    val (B·NT·R) | pad to word] then int32 words [qtables (B·128) |
    exc_img (E) | exc_off (E) | exc_val (E) | targets (B, f32 bits)].
    """
    nb = b * nt * (1 + 2 * r)
    w0 = (nb + 3) // 4
    by = jax.lax.bitcast_convert_type(buf[:w0], jnp.int8).reshape(-1)
    dc = by[:b * nt].reshape(b, nt)
    pos = by[b * nt:b * nt * (1 + r)].reshape(b, nt, r)
    val = by[b * nt * (1 + r):nb].reshape(b, nt, r)
    o = w0
    qts = buf[o:o + b * 128].reshape(b, 2, 64)
    o += b * 128
    ej = buf[o:o + e]
    ei = buf[o + e:o + 2 * e]
    ev = buf[o + 2 * e:o + 3 * e]
    o += 3 * e
    targets = jax.lax.bitcast_convert_type(buf[o:o + b], jnp.float32)
    return dc, pos, val, qts, ej, ei, ev, targets


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def unpack_chunk_csr(buf: jax.Array, b: int, nt: int, m: int, e: int):
    """Split the feeder's SINGLE int32 CSR upload back into device
    inputs — the variable-length twin of unpack_chunk_coo.

    Byte layout (int8 within the int32 words, see
    engine/batched._prep_chunk_i8 "csr"): [dc (B·NT) | counts (B·NT) |
    spos (M) | sval (M) | pad to word] then int32 words
    [qtables (B·128) | base (B) | exc_img (E) | exc_off (E) |
    exc_val (E) | targets (B, f32 bits)].
    """
    nb = 2 * b * nt + 2 * m
    w0 = (nb + 3) // 4
    by = jax.lax.bitcast_convert_type(buf[:w0], jnp.int8).reshape(-1)
    dc = by[:b * nt].reshape(b, nt)
    counts = by[b * nt:2 * b * nt].reshape(b, nt)
    spos = by[2 * b * nt:2 * b * nt + m]
    sval = by[2 * b * nt + m:nb]
    o = w0
    qts = buf[o:o + b * 128].reshape(b, 2, 64)
    o += b * 128
    base = buf[o:o + b]
    o += b
    ej = buf[o:o + e]
    ei = buf[o + e:o + 2 * e]
    ev = buf[o + 2 * e:o + 3 * e]
    o += 3 * e
    targets = jax.lax.bitcast_convert_type(buf[o:o + b], jnp.float32)
    return dc, counts, base, spos, sval, qts, ej, ei, ev, targets


def _dense_to_imgs(dense: jax.Array, in_qtabs: jax.Array, h: int, w: int,
                   in_subsample: bool) -> jax.Array:
    """(B, NT, 64) natural-order int blocks + per-image quant tables →
    reconstructed (B, h, w, 4) float32 images (shared input-decode half
    of the coefficient fast-path entries)."""
    from ..engine.compress import decode_jpeg_image_device

    mult_in = 16 if in_subsample else 8
    phi, pwi = h + (-h) % mult_in, w + (-w) % mult_in
    nyi = (phi // 8) * (pwi // 8)
    nci = (phi // 16) * (pwi // 16) if in_subsample else nyi
    in_y = dense[:, :nyi]
    in_cb = dense[:, nyi:nyi + nci]
    in_cr = dense[:, nyi + nci:]
    return jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(in_y, in_cb, in_cr, in_qtabs)


@functools.partial(jax.jit, static_argnums=(8, 9, 10, 11, 12, 13))
def batched_search_coo(dc: jax.Array, pos: jax.Array, val: jax.Array,
                       exc_img: jax.Array, exc_off: jax.Array,
                       exc_val: jax.Array, in_qtabs: jax.Array,
                       targets: jax.Array, h: int, w: int,
                       in_subsample: bool, out_subsample: bool,
                       flavor: str, max_words: int):
    """COO-upload search entry, one jit per static flavor:

    - "hist": returns (packed small (B, 548) int32, resident packed
      coefficients) — stage 1 of optimal-Huffman device emission
      (mirrors batched_decode_search_hist_i8);
    - "emit": returns ONE (B, max_words+4) uint32 array with the
      standard-table scan assembled on device (mirrors
      batched_decode_search_emit_i8);
    - "quant": returns (q, ssim, found, packed, fits_int8) (mirrors
      batched_decode_search_quantize_i8);
    - "opt": returns (header, resident packed, resident K.2 tables) —
      dispatch 1 of the chained optimal path (mirrors
      batched_decode_search_opt_i8; chase with batched_emit_custom_hdr).
    """
    return _sparse_search_body(dc, pos, val, exc_img, exc_off, exc_val,
                               in_qtabs, targets, h, w, in_subsample,
                               out_subsample, flavor, max_words)


def _stream_windows(stream: jax.Array, off: jax.Array, r: int):
    """Gather (len(off), r) windows of a 1-D stream at MONOTONE start
    offsets — the sorted-row-gather idiom (see _rows_sorted): contiguous
    slices amortize the per-index gather cost, and the sorted hint
    skips re-ordering.  CLIP keeps clamped tail reads in bounds; callers
    mask invalid slots by count."""
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,))
    return jax.lax.gather(stream, off[:, None].astype(jnp.int32), dnums,
                          (r,), indices_are_sorted=True,
                          mode=jax.lax.GatherScatterMode.CLIP)


# Blocks per expansion group: one sorted row-gather fetches a whole
# group's pairs (GROUP·rcap ≤ 1024 elements — contiguous, so the gather
# amortizes like the emission assembly's row fetches), and the
# intra-group slot expansion runs as decomposed one-hot dots instead of
# a per-BLOCK window gather (393k 16-element rows at 500²/B=64).
_CSR_GROUP = 64


def _csr_to_slots(counts: jax.Array, base: jax.Array, spos: jax.Array,
                  sval: jax.Array, r_active: int, rcap: int = 16):
    """CSR wire → fixed-slot (B, NT, r_active) (pos, val) int32 arrays.

    counts: (B, NT) per-block AC-nonzero counts (≤ rcap); base: (B,)
    int32 start of each image's pairs in the (M,) global streams;
    spos/sval: (M,) position/value streams ordered by (image, block,
    scan order).  Scatter-free and gather-light: per-image exclusive
    cumsums give every block's stream offset; one sorted row-gather per
    _CSR_GROUP blocks fetches the group's pairs as a contiguous window;
    each block's slots then select window[off_local + r] via one-hot
    dots decomposed over a (32, 32) grid (exact: window values are
    int8-range, each one-hot row selects exactly one element).  Slots
    ≥ count are masked to the pos==0 padding convention of
    _coo_to_natural."""
    b, nt = counts.shape
    g = -(-nt // _CSR_GROUP)
    pad = g * _CSR_GROUP - nt
    cnt = counts.astype(jnp.int32)
    if pad:
        cnt = jnp.pad(cnt, ((0, 0), (0, pad)))
    within = jnp.cumsum(cnt, axis=1) - cnt
    off_g = base.astype(jnp.int32)[:, None] + within
    gstart = off_g[:, ::_CSR_GROUP]                   # (B, g)
    wwidth = _CSR_GROUP * rcap

    def windows(stream):
        s32 = jnp.pad(stream.astype(jnp.int32), (0, wwidth))
        return _stream_windows(s32, gstart.reshape(-1), wwidth)

    wp = windows(spos)
    wv = windows(sval)
    off_local = (off_g - jnp.repeat(gstart, _CSR_GROUP, axis=1)
                 ).reshape(-1, _CSR_GROUP)            # (B·g, GROUP)
    slot = jnp.arange(r_active, dtype=jnp.int32)
    idx = off_local[:, :, None] + slot[None, None, :]
    live = slot[None, None, :] < cnt.reshape(-1, _CSR_GROUP)[:, :, None]
    i32r = jnp.arange(32, dtype=jnp.int32)
    oh_hi = ((idx >> 5)[..., None] == i32r).astype(jnp.bfloat16)
    oh_lo = ((idx & 31)[..., None] == i32r).astype(jnp.bfloat16)

    def expand(w):
        wg = w.reshape(-1, wwidth // 32, 32).astype(jnp.bfloat16)
        t = jnp.einsum("bgrh,bhl->bgrl", oh_hi, wg,
                       preferred_element_type=jnp.float32)
        return jnp.sum(t * oh_lo.astype(jnp.float32),
                       axis=-1).astype(jnp.int32)

    pos = jnp.where(live, expand(wp), 0)
    val = jnp.where(live, expand(wv), 0)
    pos = pos.reshape(b, g * _CSR_GROUP, r_active)[:, :nt]
    val = val.reshape(b, g * _CSR_GROUP, r_active)[:, :nt]
    return pos, val


@functools.partial(jax.jit,
                   static_argnums=(10, 11, 12, 13, 14, 15, 16))
def batched_search_csr(dc: jax.Array, counts: jax.Array,
                       base: jax.Array, spos: jax.Array,
                       sval: jax.Array, exc_img: jax.Array,
                       exc_off: jax.Array, exc_val: jax.Array,
                       in_qtabs: jax.Array, targets: jax.Array,
                       h: int, w: int, in_subsample: bool,
                       out_subsample: bool, flavor: str,
                       max_words: int, r_active: int = 16):
    """CSR-upload search entry (same flavors/returns as
    batched_search_coo).  The wire format ships each block's exact
    nonzero pairs instead of fixed R slots — ~2× fewer upload bytes on
    photographic content (mean ~3 nonzeros/block vs the best fixed
    R≈6); the slot expansion happens on device (_csr_to_slots)."""
    pos, val = _csr_to_slots(counts, base, spos, sval, r_active)
    return _sparse_search_body(dc, pos, val, exc_img, exc_off, exc_val,
                               in_qtabs, targets, h, w, in_subsample,
                               out_subsample, flavor, max_words)


def _sparse_search_body(dc, pos, val, exc_img, exc_off, exc_val,
                        in_qtabs, targets, h: int, w: int,
                        in_subsample: bool, out_subsample: bool,
                        flavor: str, max_words: int):
    """Shared body of the sparse-upload search entries."""
    from ..ops.jpeg_emit import emit_scan_device, scan_symbol_hist_device
    from ..ops.jpeg_size import bits_std_from_hist

    dense = _coo_to_natural(dc, pos, val, exc_img, exc_off, exc_val)
    imgs = _dense_to_imgs(dense, in_qtabs, h, w, in_subsample)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    if flavor == "quant":
        fits_int8 = jnp.all(jnp.abs(packed) <= 127)
        return q, s, f, packed, fits_int8

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    if flavor == "opt":
        return _search_build_tail(q, s, f, packed, ph, pw,
                                  out_subsample)
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny
    if flavor == "emit":
        words, bits = jax.vmap(lambda p: emit_scan_device(
            p[:ny], p[ny:ny + nc], p[ny + nc:],
            ph, pw, out_subsample, max_words,
            batch_hint=packed.shape[0]))(packed)
        return jnp.concatenate([
            q.astype(jnp.uint32)[:, None],
            jax.lax.bitcast_convert_type(
                s.astype(jnp.float32), jnp.uint32)[:, None],
            f.astype(jnp.uint32)[:, None],
            bits.astype(jnp.uint32)[:, None],
            words], axis=1)
    dc_freq, ac_freq = jax.vmap(lambda p: scan_symbol_hist_device(
        p[:ny], p[ny:ny + nc], p[ny + nc:],
        ph, pw, out_subsample))(packed)
    bits_std = bits_std_from_hist(dc_freq, ac_freq)
    return _pack_search_small(q, s, f, bits_std, dc_freq, ac_freq), packed


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def unpack_chunk_buf(buf: jax.Array, b: int, nt: int, k: int, e: int):
    """Split the feeder's SINGLE int32 upload back into the coefficient
    fast path's device inputs — one host→device copy instead of six.

    Layout (int32 words, see engine/batched._prep_chunk_i8):
    [i8 coefficients (B·NT·K/4, bitcast int8) | qtables (B·128) |
     exc_img (E) | exc_off (E) | exc_val (E, widened) |
     targets (B, f32 bits)].  The unpack dispatch is async — it never
    blocks the dispatch thread."""
    n0 = b * nt * k // 4
    i8 = jax.lax.bitcast_convert_type(
        buf[:n0], jnp.int8).reshape(b, nt, k)
    o = n0
    qts = buf[o:o + b * 128].reshape(b, 2, 64)
    o += b * 128
    ej = buf[o:o + e]
    ei = buf[o + e:o + 2 * e]
    ev = buf[o + 2 * e:o + 3 * e]
    o += 3 * e
    targets = jax.lax.bitcast_convert_type(buf[o:o + b], jnp.float32)
    return i8, qts, ej, ei, ev, targets


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def batched_decode_search_quantize_i8(packed_i8: jax.Array,
                                      exc_img: jax.Array,
                                      exc_off: jax.Array,
                                      exc_val: jax.Array,
                                      in_qtabs: jax.Array,
                                      targets: jax.Array,
                                      h: int, w: int, in_subsample: bool,
                                      out_subsample: bool):
    """Compact-upload variant of batched_decode_search_quantize.

    packed_i8: (B, NT, K) int8 zigzag-order input coefficients (y|cb|cr
    concatenated, truncated at the batch's max nonzero extent), with
    |v| > 127 entries zeroed and carried in (exc_img, exc_off, exc_val)
    as (image, offset) pairs into the truncated tensor — typically a
    quarter of the dense int16 host→device bytes.
    """
    dense = _i8_zigzag_to_natural(packed_i8, exc_img, exc_off, exc_val)

    mult = 16 if in_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if in_subsample else ny
    in_y = dense[:, :ny]
    in_cb = dense[:, ny:ny + nc]
    in_cr = dense[:, ny + nc:]

    from ..engine.compress import decode_jpeg_image_device

    imgs = jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(in_y, in_cb, in_cr, in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    fits_int8 = jnp.all(jnp.abs(packed) <= 127)
    return q, s, f, packed, fits_int8


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7, 8))
def batched_decode_search_emit(in_y: jax.Array, in_cb: jax.Array,
                               in_cr: jax.Array, in_qtabs: jax.Array,
                               h: int, w: int, in_subsample: bool,
                               out_subsample: bool, max_words: int, *,
                               targets: jax.Array):
    """JPEG-in → JPEG-out with the entropy bitstream ASSEMBLED ON DEVICE.

    Like batched_decode_search_quantize, but the winning coefficients are
    Huffman-emitted on device (ops/jpeg_emit.py, standard tables) — the
    device→host transfer shrinks to ≈ the size of the output files.
    Returns (q, ssim, found, words (B, max_words) u32, bits (B,) i32).
    """
    from ..engine.compress import decode_jpeg_image_device
    from ..ops.jpeg_emit import emit_scan_device

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    imgs = jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(in_y, in_cb, in_cr, in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    words, bits = jax.vmap(lambda p: emit_scan_device(
        p[:ny], p[ny:ny + nc], p[ny + nc:],
        ph, pw, out_subsample, max_words,
        batch_hint=packed.shape[0]))(packed)
    return q, s, f, words, bits


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9, 10))
def batched_decode_search_emit_i8(packed_i8: jax.Array,
                                  exc_img: jax.Array, exc_off: jax.Array,
                                  exc_val: jax.Array,
                                  in_qtabs: jax.Array, targets: jax.Array,
                                  h: int, w: int, in_subsample: bool,
                                  out_subsample: bool, max_words: int):
    """Compact-upload variant of batched_decode_search_emit: int8 + sparse
    exception coefficients in, device-assembled Huffman bitstream out —
    the transfers in BOTH directions shrink to near the entropy content.
    Returns ONE (B, max_words+4) uint32 array — col 0 q, col 1 ssim
    (f32 bits), col 2 found, col 3 total bits, cols 4: the scan words —
    so the host pays one device→host round-trip (decode with
    split_emit_full)."""
    from ..engine.compress import decode_jpeg_image_device
    from ..ops.jpeg_emit import emit_scan_device

    dense = _i8_zigzag_to_natural(packed_i8, exc_img, exc_off, exc_val)

    mult_in = 16 if in_subsample else 8
    phi, pwi = h + (-h) % mult_in, w + (-w) % mult_in
    nyi = (phi // 8) * (pwi // 8)
    nci = (phi // 16) * (pwi // 16) if in_subsample else nyi
    in_y = dense[:, :nyi]
    in_cb = dense[:, nyi:nyi + nci]
    in_cr = dense[:, nyi + nci:]

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    imgs = jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(in_y, in_cb, in_cr, in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    words, bits = jax.vmap(lambda p: emit_scan_device(
        p[:ny], p[ny:ny + nc], p[ny + nc:],
        ph, pw, out_subsample, max_words,
        batch_hint=packed.shape[0]))(packed)
    return jnp.concatenate([
        q.astype(jnp.uint32)[:, None],
        jax.lax.bitcast_convert_type(
            s.astype(jnp.float32), jnp.uint32)[:, None],
        f.astype(jnp.uint32)[:, None],
        bits.astype(jnp.uint32)[:, None],
        words], axis=1)


def split_emit_full(wb_host: np.ndarray):
    """Host-side decode of batched_decode_search_emit_i8's packed
    output: (q, ssim f32, found bool, bits int64, words (B, W))."""
    q = wb_host[:, 0].astype(np.int32)
    s = np.ascontiguousarray(wb_host[:, 1]).view(np.float32)
    f = wb_host[:, 2] != 0
    bits = wb_host[:, 3].astype(np.int64)
    return q, s, f, bits, wb_host[:, 4:]


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def batched_decode_search_hist_i8(packed_i8: jax.Array,
                                  exc_img: jax.Array, exc_off: jax.Array,
                                  exc_val: jax.Array,
                                  in_qtabs: jax.Array, targets: jax.Array,
                                  h: int, w: int, in_subsample: bool,
                                  out_subsample: bool):
    """Stage 1 of device-side optimal-Huffman encoding: decode + SSIM
    search + quantize + per-class symbol HISTOGRAMS.

    The winning coefficients stay RESIDENT on device (returned as an
    array the caller holds but never downloads); the host-visible
    outputs come back as ONE (B, 548) int32 array — each pulled array
    costs a device→host round-trip, so q/ssim/found/bits_std and the
    (2,16)+(2,256) frequency tables ride together:
    col 0 q, col 1 ssim (f32 bits), col 2 found, col 3 bits_std,
    cols 4:36 dc_freq, cols 36:548 ac_freq.  Decode with
    split_search_small on the host.
    """
    from ..engine.compress import decode_jpeg_image_device
    from ..ops.jpeg_emit import scan_symbol_hist_device
    from ..ops.jpeg_size import bits_std_from_hist

    dense = _i8_zigzag_to_natural(packed_i8, exc_img, exc_off, exc_val)

    mult_in = 16 if in_subsample else 8
    phi, pwi = h + (-h) % mult_in, w + (-w) % mult_in
    nyi = (phi // 8) * (pwi // 8)
    nci = (phi // 16) * (pwi // 16) if in_subsample else nyi
    in_y = dense[:, :nyi]
    in_cb = dense[:, nyi:nyi + nci]
    in_cr = dense[:, nyi + nci:]

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    imgs = jax.vmap(lambda y, cb, cr, qt: decode_jpeg_image_device(
        y.astype(jnp.float32), cb.astype(jnp.float32),
        cr.astype(jnp.float32), qt.astype(jnp.float32),
        h, w, in_subsample))(in_y, in_cb, in_cr, in_qtabs)
    q, s, f, packed = batched_quality_search_quantize_device(
        imgs, targets, out_subsample)
    dc_freq, ac_freq = jax.vmap(lambda p: scan_symbol_hist_device(
        p[:ny], p[ny:ny + nc], p[ny + nc:],
        ph, pw, out_subsample))(packed)
    bits_std = bits_std_from_hist(dc_freq, ac_freq)
    return _pack_search_small(q, s, f, bits_std, dc_freq, ac_freq), packed


def split_search_small(small_host: np.ndarray):
    """Host-side decode of _pack_search_small's (B, 548) int32 array:
    (q, ssim f32, found bool, bits_std, dc_freq (B,2,16), ac_freq
    (B,2,256))."""
    b = small_host.shape[0]
    q = small_host[:, 0]
    s = np.ascontiguousarray(small_host[:, 1]).view(np.float32)
    f = small_host[:, 2] != 0
    bits_std = small_host[:, 3]
    dcf = small_host[:, 4:36].reshape(b, 2, 16)
    acf = small_host[:, 36:548].reshape(b, 2, 256)
    return q, s, f, bits_std, dcf, acf


def pull_emit_words(wb, max_words: int,
                    full_limit_bytes: int = 8 << 20):
    """Pull a batched_emit_* result with minimal device round-trips.

    wb: device (B, max_words+1) uint32 (col 0 = bits, with the
    block-overflow flag in bit 31 when the emit ran at an optimistic
    lwords width).  Small buffers come down in ONE pull; above
    full_limit_bytes the bit counts come first and the word pull is
    sliced to the batch's actual extent (large-input chunks size
    max_words from the input files, which can far exceed the re-encoded
    output).  Returns (words (B, ≤max_words) uint32, bits (B,) int64,
    blk_ovf (B,) bool) — blk_ovf[j] means image j's words are INVALID
    (a block outgrew the optimistic buffer) and it must be re-emitted
    at the safe width."""
    b = wb.shape[0]
    if (max_words + 1) * b * 4 <= full_limit_bytes:
        wb_h = np.asarray(wb)
        raw = wb_h[:, 0].astype(np.int64)
        return wb_h[:, 1:], raw & 0x7FFFFFFF, (raw >> 31) != 0
    raw = np.asarray(wb[:, 0]).astype(np.int64)
    bits = raw & 0x7FFFFFFF
    ovf = (raw >> 31) != 0
    used = min(int(bits.max()) // 32 + 2, max_words)
    return np.asarray(wb[:, 1:1 + used]), bits, ovf


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def batched_emit_custom(packed: jax.Array, tables: jax.Array,
                        h: int, w: int,
                        out_subsample: bool, max_words: int,
                        lwords: int = 0):
    """Stage 2: Huffman-emit resident quantized coefficients with
    per-image code tables.  packed: (B, Ny+2Nc, 64); tables: ONE
    (B, 2, 272) int32 upload per class [luma, chroma] — dc (…, :16) and
    ac (…, 16:) concatenated on the last axis, each entry PACKED as
    code << 5 | length (huffopt.code_tables_batch) — one upload and 4×
    fewer bytes than separate code/length planes.
    Returns (B, max_words+1) uint32 — column 0 is the total bit count,
    columns 1: the scan words (one array → one round-trip; decode with
    pull_emit_words).

    lwords > 0 selects the optimistic per-block buffer width
    (ops/jpeg_emit.EMIT_LWORDS rationale); the per-image block-overflow
    flag rides in bit 31 of column 0 (bit counts are far below 2^31),
    and pull_emit_words strips + returns it.  Overflowed images must be
    redone at lwords=0."""
    from ..ops.jpeg_emit import emit_scan_device

    mult = 16 if out_subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if out_subsample else ny

    def one(p, tabp):
        dcp, acp = tabp[:, :16], tabp[:, 16:]
        dct = jnp.stack([dcp >> 5, dcp & 31], axis=1)  # (2, 2, 16)
        act = jnp.stack([acp >> 5, acp & 31], axis=1)  # (2, 2, 256)
        out = emit_scan_device(
            p[:ny], p[ny:ny + nc], p[ny + nc:], ph, pw, out_subsample,
            max_words, dc_tables=dct, ac_tables=act,
            batch_hint=packed.shape[0], lwords=lwords)
        if lwords > 0:
            words, bits, ovf = out
            return words, (bits.astype(jnp.uint32)
                           | (ovf.astype(jnp.uint32) << 31))
        return out

    words, bits = jax.vmap(one)(packed, tables)
    return jnp.concatenate(
        [bits.astype(jnp.uint32)[:, None], words], axis=1)


@jax.jit
def packed_to_int8(packed: jax.Array) -> jax.Array:
    """Device-side downcast of packed int16 blocks to int8 (caller must
    have checked fits_int8) — halves the device→host transfer."""
    return packed.astype(jnp.int8)


def split_packed(packed_host: np.ndarray, h: int, w: int,
                 subsample: bool):
    """Split a host (B, Ny+2Nc, 64) array into per-image (qy, qcb, qcr)
    views (no copies)."""
    mult = 16 if subsample else 8
    ph, pw = h + (-h) % mult, w + (-w) % mult
    ny = (ph // 8) * (pw // 8)
    nc = (ph // 16) * (pw // 16) if subsample else ny
    qy = packed_host[:, :ny]
    qcb = packed_host[:, ny:ny + nc]
    qcr = packed_host[:, ny + nc:ny + 2 * nc]
    return qy, qcb, qcr, ph, pw


def batched_quality_search_sharded(mesh: Mesh, imgs, targets,
                                   subsample: bool = True):
    """Mesh-sharded batched search: batch axis over the 'data' mesh axis.

    shard_map runs the lockstep bisection per device on its LOCAL shard
    of the batch — the multi-device CompressBatch.
    """
    img_sh = NamedSharding(mesh, P("data"))
    vec_sh = NamedSharding(mesh, P("data"))
    fn = jax.jit(jax.shard_map(
        lambda im, t: batched_quality_search_device(im, t, subsample),
        mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    return fn(jax.device_put(imgs, img_sh), jax.device_put(targets, vec_sh))


def batched_search_emit_sharded(mesh: Mesh, imgs, targets,
                                subsample: bool, max_words: int):
    """Mesh-sharded flagship path: SSIM-guided search + quantize +
    device Huffman emission, batch axis sharded over 'data'.

    One SPMD program via shard_map: every chip searches, quantizes, and
    bit-packs its LOCAL shard of the batch; the host pulls per-image
    (q, ssim, found, words, bits) shards.  No collectives are needed —
    images are independent, so all work stays chip-local (the
    CompressBatch analogue of the reference's per-core worker pool,
    batch.go:58-128)."""
    img_sh = NamedSharding(mesh, P("data"))
    vec_sh = NamedSharding(mesh, P("data"))

    def run(im, t):
        small, packed = batched_search_hist(im, t, subsample)
        wb = batched_emit_std(
            packed, im.shape[1], im.shape[2], subsample, max_words)
        q = small[:, 0]
        s = jax.lax.bitcast_convert_type(small[:, 1], jnp.float32)
        f = small[:, 2].astype(jnp.bool_)
        return q, s, f, wb[:, 1:], wb[:, 0].astype(jnp.int32)

    fn = jax.jit(jax.shard_map(run, mesh=mesh,
                               in_specs=(P("data"), P("data")),
                               out_specs=(P("data"),) * 5,
                               check_vma=False))
    return fn(jax.device_put(imgs, img_sh),
              jax.device_put(targets, vec_sh))


@jax.jit
def batched_ssim(imgs_a: jax.Array, imgs_b: jax.Array) -> jax.Array:
    """Windowed SSIM per batch element: (B, H, W, 4) × 2 → (B,).  XLA
    partitions the window slicing with halo exchange under a spatial
    mesh axis (batched_ssim_sharded)."""
    if imgs_a.shape[1] <= 8 or imgs_a.shape[2] <= 8:
        # Zero window positions (ssim.go:162-164); the jnp window maps
        # would be empty and their mean NaN.
        return jnp.ones((imgs_a.shape[0],), jnp.float32)

    def one(a, b):
        return jnp.mean(ssim_map_device(luminance_device(a),
                                        luminance_device(b)))
    return jax.vmap(one)(imgs_a, imgs_b)


@jax.jit
def _batched_ssim_fast_ds(imgs_a: jax.Array, imgs_b: jax.Array,
                          wh: jax.Array, wv: jax.Array) -> jax.Array:
    """Batched SSIMFast inner with shared device-resident box weights:
    box-downsample + luminance vmapped, then the windowed scorer."""
    from ..ops.resize import box_downsample_device

    def lum_one(im):
        return luminance_device(
            box_downsample_device(im.astype(jnp.float32), wh, wv))

    la = jax.vmap(lum_one)(imgs_a)
    lb = jax.vmap(lum_one)(imgs_b)
    if la.shape[1] <= 8 or la.shape[2] <= 8:
        # Downsample floored at exactly 8px (extreme aspect): zero
        # window positions → 1.0 per image (ssim.go:162-164).
        return jnp.ones((la.shape[0],), jnp.float32)
    return jax.vmap(lambda a, b: jnp.mean(ssim_map_device(a, b)))(la, lb)


@jax.jit
def _batched_pixel_ssim(imgs_a: jax.Array, imgs_b: jax.Array) -> jax.Array:
    from ..ops.ssim import pixel_ssim_device

    return jax.vmap(
        lambda a, b: pixel_ssim_device(a.astype(jnp.float32),
                                       b.astype(jnp.float32))
    )(imgs_a, imgs_b)


@jax.jit
def _batched_pixel_ssim_ds(imgs_a: jax.Array, imgs_b: jax.Array,
                           wh: jax.Array, wv: jax.Array) -> jax.Array:
    from ..ops.resize import box_downsample_device
    from ..ops.ssim import pixel_ssim_device

    def one(a, b):
        da = box_downsample_device(a.astype(jnp.float32), wh, wv)
        db = box_downsample_device(b.astype(jnp.float32), wh, wv)
        return pixel_ssim_device(da, db)

    return jax.vmap(one)(imgs_a, imgs_b)


def batched_ssim_fast(imgs_a, imgs_b) -> np.ndarray:
    """SSIMFast per batch element (reference ssim.go:48-70 semantics,
    512px cap, identical edge-case routing to ops/ssim.py:ssim_fast) in
    ONE device dispatch for the whole batch.  Inputs: (B, H, W, 4) arrays
    sharing dimensions; returns (B,) float64-ish host floats."""
    from ..ops.ssim import ssim_fast_dims

    a = jnp.asarray(imgs_a)
    b = jnp.asarray(imgs_b)
    h, w = int(a.shape[1]), int(a.shape[2])
    new_w, new_h = ssim_fast_dims(w, h)
    if (new_w, new_h) != (w, h):
        from ..ops.resize import box_weights_device

        wh, wv = box_weights_device(w, h, new_w, new_h)
        if new_w < 8 or new_h < 8:
            return np.asarray(_batched_pixel_ssim_ds(a, b, wh, wv))
        return np.asarray(_batched_ssim_fast_ds(a, b, wh, wv))
    if w < 8 or h < 8:
        if w * h == 0:
            return np.ones(a.shape[0])
        return np.asarray(_batched_pixel_ssim(a, b))
    if w <= 8 or h <= 8:
        return np.ones(a.shape[0])  # zero window positions (ssim.go:162-164)
    return np.asarray(batched_ssim(a.astype(jnp.float32),
                                   b.astype(jnp.float32)))


def batched_size_search_sharded(mesh: Mesh, imgs, target_scan_bytes: int,
                                lo0: int, hi0: int):
    """Mesh-sharded target-size quality bisection (strategy S1 of the
    target-size engine): each chip runs the vmapped forward DCT +
    exact-bit-count bisection for its shard of a same-shape bucket —
    the SPMD form of engine/targetsize_batched.py's stage 1.

    imgs: (B, H, W, 4) uint8/float, B divisible by the 'data' axis.
    Returns (best_q (B,) int32, found (B,) bool).
    """
    from ..codecs.jpeg import forward_dct_device
    from ..engine.size_search import size_bisect_traceable

    img_sh = NamedSharding(mesh, P("data"))
    vec_sh = NamedSharding(mesh, P("data"))

    def run(stack):
        h, w = int(stack.shape[1]), int(stack.shape[2])
        ph, pw = h + (-h) % 16, w + (-w) % 16

        def one(im):
            coefs = forward_dct_device(im.astype(jnp.float32), True)
            return size_bisect_traceable(
                coefs, ph, pw, True, jnp.int32(target_scan_bytes),
                jnp.int32(lo0), jnp.int32(hi0))

        return jax.vmap(one)(stack)

    fn = jax.jit(run, in_shardings=(img_sh,),
                 out_shardings=(vec_sh, vec_sh))
    return fn(jax.device_put(jnp.asarray(imgs), img_sh))


def batched_ssim_sharded(mesh: Mesh, imgs_a, imgs_b,
                         spatial: bool = False) -> jax.Array:
    """Mesh-sharded batched SSIM.  With spatial=True the row axis also
    shards over a 'spatial' mesh axis — XLA inserts the halo exchange for
    the 8×8 windows and reduces partial sums across chips (the
    reference's per-worker partial-sum pattern, ssim.go:150-160, done by
    the compiler)."""
    spec = P("data", "spatial", None, None) if spatial \
        else P("data", None, None, None)
    img_sh = NamedSharding(mesh, spec)
    out_sh = NamedSharding(mesh, P("data"))
    fn = jax.jit(batched_ssim, in_shardings=(img_sh, img_sh),
                 out_shardings=out_sh)
    # Pad the batch to a 'data'-axis multiple: device_put of an
    # unpadded batch over data:k raises for B % k != 0 (same padding
    # the batch engine applies to its chunks, engine/batched.py).
    a = jnp.asarray(imgs_a)
    b = jnp.asarray(imgs_b)
    n = int(a.shape[0])
    k = int(mesh.shape["data"])
    pad = (-n) % k
    if pad:
        reps = [1] * a.ndim
        reps[0] = pad
        a = jnp.concatenate([a, jnp.tile(a[:1], reps)], axis=0)
        b = jnp.concatenate([b, jnp.tile(b[:1], reps)], axis=0)
    out = fn(jax.device_put(a, img_sh), jax.device_put(b, img_sh))
    return out[:n] if pad else out


def quality_search_spatial_sharded(mesh: Mesh, img, target: float,
                                   subsample: bool = True):
    """SSIM-guided quality search + winner quantization for ONE image
    with its ROWS sharded over the mesh's 'spatial' axis — the path for
    images whose working set exceeds a single chip's HBM (the
    context-parallel analogue; SURVEY §2 parallelism table).

    The whole search program — forward DCT, per-probe dequant/IDCT/
    upsample/RGB/luminance, box downsample, windowed SSIM — runs as one
    jit with the image row-sharded: XLA's SPMD partitioner inserts the
    8×8-window halo exchanges and the downsample-matmul collectives
    (the compiler-generated twin of the reference's per-worker row
    sharding + partial-sum reduction, ssim.go:84-160).

    img: (H, W, 4); H must split over the 'spatial' axis in multiples
    of 16 (the 4:2:0 MCU height).  Returns (q, ssim, found,
    (qy, qcb, qcr)) with the quantized winner blocks kept sharded over
    'spatial' (block grids are row-major, so block-row bands align with
    row bands).
    """
    from ..engine.compress import quality_search_device
    from ..codecs.jpeg import forward_dct_device, quantize_coefs_device
    from ..ops.dct import all_quality_tables

    n_sp = int(mesh.shape["spatial"])
    h = int(img.shape[0])
    mult = 16 if subsample else 8
    if (h // n_sp) % mult or h % n_sp:
        raise ValueError(
            f"fennec: H={h} must shard over spatial={n_sp} in "
            f"multiples of {mult}")

    img_sh = NamedSharding(mesh, P("spatial", None, None))
    rep = NamedSharding(mesh, P())
    blocks_sh = NamedSharding(mesh, P("spatial", None))

    def run(im, t):
        im = im.astype(jnp.float32)
        q, s, f = quality_search_device(im, t, subsample)
        final_q = jnp.where(f, q, 100)
        coefs = forward_dct_device(im, subsample)  # CSE'd with search
        all_tables = jnp.asarray(all_quality_tables(),
                                 dtype=jnp.float32)
        qtab = jax.lax.dynamic_index_in_dim(all_tables, final_q, axis=0,
                                            keepdims=False)
        qy, qcb, qcr = quantize_coefs_device(coefs, qtab, subsample)
        return q, s, f, qy, qcb, qcr

    fn = jax.jit(run, in_shardings=(img_sh, rep),
                 out_shardings=(rep, rep, rep, blocks_sh, blocks_sh,
                                blocks_sh))
    q, s, f, qy, qcb, qcr = fn(
        jax.device_put(jnp.asarray(img), img_sh),
        jnp.float32(target))
    return q, s, f, (qy, qcb, qcr)
