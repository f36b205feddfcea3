"""Device codec adapters: batch chunks into fixed-shape arrays, dispatch the
JAX/Pallas kernels, and unpack results into backend-contract payloads.

This is the device analog of the reference's submit/poll pipeline
(doCompressIn/doCompressOut, src/qatzip.c:1483-1764): chunks are batched into
one device dispatch (32 in-flight requests -> one batch dimension), results
gathered in block order.
"""
from __future__ import annotations

import zlib
from typing import Sequence

import numpy as np

from qatzip_tpu.constants import DataFormatInternal, QzHuffmanHdr
from qatzip_tpu.engine import faults
from qatzip_tpu.engine.backend import CompressedChunk, DecompressedChunk
from qatzip_tpu.engine.health import health
from qatzip_tpu.session import InternalParams


def _stage_chunks(batch, n: int, b: int):
    """Build the [b, n+8] device input for a batch of chunks.

    Fast path (the qz_malloc zero-copy story carried to the device
    boundary): the funnel slices one contiguous request buffer
    (engine/core.py compress_ext), so full batches are a single [b, n]
    numpy VIEW over the original buffer — uploaded with no host staging
    pass at all; the +8 guard bytes are padded on the device.
    Ragged/copied batches fall back to one staged copy.  Returns (dj [b, n+8] device array, lens int32[b] host).
    """
    import jax.numpy as jnp

    lens = np.zeros((b,), np.int32)
    for i, c in enumerate(batch):
        if len(c) > n:
            raise ValueError("chunk exceeds hw_buff_sz")
        lens[i] = len(c)
    if len(batch) == b and all(
            isinstance(c, memoryview) and len(c) == n for c in batch):
        try:
            arrs = [np.frombuffer(c, np.uint8) for c in batch]
            ptr0 = arrs[0].__array_interface__["data"][0]
            if all(a.__array_interface__["data"][0] == ptr0 + i * n
                   for i, a in enumerate(arrs)):
                base = np.frombuffer(memoryview(batch[0].obj).cast("B"),
                                     np.uint8)
                off = ptr0 - base.__array_interface__["data"][0]
                if 0 <= off and off + b * n <= base.size:
                    view = base[off:off + b * n].reshape(b, n)
                    dj = jnp.asarray(view)
                    return (jnp.pad(dj, ((0, 0), (0, 8))),
                            lens)
        except (TypeError, ValueError, BufferError):
            pass
    data = np.zeros((b, n + 8), np.uint8)
    for i, c in enumerate(batch):
        data[i, :len(c)] = np.frombuffer(c, np.uint8)
    return jnp.asarray(data), lens


def _stored_block(chunk: bytes) -> bytes:
    """BFINAL=1 BTYPE=00 stored deflate block(s) for one chunk (host side)."""
    out = bytearray()
    n = len(chunk)
    pos = 0
    while True:
        seg = min(n - pos, 65535)
        last = pos + seg == n
        out.append(0x01 if last else 0x00)
        out += seg.to_bytes(2, "little")
        out += (seg ^ 0xFFFF).to_bytes(2, "little")
        out += chunk[pos:pos + seg]
        pos += seg
        if last:
            break
    return bytes(out)


class DeflateDeviceCodec:
    """Batched deflate-block compressor running on the JAX device."""

    # 4x the reference's NUM_BUFF=32 in-flight requests (internal.h:65):
    # one device dispatch per 8 MB of 64 KB chunks
    MAX_BATCH = 128

    def __init__(self):
        self._cache = {}

    def compress_chunks(self, chunks: Sequence[bytes],
                        params: InternalParams) -> list[CompressedChunk]:
        import os

        if os.environ.get("QATZIP_TPU_ENCODER", "hybrid") == "hybrid":
            return self._compress_hybrid(chunks, params)
        return self._compress_full_device(chunks, params)

    def _compress_hybrid(self, chunks: Sequence[bytes],
                         params: InternalParams) -> list[CompressedChunk]:
        """Hybrid fast path: the device runs the sort-based LZ77 candidate
        search (ops/match_finder.py, the ASIC role) and the native host
        verifies/extends/entropy-codes (qz_deflate_candidates), with
        compressed size <= zlib at the same level.  The reference splits
        work the same way between the ASIC search engine and the driver
        assembly (src/qatzip.c:1483-1764)."""
        import numpy as np

        from qatzip_tpu.native import qzcore as native
        from qatzip_tpu.ops import deflate_encode as de
        from qatzip_tpu.ops import match_finder as mf
        from qatzip_tpu.parallel.shard import local_mesh

        n = params.hw_buff_sz
        depth, _ = de.level_params(params.comp_lvl)
        mesh = local_mesh()
        ndev = mesh.devices.size if mesh is not None else 1
        # Packed candidate D2H (0.75 B/input byte vs 2; the QAT analog
        # returns compressed bytes, ratio x smaller — src/qatzip.c:1610).
        # Exceptions above the side-stream budget degrade to guesses, so
        # packing trades a few % of compressed size for 2.7x less D2H:
        # right on a bandwidth-starved link, wrong on PCIe.  Policy:
        # QATZIP_TPU_PACK=1/0 overrides; otherwise the devcal record's
        # measured winner decides (engine/devcal.py).
        import os as _os

        env_pack = _os.environ.get("QATZIP_TPU_PACK", "")
        if env_pack in ("0", "1"):
            use_packed = env_pack == "1"
        else:
            from qatzip_tpu.engine import devcal as _devcal

            use_packed = bool(_devcal._load().get("pack_wins", False))
        use_packed = use_packed and int(
            _os.environ.get("QATZIP_TPU_MF_STRIDE", "1")) == 1
        # L1/L2 default speed point: stride-2 indexing halves both sorts,
        # and depth 16 + the parser's two-sided neighbour probes keep the
        # ratio >= zlib L1 (2.1198 vs 2.1098 on the pinned corpus).  The
        # packed D2H format keeps stride 1 (its classes assume dense
        # candidates).
        stride_env = _os.environ.get("QATZIP_TPU_MF_STRIDE")
        if use_packed:
            stride = 1
        elif stride_env is not None:
            stride = int(stride_env)
        elif params.comp_lvl <= 2:
            stride = 2
            depth = max(depth, 16)
        else:
            stride = 1

        bsz = self.MAX_BATCH
        if mesh is not None and len(chunks) >= 2 * ndev:
            bsz = max(ndev, (min(len(chunks), self.MAX_BATCH * ndev)
                             // ndev) * ndev)
        else:
            mesh = None

        # submit-all-then-assemble: batch k+1's device dispatch overlaps
        # batch k's host assembly (the doCompressIn/Out overlap)
        pending: list[tuple] = []
        for start in range(0, len(chunks), bsz):
            batch = list(chunks[start:start + bsz])
            try:
                b = 1 if len(batch) == 1 else bsz
                import jax
                import jax.numpy as jnp
                dj, lens = _stage_chunks(batch, n, b)
                lj = jnp.asarray(lens)
                if mesh is not None and b >= ndev:
                    from jax.sharding import NamedSharding, PartitionSpec as P
                    dj = jax.device_put(dj, NamedSharding(mesh, P("block", None)))
                    lj = jax.device_put(lj, NamedSharding(mesh, P("block")))
                faults.check("submit", "compress")
                cand = (mf.find_candidates_packed(dj, lj, depth)
                        if use_packed else
                        mf.find_candidates(dj, lj, depth, stride=stride))
                pending.append((batch, cand))
            except Exception:
                health.record_failure()
                pending.append((batch, None))

        out: list[CompressedChunk] = []
        for batch, cand in pending:
            if cand is None:
                out.extend(_cpu_compress_batch(batch, params))
                continue
            try:
                faults.check("death", "compress")
                cand_np = np.asarray(cand)
            except Exception:
                health.record_failure()
                out.extend(_cpu_compress_batch(batch, params))
                continue
            health.record_success()
            if faults.armed() and faults.should_fire("poison", "compress"):
                # a poisoned candidate array must be HARMLESS: the native
                # parser verifies every candidate by byte compare
                rngp = np.random.default_rng(0)
                cand_np = rngp.integers(
                    0, int(np.iinfo(cand_np.dtype).max) + 1,
                    cand_np.shape).astype(cand_np.dtype)
            # host assembly threads across cores (qz_deflate_candidates
            # releases the GIL and uses thread_local scratch)
            from qatzip_tpu.engine.cpu_backend import _map_chunks

            def assemble(i_c):
                i, c = i_c
                if use_packed:
                    payload = native.deflate_candidates_packed(
                        c, cand_np[i], params.comp_lvl)
                else:
                    payload = native.deflate_candidates(c, cand_np[i],
                                                        params.comp_lvl)
                return CompressedChunk(payload, _chunk_checksum(c, params),
                                       len(c))

            out.extend(_map_chunks(assemble, list(enumerate(batch))))
        return out

    def _compress_full_device(self, chunks: Sequence[bytes],
                              params: InternalParams) -> list[CompressedChunk]:
        from qatzip_tpu.ops import deflate_encode as de

        n = params.hw_buff_sz
        depth, kwords = de.level_params(params.comp_lvl)
        allow_dynamic = params.huffman_hdr == QzHuffmanHdr.QZ_DYNAMIC_HDR
        m_words = de.words_bound(n)

        # Block-DP over the local mesh: a request with enough chunks shards
        # the batch axis over every local device (the reference's instance
        # pool round-robin, src/qatzip.c:363-400, as one SPMD dispatch).
        from qatzip_tpu.parallel.shard import local_mesh

        mesh = local_mesh()
        ndev = mesh.devices.size if mesh is not None else 1
        bsz = self.MAX_BATCH
        if mesh is not None and len(chunks) >= 2 * ndev:
            bsz = max(ndev, (min(len(chunks), self.MAX_BATCH * ndev)
                             // ndev) * ndev)
        else:
            mesh = None

        # Pipelined dispatch (the doCompressIn/doCompressOut overlap,
        # reference src/qatzip.c:1483-1764): JAX async dispatch lets batch
        # k+1 upload/compute while batch k's results transfer back — submit
        # everything, then collect in order.
        import jax.numpy as jnp
        from qatzip_tpu.ops import checksums as cksum

        kind = _checksum_kind(params)
        pending: list[tuple] = []
        for start in range(0, len(chunks), bsz):
            batch = list(chunks[start:start + bsz])
            try:
                b = 1 if len(batch) == 1 else bsz
                dj, lens = _stage_chunks(batch, n, b)
                lj = jnp.asarray(lens)  # one upload for encode + checksum
                words, bits, mode = de.encode_blocks(
                    dj, lj, depth, kwords, allow_dynamic, m_words,
                    mesh=mesh if b >= ndev and mesh is not None else None)
                # checksum fused on device from the same uploaded buffer
                # (the reference HW returns the chunk checksum with each
                # request, src/qatzip.c:1699-1718)
                cks = (cksum.adler32_blocks(dj, lj, n) if kind == "adler32"
                       else cksum.crc32_blocks(dj, lj, n))
                pending.append((batch, words, bits, mode, cks))
            except Exception:
                # mid-request per-batch reroute (compInSWFallback analog,
                # reference src/qatzip_sw.c:697-748): only this batch goes
                # to the CPU; the rest of the request stays on device
                health.record_failure()
                pending.append((batch, None, None, None, None))

        out: list[CompressedChunk] = []
        for batch, words, bits, mode, cks in pending:
            if words is None:
                out.extend(_cpu_compress_batch(batch, params))
                continue
            try:
                words = np.asarray(words)
                bits = np.asarray(bits)
                cks = np.asarray(cks)
            except Exception:
                health.record_failure()
                out.extend(_cpu_compress_batch(batch, params))
                continue
            health.record_success()
            for i, c in enumerate(batch):
                if mode[i] == de.MODE_STORED:
                    payload = _stored_block(c)
                else:
                    nbytes = (int(bits[i]) + 7) // 8
                    payload = words[i].tobytes()[:nbytes]
                out.append(CompressedChunk(payload, int(cks[i]), len(c)))
        return out

    MAX_DECODE_BATCH = 8      # speculative engine rounds
    LOCKSTEP_BATCH = 512      # chunks per inflate_batch call (PI.LANES)

    def decompress_chunks(self, payloads, hints, params):
        """Device inflate with per-chunk CPU failover (the reference's
        decompOutSWFallback behavior, src/qatzip_sw.c:792-846): chunks the
        kernel flags as unprovable are re-inflated with zlib instead of
        failing the whole batch.  The speculative engine fuses chunk
        checksums on the device; the default lockstep engine recomputes
        them on the host over each decoded part (zlib crc32/adler32,
        ~1 GB/s+ — not the decode bottleneck)."""
        import os as _os

        from qatzip_tpu.ops import deflate_decode as dd

        kind = _checksum_kind(params)
        # the lockstep engine decodes up to LANES blocks per device call;
        # feeding it smaller batches idles lanes
        bsz = (self.MAX_DECODE_BATCH
               if _os.environ.get("QATZIP_TPU_INFLATE", "lockstep") == "spec"
               else self.LOCKSTEP_BATCH)
        out: list[DecompressedChunk] = []
        for start in range(0, len(payloads), bsz):
            batch = payloads[start:start + bsz]
            bh = hints[start:start + bsz]
            try:
                faults.check("submit", "decompress")
                ran: list = []
                results = dd.inflate_batch(batch, bh, kind=kind, ran_out=ran)
                faults.check("death", "decompress")
                if ran:
                    # only a round that actually dispatched to the device is
                    # evidence of health; an all-pre-failed batch is not
                    health.record_success()
            except Exception:
                # device dispatch failure: per-batch reroute to the CPU
                # (decompInSWFallback analog, src/qatzip_sw.c:792-846)
                health.record_failure()
                results = [None] * len(batch)
            for payload, hint, r in zip(batch, bh, results):
                if r is None:
                    data, eof = _cpu_inflate(bytes(payload), hint)
                    ckv = _chunk_checksum(data, params)
                else:
                    data, eof, ckv = r
                    if faults.armed() and data and \
                            faults.should_fire("poison", "decompress"):
                        # simulated DMA corruption of decoded output: the
                        # engine's checksum/size verification must catch it
                        bad = bytearray(data)
                        bad[len(bad) // 2] ^= 0x55
                        data = bytes(bad)
                        ckv = None
                    if ckv is None:
                        ckv = _chunk_checksum(data, params)
                    if faults.armed() and \
                            faults.should_fire("checksum", "decompress"):
                        ckv ^= 0xDEAD  # checksum-engine fault, good payload
                out.append(DecompressedChunk(data, ckv, eof))
        return out


class Lz4DeviceCodec:
    """LZ4/LZ4s block compressor: device match-finder (the same LZ77
    sort-based kernel as deflate, with LZ4 parse rules) + native host byte
    assembly.  The reference maps LZ4/LZ4S onto the same HW search engine
    (src/qatzip_utils.c:264-341); here both ride the same K1 kernel."""

    MAX_BATCH = 128

    def compress_chunks(self, chunks: Sequence[bytes],
                        params: InternalParams) -> list[CompressedChunk]:
        import jax.numpy as jnp

        from qatzip_tpu.formats.lz4_fmt import gen_lz4_block_header
        from qatzip_tpu.native import qzcore as native
        from qatzip_tpu.ops import deflate_encode as de

        n = params.hw_buff_sz
        depth, kwords = de.level_params(params.comp_lvl)
        is_lz4s = params.data_fmt == DataFormatInternal.LZ4S_BK
        mode = 1 if is_lz4s else 0
        mini = params.lz4s_mini_match if is_lz4s else 4

        pending: list[tuple] = []
        for start in range(0, len(chunks), self.MAX_BATCH):
            batch = list(chunks[start:start + self.MAX_BATCH])
            try:
                b = 1 if len(batch) == 1 else self.MAX_BATCH
                dj, lens = _stage_chunks(batch, n, b)
                lj = jnp.asarray(lens)
                import os as _os
                faults.check("submit", "compress")
                if _os.environ.get("QATZIP_TPU_ENCODER", "hybrid") == "hybrid":
                    # hybrid: device candidate search (same flagship kernel
                    # as deflate), native LZ4 verify/extend/emit
                    from qatzip_tpu.ops import match_finder as mf

                    rec = ("cand", mf.find_candidates(dj, lj, depth))
                else:
                    rec = ("rec", _lz4_analyze(dj, lj, depth, kwords))
                pending.append((batch, rec))
            except Exception:
                health.record_failure()
                pending.append((batch, None))

        out: list[CompressedChunk] = []
        for batch, rec in pending:
            if rec is None:
                out.extend(_cpu_compress_batch(batch, params))
                continue
            try:
                kind_r, arr = rec
                arr = np.asarray(arr)
            except Exception:
                health.record_failure()
                out.extend(_cpu_compress_batch(batch, params))
                continue
            health.record_success()
            from qatzip_tpu.engine.cpu_backend import _map_chunks

            def assemble(i_c):
                i, c = i_c
                if kind_r == "cand":
                    payload = native.lz4_candidates(c, arr[i, :len(c)],
                                                    mode, mini)
                else:
                    payload = native.lz4_assemble(c, arr[i, :len(c)],
                                                  mode, mini)
                ckv = _chunk_checksum(c, params)
                if is_lz4s:
                    return CompressedChunk(payload, ckv, len(c))
                # LZ4 frame block section with the stored-block escape
                if len(payload) >= len(c):
                    blk = gen_lz4_block_header(len(c), stored=True) + c
                else:
                    blk = gen_lz4_block_header(len(payload),
                                               stored=False) + payload
                return CompressedChunk(blk, ckv, len(c))

            out.extend(_map_chunks(assemble, list(enumerate(batch))))
        return out


    def decompress_chunks(self, payloads, hints, params):
        """Device LZ4/LZ4s decompress (ops/lz4_decode.py): frame-block walk
        on host, batched speculative token decode on device, per-block CPU
        failover for constructs the kernel flags (the decompOutSWFallback
        behavior, reference src/qatzip_sw.c:792-846).  Reference HW LZ4
        decompress: src/qatzip.c:2103-2355."""
        import struct as _struct

        from qatzip_tpu.engine.lz4_block import (lz4_block_decompress,
                                                 lz4s_block_decompress)
        from qatzip_tpu.ops import lz4_decode

        is_lz4s = params.data_fmt == DataFormatInternal.LZ4S_BK
        mini = params.lz4s_mini_match if is_lz4s else None

        # collect every compressed block across the chunk batch; stored
        # frame blocks copy through untouched
        plan = []       # per chunk: list of ("raw", bytes) | ("blk", idx)
        blocks: list[bytes] = []
        for payload in payloads:
            pv = memoryview(payload)
            items = []
            if is_lz4s:
                items.append(("blk", len(blocks)))
                blocks.append(bytes(pv))
            else:
                off = 0
                while off + 4 <= len(pv):
                    (bsz,) = _struct.unpack_from("<I", pv, off)
                    off += 4
                    if bsz == 0:
                        break
                    stored = bool(bsz & 0x80000000)
                    bsz &= 0x7FFFFFFF
                    blk = bytes(pv[off:off + bsz])
                    off += bsz
                    if stored:
                        items.append(("raw", blk))
                    else:
                        items.append(("blk", len(blocks)))
                        blocks.append(blk)
            plan.append(items)

        decoded = []
        ran_device = False
        if blocks:
            try:
                faults.check("submit", "decompress")
                decoded = lz4_decode.decode_blocks(blocks, mini_match=mini)
                ran_device = True
            except Exception:
                health.record_failure()
                decoded = [None] * len(blocks)
        ok_any = any(d is not None for d in decoded)
        if ran_device and ok_any:
            health.record_success()

        out: list[DecompressedChunk] = []
        for payload, hint, items in zip(payloads, hints, plan):
            data = bytearray()
            for kind_i, v in items:
                if kind_i == "raw":
                    data += v
                    continue
                d = decoded[v] if decoded else None
                if d is None:
                    maxo = hint if hint and hint > 0 else 1 << 22
                    d = (lz4s_block_decompress(blocks[v], maxo, mini)
                         if is_lz4s else
                         lz4_block_decompress(blocks[v], maxo))
                data += d
            data = bytes(data)
            out.append(DecompressedChunk(data, _chunk_checksum(data, params),
                                         True))
        return out


def _lz4_analyze(data, lengths, depth: int, kwords: int):
    """Device K1 with LZ4 parse rules; returns packed (mlen<<15|dist)
    per-position records for the host assembler."""
    from qatzip_tpu.ops import deflate_encode as de

    sel, take, mlen, mdist, _f1, _f2 = de.analyze_blocks(
        data, lengths, depth, kwords, lz4_rules=True)
    return (mlen << 15) | mdist


def _cpu_inflate(payload: bytes, hint: int) -> tuple[bytes, bool]:
    do = zlib.decompressobj(-15)
    data = do.decompress(payload) + do.flush()
    return data, do.eof


def _cpu_compress_batch(batch, params) -> list[CompressedChunk]:
    """CPU fallback for one failed device batch (same wire contract)."""
    from qatzip_tpu.engine.cpu_backend import CpuBackend

    return CpuBackend().compress_chunks(batch, params)


def _checksum_kind(params: InternalParams) -> str:
    fmt = params.data_fmt
    if fmt == DataFormatInternal.DEFLATE_ZLIB:
        return "adler32"
    if fmt in (DataFormatInternal.LZ4_FH, DataFormatInternal.LZ4S_BK):
        return "xxh32"
    return "crc32"


def _chunk_checksum(chunk: bytes, params: InternalParams) -> int:
    kind = _checksum_kind(params)
    if kind == "adler32":
        return zlib.adler32(chunk) & 0xFFFFFFFF
    if kind == "xxh32":
        from qatzip_tpu.utils import checksum as _ck
        return _ck.xxh32(chunk, 0)
    return zlib.crc32(chunk) & 0xFFFFFFFF


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def register_all() -> None:
    from qatzip_tpu.ops import registry
    deflate = DeflateDeviceCodec()
    for fmt in (DataFormatInternal.DEFLATE_4B, DataFormatInternal.DEFLATE_GZIP,
                DataFormatInternal.DEFLATE_GZIP_EXT,
                DataFormatInternal.DEFLATE_RAW,
                DataFormatInternal.DEFLATE_ZLIB):
        registry.register(fmt, "compress", deflate)
        registry.register(fmt, "decompress", deflate)
    lz4 = Lz4DeviceCodec()
    registry.register(DataFormatInternal.LZ4_FH, "compress", lz4)
    registry.register(DataFormatInternal.LZ4S_BK, "compress", lz4)
    registry.register(DataFormatInternal.LZ4_FH, "decompress", lz4)
    registry.register(DataFormatInternal.LZ4S_BK, "decompress", lz4)
