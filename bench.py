#!/usr/bin/env python3
"""Headline benchmark: compress+decompress GB/s per chip, gzip L1, 64KB chunks.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N}

Methodology:

* The corpus is PINNED: fully synthetic, deterministic bytes from a seeded
  generator (eight silesia-like segment classes: text, records, markup,
  binary, logs, ...), sha256 recorded in detail.  Runs compare identical
  bytes; nothing depends on which binaries the image has.
* Device calibration (engine/devcal.py) runs in this process, before the
  timed region, and persists the routing record; the timed region then
  routes each direction to the path that measured faster — exactly what a
  production deployment does.  One process holds the GPU.
* Every rep's routing is ASSERTED from the engine's hw/sw counters and
  reported in detail, and per-rep times ship in detail for variance.
* It needs a GPU: without one it exits non-zero.  The device and the
  card's name and power limit are printed before the result line.

The baseline is the reference's software path — QATzip on a machine without
QAT hardware runs exactly zlib level-1 (reference src/qatzip_sw.c:77-256) —
measured in the same clean process on the same pinned corpus.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import zlib

_SEED = 20260821
_REPO = os.path.dirname(os.path.abspath(__file__))


def build_corpus(target_mb: int = 32) -> bytes:
    """Pinned deterministic corpus approximating silesia's mix.

    Eight ~256KB segment classes tiled round-robin with a 0.5% pointwise
    mutation per tile (so no two 64KB chunks are byte-identical, matching
    silesia's per-chunk diversity, while compressibility per chunk stays in
    the zlib-L1 ~2.4-3.0 band the north star assumes).
    """
    import numpy as np

    rng = np.random.default_rng(_SEED)
    seg_sz = 256 << 10

    def _take(parts, tot=seg_sz):
        a = np.concatenate(parts)
        reps = -(-tot // len(a))
        return np.tile(a, reps)[:tot] if reps > 1 else a[:tot]

    def text_seg():
        # zipf-ish word stream (the dickens/webster role)
        nwords = 4096
        words = [rng.integers(97, 123, rng.integers(2, 12),
                              dtype=np.uint8) for _ in range(nwords)]
        space = np.array([32], np.uint8)
        nl = np.array([10], np.uint8)
        idx = (rng.random(seg_sz // 4) ** 3 * nwords).astype(np.int64)
        parts = []
        for k, i in enumerate(idx):
            parts.append(words[i])
            parts.append(nl if k % 13 == 12 else space)
        return _take(parts)

    def records_seg():
        # CSV-ish numeric records (the sao/nci role)
        rows = []
        base = rng.integers(0, 1000000)
        for r in range(4000):
            rows.append(f"{base + r},{r % 97},{(r * 31) % 1013},"
                        f"item-{r % 50:04d},OK\n".encode())
        return _take([np.frombuffer(b"".join(rows), np.uint8)])

    def markup_seg():
        # XML-ish (the xml role)
        rows = []
        for r in range(3000):
            rows.append(f"<row id=\"{r}\"><v>{(r * 7) % 991}</v>"
                        f"<name>node{r % 211}</name></row>\n".encode())
        return _take([np.frombuffer(b"".join(rows), np.uint8)])

    def binary_seg():
        # executable-like: skewed byte histogram + zero runs (mozilla role)
        raw = rng.integers(0, 256, seg_sz, dtype=np.int64)
        skew = (raw * raw // 256 % 256).astype(np.uint8)
        out = skew.copy()
        starts = rng.integers(0, seg_sz - 64, 2000)
        for s in starts:
            out[s:s + rng.integers(8, 64)] = 0
        return out

    def log_seg():
        rows = []
        t = 1700000000
        for r in range(3000):
            t += int(rng.integers(1, 30))
            lvl = ("INFO", "WARN", "DEBUG")[r % 3]
            rows.append(f"{t} {lvl} svc{r % 17}: request {r} done "
                        f"in {int(rng.integers(1, 500))}us code=200\n".encode())
        return _take([np.frombuffer(b"".join(rows), np.uint8)])

    def b64_seg():
        # base64-ish: printable, high-entropy (hard-to-compress text)
        al = np.frombuffer(
            b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/",
            np.uint8)
        return al[rng.integers(0, 64, seg_sz)]

    def sparse_seg():
        out = np.zeros(seg_sz, np.uint8)
        starts = rng.integers(0, seg_sz - 128, 800)
        for s in starts:
            ln = int(rng.integers(16, 128))
            out[s:s + ln] = rng.integers(0, 256, ln, dtype=np.uint8)
        return out

    def xray_seg():
        # 12-bit sensor samples in 16-bit words (the x-ray role: hard but
        # not incompressible — top nibbles are zero, low bits are noise)
        samples = rng.integers(0, 4096, seg_sz // 2, dtype=np.uint16)
        smooth = samples.astype(np.int32)
        smooth[1:] = (smooth[1:] + smooth[:-1]) // 2
        return smooth.astype(np.uint16).view(np.uint8)[:seg_sz]

    # text double-weighted to match silesia's text-heavy profile
    segs = [text_seg(), records_seg(), text_seg(), markup_seg(),
            binary_seg(), log_seg(), b64_seg(), sparse_seg(), xray_seg()]
    target = target_mb << 20
    ntiles = -(-target // seg_sz)
    out = np.empty(ntiles * seg_sz, np.uint8)
    for t in range(ntiles):
        tile = segs[t % len(segs)].copy()
        # 0.5% pointwise mutation so tiles are not byte-identical
        k = len(tile) // 200
        pos = rng.integers(0, len(tile), k)
        tile[pos] = rng.integers(0, 256, k, dtype=np.uint8)
        out[t * seg_sz:(t + 1) * seg_sz] = tile
    return out[:target].tobytes()


def _card() -> str:
    """The card's name and power limit, read by a child process."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as exc:
        return f"unavailable ({exc})"


def _calibrate(detail: dict) -> dict:
    """Calibrate device vs CPU routing in this process and record what it
    measured; a rate the calibration did not measure reads "not
    measured"."""
    from qatzip_tpu.engine import devcal

    t0 = time.perf_counter()
    rec = devcal.calibrate()
    detail["calibration_s"] = round(time.perf_counter() - t0, 1)
    if "device_error" in rec:
        detail["device_calibration_error"] = rec["device_error"][:300]
    for key, name in (("dev_comp_gbps", "device_comp_GBps"),
                      ("dev_decomp_gbps", "device_decomp_GBps"),
                      ("dev_comp_compute_gbps", "device_comp_compute_GBps"),
                      ("dev_decomp_compute_gbps",
                       "device_decomp_compute_GBps"),
                      ("cpu_comp_gbps", "cpu_comp_GBps")):
        v = rec.get(key)
        detail[name] = round(v, 4) if v else "not measured"
    detail["device_wins"] = [bool(rec.get("comp_device_wins", False)),
                             bool(rec.get("decomp_device_wins", False))]
    return rec


def main() -> None:
    os.environ.setdefault("QATZIP_TPU_LOG_LEVEL", "1")
    sys.path.insert(0, _REPO)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX reports platform {dev.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    card = _card()
    print(f"device: {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}; card: {card}", flush=True)
    detail: dict = {"device": {"platform": dev.platform,
                               "kind": dev.device_kind,
                               "count": len(jax.devices()), "card": card}}
    rec = _calibrate(detail)

    corpus = build_corpus(int(os.environ.get("QZT_BENCH_MB", "32")))
    n = len(corpus)
    detail["corpus_sha256"] = hashlib.sha256(corpus).hexdigest()[:16]
    detail["corpus_bytes"] = n

    import qatzip_tpu as qz
    from qatzip_tpu.constants import QzDataFormat

    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.comp_lvl = 1
    p.common_params.hw_buff_sz = 64 * 1024
    p.data_fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    rc = qz.qz_setup_session_deflate(sess, p)
    assert rc == qz.QZ_OK, rc
    dsess = qz.QzSession()
    qz.qz_setup_session_deflate(dsess, p)

    from qatzip_tpu.engine import core as engine_core

    # warmup: full-corpus round trip compiles/loads both sessions' paths and
    # converges routing strictly before the timed region
    comp_w = qz.qz_compress(sess, corpus).data
    assert qz.qz_decompress(dsess, comp_w).data == corpus

    reps = int(os.environ.get("QZT_BENCH_REPS", "5"))

    def timed_reps(fn):
        times, paths = [], []
        for _ in range(reps):
            hw0, sw0 = (engine_core._engine.hw_requests,
                        engine_core._engine.sw_requests)
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
            dhw = engine_core._engine.hw_requests - hw0
            dsw = engine_core._engine.sw_requests - sw0
            paths.append("hw" if dhw and not dsw else
                         "sw" if dsw and not dhw else "mixed")
        return out, times, paths

    res, t_comp_l, comp_paths = timed_reps(lambda: qz.qz_compress(sess, corpus))
    assert res.rc == qz.QZ_OK
    comp = res.data

    dres, t_dec_l, dec_paths = timed_reps(lambda: qz.qz_decompress(dsess, comp))
    assert dres.rc == qz.QZ_OK and dres.data == corpus

    # routing assertion: every timed rep took exactly the path the
    # calibration selected — a mixed/contrary rep means the number is junk
    want_comp = "hw" if rec.get("comp_device_wins") else "sw"
    want_dec = "hw" if rec.get("decomp_device_wins") else "sw"
    assert all(x == want_comp for x in comp_paths), comp_paths
    assert all(x == want_dec for x in dec_paths), dec_paths

    t_comp = sum(t_comp_l) / reps
    t_decomp = sum(t_dec_l) / reps
    ours = 2 * n / (t_comp + t_decomp) / 1e9

    # baseline: reference software path == zlib L1 with 64KB chunking
    def zlib_compress_chunks(data):
        out = []
        for i in range(0, len(data), 65536):
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            out.append(co.compress(data[i:i + 65536]) + co.flush())
        return out

    zchunks = zlib_compress_chunks(corpus)  # warm
    t0 = time.perf_counter()
    zchunks = zlib_compress_chunks(corpus)
    t_zc = time.perf_counter() - t0
    zout = b"".join(zlib.decompressobj(-15).decompress(c) for c in zchunks)
    t0 = time.perf_counter()
    zout = b"".join(zlib.decompressobj(-15).decompress(c) for c in zchunks)
    t_zd = time.perf_counter() - t0
    assert zout == corpus
    baseline = 2 * n / (t_zc + t_zd) / 1e9

    ratio = n / len(comp)
    zratio = n / sum(len(c) for c in zchunks)

    detail.update({
        "compress_GBps": round(n / t_comp / 1e9, 4),
        "decompress_GBps": round(n / t_decomp / 1e9, 4),
        "comp_rep_s": [round(t, 4) for t in t_comp_l],
        "decomp_rep_s": [round(t, 4) for t in t_dec_l],
        "timed_paths": {"compress": comp_paths, "decompress": dec_paths},
        "reps": reps,
        "ratio": round(ratio, 3),
        "zlib_l1_ratio": round(zratio, 3),
        "baseline_GBps": round(baseline, 4),
    })
    print(json.dumps({
        "metric": "compress+decompress GB/s per host "
                  "(pinned 32MB silesia-like corpus, gzip L1, 64KB chunks, "
                  "calibrated best-path routing; device-path GB/s in detail)",
        "value": round(ours, 4),
        "unit": "GB/s",
        "vs_baseline": round(ours / baseline, 3),
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
