"""Device capability calibration: measured HW-vs-SW routing policy.

The reference can assume its ASIC beats zlib and routes every eligible
request to it (isQATProcessable, src/qatzip_utils.c:997-1033).  A JAX
device is not that simple: the hybrid paths split work between the device
and host cores, so whether the device path beats the native CPU funnel
depends on the card, the host's cores and the link between them.

Policy, in order of precedence:
  1. env QATZIP_TPU_DEVICE = "1"/"force" (always use device when capable)
     or "0"/"off" (never) — the operator override;
  2. a saved calibration record (written by ``calibrate()``, the bench, or
     the CLI's --calibrate flag) comparing measured device vs CPU GB/s on
     this host: device is used only where it measured faster;
  3. no record: the CPU path (safe default — a user on a badly-attached
     device must never see a 100x regression; reference analog is the
     sw_backup default, include/qatzip.h:617-632).

Latency-sensitive mode (is_sensitive_mode) bypasses this gate: its own
latency matrices probe and adapt per session (chooseLSMPath, reference
src/qatzip.c:287-297).
"""
from __future__ import annotations

import json
import os
import time

_CAL_ENV = "QATZIP_TPU_DEVCAL_PATH"
_FORCE_ENV = "QATZIP_TPU_DEVICE"
_cache: dict | None = None
_cache_path: str | None = None


def _cal_path() -> str:
    p = os.environ.get(_CAL_ENV)
    if p:
        return p
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "qatzip_tpu", "devcal.json")


def _load() -> dict:
    global _cache, _cache_path
    path = _cal_path()
    if _cache is not None and _cache_path == path:
        return _cache
    try:
        with open(path) as f:
            _cache = json.load(f)
    except (OSError, ValueError):
        _cache = {}
    _cache_path = path
    return _cache


def invalidate() -> None:
    global _cache
    _cache = None


import threading as _threading

_autocal_started = False
_autocal_lock = _threading.Lock()


def _maybe_autocalibrate() -> None:
    """Cold-start fix (round 5): with no calibration record the device is
    never used, so a fresh PCIe-attached install silently runs CPU-only
    until someone runs calibrate().  With QATZIP_TPU_AUTOCAL=1 the first
    no-record routing decision spawns ONE background calibration (small
    sample, daemon thread — requests keep routing to the CPU until the
    record lands, so the request path never blocks on kernel compiles).
    Off by default: calibration compiles kernels, which surprises
    short-lived processes."""
    global _autocal_started
    if _autocal_started or os.environ.get("QATZIP_TPU_AUTOCAL", "") != "1":
        return
    with _autocal_lock:
        if _autocal_started:   # two first-requests racing: one calibration
            return
        _autocal_started = True

    def run():
        try:
            calibrate(sample_bytes=2 << 20, save=True)
        except Exception:
            pass

    import threading

    threading.Thread(target=run, name="qz-autocal", daemon=True).start()


def device_allowed(direction) -> bool:
    """Is the device path allowed for this direction under current policy?"""
    force = os.environ.get(_FORCE_ENV, "").lower()
    if force in ("1", "force", "on", "true"):
        return True
    if force in ("0", "off", "false"):
        return False
    cal = _load()
    if not cal:
        _maybe_autocalibrate()
        return False
    from qatzip_tpu.constants import QzDirection

    if direction == QzDirection.QZ_DIR_COMPRESS:
        return bool(cal.get("comp_device_wins", False))
    if direction == QzDirection.QZ_DIR_DECOMPRESS:
        return bool(cal.get("decomp_device_wins", False))
    return bool(cal.get("comp_device_wins", False)) and \
        bool(cal.get("decomp_device_wins", False))


def calibrate(sample_bytes: int = 8 << 20, level: int = 1,
              save: bool = True) -> dict:
    # 8 MB = 128 chunks of 64 KB: one full encoder batch
    """Measure device vs CPU throughput on this host and persist the
    routing record.  Expensive on first run (kernel compiles); meant to be
    invoked explicitly (bench, CLI --calibrate, ops tooling) — never from
    the request path."""
    import numpy as np

    from qatzip_tpu.constants import DataFormatInternal, QzHuffmanHdr
    from qatzip_tpu.engine.cpu_backend import CpuBackend
    from qatzip_tpu.session import InternalParams

    rng = np.random.default_rng(0)
    words = [rng.integers(0, 256, rng.integers(3, 9), dtype=np.uint8)
             for _ in range(64)]
    stream = np.concatenate([words[i] for i in
                             rng.integers(0, 64, sample_bytes // 4)])
    data = stream[:sample_bytes].tobytes()

    p = InternalParams()
    p.comp_lvl = level
    p.data_fmt = DataFormatInternal.DEFLATE_GZIP_EXT
    p.huffman_hdr = QzHuffmanHdr.QZ_DYNAMIC_HDR
    n = p.hw_buff_sz
    chunks = [data[i:i + n] for i in range(0, len(data), n)]

    cpu = CpuBackend()
    rec: dict = {"sample_bytes": sample_bytes, "level": level,
                 "ts": time.time()}

    def timed(fn, *args):
        fn(*args)  # warm (compile)
        t0 = time.perf_counter()
        out = fn(*args)
        return out, sample_bytes / max(time.perf_counter() - t0, 1e-9) / 1e9

    comp_cpu, rec["cpu_comp_gbps"] = timed(cpu.compress_chunks, chunks, p)
    payloads = [c.payload for c in comp_cpu]
    hints = [len(c) for c in chunks]
    _, rec["cpu_decomp_gbps"] = timed(cpu.decompress_chunks, payloads,
                                      hints, p)
    try:
        from qatzip_tpu.ops.device_codecs import DeflateDeviceCodec

        dev = DeflateDeviceCodec()
        # measure both candidate D2H formats; the faster one becomes the
        # recorded default for this host (ops/device_codecs.py policy)
        prior_pack = os.environ.get("QATZIP_TPU_PACK")
        os.environ["QATZIP_TPU_PACK"] = "0"
        try:
            _, rec["dev_comp_gbps"] = timed(dev.compress_chunks, chunks, p)
            os.environ["QATZIP_TPU_PACK"] = "1"
            comp_pk, rec["dev_comp_packed_gbps"] = timed(
                dev.compress_chunks, chunks, p)
        finally:
            if prior_pack is None:
                os.environ.pop("QATZIP_TPU_PACK", None)
            else:
                os.environ["QATZIP_TPU_PACK"] = prior_pack
        rec["dev_comp_raw_gbps"] = rec["dev_comp_gbps"]
        rec["pack_wins"] = (rec["dev_comp_packed_gbps"]
                            > rec["dev_comp_gbps"])
        if rec["pack_wins"]:
            rec["dev_comp_gbps"] = rec["dev_comp_packed_gbps"]
        # decompress: end-to-end, plus the entropy-stage decoder alone on
        # the same recorded inputs
        from qatzip_tpu.ops import deflate_decode as dd
        from qatzip_tpu.ops import pallas_inflate as PI

        _, rec["dev_decomp_gbps"] = timed(dev.decompress_chunks,
                                          payloads, hints, p)
        rounds: list = []
        for i in range(0, len(payloads), dev.LOCKSTEP_BATCH):
            dd.inflate_batch(payloads[i:i + dev.LOCKSTEP_BATCH],
                             hints[i:i + dev.LOCKSTEP_BATCH],
                             rounds_out=rounds)
        if rounds:
            rec["dev_decomp_compute_gbps"] = sample_bytes / max(
                PI.time_rounds(rounds), 1e-9) / 1e9
    except Exception as exc:  # no device / kernel failure -> CPU-only
        rec["device_error"] = repr(exc)
        rec["dev_comp_gbps"] = 0.0
        rec["dev_decomp_gbps"] = 0.0
    # Device compute throughput of the finder alone: the routing decision
    # uses the end-to-end numbers above
    try:
        import jax
        import jax.numpy as jnp

        from qatzip_tpu.ops import match_finder as mf

        B = len(chunks)
        arr = np.zeros((B, n + 8), np.uint8)
        lens = np.zeros((B,), np.int32)
        for i, c in enumerate(chunks):
            arr[i, : len(c)] = np.frombuffer(c, np.uint8)
            lens[i] = len(c)
        dj = jnp.asarray(arr)
        lj = jnp.asarray(lens)
        # the shipped L1 device configuration (stride-2/depth-16 speed
        # point, ops/device_codecs.py)
        jax.block_until_ready(mf.find_candidates(dj, lj, depth=16, stride=2))
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            cand = mf.find_candidates(dj, lj, depth=16, stride=2)
        jax.block_until_ready(cand)
        rec["dev_comp_compute_gbps"] = (
            sample_bytes * reps / (time.perf_counter() - t0) / 1e9)
    except Exception as exc:
        rec["compute_probe_error"] = repr(exc)[:160]
        rec["dev_comp_compute_gbps"] = 0.0
    rec["comp_device_wins"] = rec["dev_comp_gbps"] > rec["cpu_comp_gbps"]
    rec["decomp_device_wins"] = (rec["dev_decomp_gbps"]
                                 > rec["cpu_decomp_gbps"])
    if save:
        path = _cal_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        invalidate()
    return rec
