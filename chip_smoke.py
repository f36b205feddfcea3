#!/usr/bin/env python3
"""Smoke test of the library's main path on one GPU.

Drives qz_compress / qz_decompress through the public API on a gzip-ext,
level-1, 64 KB-chunk session (the bench.py operating point) over the pinned
32 MB bench corpus with the device path forced, and compares each device
kernel of that path with its plain reference:

  1. device report (JAX device, card name and power limit, native library)
  2. compile: one warm pass over every shape the later phases use
  3. finder: one full batch of find_candidates on the GPU and on XLA:CPU,
     required identical (the pipeline is integer-only)
  4. compress through the API: device counters, gzip interop, size vs zlib
  5. decompress: inflate_batch on the device-compressed chunks (no chunk
     may fall back to the CPU), then qz_decompress through the API
  6. LZ4 frame round trip through the API (same finder)
  7. timings: end to end per direction, and device-only finder and decoder

Every phase that fails makes the script exit non-zero.  The last line of
standard output is one JSON object, printed only when every phase passed:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage:
  python3 chip_smoke.py            # one GPU
  python3 chip_smoke.py --four     # only the four-GPU mesh phase
  JAX_PLATFORMS=cpu python3 chip_smoke.py --rehearse-cpu
                                   # tiny CPU run of phases 3-6, never "ok"
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
CHUNK = 64 * 1024
CORPUS_MB = 32
FINDER_BATCH = 128                 # DeflateDeviceCodec.MAX_BATCH
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class SmokeError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def card_lines() -> list[str]:
    """nvidia-smi's name and power limit per card (a child process that
    does not import JAX)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return [f"unavailable ({exc})"]
    lines = r.stdout.strip().splitlines()
    return lines if r.returncode == 0 and lines else \
        [f"unavailable ({r.stderr.strip()[:120]})"]


class CompileClock:
    """Backend compile seconds and count, from JAX's monitoring events."""

    def __init__(self):
        self.seconds = 0.0
        self.count = 0

    def __call__(self, event: str, duration: float, **_kw) -> None:
        if event == COMPILE_EVENT:
            self.seconds += duration
            self.count += 1


def timed(fn, reps: int) -> tuple[list[float], object]:
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return times, out


class Smoke:
    def __init__(self, rehearse: bool):
        import jax

        import qatzip_tpu as qz
        from qatzip_tpu.engine import core
        from qatzip_tpu.engine.health import health

        self.jax, self.qz, self.core, self.health = jax, qz, core, health
        self.rehearse = rehearse
        self.card = card_lines()
        self.clock = CompileClock()
        jax.monitoring.register_event_duration_secs_listener(self.clock)

    # -- helpers -----------------------------------------------------------
    def session(self):
        from qatzip_tpu.constants import QzDataFormat

        qz = self.qz
        sess = qz.QzSession()
        p = qz.QzSessionParamsDeflate()
        p.common_params.comp_lvl = 1
        p.common_params.hw_buff_sz = CHUNK
        p.data_fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
        check(qz.qz_setup_session_deflate(sess, p) == qz.QZ_OK,
              "session setup failed")
        return sess

    def on_device(self, what: str, fn):
        """Run fn; require that the device served it: hw_requests rose,
        sw_requests and device failures did not."""
        eng = self.core.engine()
        hw0, sw0 = eng.hw_requests, eng.sw_requests
        f0 = self.health.total_failures
        out = fn()
        dhw, dsw = eng.hw_requests - hw0, eng.sw_requests - sw0
        df = self.health.total_failures - f0
        print(f"  {what}: hw_requests +{dhw}, sw_requests +{dsw}, "
              f"device failures +{df}")
        check(dhw > 0 and dsw == 0 and df == 0,
              f"{what} did not run on the device")
        return out

    def api(self, op, sess, data):
        res = op(sess, data)
        check(res.rc == self.qz.QZ_OK, f"{op.__name__} rc={res.rc}")
        return res.data

    # -- phases ------------------------------------------------------------
    def report(self, count: int) -> None:
        jax = self.jax
        devs = jax.devices()
        print(f"jax {jax.__version__}: platform={devs[0].platform} "
              f"kind={devs[0].device_kind} count={len(devs)}")
        for line in self.card:
            print(f"card: {line}")
        try:
            from qatzip_tpu.native import qzcore
        except ImportError as exc:
            raise SmokeError(f"libqzcore.so was not built: {exc}") from exc
        print(f"native: {qzcore._path}")
        check(len(devs) >= count, f"need {count} devices, have {len(devs)}")
        sess = self.session()
        eng = self.core.engine()
        print(f"engine: hw_present={eng.hw_present} platform={eng.platform} "
              f"devices={eng.num_devices}")
        check(eng.hw_present and eng.platform == devs[0].platform,
              "engine did not discover the device")
        del sess

    def compile_all(self, corpus: bytes) -> None:
        qz = self.qz
        t0 = time.perf_counter()
        sess = self.session()
        comp = self.api(qz.qz_compress, sess, corpus)
        self.api(qz.qz_decompress, self.session(), comp)
        lz = qz.compress(corpus, "lz4", hw_buff_sz=CHUNK)
        qz.decompress(lz, "lz4", hw_buff_sz=CHUNK)
        self.finder_inputs(corpus)
        self.jax.block_until_ready(self.find(self.dev_args))
        print(f"  set-up: {self.clock.seconds:.3f} s backend compile in "
              f"{self.clock.count} compiles; {time.perf_counter() - t0:.3f} "
              "s wall for the warm pass")

    def finder_inputs(self, corpus: bytes) -> None:
        b = 8 if self.rehearse else FINDER_BATCH
        arr = np.zeros((b, CHUNK + 8), np.uint8)
        arr[:, :CHUNK] = np.frombuffer(corpus[:b * CHUNK],
                                       np.uint8).reshape(b, CHUNK)
        self.finder_host = (arr, np.full((b,), CHUNK, np.int32))
        self.dev_args = tuple(self.jax.device_put(a, self.jax.devices()[0])
                              for a in self.finder_host)

    def find(self, args):
        from qatzip_tpu.ops import match_finder as mf

        # the shipped L1 point (DeflateDeviceCodec._compress_hybrid)
        return mf.find_candidates(*args, depth=16, stride=2)

    def finder_vs_cpu(self) -> None:
        jax = self.jax
        got = np.asarray(self.find(self.dev_args))
        cpu = jax.devices("cpu")[0]
        want = np.asarray(self.find(tuple(jax.device_put(a, cpu)
                                          for a in self.finder_host)))
        diff = int((got != want).sum())
        print(f"  find_candidates {got.shape} on {jax.devices()[0].platform}"
              f" vs XLA:CPU: {diff} differing positions")
        check(diff == 0, "finder differs from the CPU reference")

    def compress(self, corpus: bytes) -> bytes:
        from qatzip_tpu.formats import gzip_fmt

        comp = self.on_device("qz_compress", lambda: self.api(
            self.qz.qz_compress, self.session(), corpus))
        check(gzip.decompress(comp) == corpus, "gzip.decompress mismatch")
        zl = 0
        for i in range(0, len(corpus), CHUNK):
            co = zlib.compressobj(1, zlib.DEFLATED, -15)
            zl += len(co.compress(corpus[i:i + CHUNK]) + co.flush())
        # zlib's raw deflate in the same gzip-ext member framing
        nchunks = -(-len(corpus) // CHUNK)
        zl += nchunks * (gzip_fmt.GZIPEXT_HEADER_SIZE + 8)
        print(f"  compressed {len(corpus)} -> {len(comp)} bytes "
              f"(ratio {len(corpus) / len(comp):.4f}); zlib level 1 on the "
              f"same chunks and framing: {zl} bytes "
              f"(ratio {len(corpus) / zl:.4f})")
        check(len(comp) <= zl, "compressed output larger than zlib level 1")
        return comp

    def decompress(self, corpus: bytes, comp: bytes) -> list:
        from qatzip_tpu.formats import gzip_fmt
        from qatzip_tpu.ops import deflate_decode as dd
        from qatzip_tpu.ops.device_codecs import DeflateDeviceCodec

        payloads, hints = [], []
        pos = 0
        while pos < len(comp):
            ext = gzip_fmt.parse_gzipext_header(comp, pos)
            check(ext is not None, f"no gzip-ext member at {pos}")
            h = pos + gzip_fmt.GZIPEXT_HEADER_SIZE
            payloads.append(comp[h:h + ext.dest_sz])
            hints.append(ext.src_sz)
            pos = h + ext.dest_sz + 8
        rounds: list = []
        step = DeflateDeviceCodec.LOCKSTEP_BATCH
        results = []
        for i in range(0, len(payloads), step):
            results += dd.inflate_batch(payloads[i:i + step],
                                        hints[i:i + step], kind="crc32",
                                        rounds_out=rounds)
        nones = sum(r is None for r in results)
        print(f"  inflate_batch: {len(results)} chunks in {len(rounds)} "
              f"decoder calls, {nones} fell back to the CPU")
        check(nones == 0, "inflate_batch returned None chunks")
        for k, r in enumerate(results):
            chunk = corpus[k * CHUNK:(k + 1) * CHUNK]
            check(r[0] == chunk and r[2] == zlib.crc32(chunk),
                  f"inflate_batch chunk {k} differs")
        out = self.on_device("qz_decompress", lambda: self.api(
            self.qz.qz_decompress, self.session(), comp))
        check(out == corpus, "qz_decompress output differs")
        print("  qz_decompress: bit-exact")
        return rounds

    def lz4(self, corpus: bytes) -> None:
        from qatzip_tpu.ops import lz4_decode

        qz = self.qz
        lz = self.on_device("lz4 compress", lambda: qz.compress(
            corpus, "lz4", hw_buff_sz=CHUNK))
        orig, nones = lz4_decode.decode_blocks, []

        def counting(blocks, mini_match=None):
            r = orig(blocks, mini_match)
            nones.append(sum(x is None for x in r))
            return r

        lz4_decode.decode_blocks = counting
        try:
            out = self.on_device("lz4 decompress", lambda: qz.decompress(
                lz, "lz4", hw_buff_sz=CHUNK))
        finally:
            lz4_decode.decode_blocks = orig
        print(f"  lz4 frame: {len(corpus)} -> {len(lz)} bytes; "
              f"{sum(nones)} blocks fell back to the CPU")
        check(out == corpus, "lz4 round trip differs")
        check(nones and sum(nones) == 0, "lz4 blocks fell back to the CPU")

    def timings(self, corpus: bytes, comp: bytes, rounds: list) -> None:
        from qatzip_tpu.ops import pallas_inflate as PI

        qz, jax = self.qz, self.jax
        n = len(corpus)
        c0 = self.clock.count
        sess, dsess = self.session(), self.session()
        tc, _ = timed(lambda: self.api(qz.qz_compress, sess, corpus), 3)
        td, _ = timed(lambda: self.api(qz.qz_decompress, dsess, comp), 3)
        tf, _ = timed(lambda: jax.block_until_ready(
            self.find(self.dev_args)), 10)
        t_dec = PI.time_rounds(rounds, reps=3)
        fb = self.finder_host[0].shape[0] * CHUNK
        card = "; ".join(self.card)
        print(f"  [{card}] compress end to end: "
              f"{n / np.median(tc) / 1e9:.4f} GB/s "
              f"(reps {[round(t, 4) for t in tc]} s)")
        print(f"  [{card}] decompress end to end: "
              f"{n / np.median(td) / 1e9:.4f} GB/s "
              f"(reps {[round(t, 4) for t in td]} s)")
        print(f"  [{card}] find_candidates device-only: "
              f"{np.median(tf) * 1e3:.3f} ms per {fb >> 20} MB batch "
              f"({fb / np.median(tf) / 1e9:.4f} GB/s)")
        print(f"  [{card}] lockstep decoder device-only "
              f"({PI.decode_fn().__name__}): {t_dec * 1e3:.3f} ms for "
              f"{len(rounds)} calls over {n >> 20} MB "
              f"({n / t_dec / 1e9:.4f} GB/s)")
        print(f"  compiles inside the timed window: {self.clock.count - c0}")

    def four(self, corpus: bytes) -> None:
        from qatzip_tpu.parallel import shard

        qz, jax = self.qz, self.jax
        mesh = shard.local_mesh()
        check(mesh is not None and mesh.devices.size == 4,
              "no 4-device mesh")
        card = "; ".join(self.card)
        outs = {}
        for name, m in (("4-card mesh", mesh), ("1 card", None)):
            shard._MESH = m
            sess, dsess = self.session(), self.session()
            comp = self.on_device(f"{name} compress", lambda: self.api(
                qz.qz_compress, sess, corpus))
            tc, comp = timed(lambda: self.api(qz.qz_compress, sess, corpus),
                             3)
            out = self.api(qz.qz_decompress, dsess, comp)
            check(out == corpus, f"{name} decompress differs")
            td, _ = timed(lambda: self.api(qz.qz_decompress, dsess, comp), 3)
            outs[name] = comp
            print(f"  [{card}] {name}: compress "
                  f"{len(corpus) / np.median(tc) / 1e9:.4f} GB/s, "
                  f"decompress {len(corpus) / np.median(td) / 1e9:.4f} GB/s"
                  f" (bit-exact); {len(comp)} bytes")
        shard._MESH = mesh
        same = outs["4-card mesh"] == outs["1 card"]
        print(f"  4-card and 1-card compress byte-identical: {same}")
        check(same, "4-card output differs from 1-card output")
        for d in jax.devices():
            peak = (d.memory_stats() or {}).get("peak_bytes_in_use")
            print(f"  {d}: peak_bytes_in_use={peak}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phase")
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="tiny CPU run of phases 3-6 (JAX_PLATFORMS=cpu); "
                         "never reports ok")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    os.environ["QATZIP_TPU_DEVICE"] = "1"   # force the device path
    os.environ["QATZIP_TPU_PACK"] = "0"     # the uncalibrated default

    import jax

    platform = jax.devices()[0].platform
    if args.rehearse_cpu:
        if platform != "cpu":
            print("--rehearse-cpu runs only under JAX_PLATFORMS=cpu",
                  file=sys.stderr)
            return 2
    elif platform != "gpu":
        print(f"no GPU: JAX reports platform {platform!r}", file=sys.stderr)
        return 1

    from bench import build_corpus

    count = 4 if args.four else 1
    smoke = Smoke(args.rehearse_cpu)
    phase = "1 device report"
    try:
        print(f"== {phase}")
        smoke.report(count)
        corpus = build_corpus(4 if args.rehearse_cpu else CORPUS_MB)
        print(f"  corpus: {len(corpus)} bytes")
        if args.four:
            phase = "4-card mesh"
            print(f"== {phase}")
            smoke.four(corpus)
        else:
            if not args.rehearse_cpu:
                phase = "2 compile"
                print(f"== {phase}")
                smoke.compile_all(corpus)
            else:
                smoke.finder_inputs(corpus)
            phase = "3 finder vs XLA:CPU"
            print(f"== {phase}")
            smoke.finder_vs_cpu()
            phase = "4 compress"
            print(f"== {phase}")
            comp = smoke.compress(corpus)
            phase = "5 decompress"
            print(f"== {phase}")
            rounds = smoke.decompress(corpus, comp)
            phase = "6 lz4 frame"
            print(f"== {phase}")
            smoke.lz4(corpus)
            if not args.rehearse_cpu:
                phase = "7 timings"
                print(f"== {phase}")
                smoke.timings(corpus, comp, rounds)
    except Exception as exc:
        print(f"FAILED in phase {phase}: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        return 1
    if args.rehearse_cpu:
        print("rehearsal passed (CPU; no result)")
        return 0
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
