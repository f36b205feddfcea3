"""Compare the lockstep decoder's two drivers on the GPU: the Pallas-Triton
kernel and the XLA reference loop, on the same recorded inputs.

For each lane count (decoder lanes per device call) it reports, beside the
card's name and power limit:
  * device-only seconds per pass over the corpus, per max_steps bucket, for
    each driver (inputs uploaded first, block_until_ready at the end);
  * end-to-end qz_decompress GB/s with each driver (device path forced).

  python3 tools/bench_decoder.py [--mb 32] [--lanes 128 512] [--xla-reps 1]
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=32)
    ap.add_argument("--lanes", type=int, nargs="+", default=[128])
    ap.add_argument("--xla-reps", type=int, default=1)
    args = ap.parse_args()
    os.environ["QATZIP_TPU_DEVICE"] = "1"
    os.environ["QATZIP_TPU_PACK"] = "0"

    import jax

    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"no GPU: JAX reports platform {d.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}; "
          f"card: {card}", flush=True)

    import qatzip_tpu as qz
    from bench import build_corpus
    from qatzip_tpu.constants import QzDataFormat
    from qatzip_tpu.engine import core
    from qatzip_tpu.ops import deflate_decode as dd
    from qatzip_tpu.ops import pallas_inflate as PI
    from qatzip_tpu.ops.device_codecs import DeflateDeviceCodec

    corpus = build_corpus(args.mb)
    n = len(corpus)
    comp = qz.compress(corpus, "deflate", fmt=QzDataFormat.QZ_DEFLATE_GZIP_EXT,
                       level=1, hw_buff_sz=65536)
    members = [(s, e) for s, e in qz.member_boundaries(comp, "deflate",
                                                       hw_buff_sz=65536)]
    from qatzip_tpu.formats import gzip_fmt

    payloads, hints = [], []
    for s, _e in members:
        ext = gzip_fmt.parse_gzipext_header(comp, s)
        h = s + gzip_fmt.GZIPEXT_HEADER_SIZE
        payloads.append(comp[h:h + ext.dest_sz])
        hints.append(ext.src_sz)
    drivers = {"triton": PI._decode_triton, "xla": PI._decode_xla}
    chosen = PI.decode_fn

    for lanes in args.lanes:
        PI.LANES = lanes
        DeflateDeviceCodec.LOCKSTEP_BATCH = lanes
        rounds: list = []
        for i in range(0, len(payloads), lanes):
            dd.inflate_batch(payloads[i:i + lanes], hints[i:i + lanes],
                             rounds_out=rounds)
        buckets = collections.defaultdict(list)
        for r in rounds:
            buckets[(r[1], r[0][0].shape[1])].append(r)
        for name, fn in drivers.items():
            reps = args.xla_reps if name == "xla" else 3
            tot = 0.0
            for (ms, nw), rs in sorted(buckets.items()):
                t = PI.time_rounds(rs, fn=fn, reps=reps)
                tot += t
                print(f"[{card}] lanes={lanes} {name}: bucket max_steps={ms}"
                      f" stream_words={nw}: {len(rs)} calls, "
                      f"{t * 1e3:.3f} ms device-only", flush=True)
            print(f"[{card}] lanes={lanes} {name}: {tot * 1e3:.3f} ms "
                  f"device-only per pass ({n / tot / 1e9:.4f} GB/s)",
                  flush=True)
            PI.decode_fn = lambda fn=fn: fn
            try:
                sess = qz.QzSession()
                p = qz.QzSessionParamsDeflate()
                p.common_params.comp_lvl = 1
                p.common_params.hw_buff_sz = 65536
                p.data_fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
                qz.qz_setup_session_deflate(sess, p)
                assert qz.qz_decompress(sess, comp).data == corpus  # warm
                times = []
                for _ in range(reps):
                    sw0 = core.engine().sw_requests
                    t0 = time.perf_counter()
                    out = qz.qz_decompress(sess, comp).data
                    times.append(time.perf_counter() - t0)
                    assert out == corpus
                    assert core.engine().sw_requests == sw0
            finally:
                PI.decode_fn = chosen
            best = sorted(times)[len(times) // 2]
            print(f"[{card}] lanes={lanes} {name}: qz_decompress end to end "
                  f"{n / best / 1e9:.4f} GB/s (reps "
                  f"{[round(t, 4) for t in times]} s)", flush=True)


if __name__ == "__main__":
    main()
