"""Bench of the hybrid encoder on the GPU: device K1 (find_candidates) +
native host assembly.  Reports device compute per batch, candidate D2H,
host assembly rate, ratio vs zlib L1, and pipelined end to end, beside the
device and the card's name and power limit.

  python3 tools/bench_hybrid.py
"""
import os as _os
import subprocess
import sys as _sys

_REPO = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
_sys.path.insert(0, _REPO)

import time
import zlib

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from bench import build_corpus
    from qatzip_tpu.native import qzcore as native
    from qatzip_tpu.ops import match_finder as mf

    d = jax.devices()[0]
    if d.platform != "gpu":
        _sys.exit(f"no GPU: JAX reports platform {d.platform!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}; "
          f"card: {card}", flush=True)
    B, N = 128, 65536
    buf = build_corpus(B * N >> 20)
    data = np.zeros((B, N + 8), np.uint8)
    data[:, :N] = np.frombuffer(buf, np.uint8).reshape(B, N)
    lens = np.full((B,), N, np.int32)
    dj = jnp.asarray(data)
    lj = jnp.asarray(lens)

    def find():
        # the shipped L1 point (DeflateDeviceCodec._compress_hybrid)
        return mf.find_candidates(dj, lj, depth=16, stride=2)

    t0 = time.perf_counter()
    cand = jax.block_until_ready(find())
    print(f"compile+first: {time.perf_counter()-t0:.1f}s", flush=True)

    t0 = time.perf_counter()
    REPS = 10
    for _ in range(REPS):
        cand = find()
    jax.block_until_ready(cand)
    dt = (time.perf_counter() - t0) / REPS
    print(f"K1 find_candidates: {dt*1e3:.2f} ms per {B*N>>20} MB "
          f"({B*N/dt/1e9:.3f} GB/s device compute)", flush=True)

    # full D2H of the candidate array (the transfer the hybrid pays)
    t0 = time.perf_counter()
    cand_np = np.asarray(cand)
    d2h = time.perf_counter() - t0
    print(f"cand D2H: {cand_np.nbytes>>20} MB in {d2h*1e3:.1f} ms", flush=True)

    chunks = [buf[i * N:(i + 1) * N] for i in range(B)]
    t0 = time.perf_counter()
    payloads = [native.deflate_candidates(c, cand_np[i], 1)
                for i, c in enumerate(chunks)]
    host_dt = time.perf_counter() - t0
    print(f"host assembly: {host_dt*1e3:.1f} ms ({B*N/host_dt/1e9:.3f} GB/s "
          f"single-core)", flush=True)

    tot_out = sum(len(p) for p in payloads)
    tot_zlib = sum(len(zlib.compress(c, 1)) - 6 for c in chunks)
    ok = all(zlib.decompress(p, -15) == c for p, c in zip(payloads, chunks))
    print(f"ratio: {B*N/tot_out:.4f} vs zlib L1 {B*N/tot_zlib:.4f} "
          f"bit_exact={ok}", flush=True)
    # steady-state pipelined end to end: submit the next batch while the
    # host assembles the previous one (JAX async dispatch)
    t0 = time.perf_counter()
    PREPS = 5
    pend = find()
    for _ in range(PREPS):
        nxt = find()
        cand_np = np.asarray(pend)
        for i, c in enumerate(chunks):
            native.deflate_candidates(c, cand_np[i], 1)
        pend = nxt
    jax.block_until_ready(pend)
    dt = (time.perf_counter() - t0) / PREPS
    print(f"[{card}] pipelined end to end: {dt*1e3:.1f} ms per "
          f"{B*N>>20} MB ({B*N/dt/1e9:.3f} GB/s)", flush=True)


if __name__ == "__main__":
    main()
