"""Profile one warm qz_compress and one warm qz_decompress of the bench
corpus (gzip-ext, level 1, 64 KB chunks, device path forced) on the GPU,
and reduce the trace to:
  * per-window device busy and idle share (union of device op intervals
    over the host span of the call);
  * device time per op, with its XLA op and named scope (mf_sort_hash,
    mf_select, mf_sort_pos in find_candidates; lockstep_inflate);
  * host-to-device and device-to-host copy time.

  python3 tools/trace_path.py [--mb 32] [--out chiprun_out/trace_path.json]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import subprocess
import sys
import tempfile

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

WINDOWS = ("qz_compress", "qz_decompress")


def _union(intervals) -> int:
    tot, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            tot += e - s
            end = e
        elif e > end:
            tot += e - end
            end = e
    return tot


def reduce_trace(path: str) -> dict:
    """Per-window busy/idle share and per-op device time from one
    .xplane.pb file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    windows = {}
    dev_events = []     # (start, end, line name, op key)
    for plane in pd.planes:
        if plane.name.startswith("/host"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name in WINDOWS:
                        windows[ev.name] = (ev.start_ns, ev.end_ns)
        elif plane.name.startswith("/device"):
            for line in plane.lines:
                for ev in line.events:
                    st = {k: v for k, v in ev.stats}
                    scope = st.get("tf_op") or st.get("name_scope") or ""
                    key = f"{ev.name} | {st.get('hlo_op', '')} | {scope}"
                    dev_events.append((ev.start_ns, ev.end_ns, line.name,
                                       key))
    out = {}
    for w, (ws, we) in windows.items():
        inside = [e for e in dev_events if e[0] >= ws and e[1] <= we]
        busy = _union([(s, e) for s, e, *_ in inside])
        per_op = collections.Counter()
        per_line = collections.Counter()
        for s, e, line, key in inside:
            per_op[key] += e - s
            per_line[line] += e - s
        out[w] = {
            "window_ms": (we - ws) / 1e6,
            "device_busy_ms": busy / 1e6,
            "device_idle_share": 1 - busy / max(we - ws, 1),
            "per_line_ms": {k: v / 1e6 for k, v in per_line.most_common()},
            "top_ops_ms": {k: v / 1e6 for k, v in per_op.most_common(25)},
        }
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=32)
    ap.add_argument("--out", default=os.path.join(_REPO, "chiprun_out",
                                                  "trace_path.json"))
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

    import qatzip_tpu as qz
    from bench import build_corpus
    from qatzip_tpu.constants import QzDataFormat

    corpus = build_corpus(args.mb)
    sess = qz.QzSession()
    p = qz.QzSessionParamsDeflate()
    p.common_params.comp_lvl = 1
    p.common_params.hw_buff_sz = 65536
    p.data_fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    qz.qz_setup_session_deflate(sess, p)
    comp = qz.qz_compress(sess, corpus).data            # warm
    assert qz.qz_decompress(sess, comp).data == corpus  # warm
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            with jax.profiler.TraceAnnotation("qz_compress"):
                comp2 = qz.qz_compress(sess, corpus).data
            with jax.profiler.TraceAnnotation("qz_decompress"):
                out = qz.qz_decompress(sess, comp2).data
        assert out == corpus
        (path,) = glob.glob(os.path.join(tdir, "plugins", "profile", "*",
                                         "*.xplane.pb"))
        summary = reduce_trace(path)
    summary["device"] = {"platform": d.platform, "kind": d.device_kind,
                         "card": card}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
