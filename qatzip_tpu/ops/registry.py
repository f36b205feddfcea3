"""Capability registry: which (format, direction) pairs run on device.

The analog of the per-instance capability filter in qzGrabInstance
(reference src/qatzip.c:363-400).  Codecs register themselves as device
kernel coverage grows; anything absent falls back to the CPU backend.
"""
from __future__ import annotations

import os

from qatzip_tpu.constants import DataFormatInternal, QzDirection
from qatzip_tpu.session import InternalParams

_CODECS: dict[tuple[DataFormatInternal, str], object] = {}


def register(fmt: DataFormatInternal, direction: str, codec: object) -> None:
    """direction: 'compress' | 'decompress'."""
    _CODECS[(fmt, direction)] = codec


def _directions_needed(direction: QzDirection) -> list[str]:
    if direction == QzDirection.QZ_DIR_COMPRESS:
        return ["compress"]
    if direction == QzDirection.QZ_DIR_DECOMPRESS:
        return ["decompress"]
    return ["compress", "decompress"]


def supports(params: InternalParams, direction: QzDirection) -> bool:
    _ensure_registered()
    return all((params.data_fmt, d) in _CODECS
               for d in _directions_needed(direction))


def get_codec(params: InternalParams):
    _ensure_registered()

    class _Dispatch:
        def compress_chunks(self, chunks, p):
            return _CODECS[(p.data_fmt, "compress")].compress_chunks(chunks, p)

        def decompress_chunks(self, payloads, hints, p):
            return _CODECS[(p.data_fmt, "decompress")].decompress_chunks(
                payloads, hints, p)

    return _Dispatch()


_registered = False


def _ensure_registered() -> None:
    global _registered
    if _registered:
        return
    _registered = True
    setup_compile_cache()
    try:
        from qatzip_tpu.ops import device_codecs
        device_codecs.register_all()
    except ImportError as exc:
        from qatzip_tpu.utils.logging import QZ_ERROR

        QZ_ERROR("device codecs unavailable, requests run on the CPU: %s",
                 exc)


# a fixed default at the checkout root: every process of a checkout, the
# tests included, finds what an earlier one compiled
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def setup_compile_cache() -> None:
    """Persistent XLA compile cache so a fresh process pays kernel compiles
    once, not once per run.  JAX_COMPILATION_CACHE_DIR, when set, is left
    to JAX (which reads it at import); otherwise the cache lives in
    ``.jax_cache/`` at the root of the checkout."""
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
