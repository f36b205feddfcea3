"""Device backend: routes chunk batches to the JAX device codec kernels.

This is the analog of the QAT ASIC + instance pool in the reference
(src/qatzip.c:363-437, 1483-1764): chunks are batched into fixed-shape
device arrays, dispatched asynchronously, and gathered in block order.

Kernel availability is per-(algorithm, direction); anything unsupported
reports False from supports() and the engine routes it to the CPU backend,
exactly like the reference's isQATProcessable gate
(src/qatzip_utils.c:997-1033).
"""
from __future__ import annotations

import os
import warnings
from typing import Sequence

from qatzip_tpu.constants import DataFormatInternal, QzDirection
from qatzip_tpu.engine.backend import Backend, CompressedChunk, DecompressedChunk
from qatzip_tpu.session import InternalParams


def cpu_requested() -> bool:
    """True when the process asked JAX for the CPU platform first
    (``JAX_PLATFORMS=cpu``, as the tests and CPU rehearsals set it)."""
    import jax

    names = jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS", "")
    return names.split(",")[0].strip() == "cpu"


class DeviceBackend(Backend):
    name = "device"
    is_hw = True

    def __init__(self, devices):
        self.devices = devices
        self.platform = devices[0].platform
        self.device_kind = devices[0].device_kind
        self.num_devices = len(devices)

    @classmethod
    def create(cls) -> "DeviceBackend | None":
        """The backend over JAX's default devices, or None (with a warning
        that says why) when there is no accelerator.  JAX falls back to
        its CPU backend when no accelerator plugin starts; that backend
        serves as the device only when the process asked for it."""
        import jax

        devices = jax.devices()
        if devices[0].platform == "cpu" and not cpu_requested():
            warnings.warn("qatzip_tpu: no accelerator found (JAX offers only "
                          "its CPU backend and JAX_PLATFORMS does not ask "
                          "for it); running software-only", RuntimeWarning,
                          stacklevel=2)
            return None
        from qatzip_tpu.engine.instances import pool
        pool.resize(len(devices))
        return cls(devices)

    # -- capability gate ----------------------------------------------------
    def supports(self, params: InternalParams, direction: QzDirection) -> bool:
        from qatzip_tpu.ops import registry
        return registry.supports(params, direction)

    # -- dispatch -----------------------------------------------------------
    # Cross-session multiplexing: concurrent sessions take instance slots
    # from the bounded pool (qzGrabInstance analog, engine/instances.py);
    # a saturated pool raises and the engine's failover routes that
    # request to the CPU instead of piling onto the device queue.
    GRAB_TIMEOUT_S = 10.0

    def compress_chunks(self, chunks: Sequence[bytes],
                        params: InternalParams) -> list[CompressedChunk]:
        from qatzip_tpu.engine.instances import pool
        from qatzip_tpu.ops import registry
        codec = registry.get_codec(params)
        with pool.instance(timeout=self.GRAB_TIMEOUT_S) as inst:
            if inst is None:
                raise RuntimeError("device instance pool saturated")
            return codec.compress_chunks(chunks, params)

    def decompress_chunks(self, payloads: Sequence[bytes],
                          out_size_hints: Sequence[int],
                          params: InternalParams) -> list[DecompressedChunk]:
        from qatzip_tpu.engine.instances import pool
        from qatzip_tpu.ops import registry
        codec = registry.get_codec(params)
        with pool.instance(timeout=self.GRAB_TIMEOUT_S) as inst:
            if inst is None:
                raise RuntimeError("device instance pool saturated")
            return codec.decompress_chunks(payloads, out_size_hints, params)
