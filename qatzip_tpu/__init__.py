"""qatzip-tpu: a lossless compression framework offloaded to a JAX device.

A from-scratch re-design of intel/QATzip's capabilities for JAX devices:
the QAT ASIC's DEFLATE/LZ4/LZ4s offload engines are replaced by JAX/Pallas
kernels, the instance-pool/polling machinery by JAX async dispatch, and
multi-process PCIe scaling by data-parallel sharding over device meshes.

Wire formats produced/consumed: gzip (RFC1952), QATzip gzipext, 4-byte-header
deflate, raw deflate, zlib (RFC1950), LZ4 frame, LZ4s blocks — all
interoperable with the reference implementation.
"""
from qatzip_tpu.constants import *  # noqa: F401,F403
from qatzip_tpu.session import (  # noqa: F401
    QzSession,
    QzSessionParams,
    QzSessionParamsCommon,
    QzSessionParamsDeflate,
    QzSessionParamsDeflateExt,
    QzSessionParamsLZ4,
    QzSessionParamsLZ4S,
)
from qatzip_tpu.api import *  # noqa: F401,F403

__version__ = "0.1.0"
