"""Test configuration.

Unless JAX_PLATFORMS names another platform, the tests run on a virtual
8-device CPU mesh, so multi-device sharding paths are exercised without an
accelerator (the multi-node-without-a-cluster strategy; see SURVEY.md §4).
Tests marked ``gpu`` need a GPU and skip elsewhere; run them on the card
with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""
import os
import random
import sys

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    # must run before the first jax backend initialization (importing jax is
    # fine; creating a backend is not — pytest plugins import jax early)
    from jax._src import xla_bridge as _xb
    assert not _xb._backends, (
        "jax backend initialized before conftest; cannot force CPU platform")
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax as _jax
    # jax snapshots JAX_PLATFORMS at import; override the live config too
    _jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# deterministic device-routing policy: ignore any calibration record on the
# machine; tests that exercise the device path opt in via QATZIP_TPU_DEVICE
os.environ.setdefault("QATZIP_TPU_DEVCAL_PATH",
                      os.path.join(os.path.dirname(__file__),
                                   ".no-devcal.json"))

# persistent compilation cache makes repeated test runs cheap (the
# library's own default, unless JAX_COMPILATION_CACHE_DIR is set)
from qatzip_tpu.ops import registry as _registry  # noqa: E402

_registry.setup_compile_cache()

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless this process's JAX device is a GPU (decided at run
    time, never at import: every xdist worker must collect the same
    tests)."""
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return random.Random(0xC0FFEE)


def make_corpus(rng: random.Random, size: int, kind: str = "text") -> bytes:
    """Synthetic corpora mirroring test/bt.c's three generators plus a
    compressible 'text' flavor."""
    if kind == "iterative":
        return bytes(i % 256 for i in range(size))
    if kind == "random":
        return bytes(rng.getrandbits(8) for _ in range(size))
    if kind == "constant":
        return b"A" * size
    if kind == "text":
        words = [b"the", b"quick", b"brown", b"fox", b"jumps", b"over",
                 b"lazy", b"dog", b"compression", b"hardware", b"offload"]
        out = bytearray()
        while len(out) < size:
            out += rng.choice(words) + b" "
        return bytes(out[:size])
    raise ValueError(kind)


@pytest.fixture
def corpus_factory(rng):
    return lambda size, kind="text": make_corpus(rng, size, kind)
