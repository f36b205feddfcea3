"""Device bring-up contracts: discovery never serves a silent CPU fallback
as the device, the compile cache goes where the environment says, and
chip_smoke.py refuses to run without a GPU."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str, env_drop=(), env_set=None, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if k not in env_drop and k != "XLA_FLAGS"}
    env.update(env_set or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_discovery_reports_no_hw_without_accelerator():
    """JAX_PLATFORMS unset on a host whose only JAX backend is the CPU:
    the engine reports QZ_NO_HW with a warning that says why."""
    r = _run("import qatzip_tpu.engine.core as c\n"
             "rc = c.qz_init_engine()\n"
             "e = c.engine()\n"
             "print(rc, e.hw_present, repr(e.platform))",
             env_drop=("JAX_PLATFORMS",))
    assert r.returncode == 0, r.stderr
    from qatzip_tpu import constants as C

    assert r.stdout.split() == [str(C.QZ_NO_HW), "False", "''"]
    assert "no accelerator found" in r.stderr


def test_discovery_serves_requested_cpu():
    """JAX_PLATFORMS=cpu (the tests' setting) asks for the CPU backend,
    which then serves as the device and is recorded as such."""
    from qatzip_tpu.engine import core

    backend = core._discover_hw()
    assert backend is not None
    assert backend.platform == "cpu"
    assert backend.num_devices == len(__import__("jax").devices())


def test_compile_cache_defaults_to_checkout_root():
    r = _run("from qatzip_tpu.ops import registry\n"
             "import jax\n"
             "registry.setup_compile_cache()\n"
             "print(jax.config.jax_compilation_cache_dir)",
             env_drop=("JAX_COMPILATION_CACHE_DIR",),
             env_set={"JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == os.path.join(REPO, ".jax_cache")


def test_compile_cache_follows_environment(tmp_path):
    r = _run("from qatzip_tpu.ops import registry\n"
             "import jax\n"
             "registry.setup_compile_cache()\n"
             "print(jax.config.jax_compilation_cache_dir)",
             env_set={"JAX_PLATFORMS": "cpu",
                      "JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path)


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    """Alone in a directory, the script fails past its platform check
    (the CPU rehearsal gets there here) for want of the library."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py"),
                        "--rehearse-cpu"],
                       cwd=tmp_path, env={**os.environ, "JAX_PLATFORMS": "cpu"},
                       capture_output=True, text=True, timeout=240)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "ModuleNotFoundError" in r.stderr


@pytest.mark.gpu
def test_triton_decoder_matches_reference_on_gpu(gpu, corpus_factory):
    """The compiled Triton decoder against the XLA reference on the card,
    on real 64 KB chunks."""
    import zlib

    import jax

    from qatzip_tpu.ops import deflate_decode as dd
    from qatzip_tpu.ops import pallas_inflate as PI

    chunks = [corpus_factory(65536, k) for k in ("text", "iterative")]
    payloads = []
    for c in chunks:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        payloads.append(co.compress(c) + co.flush())
    rounds: list = []
    res = dd.inflate_batch(payloads, [len(c) for c in chunks],
                           rounds_out=rounds)
    assert [r[0] for r in res] == chunks
    for args, ms in rounds:
        dev = PI.device_args(*args)
        want = jax.device_get(PI._decode_xla(*dev, max_steps=ms))
        got = jax.device_get(PI._decode_triton(*dev, max_steps=ms))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
