"""The port's kernel probe entry point and kernel K3 (elementwise add) on the
CPU: the plain version against the JAX package's Pallas kernel (interpret
mode), the probe's verdict format, its timeout and failure paths, and how a
kernel's build is keyed."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl

from gluefactory_torch.ops import elementwise, kernels
from gluefactory_torch.scripts import kernel_probe

torch.set_num_threads(2)


def _pallas_add(x, y):
    """The probe's TPU kernel (gluefactory_tpu/scripts/pallas_probe.py), run
    in interpret mode."""
    def kernel(x_ref, y_ref, o_ref):
        o_ref[...] = x_ref[...] + y_ref[...]

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
                          interpret=True)(x, y)


def test_add_matches_the_pallas_kernel():
    rng = np.random.default_rng(0)
    x, y = (rng.normal(size=(256, 256)).astype(np.float32) for _ in range(2))
    before = dict(elementwise.launches)
    out = elementwise.add_cuda(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(out.numpy(), np.asarray(_pallas_add(jnp.asarray(x),
                                                                      jnp.asarray(y))))
    assert elementwise.launches == before  # the CPU runs the plain version: no launch


def test_probe_on_the_cpu_runs_both_workers(tmp_path):
    out = tmp_path / "verdict.json"
    assert kernel_probe.main(["--out", str(out), "--device", "cpu", "--timeout", "120"]) == 0
    verdict = json.loads(out.read_text())
    assert set(verdict) == {"tiny", "attention"}
    tiny, attention = verdict["tiny"], verdict["attention"]
    assert tiny["status"] == attention["status"] == "EXECUTED"
    assert tiny["ok"] and tiny["checksum"] == 131072.0 and tiny["device"] == "cpu"
    assert attention["ok"] and attention["max_abs_err"] < 1e-2
    assert tiny["seconds"] > 0 and "launches" in tiny


def test_probe_reports_a_hung_worker():
    rec = kernel_probe.probe("tiny", timeout=0.05, device="cpu")
    assert rec == {"which": "tiny", "status": "hung", "seconds": 0.1}


def test_probe_reports_a_worker_that_fails():
    rec = kernel_probe.probe("no_such_worker", timeout=120, device="cpu")
    assert rec["status"] == "rc=1" and "unknown worker" in rec["stderr"]


def test_each_kernel_library_is_keyed_by_its_own_source():
    """Adding a source never renames another's library: the name hashes the
    source's bytes and the flags only."""
    flags = " ".join(kernels.NVCC_FLAGS).encode()
    for source in ("attention.cu", "elementwise.cu"):
        digest = hashlib.sha256((kernels.CSRC_DIR / source).read_bytes() + flags).hexdigest()
        assert kernels.library_path(source).name == f"lib{source[:-3]}_{digest[:16]}.so"
