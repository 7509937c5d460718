"""Rules of the port: what it imports, where it runs, what it refuses."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from readsb_tpu_torch.ops import kernels
from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "readsb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tools", "readsb_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "make", [lambda: Demodulator(), lambda: MultiDemodulator(2)], ids=["single", "multi"]
)
def test_default_device_is_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


@pytest.mark.parametrize(
    "kw", [{"fmt": "sc16"}, {"fmt": "sc16q11"}, {"modeac": True}], ids=["sc16", "sc16q11", "modeac"]
)
def test_unported_routes_raise(kw):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Demodulator(device="cpu", **kw)


def test_kernels_module_imports_and_build_raises_without_nvcc(tmp_path):
    env = {**os.environ, "PATH": str(tmp_path), "CUDA_HOME": str(tmp_path)}
    code = (
        "import readsb_tpu_torch.ops.kernels as k\n"
        "try:\n    k.build()\nexcept RuntimeError as e:\n    print('raised', e)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "raised nvcc not found" in out.stdout


def test_cpu_tensors_take_the_plain_versions_uncounted():
    before = (kernels.dense_scan_uc8.launches, kernels.extract_syndromes.launches)
    words = torch.full((65536,), 0x8080, dtype=torch.uint16)
    corr, pwords, cs_hi, cs_lo = kernels.dense_scan_uc8(words, 58)
    assert corr.dtype == torch.int8 and tuple(pwords.shape) == (5, 2048)
    rows = torch.zeros((3, 128), dtype=torch.int32)
    out = kernels.extract_syndromes(rows, torch.tensor([0, 7, 300], dtype=torch.int32))
    assert tuple(out.shape) == (3, 128) and not out[:, 80:].any()
    assert (kernels.dense_scan_uc8.launches, kernels.extract_syndromes.launches) == before


def test_wrap_and_pack_helpers():
    x = torch.tensor([0, (1 << 31), (1 << 32) + 5, -1], dtype=torch.int64)
    assert kernels.wrap_i32(x).tolist() == [0, -(1 << 31), 5, -1]
    planes = torch.zeros((1, 64), dtype=torch.bool)
    planes[0, [0, 31, 33]] = True
    assert kernels.pack_plane_words(planes).tolist() == [[1 - (1 << 31), 2]]
    assert np.array_equal(kernels.extract_tables_np()[0][:3] & 511, [19, 22, 24])
