"""Rules of the port: what it imports, where it runs, what it refuses."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from readsb_tpu_torch import pipeline
from readsb_tpu_torch.ops import demod, fused, kernels
from readsb_tpu_torch.pipeline import Demodulator, MultiDemodulator

# the suite runs in several worker processes that share the cores
torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "readsb_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "tools", "readsb_tpu", "zstandard")


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
    "make",
    [lambda: Demodulator(), lambda: MultiDemodulator(2),
     lambda: Demodulator(fmt="sc16"), lambda: MultiDemodulator(2, fmt="sc16")],
    ids=["single", "multi", "single-sc16", "multi-sc16"],
)
def test_default_device_is_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


@pytest.mark.parametrize(
    "kw", [{"fmt": "sc16"}, {"fmt": "sc16q11"}, {"modeac": True}], ids=["sc16", "sc16q11", "modeac"]
)
def test_magnitude_routes_construct_on_the_cpu(kw):
    d = Demodulator(device="cpu", use_native=False, **kw)
    assert d.raw_route is False and d.use_gate is True
    assert d._overlap_dev.dtype == torch.uint16 and not d._overlap_dev.any()
    assert d.modeac_msgs == [] and d.stats_modeac == 0


@pytest.mark.parametrize(
    "make",
    [lambda: Demodulator(fmt="cu8", device="cpu"),
     lambda: MultiDemodulator(2, fmt="sc8", device="cpu")],
    ids=["single", "multi"],
)
def test_unknown_format_raises(make):
    with pytest.raises(ValueError, match="unknown sample format"):
        make()


def test_routes_follow_the_reference():
    """uc8 + gate + no Mode A/C is the raw route; anything else the
    magnitude route; use_gate=None means gated."""
    kw = dict(device="cpu", use_native=False)
    assert Demodulator(**kw).raw_route is True
    assert Demodulator(use_gate=False, **kw).raw_route is False
    assert Demodulator(modeac=True, **kw).raw_route is False
    assert MultiDemodulator(2, **kw).raw_route is True
    assert MultiDemodulator(2, fmt="sc16q11", **kw).raw_route is False
    with pytest.raises(ValueError, match="raw-UC8 route only"):
        Demodulator(fmt="sc16", **kw)._process(torch.zeros(4, dtype=torch.uint16), 4)


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
    def counts():
        return (kernels.dense_scan_uc8.launches, kernels.extract_syndromes.launches,
                kernels.mag_uc8.launches, kernels.dense_scan.launches)

    before = counts()
    words = torch.full((65536,), 0x8080, dtype=torch.uint16)
    corr, pwords, cs_hi, cs_lo = kernels.dense_scan_uc8(words, 58)
    assert corr.dtype == torch.int8 and tuple(pwords.shape) == (5, 2048)
    rows = torch.zeros((3, 128), dtype=torch.int32)
    out = kernels.extract_syndromes(rows, torch.tensor([0, 7, 300], dtype=torch.int32))
    assert tuple(out.shape) == (3, 128) and not out[:, 80:].any()
    mag = kernels.mag_uc8(words[:1001])
    assert mag.dtype == torch.uint16 and mag.tolist() == [363] * 1001
    c2, p2, _, _ = kernels.dense_scan(kernels.mag_uc8(words), 58)
    assert c2.dtype == torch.int8 and tuple(p2.shape) == (5, 2048)
    assert torch.equal(c2[:-19], corr[:-19])  # the tails differ: 0 against full scale
    assert counts() == before


@pytest.mark.parametrize(
    "call",
    [lambda: kernels.mag_uc8(torch.zeros(8, dtype=torch.int32)),
     lambda: kernels.mag_uc8(torch.zeros((2, 8), dtype=torch.uint16)),
     lambda: kernels.dense_scan(torch.zeros(1000, dtype=torch.uint16), 58),
     lambda: kernels.dense_scan(torch.zeros(65536, dtype=torch.int32), 58),
     lambda: kernels.extract_classify_v3(
         torch.zeros((2, 128), dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
         torch.zeros(100, dtype=torch.int32)),
     lambda: kernels.extract_classify(
         torch.zeros((2, 128), dtype=torch.int32), torch.zeros(2, dtype=torch.int64),
         torch.zeros(128, dtype=torch.int32)),
     lambda: fused.fused_demod_tiles(torch.zeros(65536 + 512, dtype=torch.uint16), 58, cap=128),
     lambda: fused.fused_demod_tiles(torch.zeros(65536, dtype=torch.int16), 58, cap=128)],
    ids=["mag-dtype", "mag-rank", "dense-length", "dense-dtype", "classify-v3-table",
         "classify-offsets-dtype", "fused-length", "fused-dtype"],
)
def test_new_wrappers_reject_bad_input(call):
    with pytest.raises(ValueError):
        call()


def test_build_rebuilds_when_a_header_is_newer(tmp_path, monkeypatch):
    """A library older than a header of csrc/ is stale.  nvcc is absent
    here, so a script that creates its -o file stands in for it."""
    import os
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(kernels.CSRC, csrc)
    out = tmp_path / "out"
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(out))
    monkeypatch.setenv("PATH", f"{tmp_path}/bin:{os.environ['PATH']}")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    nvcc.chmod(0o755)
    assert sorted(kernels.build()) == sorted(kernels.SOURCES)  # nothing built yet
    assert kernels.build() == {}  # all fresh

    def stamp_libraries(t):
        for lib in out.iterdir():
            os.utime(lib, (t, t))

    t0 = os.path.getmtime(out / "libmag_uc8.so")
    os.utime(csrc / "extract_syndromes.cu", (t0 + 10, t0 + 10))
    assert sorted(kernels.build()) == ["extract_syndromes"]  # its source alone
    headers = sorted(f.name for f in csrc.glob("*.cuh"))
    assert headers
    for i, header in enumerate(headers):
        at = t0 + 20 * (i + 1)
        stamp_libraries(at)
        assert kernels.build() == {}
        os.utime(csrc / header, (at + 10, at + 10))
        assert sorted(kernels.build()) == sorted(kernels.SOURCES)  # a header: every library


def test_the_two_route_constants_are_off_at_import():
    """The fused routes run only where a caller sets their constant."""
    code = (
        "import readsb_tpu_torch.pipeline as p, readsb_tpu_torch.ops.demod as d\n"
        "print(p.FUSE_CLASSIFY, d.USE_FUSED)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]
    assert pipeline.FUSE_CLASSIFY is False and demod.USE_FUSED is False
    assert len(kernels.SOURCES) == 7 and sorted(kernels._ARGTYPES) == sorted(kernels.SOURCES)
    for name in kernels.SOURCES:
        assert os.path.exists(os.path.join(kernels.CSRC, name + ".cu")), name


def test_new_wrappers_take_the_plain_versions_uncounted_on_the_cpu():
    wrappers = (kernels.extract_classify_v3, kernels.extract_classify, fused.fused_demod_tiles)
    before = [w.launches for w in wrappers]
    rows = torch.zeros((3, 128), dtype=torch.int32)
    offs = torch.tensor([0, 7, 300], dtype=torch.int32)
    tbl = torch.full((128,), 0x1000000, dtype=torch.int32)
    a = kernels.extract_classify_v3(rows, offs, tbl)
    assert torch.equal(a, kernels.extract_classify(rows, offs, tbl))
    assert a[:, 83:88].tolist() == [[16] * 5] * 3 and not a[:, :83].any()  # zero7 only
    out = fused.fused_demod_tiles(torch.full((65536,), 363, dtype=torch.uint16), 58, cap=5)
    assert [tuple(o.shape) for o in out] == [(5, 128), (5,), (5,), (1, 3), (65536,), (65536,)]
    assert not out[2].any() and out[1].tolist() == [65536] * 5 and not out[3].any()
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("recorded,device", [(0, torch.device("cuda", 1)), (1, torch.device("cuda", 0)),
                                             (0, torch.device("cpu"))])
def test_a_library_refuses_a_tensor_on_another_device(recorded, device):
    """A library's tables live on the device it was loaded on: any other
    device is refused, not launched on (no card needed)."""
    with pytest.raises(ValueError, match="one device per process"):
        kernels.check_device(recorded, device, "dense_scan")
    kernels.check_device(device.index or 0, torch.device("cuda", device.index or 0), "dense_scan")


def test_wrap_and_pack_helpers():
    x = torch.tensor([0, (1 << 31), (1 << 32) + 5, -1], dtype=torch.int64)
    assert kernels.wrap_i32(x).tolist() == [0, -(1 << 31), 5, -1]
    planes = torch.zeros((1, 64), dtype=torch.bool)
    planes[0, [0, 31, 33]] = True
    assert kernels.pack_plane_words(planes).tolist() == [[1 - (1 << 31), 2]]
    assert np.array_equal(kernels.extract_tables_np()[0][:3] & 511, [19, 22, 24])
