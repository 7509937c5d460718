"""The port's packaging: packaging/readsb-tpu-torch.service, its defaults
file packaging/readsb-tpu-torch.default and packaging/Dockerfile.torch,
and READSB_TPU_TORCH_BUILD_DIR, which places the compiled libraries.

The unit keeps readsb-tpu.service's hardening and restart policy and
changes only the module, the defaults file, the build directory, the
identifiers and the conflict with readsb-tpu.service; its defaults give
readsb_tpu's parse of readsb-tpu.default.  The unit's command line, with
its `$GROUP`s expanded as systemd expands them, runs on the CPU under
READSB_TPU_PLATFORM=cpu, builds the host finalizer into a fresh build
directory and writes the aircraft.json of the port's in-process App run
of the same capture; without that variable and without a card it exits
non-zero.  Every subprocess runs torch on one thread, under its own time
limit.
"""

import asyncio
import json
import os
import pathlib
import shlex
import shutil
import socket
import subprocess
import sys

import pytest
import torch

from readsb_tpu.app.config import parse_args as jax_parse_args
from readsb_tpu_torch.app import main
from readsb_tpu_torch.io import json_out
from readsb_tpu_torch.synth import build_traffic_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGING = REPO / "packaging"
UNIT = PACKAGING / "readsb-tpu-torch.service"
GROUPS = ("RECEIVER_OPTIONS", "DECODER_OPTIONS", "NET_OPTIONS", "JSON_OPTIONS")
BUILD_VAR = "READSB_TPU_TORCH_BUILD_DIR"
DEFAULT_BUILD_DIR = REPO / "build" / "readsb_tpu_torch"
# the [Service] keys in which the port's unit differs from readsb-tpu.service
CHANGED = {"ExecStart", "EnvironmentFile", "SyslogIdentifier", "Environment", "CacheDirectory"}
CHILD_TIMEOUT_S = 120


def unit_sections(path) -> dict[str, dict[str, list[str]]]:
    """{section: {key: [values in order]}} of a systemd unit file."""
    sections: dict[str, dict[str, list[str]]] = {}
    cur = None
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            cur = sections.setdefault(line.strip("[]"), {})
            continue
        key, value = line.split("=", 1)
        cur.setdefault(key, []).append(value)
    return sections


def defaults(path) -> dict[str, str]:
    """The NAME="value" assignments of an EnvironmentFile."""
    env = {}
    for line in path.read_text().splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            key, value = shlex.split(line)[0].split("=", 1)
            env[key] = value
    return env


def exec_argv(unit, default) -> list[str]:
    """The unit's ExecStart with each $GROUP of its defaults file split on
    whitespace, as systemd expands an unbraced $VAR."""
    env = defaults(default)
    argv = []
    for word in shlex.split(unit_sections(unit)["Service"]["ExecStart"][0]):
        argv += env[word[1:]].split() if word.startswith("$") else [word]
    return argv


def free_port(sbs: bool = False) -> int:
    """A free TCP port; for the SBS lane not one ending in 5, which would
    also listen on the next four (its variant lanes)."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if not (sbs and port % 10 == 5):
            return port


def child_argv(out) -> list[str]:
    """The unit's command line as the service would run it, but with this
    interpreter, --write-json at `out` and each listener on a free port."""
    argv = exec_argv(UNIT, PACKAGING / "readsb-tpu-torch.default")
    assert argv[0] == "/usr/bin/python3"
    argv[0] = sys.executable
    for i, word in enumerate(argv[:-1]):
        if word == "--write-json":
            argv[i + 1] = str(out)
        elif word.startswith("--net-") and word.endswith("-port"):
            n = len(argv[i + 1].split(","))
            argv[i + 1] = ",".join(str(free_port(word == "--net-sbs-port")) for _ in range(n))
    return argv


def child_env(build_dir, platform) -> dict[str, str]:
    env = {k: v for k, v in os.environ.items() if k not in ("READSB_TPU_PLATFORM", BUILD_VAR)}
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above, for the child
    env["PYTHONPATH"] = str(REPO)
    if build_dir is not None:
        env[BUILD_VAR] = str(build_dir)
    if platform:
        env["READSB_TPU_PLATFORM"] = platform
    return env


def dockerfile_instructions(path) -> list[tuple[str, str]]:
    """(INSTRUCTION, arguments) of a Dockerfile, continuation lines joined."""
    text = path.read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            op, _, rest = line.partition(" ")
            out.append((op.upper(), rest.strip()))
    return out


# ---------------------------------------------------------------------------
# the unit and its defaults
# ---------------------------------------------------------------------------


def test_unit_runs_the_port_with_its_build_directory():
    port = unit_sections(UNIT)
    svc = port["Service"]
    assert shlex.split(svc["ExecStart"][0]) == [
        "/usr/bin/python3", "-m", "readsb_tpu_torch.app.main",
        *(f"${g}" for g in GROUPS),
    ]
    assert svc["EnvironmentFile"] == ["/etc/default/readsb-tpu-torch"]
    assert svc["Environment"] == [f"{BUILD_VAR}=/var/cache/readsb-tpu-torch"]
    assert svc["CacheDirectory"] == ["readsb-tpu-torch"]  # systemd makes /var/cache/<it>
    assert svc["SyslogIdentifier"] == ["readsb-tpu-torch"]
    assert port["Unit"]["Conflicts"] == ["readsb-tpu.service"]
    # the card is /dev/nvidia*, and the unit runs on it
    assert "PrivateDevices" not in svc
    assert not any(e.startswith("READSB_TPU_PLATFORM=") for e in svc["Environment"])
    (doc,) = port["Unit"]["Documentation"]
    assert len(doc.split()) == 1 and doc.startswith("https://")
    assert "readsb-tpu-torch" in port["Unit"]["Description"][0]


def test_unit_keeps_the_jax_units_hardening_and_restart_policy():
    """Every [Service] key of readsb-tpu.service but the changed ones keeps
    its value, and the port's unit adds only the changed ones."""
    jax_unit = unit_sections(PACKAGING / "readsb-tpu.service")
    port = unit_sections(UNIT)
    kept = {k: v for k, v in jax_unit["Service"].items() if k not in CHANGED}
    assert {k: v for k, v in port["Service"].items() if k not in CHANGED} == kept
    assert {"ProtectSystem", "NoNewPrivileges", "Restart", "RestartSec", "User"} <= set(kept)
    assert port["Install"] == jax_unit["Install"]
    assert set(port["Unit"]) == set(jax_unit["Unit"]) | {"Conflicts"}


@pytest.mark.parametrize("group", GROUPS)
def test_defaults_parse_as_readsb_tpus(group):
    """Each group parses through the port's parse_args to what readsb_tpu's
    parse_args makes of the same group of readsb-tpu.default."""
    port = defaults(PACKAGING / "readsb-tpu-torch.default")
    jax = defaults(PACKAGING / "readsb-tpu.default")
    assert set(port) == set(jax) == set(GROUPS)
    got = vars(main.parse_args(port[group].split()))
    assert got == vars(jax_parse_args(jax[group].split()))


def test_systemd_analyze_verifies_the_unit(tmp_path):
    tool = shutil.which("systemd-analyze")
    if tool is None:
        pytest.skip("systemd-analyze is not installed")
    shutil.copy(UNIT, tmp_path)
    r = subprocess.run([tool, "verify", f"./{UNIT.name}"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=60, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert (r.returncode, r.stdout, r.stderr) == (0, "", "")


# ---------------------------------------------------------------------------
# the image recipe (not built: its base image and wheels are downloads)
# ---------------------------------------------------------------------------


def test_dockerfile_installs_only_the_port_and_builds_its_libraries():
    steps = dockerfile_instructions(PACKAGING / "Dockerfile.torch")
    ops = [op for op, _ in steps]
    base = steps[0][1]
    assert ops[0] == "FROM" and "cuda:12.8" in base and "devel-ubuntu24.04" in base
    copies = [shlex.split(arg) for op, arg in steps if op == "COPY"]
    assert copies
    for *sources, _ in copies:
        for src in sources:
            assert (REPO / src).exists(), src
            assert pathlib.PurePath(src).parts[0] not in ("readsb_tpu", "tools", "."), src
    assert ["readsb_tpu_torch", "./readsb_tpu_torch"] in copies
    pips = [arg for op, arg in steps if op == "RUN" and "pip install" in arg]
    assert pips and not any("jax" in arg or "zstandard" in arg for arg in pips)
    assert any("torch" in arg and "cu128" in arg for arg in pips)
    assert json.loads(dict(steps)["ENTRYPOINT"]) == ["python3", "-m", "readsb_tpu_torch.app.main"]
    builds = [i for i, (op, arg) in enumerate(steps) if op == "RUN" and "kernels.build()" in arg]
    assert len(builds) == 1 and "native.load()" in steps[builds[0]][1]
    envs = [i for i, (op, arg) in enumerate(steps) if op == "ENV" and arg.startswith(BUILD_VAR + "=")]
    assert envs and envs[0] < builds[0]
    jax_steps = dict(dockerfile_instructions(PACKAGING / "Dockerfile"))
    assert dict(steps)["EXPOSE"] == jax_steps["EXPOSE"] and dict(steps)["CMD"] == jax_steps["CMD"]


# ---------------------------------------------------------------------------
# READSB_TPU_TORCH_BUILD_DIR
# ---------------------------------------------------------------------------

PATHS = ("import json; from readsb_tpu_torch import native; from readsb_tpu_torch.ops import kernels; "
         "print(json.dumps([kernels.BUILD_DIR, native._SO]))")


@pytest.mark.parametrize("value", ["set", "unset", "empty"])
def test_build_dir_variable_places_every_library(value, tmp_path):
    """Set, it places the CUDA libraries and the finalizer; unset or empty,
    BUILD_DIR is build/readsb_tpu_torch beside the package."""
    env = child_env({"set": tmp_path, "unset": None, "empty": ""}[value], None)
    r = subprocess.run([sys.executable, "-c", PATHS], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    build_dir, so = json.loads(r.stdout)
    want = tmp_path if value == "set" else DEFAULT_BUILD_DIR
    assert pathlib.Path(build_dir) == want
    assert pathlib.Path(so) == want / "libfinalizer.so"


def test_an_unusable_build_dir_raises(tmp_path):
    """No fallback: where the directory cannot be made, the kernels' build,
    the finalizer's load and a demodulator (which loads the finalizer)
    raise."""
    (tmp_path / "file").write_text("")
    code = (
        "from readsb_tpu_torch import native\n"
        "from readsb_tpu_torch.ops import kernels\n"
        "from readsb_tpu_torch.pipeline import Demodulator\n"
        "for name, fn in (('native.load', native.load), ('kernels.build', kernels.build),\n"
        "                 ('Demodulator', lambda: Demodulator(device='cpu'))):\n"
        "    try:\n"
        "        fn()\n"
        "    except OSError as e:\n"
        "        print(name, type(e).__name__)\n"
        "    else:\n"
        "        print(name, 'returned')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       env=child_env(tmp_path / "file" / "build", None),
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[:3] == [f"{name} NotADirectoryError" for name in
                                        ("native.load", "kernels.build", "Demodulator")]


# ---------------------------------------------------------------------------
# the unit's command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("unit") / "cap.uc8.dat"
    build_traffic_capture(0.5, 6, 16).write_uc8(str(path))
    return path


def test_unit_command_line_on_the_cpu(capture, tmp_path, monkeypatch):
    """The unit's first start on the CPU: exit 0, the finalizer built into
    the fresh build directory, and the aircraft.json of the port's
    in-process App run of the same capture with the same options."""
    build_dir, out, cwd = tmp_path / "cache", tmp_path / "json", tmp_path / "cwd"
    build_dir.mkdir()
    cwd.mkdir()
    argv = child_argv(out)
    with open(capture, "rb") as stdin:
        r = subprocess.run(argv, cwd=cwd, env=child_env(build_dir, "cpu"), stdin=stdin,
                           capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.listdir(build_dir) == ["libfinalizer.so"]
    got = json.loads((out / "aircraft.json").read_text())

    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    opts = argv[3:]
    opts[opts.index("/dev/stdin")] = str(capture)
    app = main.App(main.parse_args(opts))
    asyncio.run(app.run_ifile())
    want = json.loads(json.dumps(json_out.generate_aircraft_json(app.tracker, app.now_ms(),
                                                                 app.messages)))
    got.pop("now")
    want.pop("now")
    assert got == want
    assert sum("lat" in a for a in got["aircraft"]) >= 4


def test_unit_command_line_without_a_card_exits_nonzero(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    build_dir = tmp_path / "cache"
    r = subprocess.run(child_argv(tmp_path / "json"), cwd=tmp_path,
                       env=child_env(build_dir, None), stdin=subprocess.DEVNULL,
                       capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not build_dir.exists() and not (tmp_path / "json").exists()

