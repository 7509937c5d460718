"""The port's command line: `python -m readsb_tpu_torch.app.main`.

The port's app runs once in process (`amain`, a module fixture) with
every --write-json option of the slice and a profile.  Under
READSB_TPU_PLATFORM=cpu the command line replays the same IQ file with
the same options, writes aircraft.json, receiver.json and stats.json and
exits 0, and its aircraft.json equals the in-process run's apart from
`now`.  Without that variable and without a card it exits non-zero and
writes nothing.  Each option whose layer is not ported raises
NotImplementedError naming its ROADMAP item, before any work starts.
No test here runs readsb_tpu's demodulator.
"""

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from readsb_tpu.app import main as jax_main
from readsb_tpu.app.config import build_parser as jax_build_parser
from readsb_tpu_torch.app import main
from readsb_tpu_torch.app.config import build_parser
from readsb_tpu_torch.synth import build_traffic_capture

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / "cap.uc8.dat")
    build_traffic_capture(0.6, 6, 61).write_uc8(path)
    return path


def _argv(capture, out):
    """The replay's options: every --write-json option the slice has."""
    return ["--device-type", "ifile", "--ifile", capture, "--blocks-per-batch", "1",
            "--throttle", "--stats", "--write-json", str(out), "--write-json-every", "0.1",
            "--write-json-gzip", "--write-receiver-id-json", "--lat", "46.5", "--lon", "6.5"]


@pytest.fixture(scope="module")
def in_process(capture, tmp_path_factory):
    """amain() in process, once for the module, with a torch.profiler trace."""
    d = tmp_path_factory.mktemp("amain")
    mp = pytest.MonkeyPatch()
    mp.setenv("READSB_TPU_PLATFORM", "cpu")
    err = io.StringIO()
    try:
        args = main.parse_args(_argv(capture, d / "json") + ["--write-profile", str(d / "prof")])
        with contextlib.redirect_stderr(err):
            rc = asyncio.run(main.App(args).amain())
    finally:
        mp.undo()
    return rc, d, err.getvalue()


def _cli(args, platform):
    env = {k: v for k, v in os.environ.items() if k != "READSB_TPU_PLATFORM"}
    env["OMP_NUM_THREADS"] = "1"  # as torch.set_num_threads(1) above, for the child
    if platform:
        env["READSB_TPU_PLATFORM"] = platform
    return subprocess.run(
        [sys.executable, "-m", "readsb_tpu_torch.app.main", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def test_app_writes_every_json_file_and_a_profile(in_process):
    """aircraft.json (+ .gz), receiver.json, receivers.json, outline.json
    (--lat) and stats.json, a torch.profiler trace, and --stats' lines."""
    rc, d, err = in_process
    assert rc == 0
    out = d / "json"
    names = {"aircraft.json", "aircraft.json.gz", "receiver.json", "receivers.json",
             "outline.json", "stats.json"}
    assert names <= set(os.listdir(out))
    receiver = json.loads((out / "receiver.json").read_text())
    assert receiver["refresh"] == 100 and receiver["lat"] == 46.5
    st = json.loads((out / "stats.json").read_text())
    assert set(st) == {"latest", "last1min", "last5min", "last15min", "total"}
    assert st["total"]["local"]["samples_processed"] > 0
    acs = json.loads((out / "aircraft.json").read_text())["aircraft"]
    assert sum("lat" in a for a in acs) >= 4
    assert json.loads((d / "prof" / "trace.json").read_text())["traceEvents"]
    assert "readsb-tpu-torch statistics" in err and "messages total" in err


def test_cli_writes_the_json_files(capture, in_process, tmp_path):
    _, d, _ = in_process
    out = tmp_path / "json"
    r = _cli(_argv(capture, out), "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "readsb-tpu-torch statistics" in r.stderr and "messages total" in r.stderr
    for name in ("aircraft.json", "receiver.json", "stats.json"):
        got = json.loads((out / name).read_text())
        want = json.loads((d / "json" / name).read_text())
        if name == "aircraft.json":
            got.pop("now")
            want.pop("now")
            assert got == want
        elif name == "receiver.json":
            assert got == want
        else:
            assert set(got) == set(want)


def test_cli_without_a_card_exits_nonzero(capture, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "json"
    r = _cli(["--device-type", "ifile", "--ifile", capture, "--write-json", str(out)], None)
    assert r.returncode != 0
    assert "READSB_TPU_PLATFORM=cpu" in r.stderr
    assert not out.exists()


DEFERRED = [
    (["--net"], "8b"), (["--net-only"], "8b"), (["--net-ro-port", "30002"], "8b"),
    (["--net-bo-port", "30005"], "8b"), (["--net-bi-port", "30004,30104"], "8b"),
    (["--net-sbs-port", "30003"], "8b"), (["--net-json-port", "30047"], "8b"),
    (["--net-api-port", "30152"], "8b"), (["--net-connector", "127.0.0.1,30005,beast_in"], "8b"),
    (["--net-garbage", "30099"], "8b"), (["--net-vrs-port", "30033"], "8b"),
    (["--modeac-auto"], "8b"), (["--interactive"], "8b"),
    (["--write-state", "st"], "8c"), (["--write-prom", "x.prom"], "8c"),
    (["--json-globe-index"], "8c"), (["--heatmap", "2"], "8c"), (["--globe-history-dir", "h"], "8c"),
    (["--db-file", "db.csv.gz"], "8c"), (["--dump-beast", "d,30"], "8c"),
    (["--net-bulk-drain"], "8d"), (["--device-arena"], "10"),
] + [(["--device-type", t], "8e") for t in
     ("rtlsdr", "soapy", "modesbeast", "gnshulc", "hackrf", "bladerf", "ubladerf", "plutosdr")]


@pytest.mark.parametrize("extra,item", DEFERRED, ids=lambda v: " ".join(v) if isinstance(v, list) else v)
def test_deferred_options_raise_naming_their_item(extra, item, capture, monkeypatch):
    monkeypatch.setenv("READSB_TPU_PLATFORM", "cpu")
    argv = ["--device-type", "ifile", "--ifile", capture, *extra]
    with pytest.raises(NotImplementedError, match=rf"ROADMAP item {item}\b"):
        main.main(argv)


def test_viewadsb_raises_naming_its_item():
    with pytest.raises(NotImplementedError, match=r"ROADMAP item 8b\b"):
        main.viewadsb_main([])


def test_parser_parses_every_option_as_the_reference():
    """Every option of readsb_tpu's parser exists in the port's, with the
    same destination and default."""
    ref = {a.dest: a for a in jax_build_parser()._actions}
    port = {a.dest: a for a in build_parser()._actions}
    assert set(port) == set(ref)
    for dest, a in ref.items():
        assert (port[dest].option_strings, port[dest].default) == (a.option_strings, a.default), dest


def test_snip_equals_reference():
    rng = np.random.default_rng(3)
    iq = np.full(400_000, 127, dtype=np.uint8)
    loud = rng.random(200_000) < 0.02
    iq[0::2][loud] = 200
    blob = iq.tobytes()
    outs = []
    for fn in (jax_main.snip_mode, main.snip_mode):
        fout = io.BytesIO()
        fn(12, io.BytesIO(blob), fout)
        outs.append(fout.getvalue())
    assert outs[0] == outs[1] and 0 < len(outs[1]) < len(blob)
