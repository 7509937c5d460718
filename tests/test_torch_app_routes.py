"""The port's App against readsb_tpu's on the two other routes:
run_ifile_multi over four uc8 files (one MultiDemodulator, frames tagged
with their receiver) and one uc8 file under --modeac (the ungated
magnitude route with Mode A/C replies, matched to the aircraft by
`match_ac`).  The comparisons are test_torch_app.py's.  The captures
here are 0.3 s, one odd/even pair per aircraft, so both routes run with
--json-reliable 0: aircraft.json shows a position after one global
decode."""

import pytest
import torch

from readsb_tpu_torch.decode.mode_ac import modec_to_modea
from readsb_tpu_torch.synth import build_traffic_capture
from tests.test_torch_app import RESULT_KEYS, argv_for, check_run, check_signal_cut, run_both

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def app_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("app_routes")
    paths = []
    for c in range(4):
        p = str(d / f"rx{c}.uc8.dat")
        build_traffic_capture(0.3, 5, 50 + c, addr_base=0x480000 + c * 0x10000).write_uc8(p)
        paths.append(p)
    cap = build_traffic_capture(0.3, 6, 47)
    # Mode C replies at the first aircraft's altitude (3000 ft), and
    # Mode A replies of one squawk that no aircraft sends
    for i in range(8):
        cap.add_modeac(modec_to_modea(30), 0.021 + 0.035 * i, amplitude=0.5)
        cap.add_modeac(0x1200, 0.036 + 0.035 * i, amplitude=0.45)
    cap.write_uc8(str(d / "ac.uc8.dat"))
    routes = {
        "multi": argv_for(",".join(paths), "--json-reliable", "0"),
        "modeac": argv_for(str(d / "ac.uc8.dat"), "--modeac", "--json-reliable", "0"),
    }
    mp = pytest.MonkeyPatch()
    try:
        return {name: run_both(argv, mp) for name, argv in routes.items()}
    finally:
        mp.undo()


@pytest.mark.parametrize("route", ["multi", "modeac"])
def test_app_run_decodes_traffic(app_runs, route):
    check_run(*app_runs[route], 0.3)


def test_routes_reach_their_paths(app_runs):
    """The multi run tags frames with receivers 1-4; the Mode A/C run
    counts replies and matches the Mode C code to an aircraft."""
    multi = app_runs["multi"][1]
    assert {a["hex"][:2] for a in multi["aircraft.json"]["aircraft"]} == {"48", "49", "4a", "4b"}
    assert "receiver_id=4" in multi["aircraft"]
    ac = app_runs["modeac"][1]
    assert ac["demod"][5] >= 12
    assert "modec_hit=True" in ac["aircraft"]


@pytest.mark.parametrize("route", ["multi", "modeac"])
def test_signal_differs_only_in_the_scan_tail(app_runs, route):
    check_signal_cut(app_runs[route][1])


@pytest.mark.parametrize("key", RESULT_KEYS)
@pytest.mark.parametrize("route", ["multi", "modeac"])
def test_app_equals_reference(app_runs, route, key):
    want, got = app_runs[route]
    assert got[key] == want[key]
