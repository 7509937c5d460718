"""Host time per superblock on the ICAO filters, ms: the program's "icao"
spans (each channel's filter aged, DeviceIcaoMirror.add_from_frames and
expire)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("icao")
