"""Host time per superblock in the upload, ms: the program's "upload" spans
(pipeline._words_from_bytes / _to_mag: the host copy, the host-to-device
copy and the enqueue of the magnitude conversion)."""

from portbench import programspans


def read(ctx):
    w = programspans.of(ctx)
    return None if w is None else w.ms_per_sb("upload")
