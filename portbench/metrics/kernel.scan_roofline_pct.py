"""The dense scan's share of its memory roofline, %: the least time its
bytes need at the card's peak bandwidth over the scan kernel's device
time.  The same work on both routes: dense_scan_uc8 (#1) on UC8,
dense_scan (#4) on SC16, both the kernel dense_tile of csrc/dense_scan.cuh."""

from portbench import peaks, roofline

KERNELS = ("dense_tile",)


def read(ctx):
    ev = ctx.kernels(KERNELS)
    bw = peaks.peak(ctx.device_name, "hbm_bytes_per_s")
    if not ev or bw is None:
        return None
    t = sum(b - a for _, a, b, _ in ev) / 1e9
    need = len(ev) * roofline.scan_bytes(roofline.scan_samples(ctx.cfg)) / bw
    return 100.0 * need / t
