"""The extraction kernel's share of its memory roofline, %, counted at the
candidates each superblock really had (not the capacity it was launched
with): csrc/extract_syndromes.cu, the kernel cand_rows of csrc/extract.cuh."""

from portbench import peaks, roofline

KERNELS = ("cand_rows",)


def read(ctx):
    ev = ctx.kernels(KERNELS)
    bw = peaks.peak(ctx.device_name, "hbm_bytes_per_s")
    if not ev or bw is None or not ctx.n_calls:
        return None
    t = sum(b - a for _, a, b, _ in ev) / 1e9
    per_launch = len(ev) / ctx.n_calls  # > 1 where a dispatch was redone
    need = per_launch * sum(roofline.extract_bytes(n) for n in ctx.candidates()) / bw
    return 100.0 * need / t
