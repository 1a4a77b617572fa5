"""The emissive regen backward's (``regen_bwd_lit_kernel``) share of its
roofline over the traced fit step: its bytes at the HBM rate
(``pb_core.peaks_regen_lit.bwd_bytes``: the residual planes and the
cotangent planes, the emission's included, of the live lane-iterations,
counted by the reference as the differentiated half's segments) over the
summed device time of its launches in that step."""

from pb_core import peaks, peaks_regen_lit as prl
from pb_core.readers import in_step

KERNEL = "regen_bwd_lit_kernel<"


def read(run):
    ops, work = in_step(run), getattr(run, "work", None)
    if ops is None or not work:
        return None
    mine = [d for n, _, d, _ in ops if KERNEL in n]
    if not mine:
        return None
    nbytes = prl.bwd_bytes(work["segments_grad"], run.softness > 0.0)
    return peaks.roofline_pct(prl.bytes_least_seconds(nbytes), sum(mine))
