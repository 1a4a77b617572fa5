"""The regen re-forward's (``regen_kernel<2, V>``, the build every call
takes: its planes do not depend on emission) share of its roofline over the
traced fit step of an emitter-lit scene: its bytes at the HBM rate
(``pb_core.peaks_regen_lit.refwd_bytes``, the differentiated half's
segments counted by the reference as the live lane-iterations) over the
summed device time of its launches in that step."""

from pb_core import peaks, peaks_regen_lit as prl
from pb_core.readers import in_step

KERNEL = "regen_kernel<2,"


def read(run):
    ops, work = in_step(run), getattr(run, "work", None)
    if ops is None or not work:
        return None
    mine = [d for n, _, d, _ in ops if KERNEL in n]
    if not mine:
        return None
    r = run.rcfg
    entries = prl.step_entries(int(r["width"]), int(r["height"]), int(r["spp"]),
                               int(r["max_depth"]), len(mine))
    nbytes = prl.refwd_bytes(work["segments_grad"], entries, run.softness > 0.0)
    return peaks.roofline_pct(prl.bytes_least_seconds(nbytes), sum(mine))
