"""The least times of a lit fit step's regeneration kernels (frozen: a later
change that does less work is measured against these).

The step renders ``spp`` samples of every pixel through the idx-only
forward (two decoupled halves) and differentiates the second half through
the re-forward and the backward, a chunk of ``chunk`` samples at a time.
The reference (``pb_reference.grad_lit``) counts the work: every pass's
segments and threefry2x32 evaluations, and the differentiated half's
segments, which are the chunks' live lane-iterations.

* The forward's least time is the larger of its scan's FP32 time
  (segments x live spheres x ``peaks.FLOPS_SOFT_TEST``, or the hard
  test's, at ``peaks.PEAK_FP32``) and its RNG's INT32 time (the
  evaluations at ``peaks_lit``'s rate).
* The re-forward's and the backward's are their bytes at
  ``peaks.PEAK_BYTES``, counted as PERF.md section 6 counts rows 4s and 3s.
  A chunk's planes are [n_iter, n_lanes]: one lane a pixel (one bank),
  n_iter = chunk x max_depth rounded up to a multiple of 9.  The
  re-forward reads the packed winner words (soft: and the blockers', 4 B
  per 3 lane-iterations each), writes every residual plane of a live
  lane-iteration (``RES_PLANES``) and alive and idx (soft: and bidx) of a
  dead one: the backward finds each lane's count in alive and the bucket
  reads every idx.  The backward reads every residual plane of a live
  lane-iteration and writes its cotangent planes (``CT_PLANES``: the
  winner's 9, the emission's 3, soft the blocker's 4).  Its dead
  lane-iterations are not counted: the bucket reads no cotangent of a row
  that names no sphere, so the zeros that today's layout stores there
  (about four fifths of a chunk's entries under roulette) and the alive
  words it reads there are this kernel's choice, not the function's; a
  backward that skips them is measured against the same count.
"""

from . import peaks, peaks_lit

CHUNK_ITERS = 9
RES_PLANES = {False: 25, True: 30}
CT_PLANES = {False: 12, True: 16}


def n_iter(chunk: int, max_depth: int) -> int:
    """Iterations of a chunk's planes."""
    return -(-chunk * max_depth // CHUNK_ITERS) * CHUNK_ITERS


def fwd_least_seconds(segments: int, live_spheres: int, evals: int, soft: bool) -> float:
    """The forward's least time: its scan's FP32 time or its RNG's INT32
    time, whichever is larger."""
    flops = peaks.FLOPS_SOFT_TEST if soft else peaks.FLOPS_HARD_TEST
    return max(peaks.scan_least_seconds(segments, live_spheres, flops),
               peaks_lit.rng_least_seconds(evals))


def refwd_bytes(live: int, entries: int, soft: bool) -> int:
    """Bytes of the re-forward over chunks of ``entries`` lane-iterations
    in all, ``live`` of them live."""
    words = (2 if soft else 1) * 4 * entries // 3
    dead = 12 if soft else 8
    return words + live * RES_PLANES[soft] * 4 + (entries - live) * dead


def bwd_bytes(live: int, soft: bool) -> int:
    """Bytes of the emissive backward over chunks of ``live`` live
    lane-iterations in all."""
    return live * (RES_PLANES[soft] + CT_PLANES[soft]) * 4


def bytes_least_seconds(nbytes: int) -> float:
    return nbytes / peaks.PEAK_BYTES


def step_entries(width: int, height: int, spp: int, max_depth: int, launches: int) -> int:
    """Lane-iterations of the planes of a step whose differentiated half
    (spp - spp / 2 samples) ran in ``launches`` chunks."""
    chunk = (spp - spp // 2) // launches
    return launches * n_iter(chunk, max_depth) * width * height
