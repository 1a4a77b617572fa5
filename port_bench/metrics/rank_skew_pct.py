"""How much longer the slowest rank's render_accum_sharded takes than the
ranks' mean, in the traced frames (each rank synchronised, between
barriers): 100 x (max / mean - 1)."""


def read(run):
    per_rank = [sum(r) / len(r) for r in (getattr(run, "rank_render_s", None) or []) if r]
    if len(per_rank) < 2:
        return None
    return 100.0 * (max(per_rank) / (sum(per_rank) / len(per_rank)) - 1.0)
