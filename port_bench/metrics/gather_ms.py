"""Rank 0's time of gather_tiles (the NCCL all-reduce of the zero-padded
tiles) per traced frame, after a barrier, until torch.cuda.synchronize()
returns."""


def read(run):
    g = getattr(run, "gather_s", None)
    if not g:
        return None
    return 1e3 * sum(g) / len(g)
