"""Small runs of the benchmark's cells on the CPU: the cell's own files at a
size a test can hold, the program on its plain versions of the kernels the
cell's route takes on the GPU."""

import torch

# 48 x 24 pixels: every size the harness reads is its own, only smaller.
SMALL = {"render": {"width": 48, "height": 24, "spp": 8}}
# The GPU routes' plain versions: the regeneration route for scene fits, the
# fused route for camera fits.
FLAGS = {
    "cover.fit_soft": {"use_pallas": False, "use_pallas_grad": True, "grad_regen": True},
    "cover.fit_camera": {"use_pallas": False, "use_pallas_grad": True},
}


def overrides(cell: str, **extra) -> dict:
    o = dict(SMALL, **extra)
    if cell in FLAGS:
        o["flags"] = FLAGS[cell]
    if cell.startswith("cover_multihost"):
        o["cpu"] = True
    return o


def run(cell: str, seed: int, trace: bool = False, seconds: float = 0.2, **extra):
    from pb_core import harness

    torch.set_num_threads(2)
    return harness.run_cell(cell, seed, seconds, trace, need_chip=False, device="cpu",
                            overrides=overrides(cell, **extra))
