"""The program under test, imported from the checkout, and the benchmark's
inputs handed to it in its own types."""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from .spec import ROOT

PROGRAM = "simplepathtracer_tpu_torch"
# Top-level module names that may not be loaded in a run (compared whole:
# the program's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "simplepathtracer_tpu")


class ProgramMissing(RuntimeError):
    pass


def load(root: Path = ROOT):
    """The program package from ``root`` (the checkout), never one installed
    elsewhere: raises ``ProgramMissing`` where the checkout holds none."""
    pkg = root / PROGRAM / "__init__.py"
    if not pkg.is_file():
        raise ProgramMissing(f"{pkg} not found: the checkout holds no program to measure")
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import importlib

    mod = importlib.import_module(PROGRAM)
    if Path(mod.__file__).resolve() != pkg.resolve():
        raise ProgramMissing(f"{PROGRAM} was imported from {mod.__file__}, not from {root}")
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN and sys.modules.get(m) is not None})


def key_tensor(key) -> torch.Tensor:
    """A key of two u32 words as the program takes it."""
    return torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64)


def scene(tpt, tables: dict):
    """The program's ``Scene`` from the benchmark's tables (tensors on the
    device)."""
    return tpt.Scene(
        centers=tables["centers"].clone(), radii=tables["radii"].clone(),
        albedo=tables["albedo"].clone(), material=tables["material"].to(torch.int32),
        fuzz=tables["fuzz"].clone(), ior=tables["ior"].clone(),
        sky_lo=tables["sky_lo"].clone(), sky_hi=tables["sky_hi"].clone(),
    )


def camera(tpt, cam: dict):
    """The program's ``Camera`` from the benchmark's camera tensors."""
    return tpt.Camera(**{k: v.detach().clone() for k, v in cam.items()})


RENDER_KEYS = ("width", "height", "spp", "max_depth", "t_min", "t_max", "gamma",
               "rr_start_depth")


def render_block(cfg: dict, **over) -> dict:
    """A configuration's render settings (its top-level sizes)."""
    return dict({k: cfg[k] for k in RENDER_KEYS if k in cfg}, **over)


def render_config(tpt, r: dict, flags: dict | None = None):
    """The program's ``RenderConfig`` of a render block, forward kernel on
    (``flags``: other route flags, for runs on the CPU)."""
    cfg = tpt.RenderConfig(
        width=int(r["width"]), height=int(r["height"]), spp=int(r["spp"]),
        max_depth=int(r["max_depth"]), t_min=float(r["t_min"]), t_max=float(r["t_max"]),
        gamma=float(r["gamma"]), rr_start_depth=int(r.get("rr_start_depth", 0)),
        use_pallas=True,
    )
    return cfg.replace(**flags) if flags else cfg
