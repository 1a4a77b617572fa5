"""Multi-device rendering on ``torch.distributed``: meshes, the sharded
render and the sharded gradient (counterpart of the JAX package's
``parallel/sharding.py``).

One process owns one device.  The processes form a 2-D
``torch.distributed.device_mesh.DeviceMesh`` with the dimensions

    ("tiles", "samples")

where the image's pixels are split along ``tiles`` and the samples per
pixel along ``samples``.  Rank (ti, si) renders the pixel ids
``ti * p_local + arange(p_local)`` for the samples ``sample_offset +
si * s_local`` onwards through ``render.render_pixel_block`` (on CUDA the
persistent kernel forward, the regeneration kernels under a gradient), and
the partial sums are added over the ``samples`` group with
``dist.all_reduce``.  The scene and camera are replicated (each process
holds its own copy).

Determinism: every random number is keyed by global (pixel, sample) ids,
so a (tiles, samples) split cannot change which samples a pixel sums.  A
tiles-only split keeps each pixel's sum in the same order and gives the
single-process image bit for bit; a samples split adds per-rank partial
sums (and ``render_pixel_block`` picks its spp chunk per rank), so it
agrees to the rounding of two orders of the same sum.

The gradient is taken by the cotangent method: each rank all-reduces a
detached copy of its block over ``samples``, forms the pixel-MSE's
cotangent of its own block from the reduced mean and pulls it back
through its own render (``torch.autograd.backward``), and the leaves'
gradients are all-reduced over the whole mesh.  No collective sits inside
the differentiated graph: the adjoint of an all-reduce would all-reduce
the cotangent again and multiply every gradient by the samples count (the
inflation the JAX package's ``_psum_samples_unchecked`` corrects).

Collectives: ``all_reduce`` only (gloo runs it on CUDA tensors through
host memory, so two ranks may share one card under ``backend="gloo"``;
NCCL refuses two ranks on one device).  The image gather is an
all-reduce over ``tiles`` of zero-padded tiles, which adds exact zeros.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..inverse import merge_params, split_params
from ..render import grad_safe_config, render_pixel_block
from ..types import Camera, RenderConfig, RenderState, Scene

MESH_DIMS = ("tiles", "samples")


def make_mesh(tiles: int | None = None, samples: int = 1, device_type=None) -> DeviceMesh:
    """A ('tiles', 'samples') mesh over every process of the job (one device
    each), ranks laid out row-major: rank = ti * samples + si.

    With ``tiles=None`` every process not used by ``samples`` goes to the
    tile axis.  ``device_type`` is the processes' device type, ``cuda``
    unless named.  Needs an initialized process group
    (``initialize_cluster`` or ``torch.distributed.init_process_group``).
    """
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "parallel.initialize_cluster (or torch.distributed.init_process_group) first"
        )
    n = dist.get_world_size()
    if tiles is None:
        if n % samples:
            raise ValueError(f"{n} devices not divisible by samples={samples}")
        tiles = n // samples
    if tiles * samples != n:
        raise ValueError(f"mesh {tiles}x{samples} != {n} devices")
    return init_device_mesh(device_type or "cuda", (tiles, samples), mesh_dim_names=MESH_DIMS)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{'tiles': nt, 'samples': ns} (the JAX ``Mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_coords(mesh: DeviceMesh):
    """This process's (tile, sample) coordinates in ``mesh``."""
    return mesh.get_local_rank("tiles"), mesh.get_local_rank("samples")


def _block_sizes(config: RenderConfig, mesh: DeviceMesh):
    shape = mesh_shape(mesh)
    nt, ns = shape["tiles"], shape["samples"]
    p_total = config.num_pixels
    if p_total % nt:
        raise ValueError(f"{p_total} pixels not divisible by tiles={nt}")
    if config.spp % ns:
        raise ValueError(f"{config.spp} spp not divisible by samples={ns}")
    return p_total // nt, config.spp // ns


def _check_device(mesh: DeviceMesh, *tensors):
    """Every tensor must lie on the mesh's device type: a CUDA mesh with CPU
    tensors raises (nothing falls back to another device)."""
    for t in tensors:
        if t is not None and t.device.type != mesh.device_type:
            raise ValueError(
                f"a {mesh.device_type} mesh needs its tensors on {mesh.device_type}, "
                f"got {t.device}"
            )


def _all_reduce(t, mesh: DeviceMesh, dim: str):
    """Sum ``t`` in place over the mesh dimension ``dim`` (no-op when that
    dimension has one process)."""
    if mesh_shape(mesh)[dim] > 1:
        dist.all_reduce(t, group=mesh.get_group(dim))
    return t


def render_accum_sharded(
    scene: Scene, camera: Camera, config: RenderConfig, key, mesh: DeviceMesh,
    sample_offset: int = 0, n_samples: int | None = None,
):
    """This process's tile of the sharded radiance SUM: [P / tiles, 3], the
    rows of pixels ``ti * P / tiles`` onwards summed over ``n_samples`` spp
    (default all of ``config.spp``) from ``sample_offset``.

    Each (tile, sample) rank renders its pixel block for its sample slice;
    the slices are summed over ``samples``, so every rank of a tile holds
    its pixels' full sums.  ``sample_offset`` continues the global sample
    ids -- the resume hook of ``checkpoint.save_sharded``: accumulating
    [0, k) then [k, spp) sums the same samples as one [0, spp) pass.
    Forward only."""
    if n_samples is None:
        n_samples = config.spp
    p_local, _ = _block_sizes(config, mesh)
    ns = mesh_shape(mesh)["samples"]
    if n_samples % ns:
        raise ValueError(f"{n_samples} spp not divisible by samples={ns}")
    s_local = n_samples // ns
    _check_device(mesh, scene.centers, camera.origin)
    ti, si = mesh_coords(mesh)
    pixel_ids = ti * p_local + torch.arange(p_local, device=scene.device)
    with torch.no_grad():
        acc = render_pixel_block(
            scene, camera, config, key, pixel_ids, sample_offset + si * s_local, s_local,
        )
    return _all_reduce(acc.contiguous(), mesh, "samples")


def gather_tiles(acc_local, config: RenderConfig, mesh: DeviceMesh):
    """The full [P, 3] array on every rank from each rank's tile rows (an
    all-reduce over ``tiles`` of the zero-padded tiles: exact)."""
    p_local, _ = _block_sizes(config, mesh)
    ti, _ = mesh_coords(mesh)
    full = acc_local.new_zeros((config.num_pixels, 3))
    full[ti * p_local:(ti + 1) * p_local] = acc_local
    return _all_reduce(full, mesh, "tiles")


def render_sharded(scene: Scene, camera: Camera, config: RenderConfig, key,
                   mesh: DeviceMesh) -> torch.Tensor:
    """Sharded one-shot render -> the [H, W, 3] gamma-corrected image in
    [0, 1], on every rank (``render``'s image, as ``RenderState.image``
    forms it)."""
    acc = gather_tiles(render_accum_sharded(scene, camera, config, key, mesh), config, mesh)
    state = RenderState(accum=acc.reshape(config.height, config.width, 3),
                        sample_count=config.spp, next_key=key)
    return state.image(config.gamma)


# ---------------------------------------------------------------------------
# The sharded gradient step.


def split_scene(scene: Scene):
    """(the scene's differentiable leaves as a dict, the scene): every leaf
    of ``inverse.DIFF_LEAVES`` the scene has."""
    return split_params(scene)


merge_scene = merge_params


def loss_and_grad_sharded(scene: Scene, target, camera: Camera, config: RenderConfig, key,
                          mesh: DeviceMesh):
    """Sharded pixel-MSE loss and its gradient in the scene's
    differentiable leaves: (loss, {leaf: gradient}), the same on every
    rank.

    ``target``: [H, W, 3] *linear* radiance (pre-gamma), on every rank.
    The loss is the mean squared error of the per-pixel sample mean over
    all spp.  The config goes through ``grad_safe_config`` for the mesh's
    device (on CUDA a ``use_pallas`` preset takes the regeneration kernels
    and the bucket).  The gradient: each rank's block ``acc`` (its tile,
    its samples) is summed over ``samples`` detached, the cotangent
    2 (mean - target) / (P 3) / spp of its rows is pulled back through
    ``acc`` alone, and the leaves' gradients are summed over the mesh; the
    loss is summed over ``tiles``."""
    dev = scene.centers.device
    _check_device(mesh, scene.centers, target, camera.origin)
    config = grad_safe_config(config, dev)
    p_local, s_local = _block_sizes(config, mesh)
    p_total = config.num_pixels
    inv_spp = 1.0 / config.spp
    ti, si = mesh_coords(mesh)
    pixel_ids = ti * p_local + torch.arange(p_local, device=dev)
    params, rest = split_scene(scene)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    acc = render_pixel_block(merge_scene(leaves, rest), camera, config, key, pixel_ids,
                             si * s_local, s_local)
    total = _all_reduce(acc.detach().clone(), mesh, "samples")
    target_local = target.reshape(p_total, 3)[ti * p_local:(ti + 1) * p_local]
    diff = total * inv_spp - target_local
    loss = torch.sum(diff * diff) / (p_total * 3)
    ct = (2.0 * diff / (p_total * 3)) * inv_spp
    torch.autograd.backward(acc, ct)
    grads = [torch.zeros_like(v) if v.grad is None else v.grad for v in leaves.values()]
    # Every leaf's gradient in one buffer, summed over the whole mesh.
    flat = torch.cat([g.reshape(-1) for g in grads])
    _all_reduce(_all_reduce(flat, mesh, "samples"), mesh, "tiles")
    out, k = {}, 0
    for name, g in zip(leaves, grads):
        out[name] = flat[k:k + g.numel()].reshape(g.shape)
        k += g.numel()
    return _all_reduce(loss.detach(), mesh, "tiles"), out


def train_step_sharded(scene: Scene, target, camera: Camera, config: RenderConfig, key,
                       mesh: DeviceMesh, lr=1e-2):
    """One SGD step on the differentiable scene leaves: (scene, loss)."""
    loss, grads = loss_and_grad_sharded(scene, target, camera, config, key, mesh)
    params, rest = split_scene(scene)
    new = {k: (p - lr * grads[k]).detach() for k, p in params.items()}
    return merge_scene(new, rest), loss
