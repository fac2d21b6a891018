"""Sharded batch ASR and the data-parallel train step (port of the JAX
package's ``parallel/sharded.py``).

Serving, on a (d, a) mesh: the copy axis is padded with identity
transforms to a multiple of a (``SRConfig.num_valid`` marks the real
copies), in contiguous blocks of N_pad / a with the padding at the end, as
JAX shards it. Each rank warps and forwards its block of the copies for
its data group's B / d images (the batch on the kernels' channel axis, as
on one card), extracts the masks, gathers its data group's blocks (one
all-reduce over the aug group) and runs the one-card tail (normalization,
max/mean, b and the solve, threshold) on the whole padded stack with the
padded config and the shared stencil: the solve is replicated across the
aug group. JAX's GSPMD partitions one program instead; the forward, which
this split shortens, is most of an image's time.

Training: the whole mesh is data parallel (``models.train.build_train_step``
with the mesh): a slice of the global batch a rank, synchronised
BatchNorm and one all-reduce of the gradient.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..models.deeplab import DeepLab
from ..pipeline.end_to_end import CopyShard, asr_step, asr_step_multiclass
from ..sr.solver import SRConfig, pad_copies
from .mesh import Mesh, Sharding, data_sharding, host_local_batch_to_global


def padded_aug_count(num_aug: int, mesh: Mesh) -> int:
    """Smallest multiple of the "aug" axis size >= num_aug: a copy count that
    does not split over the aug ranks (e.g. the production 100 copies on 3)
    runs padded with identity copies that every data term weights 0
    (SRConfig.num_valid)."""
    aug = mesh.shape["aug"]
    return -(-num_aug // aug) * aug


def padded_sr_cfg(sr_cfg: SRConfig, mesh: Mesh) -> SRConfig:
    """Public alias of the aug-padding rule: the SRConfig the batched step
    actually runs (extract the shared Gram stencil with it)."""
    return _padded_cfg(sr_cfg, mesh)


def _padded_cfg(sr_cfg: SRConfig, mesh: Mesh) -> SRConfig:
    padded = padded_aug_count(sr_cfg.num_aug, mesh)
    if padded == sr_cfg.num_aug:
        return sr_cfg
    if sr_cfg.num_valid:
        raise ValueError("sr_cfg.num_valid is managed by the parallel layer; "
                         "pass the real copy count as num_aug")
    return dataclasses.replace(sr_cfg, num_aug=padded, num_valid=sr_cfg.num_aug)


def gather_copies(mesh: Mesh, n_pad: int, blocks: Sequence[Optional[torch.Tensor]],
                  dim: int) -> Tuple[Optional[torch.Tensor], ...]:
    """The whole stacks (n_pad along dim) from this rank's blocks (n_pad / a
    along dim) and its aug group's: one all-reduce (sum) of a zero-filled
    buffer into which each rank wrote its blocks, so every value arrives
    unchanged. None passes through. The blocks share one dtype."""
    start, length = mesh.block("aug", n_pad)
    present = [b for b in blocks if b is not None]
    shapes = []
    for b in present:
        shape = list(b.shape)
        shape[dim] = n_pad
        shapes.append(shape)
    sizes = [torch.Size(s).numel() for s in shapes]
    flat = present[0].new_zeros(sum(sizes))
    fulls = [part.view(shape) for part, shape in zip(flat.split(sizes), shapes)]
    for full, b in zip(fulls, present):
        full.narrow(dim, start, length).copy_(b)
    mesh.all_reduce(flat, "sum", axis="aug")
    out = iter(fulls)
    return tuple(None if b is None else next(out) for b in blocks)


def broadcast_module(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every rank's module buffers and parameters become rank 0's: one
    broadcast per dtype, of the tensors flattened together."""
    tensors = list(module.buffers()) + list(module.parameters())
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = mesh.broadcast(torch.cat([t.detach().reshape(-1) for t in group]))
        with torch.no_grad():
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return module


def make_asr_batch_fn(mesh: Mesh, model: DeepLab, sr_cfg: SRConfig, class_id,
                      mode: str = "argmax", th_factor: float = 0.15,
                      sr_types: Tuple[str, ...] = ("aug", "max", "mean"),
                      chunk_size: int = 0, class_chunk: int = 0,
                      gram_coeffs: Optional[torch.Tensor] = None,
                      return_targets: bool = False,
                      return_label_map: bool = False,
                      pack_uint8: bool = False, timer=None):
    """Returns fn(images, angles, shifts) -> dict of masks for this rank.

    images: (B / d, H, W, 3), this rank's data slice of the batch; angles
    (N_pad / a,) and shifts (N_pad / a, 2): its block of the PADDED copy set
    that the batch shares (``shard_batch`` gives both). Every value of the
    result is (B / d, H, W, 1) per SR type and "standard", (B / d, K, H, W,
    1) for a tuple of classes (asr_step_multiclass); the aug ranks of a data
    group compute the same masks, and "standard" is the identity copy's on
    aug index 0 only (the block holding copy 0).

    Every rank calls it together: the model's weights are broadcast from
    rank 0 once, here, and so is gram_coeffs (a stencil of the fixed set
    extracted with the PADDED cfg, ``padded_sr_cfg``): every rank passes a
    tensor of its shape, or every rank None. Each call runs two
    all-reduces over the aug group (the set's blocks, then the masks').
    pack_uint8: masks as uint8 ({0, class_id} is lossless), the targets
    float. timer: given the step's stages, "gather" among them.
    """
    sr_cfg = _padded_cfg(sr_cfg, mesh)
    broadcast_module(mesh, model)
    if gram_coeffs is not None:
        gram_coeffs = mesh.broadcast(gram_coeffs.contiguous())
    multiclass = isinstance(class_id, (tuple, list)) and len(class_id) > 1
    one_class = class_id[0] if isinstance(class_id, (tuple, list)) else class_id
    n_pad = sr_cfg.num_aug

    def batch_fn(images: torch.Tensor, angles: torch.Tensor, shifts: torch.Tensor):
        full_angles, full_shifts = gather_copies(mesh, n_pad, (angles, shifts), 0)
        copies = CopyShard(angles, shifts,
                           lambda *masks: gather_copies(mesh, n_pad, masks, -4))
        kw = dict(mode=mode, th_factor=th_factor, sr_types=sr_types,
                  chunk_size=chunk_size, gram_coeffs=gram_coeffs,
                  return_targets=return_targets, timer=timer, copies=copies)
        if multiclass:
            out = asr_step_multiclass(model, images, full_angles, full_shifts, sr_cfg,
                                      tuple(class_id), class_chunk=class_chunk,
                                      return_label_map=return_label_map, **kw)
        else:
            out = asr_step(model, images, full_angles, full_shifts, sr_cfg, one_class,
                           **kw)
        if pack_uint8:
            out = {k: (v if k.endswith("_target") else v.to(torch.uint8))
                   for k, v in out.items()}
        return out

    return batch_fn


def make_sharded_train_step(mesh: Mesh, model: DeepLab, tx, bn_momentum: float = 0.9,
                            remat: bool = False, skip_nonfinite: bool = False):
    """Data-parallel train step over the whole mesh (``models.train``'s step
    with the mesh): training has no copy axis, so both mesh axes act as
    data axes; each rank takes its slice of the global batch
    (``shard_train_batch``), the parameters are rank 0's from the first
    step on, BatchNorm is synchronised (per-rank statistics would diverge
    at small per-rank batches), one all-reduce gives every rank the global
    batch's gradient, and the returned loss is the global mean.

    Returns step(master, opt_state, images, labels) -> (master, opt_state,
    loss), updating master and opt_state in place."""
    from ..models.train import build_train_step

    return build_train_step(model, tx, bn_momentum, remat=remat,
                            skip_nonfinite=skip_nonfinite, mesh=mesh)


def shard_train_batch(mesh: Mesh, images: torch.Tensor, labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's slice of a (B, H, W, 3) / (B, H, W) global training batch,
    split over every rank of the mesh (rank r takes samples [r * B / size,
    (r + 1) * B / size)). B must be a multiple of the mesh size."""
    n = mesh.size
    if images.shape[0] % n:
        raise ValueError(f"global batch {images.shape[0]} not divisible by "
                         f"the {n}-device mesh")
    per = images.shape[0] // n
    return (images.narrow(0, mesh.rank * per, per),
            labels.narrow(0, mesh.rank * per, per))


def copy_block(mesh: Mesh, angles: torch.Tensor, shifts: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The set padded to the aug axis, then this rank's block of it."""
    angles, shifts = pad_copies(angles, shifts, padded_aug_count(angles.shape[0], mesh))
    block = Sharding(mesh, ("aug",))
    return block(angles), block(shifts)


def shard_batch(mesh: Mesh, images: torch.Tensor, angles: torch.Tensor,
                shifts: torch.Tensor):
    """(this rank's images, its block of angles, of shifts) of a whole
    batch: images (B, H, W, 3) split over "data"; angles (N,) and shifts
    (N, 2), the set the batch shares, padded with identity transforms to a
    multiple of the aug axis (as ``make_asr_batch_fn``'s padded SRConfig)
    and split over "aug". (JAX's also places the params; here
    ``make_asr_batch_fn`` makes every rank's weights rank 0's.)"""
    return (data_sharding(mesh)(images),) + copy_block(mesh, angles, shifts)


def shard_batch_multihost(mesh: Mesh, images: torch.Tensor, angles: torch.Tensor,
                          shifts: torch.Tensor):
    """``shard_batch`` for a process that loaded only its own images (the
    multi-host input path). With one process per rank, as here, every
    process is a rank, and its own images are its data slice: they pass
    through (``host_local_batch_to_global``), and the set is padded and
    split as in ``shard_batch``."""
    images = host_local_batch_to_global(mesh, images, ("data",))
    return (images,) + copy_block(mesh, angles, shifts)
