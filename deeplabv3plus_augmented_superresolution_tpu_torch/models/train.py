"""Training support for the DeepLabV3+ port.

Counterpart of the JAX package's ``models/train.py``: a train step with a
bf16 (or f32) forward, f32 loss and gradients, the optax-semantics
optimizers of ``models/optim.py`` and the Keras EMA of the BatchNorm moving
statistics, over the same Keras-named parameter dict the weight loaders
fill.

The parameters are f32 master tensors in ONE flat buffer
(``MasterParams``): ``params`` is the Keras-named dict of views into it, in
the port's layout (OIHW kernels), which the training forward reads
(``DeepLab.forward_train``) and whose gradients autograd accumulates into a
flat gradient buffer of the same layout. The optimizer, the EMA and the
non-finite guard then act on whole buffers: a few dozen launches a step
whatever the number of layers, and no host synchronisation. The step
updates the buffers in place (the reference's step is pure; in place saves
a copy of every buffer) and returns them in the reference's call shape.
"""

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .deeplab import BNStats, DeepLab
from .optim import OptState, TrainOptimizer
from .weights import to_reference_layout

TorchParams = Dict[str, Dict[str, torch.Tensor]]


class MasterParams:
    """The f32 master parameters in one flat buffer, in the reference's tree
    order (layer names sorted, then weight names: jax's dict flattening,
    which optax's state and the checkpoint follow). ``params`` holds the
    Keras-named views (port layout); each view is a leaf that requires
    grad, with its ``.grad`` a view of ``grad``, so a backward pass
    accumulates straight into the flat gradient."""

    def __init__(self, params: TorchParams, device):
        self.keys: List[Tuple[str, str]] = [(layer, name) for layer in sorted(params)
                                            for name in sorted(params[layer])]
        tensors = [torch.as_tensor(params[l][w]) for l, w in self.keys]
        self.shapes = [tuple(t.shape) for t in tensors]
        self.offsets = np.cumsum([0] + [t.numel() for t in tensors]).tolist()
        self.flat = torch.cat([t.detach().reshape(-1).to(device, torch.float32)
                               for t in tensors])
        self.grad = torch.zeros_like(self.flat)
        self.params: TorchParams = {}
        for (layer, name), view, grad in zip(self.keys, self.leaves(self.flat),
                                             self.leaves(self.grad)):
            view.requires_grad_(True)
            view.grad = grad
            self.params.setdefault(layer, {})[name] = view

    def leaves(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Views of a flat buffer of this layout, one per parameter."""
        return [flat[a:b].view(shape) for a, b, shape in
                zip(self.offsets[:-1], self.offsets[1:], self.shapes)]

    def views(self, flat: torch.Tensor) -> TorchParams:
        """The Keras-named dict of views of a flat buffer of this layout."""
        out: TorchParams = {}
        for (layer, name), view in zip(self.keys, self.leaves(flat)):
            out.setdefault(layer, {})[name] = view
        return out

    def numpy_params(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The parameters as the reference's dict: numpy arrays of their own
        (no memory shared with the buffer), reference layout."""
        out: Dict[str, Dict[str, np.ndarray]] = {}
        host = self.flat.detach().cpu().numpy().copy()
        for (layer, name), a, b, shape in zip(self.keys, self.offsets[:-1],
                                              self.offsets[1:], self.shapes):
            out.setdefault(layer, {})[name] = np.ascontiguousarray(
                to_reference_layout(name, host[a:b].reshape(shape)))
        return out


def forward_train(model: DeepLab, params: TorchParams, images: torch.Tensor,
                  remat: bool = False, sync_group=None) -> Tuple[torch.Tensor, BNStats]:
    """Forward pass with batch-statistics BatchNorm: (logits, bn_batch_stats),
    the latter mapping each BN layer's name to its batch (mean, var); feed it
    to ``update_bn_stats``. sync_group: the statistics of the batch that
    the group's ranks share (synchronised BatchNorm)."""
    return model.forward_train(images, params, remat=remat, sync_group=sync_group)


@torch.no_grad()
def update_bn_stats(params: TorchParams, stats: BNStats,
                    momentum: float = 0.9) -> TorchParams:
    """EMA update of the BN moving statistics (Keras semantics:
    new = momentum * old + (1 - momentum) * batch) of the layers in
    ``stats``, in place (the reference returns a new dict), as a few
    multi-tensor launches; returns ``params``."""
    olds = [params[name][stat] for name in stats
            for stat in ("moving_mean", "moving_variance")]
    batch = [t for name in stats for t in stats[name]]
    torch._foreach_mul_(olds, momentum)
    torch._foreach_add_(olds, batch, alpha=1.0 - momentum)
    return params


def _nll_sum_and_count(logits: torch.Tensor, labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed softmax cross-entropy (f32) of the pixels whose label !=
    255, and their count (int64)."""
    labels = labels.to(torch.int64)
    valid = labels != 255
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum(), valid.sum()


def segmentation_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over pixels whose label != 255, in f32.

    logits: (..., H, W, C); labels: (..., H, W) integer in [0, C) or 255."""
    nll, count = _nll_sum_and_count(logits, labels)
    return nll / count.clamp_min(1)


def build_train_step(model: DeepLab, tx: TrainOptimizer, bn_momentum: float = 0.9,
                     remat: bool = False, skip_nonfinite: bool = False, mesh=None):
    """step(master, opt_state, images, labels) -> (master, opt_state, loss).

    images: (B, H, W, 3) f32 in [0, 1] on the master's device; labels
    (B, H, W) integer (255 = ignore), at the logits' resolution (train with
    final_upsample=True). The reference's order: gradients of the loss;
    the optimizer over the WHOLE dict, moving statistics included (adamw's
    decay shrinks them too); then the EMA of the batch statistics onto the
    updated values. The returned loss is the one before the update.

    remat=True recomputes each block's activations in the backward pass
    (``layers.segment``): the same numbers, less memory. skip_nonfinite=True
    makes the step atomic: when the loss or any gradient is non-finite,
    params, optimizer state (counts included) and moving statistics all
    stay as they were, by device-side selects (no host synchronisation).

    mesh (``parallel.Mesh``, inside a process group): data parallel over
    every rank, each with its slice of the global batch
    (``parallel.shard_train_batch``). The first step broadcasts the
    parameters from rank 0; BatchNorm takes the global batch's statistics
    (synchronised); each rank's loss is its pixels' share of the global
    mean (its summed cross-entropy over the global count of valid
    pixels), so one all-reduce (sum) of the flat gradient gives every rank
    the gradient of the global-batch mean loss, and the guard, the
    optimizer and the EMA then run on equal inputs on every rank. The
    returned loss is the global mean.
    """
    group = None
    if mesh is not None and dist.is_initialized():
        group = dist.group.WORLD
    synced = [mesh is None]

    def step(master: MasterParams, opt_state: OptState, images: torch.Tensor,
             labels: torch.Tensor):
        if not synced[0]:
            mesh.broadcast(master.flat)
            synced[0] = True
        master.grad.zero_()
        with torch.enable_grad():
            logits, stats = forward_train(model, master.params, images, remat=remat,
                                          sync_group=group)
            if logits.shape[1:3] != labels.shape[1:3]:
                raise ValueError("labels must match the logits resolution; "
                                 "train with final_upsample=True or resize")
            if mesh is None:
                loss = segmentation_loss(logits, labels)
            else:
                nll, count = _nll_sum_and_count(logits, labels)
                loss = nll / mesh.all_reduce(count).clamp_min(1)
        loss.backward()
        if mesh is not None:
            mesh.all_reduce(master.grad)
            loss = mesh.all_reduce(loss.detach())
        with torch.no_grad():
            new_flat, new_state = tx.update(master.grad, opt_state, master.flat)
            update_bn_stats(master.views(new_flat), stats, bn_momentum)
            keep = None
            if skip_nonfinite:
                keep = torch.isfinite(loss) & torch.isfinite(master.grad).all()
                torch.where(keep, new_flat, master.flat, out=master.flat)
            else:
                master.flat.copy_(new_flat)
            opt_state.assign(new_state, keep)
        return master, opt_state, loss.detach()

    return step


# The reference jits build_train_step's function under this name; PyTorch runs
# it eagerly, so both names give the same step.
make_train_step = build_train_step
