"""Train-state checkpoints as one .npz, in the JAX package's file layout.

Port of the npz side of the JAX package's ``utils/checkpoint.py`` (orbax
checkpoints are not ported). A train-state file holds:

  * the parameters under ``<layer>.<weight>``, in the reference's (Keras)
    layout (HWIO kernels), so the file is also a params-only checkpoint for
    every CLI's ``--weights_path`` (``load_params_npz`` skips ``__`` keys);
  * the optimizer state as ``__opt__.<i>``, one array per leaf in optax's
    tree-flatten order (``models/optim.OptState.leaves``), moments in the
    reference's layout;
  * the step as ``__step__.0``.

So a checkpoint written by either package resumes in the other, with its
moments and schedule position.
"""

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.weights import from_reference_layout, to_reference_layout

_OPT_PREFIX = "__opt__."
_STEP_KEY = "__step__.0"


def save_train_state(path: str, master, opt_state, step: int) -> None:
    """Save (``models/train.MasterParams``, ``models/optim.OptState``,
    step) as one .npz in the reference's layout."""
    flat = {f"{layer}.{name}": arr for layer, entry in master.numpy_params().items()
            for name, arr in entry.items()}
    for i, (name, leaf) in enumerate(opt_state.leaves(master)):
        flat[f"{_OPT_PREFIX}{i}"] = to_reference_layout(
            name, leaf.detach().cpu().numpy()).copy()   # C order, 0-d kept
    flat[_STEP_KEY] = np.asarray(int(step))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **flat)


def load_train_state(path: str) -> Tuple[Optional[List[np.ndarray]], int]:
    """(optimizer leaves in order, step) of a train-state .npz; (None, 0) for
    a params-only file. The parameters load through ``load_params_npz``."""
    with np.load(path) as flat:
        if _STEP_KEY not in flat.files:
            return None, 0
        step = int(flat[_STEP_KEY])
        opt_keys = sorted((k for k in flat.files if k.startswith(_OPT_PREFIX)),
                          key=lambda k: int(k[len(_OPT_PREFIX):]))
        return [flat[k] for k in opt_keys], step


def restore_opt_state(opt_state, master, leaves: List[np.ndarray]) -> None:
    """Fill ``opt_state`` (freshly ``init``ed for ``master``) in place from
    saved leaves. Raises ValueError when the count or a shape differs (e.g.
    the checkpoint was written for another optimizer or schedule); the state
    is then untouched."""
    targets = opt_state.leaves(master)
    if len(targets) != len(leaves):
        raise ValueError(f"optimizer state has {len(targets)} leaves but the "
                         f"checkpoint stored {len(leaves)}: different optimizer "
                         "or schedule")
    fitted = []
    for i, ((name, target), saved) in enumerate(zip(targets, leaves)):
        want = to_reference_layout(name, np.empty(tuple(target.shape), np.uint8)).shape
        if tuple(np.shape(saved)) != tuple(want):
            raise ValueError(f"optimizer leaf {i}: template shape {want} vs "
                             f"checkpoint {np.shape(saved)}")
        fitted.append(from_reference_layout(name, np.asarray(saved)).copy())
    with torch.no_grad():
        for (_, target), arr in zip(targets, fitted):
            target.copy_(torch.as_tensor(arr).to(target.dtype))
