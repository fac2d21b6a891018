"""One rank of the two-process CPU test of the port's ``parallel/``
(tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py <rank> <port> <work dir>

Joins a two-rank gloo group through ``initialize_distributed`` from
torchrun's environment variables, reads ``<work dir>/inputs.npz`` and runs,
in order (``<work dir>/config.json`` holds the configurations):
``make_asr_batch_fn`` on a (1, 2) mesh (one image, 7 copies padded to 8)
and on a (2, 1) mesh (a batch of 2); ``run_asr.main`` with ``--batch 2`` on the
JPEGs under ``<work dir>/images`` (a 64-px MobileNetV2 in place of the
CLI's 512-px Xception, as the port's CLI tests do); one sharded train step with
synchronised BatchNorm on a global batch of 4. Writes
``<work dir>/rank<rank>.npz``. Imports neither jax nor the JAX package.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

from deeplabv3plus_augmented_superresolution_tpu_torch.cli import run_asr  # noqa: E402
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (  # noqa: E402
    DeepLabConfig, build_model, params_from_jax)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.deeplab import DeepLab  # noqa: E402
from deeplabv3plus_augmented_superresolution_tpu_torch.models.optim import (  # noqa: E402
    Schedule, TrainOptimizer)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.train import (  # noqa: E402
    MasterParams)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.weights import (  # noqa: E402
    to_reference_layout)
from deeplabv3plus_augmented_superresolution_tpu_torch.parallel import (  # noqa: E402
    initialize_distributed, make_asr_batch_fn, make_mesh, make_sharded_train_step,
    shard_batch, shard_train_batch)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (  # noqa: E402
    OptimizerConfig, SRConfig)

SERVE_MODEL = dict(input_shape=(64, 64, 3), backbone="mobilenet", final_upsample=False)
TRAIN_MODEL = dict(input_shape=(32, 32, 3), classes=21, backbone="mobilenet", alpha=0.35,
                   weights=None, final_upsample=True, compute_dtype="float32")


def serve_cases(model, config, inputs, out):
    fields = dict(config["sr"], optimizer=OptimizerConfig(**config["sr"]["optimizer"]))
    cfg = SRConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items()})
    images, angles, shifts = (torch.from_numpy(inputs[k]) for k in
                              ("images", "angles", "shifts"))
    kw = dict(th_factor=0.2, sr_types=("aug", "max", "mean"), return_targets=True)
    for shape, batch in (((1, 2), images[:1]), ((2, 1), images)):
        mesh = make_mesh(shape)
        # The padded config's stencil, which equals the unpadded one's: rank
        # 0's is broadcast.
        stencil = (torch.from_numpy(inputs["stencil"]) if mesh.rank == 0
                   else torch.empty(inputs["stencil"].shape))
        batch_fn = make_asr_batch_fn(mesh, model, cfg, config["class_id"],
                                     gram_coeffs=stencil, **kw)
        im, a, s = shard_batch(mesh, batch, angles, shifts)
        for key, value in batch_fn(im, a, s).items():
            out[f"{shape[0]}x{shape[1]}/{key}"] = value.numpy()


def main_case(model, config, work, out):
    run_asr.IMG_SIZE = (64, 64)
    run_asr.build_deeplab = lambda *args, **kw: model
    summary = run_asr.main([
        "--images", os.path.join(work, "images"), "--batch", "2", "--num_aug", "7",
        "--num_iter", "5", "--shift_max", "8", "--class_id", str(config["class_id"]),
        "--sr_types", "aug,max,mean", "--cache_dir", "", "--prefetch", "0",
        "--writer_threads", "2", "--device", "cpu", "--output_dir",
        os.path.join(work, "main_out")])
    out["main/n_images"] = summary["n_images"]
    out["main/steps"] = summary["steps"]
    out["main/mesh"] = np.array([summary["mesh"]["data"], summary["mesh"]["aug"]])


def train_case(config, inputs, out):
    cfg = DeepLabConfig(**TRAIN_MODEL)
    start = {}
    for key, value in inputs.items():
        if key.startswith("train_params/"):
            _, layer, name = key.split("/")
            start.setdefault(layer, {})[name] = value
    master = MasterParams(params_from_jax(start), "cpu")
    tx = TrainOptimizer("sgd", Schedule("constant", config["train_lr"]),
                        momentum=0.9)
    opt_state = tx.init(master)
    mesh = make_mesh()
    step = make_sharded_train_step(mesh, DeepLab(cfg, device="meta"), tx,
                                   skip_nonfinite=True)
    images, labels = shard_train_batch(mesh, torch.from_numpy(inputs["train_images"]),
                                       torch.from_numpy(inputs["train_labels"]))
    master, opt_state, loss = step(master, opt_state, images, labels)
    out["train/loss"] = float(loss)
    for (layer, name), view in zip(master.keys,
                                   master.leaves(opt_state.tensors["trace"])):
        out[f"train/trace/{layer}/{name}"] = to_reference_layout(name, view.numpy().copy())
    for layer, entry in master.numpy_params().items():
        for name, value in entry.items():
            out[f"train/params/{layer}/{name}"] = value


def main():
    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="2",
                      RANK=str(rank), LOCAL_RANK=str(rank))
    assert initialize_distributed("cpu")
    with np.load(os.path.join(work, "inputs.npz")) as data:
        inputs = dict(data)
    with open(os.path.join(work, "config.json")) as f:
        config = json.load(f)
    model = build_model(DeepLabConfig(**SERVE_MODEL), seed=0, device="cpu")
    out = {}
    serve_cases(model, config, inputs, out)
    main_case(model, config, work, out)
    train_case(config, inputs, out)
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
