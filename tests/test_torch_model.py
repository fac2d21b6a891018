"""Port parity: DeepLabV3+ (Xception) parameters, layout conversion and
logits, and the only_DCNN / only_ASPP decoder variants.

One Keras-named param dict from the reference's init feeds both models. The
JAX forward runs jitted (one compile per configuration instead of one per op).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplabv3plus_augmented_superresolution_tpu.models import (
    DeepLabConfig as JDeepLabConfig,
    forward as j_forward,
    init_params as j_init_params,
    load_keras_h5_weights as j_load_h5,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLab,
    DeepLabConfig,
    build_model,
    init_params,
    load_keras_h5_weights,
    params_from_jax,
    save_params_npz,
)

torch.set_num_threads(2)

SMALL = dict(input_shape=(64, 64, 3), final_upsample=False)
j_forward_jit = jax.jit(j_forward, static_argnames="cfg")


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(JDeepLabConfig(**SMALL), seed=0)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


VARIANTS = ("only_dcnn_output", "only_aspp_output")


def _variant_cfg(variant):
    return dict(SMALL, first_upsample_size=(24, 24), **{variant: True})


@pytest.fixture(scope="module")
def os16_refs(jax_params, image):
    """The reference's OS16 logits of the full model and of both decoder
    variants, in one jitted program: each variant takes jax_params, less
    the layers it lacks, with its own init's layers where their shapes
    differ (the decoder head), so the three share the backbone's inputs and
    XLA compiles it once. Also each variant's own init (seed 1) and its
    params."""
    inits, heads = {}, {}
    for variant in VARIANTS:
        inits[variant] = j_init_params(JDeepLabConfig(**_variant_cfg(variant)), seed=1)
        heads[variant] = {
            layer: weights for layer, weights in inits[variant].items()
            if layer not in jax_params or any(
                np.shape(v) != np.shape(jax_params[layer].get(n))
                for n, v in weights.items())}
    cfgs = {"full": JDeepLabConfig(**SMALL),
            **{v: JDeepLabConfig(**_variant_cfg(v)) for v in VARIANTS}}
    logits = jax.jit(lambda p, h, x: {k: j_forward({**p, **h.get(k, {})}, x, c)
                                      for k, c in cfgs.items()})(
        jax_params, heads, jnp.asarray(image))
    variant_params = {v: {layer: heads[v].get(layer, jax_params.get(layer))
                          for layer in inits[v]} for v in VARIANTS}
    return ({k: np.asarray(v) for k, v in logits.items()}, inits, variant_params)


def test_init_params_equal_jax(jax_params):
    """numpy Glorot draws in the reference's parameter order: seed 0 gives the
    reference's exact arrays, layer for layer."""
    ours = init_params(DeepLabConfig(**SMALL), seed=0)
    assert set(ours) == set(jax_params)
    for layer, weights in jax_params.items():
        assert set(ours[layer]) == set(weights), layer
        for name, value in weights.items():
            np.testing.assert_array_equal(ours[layer][name], np.asarray(value),
                                          err_msg=f"{layer}/{name}")


def test_params_from_jax_layouts(jax_params):
    conv = np.asarray(jax_params["entry_flow_conv1_1"]["kernel"])      # HWIO
    dw = np.asarray(jax_params["entry_flow_block1_separable_conv1_depthwise"]
                    ["depthwise_kernel"])                              # (k, k, 1, C)
    tp = params_from_jax(jax_params)
    assert tuple(tp["entry_flow_conv1_1"]["kernel"].shape) == (32, 3, 3, 3)
    np.testing.assert_array_equal(tp["entry_flow_conv1_1"]["kernel"][5, 2, 0, 1],
                                  conv[0, 1, 2, 5])
    got = tp["entry_flow_block1_separable_conv1_depthwise"]["depthwise_kernel"]
    assert tuple(got.shape) == (64, 1, 3, 3)
    np.testing.assert_array_equal(got[7, 0, 2, 1], dw[2, 1, 0, 7])


@pytest.mark.parametrize("os_", [16, 8])
def test_xception_f32_logits_match_jax(jax_params, image, os16_refs, os_):
    """Shared params, f32 on both sides: ~75 convolutions deep, the two
    frameworks' conv sums differ in order, 1e-4 of the logit scale."""
    ref = os16_refs[0]["full"] if os_ == 16 else np.asarray(j_forward_jit(
        jax_params, jnp.asarray(image), JDeepLabConfig(**SMALL, os=os_)))
    model = DeepLab(DeepLabConfig(**SMALL, os=os_), device="cpu").load_params(
        params_from_jax(jax_params)).eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(image)).numpy()
    assert ours.shape == ref.shape == (2, 16, 16, 21)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_xception_bf16_masks_agree_with_jax(jax_params, image):
    """bf16 rounds at other places in the two frameworks (the bias add of the
    head, conv accumulation order), so bf16 is compared at mask level: the
    argmax labels agree on >= 90% of pixels of a random-init model (whose
    class margins are small), and the logits stay within 5% of their scale."""
    cfg = dict(SMALL, compute_dtype="bfloat16")
    ref = np.asarray(j_forward_jit(jax_params, jnp.asarray(image),
                                   JDeepLabConfig(**cfg)))
    model = build_model(DeepLabConfig(**cfg), params=jax_params, device="cpu")
    with torch.no_grad():
        ours = model(torch.from_numpy(image)).numpy()
    agree = (ours.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.9, agree
    np.testing.assert_allclose(ours, ref, atol=0.05 * np.abs(ref).max())


def test_npz_roundtrip_and_head_rename(image, tmp_path):
    """save_params_npz / build_model(weights_path=.npz) reproduce the model,
    with the pascal_voc head loaded from a custom-named head. The file
    format and the head rename do not depend on the backbone, so the small
    MobileNetV2 stands in for Xception's 41M values."""
    cfg = DeepLabConfig(**SMALL, backbone="mobilenet")
    original = init_params(cfg, seed=3)
    params = {("custom_logits_semantic" if k == "logits_semantic" else k): v
              for k, v in original.items()}
    path = str(tmp_path / "p.npz")
    save_params_npz(params, path)
    a = build_model(cfg, weights_path=path, device="cpu")
    b = build_model(cfg, params=original, device="cpu")
    x = torch.from_numpy(image)
    with torch.no_grad():
        np.testing.assert_array_equal(a(x).numpy(), b(x).numpy())


def test_h5_loader_matches_jax(jax_params, tmp_path):
    """A Keras-layout .h5 (weights-only, depthwise stored (k, k, C, 1)) loads
    into the same arrays through both loaders."""
    import h5py

    rng = np.random.default_rng(5)
    path = str(tmp_path / "w.h5")
    conv = rng.standard_normal((3, 3, 3, 32)).astype(np.float32)
    dw = rng.standard_normal((3, 3, 64, 1)).astype(np.float32)
    gamma = rng.standard_normal(32).astype(np.float32)
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [b"entry_flow_conv1_1", b"entry_flow_conv1_1_BN",
                                  b"entry_flow_block1_separable_conv1_depthwise"]
        for lname, weights in (
                ("entry_flow_conv1_1", {"kernel:0": conv}),
                ("entry_flow_conv1_1_BN", {"gamma:0": gamma}),
                ("entry_flow_block1_separable_conv1_depthwise",
                 {"depthwise_kernel:0": dw})):
            g = f.create_group(lname)
            g.attrs["weight_names"] = [f"{lname}/{k}".encode() for k in weights]
            for k, v in weights.items():
                g.create_dataset(f"{lname}/{k}", data=v)
    np_params = {k: {n: np.asarray(v) for n, v in w.items()}
                 for k, w in jax_params.items()}
    ours = load_keras_h5_weights(np_params, path)
    ref = j_load_h5(jax_params, path)
    for layer, name in (("entry_flow_conv1_1", "kernel"),
                        ("entry_flow_conv1_1_BN", "gamma"),
                        ("entry_flow_block1_separable_conv1_depthwise",
                         "depthwise_kernel")):
        np.testing.assert_array_equal(ours[layer][name], np.asarray(ref[layer][name]))
    np.testing.assert_array_equal(ours["entry_flow_conv1_1"]["kernel"], conv)


@pytest.mark.parametrize("variant", VARIANTS)
def test_unported_variants_raise(variant, image, os16_refs):
    """The decoder variants, which raised before they were ported, build and
    run as the reference does: init_params draws the reference's arrays for
    the variant (its unused ASPP included), and the f32 logits (only_DCNN:
    the projected backbone output, no ASPP; only_ASPP: the ASPP output; both
    upsampled to first_upsample_size, then the head) match the reference's
    forward on the same params and input, 1e-4 of the logit scale."""
    refs, inits, variant_params = os16_refs
    ours_params = init_params(DeepLabConfig(**_variant_cfg(variant)), seed=1)
    assert set(ours_params) == set(inits[variant])
    for layer, weights in inits[variant].items():
        for name, value in weights.items():
            np.testing.assert_array_equal(ours_params[layer][name], np.asarray(value))
    model = DeepLab(DeepLabConfig(**_variant_cfg(variant)), device="cpu").load_params(
        params_from_jax(variant_params[variant])).eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(image)).numpy()
    ref = refs[variant]
    assert ours.shape == ref.shape == (2, 24, 24, 21)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())
