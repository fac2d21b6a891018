"""Port parity: DeepLabV3+ with the MobileNetV2 backbone, TF "SAME" padding
of strided convolutions, and the fused operator and Gram stencil at
MobileNetV2's decimation factor 8.

One Keras-named param dict from the reference's init feeds both models;
the same numpy target, angles and shifts go through both operators.
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
from deeplabv3plus_augmented_superresolution_tpu.models.layers import (
    make_divisible as j_make_divisible,
)
from deeplabv3plus_augmented_superresolution_tpu.ops.fused_operator import (
    fused_warp_downsample as j_fused,
)
from deeplabv3plus_augmented_superresolution_tpu.sr import (
    SRConfig as JSRConfig,
    precompute_gram_stencil as j_precompute_gram_stencil,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.models import (
    DeepLab,
    DeepLabConfig,
    build_model,
    init_params,
    load_keras_h5_weights,
    params_from_jax,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.models.layers import (
    Conv2d,
    DepthwiseConv2d,
    make_divisible,
    relu6,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.fused_operator import (
    fused_warp_downsample,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.ops.gram import apply_gram
from deeplabv3plus_augmented_superresolution_tpu_torch.sr import (
    SRConfig,
    forward_operator,
    precompute_gram_stencil,
)
from deeplabv3plus_augmented_superresolution_tpu_torch.sr.solver import _normal_op

torch.set_num_threads(2)

SMALL = dict(input_shape=(64, 64, 3), backbone="mobilenet", final_upsample=False)
# The JAX references run jitted: one compile instead of one per op.
j_forward_jit = jax.jit(j_forward, static_argnames="cfg")


@pytest.fixture(scope="module")
def jax_params():
    return j_init_params(JDeepLabConfig(**SMALL), seed=0)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)


def test_mobilenet_init_params_equal_jax(jax_params):
    """Glorot draws in the reference's parameter order (Conv, expanded_conv,
    blocks 1-16, the two-branch ASPP, the head): seed 0 gives its arrays."""
    ours = init_params(DeepLabConfig(**SMALL), seed=0)
    assert set(ours) == set(jax_params)
    assert "expanded_conv_16_project" in ours and "aspp1_depthwise" not in ours
    for layer, weights in jax_params.items():
        assert set(ours[layer]) == set(weights), layer
        for name, value in weights.items():
            np.testing.assert_array_equal(ours[layer][name], np.asarray(value),
                                          err_msg=f"{layer}/{name}")


def test_mobilenet_f32_logits_match_jax(jax_params, image):
    """OS forced to 8, no decoder: (2, 8, 8, 21) logits at 64 px, f32 on both
    sides, 1e-4 of the logit scale (as the Xception test)."""
    cfg = DeepLabConfig(**SMALL, os=16)
    assert cfg.os == 8
    ref = np.asarray(j_forward_jit(jax_params, jnp.asarray(image),
                                   JDeepLabConfig(**SMALL)))
    model = DeepLab(cfg, device="cpu").load_params(params_from_jax(jax_params)).eval()
    with torch.no_grad():
        ours = model(torch.from_numpy(image)).numpy()
    assert ours.shape == ref.shape == (2, 8, 8, 21)
    np.testing.assert_allclose(ours, ref, atol=1e-4 * np.abs(ref).max())


def test_mobilenet_bf16_masks_agree_with_jax(jax_params, image):
    """bf16 rounds at other places in the two frameworks: argmax labels agree
    on >= 90% of pixels, logits within 5% of their scale (as the Xception
    test)."""
    cfg = dict(SMALL, compute_dtype="bfloat16")
    ref = np.asarray(j_forward_jit(jax_params, jnp.asarray(image),
                                   JDeepLabConfig(**cfg)))
    model = build_model(DeepLabConfig(**cfg), params=jax_params, device="cpu")
    with torch.no_grad():
        ours = model(torch.from_numpy(image)).numpy()
    agree = (ours.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.9, agree
    np.testing.assert_allclose(ours, ref, atol=0.05 * np.abs(ref).max())


def test_mobilenet_h5_loader_matches_jax(jax_params, tmp_path):
    """MobileNetV2's Keras names (Conv, expanded_conv_<i>_depthwise with the
    (k, k, C, 1) depthwise layout) load into the same arrays through both
    loaders."""
    import h5py

    rng = np.random.default_rng(5)
    path = str(tmp_path / "w.h5")
    weights = {"Conv": {"kernel:0": rng.standard_normal((3, 3, 3, 32))},
               "expanded_conv_1_depthwise":
                   {"depthwise_kernel:0": rng.standard_normal((3, 3, 96, 1))},
               "expanded_conv_1_project_BN": {"gamma:0": rng.standard_normal(24)}}
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [k.encode() for k in weights]
        for lname, entry in weights.items():
            g = f.create_group(lname)
            g.attrs["weight_names"] = [f"{lname}/{k}".encode() for k in entry]
            for k, v in entry.items():
                g.create_dataset(f"{lname}/{k}", data=v.astype(np.float32))
    np_params = {k: {n: np.asarray(v) for n, v in w.items()}
                 for k, w in jax_params.items()}
    ours = load_keras_h5_weights(np_params, path)
    ref = j_load_h5(jax_params, path)
    for layer, name in (("Conv", "kernel"), ("expanded_conv_1_depthwise",
                                             "depthwise_kernel"),
                        ("expanded_conv_1_project_BN", "gamma")):
        np.testing.assert_array_equal(ours[layer][name], np.asarray(ref[layer][name]))
    assert ours["expanded_conv_1_depthwise"]["depthwise_kernel"].shape == (3, 3, 1, 96)


@pytest.mark.parametrize("depthwise", [False, True], ids=["conv", "depthwise"])
@pytest.mark.parametrize("size", [16, 15])
def test_strided_same_padding_is_xlas(depthwise, size):
    """A stride-2 3x3 "SAME" convolution pads as XLA does: (0, 1) on an even
    input (where a symmetric padding of 1 would shift every output by one
    pixel), (1, 1) on an odd one. Exact to f32 conv rounding (1e-5)."""
    rng = np.random.default_rng(size)
    x = rng.standard_normal((1, size, size, 4)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 1 if depthwise else 4, 4)).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=4 if depthwise else 1))
    if depthwise:
        layer = DepthwiseConv2d("dw", 4, 3, stride=2, dtype=torch.float32)
        layer.load({"depthwise_kernel": torch.from_numpy(kernel.transpose(3, 2, 0, 1))})
    else:
        layer = Conv2d("conv", 4, 4, 3, stride=2, dtype=torch.float32)
        layer.load({"kernel": torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())})
    ours = layer(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.detach().numpy(), ref, atol=1e-5)


def test_relu6_and_make_divisible_match_jax():
    x = torch.linspace(-3.0, 9.0, 25)
    np.testing.assert_array_equal(relu6(x).numpy(), np.clip(x.numpy(), 0, 6))
    for value in (8, 12.8, 16, 24.5, 32 * 0.35, 320 * 1.4, 3):
        assert make_divisible(value, 8) == j_make_divisible(value, 8), value


# ---- the operator and the stencil at decimation factor 8 --------------------

def _factor8_case():
    rng = np.random.default_rng(11)
    angles = rng.uniform(-0.15, 0.15, 4).astype(np.float32)
    shifts = rng.uniform(-8, 8, (4, 2)).astype(np.float32)
    angles[0], shifts[0] = 0.0, 0.0
    low = rng.uniform(0, 1, (3, 8, 8)).astype(np.float32)
    planes = np.kron(low, np.ones((8, 8), np.float32))                 # (3, 64, 64)
    return angles, shifts, planes


def test_fused_operator_at_feature_8_and_class_planes():
    """64 -> 8 (MobileNetV2's 512 -> 64) against the JAX fused operator
    (2e-5, as at factor 4), and K planes in one call, as (K, H, W) or
    (1, H, W, K), against K single-plane calls, exactly."""
    angles, shifts, planes = _factor8_case()
    ta, ts = torch.from_numpy(angles), torch.from_numpy(shifts)
    j_fused_jit = jax.jit(j_fused, static_argnums=(3, 4))
    singles = []
    for k in range(3):
        ours = fused_warp_downsample(torch.from_numpy(planes[k]), ta, ts, (8, 8), 0.15)
        ref = np.asarray(j_fused_jit(jnp.asarray(planes[k]), jnp.asarray(angles),
                                     jnp.asarray(shifts), (8, 8), 0.15))
        assert ours.shape == (4, 8, 8, 1)
        np.testing.assert_allclose(ours.numpy(), ref, atol=2e-5)
        singles.append(ours[..., 0])
    stacked = torch.stack(singles, dim=-1)                            # (N, 8, 8, K)
    for target in (torch.from_numpy(planes),
                   torch.from_numpy(planes).permute(1, 2, 0)[None]):
        assert torch.equal(fused_warp_downsample(target, ta, ts, (8, 8)), stacked)


def test_stencil_at_feature_8_matches_jax_and_the_normal_operator():
    """The aliased stencil (RADIUS 3/4 at any factor, as the reference) vs the
    reference's precompute_gram_stencil, 1e-5 of the coefficient scale; and
    apply_gram vs A^T A x through autograd, 2.5e-4 of the scale (the chip
    check's STENCIL_RTOL)."""
    angles, shifts, planes = _factor8_case()
    kw = dict(num_aug=4, feature_size=(8, 8), output_size=(64, 64), angle_max=0.15,
              solver_impl="gram")
    ref = np.asarray(jax.jit(j_precompute_gram_stencil, static_argnames="cfg")(
        jnp.asarray(angles), jnp.asarray(shifts), JSRConfig(**kw)))
    cfg = SRConfig(**kw)
    ta, ts = torch.from_numpy(angles), torch.from_numpy(shifts)
    coeffs = precompute_gram_stencil(ta, ts, cfg)
    assert coeffs.shape == ref.shape == (7, 9, 64, 64)
    np.testing.assert_allclose(coeffs.numpy(), ref, atol=1e-5 * np.abs(ref).max())
    x = torch.from_numpy(planes[:1, :, :, None])
    direct = _normal_op(lambda z: forward_operator(z, ta, ts, cfg.feature_size, cfg))(x)
    scale = float(direct.abs().max())
    assert float((apply_gram(x, coeffs) - direct).abs().max()) <= 2.5e-4 * scale
