"""The port's models (``repro_torch.models``) and parameter converter
against the JAX package: JAX parameters carried across with
``repro_torch.convert``, the same numpy images in, forwards within 1e-5."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.cnn import CNN_ARCHS, cnn_apply as jax_cnn_apply, init_cnn as jax_init_cnn
from repro.models.generator import image_generator as jax_image_generator
from repro.models.generator import init_image_generator as jax_init_image_generator
from repro_torch.convert import params_from_jax, params_to_jax
from repro_torch.models.cnn import cnn_apply, conv2d, init_cnn
from repro_torch.models.generator import image_generator
from repro_torch.utils.trees import flatten_dict, unflatten_dict

pytestmark = pytest.mark.tier1

TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v) if isinstance(v, jax.Array) else v, tree)


def _jnp_tree(tree):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v) if isinstance(v, np.ndarray) else v, tree)


def _perturb_norms(tree, rng):
    """Norm scales and biases init at zero; give them values so the
    ``x·(1 + scale) + bias`` affine is exercised."""
    flat = flatten_dict(tree)
    for k, v in flat.items():
        if k.endswith(("scale", "bias")):
            flat[k] = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
    return unflatten_dict(flat)


@pytest.mark.parametrize("arch", CNN_ARCHS)
@pytest.mark.parametrize("image", [8, 16])
def test_cnn_forward_matches_jax(arch, image):
    shape = (image, image, 3)
    rng = np.random.default_rng(0)
    params = _perturb_norms(_np_tree(jax_init_cnn(jax.random.key(1), arch, 4, shape)), rng)
    x = rng.uniform(-1, 1, (5, *shape)).astype(np.float32)
    jparams = _jnp_tree(params)
    want = np.asarray(jax.jit(lambda x_: jax_cnn_apply(arch, jparams, x_))(jnp.asarray(x)))
    got = cnn_apply(arch, params_from_jax(arch, params), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("image,base", [(8, 16), (16, 64)])
def test_image_generator_matches_jax(image, base):
    shape = (image, image, 3)
    rng = np.random.default_rng(1)
    params = _perturb_norms(
        _np_tree(jax_init_image_generator(jax.random.key(2), 8, 4, shape, base=base)), rng
    )
    z = rng.standard_normal((6, 8)).astype(np.float32)
    y = rng.integers(0, 4, 6).astype(np.int32)
    want = np.asarray(
        jax.jit(jax_image_generator, static_argnums=(3, 4))(_jnp_tree(params), jnp.asarray(z), jnp.asarray(y), shape, base)
    )
    got = image_generator(
        params_from_jax("image_generator", params), torch.from_numpy(z), torch.from_numpy(y).long(), shape, base
    )
    assert tuple(got.shape) == (6, *shape)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", CNN_ARCHS + ("image_generator",))
def test_convert_round_trip(arch):
    if arch == "image_generator":
        tree = _np_tree(jax_init_image_generator(jax.random.key(3), 8, 4, (8, 8, 3), base=16))
    else:
        tree = _np_tree(jax_init_cnn(jax.random.key(3), arch, 4, (8, 8, 3)))
    back = flatten_dict(params_to_jax(arch, params_from_jax(arch, tree)))
    flat = flatten_dict(tree)
    assert back.keys() == flat.keys()
    for k, v in flat.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(back[k], v)
        else:
            assert back[k] == v  # non-array leaves ("stride") stay python values


def test_convert_layouts():
    tree = _np_tree(jax_init_cnn(jax.random.key(4), "miniresnet", 4, (8, 8, 3)))
    p = params_from_jax("miniresnet", tree)
    assert tuple(p["stem"].shape) == (32, 3, 3, 3)  # HWIO (3,3,3,32) -> OIHW
    assert tuple(p["out"].shape) == (4, 128)  # (din, dout) -> nn.Linear
    assert p["b2"]["stride"] == 2 and isinstance(p["b2"]["stride"], int)
    with pytest.raises(ValueError, match="unknown arch"):
        params_from_jax("resnet50", tree)


@pytest.mark.parametrize("size,k,stride", [(8, 3, 2), (9, 3, 2), (8, 1, 2), (7, 5, 1), (8, 4, 1)])
def test_conv_same_padding_matches_xla(size, k, stride):
    """XLA's "SAME" pads (0, 1) at stride 2 on an even input; the port must
    not use PyTorch's symmetric padding there."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
    )
    got = conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w).permute(3, 2, 0, 1), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", CNN_ARCHS)
def test_init_cnn_shapes_match_jax(arch):
    """The port's own init draws the JAX package's shapes (in port layout)."""
    g = torch.Generator().manual_seed(0)
    ours = flatten_dict(init_cnn(g, arch, 4, (8, 8, 3)))
    ref = flatten_dict(params_from_jax(arch, _np_tree(jax_init_cnn(jax.random.key(0), arch, 4, (8, 8, 3)))))
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if torch.is_tensor(v):
            assert ours[k].shape == v.shape, k
