"""The port's resize against ``jax.image.resize(..., "bilinear")`` on the
CPU in float32 (triangle kernel, antialias, half-pixel centres): identity,
upsampling 8 -> 12 and downsampling 16 -> 12, atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle_pytorch_tpu_torch.ops.image import resize_bilinear

torch.set_num_threads(1)


@pytest.mark.parametrize("size,out", [(8, 8), (8, 12), (16, 12)],
                         ids=["identity", "up_8_12", "down_16_12"])
def test_resize_matches_jax(size, out):
    x = np.random.RandomState(size + out).rand(2, size, size, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, out, out, 3), method="bilinear")
    got = resize_bilinear(torch.from_numpy(x), out, out)
    assert got.shape == (2, out, out, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    if size == out:
        assert torch.equal(got, torch.from_numpy(x))
