"""MAS in the port: the plain PyTorch version against the JAX package's
oracles (exact), the CPU dispatch, and the CUDA kernels against the plain
version on the card (exact).

The JAX oracles are imported inside a fixture, so this file also runs where
JAX is absent: on the machine with the card,
``python -m pytest --noconftest tests/test_torch_mas.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from vits_torch.ops import mas, mas_cuda

CASES = [(4, 37, 11), (2, 64, 48), (8, 150, 130)]


def _random_case(rng, b, t_y, t_x):
    """As tests/test_mas.py::_random_case: lengths with t_y >= t_x >= 2."""
    neg_cent = rng.standard_normal((b, t_y, t_x)).astype(np.float32)
    t_ys = rng.integers(t_x, t_y + 1, size=b)
    t_xs = rng.integers(2, t_x + 1, size=b)
    t_ys = np.maximum(t_ys, t_xs)
    mask = (
        (np.arange(t_y)[None, :, None] < t_ys[:, None, None])
        & (np.arange(t_x)[None, None, :] < t_xs[:, None, None])
    ).astype(np.float32)
    return neg_cent, mask, t_ys, t_xs


def _case(b, t_y, t_x):
    return _random_case(np.random.default_rng(b + t_y), b, t_y, t_x)


@pytest.fixture(scope="module")
def oracles():
    import jax.numpy as jnp

    from tests.test_mas import _numpy_mas
    from vits_tpu.ops.mas import maximum_path_scan
    from vits_tpu.ops.mas_pallas import maximum_path_pallas

    return {
        "scan": lambda n, m, ty, tx: np.asarray(
            maximum_path_scan(jnp.asarray(n), jnp.asarray(m))
        ),
        "pallas_interpret": lambda n, m, ty, tx: np.asarray(
            maximum_path_pallas(jnp.asarray(n), jnp.asarray(m), interpret=True)
        ),
        "numpy": lambda n, m, ty, tx: (_numpy_mas(n, ty, tx) * m).astype(np.float32),
    }


@pytest.mark.parametrize("oracle", ["scan", "pallas_interpret", "numpy"])
@pytest.mark.parametrize("b,t_y,t_x", CASES)
def test_plain_matches_jax_oracles(oracles, oracle, b, t_y, t_x):
    neg_cent, mask, t_ys, t_xs = _case(b, t_y, t_x)
    ref = oracles[oracle](neg_cent, mask, t_ys, t_xs)
    out = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_diagonal_is_identity(oracles):
    b, t = 3, 40  # t_y == t_x forces the pure diagonal
    neg_cent = np.random.default_rng(0).standard_normal((b, t, t)).astype(np.float32)
    mask = np.ones((b, t, t), np.float32)
    out = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    for i in range(b):
        np.testing.assert_array_equal(out[i].numpy(), np.eye(t, dtype=np.float32))
    np.testing.assert_array_equal(out.numpy(), oracles["scan"](neg_cent, mask, None, None))


def test_cpu_tensor_takes_the_plain_version():
    neg_cent, mask, _, _ = _case(*CASES[1])
    before = dict(mas_cuda.launches)
    n, m = torch.from_numpy(neg_cent), torch.from_numpy(mask)
    out = mas.maximum_path(n, m)
    assert mas_cuda.launches == before
    np.testing.assert_array_equal(out.numpy(), mas.maximum_path_torch(n, m).numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    neg_cent, mask, _, _ = _case(*CASES[0])
    n, m = torch.from_numpy(neg_cent), torch.from_numpy(mask)
    before = dict(mas_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        mas_cuda.mas_fused(n, m)
    with pytest.raises(ValueError, match="CUDA"):
        mas_cuda.mas_wide(n, m)
    assert mas_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_y,t_x", CASES + [(3, 40, 40), (32, 800, 384)])
def test_kernels_match_plain_version_on_card(b, t_y, t_x):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the MAS kernels are CUDA-only")
    neg_cent, mask, _, _ = _case(b, t_y, t_x)
    n, m = torch.from_numpy(neg_cent).cuda(), torch.from_numpy(mask).cuda()
    before = dict(mas_cuda.launches)
    assert torch.equal(mas.maximum_path(n, m), mas.maximum_path_torch(n, m))
    torch.cuda.synchronize()
    kernel = "mas_" + mas_cuda.route(t_y, t_x)
    assert {k: v - before[k] for k, v in mas_cuda.launches.items()} == \
        {k: int(k == kernel) for k in before}
