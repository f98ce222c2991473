"""The port's host MAS (``vits_torch/ops/mas_native.py``, the C++ source
``vits_torch/csrc/mas_host.cpp``) against the JAX package's
(``vits_tpu/ops/mas_native.py``), the published DP in numpy and the port's
plain PyTorch version, exactly, on ``tests/test_mas_native.py``'s cases and
on batches with zero-length items; and where it builds."""

import numpy as np
import pytest
import torch

from vits_tpu.ops import mas_native as j_native
from vits_torch._build import BUILD_DIR
from vits_torch.ops import mas_native
from vits_torch.ops.mas import maximum_path_torch

from tests.test_mas import _numpy_mas, _random_case

ROOT = BUILD_DIR.parent.parent

pytestmark = pytest.mark.skipif(not mas_native.available(), reason="g++/OpenMP unavailable")


def _lengths_case(rng, t_ys, t_xs, T_y, T_x):
    t_ys, t_xs = np.asarray(t_ys), np.asarray(t_xs)
    neg_cent = rng.standard_normal((len(t_ys), T_y, T_x)).astype(np.float32)
    mask = ((np.arange(T_y)[None, :, None] < t_ys[:, None, None])
            & (np.arange(T_x)[None, None, :] < t_xs[:, None, None])).astype(np.float32)
    return neg_cent, mask, t_ys, t_xs


CASES = {
    "4x37x11": lambda rng: _random_case(rng, 4, 37, 11),
    "8x120x60": lambda rng: _random_case(rng, 8, 120, 60),
    # zero-length items (both lengths 0, as a padded batch row has them),
    # between and at the ends of the batch
    "zero_length": lambda rng: _lengths_case(rng, [0, 30, 0, 18, 0], [0, 12, 0, 9, 0], 30, 12),
    "t_x_1": lambda rng: _lengths_case(rng, [40, 7, 1], [1, 1, 1], 40, 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_native_matches_the_jax_native_and_the_plain_versions(case):
    rng = np.random.default_rng(len(case))
    neg_cent, mask, t_ys, t_xs = CASES[case](rng)
    out = mas_native.maximum_path_native(neg_cent, mask)
    assert out.dtype == np.int32 and out.shape == neg_cent.shape
    np.testing.assert_array_equal(out, _numpy_mas(neg_cent, t_ys, t_xs) * mask.astype(np.int32))
    if j_native.available():
        np.testing.assert_array_equal(out, j_native.maximum_path_native(neg_cent, mask))
    plain = maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    np.testing.assert_array_equal(out, plain.numpy().astype(np.int32))
    assert (out.sum(axis=(1, 2)) == np.where(t_xs > 0, t_ys, 0)).all()


def test_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    """The library lands in vits_torch/_build/ under a hash of source and
    flags; a fresh build writes there and nothing into native/build/."""
    lib = mas_native.library_path()
    assert lib.parent == ROOT / "vits_torch" / "_build" and lib.name.startswith("libmas_host-")
    assert lib.exists()  # built by the cases above (available())
    native_build = ROOT / "native" / "build"
    before = sorted(native_build.iterdir()) if native_build.exists() else []
    monkeypatch.setattr(mas_native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(mas_native, "_lib", None)
    neg_cent, mask, _, _ = _random_case(np.random.default_rng(0), 2, 20, 8)
    out = mas_native.maximum_path_native(neg_cent, mask)
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [lib.name]
    after = sorted(native_build.iterdir()) if native_build.exists() else []
    assert after == before
    np.testing.assert_array_equal(out, maximum_path_torch(
        torch.from_numpy(neg_cent), torch.from_numpy(mask)).numpy().astype(np.int32))
