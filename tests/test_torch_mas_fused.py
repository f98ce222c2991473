"""MAS edge cases and the fused kernel (``mas_cuda.mas_fused``).

On the CPU: the plain version against the JAX package's oracles on the edge
cases (t_y < t_x, t_x = 1, zero-length items, t_y == t_x with partial
lengths), the fused kernel's algorithm written out in numpy against the plain
version, and every refusal of the wrapper. On the card (``-m cuda``): the
kernel against the plain version, exact, and its launch count.

The JAX oracles are imported inside a fixture, so this file also runs where
JAX is absent: on the machine with the card,
``python -m pytest --noconftest tests/test_torch_mas_fused.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from vits_torch.ops import mas, mas_cuda

# name -> (T_y, T_x, t_ys, t_xs)
EDGE = {
    "ty_lt_tx": (20, 30, [12, 20, 5], [30, 25, 17]),
    "tx_1": (40, 1, [40, 7, 1], [1, 1, 1]),
    "zero_ty": (30, 12, [0, 30, 18, 0], [12, 12, 9, 5]),
    "zero_tx": (30, 12, [30, 0, 18, 0], [0, 12, 9, 0]),
    "square_partial": (40, 40, [40, 33, 25], [40, 33, 17]),
}
# The numpy oracle is the published algorithm, which assumes t_y >= t_x >= 1:
# it restricts the DP to the band a monotonic path can reach (so it answers
# otherwise where none exists, t_y < t_x) and indexes column -1 when t_x = 0.
ORACLE_CASES = [
    (name, oracle)
    for name in EDGE
    for oracle in ("scan", "pallas_interpret", "numpy")
    if oracle != "numpy" or name not in ("ty_lt_tx", "zero_tx")
]


def _edge_case(name):
    t_y, t_x, t_ys, t_xs = EDGE[name]
    t_ys, t_xs = np.array(t_ys), np.array(t_xs)
    neg_cent = np.random.default_rng(len(name)).standard_normal(
        (len(t_ys), t_y, t_x)
    ).astype(np.float32)
    mask = (
        (np.arange(t_y)[None, :, None] < t_ys[:, None, None])
        & (np.arange(t_x)[None, None, :] < t_xs[:, None, None])
    ).astype(np.float32)
    return neg_cent, mask, t_ys, t_xs


# Kept here rather than imported from tests/test_torch_mas.py: on the machine
# with the card, `tests` is not importable as a package.
def _random_case(b, t_y, t_x):
    """As tests/test_torch_mas.py::_case: lengths with t_y >= t_x >= 2."""
    rng = np.random.default_rng(b + t_y)
    neg_cent = rng.standard_normal((b, t_y, t_x)).astype(np.float32)
    t_ys = rng.integers(t_x, t_y + 1, size=b)
    t_xs = rng.integers(2, t_x + 1, size=b)
    t_ys = np.maximum(t_ys, t_xs)
    mask = (
        (np.arange(t_y)[None, :, None] < t_ys[:, None, None])
        & (np.arange(t_x)[None, None, :] < t_xs[:, None, None])
    ).astype(np.float32)
    return neg_cent, mask, t_ys, t_xs


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


@pytest.mark.parametrize("name,oracle", ORACLE_CASES)
def test_plain_matches_jax_oracles_on_edge_cases(oracles, name, oracle):
    neg_cent, mask, t_ys, t_xs = _edge_case(name)
    ref = oracles[oracle](neg_cent, mask, t_ys, t_xs)
    out = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)


def test_plain_backtrack_without_columns_walks_nowhere():
    # an item with t_x = 0 and t_y > 0: the walk used to start at column -1
    # and step through wrapped columns out of the tensor (IndexError); the
    # kernel does no walk there, and the plain version now does the same
    dec = torch.ones((2, 10, 2), dtype=torch.uint8)
    path = mas.mas_backtrack(dec, torch.tensor([10, 10]), torch.tensor([0, 2]))
    assert not path[0].any()
    assert path[1].sum() == 10 and path[1, 9, 1] == 1


def _fused_algorithm(neg_cent, mask):
    """mas_fused_kernel's algorithm in numpy, step for step: lane l holds
    columns lK .. lK+K-1 and packs their decisions into a K-bit field a row,
    then the walk goes 32 rows a round over windows gathered from the
    fields, with the diagonal and column-0 conditions folded into their
    bits."""
    b, t_y, t_x = neg_cent.shape
    k_cols, _ = mas_cuda.fused_plan(t_y, t_x)
    lanes = 32
    big = np.float32(-1e9)
    path = np.zeros(neg_cent.shape, np.float32)
    for i in range(b):
        ty, tx = int((mask[i, :, 0] != 0).sum()), int((mask[i, 0, :] != 0).sum())
        if ty == 0 or tx == 0:
            continue
        n = np.zeros((t_y, lanes * k_cols), np.float32)
        n[:, :t_x] = neg_cent[i]
        v = n[0] + np.where(np.arange(lanes * k_cols) == 0, np.float32(0), big)
        fields = np.zeros((ty, lanes), np.int64)
        for y in range(1, ty):
            shifted = np.concatenate([[big], v[:-1]]).astype(np.float32)
            dec = (v < shifted).reshape(lanes, k_cols)
            fields[y] = (dec << np.arange(k_cols)).sum(axis=1)
            v = n[y] + np.maximum(v, shifted)
        idx = tx - 1
        for y0 in range(ty - 1, -1, -32):
            lo = max(idx - 31, 0)
            l0, off = divmod(lo, k_cols)
            wins = []
            for lane in range(32):
                yy, win = y0 - lane, 0
                if yy >= 1:
                    for j in range((k_cols + 30) // k_cols + 1):
                        fld = int(fields[yy, l0 + j]) if l0 + j < lanes else 0
                        at = j * k_cols - off
                        win |= (fld << at if at < 32 else 0) if at >= 0 else fld >> -at
                    win &= 0xFFFFFFFF
                if 0 <= yy - lo < 32:
                    win |= 1 << (yy - lo)
                if lo == 0:
                    win &= ~1
                wins.append(win)
            rel = idx - lo
            for r in range(32):
                if y0 - r >= 0:
                    path[i, y0 - r, lo + rel] = 1.0
                rel -= (wins[r] >> rel) & 1
            idx = lo + rel
    return path


@pytest.mark.parametrize(
    "name", list(EDGE) + ["random_4x37x11", "random_8x150x130", "random_2x100x70",
                          "random_2x60x33", "random_2x300x290"]
)
def test_fused_algorithm_matches_plain(name):
    if name.startswith("random"):
        neg_cent, mask, _, _ = _random_case(*map(int, name.split("_")[1].split("x")))
    else:
        neg_cent, mask, _, _ = _edge_case(name)
    ref = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    np.testing.assert_array_equal(_fused_algorithm(neg_cent, mask), ref.numpy())


def _refused(kind):
    """(neg_cent, mask, message) that mas_fused must refuse, all on the CPU."""
    b, t_y, t_x = 2, 12, 8
    if kind == "t_x_over_1024":
        t_x = 1025
    elif kind == "shared_memory":
        t_y, t_x = 4000, 384  # 250 KB of decision fields + 105 KB of ring
    neg = torch.zeros((b, t_y, t_x))
    mask = torch.ones((b, t_y, t_x))
    if kind == "bf16":
        return neg.bfloat16(), mask, "float32"
    if kind == "non_contiguous":
        return neg.transpose(1, 2), mask.transpose(1, 2), "contiguous"
    if kind == "mask_shape":
        return neg, mask[:, :, :-1].contiguous(), "shape"
    return neg, mask, {"cpu": "CUDA", "t_x_over_1024": "wider",
                       "shared_memory": "shared memory"}[kind]


@pytest.mark.parametrize(
    "kind", ["cpu", "bf16", "t_x_over_1024", "shared_memory", "non_contiguous", "mask_shape"]
)
def test_fused_refuses_before_loading_the_library(kind):
    neg, mask, message = _refused(kind)
    before = dict(mas_cuda.launches)
    with pytest.raises((ValueError, TypeError), match=message):
        mas_cuda.mas_fused(neg, mask)
    assert mas_cuda.launches == before


@pytest.mark.parametrize(
    "t_y,t_x,k_cols,smem",
    [
        # 4 stages of 16 rows (+ a spare row, + 288 bytes) and T_y x 32
        # fields of 1 byte (K=7) or 2 (K=13): 12.8 KB, 51.2 KB, 96 KB
        (400, 191, 7, 64 + 4 * (12224 + 768 + 288) + 12800),
        (800, 384, 13, 64 + 4 * (24576 + 1536 + 288) + 51200),
        (1500, 384, 13, 64 + 4 * (24576 + 1536 + 288) + 96000),
        (37, 11, 1, 64 + 4 * (704 + 48 + 288) + 37 * 32),
    ],
)
def test_fused_plan_at_the_real_buckets(t_y, t_x, k_cols, smem):
    assert mas_cuda.fused_plan(t_y, t_x) == (k_cols, smem)
    assert smem <= mas_cuda._MAX_SHARED_OPT_IN


def test_fused_plan_beyond_shared_memory():
    assert mas_cuda.fused_plan(4000, 384)[1] > mas_cuda._MAX_SHARED_OPT_IN


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: mas_fused is CUDA-only")


CARD_CASES = list(EDGE) + [
    "random_4x37x11", "random_2x64x48", "random_8x150x130", "random_3x40x40",
    "random_32x800x384", "random_64x1500x384",
]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_fused_matches_plain_on_card(name):
    _needs_card()
    if name.startswith("random"):
        neg_cent, mask, _, _ = _random_case(*map(int, name.split("_")[1].split("x")))
    else:
        neg_cent, mask, _, _ = _edge_case(name)
    n, m = torch.from_numpy(neg_cent).cuda(), torch.from_numpy(mask).cuda()
    out = mas_cuda.mas_fused(n, m)
    torch.cuda.synchronize()
    assert torch.equal(out, mas.maximum_path_torch(n, m))


@pytest.mark.cuda
def test_maximum_path_on_card_launches_the_fused_kernel_once():
    _needs_card()
    neg_cent, mask, _, _ = _random_case(16, 400, 191)
    n, m = torch.from_numpy(neg_cent).cuda(), torch.from_numpy(mask).cuda()
    before = dict(mas_cuda.launches)
    mas.maximum_path(n, m)
    torch.cuda.synchronize()
    assert mas_cuda.launches["mas_fused"] == before["mas_fused"] + 1
    assert mas_cuda.launches["mas_forward"] == before["mas_forward"]
    assert mas_cuda.launches["mas_backtrack"] == before["mas_backtrack"]


@pytest.mark.cuda
def test_plan_agrees_with_the_library():
    _needs_card()
    lib = mas_cuda._lib()
    for t_y, t_x in ((37, 11), (400, 191), (800, 384), (1500, 384), (1000, 1024), (5, 33)):
        assert lib.mas_fused_smem_bytes(t_y, t_x) == mas_cuda.fused_plan(t_y, t_x)[1]
