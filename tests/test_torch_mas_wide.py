"""MAS at every shape on the card: the wide kernel (``mas_cuda.mas_wide``)
and the dispatcher's choice by shape (``mas_cuda.route``).

On the CPU: the wide kernel's algorithm written out in numpy (warps of
columns, the boundary handed from warp to warp and from stripe to stripe,
the decisions packed in words of device memory, the windowed walk) against
the plain version; ``route`` over a grid of shapes; the wrapper's refusals;
the plain version against the JAX package at a shape only the wide kernel
takes; and the dispatcher's casts and copies (bf16, a transposed view, a
misaligned view) against the JAX ``maximum_path``. On the card (``-m
cuda``): the kernel against the plain version, exact, and which kernel
``maximum_path`` launches.

The JAX oracle is imported inside a fixture, so this file also runs where
JAX is absent: on the machine with the card,
``python -m pytest --noconftest tests/test_torch_mas_wide.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from test_torch_mas_fused import EDGE, _edge_case
from vits_torch.ops import mas, mas_cuda

BIG = np.float32(-1e9)
# the shapes of configurations that mas_fused refuses: (B, T_y, T_x)
WIDE_SHAPES = [(16, 1500, 512), (16, 2000, 1024), (8, 2000, 384), (4, 3000, 2052),
               (2, 13000, 64)]


LANE_BITS = np.arange(32, dtype=np.uint64)  # a word's bit c: the word's c-th column


def _wide_algorithm(neg_cent, mask, warp_cols=1024, max_warps=8, seed=0):
    """mas_wide_kernel's algorithm in numpy, step for step. A warp holds
    warp_cols consecutive columns (1024: 32 lanes of 32), at most max_warps
    share a row, wider rows run as stripes one after another; a warp's left
    boundary is the previous row's last column of the warp to its left, or of
    the previous stripe (its edge column), or -1e9. Each row's decisions go
    to words of 32 columns, bit x % 32 of word x / 32, in a scratch that
    starts as garbage (``torch.empty``); the walk goes 32 rows a round over
    32-column windows cut from two words, with the diagonal and column-0
    conditions folded into their bits, as mas_fused's walk."""
    b, t_y, t_x = neg_cent.shape
    warps = min(max_warps, -(-t_x // warp_cols))
    stripe_cols = warps * warp_cols
    words = -(-t_x // 32)
    rng = np.random.default_rng(seed)
    path = np.zeros(neg_cent.shape, np.float32)
    for i in range(b):
        ty, tx = int((mask[i, :, 0] != 0).sum()), int((mask[i, 0, :] != 0).sum())
        dec = rng.integers(0, 2**32, size=(t_y, words), dtype=np.uint64)
        if ty == 0 or tx == 0:
            continue
        stripes = -(-tx // stripe_cols)
        scores = np.zeros((t_y, -(-t_x // stripe_cols) * stripe_cols), np.float32)  # 0 past T_x
        scores[:, :t_x] = neg_cent[i]
        edge = None
        for s in range(stripes):
            x0 = [s * stripe_cols + w * warp_cols for w in range(warps)]
            cols = [np.arange(x, x + warp_cols) for x in x0]
            edge_out = np.zeros(t_y, np.float32)
            for y in range(ty):
                n = [scores[y, c] for c in cols]
                if y == 0:
                    v = [n[w] + np.where(cols[w] == 0, np.float32(0), BIG) for w in range(warps)]
                else:
                    new = []
                    for w in range(warps):
                        left0 = handover[w] if w > 0 else (edge[y - 1] if s > 0 else BIG)
                        shifted = np.concatenate([[left0], v[w][:-1]]).astype(np.float32)
                        bits = np.signbit(v[w] - shifted)  # set exactly where v < shifted
                        # one word a lane of 32 columns, the words past T_x not stored
                        packed = (bits.reshape(-1, 32).astype(np.uint64) << LANE_BITS).sum(1)
                        w0 = x0[w] // 32
                        stored = min(len(packed), words - w0)
                        if stored > 0:
                            dec[y, w0:w0 + stored] = packed[:stored]
                        new.append(n[w] + np.maximum(v[w], shifted))
                    v = new
                handover = [None] + [v[w - 1][-1] for w in range(1, warps)]
                edge_out[y] = v[-1][-1]
            edge = edge_out
        col = tx - 1
        for y0 in range(ty - 1, -1, -32):
            lo = max(col - 31, 0)
            w0, off = lo >> 5, lo & 31
            wins = []
            for lane in range(32):
                yy, win = y0 - lane, 0
                if yy >= 1:
                    lo_word = int(dec[yy, w0])
                    hi_word = int(dec[yy, w0 + 1]) if off and w0 + 1 < words else 0
                    win = ((lo_word >> off) | (hi_word << (32 - off))) & 0xFFFFFFFF if off \
                        else lo_word
                if 0 <= yy - lo < 32:
                    win |= 1 << (yy - lo)
                if lo == 0:
                    win &= ~1
                wins.append(win)
            rel = col - lo
            for r in range(32):
                if y0 - r >= 0:
                    path[i, y0 - r, lo + rel] = 1.0
                rel -= (wins[r] >> rel) & 1
            col = lo + rel
    return path


def _case(name):
    """(neg_cent, mask) of an EDGE case, or of "BxT_yxT_x": random scores,
    item 0 at the full T_y x T_x, the others at random lengths t_y >= 1,
    t_x >= 2 in either order (t_y < t_x included)."""
    if name in EDGE:
        return _edge_case(name)[:2]
    b, t_y, t_x = map(int, name.split("x"))
    rng = np.random.default_rng(b * 7919 + t_y * 31 + t_x)
    neg_cent = rng.standard_normal((b, t_y, t_x)).astype(np.float32)
    t_ys = rng.integers(1, t_y + 1, size=b)
    t_xs = rng.integers(min(2, t_x), t_x + 1, size=b)
    t_ys[0], t_xs[0] = t_y, t_x
    mask = (
        (np.arange(t_y)[None, :, None] < t_ys[:, None, None])
        & (np.arange(t_x)[None, None, :] < t_xs[:, None, None])
    ).astype(np.float32)
    return neg_cent, mask


# (case, warp_cols, max_warps): the kernel's own constants, and small ones
# that put several warps and stripes on a row at small widths. Only cells
# with t_y >= x can tell a wrong boundary: where x > y every value is
# unreachable, -1e9 give or take float32's rounding.
ALGORITHM_CASES = (
    [(name, 1024, 8) for name in EDGE]
    + [(name, 1024, 8) for name in ("4x37x11", "1x40x1100", "2x70x2100", "3x90x1025",
                                    "3x50x64", "1x1040x1030")]
    # stripes of one warp of 32 columns
    + [(name, 32, 1) for name in EDGE]
    + [(name, 32, 1) for name in ("2x100x90",)]
    # 2 warps of 64 columns: a stripe is 128 columns, so 290 columns take 3
    + [(name, 64, 2) for name in ("2x90x300", "2x300x290", "3x60x129", "4x30x200")]
    + [(name, 32, 3) for name in ("3x200x150", "3x40x97")]
)


@pytest.mark.parametrize("name,warp_cols,max_warps", ALGORITHM_CASES)
def test_wide_algorithm_matches_plain(name, warp_cols, max_warps):
    neg_cent, mask = _case(name)
    ref = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    out = _wide_algorithm(neg_cent, mask, warp_cols, max_warps)
    np.testing.assert_array_equal(out, ref.numpy())


def _fits_fused(t_y, t_x):
    return t_x <= 1024 and mas_cuda.fused_plan(t_y, t_x)[1] <= 232448


def test_route_over_a_grid_of_shapes():
    t_ys = sorted({1, 2, 31, 400, 800, 910, 911, 974, 975, 1500, 1981, 1982, 2000, 4000,
                   6000, 13000} | set(range(1, 13001, 397)))
    t_xs = sorted({1, 11, 32, 33, 64, 191, 384, 480, 481, 512, 514, 1000, 1023, 1024, 1025,
                   1030, 2048, 2052, 2100} | set(range(1, 2101, 53)))
    fused = wide = 0
    for t_y in t_ys:
        for t_x in t_xs:
            want = "fused" if _fits_fused(t_y, t_x) else "wide"
            assert mas_cuda.route(t_y, t_x) == want, (t_y, t_x)
            fused += want == "fused"
            wide += want == "wide"
    assert fused and wide


@pytest.mark.parametrize(
    "t_y,t_x,kernel",
    [
        # configs/config_cje.yaml: 384 columns, buckets up to 1500 frames
        (400, 191, "fused"), (800, 384, "fused"), (1500, 384, "fused"), (1981, 384, "fused"),
        (1982, 384, "wide"),
        # max_text_len 255 (514 columns) at the 1500-frame bucket; 239 (482)
        (1500, 514, "wide"), (1500, 482, "wide"), (1500, 480, "fused"),
        # the CJE text bound with a 2000-frame bucket (23 s of audio)
        (2000, 384, "wide"),
        # max_text_len 510 (1024 columns): refused by mas_fused past 910 frames
        (910, 1024, "fused"), (911, 1024, "wide"),
        # any text bound above 1024 columns
        (1, 1025, "wide"), (2, 8193, "wide"),
        *((t_y, t_x, "wide") for _, t_y, t_x in WIDE_SHAPES),
    ],
)
def test_route_at_the_configurations(t_y, t_x, kernel):
    assert mas_cuda.route(t_y, t_x) == kernel


def _no_library():
    raise AssertionError("the wrapper loaded the library")


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 13000, 64), (1, 4, 9000), (3, 2, 20000),
                                   (2, 30, 1025)])
def test_wide_refuses_a_cpu_tensor_before_loading_the_library(monkeypatch, shape):
    # and nothing by shape: the only refusal left at these shapes is the device's
    monkeypatch.setattr(mas_cuda, "_lib", _no_library)
    before = dict(mas_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        mas_cuda.mas_wide(torch.zeros(shape), torch.ones(shape))
    assert mas_cuda.launches == before


@pytest.mark.parametrize("kind", ["bf16", "non_contiguous", "mask_shape", "ndim"])
def test_wide_refuses_what_the_kernel_cannot_read(monkeypatch, kind):
    monkeypatch.setattr(mas_cuda, "_lib", _no_library)
    neg, mask = torch.zeros((2, 12, 8)), torch.ones((2, 12, 8))
    neg, mask, message = {
        "bf16": (neg.bfloat16(), mask, "float32"),
        "non_contiguous": (neg.transpose(1, 2), mask.transpose(1, 2), "contiguous"),
        "mask_shape": (neg, mask[:, :, :-1].contiguous(), "shape"),
        "ndim": (neg[0], mask[0], "3-d"),
    }[kind]
    with pytest.raises((ValueError, TypeError), match=message):
        mas_cuda.mas_wide(neg, mask)


@pytest.fixture(scope="module")
def jax_mas():
    import jax.numpy as jnp

    from vits_tpu.ops.mas import maximum_path, maximum_path_scan

    return jnp, maximum_path, maximum_path_scan


def test_plain_matches_jax_at_a_wide_shape(jax_mas):
    jnp, _, scan = jax_mas
    t_y, t_x = 600, 1030
    assert mas_cuda.route(t_y, t_x) == "wide"
    neg_cent, mask = _case(f"2x{t_y}x{t_x}")
    ref = np.asarray(scan(jnp.asarray(neg_cent), jnp.asarray(mask)))
    out = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    np.testing.assert_array_equal(out.numpy(), ref)


def _dispatch_case(kind):
    """(neg_cent, mask) as torch tensors that the kernels cannot read as
    they are, and the same values as numpy arrays in f32 for JAX."""
    neg_cent, mask = _case("3x40x30")
    n, m = torch.from_numpy(neg_cent), torch.from_numpy(mask)
    if kind == "bf16":
        n = n.bfloat16()
    elif kind == "bf16_mask":
        n, m = n.bfloat16(), m.bfloat16()
    elif kind == "transposed":
        n = n.transpose(1, 2).contiguous().transpose(1, 2)
        m = m.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "misaligned":
        n = torch.cat([torch.zeros(1), n.flatten()])[1:].view(n.shape)
    return n, m


@pytest.mark.parametrize("kind", ["bf16", "bf16_mask", "transposed", "misaligned"])
def test_dispatch_takes_what_jax_takes(jax_mas, kind):
    jnp, maximum_path, _ = jax_mas
    n, m = _dispatch_case(kind)
    assert (kind == "misaligned") == (n.data_ptr() % 16 != 0)
    assert (kind == "transposed") == (not n.is_contiguous())
    ref = maximum_path(jnp.asarray(n.float().numpy()).astype(jnp.dtype(str(n.dtype)[6:])),
                       jnp.asarray(m.float().numpy()).astype(jnp.dtype(str(m.dtype)[6:])))
    # what the kernels get: f32, contiguous, 16-byte aligned, the same values
    neg, m32 = mas.kernel_inputs(n, m)
    assert neg.dtype == m32.dtype == torch.float32
    assert neg.is_contiguous() and m32.is_contiguous() and neg.data_ptr() % 16 == 0
    assert torch.equal(neg, n.float()) and torch.equal(m32, m.float())
    out_dtype = torch.promote_types(n.dtype, m.dtype)
    for out in (mas.maximum_path(n, m), mas.maximum_path_torch(neg, m32).to(out_dtype)):
        assert str(out.dtype)[6:] == str(ref.dtype)
        np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: mas_wide is CUDA-only")


CARD_CASES = list(EDGE) + ["4x37x11", "2x64x48", "3x40x40", "1x40x1100", "2x70x2100",
                           "2x600x1030", "2x50x9000", "1x20x17000"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CARD_CASES)
def test_wide_matches_plain_on_card(name):
    _needs_card()
    neg_cent, mask = _case(name)
    n, m = torch.from_numpy(neg_cent).cuda(), torch.from_numpy(mask).cuda()
    out = mas_cuda.mas_wide(n, m)
    torch.cuda.synchronize()
    assert torch.equal(out, mas.maximum_path_torch(n, m))


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_y,t_x", WIDE_SHAPES)
def test_maximum_path_on_card_launches_the_wide_kernel_once(b, t_y, t_x):
    _needs_card()
    neg_cent, mask = _case(f"{b}x{t_y}x{t_x}")
    n, m = torch.from_numpy(neg_cent).cuda(), torch.from_numpy(mask).cuda()
    before = dict(mas_cuda.launches)
    out = mas.maximum_path(n, m)
    torch.cuda.synchronize()
    assert mas_cuda.launches == {**before, "mas_wide": before["mas_wide"] + 1}
    assert torch.equal(out, mas.maximum_path_torch(n, m))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "bf16_mask", "transposed", "misaligned"])
def test_dispatch_on_card_casts_and_copies(kind):
    _needs_card()
    n, m = (t.cuda() for t in _dispatch_case(kind))
    if kind == "misaligned":
        n = torch.cat([torch.zeros(1, device="cuda"), n.flatten()])[1:].view(n.shape)
    out = mas.maximum_path(n, m)
    ref = mas.maximum_path_torch(n, m)
    assert out.dtype == ref.dtype and torch.equal(out, ref)

