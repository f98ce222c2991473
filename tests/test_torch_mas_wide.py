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


LANE_BITS = np.arange(32, dtype=np.uint64)  # a word's bit l: the word's l-th column


class _Barrier:
    """An mbarrier: one arrival a phase, and where the kernel arms it with
    expect_tx, the bytes that must land before the phase completes."""

    def __init__(self, tx=False):
        self.phases = 0  # completed phases
        self.armed, self.bytes, self.tx = False, 0, tx

    def arrive(self):
        self.armed = True
        self._complete()

    def land(self, n):
        self.bytes -= n
        self._complete()

    def _complete(self):
        if self.armed and self.bytes <= 0 if self.tx else self.armed:
            if self.tx and self.bytes != 0:
                raise AssertionError("more bytes landed than the phase expected")
            self.phases += 1
            self.armed = False

    def expect(self, n):
        self.bytes += n
        self.arrive()

    def ready(self, parity):
        """try_wait.parity: the phase of this parity has completed, i.e. the
        current phase has the other parity (a phase that completes twice
        before the wait would alias, and the wait would hang)."""
        return self.phases % 2 != parity


def _wait(bar, parity):
    return lambda: bar.ready(parity)


def _slot_rows(flat, base, t, t_x, x_lo, x_hi):
    """The 16-byte aligned superset of row t's columns [x_lo, x_hi), as the
    bulk copy takes it."""
    a = base + t * t_x + x_lo
    e = base + t * t_x + x_hi
    return flat[a & ~3:(e + 3) & ~3]


def _wide_algorithm(neg_cent, mask, plan=None, seed=0, fault=None):
    """mas_wide_kernel's algorithm in numpy, step for step, one cluster an
    item. Block r of C owns the columns [r BC, (r + 1) BC) of a stripe (BC =
    W 32 K); warp w of W holds columns x0 + 32 c + l (c < K, lane l); rows
    wider than C BC run as stripes, joined by an edge column. Each block's
    copy agent fills a ring of S stages of R rows (the 16-byte aligned
    superset of each row's block columns; the reader skips the head) that
    the block's last active warp frees; each DP warp takes G rows a group,
    its left neighbour's last column through a ring of D slots (full
    barriers armed by the receiver and completed by the sender's bytes,
    credits back on the sender's empty barriers), rotates a row by one lane
    (lane 0 takes lane 31's value of c - 1, or the left neighbour's), and
    packs each c's decisions by ballot into word x0 / 32 + c of a scratch
    that starts as garbage (torch.empty). A seeded random schedule picks
    which agent advances next among those whose barrier phase has completed
    (the parity as try_wait.parity reads it); every slot read asserts that
    it holds what the reader expects, and every write that the slot's last
    contents were read. Then each block zero-fills a C-th of the item's path
    (garbage before) and the walk runs 32 rows a round over windows cut from
    three words a row loaded a round ahead. ``fault`` drops one wait, to
    show the assertions catch it."""
    b, t_y, t_x = neg_cent.shape
    plan = plan or mas_cuda.wide_plan(b, t_y, t_x)
    C, W, K, G, R, S, D = plan.cluster, plan.warps, plan.k, plan.group, plan.stage_rows, \
        plan.stages, plan.depth
    warp_cols, block_cols = 32 * K, plan.block_cols
    stripe_cols, dec_words = plan.stripe_cols, mas_cuda.wide_dec_words(t_x)
    slot_len = block_cols + 4
    flat = neg_cent.reshape(-1)
    rng = np.random.default_rng(seed)
    path = np.full(neg_cent.shape, np.nan, np.float32)  # torch.empty
    for i in range(b):
        ty, tx = int((mask[i, :, 0] != 0).sum()), int((mask[i, 0, :] != 0).sum())
        base = i * t_y * t_x
        dec = rng.integers(0, 2**32, size=(t_y, dec_words), dtype=np.uint64)
        edge = rng.standard_normal((2, t_y)).astype(np.float32)
        stripes = -(-tx // stripe_cols) if ty > 0 and tx > 0 else 0
        steps = ty - 1
        groups = -(-steps // G) if stripes else 0
        chunks = -(-steps // R) if stripes else 0
        # per block: the stage ring (rows of floats, stale NaNs at first) and
        # what each stage holds: (chunk, warps that read it)
        ring = [np.full((S, R, slot_len), np.nan, np.float32) for _ in range(C)]
        held = [[None] * S for _ in range(C)]
        stage_full = [[_Barrier(tx=True) for _ in range(S)] for _ in range(C)]
        stage_empty = [[_Barrier() for _ in range(S)] for _ in range(C)]
        # per (block, warp): its inbox ring and what each slot holds (group, read)
        inbox = [[np.zeros((D, G), np.float32) for _ in range(W)] for _ in range(C)]
        inbox_held = [[[None] * D for _ in range(W)] for _ in range(C)]
        in_full = [[[_Barrier(tx=True) for _ in range(D)] for _ in range(W)] for _ in range(C)]
        out_empty = [[[_Barrier() for _ in range(D)] for _ in range(W)] for _ in range(C)]
        chunk_base = [0] * C
        received = [[0] * W for _ in range(C)]
        sent = [[0] * W for _ in range(C)]

        def copier(r, xb, base_q):
            x_hi = min(xb + block_cols, tx)
            for k in range(chunks):
                q = base_q + k
                stage = q % S
                if fault != "copy_ignores_empty":
                    yield _wait(stage_empty[r][stage], (q // S & 1) ^ 1)
                was = held[r][stage]
                if was is not None and was[1] != was[2]:
                    raise AssertionError(f"stage {stage} of block {r} overwritten before read")
                for t in range(k * R + 1, min(k * R + R + 1, ty)):
                    rows = _slot_rows(flat, base, t, t_x, xb, x_hi)
                    ring[r][stage, t - k * R - 1, :len(rows)] = rows
                held[r][stage] = [q, set(), active_warps(xb)]
                stage_full[r][stage].expect(1)
                stage_full[r][stage].land(1)

        def active_warps(xb):
            return set(range(min(W, -(-(tx - xb) // warp_cols)))) if xb < tx else set()

        def dp(r, w, s, xb, base_q):
            x0 = xb + w * warp_cols
            active = len(active_warps(xb))
            left_ring = w > 0 or r > 0
            left_edge = not left_ring and s > 0
            right_ring = w + 1 < active or (w + 1 == W and r + 1 < C and xb + block_cols < tx)
            right_edge = w + 1 == W and r + 1 == C and s + 1 < stripes
            # the last active warp frees each stage: every warp to its left is ahead
            frees = 0 if fault == "first_warp_frees" else active - 1
            lr, lw = (r, w - 1) if w > 0 else (r - 1, W - 1)
            rr, rw = (r, w + 1) if w + 1 < W else (r + 1, 0)
            cols = x0 + 32 * np.arange(K)[:, None] + np.arange(32)[None, :]  # [c, lane]
            n0 = np.where(cols < t_x, flat[base + np.minimum(cols, t_x - 1)], 0).astype(np.float32)
            v = n0 + np.where(cols == 0, np.float32(0), BIG)
            carry = flat[base + x0 - 1] + BIG if x0 > 0 else BIG
            head = (base + t_x + xb) & 3
            for g in range(groups):
                q, gi = base_q + g // (R // G), g % (R // G)
                stage = q % S
                if gi == 0 and fault != "dp_ignores_full":
                    yield _wait(stage_full[r][stage], q // S & 1)
                t0 = g * G + 1
                if left_ring:
                    d = received[r][w] % D
                    in_full[r][w][d].expect(4 * G)
                    yield _wait(in_full[r][w][d], received[r][w] // D & 1)
                    if inbox_held[r][w][d] != [received[r][w], False]:
                        raise AssertionError(f"inbox {d} of warp {w}, block {r} read before written")
                    e = inbox[r][w][d].copy()
                    inbox_held[r][w][d][1] = True
                    out_empty[lr][lw][d].arrive()
                    received[r][w] += 1
                elif left_edge:
                    e = edge[(s + 1) & 1, np.minimum(np.arange(t0, t0 + G), t_y - 1)]
                else:
                    e = np.full(G, BIG, np.float32)
                out = np.zeros(G, np.float32)
                # the group's scores are read after its left values, as in the kernel
                if held[r][stage] is None or held[r][stage][0] != q:
                    raise AssertionError(f"stage {stage} of block {r} read before written")
                held[r][stage][1].add(w)
                for j in range(min(G, ty - t0)):
                    t = t0 + j
                    h = (head + (g * G + j) * t_x) & 3
                    n = ring[r][stage, gi * G + j][h + (cols - xb)]
                    rot = np.roll(v, 1, axis=1)  # lane l gets lane l-1's; lane 0 lane 31's
                    shifted = rot.copy()
                    shifted[0, 0] = carry if j == 0 else e[j - 1]
                    shifted[1:, 0] = rot[:-1, 0]
                    bits = v < shifted
                    words = (bits.astype(np.uint64) << LANE_BITS).sum(1)  # one ballot a c
                    dec[t, x0 // 32:x0 // 32 + K] = words
                    v = n + np.maximum(v, shifted)
                    out[j] = v[K - 1, 31]
                carry = e[G - 1]
                if right_ring:
                    d = sent[r][w] % D
                    if fault != "send_ignores_credit":
                        yield _wait(out_empty[r][w][d], (sent[r][w] // D & 1) ^ 1)
                    was = inbox_held[rr][rw][d]
                    if was is not None and not was[1]:
                        raise AssertionError(f"inbox {d} of warp {rw}, block {rr} overwritten "
                                             "before read")
                    inbox[rr][rw][d] = out
                    inbox_held[rr][rw][d] = [sent[r][w], False]
                    in_full[rr][rw][d].land(4 * G)
                    sent[r][w] += 1
                elif right_edge:
                    live = min(G, ty - t0)
                    edge[s & 1, t0:t0 + live] = out[:live]
                if w == frees and (gi == R // G - 1 or g + 1 == groups):
                    stage_empty[r][stage].arrive()

        with np.errstate(all="ignore"):  # columns past t_x may hold stale NaNs
            for s in range(stripes):
                agents = []
                for r in range(C):
                    xb = s * stripe_cols + r * block_cols
                    if xb >= tx:
                        continue
                    agents.append(copier(r, xb, chunk_base[r]))
                    agents += [dp(r, w, s, xb, chunk_base[r]) for w in active_warps(xb)]
                    chunk_base[r] += chunks
                waits = [None] * len(agents)
                while agents:
                    ready = [k for k, f in enumerate(waits) if f is None or f()]
                    if not ready:
                        raise AssertionError("deadlock: no agent's barrier phase completes")
                    k = ready[rng.integers(len(ready))]
                    try:
                        waits[k] = next(agents[k])
                    except StopIteration:
                        del agents[k], waits[k]
            cells = t_y * t_x
            part = (-(-cells // C) + 3) // 4 * 4
            item = path[i].reshape(-1)
            for r in range(C):
                item[r * part:min(r * part + part, cells)] = 0.0
        if not stripes:
            continue
        col = tx - 1
        lanes = np.arange(32)

        def words3(rows, first):
            idx = first + np.arange(3)
            ok = (rows[:, None] >= 1) & (idx[None, :] < dec_words)
            return np.where(ok, dec[np.clip(rows, 0, t_y - 1)[:, None],
                                    np.minimum(idx, dec_words - 1)[None, :]], 0)

        first = max(col - 31, 0) >> 5
        w3 = words3(ty - 1 - lanes, first)
        for y0 in range(ty - 1, -1, -32):
            lo = max(col - 31, 0)
            yy = y0 - lanes
            up = (lo >> 5) - first
            assert up in (0, 1), "the round's window lies outside the words loaded for it"
            a, hi = w3[:, up], w3[:, up + 1]
            off = lo & 31
            win = ((a >> off) | (hi << (32 - off))) & 0xFFFFFFFF if off else a.copy()
            first = max(col - 63, 0) >> 5
            w3 = words3(yy - 32, first)
            win = [int(x) for x in win]
            for lane in range(32):
                if 0 <= yy[lane] - lo < 32:
                    win[lane] |= 1 << int(yy[lane] - lo)
                if lo == 0:
                    win[lane] &= ~1
            rel = col - lo
            for r in range(32):
                if y0 - r >= 0:
                    path[i, y0 - r, lo + rel] = 1.0
                rel -= (win[r] >> rel) & 1
            col = lo + rel
    return path


# the wide cases that mas_fused's tests have no name for: (T_y, T_x, t_ys, t_xs)
WIDE_EDGE = {
    # five blocks of 256 columns; items 1-3 end inside blocks 0, 1 and 2
    "blocks_past_tx": (60, 1100, [60, 60, 60, 60], [1100, 100, 300, 700]),
    # zero-length items beside full ones in one batch
    "zero_beside_full": (50, 1100, [50, 0, 50, 30], [1100, 1100, 0, 500]),
}


def _case(name):
    """(neg_cent, mask) of an EDGE or WIDE_EDGE case, or of "BxT_yxT_x":
    random scores, item 0 at the full T_y x T_x, the others at random
    lengths t_y >= 1, t_x >= 2 in either order (t_y < t_x included)."""
    if name in EDGE:
        return _edge_case(name)[:2]
    if name in WIDE_EDGE:
        t_y, t_x, t_ys, t_xs = WIDE_EDGE[name]
        t_ys, t_xs = np.array(t_ys), np.array(t_xs)
        neg_cent = np.random.default_rng(len(name)).standard_normal(
            (len(t_ys), t_y, t_x)).astype(np.float32)
    else:
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


def _small_plan(cluster, warps, k, group, stage_rows, stages, depth):
    return mas_cuda.WidePlan(cluster, warps, k, group, stage_rows, stages, depth, 0)


# small constants that put several blocks, warps, stripes, stages and ring
# laps on small widths: (C, W, K, G, R, S, D). The kernel's K is 2; the model
# takes K = 1 too, so that more warps fit on a small width.
SMALL = {
    "c3w2k1": _small_plan(3, 2, 1, 2, 4, 2, 2),
    "c2w2k2": _small_plan(2, 2, 2, 4, 8, 3, 2),
    "c4w1k1": _small_plan(4, 1, 1, 4, 4, 2, 4),
    "c2w3k1": _small_plan(2, 3, 1, 2, 2, 2, 2),
}
# (case, plan): the plan wide_plan gives (None), and small ones. Only cells
# with t_y >= x can tell a wrong boundary: where x > y every value is
# unreachable, -1e9 give or take float32's rounding.
ALGORITHM_CASES = (
    [(name, None) for name in EDGE]
    + [(name, None) for name in ("4x37x11", "1x40x1100", "2x70x2100", "3x90x1025",
                                 "3x50x64", "1x1040x1030", "3x70x1027", "blocks_past_tx",
                                 "zero_beside_full")]
    + [(name, "c3w2k1") for name in EDGE]
    + [(name, "c3w2k1") for name in ("2x100x90", "2x300x290")]
    + [(name, "c2w2k2") for name in ("2x90x300", "3x60x129", "4x30x200")]
    + [(name, "c4w1k1") for name in ("3x200x150", "3x40x97")]
    + [(name, "c2w3k1") for name in ("2x64x200", "2x130x61")]
)


@pytest.mark.parametrize("name,plan", ALGORITHM_CASES)
def test_wide_algorithm_matches_plain(name, plan):
    neg_cent, mask = _case(name)
    ref = mas.maximum_path_torch(torch.from_numpy(neg_cent), torch.from_numpy(mask))
    out = _wide_algorithm(neg_cent, mask, SMALL.get(plan), seed=len(name) * 31 + len(plan or ""))
    np.testing.assert_array_equal(out, ref.numpy())


@pytest.mark.parametrize("fault,message", [
    ("copy_ignores_empty", "overwritten before read"),
    ("dp_ignores_full", "read before written"),
    ("send_ignores_credit", "overwritten before read"),
    # a stage freed early is refilled under the last warp: its copy overwrites
    # unread rows, or the last warp reads a later chunk's
    ("first_warp_frees", "overwritten before read|read before written"),
])
def test_wide_algorithm_catches_a_missing_wait(fault, message):
    # the schedule's assertions have teeth: drop one wait and a slot is read
    # early or overwritten unread, under the same seeded schedules
    neg_cent, mask = _case("2x300x290")
    with pytest.raises(AssertionError, match=message):
        for seed in range(20):
            _wide_algorithm(neg_cent, mask, SMALL["c3w2k1"], seed=seed, fault=fault)


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16, 17, 33, 64, 66, 67, 133, 300])
def test_wide_plan_over_a_grid_of_shapes(b):
    for t_y in (1, 2, 17, 400, 1500, 13000):
        for t_x in (1, 2, 31, 32, 33, 64, 65, 127, 128, 129, 191, 255, 256, 257, 384, 512,
                    1000, 1023, 1024, 1025, 2052, 4095, 4096, 4097, 9000, 17000):
            p = mas_cuda.wide_plan(b, t_y, t_x)
            where = (b, t_y, t_x, p)
            assert p.smem <= 232448 and 1 <= p.cluster <= 8 and 1 <= p.warps <= 8, where
            assert p.k == 2 and 2 <= p.stages <= 8, where
            assert p.stage_rows % p.group == 0 and p.group % 4 == 0, where
            # one wave where the batch allows it
            assert b * p.cluster <= max(132, b), where
            # every column of T_x lies in one block of one stripe, and the
            # first stripe has no block wholly past T_x
            stripes = -(-t_x // p.stripe_cols)
            assert (stripes - 1) * p.stripe_cols < t_x <= stripes * p.stripe_cols, where
            assert stripes > 1 or (p.cluster - 1) * p.block_cols < t_x, where
            assert p.smem == mas_cuda._WIDE_HEADER + p.stages * p.stage_rows * (4 * p.block_cols
                                                                             + 16), where


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


# shapes that route sends to mas_wide
NEW_CARD_CASES = [
    # a cluster with blocks past t_x; zero-length items beside full ones
    "blocks_past_tx", "zero_beside_full",
    # T_x % 4 != 0: rows of a block's columns start off 16 bytes
    "3x70x1027", "2x90x2053",
    # more blocks than the card's 132 SMs (136 clusters of one block), and 33
    # clusters of 4 where an H100 holds 30 at once: both run in two waves
    "136x24x1100", "33x40x1100",
]
CARD_CASES = list(EDGE) + ["4x37x11", "2x64x48", "3x40x40", "1x40x1100", "2x70x2100",
                           "2x600x1030", "2x50x9000", "1x20x17000"] + NEW_CARD_CASES


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
@pytest.mark.parametrize("name", NEW_CARD_CASES)
def test_maximum_path_on_card_launches_the_wide_kernel_at_the_new_cases(name):
    _needs_card()
    neg_cent, mask = _case(name)
    assert mas_cuda.route(*neg_cent.shape[1:]) == "wide"
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



@pytest.mark.cuda
def test_wide_plan_is_the_kernels():
    _needs_card()
    import ctypes

    lib = mas_cuda._lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = (ctypes.c_longlong * 8)()
    for b in (1, 2, 16, 33, 64, 136):
        for t_y in (1, 40, 1500, 13000):
            for t_x in (1, 32, 33, 64, 191, 384, 512, 1023, 1024, 2052, 9000):
                assert lib.mas_wide_plan(b, t_y, t_x, sms, out) == 0
                assert tuple(out) == tuple(mas_cuda.wide_plan(b, t_y, t_x, sms)), (b, t_y, t_x)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t_y,t_x", WIDE_SHAPES + [(64, 1500, 1024), (136, 24, 1100)])
def test_the_card_holds_a_cluster_of_the_plan(b, t_y, t_x):
    _needs_card()
    assert mas_cuda._lib().mas_wide_active_clusters(b, t_y, t_x) >= 1
