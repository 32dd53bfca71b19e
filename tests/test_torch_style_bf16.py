"""The bf16 style kernels' launch plans on the CPU (ops/style.py
_bf16_plan, _grad_bf16_plan, gram_bf16_items) at every bf16 tap the port
runs: the 512px main path, the 1024px ladder's 7 rungs, 4 lanes at
384x512 and the pool's 288x384 and 192x256 lanes, a 768x1024 shard (of 4)
and a W-sharded 510x680 one, 2880x3840 and its shard, a 17-row map and a
C of 60 (padded to 64).

What csrc/style.cu gram_bf16_kernel and style_grad_bf16_kernel are
launched with, and how they cut the work (their index arithmetic, written
out again here), must cover each lane's rows once and in order, keep
every grid axis within its limit, fit an H100 block's 227 KB of shared
memory, and write exactly the partials buffer the wrapper allocates. The
kernels themselves run on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

from style_transfer2_tpu_torch.ops import style

SMS = 132                 # an H100's SMs
SMEM_MAX = 232448         # an H100 block's dynamic shared memory
GRID_YZ = 65535
GRID_X = 2 ** 31 - 1
ALIGN = 1024              # the ring's alignment (a 128-byte swizzle atom)


def _taps(h, w):
    """(h * w, C) of conv1_1 .. conv4_1 of an h x w iterate (ceil pools)."""
    out = []
    for c in (64, 128, 256, 512):
        out.append((h * w, c))
        h, w = -(-h // 2), -(-w // 2)
    return out


LADDER = [(96, 128), (136, 181), (192, 256), (272, 362), (384, 512),
          (543, 724), (768, 1024)]
CASES = sorted(set(
    [(m, c, 1) for m, c in _taps(384, 512)]
    + [(m, c, 1) for hw in LADDER for m, c in _taps(*hw)]
    + [(m, c, 4) for hw in ((384, 512), (288, 384), (192, 256))
       for m, c in _taps(*hw)]
    + [(m, c, 1) for hw in ((192, 1024), (510, 170), (2880, 3840),
                            (720, 3840)) for m, c in _taps(*hw)]
    + [(17, 64, 1), (30, 60, 1), (30, 60, 3)]))


def _gram_items(c):
    """(I, J, bn) of each Gram item, as the kernel walks them: the blocks
    of G on or above the diagonal over channel blocks of bn."""
    bn = 64 if c <= 64 else 128
    nb = -(-c // bn)
    return [(i, j, bn) for i in range(nb) for j in range(i, nb)]


def _gram_boxes(i, j, bn):
    """64-channel boxes a stage of item (I, J) loads: block I's, and block
    J's off the diagonal."""
    return bn // 64 * (1 if i == j else 2)


def _gram_tiles(i, j, bn, nt):
    """The 64 x 64 tiles (ti, tj) item (I, J) writes, with the warpgroup
    whose rows they are (0 at bn = 64, where the two split the k-steps),
    in the kernel's order."""
    out = []
    for w in range(1 if bn == 64 else 2):
        for h in range(bn // 64):
            ti = i if bn == 64 else 2 * i + w
            tj = j * (bn // 64) + h
            if ti <= tj < nt:
                out.append((w, ti, tj))
    return out


def _gram_writes(c, n_chunks, lanes):
    """The partials offsets (in 64 x 64 tiles) that the Gram kernel's
    blocks write: block (s, item, z) the tiles (ti, tj) of its item with
    ti <= tj < nt, at ((z * n_chunks + s) * n_tiles + tile)."""
    nt = -(-c // 64)
    n_tiles = nt * (nt + 1) // 2
    writes = []
    for z in range(lanes):
        for s in range(n_chunks):
            for i, j, bn in _gram_items(c):
                for _, ti, tj in _gram_tiles(i, j, bn, nt):
                    tile = ti * nt - ti * (ti - 1) // 2 + (tj - ti)
                    writes.append((z * n_chunks + s) * n_tiles + tile)
    return writes


@pytest.mark.parametrize('m,c,lanes', CASES)
def test_gram_plan_covers_each_lane_once(m, c, lanes):
    """The bf16 Gram at one tap: the chunks, whole stages of the kernel's
    ring (256 rows where C <= 64, else 64), cover rows 0..m-1 of each
    lane once, in order; the grid (chunks, items, lanes) within its limits
    and within one block an SM where a chunk an item leaves room; the
    shared memory what the largest item's ring and its mbarriers or the
    two warpgroups' sums take, aligned, within 227 KB; the blocks write
    each float32 partial tile of the buffer once."""
    cp, chunk, n_chunks, n_partials, smem = style._bf16_plan(m, c, SMS,
                                                             lanes)
    assert cp == -(-c // 8) * 8 and cp >= c
    rows = 256 if cp <= 64 else 64
    assert chunk % rows == 0 and chunk > 0
    starts = [s * chunk for s in range(n_chunks)]
    assert starts[0] == 0 and starts[-1] < m <= starts[-1] + chunk
    items = style.gram_bf16_items(cp)
    assert [(i, j) for i, j, _ in _gram_items(cp)] == items
    assert n_chunks <= GRID_X and len(items) <= GRID_YZ and lanes <= GRID_YZ
    assert n_chunks == 1 or n_chunks * len(items) * lanes <= SMS
    bn = _gram_items(cp)[0][2]
    boxes = max(_gram_boxes(*item) for item in _gram_items(cp))
    ring = 6 * (boxes * rows * 128 + 8)
    assert smem == max(ring, 2 * 64 * (bn + 8) * 4) + ALIGN <= SMEM_MAX
    writes = _gram_writes(cp, n_chunks, lanes)
    assert n_partials % 4096 == 0
    assert sorted(writes) == list(range(n_partials // 4096))


@pytest.mark.parametrize('m,c,lanes', CASES)
def test_grad_plan_covers_each_lane_once(m, c, lanes):
    """The bf16 product at one tap: a persistent grid of at most one block
    an SM and one a (slab, panel) pair, a multiple of D's column panels;
    each block's group walks a contiguous range of the lanes' 128-row
    slabs, the ranges covering every slab once, in order, and every slab
    meeting every panel once; the shared memory (D's panel, the ring, the
    output tile) within 227 KB."""
    cp, blocks, smem = style._grad_bf16_plan(m, c, SMS, lanes)
    assert cp == -(-c // 8) * 8
    bn = 64 if cp <= 64 else 128
    panels = -(-cp // bn)
    slabs = -(-m // 128)
    total = lanes * slabs
    assert blocks % panels == 0 and 0 < blocks <= max(SMS, panels)
    assert blocks <= total * panels and blocks <= GRID_X
    groups = blocks // panels
    ranges = [(total * g // groups, total * (g + 1) // groups)
              for g in range(groups)]
    assert ranges[0][0] == 0 and ranges[-1][1] == total
    assert all(a < b for a, b in ranges)
    assert all(ranges[g][1] == ranges[g + 1][0] for g in range(groups - 1))
    pairs = sorted((q, b % panels) for b in range(blocks)
                   for q in range(*ranges[b // panels]))
    assert pairs == [(q, p) for q in range(total) for p in range(panels)]
    kpad = -(-cp // 64) * 64
    stages = 8 if bn == 64 else 4 if kpad > 256 else 6
    want = (stages * (128 * 128 + 8) + kpad * bn * 2 + 128 * bn * 2
            + ALIGN)
    assert smem == want <= SMEM_MAX


def test_grad_plan_refuses_a_c_past_the_resident_panel():
    with pytest.raises(ValueError, match='up to 512'):
        style._grad_bf16_plan(1024, 520, SMS)


@pytest.mark.parametrize('c', [8, 64, 72, 128, 136, 192, 256, 320, 512,
                               1024])
def test_gram_items_hold_each_upper_tile_once(c):
    """Every 64 x 64 tile on or above the diagonal is written by exactly
    one item and warpgroup, in the order of gram_tiles; the items are the
    blocks on or above the diagonal, row by row."""
    nt = -(-c // 64)
    held = []
    for i, j, bn in _gram_items(c):
        assert i <= j
        held += [(ti, tj) for _, ti, tj in _gram_tiles(i, j, bn, nt)]
    assert sorted(held) == style.gram_tiles(c)
    assert len(set(held)) == len(held)


def _gram_by_kernel(x, chunk, n_chunks, c):
    """The Gram as the kernel and the reduction cut it, in float64: each
    (chunk, item) block loading whole stages of rows; at bn = 64 warpgroup
    0 takes the even 16-row k-steps of each stage and warpgroup 1 the odd
    ones, added once at the end, at bn = 128 warpgroup w the rows of
    i-block 2 I + w over every k-step; the partial tiles summed in chunk
    order."""
    m = x.shape[0]
    nt = -(-c // 64)
    xp = np.zeros((n_chunks * chunk, nt * 64 + 256))
    xp[:m, :c] = x
    gram = np.zeros((nt * 64, nt * 64))
    for s in range(n_chunks):
        rows = xp[s * chunk:(s + 1) * chunk]
        for i, j, bn in _gram_items(c):
            b = rows[:, bn * j:bn * j + bn]
            if bn == 64:
                a = rows[:, 64 * i:64 * i + 64]
                wg = [np.zeros((64, bn)), np.zeros((64, bn))]
                for k in range(0, chunk, 16):
                    wg[(k // 16) % 2] += a[k:k + 16].T @ b[k:k + 16]
                parts = [wg[0] + wg[1]]
            else:
                parts = [rows[:, bn * i + 64 * w:bn * i + 64 * w + 64].T @ b
                         for w in range(2)]
            for w, ti, tj in _gram_tiles(i, j, bn, nt):
                h = tj - j * (bn // 64)
                gram[64 * ti:64 * ti + 64, 64 * tj:64 * tj + 64] += (
                    parts[w][:, 64 * h:64 * h + 64])
    upper = np.triu(np.ones((nt, nt), bool)).repeat(64, 0).repeat(64, 1)
    gram = np.where(upper, gram, gram.T)
    return gram[:c, :c]


@pytest.mark.parametrize('m,c', [(17, 64), (300, 72), (700, 136),
                                 (1000, 256), (130, 512)])
def test_gram_decomposition_sums_to_the_gram(m, c):
    """The Gram kernel's cut of the work, planned for a card of 8 SMs so
    that rows split into several chunks, run in float64, gives X^T X."""
    rng = np.random.RandomState(c)
    x = rng.randn(m, c)
    cp, chunk, n_chunks, _, _ = style._bf16_plan(m, c, 8)
    got = _gram_by_kernel(x, chunk, n_chunks, cp)
    np.testing.assert_allclose(got, x.T @ x, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize('m,c,lanes', [(300, 64, 1), (300, 72, 3),
                                       (1000, 256, 2), (200, 512, 2)])
def test_grad_decomposition_gives_the_product(m, c, lanes):
    """The product kernel's cut of the work (each block's panel of D, its
    group's slabs, slices of 64 channels), planned for a card of 8 SMs,
    run in float64, gives X D lane by lane, every output written once."""
    rng = np.random.RandomState(c + lanes)
    x = rng.randn(lanes, m, c)
    d = rng.randn(lanes, c, c)
    cp, blocks, _ = style._grad_bf16_plan(m, c, 8, lanes)
    bn = 64 if cp <= 64 else 128
    panels = -(-cp // bn)
    kpad = -(-cp // 64) * 64
    slabs = -(-m // 128)
    total = lanes * slabs
    groups = blocks // panels
    out = np.full((lanes, m, c), np.nan)
    for b in range(blocks):
        p, g = b % panels, b // panels
        for q in range(total * g // groups, total * (g + 1) // groups):
            z, r0 = q // slabs, (q % slabs) * 128
            dz = np.zeros((kpad, bn))
            cols = slice(p * bn, min(c, p * bn + bn))
            dz[:c, :cols.stop - cols.start] = d[z][:, cols]
            xs = np.zeros((128, kpad))
            rows = x[z, r0:r0 + 128]
            xs[:rows.shape[0], :c] = rows
            acc = np.zeros((128, bn))
            for k0 in range(0, kpad, 64):
                acc += xs[:, k0:k0 + 64] @ dz[k0:k0 + 64]
            n = rows.shape[0]
            assert np.isnan(out[z, r0:r0 + n, cols]).all()
            out[z, r0:r0 + n, cols] = acc[:n, :cols.stop - cols.start]
    np.testing.assert_allclose(out, x @ d, rtol=1e-12, atol=1e-9)
