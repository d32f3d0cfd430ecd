"""The WaveRNN sampler kernel's launch plan, on the CPU: at the SMALL, the
full and odd widths, for few and many folds, in f32 and bf16, the plan
places every column of every layer on exactly one block, never splits a GRU
unit, fits a block's slices with one stage of activations (f32) or with the
ring of 64-fold tiles (bf16) in shared memory, covers the folds with its
tiles, and asks for whole clusters of 4 blocks, no more than the card keeps
resident; a width it cannot place raises ``ValueError``."""
import pytest
import torch

from mockingbird_tpu_torch.ops.wavernn_sample import (CLUSTER, MIN_SLOTS, SMEM_LIMIT, TILE,
                                                      plan)

WIDTHS = {  # rnn, fc, classes, aux_d
    "small": (32, 32, 512, 4),
    "full": (512, 512, 512, 32),
    "odd": (37, 45, 61, 5),
    "uneven": (100, 200, 256, 8),
}


def _covered(ranges, width):
    cols = [c for start, stop in ranges for c in range(start, stop)]
    return sorted(cols) == list(range(width)) and len(cols) == width


def _ring_weight_bytes(pl, rnn, fc, aux_d, n_mels=80):
    """The swizzled bf16 slices, counted from the widths: each slice's rows
    padded to wgmma's N (a multiple of 8), its K in 64-column blocks, the
    exchanged part and the conditioning part apart (I: [mel, a1], and a
    block for x), 2 bytes an element."""
    def blocks(k):
        return -(-k // TILE)
    slices = ((pl.nu, blocks(n_mels + aux_d) + 1), (3 * pl.nu, blocks(rnn)),
              (3 * pl.nu, blocks(rnn)), (3 * pl.nu, blocks(rnn) + blocks(aux_d)),
              (3 * pl.nu, blocks(rnn)), (pl.nv, blocks(rnn) + blocks(aux_d)),
              (pl.nv, blocks(fc) + blocks(aux_d)), (pl.nq, blocks(fc)))
    return sum(-(-rows // 8) * 8 * b * TILE * 2 for rows, b in slices)


@pytest.mark.parametrize("n_folds", [1, 5, 72, 200, 528])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", list(WIDTHS), ids=list(WIDTHS))
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_places_every_column_once(widths, dtype, n_folds, sms):
    rnn, fc, classes, aux_d = WIDTHS[widths]
    pl = plan(rnn, fc, classes, aux_d, 80, n_folds, dtype, sms)
    assert 1 <= pl.grid <= sms and pl.grid % CLUSTER == 0
    assert pl.smem <= SMEM_LIMIT
    tiles = pl.fold_tiles()
    # the tiles cover the folds in order, each once
    assert tiles[0][0] == 0 and tiles[-1][1] == n_folds
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    if dtype == torch.bfloat16:
        # every layer's folds in one pass of 64-fold tiles (wgmma's M), the
        # last ragged where F is not a multiple of 64; the swizzled slices
        # and a ring of at least MIN_SLOTS tiles fit in shared memory
        assert len(tiles) == -(-n_folds // TILE) and pl.fchunk == len(tiles) * TILE
        assert all(stop - start == TILE for start, stop in tiles[:-1])
        assert (tiles[-1][1] - tiles[-1][0] < TILE) == (n_folds % TILE != 0)
        weights = _ring_weight_bytes(pl, rnn, fc, aux_d)
        assert pl.slots >= MIN_SLOTS
        assert weights + pl.slots * TILE * TILE * 2 < pl.smem <= SMEM_LIMIT
        # the ring takes what is left, up to 32 tiles: one more, with its
        # two mbarriers, the biases and the 1024 bytes of alignment, would
        # not fit
        nbias = 4 * (9 * pl.nu + 2 * pl.nv + pl.nq)
        assert (weights + (pl.slots + 1) * (TILE * TILE * 2 + 16) + nbias + 1024 > SMEM_LIMIT
                or pl.slots == 32)
        assert pl.exchange_elems == 2 * len(tiles) * TILE * TILE * (
            5 * -(-rnn // TILE) + 2 * -(-fc // TILE))
    else:
        assert pl.slots == 0
        assert pl.fchunk % 8 == 0 and 8 <= pl.fchunk <= -(-n_folds // 8) * 8
        assert all(stop - start == pl.fchunk for start, stop in tiles[:-1])
    # every column of every layer owned exactly once; GRU units whole (a
    # block owns units, each with its r, z and n rows)
    for width, per in ((rnn, pl.nu), (fc, pl.nv), (classes, pl.nq)):
        assert _covered(pl.owned(width, per), width)
    # no cluster beyond the last one that owns something
    owners = max(-(-rnn // pl.nu), -(-fc // pl.nv), -(-classes // pl.nq))
    assert -(-owners // CLUSTER) * CLUSTER == pl.grid


def test_plan_at_full_width():
    """The TTS path's shape: 128 blocks of 4 units, 4 fc columns and 4
    classes. In bf16 the swizzled slices take 95 KB (GRU slices of 12 rows
    padded to wgmma's N of 16, the 4-row slices to 8) and the ring 16 tiles
    of 8 KB; 72 folds are two tiles, the second ragged. f32 weights stage
    fewer than 72 folds at a time. An H100 that keeps 120 blocks resident in
    clusters of 4 takes 5 of each on 104 blocks (103 own some), f32
    included."""
    bf = plan(512, 512, 512, 32, 80, 72, torch.bfloat16, 132)
    assert (bf.grid, bf.nu, bf.nv, bf.nq, bf.slots) == (128, 4, 4, 4, 16)
    assert _ring_weight_bytes(bf, 512, 512, 32) == 97280
    assert bf.fold_tiles() == [(0, 64), (64, 72)] and bf.fchunk == 128
    for dtype in (torch.bfloat16, torch.float32):
        pl = plan(512, 512, 512, 32, 80, 72, dtype, 120)
        assert (pl.grid, pl.nu, pl.nv, pl.nq) == (104, 5, 5, 5) and pl.smem <= SMEM_LIMIT
    f32 = plan(512, 512, 512, 32, 80, 72, torch.float32, 132)
    assert f32.grid == 128 and f32.fchunk < 72 and f32.slots == 0
    # f32 slices, stride-padded: about twice the bf16 slices' unpadded bytes
    assert f32.smem - f32.fchunk * 4 * 568 > 1.9 * 2 * (4 * 113 + 12 * (4 * 512 + 32)
                                                        + 4 * (544 + 544 + 512))
    assert bf.state_elems == f32.state_elems == 128 * 72 * (12 * 4 + 4)
    # exchange buffers: five R-wide and two FC-wide, double-buffered; bf16
    # as whole 64 x 64 tiles (2 fold tiles x 8 column blocks each)
    assert bf.exchange_elems == 2 * 2 * (5 * 8 + 2 * 8) * 64 * 64
    assert f32.exchange_elems == 2 * 72 * (5 * 512 + 2 * 512)
    assert bf.exchange_bytes == 72 * 2 * (5 * 512 + 2 * 512) + 8 * 72
    # the cell's launch: 186 folds, three tiles (58 in the last), one pass
    cell = plan(512, 512, 512, 32, 80, 186, torch.bfloat16, 132)
    assert cell.fold_tiles() == [(0, 64), (64, 128), (128, 186)] and cell.slots == 16


@pytest.mark.parametrize("rnn", [130, 131])
def test_plan_rounds_odd_widths_to_whole_clusters(rnn):
    """rnn 130 and 131 own one unit a block on 132 blocks; in clusters of 4
    on a card that keeps 128 resident they take two units a block, 66 or 65
    unit owners and 128 blocks (the classes need 128); on 132 the grid
    rounds 130 or 131 owners up to 132."""
    pl = plan(rnn, rnn - 90, 512, 4, 80, 9, torch.bfloat16, 128)
    assert (pl.grid, pl.nu, pl.nv, pl.nq) == (128, 2, 1, 4)
    pl = plan(rnn, rnn - 90, 512, 4, 80, 9, torch.bfloat16, 132)
    assert (pl.grid, pl.nu) == (132, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plan_refuses_what_it_cannot_place(dtype):
    with pytest.raises(ValueError, match="cannot place"):
        plan(2048, 2048, 512, 32, 80, 8, dtype, 132)
    with pytest.raises(ValueError, match="cannot place"):
        plan(512, 512, 512, 32, 80, 8, dtype, 8)
    with pytest.raises(ValueError, match="cannot place a cluster"):
        plan(32, 32, 512, 4, 80, 8, dtype, 3)
    with pytest.raises(TypeError):
        plan(512, 512, 512, 32, 80, 8, torch.float16, 132)


@pytest.mark.parametrize("n_folds,aux_d", [(1, 32), (58, 32), (65, 32), (130, 5)])
def test_cond_tiles_hold_each_column_where_the_ring_reads_it(n_folds, aux_d):
    """The bf16 kernel's conditioning tiles: per step and 64-fold tile,
    [mel, a1] in 64-column blocks, then a2, a3 and a4 each in their own;
    element (fold f, column c) of block b at row f mod 64, 16-byte chunk
    (c // 8) ^ (f mod 8) of its tile; every value rounded to bf16; folds
    past F and the padding zero. Built in chunks of steps as in one."""
    from mockingbird_tpu_torch.ops.wavernn_sample import cond_tiles
    steps, m = 7, 80
    rng = torch.Generator().manual_seed(n_folds)
    mels = torch.randn(n_folds, steps, m, generator=rng)
    aux = torch.randn(n_folds, steps, 4 * aux_d, generator=rng)
    tiles = cond_tiles(mels, aux, steps=3)
    ki, ka = -(-(m + aux_d) // TILE), -(-aux_d // TILE)
    mt = -(-n_folds // TILE)
    assert tiles.shape == (steps, mt, ki + 3 * ka, TILE, TILE) and tiles.dtype == torch.bfloat16
    assert torch.equal(tiles, cond_tiles(mels, aux))
    # the logical [step][fold][column] view, unswizzled
    f = torch.arange(mt * TILE)[:, None]
    c = torch.arange((ki + 3 * ka) * TILE)[None, :]
    flat = tiles[:, f // TILE, c // TILE, f % TILE, (((c % TILE) // 8) ^ (f % 8)) * 8 + c % 8]
    want = torch.zeros(steps, mt * TILE, (ki + 3 * ka) * TILE)
    want[:, :n_folds, :m] = mels.transpose(0, 1)
    want[:, :n_folds, m:m + aux_d] = aux[..., :aux_d].transpose(0, 1)
    for k in (1, 2, 3):
        col = (ki + (k - 1) * ka) * TILE
        want[:, :n_folds, col:col + aux_d] = aux[..., k * aux_d:(k + 1) * aux_d].transpose(0, 1)
    assert torch.equal(flat.float(), want.to(torch.bfloat16).float())
