"""The WaveRNN sampler kernel's launch plan, on the CPU: at the SMALL, the
full and odd widths, for few and many folds, in f32 and bf16, the plan
places every column of every layer on exactly one block, never splits a GRU
unit, fits a block's slices and one stage of activations in shared memory,
and asks for whole clusters of 4 blocks, no more than the card keeps
resident; a width it cannot place raises ``ValueError``."""
import pytest
import torch

from mockingbird_tpu_torch.ops.wavernn_sample import CLUSTER, SMEM_LIMIT, plan

WIDTHS = {  # rnn, fc, classes, aux_d
    "small": (32, 32, 512, 4),
    "full": (512, 512, 512, 32),
    "odd": (37, 45, 61, 5),
    "uneven": (100, 200, 256, 8),
}


def _covered(ranges, width):
    cols = [c for start, stop in ranges for c in range(start, stop)]
    return sorted(cols) == list(range(width)) and len(cols) == width


@pytest.mark.parametrize("n_folds", [1, 5, 72, 200, 528])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", list(WIDTHS), ids=list(WIDTHS))
@pytest.mark.parametrize("sms", [132, 114])
def test_plan_places_every_column_once(widths, dtype, n_folds, sms):
    rnn, fc, classes, aux_d = WIDTHS[widths]
    pl = plan(rnn, fc, classes, aux_d, 80, n_folds, dtype, sms)
    assert 1 <= pl.grid <= sms and pl.grid % CLUSTER == 0
    assert pl.smem <= SMEM_LIMIT
    assert pl.fchunk % 8 == 0 and 8 <= pl.fchunk <= -(-n_folds // 8) * 8
    # every column of every layer owned exactly once; GRU units whole (a
    # block owns units, each with its r, z and n rows)
    for width, per in ((rnn, pl.nu), (fc, pl.nv), (classes, pl.nq)):
        assert _covered(pl.owned(width, per), width)
    # no cluster beyond the last one that owns something
    owners = max(-(-rnn // pl.nu), -(-fc // pl.nv), -(-classes // pl.nq))
    assert -(-owners // CLUSTER) * CLUSTER == pl.grid


def test_plan_at_full_width():
    """The TTS path's shape: 128 blocks of 4 units, 4 fc columns and 4
    classes; 72 folds staged in one chunk in bf16; f32 weights take about
    twice the shared memory and stage fewer folds at a time. An H100 that
    keeps 120 blocks resident in clusters of 4 takes 5 of each on 104
    blocks (103 own some), f32 included."""
    bf = plan(512, 512, 512, 32, 80, 72, torch.bfloat16, 132)
    assert (bf.grid, bf.nu, bf.nv, bf.nq, bf.fchunk) == (128, 4, 4, 4, 72)
    for dtype in (torch.bfloat16, torch.float32):
        pl = plan(512, 512, 512, 32, 80, 72, dtype, 120)
        assert (pl.grid, pl.nu, pl.nv, pl.nq) == (104, 5, 5, 5) and pl.smem <= SMEM_LIMIT
    f32 = plan(512, 512, 512, 32, 80, 72, torch.float32, 132)
    assert f32.grid == 128 and f32.fchunk < 72
    assert f32.smem - f32.fchunk * 4 * 568 > 1.9 * (bf.smem - bf.fchunk * 2 * 568)
    assert bf.state_elems == f32.state_elems == 128 * 72 * (12 * 4 + 4)
    # exchange rows: five R-wide and two FC-wide, double-buffered
    assert bf.exchange_elems == 2 * 72 * (5 * 512 + 2 * 512)
    assert bf.exchange_bytes == 72 * 2 * (5 * 512 + 2 * 512) + 8 * 72


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
