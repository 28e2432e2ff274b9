"""The batch-norm layout of the port's H100 model,
``repro_torch.core.gpu_model.bn_layout``, which ``bn_forward.cu`` and
``bn_backward.cu`` are launched with (one persistent cooperative launch,
one block an SM).  Pure arithmetic on the shape and the module's
constants, so it is held here on the CPU: every row and channel covered
once, shared memory within a block's, the 16-byte route only where the
channel count and the alignment allow it, and a full card (132 blocks,
or a block a row) at every BN shape of ResNet-50 at batch 32.  What no
CPU can show, that the card holds the grid resident, the wrappers check
with the occupancy API on the card."""
import re
from pathlib import Path

import pytest

from repro_torch.core import gpu_model as g
from repro_torch.core.gpu_model import bn_layout
from repro_torch.kernels.forward import resnet50_calls

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / \
    "kernels" / "csrc"

MAIN = sorted({shape for kind, _, shape in resnet50_calls(32)
               if kind == "bn_forward"})
RAGGED = [(300, 70), (256, 128), (64, 33), (1001, 67), (4099, 1030),
          (128, 16), (1, 1), (7, 5000), (131, 8), (133, 24)]
FORMS = [(bytes_per_el, tensors) for bytes_per_el in (4, 2)
         for tensors in (1, 2)]


def test_main_path_has_twelve_shapes():
    assert len(MAIN) == 12
    assert (401408, 64) in MAIN and (1568, 2048) in MAIN


def _check(n, c, bytes_per_el, tensors, lay, aligned=True):
    width = 16 // bytes_per_el
    # channels: equal groups of a multiple of vec, together exactly [0, c)
    assert lay.group_c % lay.vec == 0
    assert lay.group_c // lay.vec <= lay.threads == g.BN_THREADS
    assert lay.lanes == lay.threads // (lay.group_c // lay.vec) >= 1
    starts = [i * lay.group_c for i in range(lay.channel_groups)]
    assert starts[-1] < c <= lay.channel_groups * lay.group_c
    # rows: the groups' bounds tile [0, n) in order, sizes within one
    bounds = lay.row_bounds(n)
    assert len(bounds) == lay.row_groups
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    sizes = [r1 - r0 for r0, r1 in bounds]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert lay.rows == max(sizes)
    # on chip: at most the group, and the rest read again
    assert 0 <= lay.rows_kept <= lay.rows
    assert lay.rows_streamed == lay.rows - lay.rows_kept
    assert lay.smem == g.bn_smem(lay.group_c, lay.lanes, lay.rows_kept,
                                 bytes_per_el, tensors)
    assert lay.smem <= g.BN_SMEM_BUDGET <= g.SMEM_BYTES
    # one more kept row would not fit the budget
    if lay.rows_kept < lay.rows:
        assert g.bn_smem(lay.group_c, lay.lanes, lay.rows_kept + 1,
                         bytes_per_el, tensors) > g.BN_SMEM_BUDGET
    # the grid fits one block an SM
    assert lay.blocks <= g.BN_BLOCKS_PER_SM * g.SM_COUNT
    # the vector route only where c is a multiple of the pack width and
    # the tensors are 16-byte aligned
    assert (lay.route == "vector") == (c % width == 0 and aligned)
    assert lay.vec == (width if lay.route == "vector" else 1)


@pytest.mark.parametrize("bytes_per_el,tensors", FORMS)
@pytest.mark.parametrize("n,c", MAIN + RAGGED)
def test_bn_layout_covers_each_row_and_channel_once(n, c, bytes_per_el,
                                                    tensors):
    _check(n, c, bytes_per_el, tensors,
           bn_layout(n, c, bytes_per_el, tensors))


@pytest.mark.parametrize("bytes_per_el,tensors", FORMS)
@pytest.mark.parametrize("n,c", MAIN)
def test_main_path_fills_the_card_on_the_vector_route(n, c, bytes_per_el,
                                                      tensors):
    lay = bn_layout(n, c, bytes_per_el, tensors)
    assert lay.route == "vector"
    assert lay.blocks >= g.SM_COUNT or lay.row_groups == n
    # every main-path shape spans its channels with one group
    assert lay.channel_groups == 1


@pytest.mark.parametrize("n,c", [(300, 70), (64, 33), (1001, 67)])
def test_ragged_shapes_get_all_their_rows_or_a_full_card(n, c):
    for bytes_per_el, tensors in FORMS:
        lay = bn_layout(n, c, bytes_per_el, tensors)
        assert lay.blocks >= g.SM_COUNT or lay.row_groups == n
        assert lay.route == ("scalar" if c % (16 // bytes_per_el)
                             else "vector")


@pytest.mark.parametrize("bytes_per_el,tensors", FORMS)
def test_unaligned_tensors_take_the_scalar_route(bytes_per_el, tensors):
    lay = bn_layout(6272, 256, bytes_per_el, tensors, aligned=False)
    assert (lay.route, lay.vec) == ("scalar", 1)
    _check(6272, 256, bytes_per_el, tensors, lay, aligned=False)


def test_wide_channels_split_into_equal_groups():
    lay = bn_layout(4099, 1030, 4, 2)
    assert (lay.route, lay.channel_groups, lay.group_c) == ("scalar", 3, 344)
    assert lay.row_groups == g.SM_COUNT // 3
    lay = bn_layout(64, 8192, 4, 1)
    assert (lay.vec, lay.channel_groups, lay.group_c) == (4, 4, 2048)


def test_x_and_dy_share_the_budget():
    one, two = bn_layout(401408, 64, 4, 1), bn_layout(401408, 64, 4, 2)
    assert 0 < two.rows_kept < one.rows_kept < one.rows
    assert two.rows_kept * 2 <= one.rows_kept + 1


@pytest.mark.parametrize("kw", [dict(n=0), dict(c=0), dict(bytes_per_el=8),
                                dict(tensors=3)])
def test_bn_layout_rejects_bad_arguments(kw):
    with pytest.raises(ValueError):
        bn_layout(**(dict(n=8, c=8, bytes_per_el=4, tensors=1) | kw))


def test_kernel_constants_match_the_model():
    """The sources' block size is the model's, and both kernels are
    launched cooperatively behind a grid barrier."""
    common = (CSRC / "bn_common.cuh").read_text()
    assert int(re.search(r"kThreads = (\d+);", common).group(1)) \
        == g.BN_THREADS
    assert "cudaLaunchCooperativeKernel" in common
    for source in ("bn_forward.cu", "bn_backward.cu"):
        text = (CSRC / source).read_text()
        # after the blocks' partials, and after the merge is published
        assert text.count("bn::grid_sync()") == 2
        assert '#include "bn_common.cuh"' in text
