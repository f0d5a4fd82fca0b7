"""The host-side plans of kernels B7 (int8 GEMM) and B6-fwd (LayerNorm
forward), on the CPU.

The kernels run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Which of a source's kernels runs, with which tile, K split
or row geometry, is plain Python: ``int8_plan`` and ``split_ranges`` in
ofasys_torch/ops/int8_matmul.py, ``ln_fwd_plan`` in
ofasys_torch/ops/layer_norm.py. These tests hold the plans to what the
kernels take and to the rules they state: B7's small-M plan up to 64 rows
and 128 x 128 tiles above, a cluster split only where the tiles alone give
fewer than ``MIN_BLOCKS`` blocks and never below ``MIN_SPLIT_K`` (128) bytes
of K a rank, the ``__dp4a`` kernel exactly where 16-byte copies are impossible;
B6-fwd's row in registers at every width of the arch table and its FFN
widths, in bf16 and fp32, and the two-walk kernel at any other width.
"""

import re
from pathlib import Path

import pytest

from ofasys_torch.model.config import _ARCH_TABLE
from ofasys_torch.ops import int8_matmul as ti8
from ofasys_torch.ops import layer_norm as tln

CSRC = Path(ti8.__file__).resolve().parent.parent / "csrc"

# ------------------------------------------------------------------ B7
# (M, K, N) of serve_int8 at base width: a beam-5 decode step of 8 requests
# (40 rows), a greedy step of 4, the largest dispatch's encoder (1,472 rows)
PATH_SHAPES = {
    "decode_logits": (40, 768, 50048), "greedy_logits": (4, 768, 50048),
    "decode_fc1": (40, 768, 3072), "decode_fc2": (40, 3072, 768), "decode_qkv": (40, 768, 768),
    "greedy_cross_q": (4, 768, 768), "encoder_fc1": (1472, 768, 3072),
    "encoder_fc2": (1472, 3072, 768), "encoder_qkv": (1472, 768, 768),
}
GRID_M = (1, 4, 40, 63, 64, 65, 128, 300, 1472)
GRID_N = (8, 200, 333, 768, 1000, 1608, 3072, 3208, 50048)
GRID_K = (16, 48, 64, 128, 144, 200, 333, 768, 3072, 8192)


def _tiles(plan, M, N):
    return -(-M // plan.tile_m) * -(-N // plan.tile_n)


@pytest.mark.parametrize("M", GRID_M)
def test_int8_plan_rules(M):
    """Over a grid of N and K: the kernel by M and K, the split rule, and a
    tile the C entry takes."""
    for N in GRID_N:
        for K in GRID_K:
            plan = ti8.int8_plan(M, N, K)
            if K % 16:
                assert plan.kernel == "dp4a" and plan.split == 1, (M, N, K, plan)
                continue
            assert plan.kernel == ("small_m" if M <= ti8.SMALL_M else "large_m"), (M, N, K)
            assert (plan.tile_m, plan.tile_n) in ((64, 32), (64, 64), (128, 128))
            split, tiles = plan.split, _tiles(plan, M, N)
            assert split in (1, 2, 4, 8), (M, N, K, plan)
            if split > 1:
                # split only where the tiles alone are too few, never below 128 bytes a rank
                assert tiles * split // 2 < ti8.MIN_BLOCKS and K // split >= ti8.MIN_SPLIT_K
            else:
                assert tiles >= ti8.MIN_BLOCKS or K // 2 < ti8.MIN_SPLIT_K
            # doubling stops at the cluster cap, at enough blocks, or at 128 bytes a rank
            assert (split == ti8.MAX_SPLIT or tiles * split >= ti8.MIN_BLOCKS
                    or K // (2 * split) < ti8.MIN_SPLIT_K)


@pytest.mark.parametrize("case", list(PATH_SHAPES))
def test_int8_plan_at_the_path_shapes(case):
    """Every shape of the serving path runs on the tensor cores with at
    least about 100 blocks; the logits need no split."""
    M, K, N = PATH_SHAPES[case]
    plan = ti8.int8_plan(M, N, K)
    assert plan.kernel == ("small_m" if M <= 64 else "large_m")
    assert plan.blocks(M, N) >= 96
    if N == 50048:
        assert (plan.tile_n, plan.split) == (64, 1)
    # N / tile alone gives 24 blocks: K is split over a cluster, 8 ranks of
    # 384 bytes at K = 3,072, 4 of 192 at K = 768 (8 would leave 96 bytes)
    if case == "decode_fc2":
        assert (plan.tile_n, plan.split) == (32, 8)
    if case in ("decode_qkv", "greedy_cross_q"):
        assert (plan.tile_n, plan.split) == (32, 4)


@pytest.mark.parametrize("K", [16, 32, 48, 200, 333, 768, 770, 3072, 8192, 8200])
def test_int8_dp4a_exactly_where_16_byte_copies_are_impossible(K):
    for M in (4, 40, 1472):
        assert (ti8.int8_plan(M, 768, K).kernel == "dp4a") == (K % 16 != 0)
        assert ti8.int8_plan(M, 768, K, aligned=False).kernel == "dp4a"


@pytest.mark.parametrize("K", [64, 128, 144, 768, 784, 3072, 8192])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_split_ranges_cover_k_in_16_byte_chunks(K, split):
    ranges = ti8.split_ranges(K, split)
    assert len(ranges) == split and ranges[0][0] == 0 and ranges[-1][1] == K
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(k0 % 16 == 0 and k1 % 16 == 0 and k1 >= k0 for k0, k1 in ranges)
    if K // split >= ti8.MIN_SPLIT_K:       # the only splits the plan makes
        assert min(k1 - k0 for k0, k1 in ranges) >= ti8.MIN_SPLIT_K


def test_int8_plans_are_the_ones_the_source_takes():
    """The C entry's dispatch names the same kernels, tiles, row limit and
    cluster cap as the plan."""
    src = (CSRC / "int8_matmul.cu").read_text()
    small = set(int(t) for t in re.findall(r"kernel == 1 && M <= 64 && tile_n == (\d+)", src))
    large = set(int(t) for t in re.findall(r"kernel == 2 && tile_n == (\d+)", src))
    assert ti8.SMALL_M == 64 and small == {32, 64} and large == {128}
    assert f"split > {ti8.MAX_SPLIT}" in src
    assert ti8._KERNEL_CODE == {"dp4a": 0, "small_m": 1, "large_m": 2}


# ------------------------------------------------------------------ B6-fwd
WIDTHS = sorted({w for e, f, *_ in _ARCH_TABLE.values() for w in (e, f)})


def test_ln_widths_are_the_arch_tables():
    assert WIDTHS == [256, 512, 768, 1024, 1280, 2048, 2560, 2816, 3072, 4096, 5120, 10240, 11264]
    assert set(WIDTHS) == tln.LN_WIDTHS


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("E", WIDTHS)
def test_ln_fwd_geometry_at_arch_widths(E, element_size):
    """The row held in registers: one warp up to E = 1,024, 2-8 above; each
    lane's slots cover the row with no slot row left empty; a slot count the
    kernel is instantiated for; whole groups in a block of at most 256."""
    plan = tln.ln_fwd_plan(E, element_size)
    nv = E // (16 // element_size)
    W, P = plan.warps, plan.slots
    assert plan.kernel == "rows"
    assert (W == 1) if E <= 1024 else (2 <= W <= 8)
    assert 32 * W * P >= nv > 32 * W * (P - 1)
    assert P in tln.LN_SLOTS
    rows = max(1, 8 // W)
    assert 32 * W * rows <= 256


def test_ln_fwd_geometry_at_fc2_ln():
    """E = 3,072 in bf16 (fc2_ln at base width): 4 warps of 3 vectors a lane."""
    assert tln.ln_fwd_plan(3072, 2) == tln.LnFwdPlan("rows", 4, 3)
    assert tln.ln_fwd_plan(768, 2) == tln.LnFwdPlan("rows", 1, 3)


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("E", [1, 100, 300, 776, 1001, 1536, 3000, 3080, 6144, 11265])
def test_ln_fwd_two_walk_at_any_other_width(E, element_size):
    plan = tln.ln_fwd_plan(E, element_size)
    assert plan.kernel == "two_walk" and (plan.warps, plan.slots) == (0, 0)
    assert plan.vec == (E % (16 // element_size) == 0)


@pytest.mark.parametrize("E", [768, 3072])
def test_ln_fwd_unaligned_rows_walk_twice_element_by_element(E):
    assert tln.ln_fwd_plan(E, 2, aligned=False) == tln.LnFwdPlan("two_walk", vec=False)


def test_ln_slots_are_the_ones_the_source_instantiates():
    src = (CSRC / "layer_norm.cu").read_text()
    cases = tuple(int(p) for p in re.findall(r"case (\d+): return fwd_rows_launch<T, \1>", src))
    assert cases == tln.LN_SLOTS
    used = {tln.ln_fwd_plan(E, s).slots for E in WIDTHS for s in (2, 4)}
    assert used <= set(tln.LN_SLOTS)
