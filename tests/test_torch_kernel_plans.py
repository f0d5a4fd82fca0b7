"""The host-side plans of kernels B7 (int8 GEMM), B6-fwd and B6-bwd
(LayerNorm forward and backward), on the CPU.

The kernels run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Which of a source's kernels runs, with which tile, K split
or row geometry, is plain Python: ``int8_plan`` and ``split_ranges`` in
ofasys_torch/ops/int8_matmul.py, ``ln_fwd_plan``, ``ln_bwd_plan`` and
``ln_bwd_partition`` in ofasys_torch/ops/layer_norm.py. These tests hold the plans to what the
kernels take and to the rules they state: B7's small-M plan up to 64 rows
and 128 x 128 tiles above, a cluster split only where the tiles alone give
fewer than ``MIN_BLOCKS`` blocks and never below ``MIN_SPLIT_K`` (128) bytes
of K a rank, the ``__dp4a`` kernel exactly where 16-byte copies are impossible;
B6-fwd's and B6-bwd's row in registers at every width of the arch table
and its FFN widths, in bf16 and fp32, and the two-walk kernel at any other
width; B6-bwd's dg/db accumulators in registers within the plan's register
budget, and its persistent partition covering every row once, in chunk
order.
"""

import dataclasses
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


# ------------------------------------------------------------------ B6-bwd
@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("E", WIDTHS)
def test_ln_bwd_geometry_at_arch_widths(E, element_size):
    """The row held in registers: each lane's slots cover the row with no
    slot row left empty; whole groups in a block of at most 256 threads; dg
    and db in registers only within ACC_REG_BUDGET, and in shared memory
    only for one group of eight warps a block; up to two blocks a SM within
    PAIR_SMEM, else one; a ring of RING row buffers a group wherever a block
    holds it, else none; a slot count the source is instantiated for."""
    plan = tln.ln_bwd_plan(E, element_size)
    nv = E // (16 // element_size)
    W, P = plan.warps, plan.slots
    assert plan.kernel == "rows" and 1 <= W <= 8
    assert 32 * W * P >= nv > 32 * W * (P - 1)
    assert 32 * W * plan.groups <= 256 and plan.groups == 8 // W
    assert P in tln.LN_BWD_SLOTS[(element_size, plan.acc)]
    smem = tln.ln_bwd_smem(plan, element_size)
    if plan.acc == "regs":
        assert tln.ln_bwd_regs(P, element_size, "regs") <= tln.ACC_REG_BUDGET
    else:
        assert plan.acc == "smem" and W == 8 and plan.groups == 1
        assert tln.ln_bwd_regs(P, element_size, "regs") > tln.ACC_REG_BUDGET
    assert plan.ring in (tln.RING, 0)
    if plan.ring == 0:              # no ring only where a block cannot hold one
        ringed = dataclasses.replace(plan, ring=tln.RING)
        assert tln.ln_bwd_smem(ringed, element_size) > tln.BLOCK_SMEM
    if plan.sm_blocks == 2:         # a pair of blocks: 128 registers a thread
        assert plan.acc == "regs" and plan.ring == tln.RING and smem <= tln.PAIR_SMEM
        assert 2 * W * plan.groups <= 16
    else:
        assert plan.sm_blocks == 1 and smem <= tln.BLOCK_SMEM
        pair = dataclasses.replace(plan, ring=tln.RING, sm_blocks=2)
        assert plan.acc == "smem" or tln.ln_bwd_smem(pair, element_size) > tln.PAIR_SMEM
    assert plan.sm_blocks * (smem + 1024) <= tln.SM_SMEM


def test_ln_bwd_geometry_at_the_train_mix():
    """E = 768 and fc2_ln's 3,072 in bf16: dg and db in registers, one warp
    of 3 vectors a lane (8 rows a block, two blocks a SM, two row buffers a
    group) and 4 warps of 3 (2 rows, 80 KB and more: one block, two
    buffers); E = 11,264 holds no ring beside its shared-memory
    accumulators."""
    assert tln.ln_bwd_plan(768, 2) == tln.LnBwdPlan("rows", 1, 3, "regs", 2, 2)
    assert tln.ln_bwd_plan(3072, 2) == tln.LnBwdPlan("rows", 4, 3, "regs", 2, 1)
    assert tln.ln_bwd_regs(3, 2, "regs") == 72
    assert tln.ln_bwd_plan(11264, 2) == tln.LnBwdPlan("rows", 8, 6, "smem", 0, 1)


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("E", [1, 100, 300, 776, 1001, 1536, 3000, 3080, 6144, 11265])
def test_ln_bwd_two_walk_at_any_other_width(E, element_size):
    plan = tln.ln_bwd_plan(E, element_size)
    assert plan == tln.LnBwdPlan("two_walk", vec=E % (16 // element_size) == 0)
    assert plan.groups == 8 and plan.sm_blocks == 2


@pytest.mark.parametrize("E", [768, 3072])
def test_ln_bwd_unaligned_rows_walk_twice_element_by_element(E):
    assert tln.ln_bwd_plan(E, 2, aligned=False) == tln.LnBwdPlan("two_walk", vec=False)


def test_ln_bwd_slots_are_the_ones_the_source_instantiates():
    """The (element size, accumulator, slots) the plan returns over the arch
    widths are exactly the C dispatch's cases, and the source's shared
    memory is the plan's."""
    src = (CSRC / "layer_norm.cu").read_text()
    cases = re.findall(r"case (\d+): return bwd_rows_launch<T, \1, (false|true)>", src)
    bodies = src.split("cudaError_t bwd_rows_fp32(")
    assert len(bodies) == 2 and "using T = __nv_bfloat16;" in bodies[0].split("bwd_rows_bf16(")[1]
    source = set()
    for size, body in ((2, bodies[0].split("cudaError_t bwd_rows_bf16(")[1]), (4, bodies[1])):
        for p, acc in re.findall(r"case (\d+): return bwd_rows_launch<T, \1, (false|true)>", body):
            source.add((size, "smem" if acc == "true" else "regs", int(p)))
    assert len(source) == len(cases)
    assert source == {(s, acc, p) for (s, acc), ps in tln.LN_BWD_SLOTS.items() for p in ps}
    plans = {(s, tln.ln_bwd_plan(E, s)) for E in WIDTHS for s in (2, 4)}
    assert {(s, p.acc, p.slots) for s, p in plans} == source
    assert "W != kWarps" in src                     # smem accumulators: one group a block
    assert f"constexpr int kRing = {tln.RING};" in src and "!(S == 0 || S == kRing)" in src
    assert "16 * stride * (2 * P + 1) * S * G +" in src
    assert "sizeof(float) * stride * P * V * (kSmemAcc || G > 1 ? 3 : 1)" in src


@pytest.mark.parametrize("plan", [tln.ln_bwd_plan(768, 2), tln.ln_bwd_plan(3072, 2),
                                  tln.ln_bwd_plan(11264, 2), tln.ln_bwd_plan(1001, 2)],
                         ids=["E768", "fc2_ln", "smem", "two_walk"])
@pytest.mark.parametrize("N", [1, 40, 77, 1001, 12288])
def test_ln_bwd_partition_covers_every_row_once_in_chunk_order(N, plan):
    """One wave of blocks at 132 SMs, none empty; block k owns the k-th
    chunk of consecutive rows, and its groups (rows r0 + q, r0 + q + G, ...,
    as the kernels walk them) take each row of the chunk once."""
    sms = 132
    blocks, rows = tln.ln_bwd_partition(N, plan, sms)
    assert 1 <= blocks <= sms * plan.sm_blocks
    assert (blocks - 1) * rows < N <= blocks * rows
    seen = []
    for k in range(blocks):
        r0, r1 = k * rows, min(N, (k + 1) * rows)
        chunk = sorted(r for q in range(plan.groups) for r in range(r0 + q, r1, plan.groups))
        assert chunk == list(range(r0, r1))
        seen += chunk
    assert seen == list(range(N))


@pytest.mark.parametrize("E", [768, 4096])
@pytest.mark.parametrize("N, per_sm", [(40, 1), (2048, 1), (6335, 1), (6336, 2), (8192, 2),
                                       (12288, 2)])
def test_ln_bwd_partition_takes_one_block_a_sm_at_few_rows(N, per_sm, E):
    """Plans of two blocks a SM (E = 768: eight one-warp groups a block;
    4,096: one group of six warps) keep two only from 132 * 2 *
    PAIR_BLOCK_ROWS = 6,336 rows; below that one block a SM (the gigaword
    decoder's 2,048 rows: 128 blocks of 16)."""
    plan = tln.ln_bwd_plan(E, 2)
    assert (plan.sm_blocks, tln.PAIR_BLOCK_ROWS) == (2, 24)
    blocks, rows = tln.ln_bwd_partition(N, plan, 132)
    assert rows == max(1, -(-N // (132 * per_sm)))
    assert blocks == -(-N // rows) <= 132 * per_sm
