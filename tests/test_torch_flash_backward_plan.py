"""The launch plan of the flash backward's one tensor-core pass
(``ofasys_torch.ops.flash_attention.backward_plan``), on the CPU.

The pass itself runs only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py). Its plan is plain Python: how many keys a block takes, how
the samples split into chunks, and, past ``SCRATCH_CAP``, into groups of
samples and of key ranges launched one after the other. These tests hold
the plan to what the kernel needs: every key and every sample covered once,
a range that fits a block's shared memory, no empty chunk, and fp32
scratch under the cap (one sample's single range partial and running sum
excepted).
"""

import pytest

from ofasys_torch.ops import flash_attention as tflash

# (B, H, Tq, Tk, D, shared bias gradient): the long paths' flash calls at
# base width, the kernel phase's edge shapes, and longer ones past the cap
SHAPES = {
    "gigaword_long_encoder": (16, 12, 1000, 1000, 64, True),
    "gigaword_long_cross": (16, 12, 64, 1000, 64, True),
    "infill_long_encoder": (16, 12, 488, 488, 64, True),
    "infill_long_decoder": (16, 12, 528, 528, 64, True),
    "serve_long": (8, 12, 944, 944, 64, False),
    "per_bh": (2, 12, 300, 300, 64, False),
    "ragged": (3, 12, 200, 333, 64, True),
    "D88": (2, 32, 300, 333, 88, True),
    "D128": (4, 16, 300, 300, 128, True),
    "D256": (2, 16, 290, 290, 256, True),
    "D32_one_range": (4, 8, 256, 256, 32, True),
    "B1": (1, 12, 1000, 1000, 64, False),
    "long_T4096": (2, 12, 4096, 4096, 64, True),
    "long_T8192": (1, 12, 8192, 8192, 64, False),
    "long_T8192_B3": (3, 16, 8192, 8192, 64, True),
    "many_samples": (64, 12, 1000, 1000, 64, True),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_plan_covers_every_key_and_sample_within_the_block_and_the_cap(case):
    B, H, Tq, Tk, D, shared = SHAPES[case]
    plan = tflash.backward_plan(B, H, Tq, Tk, D, shared)
    KR, R = plan.key_range, plan.ranges
    # every key in exactly one range, each range no wider than a block holds
    assert (R - 1) * KR < Tk <= R * KR
    assert KR <= tflash.max_key_range(Tk, D)
    assert R == 1 or KR % 16 == 0
    assert tflash._smem_bytes(KR, D) <= tflash._MAX_SMEM
    # the launches the C entry makes, one after the other: every (sample,
    # range) pair once
    G, RG = plan.group_samples, plan.group_ranges
    pairs = [(b, r) for s0 in range(0, B, G) for r0 in range(0, R, RG)
             for b in range(s0, min(B, s0 + G)) for r in range(r0, min(R, r0 + RG))]
    assert sorted(pairs) == [(b, r) for b in range(B) for r in range(R)]
    # chunks: at least one sample each, as many as the group allows
    per_chunk = -(-G // plan.chunks)
    assert 1 <= plan.chunks <= G and -(-G // per_chunk) == plan.chunks
    # scratch, fp32: the ranges' dq partials (+ the running sum), the chunk
    # partials of a shared bias's gradient
    slot = Tq * H * D
    if R == 1:
        assert plan.dq_scratch == 0
    else:
        assert plan.dq_scratch == (RG + (RG < R)) * G * slot
        assert 4 * plan.dq_scratch <= tflash.SCRATCH_CAP or (G, RG) == (1, 1)
    assert plan.dbias_scratch == (plan.chunks * H * Tq * Tk if shared and plan.chunks > 1 else 0)
    assert 4 * plan.dbias_scratch <= tflash.SCRATCH_CAP


# the plans of the long paths' flash calls (H100: 132 SMs), as PERF.md
# records them: (key range, ranges, chunks, samples a group, ranges a group)
PATH_PLANS = {
    "gigaword_long_encoder": (208, 5, 2, 16, 5),
    "gigaword_long_cross": (208, 5, 2, 16, 5),
    "infill_long_encoder": (176, 3, 16, 16, 3),
    "infill_long_decoder": (176, 3, 16, 16, 3),
    "long_T4096": (240, 18, 1, 1, 18),
    "long_T8192": (240, 35, 1, 1, 9),
}


@pytest.mark.parametrize("case", list(PATH_PLANS))
def test_plan_at_the_path_and_long_shapes(case):
    plan = tflash.backward_plan(*SHAPES[case])
    assert (plan.key_range, plan.ranges, plan.chunks, plan.group_samples,
            plan.group_ranges) == PATH_PLANS[case]


@pytest.mark.parametrize("Tk,D,expect", [(1000, 64, 240), (4096, 64, 240), (333, 88, 160),
                                         (300, 128, 128), (290, 256, 48), (256, 32, 256),
                                         (250, 32, 250), (257, 16, 256)])
def test_max_key_range_mirrors_the_shared_memory_rule(Tk, D, expect):
    """The largest range whose block fits 227 KB: all keys when they fit,
    else a multiple of 16 (the kernel's own ``key_range``; a card test holds
    the two equal)."""
    KR = tflash.max_key_range(Tk, D)
    assert KR == expect
    assert tflash._smem_bytes(KR, D) <= tflash._MAX_SMEM
    if KR < Tk and KR < tflash._MAX_RANGE:
        assert tflash._smem_bytes(KR + 16, D) > tflash._MAX_SMEM


@pytest.mark.parametrize("cap_slots", [1, 2, 3, 4])
def test_a_smaller_cap_groups_samples_then_ranges(cap_slots):
    """Under a cap of fewer dq partial slots than one sample's five ranges
    the samples go one at a time, and a sample's ranges in groups that
    leave a slot for the running sum."""
    B, H, Tq, Tk, D = 3, 4, 300, 1000, 64
    cap = cap_slots * Tq * H * D * 4
    plan = tflash.backward_plan(B, H, Tq, Tk, D, True, cap=cap)
    assert plan.group_samples == 1
    assert plan.group_ranges == max(1, cap_slots - 1)
    assert plan.chunks == 1 and plan.dbias_scratch == 0      # one sample a group
    assert 4 * plan.dq_scratch <= max(cap, 2 * Tq * H * D * 4)


def test_chunks_fill_the_sms():
    """Blocks of (range, head, chunk) run one per SM: the plan takes the
    fewest chunks that reach the fewest waves times samples a chunk."""
    plan = tflash.backward_plan(16, 12, 1000, 1000, 64, False, sms=132)
    waves = -(-(plan.ranges * 12 * plan.chunks) // 132) * -(-16 // plan.chunks)
    assert waves == min(-(-(plan.ranges * 12 * c) // 132) * -(-16 // c) for c in range(1, 17))
    assert tflash.backward_plan(16, 12, 1000, 1000, 64, False, sms=1000).chunks == 16
