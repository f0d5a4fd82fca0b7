"""ofasys_torch/tools/profile_breakdown.py on Chrome traces.

A synthetic trace fixes what the tool must find: kernels on two streams
that overlap (device busy is their union, less than their sum), launches
matched to their kernels by correlation id, a kernel without a launch, a
copy, two ``update <n>`` ranges, and an idle gap that begins under a known
``cpu_op``. A real trace from ``utils/profiler.profile`` around a tiny
forward on the CPU has no device events: the tool says so and summarizes
the host. ``classify`` knows every ``__global__`` kernel of the port's
``csrc/`` by its id.
"""

import json
import re

import pytest
import torch

from ofasys_torch.ops.cuda_build import CSRC
from ofasys_torch.tools import profile_breakdown as pb
from ofasys_torch.utils import profiler

HOST, DEV = 100, 0      # pids: the host process, the card
MAIN = 1                # the launching thread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(cat, name, ts, dur, pid=HOST, tid=MAIN, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, pid=pid, tid=tid, args=args)


def _launch(ts, corr, name="cudaLaunchKernel"):
    return _x("cuda_runtime", name, ts, 1.0, correlation=corr)


def _kernel(name, ts, dur, stream, corr=None, cat="kernel"):
    args = {} if corr is None else {"correlation": corr}
    return _x(cat, name, ts, dur, pid=DEV, tid=stream, **args)


GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute_segment_k_off_kernel__5x_cublas"
ADD = "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)"
FLASH_BWD = "void dense_bwd_mma::bwd_mma_kernel<false, true>(__nv_bfloat16 const*, __nv_bfloat16 const*, int)"
DQ_REDUCE = "void dense_bwd_mma::dq_reduce_kernel(float const*, float*, __nv_bfloat16*, unsigned long, int, float)"
B1 = "void (anonymous namespace)::dense_attention_fwd_mma_kernel(__nv_bfloat16 const*, __nv_bfloat16 const*, int)"
REDUCE = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4> >(at::native::ReduceOp<float, at::native::func_wrapper_t<float, at::native::sum_functor<float, float, float>::operator()(at::TensorIterator&)::{lambda(float, float)#1}>, unsigned int, float, 4, 4>)"


def synthetic_trace():
    """Times in µs. update 1 [0, 100]: a GEMM [15, 35] on stream 7 and an
    add [25, 45] on stream 8 (union 30, sum 40), then the flash backward
    [50, 60] and its dq reduction [61, 65]. update 2 [200, 300]: B1 [210,
    220], a DtoH copy [221, 222], then the host sits in aten::item from 222
    (the device idle until a reduction [270, 290]), and a kernel without a
    launch [292, 295]."""
    ev = [
        dict(ph="M", name="process_name", pid=HOST, tid=0, args={"name": "python"}),
        _x("Trace", "PyTorch Profiler (0)", -50.0, 400.0),
        _x("user_annotation", "update 1", 0.0, 100.0),
        _x("cpu_op", "aten::addmm", 10.0, 10.0), _launch(12.0, 1),
        _x("cpu_op", "aten::add", 20.0, 5.0), _launch(21.0, 2),
        _x("cpu_op", "FlashAttentionBackward", 28.0, 20.0), _launch(30.0, 3), _launch(31.0, 4),
        _kernel(GEMM, 15.0, 20.0, 7, 1), _kernel(ADD, 25.0, 20.0, 8, 2),
        _kernel(FLASH_BWD, 50.0, 10.0, 7, 3), _kernel(DQ_REDUCE, 61.0, 4.0, 7, 4),
        _x("user_annotation", "update 2", 200.0, 100.0),
        _x("cpu_op", "DenseAttention", 204.0, 4.0), _launch(205.0, 5),
        _launch(209.0, 6, "cudaMemcpyAsync"),
        _x("cpu_op", "aten::item", 222.0, 40.0),
        _x("cpu_op", "aten::_local_scalar_dense", 223.0, 38.0),
        _x("cpu_op", "aten::sum", 264.0, 3.0), _launch(265.0, 7),
        _kernel(B1, 210.0, 10.0, 7, 5),
        _kernel("Memcpy DtoH (Device -> Pinned)", 221.0, 1.0, 7, 6, cat="gpu_memcpy"),
        _kernel(REDUCE, 270.0, 20.0, 8, 7),
        _kernel(ADD, 292.0, 3.0, 8),
        _x("gpu_user_annotation", "update 2", 200.0, 100.0, pid=DEV, tid=7),
        dict(ph="s", cat="ac2g", name="ac2g", id=5, pid=HOST, tid=MAIN, ts=205.0),
    ]
    return {"traceEvents": ev}


@pytest.fixture
def trace_dir(tmp_path):
    d = tmp_path / "profile" / "run"
    d.mkdir(parents=True)
    (d / "trace.json").write_text(json.dumps(synthetic_trace()))
    return str(tmp_path / "profile")


def test_find_trace(trace_dir, tmp_path):
    assert pb.find_trace(trace_dir).endswith("run/trace.json")
    assert pb.find_trace(pb.find_trace(trace_dir)) == pb.find_trace(trace_dir)
    with pytest.raises(FileNotFoundError):
        pb.find_trace(str(tmp_path / "profile" / "run" / "empty_dir_absent"))


def test_load_ops_correlates_launches(trace_dir):
    ops = pb.load_ops(pb.find_trace(trace_dir))
    assert [o["kind"] for o in ops] == ["gemm", "elementwise", "flash-bwd", "flash-bwd", "B1",
                                         "copy/set", "reduction", "elementwise"]
    assert [o["launch_ts"] for o in ops] == [12.0, 21.0, 30.0, 31.0, 205.0, 209.0, 265.0, None]
    assert ops[5]["launch_name"] == "cudaMemcpyAsync"
    assert {o["launch_tid"] for o in ops[:-1]} == {MAIN}


def test_summary_union_kinds_and_gaps(trace_dir):
    res = pb.summarize(trace_dir, top_n=5, verbose=False)
    assert res["device"]
    assert res["wall_ms"] == pytest.approx(0.300)               # first host event to last end
    assert res["busy_ms"] == pytest.approx(0.078)               # union: 30 + 10 + 4 + 10 + 1 + 20 + 3
    assert sum(k["ms"] for k in res["by_kind"].values()) == pytest.approx(0.088)   # the sum
    assert res["idle"] == pytest.approx(1 - 78 / 300)
    assert (res["launches"], res["copies"]) == (7, 1)
    assert {k: (round(v["ms"], 6), v["count"]) for k, v in res["by_kind"].items()} == {
        "gemm": (0.02, 1), "elementwise": (0.023, 2), "flash-bwd": (0.014, 2), "B1": (0.01, 1),
        "reduction": (0.02, 1), "copy/set": (0.001, 1)}
    assert res["top_ops"][0]["name"] == ADD and res["top_ops"][0]["count"] == 2
    gap = res["gaps"][0]
    assert gap["ms"] == pytest.approx(0.145) and gap["at_ms"] == pytest.approx(0.065)
    assert gap["stack"] == ["update 1"] and gap["next_op"] == B1
    assert [round(g["ms"], 6) for g in res["gaps"]] == [0.145, 0.048, 0.015, 0.005, 0.005]


def test_summary_ranges(trace_dir):
    res = pb.summarize(trace_dir, ranges="update ", verbose=False)
    u1, u2 = res["ranges"]["update 1"], res["ranges"]["update 2"]
    assert sorted(res["ranges"]) == ["update 1", "update 2"]
    assert (u1["wall_ms"], u1["busy_ms"], u1["launches"]) == (pytest.approx(0.1), pytest.approx(0.044), 4)
    assert u1["idle"] == pytest.approx(0.56)
    # the kernel without a launch goes with the range of the event before it
    assert (u2["busy_ms"], u2["launches"], u2["copies"]) == (pytest.approx(0.034), 3, 1)
    assert u2["op_counts"] == {B1: 1, "Memcpy DtoH (Device -> Pinned)": 1, REDUCE: 1, ADD: 1}
    gap = u2["gaps"][0]
    assert gap["ms"] == pytest.approx(0.048) and gap["at_ms"] == pytest.approx(0.022)
    assert (gap["host"], gap["host_cat"]) == ("aten::item", "cpu_op")
    assert gap["stack"] == ["update 2", "aten::item"]


def test_cli_prints_the_summary(trace_dir, capsys):
    assert pb.main([trace_dir, "3", "--ranges", "update "]) == 0
    out = capsys.readouterr().out
    assert "device busy 0.078 ms (union), idle 74.0%, 7 kernel launches, 1 copies/sets" in out
    assert "== update 2" in out and "update 2 > aten::item" in out


def test_cpu_trace_has_no_device_lines(tmp_path, capsys):
    with profiler.profile(str(tmp_path)):
        with profiler.annotate("update 1"):
            net = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.ReLU(), torch.nn.Linear(32, 4))
            net(torch.randn(8, 16)).sum()
    res = pb.summarize(str(tmp_path), ranges="update ")
    out = capsys.readouterr().out
    assert not res["device"] and res["idle"] is None and res["busy_ms"] == 0.0
    assert res["launches"] == 0 and res["gaps"] == [] and res["by_kind"] == {}
    assert res["wall_ms"] > 0
    assert "aten::linear" in {o["name"] for o in res["host_ops"]}
    assert res["ranges"]["update 1"]["idle"] is None
    assert "no device events in this trace" in out and "aten::linear" in out


PORT_KERNELS = [
    ("void (anonymous namespace)::dense_attention_fwd_mma_kernel(__nv_bfloat16 const*, int)", "B1"),
    ("void (anonymous namespace)::dense_attention_fwd_kernel<float>(float const*, int)", "B1"),
    ("void dense_bwd_mma::bwd_mma_kernel<false, false>(__nv_bfloat16 const*, int)", "B2"),
    ("void dense_bwd_mma::bwd_mma_kernel<(bool)0, (bool)0>(__nv_bfloat16 const*, int)", "B2"),
    ("void (anonymous namespace)::bwd_rows_kernel<float>(float const*, int)", "B2"),
    ("void (anonymous namespace)::bwd_cols_kernel<float>(float const*, int)", "B2"),
    ("void dense_bwd_mma::bwd_mma_kernel<true, false>(__nv_bfloat16 const*, int)", "B2r"),
    ("void (anonymous namespace)::bwd_rowmajor_kernel<float>(float const*, int)", "B2r"),
    ("void (anonymous namespace)::dq_reduce_kernel(float const*, float*, unsigned long, int)", "B2r"),
    ("void (anonymous namespace)::flash_fwd_mma_kernel<64, 64>(__nv_bfloat16 const*, int)", "B3"),
    ("void dense_bwd_mma::bwd_mma_kernel<false, true>(__nv_bfloat16 const*, int)", "flash-bwd"),
    ("void dense_bwd_mma::bwd_mma_kernel<true, true>(__nv_bfloat16 const*, int)", "flash-bwd"),
    ("void dense_bwd_mma::bwd_mma_kernel<(bool)1, (bool)1>(__nv_bfloat16 const*, int)", "flash-bwd"),
    ("void dense_bwd_mma::dq_reduce_kernel(float const*, float*, unsigned long)", pb.SHARED_REDUCTION),
    ("void dense_bwd_mma::dbias_reduce_kernel(float const*, float*, unsigned long)", pb.SHARED_REDUCTION),
    ("void (anonymous namespace)::ln_fwd_kernel<__nv_bfloat16>(__nv_bfloat16 const*, int)", "B6"),
    ("void (anonymous namespace)::ln_fwd_rows_kernel<__nv_bfloat16, 1, 3>(__nv_bfloat16 const*)", "B6"),
    ("void (anonymous namespace)::ln_bwd_kernel<float>(float const*, int)", "B6"),
    ("void (anonymous namespace)::ln_bwd_rows_kernel<__nv_bfloat16, 1, 3, 2, false>(float const*)", "B6"),
    ("void (anonymous namespace)::ln_bwd_reduce_kernel(float const*, float*, int)", "B6"),
    ("void (anonymous namespace)::int8_mma_kernel<2, 2, 4, 2, 64, 4, true, __nv_bfloat16>(signed char const*)",
     "B7"),
    ("void (anonymous namespace)::int8_dp4a_kernel<__nv_bfloat16>(signed char const*, int)", "B7"),
]
OTHERS = [
    (GEMM, "gemm"), ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_NTT", "gemm"),
    ("void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, false>(float)", "gemm"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align8>(int)", "gemm"),
    (ADD, "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)"
     "::{lambda()#3}::operator()() const::{lambda(float)#1}>(int)", "copy/set"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, std::array<char*, 1ul> >"
     "(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)", "copy/set"),
    (REDUCE, "reduction"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>(int, float)",
     "reduction"),
    ("void (anonymous namespace)::softmax_warp_forward<float, float, float, 8, false, false>(float*)", "reduction"),
    ("void at::native::(anonymous namespace)::indexing_backward_kernel<float, 4>(long const*, float*)", "other"),
]


@pytest.mark.parametrize("name,kind", PORT_KERNELS + OTHERS)
def test_classify(name, kind):
    assert pb.classify(name) == kind


@pytest.mark.parametrize("cat", ["gpu_memcpy", "gpu_memset"])
def test_classify_copies_and_sets(cat):
    assert pb.classify("Memcpy HtoD (Pageable -> Device)", cat) == "copy/set"


def test_every_port_kernel_has_an_id():
    """Each __global__ function of csrc/ is named in PORT_KERNELS and
    classified as a port kernel."""
    names = set()
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                                src.read_text()))
    assert len(names) >= 14
    named = {pb.symbol(n) for n, _ in PORT_KERNELS}
    assert names <= named, names - named
    for n, kind in PORT_KERNELS:
        assert kind in pb.PORT_IDS + (pb.SHARED_REDUCTION,)
