"""The frozen trace reader on a small synthetic trace."""

import json

from portbench import trace


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid, "args": args}


def test_window_between_marks(tmp_path):
    events = [
        _x("portbench_open", "user_annotation", 100.0, 0.0),
        _x("aten::mm", "cpu_op", 100.0, 40.0),
        _x("cudaLaunchKernel", "cuda_runtime", 101.0, 2.0, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 110.0, 2.0, correlation=2),
        _x("aten::copy_", "cpu_op", 150.0, 30.0),
        _x("cudaLaunchKernel", "cuda_runtime", 170.0, 2.0, correlation=3),
        # device: two overlapping kernels on two streams, then a gap under aten::copy_, then a B3
        _x("nvjet_tst_gemm", "kernel", 105.0, 20.0, tid=7, correlation=1),
        _x("void at::native::vectorized_elementwise_kernel<4>", "kernel", 115.0, 20.0, tid=8, correlation=2),
        _x("void flash_fwd_mma_kernel<bf16>(args)", "kernel", 175.0, 15.0, tid=7, correlation=3),
        _x("Memcpy HtoD", "gpu_memcpy", 300.0, 10.0, tid=7),
        _x("portbench_close", "user_annotation", 200.0, 0.0),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    w = trace.read(str(path), "portbench_open", "portbench_close")
    assert w["wall_s"] == 100.0 / 1e6
    # union: 105..135 and 175..190; the copy at 300 lies outside the window
    assert abs(w["busy_s"] - 45.0 / 1e6) < 1e-12
    assert abs(w["idle"] - 0.55) < 1e-12
    assert w["launches"] == 3
    assert [op["kind"] for op in w["ops"]] == ["gemm", "elementwise", "B3"]
    gaps = dict((round(s * 1e6, 6), n) for n, s in w["idle_gaps"])
    assert gaps[40.0] == "aten::mm"          # 135..175: the host event active where the gap starts
    assert gaps[5.0] == "aten::mm"           # 100..105
    assert gaps[10.0] == "none"              # 190..200: nothing active on the launching thread
    assert w["device_ops"][0] == ["nvjet_tst_gemm", 20.0 / 1e6]


def test_classify_port_kernels():
    assert trace.classify("void dense_bwd_mma::bwd_mma_kernel<false, true>(__nv_bfloat16 const*, int)") == "flash-bwd"
    assert trace.classify("void dense_bwd_mma::bwd_mma_kernel<false, false>(__nv_bfloat16 const*, int)") == "B2"
    assert trace.classify("void flash_fwd_mma_kernel<64>(x)") == "B3"
    assert trace.classify("Memset", "gpu_memset") == "copy/set"
