"""The port's trace breakdown (``utils/trace.py``) against the JAX
module's (``tossctr_tpu/utils/trace.py``):

* ``classify_op`` gives the JAX module's class on each case of
  ``tests/test_trace.py``, translated into a kernel and the ``cpu_op``
  that launched it (the table write by its output rows, the table gather
  by its operand rows, attention, matmul, elementwise, sort, data
  formatting), and on the port's own kernels (the attention, custom-call
  and table-sweep kernels, whatever op launched them); ``_shape_rows``
  reads a ``cpu_op``'s input shapes (TensorLists and scalars among them);
* a hand-written trace in the form ``torch.profiler`` exports (host
  ``cpu_op``, ``user_annotation``, ``cuda_runtime`` and ``Trace`` events,
  the device's kernel, memcpy and memset events and a
  ``gpu_user_annotation`` span over them, flow events, linked by
  ``External id``): only the device's kernel, memcpy and memset time is
  summed, once, and each class gets its share; ``find_trace_file`` finds
  the latest ``.json`` / ``.json.gz``; ``top_ops`` and
  ``top_ops_detailed`` rank the kernels with their op and class;
* a real CPU profile of a few tensor ops yields no device events.

One test item (see ``_torch_helpers``).
"""

import gzip
import json
import os
import time

from _torch_helpers import Checks

TBL = "%f = bf16[10000000,128]{1,0} fusion(bf16[10000000,128]{1,0} %t)"
GAT = "%f = bf16[3276800,128]{1,0} fusion(bf16[10000000,128]{1,0} %t)"
ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add"
               "<c10::BFloat16>, at::detail::Array<char*, 3> >(int, at::native::CUDAFunctor_add"
               "<c10::BFloat16>, at::detail::Array<char*, 3>)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroupsize1x1x1_execute"

# (the JAX case of tests/test_trace.py: name, long_name, hlo_category),
# (its translation: kernel name, op, input dims, trace category)
CASES = [
    (("fusion.27", TBL, "custom fusion"),
     (ELEMENTWISE, "aten::add_", [[10000000, 128], [10000000, 128], []], "kernel")),
    (("fusion", GAT, "custom fusion"),
     ("void at::native::elementwise_kernel<128, 2>(int)", "aten::mul",
      [[10000000, 128], [3276800, 1]], "kernel")),
    (("mha.9", "", "custom-call"),
     ("void mha_qkv_fwd_chain<8>(__nv_bfloat16 const*, float*)", "", [], "kernel")),
    (("fusion.99", "%f = f32[8192,60]", "convolution fusion"),
     (GEMM, "aten::mm", [[8192, 60], [60, 64]], "kernel")),
    (("fusion.5", "%f = f32[8192,60]", "loop fusion"),
     ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>(int)",
      "aten::gelu", [[8192, 60], []], "kernel")),
    (("sort.1", "", "sort"),
     ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<at_cuda_detail::cub::"
      "DeviceRadixSortPolicy<long, long, int>::Policy900>(int*)", "aten::sort",
      [[8192, 400], [], []], "kernel")),
    (("copy.2", "", "data formatting"),
     ("Memcpy DtoD (Device -> Device)", "aten::copy_", [[8192, 60], [8192, 60], []],
      "gpu_memcpy")),
]

# more torch kernels and the class each must get
TORCH_CASES = [
    (("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float>(float*)",
      "aten::_softmax", [[8192, 8, 64, 64], [], []], "kernel"), "attention"),
    (("void at::native::indexFuncLargeIndex<c10::BFloat16, long>(int)", "aten::index_add_",
      [[4096, 64], [], [512], [512, 64]], "kernel"), "table_update"),
    (("void at::native::(anonymous namespace)::indexSelectLargeIndex<float>(int)",
      "aten::index_select", [[4096, 64], [], [512]], "kernel"), "select_gather"),
    (("void at::native::index_elementwise_kernel<128, 4>(long)", "aten::index",
      [[8192, 400], []], "kernel"), "select_gather"),
    (("void at::native::index_elementwise_kernel<128, 4>(long)", "aten::index_put_",
      [[8192, 400], [], [8192, 400], []], "kernel"), "table_update"),
    (("nvjet_tst_128x64_64x8_1x2_h_bz_coopA_NNT", "aten::addmm",
      [[64], [8192, 60], [60, 64], [], []], "kernel"), "matmul"),
    (("Memset (Device)", "aten::zero_", [[8192, 64]], "gpu_memset"), "data_formatting"),
    (("Memset (Device)", "aten::zero_", [[10000000, 64]], "gpu_memset"), "table_update"),
    (("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, 4>(int)",
      "aten::cat", [[[8192, 60], [8192, 4]], []], "kernel"), "data_formatting"),
    (("void at::native::reduce_kernel<512, 1>(int)", "aten::sum", [[8192, 60], [], []],
      "kernel"), "elementwise_fusion"),
    (("void at::native::multi_tensor_apply_kernel<4>(int)", "aten::_foreach_mul_",
      [[[10000000, 128], [64, 64]], []], "kernel"), "table_update"),
    (("void some_library_kernel(int)", "", [], "kernel"), "other"),
    # the port's hand-written kernels go by their own names
    (("void tail_bwd_mma<8>(float*)", "autograd::engine::evaluate_function: _FusedMHAQKVBackward",
      [], "kernel"), "custom_call"),
    (("void reduce_partials(float const*, float*, int, int)",
      "autograd::engine::evaluate_function: _FusedMHAQKVBackward", [], "kernel"), "custom_call"),
    (("void block_tail_fwd_kernel<float>(float*)", "", [], "kernel"), "custom_call"),
    (("void ffn_bwd_mma<8>(float*)", "", [], "kernel"), "custom_call"),
    (("void fm_bwd_mma_kernel<8>(float*)", "", [], "kernel"), "custom_call"),
    (("void fm_dv_kernel(float*)", "", [], "kernel"), "custom_call"),
    (("void attn_dump_kernel(unsigned char*)", "", [], "kernel"), "custom_call"),
    (("void ffn_dump_kernel(unsigned char*)", "", [], "kernel"), "custom_call"),
    (("void mha_bwd_mma<8>(float*)", "aten::empty", [[8192, 64]], "kernel"), "attention"),
    (("void sweep_pieces_kernel<__nv_bfloat16>(int)", "", [], "kernel"), "table_update"),
    (("void sweep_merge_kernel<float>(int)", "aten::sort", [[491520]], "kernel"),
     "table_update"),
    (("sweep_kernel(__nv_bfloat16*, Walk, float)", "", [], "kernel"), "table_update"),
]


def _write_trace(path):
    """A trace in torch.profiler's chrome form: host pid 100 (python thread
    100), device pid 0 stream 7; 6 ms of table update + 4 ms of attention
    + 0.5 ms memcpy + 0.25 ms memset on the device, under spans that must
    not be counted."""
    ev = [
        {"ph": "M", "name": "process_name", "pid": 100, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)", "pid": "Spans",
         "tid": "PyTorch Profiler", "ts": 0, "dur": 20_000},
        {"ph": "X", "cat": "user_annotation", "name": "select.dense", "pid": 100, "tid": 100,
         "ts": 0, "dur": 12_000, "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::index_add_", "pid": 100, "tid": 100,
         "ts": 10, "dur": 50, "args": {"External id": 2,
                                       "Input Dims": [[10000000, 128], [], [491520],
                                                      [491520, 128]]}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 100, "tid": 100,
         "ts": 20, "dur": 5, "args": {"External id": 2, "correlation": 40}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "pid": 100, "tid": 100, "ts": 70,
         "dur": 20, "args": {"External id": 3, "Input Dims": [[8192, 60], [8192, 60], []]}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "pid": 100, "tid": 100,
         "ts": 72, "dur": 5, "args": {"External id": 3, "correlation": 41}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 100, "tid": 100,
         "ts": 95, "dur": 5, "args": {"External id": 0, "correlation": 42}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::zero_", "pid": 100, "tid": 100, "ts": 110,
         "dur": 20, "args": {"External id": 4, "Input Dims": [[8192, 64]]}},
        {"ph": "X", "cat": "python_function", "name": "train.py(12): step", "pid": 100,
         "tid": 100, "ts": 0, "dur": 20_000, "args": {"Python id": 1}},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 40, "pid": 100, "tid": 100, "ts": 20},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 40, "pid": 0, "tid": 7, "ts": 100,
         "bp": "e"},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "select.dense", "pid": 0, "tid": 7,
         "ts": 100, "dur": 11_000, "args": {"External id": 1}},
        {"ph": "X", "cat": "kernel", "name": ELEMENTWISE, "pid": 0, "tid": 7, "ts": 100,
         "dur": 6_000, "args": {"External id": 2, "correlation": 40, "stream": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD (Device -> Device)", "pid": 0,
         "tid": 7, "ts": 6_100, "dur": 500, "args": {"External id": 3, "correlation": 41}},
        {"ph": "X", "cat": "kernel", "name": "void mha_qkv_bwd_mma<8>(float*)", "pid": 0,
         "tid": 7, "ts": 6_600, "dur": 4_000, "args": {"External id": 0, "correlation": 42}},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset (Device)", "pid": 0, "tid": 7,
         "ts": 10_600, "dur": 250, "args": {"External id": 4, "correlation": 43}},
    ]
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": ev}, f)


def test_torch_trace_breakdown(tmp_path):
    import torch

    from tossctr_tpu.utils import trace as jtrace
    from tossctr_tpu_torch.utils import trace

    def classify_cases():
        assert trace.BIG_ROWS == jtrace.BIG_ROWS == 5_000_000
        for (jname, jlong, jcat), (name, op, dims, cat) in CASES:
            want = jtrace.classify_op(jname, jlong, jcat)
            got = trace.classify_op(name, op, dims, cat)
            assert got == want, (jname, name, got, want)
        for (name, op, dims, cat), want in TORCH_CASES:
            got = trace.classify_op(name, op, dims, cat)
            assert got == want, (name, op, got, want)
        # the row threshold is a parameter, as in the JAX module
        assert trace.classify_op(ELEMENTWISE, "aten::add_", [[4096, 64]], "kernel",
                                 big_rows=4096) == "table_update"

    def shape_rows():
        assert trace._shape_rows("aten::index_add_", [[10000000, 128], [], [491520],
                                                      [491520, 128]]) == (10_000_000, 10_000_000)
        assert trace._shape_rows("aten::index_select", [[10000000, 128], [], [3276800]]) == \
            (0, 10_000_000)
        assert trace._shape_rows("aten::_foreach_add_", [[[10000000, 128], [64, 64]],
                                                         [[10000000, 128], [64, 64]], []]) == \
            (10_000_000, 10_000_000)
        assert trace._shape_rows("aten::cat", [[[3, 4], [5, 4]], []]) == (0, 5)
        assert trace._shape_rows("aten::mul", []) == (0, 0)
        assert trace._shape_rows("aten::add", [[], []]) == (0, 0)
        assert trace._shape_rows("", None) == (0, 0)

    def hand_written_trace():
        d = tmp_path / "prof" / "worker0"
        d.mkdir(parents=True)
        old = d / "old.pt.trace.json"
        _write_trace(old)
        os.utime(old, (time.time() - 60, time.time() - 60))
        tp = d / "step.pt.trace.json.gz"
        _write_trace(tp)
        assert trace.find_trace_file(str(tmp_path / "prof")) == str(tp)
        assert trace.find_trace_file(str(tmp_path / "nothing")) is None
        for path in (tp, old):
            events = trace.load_device_events(str(path))
            assert [e["cat"] for e in events] == ["kernel", "gpu_memcpy", "kernel", "gpu_memset"]
            assert [e["op"] for e in events] == ["aten::index_add_", "aten::copy_", "",
                                                 "aten::zero_"]
            bd = trace.op_time_breakdown(str(path))
            assert bd == {"table_update": 6.0, "attention": 4.0, "data_formatting": 0.75}, bd
            assert list(bd) == ["table_update", "attention", "data_formatting"]
            assert sum(bd.values()) == 10.75  # the device's work once: no span counted
            assert trace.op_time_breakdown(events) == bd
        top = trace.top_ops(str(tp), n=2)
        assert top == [(ELEMENTWISE, 6.0), ("void mha_qkv_bwd_mma<8>(float*)", 4.0)]
        det = trace.top_ops_detailed(str(tp), n=3)
        assert [(d["class"], d["op"], d["calls"], d["ms"]) for d in det] == [
            ("table_update", "aten::index_add_", 1, 6.0), ("attention", "", 1, 4.0),
            ("data_formatting", "aten::copy_", 1, 0.5)]
        assert det[0]["input_dims"] == "[[10000000, 128], [], [491520], [491520, 128]]"

    def cpu_profile_has_no_device_events():
        from torch.profiler import ProfilerActivity, profile, record_function

        a = torch.randn(64, 32)
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            with record_function("select.dense"):
                c = a @ a.T
            c.add_(1.0)
            torch.cat([c, c]).sum()
        path = tmp_path / "cpu" / "cpu.json"
        path.parent.mkdir()
        prof.export_chrome_trace(str(path))
        assert trace.find_trace_file(str(path.parent)) == str(path)
        assert trace.load_device_events(str(path)) == []
        assert trace.op_time_breakdown(str(path)) == {}
        assert trace.top_ops_detailed(str(path)) == []

    checks = Checks()
    checks.run("classify_op: the JAX cases and the torch kernels", classify_cases)
    checks.run("_shape_rows from a cpu_op's input dims", shape_rows)
    checks.run("a hand-written torch.profiler trace", hand_written_trace)
    checks.run("a CPU profile has no device events", cpu_profile_has_no_device_events)
    checks.done()
