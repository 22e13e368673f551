"""The benchmark's reader of the program's spans (portbench/spans.py) on a
small hand-written Chrome trace, and the span metrics' readers
(portbench/metrics/), which read nothing from an untraced run or from a
trace read without the spans."""

import json

import pytest

from portbench import spans, spec

US = 1e-6


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": dur, "args": args}


def _trace():
    """Thread 1: local_energy [0, 100] holds el.chunk [10, 50], with
    el.det_head [20, 40] and el.ewald [40, 48] right after it, and el.chunk
    [50, 90] right after the first. A kernel launched at 25 in el.det_head
    runs at 200, after every span ended; cuBLAS's driver launch at 45 lies
    in el.ewald and not in the det head that ended at 40; a copy launched
    at 70 in the second el.chunk. A kernel launched at 150 lies in no span
    of its thread (thread 2's op span covers 150 and must not take it), a
    memset has no launch, and an iteration span left open when the
    profiler stopped is no span. Thread 3 opens no span, as the autograd
    engine's worker: its launch at 80 falls in thread 1's second el.chunk
    and in nothing of thread 2, and so does its ATen call at 78. The op
    span holds two ATen calls, one inside the other; thread 1's call at
    148 lies in no span."""
    return [
        _x("user_annotation", "deepsolid.iteration", 0, 300, finished=False),
        _x("user_annotation", "deepsolid.local_energy", 0, 100),
        _x("user_annotation", "deepsolid.el.chunk", 10, 40),
        _x("user_annotation", "deepsolid.el.det_head", 20, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 25, 2, correlation=1),
        _x("user_annotation", "deepsolid.el.ewald", 40, 8),
        _x("cuda_driver", "cuLaunchKernel", 45, 2, correlation=2),
        _x("user_annotation", "deepsolid.el.chunk", 50, 40),
        _x("cuda_runtime", "cudaMemcpyAsync", 70, 2, correlation=3),
        _x("cpu_op", "autograd::engine::evaluate_function: MulBackward0", 78, 5, tid=3),
        _x("cuda_runtime", "cudaLaunchKernel", 80, 2, tid=3, correlation=5),
        _x("cpu_op", "aten::mm", 148, 5),
        _x("cuda_runtime", "cudaLaunchKernel", 150, 2, correlation=4),
        _x("user_annotation", "deepsolid.op.gj_inverse_slogdet", 140, 20, tid=2),
        _x("cpu_op", "aten::zeros", 142, 4, tid=2),
        _x("cpu_op", "aten::empty", 143, 1, tid=2),
        _x("user_annotation", "portbench.local_energy", 0, 100),
        _x("kernel", "gj_registers_kernel", 200, 30, tid=7, correlation=1),
        _x("kernel", "sm80_xmma_gemm", 231, 10, tid=7, correlation=2),
        _x("gpu_memcpy", "Memcpy DtoD", 242, 5, tid=7, correlation=3),
        _x("kernel", "elementwise_kernel", 250, 7, tid=7, correlation=4),
        _x("gpu_memset", "Memset", 260, 2, tid=7),
        _x("kernel", "mul_backward_kernel", 263, 4, tid=7, correlation=5),
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "pid": 1, "tid": 7, "ts": 200,
         "id": 1},
    ]


def test_read_attributes_device_time_by_launch(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    got = spans.read(str(path))
    assert got["count"] == {"local_energy": 1, "el.chunk": 2, "el.det_head": 1,
                            "el.ewald": 1, "op.gj_inverse_slogdet": 1}
    assert got["host_s"] == pytest.approx({"local_energy": 100 * US, "el.chunk": 80 * US,
                                           "el.det_head": 20 * US, "el.ewald": 8 * US,
                                           "op.gj_inverse_slogdet": 20 * US})
    # inclusive: the det head's kernel counts for el.chunk and local_energy
    assert got["device_s"] == pytest.approx({"el.det_head": 30 * US, "el.ewald": 10 * US,
                                             "el.chunk": 49 * US, "local_energy": 49 * US})
    assert got["launches"] == {"el.det_head": 1, "el.ewald": 1, "el.chunk": 4,
                               "local_energy": 4}
    assert got["unattributed_s"] == pytest.approx(9 * US)
    assert got["cpu_ops"] == {"local_energy": 1, "el.chunk": 1, "op.gj_inverse_slogdet": 2}


METRICS = ("el_trunk_s", "el_orbitals_s", "el_det_head_s", "el_launches_per_chunk",
           "wrapper_host_us", "wrapper_aten_ops_per_call")


@pytest.mark.parametrize("name", METRICS)
def test_span_metrics_read_nothing_without_spans(name):
    read = spec.reader(name)
    run = {"batch": 4, "traffic": {"el_chunk": 2}}
    assert read({**run, "trace": None}) is None  # untraced
    assert read({**run, "trace": {"busy_s": 1.0}}) is None  # no spans read


def test_span_metrics_on_the_hand_written_trace():
    run = {"batch": 4, "traffic": {"el_chunk": 2},
           "trace": {"spans": spans.summarize(_trace())}}
    # two chunks of 2 walkers: one pass over the batch of 4
    assert spans.el_passes(run["trace"]["spans"], 2, 4) == 1
    assert spans.el_passes(run["trace"]["spans"], 0, 4) == 2  # unchunked
    assert spec.reader("el_det_head_s")(run) == pytest.approx(30 * US)
    assert spec.reader("el_trunk_s")(run) is None  # no such span
    assert spec.reader("el_launches_per_chunk")(run) == 2.0
    assert spec.reader("wrapper_host_us")(run) == pytest.approx(20.0)
    assert spec.reader("wrapper_aten_ops_per_call")(run) == 2.0
