"""The reduction of a traced window: busy time, device time by kernel
name and by the host span that launched it, idle gaps by what the host
was doing, and the per-layer readers on top of it."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench import cell as cell_mod, trace
from port_bench.tests.small import ROOT

MS = 1_000_000  # ns


class Ev:
    """A profiler event as the card's torch gives it: a name, a device type,
    whether it is a user annotation, times and a correlation id (and no
    activity type)."""

    def __init__(self, name, kind, start, end, corr=0, device=False):
        self._v = (name, kind, start, end, corr, device)

    def name(self): return self._v[0]
    def is_user_annotation(self): return self._v[1].endswith("user_annotation")
    def start_ns(self): return self._v[2]
    def end_ns(self): return self._v[3]
    def correlation_id(self): return self._v[4]
    def device_type(self): return DeviceType.CUDA if self._v[5] else DeviceType.CPU


def fake_profile():
    events = [
        Ev(trace.WINDOW_SPAN, "user_annotation", 0, 100 * MS),
        Ev("bench.prefill", "user_annotation", 1 * MS, 40 * MS),
        Ev("attention", "user_annotation", 2 * MS, 10 * MS),
        Ev("attention", "gpu_user_annotation", 5 * MS, 15 * MS, 1, True),
        Ev("aten::mm", "cpu_op", 3 * MS, 4 * MS),
        Ev("cudaLaunchKernel", "cuda_runtime", 3 * MS, 3 * MS + 10, corr=1),
        Ev("cudaLaunchKernel", "cuda_runtime", 20 * MS, 20 * MS + 10, corr=2),
        Ev("aten::item", "cpu_op", 50 * MS, 90 * MS),
        Ev("cuLaunchKernelEx", "cuda_driver", 60 * MS, 60 * MS + 10, corr=3),
        Ev("void flash_kernel_wgmma<128, 2>(CUtensorMap)", "kernel", 5 * MS, 15 * MS, 1, True),
        Ev("ampere_bf16_gemm", "kernel", 15 * MS, 30 * MS, 2, True),
        Ev("Memset (Device)", "gpu_memset", 70 * MS, 80 * MS, 3, True),
        Ev("late", "kernel", 95 * MS, 120 * MS, 9, True),  # clipped at the window
    ]
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_busy_spans_kernels_and_gaps():
    tr = trace.Trace(fake_profile())
    assert tr.event_kinds == {"annotation": 3, "device_annotation": 1, "host_op": 2,
                              "launch": 3, "device_op": 4}
    assert tr.window_s == pytest.approx(0.1)
    assert tr.busy_s == pytest.approx(0.040)
    assert tr.device_s() == pytest.approx(0.040)
    assert tr.device_s(r"\bflash_kernel_(wgmma|f32)\b") == pytest.approx(0.010)
    assert tr.device_s_in("attention") == pytest.approx(0.010)
    assert tr.device_s_in("bench.prefill") == pytest.approx(0.025)
    assert tr.device_s_in("moe_ffn") is None
    assert tr.unattributed == 1  # "late" has no launch record
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["ampere_bf16_gemm", pytest.approx(0.015)]
    assert ["flash_kernel_wgmma", pytest.approx(0.010)] in bd["device_ops"]
    gaps = dict(bd["idle_gaps"])  # by the innermost host event at each gap's start
    assert gaps == {"bench.prefill": pytest.approx(0.040),  # 30-70 ms
                    "aten::item": pytest.approx(0.015),  # 80-95 ms
                    "bench.window": pytest.approx(0.005)}  # 0-5 ms


def test_readers_of_the_serving_cell():
    cell = cell_mod.resolve(ROOT, "yi-serve-docs-c64")
    tr = trace.Trace(fake_profile())
    counts = {"window_s": 0.1, "ticks": 2, "tick_host_ms": 30.0,
              "prefill_lens": [16], "decodes": [(4, 100)],
              "flash_forward_calls": cell.config["num_layers"],
              "ttft_ms": [float(t) for t in range(20, 0, -1)]}
    got = {m["name"]: r.read(tr, counts, cell.config) for m, r in cell.per_layer}
    assert got["serve.decode_tick_ms"] == 15.0
    assert got["serve.ttft_p90_ms"] == 18.0  # the 18th of 20: nearest rank
    assert got["serve.prefill_ms"] == pytest.approx(25.0)
    assert got["device.idle_share.serve"] == pytest.approx(60.0)
    assert got["attention.share.serve"] == pytest.approx(25.0)
    assert 0 < got["mfu.serve"] < 100 and 0 < got["flash_fwd_roofline"]
    counts["flash_forward_calls"] += 1  # launches the prompts do not account for
    reader = next(r for m, r in cell.per_layer if m["name"] == "flash_fwd_roofline")
    assert reader.read(tr, counts, cell.config) is None


def test_readers_of_the_training_cell():
    events = [
        Ev(trace.WINDOW_SPAN, "user_annotation", 0, 100 * MS),
        Ev("moe_ffn", "user_annotation", 10 * MS, 50 * MS),
        Ev("moe_experts", "user_annotation", 20 * MS, 30 * MS),
        Ev("cudaLaunchKernel", "cuda_runtime", 12 * MS, 12 * MS + 10, corr=1),
        Ev("cudaLaunchKernel", "cuda_runtime", 25 * MS, 25 * MS + 10, corr=2),
        Ev("cuLaunchKernelEx", "cuda_driver", 60 * MS, 60 * MS + 10, corr=3),
        Ev("cuLaunchKernelEx", "cuda_driver", 61 * MS, 61 * MS + 10, corr=4),
        Ev("one_hot_cumsum", "kernel", 12 * MS, 20 * MS, 1, True),
        Ev("sm90_gemm", "kernel", 25 * MS, 45 * MS, 2, True),
        Ev("void bwd_dq_wgmma<128>(CUtensorMap)", "kernel", 60 * MS, 70 * MS, 3, True),
        Ev("void rmsnorm_bwd_rows<bf16>(float*)", "kernel", 70 * MS, 80 * MS, 4, True),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    cell = cell_mod.resolve(ROOT, "olmoe-train-s4096")
    tr = trace.Trace(prof)
    counts = {"window_s": 0.1, "steps": 2, "batch": 1, "seq_len": 4096,
              "flash_backward_calls": 2}
    got = {m["name"]: r.read(tr, counts, cell.config) for m, r in cell.per_layer}
    assert got["moe.route_dispatch_ms"] == pytest.approx(4.0)  # (28 - 20) ms / 2
    assert got["device.idle_share.train"] == pytest.approx(52.0)
    bound = 2 * 10 * 16 * 128 * (4096 * 4097 // 2) / 989e12
    assert got["flash_bwd_roofline"] == pytest.approx(100 * bound / 0.010)
    step = 6 * (537_919_488 + 2048 * 50304) * 4096 + 3 * 8 * 4 * 16 * 128 * (4096 * 4097 // 2)
    assert got["mfu.train"] == pytest.approx(100 * 2 * step / (0.1 * 989e12))
