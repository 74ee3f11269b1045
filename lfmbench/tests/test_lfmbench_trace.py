"""The device timeline on a small synthetic Chrome trace, and on a real
CPU profile."""

import pytest
import torch

from lfmbench import trace


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("lfmbench.window", "user_annotation", 1000.0, 1000.0),
    _x("lfmbench.fit", "user_annotation", 1000.0, 1000.0),
    # launches: K2 on the main thread, the factor inside the MLL's op on thread 2
    _x("cudaLaunchKernel", "cuda_runtime", 1050.0, 5.0, tid=1, corr=7),
    _x("_MvnLogpdfCentered", "cpu_op", 1400.0, 200.0, tid=2),
    _x("cudaLaunchKernel", "cuda_runtime", 1450.0, 5.0, tid=2, corr=8),
    _x("cudaLaunchKernel", "cuda_runtime", 1460.0, 5.0, tid=2, corr=9),
    _x("aten::mm", "cpu_op", 1600.0, 100.0, tid=1),
    _x("void gram_sym_kernel<float, 0>(float const*, int)", "kernel", 1100.0, 100.0, corr=7),
    _x("void gram_sym_bwd_kernel<float, 0>(float const*)", "kernel", 1300.0, 50.0),
    _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 1340.0, 60.0),
    _x("void kernel<getrf_wo_pivot_params_<float> >(int)", "kernel", 1500.0, 100.0, corr=8),
    _x("void (anonymous namespace)::syrk_ltl_tril_kernel<true>(float const*)", "kernel",
       1800.0, 100.0, corr=9),
    # half outside the window: clipped to 50 us
    _x("void elementwise_kernel<128>(int)", "kernel", 1950.0, 100.0),
]


@pytest.fixture
def tl():
    return trace.from_events(EVENTS)


def test_window_and_busy_union(tl):
    assert tl.window_s == pytest.approx(1e-3)
    # 100 (K2) + 100 (bwd 1300-1350 with the copy 1340-1400) + 100 + 100 + 50 clipped
    assert tl.busy_s() == pytest.approx(450e-6)


def test_idle_gaps():
    gaps = trace.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8)
    assert gaps == [(0, 1), (3, 5), (6, 8)]
    assert trace.union_seconds([(1, 2), (1.5, 3), (5, 6)]) == 3


def test_kernel_buckets(tl):
    assert tl.kernel_seconds(r"gram_sym_kernel") == pytest.approx(100e-6)
    assert tl.kernel_seconds(r"gram_sym_bwd_kernel") == pytest.approx(50e-6)
    assert tl.kernel_seconds(r"gram_sym") == pytest.approx(150e-6)
    assert tl.kernel_count() == 5


def test_launched_under_the_mll_op(tl):
    # getrf and K3 were launched inside _MvnLogpdfCentered on thread 2
    assert tl.launched_under(r"_MvnLogpdfCentered") == pytest.approx(200e-6)
    assert tl.launched_under(r"_MvnLogpdfCentered", exclude=r"syrk_ltl") == pytest.approx(100e-6)
    assert tl.launched_under(r"aten::mm") == 0.0


def test_breakdown(tl):
    b = trace.breakdown(tl)
    names = [n for n, _ in b["device_ops"]]
    assert names[0] in ("gram_sym_kernel<float, 0>", "kernel<getrf_wo_pivot_params_<float> >",
                        "syrk_ltl_tril_kernel<true>")
    assert len(b["device_ops"]) == 6
    longest = b["idle_gaps"][0]
    # 1200-1300 us, 1400-1500 us and 1600-1800 us are idle; the last is longest
    assert longest[1] == pytest.approx(200e-6)
    assert longest[0] == "lfmbench.fit / aten::mm"


@pytest.mark.parametrize("name, short", [
    ("void (anonymous namespace)::gram_sym_kernel<float, 0>(float const*, int)",
     "gram_sym_kernel<float, 0>"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(int)",
     "at::native::CatArrayBatchedCopy<int>"),
])
def test_short_name(name, short):
    assert trace.short_name(name) == short


def test_a_real_profile_reads(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW_SPAN):
            torch.ones(64, 64) @ torch.ones(64, 64)
    tl = trace.from_profiler(prof, directory=str(tmp_path))
    assert tl.window_s > 0
    assert any("aten::mm" in name or "aten::matmul" in name for *_, name, _ in tl.host)
    assert not list(tmp_path.iterdir())  # the exported file is gone
