"""``chip_smoke.py``'s measurement helpers on the CPU: profiler events are
built by hand as the card's profiler reports them, so the arithmetic that
turns them into device times and bounds is checked without a card."""
import pathlib
import sys

import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import EventList, FunctionEvent

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402


def _events():
    # one host op (aten::mm) that launched one 7 us kernel, the kernel's own
    # event, and a 3 us copy: the card was busy 10 us
    kw = dict(thread=0, use_device="cuda", stack=[])
    op = FunctionEvent(id=1, name="aten::mm", start_us=0, end_us=20, **kw)
    op.append_kernel("sgemm", 0, 7.0)
    kernel = FunctionEvent(id=2, name="sgemm", start_us=2, end_us=9,
                           device_type=DeviceType.CUDA, **kw)
    copy = FunctionEvent(id=3, name="Memcpy HtoD", start_us=10, end_us=13,
                         device_type=DeviceType.CUDA, **kw)
    events = EventList([op, kernel, copy], use_device="cuda")
    events._build_tree()
    return events


@pytest.mark.parametrize("averaged", [False, True])
def test_device_time_counts_each_kernel_once(averaged):
    events = _events()
    if averaged:
        events = events.key_averages()
    assert sum(chip_smoke._self_device_us(e) for e in events) == 10.0
    # the host op's own figure repeats its kernel's time, which is what
    # made a plain sum over all events count the kernel twice
    assert sum(e.self_device_time_total for e in events) == 17.0


def test_bound_takes_the_slower_of_bytes_and_operations():
    ms, by = chip_smoke.bound_ms(3.35e9, 1.0)          # 1 ms of bytes
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound_ms(1.0, 67e9 * 2)        # 2 ms of fp32 ops
    assert by == "operations" and ms == pytest.approx(2.0)


def test_tensor_core_bound_counts_three_tf32_products_per_fp32_one():
    # 165 GFLOP of fp32 products are 495 GFLOP of TF32: 1 ms; 67 GFLOP of
    # softmax on the CUDA cores: 1 ms more
    ms, by = chip_smoke.tc_bound_ms(1.0, 165e9, 67e9)
    assert by == "operations" and ms == pytest.approx(2.0)
    ms, by = chip_smoke.tc_bound_ms(3.35e10, 165e9, 0.0)   # 10 ms of bytes
    assert by == "bytes" and ms == pytest.approx(10.0)
    # zamba2's prefill (73,920 causal pairs x 32 heads at d = 112): 6.6 us
    # with the products on the tensor cores, 16.0 us on the CUDA cores
    pairs = 384 * 385 // 2 * 32
    nbytes = 4 * (2 * 384 * 32 * 112 + 2 * 384 * 32 * 112) + 4
    ms, by = chip_smoke.tc_bound_ms(nbytes, pairs * 4 * 112, pairs * 5)
    assert by == "operations" and ms == pytest.approx(0.006599, abs=1e-6)
    assert chip_smoke.bound_ms(nbytes, pairs * (4 * 112 + 5))[0] == \
        pytest.approx(0.015993, abs=1e-6)


def test_in_turns_alternates_and_keeps_each_turn():
    calls = []

    def timer(fn):
        calls.append(fn())
        return float(len(calls))

    times = chip_smoke.in_turns({"kernel": lambda: "k",
                                 "library": lambda: "l"}, timer)
    assert calls == ["k", "l", "l", "k"]
    assert times == {"kernel": [1.0, 4.0], "library": [2.0, 3.0]}


def test_versus_library_reports_both_device_times(monkeypatch):
    monkeypatch.setattr(chip_smoke, "time_ms",
                        lambda torch, fn, reps=30, warmup=5: fn())
    monkeypatch.setattr(chip_smoke, "profile_device",
                        lambda torch, fn, reps=1: (fn() / 10, None))
    timed, lib, turns = chip_smoke.versus_library(None, lambda: 2.0,
                                                  lambda: 4.0)
    assert timed == (2.0, 0.2) and lib == (4.0, 0.4)
    assert turns == {"kernel": [2.0, 2.0], "library": [4.0, 4.0]}


def test_ssd_ops_counts_the_partial_chunk_by_its_length():
    # the count is the recurrence's, step by step: a sequence one step
    # longer than a chunk costs one more step, not a second full chunk,
    # and one step of one head costs 5pn + p + 2
    one = chip_smoke.ssd_ops(1, 256, 1, 64, 64)
    two = chip_smoke.ssd_ops(1, 257, 1, 64, 64)
    step = chip_smoke.ssd_ops(1, 1, 1, 64, 64)
    assert two == one + step and step == 5 * 64 * 64 + 64 + 2
    assert chip_smoke.ssd_ops(2, 300, 3, 8, 16) == 6 * chip_smoke.ssd_ops(
        1, 300, 1, 8, 16)
    # zamba2's prefill: about 0.88 GFLOP, 13.2 us at 67 TFLOP/s, above the
    # 7.2 us its 24.2 MB take at 3.35 TB/s
    ops = chip_smoke.ssd_ops(1, 384, 112, 64, 64)
    nbytes = 4 * (2 * 384 * 112 * 64 + 384 * 112 + 112 + 2 * 384 * 64
                  + 112 * 64 * 64)
    ms, by = chip_smoke.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(0.0131887, abs=1e-6)


def test_ptxas_summary_names_each_template_instance():
    log = "\n".join([
        "== flash_attention.cu",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3"
        "_18_flash_attention_cu_9f239f9d22flash_attention_kernelILi4EEEvPKf"
        "S2_S2_PKiPfiiiiiiiff' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN51_GLOBAL",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__184f87bf"
        "_11_ssd_scan_cu_d854013215ssd_scan_kernelEPKfS1_' for 'sm_90a'",
        "    56 bytes stack frame, 56 bytes spill stores, 104 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers"])
    assert list(chip_smoke.ptxas_summary(log)) == [
        "flash_attention_kernel<4>: Used 96 registers, used 1 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ssd_scan_kernel: Used 128 registers, used 1 barriers; 56 bytes "
        "stack frame, 56 bytes spill stores, 104 bytes spill loads"]


def test_ptxas_summary_names_bool_template_instances():
    # K3's two instances, onevsall_kernel<true> (the staged readout) and
    # <false>, mangle their argument as Lb1E / Lb0E
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115"
        "onevsall_kernelILb0EEEvPKfS2_PKiPfiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 61 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115"
        "onevsall_kernelILb1EEEvPKfS2_PKiPfiiii' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers"])
    assert [line.split(":")[0] for line in chip_smoke.ptxas_summary(log)] \
        == ["onevsall_kernel<0>", "onevsall_kernel<1>"]
