"""``chip_smoke.py``'s measurement helpers on the CPU: profiler events are
built by hand as the card's profiler reports them, so the arithmetic that
turns them into device times and bounds is checked without a card."""
import pathlib
import sys

import pytest
import torch
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
                        lambda torch, fn, reps=1, once=False:
                        (fn() / 10, None))
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


@pytest.mark.parametrize("mangled,want", [
    ("_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_0ee807be4tc1627flash_"
     "attention_bf16_kernelILi8EEEvPK13__nv_bfloat16S4_S4_PKiPS2_iiiiiiiff",
     "flash_attention_bf16_kernel<8>"),
    ("_ZN44_GLOBAL__N__184f87bf_11_ssd_scan_cu_d85401322tc17ssd_output_kernel"
     "I13__nv_bfloat16Li8ELi8EEEvPKT_PKfS7_S5_S5_S7_PS3_iiiiiii",
     "ssd_output_kernel<bf16, 8, 8>"),
    ("_ZN44_GLOBAL__N__184f87bf_11_ssd_scan_cu_d85401322tc16ssd_state_kernel"
     "IfLi0ELi0EEEvPKT_PKfS6_S4_PfS7_iiiiiii", "ssd_state_kernel<float, 0, 0>"),
    ("_ZN12_GLOBAL__N_121decode_combine_kernelIfEEvPKfPKT_PS3_iiiiii",
     "decode_combine_kernel<float>"),
    ("_ZN12_GLOBAL__N_121ssd_state_pass_kernelEPKfPfS1_S2_iiiiii",
     "ssd_state_pass_kernel")])
def test_kernel_instance_names_type_and_value_arguments(mangled, want):
    # the bf16 instances: a type argument (float or __nv_bfloat16) before
    # the integers, and a digit inside the kernel's own name
    assert chip_smoke.kernel_instance(mangled) == want


def test_decode_bytes_count_each_valid_k_and_v_row_once():
    # zamba2's decode: 4 slots x 32 heads x d = 112; K and V of all 512
    # slots are 58.7 MB, the path's lengths read 45.1 MB: 13.5 us
    full = 4 * 2 * 4 * 512 * 32 * 112
    assert full == 58_720_256
    nbytes = chip_smoke.decode_nbytes(4, 32, 32, 112, [385, 390, 395, 399],
                                      512, None)
    rows = 385 + 390 + 395 + 399
    assert nbytes == 4 * (2 * 4 * 32 * 112 + 2 * rows * 32 * 112) + 16
    assert nbytes == 45_101_072
    ms, by = chip_smoke.bound_ms(nbytes, 0.0)
    assert by == "bytes" and ms == pytest.approx(0.013463, abs=1e-6)
    # a window reads only its last slots; an empty row and a length past
    # the cache read none and S
    assert chip_smoke.decode_nbytes(1, 2, 1, 8, [100], 512, 64) == \
        4 * (2 * 2 * 8 + 2 * 64 * 8) + 4
    assert chip_smoke.decode_nbytes(2, 2, 1, 8, [0, 600], 512, None) == \
        4 * (2 * 2 * 2 * 8 + 2 * 512 * 8) + 8


def test_ssd_tensor_core_ops_count_the_chunked_products():
    # zamba2's prefill: chunks of 256 and 128 steps; the causal triangles
    # hold 256 * 257 / 2 + 128 * 129 / 2 pairs; per head C B^T and W U
    # take 2n + 2p flops a pair, the chunk states and the incoming term
    # 2pn a step each: 1.885 GFLOP over 112 heads
    pairs = 256 * 257 // 2 + 128 * 129 // 2
    assert pairs == 41_152
    mma, other, bf16, x2 = chip_smoke.ssd_tc_ops(1, 384, 112, 64, 64, 256)
    assert mma == 112 * (2 * (64 + 64) * pairs + 4 * 384 * 64 * 64)
    assert mma == 1_884_553_216
    assert bf16 == x2 == 0                    # float32: all in 3xTF32
    # bf16 operands: C B^T a bf16 product, each other product one bf16
    # operand beside a float32 one
    _, _, cbt, x2 = chip_smoke.ssd_tc_ops(1, 384, 112, 64, 64, 256,
                                           bf16=True)
    assert cbt == 112 * 2 * 64 * pairs
    assert x2 == mma - cbt
    assert other == 112 * (3 * pairs + 384 * (4 * 64 + 5) + 2 * 64 * 64 * 2)
    # three TF32 products per fp32 one at 495 TFLOP/s, the rest at 67:
    # 11.82 us, above the 7.2 us of its 24.2 MB
    nbytes = 4 * (2 * 384 * 112 * 64 + 384 * 112 + 112 + 2 * 384 * 64
                  + 112 * 64 * 64)
    ms, by = chip_smoke.tc_bound_ms(nbytes, mma, other)
    assert by == "operations"
    assert ms == pytest.approx(3 * mma / 495e9 + other / 67e9, rel=1e-12)
    assert ms == pytest.approx(0.011823, abs=1e-6)
    # bf16 operands: C B^T at bf16's 989.4 TFLOP/s, the rest as two TF32
    # products each (the bf16 operand is exact in tf32): 6.23 us, above
    # the 3.9 us of its 13.1 MB
    nbytes16 = chip_smoke.ssd_nbytes(1, 384, 112, 64, 64, False, size=2)
    assert nbytes16 == nbytes - 2 * (2 * 384 * 112 * 64 + 2 * 384 * 64)
    ms16, by16 = chip_smoke.tc_bound_ms(nbytes16, mma, other, cbt, x2)
    assert by16 == "operations"
    assert ms16 == pytest.approx(2 * (mma - cbt) / 495e9 + cbt / 989.4e9
                                 + other / 67e9, rel=1e-12)
    assert ms16 == pytest.approx(0.006228, abs=1e-6)
    # C B^T alone at bf16's rate, the rest in 3xTF32, would read 8.84 us
    assert ms16 < chip_smoke.tc_bound_ms(nbytes16, mma, other, cbt)[0] < ms
    # one chunk holding the whole sequence: a single triangle
    assert chip_smoke.ssd_tc_ops(2, 10, 3, 8, 16, 64)[0] == \
        2 * 3 * (2 * 24 * 55 + 4 * 10 * 8 * 16)


def test_device_kernels_lists_each_kernel_per_call():
    events = _events().key_averages()
    names, kinds = chip_smoke.device_kernels(events, reps=1)
    assert names == [("sgemm", 1.0), ("Memcpy HtoD", 1.0)]
    assert kinds == 2


def _window(counts_us):
    """Key averages of a profile whose kernels (name -> (events kept, us
    each)) ran as listed."""
    kw = dict(thread=0, use_device="cuda", stack=[])
    events, i = [], 0
    for name, (n, us) in counts_us.items():
        for _ in range(n):
            events.append(FunctionEvent(id=i, name=name, start_us=10 * i,
                                        end_us=10 * i + us,
                                        device_type=DeviceType.CUDA, **kw))
            i += 1
    events = EventList(events, use_device="cuda")
    events._build_tree()
    return events.key_averages()


@pytest.mark.parametrize("kept,want", [
    # ten calls of two kernels (2 us and 3 us), every event kept: 5 us
    ({"a": (10, 2), "b": (10, 3)}, 5.0),
    # a kernel launched twice a call: its 20 events are 2 a call
    ({"a": (20, 2), "b": (10, 3)}, 7.0),
    # the profiler kept 9 of the first kernel's 10 events: the window lost
    # events, so the time is not measured (it was 4.8 as a plain sum over
    # 10 calls, 5.0 with the kept events' mean)
    ({"a": (9, 2), "b": (10, 3)}, None),
    # 19 of a twice-a-call kernel's 20
    ({"a": (19, 2), "b": (10, 3)}, None)])
def test_device_time_per_call_survives_dropped_events(kept, want):
    got = chip_smoke.device_us_per_call(_window(kept), 10)
    assert got == (None if want is None else pytest.approx(want))
    # the host op's own figure is not counted, as in the plain sum
    assert chip_smoke.device_us_per_call(_events().key_averages(), 1) == \
        10.0


def test_device_time_per_call_is_null_for_one_event_of_five():
    # K6 at 6 x 32k on an H100: 5 calls of a 406 ms kernel of
    # which the profiler kept one event; scaling by 1 / 5 printed 81 ms
    avgs = _window({"flash_attention_bf16_kernel": (1, 406000)})
    assert chip_smoke.device_us_per_call(avgs, 5) is None
    assert chip_smoke.device_us_per_call(avgs, 5, once=True) is None
    assert chip_smoke.device_us_per_call(
        _window({"flash_attention_bf16_kernel": (5, 406000)}), 5,
        once=True) == pytest.approx(406000)


def test_parent_llm_rows_are_relayed(monkeypatch, capsys):
    # --parent runs the parent's K7 and K8 phases in a subprocess and
    # relays their rows (float32 and bf16), nothing else
    seen = {}

    class Run:
        returncode, stderr = 0, ""
        stdout = "\n".join([
            "K7 decode_attention b=4 S=512: kernel 0.07 ms per call (0.0230 "
            "ms on the device) [c]",
            "K8 bf16 ssd_scan path b=1 s=384: kernel 0.14 ms per call "
            "(0.0807 ms on the device) [c]",
            "  decode_split_kernel<float, 1>: Used 64 registers"])

    def run(cmd, **kw):
        seen["code"] = cmd[-1]
        return Run()

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    chip_smoke.relay_parent_llm("build/parent", "before")
    assert "cs.phase_decode_attention(torch, np, card)" in seen["code"]
    assert "cs.phase_ssd_scan(torch, np, card)" in seen["code"]
    out = capsys.readouterr().out.splitlines()
    assert out == ["  parent (before this tree's): " + line
                   for line in Run.stdout.splitlines()[:2]]


def test_parent_k6_rows_are_relayed_and_only_runs_those_named(monkeypatch,
                                                              capsys):
    # --parent relays the parent's K6 rows too; with --only k6 k7 the
    # parent runs just those two phases
    seen = {}

    class Run:
        returncode, stderr = 0, ""
        stdout = "\n".join([
            "K6 flash_attention gemma2 cache prefill, global layer: kernel "
            "0.3368 ms per call (0.3120 ms on the device) [c]",
            "K7 decode_attention b=4 S=512: kernel 0.08 ms per call [c]",
            "built x"])

    def run(cmd, **kw):
        seen["code"] = cmd[-1]
        return Run()

    monkeypatch.setattr(chip_smoke.subprocess, "run", run)
    chip_smoke.relay_parent_llm("build/parent", "after", ["k6", "k7"])
    assert "cs.phase_flash_attention(torch, np, card)" in seen["code"]
    assert "cs.phase_decode_attention(torch, np, card)" in seen["code"]
    assert "phase_ssd_scan" not in seen["code"]
    out = capsys.readouterr().out.splitlines()
    assert out == ["  parent (after this tree's): " + line
                   for line in Run.stdout.splitlines()[:2]]
    chip_smoke.relay_parent_llm("build/parent", "before")
    assert all(f"cs.{p}(torch, np, card)" in seen["code"]
               for p in chip_smoke.PARENT_LLM.values())


def test_k7_instance_names_the_float32_bulk_kernel():
    # float32 past d = 128 runs decode_bulk_kernel<G> (G: a group of 1 or
    # 2 whole, else 4 q-heads a warp); d = 112 and d % 4 != 0 keep the
    # split kernel
    from repro_torch.kernels import decode_attention as da
    from repro_torch.testing import decode_case
    for (n_q, n_kv, d), want in {
            (16, 8, 256): "decode_bulk_kernel<2>",
            (8, 8, 192): "decode_bulk_kernel<1>",
            (16, 2, 256): "decode_bulk_kernel<4>",
            (32, 32, 112): "decode_split_kernel<float, 1>",
            (4, 2, 130): "decode_split_kernel<float, 2>"}.items():
        q, kc, vc = (torch.as_tensor(a) for a in
                     decode_case(1, 8, n_q, n_kv, d))
        assert chip_smoke.k7_instance(da, q, kc, vc) == want


def test_parent_device_ms_reads_the_parent_k2_and_k5_lines(monkeypatch):
    # the parent's phases print one line per shape (and, since the K2/K5
    # redesign, an in-turns line after it, whose library device time must
    # not be read as the kernel's)
    lines = [
        "K2 crop_gather B=128 (100 valid) F=32: bit-equal: kernel 0.0285 ms "
        "per call (0.0067 ms on the device), plain 1.6810 ms (0.1837 ms on "
        "the device), grid_sample 0.0223 ms, bound 0.001287 ms (bytes) [c]",
        "K2 crop_gather B=128 (100 valid) F=32 in turns (kernel, "
        "grid_sample, grid_sample, kernel): kernel 0.0300, 0.0290 ms per "
        "call; grid_sample 0.0220, 0.0230 ms per call (0.0051 ms on the "
        "device) [c]",
        "K5 onevsall_update B=2048 D1=129 C=8: max abs err 2.594e-04 "
        "(8.63e-07 of the output scale), bit-identical run to run, 1024 B "
        "dyn. smem: kernel 0.7942 ms per call (0.7482 ms on the device), "
        "plain 0.1250 ms (0.0168 ms on the device) [c]",
        "K7 decode_attention b=4: kernel 0.1 ms per call (0.09 ms on the "
        "device) [c]",
        # K1 and K4b, keyed by their whole shape; the sparse lines of a
        # tree that has them are not the rows' times
        "K1 region_filter_mask_batch F=32 N=256 M=256: masks equal: kernel "
        "0.0731 ms per call (0.0502 ms on the device), plain 0.7269 ms "
        "(0.1228 ms on the device), bound 0.000352 ms (operations) [c]",
        "K1 region_filter_mask_batch sparse F=32 N=256 M=256 (4 valid "
        "accepted a frame): masks equal: kernel 0.0300 ms per call (0.0030 "
        "ms on the device), plain 0.7 ms (0.1 ms on the device) [c]",
        "K4b region_filter_mask N=256 M=256: masks equal: kernel 0.0766 ms "
        "per call (0.0454 ms on the device), plain 0.5840 ms (0.0569 ms on "
        "the device), bound 0.000011 ms (operations) [c]",
        "K4b region_filter_mask N=130 M=70: masks equal: kernel 0.0700 ms "
        "per call (0.0300 ms on the device), plain 0.5 ms (0.05 ms on the "
        "device) [c]",
        # K4a, keyed by its whole shape; its ptxas line is not a time
        "K4a iou_matrix B=32 N=256 M=256: bit-equal: kernel 0.0742 ms per "
        "call (0.0081 ms on the device), plain 0.4551 ms (0.0893 ms on the "
        "device), bound 0.002582 ms (bytes) [c]",
        "K4a ptxas: iou_matrix_kernel: Used 30 registers [c]"]

    class Run:
        returncode, stdout, stderr = 0, "\n".join(lines), ""

    monkeypatch.setattr(chip_smoke.subprocess, "run",
                        lambda *a, **kw: Run())
    assert chip_smoke.parent_device_ms("build/parent", "c") == {
        ("K2", "B=128"): 0.0067, ("K5", "B=2048"): 0.7482,
        ("K1", "F=32 N=256 M=256"): 0.0502, ("K4b", "N=256 M=256"): 0.0454,
        ("K4b", "N=130 M=70"): 0.0300, ("K4a", "B=32 N=256 M=256"): 0.0081}
    # the rows of this tree look their parent times up by the same keys
    assert chip_smoke.parent_key("K5", "B=2048 D1=129 C=8") == \
        ("K5", "B=2048")
    assert chip_smoke.parent_key("K1", "F=32 N=256 M=256") == \
        ("K1", "F=32 N=256 M=256")
    assert chip_smoke.parent_key("K4a", "B=1 N=13 M=7") == \
        ("K4a", "B=1 N=13 M=7")


@pytest.mark.parametrize("kept,want", [
    # a call of two kernels (3 us and 1 us), each launched once, profiled
    # 30 times with every event kept: 4 us
    ({"step": (30, 3), "combine": (30, 1)}, 4.0),
    # the profiler kept 6 of the first kernel's 30 events: not measured
    # (rounding 6 / 30 per call gave 1.6 us, the kept events' mean 4.0)
    ({"step": (6, 3), "combine": (30, 1)}, None),
    # 1 of 5: not measured either
    ({"step": (1, 3), "combine": (30, 1)}, None)])
def test_device_time_once_sums_each_kernels_mean(kept, want):
    got = chip_smoke.device_us_per_call(_window(kept), 30, once=True)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("device,lib,tc,flagged", [
    (0.5, 0.4, None, ()),                      # both above the bound
    (0.05, 0.4, None, ("device_ms",)),          # the kernel below it
    (0.5, 0.08, None, ("library_device_ms",)),  # the library below it
    # the tensor-core bound is the least bound where the row has one
    (0.06, 0.4, 0.05, ()),
    (0.04, 0.4, 0.05, ("device_ms",))])
def test_device_time_below_its_bound_is_flagged(device, lib, tc, flagged):
    row = dict(bound_ms=0.1, device_ms=device, plain_device_ms=0.9,
               library_device_ms=lib)
    if tc is not None:
        row["bound_tc_ms"] = tc
    note = chip_smoke.flag_below_bound(row)
    for key, ms in (("device_ms", device), ("library_device_ms", lib)):
        if key in flagged:
            assert row[key] is None and row[key + "_below_bound"] == ms
            assert f"{key} read {ms:.6f} ms, below the bound" in note
        else:
            assert row[key] == ms and key + "_below_bound" not in row
    assert row["plain_device_ms"] == 0.9
    assert (note == "") == (not flagged)


def test_profile_device_retries_a_window_that_lost_events(monkeypatch):
    # the first two windows lost events, the third is whole
    windows = iter([{"k": (4, 2)}, {"k": (3, 2)}, {"k": (5, 2)}])

    class Prof:
        def __enter__(self):
            self.avgs = _window(next(windows))
            return self

        def __exit__(self, *a):
            return False

        def key_averages(self):
            return self.avgs

    import torch.profiler
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: Prof())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ms, _ = chip_smoke.profile_device(torch, lambda: None, reps=5)
    assert ms == pytest.approx(0.002)
    windows = iter([{"k": (4, 2)}] * chip_smoke.PROFILE_ATTEMPTS)
    assert chip_smoke.profile_device(torch, lambda: None, reps=5)[0] is None


def test_nms_bound_counts_the_candidate_rows():
    # the flush's shape with every box a candidate: F N N floats read
    # (8.4 MB, 2.5 us at 3.35 TB/s) and 6 bytes a box
    nbytes, ops = chip_smoke.nms_bound(256, [256] * 32)
    assert nbytes == 4 * 32 * 256 * 256 + 6 * 32 * 256
    assert ops == 32 * 256 * 256 + 32 * 256 * 256
    ms, by = chip_smoke.bound_ms(nbytes, ops)
    assert by == "bytes" and ms == pytest.approx(0.0025178, abs=1e-6)
    # only the candidates' rows are read: a frame of 3 and an empty one
    assert chip_smoke.nms_bound(10, [3, 0]) == (4 * 10 * 3 + 6 * 10 * 2,
                                                10 * 3 + 9)


def test_nms_candidates_follow_the_greedy_loop():
    # valid with a score > -1e30; a frame with a valid NaN score reads no
    # row (the loop's first step ends it); an invalid NaN is not counted
    nan, big = float("nan"), -1e30
    scores = torch.tensor([[0.5, big, -float("inf"), 0.1],
                           [0.5, nan, 0.2, 0.3],
                           [nan, 0.4, -0.0, 0.3]])
    valid = torch.tensor([[True, True, True, True],
                          [True, True, True, False],
                          [False, True, True, False]])
    assert chip_smoke.nms_candidates(torch, scores, valid) == [2, 0, 2]


def test_kernel_row_holds_the_contract_keys_and_its_bound():
    # the measured numbers and the bound, nothing estimated besides it
    row = chip_smoke._row("nms_greedy", "src/x.cu", "ref.py:1", "F=32", 0.0,
                          (0.05, 0.011), (48.0, 6.2), None,
                          *chip_smoke.nms_bound(256, [256] * 32))
    assert set(row) == {"name", "route", "source", "replaces", "shape",
                        "max_abs_err", "ms", "device_ms", "plain_ms",
                        "plain_device_ms", "bound_ms", "bound_by",
                        "library_ms"}
    assert row["route"] == "cuda" and row["library_ms"] is None
    assert (row["ms"], row["device_ms"]) == (0.05, 0.011)
    assert row["bound_by"] == "bytes"
    assert row["bound_ms"] == pytest.approx(0.0025178, abs=1e-6)


def test_check_nms_launches_pairs_k4a_with_the_nms_kernel():
    chip_smoke.check_nms_launches({"iou_matrix": 14, "nms_greedy": 14}, "x")
    with pytest.raises(AssertionError, match="14 K4a launches but 0 NMS"):
        chip_smoke.check_nms_launches({"iou_matrix": 14, "nms_greedy": 0},
                                      "x")


def test_step_split_divides_each_part_by_the_steps():
    s = chip_smoke.step_split(2.0, [0.009] * 100, [1.0] * 100)
    assert s["steps"] == 100
    assert s["wall_ms"] == pytest.approx(20.0)
    assert s["host_ms"] == pytest.approx(9.0)
    assert s["device_ms"] == pytest.approx(1.0)
    assert s["other_ms"] == pytest.approx(10.0)
    assert s["host_share"] == pytest.approx(0.45)
    with pytest.raises(AssertionError):
        chip_smoke.step_split(1.0, [0.1] * 3, [1.0] * 4)


def test_step_split_timer_sees_every_batch_and_step_and_restores():
    import types
    import time

    from repro_torch.configs.vpaas_video import ClassifierConfig
    from repro_torch.training import data, train_loop

    class Event:                      # the host clock in place of CUDA's
        def __init__(self, **kw):
            self.t = None

        def record(self):
            self.t = time.perf_counter()

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e3

    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        Event=Event, synchronize=lambda: None))
    saved = (data.classifier_batches, train_loop.classifier_step)
    cfg = ClassifierConfig(name="t", crop_hw=(8, 8), widths=(4,),
                           feature_dim=4)
    with chip_smoke.StepSplit(fake) as split:
        assert train_loop.classifier_step is not saved[1]
        train_loop.train_classifier(cfg, steps=3, batch_size=2,
                                    device="cpu")
    assert (data.classifier_batches, train_loop.classifier_step) == saved
    assert len(split.host_s) == 3 and all(t > 0 for t in split.host_s)
    ms = split.device_ms()
    assert len(ms) == 3 and all(t > 0 for t in ms)
    assert chip_smoke.step_split(1.0, split.host_s, ms)["steps"] == 3


def test_detector_tie_frames_flags_scores_at_a_threshold(monkeypatch):
    import numpy as np

    from repro_torch import weights
    from repro_torch.configs.vpaas_video import DETECTOR
    from repro_torch.models import detector
    from repro_torch.video import synthetic
    params = weights.init_detector(DETECTOR, torch.Generator().manual_seed(0),
                                   "cpu")
    chunk = synthetic.make_chunk(np.random.default_rng(0), "traffic",
                                 num_frames=3)
    ties = chip_smoke.detector_tie_frames(torch, np, params, chunk, "cpu")
    assert ties.shape == (3,) and ties.dtype == bool
    real = detector.detect

    def at_threshold(cfg, p, frames):     # frame 1 scores one cell at 0.5
        out = dict(real(cfg, p, frames))
        loc = out["loc_scores"].clone()
        loc[1, 7] = 0.5
        out["loc_scores"] = loc
        return out

    monkeypatch.setattr(detector, "detect", at_threshold)
    ties2 = chip_smoke.detector_tie_frames(torch, np, params, chunk, "cpu")
    assert ties2[1] and (ties2 == (ties | np.eye(3, dtype=bool)[1])).all()


def test_profile_device_retries_a_profile_without_device_time(monkeypatch):
    import contextlib
    import types

    import torch.profiler

    class Prof:
        def key_averages(self):
            return ["avgs"]

    profiles = []

    @contextlib.contextmanager
    def profile(activities):
        profiles.append(activities)
        yield Prof()

    monkeypatch.setattr(torch.profiler, "profile", profile)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None))
    found = iter([0.0, 7000.0])
    monkeypatch.setattr(chip_smoke, "device_us_per_call",
                        lambda avgs, reps, once=False: next(found))
    calls = []
    ms, avgs = chip_smoke.profile_device(fake, lambda: calls.append(1),
                                         reps=3)
    assert ms == pytest.approx(7.0) and avgs == ["avgs"]
    assert len(profiles) == 2 and len(calls) == 1 + 2 * 3
    # empty profiles: reported as not measured, after PROFILE_ATTEMPTS
    # windows (a window that lost events is retried the same way)
    profiles.clear()
    monkeypatch.setattr(chip_smoke, "device_us_per_call",
                        lambda avgs, reps, once=False: 0.0)
    assert chip_smoke.profile_device(fake, lambda: None)[0] is None
    assert len(profiles) == chip_smoke.PROFILE_ATTEMPTS == 3


def _report(**kw):
    rep = {"frames": 64, "sched_finalizes": 16, "sched_events": 90,
           "wall_s": 0.5, "frames_per_s": 128.0, "hot_inflight_peak": 3,
           "detect_occupancy": 0.5, "steals": 0, "shards": 1}
    rep.update(kw)
    return rep


def test_check_reports_passes_host_clock_and_partition_keys():
    a = _report()
    b = _report(wall_s=0.9, frames_per_s=71.1, sched_events=120,
                hot_inflight_peak=5, detect_occupancy=0.3, steals=2,
                shards=4)
    chip_smoke.check_reports(a, b, "x", peaks=False)
    with pytest.raises(AssertionError, match="hot_inflight_peak"):
        chip_smoke.check_reports(a, b, "x", peaks=True)
    with pytest.raises(AssertionError, match="sched_finalizes 16 vs 15"):
        chip_smoke.check_reports(a, _report(sched_finalizes=15), "x",
                                 peaks=False)
    with pytest.raises(AssertionError, match="calls"):
        chip_smoke.check_reports(a, _report(calls=3), "x", peaks=False)


def _sched(results, live=None):
    import types
    store = None if live is None else types.SimpleNamespace(
        live_refs=lambda: live)
    streams = {name: types.SimpleNamespace(
        results=[(c, None, "cloud") for c in chunks])
        for name, chunks in results.items()}
    return types.SimpleNamespace(streams=streams, store=store)


def test_check_conservation_wants_each_chunk_once_in_order():
    a, b, c = object(), object(), object()
    submitted = {"cam0": [a, b], "cam1": [c]}
    chip_smoke.check_conservation(_sched({"cam0": [a, b], "cam1": [c]}, {}),
                                  submitted, "x")
    for bad in ({"cam0": [b, a], "cam1": [c]},          # reordered
                {"cam0": [a, b, b], "cam1": [c]},       # finalized twice
                {"cam0": [a], "cam1": [c]},             # lost
                {"cam0": [a, b], "cam1": [a]}):         # another's chunk
        with pytest.raises(AssertionError, match="lost, repeated"):
            chip_smoke.check_conservation(_sched(bad), submitted, "x")
    with pytest.raises(AssertionError, match="live store references"):
        chip_smoke.check_conservation(
            _sched({"cam0": [a, b], "cam1": [c]}, {"k": 1}), submitted, "x")


def test_check_same_results_compares_every_array_and_latency():
    import types

    import numpy as np

    def res(score, total=1.0):
        return types.SimpleNamespace(
            boxes=np.zeros((1, 2, 4)), labels=np.zeros((1, 2), int),
            valid=np.ones((1, 2), bool), fog_features=np.zeros((1, 2, 3)),
            fog_scores=np.full((1, 2, 2), score), wan_bytes=10.0,
            coord_bytes=2.0, latency=types.SimpleNamespace(total=total))

    chunk = object()

    def sched(r):
        return types.SimpleNamespace(streams={"cam0": types.SimpleNamespace(
            results=[(chunk, r, "cloud")])})

    chip_smoke.check_same_results(sched(res(0.25)), sched(res(0.25)), "x")
    with pytest.raises(AssertionError, match="fog_scores differs"):
        chip_smoke.check_same_results(sched(res(0.25)),
                                      sched(res(np.nextafter(0.25, 1))), "x")
    with pytest.raises(AssertionError, match="latency differs"):
        chip_smoke.check_same_results(sched(res(0.25)),
                                      sched(res(0.25, 1.5)), "x")


def test_compare_tenant_outputs_holds_answers_and_products():
    import types

    import numpy as np
    chunk = object()

    def states(answers, products, scores):
        pipe = types.SimpleNamespace()
        casc = {"answers": np.asarray(answers, np.int32), "escalated": 1,
                "frames": 2}
        shop = {"products": np.asarray(products, np.int32),
                "scores": np.asarray(scores, np.float32), "frames": 2}
        return [types.SimpleNamespace(
            name=name, tenant=types.SimpleNamespace(pipeline=p),
            results=[(chunk, types.SimpleNamespace(outputs=o), "cloud")])
            for name, p, o in (("cam0", None, None), ("cam1", pipe, casc),
                               ("cam2", pipe, shop))]

    want = states([3, 4], [7, 9], [0.5, 0.25])
    assert chip_smoke.compare_tenant_outputs(
        np, want, states([3, 4], [7, 9], [0.500004, 0.25])) == 2
    with pytest.raises(AssertionError, match="cascade answers differ"):
        chip_smoke.compare_tenant_outputs(
            np, want, states([3, 5], [7, 9], [0.5, 0.25]))
    with pytest.raises(AssertionError, match="product ids differ"):
        chip_smoke.compare_tenant_outputs(
            np, want, states([3, 4], [7, 8], [0.5, 0.25]))
    with pytest.raises(AssertionError):
        chip_smoke.compare_tenant_outputs(
            np, want, states([3, 4], [7, 9], [0.5, 0.2501]))


def test_cascade_launches_follow_the_cut():
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-7b")
    cut = chip_smoke.block_cut(cfg, 1)
    assert (cut.num_layers, cut.num_blocks) == (9, 1)
    assert (cut.vocab_size, cut.d_model) == (cfg.vocab_size, cfg.d_model)
    n_pre = len(cfg.prefix_layers)
    per_block = sum(k == "ssm" for k in cfg.block_pattern)
    assert chip_smoke.llm_kernel_calls(cfg) == (10, n_pre + 10 * per_block)
    assert chip_smoke.llm_kernel_calls(cut) == (1, n_pre + per_block)
    assert n_pre + len(cfg.block_pattern) == 9


def test_llm_path_launches_follow_each_config():
    # zamba2: a shared-attention K6 per block at prefill and a K7 per block
    # at decode, a K8 per Mamba2 layer; deepseek-v2-lite: a K6 per layer at
    # prefill (MLA's), none at decode (the absorbed einsum); musicgen: a
    # self- and a cross-attention K6 per layer at prefill, a cross K6 and a
    # self K7 per layer at decode
    from repro_torch.configs import get_config
    assert chip_smoke.path_launches(get_config("zamba2-7b"), 8, 30) == {
        "flash_attention": 80, "decode_attention": 300, "ssd_scan": 568}
    assert chip_smoke.path_launches(get_config("deepseek-v2-lite-16b"), 8,
                                    30) == {"flash_attention": 27 * 8,
                                            "decode_attention": 0,
                                            "ssd_scan": 0}
    assert chip_smoke.path_launches(get_config("musicgen-medium"), 1,
                                    16) == {"flash_attention": 96 + 16 * 48,
                                            "decode_attention": 16 * 48,
                                            "ssd_scan": 0}
    # mamba2-2.7b: a K8 per Mamba2 layer at prefill, no K6 or K7 anywhere,
    # and its decode step (the plain recurrent ssd_step) launches nothing
    mamba2 = get_config("mamba2-2.7b")
    assert chip_smoke.path_launches(mamba2, 1, 0) == {
        "flash_attention": 0, "decode_attention": 0, "ssd_scan": 64}
    assert chip_smoke.path_launches(mamba2, 0, 1) == {
        "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}
    assert chip_smoke.path_launches(mamba2, 8, 30)["ssd_scan"] == 8 * 64
    with pytest.raises(AssertionError, match="decode_attention 1 times"):
        chip_smoke.check_launches({"decode_attention": 1},
                                  {"decode_attention": 0}, "x")


def test_block_cuts_keep_the_widths():
    from repro_torch.configs import get_config
    from repro_torch.models import schema as sch
    from repro_torch.models import transformer as tfm
    ds = get_config("deepseek-v2-lite-16b")
    cut = chip_smoke.block_cut(ds, 2)
    assert (cut.num_layers, cut.num_blocks) == (3, 2)
    assert cut.prefix_layers == ds.prefix_layers == ("attn",)
    assert (cut.d_model, cut.num_experts, cut.vocab_size) == \
        (ds.d_model, ds.num_experts, ds.vocab_size)
    # ~1.6 B parameters, 6.4 GB in float32, against the full model's
    # 15.6 B (62.6 GB: it fits one 80 GB card)
    assert sch.param_bytes(tfm.model_schema(cut)) == 4 * 1_611_544_576
    assert sch.param_bytes(tfm.model_schema(ds)) == 4 * 15_647_881_216
    mg = get_config("musicgen-medium")
    assert chip_smoke.block_cut(mg, 4).num_layers == 4
    assert sch.param_bytes(tfm.model_schema(mg)) == 4 * 2_272_617_984
    assert chip_smoke.block_cut(get_config("zamba2-7b"), 1).name == \
        "zamba2-7b-9-layers"


def test_flash_bound_at_the_new_path_shapes():
    # MLA's prefill: 73,920 causal pairs x 16 heads x (2 (192 + 128) + 5)
    # flops, 11.4 us at 67 TFLOP/s, above the 4.7 us its 15.7 MB take
    nbytes, ops, pairs = chip_smoke.flash_bound(1, 384, 512, 16, 16, 192,
                                                128, True, None, None)
    assert pairs == 384 * 385 // 2 == 73_920
    assert ops == pairs * 16 * (2 * 192 + 2 * 128 + 5)
    assert nbytes == 4 * (384 * 16 * 320 + 384 * 16 * 320) + 4
    ms, by = chip_smoke.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(0.0113859, abs=1e-6)
    # musicgen's cross-attention decode step reads all 256 context keys of
    # its 4 rows: bytes bound it
    nbytes, ops, pairs = chip_smoke.flash_bound(4, 1, 256, 24, 24, 64, 64,
                                                False, None, None)
    assert pairs == 4 * 256
    assert nbytes == 4 * (4 * 24 * 128 + 4 * 256 * 24 * 128) + 16
    assert chip_smoke.bound_ms(nbytes, ops)[1] == "bytes"
    # musicgen's self-attention prefill: 4 rows' causal triangles, 24 heads
    nbytes, ops, pairs = chip_smoke.flash_bound(4, 384, 512, 24, 24, 64, 64,
                                                True, None, None)
    assert pairs == 4 * 73_920 and ops == pairs * 24 * (4 * 64 + 5)
    # the zamba2 prefill's bound is what it was
    assert chip_smoke.bound_ms(*chip_smoke.flash_bound(
        1, 384, 512, 32, 32, 112, 112, True, None, None)[:2])[0] == \
        pytest.approx(0.015993, abs=1e-6)


def test_flash_tensor_core_bound_counts_d_plus_d_v_products():
    # MLA's prefill on the tensor cores: 2 (192 + 128) products a pair in
    # 3xTF32 (4.59 us) and 5 softmax operations (0.09 us) are below the
    # 4.69 us of its 15.7 MB: bytes bound it (4 d = 768 products a pair
    # charged 1.2x the work)
    nbytes, ops, pairs = chip_smoke.flash_bound(1, 384, 512, 16, 16, 192,
                                                128, True, None, None)
    ms, by = chip_smoke.flash_tc_bound(nbytes, pairs * 16, 192, 128, None)
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)
    mma = pairs * 16 * 640
    assert chip_smoke.flash_tc_bound(1, pairs * 16, 192, 128, None)[0] == \
        pytest.approx(3 * mma / 495e9 + pairs * 16 * 5 / 67e9, rel=1e-12)
    # d = d_v: 4 d, as before; a softcap's 3 operations go to the CUDA cores
    assert chip_smoke.flash_tc_bound(1, 10, 112, 112, 30.0)[0] == \
        pytest.approx(3 * 10 * 448 / 495e9 + 10 * 8 / 67e9, rel=1e-12)


def _k6_routes(monkeypatch):
    """The K6 wrapper with the library's route queries stubbed as the
    card's library answers them: in bf16 the d <= 64 kernels (the
    persistent one, the one-row one at s_q = 1), else the wgmma kernel by
    its block's warpgroups."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    def on_tc(d, d_v):
        return (d <= 192 and d_v <= 128) or (d == d_v and d <= 256)

    def query(fn, *args):
        if fn == "vpaas_flash_attention_on_tensor_cores":
            return int(on_tc(*args[:2]))
        assert fn == "vpaas_flash_attention_bf16_kernel"
        b, s_q, n_q, d, d_v = args
        if not on_tc(d, d_v):
            return 0
        if d <= 64:
            return 4 if s_q == 1 else 3
        return 1 if b * n_q * -(-s_q // 128) < 132 else 2
    monkeypatch.setattr(_build, "query", query)
    return fa


def test_k6_instance_follows_the_launcher_routes(monkeypatch):
    # the ptxas names the K6 rows carry, from the routes the library
    # answers
    fa = _k6_routes(monkeypatch)
    bf, f32 = torch.bfloat16, torch.float32
    assert chip_smoke._k6_instance(fa, 6, 32768, 24, 64, 64, bf) == \
        "flash_attention_ws_kernel<4>"
    assert chip_smoke._k6_instance(fa, 7, 1, 24, 64, 64, bf) == \
        "flash_attention_row_kernel<4>"
    assert chip_smoke._k6_instance(fa, 6, 32768, 32, 112, 112, bf) == \
        "flash_attention_wgmma_kernel<2, 7, 7>"
    assert chip_smoke._k6_instance(fa, 1, 384, 32, 112, 112, bf) == \
        "flash_attention_wgmma_kernel<1, 7, 7>"
    assert chip_smoke._k6_instance(fa, 1, 65, 2, 18, 18, bf) == \
        "flash_attention_ws_kernel<2>"
    # MLA's d 192 over d_v 128 in bf16: the wgmma kernel's <NWG, 12, 8>
    # (was the CUDA-core flash_attention_simt_kernel<bf16, 4>), 128-row
    # blocks at deepseek's prefill_32k; -smoke's 96 / 64 the d = d_v
    # instance with V at its own width; past 192 / 128 the CUDA cores
    assert chip_smoke._k6_instance(fa, 1, 384, 16, 192, 128, bf) == \
        "flash_attention_wgmma_kernel<1, 12, 8>"
    assert chip_smoke._k6_instance(fa, 6, 32768, 16, 192, 128, bf) == \
        "flash_attention_wgmma_kernel<2, 12, 8>"
    assert chip_smoke._k6_instance(fa, 2, 24, 4, 96, 64, bf) == \
        "flash_attention_wgmma_kernel<1, 6, 6>"
    assert chip_smoke._k6_instance(fa, 1, 384, 16, 256, 128, bf) == \
        "flash_attention_simt_kernel<bf16, 4>"
    assert chip_smoke._k6_instance(fa, 1, 384, 16, 192, 128, f32) == \
        "flash_attention_mma_kernel<24, 16, 2>"
    assert chip_smoke._k6_instance(fa, 2, 24, 4, 96, 64, f32) == \
        "flash_attention_mma_kernel<12, 8, 4>"
    assert chip_smoke._k6_instance(fa, 1, 384, 32, 112, 112, f32) == \
        "flash_attention_mma_kernel<14, 14, 4>"
    # gemma2-9b's d = 256 in float32: the column-warp 3xTF32 kernel (was
    # the CUDA-core flash_attention_simt_kernel<float, 8>), as every
    # float32 d = d_v past 128
    assert chip_smoke._k6_instance(fa, 1, 384, 32, 256, 256, f32) == \
        "flash_attention_cols_kernel"
    assert chip_smoke._k6_instance(fa, 1, 40, 4, 130, 130, f32) == \
        "flash_attention_cols_kernel"
    # float32 d_v != d past MLA's 192 / 128 stays on the CUDA cores
    assert chip_smoke._k6_instance(fa, 1, 384, 16, 256, 128, f32) == \
        "flash_attention_simt_kernel<float, 4>"
    # gemma2-9b's d = 256 in bf16: the wgmma kernel at NKT 16, 128-row
    # blocks at prefill_32k, 64-row ones at the 384-token serving prefill
    assert chip_smoke._k6_instance(fa, 3, 32768, 16, 256, 256, bf) == \
        "flash_attention_wgmma_kernel<2, 16, 16>"
    assert chip_smoke._k6_instance(fa, 1, 384, 16, 256, 256, bf) == \
        "flash_attention_wgmma_kernel<1, 16, 16>"


def test_kernel_phases_hold_every_llm_path_shape():
    # each K6 and K7 shape the three LLM main paths launch at (4 slots,
    # 384-token prompts, a 512-slot cache) is held against its plain
    # version: zamba2's shared attention, deepseek's MLA, musicgen's self-
    # and cross-attention
    flash = {c[:8] for c in chip_smoke.FLASH_PATH_SHAPES}
    assert {(1, 384, 512, 32, 32, 112, 112, True),
            (1, 384, 512, 16, 16, 192, 128, True),
            (4, 384, 512, 24, 24, 64, 64, True),
            (4, 384, 256, 24, 24, 64, 64, False),
            (4, 1, 256, 24, 24, 64, 64, False)} <= flash
    decode = {c[:5] for c in chip_smoke.DECODE_PATH_SHAPES}
    assert {(4, 512, 32, 32, 112), (4, 512, 24, 24, 64)} <= decode
    # gemma2-9b's global and LOCAL layers (window 4096, softcap 50)
    flash = {c[:10] for c in chip_smoke.FLASH_PATH_SHAPES}
    assert {(1, 384, 512, 16, 8, 256, 256, True, None, 50.0),
            (1, 384, 512, 16, 8, 256, 256, True, 4096, 50.0)} <= flash
    decode = {c[:5] + c[6:] for c in chip_smoke.DECODE_PATH_SHAPES}
    assert {(4, 512, 16, 8, 256, None, 50.0),
            (4, 512, 16, 8, 256, 4096, 50.0)} <= decode


def test_dynamic_smem_of_the_k7_and_k8_instances():
    # K7's bf16 TMA kernel: a 64 KB ring of (K + V) stages of 64-column
    # boxes of 4 heads x 16 slots, asked as 120 KB: one block an SM
    assert chip_smoke.k7_tma_smem(112) == chip_smoke.k7_tma_smem(64) \
        == 122_880
    # d = 256: three 64 KB stages, their mbarriers, and Q's fragments (4
    # warps x 16 k steps x 32 lanes x 16 bytes): one block an SM, within
    # the 227 KB a block may have
    assert chip_smoke.k7_tma_smem(256) == 3 * 65_536 + 48 + 32_768 \
        == 229_424 <= 232_448
    # K8 at zamba2's p = n = 64, chunk 256: the float32 output kernel's
    # 106,560 B, the state kernel's double-buffered tiles, and the bf16
    # tiles at half their bytes
    f32 = chip_smoke.k8_smem(64, 64, 256, False)
    b16 = chip_smoke.k8_smem(64, 64, 256, True)
    assert f32 == {"state": 75_840, "output": 106_560}
    assert b16 == {"state": 43_072, "output": 65_600}


@pytest.mark.parametrize("spans,want", [
    ([], 0.0),
    ([(0, 2, "a"), (5, 6, "b")], 3.0),                 # apart
    ([(0, 4, "a"), (1, 2, "b"), (3, 7, "c")], 7.0),     # nested, overlapping
    ([(0, 1, "a"), (1, 3, "b")], 3.0)])                # touching
def test_busy_time_is_the_union_of_the_kernels_spans(spans, want):
    # the decode step's device busy time: kernels of two streams overlap,
    # and a kernel inside another adds nothing
    assert chip_smoke.busy_us(spans) == want


def test_bf16_steps_count_how_far_a_result_lies_from_its_rounding():
    # rounding the float32 value gives 0 steps and at most half an ulp; a
    # value pushed across one rounding boundary is one step away
    want = torch.tensor([1.0, -3.0, 0.1, 1000.0])
    steps = chip_smoke.bf16_steps(torch, want.to(torch.bfloat16), want)
    assert steps["steps"] == {"0": 4, "1": 0, ">1": 0}
    assert steps["max_ulps"] <= 0.5
    got = want.to(torch.bfloat16)
    got[1] = torch.tensor(-3.0 - 2 ** -6).to(torch.bfloat16)   # 1 ulp at 2
    got[3] = torch.tensor(1000.0 + 3 * 4).to(torch.bfloat16)   # 3 at 512
    steps = chip_smoke.bf16_steps(torch, got, want)
    assert steps["steps"] == {"0": 2, "1": 1, ">1": 1}
    assert steps["max_ulps"] == pytest.approx(3.0)


def test_gemma2_bounds_at_its_32k_and_serving_shapes():
    # gemma2-9b (16 q-heads over 8, d 256, softcap 50) at prefill_32k's 3
    # rows and decode_32k's 5 slots, worked out by hand: a global layer's
    # K6 has 3 x 16 x 32,768 x 32,769 / 2 causal pairs, each 2 (256 + 256)
    # bf16 products and 5 + 3 other operations; a LOCAL layer's (window
    # 4096) 3 x 16 x (4096 x 4097 / 2 + 28,672 x 4096); K7 reads every K and
    # V row of its slots (the window's last 4096 on a LOCAL layer) once
    from repro_torch.configs import get_config
    cfg = get_config("gemma2-9b")
    pairs = 3 * 16 * 32768 * 32769 // 2
    assert pairs == 25_770_590_208
    nbytes, mma, other, (ms, by) = chip_smoke.gemma2_bound(cfg, "K6", 3,
                                                           32768, None)
    assert nbytes == 2 * (3 * 32768 * 16 * 512 + 3 * 32768 * 8 * 512) + 12
    assert (mma, other) == (pairs * 1024, pairs * 8)
    assert by == "operations" and ms == pytest.approx(
        (pairs * 1024 / 989.4e12 + pairs * 8 / 67e12) * 1e3, rel=1e-12)
    assert ms == pytest.approx(29.748891, abs=1e-6)
    local = 3 * 16 * (4096 * 4097 // 2 + (32768 - 4096) * 4096)
    _, mma, _, (ms, by) = chip_smoke.gemma2_bound(cfg, "K6", 3, 32768, 4096)
    assert mma == local * 1024 and by == "operations"
    assert ms == pytest.approx(6.972297, abs=1e-6)
    nbytes, mma, _, (ms, by) = chip_smoke.gemma2_bound(cfg, "K7", 5, 32768,
                                                       None)
    assert nbytes == 2 * (2 * 5 * 16 * 256 + 2 * 5 * 32768 * 8 * 256) + 20
    assert mma == 5 * 32768 * 16 * 1024 and by == "bytes"
    assert ms == pytest.approx(1_342_259_220 / 3.35e9, rel=1e-12)
    nbytes, _, _, (ms, by) = chip_smoke.gemma2_bound(cfg, "K7", 5, 32768,
                                                     4096)
    assert nbytes == 167_854_100 and by == "bytes"
    assert ms == pytest.approx(0.050106, abs=1e-6)
    # the float32 serving shapes: a 384-token prompt into a 512-slot cache
    # (73,920 causal pairs, 16 heads, operations at 67 TFLOP/s) and four
    # slots at 385-399 of 512 (1,569 valid rows)
    nbytes, ops, pairs = chip_smoke.flash_bound(1, 384, 512, 16, 8, 256,
                                                256, True, None, 50.0)
    assert pairs == 73_920 and ops == pairs * 16 * (1024 + 8)
    assert nbytes == 4 * (384 * 16 * 512 + 384 * 8 * 512) + 4
    ms, by = chip_smoke.bound_ms(nbytes, ops)
    assert by == "operations" and ms == pytest.approx(0.0182174, abs=1e-6)
    lens = [385, 390, 395, 399]
    assert chip_smoke.decode_nbytes(4, 16, 8, 256, lens, 512, None) == \
        4 * (2 * 4 * 16 * 256 + 2 * sum(lens) * 8 * 256) + 16


def test_gemma2_32k_cases_take_a_global_and_a_local_layer():
    from repro_torch.configs import get_config
    cases = chip_smoke.gemma2_32k_cases(
        get_config("gemma2-9b"), {"prefill_32k": 3, "decode_32k": 5})
    assert cases == [("K6", "global", 3, None), ("K6", "LOCAL", 3, 4096),
                     ("K7", "global", 5, None), ("K7", "LOCAL", 5, 4096)]


def test_gemma2_phases_are_wired_in():
    # the full run: gemma2's bf16 dry-run steps, K6 and K7 at its 32k shapes
    # against their plain versions and its one-block cut inside the dry
    # run; its two-block float32 cut against the CPU and its float32
    # serving path after deepseek's and musicgen's; --only runs the probe
    # and the gemma2 phases alone
    import inspect
    dry = inspect.getsource(chip_smoke.phase_dryrun)
    assert "phase_dryrun_card(torch, card, table, GEMMA_ARCH)" in dry
    assert "phase_gemma2_32k(" in dry and "check=True" in dry
    assert "phase_dryrun_reference(torch, np, card, GEMMA_ARCH)" in dry
    main = inspect.getsource(chip_smoke.main)
    assert "GEMMA_ARCH: phase_gemma2_reference(torch, np, card)" in main
    assert main.index("cross_counts = phase_cross_main_path") < main.index(
        "gemma_counts, _, gemma_params, _ = phase_llm_main_path")
    assert chip_smoke.GEMMA_ARCH == "gemma2-9b"
    assert {"gemma2", "gemma2_32k", "gemma2_serve", "k6"} <= set(
        chip_smoke.ONLY_PHASES)
    assert chip_smoke.ONLY_PHASES["k6"] is chip_smoke.phase_flash_attention
    assert chip_smoke.PROBES["phase_gemma2_32k"] == "gemma2 32k"
    # the float32 serving probe: the cut against the CPU, then the served
    # path, one summary line a tree
    assert chip_smoke.PROBES["phase_gemma2_serve"] == "gemma2 serve"
    serve = inspect.getsource(chip_smoke.phase_gemma2_serve)
    assert serve.index("phase_gemma2_reference(") < serve.index(
        "phase_llm_main_path(torch, np, card, GEMMA_ARCH)")
    assert 'print(f"gemma2 serve float32: ' in serve
    ref = inspect.getsource(chip_smoke.phase_gemma2_reference)
    assert "block_cut(get_config(GEMMA_ARCH), 2)" in ref


def test_deepseek_k6_bound_at_its_32k_shape():
    # deepseek-v2-lite-16b's MLA prefill at prefill_32k's 6 rows, worked
    # out by hand: q and k at 128 + 64 = 192, v at 128, 16 heads each their
    # own kv-head; 6 x 16 x 32,768 x 32,769 / 2 causal pairs, each
    # 2 (192 + 128) bf16 products and 5 softmax operations; q, k, v and
    # the output once in bf16 (4.03 GB): the products bound it
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    assert chip_smoke.mla_k6_dims(cfg) == (16, 16, 192, 128)
    pairs = 6 * 16 * 32768 * 32769 // 2
    assert pairs == 51_541_180_416
    nbytes, mma, other, (ms, by) = chip_smoke.k6_causal_bound(
        6, 32768, *chip_smoke.mla_k6_dims(cfg))
    assert nbytes == 2 * 2 * 6 * 32768 * 16 * 320 + 24 == 4_026_531_864
    assert (mma, other) == (pairs * 640, pairs * 5)
    assert by == "operations" and ms == pytest.approx(
        (pairs * 640 / 989.4e12 + pairs * 5 / 67e12) * 1e3, rel=1e-12)
    assert ms == pytest.approx(37.186114, abs=1e-6)
    # -smoke: 64 + 32 over 64, 4 heads
    assert chip_smoke.mla_k6_dims(get_config(
        "deepseek-v2-lite-16b-smoke")) == (4, 4, 96, 64)


def test_kernel_offsets_follow_each_configs_kernels():
    # K6's q at MLA's 192 (not head_dim's 128); K7's caches and workspace
    # only where the config decodes by K7 (not MLA's absorbed decode); K8's
    # only with Mamba2 layers.  Each stays below 2^31 at its card batches
    from repro_torch.configs import get_config
    got = chip_smoke.kernel_offsets(get_config("deepseek-v2-lite-16b"),
                                    {"prefill_32k": 6, "decode_32k": 44})
    assert got == {"flash_attention": 6 * 32768 * 16 * 192}
    got = chip_smoke.kernel_offsets(get_config("gemma2-9b"),
                                    {"prefill_32k": 3, "decode_32k": 5})
    assert set(got) == {"flash_attention", "decode_attention"}
    assert got["flash_attention"] == 3 * 32768 * 16 * 256
    assert got["decode_attention"] >= 5 * 32768 * 8 * 256
    got = chip_smoke.kernel_offsets(get_config("zamba2-7b"),
                                    {"prefill_32k": 6, "decode_32k": 14})
    assert set(got) == {"flash_attention", "decode_attention", "ssd_scan"}
    assert max(got.values()) < chip_smoke.INT32_LIMIT


def test_deepseek_phases_are_wired_in():
    # the full run: deepseek's bf16 dry-run steps, K6 at its 32k shape
    # against its plain version and its one-block cut, after gemma2's, on
    # the dry run's table; --only deepseek runs them alone, --only
    # deepseek_32k the timing probe (with --parent on the parent's package
    # too); K6's bf16 row carries its launches and its 32k row
    import inspect
    dry = inspect.getsource(chip_smoke.phase_dryrun)
    assert dry.index("phase_dryrun_reference(torch, np, card, GEMMA_ARCH)") \
        < dry.index("phase_deepseek(torch, np, card, table)")
    phase = inspect.getsource(chip_smoke.phase_deepseek)
    assert phase.index("MOE_ARCH), MOE_ARCH)") < phase.index(
        "k6 = phase_deepseek_32k(") < phase.index(
        "phase_dryrun_reference(torch, np, card, MOE_ARCH)")
    assert "check=True" in phase
    assert chip_smoke.MOE_ARCH == "deepseek-v2-lite-16b"
    assert chip_smoke.ONLY_PHASES["deepseek"] is chip_smoke.phase_deepseek
    assert "deepseek_32k" in chip_smoke.ONLY_PHASES
    assert chip_smoke.PROBES["phase_deepseek_32k"] == "deepseek 32k"
    probe = inspect.getsource(chip_smoke.phase_deepseek_32k)
    assert 'print(f"deepseek 32k K6 bf16 MLA' in probe
    assert "SDPBackend.EFFICIENT_ATTENTION" in probe
    main = inspect.getsource(chip_smoke.main)
    assert 'bf["dryrun_deepseek"] = dryrun["kernels"]["deepseek"]' in main
    assert '"card_deepseek",' in main
    # deepseek's K6 launches: 27 a prefill (one a layer), no K7 or K8
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    assert chip_smoke.path_launches(cfg, 1, 0) == {
        "flash_attention": 27, "decode_attention": 0, "ssd_scan": 0}
    assert chip_smoke.path_launches(cfg, 0, 1) == {
        "flash_attention": 0, "decode_attention": 0, "ssd_scan": 0}


def test_offsets_past_2_31_pass_for_k8_only():
    # mamba2-2.7b at prefill_32k's 18 rows: K8's x holds 18 x 32,768 x 80
    # x 64 = 3.02e9 elements (its workspace 18 x 128 chunks x 80 heads x
    # (64 x 128 + 1) floats, fewer), past 2^31; K8's offsets are 64-bit and
    # proven there on the card, so the gate lets it through.  K6's and K7's
    # counts past 2^31 still raise
    from repro_torch.configs import get_config
    got = chip_smoke.kernel_offsets(get_config("mamba2-2.7b"), {
        "prefill_32k": 18, "decode_32k": 128, "long_500k": 1})
    assert got == {"ssd_scan": 18 * 32768 * 80 * 64}
    assert got["ssd_scan"] == 3_019_898_880
    assert got["ssd_scan"] > chip_smoke.INT32_LIMIT
    assert chip_smoke.OFFSETS_64BIT == ("ssd_scan",)
    chip_smoke.check_offsets(got)
    for name in ("flash_attention", "decode_attention"):
        with pytest.raises(AssertionError, match=f"reaches 2\\^31.*{name}"):
            chip_smoke.check_offsets({**got, name: chip_smoke.INT32_LIMIT})
        chip_smoke.check_offsets({**got, name: chip_smoke.INT32_LIMIT - 1})
    # zamba2 at 40 rows of 32k: K6's q holds 4.70e9 elements
    big = chip_smoke.kernel_offsets(get_config("zamba2-7b"),
                                    {"prefill_32k": 40, "decode_32k": 14})
    assert big["flash_attention"] == 40 * 32768 * 32 * 112
    with pytest.raises(AssertionError, match="flash_attention"):
        chip_smoke.check_offsets(big)
    chip_smoke.check_offsets(chip_smoke.kernel_offsets(
        get_config("zamba2-7b"), {"prefill_32k": 6, "decode_32k": 14}))


def test_card_shapes_take_long_500k_for_mamba2_only():
    # zamba2 and gemma2 keep the two 32k shapes; mamba2 adds long_500k
    # (deepseek and the dense archs do too, musicgen train_4k: the tests
    # below)
    assert chip_smoke.MAMBA_ARCH == "mamba2-2.7b"
    for arch in (chip_smoke.DRYRUN_ARCH, chip_smoke.GEMMA_ARCH):
        assert chip_smoke.card_shapes(arch) == ("prefill_32k", "decode_32k")
    assert chip_smoke.card_shapes("mamba2-2.7b") == (
        "prefill_32k", "decode_32k", "long_500k")
    # the batches its abstract pass picked (ISSUE table: 18, 128, 1)
    table = {("mamba2-2.7b", s): {"max_batch": b} for s, b in (
        ("prefill_32k", 18), ("decode_32k", 128), ("long_500k", 1),
        ("train_4k", 0))}
    assert chip_smoke.card_batches(table, "mamba2-2.7b") == {
        "prefill_32k": 18, "decode_32k": 128, "long_500k": 1}


def test_mamba2_k8_bound_at_its_32k_shape():
    # K8 at 18 x 32,768, 80 heads, p 64, n 128, chunk 256 in bf16: x and y
    # bf16 (2 x 6.04 GB), B and C bf16, dt, A and the final state float32:
    # 12.62 GB, 3.77 ms at HBM's rate; the function's 5pn + p + 2
    # operations a (row, head, step) at fp32's rate bound it (28.89 ms);
    # on the tensor cores C B^T's 1.55e12 bf16 products, 2.32e12 products
    # with one bf16 operand (two TF32 each) and 3.35e10 other operations
    from repro_torch.configs import get_config
    h, p, n, chunk = chip_smoke.mamba2_k8_dims(get_config("mamba2-2.7b"))
    assert (h, p, n, chunk) == (80, 64, 128, 256)
    nbytes = chip_smoke.ssd_nbytes(18, 32768, h, p, n, False, size=2)
    assert nbytes == 12_617_515_328
    mma, other, bf16, tf32x2 = chip_smoke.ssd_tc_ops(18, 32768, h, p, n,
                                                     chunk, bf16=True)
    assert (bf16, tf32x2, other) == (1_552_228_024_320, 2_322_302_238_720,
                                     33_525_596_160)
    assert mma == bf16 + tf32x2
    ms, by = chip_smoke.bound_ms(nbytes, chip_smoke.ssd_ops(18, 32768, h, p,
                                                           n))
    assert by == "operations" and ms == pytest.approx(28.893277, abs=1e-6)
    ms, by = chip_smoke.tc_bound_ms(nbytes, mma, other, bf16, tf32x2)
    assert by == "operations" and ms == pytest.approx(11.452279, abs=1e-6)
    # the float32 output kernel at n 128 asks 172,096 B: one block an SM
    assert chip_smoke.k8_smem(p, n, chunk, False)["output"] == 172_096


def test_mamba2_phases_are_wired_in():
    # the full run: mamba2's bf16 dry-run steps, K8 at its 32k shape
    # against its plain version, its cut layer by layer and its float32
    # serving path, after deepseek's, on the dry run's table; --only mamba2
    # runs them alone, --only mamba2_32k the timing probe (with --parent on
    # the parent's package too); K8's rows carry its launches and shapes
    import inspect
    dry = inspect.getsource(chip_smoke.phase_dryrun)
    assert dry.index("phase_deepseek(torch, np, card, table)") < dry.index(
        "phase_mamba2(torch, np, card, table)")
    assert '"card_mamba2": mamba["card"]' in dry
    assert '"card_vs_cpu_mamba2": mamba["card_vs_cpu"]' in dry
    phase = inspect.getsource(chip_smoke.phase_mamba2)
    assert phase.index("MAMBA_ARCH), MAMBA_ARCH)") < phase.index(
        "k8 = phase_mamba2_32k(") < phase.index(
        "phase_dryrun_reference(torch, np, card, MAMBA_ARCH,") < \
        phase.index("phase_mamba2_serve(torch, np, card)")
    assert "check=True" in phase
    serve = inspect.getsource(chip_smoke.phase_mamba2_serve)
    assert serve.index("llm_reference(") < serve.index(
        "phase_llm_main_path(torch, np, card,") < serve.index(
        "phase_mamba2_serve_k8(torch, card)")
    assert 'print(f"mamba2 serve float32: ' in serve
    assert chip_smoke.ONLY_PHASES["mamba2"] is chip_smoke.phase_mamba2
    assert "mamba2_32k" in chip_smoke.ONLY_PHASES
    assert chip_smoke.PROBES["phase_mamba2_32k"] == "mamba2 32k"
    probe = inspect.getsource(chip_smoke.phase_mamba2_32k)
    assert 'print(f"mamba2 32k K8 bf16' in probe
    assert "kernel_split(torch, fn, K8_KERNELS)" in probe
    main = inspect.getsource(chip_smoke.main)
    assert 'bf["dryrun_mamba2"] = dryrun["kernels"]["mamba2"]' in main
    assert '"card_mamba2",' in main and '"card_vs_cpu_mamba2")' in main
    assert 'row["mamba2_serving_shape"]' in main
    # its cuts: MAMBA_REF_BLOCKS Mamba2 layers at full width
    from repro_torch.configs import get_config
    cut = chip_smoke.block_cut(get_config("mamba2-2.7b"),
                               chip_smoke.MAMBA_REF_BLOCKS)
    assert (cut.num_layers, cut.d_model, cut.n_ssm_heads, cut.vocab_size) \
        == (2, 2560, 80, 50280)
    assert chip_smoke.llm_kernel_calls(cut) == (0, 2)


def test_card_shapes_take_long_500k_for_mamba2_and_the_dense_archs():
    # long_500k on the card for the archs whose abstract pass fits it at
    # batch 1: mamba2-2.7b, the dense GQA decoders (their +sliding
    # variant) and deepseek-v2-lite-16b (its 524,288-slot latent cache);
    # zamba2 and gemma2 keep the two 32k shapes
    from repro_torch.configs import list_archs
    assert chip_smoke.DENSE_ARCHS == ("qwen2-7b", "starcoder2-7b")
    long = {a for a in list_archs()
            if "long_500k" in chip_smoke.card_shapes(a)}
    assert long == {"mamba2-2.7b", "qwen2-7b", "starcoder2-7b",
                    "deepseek-v2-lite-16b"}
    for arch in (chip_smoke.DRYRUN_ARCH, chip_smoke.GEMMA_ARCH):
        assert chip_smoke.card_shapes(arch) == ("prefill_32k", "decode_32k")
    assert chip_smoke.card_shapes(chip_smoke.MOE_ARCH) == (
        "prefill_32k", "decode_32k", "long_500k")
    # the batches their abstract passes pick (qwen2 9, 34, 1; starcoder2
    # 8, 27, 1)
    for arch, (bp, bd) in (("qwen2-7b", (9, 34)), ("starcoder2-7b", (8, 27))):
        table = {(arch, s): {"max_batch": b} for s, b in (
            ("prefill_32k", bp), ("decode_32k", bd), ("long_500k", 1),
            ("train_4k", 0))}
        assert chip_smoke.card_batches(table, arch) == {
            "prefill_32k": bp, "decode_32k": bd, "long_500k": 1}


def test_kernel_offsets_count_each_card_shape_at_its_own_length():
    # K6's q at prefill_32k's rows, K7's caches at decode_32k's slots and at
    # long_500k's one row of 524,288 slots (a 32k count would read 1/16 of
    # it); every count below 2^31, so K6 and K7 stay gated there
    from repro_torch.configs import get_config
    qwen2, sc2 = get_config("qwen2-7b"), get_config("starcoder2-7b")
    got = chip_smoke.kernel_offsets(qwen2, {"prefill_32k": 9,
                                            "decode_32k": 34,
                                            "long_500k": 1})
    assert got == {"flash_attention": 9 * 32768 * 28 * 128,
                   "decode_attention": 34 * 32768 * 4 * 128}
    assert got["flash_attention"] == 1_056_964_608
    got = chip_smoke.kernel_offsets(sc2, {"prefill_32k": 8,
                                          "decode_32k": 27,
                                          "long_500k": 1})
    assert got == {"flash_attention": 8 * 32768 * 36 * 128,
                   "decode_attention": 27 * 32768 * 4 * 128}
    for cfg in (qwen2, sc2):
        assert chip_smoke.kernel_offsets(cfg, {"long_500k": 1}) == {
            "decode_attention": 524288 * 4 * 128}
        chip_smoke.check_offsets(chip_smoke.kernel_offsets(cfg, {
            "prefill_32k": 9, "decode_32k": 34, "long_500k": 1}))
    assert "flash_attention" not in chip_smoke.OFFSETS_64BIT
    assert "decode_attention" not in chip_smoke.OFFSETS_64BIT
    # 19 rows of qwen2's prefill would pass 2^31 and raise
    with pytest.raises(AssertionError, match="flash_attention"):
        chip_smoke.check_offsets(chip_smoke.kernel_offsets(
            qwen2, {"prefill_32k": 19}))


def test_dense_path_launches_follow_their_layers():
    # a K6 a layer at prefill, a K7 a layer at decode (the long_500k
    # variant's LOCAL layers too), no K8; the serving path's totals
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.specs import arch_for_shape
    for arch, n in (("qwen2-7b", 28), ("starcoder2-7b", 32)):
        cfg = get_config(arch)
        assert chip_smoke.path_launches(cfg, 1, 0) == {
            "flash_attention": n, "decode_attention": 0, "ssd_scan": 0}
        assert chip_smoke.path_launches(cfg, 0, 1) == {
            "flash_attention": 0, "decode_attention": n, "ssd_scan": 0}
        slid = arch_for_shape(cfg, INPUT_SHAPES["long_500k"])
        assert chip_smoke.path_launches(slid, 0, 1) == \
            chip_smoke.path_launches(cfg, 0, 1)
        assert chip_smoke.path_launches(cfg, 8, 30) == {
            "flash_attention": 8 * n, "decode_attention": 30 * n,
            "ssd_scan": 0}


def test_dense_kernel_instances_in_both_dtypes(monkeypatch):
    # bf16 K6 at the 32k prefills: 128-row blocks of the wgmma kernel at d
    # 128; float32 K6 at the serving prefill: the 3xTF32 kernel; bf16 K7:
    # the TMA kernel at NKT 8; float32 K7 at d 128 (not the bulk kernel,
    # which takes d > 128): the split kernel's 8 q-heads a block
    import types
    fa = _k6_routes(monkeypatch)
    bf, f32 = torch.bfloat16, torch.float32
    for b, h in ((9, 28), (8, 36)):
        assert chip_smoke._k6_instance(fa, b, 32768, h, 128, 128, bf) == \
            "flash_attention_wgmma_kernel<2, 8, 8>"
        assert chip_smoke._k6_instance(fa, 1, 384, h, 128, 128, f32) == \
            "flash_attention_mma_kernel<16, 16, 4>"
    da = types.SimpleNamespace(
        on_tma=lambda q, k, v: q.dtype == bf and q.shape[-1] <= 256,
        on_bulk=lambda q, k, v: q.dtype == f32 and q.shape[-1] > 128)
    for h in (28, 36):
        for dtype, want in ((bf, "decode_tma_kernel<8>"),
                            (f32, "decode_split_kernel<float, 8>")):
            q = torch.empty((4, h, 128), dtype=dtype)
            kc = torch.empty((4, 16, 4, 128), dtype=dtype)
            assert chip_smoke.k7_instance(da, q, kc, kc) == want


def test_dense_bounds_at_their_card_shapes():
    # bf16 K6 at 9 x 32,768 (qwen2, 28 / 4 heads) and 8 x 32,768
    # (starcoder2, 36 / 4), causal, d 128: operations bound them; K7 at
    # decode_32k's slots and long_500k's 8192-slot window: bytes
    ms = {}
    for key, (b, h) in {"qwen2": (9, 28), "starcoder2": (8, 36)}.items():
        nbytes, mma, other, (bound, by) = chip_smoke.k6_causal_bound(
            b, 32768, h, 4, 128, 128)
        assert by == "operations"
        ms[key] = (bound, mma, nbytes)
    assert ms["qwen2"][0] == pytest.approx(80.110176, abs=1e-6)
    assert ms["qwen2"][1] == 69_271_346_479_104
    assert ms["qwen2"][2] == 4_831_838_244
    assert ms["starcoder2"][0] == pytest.approx(91.554487, abs=1e-6)
    assert ms["starcoder2"][1] == 79_167_253_118_976
    nbytes, _, _, (bound, by) = chip_smoke.k7_bound(
        34, 28, 4, 128, [32768] * 34, 32768, None)
    assert (nbytes, by) == (2_282_188_936, "bytes")
    assert bound == pytest.approx(0.681250, abs=1e-6)
    nbytes, _, _, (bound, by) = chip_smoke.k7_bound(
        27, 36, 4, 128, [32768] * 27, 32768, None)
    assert (nbytes, by) == (1_812_437_100, "bytes")
    assert bound == pytest.approx(0.541026, abs=1e-6)
    nbytes, _, _, (_, by) = chip_smoke.k7_bound(1, 28, 4, 128, [524288],
                                                524288, 8192)
    assert (nbytes, by) == (16_791_556, "bytes")    # the window's rows only
    # the long_500k cases: the window's tiles from slot 516,096, and a
    # length inside the first window
    cases = chip_smoke.dense_k7_cases({"decode_32k": 34, "long_500k": 1})
    assert cases == [("K7 decode_32k", 34, 32768, None, 32768),
                     ("K7 long_500k", 1, 524288, 8192, 524288),
                     ("K7 long_500k early", 1, 524288, 8192, 4097)]
    assert 524288 - 8192 == 516_096


class _ClockEvent:
    """A CUDA event on a fake clock (``_ClockEvent.now``, in ms)."""
    now = 0.0

    def __init__(self, **kw):
        self.t = None

    def record(self):
        self.t = _ClockEvent.now

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_k6_device_ms_reads_the_launchers_events(monkeypatch):
    # K6's device time comes from the events its launcher records inside
    # the very calls the turns time (event_turns): each call 3 ms of wall,
    # 2 of them its kernel's, so the device time cannot pass the wall
    # time; a launcher that records none (an older package): the handed
    # events are withdrawn and the profiler's one-call figure stands
    from repro_torch.kernels import _build
    handed, records = [], [True]
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(_build, "time_next_launch",
                        lambda ev: handed.append(list(ev)))
    monkeypatch.setattr(_build, "launch_events_recorded",
                        lambda: len(handed[-1]) if records[0] else 0)
    monkeypatch.setattr(chip_smoke, "profile_device",
                        lambda torch, fn, reps, once: (3.5, []))

    def kernel():                   # the launcher: its events around 2 ms
        _ClockEvent.now += 0.5
        if records[0] and handed and handed[-1]:
            handed[-1][0].record()
        _ClockEvent.now += 2.0
        if records[0] and handed and handed[-1]:
            handed[-1][1].record()
        _ClockEvent.now += 0.5

    def library():
        _ClockEvent.now += 1.0
    turns, split, source = chip_smoke.event_turns(
        torch, {"kernel": kernel, "library": library},
        chip_smoke.K6_KERNELS, reps=3, warmup=1)
    assert turns == {"kernel": [3.0, 3.0], "library": [1.0, 1.0]}
    assert split == {"attention": 2.0, "total": 2.0} and source == "events"
    assert len(handed) == 6 and all(len(ev) == 2 for ev in handed)
    records[0] = False
    handed.clear()
    turns, split, source = chip_smoke.event_turns(
        torch, {"kernel": kernel, "library": library},
        chip_smoke.K6_KERNELS, reps=3, warmup=1)
    assert turns["kernel"] == [3.0, 3.0]
    assert split == {"total": 3.5} and source == "profiler"
    assert [len(ev) for ev in handed] == [2, 0, 2, 0]
    assert chip_smoke.K6_KERNELS == ("attention",)


def test_dense_phases_are_wired_in():
    # the full run: each dense arch's bf16 dry-run steps, K6 and K7 at its
    # card shapes against their plain versions, its cut layer by layer and
    # its float32 serving path, after mamba2's, on the dry run's table;
    # --only qwen2 / starcoder2 run them alone, --only qwen2_32k /
    # starcoder2_32k the timing probe (with --parent on the parent's
    # package too); the 32k K6 rows take their device time from the
    # launcher's events
    import inspect
    dry = inspect.getsource(chip_smoke.phase_dryrun)
    assert dry.index("phase_mamba2(torch, np, card, table)") < dry.index(
        "phase_dense(torch, np, card, arch, table)")
    assert 'f"card_{tag}": got["card"]' in dry
    assert 'f"card_vs_cpu_{tag}": got["card_vs_cpu"]' in dry
    assert 'f"{tag}_serve": got["serve"]' in dry
    phase = inspect.getsource(chip_smoke.phase_dense)
    assert phase.index("arch=arch), arch)") < phase.index(
        "phase_dense_32k(torch, card, arch,") < phase.index(
        "phase_dryrun_reference(torch, np, card, arch,") < \
        phase.index("phase_dense_serve(torch, np, card, arch)")
    assert "check=True" in phase
    serve = inspect.getsource(chip_smoke.phase_dense_serve)
    assert serve.index("llm_reference(") < serve.index(
        "phase_llm_main_path(torch, np, card, arch)") < serve.index(
        "phase_dense_serve_kernels(torch, card, arch)")
    for tag in ("qwen2", "starcoder2"):
        assert tag in chip_smoke.ONLY_PHASES
        assert tag + "_32k" in chip_smoke.ONLY_PHASES
        assert chip_smoke.PROBES[f"phase_{tag}_32k"] == f"{tag} 32k"
        assert callable(getattr(chip_smoke, f"phase_{tag}_32k"))
    probe = inspect.getsource(chip_smoke.phase_dense_32k)
    assert 'print(f"{tag} 32k {key} bf16' in probe
    assert "K6_KERNELS if key.startswith(\"K6\") else K7_KERNELS" in probe
    for fn in (chip_smoke.phase_dense_32k, chip_smoke.phase_gemma2_32k,
               chip_smoke.phase_deepseek_32k,
               chip_smoke.phase_dryrun_kernels):
        assert "event_turns(" in inspect.getsource(fn)
    main = inspect.getsource(chip_smoke.main)
    assert 'row[f"{tag}_serving_shape"]' in main
    assert 'bf[f"dryrun_{dense_tag(arch)}"]' in main
    # their cuts: DENSE_REF_BLOCKS layers at full width
    from repro_torch.configs import get_config
    for arch, width, vocab in (("qwen2-7b", 3584, 152064),
                               ("starcoder2-7b", 4608, 49152)):
        cut = chip_smoke.block_cut(get_config(arch),
                                   chip_smoke.DENSE_REF_BLOCKS)
        assert (cut.num_layers, cut.d_model, cut.vocab_size) == (2, width,
                                                                 vocab)
        assert chip_smoke.llm_kernel_calls(cut) == (2, 0)
    assert chip_smoke.dense_tag("starcoder2-7b") == "starcoder2"


def test_launcher_cut_runs_beside_the_build(monkeypatch, capsys):
    # the launcher's cut is abstract passes alone (no card): it runs in the
    # dry run's spawned pool, submitted first, and main() hands its result
    # to the launcher's phase; on a smoke config the card's HBM holds every
    # block, so the cut is the config's own
    import inspect
    start = inspect.getsource(chip_smoke.start_dryrun_table)
    assert start.index("pool.submit(launcher_cut)") < start.index(
        "pool.submit(_abstract_row, c)")
    assert "started[4].result()" in inspect.getsource(chip_smoke.main)
    monkeypatch.setattr(chip_smoke, "LLM_ARCH", "zamba2-7b-smoke")
    monkeypatch.setattr(chip_smoke, "LAUNCHER_BATCH", 1)
    monkeypatch.setattr(chip_smoke, "LAUNCHER_SEQ", 32)
    threads = torch.get_num_threads()
    try:
        cut = chip_smoke.launcher_cut()
    finally:
        torch.set_num_threads(threads)
    n, peaks, seconds = cut
    assert n == 1 and sorted(peaks) == [1, 2] and seconds > 0
    assert 0 < peaks[1] < peaks[2]
    assert chip_smoke.report_launcher_cut("card", cut) == peaks[1]
    assert "1 blocks (9 layers)" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# musicgen-medium's bf16 steps on the card, deepseek's long_500k, the cuts
# ---------------------------------------------------------------------------
def test_musicgen_card_shapes_and_step_launches():
    # prefill_32k, decode_32k and the first train step on the card (its
    # long_500k fits no batch); the launches each step must make, every
    # one a bf16 one: 48 cross layers, a self- and a cross-attention K6 a
    # layer at prefill, a K7 and a cross K6 at decode, and at train the
    # forward's 96 again under remat with one plain VJP a first-pass launch
    from repro_torch.configs import get_config
    assert chip_smoke.CROSS_ARCH == "musicgen-medium"
    assert chip_smoke.card_shapes("musicgen-medium") == (
        "prefill_32k", "decode_32k", "train_4k")
    table = {("musicgen-medium", s): {"max_batch": b} for s, b in (
        ("prefill_32k", 6), ("decode_32k", 7), ("train_4k", 7),
        ("long_500k", 0))}
    assert chip_smoke.card_batches(table, "musicgen-medium") == {
        "prefill_32k": 6, "decode_32k": 7, "train_4k": 7}
    cfg = get_config("musicgen-medium")
    none = {k: 0 for k in ("ssd_scan", "ssd_scan_bf16")}
    assert chip_smoke.step_launches(cfg, "train") == {
        "flash_attention": 192, "flash_attention_bf16": 192,
        "flash_attention_vjp": 96, "ssd_scan_vjp": 0, "decode_attention": 0,
        "decode_attention_bf16": 0, **none}
    assert chip_smoke.train_launches(cfg, remat=False) == {
        "flash_attention": 96, "ssd_scan": 0, "flash_attention_vjp": 96,
        "ssd_scan_vjp": 0}
    assert chip_smoke.step_launches(cfg, "prefill") == {
        "flash_attention": 96, "flash_attention_bf16": 96,
        "decode_attention": 0, "decode_attention_bf16": 0,
        "flash_attention_vjp": 0, "ssd_scan_vjp": 0, **none}
    assert chip_smoke.step_launches(cfg, "decode") == {
        "flash_attention": 48, "flash_attention_bf16": 48,
        "decode_attention": 48, "decode_attention_bf16": 48,
        "flash_attention_vjp": 0, "ssd_scan_vjp": 0, **none}


def test_deepseek_long_500k_launches_nothing():
    # MLA's absorbed decode over the +sliding variant's 524,288-slot latent
    # cache: no K6, K7 or K8, and no K7 offset to gate
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.specs import arch_for_shape
    cfg = arch_for_shape(get_config("deepseek-v2-lite-16b"),
                         INPUT_SHAPES["long_500k"])
    assert set(chip_smoke.step_launches(cfg, "decode").values()) == {0}
    assert chip_smoke.kernel_offsets(get_config("deepseek-v2-lite-16b"),
                                     {"long_500k": 1}) == {}


def test_kernel_offsets_at_musicgens_card_batches():
    # K6's q at prefill_32k's 6 rows (the train step's 7 x 4,096 is
    # smaller) and K7's caches at decode_32k's 7 slots: below 2^31
    from repro_torch.configs import get_config
    cfg = get_config("musicgen-medium")
    got = chip_smoke.kernel_offsets(cfg, {"prefill_32k": 6,
                                          "decode_32k": 7, "train_4k": 7})
    assert got == {"flash_attention": 6 * 32768 * 24 * 64,
                   "decode_attention": 7 * 32768 * 24 * 64}
    assert got == {"flash_attention": 301_989_888,
                   "decode_attention": 352_321_536}
    assert chip_smoke.kernel_offsets(cfg, {"train_4k": 7}) == {
        "flash_attention": 7 * 4096 * 24 * 64}
    chip_smoke.check_offsets(got)


def test_musicgen_bounds_at_its_card_shapes():
    # K6's causal self-attention at 6 x 32,768 (24 / 24 heads, d 64):
    # 20.00 ms of bf16 products and 5.77 of softmax operations; its
    # cross-attention over 256 context keys by operations too; its decode
    # step (one query a slot) and K7 over 7 x 32,768 slots by bytes
    nbytes, mma, other, (bound, by) = chip_smoke.k6_causal_bound(
        6, 32768, 24, 24, 64, 64)
    assert by == "operations"
    assert bound == pytest.approx(25.773389, abs=1e-6)
    assert mma / 989.4e12 * 1e3 == pytest.approx(20.00, abs=0.01)
    nbytes, mma, other, (bound, by) = chip_smoke.k6_cross_bound(
        6, 32768, 256, 24, 24, 64)
    assert (by, mma) == ("operations", 6 * 32768 * 256 * 24 * 4 * 64)
    assert nbytes == 2 * 6 * 24 * 64 * 2 * (32768 + 256) + 4 * 6
    assert bound == pytest.approx(0.402697, abs=1e-6)
    assert chip_smoke.k6_cross_bound(7, 1, 256, 24, 24, 64)[3][1] == "bytes"
    nbytes, _, _, (bound, by) = chip_smoke.k7_bound(
        7, 24, 24, 64, [32768] * 7, 32768, None)
    assert (nbytes, by) == (1_409_329_180, "bytes")
    assert bound == pytest.approx(0.420695, abs=1e-6)


def test_k6_32k_cases_follow_the_context():
    # musicgen: its self-attention at prefill_32k, the cross-attention
    # over its 256 context keys at prefill_32k and at decode_32k's one
    # token a slot, K7 at decode_32k only; a dense arch: its causal
    # prefill, and long_500k's K7 cases where it runs that shape
    from repro_torch.configs import get_config
    got = chip_smoke.k6_32k_cases(get_config("musicgen-medium"),
                                  {"prefill_32k": 6, "decode_32k": 7})
    assert got == [("K6 self prefill_32k", 6, 32768, 32768, True),
                   ("K6 cross prefill_32k", 6, 32768, 256, False),
                   ("K6 cross decode_32k", 7, 1, 256, False)]
    assert chip_smoke.dense_k7_cases({"prefill_32k": 6, "decode_32k": 7}) \
        == [("K7 decode_32k", 7, 32768, None, 32768)]
    assert chip_smoke.k6_32k_cases(get_config("qwen2-7b"), {
        "prefill_32k": 9, "decode_32k": 34}) == [
        ("K6 prefill_32k", 9, 32768, 32768, True)]
    assert len(chip_smoke.dense_k7_cases({"decode_32k": 34,
                                          "long_500k": 1})) == 3


def test_musicgen_phases_are_wired_in():
    # the full run: musicgen's bf16 steps, K6 and K7 at its card shapes
    # against their plain versions, its 2-layer cut's steps layer by layer
    # and its train step, after the dense archs', on the dry run's table;
    # --only musicgen alone, --only musicgen_32k the timing probe; the
    # JSON line's dryrun and K6 / K7 bf16 rows carry them
    import inspect
    dry = inspect.getsource(chip_smoke.phase_dryrun)
    assert dry.index("phase_dense(torch, np, card, arch, table)") < \
        dry.index("phase_musicgen(torch, np, card, table)")
    assert '"card_musicgen": musicgen["card"]' in dry
    assert '"card_vs_cpu_musicgen": musicgen["card_vs_cpu"]' in dry
    phase = inspect.getsource(chip_smoke.phase_musicgen)
    assert phase.index("CROSS_ARCH), CROSS_ARCH)") < phase.index(
        "phase_musicgen_32k(torch, card,") < phase.index(
        "phase_dryrun_reference(torch, np, card, CROSS_ARCH,") < \
        phase.index("phase_llm_launcher_reference(torch, np, card, "
                    "CROSS_ARCH,")
    assert "check=True" in phase
    assert chip_smoke.ONLY_PHASES["musicgen"] is chip_smoke.phase_musicgen
    assert "musicgen_32k" in chip_smoke.ONLY_PHASES
    assert chip_smoke.PROBES["phase_musicgen_32k"] == "musicgen 32k"
    assert chip_smoke.dense_tag("musicgen-medium") == "musicgen"
    main = inspect.getsource(chip_smoke.main)
    assert "DENSE_ARCHS + (CROSS_ARCH,)" in main
    ref = inspect.getsource(chip_smoke.phase_dryrun_reference)
    assert "prefill(params[dev], t, ctx[dev])" in ref
    # its cuts: MUSICGEN_REF_BLOCKS cross layers at full width
    from repro_torch.configs import get_config
    cut = chip_smoke.block_cut(get_config("musicgen-medium"),
                               chip_smoke.MUSICGEN_REF_BLOCKS)
    assert (cut.num_layers, cut.d_model, cut.num_ctx_tokens) == (2, 1536,
                                                                 256)
    assert chip_smoke.llm_kernel_calls(cut) == (4, 0)


def test_adamw_first_step_is_adamws_update():
    # the float64 oracle of the launcher checks against AdamW's own
    # float32 update from the same gradients: within one bf16 ulp an entry
    # (a float32 result can round to bf16 the other way at a tie), with
    # the global-norm clip active and not
    from repro_torch.training.optimizer import AdamW
    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(64, 32, generator=gen).to(torch.bfloat16),
              "b": torch.randn(7, generator=gen).to(torch.bfloat16)}
    for scale in (1e-3, 10.0):                    # unclipped, clipped
        grads = {k: (scale * torch.randn(p.shape, generator=gen)).to(
            torch.bfloat16) for k, p in params.items()}
        opt = AdamW(lr=3e-4)
        want = opt.update(grads, opt.init(params), params)[0]
        got = chip_smoke.adamw_first_step(opt, grads, params)
        assert got.keys() == want.keys()
        assert all(got[k].dtype == torch.bfloat16 for k in got)
        ulps, differ = chip_smoke.bf16_update_ulps(got, want, 3e-4)
        assert ulps <= 1.0 and differ < 0.01
        assert any(not torch.equal(got[k], params[k]) for k in got)


def test_the_cuts_keep_every_check():
    # the time the musicgen block takes comes from earlier paths, each
    # check kept: train_llm on one block of zamba2-7b (9 layers: its
    # Mamba2 layers and its shared attention, so K6 and K8 and both plain
    # VJPs still launch); the launcher check's and the float32 train
    # check's CPU side computes the step's loss and gradients only, and
    # AdamW's step (the launcher's from the card's gradients, the float32
    # one from the CPU's) is its float64 oracle on the card
    import inspect
    from repro_torch.configs import get_config
    assert chip_smoke.TRAIN_LLM_BLOCKS == 1
    cut = chip_smoke.block_cut(get_config("zamba2-7b"),
                               chip_smoke.TRAIN_LLM_BLOCKS)
    assert cut.num_layers == 9 and "shared_attn" in chip_smoke.layer_kinds(
        cut)
    assert chip_smoke.train_launches(cut, remat=True) == {
        "flash_attention": 2, "ssd_scan": 15, "flash_attention_vjp": 1,
        "ssd_scan_vjp": 8}
    ref = inspect.getsource(chip_smoke.phase_llm_launcher_reference)
    assert "adamw_first_step(AdamW(lr=LAUNCHER_LR), g," in ref
    assert 'run("cpu", update=False)' in ref
    assert "opt.update(" not in ref
    assert "ulps <= 1.0" in ref and "BF16_GRAD_RTOL" in ref
    fp32 = inspect.getsource(chip_smoke.phase_llm_train_reference)
    assert "adamw_first_step(AdamW(lr=TRAIN_LLM_LR)," in fp32
    assert "assert_train_params_close(p, p0, g0," in fp32
    assert fp32.count("make_train_step(") == 1          # the card's step


def test_d64_entry_is_a_kernel_line_of_its_own():
    # K6's bf16 kernels at d <= 64 as a kernel line of their own: the bf16
    # K6 phase's musicgen serving row's numbers, the d <= 64 instances its
    # rows ran, and the d <= 64 launches of musicgen's dry-run steps
    keys = dict(route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:86",
                launches=None, max_abs_err=3e-3, ms=0.1, plain_ms=0.4,
                bound_ms=0.03, bound_by="operations", library_ms=0.09)
    bf = dict(keys, name="flash_attention_bf16", what="zamba2 cache prefill",
              kernel="flash_attention_wgmma_kernel<1, 7, 7>",
              dryrun_musicgen={"prefill_32k": 1.0})
    bf["other_shapes"] = [
        dict(keys, what=chip_smoke.D64_SHAPE, ms=0.05,
             kernel="flash_attention_ws_kernel<4>"),
        dict(keys, what="musicgen cross-attention decode step",
             kernel="flash_attention_row_kernel<4>"),
        dict(keys, what="deepseek-v2-lite MLA cache prefill",
             kernel="flash_attention_wgmma_kernel<1, 12, 8>")]
    shapes = chip_smoke.card_shapes(chip_smoke.CROSS_ARCH)
    dryrun = {"card_musicgen": {s: {"launches_d64": 48 + i}
                                for i, s in enumerate(shapes)}}
    entry = chip_smoke.d64_entry(bf, dryrun)
    assert entry["name"] == "flash_attention_bf16_d64"
    assert entry["ms"] == 0.05 and "what" not in entry
    assert entry["launches"] == sum(48 + i for i in range(len(shapes)))
    assert entry["kernels"] == ["flash_attention_row_kernel<4>",
                                "flash_attention_ws_kernel<4>"]
    assert entry["dryrun_musicgen"] == {"prefill_32k": 1.0}
    assert set(keys) <= set(entry)
