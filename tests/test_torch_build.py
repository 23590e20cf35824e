"""The port's kernel build and launch path (``repro_torch.kernels._build``)
on the CPU: what names the built library, and the one-pass operand check
that guards every pointer handed to native code."""
import ctypes
import shutil
import types

import pytest
import torch

from repro_torch.kernels import _build


def test_digest_covers_headers_as_well_as_sources(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert _build._digest(csrc) == _build._digest()
    header = csrc / "primitives.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    changed = _build._digest(csrc)
    assert changed != _build._digest()
    (csrc / "flash_attention.cu").write_text(
        (csrc / "flash_attention.cu").read_text() + "\n")
    assert _build._digest(csrc) != changed
    (csrc / "notes.txt").write_text("not a source")
    assert _build._digest(csrc) == _build._digest(csrc)


def _fake(shape=(2, 3), dtype=torch.float32, contiguous=True, device=0,
          cuda=True):
    """A stand-in for a CUDA tensor: the attributes the check reads."""
    return types.SimpleNamespace(
        is_cuda=cuda, dtype=dtype, shape=torch.Size(shape),
        device=f"cuda:{device}" if cuda else "cpu",
        is_contiguous=lambda: contiguous, get_device=lambda: device)


@pytest.mark.parametrize("bad,match", [
    (dict(cuda=False), "CUDA"),
    (dict(dtype=torch.float64), "float32"),
    (dict(shape=(3, 2)), "shape"),
    (dict(contiguous=False), "contiguous"),
    (dict(device=1), "current device"),
])
def test_operand_check_rejects_each_fault(monkeypatch, bad, match):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    good = ("x", _fake(), torch.float32, (2, 3))
    _build.check_operands(good, ("y", _fake(), torch.float32, None))
    with pytest.raises(ValueError, match=match):
        _build.check_operands(good, ("y", _fake(**bad), torch.float32,
                                     (2, 3)))


@pytest.mark.parametrize("q,k,match", [
    (torch.bfloat16, torch.bfloat16, None),
    (torch.float32, torch.float32, None),
    (torch.float32, torch.bfloat16, "share one dtype"),
    (torch.float16, torch.float16, "one of torch.float32, torch.bfloat16"),
])
def test_operand_check_takes_dtype_sets_and_shared_dtypes(monkeypatch, q, k,
                                                          match):
    # the LLM kernels take float32 or bf16 operands, the same for the
    # operands of one group; float16 and a mix raise, nothing converts
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    both = (torch.float32, torch.bfloat16)
    operands = (("q", _fake(dtype=q), both, None),
                ("k", _fake(dtype=k), both, (2, 3)),
                ("dt", _fake(), torch.float32, None))
    if match is None:
        _build.check_operands(*operands, same=[("q", "k")])
    else:
        with pytest.raises(ValueError, match=match):
            _build.check_operands(*operands, same=[("q", "k")])


def test_operand_check_rejects_cpu_tensors():
    # what the on-card rejection tests see for a tensor left on the host
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_operands(("x", x, torch.float32, (4, 3)))


def test_filter_args_struct_is_cached_per_key(monkeypatch):
    # K1's and K4b's launchers read VpaasFilterArgs (three ints, four
    # floats); the wrappers build one per (sizes, thresholds) and hand its
    # address to every launch with that key
    from repro_torch.kernels import iou_filter as ik
    assert ctypes.sizeof(ik.FilterArgs) == 28
    monkeypatch.setattr(ik, "_args", {})
    kw = (0.4, 0.3, 0.5, 1.0)
    first = ik.filter_args(32, 256, 256, *kw)
    assert ik.filter_args(32, 256, 256, *kw) == first
    args = ctypes.cast(first, ctypes.POINTER(ik.FilterArgs)).contents
    assert (args.F, args.N, args.M) == (32, 256, 256)
    assert (args.theta_iou, args.frame_area) == (pytest.approx(0.3), 1.0)
    assert ik.filter_args(1, 256, 256, *kw) != first       # K4b's frame
    other = ik.filter_args(32, 256, 256, 0.4, 0.5, 0.5, 1.0)
    assert other != first
    assert ctypes.cast(other, ctypes.POINTER(ik.FilterArgs)).contents \
        .theta_iou == 0.5


@pytest.mark.parametrize("module,struct,values", [
    ("iou_matrix", "IouArgs", (32, 256, 256)),            # B, N, M
    ("nms", "NmsArgs", (32, 256, 0.45))])                 # F, N, threshold
def test_launch_arg_structs_are_cached_per_key(monkeypatch, module, struct,
                                               values):
    # K4a's VpaasIouArgs and NMS's VpaasNmsArgs (three 4-byte fields each,
    # as csrc/iou_filter.cu and csrc/nms.cu lay them out), one struct per
    # key through _build.struct_address
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    cls = getattr(mod, struct)
    assert ctypes.sizeof(cls) == 12
    cache = {}
    first = _build.struct_address(cache, cls, *values)
    assert _build.struct_address(cache, cls, *values) == first
    got = ctypes.cast(first, ctypes.POINTER(cls)).contents
    assert [getattr(got, name) for name, _ in cls._fields_] == \
        pytest.approx(list(values))
    other = _build.struct_address(cache, cls, 1, *values[1:])
    assert other != first and len(cache) == 2
    monkeypatch.setattr(_build, "MAX_CACHED", 2)
    _build.struct_address(cache, cls, 2, *values[1:])      # past the cap
    assert len(cache) == 1
