"""The seam between the port and its CUDA library (kernels.py), on the CPU.

- `kernels.c_args`, the argument conversion of `kernels.launch`: a tensor
  becomes its data pointer, None a null pointer, a Python int a C int, a
  ctypes.Structure a reference to it; an int outside int32 (a pointer
  passed where its tensor belongs) and a value with no C form raise, and
  `launch` raises for them before it loads the library.
- `kernels.device_of`, and every kernel wrapper, refuse a tensor on a
  device with no kernel ("no kernel for device").
- Each wrapper's `launch` call against its C entry point in csrc/: with
  the launch recorded instead of made, the arguments are as many as the
  entry point's parameters before the stream, each of the kind it takes
  (a pointer: a tensor, None or a parameter struct; an int: an int).
- A source scan: no module of cvsim_tpu_torch but kernels.py reads a
  stream handle, names a `cvsim_*` entry point or sets argtypes (the
  native/ loaders of the g++-built host libraries aside), and the gen-1
  wrappers import nothing from the gen-2 ones.
"""

import ast
import ctypes
import re
from pathlib import Path

import pytest
import torch

from cvsim_tpu_torch import kernels
from cvsim_tpu_torch.config import CompositeConfig
from cvsim_tpu_torch.interop import key32_from_seed
from cvsim_tpu_torch.host import payload
from cvsim_tpu_torch.models import chain_prep, fused_yiq, fused_yuv, raw28
from cvsim_tpu_torch.ops import fused_iir

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "cvsim_tpu_torch"
MODULES = sorted(str(p.relative_to(ROOT)) for p in PACKAGE.rglob("*.py")
                 if p.name != "kernels.py" or p.parent != PACKAGE)
# native/ loads its own host libraries (built with g++), not the CUDA one
HOST_LIBRARIES = "cvsim_tpu_torch/native/"


class _Params(ctypes.Structure):
    _fields_ = [("a", ctypes.c_int), ("b", ctypes.c_float)]


def test_c_args_converts_each_kind():
    t = torch.arange(6, dtype=torch.int32)
    params = _Params(a=3, b=0.5)
    ptr, null, n, ref, flag = kernels.c_args(
        [t, None, -7, params, True])
    assert isinstance(ptr, ctypes.c_void_p) and ptr.value == t.data_ptr()
    assert isinstance(null, ctypes.c_void_p) and null.value is None
    assert isinstance(n, ctypes.c_int) and n.value == -7
    assert ref._obj is params
    assert isinstance(flag, ctypes.c_int) and flag.value == 1


@pytest.mark.parametrize("value", [2 ** 31 - 1, -2 ** 31])
def test_c_args_takes_the_int32_range(value):
    assert kernels.c_args([value])[0].value == value


@pytest.mark.parametrize("value", [2 ** 31, -2 ** 31 - 1, 2 ** 40 + 256])
def test_c_args_refuses_an_int_beyond_int32(value):
    with pytest.raises(ValueError, match="outside a C int"):
        kernels.c_args([torch.zeros(1), value])


def test_c_args_refuses_a_value_with_no_c_form():
    with pytest.raises(TypeError, match="no C form for float"):
        kernels.c_args([1.5])


def test_launch_refuses_a_stray_pointer_before_loading(monkeypatch):
    def load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", load)
    t = torch.zeros(4)
    with pytest.raises(ValueError, match="argument 1"):
        kernels.launch("yiq_chain", t, t.data_ptr() | 2 ** 40,
                       device=torch.device("cpu"))


def test_device_of():
    assert kernels.device_of(torch.zeros(1), "k") is None
    with pytest.raises(ValueError, match="k: no kernel for device meta"):
        kernels.device_of(torch.zeros(1, device="meta"), "k")


def _meta(shape, dtype=torch.uint8):
    return torch.zeros(shape, dtype=dtype, device="meta")


CFG = CompositeConfig()
WRAPPERS = {
    "field_streams": lambda: chain_prep.field_streams_fused(
        CFG, _meta(2, torch.int32), _meta(2, torch.int32), 4, 8, 1),
    "yiq_chain": lambda: fused_yiq.composite_layer_rgb_fused(
        _meta((1, 2, 8, 3)), None, cfg=CFG),
    "yiq_a": lambda: fused_yiq.stage_a(_meta((1, 2, 8, 3)), None, cfg=CFG),
    "yiq_b1": lambda: fused_yiq.stage_b1(_meta((1, 2, 128), torch.float32),
                                         None, cfg=CFG, w=8),
    "yiq_b2": lambda: fused_yiq.stage_b2(
        *(_meta((1, 2, 128), torch.float32),) * 3, None, cfg=CFG, w=8),
    "yuv_chain": lambda: fused_yuv.composite_video_process_merged(
        _meta((1, 2, 8)), _meta((1, 2, 4)), _meta((1, 2, 4)), None, cfg=CFG),
    "yuv_a": lambda: fused_yuv.stage_a(_meta((1, 2, 8)), _meta((1, 2, 4)),
                                       _meta((1, 2, 4)), None, cfg=CFG),
    "yuv_b1": lambda: fused_yuv.stage_b1(_meta((1, 2, 8)), None, cfg=CFG),
    "yuv_b2": lambda: fused_yuv.stage_b2(_meta((1, 2, 8)), _meta((1, 2, 4)),
                                         _meta((1, 2, 4)), None, cfg=CFG),
    "fused_iir": lambda: fused_iir.fused_iir(
        _meta((2, 8), torch.float32), alphas=(0.5,), y0s=(0.0,)),
    "raw28_tails": lambda: raw28.raw28_tails(
        _meta((3, raw28.TAIL_COLS), torch.int32),
        _meta((3, raw28.OUT_COLS), torch.int32),
        _meta(raw28.CARRY, torch.int32)),
    "y4m_payload": lambda: payload.payloads(_meta((1, 2, 8, 3)), 4, False),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_refuses_a_device_with_no_kernel(name):
    with pytest.raises(ValueError, match=f"{name}: no kernel for device meta"):
        WRAPPERS[name]()


def _c_signatures() -> dict:
    """{entry point: kinds of its parameters before the stream}, each
    "ptr" or "int", from csrc/*.cu."""
    sigs = {}
    for src in sorted((PACKAGE / "csrc").glob("*.cu")):
        for m in re.finditer(r'extern "C" int cvsim_(\w+)\((.*?)\)\s*\{',
                             src.read_text(), re.S):
            params = [p.strip() for p in m.group(2).split(",")]
            sigs[m.group(1)] = ["ptr" if "*" in p else p.split()[0]
                                for p in params]
    return {name: kinds[:-1] for name, kinds in sigs.items()
            if kinds and kinds[-1] == "ptr"}


def _signature_calls():
    """{kernel: a call of its wrapper on small CPU inputs}."""
    fn = torch.arange(2, dtype=torch.int32) + 3
    key = key32_from_seed(5)
    rgb = torch.zeros((2, 4, 8, 3), dtype=torch.uint8)
    prep2 = fused_yiq.prepare(CFG, rgb, fn, fn % 2, key)
    y = torch.zeros((2, 4, 8), dtype=torch.uint8)
    u = torch.zeros((2, 4, 4), dtype=torch.uint8)
    prep1 = fused_yuv.prepare(CFG, y, fn, fn % 2, key)
    yp = torch.zeros((2, 4, 128), dtype=torch.float32)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    return {
        "field_streams": lambda: chain_prep.field_streams_fused(
            CFG.with_(video_chroma_phase_noise=6), fn, fn % 2, 4, 8, key),
        "yiq_chain": lambda: fused_yiq.composite_layer_rgb_fused(
            rgb, prep2, cfg=CFG),
        "yiq_a": lambda: fused_yiq.stage_a(rgb, prep2, cfg=CFG),
        "yiq_b1": lambda: fused_yiq.stage_b1(yp, prep2, cfg=CFG, w=8),
        "yiq_b2": lambda: fused_yiq.stage_b2(yp, yp, yp, prep2, cfg=CFG, w=8),
        "yuv_chain": lambda: fused_yuv.composite_video_process_merged(
            y, u, u, prep1, cfg=CFG),
        "yuv_a": lambda: fused_yuv.stage_a(y, u, u, prep1, cfg=CFG),
        "yuv_b1": lambda: fused_yuv.stage_b1(y, prep1, cfg=CFG),
        "yuv_b2": lambda: fused_yuv.stage_b2(y, u, u, prep1, cfg=CFG),
        "fused_iir": lambda: fused_iir.fused_iir(
            torch.zeros((2, 8)), alphas=(0.5, 0.25), y0s=(0.0, 0.0)),
        "raw28_tails": lambda: raw28.raw28_tails(
            i32(3, raw28.TAIL_COLS), i32(3, raw28.OUT_COLS), i32(raw28.CARRY)),
        "y4m_payload": lambda: payload.payloads(rgb, 7, True),
    }


def test_signature_calls_cover_every_launched_entry_point():
    assert sorted(_signature_calls()) == sorted(_c_signatures())


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_launches_its_entry_points_signature(monkeypatch, name):
    calls = _signature_calls()
    launched = []
    monkeypatch.setattr(kernels, "device_of", lambda t, what: t.device)
    monkeypatch.setattr(kernels, "launch", lambda kernel, *args, device:
                        launched.append((kernel, args, device)))
    calls[name]()
    assert [k for k, _, _ in launched] == [name]
    _, args, device = launched[0]
    kinds = ["int" if isinstance(a, int) else "ptr" for a in args]
    assert kinds == _c_signatures()[name]
    assert device == torch.device("cpu")
    assert all(isinstance(a, (int, torch.Tensor, ctypes.Structure))
               or a is None for a in args)


def _attributes(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    return [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)]


@pytest.mark.parametrize("path", MODULES)
def test_only_kernels_talks_to_the_cuda_library(path):
    attrs = _attributes(path)
    assert not [n.lineno for n in attrs if n.attr == "cuda_stream"], path
    if path.startswith(HOST_LIBRARIES):
        return
    bad = [(n.attr, n.lineno) for n in attrs
           if n.attr == "argtypes" or n.attr.startswith("cvsim_")]
    assert not bad, f"{path} talks to the library: {bad}"


def test_library_scan_covers_the_wrappers():
    for path in ("cvsim_tpu_torch/models/fused_yiq.py",
                 "cvsim_tpu_torch/models/fused_yuv.py",
                 "cvsim_tpu_torch/models/chain_prep.py",
                 "cvsim_tpu_torch/models/raw28.py",
                 "cvsim_tpu_torch/ops/fused_iir.py",
                 "cvsim_tpu_torch/host/payload.py"):
        assert path in MODULES
    assert "cvsim_tpu_torch/kernels.py" not in MODULES


def test_gen1_wrappers_import_nothing_of_gen2():
    path = "cvsim_tpu_torch/models/fused_yuv.py"
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    imported = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported += [node.module]
            imported += [f"{node.module}.{a.name}" for a in node.names]
    assert "cvsim_tpu_torch.models.fused_yiq" not in imported
    assert not hasattr(fused_yuv, "fused_yiq")
