"""The pure-Python part of the port's kernel binding (rmi_tpu_torch/ops/
_build.py), on the CPU: the table of C entry points read from
csrc/entries.h, the refusal of unknown names before any build, the
compile and link commands, and the build's key.  The compiled binding
itself runs on the card (tests/test_torch_cuda_kernels.py)."""

import re

import pytest
import torch

from rmi_tpu_torch import config
from rmi_tpu_torch.ops import _build

ARG_TYPES = {"int64_t", "int32_t", "double", "void*"} | {
    f"{c}{t}*" for c in ("", "const ") for t in ("float", "double", "int32_t", "int64_t")}


def _defined_entries():
    """Names of the RMI_API functions that csrc/*.cu defines, eval.cu's
    macro-made ones expanded."""
    names = set()
    for src in config.CSRC_DIR.glob("*.cu"):
        text = src.read_text()
        names |= set(re.findall(r"^RMI_API int (rmi_\w+)\(", text, re.MULTILINE))
        for macro, prefix in (("RMI_LEAF_EVAL_ENTRY", "rmi_leaf_eval_"),
                              ("RMI_LOOKUP_ENTRY", "rmi_lookup_")):
            names |= {prefix + n for n in
                      re.findall(rf"^{macro}\((\w+),", text, re.MULTILINE)}
    return names


def test_signatures_cover_every_entry_point():
    """SIGNATURES holds each C entry that csrc/ defines, once, with
    parameter types the binding converts, its stream last; launches
    counts each of them."""
    assert len(_build.SIGNATURES) == 47
    assert set(_build.SIGNATURES) == _defined_entries()
    assert list(_build.launches) == list(_build.SIGNATURES)
    for name, params in _build.SIGNATURES.items():
        assert params[-1] == "void*", name
        assert set(params) <= ARG_TYPES, (name, params)
        assert any(p.endswith("*") and not p.startswith("const") for p in params[:-1]), name


@pytest.mark.parametrize("name", ["rmi_no_such_entry", "", "rmi_probe_scale"])
def test_launch_rejects_unknown_names_before_building(monkeypatch, name):
    def no_build():
        raise AssertionError("an unknown name must not reach the build")
    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="unknown C entry point"):
        _build.launch(name, torch.zeros(4))


def test_build_commands():
    """One nvcc per .cu with the kernels' flags, one host compile of the
    binding against torch's headers with torch's C++ ABI and Python.h,
    and one link of every object with torch's libraries."""
    from torch.utils import cpp_extension
    compiles, link = _build.commands("/opt/cuda/bin/nvcc", "/usr/bin/c++", "/obj", "/x.so")
    cus = sorted(p.name for p in config.CSRC_DIR.glob("*.cu"))
    assert [name for name, _ in compiles] == sorted(cus + [_build.BINDING])
    objs = []
    for name, cmd in compiles:
        assert cmd[cmd.index("-o") + 1] == f"/obj/{name.rsplit('.', 1)[0]}.o"
        objs.append(cmd[cmd.index("-o") + 1])
        if name == _build.BINDING:
            assert cmd[0] == "/usr/bin/c++"
            assert f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}" in cmd
            for inc in [*cpp_extension.include_paths(), _build.python_include(),
                        "/opt/cuda/include"]:
                assert f"-I{inc}" in cmd
        else:
            assert cmd[0] == "/opt/cuda/bin/nvcc" and set(_build.NVCC_FLAGS) <= set(cmd)
    assert link[0] == "/opt/cuda/bin/nvcc" and link[link.index("-o") + 1] == "/x.so"
    assert set(objs) <= set(link)
    assert {f"-l{lib}" for lib in _build.TORCH_LIBS} <= set(link)


def test_build_key_covers_the_binding(monkeypatch, tmp_path):
    """The build's key changes with the binding's source, with the
    entries' list and with the torch it is built for."""
    for src in config.CSRC_DIR.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(config, "CSRC_DIR", tmp_path)
    names = {p.name for p in _build._sources()}
    assert {_build.BINDING, "entries.h", "common.cuh", "probes.cu"} <= names
    key = _build._digest()
    for name in (_build.BINDING, "entries.h"):
        (tmp_path / name).write_bytes((config.CSRC_DIR / name).read_bytes() + b"\n")
        assert _build._digest() != key
        key = _build._digest()
    monkeypatch.setattr(torch, "__version__", torch.__version__ + "+other")
    assert _build._digest() != key
