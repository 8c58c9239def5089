"""The flash kernels' bindings and dispatch, without a GPU or ``nvcc``:
every ctypes signature against the ``extern "C"`` entry points of the CUDA
sources, and the Python side's choice of design (tensor-core ``mma`` for
every bf16 pass, the 3xTF32 tensor-core ``tf32x3`` for every fp32 pass) and
of entry point for each pass."""

import ctypes
import re

import pytest
import torch

from baton_tpu_torch.ops import flash_attention as fa

# small shapes: one thread each keeps the parallel test workers from
# oversubscribing the cores
torch.set_num_threads(1)

CTYPE = {"pointer": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _entry_points():
    """{name: [ctypes type of each argument]} from the extern "C" blocks of
    every .cu in csrc/."""
    found = {}
    for src in sorted(fa._CSRC.glob("*.cu")):
        text = src.read_text()
        for block in re.findall(r'extern "C" \{(.*?)\n\}  // extern "C"', text, re.S):
            for name, args in re.findall(r"^int (\w+)\(([^)]*)\)\s*\{", block, re.M):
                kinds = []
                for arg in args.split(","):
                    arg = " ".join(arg.split())
                    if "*" in arg:
                        kinds.append(CTYPE["pointer"])
                    elif re.fullmatch(r"(const )?int \w+", arg):
                        kinds.append(CTYPE["int"])
                    elif re.fullmatch(r"(const )?float \w+", arg):
                        kinds.append(CTYPE["float"])
                    else:
                        raise AssertionError(f"{src.name}:{name}: unknown argument {arg!r}")
                assert name not in found, f"{name} defined twice"
                found[name] = kinds
    return found


def test_every_source_is_built():
    assert sorted(fa._SOURCES) == sorted(p.name for p in fa._CSRC.glob("*.cu"))


def test_signatures_match_the_extern_c_entry_points():
    entry = _entry_points()
    assert set(entry) == set(fa.SIGNATURES), "bound and defined entry points differ"
    for name, argtypes in fa.SIGNATURES.items():
        assert argtypes == entry[name], f"{name}: ctypes {argtypes} vs C {entry[name]}"


def test_load_library_binds_every_signature(monkeypatch, tmp_path):
    """load_library sets argtypes and restype from SIGNATURES on the library
    it opens (a stand-in here: nothing is built)."""
    so = tmp_path / "libflash_attention_test.so"
    so.write_bytes(b"")

    class FakeLib:
        def __init__(self, path):
            assert path == str(so)
            self.fns = {name: type("Fn", (), {})() for name in fa.SIGNATURES}

        def __getattr__(self, name):
            return self.fns[name]

    monkeypatch.setattr(fa, "_lib", None)
    monkeypatch.setattr(fa, "library_path", lambda: so)
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    lib = fa.load_library()
    for name, argtypes in fa.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.argtypes == argtypes and fn.restype is ctypes.c_int
    monkeypatch.setattr(fa, "_lib", None)


@pytest.mark.parametrize("pass_", ["fwd", "bwd_dkv", "bwd_dq"])
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 64), (torch.bfloat16, 128), (torch.float32, 64), (torch.float32, 128),
])
def test_design_by_dtype_and_head_dim(dtype, d, pass_):
    """bf16 takes the mma design in every pass, fp32 the 3xTF32 one in
    every pass (the forward included: no SIMT design is left)."""
    want = "mma" if dtype == torch.bfloat16 else "tf32x3"
    assert fa._design(dtype, d, pass_) == want


@pytest.mark.parametrize("dtype,d,error", [
    (torch.float16, 64, TypeError), (torch.float64, 128, TypeError),
    (torch.bfloat16, 32, ValueError), (torch.float32, 96, ValueError),
    (torch.bfloat16, 256, ValueError),
])
def test_other_dtypes_and_head_dims_are_refused(dtype, d, error):
    for pass_ in ("fwd", "bwd_dkv", "bwd_dq"):
        with pytest.raises(error):
            fa._design(dtype, d, pass_)


def test_an_unknown_pass_is_refused():
    with pytest.raises(ValueError, match="pass"):
        fa._design(torch.float32, 64, "bwd")


@pytest.mark.parametrize("dtype,designs", [(torch.bfloat16, ("mma", "mma", "mma")),
                                           (torch.float32, ("tf32x3", "tf32x3", "tf32x3"))])
def test_wrappers_launch_the_entry_point_of_their_design(monkeypatch, dtype, designs):
    """With the kernel path forced for CPU tensors and the launch recorded,
    each pass calls its design's entry point with as many arguments as its
    signature (the stream comes last, from _launch), and counts it."""
    calls = []
    monkeypatch.setattr(fa, "_on_cpu", lambda *xs: False)
    monkeypatch.setattr(fa, "_launch", lambda name, device, *args: calls.append((name, args)))
    fa.reset_launches()
    b, hq, hkv, l, d = 1, 4, 2, 40, 64
    q, dout = (torch.zeros(b, hq, l, d, dtype=dtype) for _ in range(2))
    k, v = (torch.zeros(b, hkv, l, d, dtype=dtype) for _ in range(2))
    bias = torch.zeros(b, l)
    lse, delta = torch.zeros(b, hq, l), torch.zeros(b, hq, l)
    fa._fwd(q, k, v, bias, True, 0.125)
    fa._bwd_dkv(q, k, v, bias, dout, lse, delta, True, 0.125)
    fa._bwd_dq(q, k, v, bias, dout, lse, delta, True, 0.125)
    names = [name for name, _ in calls]
    keys = [f"{p}_{design}" for p, design in zip(("fwd", "bwd_dkv", "bwd_dq"), designs)]
    assert names == [f"flash_{key}" for key in keys]
    for name, args in calls:
        assert len(args) + 1 == len(fa.SIGNATURES[name]), name
        assert args[0] == d, name
    assert fa.launches() == {"fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}
    assert {k: n for k, n in fa.launches_by_design.items() if n} == dict.fromkeys(keys, 1)
    fa.reset_launches()
    assert not any(fa.launches_by_design.values())


def test_kernel_inputs_are_16_byte_aligned():
    """The mma kernels copy rows in 16-byte pieces: a view at an odd offset
    is copied, an aligned contiguous tensor is passed as it is."""
    flat = torch.arange(200, dtype=torch.bfloat16)
    odd = flat[1:129].view(1, 1, 2, 64)
    assert odd.data_ptr() % 16 != 0
    fixed = fa._dense(odd)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, odd)
    aligned = torch.zeros(1, 1, 2, 64, dtype=torch.bfloat16)
    assert fa._dense(aligned) is aligned
