"""The port's kernel build (``repro_torch.kernels.build``) on the CPU.

nvcc is not needed: a stand-in compiler (a small Python script) records
its arguments and writes the library file, so these tests check what
``build.py`` asks of nvcc, how it caches, and how it fails.  The real build runs
on the card's machine (``chip_smoke.py``, ``tests/test_torch_gpu.py``).
"""

import os
import stat
import sys

import pytest

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.hash_decode import ops as hd_ops
from repro_torch.kernels.lsh_encode import ops as lsh_ops

KERNELS = [hd_ops, fa_ops, lsh_ops]

FAKE_NVCC = """#!{python}
import sys
args = sys.argv[1:]
with open({record!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
if {fail!r}:
    sys.stderr.write("error: refused\\n")
    sys.exit(1)
out = args[args.index("-o") + 1]
with open(out, "w") as f:
    f.write("library")
print("ptxas info    : Used 40 registers, 0 bytes spill stores")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Point ``build`` at a stand-in compiler and a temporary build dir;
    returns a function that makes the compiler fail or succeed and a
    reader of the argument lists it was called with."""
    record = tmp_path / "calls.txt"
    script = tmp_path / "nvcc"

    def make(fail=False):
        script.write_text(FAKE_NVCC.format(python=sys.executable, record=str(record),
                                           fail=fail))
        script.chmod(script.stat().st_mode | stat.S_IXUSR)
        return script

    make()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(script))

    def calls():
        return record.read_text().splitlines() if record.exists() else []

    return make, calls


def test_library_path_is_keyed_by_source_and_flags(tmp_path, monkeypatch):
    a, b = tmp_path / "a.cu", tmp_path / "b.cu"
    a.write_text("int a;")
    b.write_text("int b;")
    assert build.library_path("k", a) == build.library_path("k", a)
    assert build.library_path("k", a) != build.library_path("k", b)
    before = build.library_path("k", a)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k", a) != before       # another flag set, another library


@pytest.mark.parametrize("mod", KERNELS, ids=lambda m: m.NAME)
def test_every_kernel_builds_with_the_global_flags(fake_nvcc, mod):
    """One flag set for all three sources: ``--fmad=false`` (hash_decode's
    and lsh_encode's bitwise targets need unfused multiply and add) and
    ``sm_90a`` (wgmma and setmaxnreg exist only there); libcuda is not
    linked (flash_attention fetches cuTensorMapEncodeTiled at run time)."""
    _, calls = fake_nvcc
    path, log = mod.build()
    (args,) = calls()
    assert "--fmad=false" in args.split()
    assert "arch=compute_90a,code=sm_90a" in args.split()
    assert "-lcuda" not in args.split()
    assert args.split()[-1] == str(mod.SOURCE)
    assert path == build.library_path(mod.NAME, mod.SOURCE) and path.exists()
    assert "registers" in log


def test_build_is_cached_with_its_log(fake_nvcc):
    _, calls = fake_nvcc
    first = fa_ops.build()
    second = fa_ops.build()
    assert first == second and len(calls()) == 1
    leftovers = [p.name for p in build.BUILD_DIR.iterdir() if ".tmp" in p.name]
    assert leftovers == []
    assert sorted(p.suffix for p in build.BUILD_DIR.iterdir()) == [".log", ".so"]


def test_failed_build_raises_and_leaves_no_library(fake_nvcc):
    make, _ = fake_nvcc
    make(fail=True)
    with pytest.raises(RuntimeError, match="refused"):
        fa_ops.build()
    assert list(build.BUILD_DIR.iterdir()) == []


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


def test_a_found_nvcc_is_returned(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert build.find_nvcc() == os.fspath(nvcc)


def test_flash_ablation_variants_apply_to_the_kernel_source():
    """``python -m repro_torch.kernels.flash_attention.ablate`` derives each
    variant by one text edit of the shipped source: every edit must still
    apply, and each variant must differ from the shipped kernel."""
    from repro_torch.kernels.flash_attention import ablate
    sources = ablate.variant_sources(fa_ops.SOURCE.read_text())
    assert set(sources) == set(ablate.VARIANTS)
    assert sources["shipped"] == fa_ops.SOURCE.read_text()
    others = [name for name in sources if name != "shipped"]
    assert all(sources[name] != sources["shipped"] for name in others)
    with pytest.raises(ValueError, match="does not apply"):
        ablate.variant_sources("// not the kernel")


@pytest.mark.parametrize("name", ["lsh_encode", "hash_decode"])
def test_encode_and_decode_ablation_variants_apply_to_their_kernel_sources(name):
    """``python -m repro_torch.kernels.<name>.ablate`` derives each variant by
    text edits of the shipped source (``build.apply_edits``): every edit
    must still apply once, and each variant must differ from the shipped
    kernel."""
    import importlib
    ablate = importlib.import_module(f"repro_torch.kernels.{name}.ablate")
    mod = {m.NAME: m for m in KERNELS}[name]
    sources = ablate.variant_sources(mod.SOURCE.read_text())
    assert set(sources) == set(ablate.VARIANTS) and len(sources) >= 3
    assert sources["shipped"] == mod.SOURCE.read_text()
    assert all(sources[v] != sources["shipped"] for v in sources if v != "shipped")
    with pytest.raises(ValueError, match="does not apply"):
        ablate.variant_sources("// not the kernel")
