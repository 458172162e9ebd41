"""The port's kernel build (``repro_torch.kernels._build``) on the CPU.

No compiler runs here: the tests check what names the library (a hash of
every file under the kernel's ``csrc/``, its sources and the flags, so
that an edited header is never served from a stale library) and the
``nvcc`` command that a build would start (the flags, then every source
of the kernel).
"""
import subprocess

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A kernel ``toy`` of two sources and a header, built into tmp_path."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n')
    (csrc / "b.cu").write_text("// second source\n")
    (csrc / "common.cuh").write_text("#pragma once\n")
    kernels = dict(_build.KERNELS)
    kernels["toy"] = _build.Kernel(csrc, ("a.cu", "b.cu"))
    monkeypatch.setattr(_build, "KERNELS", kernels)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_every_listed_source_exists():
    for name, kern in _build.KERNELS.items():
        assert kern.sources, name
        for src in kern.sources:
            assert (kern.csrc / src).is_file(), (name, src)
    fa = _build.KERNELS["flash_attention"]
    assert set(fa.sources) == {"flash_attention.cu", "flash_attention_tc.cu"}
    assert (fa.csrc / "hopper.cuh").is_file()


def test_library_name_follows_headers_sources_and_flags(toy, monkeypatch):
    first = _build.library_path("toy")
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith("libtoy_") and first.suffix == ".so"
    assert _build.library_path("toy") == first          # deterministic
    (toy / "common.cuh").write_text("#pragma once\n#define X 1\n")
    after_header = _build.library_path("toy")
    assert after_header != first
    (toy / "b.cu").write_text("// edited\n")
    after_source = _build.library_path("toy")
    assert after_source not in (first, after_header)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-DX",))
    assert _build.library_path("toy") not in (first, after_header,
                                              after_source)


def test_build_runs_one_nvcc_with_every_source_then_the_flags(toy,
                                                               monkeypatch):
    seen = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            seen.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            open(out, "wb").close()

        def communicate(self, timeout=None):
            return "ptxas info    : Used 8 registers\n", None

    monkeypatch.setattr(_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    built = _build.build("toy")
    assert len(seen) == 1
    cmd = seen[0]
    assert cmd[:1 + len(_build.NVCC_FLAGS)] == ["nvcc", *_build.NVCC_FLAGS]
    assert cmd[-4] == "-o"
    assert cmd[-2:] == [str(toy / "a.cu"), str(toy / "b.cu")]
    assert built["toy"] == _build.library_path("toy")
    assert built["toy"].exists()
    assert "Used 8 registers" in _build.build_log("toy")
    # built already: a second call starts no compiler
    _build.build("toy")
    assert len(seen) == 1
